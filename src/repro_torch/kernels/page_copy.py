"""Wrapper of the hand-written row-copy kernel
(`repro_torch/csrc/page_copy.cu`).

`page_copy(*pairs, keep=None)` does, on the card, in one launch,

    for every pair (dst, dst_index, src, src_index) and every row r
    with keep[r]:  dst[dst_index(r)] = src[src_index(r)]

for one to four pairs. Each index is a tuple with one entry per leading
dim of its side: an int32 CUDA tensor [M] (the index of each row) or
None (the row number r itself); every pair has M rows, and `keep`
(bool [M], optional) skips the rows it marks False. The dims after the
indexed ones form the row and must be contiguous; every side's rows
hold the same bytes. A row whose index is out of range on either side
(e.g. -1) is skipped — the reference's `mode="drop"`.

A side is a tensor, or a `Split` of two pools seen as one on one index
dim: the reference's slot space, where an index below the split
addresses the first pool (HBM slots) and the ones from the split on
the second at index - split (host slots). Either pool of a side may
live on the card or in pinned host memory, which the kernel reads and
writes over the link through its mapped device address
(`host_memory.device_address`); an unpinned CPU tensor raises, and
nothing is ever copied to the card on the side. The pairs of one call
run concurrently: no pair may read what another writes.

The plain version is `ref.page_copy_ref`; `ops.copy_rows` picks between
the two by device. Not a port of a TPU kernel: the reference moves
pages with XLA gathers and scatters.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import struct
from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels.build import COUNTS, library
from repro_torch.kernels.host_memory import check_memory, device_address

Index = Sequence[Optional[torch.Tensor]]

#: pairs one launch carries (`kMaxPairs` of the source)
MAX_PAIRS = 4


@dataclasses.dataclass(frozen=True)
class Split:
    """Pools `a` and `b` seen as one on index dim `dim`: index i < `at`
    addresses a at i, index i >= `at` addresses b at i - `at` (each
    within its own bound). `at` defaults to a's size on `dim`: the
    reference's slot space, HBM slots then host slots."""
    a: torch.Tensor
    b: torch.Tensor
    dim: int
    at: Optional[int] = None

    @property
    def split(self) -> int:
        return self.a.shape[self.dim] if self.at is None else self.at


Pool = Union[torch.Tensor, Split]
Pair = Tuple[Pool, Index, Pool, Index]

# The launcher's `Desc` (csrc/page_copy.cu), native layout: per pair a
# dst and a src side, each two pools (base, 4 byte strides, 4 bounds),
# 4 index pointers, ndim, split dim, split point, padding; then the
# keep pointer, the pair and row counts and the row's bytes.
_SIDE = "P4q4i" * 2 + "4P4i"
_DESC = struct.Struct("@" + _SIDE * 2 * MAX_PAIRS + "Piiq")
_NO_POOL = [0] * 9
_NO_SIDE = _NO_POOL * 2 + [0] * 8
assert _DESC.size == 1304


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = library("page_copy")
    lib.page_copy_launch.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    lib.page_copy_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1024)
def _layout(name: str, shape, stride, itemsize: int, nd: int):
    """The layout half of one pool's launcher arguments, checked once per
    (shape, strides, dtype): per dim (bound, byte stride), padded to
    four, and the row's bytes."""
    if not 1 <= nd <= min(4, len(shape)):
        raise ValueError(f"{name}: 1..4 indexed dims of a {len(shape)}-d "
                         f"tensor, got {nd}")
    row = shape[nd:]
    expect = 1
    for size, st in reversed(list(zip(row, stride[nd:]))):
        if size > 1 and st != expect:
            raise ValueError(f"{name}: the dims after the indexed ones must "
                             f"be contiguous, strides {stride}")
        expect *= size
    strides = [st * itemsize for st in stride[:nd]]
    if any(st % 16 for st in strides):
        raise ValueError(f"{name}: strides must be multiples of 16 bytes "
                         f"(16-byte copies)")
    pad = 4 - nd
    return (list(shape[:nd]) + [1] * pad + strides + [0] * pad,
            math.prod(row) * itemsize)


def _pool(name: str, t: torch.Tensor, nd: int, device):
    """One pool's packed values (base address, byte strides, bounds) and
    its row's bytes."""
    check_memory(name, t)
    if t.device.type == "cuda" and t.device != device:
        raise ValueError(f"{name}: on {t.device}, the indices on {device}")
    layout, row_bytes = _layout(name, tuple(t.shape), t.stride(),
                                t.element_size(), nd)
    addr = device_address(t)
    if addr % 16:
        raise ValueError(f"{name}: base address must be a multiple of 16 "
                         f"bytes (16-byte copies)")
    return [addr] + layout[4:] + layout[:4], row_bytes


def _side(name, side: Pool, index: Index, rows: int, device):
    """The packed values of one side, its dtype and its row's bytes."""
    nd = len(index)
    if isinstance(side, Split):
        if side.a.dtype != side.b.dtype:
            raise ValueError(f"{name}: a split of {side.a.dtype} and "
                             f"{side.b.dtype} pools")
        if not 0 <= side.dim < nd or side.split < 0:
            raise ValueError(f"{name}: split dim {side.dim} at {side.split} "
                             f"of {nd} indexed dims")
        a, a_bytes = _pool(f"{name} (first pool)", side.a, nd, device)
        b, b_bytes = _pool(f"{name} (second pool)", side.b, nd, device)
        if a_bytes != b_bytes:
            raise ValueError(f"{name}: split pools with rows of {a_bytes} "
                             f"and {b_bytes} bytes")
        pools, split, dtype = a + b, [side.dim, side.split], side.a.dtype
    else:
        pools, a_bytes = _pool(name, side, nd, device)
        pools, split, dtype = pools + _NO_POOL, [-1, 0], side.dtype
    ptrs = []
    for i in index:
        if i is None:
            ptrs.append(0)
            continue
        if i.dtype != torch.int32 or i.dim() != 1 or i.shape[0] != rows \
                or not i.is_contiguous() or i.device != device:
            raise ValueError(f"{name}: every index must be a contiguous "
                             f"int32 [{rows}] tensor on {device}")
        ptrs.append(i.data_ptr())
    return pools + ptrs + [0] * (4 - nd) + [nd] + split + [0], dtype, a_bytes


def index_device(pairs: Sequence[Pair], keep=None):
    """(device, rows) of a call: those of its first index tensor."""
    given = [i for p in pairs for i in (*p[1], *p[3]) if i is not None]
    if keep is not None:
        given.append(keep)
    if not given:
        raise ValueError("page_copy: at least one index must be a tensor")
    return given[0].device, given[0].shape[0]


def page_copy(*pairs: Pair, keep: Optional[torch.Tensor] = None) -> None:
    """For each pair (dst, dst_index, src, src_index), dst[dst_index(r)] =
    src[src_index(r)] for every row r kept, on the card, in one launch
    (see the module docstring). Launches on the current stream of the
    indices' device."""
    if not 1 <= len(pairs) <= MAX_PAIRS:
        raise ValueError(f"page_copy: 1..{MAX_PAIRS} pairs, got "
                         f"{len(pairs)}")
    device, rows = index_device(pairs, keep)
    if device.type != "cuda":
        raise ValueError("page_copy launches a CUDA kernel; CPU indices "
                         "take ref.page_copy_ref")
    values, row_bytes = [], None
    for dst, dst_index, src, src_index in pairs:
        d_vals, d_type, d_bytes = _side("dst", dst, dst_index, rows, device)
        s_vals, s_type, s_bytes = _side("src", src, src_index, rows, device)
        if s_type != d_type:
            raise ValueError(f"page_copy: {s_type} rows into {d_type}")
        if {d_bytes, s_bytes} != {row_bytes or d_bytes} or d_bytes % 16:
            raise ValueError(f"page_copy: rows of {s_bytes} bytes into rows "
                             f"of {d_bytes}; every side's must match, in "
                             f"16-byte units")
        row_bytes = d_bytes
        values += d_vals + s_vals
    keep_ptr = 0
    if keep is not None:
        if keep.dtype != torch.bool or keep.dim() != 1 \
                or keep.shape[0] != rows or not keep.is_contiguous() \
                or keep.device != device:
            raise ValueError(f"page_copy: keep must be a contiguous bool "
                             f"[{rows}] tensor on {device}")
        keep_ptr = keep.data_ptr()
    if rows == 0:
        return
    values += _NO_SIDE * 2 * (MAX_PAIRS - len(pairs))
    desc = _DESC.pack(*values, keep_ptr, len(pairs), rows, row_bytes)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _library().page_copy_launch(desc, stream)
    if err != 0:
        raise RuntimeError(f"page_copy launch failed: CUDA error {err}")
    COUNTS["page_copy"] += 1
