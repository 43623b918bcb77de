"""Wrapper of the hand-written row-copy kernel
(`repro_torch/csrc/page_copy.cu`).

`page_copy(dst, dst_index, src, src_index)` does, on the card,

    for every row r:  dst[dst_index(r)] = src[src_index(r)]

where each index is a tuple with one entry per leading dim of its
tensor: an int32 CUDA tensor [M] (the index of each row) or None (the
row number r itself). The dims after the indexed ones form the row and
must be contiguous; both sides' rows hold the same bytes. A row whose
index is out of range on either side (e.g. -1) is skipped — the
reference's `mode="drop"`. Either tensor may live on the card or in
pinned host memory, which the kernel reads and writes over the link
through its mapped device address (`host_memory.device_address`); an
unpinned CPU tensor raises, and nothing is ever copied to the card on
the side.

The plain version is `ref.page_copy_ref`; `ops.copy_rows` picks between
the two by device. Not a port of a TPU kernel: the reference moves
pages with XLA gathers and scatters.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence

import torch

from repro_torch.kernels.build import COUNTS, library
from repro_torch.kernels.host_memory import check_memory, device_address

Index = Sequence[Optional[torch.Tensor]]


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = library("page_copy")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    side = [ptr, i32] + [ptr] * 4 + [i32] * 4 + [i64] * 4
    lib.page_copy_launch.argtypes = side + side + [i32, i64, ptr]
    lib.page_copy_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1024)
def _layout(name: str, shape, stride, itemsize: int, nd: int):
    """The layout half of one side's launcher arguments, checked once per
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
                         f"(16-byte vector copies)")
    pad = 4 - nd
    return (list(shape[:nd]) + [1] * pad + strides + [0] * pad,
            math.prod(row) * itemsize)


def _side(name, t: torch.Tensor, index: Index, rows: int, device):
    """The launcher's arguments of one side: address, dims, per dim the
    index pointer, then (bounds, byte strides); and the row's bytes."""
    check_memory(name, t)
    if t.device.type == "cuda" and t.device != device:
        raise ValueError(f"{name}: on {t.device}, the indices on {device}")
    nd = len(index)
    layout, row_bytes = _layout(name, tuple(t.shape), t.stride(),
                                t.element_size(), nd)
    addr = device_address(t)
    if addr % 16:
        raise ValueError(f"{name}: base address must be a multiple of 16 "
                         f"bytes (16-byte vector copies)")
    ptrs = []
    for i in index:
        if i is None:
            ptrs.append(None)
            continue
        if i.dtype != torch.int32 or i.dim() != 1 or i.shape[0] != rows \
                or not i.is_contiguous() or i.device != device:
            raise ValueError(f"{name}: every index must be a contiguous "
                             f"int32 [{rows}] tensor on {device}")
        ptrs.append(i.data_ptr())
    return [addr, nd] + ptrs + [None] * (4 - nd) + layout, row_bytes


def page_copy(dst: torch.Tensor, dst_index: Index, src: torch.Tensor,
              src_index: Index) -> None:
    """dst[dst_index(r)] = src[src_index(r)] for every row r, on the card
    (see the module docstring). Launches on the current stream of the
    indices' device."""
    given = [i for i in (*dst_index, *src_index) if i is not None]
    if not given:
        raise ValueError("page_copy: at least one index must be a tensor")
    device = given[0].device
    if device.type != "cuda":
        raise ValueError("page_copy launches a CUDA kernel; CPU indices "
                         "take ref.page_copy_ref")
    if src.dtype != dst.dtype:
        raise ValueError(f"page_copy: {src.dtype} rows into {dst.dtype}")
    rows = given[0].shape[0]
    d_args, d_bytes = _side("dst", dst, dst_index, rows, device)
    s_args, s_bytes = _side("src", src, src_index, rows, device)
    if d_bytes != s_bytes or d_bytes % 16:
        raise ValueError(f"page_copy: rows of {s_bytes} bytes into rows "
                         f"of {d_bytes}; both must match, in 16-byte units")
    if rows == 0:
        return
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _library().page_copy_launch(*d_args, *s_args, rows, d_bytes,
                                      stream)
    if err != 0:
        raise RuntimeError(f"page_copy launch failed: CUDA error {err}")
    COUNTS["page_copy"] += 1
