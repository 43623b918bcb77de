"""Wrappers of the hand-written AdamW kernels
(`repro_torch/csrc/adamw.cu`): the global-norm clip's sums and the
update, each over every leaf of a parameter tree in one launch.

  grad_sumsq(grads) -> f32 [n leaves]
      each leaf's sum of squares of its f32 values, on the card
      (f32 squares added in f64, rounded to f32 once).
  adamw_apply(grads, params, m, v, params_out, m_out, v_out, *, scale,
              lr, bc1, bc2, b1, b2, eps, weight_decay)
      the step of `kernels/ref.py adamw_apply_ref`, bitwise for the
      same scalars, into the `*_out` tensors: the inputs themselves (a
      donated state, in place) or new tensors of the same layout.
      `scale`, `bc1`, `bc2` are f32 scalars on the card; `lr` one too,
      or a Python float.

Gradients are bf16 or f32, parameters bf16 or f32 (their own type,
kept), m and v f32; every parameter, m and v contiguous, each
gradient as its parameter (another layout is copied to it first). The
wrappers plan the grid (each leaf a share of the blocks in proportion
to its elements), pack the leaf table the launcher takes, launch on the
current stream and count each launch in `COUNTS`. They take CUDA
tensors only: `ops.grad_sumsq` and `ops.adamw_apply` send CPU tensors to
the plain versions and meta tensors to `kernels/meta.py`. Not a port of
a TPU kernel: the reference's update is XLA's fusion of plain jnp
(see the source).
"""

from __future__ import annotations

import ctypes
import functools
import math
import struct
from typing import List, Sequence, Union

import torch

from repro_torch.kernels.build import COUNTS, library

#: leaves one launch carries (`kMaxLeaves` of the source); a longer tree
#: is launched in groups of this many
MAX_LEAVES = 48
#: threads a block and elements a thread moves a step (the source's)
THREADS, VEC = 256, 8
#: blocks the grid aims at per SM, shared among the leaves
BLOCKS_PER_SM = 8

_GRAD_BF16, _PARAM_BF16, _ALIGNED = 1, 2, 4
# The launchers' `UpdateDesc` and `SumDesc`, native layout: per leaf its
# pointers, element count, first block and flags; then the scalars.
_UPDATE = struct.Struct("@" + "7Pqii" * MAX_LEAVES + "4P7f3i")
_SUM = struct.Struct("@" + "Pqii" * MAX_LEAVES + "2P2i")
assert _UPDATE.size == 3528 and _SUM.size == 1176
_NO_LEAF = [0] * 10
_NO_SUM_LEAF = [0] * 4

Scalar = Union[float, torch.Tensor]


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = library("adamw")
    for fn in (lib.adamw_apply_launch, lib.grad_sumsq_launch):
        fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_blocks(counts: Sequence[int], sms: int) -> List[int]:
    """Each leaf's first block and, last, the grid's blocks: every leaf
    at least one block, at most one per THREADS * VEC elements, and the
    rest of `sms * BLOCKS_PER_SM` in proportion to its elements."""
    total = max(sum(counts), 1)
    target = sms * BLOCKS_PER_SM
    starts = [0]
    for n in counts:
        blocks = min(math.ceil(n / (THREADS * VEC)),
                     math.ceil(target * n / total))
        starts.append(starts[-1] + max(1, blocks))
    return starts


def _device(tensors) -> torch.device:
    device = tensors[0].device
    if device.type != "cuda":
        raise ValueError("the AdamW kernels launch on the card; CPU tensors "
                         "take kernels/ref.py's plain versions")
    if any(t.device != device for t in tensors):
        raise ValueError(f"every tensor must be on {device}")
    return device


def _grad_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """`g` in `p`'s contiguous layout (a copy where it is another)."""
    if g.shape != p.shape:
        raise ValueError(f"a gradient of {tuple(g.shape)} for a parameter "
                         f"of {tuple(p.shape)}")
    if g.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"gradients are bf16 or f32, got {g.dtype}")
    return g if g.is_contiguous() else g.contiguous()


def _scalar(name: str, t: torch.Tensor, device) -> int:
    if t.dtype != torch.float32 or t.numel() != 1 or t.device != device:
        raise ValueError(f"{name}: an f32 scalar on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return t.data_ptr()


def _groups(n: int):
    return [range(i, min(i + MAX_LEAVES, n)) for i in range(0, n, MAX_LEAVES)]


def grad_sumsq(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """Each gradient's sum of squares, f32 [len(grads)] on the card, in
    one launch (two passes, no atomics: bitwise the same every run)."""
    grads = [g if g.is_contiguous() else g.contiguous() for g in grads]
    device = _device(grads)
    for g in grads:
        if g.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"gradients are bf16 or f32, got {g.dtype}")
    out = torch.empty(len(grads), dtype=torch.float32, device=device)
    sms = _sm_count(device.index if device.index is not None
                    else torch.cuda.current_device())
    stream = torch.cuda.current_stream(device).cuda_stream
    for group in _groups(len(grads)):
        leaves = [grads[i] for i in group]
        starts = plan_blocks([g.numel() for g in leaves], sms)
        partial = torch.empty(starts[-1], dtype=torch.float64, device=device)
        values = []
        for g, b0 in zip(leaves, starts):
            flags = (_GRAD_BF16 if g.dtype == torch.bfloat16 else 0) | (
                _ALIGNED if g.data_ptr() % 16 == 0 else 0)
            values += [g.data_ptr(), g.numel(), b0, flags]
        values += _NO_SUM_LEAF * (MAX_LEAVES - len(leaves))
        desc = _SUM.pack(*values, partial.data_ptr(),
                         out.data_ptr() + 4 * group.start, len(leaves),
                         starts[-1])
        with torch.cuda.device(device):
            err = _library().grad_sumsq_launch(desc, stream)
        if err != 0:
            raise RuntimeError(f"grad_sumsq launch failed: CUDA error {err}")
        COUNTS["grad_sumsq"] += 1
    return out


def adamw_apply(grads, params, m, v, params_out, m_out, v_out, *,
                scale: torch.Tensor, lr: Scalar, bc1: torch.Tensor,
                bc2: torch.Tensor, b1: float, b2: float, eps: float,
                weight_decay: float) -> None:
    """The AdamW step of every leaf into `params_out`, `m_out`, `v_out`
    (see the module docstring), in one launch."""
    n = len(params)
    if not all(len(x) == n for x in (grads, m, v, params_out, m_out,
                                     v_out)):
        raise ValueError("adamw_apply: every list has one tensor a leaf")
    grads = [_grad_like(g, p) for g, p in zip(grads, params)]
    device = _device([*grads, *params, *m, *v, *params_out, *m_out,
                      *v_out])
    for i in range(n):
        p = params[i]
        if p.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"parameters are bf16 or f32, got {p.dtype}")
        for name, t, dtype in (("m", m[i], torch.float32),
                               ("v", v[i], torch.float32),
                               ("params_out", params_out[i], p.dtype),
                               ("m_out", m_out[i], torch.float32),
                               ("v_out", v_out[i], torch.float32)):
            if t.dtype != dtype or t.shape != p.shape:
                raise ValueError(f"{name}: {dtype} {tuple(p.shape)}, got "
                                 f"{t.dtype} {tuple(t.shape)}")
        for name, t, src in (("params", p, None), ("m", m[i], None),
                             ("v", v[i], None), ("params_out", params_out[i], p),
                             ("m_out", m_out[i], m[i]),
                             ("v_out", v_out[i], v[i])):
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
            if src is not None and t.data_ptr() != src.data_ptr() and \
                    _overlap(t, src):
                raise ValueError(f"{name} overlaps its input without being "
                                 f"it: in place or apart")
    scalars = [_scalar("scale", scale, device), 0, _scalar("bc1", bc1, device),
               _scalar("bc2", bc2, device)]
    lr_value = 0.0
    if isinstance(lr, torch.Tensor):
        scalars[1] = _scalar("lr", lr, device)
    else:
        lr_value = float(lr)
    consts = [lr_value, b1, 1 - b1, b2, 1 - b2, eps, weight_decay]
    sms = _sm_count(device.index if device.index is not None
                    else torch.cuda.current_device())
    stream = torch.cuda.current_stream(device).cuda_stream
    for group in _groups(n):
        starts = plan_blocks([params[i].numel() for i in group], sms)
        values = []
        for i, b0 in zip(group, starts):
            ptrs = [t.data_ptr() for t in (grads[i], params[i], m[i], v[i],
                                           params_out[i], m_out[i],
                                           v_out[i])]
            flags = (
                (_GRAD_BF16 if grads[i].dtype == torch.bfloat16 else 0)
                | (_PARAM_BF16 if params[i].dtype == torch.bfloat16 else 0)
                | (_ALIGNED if all(x % 16 == 0 for x in ptrs) else 0))
            values += ptrs + [params[i].numel(), b0, flags]
        values += _NO_LEAF * (MAX_LEAVES - len(group))
        desc = _UPDATE.pack(*values, *scalars, *consts, len(group),
                            starts[-1], 0)
        with torch.cuda.device(device):
            err = _library().adamw_apply_launch(desc, stream)
        if err != 0:
            raise RuntimeError(f"adamw_apply launch failed: CUDA error {err}")
        COUNTS["adamw_apply"] += 1


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two contiguous tensors' bytes overlap."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.nbytes and b0 < a0 + a.nbytes
