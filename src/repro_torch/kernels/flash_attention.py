"""Wrapper of the hand-written Hopper flash-attention kernel.

`flash_attention` has the semantics of
`repro_torch.kernels.ref.flash_attention_ref` (public layout
[B, S, H, D], K/V with KH heads, KH dividing H) and launches the CUDA
kernel in `repro_torch/csrc/flash_attention.cu` on the current stream.
It takes CUDA tensors only: the CPU path is the plain version, chosen
by `ops.flash_attention` from the tensor's device. Build: at first use,
by `kernels.build`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import COUNTS, library

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernel is instantiated for (160 in a tile padded to 192)
HEAD_DIMS = (16, 32, 64, 128, 160)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = library("flash_attention")
    fn = lib.flash_attention_launch
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = ([ptr] * 4 + [i32] * 6 + [i64] * 9
                   + [i32, ctypes.c_float, i32, ptr])
    fn.restype = ctypes.c_int
    return lib


def _check(name, t, shape, dtype, device):
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype} on {device}, got "
                         f"{t.dtype} on {t.device}")
    if t.dim() != 4 or tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    vec = 16 // t.element_size()
    if t.stride(-1) != 1 or any(st % vec for st in t.stride()[:3]) \
            or t.data_ptr() % 16:
        raise ValueError(f"{name}: the last dim must be contiguous and the "
                         f"other strides multiples of {vec} elements "
                         f"(16-byte vector loads), base 16-byte aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Semantics identical to `ref.flash_attention_ref`, on the card.

    q: [B, Sq, H, D]; k, v: [B, Sk, KH, D] with KH dividing H (query
    head h reads KV head h // (H // KH)); f32 or bf16, one dtype; any
    strides with a contiguous last dim. Returns out [B, Sq, H, D]
    (contiguous, q's dtype)."""
    if q.device.type != "cuda":
        raise ValueError("flash_attention launches a CUDA kernel; CPU "
                         "tensors take ref.flash_attention_ref")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtype {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, Sq, H, D], got {tuple(q.shape)}")
    B, Sq, H, D = q.shape
    if k.dim() != 4:
        raise ValueError(f"k must be [B, Sk, KH, D], got {tuple(k.shape)}")
    Sk, KH = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}: the kernel is "
                         f"not instantiated for it")
    if min(B, Sq, Sk, KH) < 1 or H % KH:
        raise ValueError(f"need B, Sq, Sk >= 1 and KH ({KH}) dividing H "
                         f"({H}), got q {tuple(q.shape)} k "
                         f"{tuple(k.shape)}")
    _check("q", q, (B, Sq, H, D), q.dtype, q.device)
    _check("k", k, (B, Sk, KH, D), q.dtype, q.device)
    _check("v", v, (B, Sk, KH, D), q.dtype, q.device)
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Sk, H, KH, D, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], int(causal), D ** -0.5, _DTYPE_CODE[q.dtype],
        stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error "
                           f"{err}")
    COUNTS["flash_attention"] += 1
    return out
