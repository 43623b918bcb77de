"""Wrappers of the hand-written Hopper flash-attention kernels: the
forward and its gradient.

`flash_attention` has the semantics of
`repro_torch.kernels.ref.flash_attention_ref` (public layout
[B, S, H, D], K/V with KH heads, KH dividing H) and launches the CUDA
kernel in `repro_torch/csrc/flash_attention.cu` on the current stream;
with `return_lse` it also returns each row's log-sum-exp.
`flash_attention_bwd` launches `csrc/flash_attention_bwd.cu` (the
semantics of `ref.flash_attention_bwd_ref`), and `FlashAttention` ties
the two together as a `torch.autograd.Function`. They take CUDA tensors
only: the CPU path is the plain version, chosen by `ops.flash_attention`
from the tensor's device. Build: at first use, by `kernels.build`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import COUNTS, library

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernel is instantiated for (160 in a tile padded to 192)
HEAD_DIMS = (16, 32, 64, 128, 160)


_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = library("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = ([_PTR] * 5 + [_I32] * 6 + [_I64] * 9
                   + [_I32, ctypes.c_float, _I32, _PTR])
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def _bwd_library() -> ctypes.CDLL:
    lib = library("flash_attention_bwd")
    fn = lib.flash_attention_bwd_launch
    fn.argtypes = ([_PTR] * 10 + [_I32] * 6 + [_I64] * 9
                   + [_I32, ctypes.c_float, _I32, _PTR])
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


def _shape(q, k, v):
    """(B, Sq, Sk, H, KH, D) of a kernel call, after checking what the
    kernels take."""
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
    return B, Sq, Sk, H, KH, D


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, return_lse: bool = False):
    """Semantics identical to `ref.flash_attention_ref`, on the card.

    q: [B, Sq, H, D]; k, v: [B, Sk, KH, D] with KH dividing H (query
    head h reads KV head h // (H // KH)); f32 or bf16, one dtype; any
    strides with a contiguous last dim. Returns out [B, Sq, H, D]
    (contiguous, q's dtype), and with `return_lse` also (out, lse): lse
    f32 [B, H, Sq], each row's log-sum-exp of its scaled scores, which
    the backward recomputes the probabilities from. Without it the
    kernel writes no LSE (serving's path)."""
    B, Sq, Sk, H, KH, D = _shape(q, k, v)
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32,
                      device=q.device) if return_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        B, Sq, Sk, H, KH, D, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], int(causal), D ** -0.5, _DTYPE_CODE[q.dtype],
        stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error "
                           f"{err}")
    COUNTS["flash_attention"] += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal: bool = True):
    """Gradients (dq, dk, dv) of `flash_attention`, on the card: the
    semantics of `ref.flash_attention_bwd_ref`. q, k, v as the forward
    took them; out its output, lse its `return_lse` output, dout the
    gradient of out (any layout: made contiguous here). Returns dq
    [B, Sq, H, D] and dk, dv [B, Sk, KH, D], contiguous, in q's dtype
    (f32 sums inside). Three launches of `csrc/flash_attention_bwd.cu`,
    counted once; deterministic (no atomics)."""
    B, Sq, Sk, H, KH, D = _shape(q, k, v)
    _check("out", out, (B, Sq, H, D), q.dtype, q.device)
    dout = dout.contiguous()
    _check("dout", dout, (B, Sq, H, D), q.dtype, q.device)
    if not out.is_contiguous():
        raise ValueError("out must be contiguous (the forward's output)")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, Sq) \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"lse must be a contiguous f32 [B, H, Sq] = "
                         f"{(B, H, Sq)} on {q.device}")
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Sk, KH, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _bwd_library().flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), B, Sq, Sk, H, KH, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal),
        D ** -0.5, _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error "
                           f"{err}")
    COUNTS["flash_attention_bwd"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The flash kernel with its hand-written gradient: forward keeps
    (q, k, v, out, lse), backward is `flash_attention_bwd`. The caller
    (`ops.flash_attention`) applies it only when a gradient is asked
    for, so inference writes no LSE."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse,
                                         causal=ctx.causal)
        return dq, dk, dv, None
