"""Wrapper of the hand-written Hopper paged-attention kernel.

`paged_attention` has the signature and semantics of
`repro_torch.kernels.ref.paged_attention_ref` and launches the CUDA
kernel in `repro_torch/csrc/paged_attention.cu` on the current stream.
It takes CUDA tensors only: the CPU path is the plain version, chosen
by `ops.tier_attention` from the tensor's device.

Build: `kernels.build` compiles the source at first use (see there).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels.build import COUNTS, library

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = library("paged_attention")
    fn = lib.paged_attention_launch
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = ([ptr] * 12 + [i32] * 7 + [i64] * 8
                   + [i32, i32, ctypes.c_float, i32, ptr])
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(
        device_index).multi_processor_count


def choose_splits(batch: int, kv_heads: int, n_pages: int,
                  sm_count: int) -> Tuple[int, int]:
    """(splits, pages_per_split): enough CTAs for ~4 per SM — B*KH alone
    is 64 at full width, half the H100's SMs — without empty splits."""
    want = max(1, -(-4 * sm_count // max(batch * kv_heads, 1)))
    splits = min(want, n_pages)
    per = -(-n_pages // splits)
    return -(-n_pages // per), per


def _check_pool(name, pool, B, T, KH, HD, dtype, device):
    if pool.device != device or pool.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype} on {device}, got "
                         f"{pool.dtype} on {pool.device}")
    if pool.dim() != 5 or pool.shape[0] != B or pool.shape[2:] != (T, KH, HD):
        raise ValueError(f"{name}: expected [B={B}, P, T={T}, KH={KH}, "
                         f"HD={HD}], got {tuple(pool.shape)}")
    vec = 16 // pool.element_size()
    if pool.stride(-1) != 1 or any(st % vec for st in pool.stride()[:4]) \
            or pool.data_ptr() % 16:
        raise ValueError(f"{name}: the last dim must be contiguous and the "
                         f"other strides multiples of {vec} elements "
                         f"(16-byte vector loads), base 16-byte aligned")


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, page_list: torch.Tensor,
                    page_valid: torch.Tensor):
    """Semantics identical to `ref.paged_attention_ref`, on the card.

    q: [B, KH, G, HD] contiguous (f32 or bf16); k_pool/v_pool:
    [B, P, T, KH, HD] of q's dtype, any strides with a contiguous last
    dim; page_list/page_valid: [B, N] int32. Returns (out, m, l,
    page_lse) as the plain version does."""
    if q.device.type != "cuda":
        raise ValueError("paged_attention launches a CUDA kernel; CPU "
                         "tensors take ref.paged_attention_ref")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtype {q.dtype}")
    if q.dim() != 4 or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous [B, KH, G, HD] tensor, "
                         f"got {tuple(q.shape)}")
    B, KH, G, HD = q.shape
    T = k_pool.shape[2]
    if HD % (16 // q.element_size()):
        raise ValueError(f"head_dim {HD} is not a whole number of "
                         f"16-byte vectors")
    if not 1 <= T <= 32:
        raise ValueError(f"page_tokens {T} outside 1..32")
    _check_pool("k_pool", k_pool, B, T, KH, HD, q.dtype, q.device)
    _check_pool("v_pool", v_pool, B, T, KH, HD, q.dtype, q.device)
    if k_pool.shape[1] != v_pool.shape[1]:
        raise ValueError("k_pool and v_pool differ in page count")
    N = page_list.shape[1]
    for name, t in (("page_list", page_list), ("page_valid", page_valid)):
        if t.dtype != torch.int32 or t.shape != (B, N) or \
                not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name}: expected contiguous int32 [B={B}, "
                             f"N={N}] on {q.device}")
    P = k_pool.shape[1]

    splits, per = choose_splits(B, KH, N, _sm_count(q.device.index))
    f32 = dict(device=q.device, dtype=torch.float32)
    out = torch.empty_like(q)
    m = torch.empty((B, KH, G), **f32)
    l = torch.empty((B, KH, G), **f32)
    lse = torch.empty((B, KH, G, N), **f32)
    part_m = torch.empty((splits, B, KH, G), **f32)
    part_l = torch.empty((splits, B, KH, G), **f32)
    part_acc = torch.empty((splits, B, KH, G, HD), **f32)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _library().paged_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_list.data_ptr(), page_valid.data_ptr(), out.data_ptr(),
        m.data_ptr(), l.data_ptr(), lse.data_ptr(), part_m.data_ptr(),
        part_l.data_ptr(), part_acc.data_ptr(),
        B, KH, G, HD, P, T, N, *k_pool.stride()[:4], *v_pool.stride()[:4],
        splits, per, HD ** -0.5, _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: CUDA error "
                           f"{err}")
    COUNTS["paged_attention"] += 1
    return out, m, l, lse
