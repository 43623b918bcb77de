"""Wrapper of the hand-written Hopper paged-attention kernel.

`paged_attention` has the signature and semantics of
`repro_torch.kernels.ref.paged_attention_ref` and launches the CUDA
kernel in `repro_torch/csrc/paged_attention.cu` on the current stream.
It takes CUDA tensors only, except for the two pools, which may also
lie in pinned host memory (the host tier of overlap mode): the kernel
then reads them in place over the link, through the device address
`cudaHostGetDevicePointer` gives (`host_memory.device_address`). A pool
in pageable host memory raises; no pool is ever copied to the card.
The CPU path is the plain version, chosen by `ops.tier_attention` from
the tensor's device.

Build: `kernels.build` compiles the source at first use (see there).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels.build import COUNTS, library
from repro_torch.kernels.host_memory import check_memory, device_address

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = library("paged_attention")
    fn = lib.paged_attention_launch
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = ([ptr] * 13 + [i32] * 7 + [i64] * 8
                   + [i32, i32, i32, ctypes.c_float, i32, ptr])
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(
        device_index).multi_processor_count


#: page stages in each warp's cp.async ring (`kRing` in the source)
RING = 3
#: shared memory one CTA may use, and one SM holds (H100), in bytes
CTA_SMEM = 232_448
SM_SMEM = 233_472


def smem_bytes(warps: int, G: int, HD: int, T: int, itemsize: int,
               per: int) -> int:
    """Shared memory of one CTA, as `smem_bytes` in the source lays it
    out: each warp's ring of K/V page stages in the pools' dtype, then
    q, the warps' accumulators and (m, l) in f32, then the compacted
    page list."""
    return (warps * RING * 2 * T * HD * itemsize
            + 4 * (G * HD + warps * G * HD + 2 * warps * G + 3 * per + 2))


def choose_splits(batch: int, kv_heads: int, n_pages: int, sm_count: int,
                  per_sm: int = 4, min_pages: int = 8) -> Tuple[int, int]:
    """(splits, pages_per_split): at most one wave of `per_sm` CTAs per
    SM — B*KH alone is 64 at full width, half the H100's SMs — with at
    least `min_pages` pages per split (two per warp, so that each
    warp's ring has a next page in flight) and no empty split."""
    want = max(1, per_sm * sm_count // max(batch * kv_heads, 1))
    per = max(-(-n_pages // want), min(min_pages, n_pages))
    return -(-n_pages // per), per


class Plan(NamedTuple):
    splits: int
    per: int
    warps: int


@functools.lru_cache(maxsize=256)
def launch_plan(B: int, KH: int, G: int, HD: int, T: int, N: int,
                itemsize: int, sm_count: int) -> Plan:
    """Warps per CTA (4, fewer only where four rings do not fit in a
    CTA's shared memory) and the split of the page range. Raises if one
    warp's ring does not fit."""
    for warps in (4, 3, 2, 1):
        if smem_bytes(warps, G, HD, T, itemsize, N) <= CTA_SMEM:
            break
    else:
        raise ValueError(f"pages of T={T} x HD={HD} x {itemsize} bytes: "
                         f"{RING} stages of K and V do not fit in "
                         f"{CTA_SMEM} bytes of shared memory")
    per_sm = max(1, min(4, SM_SMEM // (smem_bytes(
        warps, G, HD, T, itemsize, N) + 1024)))
    return Plan(*choose_splits(B, KH, N, sm_count, per_sm, 2 * warps),
                warps)


def scratch_layout(B: int, KH: int, G: int, HD: int, N: int,
                   splits: int) -> Tuple[Tuple[str, int, Tuple[int, ...]],
                                         ...]:
    """(name, offset, shape) of each f32 output and partial buffer in
    the one scratch allocation of a call, back to back."""
    shapes = (("m", (B, KH, G)), ("l", (B, KH, G)),
              ("lse", (B, KH, G, N)), ("part_m", (splits, B, KH, G)),
              ("part_l", (splits, B, KH, G)),
              ("part_acc", (splits, B, KH, G, HD)))
    out, off = [], 0
    for name, shape in shapes:
        out.append((name, off, shape))
        off += math.prod(shape)
    return tuple(out)


_TICKETS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


#: ticket sets made at once on a card: one per launch that may run
#: concurrently (`ops.tiered_paged_attention`'s two tiers)
TICKET_SETS = 2


def _tickets(device: torch.device, ticket_set: int, n: int) -> torch.Tensor:
    """The kernel's per-(b, kh) ticket counters, one set per
    `ticket_set` (launches that may run at once use different sets):
    zeroed once here, and left zero by every launch (the last CTA of
    each (b, kh) resets its counter), so CUDA-graph replays reuse them.
    Every set of a card is made at its first launch, so a graph
    captured later finds them all. Grown, never shrunk."""
    t = _TICKETS.get((device, ticket_set))
    if t is None or t.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("paged_attention: call it once outside CUDA-"
                               "graph capture first (its ticket counters "
                               "must outlive the graph)")
        for s in range(max(TICKET_SETS, ticket_set + 1)):
            old = _TICKETS.get((device, s))
            if old is None or old.numel() < n:
                _TICKETS[(device, s)] = torch.zeros(
                    max(n, 4096), dtype=torch.int32, device=device)
        t = _TICKETS[(device, ticket_set)]
    return t


def _check_pool(name, pool, B, T, KH, HD, dtype, device):
    if pool.device.type == "cpu":
        check_memory(name, pool)        # pinned host memory, or raise
    elif pool.device != device:
        raise ValueError(f"{name}: expected {device} or pinned host "
                         f"memory, got {pool.device}")
    if pool.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {pool.dtype}")
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
                    page_valid: torch.Tensor, ticket_set: int = 0):
    """Semantics identical to `ref.paged_attention_ref`, on the card.

    q: [B, KH, G, HD] contiguous (f32 or bf16); k_pool/v_pool:
    [B, P, T, KH, HD] of q's dtype, on q's card or in pinned host
    memory, any strides with a contiguous last dim; page_list/
    page_valid: [B, N] int32. Returns (out, m, l, page_lse) as the
    plain version does. Launches that may run concurrently (on two
    streams) pass different `ticket_set`s."""
    args, outputs = launch_args(q, k_pool, v_pool, page_list, page_valid,
                                ticket_set)
    err = _library().paged_attention_launch(*args)
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: CUDA error "
                           f"{err}")
    COUNTS["paged_attention"] += 1
    return outputs


def launch_args(q, k_pool, v_pool, page_list, page_valid,
                ticket_set: int = 0):
    """(the arguments of the library's `paged_attention_launch` on the
    current stream, the outputs (out, m, l, page_lse) it writes) for
    `paged_attention`'s inputs, checked as it documents them."""
    for name, pool in (("k_pool", k_pool), ("v_pool", v_pool)):
        # before any CUDA call: a pageable host pool is refused outright
        check_memory(name, pool)
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

    plan = launch_plan(B, KH, G, HD, T, N, q.element_size(),
                       _sm_count(q.device.index))
    layout = scratch_layout(B, KH, G, HD, N, plan.splits)
    _, end, shape = layout[-1]
    scratch = torch.empty(end + math.prod(shape), dtype=torch.float32,
                          device=q.device)
    m, l, lse, part_m, part_l, part_acc = (
        scratch[o:o + math.prod(sh)].view(sh) for _, o, sh in layout)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), device_address(k_pool), device_address(v_pool),
            page_list.data_ptr(), page_valid.data_ptr(), out.data_ptr(),
            m.data_ptr(), l.data_ptr(), lse.data_ptr(), part_m.data_ptr(),
            part_l.data_ptr(), part_acc.data_ptr(),
            _tickets(q.device, ticket_set, B * KH).data_ptr(),
            B, KH, G, HD, P, T, N, *k_pool.stride()[:4],
            *v_pool.stride()[:4], plan.splits, plan.per, plan.warps,
            HD ** -0.5, _DTYPE_CODE[q.dtype], stream)
    return args, (out, m, l, lse)
