"""Public ops over the hand-written kernels (the port of the reference's
`kernels/ops.py`, plus the optimizer's).

Each op picks by device: a CUDA tensor launches the hand-written kernel
— there is no fallback — a CPU tensor takes the plain version in
`ref.py`, a meta tensor (the dry run's) the kernel's opaque operator in
`meta.py`, and any other device raises.

  tier_attention          paged decode attention over one tier
                          (`paged_attention.paged_attention`).
  tiered_paged_attention  runs it once per tier and merges the two
                          partials exactly (log-sum-exp), the paper's
                          concurrent HBM/DRAM reads of Eq. (2): on the
                          card, with the host tier in pinned host
                          memory, its launch runs on a side stream
                          beside the HBM-tier launch.
  shard_paged_attention   the same over a rank's block of each tier's
                          slots (the `pages` rule), the partials of
                          every rank merged exactly.
  flash_attention         whole-sequence (prefill) attention, public
                          layout [B, S, H, D], GQA K/V un-repeated
                          (`flash_attention.flash_attention`); when a
                          gradient is asked for, through
                          `flash_attention.FlashAttention`, whose
                          backward is the hand-written backward kernel.
  copy_rows               row copies into, out of and between pools,
                          up to four (dst, src) pairs in one launch,
                          either side one pool or a `Split` of two (the
                          two tiers), on the card or in pinned host
                          memory (`page_copy.page_copy`): every pool
                          write and gather of the port.
  grad_sumsq              each gradient leaf's f32 sum of squares, one
                          launch for the whole tree
                          (`adamw.grad_sumsq`).
  adamw_apply             the AdamW step of every leaf, one launch for
                          the whole tree, in place for a donated state
                          (`adamw.adamw_apply`).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels import adamw as _adamw
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import meta, ref
from repro_torch.kernels.page_copy import Split, index_device, page_copy
from repro_torch.kernels.paged_attention import paged_attention


def tier_attention(q, k_pool, v_pool, page_list, page_valid,
                   ticket_set: int = 0):
    """Partial attention over one tier -> (out, m, l, page_lse).
    `ticket_set`: see `paged_attention` (the card only)."""
    if q.device.type == "cuda":
        return paged_attention(q, k_pool, v_pool, page_list, page_valid,
                               ticket_set)
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pool, v_pool, page_list,
                                       page_valid)
    if q.device.type == "meta":
        return meta.paged_attention(q, k_pool, v_pool, page_list,
                                    page_valid)
    raise ValueError(f"tier_attention runs on cuda or cpu, not {q.device}")


def tier_partials(
    q: torch.Tensor,
    k_hbm: torch.Tensor, v_hbm: torch.Tensor,
    k_host: torch.Tensor, v_host: torch.Tensor,
    hbm_list: torch.Tensor, hbm_valid: torch.Tensor,
    host_list: torch.Tensor, host_valid: torch.Tensor,
):
    """Each tier's partial attention, (out, m, l, page_lse) of the HBM
    tier and of the host tier (`tier_attention`; q [B, KH, G, HD])."""
    if q.device.type == "cuda" and k_host.device.type == "cpu":
        # the host tier lies in pinned host memory (overlap mode): its
        # launch reads over the link for milliseconds, so it runs on a
        # side stream, after everything the current stream has queued
        # (this step's token write included); the merge waits on it.
        # Every tensor the side stream touches is also ordered by these
        # two waits, so none is reused early. With both tiers in HBM the
        # two launches take tens of microseconds, less than the stream
        # switches cost the host, and run one after the other below.
        main = torch.cuda.current_stream(q.device)
        side = side_stream(q.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            host = tier_attention(q, k_host, v_host, host_list, host_valid,
                                  ticket_set=1)
        hbm = tier_attention(q, k_hbm, v_hbm, hbm_list, hbm_valid)
        main.wait_stream(side)
        return hbm, host
    return (tier_attention(q, k_hbm, v_hbm, hbm_list, hbm_valid),
            tier_attention(q, k_host, v_host, host_list, host_valid))


def tiered_paged_attention(
    q: torch.Tensor,
    k_hbm: torch.Tensor, v_hbm: torch.Tensor,
    k_host: torch.Tensor, v_host: torch.Tensor,
    hbm_list: torch.Tensor, hbm_valid: torch.Tensor,
    host_list: torch.Tensor, host_valid: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode attention over the union of two tiers.

    q: [B, KH, G, HD]. Returns (out [B, KH, G, HD], importance [B, Nh+Ne])
    where importance is the per-page attention mass (summed over heads),
    ordered [hbm pages..., host pages...] matching the two lists.
    """
    (out_h, m_h, l_h, lse_h), (out_e, m_e, l_e, lse_e) = tier_partials(
        q, k_hbm, v_hbm, k_host, v_host, hbm_list, hbm_valid, host_list,
        host_valid)
    merged, total_lse = ref.merge_partials(
        [(out_h, m_h, l_h), (out_e, m_e, l_e)])
    imp_h = ref.page_importance(lse_h, total_lse)
    imp_e = ref.page_importance(lse_e, total_lse)
    return merged.to(q.dtype), torch.cat([imp_h, imp_e], dim=-1)


def shard_paged_attention(q, k_hbm, v_hbm, k_host, v_host, hbm_list,
                          hbm_valid, host_list, host_valid, gather):
    """Decode attention over two tiers whose slots are split over the
    ranks of an axis (the `pages` KV pool rule: sequence-parallel
    attention). The rank's pools and lists hold its slots; q holds every
    head. Each tier's partial (the paged kernel on the card), then the
    partials of every rank's tiers — `gather(t, 0)` concatenates the
    ranks' `t` in rank order — merged exactly by the log-sum-exp merge
    in one exchange (`ref.merge_over`, plain PyTorch: rank order, each
    rank's HBM tier first), so every rank holds the same output. Returns (out
    [B, KH, G, HD], (importance of the rank's HBM slots [B, n_h], of its
    host slots [B, n_e])): its pages' attention mass against the merged
    (global) LSE, summed over heads."""
    hbm, host = tier_partials(q, k_hbm, v_hbm, k_host, v_host, hbm_list,
                              hbm_valid, host_list, host_valid)
    merged, total_lse = ref.merge_over([hbm[:3], host[:3]], gather)
    return merged.to(q.dtype), (ref.page_importance(hbm[3], total_lse),
                                ref.page_importance(host[3], total_lse))


_SIDE: Dict[torch.device, "torch.cuda.Stream"] = {}


def side_stream(device: torch.device) -> "torch.cuda.Stream":
    """The stream of `device` the host-tier launches run on (made at
    first use; the serve engine makes it before any CUDA-graph
    capture)."""
    if device not in _SIDE:
        _SIDE[device] = torch.cuda.Stream(device)
    return _SIDE[device]


def copy_rows(*pairs, keep=None) -> None:
    """For each pair (dst, dst_index, src, src_index), dst[dst_index(r)]
    = src[src_index(r)] for every row r that `keep` keeps and whose
    indices are in range (see `page_copy`). Index tensors on the card
    launch the kernel once for all pairs — a pool may then be pinned
    host memory — CPU ones take the plain version and meta ones one
    opaque operator that prices the pairs' rows."""
    dev = index_device(pairs, keep)[0]
    if dev.type == "cuda":
        page_copy(*pairs, keep=keep)
    elif dev.type == "cpu":
        ref.page_copy_ref(*pairs, keep=keep)
    elif dev.type == "meta":
        dst, dst_index = pairs[0][:2]
        pool = dst.a if isinstance(dst, Split) else dst
        row = math.prod(pool.shape[len(dst_index):]) * pool.element_size()
        index = next(i for p in pairs for i in (*p[1], *p[3])
                     if i is not None)
        meta.page_copy(index, len(pairs), row)
    else:
        raise ValueError(f"copy_rows runs on cuda or cpu, not {dev}")


def flash_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Prefill attention, public layout: q [B, S, H, D], k/v
    [B, S, KH, D] with KH dividing H -> out [B, S, H, D]. On the card,
    with grad mode on and an input that requires grad, the kernel also
    keeps its LSE and its gradient is the backward kernel; otherwise it
    launches the forward alone. On the CPU autograd differentiates the
    plain version."""
    if q.device.type == "cuda":
        if torch.is_grad_enabled() and (
                q.requires_grad or k.requires_grad or v.requires_grad):
            return _flash.FlashAttention.apply(q, k, v, causal)
        return _flash.flash_attention(q, k, v, causal=causal)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal)
    if q.device.type == "meta":
        return meta.flash_attention(q, k, v, causal)
    raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")


def grad_sumsq(grads) -> torch.Tensor:
    """Each gradient's f32 sum of squares, [len(grads)] f32 on their
    device: on the card one launch of the kernel for every leaf."""
    dev = grads[0].device
    if dev.type == "cuda":
        return _adamw.grad_sumsq(grads)
    if dev.type == "cpu":
        return ref.grad_sumsq_ref(grads)
    if dev.type == "meta":
        return meta.grad_sumsq(list(grads))
    raise ValueError(f"grad_sumsq runs on cuda or cpu, not {dev}")


def adamw_apply(grads, params, m, v, params_out, m_out, v_out, **scalars
                ) -> None:
    """The AdamW step of every leaf (lists in tree order) into
    `params_out`, `m_out`, `v_out` — the inputs themselves for a donated
    state — given `scale`, `lr`, `bc1`, `bc2`, `b1`, `b2`, `eps`,
    `weight_decay` (`ref.adamw_apply_ref`): on the card one launch of
    the kernel for every leaf, bitwise the plain version's."""
    dev = params[0].device
    if dev.type == "cuda":
        _adamw.adamw_apply(grads, params, m, v, params_out, m_out, v_out,
                           **scalars)
    elif dev.type == "cpu":
        ref.adamw_apply_ref(grads, params, m, v, params_out, m_out, v_out,
                            **scalars)
    elif dev.type == "meta":
        meta.adamw_apply(*(list(x) for x in (grads, params, m, v,
                                             params_out, m_out, v_out)))
    else:
        raise ValueError(f"adamw_apply runs on cuda or cpu, not {dev}")
