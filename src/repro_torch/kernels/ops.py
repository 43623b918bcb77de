"""Public attention ops over the hand-written kernels (the port of the
reference's `kernels/ops.py`).

Each op picks by device: a CUDA tensor launches the hand-written kernel
— there is no fallback — a CPU tensor takes the plain version in
`ref.py`, and any other device raises.

  tier_attention          paged decode attention over one tier
                          (`paged_attention.paged_attention`).
  tiered_paged_attention  runs it once per tier and merges the two
                          partials exactly (log-sum-exp), the paper's
                          concurrent HBM/DRAM reads of Eq. (2).
  flash_attention         whole-sequence (prefill) attention, public
                          layout [B, S, H, D], GQA K/V un-repeated
                          (`flash_attention.flash_attention`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref
from repro_torch.kernels.paged_attention import paged_attention


def tier_attention(q, k_pool, v_pool, page_list, page_valid):
    """Partial attention over one tier -> (out, m, l, page_lse)."""
    if q.device.type == "cuda":
        return paged_attention(q, k_pool, v_pool, page_list, page_valid)
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pool, v_pool, page_list,
                                       page_valid)
    raise ValueError(f"tier_attention runs on cuda or cpu, not {q.device}")


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
    out_h, m_h, l_h, lse_h = tier_attention(q, k_hbm, v_hbm, hbm_list,
                                            hbm_valid)
    out_e, m_e, l_e, lse_e = tier_attention(q, k_host, v_host, host_list,
                                            host_valid)
    merged, total_lse = ref.merge_partials(
        [(out_h, m_h, l_h), (out_e, m_e, l_e)])
    imp_h = ref.page_importance(lse_h, total_lse)
    imp_e = ref.page_importance(lse_e, total_lse)
    return merged.to(q.dtype), torch.cat([imp_h, imp_e], dim=-1)


def flash_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Prefill attention, public layout: q [B, S, H, D], k/v
    [B, S, KH, D] with KH dividing H -> out [B, S, H, D]."""
    if q.device.type == "cuda":
        return _flash.flash_attention(q, k, v, causal=causal)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal)
    raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
