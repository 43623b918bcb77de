"""Model facade (the port of the reference's `models/model.py`, dense
family only).

`Model(cfg)` exposes:
  schema() / init(seed_or_generator, device)   parameters
  cache_geometry(batch, max_context, ...)       paged-cache geometry
  prefill(params, tokens, geo)                  logits + PagedKVCache
  prefill_chunk(params, cache, tokens, start, n_valid)
  decode_step(params, cache, token, write_slot=..., ...)
The other families arrive with their slices of the port.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.kvcache.paged import (
    CacheGeometry, PagedKVCache, prefill_cache,
)
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import init_params

_LATER = ("family {fam!r} is not ported yet; the port's first slice "
          "covers 'dense' (moe and the other families follow in later "
          "slices, ROADMAP.md queue 1)")


class Model:
    def __init__(self, cfg: ModelConfig):
        if cfg.family != "dense":
            raise NotImplementedError(_LATER.format(fam=cfg.family))
        self.cfg = cfg

    def schema(self):
        return tfm.dense_schema(self.cfg)

    def init(self, seed=0, device=None):
        """Random parameters on `device` (default: the CUDA card), drawn
        from a `torch.Generator` seeded with `seed` (or the generator
        itself)."""
        dev = resolve_device(device)
        if isinstance(seed, torch.Generator):
            gen = seed
        else:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
        return init_params(self.schema(), gen, self.cfg.param_dtype,
                           device=dev)

    def cache_geometry(self, batch: int, max_context: int,
                       hbm_fraction: float = 0.25,
                       pad_to: int = 16) -> CacheGeometry:
        cfg = self.cfg
        return CacheGeometry.for_context(
            num_layers=len(cfg.attention_layer_ids()), batch=batch,
            context=max_context, kv_heads=cfg.kv_heads,
            head_dim=cfg.head_dim, page_tokens=cfg.kv_page_tokens,
            hbm_fraction=hbm_fraction, pad_to=pad_to, dtype=cfg.dtype)

    def prefill(self, params, tokens, geo: CacheGeometry):
        """Whole-prompt prefill: (last-position logits [B, V], cache)."""
        logits, (k, v) = tfm.dense_forward(params, self.cfg, tokens)
        cache = prefill_cache(geo, k, v, tokens.shape[1])
        return logits[:, -1], cache

    def prefill_chunk(self, params, cache: PagedKVCache, tokens, start,
                      n_valid, end: Optional[int] = None):
        """Consume a [B, C] prompt slice directly into the paged cache;
        see `transformer.dense_prefill_chunk`."""
        return tfm.dense_prefill_chunk(params, self.cfg, cache, tokens,
                                       start, n_valid, end)

    def decode_step(self, params, state: PagedKVCache, token, *,
                    write_slot: Optional[torch.Tensor] = None,
                    logical_page_mask: Optional[torch.Tensor] = None,
                    active: Optional[torch.Tensor] = None,
                    pool_ready=None):
        """One decode step; `write_slot` defaults to static placement.
        `pool_ready`: see `transformer.dense_decode_step`."""
        if write_slot is None:
            write_slot = default_write_slot(state)
        return tfm.dense_decode_step(params, self.cfg, state, token,
                                     write_slot,
                                     logical_page_mask=logical_page_mask,
                                     active=active, pool_ready=pool_ready)


def default_write_slot(cache: PagedKVCache) -> torch.Tensor:
    """Static-placement slot choice with no control plane: the token's
    logical page maps to HBM while room, else host."""
    B = cache.page_table.shape[1]
    T = cache.k_hbm.shape[3]
    logical = (cache.length // T).long()                       # [B]
    # the reference's gather clamps an out-of-range page index
    at = logical.clamp_max(cache.page_table.shape[2] - 1)
    existing = cache.page_table[:, torch.arange(B, device=logical.device),
                                at]                            # [L, B]
    slot = torch.where(existing >= 0, existing, logical[None, :])
    max_slot = cache.k_hbm.shape[2] + cache.k_host.shape[2] - 1
    return slot.clamp(0, max_slot).to(torch.int32)
