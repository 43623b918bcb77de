"""Model facade (the port of the reference's `models/model.py`, dense and
moe families).

`Model(cfg)` exposes:
  schema() / init(seed_or_generator, device)   parameters
  cache_geometry(batch, max_context, ...)       paged-cache geometry
  prefill(params, tokens, geo)                  logits + PagedKVCache
  prefill_chunk(params, cache, tokens, start, n_valid)
  decode_step(params, cache, token, write_slot=..., ...)

Both families run one decoder (`transformer.decoder_*`) over a list of
(attention weights, FFN) blocks, one per cache layer. A moe model's
FFN is `moe.moe_block` on every layer (interleave 1) or a dense MLP and
a moe block alternating (interleave 2: the reference's superblocks,
cache layers ordered [dense0, moe0, dense1, moe1, ...]). Because its
routing groups every row it is given, a moe model runs every lane
through each decode step and prefill chunk (`all_lanes`), as the
reference does. The other families arrive with their slices of the
port.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.kvcache.paged import (
    CacheGeometry, PagedKVCache, prefill_cache,
)
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import Param, init_params

FAMILIES = ("dense", "moe")

_LATER = ("family {fam!r} is not ported yet; the port covers 'dense' and "
          "'moe' (the other families follow in later slices, ROADMAP.md "
          "queue 1)")


class Model:
    def __init__(self, cfg: ModelConfig):
        if cfg.family not in FAMILIES:
            raise NotImplementedError(_LATER.format(fam=cfg.family))
        if cfg.family == "moe" and cfg.moe.interleave not in (1, 2):
            raise ValueError("moe interleave 1 or 2 supported, got "
                             f"{cfg.moe.interleave}")
        self.cfg = cfg

    def schema(self):
        if self.cfg.family == "dense":
            return tfm.dense_schema(self.cfg)
        return self._moe_schema()

    def _moe_schema(self):
        cfg = self.cfg
        if cfg.moe.interleave == 1:
            layers = {**tfm.attn_schema(cfg, cfg.num_layers),
                      **moe_mod.moe_schema(cfg, cfg.num_layers)}
        else:
            nb = cfg.num_layers // 2
            layers = {
                "dense_attn": tfm.attn_schema(cfg, nb),
                "dense_mlp": tfm.mlp_schema(cfg, nb),
                "moe_attn": tfm.attn_schema(cfg, nb),
                "moe": moe_mod.moe_schema(cfg, nb),
            }
        s = {
            "embed": Param((cfg.vocab, cfg.d_model), "embed"),
            "final_norm": Param((cfg.d_model,), "ones"),
            "layers": layers,
        }
        if not cfg.tie_embeddings:
            s["unembed"] = Param((cfg.d_model, cfg.vocab), fan_in_axes=(0,))
        return s

    def blocks(self, params):
        """(attention weights, FFN) per cache layer, in cache order."""
        cfg = self.cfg
        if cfg.family == "dense":
            return tfm.dense_blocks(params, cfg)
        layers = params["layers"]

        def moe_ffn(lp):
            return lambda h, group_size=None: moe_mod.moe_block(
                h, lp, cfg, group_size=group_size)

        if cfg.moe.interleave == 1:
            out = []
            for l in range(cfg.num_layers):
                lp = {k: v[l] for k, v in layers.items()}
                out.append((lp, moe_ffn(lp)))
            return out
        out = []
        for i in range(cfg.num_layers // 2):
            def at(tree):
                return {k: v[i] for k, v in tree.items()}
            dense_mlp = at(layers["dense_mlp"])
            out.append((at(layers["dense_attn"]),
                        lambda h, group_size=None, lp=dense_mlp:
                        tfm.dense_mlp_block(h, lp, cfg)))
            out.append((at(layers["moe_attn"]), moe_ffn(at(layers["moe"]))))
        return out

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
        logits, (k, v) = tfm.decoder_forward(params, self.cfg, tokens,
                                             self.blocks(params))
        cache = prefill_cache(geo, k, v, tokens.shape[1])
        return logits[:, -1], cache

    def prefill_chunk(self, params, cache: PagedKVCache, tokens, start,
                      n_valid, end: Optional[int] = None):
        """Consume a [B, C] prompt slice directly into the paged cache;
        see `transformer.decoder_prefill_chunk`."""
        return tfm.decoder_prefill_chunk(
            params, self.cfg, cache, tokens, start, n_valid,
            self.blocks(params), end,
            all_lanes=self.cfg.family == "moe")

    def decode_step(self, params, state: PagedKVCache, token, *,
                    write_slot: Optional[torch.Tensor] = None,
                    logical_page_mask: Optional[torch.Tensor] = None,
                    active: Optional[torch.Tensor] = None,
                    pool_ready=None):
        """One decode step; `write_slot` defaults to static placement.
        `active`, `pool_ready`: see `transformer.decoder_decode_step`."""
        if write_slot is None:
            write_slot = default_write_slot(state)
        return tfm.decoder_decode_step(
            params, self.cfg, state, token, write_slot,
            self.blocks(params), logical_page_mask=logical_page_mask,
            active=active, pool_ready=pool_ready,
            all_lanes=self.cfg.family == "moe")


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
