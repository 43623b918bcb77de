"""Model facade (the port of the reference's `models/model.py`: the
dense, moe, vlm and encdec families).

`Model(cfg)` exposes:
  schema() / init(seed_or_generator, device)   parameters
  cache_geometry(batch, max_context, ...)       paged-cache geometry
  prefill(params, tokens, geo, extra=None)      logits + decode state
  prefill_chunk(params, cache, tokens, start, n_valid)   dense, moe
  decode_step(params, state, token, write_slot=..., ...)

The decode state is a `PagedKVCache`, or for encdec {"kv": the
decoder's self-attention cache, "enc": the encoder output [B, F, d]}.
The dense, moe and vlm families run one decoder
(`transformer.decoder_*`) over a list of (attention weights, FFN)
blocks, one per cache layer; vlm is the dense decoder over the patch
embeddings (`extra["patch_embeds"]` [B, num_embeddings, d]) followed by
the token embeddings, so its prompt length counts the patches. encdec
is whisper's encoder over `extra["frame_embeds"]` [B, F, d] and a
decoder whose self-attention is paged and whose cross-attention is
dense over the encoder output (`transformer.encdec_*`). A moe model's
FFN is `moe.moe_block` on every layer (interleave 1) or a dense MLP and
a moe block alternating (interleave 2: the reference's superblocks,
cache layers ordered [dense0, moe0, dense1, moe1, ...]). Because its
routing groups every row it is given, a moe model runs every lane
through each decode step and prefill chunk (`all_lanes`), as the
reference does. The recurrent families arrive with their slices of the
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

FAMILIES = ("dense", "moe", "vlm", "encdec")

_LATER = ("family {fam!r} is not ported yet; the port covers 'dense', "
          "'moe', 'vlm' and 'encdec' (the other families follow in later "
          "slices, ROADMAP.md queue 1)")


class Model:
    def __init__(self, cfg: ModelConfig):
        if cfg.family not in FAMILIES:
            raise NotImplementedError(_LATER.format(fam=cfg.family))
        if cfg.family == "moe" and cfg.moe.interleave not in (1, 2):
            raise ValueError("moe interleave 1 or 2 supported, got "
                             f"{cfg.moe.interleave}")
        self.cfg = cfg

    def schema(self):
        fam = self.cfg.family
        if fam in ("dense", "vlm"):
            return tfm.dense_schema(self.cfg)
        if fam == "encdec":
            return tfm.encdec_schema(self.cfg)
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
        """(attention weights, FFN) per cache layer, in cache order (the
        dense, vlm and moe families)."""
        cfg = self.cfg
        if cfg.family in ("dense", "vlm"):
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

    def prefill(self, params, tokens, geo: CacheGeometry, extra=None):
        """Whole-prompt prefill: (last-position logits [B, V], decode
        state). `extra`: {"patch_embeds"} (vlm) or {"frame_embeds"}
        (encdec), tensors on the tokens' device."""
        cfg = self.cfg
        if cfg.family == "encdec":
            logits, (k, v), enc = tfm.encdec_forward(
                params, cfg, tokens, extra["frame_embeds"])
            cache = prefill_cache(geo, k, v, tokens.shape[1])
            return logits[:, -1], {"kv": cache, "enc": enc}
        embeds, prompt = None, tokens.shape[1]
        if cfg.family == "vlm":
            patches = extra["patch_embeds"].to(cfg.dtype)
            embeds = torch.cat(
                [patches, tfm.embed_tokens(params, cfg, tokens)], dim=1)
            prompt += cfg.frontend.num_embeddings
        logits, (k, v) = tfm.decoder_forward(params, cfg, tokens,
                                             self.blocks(params),
                                             input_embeds=embeds)
        cache = prefill_cache(geo, k, v, prompt)
        return logits[:, -1], cache

    def prefill_chunk(self, params, cache: PagedKVCache, tokens, start,
                      n_valid, end: Optional[int] = None):
        """Consume a [B, C] prompt slice directly into the paged cache;
        see `transformer.decoder_prefill_chunk`. Dense and moe only, as
        in the reference."""
        fam = self.cfg.family
        if fam not in ("dense", "moe"):
            raise NotImplementedError(
                f"chunked prefill covers cache-backed families "
                f"(dense/moe); family {fam!r} needs prefill extras or "
                f"recurrent state")
        return tfm.decoder_prefill_chunk(
            params, self.cfg, cache, tokens, start, n_valid,
            self.blocks(params), end,
            all_lanes=self.cfg.family == "moe")

    def decode_step(self, params, state, token, *,
                    write_slot: Optional[torch.Tensor] = None,
                    logical_page_mask: Optional[torch.Tensor] = None,
                    active: Optional[torch.Tensor] = None,
                    pool_ready=None):
        """One decode step over `state` (a `PagedKVCache`, or encdec's
        {"kv", "enc"}); `write_slot` defaults to static placement.
        `active`, `pool_ready`: see `transformer.decoder_decode_step`
        (encdec, which `serve` does not drive, takes `active` only).
        Returns (logits [B, V], the new state)."""
        if self.cfg.family == "encdec":
            return self._encdec_decode_step(params, state, token, write_slot,
                                            logical_page_mask, active)
        if write_slot is None:
            write_slot = default_write_slot(state)
        return tfm.decoder_decode_step(
            params, self.cfg, state, token, write_slot,
            self.blocks(params), logical_page_mask=logical_page_mask,
            active=active, pool_ready=pool_ready,
            all_lanes=self.cfg.family == "moe")

    def _encdec_decode_step(self, params, state, token, write_slot,
                            logical_page_mask=None, active=None):
        """Decoder step: paged self-attention + dense cross-attention
        over the encoder output. state: {"kv": PagedKVCache, "enc":
        [B, F, d]}."""
        cache = state["kv"]
        if write_slot is None:
            write_slot = default_write_slot(cache)
        logits, cache = tfm.encdec_decode_step(
            params, self.cfg, cache, state["enc"], token, write_slot,
            logical_page_mask=logical_page_mask, active=active)
        return logits, {"kv": cache, "enc": state["enc"]}


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
