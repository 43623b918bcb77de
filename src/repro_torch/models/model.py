"""Model facade (the port of the reference's `models/model.py`: every
family — dense, moe, vlm, encdec, and the recurrent hybrid/ssm and
xlstm).

`Model(cfg)` exposes:
  schema() / init(seed_or_generator, device)   parameters
  forward(params, tokens, extra=None)           logits at every position
  forward_hidden(params, tokens, extra=None, remat=True)
                                                final-norm hidden states
                                                (training's loss)
  cache_geometry(batch, max_context, ...)       paged-cache geometry
  prefill(params, tokens, geo, extra=None)      logits + decode state
  prefill_chunk(params, cache, tokens, start, n_valid)   dense, moe
  init_decode_state(batch, geo=None, device=None)
  decode_step(params, state, token, write_slot=..., ...)

Decode states:
  dense, moe, vlm   a `PagedKVCache`
  encdec            {"kv": the decoder's self-attention cache,
                     "enc": the encoder output [B, F, d]}
  hybrid            {"ssm": {"s": [L, B, H, N, P], "conv": [L, B, W-1, C]},
                     "kv": a cache over the shared-attention sites}
  ssm               {"ssm": ...} (no attention layers)
  xlstm             the stacked recurrent tensors (m_C, m_n, m_m, m_conv
                    of the mLSTM blocks, s_c, s_n, s_m, s_h of the sLSTM
                    blocks); no cache
Recurrent state is f32 in every model dtype.

The dense, moe and vlm families run one decoder (`transformer.decoder_*`)
over a list of (attention weights, FFN) blocks, one per cache layer;
vlm is the dense decoder over the patch embeddings
(`extra["patch_embeds"]` [B, num_embeddings, d]) followed by the token
embeddings, so its prompt length counts the patches. encdec is
whisper's encoder over `extra["frame_embeds"]` [B, F, d] and a decoder
whose self-attention is paged and whose cross-attention is dense over
the encoder output (`transformer.encdec_*`). A moe model's FFN is
`moe.moe_block` on every layer (interleave 1) or a dense MLP and a moe
block alternating (interleave 2: the reference's superblocks, cache
layers ordered [dense0, moe0, dense1, moe1, ...]). Because its routing
groups every row it is given, a moe model runs every lane through each
decode step (`all_lanes`) and prefill chunk, as the reference does; a
chunk's `end` must then bound every row's position, not the real rows'
alone.

hybrid (zamba2) is a stack of Mamba2 blocks (`models.ssm`) with ONE
weight-shared attention + MLP block after every `attn_every`-th of
them; those sites are the cache's only layers. Its whole-prompt
attention is the flash kernel on the card, its decode attention the
paged kernel, per site. ssm is the same stack with no site. xlstm
(`models.xlstm`) stacks mLSTM blocks with an sLSTM block every
`slstm_every`-th; its prefill replays one decode step per prompt token,
as the reference's does, and it launches no kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.kvcache.paged import (
    CacheGeometry, PagedKVCache, init_cache, prefill_cache,
    write_token_layer,
)
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tfm
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.models.params import Param, init_params, logical_axes

FAMILIES = ("dense", "moe", "vlm", "encdec", "hybrid", "ssm", "xlstm")

#: the xlstm decode state's keys, by block kind, in layer-state order
XLSTM_KEYS = {"mlstm": ("m_C", "m_n", "m_m", "m_conv"),
              "slstm": ("s_c", "s_n", "s_m", "s_h")}


class Model:
    def __init__(self, cfg: ModelConfig, tp=None):
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r}; the "
                             f"families are {', '.join(FAMILIES)}")
        if cfg.family == "moe" and cfg.moe.interleave not in (1, 2):
            raise ValueError("moe interleave 1 or 2 supported, got "
                             f"{cfg.moe.interleave}")
        self.cfg = cfg
        #: a meshed serve's or train step's rank: its
        #: `transformer.TensorParallel` over the rank-local `cfg` and the
        #: rank's weight shards (a serving rank's, every family:
        #: `TensorParallel.serving`, which the meshed engine binds for
        #: the dense and moe families; a train step's, every family, also
        #: binds its FSDP blocks over `data`); None: the whole model
        self.tp = tp

    def with_rows(self, rows) -> "Model":
        """A meshed rank's model whose rows are block `rows` = (index,
        size) of a stream split over `data`, or the whole of it (None):
        what a moe model's routing must see (`TensorParallel.rows`).
        Itself when its `tp` already says so."""
        if self.tp.rows == rows:
            return self
        return Model(self.cfg, tp=dataclasses.replace(self.tp, rows=rows))

    def schema(self):
        fam = self.cfg.family
        if fam in ("dense", "vlm"):
            return tfm.dense_schema(self.cfg)
        if fam == "encdec":
            return tfm.encdec_schema(self.cfg)
        if fam == "xlstm":
            return self._xlstm_schema()
        if fam in ("ssm", "hybrid"):
            return self._hybrid_schema()
        return self._moe_schema()

    def logical_axes(self):
        """Each parameter's logical axis names, in the schema's tree."""
        return logical_axes(self.schema())

    def _head(self, s):
        """`s` with the embedding, final norm and (untied) unembedding."""
        return {**tfm.head_schema(self.cfg), **s}

    def _xlstm_schema(self):
        cfg = self.cfg
        n_s = len(self._slstm_ids())
        return self._head({
            "mlstm": xlstm_mod.mlstm_schema(cfg, cfg.num_layers - n_s),
            "slstm": xlstm_mod.slstm_schema(cfg, n_s)})

    def _hybrid_schema(self):
        cfg = self.cfg
        s = {"mamba": ssm_mod.mamba2_schema(cfg, cfg.num_layers)}
        if cfg.attention_layer_ids():
            # ONE weight-shared attention block (zamba2) and its MLP
            s["shared_attn"] = {
                k: Param(p.shape[1:], p.axes[1:], p.init,
                         tuple(a - 1 for a in p.fan_in_axes))
                for k, p in {**tfm.attn_schema(cfg, 1),
                             **tfm.mlp_schema(cfg, 1)}.items()}
        return self._head(s)

    def _slstm_ids(self):
        k = self.cfg.xlstm.slstm_every
        return tuple(range(k - 1, self.cfg.num_layers, k)) if k else ()

    def _xlstm_layers(self):
        """(block kind, index in its stack) of each layer, in order."""
        slstm = set(self._slstm_ids())
        count = {"mlstm": 0, "slstm": 0}
        for l in range(self.cfg.num_layers):
            kind = "slstm" if l in slstm else "mlstm"
            yield kind, count[kind]
            count[kind] += 1

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
        return self._head({"layers": layers})

    def blocks(self, params):
        """(attention weights, FFN) per cache layer, in cache order (the
        dense, vlm and moe families)."""
        cfg = self.cfg
        if cfg.family in ("dense", "vlm"):
            return tfm.dense_blocks(params, cfg, self.tp)
        layers = params["layers"]
        tp = self.tp

        def moe_ffn(lp, at):
            return lambda h, group_size=None: moe_mod.moe_block(
                h, lp, cfg, group_size=group_size, tp=tp, at=at)

        if cfg.moe.interleave == 1:
            return [(lp, moe_ffn(lp, "layers"))
                    for lp in tfm.layers_of(layers)]
        out = []
        for da, dm, ma, mo in zip(*(tfm.layers_of(layers[k]) for k in (
                "dense_attn", "dense_mlp", "moe_attn", "moe"))):
            out.append((da, lambda h, group_size=None, lp=dm:
                        tfm.dense_mlp_block(h, lp, cfg, tp,
                                            "layers/dense_mlp")))
            out.append((ma, moe_ffn(mo, "layers/moe")))
        return out

    def attn_paths(self):
        """The path in the parameter tree of each block's attention
        weights, in `blocks` order (a training rank's FSDP blocks are
        named by path)."""
        cfg = self.cfg
        if cfg.family == "moe" and cfg.moe.interleave == 2:
            return ["layers/dense_attn", "layers/moe_attn"] * (
                cfg.num_layers // 2)
        return ["layers"] * cfg.num_layers

    def init(self, seed=0, device=None, keep=None):
        """Random parameters on `device` (default: the CUDA card), drawn
        from a `torch.Generator` seeded with `seed` (or the generator
        itself); `keep`: see `init_params`."""
        dev = resolve_device(device)
        if isinstance(seed, torch.Generator):
            gen = seed
        else:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
        return init_params(self.schema(), gen, self.cfg.param_dtype,
                           device=dev, keep=keep)

    def forward(self, params, tokens, extra=None):
        """Logits [B, S, V] at every position of `tokens` [B, S] (vlm:
        [B, num_embeddings + S, V], over `extra["patch_embeds"]` first;
        encdec: over `extra["frame_embeds"]`)."""
        cfg = self.cfg
        fam = cfg.family
        if fam == "encdec":
            return tfm.encdec_forward(params, cfg, tokens,
                                      extra["frame_embeds"].to(cfg.dtype))[0]
        if fam == "xlstm":
            return self._xlstm_forward(params, tokens)
        if fam in ("ssm", "hybrid"):
            return self._hybrid_forward(params, tokens)[0]
        return tfm.decoder_forward(params, cfg, tokens, self.blocks(params),
                                   input_embeds=self._vlm_embeds(
                                       params, tokens, extra),
                                   tp=self.tp)[0]

    def forward_hidden(self, params, tokens, extra=None, remat: bool = True):
        """The final-norm hidden states [B, S, d] before the unembedding
        (vlm: [B, num_embeddings + S, d], the patches first, as the
        reference), which the chunked loss unembeds a slice at a time.
        `remat` checkpoints each block (`transformer.remat_call`), as the
        reference's `jax.checkpoint`; the values are the same with it on
        or off. On a train step's rank (`self.tp` with its data-axis
        binding, every family) `params` are the rank's shards and the
        result is its rows' hidden states, whole on every model rank;
        each layer gathers its FSDP blocks inside its checkpointed
        block."""
        cfg = self.cfg
        fam = cfg.family
        if fam == "encdec":
            return tfm.encdec_forward(
                params, cfg, tokens, extra["frame_embeds"].to(cfg.dtype),
                return_hidden=True, remat=remat, tp=self.tp)
        if fam == "xlstm":
            return self._xlstm_forward(params, tokens, return_hidden=True,
                                       remat=remat)
        if fam in ("ssm", "hybrid"):
            return self._hybrid_forward(params, tokens, return_hidden=True,
                                        remat=remat)
        return tfm.decoder_forward(params, cfg, tokens, self.blocks(params),
                                   input_embeds=self._vlm_embeds(
                                       params, tokens, extra),
                                   return_hidden=True, remat=remat,
                                   tp=self.tp, attn_at=self.attn_paths())

    def _vlm_embeds(self, params, tokens, extra):
        """The vlm family's input: patch embeddings, then the tokens'
        (None for the other decoder families)."""
        cfg = self.cfg
        if cfg.family != "vlm":
            return None
        return torch.cat([extra["patch_embeds"].to(cfg.dtype),
                          tfm.embed_tokens(params, cfg, tokens, self.tp)],
                         dim=1)

    def _xlstm_forward(self, params, tokens, return_hidden: bool = False,
                       remat: bool = False):
        """Logits [B, S, V], or with `return_hidden` the final-norm
        hidden states (`remat` checkpoints each block). On a training
        rank (`self.tp`) each block runs its heads (`models.xlstm`)."""
        cfg, tp = self.cfg, self.tp
        h = tfm.embed_tokens(params, cfg, tokens, tp)
        stacks = {kind: tfm.layers_of(params[kind])
                  for kind in ("mlstm", "slstm")}
        for kind, i in self._xlstm_layers():
            fn = xlstm_mod.slstm_forward_layer if kind == "slstm" \
                else xlstm_mod.mlstm_forward_layer
            h = h + tfm.remat_call(remat, fn, h, stacks[kind][i], cfg, tp)
        h = tfm.final_norm(params, cfg, h, tp)
        return h if return_hidden else tfm.unembed(params, cfg, h, tp)

    def _hybrid_forward(self, params, tokens, collect_state: bool = False,
                        return_hidden: bool = False, remat: bool = False):
        """(logits [B, S, V], the sites' post-RoPE (k, v) stacked
        [n_sites, B, S, KH, HD] (None without sites), and with
        `collect_state` the Mamba2 state (s [L, B, H, N, P], conv
        [L, B, W-1, C]) after the sequence). The shared attention block
        runs after the Mamba2 block at each site. With `return_hidden`:
        the final-norm hidden states alone (`remat` checkpoints each
        Mamba2 block and each site). On a training rank (`self.tp`) each
        Mamba2 block runs its heads (`models.ssm`) and each site is the
        attention and MLP blocks' tensor parallelism over the shared
        weights, gathered over `data` at every site (their gradient
        reduce-scattered once a site, summed on the rank's block)."""
        cfg, tp = self.cfg, self.tp
        h = tfm.embed_tokens(params, cfg, tokens, tp)
        positions = torch.arange(h.shape[1], device=h.device)[None, :]
        sites = set(cfg.attention_layer_ids())
        ks, vs, ss, convs = [], [], [], []

        def site(h, sp):
            h, kv = tfm.full_attn_block(h, sp, cfg, positions, tp,
                                        "shared_attn")
            return tfm.dense_mlp_block(h, sp, cfg, tp, "shared_attn"), kv
        for l, lp in enumerate(tfm.layers_of(params["mamba"])):
            out = tfm.remat_call(remat, ssm_mod.mamba2_forward_layer, h, lp,
                                 cfg, collect_state, tp)
            if collect_state:
                out, (s, conv) = out
                ss.append(s)
                convs.append(conv)
            h = h + out
            if l in sites:
                h, (k, v) = tfm.remat_call(remat, site, h,
                                           params["shared_attn"])
                if not return_hidden:
                    ks.append(k)
                    vs.append(v)
        h = tfm.final_norm(params, cfg, h, tp)
        if return_hidden:
            return h
        kv = (torch.stack(ks), torch.stack(vs)) if ks else None
        state = (torch.stack(ss), torch.stack(convs)) if ss else None
        return tfm.unembed(params, cfg, h, tp), kv, state

    def cache_geometry(self, batch: int, max_context: int,
                       hbm_fraction: float = 0.25,
                       pad_to: int = 16) -> CacheGeometry:
        """The paged cache of the attention layers (one layer per hybrid
        site; a family with none gets a one-layer geometry, as the
        reference's, which only the policy state reads)."""
        cfg = self.cfg
        return CacheGeometry.for_context(
            num_layers=max(len(cfg.attention_layer_ids()), 1), batch=batch,
            context=max_context, kv_heads=cfg.kv_heads,
            head_dim=cfg.head_dim, page_tokens=cfg.kv_page_tokens,
            hbm_fraction=hbm_fraction, pad_to=pad_to, dtype=cfg.dtype)

    def prefill(self, params, tokens, geo: CacheGeometry, extra=None):
        """Whole-prompt prefill: (last-position logits [B, V], decode
        state). `extra`: {"patch_embeds"} (vlm) or {"frame_embeds"}
        (encdec), tensors on the tokens' device. hybrid needs prompts of
        at least conv_width - 1 tokens; xlstm replays one decode step
        per token; ssm (no attention sites) has no prefill, as in the
        reference."""
        cfg = self.cfg
        fam = cfg.family
        if fam == "encdec":
            logits, (k, v), enc = tfm.encdec_forward(
                params, cfg, tokens, extra["frame_embeds"], tp=self.tp)
            cache = prefill_cache(geo, k, v, tokens.shape[1], self._pool())
            return logits[:, -1], {"kv": cache, "enc": enc}
        if fam == "hybrid":
            logits, (k, v), (s, conv) = self._hybrid_forward(
                params, tokens, collect_state=True)
            cache = prefill_cache(geo, k, v, tokens.shape[1], self._pool())
            return logits[:, -1], {"ssm": {"s": s, "conv": conv},
                                   "kv": cache}
        if fam == "xlstm":
            state = self.init_decode_state(tokens.shape[0],
                                           device=tokens.device)
            logits = None
            for t in range(tokens.shape[1]):
                logits, state = self.decode_step(params, state, tokens[:, t])
            return logits, state
        if fam == "ssm":
            raise ValueError(f"prefill not supported for {fam}")
        embeds = self._vlm_embeds(params, tokens, extra)
        prompt = tokens.shape[1] + (
            cfg.frontend.num_embeddings if fam == "vlm" else 0)
        logits, (k, v) = tfm.decoder_forward(params, cfg, tokens,
                                             self.blocks(params),
                                             input_embeds=embeds, tp=self.tp)
        cache = prefill_cache(geo, k, v, prompt, self._pool())
        return logits[:, -1], cache

    def prefill_chunk(self, params, cache: PagedKVCache, tokens, start,
                      n_valid, end: Optional[int] = None):
        """Consume a [B, C] prompt slice directly into the paged cache;
        see `transformer.decoder_prefill_chunk` (`end`: the slots it
        reads, which must hold every real row's position, and every
        row's for moe). Dense and moe only, as in the reference."""
        fam = self.cfg.family
        if fam not in ("dense", "moe"):
            raise NotImplementedError(
                f"chunked prefill covers cache-backed families "
                f"(dense/moe); family {fam!r} needs prefill extras or "
                f"recurrent state")
        return tfm.decoder_prefill_chunk(
            params, self.cfg, cache, tokens, start, n_valid,
            self.blocks(params), end, tp=self.tp)

    def init_decode_state(self, batch: int,
                          geo: Optional[CacheGeometry] = None, device=None):
        """A fresh decode state for `batch` lanes on `device` (default:
        the CUDA card): an empty cache of `geo` (the cache-backed
        families; hybrid also the zero Mamba2 state, and that state alone
        without `geo`; a meshed rank's pools hold its slots under the
        `pages` rule), or the xlstm family's initial recurrent state."""
        fam = self.cfg.family
        device = resolve_device(device)
        if fam == "xlstm":
            return self._xlstm_state(batch, device)
        if fam in ("ssm", "hybrid"):
            state = {"ssm": self._mamba_state(batch, device)}
            if geo is not None and self.cfg.attention_layer_ids():
                state["kv"] = init_cache(geo, device, shard=self._pool())
            return state
        if geo is None:
            raise ValueError(f"family {fam!r} decodes over a paged cache; "
                             f"pass its geometry")
        return init_cache(geo, device, shard=self._pool())

    def _pool(self):
        """The rank's block of the pools' slots under the `pages` KV
        pool rule (`TensorParallel.pool`), or None: every slot."""
        return self.tp.pool if self.tp is not None else None

    def _mamba_state(self, batch, device):
        """The zero Mamba2 state: `s` of the heads the blocks compute (a
        rank's, `SSMConfig.shards`), `conv` over every channel (each
        rank runs the conv whole)."""
        cfg = self.cfg
        inner = cfg.ssm.expand * cfg.d_model
        _, H, P, N = ssm_mod._dims(cfg)
        f32 = dict(dtype=torch.float32, device=device)
        return {
            "s": torch.zeros((cfg.num_layers, batch, H, N, P), **f32),
            "conv": torch.zeros((cfg.num_layers, batch,
                                 cfg.ssm.conv_width - 1, inner + 2 * N),
                                **f32),
        }

    def _xlstm_state(self, batch, device):
        """The initial xlstm state: the memories of the heads the blocks
        compute (a rank's, `XLSTMConfig.shards`), the mLSTM conv state
        over every channel (each rank runs the conv whole)."""
        cfg = self.cfg
        inner = cfg.xlstm.expand * cfg.d_model
        H = cfg.num_heads
        P = inner // (H * cfg.xlstm.shards)
        Ps = cfg.d_model // (H * cfg.xlstm.shards)
        n_s = len(self._slstm_ids())
        n_m = cfg.num_layers - n_s
        f32 = dict(dtype=torch.float32, device=device)
        neg = xlstm_mod.NEG
        return {
            "m_C": torch.zeros((n_m, batch, H, P, P), **f32),
            "m_n": torch.zeros((n_m, batch, H, P), **f32),
            "m_m": torch.full((n_m, batch, H), neg, **f32),
            "m_conv": torch.zeros((n_m, batch, cfg.xlstm.conv_width - 1,
                                   inner), **f32),
            "s_c": torch.zeros((n_s, batch, H, Ps), **f32),
            "s_n": torch.zeros((n_s, batch, H, Ps), **f32),
            "s_m": torch.full((n_s, batch, H, Ps), neg, **f32),
            "s_h": torch.zeros((n_s, batch, H, Ps), **f32),
        }

    def decode_step(self, params, state, token, *,
                    write_slot: Optional[torch.Tensor] = None,
                    logical_page_mask: Optional[torch.Tensor] = None,
                    active: Optional[torch.Tensor] = None,
                    pool_ready=None):
        """One decode step over `state` (see the module docstring);
        `write_slot` defaults to static placement. `active`,
        `pool_ready`: see `transformer.decoder_decode_step` (encdec,
        which `serve` does not drive, takes `active` only; the recurrent
        families, which it does not drive either, take neither). A
        `logical_page_mask` on a family without attention layers raises
        ValueError, as in the reference. Returns (logits [B, V], the new
        state)."""
        fam = self.cfg.family
        if logical_page_mask is not None and \
                not self.cfg.attention_layer_ids():
            raise ValueError(
                f"logical_page_mask needs a paged KV cache; family {fam} "
                f"has no attention layers")
        if fam in ("ssm", "hybrid", "xlstm") and active is not None:
            raise ValueError(f"lane masking (`active`) is the serve loop's, "
                             f"and serve() does not drive family {fam!r}")
        if fam == "xlstm":
            return self._xlstm_decode_step(params, state, token)
        if fam in ("ssm", "hybrid"):
            return self._hybrid_decode_step(params, state, token, write_slot,
                                            logical_page_mask)
        if fam == "encdec":
            return self._encdec_decode_step(params, state, token, write_slot,
                                            logical_page_mask, active)
        if write_slot is None:
            write_slot = default_write_slot(state)
        return tfm.decoder_decode_step(
            params, self.cfg, state, token, write_slot,
            self.blocks(params), logical_page_mask=logical_page_mask,
            active=active, pool_ready=pool_ready,
            all_lanes=self.cfg.family == "moe", tp=self.tp)

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
            logical_page_mask=logical_page_mask, active=active, tp=self.tp)
        return logits, {"kv": cache, "enc": state["enc"]}

    def _xlstm_decode_step(self, params, state, token):
        """One token through every block's recurrent update; the state's
        stacks are rebuilt, the old ones left as they were."""
        cfg, tp = self.cfg, self.tp
        h = tfm.embed_tokens(params, cfg, token[:, None], tp)[:, 0]
        new = {k: [] for k in state}
        stacks = {kind: tfm.layers_of(params[kind])
                  for kind in ("mlstm", "slstm")}
        for kind, i in self._xlstm_layers():
            keys = XLSTM_KEYS[kind]
            fn = xlstm_mod.slstm_decode_layer if kind == "slstm" \
                else xlstm_mod.mlstm_decode_layer
            y, st = fn(h, stacks[kind][i], cfg,
                       tuple(state[k][i] for k in keys), tp)
            for k, t in zip(keys, st):
                new[k].append(t)
            h = h + y
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        logits = tfm.unembed(params, cfg, h, tp)
        return logits, {k: torch.stack(v) if v else state[k]
                        for k, v in new.items()}

    def _hybrid_decode_step(self, params, state, token, write_slot,
                            logical_page_mask=None):
        """Each Mamba2 block's recurrent update, and at each site the
        shared attention block over that site's layer of the paged cache
        (the paged kernel on the card, one launch per tier) and its MLP.
        state: {"ssm": {"s", "conv"}, "kv": PagedKVCache} ("kv" absent
        for the ssm family). On a serving rank (`self.tp`) each Mamba2
        block runs its heads or whole (`ssm.mamba2_decode_layer`), each
        site its heads, MLP hidden units and pools' slots as a dense
        decode layer does."""
        cfg, tp = self.cfg, self.tp
        split = tp is not None and tp.heads_split
        h = tfm.embed_tokens(params, cfg, token[:, None], tp)[:, 0]
        ssm_state = state["ssm"]
        cache: Optional[PagedKVCache] = state.get("kv")
        sites = cfg.attention_layer_ids() if cache is not None else ()
        if cache is not None:
            T = cache.k_hbm.shape[3]
            pos = cache.length
            offset = pos % T
            if write_slot is None:
                write_slot = default_write_slot(cache)
            cache = tfm.allocate_token_page(cache, write_slot)
            logical_page_mask = tfm.mask_write_visible(cache,
                                                       logical_page_mask)
            lists = cache.tier_lists(logical_page_mask=logical_page_mask)
        ss, convs, imps = [], [], []
        for l, lp in enumerate(tfm.layers_of(params["mamba"])):
            y, s, conv = ssm_mod.mamba2_decode_layer(
                h, lp, cfg, ssm_state["s"][l], ssm_state["conv"][l], tp)
            ss.append(s)
            convs.append(conv)
            h = h + y
            if l in sites:
                i = len(imps)
                sp = params["shared_attn"]
                hs = h[:, None]
                x = rms_norm(hs, sp["attn_norm"], cfg.norm_eps)
                q, k, v = tfm.attn_qkv(x, sp, cfg, pos[:, None])
                pools = (cache.k_hbm[i], cache.v_hbm[i], cache.k_host[i],
                         cache.v_host[i])
                o, imp = tfm.decode_attend(
                    q, k, v, pools, tuple(t[i] for t in lists),
                    write_slot[i], offset, cfg, tp)
                hs = hs + tfm.model_sum(tfm.attn_out(o, sp), tp, split)
                hs = tfm.dense_mlp_block(hs, sp, cfg, tp, "shared_attn")
                h = hs[:, 0]
                imps.append(imp)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        logits = tfm.unembed(params, cfg, h, tp)
        new = {"ssm": {"s": torch.stack(ss), "conv": torch.stack(convs)}}
        if cache is not None:
            imp = tfm.model_sum(torch.stack(imps), tp,
                                tp is not None and tp.imp_split)
            new["kv"] = tfm._update_cache_after_step(cache, imp, write_slot)
        return logits, new


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
    max_slot = cache.hbm_owner.shape[2] + cache.host_owner.shape[2] - 1
    return slot.clamp(0, max_slot).to(torch.int32)
