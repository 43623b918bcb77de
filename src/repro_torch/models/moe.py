"""Mixture-of-Experts FFN with capacity-based dispatch (the port of the
reference's `models/moe.py`, GShard style).

Tokens are routed in groups of `group_size`: softmax over the experts,
top-k, and per-expert capacity C = round_up(max(int(group * k / E *
capacity_factor), 4), 4); a token whose choice lands past its expert's
capacity is dropped for that choice (its residual path still carries
it). Positions inside an expert are assigned choice by choice (every
token's first choice before any second choice), in token order within
the group, as the reference's cumulative counts do. The padded experts
of `pad_experts_to` are masked out of routing but computed.

Dispatch and combine are the reference's dense products over a
materialized [G, s, E, C] mask (`torch.einsum`): the reference computes
them outside any Pallas kernel, so they are plain PyTorch here too.
Routing sees every row it is given — in serve, idle lanes and padding
slots included — so capacity drops are the reference's.

Expert parallelism (a meshed serve's or train step's rank, `tp`, a
`transformer.TensorParallel`): the router and `moe_norm` are whole on
every rank, so the model ranks compute the same logits and route alike;
a rank runs its own experts (`tp.experts`, a range of the padded ones)
over its slice of dispatch and combine, and its routed partial sum and
the shared expert's row-parallel partial leave through one
`model_sum`. Where the rank's rows are one block of a stream split over
`data` (`tp.rows`), routing runs over the whole stream's groups: the
logits of every data rank's rows are gathered (`tp.gather_rows`), so
positions and drops are those of the unsplit stream, and the rank
computes its own rows alone (a slot another rank's token holds meets a
zero row here and yields zero, which its combine never reads). When its
rows hold whole groups, it routes them locally, exactly, with no
collective.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rms_norm, swiglu
from repro_torch.models.params import Param

#: the weights of a moe block
MOE_LEAVES = ("moe_norm", "router", "we_gate", "we_up", "we_down",
              "ws_gate", "ws_up", "ws_down")


def moe_schema(cfg: ModelConfig, L: int):
    """The moe block's leaves; a rank-local config's expert leaves hold
    its share (`MoEConfig.local_experts`, `.expert_d_ff`)."""
    d, f = cfg.d_model, cfg.d_ff
    E = cfg.moe.local_experts or cfg.moe.num_experts_padded
    fe = cfg.moe.expert_d_ff or f
    s = {
        "moe_norm": Param((L, d), ("layers", "embed"), "ones"),
        "router": Param((L, d, cfg.moe.num_experts),
                        ("layers", "embed", None), fan_in_axes=(1,)),
        "we_gate": Param((L, E, d, fe),
                         ("layers", "experts", "embed", "mlp"),
                         fan_in_axes=(2,)),
        "we_up": Param((L, E, d, fe), ("layers", "experts", "embed", "mlp"),
                       fan_in_axes=(2,)),
        "we_down": Param((L, E, fe, d),
                         ("layers", "experts", "mlp", "embed"),
                         fan_in_axes=(2,)),
    }
    if cfg.moe.shared_expert:
        s["ws_gate"] = Param((L, d, f), ("layers", "embed", "mlp"),
                             fan_in_axes=(1,))
        s["ws_up"] = Param((L, d, f), ("layers", "embed", "mlp"),
                           fan_in_axes=(1,))
        s["ws_down"] = Param((L, f, d), ("layers", "mlp", "embed"),
                             fan_in_axes=(1,))
    return s


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def capacity(cfg: ModelConfig, group_size: int) -> int:
    """Per-expert slots of one routing group."""
    moe = cfg.moe
    return _round_up(max(int(group_size * moe.top_k / moe.num_experts
                             * moe.capacity_factor), 4), 4)


def route(xg: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """Capacity routing of grouped tokens xg [G, s, d]: (dispatch bool
    [G, s, E_pad, C], combine f32 [G, s, E_pad, C])."""
    return route_logits((xg @ router).float(), cfg)


def route_logits(logits: torch.Tensor, cfg: ModelConfig):
    """`route` from the grouped router logits [G, s, E] (f32)."""
    moe = cfg.moe
    G, s, _ = logits.shape
    E, k, E_pad = moe.num_experts, moe.top_k, moe.num_experts_padded
    C = capacity(cfg, s)
    if E_pad != E:
        logits = F.pad(logits, (0, E_pad - E), value=-1e30)
    probs = torch.softmax(logits, dim=-1)
    # top-k with ties to the lower index, as jax.lax.top_k orders them
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, gate_idx = gate_vals[..., :k], gate_idx[..., :k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    dev = logits.device
    dispatch = torch.zeros((G, s, E_pad, C), dtype=torch.bool, device=dev)
    combine = torch.zeros((G, s, E_pad, C), dtype=torch.float32,
                          device=dev)
    counts = torch.zeros((G, E_pad), dtype=torch.int64, device=dev)
    for j in range(k):
        onehot = F.one_hot(gate_idx[..., j], E_pad)            # [G, s, E]
        pos = torch.cumsum(onehot, dim=1) - 1 + counts[:, None, :]
        counts = counts + onehot.sum(dim=1)
        within = (pos < C) & (onehot > 0)
        oh_c = F.one_hot(pos.clamp(0, C - 1), C).float() \
            * within[..., None].float()                        # [G,s,E,C]
        dispatch |= oh_c > 0
        combine += oh_c * gate_vals[..., j][..., None, None] \
            * onehot[..., None].float()
    return dispatch, combine


def experts_ffn(xg, dispatch, combine, lp, cfg: ModelConfig):
    """The experts of `lp` over grouped tokens xg [G, s, d] by their
    (dispatch, combine) [G, s, E, C] (E: the experts `lp` holds) ->
    [G, s, d]."""
    expert_in = torch.einsum("gsec,gsd->gecd", dispatch.to(cfg.dtype), xg)
    h = F.silu(torch.einsum("gecd,edf->gecf", expert_in, lp["we_gate"])) \
        * torch.einsum("gecd,edf->gecf", expert_in, lp["we_up"])
    expert_out = torch.einsum("gecf,efd->gecd", h, lp["we_down"])
    return torch.einsum("gsec,gecd->gsd", combine.to(cfg.dtype), expert_out)


def moe_ffn(x: torch.Tensor, lp, cfg: ModelConfig, *,
            group_size: Optional[int] = None, tp=None) -> torch.Tensor:
    """x [B, S, d] -> [B, S, d] routed through the experts. The token
    stream is padded to a group multiple; padded rows route like
    tokens (consuming capacity of the last group) and are sliced away.
    `tp`: a rank's `TensorParallel` (see the module docstring); then
    `group_size` counts rows of the whole stream."""
    if tp is not None:
        return _rank_moe_ffn(x, lp, cfg, group_size, tp)
    moe = cfg.moe
    B, S, d = x.shape
    T_real = B * S
    xt = x.reshape(T_real, d)
    if group_size is None:
        group_size = min(T_real, moe.group_size)
    pad = (-T_real) % group_size
    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
    G = (T_real + pad) // group_size
    xg = xt.reshape(G, group_size, d)
    dispatch, combine = route(xg, lp["router"], cfg)
    y = experts_ffn(xg, dispatch, combine, lp, cfg)
    if moe.shared_expert:
        y = y + swiglu(xg, lp["ws_gate"], lp["ws_up"], lp["ws_down"])
    return y.reshape(-1, d)[:T_real].reshape(B, S, d)


def _rank_moe_ffn(x, lp, cfg: ModelConfig, group_size, tp):
    """`moe_ffn` on a rank: this rank's rows x [B, S, d] are block r of
    n of the routed stream (`tp.rows`, else the whole of it); its
    experts `tp.experts` (None: every expert, at its share of the hidden
    width when `tp.mlp_split`). Returns its rows' output, whole on
    `model`."""
    from repro_torch.models.transformer import model_enter, model_sum
    moe = cfg.moe
    B, S, d = x.shape
    T_real = B * S
    r, n = tp.rows or (0, 1)
    T_all = T_real * n
    if group_size is None:
        group_size = min(T_all, moe.group_size)
    pad = (-T_all) % group_size
    G = (T_all + pad) // group_size
    # the experts are split over `model` (by experts, or by their MLP
    # with the shared expert's); the router is whole, used on the rank's
    # experts alone: its gradient, and its input's, sum over the axis
    split = tp.experts is not None or tp.mlp_split
    xt = model_enter(x.reshape(T_real, d), tp, split)
    router = model_enter(lp["router"], tp, split)
    if n > 1 and T_real % group_size:
        # groups span data ranks: route the whole stream's logits, in
        # row order (padding rows route as the zero rows they are
        # unsplit), and keep the groups that hold the rank's rows
        lo = r * T_real
        g_lo, g_hi = lo // group_size, -(-(lo + T_real) // group_size)
        logits = F.pad(tp.gather_rows((xt @ router).float(), 0),
                       (0, 0, 0, pad))
        logits = logits.view(G, group_size, -1)[g_lo:g_hi]
        start = lo - g_lo * group_size  # the rank's rows in its groups
        xg = F.pad(xt, (0, 0, start, (g_hi - g_lo) * group_size - start
                        - T_real)).view(-1, group_size, d)
    else:
        # the rank's rows are whole groups (or all of them): routed here
        # as unsplit
        start = 0
        xg = F.pad(xt, (0, 0, 0, (-T_real) % group_size)).view(
            -1, group_size, d)
        logits = (xg @ router).float()
    dispatch, combine = route_logits(logits, cfg)
    if tp.experts is not None:
        e_lo, e_hi = tp.experts
        dispatch = dispatch[:, :, e_lo:e_hi]
        combine = combine[:, :, e_lo:e_hi]
    y = experts_ffn(xg, dispatch, combine, lp, cfg)
    if moe.shared_expert:
        y_sh = swiglu(xg, lp["ws_gate"], lp["ws_up"], lp["ws_down"])
        if tp.mlp_split:                # a row-parallel partial too
            y = y + y_sh
    y = model_sum(y.reshape(-1, d)[start:start + T_real], tp, split)
    if moe.shared_expert and not tp.mlp_split:
        # a shared expert whole on `model` joins after the sum
        y = y + y_sh.reshape(-1, d)[start:start + T_real]
    return y.reshape(B, S, d)


def moe_block(h, lp, cfg: ModelConfig, *, group_size=None, tp=None,
              at: str = "layers"):
    """Pre-norm residual MoE block. `tp`: a rank's (see the module
    docstring); a training rank gathers its FSDP blocks over `data`
    here (`at`: the weights' path in the parameter tree)."""
    from repro_torch.models.transformer import data_whole
    lp = data_whole(lp, tp, at, MOE_LEAVES)
    x = rms_norm(h, lp["moe_norm"], cfg.norm_eps)
    return h + moe_ffn(x, lp, cfg, group_size=group_size, tp=tp)
