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
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rms_norm, swiglu
from repro_torch.models.params import Param


def moe_schema(cfg: ModelConfig, L: int):
    d, f = cfg.d_model, cfg.d_ff
    E = cfg.moe.num_experts_padded
    s = {
        "moe_norm": Param((L, d), ("layers", "embed"), "ones"),
        "router": Param((L, d, cfg.moe.num_experts),
                        ("layers", "embed", None), fan_in_axes=(1,)),
        "we_gate": Param((L, E, d, f), ("layers", "experts", "embed", "mlp"),
                         fan_in_axes=(2,)),
        "we_up": Param((L, E, d, f), ("layers", "experts", "embed", "mlp"),
                       fan_in_axes=(2,)),
        "we_down": Param((L, E, f, d), ("layers", "experts", "mlp", "embed"),
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
    moe = cfg.moe
    G, s, _ = xg.shape
    E, k, E_pad = moe.num_experts, moe.top_k, moe.num_experts_padded
    C = capacity(cfg, s)
    logits = (xg @ router).float()
    if E_pad != E:
        logits = F.pad(logits, (0, E_pad - E), value=-1e30)
    probs = torch.softmax(logits, dim=-1)
    # top-k with ties to the lower index, as jax.lax.top_k orders them
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, gate_idx = gate_vals[..., :k], gate_idx[..., :k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    dispatch = torch.zeros((G, s, E_pad, C), dtype=torch.bool,
                           device=xg.device)
    combine = torch.zeros((G, s, E_pad, C), dtype=torch.float32,
                          device=xg.device)
    counts = torch.zeros((G, E_pad), dtype=torch.int64, device=xg.device)
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


def moe_ffn(x: torch.Tensor, lp, cfg: ModelConfig, *,
            group_size: Optional[int] = None) -> torch.Tensor:
    """x [B, S, d] -> [B, S, d] routed through the experts. The token
    stream is padded to a group multiple; padded rows route like
    tokens (consuming capacity of the last group) and are sliced away."""
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
    expert_in = torch.einsum("gsec,gsd->gecd", dispatch.to(cfg.dtype), xg)
    h = F.silu(torch.einsum("gecd,edf->gecf", expert_in, lp["we_gate"])) \
        * torch.einsum("gecd,edf->gecf", expert_in, lp["we_up"])
    expert_out = torch.einsum("gecf,efd->gecd", h, lp["we_down"])
    y = torch.einsum("gsec,gecd->gsd", combine.to(cfg.dtype), expert_out)
    if moe.shared_expert:
        y = y + swiglu(xg, lp["ws_gate"], lp["ws_up"], lp["ws_down"])
    return y.reshape(-1, d)[:T_real].reshape(B, S, d)


def moe_block(h, lp, cfg: ModelConfig, *, group_size=None):
    """Pre-norm residual MoE block."""
    x = rms_norm(h, lp["moe_norm"], cfg.norm_eps)
    return h + moe_ffn(x, lp, cfg, group_size=group_size)
