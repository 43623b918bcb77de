"""Mamba2 (SSD) blocks of the hybrid and ssm families (the port of the
reference's `models/ssm.py`), in plain PyTorch: the reference computes
all of it with array ops outside any Pallas kernel.

Prefill uses the chunked SSD algorithm (intra-chunk attention-like
products plus an inter-chunk state scan); decode is the O(1)
recurrent update; `mamba2_forward_layer_ref` is the sequential oracle
of both, kept for the tests.

Precision follows the reference's JAX promotion: the recurrence, the
gates and the decode state are f32, the projections and the prefill's
causal conv run in the model dtype, and where an f32 tensor meets a
model-dtype weight (the decode conv over the f32 conv state) the
weight is widened to f32, as JAX promotes bf16 with f32 to f32.

Every many-operand contraction of the chunked form is written as
explicit broadcasts and `matmul`s in a fixed order, so the largest
temporary is [B, nc, Q, Q, H] (the decay-weighted C.B scores), never a
product with the head dim P on top of it.

On a training rank of a mesh (`tp`, a `transformer.TensorParallel`,
and a rank-local config, `SSMConfig.shards`) a block computes its
heads. The sharding rules cut `w_in` (z | x | B | C | dt) and the conv
(x | B | C) into contiguous blocks that do not follow the heads, so the
rank gathers those three leaves over `model` and runs the input
projection and the conv whole; its heads' z, x and dt and the shared
B and C enter the split region there. `a_log`, `dt_bias`, `skip_d`,
`y_norm` and `w_out` are cut by heads: the scan runs on the rank's
heads, the gated norm over the inner width sums its mean of squares
over `model`, and the output projection's partial is summed over it.
Where the axis does not divide the heads (`TensorParallel.
recurrent_split` False: zamba2's 32 at 3 ranks) the rank gathers every
leaf it holds a block of and runs the block whole, as every model rank
does alike: nothing enters the split region and nothing is summed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import causal_conv, rms_norm
from repro_torch.models.params import Param
from repro_torch.models.transformer import (
    data_whole, model_cols, model_enter, model_own, model_part, model_sum,
    model_whole, split_rms_norm,
)

#: the Mamba2 leaves a rank gathers over `model` (their cut does not
#: follow the heads) and those it uses as its heads' block (dim 0)
WHOLE_LEAVES = ("w_in", "conv_w", "conv_b")
HEAD_LEAVES = ("a_log", "dt_bias", "skip_d", "y_norm", "w_out")


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------

def mamba2_schema(cfg: ModelConfig, L: int):
    d = cfg.d_model
    ssm = cfg.ssm
    inner = ssm.expand * d
    H = cfg.num_heads            # ssm heads
    N = ssm.state_dim
    conv_ch = inner + 2 * N
    return {
        "norm": Param((L, d), ("layers", "embed"), "ones"),
        # in_proj -> [z(inner), x(inner), B(N), C(N), dt(H)]
        "w_in": Param((L, d, 2 * inner + 2 * N + H),
                      ("layers", "embed", "mlp"), fan_in_axes=(1,)),
        "conv_w": Param((L, ssm.conv_width, conv_ch),
                        ("layers", None, "mlp"), fan_in_axes=(1,)),
        "conv_b": Param((L, conv_ch), ("layers", "mlp"), "zeros"),
        "a_log": Param((L, H), ("layers", "heads"), "zeros"),
        "dt_bias": Param((L, H), ("layers", "heads"), "zeros"),
        "skip_d": Param((L, H), ("layers", "heads"), "ones"),
        "y_norm": Param((L, inner), ("layers", "mlp"), "ones"),
        "w_out": Param((L, inner, d), ("layers", "mlp", "embed"),
                       fan_in_axes=(1,)),
    }


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------

def _dims(cfg: ModelConfig):
    """(inner width, heads, head dim P, state dim N) of what a block
    computes: the whole model's, or a rank's share of the heads and of
    the inner width (`SSMConfig.shards`)."""
    ssm = cfg.ssm
    inner = ssm.expand * cfg.d_model // ssm.shards
    return inner, cfg.num_heads, inner // cfg.num_heads, ssm.state_dim


def _split_proj(x, lp, cfg: ModelConfig, proj=None):
    """x [B,S,d] -> (z [B,S,inner], conv_in [B,S,inner+2N], dt [B,S,H]),
    at the whole model's widths (a rank's `w_in` gathered whole, or
    `proj`, the whole product, given)."""
    ssm = cfg.ssm
    inner = ssm.expand * cfg.d_model
    N = ssm.state_dim
    if proj is None:
        proj = x @ lp["w_in"]
    z, xin, Bc, Cc, dt = torch.split(
        proj, [inner, inner, N, N, cfg.num_heads * ssm.shards], dim=-1)
    return z, torch.cat([xin, Bc, Cc], dim=-1), dt


def _dt_a(dt_raw, lp):
    """(dt = softplus(dt_raw + dt_bias) in f32, a = -exp(a_log))."""
    dt = F.softplus(dt_raw.float() + lp["dt_bias"].float())
    return dt, -torch.exp(lp["a_log"].float())


def _gate_out(y, z, lp, cfg: ModelConfig, tp=None):
    """y [..., inner] f32 gated by silu(z), normed in the model dtype,
    projected out to d (on a rank, `tp`: its heads' block of the inner
    width, the norm's mean of squares and the projection's partial
    summed over `model`)."""
    y = y * F.silu(z.float())
    y = split_rms_norm(y.to(cfg.dtype), lp["y_norm"], cfg.norm_eps, tp)
    return model_sum(y @ lp["w_out"], tp)


# ---------------------------------------------------------------------------
# Chunked SSD forward (one layer)
# ---------------------------------------------------------------------------

def mamba2_forward_layer(h, lp, cfg: ModelConfig, return_state: bool = False,
                         tp=None, at: str = "mamba"):
    """h: [B, S, d] -> [B, S, d] (residual applied by the caller).

    return_state additionally yields the post-sequence recurrent state
    (s [B,H,N,P] f32, conv [B,W-1,conv_ch] f32) so prefill can hand off
    to the recurrent decode path; it needs S >= conv_width - 1 (the
    reference's slice of a shorter prompt wraps around and gives a
    conv state of the wrong size, so this raises ValueError). `tp`: a
    training rank's, with `lp` its blocks of the weights at path `at`
    of the parameter tree (the module docstring)."""
    ssm = cfg.ssm
    B_, S, d = h.shape
    inner, H, P, N = _dims(cfg)
    W = ssm.conv_width
    if tp is not None and not tp.recurrent_split:
        lp = model_whole(data_whole(lp, tp, at), tp, at, tuple(lp))
        tp = None                       # the block runs whole from here
    elif tp is not None:
        lp = model_whole(data_whole(lp, tp, at), tp, at, WHOLE_LEAVES)
        lp = {**lp, **{k: model_own(lp, tp, at, k, 0) for k in HEAD_LEAVES}}
    if return_state and S < W - 1:
        raise ValueError(
            f"prefill of a Mamba2 layer needs at least conv_width - 1 = "
            f"{W - 1} prompt tokens to fill its conv state, got {S}")
    Q = min(ssm.chunk, S)

    x = rms_norm(h, lp["norm"], cfg.norm_eps)
    z, conv_in, dt_raw = _split_proj(x, lp, cfg)
    conv_in_real, S_real = conv_in, S
    # pad to a chunk multiple; padded positions get dt=0 (identity decay,
    # zero input) so the recurrent state is untouched by padding
    pad = (-S) % Q
    if pad:
        conv_in = F.pad(conv_in, (0, 0, 0, pad))
        dt_raw = F.pad(dt_raw, (0, 0, 0, pad))
        z = F.pad(z, (0, 0, 0, pad))
        S = S + pad
    nc = S // Q

    conv = F.silu(causal_conv(conv_in, lp["conv_w"], lp["conv_b"]))
    xin, Bc, Cc = torch.split(conv, [inner * ssm.shards, N, N], dim=-1)
    if tp is not None:
        # the part run whole ends: the rank's heads, the shared B and C
        z, xin, dt_raw = (model_part(t, tp, -1) for t in (z, xin, dt_raw))
        Bc, Cc = model_enter(Bc, tp), model_enter(Cc, tp)

    dt, a = _dt_a(dt_raw, lp)                                   # [B,S,H]
    if pad:
        live = (torch.arange(S, device=h.device) < S_real)[None, :, None]
        dt = torch.where(live, dt, 0.0)
    da = dt * a                                                 # <= 0

    xh = xin.reshape(B_, S, H, P).float()
    xbar = xh * dt[..., None]

    # chunked views
    la = torch.cumsum(da.reshape(B_, nc, Q, H), dim=2)          # [B,nc,Q,H]
    Bq = Bc.float().reshape(B_, nc, Q, N)
    Cq = Cc.float().reshape(B_, nc, Q, N)
    # [B,nc,H,Q,P]: heads ahead of positions for the batched products
    xq = xbar.reshape(B_, nc, Q, H, P).permute(0, 1, 3, 2, 4)

    # ---- intra-chunk: Y[i] = sum_{j<=i} (C_i.B_j) exp(la_i-la_j) xbar_j
    cb = Cq @ Bq.transpose(-1, -2)                              # [B,nc,Q,Q]
    lh = la.permute(0, 1, 3, 2)                                 # [B,nc,H,Q]
    ar = torch.arange(Q, device=h.device)
    tri = ar[:, None] >= ar[None, :]
    # exp of the differences (exp(li) * exp(-lj) overflows), masked
    # before the exp: above the diagonal li - lj >= 0 grows with the
    # chunk's decay, and an exp that overflows there, masked after it,
    # gives its gradient inf * 0 = NaN (the reference's masking, whose
    # gradient is NaN at zamba2's full width); the values are the same
    decay = torch.exp(torch.where(tri, lh[..., :, None] - lh[..., None, :],
                                  float("-inf")))               # [B,nc,H,Q,Q]
    y_intra = (cb[:, :, None] * decay) @ xq                     # [B,nc,H,Q,P]

    # ---- chunk states: S_c = sum_j exp(la_end - la_j) B_j (x) xbar_j
    w_end = torch.exp(lh[..., -1:] - lh)                        # [B,nc,H,Q]
    s_chunk = Bq.transpose(-1, -2)[:, :, None] @ (
        w_end[..., None] * xq)                                  # [B,nc,H,N,P]

    # ---- inter-chunk scan
    chunk_decay = torch.exp(la[:, :, -1, :])                    # [B,nc,H]
    s = torch.zeros((B_, H, N, P), dtype=torch.float32, device=h.device)
    before = []
    for c in range(nc):
        before.append(s)
        s = s * chunk_decay[:, c, :, None, None] + s_chunk[:, c]
    s_before = torch.stack(before, dim=1)                       # [B,nc,H,N,P]

    y_inter = (Cq[:, :, None] @ s_before) * torch.exp(lh)[..., None]
    y = (y_intra + y_inter).permute(0, 1, 3, 2, 4).reshape(B_, S, H, P)
    y = y + xh * lp["skip_d"].float()[None, None, :, None]

    out = _gate_out(y.reshape(B_, S, inner), z, lp, cfg, tp)[:, :S_real]
    if return_state:
        conv_state = conv_in_real[:, S_real - (W - 1):, :].float()
        return out, (s, conv_state)
    return out


# ---------------------------------------------------------------------------
# Recurrent decode (one layer, one token)
# ---------------------------------------------------------------------------

def mamba2_decode_layer(h, lp, cfg: ModelConfig, state, conv_state,
                        tp=None, at: str = "mamba"):
    """h: [B, d]; state: [B,H,N,P] f32; conv_state: [B, W-1, conv_ch]
    f32. Returns (out [B, d], state, conv_state). `tp`: a serving rank's
    (a `TensorParallel` with its serve-mode blocks, `lp` its shards at
    path `at`, `cfg` rank-local): where the axis divides the heads, the
    input projection's block of columns the rank holds gathered over
    `model` as a product (`model_cols`), the conv run whole (its small
    leaves gathered; `conv_state` whole on every model rank), then the
    rank's heads on its block of `state` [B, H/size, N, P], the gated
    norm and the output projection summed over `model`; otherwise every
    leaf gathered and the block run whole on the whole state."""
    ssm = cfg.ssm
    B_, d = h.shape
    inner, H, P, N = _dims(cfg)
    if tp is not None and not tp.recurrent_split:
        lp = model_whole(lp, tp, at, tuple(lp))
        tp = None                       # the block runs whole from here
    elif tp is not None:
        lp = model_whole(lp, tp, at, ("conv_w", "conv_b"))
        lp = {**lp, **{k: model_own(lp, tp, at, k, 0) for k in HEAD_LEAVES}}

    x = rms_norm(h, lp["norm"], cfg.norm_eps)[:, None]
    z, conv_in, dt_raw = _split_proj(x, lp, cfg,
                                     model_cols(x, lp, tp, at, "w_in"))
    # causal conv over [conv_state ; conv_in], in f32 (the state's dtype)
    hist = torch.cat([conv_state, conv_in.float()], dim=1)     # [B,W,C]
    conv = F.silu(torch.einsum("bwc,wc->bc", hist, lp["conv_w"].float())
                  + lp["conv_b"].float())
    conv_state = hist[:, 1:]

    xin, Bc, Cc = torch.split(conv, [inner * ssm.shards, N, N], dim=-1)
    if tp is not None:
        # the rank's heads of the parts run whole
        z, xin, dt_raw = (model_part(t, tp, -1) for t in (z, xin, dt_raw))
    dt, a = _dt_a(dt_raw[:, 0], lp)                             # [B,H]
    dec = torch.exp(dt * a)

    xh = xin.reshape(B_, H, P).float()
    xbar = xh * dt[..., None]
    Bf, Cf = Bc.float(), Cc.float()

    state = (state * dec[:, :, None, None]
             + Bf[:, None, :, None] * xbar[:, :, None, :])     # [B,H,N,P]
    y = (Cf[:, None, None, :] @ state)[:, :, 0]                 # [B,H,P]
    y = y + xh * lp["skip_d"].float()[None, :, None]
    return _gate_out(y.reshape(B_, inner), z[:, 0], lp, cfg, tp), state, \
        conv_state


# ---------------------------------------------------------------------------
# Sequential reference (oracle for tests)
# ---------------------------------------------------------------------------

def mamba2_forward_layer_ref(h, lp, cfg: ModelConfig):
    """O(S) sequential recurrence — ground truth for the chunked path."""
    B_, S, d = h.shape
    ssm = cfg.ssm
    inner = ssm.expand * d
    H, N = cfg.num_heads, ssm.state_dim
    P = inner // H

    x = rms_norm(h, lp["norm"], cfg.norm_eps)
    z, conv_in, dt_raw = _split_proj(x, lp, cfg)
    conv = F.silu(causal_conv(conv_in, lp["conv_w"], lp["conv_b"]))
    xin, Bc, Cc = torch.split(conv, [inner, N, N], dim=-1)
    dt, a = _dt_a(dt_raw, lp)
    dec = torch.exp(dt * a)                                     # [B,S,H]
    xh = xin.reshape(B_, S, H, P).float()
    xbar = xh * dt[..., None]
    Bf, Cf = Bc.float(), Cc.float()

    s = torch.zeros((B_, H, N, P), dtype=torch.float32, device=h.device)
    ys = []
    for t in range(S):
        s = s * dec[:, t, :, None, None] \
            + Bf[:, t, None, :, None] * xbar[:, t, :, None, :]
        ys.append((Cf[:, t, None, None, :] @ s)[:, :, 0])
    y = torch.stack(ys, dim=1)                                  # [B,S,H,P]
    y = y + xh * lp["skip_d"].float()[None, None, :, None]
    return _gate_out(y.reshape(B_, S, inner), z, lp, cfg)
