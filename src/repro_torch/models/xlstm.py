"""xLSTM blocks of the xlstm family (the port of the reference's
`models/xlstm.py`): mLSTM (matrix memory, chunk-parallel) and sLSTM
(scalar memory, sequential by construction), in plain PyTorch — the
reference computes them outside any Pallas kernel.

mLSTM uses exponential gating with the stabiliser recurrence
  m_t = max(logsig(f_t) + m_{t-1}, i_t),
which is max-plus associative, so the chunked form computes the same
m_t in parallel: m_i = max(m_prev + lf_i, max_{j<=i} w_ij) with
w_ij = lf_i - lf_j + i_j. Masked entries take the finite `NEG`, never
-inf: a difference of two masked values must stay finite (-inf - -inf
is NaN).

Precision follows the reference's JAX promotion: gates, memories and
the decode state are f32, the projections run in the model dtype, and
where an f32 tensor meets a model-dtype weight (the decode conv over
the f32 conv state, the gates' projections of its f32 output, the
sLSTM's recurrent products over its f32 hidden state) the weight is
widened to f32.

The family has no KV cache: its decode state is a fixed-size set of
recurrent tensors that every step reads whole, so the paper's
placement does not apply to it.

On a training rank of a mesh (`tp`, a `transformer.TensorParallel`,
and a rank-local config, `XLSTMConfig.shards`) a block computes its
heads. mLSTM: the sharding rules cut `w_up` (x | z), the conv and the
input dim of `wq`, `wk` and `wv`, none of which follows the heads, so
the rank gathers them over `model` and runs the up projection, the conv
and q, k, v whole; its heads of q, k, v and z enter the split region
there, the gates come from its heads' columns of `wi` and `wf` (cut by
heads), and the gated norm (a summed mean of squares) and the output
projection (a partial summed over `model`) run on its heads' block of
the inner width. sLSTM: its heads' block of d (the recurrent `r{z,i,f,
o}` cut by heads; the columns of `w{z,i,f,o}` and `b{z,i,f,o}`, the
weight of the gated norm and the rows of `w_out`, held whole, cut here
from the whole) runs the recurrence, the norm and the projection
likewise. Where the axis does not divide the heads (`TensorParallel.
recurrent_split` False: xlstm-125m's 4 at 8 ranks, whose mLSTM inner
width the rules still cut) either block gathers every leaf the rank
holds a block of and runs whole, alike on every model rank: nothing
enters the split region and nothing is summed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import causal_conv, rms_norm
from repro_torch.models.params import Param
from repro_torch.models.transformer import (
    data_whole, model_cols, model_enter, model_own, model_part, model_rows,
    model_sum, model_whole, split_rms_norm,
)

NEG = -1e30
#: an mLSTM rank's leaves gathered over `model` (cut across its heads),
#: and those it uses as its heads' block, by the dim the heads follow
MLSTM_WHOLE = ("w_up", "conv_w", "conv_b", "wq", "wk", "wv")
MLSTM_HEADS = {"wi": 1, "wf": 1, "bi": 0, "bf": 0, "y_norm": 0, "w_out": 0}
#: an sLSTM rank's heads' blocks, by dim
SLSTM_HEADS = {**{f"{w}{g}": 1 if w == "w" else 0
                  for w in "wrb" for g in "zifo"}, "y_norm": 0, "w_out": 0}


def _rank_leaves(lp, tp, at, whole, heads):
    """(a rank's weights of one block at path `at`, the `tp` the block
    runs with): FSDP blocks gathered over `data`, the leaves `whole`
    gathered over `model`, and of each leaf in `heads` its heads' block
    on the given dim; where the axis does not divide the heads, every
    leaf gathered whole and no `tp` (the block runs whole)."""
    lp = data_whole(lp, tp, at)
    if not tp.recurrent_split:
        return model_whole(lp, tp, at, tuple(lp)), None
    lp = model_whole(lp, tp, at, whole)
    return {**lp, **{k: model_own(lp, tp, at, k, d)
                     for k, d in heads.items()}}, tp


# ---------------------------------------------------------------------------
# Schemas
# ---------------------------------------------------------------------------

def mlstm_schema(cfg: ModelConfig, L: int):
    d = cfg.d_model
    inner = cfg.xlstm.expand * d
    H = cfg.num_heads
    W = cfg.xlstm.conv_width
    return {
        "norm": Param((L, d), ("layers", "embed"), "ones"),
        "w_up": Param((L, d, 2 * inner), ("layers", "embed", "mlp"),
                      fan_in_axes=(1,)),
        "conv_w": Param((L, W, inner), ("layers", None, "mlp"),
                        fan_in_axes=(1,)),
        "conv_b": Param((L, inner), ("layers", "mlp"), "zeros"),
        "wq": Param((L, inner, inner), ("layers", "mlp", None),
                    fan_in_axes=(1,)),
        "wk": Param((L, inner, inner), ("layers", "mlp", None),
                    fan_in_axes=(1,)),
        "wv": Param((L, inner, inner), ("layers", "mlp", None),
                    fan_in_axes=(1,)),
        "wi": Param((L, inner, H), ("layers", "mlp", "heads"),
                    fan_in_axes=(1,)),
        "wf": Param((L, inner, H), ("layers", "mlp", "heads"),
                    fan_in_axes=(1,)),
        "bi": Param((L, H), ("layers", "heads"), "zeros"),
        "bf": Param((L, H), ("layers", "heads"), "ones"),
        "y_norm": Param((L, inner), ("layers", "mlp"), "ones"),
        "w_out": Param((L, inner, d), ("layers", "mlp", "embed"),
                       fan_in_axes=(1,)),
    }


def slstm_schema(cfg: ModelConfig, L: int):
    d = cfg.d_model
    H = cfg.num_heads
    P = d // H
    gates = {}
    for g in ("z", "i", "f", "o"):
        gates[f"w{g}"] = Param((L, d, d), ("layers", "embed", None),
                               fan_in_axes=(1,))
        gates[f"r{g}"] = Param((L, H, P, P), ("layers", "heads", None, None),
                               fan_in_axes=(2,))
        gates[f"b{g}"] = Param((L, d), ("layers", "embed"),
                               "ones" if g == "f" else "zeros")
    return {
        "norm": Param((L, d), ("layers", "embed"), "ones"),
        **gates,
        "y_norm": Param((L, d), ("layers", "embed"), "ones"),
        "w_out": Param((L, d, d), ("layers", "embed", None),
                       fan_in_axes=(1,)),
    }


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in the promoted dtype of the two (JAX's rule: bf16 with
    f32 gives f32)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


# ---------------------------------------------------------------------------
# mLSTM: chunk-parallel forward / recurrent decode / sequential ref
# ---------------------------------------------------------------------------

def _mlstm_inputs(h, lp, cfg: ModelConfig, up=None):
    """(x path, z, inner, H, P): the up projection at the whole model's
    width (`up(x)`, the whole product, where given); inner, H and P what
    the block computes (a rank's share, `XLSTMConfig.shards`)."""
    inner = cfg.xlstm.expand * cfg.d_model // cfg.xlstm.shards
    H = cfg.num_heads
    x = rms_norm(h, lp["norm"], cfg.norm_eps)
    xpath, z = torch.chunk(x @ lp["w_up"] if up is None else up(x), 2,
                           dim=-1)
    return xpath, z, inner, H, inner // H


def _qkv_gates(xconv, xpath, lp, H, P, tp=None, proj=None):
    """(q, k scaled by P^-1/2, v, input gate, log forget gate), all f32:
    q, k and the gates from the conv path, v from the plain path. On a
    rank (`tp`): q, k, v of the whole width, then its heads' block; the
    gates from its heads' columns. `proj(x, name)`: the whole product of
    `x` and the leaf `name` (default `_mm(x, lp[name])`)."""
    B_, S, _ = xconv.shape
    if proj is None:
        def proj(x, name):
            return _mm(x, lp[name])

    def heads(t):
        return model_part(t, tp, -1).reshape(B_, S, H, P)
    q = heads(proj(xconv, "wq"))
    k = heads(proj(xconv, "wk"))
    v = heads(proj(xpath, "wv"))
    k = k.float() * (P ** -0.5)
    xg = model_enter(xconv, tp)
    ig = (_mm(xg, lp["wi"]) + lp["bi"]).float()
    fg = (_mm(xg, lp["wf"]) + lp["bf"]).float()
    return q.float(), k, v.float(), ig, F.logsigmoid(fg)


def _mlstm_out(y, z, lp, cfg: ModelConfig, tp=None):
    """y [..., inner] f32 gated by silu(z), normed in the model dtype,
    projected out to d (on a rank: the norm's mean of squares and the
    projection's partial summed over `model`)."""
    y = y * F.silu(z.float())
    y = split_rms_norm(y.to(cfg.dtype), lp["y_norm"], cfg.norm_eps, tp)
    return model_sum(y @ lp["w_out"], tp)


def mlstm_forward_layer(h, lp, cfg: ModelConfig, tp=None,
                        at: str = "mlstm"):
    """h [B,S,d] -> [B,S,d] (residual added by the caller). `tp`: a
    training rank's, with `lp` its blocks of the weights at path `at`
    (the module docstring)."""
    B_, S, d = h.shape
    if tp is not None:
        lp, tp = _rank_leaves(lp, tp, at, MLSTM_WHOLE, MLSTM_HEADS)
    xpath, z, inner, H, P = _mlstm_inputs(h, lp, cfg)
    xconv = F.silu(causal_conv(xpath, lp["conv_w"], lp["conv_b"]))
    q, k, v, ig, lf = _qkv_gates(xconv, xpath, lp, H, P, tp)
    z = model_part(z, tp, -1)

    Q = min(cfg.xlstm.chunk, S)
    S_real = S
    pad = (-S) % Q
    if pad:
        # padded steps: lf=0 (no decay), i=NEG (no input) -> state fixed
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        lf = F.pad(lf, (0, 0, 0, pad))
        ig = F.pad(ig, (0, 0, 0, pad), value=NEG)
        z = F.pad(z, (0, 0, 0, pad))
        S = S + pad
    nc = S // Q
    # per chunk, heads ahead of positions: [B,nc,H,Q,P] and [B,nc,H,Q]
    qc, kc, vc = (t.reshape(B_, nc, Q, H, P).permute(0, 1, 3, 2, 4)
                  for t in (q, k, v))
    igc = ig.reshape(B_, nc, Q, H).permute(0, 1, 3, 2)
    lfc = torch.cumsum(lf.reshape(B_, nc, Q, H), dim=2) \
        .permute(0, 1, 3, 2)                                # within-chunk

    ar = torch.arange(Q, device=h.device)
    tri = ar[:, None] >= ar[None, :]
    C = torch.zeros((B_, H, P, P), dtype=torch.float32, device=h.device)
    n = torch.zeros((B_, H, P), dtype=torch.float32, device=h.device)
    m = torch.full((B_, H), NEG, dtype=torch.float32, device=h.device)
    ys = []
    for c in range(nc):
        qb, kb, vb = qc[:, c], kc[:, c], vc[:, c]           # [B,H,Q,P]
        ib, lfb = igc[:, c], lfc[:, c]                      # [B,H,Q]
        # log weights w_ij = lf_i - lf_j + i_j  (i >= j)
        w = lfb[..., :, None] - lfb[..., None, :] + ib[..., None, :]
        w = torch.where(tri, w, NEG)                        # [B,H,Qi,Qj]
        c_i = m[..., None] + lfb                            # [B,H,Q]
        m_i = torch.maximum(w.amax(dim=-1), c_i)            # exact m_t
        p = torch.exp(w - m_i[..., None])
        carry_w = torch.exp(c_i - m_i)                      # [B,H,Q]

        qkp = (qb @ kb.transpose(-1, -2)) * p               # [B,H,Qi,Qj]
        num = qkp @ vb + (qb @ C) * carry_w[..., None]      # [B,H,Q,P]
        den = qkp.sum(-1) + (qb @ n[..., None])[..., 0] * carry_w
        ys.append(num / torch.maximum(den.abs(),
                                      torch.exp(-m_i))[..., None])

        # chunk-end state update
        lf_end = lfb[..., -1]                               # [B,H]
        a_j = lf_end[..., None] - lfb + ib                  # [B,H,Q]
        m_new = torch.maximum(m + lf_end, a_j.amax(dim=-1))
        scale_old = torch.exp(m + lf_end - m_new)
        pw = torch.exp(a_j - m_new[..., None])              # [B,H,Q]
        C = C * scale_old[..., None, None] \
            + (kb * pw[..., None]).transpose(-1, -2) @ vb
        n = n * scale_old[..., None] + (pw[..., None] * kb).sum(-2)
        m = m_new
    y = torch.stack(ys, dim=1)                              # [B,nc,H,Q,P]
    y = y.permute(0, 1, 3, 2, 4).reshape(B_, S, inner)
    return _mlstm_out(y, z, lp, cfg, tp)[:, :S_real]


def _mlstm_cell(C, n, m, qt, kt, vt, it, lft):
    """One step of the stabilised recurrence: (C, n, m, y [B,H,P])."""
    m_new = torch.maximum(lft + m, it)
    f_ = torch.exp(lft + m - m_new)
    i_ = torch.exp(it - m_new)
    C = C * f_[..., None, None] + i_[..., None, None] \
        * (kt[..., :, None] * vt[..., None, :])
    n = n * f_[..., None] + i_[..., None] * kt
    num = (qt[..., None, :] @ C)[..., 0, :]                 # [B,H,P]
    den = (n * qt).sum(-1)
    y = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return C, n, m_new, y


def mlstm_forward_layer_ref(h, lp, cfg: ModelConfig):
    """Sequential oracle."""
    B_, S, d = h.shape
    xpath, z, inner, H, P = _mlstm_inputs(h, lp, cfg)
    xconv = F.silu(causal_conv(xpath, lp["conv_w"], lp["conv_b"]))
    q, k, v, ig, lf = _qkv_gates(xconv, xpath, lp, H, P)
    C = torch.zeros((B_, H, P, P), dtype=torch.float32, device=h.device)
    n = torch.zeros((B_, H, P), dtype=torch.float32, device=h.device)
    m = torch.full((B_, H), NEG, dtype=torch.float32, device=h.device)
    ys = []
    for t in range(S):
        C, n, m, y = _mlstm_cell(C, n, m, q[:, t], k[:, t], v[:, t],
                                 ig[:, t], lf[:, t])
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(B_, S, inner)
    return _mlstm_out(y, z, lp, cfg)


def mlstm_decode_layer(h, lp, cfg: ModelConfig, state, tp=None,
                       at: str = "mlstm"):
    """h [B,d]; state = (C [B,H,P,P], n [B,H,P], m [B,H],
    conv [B,W-1,inner]), all f32. Returns (out [B,d], new state). `tp`:
    a serving rank's (its serve-mode shards at path `at`, `cfg`
    rank-local): where the axis divides the heads, the up projection's
    block of columns gathered over `model` as a product
    (`model_cols`), the conv run whole (its leaves gathered; the conv
    state whole on every model rank), q, k and v as the rank's block of
    their input rows times its rows of `wq`, `wk`, `wv`, summed over
    `model` (`model_rows`), then its heads on its block of C, n and m,
    the gated norm and the output projection summed over `model`;
    otherwise every leaf gathered and the block run whole."""
    C, n, m, conv_state = state
    if tp is not None:
        lp, tp = _rank_leaves(lp, tp, at, ("conv_w", "conv_b"),
                              MLSTM_HEADS)
    xpath, z, inner, H, P = _mlstm_inputs(
        h[:, None], lp, cfg, lambda x: model_cols(x, lp, tp, at, "w_up"))
    # causal conv over [conv_state ; xpath], in f32 (the state's dtype)
    hist = torch.cat([conv_state, xpath.float()], dim=1)
    xconv = F.silu(torch.einsum("bwc,wc->bc", hist, lp["conv_w"].float())
                   + lp["conv_b"].float())
    q, k, v, ig, lf = _qkv_gates(
        xconv[:, None], xpath, lp, H, P, tp,
        lambda x, name: model_rows(x, lp, tp, at, name, _mm))
    C, n, m, y = _mlstm_cell(C, n, m, q[:, 0], k[:, 0], v[:, 0], ig[:, 0],
                             lf[:, 0])
    out = _mlstm_out(y.reshape(h.shape[0], inner),
                     model_part(z, tp, -1)[:, 0], lp, cfg, tp)
    return out, (C, n, m, hist[:, 1:])


# ---------------------------------------------------------------------------
# sLSTM (sequential by construction)
# ---------------------------------------------------------------------------

def _slstm_step(lp, cfg: ModelConfig, carry, xt):
    """carry: (c, n, m, hprev) each [B,H,P] f32; xt: [B,d] normed input.
    Returns (the new carry, h [B,H,P])."""
    c, n, m, hprev = carry
    H, P = _slstm_dims(cfg)
    B_ = xt.shape[0]

    def gate(name):
        wx = xt @ lp[f"w{name}"]
        # [H, B, P] @ [H, P, P]: each head's recurrent product
        rh = _mm(hprev.transpose(0, 1), lp[f"r{name}"]).transpose(0, 1)
        return (wx + rh.reshape(B_, H * P) + lp[f"b{name}"]).float() \
            .reshape(B_, H, P)

    zt = torch.tanh(gate("z"))
    it = gate("i")
    ft = F.logsigmoid(gate("f"))
    ot = torch.sigmoid(gate("o"))
    m_new = torch.maximum(ft + m, it)
    i_ = torch.exp(it - m_new)
    f_ = torch.exp(ft + m - m_new)
    c = f_ * c + i_ * zt
    n = f_ * n + i_
    hnew = ot * c / torch.clamp_min(n, 1.0)
    return (c, n, m_new, hnew), hnew


def _slstm_dims(cfg: ModelConfig):
    """(heads, head dim P) of what an sLSTM block computes (a rank's
    share of the heads: `XLSTMConfig.shards`)."""
    H = cfg.num_heads
    return H, cfg.d_model // (H * cfg.xlstm.shards)


def _slstm_out(y, lp, cfg: ModelConfig, tp=None):
    y = split_rms_norm(y.to(cfg.dtype), lp["y_norm"], cfg.norm_eps, tp)
    return model_sum(y @ lp["w_out"], tp)


def slstm_forward_layer(h, lp, cfg: ModelConfig, tp=None,
                        at: str = "slstm"):
    """h [B,S,d] -> [B,S,d]: the recurrence over time (the reference's
    `lax.scan`) as a Python loop. `tp`: a training rank's, with `lp` its
    blocks of the weights at path `at` (the module docstring)."""
    B_, S, d = h.shape
    H, P = _slstm_dims(cfg)
    if tp is not None:
        lp, tp = _rank_leaves(lp, tp, at, (), SLSTM_HEADS)
    x = model_enter(rms_norm(h, lp["norm"], cfg.norm_eps), tp)
    z0 = torch.zeros((B_, H, P), dtype=torch.float32, device=h.device)
    carry = (z0, z0, torch.full_like(z0, NEG), z0)
    ys = []
    for t in range(S):
        carry, y = _slstm_step(lp, cfg, carry, x[:, t])
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(B_, S, H * P)
    return _slstm_out(y, lp, cfg, tp)


def slstm_decode_layer(h, lp, cfg: ModelConfig, state, tp=None,
                       at: str = "slstm"):
    """h [B,d]; state = (c, n, m, h) [B,H,P] f32 each. Returns (out
    [B,d], new state). `tp`: a serving rank's, as the forward's: its
    heads' block of d on its block of the state where the axis divides
    the heads, else the block whole."""
    H, P = _slstm_dims(cfg)
    if tp is not None:
        lp, tp = _rank_leaves(lp, tp, at, (), SLSTM_HEADS)
    x = model_enter(rms_norm(h, lp["norm"], cfg.norm_eps), tp)
    state, y = _slstm_step(lp, cfg, state, x)
    return _slstm_out(y.reshape(h.shape[0], H * P), lp, cfg, tp), state
