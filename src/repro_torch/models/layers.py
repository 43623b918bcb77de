"""Layer ops of every family (the port of the reference's
`models/layers.py`, and the depthwise causal conv its `ssm.py` and
`xlstm.py` each define): plain functions on tensors, with the reference's
precision choices kept — `rms_norm` casts back to the model dtype
before the weight multiply, and attention logits are taken in the
input dtype, then f32. On the card, whole-sequence `attention` runs
the hand-written flash kernel instead (f32 scores from the inputs).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dtype) * w


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with the reference's precision: statistics in f32
    (population variance), cast back before the affine."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps)
    return y.to(dtype) * w + b


# --- RoPE -------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e6) -> torch.Tensor:
    """x: [..., S, H, D]; positions: broadcastable to [..., S]."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                  # [D/2]
    angles = positions[..., None].float() * freqs           # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]                   # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --- activations ------------------------------------------------------------

def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of the recurrent families' blocks.
    x [B,S,C]; w [W,C]; left-pad W-1."""
    W, S = w.shape[0], x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, W - 1, 0))
    out = xp[:, 0:S] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + S] * w[i]
    return out + b


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    return (torch.nn.functional.silu(g) * u) @ w_down


def gelu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu`'s default: the tanh approximation."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def gelu_mlp(x: torch.Tensor, w_in: torch.Tensor,
             w_out: torch.Tensor) -> torch.Tensor:
    return gelu(x @ w_in) @ w_out


# --- attention (full-sequence paths: prefill) -------------------------------

def repeat_kv(x: torch.Tensor, q_per_kv: int) -> torch.Tensor:
    """[B, S, KH, D] -> [B, S, KH*q_per_kv, D]."""
    if q_per_kv == 1:
        return x
    b, s, kh, d = x.shape
    return x[:, :, :, None, :].expand(b, s, kh, q_per_kv, d) \
        .reshape(b, s, kh * q_per_kv, d)


def prefix_chunk_attention(q, k, v, q_positions) -> torch.Tensor:
    """Causal attention of a query chunk against a prefix key buffer.

    q: [B, C, H, D]; k, v: [B, S, H, D] (GQA heads repeated);
    q_positions: [B, C] absolute position of each query. Key i is
    visible to the query at position p iff i <= p; keys past the
    written prefix contribute exact zeros.
    """
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = kpos[None, None, None, :] <= q_positions[:, None, :, None]
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def prefix_chunk_partial(q, k, v, q_positions, k_positions):
    """`prefix_chunk_attention` over a part of the prefix, as a partial
    for an exact log-sum-exp merge with the other parts'
    (`kernels.ref.merge_partials`): key i sits at absolute position
    k_positions[i] [S] and is visible to the query at position p iff
    k_positions[i] <= p. q: [B, C, H, D]; k, v: [B, S, H, D]. Returns
    (out [B, C, H, D] normalized over the part, m and l [B, C, H], the
    f32 max score and sum of exp(score - m)); a query that sees no key
    of the part gets out 0, m -1e30 and l 0, which the merge ignores."""
    if k.shape[1] == 0:
        B, C, H, _ = q.shape
        none = torch.zeros((B, C, H), dtype=torch.float32, device=q.device)
        return torch.zeros_like(q), none + NEG_INF, none
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    mask = k_positions[None, None, None, :] <= q_positions[:, None, :, None]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)
    m_safe = torch.where(m <= NEG_INF / 2, 0.0, m)
    p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
    l = p.sum(dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), v).float() \
        / l.clamp_min(1e-20).transpose(1, 2)[..., None]
    m = torch.where(l > 0, m_safe, NEG_INF)
    return out.to(q.dtype), m.transpose(1, 2), l.transpose(1, 2)


def naive_attention(q, k, v, *, causal: bool = True,
                    q_offset: int = 0) -> torch.Tensor:
    """Reference attention. q: [B,Sq,H,D], k/v: [B,Sk,H,D]."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        qpos = torch.arange(sq, device=q.device) + q_offset
        kpos = torch.arange(sk, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        logits = torch.where(mask[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def flash_attention_chunked(q, k, v, *, causal: bool = True,
                            k_chunk: int = 1024,
                            q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention over key chunks; never materializes the
    full [Sq, Sk] score matrix. q: [B, Sq, H, D]; k, v: [B, Sk, H, D]."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = d ** -0.5
    qbh = q.transpose(1, 2)                                  # [B,H,Sq,D]
    qpos = torch.arange(sq, device=q.device) + q_offset
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    for k0 in range(0, sk, k_chunk):
        k_blk = k[:, k0:k0 + k_chunk].transpose(1, 2)        # [B,H,kc,D]
        v_blk = v[:, k0:k0 + k_chunk].transpose(1, 2)
        s = torch.einsum("bhqd,bhkd->bhqk", qbh, k_blk).float() * scale
        if causal:
            kpos = torch.arange(k0, k0 + k_blk.shape[2], device=q.device)
            s = torch.where(kpos[None, :] <= qpos[:, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(v_blk.dtype), v_blk).float()
        m = m_new
    out = (acc / l.clamp_min(1e-20)[..., None]).to(q.dtype)
    return out.transpose(1, 2)


def attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
              flash_threshold: int = 2048) -> torch.Tensor:
    """Whole-sequence attention. q: [B, Sq, H, D]; k/v: [B, Sk, KH, D]
    with KH dividing H.

    On the card every size runs the hand-written flash kernel
    (`ops.flash_attention`, GQA K/V read un-repeated; queries aligned
    at key 0, so `q_offset` must be 0), and on the meta device (the dry
    run) its opaque operator. On the CPU the reference's
    dispatch: K/V repeated per query head, small sequences take the
    naive path, long ones the chunked one."""
    if q.device.type in ("cuda", "meta"):
        if q_offset:
            raise ValueError("the flash kernel aligns queries at key 0; "
                             f"q_offset={q_offset} is not supported")
        return ops.flash_attention(q, k, v, causal=causal)
    rep = q.shape[2] // k.shape[2]
    k, v = repeat_kv(k, rep), repeat_kv(v, rep)
    if q.shape[1] * k.shape[1] <= flash_threshold ** 2:
        return naive_attention(q, k, v, causal=causal, q_offset=q_offset)
    return flash_attention_chunked(q, k, v, causal=causal,
                                   q_offset=q_offset)
