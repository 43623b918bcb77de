"""Plain PyTorch versions of the attention kernels and their jnp-side
companions (the port of the reference's `kernels/ref.py`).

`paged_attention_ref` defines the per-tier paged decode attention:

  * q:         [B, KH, G, HD]    one query token, grouped GQA layout
  * k_pool:    [B, P, T, KH, HD] physical page pool of ONE tier
  * v_pool:    [B, P, T, KH, HD]
  * page_list: [B, N] int32      pool slot of the n-th resident page;
                                 -1 = hole (nothing resident)
  * page_valid:[B, N] int32      valid tokens in that page (0..T)

  returns (out, m, l, page_lse):
  * out:       [B, KH, G, HD]    attention output over this tier,
                                 normalized by l (q's dtype)
  * m:         [B, KH, G]        max score (f32); -1e30 when empty
  * l:         [B, KH, G]        sum of exp(score - m) (f32)
  * page_lse:  [B, KH, G, N]     per-page log-sum-exp of scores (f32);
                                 -1e30 for invalid pages

Two tiers combine exactly with `merge_partials` (associative
log-sum-exp merge). RoPE is applied to K before it enters the cache,
so page order carries no positional meaning and causality reduces to
validity masking.

`flash_attention_ref` defines the whole-sequence (prefill) attention
of the flash kernel, `flash_attention_bwd_ref` its gradient.
`grad_sumsq_ref` and `adamw_apply_ref` are the AdamW kernels' plain
versions: the reference's `adamw_update` arithmetic, op for op.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.page_copy import Split

NEG_INF = -1e30

Partials = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def paged_attention_ref(q, k_pool, v_pool, page_list, page_valid) -> Partials:
    B, KH, G, HD = q.shape
    P, T = k_pool.shape[1], k_pool.shape[2]
    scale = HD ** -0.5

    slot = page_list.clamp(0, P - 1).long()                  # [B, N]
    bidx = torch.arange(B, device=q.device)[:, None]
    k = k_pool[bidx, slot]                                   # [B, N, T, KH, HD]
    v = v_pool[bidx, slot]

    s = torch.einsum("bkgd,bntkd->bkgnt", q.float(), k.float()) * scale
    tok = torch.arange(T, device=q.device)[None, None, :]
    valid = (page_list[:, :, None] >= 0) & (tok < page_valid[:, :, None])
    vmask = valid[:, None, None]                             # [B,1,1,N,T]
    s = torch.where(vmask, s, NEG_INF)

    m = s.amax(dim=(-2, -1))                                 # [B, KH, G]
    m_safe = torch.where(m <= NEG_INF / 2, 0.0, m)
    p = torch.exp(s - m_safe[..., None, None])
    p = torch.where(vmask, p, 0.0)
    l = p.sum(dim=(-2, -1))
    num = torch.einsum("bkgnt,bntkd->bkgd", p, v.float())
    out = num / l.clamp_min(1e-20)[..., None]

    page_lse = torch.where(
        valid.any(-1)[:, None, None],
        m_safe[..., None] + torch.log(p.sum(-1).clamp_min(1e-37)),
        NEG_INF)                                             # [B, KH, G, N]
    m = torch.where(l > 0, m_safe, NEG_INF)
    return out.to(q.dtype), m, l, page_lse


def pool_attention_ref(q, k_pool, v_pool, page_valid) -> Partials:
    """Gather-free tier attention over an identity page layout: slot p
    holds logical data iff page_valid[b, p] > 0. Same result as
    `paged_attention_ref` with page_list = arange(P) where valid."""
    B, KH, G, HD = q.shape
    P, T = k_pool.shape[1], k_pool.shape[2]
    scale = HD ** -0.5

    s = torch.einsum("bkgd,bptkd->bkgpt", q, k_pool).float() * scale
    tok = torch.arange(T, device=q.device)[None, None, :]
    valid = tok < page_valid[:, :, None]                     # [B, P, T]
    vmask = valid[:, None, None]
    s = torch.where(vmask, s, NEG_INF)

    m = s.amax(dim=(-2, -1))
    m_safe = torch.where(m <= NEG_INF / 2, 0.0, m)
    p = torch.exp(s - m_safe[..., None, None])
    p = torch.where(vmask, p, 0.0)
    l = p.sum(dim=(-2, -1))
    num = torch.einsum("bkgpt,bptkd->bkgd", p.to(q.dtype), v_pool)
    out = num.float() / l.clamp_min(1e-20)[..., None]

    page_lse = torch.where(
        valid.any(-1)[:, None, None],
        m_safe[..., None] + torch.log(p.sum(-1).clamp_min(1e-37)),
        NEG_INF)
    m = torch.where(l > 0, m_safe, NEG_INF)
    return out.to(q.dtype), m, l, page_lse


def merge_partials(parts) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-tier partial attentions exactly.

    parts: list of (out [**, HD], m [**], l [**]). Returns (out, lse)
    with out normalized over the union of tiers (f32).
    """
    m = torch.stack([p[1] for p in parts]).amax(dim=0)
    m_safe = torch.where(m <= NEG_INF / 2, 0.0, m)
    num = 0.0
    den = 0.0
    for out, mi, li in parts:
        corr = torch.exp(torch.where(li > 0, mi - m_safe, NEG_INF))
        num = num + out.float() * (li * corr)[..., None]
        den = den + li * corr
    merged = num / den.clamp_min(1e-20)[..., None]
    lse = m_safe + torch.log(den.clamp_min(1e-37))
    return merged, lse


def merge_over(parts, gather) -> Tuple[torch.Tensor, torch.Tensor]:
    """`merge_partials` of the partials every rank of an axis holds:
    this rank's `parts` packed into one f32 tensor (out, m and l on the
    last dim), `gather(t, 0)` concatenating every rank's in rank order,
    then one merge over all of them in that order, so every rank gets
    the same (out, lse). The exchange of sequence-parallel attention
    (the `pages` KV pool rule), plain PyTorch."""
    HD = parts[0][0].shape[-1]
    mine = torch.stack([torch.cat([out.float(), m[..., None], l[..., None]],
                                  dim=-1) for out, m, l in parts])
    return merge_partials([(p[..., :HD], p[..., HD], p[..., HD + 1])
                           for p in gather(mine, 0)])


def page_importance(page_lse: torch.Tensor,
                    total_lse: torch.Tensor) -> torch.Tensor:
    """Attention mass per page: sum over (KH, G) of exp(page_lse - lse).

    page_lse: [B, KH, G, N]; total_lse: [B, KH, G] -> [B, N] in [0, H].
    """
    mass = torch.exp(page_lse - total_lse[..., None])
    mass = torch.where(page_lse <= NEG_INF / 2, 0.0, mass)
    return mass.sum(dim=(1, 2))


def _flash_scores(q, k, causal, q_offset=0):
    """f32 scaled scores [B, H, Sq, Sk] of q against k/v's KH heads
    repeated per query head (query head h reads KV head h // (H // KH)),
    NEG_INF above the diagonal when causal; and k's repeat factor."""
    rep = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        kpos = torch.arange(sk, device=q.device)
        qpos = torch.arange(sq, device=q.device) + q_offset
        s = torch.where((kpos[None, :] <= qpos[:, None])[None, None], s,
                        NEG_INF)
    return s, rep


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        q_offset: int = 0, return_lse: bool = False):
    """Plain version of the prefill flash kernel. q: [B, Sq, H, D];
    k, v: [B, Sk, KH, D] with KH dividing H (query head h reads KV head
    h // (H // KH); KH == H is the reference's op). f32 scores and
    softmax, output in q's dtype; with `return_lse` also each row's
    log-sum-exp of its scaled scores, f32 [B, H, Sq]."""
    s, rep = _flash_scores(q, k, causal, q_offset)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.repeat_interleave(
        rep, dim=2).float()).to(q.dtype)
    return (out, torch.logsumexp(s, dim=-1)) if return_lse else out


def flash_attention_bwd_ref(q, k, v, out, dout, lse, causal: bool = True):
    """Plain version of the flash backward kernel: (dq, dk, dv) of
    `flash_attention_ref` by the closed formulas, in f32 from the given
    `out` and `lse` (f32 [B, H, Sq]), cast to q's dtype:
    P = exp(S - lse) (0 where masked), dV = P^T dout,
    dS = P (dout V^T - rowsum(dout * out)), dQ = dS K scale,
    dK = dS^T Q scale; dK and dV summed over each KV head's G query
    heads."""
    B, Sq, H, D = q.shape
    KH = k.shape[2]
    s, rep = _flash_scores(q, k, causal)
    p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - lse[..., None]))
    g = dout.float()
    vr = v.repeat_interleave(rep, dim=2).float()
    kr = k.repeat_interleave(rep, dim=2).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, g)
    dp = torch.einsum("bqhd,bkhd->bhqk", g, vr)
    delta = (g * out.float()).sum(-1).transpose(1, 2)        # [B, H, Sq]
    ds = p * (dp - delta[..., None])
    scale = D ** -0.5
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale

    def group(t):       # [B, Sk, H, D] -> [B, Sk, KH, D], summed over G
        return t.reshape(B, t.shape[1], KH, rep, D).sum(3)
    return dq.to(q.dtype), group(dk).to(q.dtype), group(dv).to(q.dtype)


def page_copy_ref(*pairs, keep=None) -> None:
    """Plain version of the row-copy kernel (`page_copy.page_copy`), in
    place: for each pair (dst, dst_index, src, src_index),
    dst[dst_index(r)] = src[src_index(r)] for every row r that `keep`
    (bool [M], optional) keeps and whose indices are all in range on
    both sides. Each index is a tuple with one int tensor [M] (or None:
    the row number) per leading dim; a side is a tensor or a `Split` of
    two pools."""
    given = [i for p in pairs for i in (*p[1], *p[3]) if i is not None]
    if keep is not None:
        given.append(keep)
    rows = given[0].shape[0]
    ar = torch.arange(rows, device=given[0].device)
    kept = torch.ones(rows, dtype=torch.bool, device=ar.device) \
        if keep is None else keep.bool()
    for dst, dst_index, src, src_index in pairs:
        d_parts = _ref_pools(dst, dst_index, ar)
        s_parts = _ref_pools(src, src_index, ar)
        ok = kept & torch.stack([part[2] for part in d_parts]).any(0) \
            & torch.stack([part[2] for part in s_parts]).any(0)
        vals = None
        for pool, cols, in_pool in s_parts:
            sel = ok & in_pool
            got = pool[tuple(c[sel] for c in cols)]
            if vals is None:
                vals = got.new_empty((rows,) + got.shape[1:])
            vals[sel] = got
        for pool, cols, in_pool in d_parts:
            sel = ok & in_pool
            nd = len(cols)
            pool[tuple(c[sel] for c in cols)] = \
                vals[sel].reshape((-1,) + pool.shape[nd:])


def _ref_pools(side, index, ar):
    """[(pool, per-dim row indices (long), rows in range of it)]: one
    entry for a tensor, two for a `Split`, whose rows fall in one pool
    or in neither."""
    cols = [ar if i is None else i.long() for i in index]

    def in_range(t, cs):
        ok = torch.ones_like(ar, dtype=torch.bool)
        for d, c in enumerate(cs):
            ok = ok & (c >= 0) & (c < t.shape[d])
        return ok
    if not isinstance(side, Split):
        return [(side, cols, in_range(side, cols))]
    low = cols[side.dim] < side.split
    high = list(cols)
    high[side.dim] = cols[side.dim] - side.split
    return [(side.a, cols, low & in_range(side.a, cols)),
            (side.b, high, ~low & in_range(side.b, high))]


def grad_sumsq_ref(grads) -> torch.Tensor:
    """Plain version of `adamw.grad_sumsq`: each leaf's f32 sum of
    squares, stacked [n leaves]."""
    return torch.stack([g.float().square().sum() for g in grads])


def adamw_apply_ref(grads, params, m, v, params_out, m_out, v_out, *,
                    scale, lr, bc1, bc2, b1, b2, eps, weight_decay) -> None:
    """Plain version of `adamw.adamw_apply`: for every leaf the AdamW
    step of the reference's `adamw_update` (the clip's `scale`, the
    bias corrections `bc1`, `bc2` and `lr` given), in f32, the new
    parameters cast back to their type, written into `params_out`,
    `m_out`, `v_out` (which may be the inputs: each leaf's values are
    computed before any is written)."""
    for g, p, m_, v_, p_out, m_out_, v_out_ in zip(
            grads, params, m, v, params_out, m_out, v_out):
        g = g.float() * scale
        m_new = b1 * m_ + (1 - b1) * g
        v_new = b2 * v_ + (1 - b2) * g * g
        u = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
        u = u + weight_decay * p.float()
        p_new = (p.float() - lr * u).to(p.dtype)
        m_out_.copy_(m_new)
        v_out_.copy_(v_new)
        p_out.copy_(p_new)
