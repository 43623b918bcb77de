"""The flash backward's plain version, `ref.flash_attention_bwd_ref`
(the closed formulas the CUDA kernel computes), against two independent
gradients on the CPU: torch.autograd through `ref.flash_attention_ref`,
and `jax.grad` through the reference's `naive_attention` and
`flash_attention_jnp` (GQA K/V repeated with the reference's
`repeat_kv`, so its gradient sums over each group). Causal and not,
Sq != Sk (queries aligned at key 0, as the kernel), GQA, head dims 16
to 160, f32 and bf16.

Tolerances: f32, 1e-5 of each gradient's largest entry (sums in other
orders); bf16 inputs, 1e-2 (one bf16 rounding of the result: the
closed formulas sum in f32 and round once, autograd rounds P and
intermediate products to bf16 on the way). The bf16 tensor-core body
of the kernel feeds P and dS to its products rounded once to bf16;
`test_bf16_products_within_the_backward_tolerance` holds that model to
the kernel's tolerance (`chip_smoke.BWD_TOL["bf16"]`, 1e-2 of each
gradient's largest entry).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

CASES = [
    # (B, Sq, Sk, H, KH, D, causal)
    (2, 37, 37, 4, 2, 16, True),
    (1, 50, 50, 6, 2, 64, True),        # H / KH = 3
    (2, 24, 24, 4, 4, 160, True),
    (1, 21, 45, 3, 3, 32, False),       # cross-attention: Sq < Sk
    (1, 45, 21, 2, 1, 16, True),        # causal, Sq > Sk
    (2, 19, 30, 4, 1, 160, False),
]


def inputs(case, seed=0, dtype=np.float32):
    B, Sq, Sk, H, KH, D, _ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in
            ((B, Sq, H, D), (B, Sk, KH, D), (B, Sk, KH, D), (B, Sq, H, D))]


def closed_form(q, k, v, g, causal):
    q, k, v, g = (torch.from_numpy(a) for a in (q, k, v, g))
    out, lse = ref.flash_attention_ref(q, k, v, causal=causal,
                                       return_lse=True)
    return ref.flash_attention_bwd_ref(q, k, v, out, g, lse, causal)


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("case", CASES, ids=str)
def test_closed_form_matches_torch_autograd(case):
    causal = case[-1]
    q, k, v, g = inputs(case)
    want = closed_form(q, k, v, g, causal)
    leaves = [torch.from_numpy(a).double().requires_grad_() for a in
              (q, k, v)]
    out = ref.flash_attention_ref(*leaves, causal=causal)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g).double())
    for a, b in zip(want, got):
        assert a.shape == b.shape
        assert rel_err(a, b.float()) <= 1e-5


@pytest.mark.parametrize("impl", ["naive_attention", "flash_attention_jnp"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_closed_form_matches_jax_grad(case, impl):
    B, Sq, Sk, H, KH, D, causal = case
    q, k, v, g = inputs(case, seed=1)
    fn = getattr(jlayers, impl)
    kw = dict(q_chunk=16, k_chunk=16) if impl == "flash_attention_jnp" \
        else {}

    def f(q, k, v):
        rep = H // KH
        return fn(q, jlayers.repeat_kv(k, rep), jlayers.repeat_kv(v, rep),
                  causal=causal, **kw)
    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    got = closed_form(q, k, v, g, causal)
    for a, b in zip(got, want):
        assert rel_err(a, b) <= 1e-5


@pytest.mark.parametrize("case", CASES[:3], ids=str)
def test_bf16_closed_form_within_one_rounding(case):
    causal = case[-1]
    q, k, v, g = inputs(case, seed=2)
    want = closed_form(q, k, v, g, causal)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, g)]
    out, lse = ref.flash_attention_ref(*bf[:3], causal=causal,
                                       return_lse=True)
    got = ref.flash_attention_bwd_ref(*bf[:3], out, bf[3], lse, causal)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        assert rel_err(a.float(), b) <= 1e-2


#: (B, Sq, Sk, H, KH, D, causal) of the bf16-product model: the causal
#: D=64 G=2 shape, a ragged D=160 one with Sq != Sk (not causal), and
#: a causal Sq > Sk one at G=4 with D=16
ROUNDED_CASES = [
    (2, 128, 128, 4, 2, 64, True),
    (2, 100, 70, 4, 1, 160, False),
    (1, 90, 40, 8, 2, 16, True),
]


def rounded_closed_form(q, k, v, out, g, lse, causal):
    """The closed form as the kernel's bf16 body computes it: P and dS
    (from f32 P) rounded once to bf16 before they enter their products,
    f32 sums, dq, dk, dv rounded to bf16."""
    B, Sq, H, D = q.shape
    KH = k.shape[2]
    s, rep = ref._flash_scores(q, k, causal)
    p = torch.where(s <= ref.NEG_INF / 2, 0.0, torch.exp(s - lse[..., None]))
    gf = g.float()
    vr = v.repeat_interleave(rep, dim=2).float()
    kr = k.repeat_interleave(rep, dim=2).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.bfloat16().float(), gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vr)
    delta = (gf * out.float()).sum(-1).transpose(1, 2)
    ds = (p * (dp - delta[..., None])).bfloat16().float()
    scale = D ** -0.5
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale

    def group(t):
        return t.reshape(B, t.shape[1], KH, rep, D).sum(3)
    return (dq.bfloat16(), group(dk).bfloat16(), group(dv).bfloat16())


@pytest.mark.parametrize("case", ROUNDED_CASES, ids=str)
def test_bf16_products_within_the_backward_tolerance(case):
    """P and dS rounded once to bf16 before the products (no hi + lo
    split) stay within the card's bf16 tolerance of the f32 closed form
    on the same bf16 inputs (2.2e-3 to 4.0e-3 at these shapes)."""
    causal = case[-1]
    q, k, v, g = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in inputs(case, seed=4))
    out, lse = ref.flash_attention_ref(q, k, v, causal=causal,
                                       return_lse=True)
    got = rounded_closed_form(q, k, v, out, g, lse, causal)
    f32 = [t.float() for t in (q, k, v, out, g)]
    want = ref.flash_attention_bwd_ref(*f32, lse, causal)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        assert rel_err(a.float(), b) <= 1e-2


def test_lse_is_the_rows_log_sum_exp():
    q, k, v, _ = inputs(CASES[0])
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    _, lse = ref.flash_attention_ref(q, k, v, causal=True, return_lse=True)
    kr = k.repeat_interleave(2, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kr) * q.shape[-1] ** -0.5
    mask = torch.ones(s.shape[-2:], dtype=torch.bool).tril()
    want = torch.logsumexp(s.masked_fill(~mask, -torch.inf), dim=-1)
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-6)


def test_ops_flash_attention_differentiates_on_the_cpu():
    """On CPU tensors `ops.flash_attention` is the plain version, and
    autograd through it gives the closed form's gradients."""
    case = CASES[1]
    q, k, v, g = inputs(case, seed=3)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=True)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    want = closed_form(q, k, v, g, True)
    for a, b in zip(got, want):
        assert rel_err(a, b) <= 1e-5
