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
intermediate products to bf16 on the way).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

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
