"""The hand-written CUDA kernels (paged decode attention, prefill
flash attention and its backward, row copies between pools, AdamW's
sums and update) against their plain versions, on the card, and
training steps on the card against the CPU's.

Marked `cuda`: every test here needs an NVIDIA Hopper card and `nvcc`,
and skips without them. On the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

Tolerances: in float32 the kernel sums in another order than the plain
version (atol 2e-5 on `out`); in bfloat16 `out` is rounded to bf16 on
both sides, one bf16 step apart at most (atol 1e-2). `m` and the
per-page LSE agree within 1e-4, `l` within 1e-4 relative. The flash
kernel's `out` is held to the same 2e-5 (f32) and 1e-2 (bf16). Row
copies are exact. The overlap-mode serve on the card must give the
CPU's tokens, statuses and step bytes exactly. The flash backward's
dq, dk, dv agree within 1e-2 (bf16) / 1e-4 (f32) of each gradient's
largest entry and are bitwise reproducible; train steps hold to
`chip_smoke.TRAIN_TOL`. AdamW's update is bitwise the plain version's,
pure and in place, and its sums within 1e-6 relative (f32 squares
added in f64 against the plain f32 sum), bitwise reproducible; donated
train steps equal pure ones bitwise.
"""

import dataclasses
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import page_copy as pc  # noqa: E402
from repro_torch.kernels.page_copy import Split  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import layers  # noqa: E402

pytestmark = pytest.mark.cuda

SHAPES = [
    # (B, KH, G, HD, P, T, N)
    (8, 8, 2, 128, 64, 16, 64),      # internlm2-1.8b, HBM tier
    (8, 8, 2, 128, 208, 16, 208),    # internlm2-1.8b, host tier
    (2, 2, 2, 16, 32, 16, 32),       # the smoke config
    (3, 2, 5, 128, 8, 16, 5),
    (1, 1, 1, 64, 4, 16, 4),
    (2, 4, 2, 64, 6, 8, 6),          # 8-token pages
    (8, 8, 3, 64, 64, 16, 64),       # granite-moe-3b-a800m, HBM tier
    (8, 8, 3, 64, 208, 16, 208),     # granite-moe-3b-a800m, host tier
    (8, 8, 4, 128, 64, 16, 64),      # llama31-8b, granite-8b: G = 4
    (8, 8, 8, 128, 208, 16, 208),    # qwen3-32b: G = 8
    (8, 8, 4, 160, 64, 16, 64),      # stablelm-12b: HD = 160
    (8, 8, 4, 160, 208, 16, 208),
    (4, 6, 1, 64, 32, 16, 32),       # whisper-tiny: G = 1
    (2, 16, 1, 64, 9, 16, 9),
]
OUT_ATOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def inputs(shape, dtype, device, seed):
    """Holes, a permuted page list, partial pages, a listed page with no
    valid token, and an all-hole last lane."""
    B, KH, G, HD, P, T, N = shape
    rng = np.random.default_rng(seed)
    page_list = np.full((B, N), -1, np.int32)
    page_valid = np.zeros((B, N), np.int32)
    for b in range(B - 1 if B > 1 else B):
        n_res = int(rng.integers(1, min(N, P) + 1))
        where = rng.choice(N, size=n_res, replace=False)
        page_list[b, where] = rng.permutation(P)[:n_res]
        page_valid[b, where] = rng.integers(1, T + 1, n_res)
        page_valid[b, rng.choice(where)] = 0
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=gen, device=device).to(dtype)
    return (randn(B, KH, G, HD), randn(B, P, T, KH, HD),
            randn(B, P, T, KH, HD),
            torch.as_tensor(page_list, device=device),
            torch.as_tensor(page_valid, device=device))


def assert_close(got, want, dtype):
    out, m, l, lse = got
    w_out, w_m, w_l, w_lse = want
    torch.testing.assert_close(out.float(), w_out.float(),
                               atol=OUT_ATOL[dtype], rtol=0)
    torch.testing.assert_close(m, w_m, atol=1e-4, rtol=0)
    torch.testing.assert_close(l, w_l, atol=0, rtol=1e-4)
    torch.testing.assert_close(lse, w_lse, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_kernel_matches_plain_version(device, shape, dtype):
    args = inputs(shape, dtype, device, seed=sum(shape))
    got = pa.paged_attention(*args)
    torch.cuda.synchronize()
    assert_close(got, ref.paged_attention_ref(*args), dtype)
    if shape[0] > 1:                  # the all-hole lane is empty
        assert bool((got[2][-1] == 0).all())
        assert bool((got[0][-1] == 0).all())
        assert bool((got[1][-1] == ref.NEG_INF).all())


def test_kernel_reads_pools_through_their_strides(device):
    """A pool stored [B, T, P, KH, HD] and viewed as [B, P, T, KH, HD]."""
    shape = (2, 2, 2, 64, 12, 16, 12)
    q, k, v, page_list, page_valid = inputs(shape, torch.bfloat16, device, 7)
    k_t = k.transpose(1, 2).contiguous().transpose(1, 2)
    v_t = v.transpose(1, 2).contiguous().transpose(1, 2)
    assert not k_t.is_contiguous()
    got = pa.paged_attention(q, k_t, v_t, page_list, page_valid)
    assert_close(got, ref.paged_attention_ref(q, k, v, page_list,
                                              page_valid), torch.bfloat16)


def listed_inputs(shape, page_list, page_valid, dtype, device, seed):
    """Random q and pools for the given page list and valid counts."""
    B, KH, G, HD, P, T, N = shape
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=gen, device=device).to(dtype)
    return (randn(B, KH, G, HD), randn(B, P, T, KH, HD),
            randn(B, P, T, KH, HD),
            torch.as_tensor(np.asarray(page_list, np.int32), device=device),
            torch.as_tensor(np.asarray(page_valid, np.int32), device=device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("N", [1, 2, 3])
def test_paged_fewer_pages_than_the_ring(device, N, dtype):
    """N = 1, and N below the ring depth of three stages."""
    shape = (2, 2, 2, 128, 4, 16, N)
    page_list = [[3, 0, 2][:N], [1, -1, 0][:N]]
    page_valid = [[16, 5, 16][:N], [7, 0, 16][:N]]
    args = listed_inputs(shape, page_list, page_valid, dtype, device, N)
    assert_close(pa.paged_attention(*args), ref.paged_attention_ref(*args),
                 dtype)


def test_paged_split_whose_pages_are_all_holes(device):
    """At full width: one split of lane 0 is all holes (page_list -1),
    the same split of lane 1 all listed with no valid token."""
    B, KH, G, HD, P, T, N = 8, 8, 2, 128, 64, 16, 64
    plan = pa.launch_plan(B, KH, G, HD, T, N, 2, pa._sm_count(
        device.index or 0))
    assert plan.splits > 1
    rng = np.random.default_rng(11)
    page_list = np.stack([rng.permutation(P) for _ in range(B)])
    page_valid = rng.integers(1, T + 1, (B, N))
    page_list[0, plan.per:2 * plan.per] = -1
    page_valid[1, plan.per:2 * plan.per] = 0
    args = listed_inputs((B, KH, G, HD, P, T, N), page_list, page_valid,
                         torch.bfloat16, device, 11)
    got = pa.paged_attention(*args)
    assert_close(got, ref.paged_attention_ref(*args), torch.bfloat16)
    assert bool((got[3][:2, :, :, plan.per:2 * plan.per]
                 == ref.NEG_INF).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_paged_partial_pages_of_one_token(device, dtype):
    B, KH, G, HD, P, T, N = 3, 2, 2, 128, 24, 16, 24
    rng = np.random.default_rng(5)
    page_list = np.stack([rng.permutation(P) for _ in range(B)])
    page_valid = np.ones((B, N), np.int32)           # lane 0: all 1 token
    page_valid[1] = rng.integers(1, 3, N)            # lane 1: 1 or 2
    page_valid[2, ::3] = 1                           # lane 2: some
    page_valid[2, 1::3] = T
    args = listed_inputs((B, KH, G, HD, P, T, N), page_list, page_valid,
                         dtype, device, 5)
    assert_close(pa.paged_attention(*args), ref.paged_attention_ref(*args),
                 dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("T", [8, 16, 32])
def test_paged_page_sizes(device, T, dtype):
    shape = (2, 2, 2, 64, 40, T, 40)
    args = inputs(shape, dtype, device, seed=T)
    assert_close(pa.paged_attention(*args), ref.paged_attention_ref(*args),
                 dtype)


def test_paged_graph_replays_repeat(device):
    """One launch captured in a CUDA graph and replayed twice gives the
    same result both times, and the plain version's: the last split of
    each (b, kh) leaves its ticket counter at 0 for the next replay."""
    shape = (8, 8, 2, 128, 64, 16, 64)
    args = inputs(shape, torch.bfloat16, device, seed=3)
    assert pa.launch_plan(8, 8, 2, 128, 16, 64, 2, pa._sm_count(
        device.index or 0)).splits > 1
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pa.paged_attention(*args)                    # warm up, allocate
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        res = pa.paged_attention(*args)
    runs = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        runs.append([t.clone() for t in res])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert_close(runs[1], ref.paged_attention_ref(*args), torch.bfloat16)
    assert_close(pa.paged_attention(*args), ref.paged_attention_ref(*args),
                 torch.bfloat16)


def test_tiered_attention_launches_the_kernel(device):
    """Two tiers on the card: two launches, and the same merged result
    as the plain version on the CPU."""
    hbm = inputs((2, 2, 2, 64, 8, 16, 8), torch.float32, device, 1)
    host = inputs((2, 2, 2, 64, 24, 16, 24), torch.float32, device, 2)
    q = hbm[0]
    before = pa.COUNTS["paged_attention"]
    out, imp = ops.tiered_paged_attention(q, hbm[1], hbm[2], host[1],
                                          host[2], hbm[3], hbm[4], host[3],
                                          host[4])
    assert pa.COUNTS["paged_attention"] == before + 2
    cpu = [t.cpu() for t in (q, hbm[1], hbm[2], host[1], host[2], hbm[3],
                             hbm[4], host[3], host[4])]
    w_out, w_imp = ops.tiered_paged_attention(*cpu)
    torch.testing.assert_close(out.cpu(), w_out, atol=2e-5, rtol=0)
    torch.testing.assert_close(imp.cpu(), w_imp, atol=1e-4, rtol=0)


def test_wrapper_refuses_what_the_kernel_does_not_take(device):
    q, k, v, page_list, page_valid = inputs((2, 2, 2, 64, 4, 16, 4),
                                            torch.float32, device, 3)
    with pytest.raises(ValueError, match="page_list"):
        pa.paged_attention(q, k, v, page_list.cpu(), page_valid)
    with pytest.raises(ValueError, match="dtype"):
        pa.paged_attention(q.half(), k.half(), v.half(), page_list,
                           page_valid)
    with pytest.raises(ValueError, match="k_pool"):
        pa.paged_attention(q, k.bfloat16(), v, page_list, page_valid)


FLASH_SHAPES = [
    # (B, S, H, KH, D, dtype, causal)
    (4, 2304, 16, 8, 128, torch.bfloat16, True),   # the prefill of the path
    (2, 1000, 4, 4, 128, torch.bfloat16, True),    # ragged S, KH == H
    (2, 1000, 4, 2, 64, torch.bfloat16, False),    # not causal
    (2, 300, 4, 2, 16, torch.float32, True),       # the smoke config
    (1, 77, 2, 1, 32, torch.float32, False),
    (4, 2304, 24, 8, 64, torch.bfloat16, True),    # granite-moe's prefill
    (2, 1000, 24, 8, 64, torch.float32, True),     # H/KH = 3 in f32
    (4, 2304, 32, 8, 160, torch.bfloat16, True),   # stablelm-12b's prefill
    (2, 1000, 32, 8, 160, torch.float32, True),    # D = 160 in f32
    (2, 300, 4, 1, 160, torch.bfloat16, False),
    (4, 1500, 6, 6, 64, torch.bfloat16, False),    # whisper's encoder
    (4, 2304, 64, 8, 128, torch.bfloat16, True),   # qwen3-32b: H/KH = 8
]


def flash_inputs(B, S, H, KH, D, dtype, device, seed, Sk=None):
    """q [B, S, H, D]; k, v [B, Sk, KH, D] (Sk = S unless given)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    Sk = S if Sk is None else Sk

    def randn(*s):
        return torch.randn(s, generator=gen, device=device).to(dtype)
    return randn(B, S, H, D), randn(B, Sk, KH, D), randn(B, Sk, KH, D)


@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=str)
def test_flash_kernel_matches_plain_version(device, shape):
    B, S, H, KH, D, dtype, causal = shape
    q, k, v = flash_inputs(B, S, H, KH, D, dtype, device, seed=S + D)
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=OUT_ATOL[dtype], rtol=0)


@pytest.mark.parametrize("S", [1, 63, 65, 129, 1000])
@pytest.mark.parametrize("D", [16, 32, 64, 128, 160])
def test_flash_bf16_head_dims_and_ragged_lengths(device, D, S):
    """The tensor-core body at every head dim, with S not a multiple of
    the 64-row tiles: padded rows and keys are masked, never NaN."""
    q, k, v = flash_inputs(2, S, 4, 2, D, torch.bfloat16, device, S * D)
    got = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    want = ref.flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=0)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("Sq, Sk", [(100, 300), (300, 100), (1, 129),
                                    (65, 1), (200, 1000)])
def test_flash_bf16_query_and_key_lengths_differ(device, Sq, Sk, causal):
    """Sq != Sk; causal is aligned at key 0 (query i sees keys 0..i)."""
    q, k, v = flash_inputs(2, Sq, 4, 2, 128, torch.bfloat16, device,
                           Sq + 7 * Sk, Sk=Sk)
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=0)


@pytest.mark.parametrize("D", [64, 160])
@pytest.mark.parametrize("Sq, Sk", [(37, 1500), (1, 1500), (64, 1500),
                                    (200, 1473)])
def test_flash_non_causal_keys_past_the_end(device, Sq, Sk, D):
    """Non-causal with Sk not a multiple of the 64-key tiles (whisper's
    cross-attention over 1500 frames, in prefill and at decode): the
    keys past Sk are masked to -inf in the last tile, not read as the
    zeros TMA fills there."""
    q, k, v = flash_inputs(4, Sq, 6, 6, D, torch.bfloat16, device, Sq + D,
                           Sk=Sk)
    got = fa.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    want = ref.flash_attention_ref(q, k, v, causal=False)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=0)
    # every real key's score far below 0 and V near 1: keys past Sk
    # read as zeros (score 0) would take nearly all the weight and pull
    # out to ~0
    q, k, v = q.abs(), -(k.abs() + 1), 1 + 0.1 * v
    got = fa.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    want = ref.flash_attention_ref(q, k, v, causal=False)
    assert float(want.float().min()) > 0.5
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=0)


@pytest.mark.parametrize("KH", [8, 4, 1], ids=["gqa1", "gqa2", "gqa8"])
def test_flash_bf16_gqa_ratios(device, KH):
    q, k, v = flash_inputs(2, 200, 8, KH, 128, torch.bfloat16, device, KH)
    got = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    want = ref.flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=0)


def test_flash_kernel_reads_inputs_through_their_strides(device):
    """q, k, v as views into one packed [B, S, H + 2 KH, D] projection."""
    B, S, H, KH, D = 2, 200, 4, 2, 64
    qkv = torch.randn(B, S, H + 2 * KH, D, device=device,
                      dtype=torch.bfloat16)
    q, k, v = qkv.split([H, KH, KH], dim=2)
    assert not q.is_contiguous()
    got = fa.flash_attention(q, k, v)
    want = ref.flash_attention_ref(q.contiguous(), k.contiguous(),
                                   v.contiguous())
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=0)


def test_flash_wrapper_refuses_what_the_kernel_does_not_take(device):
    q, k, v = flash_inputs(1, 64, 4, 2, 64, torch.float32, device, 0)
    for D in (48, 96, 256):       # not instantiated: raises, no fallback
        x = flash_inputs(1, 64, 4, 2, D, torch.bfloat16, device, D)
        with pytest.raises(ValueError, match="not instantiated"):
            fa.flash_attention(*x)
        with pytest.raises(ValueError, match="not instantiated"):
            layers.attention(*x)
    with pytest.raises(ValueError, match="dividing"):
        fa.flash_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="k:"):
        fa.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="v:"):
        fa.flash_attention(q, k, v[:, :32])
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, k.transpose(1, 3).contiguous().transpose(1, 3),
                           v)


@pytest.mark.parametrize("S", [40, 3000], ids=["short", "long"])
def test_layers_attention_launches_the_kernel(device, S):
    """On the card every sequence length goes to the flash kernel, one
    launch per call, and agrees with the CPU's dispatch."""
    q, k, v = flash_inputs(1, S, 4, 2, 16, torch.float32, device, S)
    before = build.COUNTS["flash_attention"]
    got = layers.attention(q, k, v)
    assert build.COUNTS["flash_attention"] == before + 1
    want = layers.attention(q.cpu(), k.cpu(), v.cpu())
    torch.testing.assert_close(got.cpu(), want, atol=2e-5, rtol=0)


# --------------------------------------------------------------------------
# overlap mode: the host tier in pinned host memory
# --------------------------------------------------------------------------

def rand_pool(shape, dtype, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def rows(device, *cols):
    return tuple(None if c is None else
                 torch.as_tensor(np.asarray(c, np.int32), device=device)
                 for c in cols)


def card_copy(side, device):
    """A copy on the card of a side (a tensor, or both pools of a
    Split)."""
    if isinstance(side, Split):
        return Split(card_copy(side.a, device), card_copy(side.b, device),
                     side.dim, side.at)
    return side.to(device).clone()


def tensors(side):
    return [side.a, side.b] if isinstance(side, Split) else [side]


def check_copy(device, *pairs, keep=None):
    """The kernel on `pairs` (any pool may be pinned) against the plain
    version on card copies of every pool: exactly equal, and one launch
    counted for all the pairs."""
    want = [card_copy(p[0], device) for p in pairs]
    ref.page_copy_ref(*[(w, di, card_copy(src, device), si)
                        for w, (_, di, src, si) in zip(want, pairs)],
                      keep=keep)
    before = build.COUNTS["page_copy"]
    pc.page_copy(*pairs, keep=keep)
    torch.cuda.synchronize()
    assert build.COUNTS["page_copy"] == before + 1
    for w, p in zip(want, pairs):
        for got, exp in zip(tensors(p[0]), tensors(w)):
            assert torch.equal(got.to(device), exp)


# pages of [T=16, KH=2, HD=64]; -1 and out-of-range rows are skipped
LAYER = [0, 1, -1, 1, 0, 2, 1]
LANE = [1, 0, 0, 1, 3, 0, 0]
SLOT = [4, 0, 2, 5, 1, 3, 6]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_page_copy_gathers_pages_out_of_pinned_memory(device, dtype):
    pool = rand_pool((2, 2, 6, 16, 2, 64), dtype, device, 1).cpu() \
        .pin_memory()
    out = torch.zeros((len(LAYER), 16, 2, 64), dtype=dtype, device=device)
    check_copy(device, (out, (None,), pool, rows(device, LAYER, LANE, SLOT)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_page_copy_scatters_pages_into_pinned_memory(device, dtype):
    pool = rand_pool((2, 2, 6, 16, 2, 64), dtype, device, 2).cpu() \
        .pin_memory()
    staged = rand_pool((len(LAYER), 16, 2, 64), dtype, device, 3)
    check_copy(device, (pool, rows(device, LAYER, LANE, SLOT), staged,
                        (None,)))


def test_page_copy_device_to_device(device):
    pool = rand_pool((2, 2, 6, 16, 2, 64), torch.bfloat16, device, 4)
    staged = rand_pool((len(LAYER), 16, 2, 64), torch.bfloat16, device, 5)
    check_copy(device, (pool, rows(device, LAYER, LANE, SLOT), staged,
                        (None,)))


def test_page_copy_scatters_tokens_into_pinned_memory(device):
    """The decode token write: lane b's [KH, HD] row to (b, slot,
    offset), lanes with slot -1 untouched."""
    pool = rand_pool((4, 6, 16, 2, 64), torch.bfloat16, device, 6).cpu() \
        .pin_memory()
    tok = rand_pool((4, 2, 64), torch.bfloat16, device, 7)
    check_copy(device, (pool, rows(device, None, [2, -1, 5, 0],
                                   [15, 3, 0, 7]), tok, (None,)))


def test_page_copy_refuses_pageable_memory(device):
    pool = torch.zeros((2, 6, 16, 2, 64), dtype=torch.bfloat16)
    tok = torch.zeros((2, 2, 64), dtype=torch.bfloat16, device=device)
    with pytest.raises(ValueError, match="pageable"):
        pc.page_copy((pool, rows(device, None, [0, 1], [0, 1]), tok,
                      (None,)))


def test_page_copy_split_side_into_pinned_memory(device):
    """One launch writes K and V tokens into two tiers split on the slot
    dim, the HBM pool on the card and the host pool pinned: slots below
    4 land in the first, 4..9 in the second at slot - 4, the rest (and
    -1) nowhere."""
    k = [rand_pool((4, 4, 16, 2, 64), torch.bfloat16, device, 8),
         rand_pool((4, 6, 16, 2, 64), torch.bfloat16, device, 9).cpu()
         .pin_memory()]
    v = [rand_pool((4, 4, 16, 2, 64), torch.bfloat16, device, 10),
         rand_pool((4, 6, 16, 2, 64), torch.bfloat16, device, 11).cpu()
         .pin_memory()]
    at = rows(device, None, [3, 4, 9, 10], [-1, 7, 0, 15])
    tok_k = rand_pool((4, 2, 64), torch.bfloat16, device, 12)
    tok_v = rand_pool((4, 2, 64), torch.bfloat16, device, 13)
    check_copy(device, (Split(*k, 1), at, tok_k, (None,)),
               (Split(*v, 1), at, tok_v, (None,)))


def test_page_copy_keep_mask(device):
    """`keep` drops its False rows from every pair (the decode step's
    inactive lanes), split sides and plain ones alike."""
    pool = [rand_pool((4, 6, 16, 2, 64), torch.float32, device, 14),
            rand_pool((4, 5, 16, 2, 64), torch.float32, device, 15).cpu()
            .pin_memory()]
    tok = rand_pool((4, 2, 64), torch.float32, device, 16)
    out = torch.zeros_like(tok)
    keep = torch.tensor([True, False, True, False], device=device)
    at = rows(device, None, [1, 7, 8, 0], [0, 1, 2, 3])
    check_copy(device, (Split(*pool, 1, 6), at, tok, (None,)),
               (out, (None,), pool[0], at), keep=keep)


def test_page_copy_four_pairs_in_one_launch(device):
    """A commit's four page lists in one launch: two gathers out of a
    pinned pool and two scatters into pools on the card, each pair with
    its own index lists (sentinel rows among them)."""
    pinned = [rand_pool((2, 2, 6, 16, 2, 64), torch.bfloat16, device, s)
              .cpu().pin_memory() for s in (17, 18)]
    card = [rand_pool((2, 2, 6, 16, 2, 64), torch.bfloat16, device, s)
            for s in (19, 20)]
    staged = [rand_pool((7, 16, 2, 64), torch.bfloat16, device, s)
              for s in (21, 22)]
    outs = [torch.zeros((7, 16, 2, 64), dtype=torch.bfloat16,
                        device=device) for _ in range(2)]
    gather = rows(device, LAYER, LANE, SLOT)
    scatter = rows(device, LANE, LAYER, [5, 4, 3, 2, 1, 0, -1])
    check_copy(device, (outs[0], (None,), pinned[0], gather),
               (outs[1], (None,), pinned[1], gather),
               (card[0], scatter, staged[0], (None,)),
               (card[1], scatter, staged[1], (None,)))


@pytest.mark.parametrize("pinned", [False, True], ids=["card", "pinned"])
def test_page_copy_one_row(device, pinned):
    pool = rand_pool((3, 16, 8, 128), torch.bfloat16, device, 23)
    if pinned:
        pool = pool.cpu().pin_memory()
    out = torch.zeros((1, 16, 8, 128), dtype=torch.bfloat16, device=device)
    check_copy(device, (out, (None,), pool, rows(device, [2])))


@pytest.mark.parametrize("pinned", [False, True], ids=["card", "pinned"])
def test_page_copy_ragged_rows(device, pinned):
    """Row counts and row bytes that fill neither the persistent grid nor
    whole bulk chunks: 1,153 rows of 8,208 bytes (a chunk and 16 bytes)
    gathered out of 2,000, 137 of them dropped."""
    rng = np.random.default_rng(24)
    pool = rand_pool((2000, 2052), torch.float32, device, 25)
    if pinned:
        pool = pool.cpu().pin_memory()
    idx = rng.choice(2000, size=1153, replace=False)
    idx[rng.choice(1153, size=137, replace=False)] = -1
    out = torch.zeros((1153, 2052), dtype=torch.float32, device=device)
    check_copy(device, (out, (None,), pool, rows(device, idx)))


def call_site(name, cache, device):
    """One call site of the row copy on `cache` (pools written in place);
    returns its outputs. The same seeds on the card and on the CPU."""
    from repro_torch.kvcache import migrate, paged
    from repro_torch.models import transformer
    from repro_torch.serving import control as tctl
    layer = tuple(getattr(cache, n)[1] for n in
                  ("k_hbm", "v_hbm", "k_host", "v_host"))
    gen = torch.Generator().manual_seed(30)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(device)

    def ints(values):
        return torch.tensor(values, dtype=torch.int32, device=device)
    if name == "write_token_layer":
        paged.write_token_layer(*layer, ints([1, 5, 9]), ints([0, 7, 15]),
                                randn(3, 2, 64), randn(3, 2, 64),
                                active=torch.tensor([True, False, True],
                                                    device=device))
        return ()
    if name == "read_token_layer":
        return paged.read_token_layer(*layer, ints([1, 5, 9]),
                                      ints([0, 7, 15]))
    if name == "write_tokens_layer":
        slot = ints([[1, 3, 4, 9, 0], [5, 5, 2, 2, 8]])
        off = ints([[0, 15, 3, 8, 1], [1, 2, 3, 4, 5]])
        valid = torch.tensor([[True] * 5, [True, True, False, True, True]],
                             device=device)
        paged.write_tokens_layer(*layer, slot, off, randn(2, 5, 2, 64),
                                 randn(2, 5, 2, 64), valid,
                                 lanes=torch.tensor([2, 0], device=device))
        return ()
    if name == "lane_pages":
        return transformer.lane_pages(layer, torch.tensor([0, 2],
                                                          device=device),
                                      (3, 4))
    if name == "append_token":
        # every layer's token: slots in both tiers, 10 past both pools
        out = paged.append_token(
            on(cache, device), randn(2, 3, 2, 64), randn(2, 3, 2, 64),
            ints([[1, 5, 9], [3, 10, 0]]), ints([0, 7, 15]))
        return (out.length.cpu(),)
    if name == "insert_lane":
        lane = pinned_cache(paged.CacheGeometry(
            num_layers=2, batch=1, page_tokens=16, hbm_pages=4,
            host_pages=6, kv_heads=2, head_dim=64, dtype=torch.float32), 50)
        lane.page_table = torch.arange(10, dtype=torch.int32, device="cuda") \
            .expand(2, 1, 10).contiguous()
        lane.length = torch.tensor([77], dtype=torch.int32, device="cuda")
        out = tctl.insert_lane(on(cache, device), on(lane, device),
                               torch.tensor(2, dtype=torch.int32,
                                            device=device))
        return tuple(getattr(out, n).cpu() for n in (
            "page_table", "hbm_owner", "host_owner", "length", "importance"))
    plan = migrate.MigrationPlan.build(
        6, [(0, 1, 2, 3, 6), (1, 0, 5, 0, 9), (1, 1, 0, 2, 4)],
        [(0, 1, 3, 2, 3), (1, 0, 0, 5, 0)], device=device)
    if name == "stage_plan":
        return migrate.stage_plan(cache, plan)
    staged = tuple(randn(6, 16, 2, 64) for _ in range(4))
    migrate.scatter_staged(cache, plan, staged)
    return ()


@pytest.mark.parametrize("name", ["write_token_layer", "read_token_layer",
                                  "write_tokens_layer", "lane_pages",
                                  "stage_plan", "scatter_staged",
                                  "append_token", "insert_lane"])
def test_call_site_is_one_launch(device, name):
    """Each call site moves K and V (a commit: four page lists;
    `append_token` and `insert_lane`: every layer) of both tiers, the
    host tier pinned, in one row-copy launch; pools and outputs equal
    the CPU's plain path on the same inputs."""
    from repro_torch.kvcache.paged import CacheGeometry
    geo = CacheGeometry(num_layers=2, batch=3, page_tokens=16, hbm_pages=4,
                        host_pages=6, kv_heads=2, head_dim=64,
                        dtype=torch.float32)
    cache = pinned_cache(geo, 40)
    cpu = dataclasses.replace(cache, **{
        n: getattr(cache, n).cpu().clone()
        for n in ("k_hbm", "v_hbm", "k_host", "v_host")})
    before = build.COUNTS["page_copy"]
    got = call_site(name, cache, device)
    torch.cuda.synchronize()
    assert build.COUNTS["page_copy"] == before + 1
    want = call_site(name, cpu, torch.device("cpu"))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    for n in ("k_hbm", "v_hbm", "k_host", "v_host"):
        assert torch.equal(getattr(cache, n).cpu(), getattr(cpu, n)), n


def on(cache, device):
    """`cache` as it is for the card (host pools pinned), or with every
    tensor on the CPU (pools already there kept, so writes land in
    them)."""
    if device.type == "cuda":
        return cache
    return dataclasses.replace(cache, **{
        f: getattr(cache, f).cpu() for f in cache.__dataclass_fields__})


def pinned_cache(geo, seed):
    """A cache on the card with pinned host pools, all pools random."""
    from repro_torch.kvcache.paged import init_cache
    cache = init_cache(geo, device="cuda", host_pinned=True)
    for i, name in enumerate(("k_hbm", "v_hbm", "k_host", "v_host")):
        pool = getattr(cache, name)
        pool.copy_(rand_pool(pool.shape, pool.dtype, device=torch.device(
            "cuda"), seed=seed + i))
    return cache


@pytest.mark.parametrize("asynchronous", [False, True],
                         ids=["inline", "side_stream"])
def test_migration_over_pinned_pools_matches_the_cpu(device, asynchronous):
    """A plan with swaps whose demotion lands in the host slot its
    promotion vacates (dem_dst == pro_src), fills and sentinel rows,
    committed through the row-copy kernel (inline, or on a side stream
    with `commit_async`): pools and tables equal the CPU's indexing
    path on the same plan."""
    from repro_torch.kvcache import migrate
    from repro_torch.kvcache.paged import CacheGeometry
    geo = CacheGeometry(num_layers=2, batch=2, page_tokens=16, hbm_pages=4,
                        host_pages=6, kv_heads=2, head_dim=64)
    cache = pinned_cache(geo, 10)
    assert cache.k_host.is_pinned() and cache.k_hbm.is_cuda
    cache.hbm_owner = torch.arange(4, dtype=torch.int32, device=device) \
        .expand(2, 2, 4).contiguous()
    cache.host_owner = (4 + torch.arange(6, dtype=torch.int32,
                                         device=device)).expand(2, 2, 6) \
        .contiguous()
    cache.page_table = torch.arange(10, dtype=torch.int32, device=device) \
        .expand(2, 2, 10).contiguous()
    plan = migrate.MigrationPlan.build(
        6, [(0, 1, 2, 3, 6), (1, 0, 5, 0, 9), (1, 1, 0, 2, 4)],
        [(0, 1, 3, 2, 3), (1, 0, 0, 5, 0)], device=device)
    cpu = migrate.PagedKVCache(**{f: getattr(cache, f).cpu().clone()
                                 for f in cache.__dataclass_fields__})
    want = migrate.apply_migrations(
        cpu, migrate.MigrationPlan(*[getattr(plan, f).cpu()
                                     for f in migrate._FIELDS]))
    before = build.COUNTS["page_copy"]
    if asynchronous:
        got, done = migrate.commit_async(cache, plan, torch.cuda.Stream())
        torch.cuda.current_stream().wait_event(done)
    else:
        got = migrate.apply_migrations(cache, plan)
    torch.cuda.synchronize()
    # one launch gathers the plan's four page lists, one scatters them
    assert build.COUNTS["page_copy"] == before + 2
    for f in want.__dataclass_fields__:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[2], SHAPES[7]],
                         ids=str)
def test_paged_kernel_reads_pinned_pools(device, shape):
    """The host-tier launch of overlap mode: pools in pinned host memory,
    read in place over the link, against the plain version on device
    copies of the same pools."""
    dtype = torch.bfloat16 if shape[3] == 128 else torch.float32
    q, k, v, page_list, page_valid = inputs(shape, dtype, device, 11)
    k_h, v_h = k.cpu().pin_memory(), v.cpu().pin_memory()
    got = pa.paged_attention(q, k_h, v_h, page_list, page_valid)
    torch.cuda.synchronize()
    assert_close(got, ref.paged_attention_ref(q, k_h.to(device),
                                              v_h.to(device), page_list,
                                              page_valid), dtype)


def _card_and_cpu(cfg, ecfg, reqs_of, serve_kw=None):
    """The same stream served on the card and on the CPU (same weights):
    per device (tokens, statuses with error codes, step bytes, events),
    and the engines."""
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import ServingEngine
    model = Model(cfg)
    params = model.init(0, device="cpu")
    runs, engines = {}, {}
    for dev in ("cuda", "cpu"):
        eng = ServingEngine(model, params, ecfg, device=dev)
        rep = eng.serve(reqs_of(), **(serve_kw or {}))
        runs[dev] = ({r.rid: r.output for r in rep},
                     {r.rid: (r.status, r.error.code if r.error else None)
                      for r in rep.completed + rep.rejected},
                     [(s.h_read, s.e_read, s.m_in, s.m_out)
                      for s in eng.stats],
                     [{k: v for k, v in e.items() if k != "reason"}
                      for e in rep.events])
        engines[dev] = (eng, rep)
    return runs, engines


def test_overlap_serve_on_the_card_matches_the_cpu(device):
    """A small f32 overlap-mode stream under HBM pressure, lanes reused:
    the card (pinned host pools, commits on a side stream) and the CPU
    give the same tokens, statuses and per-step bytes, with commits."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.scheduler import Request
    cfg = dataclasses.replace(configs.get_smoke("internlm2-1.8b"),
                              dtype=torch.float32, param_dtype=torch.float32)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, (272 + 16 * (i % 2),))
               for i in range(3)]
    ecfg = EngineConfig(max_context=512, policy="importance",
                        attention_sparsity=0.5, promote_thresh=1e-4,
                        telemetry_stride=8, prefill_chunk=16,
                        overlap_migrations=True)
    runs, engines = _card_and_cpu(cfg, ecfg, lambda: [
        Request(rid=i, prompt=p, max_new_tokens=8)
        for i, p in enumerate(prompts)], {"num_slots": 2})
    assert engines["cuda"][0].state.k_host.is_pinned()
    assert runs["cuda"] == runs["cpu"]
    assert sum(r[2] + r[3] for r in runs["cuda"][2]) > 0


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m",
                                  "llama4-maverick-400b-a17b"])
@pytest.mark.parametrize("overlap", [False, True], ids=["inline", "overlap"])
def test_moe_serve_on_the_card_matches_the_cpu(device, name, overlap):
    """The moe smoke configs (capacity factor 0.5, so choices drop) in
    f32, 10 requests through 8 slots: tokens, statuses and step bytes of
    the card, served through captured chunks within the bound the cache
    geometry fixes, equal the CPU's."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.serving.engine import EngineConfig, serve_graph_bound
    from repro_torch.serving.scheduler import Request
    cfg = configs.get_smoke(name)
    cfg = dataclasses.replace(cfg, dtype=torch.float32,
                              param_dtype=torch.float32,
                              moe=dataclasses.replace(cfg.moe,
                                                      capacity_factor=0.5))
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, cfg.vocab, (n,)) for n in
               (300, 40, 280, 20, 150, 64, 260, 33, 90, 17)]
    ecfg = EngineConfig(max_context=512, policy="importance",
                        prefill_chunk=16, telemetry_stride=8,
                        promote_thresh=1e-4, overlap_migrations=overlap)
    runs, engines = _card_and_cpu(cfg, ecfg, lambda: [
        Request(rid=i, prompt=p, max_new_tokens=10)
        for i, p in enumerate(prompts)], {"num_slots": 8})
    assert runs["cuda"] == runs["cpu"]
    assert set(s for s, _ in runs["cuda"][1].values()) == {"ok"}
    eng = engines["cuda"][0]
    assert eng._graphs.replays
    assert 0 < sum(eng.captures.values()) <= serve_graph_bound(
        eng.geo, ecfg.telemetry_stride)


@pytest.mark.parametrize("overlap", [False, True], ids=["inline", "overlap"])
def test_faulted_traced_serve_on_the_card_matches_the_cpu(device, overlap):
    """A fault plane of every kind, SLO admission with 0 / infinite
    targets per tier, and trace capture, on the internlm2 smoke config
    in f32: the card's tokens, statuses, step bytes, events and serve
    trace equal the CPU's, and the scores agree."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.serving import trace_bridge
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.faults import (
        FaultPlane, MigrationFault, PoisonFault, PoolFault, TierFault,
    )
    from repro_torch.serving.scheduler import Request
    from repro_torch.serving.slo import SLOPolicy, SLOTarget
    cfg = dataclasses.replace(configs.get_smoke("internlm2-1.8b"),
                              dtype=torch.float32, param_dtype=torch.float32)
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, cfg.vocab, (n,))
               for n in (272, 288, 40, 280, 24, 30)]
    plane = FaultPlane(
        tier=(TierFault(start=8, stop=40, link_scale=0.25),),
        migration=(MigrationFault(start=16, stop=32, commit_frac=0.05),),
        pool=(PoolFault(step=24, delta=-2),),
        poison=(PoisonFault(rid=3, step=53),))
    slo = SLOPolicy({"interactive": SLOTarget(0.0, 1.0),
                     "batch": SLOTarget(float("inf"), float("inf"))})

    def reqs():
        return [Request(rid=i, prompt=p, max_new_tokens=8,
                        tier="interactive" if i >= 4 else "batch")
                for i, p in enumerate(prompts)]
    ecfg = EngineConfig(max_context=512, policy="importance",
                        attention_sparsity=0.5, promote_thresh=1e-4,
                        telemetry_stride=8, prefill_chunk=16,
                        trace_telemetry=True, overlap_migrations=overlap)
    runs, engines = _card_and_cpu(cfg, ecfg, reqs, {
        "num_slots": 2, "faults": plane, "slo": slo})
    assert runs["cuda"] == runs["cpu"]
    statuses = runs["cuda"][1]
    assert statuses[3] == ("failed", "poisoned_logits")
    assert statuses[4] == statuses[5] == ("rejected", "slo_shed")
    recs = {dev: trace_bridge.collect_serve(eng)
            for dev, (eng, _) in engines.items()}
    for name in ("access", "tier", "emitted", "first", "rids"):
        np.testing.assert_array_equal(getattr(recs["cuda"], name),
                                      getattr(recs["cpu"], name))


@pytest.mark.parametrize("name", chip_smoke.FAMILY_ARCHS)
def test_single_stream_on_the_card_matches_the_cpu(device, name):
    """start + generate(16) of each new architecture's smoke config in
    f32 on the card and on the CPU, same weights (the smoke's phase 3f):
    tokens and step bytes equal, start logits within 1e-4, and the host
    tier read."""
    err, same_tokens, same_bytes, stats = chip_smoke.stream_card_vs_cpu(
        name, 5)
    assert err <= 1e-4
    assert same_tokens and same_bytes
    assert any(r[1] > 0 for r in stats)                # host tier read


def test_xlstm_prefill_and_decode_on_the_card_match_the_cpu(device):
    """xlstm-125m's smoke config in f32: `Model.prefill` + 16 greedy
    `decode_step`s on the card and on the CPU through the smoke's
    `xlstm_steps` (the helper of its phases 3f and 11): tokens equal,
    logits and the recurrent state within 1e-4."""
    errs, same_tokens = chip_smoke.xlstm_card_vs_cpu(5)
    assert errs["logits"] <= 1e-4 and errs["state"] <= 1e-4
    assert same_tokens



@pytest.mark.parametrize("overlap", [False, True], ids=["inline", "overlap"])
def test_fused_serve_replays_its_graphs(device, overlap):
    """A small f32 stream (phase 3's) through captured chunks: the
    card's tokens, statuses and step bytes equal the CPU's, the graphs
    replay, and serving the stream again on the same engine captures
    nothing, within the bound the cache geometry fixes."""
    from repro_torch.serving.engine import serve_graph_bound
    runs, engines = chip_smoke.parity_runs(5, overlap)
    assert runs["cuda"] == runs["cpu"]
    eng, _ = engines["cuda"]
    first = dict(eng.captures)
    assert first and eng._graphs.replays
    again = chip_smoke.serve_again(eng, 5)
    assert again == runs["cuda"]
    assert dict(eng.captures) == first
    bound = serve_graph_bound(eng.geo, eng.cfg.telemetry_stride)
    assert sum(first.values()) <= bound


@pytest.mark.parametrize("policy", ["importance", "quest"])
def test_fused_run_equals_steps_on_the_card(device, policy):
    """`run` over two strides through captured graphs against as many
    `step()` calls from the same state (f32 smoke config): integer
    state and step bytes equal, logits within chip_smoke.FUSED_TOL."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(configs.get_smoke("internlm2-1.8b"),
                              dtype=torch.float32, param_dtype=torch.float32)
    model = Model(cfg)
    res = chip_smoke.fused_vs_eager(model, model.init(0, device=device), 5,
                                    batch=2, prompt_len=300, stride=8,
                                    max_context=512, policy=policy)
    assert res["int_state"] and res["step_bytes"] and res["replays"]
    assert res["logits_err"] <= chip_smoke.FUSED_TOL


#: bf16 backward cases beside phase 2d's, in its format: head dims 16
#: and 32 (TMA's 32- and 64-byte swizzles), causal with Sq != Sk both
#: ways (queries aligned at key 0; past Sq no query sees the last keys)
#: and KH = 1 (G = H = 8)
BWD_CARD_CASES = (
    ("bf16 D=16", 2, 200, 200, 4, 2, 16, "bf16", True, False),
    ("bf16 D=32 not causal", 2, 130, 130, 6, 3, 32, "bf16", False, False),
    ("causal Sq > Sk", 2, 300, 170, 8, 2, 128, "bf16", True, False),
    ("causal Sq < Sk", 1, 100, 260, 4, 4, 64, "bf16", True, False),
    ("KH = 1", 2, 256, 256, 8, 1, 128, "bf16", True, False),
)


@pytest.mark.parametrize("shape", chip_smoke.BWD_SHAPES + BWD_CARD_CASES,
                         ids=lambda s: s[0])
def test_flash_backward_matches_plain_version(device, shape):
    """The backward kernel against `ref.flash_attention_bwd_ref` on the
    forward kernel's own out and LSE (the smoke's phase 2d shapes and
    `BWD_CARD_CASES`): dq, dk, dv within 1e-2 (bf16) / 1e-4 (f32) of
    each gradient's max |value|, and two runs bitwise equal (no
    atomics)."""
    _, B, Sq, Sk, H, KH, D, dt, causal, _ = shape
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dt]
    q, k, v = flash_inputs(B, Sq, H, KH, D, dtype, device, seed=Sq + D,
                           Sk=Sk)
    out, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    _, want_lse = ref.flash_attention_ref(q, k, v, causal=causal,
                                          return_lse=True)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)
    g = torch.randn_like(out)
    got = fa.flash_attention_bwd(q, k, v, out, g, lse, causal=causal)
    again = fa.flash_attention_bwd(q, k, v, out, g, lse, causal=causal)
    want = ref.flash_attention_bwd_ref(q, k, v, out, g, lse, causal)
    torch.cuda.synchronize()
    for a, b, c in zip(got, again, want):
        assert a.dtype == dtype and a.shape == c.shape
        assert torch.equal(a, b)
        err = (a.float() - c.float()).abs().max() / c.float().abs().max()
        assert err <= chip_smoke.BWD_TOL[dt]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_autograd_function_on_the_card(device, dtype):
    """`ops.flash_attention` with inputs that require grad goes through
    `FlashAttention`: one forward and one backward launch, gradients as
    autograd's through the plain version (strided q, k, v views of a
    packed projection); under no_grad the forward launches alone."""
    B, S, H, KH, D = 2, 200, 4, 2, 64
    qkv = torch.randn(B, S, H + 2 * KH, D, device=device, dtype=dtype,
                      requires_grad=True)
    q, k, v = qkv.split([H, KH, KH], dim=2)
    g = torch.randn(B, S, H, D, device=device, dtype=dtype)
    before = dict(build.COUNTS)
    out = ops.flash_attention(q, k, v)
    (got,) = torch.autograd.grad(out, qkv, g)
    assert build.COUNTS["flash_attention"] == before.get(
        "flash_attention", 0) + 1
    assert build.COUNTS["flash_attention_bwd"] == before.get(
        "flash_attention_bwd", 0) + 1
    (want,) = torch.autograd.grad(ref.flash_attention_ref(q, k, v), qkv, g)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    assert (got.float() - want.float()).abs().max() <= \
        tol * want.float().abs().max()
    with torch.no_grad():
        ops.flash_attention(q, k, v)
    assert build.COUNTS["flash_attention_bwd"] == before.get(
        "flash_attention_bwd", 0) + 1


@pytest.mark.parametrize("name", chip_smoke.TRAIN_PARITY_ARCHS)
def test_train_steps_on_the_card_match_the_cpu(device, name):
    """Three f32 train steps of each smoke config on the card and on the
    CPU from one init (the smoke's phase 12a), the flash backward
    launched on the card."""
    errs, launches, _ = chip_smoke.train_card_vs_cpu(name, 5)
    assert all(errs[k] <= chip_smoke.TRAIN_TOL[k] for k in errs), errs
    assert launches > 0


def adamw_leaves(device, shapes, p_dtype, g_dtype, seed, offset=0):
    """(grads, params, m, v) on the card; `offset` elements into a
    larger buffer, so no leaf starts 16-byte aligned where it is odd."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(shape, std, dtype, square=False):
        n = int(np.prod(shape))
        x = torch.randn(n + offset, generator=gen, device=device)
        x = (x.square() if square else x).mul(std).to(dtype)
        return x[offset:].view(shape)
    return ([draw(s, 1e-2, g_dtype) for s in shapes],
            [draw(s, 1.0, p_dtype) for s in shapes],
            [draw(s, 1e-2, torch.float32) for s in shapes],
            [draw(s, 1e-4, torch.float32, square=True) for s in shapes])


#: leaf shapes: ragged tails, an empty leaf, one element, a large one
ADAMW_SHAPES = [(7,), (0,), (1,), (3, 5, 9), (2048, 129), (4, 8)]
ADAMW_CASES = [(torch.bfloat16, torch.bfloat16, 0), (torch.float32,
               torch.float32, 0), (torch.bfloat16, torch.float32, 0),
               (torch.bfloat16, torch.bfloat16, 1), (torch.float32,
               torch.float32, 3)]


def adamw_scalars(device, step, clip, norm, lr):
    stepf = torch.tensor(step, device=device).float()
    return dict(scale=torch.clamp(clip / torch.clamp(norm, min=1e-12),
                                  max=1.0),
                lr=lr, bc1=1 - torch.pow(0.9, stepf),
                bc2=1 - torch.pow(0.95, stepf), b1=0.9, b2=0.95, eps=1e-8,
                weight_decay=0.1)


@pytest.mark.parametrize("p_dtype,g_dtype,offset", ADAMW_CASES,
                         ids=["bf16", "f32", "bf16-f32grad",
                              "bf16-unaligned", "f32-unaligned"])
def test_adamw_kernels_match_plain_versions(device, p_dtype, g_dtype,
                                            offset):
    """The sums within 1e-6 relative of the plain sums and bitwise the
    same twice; the update pure and in place bitwise the plain
    version's, lr a card scalar and a float, the clip active and idle;
    one launch of each for the whole tree."""
    from repro_torch.kernels import adamw
    g, p, m, v = adamw_leaves(device, ADAMW_SHAPES, p_dtype, g_dtype, 7,
                              offset)
    before = dict(build.COUNTS)
    sums = adamw.grad_sumsq(g)
    assert torch.equal(sums, adamw.grad_sumsq(g))
    want = ref.grad_sumsq_ref(g)
    assert torch.allclose(sums, want, rtol=1e-6, atol=0)
    norm = torch.sqrt(sums.sum())
    for clip, lr in ((0.5 * float(norm), torch.tensor(3e-3, device=device)),
                     (2.0 * float(norm), 1e-3)):
        scalars = adamw_scalars(device, 4, clip, norm, lr)
        outs = [[torch.empty_like(t) for t in ts] for ts in (p, m, v)]
        adamw.adamw_apply(g, p, m, v, *outs, **scalars)
        plain = [[torch.empty_like(t) for t in ts] for ts in (p, m, v)]
        ref.adamw_apply_ref(g, p, m, v, *plain, **scalars)
        copies = [[t.clone() for t in ts] for ts in (p, m, v)]
        adamw.adamw_apply(g, *copies, *copies, **scalars)
        for got, again, want in zip(outs, copies, plain):
            for a, b, c in zip(got, again, want):
                assert torch.equal(a, c) and torch.equal(b, c)
    assert build.COUNTS["grad_sumsq"] == before.get("grad_sumsq", 0) + 2
    assert build.COUNTS["adamw_apply"] == before.get("adamw_apply", 0) + 4


def test_adamw_kernels_take_trees_longer_than_a_launch(device):
    """A tree of more leaves than one launch carries goes in groups of
    `MAX_LEAVES`, each a launch, and still equals the plain versions."""
    from repro_torch.kernels import adamw
    shapes = [(i % 5 + 1, 33) for i in range(adamw.MAX_LEAVES + 5)]
    g, p, m, v = adamw_leaves(device, shapes, torch.bfloat16,
                              torch.bfloat16, 8)
    before = dict(build.COUNTS)
    sums = adamw.grad_sumsq(g)
    assert torch.allclose(sums, ref.grad_sumsq_ref(g), rtol=1e-6, atol=0)
    scalars = adamw_scalars(device, 1, 1.0, torch.sqrt(sums.sum()), 1e-3)
    outs = [[torch.empty_like(t) for t in ts] for ts in (p, m, v)]
    adamw.adamw_apply(g, p, m, v, *outs, **scalars)
    ref.adamw_apply_ref(g, p, m, v, p, m, v, **scalars)
    for got, want in zip(outs, (p, m, v)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert build.COUNTS["grad_sumsq"] == before.get("grad_sumsq", 0) + 2
    assert build.COUNTS["adamw_apply"] == before.get("adamw_apply", 0) + 2


def test_adamw_wrappers_refuse_what_the_kernels_do_not_take(device):
    from repro_torch.kernels import adamw
    g, p, m, v = adamw_leaves(device, [(4, 8)], torch.bfloat16,
                              torch.bfloat16, 9)
    one = torch.ones((), device=device)
    kw = dict(scale=one, lr=1e-3, bc1=one, bc2=one, b1=0.9, b2=0.95,
              eps=1e-8, weight_decay=0.1)
    with pytest.raises(ValueError, match="float32"):    # m in bf16
        adamw.adamw_apply(g, p, [t.bfloat16() for t in m], v, p, m, v, **kw)
    strided = p[0].t().contiguous().t()                 # (4, 8), not dense
    with pytest.raises(ValueError, match="contiguous"):
        adamw.adamw_apply(g, [strided], m, v, [strided], m, v, **kw)
    whole = torch.zeros(33, dtype=torch.bfloat16, device=device)
    with pytest.raises(ValueError, match="overlaps"):   # one element off
        adamw.adamw_apply(g, [whole[:32].view(4, 8)], m, v,
                          [whole[1:].view(4, 8)], m, v, **kw)
    with pytest.raises(ValueError, match="scalar"):
        adamw.adamw_apply(g, p, m, v, p, m, v,
                          **dict(kw, scale=one.double()))


@pytest.mark.parametrize("accum", [1, 2])
def test_donated_train_steps_on_the_card_equal_pure_ones(device, accum):
    """Three train steps of the bf16 smoke config on the card, donated
    and pure from one init: bitwise equal, the donated state the given
    tensors, each AdamW kernel launched once a step."""
    from repro_torch import configs
    from repro_torch.models.model import Model
    from repro_torch.training.train_step import (
        init_train_state, make_train_step)
    from repro_torch.tree import tree_leaves
    model = Model(configs.get_smoke("internlm2-1.8b"))
    rng = np.random.default_rng(10)
    batches = [torch.as_tensor(rng.integers(0, model.cfg.vocab, (4, 33)),
                               dtype=torch.int32, device=device)
               for _ in range(3)]
    runs = {}
    for donate in (False, True):
        state = init_train_state(model, 0, device)
        given = [t.data_ptr() for t in tree_leaves(
            (state.params, state.opt.m, state.opt.v))]
        before = dict(build.COUNTS)
        step = make_train_step(model, lr=1e-3, accum_steps=accum,
                               donate=donate)
        for toks in batches:
            state, _ = step(state, {"tokens": toks})
        for name in ("grad_sumsq", "adamw_apply"):
            assert build.COUNTS[name] == before.get(name, 0) + 3
        held = [t.data_ptr() for t in tree_leaves(
            (state.params, state.opt.m, state.opt.v))]
        assert (held == given) == donate
        runs[donate] = state
    for a, b in zip(tree_leaves(runs[True]), tree_leaves(runs[False])):
        assert torch.equal(a, b)
