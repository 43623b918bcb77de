"""Host-side launch planning of the hand-written kernels, on the CPU.

The paged-attention wrapper picks the warps per CTA, the split of the
page range and the shared memory of each launch, and lays its f32
outputs and partial buffers out in one scratch allocation; the CUDA
sources hold the constants this planning mirrors. None of it needs a
card: these tests hold the plan to its invariants and to the sources.
"""

import math
import pathlib
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

H100_SMS = 132


@pytest.mark.parametrize("B, KH, N, per_sm, min_pages", [
    (8, 8, 64, 2, 8),      # full width, HBM tier
    (8, 8, 208, 2, 8),     # full width, host tier
    (8, 8, 1, 2, 8),
    (8, 8, 2, 2, 8),
    (2, 2, 32, 4, 8),      # the smoke config
    (1, 1, 500, 4, 2),
    (3, 2, 5, 1, 4),
])
def test_choose_splits_is_one_wave_without_empty_splits(B, KH, N, per_sm,
                                                        min_pages):
    splits, per = pa.choose_splits(B, KH, N, H100_SMS, per_sm, min_pages)
    assert 1 <= splits <= N and splits * per >= N
    assert (splits - 1) * per < N                   # no empty split
    assert per >= min(min_pages, N)                 # the ring has work
    # at most one wave: no more CTAs than the card holds at per_sm each,
    # unless (B, KH) alone needs more, or a split is down to the minimum
    assert B * KH * splits <= max(per_sm * H100_SMS, B * KH) or \
        per == min(min_pages, N)


@pytest.mark.parametrize("N", [1, 2, 5, 64, 208])
def test_launch_plan_at_full_width(N):
    """bf16 pools of 16 tokens x 128: four warps, each with its own
    three-stage ring, two CTAs per SM."""
    plan = pa.launch_plan(8, 8, 2, 128, 16, N, 2, H100_SMS)
    assert plan.warps == 4
    smem = pa.smem_bytes(4, 2, 128, 16, 2, plan.per)
    assert 2 * (smem + 1024) <= pa.SM_SMEM
    assert plan.splits * plan.per >= N
    assert plan.per >= min(2 * plan.warps, N)


@pytest.mark.parametrize("T, HD, itemsize, warps", [
    (16, 128, 4, 4),       # f32 pools: 4 rings of 3 stages still fit
    (32, 128, 4, 2),       # 32-token f32 pages: two warps
    (32, 128, 2, 4),
    (8, 16, 4, 4),
])
def test_launch_plan_takes_fewer_warps_where_rings_do_not_fit(T, HD,
                                                              itemsize,
                                                              warps):
    plan = pa.launch_plan(2, 2, 2, HD, T, 32, itemsize, H100_SMS)
    assert plan.warps == warps
    assert pa.smem_bytes(warps, 2, HD, T, itemsize, plan.per) <= pa.CTA_SMEM


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("N", [1, 5, 64, 208])
def test_launch_plan_at_the_moe_shapes(N, itemsize):
    """granite-moe-3b-a800m's decode: G = 3 query heads per KV head
    (an odd G: the kernel's rows go two at a time, the last alone) and
    head_dim 64. Four warps fit in bf16 and f32; the shared memory
    holds three query rows and their accumulators; one wave."""
    B, KH, G, HD, T = 8, 8, 3, 64, 16
    plan = pa.launch_plan(B, KH, G, HD, T, N, itemsize, H100_SMS)
    assert plan.warps == 4
    smem = pa.smem_bytes(4, G, HD, T, itemsize, plan.per)
    assert smem <= pa.CTA_SMEM
    assert smem - pa.smem_bytes(4, 2, HD, T, itemsize, plan.per) == \
        4 * (HD + 4 * HD + 2 * 4)                   # one more query row
    assert plan.splits * plan.per >= N and \
        (plan.splits - 1) * plan.per < N
    per_sm = max(1, min(4, pa.SM_SMEM // (smem + 1024)))
    assert B * KH * plan.splits <= max(per_sm * H100_SMS, B * KH) or \
        plan.per == min(2 * plan.warps, N)
    layout = pa.scratch_layout(B, KH, G, HD, N, plan.splits)
    assert dict((n, sh) for n, _, sh in layout)["part_acc"] == \
        (plan.splits, B, KH, G, HD)


def test_launch_plan_refuses_pages_that_do_not_fit():
    with pytest.raises(ValueError, match="do not fit"):
        pa.launch_plan(1, 1, 1, 1024, 32, 4, 4, H100_SMS)


@pytest.mark.parametrize("splits", [1, 5])
def test_scratch_layout_is_one_buffer_of_disjoint_views(splits):
    B, KH, G, HD, N = 3, 2, 5, 16, 7
    layout = pa.scratch_layout(B, KH, G, HD, N, splits)
    names = [name for name, _, _ in layout]
    assert names == ["m", "l", "lse", "part_m", "part_l", "part_acc"]
    want = {"m": (B, KH, G), "l": (B, KH, G), "lse": (B, KH, G, N),
            "part_m": (splits, B, KH, G), "part_l": (splits, B, KH, G),
            "part_acc": (splits, B, KH, G, HD)}
    off = 0
    for name, o, shape in layout:                   # back to back
        assert o == off and shape == want[name]
        off += math.prod(shape)
    buf = torch.zeros(off)
    views = [buf[o:o + math.prod(sh)].view(sh) for _, o, sh in layout]
    for i, v in enumerate(views):
        v.fill_(i + 1)
    for i, v in enumerate(views):                   # nothing overlaps
        assert bool((v == i + 1).all()) and v.is_contiguous()
    assert bool((buf > 0).all())


def _source(name):
    """`csrc/<name>.cu` and the `csrc/` headers it includes."""
    paths = (pathlib.Path(build.CSRC) / f"{name}.cu", *build.headers(name))
    return "".join(p.read_text() for p in paths)


def test_paged_plan_mirrors_the_source():
    """The wrapper's ring depth is the kernel's, and the kernel keeps at
    least three page stages in flight."""
    src = _source("paged_attention")
    ring = int(re.search(r"constexpr int kRing = (\d+);", src).group(1))
    assert ring == pa.RING >= 3
    # the source's smem_bytes has the same terms as the wrapper's
    body = re.search(r"smem_bytes\(int warps.*?\n}", src, re.S).group(0)
    for term in ("warps * kRing * 2 * T * HD * es", "(size_t)G * HD",
                 "(size_t)warps * G * HD", "2 * (size_t)warps * G",
                 "3 * (size_t)per + 2"):
        assert term in body


def test_flash_head_dims_are_the_sources():
    src = _source("flash_attention")
    cases = tuple(int(d) for d in re.findall(r"case (\d+): return", src))
    assert cases == fa.HEAD_DIMS
    assert "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16" in src
    # the kernel_variants script replaces this constant
    assert len(re.findall(r"constexpr int kStages = \d+;", src)) == 1
