"""The port's prefill attention (plain version of the flash kernel,
`ops.flash_attention` and `layers.attention`) against the reference on
the same numpy inputs, on the CPU.

The reference side runs the Pallas kernel `flash_attention_bhsd` in
interpret mode, its oracle `flash_attention_ref` and its
`layers.attention`; the port side runs `repro_torch.kernels.ref`,
`repro_torch.kernels.ops` and `repro_torch.models.layers`.
Tolerances: atol 1e-5 in float32 (the two frameworks sum in different
orders); in bfloat16 both sides round the output to bf16 from
differently ordered f32 sums, so atol 3e-2 (a few bf16 steps at |x|~1).
The kernel itself is held to the plain version on the card
(`tests/test_torch_cuda.py`).
"""

import re

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_bhsd  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

ATOL = {"f32": 1e-5, "bf16": 3e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def to_t(x, dt="f32"):
    return torch.from_numpy(np.asarray(x, np.float32)).to(TDT[dt])


def to_np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,H,S,D,qb,kb", [
    # the grid of tests/test_kernels.py::TestFlashAttention
    (1, 1, 128, 64, 64, 64),
    (2, 3, 256, 64, 128, 64),
    (1, 2, 512, 128, 128, 256),
])
def test_flash_attention_matches_pallas_kernel(B, H, S, D, qb, kb, dt,
                                               causal):
    rng = np.random.default_rng(B * 100 + S)
    q, k, v = (rand(rng, B, S, H, D) for _ in range(3))
    want = flash_attention_bhsd(
        *(jnp.asarray(x.transpose(0, 2, 1, 3), JDT[dt]) for x in (q, k, v)),
        causal=causal, q_block=qb, k_block=kb, interpret=True)
    got = tops.flash_attention(to_t(q, dt), to_t(k, dt), to_t(v, dt),
                               causal=causal)
    assert got.dtype == TDT[dt] and got.shape == (B, S, H, D)
    np.testing.assert_allclose(to_np(got), to_np(want).transpose(0, 2, 1, 3),
                               atol=ATOL[dt])


@pytest.mark.parametrize("H,KH", [(4, 2), (4, 1), (16, 8)])
def test_gqa_matches_pallas_kernel_on_repeated_kv(H, KH):
    """K/V with KH heads un-repeated == the reference kernel on K/V
    repeated per query head (query head h reads KV head h // (H/KH))."""
    rng = np.random.default_rng(H * 10 + KH)
    B, S, D = 2, 128, 32
    q = rand(rng, B, S, H, D)
    k, v = rand(rng, B, S, KH, D), rand(rng, B, S, KH, D)
    rep = [np.repeat(x, H // KH, axis=2).transpose(0, 2, 1, 3)
           for x in (k, v)]
    want = flash_attention_bhsd(
        jnp.asarray(q.transpose(0, 2, 1, 3)), *map(jnp.asarray, rep),
        causal=True, q_block=64, k_block=64, interpret=True)
    got = tops.flash_attention(to_t(q), to_t(k), to_t(v))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).transpose(0, 2, 1, 3),
                               atol=ATOL["f32"])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk", [(100, 100), (37, 100), (1, 9)])
def test_ragged_lengths_match_reference_oracle(Sq, Sk, causal):
    """Lengths that no block size divides, and Sq != Sk (queries aligned
    at key 0), against the reference's `flash_attention_ref`."""
    rng = np.random.default_rng(Sq + Sk)
    q = rand(rng, 2, Sq, 4, 16)
    k, v = rand(rng, 2, Sk, 4, 16), rand(rng, 2, Sk, 4, 16)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal)
    got = tref.flash_attention_ref(to_t(q), to_t(k), to_t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL["f32"])


@pytest.mark.parametrize("branch", ["naive", "chunked"])
def test_layers_attention_matches_reference(branch):
    """Both of the reference's CPU branches: the port's `attention`
    takes K/V with KH heads, the reference's takes them repeated."""
    rng = np.random.default_rng(3)
    B, S, H, KH, D = 2, 64, 4, 2, 16
    q = rand(rng, B, S, H, D)
    k, v = rand(rng, B, S, KH, D), rand(rng, B, S, KH, D)
    thresh = 2048 if branch == "naive" else 16
    want = jlayers.attention(
        jnp.asarray(q), *(jlayers.repeat_kv(jnp.asarray(x), H // KH)
                          for x in (k, v)), flash_threshold=thresh)
    got = tlayers.attention(to_t(q), to_t(k), to_t(v),
                            flash_threshold=thresh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL["f32"])


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """On the CPU neither `ops.flash_attention` nor `layers.attention`
    reaches the kernel wrapper, and no launch is counted."""
    from repro_torch.kernels import flash_attention as fa

    def no_kernel(*a, **k):
        raise AssertionError("the kernel wrapper was called for CPU tensors")

    monkeypatch.setattr(fa, "flash_attention", no_kernel)
    before = build.COUNTS["flash_attention"]
    rng = np.random.default_rng(4)
    q, k, v = (to_t(rand(rng, 1, 40, 2, 16)) for _ in range(3))
    assert torch.equal(tops.flash_attention(q, k, v),
                       tref.flash_attention_ref(q, k, v))
    tlayers.attention(q, k, v)
    tlayers.attention(q, k, v, flash_threshold=8)
    assert build.COUNTS["flash_attention"] == before


def test_kernel_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels.flash_attention import flash_attention as kern
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        kern(q, q, q)


def test_every_kernel_source_is_built(tmp_path, monkeypatch):
    """`build.SOURCES` names every `csrc/*.cu`, and each library path is
    keyed by its source's content."""
    assert sorted(build.SOURCES) == sorted(
        p.stem for p in build.CSRC.glob("*.cu"))
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    paths = {build.library_path(n) for n in build.SOURCES}
    assert len(paths) == len(build.SOURCES)
    assert all(p.parent == tmp_path and p.suffix == ".so" for p in paths)


def test_library_path_covers_the_included_headers(tmp_path, monkeypatch):
    """A library's name changes with every `csrc/` header its source
    includes, directly or through another header, and with no other."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include <cuda.h>\n#include "a.cuh"\n'
                               'int k;\n')
    (csrc / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (csrc / "b.cuh").write_text("// b\n")
    (csrc / "c.cuh").write_text("// not included\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "out"))
    assert build.headers("k") == (csrc / "a.cuh", csrc / "b.cuh")
    seen = {build.library_path("k")}
    for header, text in (("b.cuh", "// b, changed\n"),
                         ("a.cuh", '#pragma once\n#include "b.cuh"\n')):
        (csrc / header).write_text(text)
        seen.add(build.library_path("k"))
    assert len(seen) == 3
    (csrc / "c.cuh").write_text("// changed, not included\n")
    assert build.library_path("k") in seen


def test_flash_sources_share_the_hopper_header():
    """Both flash sources take their `wgmma`, TMA and mbarrier helpers
    from one header, and the row copy its mbarrier helpers; the other
    sources include none."""
    hopper = build.CSRC / "hopper.cuh"
    assert build.headers("flash_attention") == (hopper,)
    assert build.headers("flash_attention_bwd") == (hopper,)
    assert build.headers("page_copy") == (hopper,)
    for name in ("paged_attention", "host_memory"):
        assert build.headers(name) == ()
    sources = [(build.CSRC / f"{name}.cu").read_text()
               for name in ("flash_attention", "flash_attention_bwd",
                            "page_copy")]
    for helper in ("gmma_desc", "wgmma_ss_n64", "wgmma_rs_tile", "mbar_wait",
                   "tma_load", "encode_tiled", "tile_map"):
        defined = re.compile(rf"^\w[\w ]*\s{helper}\(", re.M)
        assert defined.search(hopper.read_text()), helper
        assert not any(defined.search(src) for src in sources), helper
