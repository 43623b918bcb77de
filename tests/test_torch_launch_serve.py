"""The one-card serve CLI (`repro_torch.launch.serve`) against the
reference's (`repro.launch.serve`): the same request stream bitwise
from the same seed, the same served stream — tokens, statuses and
per-step bytes — from the same f32 smoke weights carried by the bridge
under `--spec gh200`, `main` on the CPU, `--mesh` over a model axis
that does not divide the KV heads with `--parity`, and the refusal of
`--parity` without a card or `--mesh`."""

import argparse
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.launch import serve as jserve  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402

from _torch_serve_ref import smoke_pair  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def args(**kw):
    """The CLI's parsed arguments (its defaults, `kw` over them)."""
    base = dict(arch="internlm2-1.8b", smoke=True, policy="importance",
                sparsity=0.0, hbm_fraction=0.25, spec="gh200", requests=5,
                prompt_len=48, new_tokens=6, batch_slots=3, stride=4,
                seed=0, mesh="", parity=False, device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("seed", [0, 5])
def test_build_requests_equal_the_reference(seed):
    got = tserve.build_requests(256, 7, 40, 5, seed=seed)
    want = jserve.build_requests(256, 7, 40, 5, seed=seed)
    assert [(r.rid, r.max_new_tokens) for r in got] == \
        [(r.rid, r.max_new_tokens) for r in want]
    for g, w in zip(got, want):
        assert g.prompt.dtype == w.prompt.dtype
        np.testing.assert_array_equal(g.prompt, w.prompt)


@pytest.fixture(scope="module")
def models():
    return smoke_pair()


@pytest.mark.parametrize("policy,sparsity,hbm_fraction", [
    ("importance", 0.0, 0.25),
    ("quest", 0.5, 0.5),
])
def test_run_stream_equals_the_reference(models, policy, sparsity,
                                         hbm_fraction):
    jm, jp, tm, tp = models
    # 272-304-token prompts pass the 16-page (256-token) HBM pool: every
    # lane reads the host tier
    a = args(policy=policy, sparsity=sparsity, hbm_fraction=hbm_fraction,
             prompt_len=272, requests=3, new_tokens=4)
    jeng, jrep, _ = jserve.run_stream(jm, jp, a, None)
    teng, trep, _ = tserve.run_stream(tm, tp, a, "cpu")
    assert trep.statuses == jrep.statuses
    assert all(s == "ok" for s in trep.statuses.values())
    assert {r.rid: list(r.output) for r in trep} == \
        {r.rid: list(r.output) for r in jrep}
    assert [(s.h_read, s.e_read, s.m_in, s.m_out) for s in teng.stats] == \
        [(s.h_read, s.e_read, s.m_in, s.m_out) for s in jeng.stats]
    np.testing.assert_allclose(
        [s.modeled_latency_s for s in teng.stats],
        [s.modeled_latency_s for s in jeng.stats], rtol=1e-12)
    assert min(s.hbm_hit_rate for s in teng.stats) < 1.0


def test_main_serves_on_the_cpu(capsys):
    assert tserve.main(["--smoke", "--device", "cpu", "--requests", "3",
                        "--new-tokens", "4", "--prompt-len", "32"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("served 3 requests / ")
    assert out[-1].endswith("device cpu")
    assert len(out) == 3


def test_mesh_over_kv_heads_it_does_not_divide_serves_with_parity():
    """`--mesh data=1,model=4` on the smoke config's 2 KV heads (the
    reference's `pages` KV pool rule: each rank's pools hold a quarter
    of each tier's slots) spawns its 4 ranks, serves, and `--parity`
    holds the meshed stream to the unmeshed one (`MESH PARITY OK`);
    tests/test_torch_mesh_pages.py holds the engine to the
    reference's."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    src = os.path.join(REPO, "src")
    env["PYTHONPATH"] = src + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--parity", "--mesh", "data=1,model=4", "--device", "cpu",
         "--requests", "3", "--new-tokens", "3", "--batch-slots", "2",
         "--stride", "8"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert "MESH PARITY OK" in proc.stdout, proc.stdout


def test_parity_without_a_card_refuses(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tserve.main(["--smoke", "--parity"]) != 0
    assert "no CUDA card" in capsys.readouterr().err


def test_parity_never_compares_the_cpu_with_itself(monkeypatch):
    """With a card claimed but none there, the card half of --parity
    raises instead of quietly serving on the CPU twice."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    calls = []
    real = tserve.run_stream

    def spy(model, params, a, device=None, **kw):
        calls.append(str(device))
        if device == "cuda":
            raise RuntimeError("no card here")
        return real(model, params, a, device, **kw)
    monkeypatch.setattr(tserve, "run_stream", spy)
    with pytest.raises(RuntimeError, match="no card here"):
        tserve.main(["--smoke", "--parity", "--requests", "2",
                     "--new-tokens", "3", "--prompt-len", "16"])
    assert calls == ["cpu", "cuda"]
