"""The rank-local prefill and decode of the vlm, encdec, hybrid, ssm and
xlstm families on real gloo meshes on the CPU, against the port's
unmeshed steps and the reference's `Model.prefill` / `decode_step`.

Eight ranks are spawned once, over a `file://` store in `tmp_path`
(`_torch_mesh_decode_worker`), and build in turn the meshes of `PLAN`:
(1, 2) and (2, 2) for every config, and one `model` axis that divides
no head count for each: internvl2-2b's smoke config (4 heads over 2 KV
heads) at (1, 4), its query heads split over whole KV heads under the
`pages` KV pool rule; whisper-tiny's (4 heads) at (1, 3), the heads
and MLP whole, the pools whole (`none`); zamba2-1.2b's (4 heads) at
(1, 3), its Mamba2 blocks and site whole; its ssm stack (the same
blocks, no site) at (1, 3); xlstm-125m's (4 heads) at (1, 8), its
blocks whole. Each rank binds the rank-local model as the meshed
engine binds a rank (`TensorParallel.serving`) over its serve-mode
shards and its rows of the batch (split over `data`), prefills 2
prompts of `PROMPT` tokens (vlm: after its patch embeddings; encdec:
over its frame embeddings; ssm: decoded from the zero state, as it has
no prefill) and takes `STEPS` greedy steps. Every collective times out
after 60 s. While they run, this process runs the same steps unmeshed
through the port and, for the families that have a prefill, the
reference. Then `chip_smoke.py`'s phase 20 at the smoke configs on
threads.

The contract is the meshed streams' (`tests/test_torch_mesh_serve.py`):
greedy tokens equal the unmeshed port's and the reference's; logits
within `STREAM_ATOL` of the unmeshed port's and `REF_ATOL` of the
reference's; the integer cache state (page table, owner maps, length)
equal to the unmeshed rows' exactly (the tables are whole on every
model rank); each rank's pools and recurrent state within `STATE_ATOL`
of its block of the unmeshed state (its KV heads, or its slots under `pages`, or the whole pools;
the recurrent memories' heads where the axis divides them, the conv
states and the encoder output whole).
"""

import dataclasses
import multiprocessing
import os
import pickle
import sys
import threading

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402

import _torch_mesh_decode_worker as worker  # noqa: E402
from _torch_serve_ref import smoke_pair, state_numpy  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the configs: tag -> (architecture, the mesh that divides no head count)
CONFIGS = {"vlm": ("internvl2-2b", (1, 4)), "encdec": ("whisper-tiny", (1, 3)),
           "hybrid": ("zamba2-1.2b", (1, 3)), "ssm": ("zamba2-1.2b", (1, 3)),
           "xlstm": ("xlstm-125m", (1, 8))}
#: what the ranks run, in order
PLAN = tuple((tag, shape, "steps") for tag, (_, odd) in CONFIGS.items()
             for shape in ((1, 2), (2, 2), odd))
#: the ranks spawned; a smaller mesh takes the first of them
WORLD = 8
#: seconds to wait for the ranks
JOIN_S = 300
#: prompts, tokens each (the ssm stack's decoded one at a time), and
#: greedy decode steps
LANES, PROMPT, SSM_PROMPT, STEPS = 2, 24, 8, 4
#: a rank's logits against the unmeshed port's (f32; the meshed
#: streams' bound) and against the reference's (the families' own
#: tests' bound, `tests/test_torch_hybrid.py`); the largest seen on the
#: CPU: 7.7e-6 and 7.3e-6 (the ssm stack and zamba2 at (2, 2), (1, 2))
STREAM_ATOL, REF_ATOL = 2e-5, 2e-5
#: a rank's pools and recurrent state against its block of the unmeshed
#: state: about twice the largest difference seen on the CPU (1.29e-5,
#: the ssm stack's Mamba2 state at (2, 2), values up to ~6)
STATE_ATOL = 2.5e-5


def models():
    """{tag: (reference model or None, its params, port config, its
    params, prompts, extra)}: the f32 smoke configs, one set of weights
    from the reference's init through the bridge."""
    out = {}
    rng = np.random.default_rng(30)
    for tag, (name, _) in CONFIGS.items():
        jm, jp, tm, tp = smoke_pair(name)
        cfg = tm.cfg
        prompt = PROMPT
        if tag == "ssm":
            def stack(c):
                return dataclasses.replace(c, family="ssm", ssm=dataclasses
                                           .replace(c.ssm, attn_every=0))
            cfg = stack(cfg)
            tp = {k: v for k, v in tp.items() if k != "shared_attn"}
            jm, jp, prompt = None, None, SSM_PROMPT
        prompts = rng.integers(0, cfg.vocab, (LANES, prompt)).astype(
            np.int32)
        key = {"vlm": "patch_embeds", "encdec": "frame_embeds"}.get(tag)
        extra = None if key is None else {key: rng.standard_normal(
            (LANES, cfg.frontend.num_embeddings, cfg.d_model)).astype(
                np.float32)}
        out[tag] = (jm, jp, cfg, tp, prompts, extra)
    return out


def reference_steps(jm, jp, prompts, extra, context=256):
    """The reference's prefill and `STEPS` greedy decode steps: {"logits",
    "tokens", "state"} as numpy."""
    jx = None if extra is None else {k: jnp.asarray(v)
                                     for k, v in extra.items()}
    geo = jm.cache_geometry(prompts.shape[0], context) \
        if jm.cfg.attention_layer_ids() else None
    logits, state = jm.prefill(jp, jnp.asarray(prompts), geo, extra=jx)
    out = {"logits": [np.asarray(logits)], "tokens": []}
    for _ in range(STEPS):
        tok = np.asarray(logits).argmax(-1).astype(np.int32)
        out["tokens"].append(tok)
        logits, state = jm.decode_step(jp, state, jnp.asarray(tok),
                                       use_pallas=False)
        out["logits"].append(np.asarray(logits))
    out["state"] = state_numpy(state)
    return out


def run_ranks(tmp, data_path):
    """Spawn the `WORLD` ranks over `PLAN` and wait; their exit codes."""
    ctx = multiprocessing.get_context("spawn")
    ranks = [ctx.Process(target=worker.rank_main, args=(
        r, WORLD, str(tmp / "store"), PLAN, data_path, str(tmp)))
        for r in range(WORLD)]
    try:
        for proc in ranks:
            proc.start()
        for proc in ranks:
            proc.join(JOIN_S)
    finally:
        for proc in ranks:
            if proc.is_alive():
                proc.kill()
                proc.join()
    return [proc.exitcode for proc in ranks]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"port": {tag: the unmeshed port's run}, "ref": {tag: the
    reference's}, (tag, shape): [each rank's run, by rank]}."""
    cases = models()
    tmp = tmp_path_factory.mktemp("decode_families")
    data_path = str(tmp / "data.pkl")
    with open(data_path, "wb") as f:
        pickle.dump({tag: (c[2], c[3], c[4], c[5], STEPS)
                     for tag, c in cases.items()}, f)
    codes = []
    ranks = threading.Thread(target=lambda: codes.extend(
        run_ranks(tmp, data_path)))
    ranks.start()
    try:
        got = {"port": {tag: worker.run_steps(c[2], c[3], c[4], c[5], STEPS)
                        for tag, c in cases.items()},
               "ref": {tag: reference_steps(c[0], c[1], c[4], c[5])
                       for tag, c in cases.items() if c[0] is not None}}
    finally:
        ranks.join()
    assert codes == [0] * WORLD, codes
    by_rank = [pickle.loads((tmp / f"rank{r}.pkl").read_bytes())
               for r in range(WORLD)]
    for tag, (d, m), case in PLAN:
        got[(tag, (d, m))] = [res[(tag, (d, m), case)]
                              for res in by_rank[:d * m]]
    return got


CELLS = [(tag, shape) for tag, shape, _ in PLAN]


def ids(rows):
    return [f"{t}-{d}x{m}" for t, (d, m) in rows]


def rows_of(coord, data, lanes=LANES):
    """The slice of the lanes that the rank at `coord` holds: its block
    where `data` divides them, else all."""
    if data == 1 or lanes % data:
        return slice(None)
    n = lanes // data
    return slice(coord["data"] * n, (coord["data"] + 1) * n)


def rank_block(state, facts, rows, path=()):
    """The rank's block of an unmeshed state (numpy dicts as
    `bridge.cache_to_numpy` gives): the rows of its lanes; a pool's KV
    heads (the `kv_heads` rule) or slots (`pages`); a recurrent memory's
    heads where the axis divides them; tables, conv states and the
    encoder output whole on `model`."""
    out = {}
    m, r = facts["size"], facts["rank"]
    for k, v in state.items():
        if isinstance(v, dict):
            out[k] = rank_block(v, facts, rows, path + (k,))
            continue
        lane_dim = 0 if k in ("length", "enc") else 1
        v = v[(slice(None),) * lane_dim + (rows,)]
        if k in ("k_hbm", "v_hbm", "k_host", "v_host"):
            if facts["kv_split"]:
                n = v.shape[4] // m
                v = v[..., r * n:(r + 1) * n, :]
            elif facts["pool"] is not None:
                lo, hi = facts["pool"][0 if "hbm" in k else 1]
                v = v[:, :, lo:hi]
        elif k in ("s", "m_C", "m_n", "m_m", "s_c", "s_n", "s_m", "s_h") \
                and facts["recurrent_split"]:
            n = v.shape[2] // m
            v = v[:, :, r * n:(r + 1) * n]
        out[k] = v
    return out


def flat(state, path=()):
    for k, v in state.items():
        if isinstance(v, dict):
            yield from flat(v, path + (k,))
        else:
            yield path + (k,), v


def test_the_meshes_take_the_splits_they_claim(runs):
    """(1, 2) splits every config's heads (its KV heads and recurrent
    blocks); the odd axes split none but internvl2's query heads (over
    whole KV heads, its pools' slots under `pages`); whisper's and
    zamba2's pools are whole at 3 (`none`)."""
    for tag, (_, odd) in CONFIGS.items():
        f2 = runs[(tag, (1, 2))][0]["out"]["facts"]
        assert f2["kv_split"] and f2["recurrent_split"], tag
        f = runs[(tag, odd)][0]["out"]["facts"]
        assert not f["kv_split"] and not f["recurrent_split"], tag
        if tag == "vlm":
            assert f["heads"] == (0, 1) and f["pool"] is not None
        if tag in ("encdec", "hybrid"):
            assert f["heads"] is None and f["pool"] is None


@pytest.mark.parametrize("tag,shape", CELLS, ids=ids(CELLS))
def test_rank_local_steps_equal_the_unmeshed_steps(runs, tag, shape):
    """On every rank: greedy tokens equal the unmeshed port's and the
    reference's; logits within STREAM_ATOL of the port's and REF_ATOL of
    the reference's; the integer cache state equal to its rows' of the
    unmeshed state; its pools and recurrent state within STATE_ATOL of
    its block of the unmeshed state."""
    port, ref = runs["port"][tag], runs["ref"].get(tag)
    for res in runs[(tag, shape)]:
        got, coord = res["out"], res["coord"]
        rows = rows_of(coord, shape[0])
        for step, logits in enumerate(got["logits"]):
            np.testing.assert_allclose(logits, port["logits"][step][rows],
                                       atol=STREAM_ATOL,
                                       err_msg=f"step {step}")
            if ref is not None:
                np.testing.assert_allclose(
                    logits, ref["logits"][step][rows], atol=REF_ATOL,
                    err_msg=f"reference, step {step}")
        for step, tok in enumerate(got["tokens"]):
            np.testing.assert_array_equal(tok, port["tokens"][step][rows])
            if ref is not None:
                np.testing.assert_array_equal(tok, ref["tokens"][step][rows])
        want = dict(flat(rank_block(port["state"], got["facts"], rows)))
        have = dict(flat(got["state"]))
        assert set(have) == set(want)
        for path, a in have.items():
            b = want[path]
            assert a.shape == b.shape, path
            if np.issubdtype(a.dtype, np.floating):
                np.testing.assert_allclose(a, b, atol=STATE_ATOL, rtol=0,
                                           err_msg=path)
            else:
                np.testing.assert_array_equal(a, b, err_msg=str(path))


@pytest.mark.parametrize("tag", [t for t in CONFIGS if t != "ssm"])
def test_unmeshed_port_matches_the_reference(runs, tag):
    """The baseline the ranks are held to: the port's unmeshed steps
    against the reference's (tokens equal, logits within REF_ATOL)."""
    port, ref = runs["port"][tag], runs["ref"][tag]
    for a, b in zip(port["logits"], ref["logits"]):
        np.testing.assert_allclose(a, b, atol=REF_ATOL)
    for a, b in zip(port["tokens"], ref["tokens"]):
        np.testing.assert_array_equal(a, b)


def test_chip_smoke_phase_20_at_the_smoke_configs():
    """`chip_smoke.py`'s phase 20 on the CPU at the f32 smoke configs
    (2 lanes, 3 decode steps), the ranks as threads: internvl2 at 2 and
    4, whisper, zamba2, its ssm stack at 2 and 3, xlstm at 2 and 8,
    every rank's logits within the phase's f32 tolerance (it raises
    otherwise), the integer state equal, the whole blocks' errors 0;
    then its qwen3-32b `--mesh multi` record, complete."""
    sys.path.insert(0, REPO)
    import chip_smoke

    def get(name):
        if name == "ssm":
            cfg = models_ssm()
        else:
            cfg = tconfigs.get_smoke(name)
        return dataclasses.replace(cfg, dtype=torch.float32,
                                   param_dtype=torch.float32)
    splits = (("internvl2-2b", (2, 4), 24, "f32"),
              ("whisper-tiny", (2, 3), 16, "f32"),
              ("zamba2-1.2b", (2, 3), 24, "f32"),
              ("ssm", (2, 3), 8, "f32"),
              ("xlstm-125m", (2, 8), 8, "f32"))
    launches, rows, record = chip_smoke.family_rank_phase(
        0, device="cpu", get=get, splits=splits, batch=2, steps=3)
    assert launches == {}
    assert [(r["model"], r["split"]) for r in rows] == [
        (cfg, m) for name, sizes, _, _ in splits
        for cfg, m in ((get(name).name, m) for m in sizes)]
    limit = chip_smoke.FAMILY_RANK_TOL["f32"]
    assert all(r["logits_err"] <= limit and r["flips"] == 0 for r in rows)
    whole = [r for r in rows if r["split"] in (3, 8)
             and r["model"] != "internvl2-smoke"]
    assert whole and all(r["logits_err"] == r["state_err"] == 0
                         for r in whole)
    assert record["status"] == "ok"
    assert record["collective_bytes_per_device"]["by_axis"]["model"] > 0


def models_ssm():
    """zamba2's smoke stack without its attention site (the ssm
    family)."""
    cfg = tconfigs.get_smoke("zamba2-1.2b")
    return dataclasses.replace(cfg, family="ssm", ssm=dataclasses.replace(
        cfg.ssm, attn_every=0))
