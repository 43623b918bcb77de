"""The dry run and its roofline against the reference: the roofline
terms and table of one record under one made-up chip built in both
packages, the cell list, a decode cell counted on the meta device, a
cell that does not fit the card, the twin-pod (`multi`) records' bytes
per card against the reference's own sharding rules, their rank-local
counts and all three roofline terms, and `op_cost`'s
FLOPs of a smoke decode step against the reference's HLO analyzer on
the same step."""

import dataclasses
import functools
import json
import math
import os
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.tiers import ChipSpec as JChip  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.launch import shardings as jshd  # noqa: E402
from repro.launch.hlo_cost import analyze  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.tiers import H100_CHIP  # noqa: E402
from repro_torch.core.tiers import ChipSpec as TChip  # noqa: E402
from repro_torch.kvcache.paged import abstract_cache  # noqa: E402
from repro_torch.launch import dryrun, op_cost  # noqa: E402
from repro_torch.launch import roofline as troof  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.models.params import abstract_params  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

CHIP = dict(name="made-up", peak_flops_bf16=123e12, hbm_bw=1.5e12,
            ici_bw=77e9, hbm_capacity=40 * 1024**3)

RECORDS = [
    {"arch": "internlm2-1.8b", "shape": "decode_32k", "mesh": "single",
     "devices": 1, "status": "ok", "flops_per_device": 9.9e9,
     "bytes_per_device": 7.1e9, "collective_bytes_per_device":
     {"total": 0.0}, "params": 1889009664, "active_params": 1889009664,
     "seq": 32768, "batch": 1, "kind": "decode"},
    {"arch": "granite-8b", "shape": "train_4k", "mesh": "single",
     "devices": 1, "status": "ok", "flops_per_device": 2.1e14,
     "bytes_per_device": 3.3e12, "collective_bytes_per_device":
     {"total": 5.0e9}, "params": 8e9, "active_params": 8e9,
     "seq": 4096, "batch": 1, "kind": "train"},
    {"arch": "qwen3-32b", "shape": "train_4k", "mesh": "single",
     "status": "skip", "reason": "too big"},
]


def test_h100_chip_constants():
    assert H100_CHIP.peak_flops_bf16 == 989e12
    assert H100_CHIP.hbm_bw == 3.35e12
    assert H100_CHIP.ici_bw == 450e9
    assert H100_CHIP.hbm_capacity == 85_017_493_504


@pytest.mark.parametrize("rec", RECORDS[:2], ids=lambda r: r["shape"])
def test_roofline_terms_equal_the_reference(rec):
    got = troof.roofline_terms(rec, TChip(**CHIP))
    want = jroof.roofline_terms(rec, JChip(**CHIP))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k


def test_table_equals_the_reference(tmp_path, monkeypatch):
    path = tmp_path / "results.jsonl"
    path.write_text("".join(json.dumps(r) + "\n"
                            for r in RECORDS + RECORDS[:1]))
    monkeypatch.setattr(jroof, "roofline_terms", functools.partial(
        jroof.roofline_terms, chip=JChip(**CHIP)))
    got = troof.table(str(path), TChip(**CHIP))
    assert got == jroof.table(str(path))
    assert len(got.splitlines()) == 2 + 3
    assert len(troof.load_results(str(path))) == 3


def test_cells_equal_the_reference():
    # the reference's dryrun module sets XLA_FLAGS when imported (read
    # only when a JAX backend starts); put it back at once
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdry
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    assert dryrun.cells() == jdry.cells()
    assert dryrun.SHAPES == jdry.SHAPES
    assert dryrun.SUBQUADRATIC == jdry.SUBQUADRATIC
    assert dryrun.cells(["qwen3-32b"], ["decode_32k"]) == \
        jdry.cells(["qwen3-32b"], ["decode_32k"])


def test_decode_cell_counts_on_meta():
    rec = dryrun.run_cell("internlm2-1.8b", "decode_32k", "single")
    cfg = tconfigs.get("internlm2-1.8b")
    assert rec["status"] == "ok"
    assert (rec["devices"], rec["batch"], rec["global_batch"]) == (1, 1, 128)
    assert rec["params"] == cfg.param_count()
    # one paged launch per tier per layer, one token write per layer
    assert rec["kernels"] == {"paged_attention": 2 * cfg.num_layers,
                              "page_copy": cfg.num_layers}
    # at least the weights' products and reads
    assert rec["flops_per_device"] > 2 * cfg.param_count()
    assert rec["bytes_per_device"] > 2 * cfg.param_count()
    mem = rec["memory"]
    assert 0 < mem["pinned_host_bytes"] < mem["card_bytes"]
    # one token's logits over the vocabulary at least, far under the
    # arguments
    assert 4 * cfg.vocab <= mem["activation_bytes"] < mem["card_bytes"]
    terms = troof.roofline_terms(rec)
    assert terms["dominant"] == "memory" and terms["collective_s"] == 0.0


def test_cell_past_the_card_is_skipped_with_its_bytes():
    rec = dryrun.run_cell("qwen3-32b", "train_4k", "single")
    n = TModel(tconfigs.get("qwen3-32b")).schema()
    from repro_torch.models.params import count_params
    # bf16 parameters and f32 AdamW moments, plus the int32 tokens
    want = 2 * count_params(n) + 8 * count_params(n) + 4 * 4096 + 4
    assert rec["status"] == "skip"
    assert rec["memory"]["card_bytes"] == want
    assert str(want) in rec["reason"]


#: the twin-pod cells held to the reference's rules: two decode cells,
#: whose pools split their pages over `model` (8 KV heads do not divide
#: 16), a dense and a moe train step (the single record skips
#: llama4-maverick's: it does not fit one card)
MULTI_CELLS = [("internlm2-1.8b", "decode_32k"), ("qwen3-32b", "decode_32k"),
               ("granite-8b", "train_4k"),
               ("llama4-maverick-400b-a17b", "train_4k")]


def reference_card_bytes(leaves, specs, sizes, itemsize=None):
    """Bytes of one card's blocks of the reference's abstract `leaves`
    under its `PartitionSpec`s `specs` on a mesh of `sizes`."""
    total = 0
    for leaf, spec in zip(leaves, specs):
        shape = list(leaf.shape)
        for d, entry in enumerate(spec):
            axes = () if entry is None else \
                (entry,) if isinstance(entry, str) else tuple(entry)
            n = math.prod(sizes[a] for a in axes)
            assert shape[d] % n == 0
            shape[d] //= n
        total += math.prod(shape) * (itemsize or leaf.dtype.itemsize)
    return total


@pytest.mark.parametrize("arch,shape", MULTI_CELLS,
                         ids=[f"{a}-{s}" for a, s in MULTI_CELLS])
def test_multi_record_bytes_follow_the_reference_rules(arch, shape,
                                                       monkeypatch):
    """A twin-pod record's per-card parameter, AdamW and decode-state
    bytes (its host tier apart) equal those the reference's own
    `param_pspec` and `state_shardings_for` give on its (2, 16, 16) mesh
    of names and sizes (its `NamedSharding` swapped for a holder of the
    spec: the mesh has no devices); the inputs by its
    `tokens_sharding`; beside them the rank-local step's FLOPs, bytes,
    activations and collectives."""
    from jax.sharding import AbstractMesh as JMesh
    from jax.sharding import PartitionSpec as P
    monkeypatch.setattr(jshd, "NamedSharding",
                        lambda mesh, spec: SimpleNamespace(spec=spec))
    jmesh = JMesh((2, 16, 16), ("pod", "data", "model"))
    sizes = dict(zip(jmesh.axis_names, jmesh.axis_sizes))
    rec = dryrun.run_cell(arch, shape, "multi")
    seq, batch, kind = dryrun.SHAPES[shape]
    assert (rec["mesh"], rec["devices"], rec["batch"]) == ("multi", 512,
                                                          batch)
    assert rec["status"] == "ok"
    jm = JModel(jconfigs.get(arch))
    mode = "train" if kind == "train" else "serve"
    params = jax.tree.leaves(jm.abstract_params())
    axes = jax.tree.leaves(jm.logical_axes(),
                           is_leaf=lambda x: isinstance(x, tuple))
    pspecs = [jshd.param_pspec(a, p.shape, jmesh, mode)
              for a, p in zip(axes, params)]
    mem = rec["memory"]
    assert mem["param_bytes"] == reference_card_bytes(params, pspecs, sizes)
    tok = jshd.tokens_sharding(jmesh, batch).spec
    if kind == "train":
        assert mem["opt_bytes"] == 2 * reference_card_bytes(
            params, pspecs, sizes, itemsize=4) + 4
        assert (mem["state_bytes"], mem["pinned_host_bytes"]) == (0, 0)
        assert mem["input_bytes"] == reference_card_bytes(
            [jax.ShapeDtypeStruct((batch, seq), jnp.int32)], [tok], sizes)
    else:
        geo = jm.cache_geometry(batch, seq, hbm_fraction=0.25)
        state = jax.eval_shape(lambda: jm.init_decode_state(batch, geo))
        holders = jshd.state_shardings_for(jm, state, jmesh)
        specs = [h.spec for h in jax.tree.leaves(
            holders, is_leaf=lambda x: isinstance(x, SimpleNamespace))]
        host = reference_card_bytes([state.k_host, state.v_host],
                                    [holders.k_host.spec,
                                     holders.v_host.spec], sizes)
        total = reference_card_bytes(jax.tree.leaves(state), specs, sizes)
        assert mem["pinned_host_bytes"] == host
        assert mem["state_bytes"] == total - host
        assert mem["opt_bytes"] == 0
        assert mem["input_bytes"] == reference_card_bytes(
            [jax.ShapeDtypeStruct((batch,), jnp.int32)], [P(tok[0])], sizes)
        # qwen3-32b's 8 KV heads do not divide 16: the pools split pages
        assert (holders.k_hbm.spec[2] == "model") == \
            (jm.cfg.kv_heads % 16 != 0)
    assert mem["card_bytes"] == mem["param_bytes"] + mem["opt_bytes"] + \
        mem["state_bytes"] + mem["input_bytes"]
    assert mem["card_bytes"] <= H100_CHIP.hbm_capacity
    # the rank-local step's own counts beside them
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert mem["activation_bytes"] > 0 and mem["rank_extra_bytes"] >= 0
    assert rec["collective_bytes_per_device"]["total"] > 0
    assert "flops_split" not in rec and "unmeasured" not in rec


def test_multi_fits_what_one_card_cannot():
    """llama4-maverick's train step skips on one card and fits each card
    of the twin-pod mesh (the rank's arguments and activations counted);
    internlm2's decode rank (4 lanes, 1 of 16 query heads, its 8 KV
    heads whole under `pages`) counts at least 128/512 of the one-card
    (batch 1) step's FLOPs and at most 1.5 times that: each rank also
    computes every KV head's K/V (1.31 times on the CPU)."""
    single = dryrun.run_cell("llama4-maverick-400b-a17b", "train_4k",
                             "single")
    assert single["status"] == "skip"
    assert dryrun.run_cell("llama4-maverick-400b-a17b", "train_4k",
                           "multi")["status"] == "ok"
    one = dryrun.run_cell("internlm2-1.8b", "decode_32k", "single")
    multi = dryrun.run_cell("internlm2-1.8b", "decode_32k", "multi")
    even = one["flops_per_device"] * 128 / 512
    assert even <= multi["flops_per_device"] <= 1.5 * even
    assert multi["memory"]["card_bytes"] < one["memory"]["card_bytes"]


@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-1.2b"])
def test_multi_flops_count_the_cards_that_split_the_step(arch):
    """long_500k's batch of 1 is whole on every `pod` and `data` card
    (the reference's `tokens_sharding` replicates it), so only the
    16-way `model` axis can split the rank's step, which runs the same
    global batch as the one-card record: zamba2's 32 heads split, so
    its rank counts 1/16 of the one-card step within 3% (the norms,
    conv and residual adds every rank repeats); xlstm's 4 heads do not,
    so its rank runs every block whole and splits only the vocabulary:
    more than half the one-card step, less than all of it."""
    from jax.sharding import AbstractMesh as JMesh
    single = dryrun.run_cell(arch, "long_500k", "single")
    multi = dryrun.run_cell(arch, "long_500k", "multi")
    jmesh = JMesh((2, 16, 16), ("pod", "data", "model"))
    assert jshd.tokens_sharding(jmesh, 1).spec[0] is None
    assert multi["status"] == single["status"] == "ok"
    assert multi["batch"] == single["batch"] == 1
    one, rank = single["flops_per_device"], multi["flops_per_device"]
    if arch == "zamba2-1.2b":
        assert 16 * rank == pytest.approx(one, rel=0.03)
        assert 16 * rank >= one
    else:
        assert one / 2 < rank < one


def test_multi_record_gets_all_three_terms():
    """A twin-pod record prices its rank's FLOPs, bytes and collectives:
    the three terms all positive, equal to the reference's
    `roofline_terms` of the same record on the same chip (the H100's
    constants in both packages' `ChipSpec`), its collective term the
    collectives over `ici_bw`."""
    rec = dryrun.run_cell("whisper-tiny", "decode_32k", "multi")
    h100 = dict(name="h100", peak_flops_bf16=H100_CHIP.peak_flops_bf16,
                hbm_bw=H100_CHIP.hbm_bw, ici_bw=H100_CHIP.ici_bw,
                hbm_capacity=H100_CHIP.hbm_capacity)
    got = troof.roofline_terms(rec)
    want = jroof.roofline_terms(rec, JChip(**h100))
    assert got == want
    assert min(got["compute_s"], got["memory_s"], got["collective_s"]) > 0
    assert got["collective_s"] == \
        rec["collective_bytes_per_device"]["total"] / H100_CHIP.ici_bw


def test_mesh_both_writes_both_records(capsys, tmp_path):
    """`--mesh both` runs the one-card record, then the twin-pod one;
    the roofline table renders both with all three terms."""
    dryrun.main(["--arch", "internlm2-1.8b", "--shape", "decode_32k",
                 "--mesh", "both"])
    lines = capsys.readouterr().out.strip().splitlines()
    recs = [json.loads(line) for line in lines]
    assert [r["mesh"] for r in recs] == ["single", "multi"]
    assert [r["devices"] for r in recs] == [1, 512]
    path = tmp_path / "results.jsonl"
    path.write_text("".join(line + "\n" for line in lines))
    rows = troof.table(str(path)).splitlines()
    assert len(rows) == 2 + 2
    for row, mesh in zip(rows[2:], ("multi", "single")):
        cols = row.split()
        assert cols[2] == mesh and cols[3] in ("compute", "memory",
                                               "collective")
        assert all(float(c) > 0 for c in cols[4:6])
    assert float(rows[2].split()[6]) > 0 == float(rows[3].split()[6])


#: op_cost against the reference's analyzer on one smoke decode step.
#: Both count a product's 2 FLOPs per multiply-add and elementwise ops
#: at 1 per element. They differ by what each graph holds: the port's
#: paged kernel is priced at 4 FLOPs per (token, query row, dim) over
#: the tier's listed pages while the reference's CPU path computes the
#: same dense pool attention op by op, and XLA folds, fuses away or
#: rewrites some elementwise work (converts, selects, iotas) the eager
#: graph runs one by one; the matmuls, which the two count alike,
#: dominate. op_cost counts 0.89x the reference's here (0.87x at B=4
#: over 1024 tokens); 20% bounds the difference.
FLOPS_RTOL = 0.2


def test_op_cost_flops_match_the_reference_analyzer():
    name, B, ctx = "internlm2-1.8b", 2, 256
    jcfg = dataclasses.replace(jconfigs.get_smoke(name), dtype=jnp.float32,
                               param_dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.get_smoke(name), dtype=torch.float32,
                               param_dtype=torch.float32)
    jm, tm = JModel(jcfg), TModel(tcfg)

    geo_j = jm.cache_geometry(B, ctx)
    state_j = jax.eval_shape(lambda: jm.init_decode_state(B, geo_j))
    token_j = jax.ShapeDtypeStruct((B,), jnp.int32)
    hlo = jax.jit(jm.decode_step).lower(
        jm.abstract_params(), state_j, token_j).compile().as_text()
    want = analyze(hlo)["flops"]

    params = abstract_params(tm.schema(), torch.float32)
    state = abstract_cache(tm.cache_geometry(B, ctx))
    token = torch.empty((B,), dtype=torch.int32, device="meta")
    got = op_cost.analyze(tm.decode_step, params, state, token)
    assert got["kernels"] == {"paged_attention": 2 * tcfg.num_layers,
                              "page_copy": tcfg.num_layers}
    assert got["flops"] == pytest.approx(want, rel=FLOPS_RTOL)


def test_op_cost_prices_the_kernels_by_their_formulas():
    meta = dict(device="meta", dtype=torch.bfloat16)
    q = torch.empty((2, 4, 3, 64), **meta)
    pool = torch.empty((2, 5, 16, 4, 64), **meta)
    plist = torch.empty((2, 5), device="meta", dtype=torch.int32)
    from repro_torch.kernels import ops
    with op_cost.OpCost() as cost:
        ops.tier_attention(q, pool, pool, plist, plist)
    assert cost.kernels == {"paged_attention": 1}
    assert cost.flops == 4 * 2 * 5 * 16 * 4 * 3 * 64
    qf = torch.empty((1, 96, 8, 32), **meta)
    kf = torch.empty((1, 96, 2, 32), **meta)
    with op_cost.OpCost() as cost:
        ops.flash_attention(qf, kf, kf, causal=True)
    assert cost.flops == op_cost.flash_flops(1, 96, 96, 8, 32, True) == \
        4 * 8 * 32 * (96 * 97 // 2)
    assert cost.bytes == 2 * (2 * qf.numel() + 2 * kf.numel())


def test_op_cost_peak_counts_live_results_only():
    """`peak` is the most bytes of results alive at once: a freed
    result leaves it, a view or an in-place write adds nothing."""
    a = torch.empty((100, 100), device="meta")
    with op_cost.OpCost() as cost:
        b = a @ a
        c = b + 1
        del b
        d = c * 2
        d.add_(1)
        d.view(-1)
        assert cost.live == 2 * 4 * 100 * 100
    assert cost.peak == 2 * 4 * 100 * 100

