"""The port's checkpoints against the reference's, on the CPU.

- The chunk files are byte-identical to the reference's
  `save_pytree(codec="zlib")` for the same tree (bf16, f32 and int32
  leaves, a nested dict, a list and a 0-d leaf), with both `_CHUNK`
  constants monkeypatched small so that a leaf spans several chunks;
  the leaf names and every manifest field equal the reference's (its
  msgpack decoded here; the port writes JSON).
- A TrainState's leaf names are the reference's (dataclass fields as
  ".params", ".opt/.step"); a serial and a threaded save write the
  same bytes; the reference's checkpoint restores into the port, and
  the port's restores into the reference (manifest converted).
- Round-trip (into real and meta-device targets), a corrupt chunk
  raises, an uncommitted step is invisible and collected, keep-N,
  `restore_or_init`, an async save's error raises at `wait()`, and the
  snapshot is taken at `save()`.
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import msgpack  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.training.train_step import TrainState as JTrainState  # noqa: E402
from repro.training.optimizer import adamw_init as jadamw_init  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.training.optimizer import adamw_init  # noqa: E402
from repro_torch.training.train_step import TrainState  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

CHUNK = 1000        # bytes: every leaf but the scalars spans chunks


def numpy_tree(seed=0):
    rng = np.random.default_rng(seed)
    bf16 = jnp.bfloat16
    return {
        "w": rng.standard_normal((33, 17)).astype(np.float32),
        "nested": {"b": np.asarray(jnp.asarray(
            rng.standard_normal((4, 9, 40)), bf16)),
            "c": rng.integers(0, 1 << 30, (700,)).astype(np.int32)},
        "list": [rng.standard_normal((5,)).astype(np.float32),
                 np.asarray(jnp.asarray(rng.standard_normal((3, 600)),
                                        bf16))],
        "scalar": np.asarray(3, np.int32),
    }


def as_torch(tree):
    return tree_map(lambda a: bridge.to_torch(
        a, torch.bfloat16 if a.dtype.name == "bfloat16" else None, "cpu"),
        tree)


def files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))
            if f not in ("manifest.json", "manifest.msgpack", "COMMIT")}


@pytest.fixture
def small_chunks(monkeypatch):
    monkeypatch.setattr(jckpt, "_CHUNK", CHUNK)
    monkeypatch.setattr(ckpt, "_CHUNK", CHUNK)


def test_chunk_files_and_manifest_equal_the_reference(tmp_path,
                                                      small_chunks):
    tree = numpy_tree()
    jckpt.save_pytree(jax.tree.map(jnp.asarray, tree), str(tmp_path / "j"),
                      codec="zlib")
    ckpt.save_pytree(as_torch(tree), str(tmp_path / "t"), codec="zlib")
    want, got = files(tmp_path / "j"), files(tmp_path / "t")
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name
    jman = msgpack.unpackb(open(tmp_path / "j" / "manifest.msgpack",
                                "rb").read())
    tman = json.load(open(tmp_path / "t" / "manifest.json"))
    assert tman == jman
    assert max(len(leaf["chunks"]) for leaf in tman["leaves"]) >= 3
    assert {leaf["dtype"] for leaf in tman["leaves"]} == {
        "float32", "bfloat16", "int32"}


def test_train_state_leaf_names_equal_the_reference(tmp_path):
    tree = {"a": np.ones((2, 3), np.float32),
            "b": {"c": np.zeros((4,), np.float32)}}
    jstate = JTrainState(params=jax.tree.map(jnp.asarray, tree),
                         opt=jadamw_init(jax.tree.map(jnp.asarray, tree)))
    params = as_torch(tree)
    tstate = TrainState(params=params, opt=adamw_init(params))
    jckpt.save_pytree(jstate, str(tmp_path / "j"), codec="zlib")
    ckpt.save_pytree(tstate, str(tmp_path / "t"), codec="zlib")
    assert files(tmp_path / "t") == files(tmp_path / "j")
    names = [leaf["name"] for leaf in json.load(
        open(tmp_path / "t" / "manifest.json"))["leaves"]]
    assert names[0] == ".params/a" and ".opt/.step" in names


def test_threaded_save_writes_the_serial_bytes(tmp_path, small_chunks,
                                               monkeypatch):
    tree = as_torch(numpy_tree(1))
    monkeypatch.setattr(ckpt, "WORKERS", 1)
    n1 = ckpt.save_pytree(tree, str(tmp_path / "one"), codec="zlib")
    monkeypatch.setattr(ckpt, "WORKERS", 4)
    n4 = ckpt.save_pytree(tree, str(tmp_path / "four"), codec="zlib")
    assert n1 == n4 > 0
    assert files(tmp_path / "one") == files(tmp_path / "four")
    assert open(tmp_path / "one" / "manifest.json").read() == \
        open(tmp_path / "four" / "manifest.json").read()


def test_restores_across_the_two_packages(tmp_path, small_chunks):
    tree = numpy_tree(2)
    jtree = jax.tree.map(jnp.asarray, tree)
    jckpt.save_pytree(jtree, str(tmp_path / "j"), codec="zlib")
    # the reference's checkpoint, manifest converted to JSON, in the port
    man = msgpack.unpackb(open(tmp_path / "j" / "manifest.msgpack",
                               "rb").read())
    json.dump(man, open(tmp_path / "j" / "manifest.json", "w"))
    got = ckpt.restore_pytree(as_torch(tree), str(tmp_path / "j"),
                              device="cpu")
    for a, b in zip(tree_leaves(got), tree_leaves(as_torch(tree))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the port's in the reference, manifest converted to msgpack
    ckpt.save_pytree(as_torch(tree), str(tmp_path / "t"), codec="zlib")
    man = json.load(open(tmp_path / "t" / "manifest.json"))
    open(tmp_path / "t" / "manifest.msgpack", "wb").write(
        msgpack.packb(man))
    back = jckpt.restore_pytree(jtree, str(tmp_path / "t"))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_round_trip_into_real_and_meta_targets(tmp_path, small_chunks):
    tree = as_torch(numpy_tree(3))
    d = str(tmp_path / "ck")
    ckpt.save_pytree(tree, d)          # the default codec
    assert ckpt.is_committed(d)
    for target in (tree, tree_map(lambda t: t.to("meta"), tree)):
        got = ckpt.restore_pytree(target, d, device="cpu")
        for a, b in zip(tree_leaves(got), tree_leaves(tree)):
            assert a.dtype == b.dtype and a.device.type == "cpu"
            assert torch.equal(a, b)
    # restoring casts to the target's dtype
    f64 = tree_map(lambda t: t.double(), tree)
    got = ckpt.restore_pytree(f64, d, device="cpu")
    assert all(t.dtype == torch.float64 for t in tree_leaves(got))


def test_corrupt_chunk_raises(tmp_path):
    tree = as_torch(numpy_tree(4))
    d = str(tmp_path / "ck")
    ckpt.save_pytree(tree, d, codec="zlib")
    victim = os.path.join(d, "w.zlib")
    blob = bytearray(open(victim, "rb").read())
    blob[10] ^= 0xFF
    open(victim, "wb").write(bytes(blob))
    with pytest.raises(ValueError, match="corrupt chunk in w"):
        ckpt.restore_pytree(tree, d, device="cpu")


def test_restore_refuses_what_is_not_there(tmp_path):
    tree = as_torch(numpy_tree(5))
    d = str(tmp_path / "ck")
    with pytest.raises(FileNotFoundError):
        ckpt.restore_pytree(tree, d, device="cpu")
    ckpt.save_pytree(tree, d, codec="zlib")
    with pytest.raises(KeyError):
        ckpt.restore_pytree({**tree, "extra": torch.zeros(2)}, d,
                            device="cpu")
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_pytree({**tree, "w": torch.zeros(2)}, d, device="cpu")


def test_uncommitted_step_is_invisible_and_collected(tmp_path):
    tree = as_torch(numpy_tree())
    root = str(tmp_path / "root")
    mgr = CheckpointManager(root)
    mgr.save(1, tree, blocking=True)
    os.makedirs(os.path.join(root, "step_2"))     # a torn write
    assert mgr.latest_step() == 1
    CheckpointManager(root)
    assert not os.path.exists(os.path.join(root, "step_2"))


def test_keep_n(tmp_path):
    tree = as_torch(numpy_tree())
    mgr = CheckpointManager(str(tmp_path / "r"), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree, blocking=True)
    assert mgr.steps() == [3, 4]


def test_restore_or_init(tmp_path):
    tree = as_torch(numpy_tree())
    mgr = CheckpointManager(str(tmp_path / "r"))
    got, step = mgr.restore_or_init(tree, lambda: tree, device="cpu")
    assert step == 0 and got is tree
    mgr.save(7, tree)                  # async
    mgr.wait()
    got, step = mgr.restore_or_init(tree, lambda: None, device="cpu")
    assert step == 7
    for a, b in zip(tree_leaves(got), tree_leaves(tree)):
        assert torch.equal(a, b)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(tree,
                                                          device="cpu")


def test_async_save_error_raises_at_wait(tmp_path, monkeypatch):
    from repro_torch.checkpoint import manager as mgr_mod
    tree = as_torch(numpy_tree())
    mgr = CheckpointManager(str(tmp_path / "r"))

    def broken(*args, **kwargs):
        raise OSError("disk full")
    monkeypatch.setattr(mgr_mod, "save_pytree", broken)
    mgr.save(1, tree)                  # returns; the error is held
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()                         # raised once
    assert mgr.steps() == []


def test_save_snapshots_before_returning(tmp_path):
    """What is saved is the tree at `save()`, whatever the caller does
    to its tensors afterwards."""
    tree = {"w": torch.ones(1000)}
    mgr = CheckpointManager(str(tmp_path / "r"))
    mgr.save(1, tree)
    tree["w"].mul_(3)
    mgr.wait()
    got = mgr.restore({"w": torch.zeros(1000)}, device="cpu")
    assert torch.equal(got["w"], torch.ones(1000))
