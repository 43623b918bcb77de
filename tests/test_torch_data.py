"""The port's data pipeline (its own numpy copy) against the
reference's: batches bitwise equal for several (seed, shard, step) and
configurations, skip-ahead equal to stepping, and every batch a pure
function of (seed, shard, step)."""

import itertools

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import pipeline as jpipe  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

CONFIGS = [dict(vocab=256, seq_len=33, global_batch=4),
           dict(vocab=92544, seq_len=64, global_batch=8, num_shards=2,
                seed=7),
           dict(vocab=1000, seq_len=17, global_batch=6, num_shards=3,
                seed=123, zipf_a=1.5, ngram=2)]


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: str(kw["vocab"]))
def test_batches_equal_the_reference(kw):
    jc = jpipe.SyntheticCorpus(jpipe.DataConfig(**kw))
    tc = tpipe.SyntheticCorpus(tpipe.DataConfig(**kw))
    for shard, step in itertools.product(range(kw.get("num_shards", 1)),
                                         (0, 1, 5, 1000)):
        want = jc.batch(shard, step)["tokens"]
        got = tc.batch(shard, step)["tokens"]
        assert got.dtype == want.dtype == np.int32
        assert got.shape == (kw["global_batch"] // kw.get("num_shards", 1),
                             kw["seq_len"])
        np.testing.assert_array_equal(got, want)


def test_skip_ahead_equals_stepping():
    cfg = tpipe.DataConfig(vocab=512, seq_len=24, global_batch=4,
                           num_shards=2, seed=3)
    stepped = tpipe.make_batches(cfg, shard=1)
    for _ in range(6):
        next(stepped)
    ahead = next(tpipe.make_batches(cfg, shard=1, start_step=6))
    np.testing.assert_array_equal(next(stepped)["tokens"], ahead["tokens"])
    ref = next(jpipe.make_batches(jpipe.DataConfig(
        vocab=512, seq_len=24, global_batch=4, num_shards=2, seed=3),
        shard=1, start_step=6))
    np.testing.assert_array_equal(ahead["tokens"], ref["tokens"])


def test_batch_is_a_pure_function_of_seed_shard_step():
    cfg = tpipe.DataConfig(vocab=300, seq_len=16, global_batch=2)
    a = tpipe.SyntheticCorpus(cfg)
    b = tpipe.SyntheticCorpus(cfg)
    np.testing.assert_array_equal(b.batch(0, 9)["tokens"],
                                  a.batch(0, 9)["tokens"])
    assert not np.array_equal(a.batch(0, 9)["tokens"],
                              a.batch(0, 10)["tokens"])
    other = tpipe.SyntheticCorpus(tpipe.DataConfig(vocab=300, seq_len=16,
                                                   global_batch=2, seed=1))
    assert not np.array_equal(a.batch(0, 9)["tokens"],
                              other.batch(0, 9)["tokens"])
