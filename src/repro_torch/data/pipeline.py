"""Deterministic, shardable synthetic data pipeline (the port's own copy
of the reference's `data/pipeline.py`: numpy only, and batches bitwise
equal to the reference's for every (seed, shard, step)).

Fault-tolerance property used by the runtime: batch (shard, step) is a
pure function of (seed, shard, step) — any worker can recompute any
other worker's batch, so a failed/straggling data worker is replaced by
skip-ahead recomputation instead of replay logs. This is the standard
deterministic-input-pipeline trick used by large-scale trainers.

The corpus is a Zipfian token stream with injected n-gram structure so
losses actually decrease during the example runs (pure uniform noise
gives a flat loss and hides wiring bugs).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    num_shards: int = 1
    seed: int = 0
    zipf_a: float = 1.2
    ngram: int = 3        # injected structure order


class SyntheticCorpus:
    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.num_shards == 0
        self.cfg = cfg
        base = np.random.default_rng(cfg.seed)
        # fixed n-gram transition table: next-token = f(prev) with noise
        self._succ = base.integers(0, cfg.vocab,
                                   size=(cfg.ngram, cfg.vocab))

    def batch(self, shard: int, step: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, shard, step)."""
        cfg = self.cfg
        per_shard = cfg.global_batch // cfg.num_shards
        rng = np.random.default_rng(
            (cfg.seed, shard, step))          # independent stream
        # Zipf-distributed seeds + deterministic n-gram continuation
        out = np.empty((per_shard, cfg.seq_len), np.int32)
        cur = (rng.zipf(cfg.zipf_a, size=per_shard) - 1) % cfg.vocab
        out[:, 0] = cur
        for t in range(1, cfg.seq_len):
            use_struct = rng.random(per_shard) < 0.8
            nxt_struct = self._succ[t % cfg.ngram, cur]
            nxt_rand = (rng.zipf(cfg.zipf_a, size=per_shard) - 1) % cfg.vocab
            cur = np.where(use_struct, nxt_struct, nxt_rand).astype(np.int32)
            out[:, t] = cur
        return {"tokens": out}


def make_batches(cfg: DataConfig, shard: int,
                 start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    corpus = SyntheticCorpus(cfg)
    step = start_step
    while True:
        yield corpus.batch(shard, step)
        step += 1
