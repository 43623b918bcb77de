"""Attention access-pattern traces for the placement simulator.

The port's copy of the reference's `core/traces.py` (numpy only).

The paper records layerwise attention scores from LLaMA-3.1-8B on
LongBench (30k-token prompts, 10k decoded tokens) and uses them as the
access pattern. We provide:

  * `synthetic_trace` — a generative model with the two knobs the paper's
    sensitivity study varies: attention *sparsity* (fraction of past
    tokens excluded per step) and *importance variation* (how fast the
    set of important tokens drifts). Importance is spatially clustered
    (heavy-hitter pages + attention sinks + a recency window), matching
    the published observations that motivate Quest-style paging.
  * `trace_from_scores` — build a trace from real attention scores
    (e.g. captured from `repro_torch.models` on CPU) by thresholding to a
    sparsity target.

A `Trace` is page-granular: `access[s, p]` says whether page `p` is read
at decode step `s`. Pages hold `page_tokens` tokens; page `p` exists once
`page_born[p] <= s`. Token granularity is the special case
`page_tokens=1`.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Trace:
    access: np.ndarray        # bool [steps, num_pages]
    page_born: np.ndarray     # int32 [num_pages] — step at which page exists
    page_tokens: int
    prompt_len: int           # tokens
    decode_len: int           # steps == decoded tokens
    sparsity: float           # realized mean sparsity (fraction skipped)

    @property
    def num_steps(self) -> int:
        return self.access.shape[0]

    @property
    def num_pages(self) -> int:
        return self.access.shape[1]

    def alive(self, step: int) -> np.ndarray:
        return self.page_born <= step

    def validate(self) -> None:
        # Invariant: a page is never accessed before it exists.
        steps = np.arange(self.num_steps)[:, None]
        premature = self.access & (self.page_born[None, :] > steps)
        assert not premature.any(), "access before page birth"


def _pages_for(tokens: int, page_tokens: int) -> int:
    return -(-tokens // page_tokens)


def synthetic_trace(
    prompt_len: int,
    decode_len: int,
    *,
    page_tokens: int = 16,
    sparsity: float = 0.6,
    variation: float = 0.3,
    sink_pages: int = 4,
    recency_pages: int = 8,
    heavy_frac: float = 0.08,
    seed: int = 0,
) -> Trace:
    """Clustered, drifting attention access pattern.

    variation in [0, 1]: 0 -> the important-page set is frozen;
    1 -> it is resampled every step (paper's "high variation").
    Importance follows an AR(1) (Ornstein-Uhlenbeck-like) process over a
    lognormal heavy-hitter base, so a `heavy_frac` subset of pages
    dominates at any instant but the subset drifts at rate `variation`.
    """
    rng = np.random.default_rng(seed)
    prompt_pages = _pages_for(prompt_len, page_tokens)
    total_pages = _pages_for(prompt_len + decode_len, page_tokens)

    # Birth step of each page: prompt pages exist at step 0; decode pages
    # appear as tokens are generated.
    page_born = np.zeros(total_pages, dtype=np.int32)
    for p in range(prompt_pages, total_pages):
        first_token = p * page_tokens  # global token index
        page_born[p] = max(0, first_token - prompt_len)

    # Base importance: lognormal heavy hitters (a small fraction of pages
    # carries most attention mass, as in H2O / Quest observations).
    base = rng.lognormal(mean=0.0, sigma=2.0, size=total_pages)
    heavy = rng.random(total_pages) < heavy_frac
    base[heavy] *= 10.0

    # AR(1) drift: score_t = rho * score_{t-1} + (1-rho) * noise_t
    rho = 1.0 - variation
    access = np.zeros((decode_len, total_pages), dtype=bool)
    score = base * rng.lognormal(0.0, 1.0, size=total_pages)
    keep_frac = max(1.0 - sparsity, 1e-3)

    realized_reads = 0
    realized_alive = 0
    for s in range(decode_len):
        if variation > 0:
            noise = base * rng.lognormal(0.0, 1.0, size=total_pages)
            score = rho * score + (1.0 - rho) * noise
        alive = page_born <= s
        n_alive = int(alive.sum())
        k = max(1, int(round(keep_frac * n_alive)))
        # Top-k alive pages by current importance score.
        masked = np.where(alive, score, -np.inf)
        top = np.argpartition(masked, -k)[-k:]
        row = access[s]
        row[top] = True
        # Attention sinks: first pages are always read.
        row[:min(sink_pages, n_alive)] = True
        # Recency window: latest alive pages always read.
        alive_idx = np.nonzero(alive)[0]
        row[alive_idx[-recency_pages:]] = True
        row &= alive
        realized_reads += int(row.sum())
        realized_alive += n_alive

    realized_sparsity = 1.0 - realized_reads / max(realized_alive, 1)
    tr = Trace(
        access=access,
        page_born=page_born,
        page_tokens=page_tokens,
        prompt_len=prompt_len,
        decode_len=decode_len,
        sparsity=float(realized_sparsity),
    )
    tr.validate()
    return tr


def trace_from_scores(
    scores: np.ndarray,
    prompt_len: int,
    *,
    page_tokens: int = 16,
    sparsity: float = 0.6,
    sink_pages: int = 2,
    recency_pages: int = 4,
) -> Trace:
    """Build a trace from real attention scores.

    scores: [decode_steps, total_tokens] nonneg attention mass that step
            assigns to each past token (zero for not-yet-generated ones).
    A page is accessed if its pooled score is in the top-(1-sparsity)
    fraction of alive pages at that step.
    """
    decode_len, total_tokens = scores.shape
    num_pages = _pages_for(total_tokens, page_tokens)
    pad = num_pages * page_tokens - total_tokens
    if pad:
        scores = np.pad(scores, ((0, 0), (0, pad)))
    # Max-pool token scores to page scores (Quest-style page metadata).
    page_scores = scores.reshape(decode_len, num_pages, page_tokens).max(-1)

    page_born = np.zeros(num_pages, dtype=np.int32)
    for p in range(_pages_for(prompt_len, page_tokens), num_pages):
        page_born[p] = max(0, p * page_tokens - prompt_len)

    access = np.zeros((decode_len, num_pages), dtype=bool)
    keep_frac = max(1.0 - sparsity, 1e-3)
    for s in range(decode_len):
        alive = page_born <= s
        n_alive = int(alive.sum())
        k = max(1, int(round(keep_frac * n_alive)))
        masked = np.where(alive, page_scores[s], -np.inf)
        top = np.argpartition(masked, -k)[-k:]
        row = access[s]
        row[top] = True
        row[:min(sink_pages, n_alive)] = True
        alive_idx = np.nonzero(alive)[0]
        row[alive_idx[-recency_pages:]] = True
        row &= alive
        access[s] = row

    realized = 1.0 - access.sum() / max((page_born[None, :] <=
                                         np.arange(decode_len)[:, None]).sum(), 1)
    tr = Trace(access=access, page_born=page_born, page_tokens=page_tokens,
               prompt_len=prompt_len, decode_len=decode_len,
               sparsity=float(realized))
    tr.validate()
    return tr
