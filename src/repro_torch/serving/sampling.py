"""Token sampling for the serve loop (the port of the reference's
`serving/sampling.py`).

`make_sampler(cfg)` returns `(logits [B, V], generators, lanes) ->
tokens [B]`. Greedy decoding (temperature 0) is a plain argmax over
every lane and touches no generator. Otherwise each lane draws from its
own `torch.Generator`, seeded from (serve seed, request id) by
`lane_generator`, and only the lanes in `lanes` draw: a request's
tokens then depend only on its own key and logits, never on the batch
company. The reference's JAX PRNG keys give other numbers from the same
seed, so sampled streams are checked within the port only.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Sampling knobs: temperature 0 is greedy argmax."""

    #: 0.0 = greedy argmax
    temperature: float = 0.0
    #: keep only the k most likely tokens (0 = off)
    top_k: int = 0
    #: nucleus sampling: keep the smallest set of tokens whose
    #: cumulative probability reaches top_p (1.0 = off)
    top_p: float = 1.0


def lane_generator(seed: int, rid: int, device) -> torch.Generator:
    """A request's sampling generator, derived from (seed, rid) only."""
    state = np.random.SeedSequence([seed, rid]).generate_state(1, np.uint64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) & 0x7FFF_FFFF_FFFF_FFFF)
    return gen


def _top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    kth = torch.sort(logits, dim=-1, descending=True).values[..., k - 1:k]
    return torch.where(logits >= kth, logits, float("-inf"))


def _top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Keep every token whose cumulative probability BEFORE it is below
    top_p, so at least the most likely token survives."""
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc, dim=-1)
    cum_before = torch.cumsum(probs, dim=-1) - probs
    keep = cum_before < top_p
    thresh = torch.where(keep, sorted_desc, float("inf")).amin(
        dim=-1, keepdim=True)
    return torch.where(logits >= thresh, logits, float("-inf"))


def make_sampler(cfg: SamplingConfig) -> Callable:
    """Build `(logits [B, V], generators, lanes [B] bool) -> tokens [B]`."""
    if cfg.temperature <= 0.0:
        def greedy(logits, generators=None, lanes=None):
            del generators, lanes
            return logits.argmax(dim=-1).to(torch.int32)
        return greedy

    def sample(logits, generators: Sequence[torch.Generator], lanes):
        x = logits.float() / cfg.temperature
        if cfg.top_k > 0:
            x = _top_k_filter(x, cfg.top_k)
        if cfg.top_p < 1.0:
            x = _top_p_filter(x, cfg.top_p)
        probs = torch.softmax(x, dim=-1)
        out = torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)
        for b in torch.nonzero(lanes).flatten().tolist():
            out[b] = torch.multinomial(probs[b], 1,
                                       generator=generators[b])[0]
        return out

    return sample
