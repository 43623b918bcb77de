"""Token sampling for the serve loop (the port of the reference's
`serving/sampling.py`).

`make_sampler(cfg)` returns `(logits [B, V], keys [B, 2], counter [B])
-> tokens [B]`. Greedy decoding (temperature 0) is a plain argmax over
every lane and reads neither keys nor counter. Otherwise every lane
draws one uniform from a counter-based hash of its key and its counter
(`uniforms`), in fixed-shape integer ops on the logits' device, and
samples by inverse CDF over its filtered probabilities. A lane's key
comes from (serve seed, request id) alone (`lane_key`) and the engine
passes the tokens the request still has to draw as its counter, so a
request's tokens depend only on its own key and logits, never on the
batch company or on the step; and nothing reads a device value back to
the host, so a CUDA graph can hold the draw. The reference's JAX PRNG
keys give other numbers from the same seed, so sampled streams are
checked within the port only.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

_MASK32 = 0xFFFF_FFFF


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


def lane_key(seed: int, rid: int) -> np.ndarray:
    """A request's sampling key, derived from (seed, rid) only: two
    32-bit words, int64 [2]."""
    state = np.random.SeedSequence([seed, rid]).generate_state(2, np.uint32)
    return state.astype(np.int64)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32) held in int64, in 16-bit
    halves so that no product leaves int64's positive range."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer (xor-shift-multiply), int64 in and
    out, values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def uniforms(keys: torch.Tensor, counter: torch.Tensor) -> torch.Tensor:
    """One uniform in [0, 1) per lane, float64 [B], a function of the
    lane's key (int64 [B, 2]) and counter (int [B]) alone: two hashed
    32-bit words give 53 bits."""
    c = counter.to(torch.int64) & _MASK32
    k0, k1 = keys[:, 0], keys[:, 1]
    words = [_hash32(k1 ^ _hash32(k0 ^ _hash32(c ^ (0x9E3779B9 * j
                                                     & _MASK32))))
             for j in (1, 2)]
    bits = (words[0] >> 6) * (1 << 26) + (words[1] >> 6)
    return bits.to(torch.float64) * 2.0 ** -52


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


def inverse_cdf(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Token of each row whose cumulative probability first passes
    u * total (u float64 [B] in [0, 1)), int32 [B]: always a token of
    nonzero probability (the last one where rounding would pass the
    end)."""
    cdf = torch.cumsum(probs.to(torch.float64), dim=-1)
    at = (cdf <= (u * cdf[:, -1])[:, None]).sum(-1)
    ar = torch.arange(probs.shape[-1], device=probs.device)
    last = torch.where(probs > 0, ar, 0).amax(-1)
    return torch.minimum(at, last).to(torch.int32)


def make_sampler(cfg: SamplingConfig) -> Callable:
    """Build `(logits [B, V], keys [B, 2], counter [B]) -> tokens [B]`."""
    if cfg.temperature <= 0.0:
        def greedy(logits, keys=None, counter=None):
            del keys, counter
            return logits.argmax(dim=-1).to(torch.int32)
        return greedy

    def sample(logits, keys, counter):
        x = logits.float() / cfg.temperature
        if cfg.top_k > 0:
            x = _top_k_filter(x, cfg.top_k)
        if cfg.top_p < 1.0:
            x = _top_p_filter(x, cfg.top_p)
        return inverse_cdf(torch.softmax(x, dim=-1), uniforms(keys, counter))

    return sample
