#!/usr/bin/env python3
"""How rounding P to bf16 moves the flash kernel's bf16 output against
the plain version, on the CPU.

    python3 scripts/bf16_p_rounding.py [--seeds 3] [--batch 1]

The flash kernel feeds P (the softmax numerators, f32 in [0, 1]) to the
tensor cores as bf16. This repeats the kernel's arithmetic in PyTorch
at the prefill shape (S=2304, H=16 over KH=8, D=128, causal, random
bf16 inputs from each seed) with P rounded once to bf16 and with P as
bf16 hi + lo, rounds out to bf16, and prints against
`ref.flash_attention_ref`: the largest error, and how many values with
|out| >= 2 (where one bf16 step, 0.0156, exceeds the 1e-2 tolerance)
round differently.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.kernels import ref  # noqa: E402


def kernel_like(q, k, v, split: bool) -> torch.Tensor:
    """Causal attention with P given to P.V as bf16 (hi, or hi + lo)."""
    rep = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(rep, 2)
    v = v.repeat_interleave(rep, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s * q.shape[-1] ** -0.5
    S = q.shape[1]
    s = torch.where(torch.arange(S)[None] <= torch.arange(S)[:, None], s,
                    ref.NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    hi = p.bfloat16().float()
    pp = hi + (p - hi).bfloat16().float() if split else hi
    o = torch.einsum("bhqk,bkhd->bqhd", pp.double(), v.double())
    return (o.float() / l.transpose(1, 2)).bfloat16()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--batch", type=int, default=1)
    args = ap.parse_args()
    B, S, H, KH, D = args.batch, 2304, 16, 8, 128
    for seed in range(args.seeds):
        gen = torch.Generator().manual_seed(seed)
        q, k, v = (torch.randn(shape, generator=gen).bfloat16()
                   for shape in ((B, S, H, D), (B, S, KH, D), (B, S, KH, D)))
        want = ref.flash_attention_ref(q, k, v, causal=True).float()
        big = want.abs() >= 2
        for split in (False, True):
            got = kernel_like(q, k, v, split).float()
            print(f"seed {seed} P as bf16 {'hi + lo' if split else 'hi   '}"
                  f": max err {(got - want).abs().max().item():.4f}, "
                  f"{int(((got != want) & big).sum())} of {int(big.sum())} "
                  f"values with |out| >= 2 round differently", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
