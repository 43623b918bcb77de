"""PyTorch/CUDA port of the two-tier KV placement serving stack.

The JAX package `repro` is the reference; this package mirrors its
module paths (`repro_torch.serving.engine` is the counterpart of
`repro.serving.engine`, and so on) and imports nothing of it. The
paged decode attention and the prefill attention, forward and backward,
run in hand-written CUDA kernels for Hopper
(`repro_torch/csrc/paged_attention.cu`, `flash_attention.cu`,
`flash_attention_bwd.cu`); every other op is plain PyTorch.

Entry points run on the card unless the caller asks for the CPU:
`resolve_device(None)` is "cuda", and raises when no card is present,
so a run never drops to the CPU without being asked to. The meta device
(shapes only, no data) is taken when asked for: the dry run
(`launch.dryrun`) builds its parameters, state and inputs there.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` if given ("cuda",
    "cpu" or "meta"), else the current CUDA card. Raises when CUDA is
    asked for (explicitly or by default) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card by default and none is "
            "available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
