"""Parameter schema: one declaration drives init (the port of the
reference's `models/params.py`, same init rules).

A schema is a nested dict of `Param` leaves; `init_params` draws every
leaf from one explicit `torch.Generator` in sorted-key order, so a seed
fixes the whole tree. The reference's JAX keys give other numbers from
the same seed; weights cross between the two through `repro_torch.bridge`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Param:
    shape: Tuple[int, ...]
    init: str = "normal"                # normal | zeros | ones | embed
    fan_in_axes: Tuple[int, ...] = ()   # dims forming fan-in for scaling


Schema = Dict[str, Any]  # nested dict with Param leaves


def init_params(schema: Schema, generator: torch.Generator,
                dtype=torch.bfloat16, device="cpu") -> Dict[str, Any]:
    """Concrete parameters for `schema`: ones/zeros as named, else
    normal * scale with scale 0.02 for embeddings and 1/sqrt(fan_in)
    otherwise (fan_in = the product of `fan_in_axes`, else dim 0)."""
    out = {}
    for key in sorted(schema):
        p = schema[key]
        if isinstance(p, dict):
            out[key] = init_params(p, generator, dtype, device)
        elif p.init == "zeros":
            out[key] = torch.zeros(p.shape, dtype=dtype, device=device)
        elif p.init == "ones":
            out[key] = torch.ones(p.shape, dtype=dtype, device=device)
        else:
            fan_in = (math.prod(p.shape[i] for i in p.fan_in_axes)
                      if p.fan_in_axes else p.shape[0] if p.shape else 1)
            scale = 0.02 if p.init == "embed" else \
                1.0 / math.sqrt(max(fan_in, 1))
            w = torch.randn(p.shape, generator=generator,
                            dtype=torch.float32, device=device)
            out[key] = (w * scale).to(dtype)
    return out
