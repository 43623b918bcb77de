"""Parameter schema: one declaration drives init, abstract shapes (the
allocation-free dry run) and the counts (the port of the reference's
`models/params.py`, same init rules).

A schema is a nested dict of `Param` leaves; `init_params` draws every
leaf from one explicit `torch.Generator` in sorted-key order, so a seed
fixes the whole tree. The reference's JAX keys give other numbers from
the same seed; weights cross between the two through `repro_torch.bridge`.
`abstract_params` gives tensors on `torch.device("meta")`, PyTorch's
counterpart of the reference's `ShapeDtypeStruct`s. Each leaf names the
logical axis of each dim (`Param.axes`, `logical_axes`), which
`repro_torch.launch.shardings` resolves to mesh axes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class Param:
    shape: Tuple[int, ...]
    #: logical axis name per dim (None = replicated); None = all None
    axes: Optional[Tuple[Optional[str], ...]] = None
    init: str = "normal"                # normal | zeros | ones | embed
    fan_in_axes: Tuple[int, ...] = ()   # dims forming fan-in for scaling

    def __post_init__(self):
        if self.axes is None:
            object.__setattr__(self, "axes", (None,) * len(self.shape))
        if len(self.axes) != len(self.shape):
            raise ValueError(f"Param axes {self.axes} do not match its "
                             f"shape {self.shape}")


Schema = Dict[str, Any]  # nested dict with Param leaves

#: f32 bytes of a stacked leaf's draw past which `init_params` draws it
#: one slice at a time: 8 GiB, a tenth of the card, so that every model
#: up to granite-8b keeps its whole-leaf draws (stablelm-12b's and
#: qwen3-32b's MLP leaves are sliced)
SLICED_DRAW_BYTES = 8 << 30


def init_params(schema: Schema, generator: torch.Generator,
                dtype=torch.bfloat16, device=None,
                keep=None) -> Dict[str, Any]:
    """Concrete parameters for `schema` on `device` (default: the CUDA
    card): ones/zeros as named, else normal * scale with scale 0.02 for
    embeddings and 1/sqrt(fan_in) otherwise (fan_in = the product of
    `fan_in_axes`, else dim 0).

    A stacked leaf (3 or more dims) whose f32 draw would pass
    `SLICED_DRAW_BYTES` is drawn one slice of its leading axis at a
    time, in order, so the f32 temporary is one slice (0.5 GB for
    qwen3-32b's `w_gate`, not its 33.5 GB). On the CPU this gives the
    numbers of one whole draw: the generator fills 16 values at a time,
    and each slice is a whole number of 16 (else the leaf is drawn
    whole). On the card a sliced leaf's numbers differ from a whole
    draw's (they are as fixed by the seed); every leaf under the limit
    is drawn whole, with the numbers it always had.

    `keep(param, tensor)` (optional) gives what is kept of each leaf as
    soon as it is drawn (`bridge.init_shards`: one rank's shard), so at
    most one whole leaf is alive beside what was kept; the draws, and
    so the numbers, are the same."""
    device = resolve_device(device)
    out = {}
    for key in sorted(schema):
        p = schema[key]
        if isinstance(p, dict):
            out[key] = init_params(p, generator, dtype, device, keep)
            continue
        if p.init == "zeros":
            out[key] = torch.zeros(p.shape, dtype=dtype, device=device)
        elif p.init == "ones":
            out[key] = torch.ones(p.shape, dtype=dtype, device=device)
        else:
            fan_in = (math.prod(p.shape[i] for i in p.fan_in_axes)
                      if p.fan_in_axes else p.shape[0] if p.shape else 1)
            scale = 0.02 if p.init == "embed" else \
                1.0 / math.sqrt(max(fan_in, 1))
            if len(p.shape) >= 3 and math.prod(p.shape[1:]) % 16 == 0 \
                    and 4 * math.prod(p.shape) > SLICED_DRAW_BYTES:
                w = torch.empty(p.shape, dtype=dtype, device=device)
                for i in range(p.shape[0]):
                    w[i] = _normal(p.shape[1:], generator, scale, device)
                out[key] = w
            else:
                out[key] = _normal(p.shape, generator, scale,
                                   device).to(dtype)
        if keep is not None:
            out[key] = keep(p, out[key])
    return out


def _normal(shape, generator, scale, device) -> torch.Tensor:
    """f32 normal draws of `shape`, times `scale`."""
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device).mul_(scale)


def _leaves(schema: Schema):
    for key in sorted(schema):
        p = schema[key]
        yield from (_leaves(p) if isinstance(p, dict) else [p])


def abstract_params(schema: Schema, dtype=torch.bfloat16) -> Dict[str, Any]:
    """The parameters' shapes and dtype as tensors on the meta device,
    keyed in `init_params`' order (a step walks them as it walks drawn
    parameters): nothing is allocated."""
    return {k: abstract_params(schema[k], dtype)
            if isinstance(schema[k], dict)
            else torch.empty(schema[k].shape, dtype=dtype, device="meta")
            for k in sorted(schema)}


def logical_axes(schema: Schema) -> Dict[str, Any]:
    """The schema's tree with each leaf's logical axes in its place."""
    return {k: logical_axes(p) if isinstance(p, dict) else p.axes
            for k, p in schema.items()}


def param_bytes(schema: Schema, dtype_bytes: int = 2) -> int:
    return sum(math.prod(p.shape) for p in _leaves(schema)) * dtype_bytes


def count_params(schema: Schema) -> int:
    return sum(math.prod(p.shape) for p in _leaves(schema))
