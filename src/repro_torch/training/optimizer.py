"""AdamW and its cosine schedule as plain functions over the parameter
tree (the port of the reference's `training/optimizer.py`).

The parameters stay in their own dtype (bf16 at full width), with no
f32 master copy, as in the reference; m and v are f32, the global-norm
clip and the update are taken in f32 and the result cast back per leaf
(`(p.float() - lr * u).to(p.dtype)`). That is why this is not
`torch.optim.AdamW`, which would update bf16 parameters in bf16.

The arithmetic runs through `kernels.ops`: on the card the hand-written
kernels (`csrc/adamw.cu`), one launch for the whole tree of each of the
norm's sums (`grad_sumsq`) and the update (`adamw_apply`), the update
bitwise the plain version's for the same scalars; on the CPU the plain
versions (`kernels/ref.py`), the reference's arithmetic op for op.
`adamw_update` is pure by default: it returns new tensors and leaves
its arguments as they were. With `donate=True` — the counterpart of the
reference CLI's `jax.jit(..., donate_argnums=(0,))` — it writes the new
parameters, m and v into the given tensors and returns those, so the
update holds p, g, m and v alone (12 bytes a parameter with bf16
weights) where the pure one also holds their new copies.

Across a mesh (`make_train_step(..., mesh=)`) the trees are a rank's
shards, m and v held as the parameters are (ZeRO-style, as the
reference's state is sharded with the parameters' specs): the update
is elementwise, so it runs on the shards as they are; only the global
norm needs the mesh, through `across`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor      # int32 scalar, on the parameters' device
    m: Any                  # f32 tree shaped as the parameters
    v: Any


def adamw_init(params) -> AdamWState:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                   params),
        v=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                   params))


def cosine_schedule(step, *, peak_lr=3e-4, warmup=100, total=10_000,
                    min_frac=0.1):
    """Linear warm-up to `peak_lr`, then a cosine down to
    `min_frac * peak_lr` at `total`, in f32; `step` a tensor."""
    step = step.float()
    warm = peak_lr * step / max(warmup, 1)
    t = ((step - warmup) / max(total - warmup, 1)).clamp(0.0, 1.0)
    cos = peak_lr * (min_frac + (1 - min_frac) * 0.5
                     * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup, warm, cos)


def global_norm(grads, across: Optional[Callable] = None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares
    (`ops.grad_sumsq`), in leaf order. `across` (a meshed step's): maps
    the vector of the rank's per-leaf sums over its blocks to each
    leaf's sum over the whole model, so every element counts once and
    every rank gets the same norm."""
    sums = ops.grad_sumsq(tree_leaves(grads))
    if across is not None:
        sums = across(sums)
    return torch.sqrt(sum(sums.unbind()))


def adamw_update(grads, state: AdamWState, params, *, lr=None,
                 b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                 grad_clip=1.0, across: Optional[Callable] = None,
                 gnorm: Optional[torch.Tensor] = None, donate: bool = False
                 ) -> Tuple[Any, AdamWState]:
    """One AdamW step: (new params, new state). `lr` a float, a tensor
    or a function of the new step (e.g. a `cosine_schedule` with its
    own warm-up); None takes `cosine_schedule` of the new step.
    `across`: `global_norm`'s, for a rank's shards. `gnorm`: the
    gradients' global norm where the caller has it already (it is then
    not read again). `donate`: write the new parameters, m and v into
    `params`, `state.m` and `state.v` and return those tensors (the
    step count is a new tensor either way)."""
    step = state.step + 1
    if lr is None:
        lr = cosine_schedule(step)
    elif callable(lr):
        lr = lr(step)

    # global-norm clip
    if gnorm is None:
        gnorm = global_norm(grads, across)
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    stepf = step.float()
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)

    ins = [tree_leaves(t) for t in (params, state.m, state.v)]
    outs = ins if donate else [
        [torch.empty_like(t, memory_format=torch.contiguous_format)
         for t in leaves] for leaves in ins]
    ops.adamw_apply(tree_leaves(grads), *ins, *outs, scale=scale, lr=lr,
                    bc1=bc1, bc2=bc2, b1=b1, b2=b2, eps=eps,
                    weight_decay=weight_decay)
    new_params, m, v = (tree_unflatten(tree, leaves) for tree, leaves in
                        zip((params, state.m, state.v), outs))
    return new_params, AdamWState(step=step, m=m, v=v)
