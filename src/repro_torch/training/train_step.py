"""Training step: next-token loss, gradients, AdamW, remat (the port of
the reference's `training/train_step.py`).

Written against the `Model` facade, so every family trains through the
same entry point. The gradient is torch's autograd; on the card the
whole-sequence attention inside it is the hand-written flash kernel
forward and backward (`kernels.flash_attention.FlashAttention`), on the
CPU the plain version. Gradient accumulation in f32 and a bf16 compute /
f32 optimizer-state split are built in, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
import torch.utils.checkpoint

from repro_torch.models.model import Model
from repro_torch.training.optimizer import (
    AdamWState, adamw_init, adamw_update, global_norm,
)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: AdamWState


def _chunk_loss(h_blk, t_blk, w):
    """Summed next-token NLL of one sequence chunk: its [B, c, V]
    logits `(h @ w).float()` (the reference's precision), taken under
    checkpointing so no chunk's logits outlive it."""
    logits = (h_blk @ w).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, t_blk[..., None])[..., 0]
    return (logz - gold).sum()


def loss_fn(model: Model, params, tokens, *, extra: Optional[Dict] = None,
            logit_chunk: int = 512):
    """Causal LM loss. tokens [B, S]; shift-by-one inside.

    The [B, S, vocab] logits are never materialized: the hidden states
    are unembedded `logit_chunk` positions at a time, each chunk under
    `torch.utils.checkpoint`, so the backward recomputes one chunk's
    logits at a time (peak ~ B * chunk * vocab f32); the blocks of the
    forward are checkpointed too (`forward_hidden`'s remat). The vlm
    family's loss runs over the text tail only; tied embeddings unembed
    through `embed`."""
    cfg = model.cfg
    hidden = model.forward_hidden(params, tokens[:, :-1], extra=extra)
    # VLM prepends patch embeddings: loss only over the text tail
    if cfg.family == "vlm":
        hidden = hidden[:, -(tokens.shape[1] - 1):]
    targets = tokens[:, 1:].long()
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    B, S, _ = hidden.shape
    c = min(logit_chunk, S)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s0 in range(0, S, c):
        total = total + torch.utils.checkpoint.checkpoint(
            _chunk_loss, hidden[:, s0:s0 + c], targets[:, s0:s0 + c], w,
            use_reentrant=False)
    return total / (B * S)


def value_and_grad(model: Model, params, tokens, extra=None):
    """(loss, grads shaped as `params`) of `loss_fn`, by autograd. The
    parameters are not modified: the graph runs on detached aliases."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(model, tree_unflatten(params, leaves), tokens,
                       extra=extra)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(model: Model, *, accum_steps: int = 1,
                    extra_keys: tuple = (), lr=None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    batch: {"tokens": [B, S]} (+ modality extras, named by
    `extra_keys`), tensors on the parameters' device. With
    accum_steps > 1 the batch's leading dim is split into micro-batches
    and gradients are accumulated in f32 before one optimizer update.
    metrics: {"loss", "grad_norm", "step"}, tensors on the device (no
    host sync inside the step)."""

    def train_step(state: TrainState, batch: Dict) -> tuple:
        tokens = batch["tokens"]
        extra = {k: batch[k] for k in extra_keys} or None

        if accum_steps == 1:
            loss, grads = value_and_grad(model, state.params, tokens, extra)
        else:
            mb = tokens.shape[0] // accum_steps
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for i in range(accum_steps):
                sl = slice(i * mb, (i + 1) * mb)
                ex = None if extra is None else {
                    k: v[sl] for k, v in extra.items()}
                l_i, g = value_and_grad(model, state.params, tokens[sl], ex)
                grads = tree_map(lambda a, b: a + b.float(), grads, g)
                loss = loss + l_i
            grads = tree_map(lambda g: g / accum_steps, grads)
            loss = loss / accum_steps

        params, opt = adamw_update(grads, state.opt, state.params, lr=lr)
        return TrainState(params=params, opt=opt), {
            "loss": loss, "grad_norm": global_norm(grads), "step": opt.step}

    return train_step


def init_train_state(model: Model, seed=0, device=None) -> TrainState:
    """Random parameters (`Model.init(seed, device)`; default device the
    CUDA card) and a zero AdamW state beside them."""
    params = model.init(seed, device=device)
    return TrainState(params=params, opt=adamw_init(params))
