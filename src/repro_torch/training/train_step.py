"""Training step: next-token loss, gradients, AdamW, remat (the port of
the reference's `training/train_step.py`).

Written against the `Model` facade, so every family trains through the
same entry point. The gradient is torch's autograd; on the card the
whole-sequence attention inside it is the hand-written flash kernel
forward and backward (`kernels.flash_attention.FlashAttention`), on the
CPU the plain version. Gradient accumulation in f32 and a bf16 compute /
f32 optimizer-state split are built in, as in the reference.

Across a (`data`, `model`) mesh (`make_train_step(..., mesh=)`, every
family) the step is explicit SPMD, one process a rank, as the meshed
serve: the rank holds its train-mode shards of the parameters and of m
and v (`bridge.shard_params(..., mode="train")`: tensor parallelism
over `model` — a moe model's experts split over it, expert
parallelism; a recurrent block's heads, with the leaves the rules cut
across its heads gathered over it, `models.ssm`, `models.xlstm` —,
FSDP blocks over `data`), takes its rows of each micro-batch
(`launch.shardings.tokens_sharding`; every rank takes every row where
`data` does not divide them; a modality extra's rows alike), and runs
the rank-local model (`TrainMesh`) whose collectives carry the gradient
(`launch.mesh`). A `model` axis of any size trains: where it does not
divide the KV heads the rank holds every KV head and its block of the
query heads (`wk`/`wv` whole, their gradient summed over `model`), or
every head where it does not divide them, and a recurrent block whose
heads it does not divide runs whole (`transformer.TensorParallel`);
a part every model rank runs whole neither enters the split region nor
is summed, so its gradient is whole on every rank and counted once in
the norm. A moe model routes over every data rank's rows of the
micro-batch, as the unsplit step does (`models.moe`); its router,
whole on every rank and used on each model rank's experts alone, has
its gradient summed over `model` (`enter`). The loss is the mean over
every data rank's rows; the FSDP leaves' gradients come out of their
gathers' backward reduce-scattered over `data`, the leaves whole on
`data` are summed over it here, and the global norm counts each element
of the whole model once. The step then equals the unmeshed one up to
the order of its sums.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.utils.checkpoint

from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.shardings import (
    data_dim, shard, spec_axes, tokens_sharding,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.models.transformer import TensorParallel, unembed_weight
from repro_torch.training.optimizer import (
    AdamWState, adamw_init, adamw_update, global_norm,
)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: AdamWState


def _chunk_loss(h_blk, t_blk, w, gather=None):
    """Summed next-token NLL of one sequence chunk: its [B, c, V]
    logits `(h @ w).float()` (the reference's precision), taken under
    checkpointing so no chunk's logits outlive it. `gather`: a meshed
    rank's, which concatenates the model ranks' vocabulary slices of
    the chunk's logits (`TensorParallel.gather`) before any reads
    them."""
    logits = h_blk @ w
    if gather is not None:
        logits = gather(logits, -1)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, t_blk[..., None])[..., 0]
    return (logz - gold).sum()


def loss_fn(model: Model, params, tokens, *, extra: Optional[Dict] = None,
            logit_chunk: int = 512, rows: Optional[int] = None):
    """Causal LM loss. tokens [B, S]; shift-by-one inside.

    The [B, S, vocab] logits are never materialized: the hidden states
    are unembedded `logit_chunk` positions at a time, each chunk under
    `torch.utils.checkpoint`, so the backward recomputes one chunk's
    logits at a time (peak ~ B * chunk * vocab f32); the blocks of the
    forward are checkpointed too (`forward_hidden`'s remat). The vlm
    family's loss runs over the text tail only; tied embeddings unembed
    through `embed`. `rows`: the rows the mean runs over (default B; a
    meshed rank's: every data rank's rows together, so the ranks'
    losses sum to the global mean). On a meshed rank (`model.tp`) the
    unembedding is its vocabulary columns, whose logits are gathered a
    chunk at a time inside the chunk's checkpoint."""
    cfg = model.cfg
    tp = model.tp
    hidden = model.forward_hidden(params, tokens[:, :-1], extra=extra)
    # VLM prepends patch embeddings: loss only over the text tail
    if cfg.family == "vlm":
        hidden = hidden[:, -(tokens.shape[1] - 1):]
    targets = tokens[:, 1:].long()
    w = unembed_weight(params, cfg, tp)
    chunk = _chunk_loss
    if tp is not None and tp.vocab is not None:
        hidden = tp.enter(hidden)
        chunk = functools.partial(_chunk_loss, gather=tp.gather)
    B, S, _ = hidden.shape
    c = min(logit_chunk, S)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s0 in range(0, S, c):
        total = total + torch.utils.checkpoint.checkpoint(
            chunk, hidden[:, s0:s0 + c], targets[:, s0:s0 + c], w,
            use_reentrant=False)
    return total / ((B if rows is None else rows) * S)


def value_and_grad(model: Model, params, tokens, extra=None,
                   rows: Optional[int] = None, logit_chunk: int = 512):
    """(loss, grads shaped as `params`) of `loss_fn` (`rows` and
    `logit_chunk` its), by autograd. The parameters are not modified:
    the graph runs on detached aliases."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(model, tree_unflatten(params, leaves), tokens,
                       extra=extra, logit_chunk=logit_chunk, rows=rows)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def layer_dims(cfg: ModelConfig, specs, axis: str) -> Dict[str, int]:
    """{leaf path: the dim `axis` splits, of one layer's weights for a
    stacked leaf} for each leaf of `cfg` that `specs` (by path) split
    over `axis`: how a block, handed one layer's weights, finds its
    blocks (`TensorParallel.data_dims`, `.model_dims`)."""
    from repro_torch.tree import path_name
    out = {}

    def walk(schema, prefix):
        for k, p in schema.items():
            if isinstance(p, dict):
                walk(p, prefix + (k,))
                continue
            name = path_name(prefix + (k,))
            d = next((d for d, entry in enumerate(specs[name])
                      if axis in spec_axes((entry,))), None)
            if d is not None:
                out[name] = d - (p.axes[:1] == ("layers",))
    walk(Model(cfg).schema(), ())
    return out


@dataclasses.dataclass
class TrainMesh:
    """A rank's part of a meshed train step: the rank-local model (its
    `TensorParallel` bound to its `comm`'s differentiable collectives
    and to its FSDP blocks), the axis sizes, and for each parameter leaf
    (in tree order) whether it is whole on `data` and which axes split
    it. `comm` (`launch.mesh.Collectives`) is how the rank reaches its
    peers: every collective of the step goes through it."""

    model: Model
    mesh: Any
    comm: mesh_mod.Collectives
    sizes: Dict[str, int]
    whole_on_data: List[bool]
    #: {axis: whether it splits each leaf, a bool tensor on the rank's
    #: device}, for each axis of more than one rank that splits a leaf
    split_by: Dict[str, torch.Tensor]

    @classmethod
    def bind(cls, model: Model, mesh, comm=None) -> "TrainMesh":
        """This rank's part of `mesh` for training `model` (the whole
        model's `Model(cfg)`), at any axis sizes: its collectives `comm`,
        by default `Collectives.of(mesh)` (`mesh` a `DeviceMesh`; with
        `comm` given, anything with the mesh's axis sizes)."""
        from repro_torch.bridge import param_specs
        cfg = model.cfg
        comm = comm or mesh_mod.Collectives.of(mesh)
        sizes = mesh_mod.mesh_axis_sizes(mesh)
        specs = param_specs(cfg, mesh, "train")
        tp = TensorParallel.of(
            cfg, sizes["model"], comm.coord["model"], reduce=comm.reduce,
            gather=comm.gather, enter=comm.enter,
            data_dims=layer_dims(cfg, specs, "data"),
            model_dims=layer_dims(cfg, specs, "model"),
            gather_data=comm.gather_data, gather_rows=comm.gather_data)
        split_by = {}
        for axis in mesh_mod.AXES:
            mask = [axis in spec_axes(s) for s in specs.values()]
            if sizes[axis] > 1 and any(mask):
                split_by[axis] = torch.tensor(mask, device=comm.device)
        return cls(model=Model(cfg.rank_local(sizes["model"]), tp=tp),
                   mesh=mesh, comm=comm, sizes=sizes,
                   whole_on_data=[data_dim(s) is None
                                  for s in specs.values()],
                   split_by=split_by)

    @property
    def coord(self) -> Dict[str, int]:
        return self.comm.coord

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global batch tensor [B, ...], as
        `tokens_sharding` splits them (all B where `data` does not
        divide B)."""
        spec = tokens_sharding(self.mesh, t.shape[0])
        return shard(t, spec + (None,) * (t.dim() - 2), self.mesh,
                     self.coord)

    def model_for(self, batch: int) -> Model:
        """The rank-local model for a micro-batch of `batch` global rows:
        a moe model's routing sees every data rank's rows when `data`
        splits them (`TensorParallel.rows`)."""
        split = tokens_sharding(self.mesh, batch)[0] == ("data",)
        return self.model.with_rows(
            (self.coord["data"], self.sizes["data"]) if split else None)

    def reduce_grads(self, grads):
        """The gradients of the leaves whole on `data` summed over it
        (the step's own tensors handed over); the FSDP leaves' arrive
        reduce-scattered already."""
        return tree_unflatten(grads, [
            self.comm.sum(g, "data") if whole else g
            for g, whole in zip(tree_leaves(grads), self.whole_on_data)])

    def leaf_sums(self, sums: torch.Tensor) -> torch.Tensor:
        """The per-leaf sums of squares over the rank's blocks [n leaves]
        -> each leaf's sum over the whole model: summed over `model`,
        then `data`, where that axis splits the leaf (a leaf whole on
        both counts once)."""
        for axis, mask in self.split_by.items():
            part = torch.where(mask, sums, torch.zeros_like(sums))
            sums = torch.where(mask, self.comm.sum(part, axis), sums)
        return sums


def make_train_step(model: Model, *, accum_steps: int = 1,
                    extra_keys: tuple = (), lr=None, mesh=None,
                    comm=None, logit_chunk: int = 512) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    batch: {"tokens": [B, S]} (+ modality extras, named by
    `extra_keys`), tensors on the parameters' device. With
    accum_steps > 1 the batch's leading dim is split into micro-batches
    and gradients are accumulated in f32 before one optimizer update.
    metrics: {"loss", "grad_norm", "step"}, tensors on the device (no
    host sync inside the step). `logit_chunk`: `loss_fn`'s.

    With `mesh` (a (`data`, `model`) `DeviceMesh` of any sizes; every
    family): every rank calls the step with its own state (`init_train_state(..., mesh=)`,
    `bridge.train_state_from_jax(..., mesh=)`: its train-mode shards)
    and the same global batch; accum_steps splits it into micro-batches
    of global rows, as unmeshed, and the rank takes its rows of each
    (`TrainMesh.rows`). The metrics are the global ones on every
    rank. `comm`: the rank's collectives where they are not the
    `DeviceMesh`'s (`TrainMesh.bind`)."""
    rank = None if mesh is None else TrainMesh.bind(model, mesh, comm)
    across = None if rank is None else rank.leaf_sums

    def micro(params, tokens, extra):
        """(loss, grads) of a micro-batch of global rows: on a rank, of
        its rows of them, the loss a share of the global mean."""
        if rank is None:
            return value_and_grad(model, params, tokens, extra,
                                  logit_chunk=logit_chunk)
        run = rank.model_for(tokens.shape[0])
        tokens = rank.rows(tokens)
        extra = None if extra is None else {
            k: rank.rows(v) for k, v in extra.items()}
        return value_and_grad(run, params, tokens, extra,
                              rows=tokens.shape[0] * rank.sizes["data"],
                              logit_chunk=logit_chunk)

    def train_step(state: TrainState, batch: Dict) -> tuple:
        tokens = batch["tokens"]
        extra = {k: batch[k] for k in extra_keys} or None
        if accum_steps == 1:
            loss, grads = micro(state.params, tokens, extra)
        else:
            mb = tokens.shape[0] // accum_steps
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for i in range(accum_steps):
                sl = slice(i * mb, (i + 1) * mb)
                ex = None if extra is None else {
                    k: v[sl] for k, v in extra.items()}
                l_i, g = micro(state.params, tokens[sl], ex)
                grads = tree_map(lambda a, b: a + b.float(), grads, g)
                loss = loss + l_i
            grads = tree_map(lambda g: g / accum_steps, grads)
            loss = loss / accum_steps
        if rank is not None:
            grads = rank.reduce_grads(grads)
            loss = rank.comm.sum(loss.clone(), "data")

        params, opt = adamw_update(grads, state.opt, state.params, lr=lr,
                                   across=across)
        return TrainState(params=params, opt=opt), {
            "loss": loss, "grad_norm": global_norm(grads, across),
            "step": opt.step}

    return train_step


def init_train_state(model: Model, seed=0, device=None,
                     mesh=None) -> TrainState:
    """Random parameters (`Model.init(seed, device)`; default device the
    CUDA card) and a zero AdamW state beside them. With `mesh`: this
    rank's train-mode shards of them, drawn leaf by leaf
    (`bridge.init_shards`, the same numbers) so no whole model is ever
    on the device."""
    if mesh is None:
        params = model.init(seed, device=device)
    else:
        from repro_torch.bridge import init_shards
        params = init_shards(model.cfg, seed, mesh,
                             mesh_mod.mesh_coordinate(mesh), device,
                             mode="train")
    return TrainState(params=params, opt=adamw_init(params))
