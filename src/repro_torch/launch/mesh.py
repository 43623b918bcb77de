"""Device meshes, the collectives of the meshed serve and training, and
the CLIs' rank launch (the port of the reference's `launch/mesh.py`).

The process model differs from the reference's. JAX runs one
controller over every device of a mesh and GSPMD inserts the
collectives; the port runs one process per rank (under `torchrun`, or
spawned by the serve CLI), each with one card (or the CPU under gloo),
and its code is explicit SPMD: plain tensors per rank and the named
collectives below at fixed points. A mesh is a
`torch.distributed.DeviceMesh` over the running process group, so it
exists only once `torch.distributed.init_process_group` has run.

Two kinds of collective. The serve's (`all_reduce_sum`, `all_gather`)
carry no gradient: the first works in place and both sit inside
captured CUDA graphs. Training's are `torch.autograd.Function`s, each
the other's transpose in its backward (Megatron's f and g, and FSDP's
gather): `enter_model`, `sum_model`, `gather_model`, `gather_data`,
which `Collectives.of` hands the meshed train step.

Defined as FUNCTIONS so importing this module creates no process group
and touches no device.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import shutil
import sys
import tempfile
import time
from typing import Callable, Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device

#: the serving mesh's axes, in the reference's order
AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes with no devices (the reference's
    `jax.sharding.AbstractMesh`): what the sharding rules read of a mesh
    that does not exist here."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The 256-chip (`data`, `model`) pod mesh — or, with `multi_pod`,
    the 512-chip (`pod`, `data`, `model`) twin-pod one the dry-run cost
    tables assume. Abstract: those cards do not exist here, so only the
    sharding rules read it."""
    if multi_pod:
        return AbstractMesh(("pod",) + AXES, (2, 16, 16))
    return AbstractMesh(AXES, (16, 16))


def make_test_mesh(data: int = 1, model: int = 1):
    """The (`data`, `model`) `DeviceMesh` over the running process
    group: on `cuda` under NCCL (each rank's current card), on `cpu`
    under gloo — how the CPU tests run a real multi-rank mesh, where the
    reference fakes host devices. Rank r sits at (r // model, r %
    model). Raises when no group is running or its size is not
    data x model."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_test_mesh needs a running process group "
                           "(torch.distributed.init_process_group)")
    if dist.get_world_size() != data * model:
        raise ValueError(f"a data={data} x model={model} mesh needs "
                         f"{data * model} ranks, the group has "
                         f"{dist.get_world_size()}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (data, model), mesh_dim_names=AXES)


def mesh_device(mesh) -> torch.device:
    """The device this rank's collectives over `mesh` take their tensors
    on: its current card under NCCL, the CPU under gloo."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names (`AbstractMesh.axis_names`, a
    `DeviceMesh`'s `mesh_dim_names`, or a jax mesh's)."""
    names = getattr(mesh, "axis_names", None)
    return tuple(names if names is not None else mesh.mesh_dim_names)


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size}, e.g. {"data": 2, "model": 2}."""
    shape = mesh.shape
    if isinstance(shape, tuple):          # a DeviceMesh: sizes by dim
        return dict(zip(axis_names(mesh), shape))
    return dict(shape)


def mesh_coordinate(mesh) -> Dict[str, int]:
    """{axis name: this rank's index on it}."""
    return dict(zip(axis_names(mesh), mesh.get_coordinate()))


# ---------------------------------------------------------------------------
# Collectives over one named axis (the meshed path calls them whatever the
# axis size; a size-1 axis leaves the values as they are)
# ---------------------------------------------------------------------------

def all_reduce_sum(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """`t` summed over the ranks of `axis`, IN PLACE: callers hand it a
    temporary (a partial product, a stacked statistic). Returns `t`."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return t


def all_gather(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The ranks' `t` along `axis`, concatenated on `dim` in rank order
    (the rank at index i on the axis gives block i). One collective
    into one tensor (no copies out of a list: a CUDA graph holds it);
    bool tensors cross as uint8."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    src = (t.to(torch.uint8) if t.dtype == torch.bool else t).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _gather_into(out, src, group=group)
    d = dim % src.dim()
    shape = list(src.shape)
    shape[d] *= n
    out = out.view(n, *src.shape).movedim(0, d).reshape(shape)
    return out.bool() if t.dtype == torch.bool else out


#: the one-tensor all-gather (`all_gather_single` where this PyTorch
#: has it, `all_gather_into_tensor` before)
_gather_into = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
#: the one-tensor reduce-scatter, likewise
_scatter_from = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def reduce_scatter_sum(t: torch.Tensor, mesh, axis: str,
                       dim: int) -> torch.Tensor:
    """`t` summed over the ranks of `axis`, of which this rank keeps its
    block on `dim` (the rank at index i on the axis keeps block i: the
    transpose of `all_gather`). `t.shape[dim]` must divide by the axis
    size."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    d = dim % t.dim()
    shape = list(t.shape)
    shape[d] //= n
    src = t.reshape(shape[:d] + [n] + shape[d:]).movedim(d, 0) \
        .reshape([n * shape[0]] + shape[1:])
    out = torch.empty(shape, dtype=t.dtype, device=t.device)
    _scatter_from(out, src, op=dist.ReduceOp.SUM, group=group)
    return out


def gather_whole(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor from this rank's block `t` of it under the
    partition spec `spec` (`launch.shardings`: one entry per dim, None,
    an axis name or a tuple of them, the first axis major): all-gathered
    over each axis that splits a dim, the last axis of a dim first.
    Every rank of the mesh gets the whole tensor; `t` itself where
    nothing is split. Carries no gradient."""
    for d, entry in enumerate(spec):
        axes = () if entry is None else \
            (entry,) if isinstance(entry, str) else tuple(entry)
        for axis in reversed(axes):
            t = all_gather(t, mesh, axis, d)
    return t


# ---------------------------------------------------------------------------
# Training's collectives: differentiable, each the other's transpose
# ---------------------------------------------------------------------------

def _summed(g: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """A copy of `g` summed over `axis` (autograd's gradients may be
    shared, so never in place)."""
    return all_reduce_sum(g.clone(memory_format=torch.contiguous_format),
                          mesh, axis)


class _EnterModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.mesh, "model"), None


class _SumModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _summed(x, mesh, "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.size = mesh, dim, x.shape[dim]
        return all_gather(x, mesh, "model", dim)

    @staticmethod
    def backward(ctx, g):
        start = mesh_coordinate(ctx.mesh)["model"] * ctx.size
        return g.narrow(ctx.dim, start, ctx.size).contiguous(), None, None


class _GatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return all_gather(x, mesh, "data", dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_sum(g, ctx.mesh, "data", ctx.dim), None, None


def enter_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """Megatron's f, where a replicated activation enters the
    model-split region (before each column-parallel product): the
    identity forward; backward, the gradient summed over `model`, since
    each model rank's products give only its heads' (its MLP columns',
    its vocabulary's) share of it."""
    return _EnterModel.apply(x, mesh)


def sum_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """Megatron's g, where the model-split region leaves (after each
    row-parallel product, and the vocabulary-split embedding): `x`
    summed over `model` forward (out of place); the identity backward,
    since every model rank holds the whole gradient of the sum."""
    return _SumModel.apply(x, mesh)


def gather_model(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """The model ranks' `x` concatenated on `dim` in rank order (the
    unembedding's vocabulary slices); backward, this rank's own slice of
    the gradient, which every model rank holds whole."""
    return _GatherModel.apply(x, mesh, dim)


def gather_data(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """FSDP's gather: a leaf's data ranks' blocks concatenated on `dim`
    in rank order, the order `shardings.shard` cuts them in; backward,
    the gradient reduce-scattered over `data` (each data rank keeps the
    sum of every data rank's gradient of its block)."""
    return _GatherData.apply(x, mesh, dim)


@dataclasses.dataclass(frozen=True)
class Collectives:
    """How one rank of a meshed train step reaches its peers: its
    coordinate and device, `sum(t, axis)` (`t` summed over the ranks of
    `axis`, no gradient; the caller uses the returned tensor and hands
    `t` over), and the differentiable collectives its `TensorParallel`
    calls: `enter` and `reduce` over `model` (Megatron's f and g),
    `gather(t, dim)` over `model`, `gather_data(t, dim)` over `data`.
    `of(mesh)`: this process's over a `DeviceMesh`; ranks run another
    way (threads of one process standing for them) bring their own."""

    coord: Dict[str, int]
    device: torch.device
    sum: Callable
    enter: Callable
    reduce: Callable
    gather: Callable
    gather_data: Callable

    @classmethod
    def of(cls, mesh) -> "Collectives":
        return cls(
            coord=mesh_coordinate(mesh), device=mesh_device(mesh),
            sum=lambda t, axis: all_reduce_sum(t, mesh, axis),
            enter=lambda t: enter_model(t, mesh),
            reduce=lambda t: sum_model(t, mesh),
            gather=lambda t, dim: gather_model(t, mesh, dim),
            gather_data=lambda t, dim: gather_data(t, mesh, dim))


# ---------------------------------------------------------------------------
# The CLIs' ranks: one process a rank, under torchrun or spawned here
# ---------------------------------------------------------------------------

#: seconds a collective of a CLI mesh may wait before it fails: the
#: other ranks wait in `CheckpointManager.wait` while the first writes a
#: full-width train state (~19 GB through zlib: minutes)
MESH_TIMEOUT_S = 1800
#: seconds the spawning process waits for its ranks
SPAWN_TIMEOUT_S = 3600


def join_mesh(sizes: Dict[str, int], device_arg):
    """This process's rank of the mesh: joins the process group from
    RANK, WORLD_SIZE and LOCAL_RANK (torchrun's variables; the group's
    address is torchrun's, or the `file://` store of `spawn_ranks` in
    REPRO_TORCH_MESH_STORE) and builds the (`data`, `model`) mesh.
    Returns (mesh, device): `cuda:LOCAL_RANK` over NCCL, or the CPU over
    gloo when `device_arg` is "cpu"."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if str(device_arg) == "cpu":
        device, backend = torch.device("cpu"), "gloo"
    else:
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = resolve_device(f"cuda:{local}")
        torch.cuda.set_device(device)
        backend = "nccl"
    store = os.environ.get("REPRO_TORCH_MESH_STORE")
    dist.init_process_group(
        backend, init_method=f"file://{store}" if store else "env://",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    return make_test_mesh(sizes["data"], sizes["model"]), device


def _rank_entry(rank: int, world: int, store: str, main: Callable,
                argv) -> None:
    """A spawned rank: `main(argv)` with the rank's variables set."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), REPRO_TORCH_MESH_STORE=store)
    sys.exit(main(argv))


def spawn_ranks(world: int, main: Callable, argv) -> int:
    """Run `main(argv)` (a module-level function: a CLI's own) in
    `world` spawned processes over a `file://` store in a temporary
    directory; the worst exit status."""
    tmp = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry,
                         args=(r, world, os.path.join(tmp, "store"), main,
                               argv))
             for r in range(world)]
    try:
        for proc in procs:
            proc.start()
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        for proc in procs:
            proc.join(max(0.0, deadline - time.monotonic()))
        codes = []
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
                codes.append(124)
            else:
                codes.append(proc.exitcode)
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    return max(abs(c) for c in codes)
