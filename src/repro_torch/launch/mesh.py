"""Device meshes and the collectives of the meshed serve (the port of
the reference's `launch/mesh.py`).

The process model differs from the reference's. JAX runs one
controller over every device of a mesh and GSPMD inserts the
collectives; the port runs one process per rank (under `torchrun`, or
spawned by the serve CLI), each with one card (or the CPU under gloo),
and its code is explicit SPMD: plain tensors per rank and the named
collectives below at fixed points. A mesh is a
`torch.distributed.DeviceMesh` over the running process group, so it
exists only once `torch.distributed.init_process_group` has run.

Defined as FUNCTIONS so importing this module creates no process group
and touches no device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.distributed as dist

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
