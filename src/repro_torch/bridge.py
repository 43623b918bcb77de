"""Carry parameters and caches between the reference and the port.

Everything crosses as numpy arrays, so this module imports no JAX: a
caller turns a reference pytree into numpy first
(`jax.device_get(Model(cfg).init(key))`). bfloat16 arrays (numpy's
`ml_dtypes` extension type) cross through float32, which is exact.
Every function that makes tensors puts them on `device`, by default
the CUDA card (`resolve_device`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kvcache.paged import PagedKVCache
from repro_torch.models.config import ModelConfig
from repro_torch.training.optimizer import AdamWState
from repro_torch.training.train_step import TrainState
from repro_torch.tree import (
    leaves_with_path, path_name, tree_map, tree_unflatten,
)

CACHE_FIELDS = tuple(f.name for f in dataclasses.fields(PagedKVCache))
_POOLS = ("k_hbm", "v_hbm", "k_host", "v_host")


def to_torch(a, dtype=None, device=None) -> torch.Tensor:
    """A numpy array (bfloat16 included) as a torch tensor on `device`
    (default: the CUDA card)."""
    device = resolve_device(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bfloat16 widens to float32 (exact)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device=None) -> Dict[str, Any]:
    """The reference's parameter tree (nested dict of numpy arrays) as
    the port's parameters on `device` (default: the CUDA card), cast to
    `cfg.param_dtype`. The layouts are the same for every ported family
    — dense and vlm (one layout), moe of either interleave, and encdec
    (`enc_layers` / `dec_layers` with their layer norms' weights and
    biases, `self_attn` / `cross_attn`, `enc_pos` / `dec_pos`), hybrid
    and ssm (`mamba`, `shared_attn`) and xlstm (`mlstm`, `slstm`) — so
    this is a per-leaf conversion."""
    device = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return to_torch(node, cfg.param_dtype, device)
    return conv(tree)


#: the logical dims a rank holds its shard of on the `model` axis
SPLIT_NAMES = ("experts", "heads", "kv_heads", "mlp", "vocab")


def leaf_spec(param, mesh, mode: str = "serve"):
    """The spec of the block a rank holds of the leaf `param` (a schema
    `Param`) in `mode` ("serve" or "train"; `shard_params` states the
    rule): `param_pspec`'s, with `model` dropped from a dim whose
    logical axis is not one of `SPLIT_NAMES`."""
    from repro_torch.launch.shardings import param_pspec
    spec = param_pspec(param.axes, param.shape, mesh, mode)
    return tuple(None if s == "model" and a not in SPLIT_NAMES else s
                 for s, a in zip(spec, param.axes))


def shard_leaf(tensor: torch.Tensor, param, mesh, coord: Dict[str, int],
               mode: str = "serve") -> torch.Tensor:
    """What the rank at `coord` holds of the leaf `param` (a schema
    `Param`) in `mode`: `tensor` at the leaf's whole shape is cut
    (`shard_params` states the rule); a tensor already at the shard's
    shape is kept as it is."""
    from repro_torch.launch.shardings import local_shape, shard
    spec = leaf_spec(param, mesh, mode)
    if tuple(tensor.shape) == tuple(param.shape):
        return shard(tensor, spec, mesh, coord)
    if tuple(tensor.shape) == local_shape(param.shape, spec, mesh):
        return tensor
    raise ValueError(f"a leaf of shape {tuple(tensor.shape)} is neither "
                     f"the whole {tuple(param.shape)} nor its shard")


def shard_params(params: Dict[str, Any], cfg: ModelConfig, mesh,
                 coord: Dict[str, int], mode: str = "serve"
                 ) -> Dict[str, Any]:
    """One rank's parameters for the meshed serve (`mode` "serve") or
    the meshed train step ("train"), cut from the whole ones
    (`params_from_jax`, `Model.init`, wherever they lie) by the
    sharding rules (`launch.shardings.param_pspec(..., mode)`) at mesh
    coordinate `coord` ({axis: index}). Leaves already at their shard's
    shape (`init_shards`) are kept as they are.

    The rule on `model`, in both modes: a leaf whose spec puts `model`
    on an `experts`, `heads`, `kv_heads`, `mlp` or `vocab` dim is held
    as its shard (`shard`, a contiguous copy); a leaf whose spec puts
    `model` on `embed` or `head_dim` (the norm weights and the moe
    router, which those rules shard at the tail of their priority, or
    an MLP or vocabulary the axis does not divide) is held whole on
    `model`, as GSPMD's all-gather would give it. So what the port
    splits on `model` is exactly what `ModelConfig.rank_local` counts:
    a moe model's expert leaves by experts (granite-moe's `we_gate`
    [L, 48, d, f] as [L, 48 / model, d, f]). On `data`, serve mode
    holds every leaf whole; train mode holds the leaf's FSDP block on
    the dim that `param_pspec(..., "train")` gives `data` (for internlm2
    at (2, 2): `wq`'s `embed`, `w_down`'s `embed`, `embed`'s `embed`;
    for an expert leaf its `embed`), so a rank holds about 1/(data x
    model) of the big leaves. A leaf that is held whole is the same
    tensor, not a copy."""
    from repro_torch.models.model import Model

    def cut(node, schema):
        if isinstance(node, dict):
            return {k: cut(v, schema[k]) for k, v in node.items()}
        return shard_leaf(node, schema, mesh, coord, mode)
    return cut(params, Model(cfg).schema())


def init_shards(cfg: ModelConfig, seed, mesh, coord: Dict[str, int],
                device=None, mode: str = "serve") -> Dict[str, Any]:
    """`shard_params(Model(cfg).init(seed, device), ..., mode)` without
    the whole model: each leaf is cut as soon as it is drawn, so the
    device holds the rank's shards and at most one whole leaf beside
    them. The same draws, so on the CPU the same numbers."""
    from repro_torch.models.model import Model
    return Model(cfg).init(seed, device, keep=lambda p, t: shard_leaf(
        t, p, mesh, coord, mode))


def param_specs(cfg: ModelConfig, mesh, mode: str = "train"
                ) -> Dict[str, Any]:
    """{leaf name: the spec of the block a rank holds in `mode`}, one
    entry per parameter, named by its path (`tree.path_name`, e.g.
    "layers/wq")."""
    from repro_torch.models.model import Model
    out = {}

    def walk(schema, prefix):
        for k in sorted(schema):
            if isinstance(schema[k], dict):
                walk(schema[k], prefix + (k,))
            else:
                out[path_name(prefix + (k,))] = leaf_spec(schema[k], mesh,
                                                          mode)
    walk(Model(cfg).schema(), ())
    return out


def train_state_specs(cfg: ModelConfig, mesh) -> Dict[str, Any]:
    """`param_specs(cfg, mesh, "train")` for a `TrainState`'s leaves
    (".params/...", ".opt/.m/...", ".opt/.v/...", the checkpoint's leaf
    names): m and v are held as the parameters are, ZeRO-style; the
    AdamW step (".opt/.step") is whole on every rank."""
    specs = param_specs(cfg, mesh, "train")
    out = {".opt/.step": ()}
    for prefix in (".params", ".opt/.m", ".opt/.v"):
        out.update({f"{prefix}/{k}": v for k, v in specs.items()})
    return out


def unshard(tree, cfg: ModelConfig, mesh):
    """The whole leaves of a rank's train-mode shards, the inverse of
    `shard_params(..., mode="train")`: a parameter tree, or a whole
    `TrainState` (m and v held as the parameters). Every leaf is
    all-gathered over the axes that split it (`launch.mesh.
    gather_whole`), so every rank of `mesh` gets the whole tree; for a
    checkpoint write and for the tests."""
    from repro_torch.launch.mesh import gather_whole
    specs = train_state_specs(cfg, mesh) if isinstance(tree, TrainState) \
        else param_specs(cfg, mesh, "train")
    with torch.no_grad():
        return tree_unflatten(tree, [
            gather_whole(t, specs[path_name(path)], mesh)
            for path, t in leaves_with_path(tree)])


def train_state_from_jax(params_np, opt_np, cfg: ModelConfig,
                         device=None, mesh=None) -> TrainState:
    """A `TrainState` on `device` (default: the CUDA card) from the
    reference's, turned into numpy (`jax.device_get(state.params)`,
    `jax.device_get(state.opt)`): the parameters cast to
    `cfg.param_dtype`, the AdamW step int32 and m, v f32. `opt_np` is
    the reference's `AdamWState` of numpy arrays or a dict with the keys
    step, m and v. With `mesh` (a `DeviceMesh`): this rank's train-mode
    shards of the parameters, m and v (`shard_params(...,
    mode="train")` at its coordinate)."""
    device = resolve_device(device)

    def get(name):
        return opt_np[name] if isinstance(opt_np, dict) \
            else getattr(opt_np, name)

    def f32(tree):
        return tree_map(lambda a: to_torch(a, torch.float32, device), tree)
    state = TrainState(
        params=params_from_jax(params_np, cfg, device),
        opt=AdamWState(step=to_torch(get("step"), torch.int32, device),
                       m=f32(get("m")), v=f32(get("v"))))
    if mesh is None:
        return state
    from repro_torch.launch.mesh import mesh_coordinate
    coord = mesh_coordinate(mesh)

    def cut(tree):
        return shard_params(tree, cfg, mesh, coord, "train")
    return TrainState(params=cut(state.params), opt=AdamWState(
        step=state.opt.step, m=cut(state.opt.m), v=cut(state.opt.v)))


def train_state_to_numpy(state: TrainState):
    """(params, {"step", "m", "v"}) as numpy, the inverse of
    `train_state_from_jax` (bf16 widened to f32, exactly)."""
    return (tree_map(to_numpy, state.params),
            {"step": to_numpy(state.opt.step),
             "m": tree_map(to_numpy, state.opt.m),
             "v": tree_map(to_numpy, state.opt.v)})


def cache_from_numpy(arrays: Dict[str, Any], device=None, pool_dtype=None
                     ) -> Union[PagedKVCache, Dict[str, Any]]:
    """A decode state from numpy arrays on `device` (default: the CUDA
    card): a `PagedKVCache` from a dict keyed by the field names the
    reference's `PagedKVCache` uses (`pool_dtype` casts its pools), or
    a dict state of any family with its cache converted so and every
    other array kept in its dtype — encdec's {"kv", "enc"}, hybrid's
    {"ssm": {"s", "conv"}, "kv"}, xlstm's flat dict of recurrent
    tensors (the recurrent state stays f32)."""
    device = resolve_device(device)
    if "page_table" in arrays:
        return PagedKVCache(**{
            name: to_torch(arrays[name],
                           pool_dtype if name in _POOLS else None, device)
            for name in CACHE_FIELDS})
    return {k: cache_from_numpy(v, device, pool_dtype)
            if isinstance(v, dict) else to_torch(v, device=device)
            for k, v in arrays.items()}


def cache_to_numpy(state) -> Dict[str, Any]:
    """A decode state as numpy, the inverse of `cache_from_numpy`: a
    cache's fields keyed by field name, a dict state with the same keys
    and nesting."""
    if isinstance(state, PagedKVCache):
        return {name: to_numpy(getattr(state, name))
                for name in CACHE_FIELDS}
    return {k: cache_to_numpy(v) if isinstance(v, (dict, PagedKVCache))
            else to_numpy(v) for k, v in state.items()}
