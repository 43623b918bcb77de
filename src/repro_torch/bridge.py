"""Carry parameters and caches between the reference and the port.

Everything crosses as numpy arrays, so this module imports no JAX: a
caller turns a reference pytree into numpy first
(`jax.device_get(Model(cfg).init(key))`). bfloat16 arrays (numpy's
`ml_dtypes` extension type) cross through float32, which is exact.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.kvcache.paged import PagedKVCache
from repro_torch.models.config import ModelConfig

CACHE_FIELDS = tuple(f.name for f in dataclasses.fields(PagedKVCache))


def to_torch(a, dtype=None, device="cpu") -> torch.Tensor:
    """A numpy array (bfloat16 included) as a torch tensor."""
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
                    device="cpu") -> Dict[str, Any]:
    """The reference's parameter tree of a dense or moe model (nested
    dict of numpy arrays; a moe tree of either interleave) as the
    port's parameters, cast to `cfg.param_dtype`. The layouts are the
    same, so this is a per-leaf conversion."""
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return to_torch(node, cfg.param_dtype, device)
    return conv(tree)


def cache_from_numpy(arrays: Dict[str, Any], device="cpu",
                     pool_dtype=None) -> PagedKVCache:
    """A `PagedKVCache` from a dict of numpy arrays keyed by the field
    names the reference's `PagedKVCache` uses."""
    out = {}
    for name in CACHE_FIELDS:
        dtype = pool_dtype if name in ("k_hbm", "v_hbm", "k_host",
                                       "v_host") else None
        out[name] = to_torch(arrays[name], dtype, device)
    return PagedKVCache(**out)


def cache_to_numpy(cache: PagedKVCache) -> Dict[str, np.ndarray]:
    """The cache's fields as numpy arrays, keyed by field name."""
    return {name: to_numpy(getattr(cache, name)) for name in CACHE_FIELDS}
