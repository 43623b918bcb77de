"""FLOPs and bytes of the operators a computation dispatches (the
port's counterpart of the reference's `launch/hlo_cost.analyze`, which
reads XLA's optimized HLO; the port has none).

`OpCost` is a `TorchDispatchMode`: every aten operator run under it is
counted once per call, at the shapes it was called with, which on the
meta device costs no memory and no arithmetic.

  FLOPs  products and attention by `torch.utils.flop_counter`'s
         registry (2 per multiply-add); pointwise operators 1 per
         output element and reductions 1 per input element, as the
         reference's analyzer counts elementwise HLO.
  bytes  every operand's bytes plus every result's, for each operator
         that moves data (views and allocations move none): an upper
         bound that assumes no fusion, where XLA's count is taken at
         fusion boundaries.
  peak   the most bytes of the results made under it that were alive
         at once (a result that aliases an operand, a view or an
         in-place write, makes none; a result is freed when its tensor
         is): the step's activations and new state on top of its
         arguments, with the caching allocator's rounding and
         fragmentation left out.
  kernels the hand-written kernels' operators (`kernels.meta`, what
         `kernels.ops` dispatches for meta tensors) are priced by the
         formulas of the bound column of PERF.md §6 and `chip_smoke.py`,
         so a kernel costs the same work whatever implements it:
           paged attention  bytes of q, out, the partials and lists, and
                            K/V of every listed page (all T tokens: a
                            meta tensor holds no valid counts, so this
                            is the most a call could read); 4 FLOPs per
                            (token, query row, head-dim element)
           flash attention  q, k, v read and out written once; 4*D
                            FLOPs per visible (query, key) pair per head
           its backward     q, k, v, out, dout and the f32 LSE read, dq,
                            dk, dv written; 2.5x the forward's FLOPs
           row copy         every row read once and written once.

The reference weighs a `lax.scan` body by its trip count; the port's
layer loop is Python, so every op already counts once per layer.
"""

from __future__ import annotations

import collections
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

#: allocations: no data moves
_FREE = {"aten::empty", "aten::empty_strided", "aten::empty_like",
         "aten::new_empty", "aten::new_empty_strided"}

_REDUCTIONS = {"aten::sum", "aten::mean", "aten::amax", "aten::amin",
               "aten::max", "aten::min", "aten::prod", "aten::logsumexp",
               "aten::cumsum", "aten::argmax", "aten::argmin", "aten::any",
               "aten::all", "aten::norm", "aten::linalg_vector_norm",
               "aten::_softmax", "aten::_log_softmax"}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _paged(args, out):
    q, k_pool, _, page_list, _ = args
    B, KH, G, HD = q.shape
    T = k_pool.shape[2]
    tokens = page_list.numel() * T
    kv = 2 * tokens * KH * HD * k_pool.element_size()
    return 4 * tokens * KH * G * HD, \
        _bytes(q) + kv + 2 * page_list.numel() * 4 + _bytes(out)


def flash_flops(B, Sq, Sk, H, D, causal) -> int:
    """4*D FLOPs per visible (query, key) pair per head; causal queries
    aligned at key 0."""
    if causal:
        full = min(Sq, Sk)
        pairs = full * (full + 1) // 2 + (Sq - full) * Sk
    else:
        pairs = Sq * Sk
    return 4 * B * H * D * pairs


def _flash(args, out):
    q, k, v, causal = args
    B, Sq, H, D = q.shape
    return flash_flops(B, Sq, k.shape[1], H, D, causal), \
        _bytes((q, k, v, out))


def _flash_bwd(args, out):
    q, k, v, o, dout, causal = args
    B, Sq, H, D = q.shape
    return 2.5 * flash_flops(B, Sq, k.shape[1], H, D, causal), \
        _bytes((q, k, v, o, dout, out)) + 4 * B * H * Sq


def _page_copy(args, out):
    index, pairs, row_bytes = args
    return 0, 2 * pairs * index.shape[0] * row_bytes


#: the hand-written kernels' operators (`kernels.meta`) and their prices
KERNELS = {
    "repro_torch::paged_attention": _paged,
    "repro_torch::flash_attention": _flash,
    "repro_torch::flash_attention_bwd": _flash_bwd,
    "repro_torch::page_copy": _page_copy,
}


class OpCost(TorchDispatchMode):
    """Counts FLOPs and bytes of every operator dispatched under it.

    After the `with` block: `flops`, `bytes`, `peak` (bytes) and
    `kernels`, the launches of each hand-written kernel's operator."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.kernels = collections.Counter()
        self.live = 0
        self.peak = 0

    def _made(self, func, out) -> None:
        """Count the new results of `func` live until they are freed."""
        if any(r.alias_info is not None for r in func._schema.returns):
            return
        for t in _tensors(out):
            n = t.numel() * t.element_size()
            self.live += n
            weakref.finalize(t, self._freed, n)
        self.peak = max(self.peak, self.live)

    def _freed(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name
        if name in KERNELS:
            flops, nbytes = KERNELS[name](args, out)
            self.kernels[name.split("::")[1]] += 1
        else:
            flops, nbytes = self._aten(func, name, args, kwargs, out)
        self.flops += flops
        self.bytes += nbytes
        self._made(func, out)
        return out

    @staticmethod
    def _aten(func, name, args, kwargs, out):
        if func.is_view or name in _FREE:
            return 0, 0
        packet = func.overloadpacket
        if packet in flop_registry:
            flops = flop_registry[packet](*args, out_val=out, **kwargs)
        elif torch.Tag.pointwise in func.tags:
            flops = sum(t.numel() for t in _tensors(out))
        elif name in _REDUCTIONS:
            flops = max((t.numel() for t in _tensors(args)), default=0)
        else:
            flops = 0
        return flops, _bytes((args, kwargs)) + _bytes(out)


def analyze(fn, *args, **kwargs) -> dict:
    """Run `fn(*args, **kwargs)` under `OpCost`: {"flops", "bytes",
    "peak", "kernels"}."""
    with OpCost() as cost:
        fn(*args, **kwargs)
    return {"flops": cost.flops, "bytes": cost.bytes, "peak": cost.peak,
            "kernels": dict(cost.kernels)}


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in a nested dict/list/tuple/dataclass."""
    if hasattr(tree, "__dataclass_fields__"):
        tree = [getattr(tree, f) for f in tree.__dataclass_fields__]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(t) for t in tree)
    return tree.numel() * tree.element_size() \
        if isinstance(tree, torch.Tensor) else 0

