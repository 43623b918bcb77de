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
           row copy         every row read once and written once
           grad sums        every gradient read once, the f32 sums
                            written; 2 FLOPs (square, add) an element
           AdamW update     g, p, m, v read once and p, m, v written
                            once (22 bytes a bf16 parameter); the plain
                            version's 17 f32 operations an element.

The reference weighs a `lax.scan` body by its trip count; the port's
layer loop is Python, so every op already counts once per layer.

`CountingRank` is one rank of a mesh that does not exist (the dry run's
twin-pod `AbstractMesh`): the collectives a rank-local step calls
(`launch.mesh.Collectives` for a meshed train step, the serve-side
`reduce`, `gather`, `gather_rows` and `exchange` of
`transformer.TensorParallel.serving`) return meta tensors of the shapes
the real collectives return and record (kind, axis, bytes) under the
reference's kinds, bytes as `collective_bytes_of_hlo` counts them: the
result's, an all-reduce twice (the ring). They move no data, so
`OpCost` (which sees their results made) keeps the collectives out of
its FLOPs and bytes.
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


def _grad_sumsq(args, out):
    (grads,) = args
    return 2 * sum(g.numel() for g in grads), _bytes(grads) + _bytes(out)


#: f32 operations of one element's AdamW step (the clip's scale, m's 3,
#: v's 4, the bias-corrected ratio's 5, the decay's 2, the step's 2)
ADAMW_FLOPS = 17


def _adamw_apply(args, out):
    grads, params, m, v, params_out, m_out, v_out = args
    return ADAMW_FLOPS * sum(p.numel() for p in params), \
        _bytes((grads, params, m, v)) + _bytes((params_out, m_out, v_out))


#: the hand-written kernels' operators (`kernels.meta`) and their prices
KERNELS = {
    "repro_torch::paged_attention": _paged,
    "repro_torch::flash_attention": _flash,
    "repro_torch::flash_attention_bwd": _flash_bwd,
    "repro_torch::page_copy": _page_copy,
    "repro_torch::grad_sumsq": _grad_sumsq,
    "repro_torch::adamw_apply": _adamw_apply,
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



# ---------------------------------------------------------------------------
# A counting rank: the collectives of a rank-local step, recorded
# ---------------------------------------------------------------------------

#: the reference's collective kinds (`collective_bytes_of_hlo`)
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter")


def collective_bytes(kind: str, result: torch.Tensor) -> int:
    """A collective's bytes as the reference's HLO count takes them: its
    result's, twice for an all-reduce (the ring moves ~2x the
    buffer)."""
    n = result.numel() * result.element_size()
    return 2 * n if kind == "all-reduce" else n


class CountingRank:
    """One rank of a mesh of `sizes` ({axis: size}) at coordinate 0 on
    every axis, on the meta device: every collective it hands out
    records (kind, axis, bytes) in `records` and returns what the real
    one would (a sum keeps the shape; a gather over an axis multiplies
    `dim` by its size; a reduce-scatter divides it). `batch_axes`: the
    axes a moe rank's `gather_rows` spans (the batch axes in use,
    gathered the last one first, as `launch.mesh.gather_whole`)."""

    def __init__(self, sizes, batch_axes=("data",)):
        self.sizes = dict(sizes)
        self.batch_axes = tuple(batch_axes)
        self.coord = {a: 0 for a in self.sizes}
        self.records = []

    def record(self, kind: str, axis: str, result: torch.Tensor):
        self.records.append((kind, axis, collective_bytes(kind, result)))
        return result

    # -- the collectives, with no gradient ---------------------------------

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """`t` summed over `axis` (in place, as `launch.mesh.
        all_reduce_sum`): `t`."""
        return self.record("all-reduce", axis, t)

    def all_gather(self, t: torch.Tensor, axis: str,
                   dim: int) -> torch.Tensor:
        shape = list(t.shape)
        shape[dim % t.dim()] *= self.sizes[axis]
        return self.record("all-gather", axis, t.new_empty(shape))

    def reduce_scatter(self, t: torch.Tensor, axis: str,
                       dim: int) -> torch.Tensor:
        shape = list(t.shape)
        shape[dim % t.dim()] //= self.sizes[axis]
        return self.record("reduce-scatter", axis, t.new_empty(shape))

    # -- a serving rank's (`TensorParallel.serving`) ------------------------

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        return self.all_reduce(t, "model")

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return self.all_gather(t, "model", dim)

    def gather_rows(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        for axis in reversed(self.batch_axes):
            t = self.all_gather(t, axis, dim)
        return t

    # -- a training rank's (`launch.mesh.Collectives`) ----------------------

    def collectives(self):
        """The meshed train step's collectives: `sum` with no gradient;
        `enter`, `reduce`, `gather` (over `model`) and `gather_data`
        (over `data`) differentiable, each recording its backward's
        collective too (enter <-> a sum over `model`, the gather over
        `model` <-> its slice, none; `gather_data` <-> a reduce-scatter
        over `data`), as `launch.mesh`'s."""
        from repro_torch.launch.mesh import Collectives
        rank = self

        class Enter(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x.view_as(x)

            @staticmethod
            def backward(ctx, g):
                return rank.all_reduce(g.clone(), "model")

        class Sum(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return rank.all_reduce(x.clone(), "model")

            @staticmethod
            def backward(ctx, g):
                return g

        class Gather(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, axis, dim):
                ctx.axis, ctx.dim, ctx.size = axis, dim, x.shape[dim]
                return rank.all_gather(x, axis, dim)

            @staticmethod
            def backward(ctx, g):
                if ctx.axis == "data":
                    return rank.reduce_scatter(g, "data", ctx.dim), \
                        None, None
                return g.narrow(ctx.dim, 0, ctx.size).contiguous(), \
                    None, None

        return Collectives(
            coord=dict(self.coord), device=torch.device("meta"),
            sum=lambda t, axis: self.all_reduce(t, axis),
            enter=Enter.apply, reduce=Sum.apply,
            gather=lambda t, dim: Gather.apply(t, "model", dim),
            gather_data=lambda t, dim: Gather.apply(t, "data", dim))

    def tally(self) -> dict:
        """{kind: bytes (each of COLLECTIVE_KINDS), "total": bytes,
        "by_axis": {axis: bytes}} of every record."""
        out = {k: 0.0 for k in COLLECTIVE_KINDS}
        by_axis = collections.Counter()
        for kind, axis, n in self.records:
            out[kind] += n
            by_axis[axis] += n
        out["total"] = float(sum(n for _, _, n in self.records))
        out["by_axis"] = {a: float(n) for a, n in sorted(by_axis.items())}
        return out
