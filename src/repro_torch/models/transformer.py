"""Decoder over the two-tier paged cache (the port of the reference's
`models/transformer.py`: the dense decoder, shared with the moe and vlm
families, and whisper's encoder-decoder).

Parameters are a nested dict of tensors in the reference's layout:
per-layer weights stacked on a leading [L] dim (`params["layers"]`),
`wq` [L, d, H, HD], `wk`/`wv` [L, d, KH, HD], `wo` [L, H, HD, d]. The
reference's `lax.scan` over layers is a Python loop here, over
`blocks`: one (attention weights, FFN) pair per cache layer, in cache
order (`dense_blocks` here, `Model.blocks` for the moe family). An
FFN is called as `ffn(h, group_size)`; `group_size` is the moe routing
group, which the dense MLP ignores.

Tensor parallelism (the meshed serve): a rank's `Model` runs its
rank-local config (`ModelConfig.rank_local`: local head counts) over
its weight shards (`bridge.shard_params`) and holds a `TensorParallel`,
which the dense path's functions take as `tp` (None: the whole model).
The attention output projection and the MLP's down projection give
partial sums, all-reduced over `model`; the embedding is the rank's
vocabulary rows, looked up where the token falls in them (zero
elsewhere) and all-reduced, which is exact; the logits are the rank's
vocabulary columns, all-gathered over `model` before anything reads
them; the decode step's per-page importance sums over KV heads, so
each rank's share is all-reduced before it enters the cache, and every
model rank plans from the same numbers. A dim the axis does not divide
(`TensorParallel.mlp_split` False, `.vocab` None) is held whole and
needs no collective. `TensorParallel.serving` binds such a rank for
every family: whisper's decoder and the hybrid sites attend as a dense
decode layer does (`decode_attend`), a recurrent block's decode
multiplies by the weight blocks it holds and moves the products
(`model_cols`, `model_rows`).

Training across a mesh (`loss_fn` under `make_train_step(..., mesh=)`,
every family) binds the same `TensorParallel` to differentiable
collectives (`launch.mesh`): the sums are Megatron's g, the logits'
gather gives each rank its slice of the gradient back, and `enter`
(Megatron's f: the identity forward, the gradient summed over `model`
backward) sits where a replicated activation meets a column-parallel
product (the QKV and gate/up projections, the unembedding) and on the
per-head norm weights, so the gradients of the norm weights, the
residual stream and the embedding rows are whole on every rank. Only a
part the axis splits enters or is summed: a part it does not split (the
attention where it divides no head count, a recurrent block where it
does not divide the heads, an MLP or vocabulary it does not divide)
runs whole and alike on every model rank, whose gradients are then
whole already (an enter would count them size times). A
training rank also holds FSDP blocks over `data`
(`TensorParallel.data_dims`, by the leaf's path in the parameter tree):
each block gathers them whole inside itself (`data_whole`, given the
path of its weights), so under remat a layer's whole weights live only
during its forward and its recompute, and the gather's backward
reduce-scatters their gradient. A recurrent block (`models.ssm`,
`models.xlstm`) whose leaves the sharding rules cut across its heads
gathers those over `model` (`model_whole`) and runs that part whole;
it splits only what follows its heads (`model_own`, `model_part`,
`split_rms_norm`), and where the axis does not divide its heads it
gathers every leaf it holds a block of and runs whole.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.kernels import ops, ref
from repro_torch.kernels.page_copy import Split
from repro_torch.kvcache.paged import (
    IMPORTANCE_EMA, PagedKVCache, PoolShard, allocate_prompt_pages,
    read_token_layer, write_token_layer, write_tokens_layer,
)
from repro_torch.models.config import ModelConfig, splits
from repro_torch.models.layers import (
    apply_rope, attention, gelu, layer_norm, prefix_chunk_attention,
    prefix_chunk_partial, repeat_kv, rms_norm, swiglu,
)
from repro_torch.models.params import Param


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------

def attn_schema(cfg: ModelConfig, L: int):
    d, h, kh, hd = cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.head_dim
    s = {
        "attn_norm": Param((L, d), ("layers", "embed"), "ones"),
        "wq": Param((L, d, h, hd), ("layers", "embed", "heads", "head_dim"),
                    fan_in_axes=(1,)),
        "wk": Param((L, d, kh, hd),
                    ("layers", "embed", "kv_heads", "head_dim"),
                    fan_in_axes=(1,)),
        "wv": Param((L, d, kh, hd),
                    ("layers", "embed", "kv_heads", "head_dim"),
                    fan_in_axes=(1,)),
        "wo": Param((L, h, hd, d), ("layers", "heads", "head_dim", "embed"),
                    fan_in_axes=(1, 2)),
    }
    if cfg.qk_norm:
        s["q_norm"] = Param((L, hd), ("layers", "head_dim"), "ones")
        s["k_norm"] = Param((L, hd), ("layers", "head_dim"), "ones")
    return s


def mlp_schema(cfg: ModelConfig, L: int):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mlp_norm": Param((L, d), ("layers", "embed"), "ones"),
        "w_gate": Param((L, d, f), ("layers", "embed", "mlp"),
                        fan_in_axes=(1,)),
        "w_up": Param((L, d, f), ("layers", "embed", "mlp"),
                      fan_in_axes=(1,)),
        "w_down": Param((L, f, d), ("layers", "mlp", "embed"),
                        fan_in_axes=(1,)),
    }


def head_schema(cfg: ModelConfig):
    """The embedding, the final norm and the (untied) unembedding."""
    s = {"embed": Param((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                        "embed"),
         "final_norm": Param((cfg.d_model,), ("embed",), "ones")}
    if not cfg.tie_embeddings:
        s["unembed"] = Param((cfg.d_model, cfg.vocab), ("embed", "vocab"),
                             fan_in_axes=(0,))
    return s


def dense_schema(cfg: ModelConfig):
    return {**head_schema(cfg), "layers": {
        **attn_schema(cfg, cfg.num_layers),
        **mlp_schema(cfg, cfg.num_layers)}}


def encdec_schema(cfg: ModelConfig):
    """Whisper-style: LN with bias, GELU MLP, learned positions,
    cross-attention."""
    d, f = cfg.d_model, cfg.d_ff
    Le = cfg.encdec.enc_layers
    Ld = cfg.num_layers

    def ln(L):
        return {"w": Param((L, d), ("layers", "embed"), "ones"),
                "b": Param((L, d), ("layers", "embed"), "zeros")}

    def attn(L):
        base = attn_schema(cfg, L)
        del base["attn_norm"]
        return base

    def mlp(L):
        return {
            "w_in": Param((L, d, f), ("layers", "embed", "mlp"),
                          fan_in_axes=(1,)),
            "b_in": Param((L, f), ("layers", "mlp"), "zeros"),
            "w_out": Param((L, f, d), ("layers", "mlp", "embed"),
                           fan_in_axes=(1,)),
            "b_out": Param((L, d), ("layers", "embed"), "zeros"),
        }

    def final():
        return {"w": Param((d,), ("embed",), "ones"),
                "b": Param((d,), ("embed",), "zeros")}

    return {
        "embed": Param((cfg.vocab, d), ("vocab", "embed"), "embed"),
        "dec_pos": Param((cfg.encdec.dec_positions, d), (None, "embed"),
                         "embed"),
        "enc_pos": Param((cfg.encdec.enc_positions, d), (None, "embed"),
                         "embed"),
        "enc_layers": {"ln1": ln(Le), "attn": attn(Le), "ln2": ln(Le),
                       "mlp": mlp(Le)},
        "enc_final": final(),
        "dec_layers": {"ln1": ln(Ld), "self_attn": attn(Ld),
                       "ln2": ln(Ld), "cross_attn": attn(Ld),
                       "ln3": ln(Ld), "mlp": mlp(Ld)},
        "dec_final": final(),
    }


def layers_of(tree):
    """Every layer's weights out of a stacked (nested) tree, as a list:
    one `unbind` per leaf. Under autograd its backward stacks the L
    layers' gradients in one pass, where indexing each layer would add
    L zero-padded full-size gradients."""
    flat = {k: layers_of(v) if isinstance(v, dict) else v.unbind(0)
            for k, v in tree.items()}
    n = len(next(iter(flat.values()))) if flat else 0
    return [{k: v[l] for k, v in flat.items()} for l in range(n)]


# ---------------------------------------------------------------------------
# Forward building blocks
# ---------------------------------------------------------------------------

def attn_qkv(x, lp, cfg: ModelConfig, positions, rope: bool = True,
             tp=None):
    """x [B,S,d] -> q [B,S,H,HD], k/v [B,S,KH,HD] (RoPE applied), the
    heads those of the weights (a rank's `wq` shard under a rule that
    keeps the KV heads whole: its `TensorParallel.heads`). `tp`: a
    training rank's, whose per-head norm weights (whole on `model`,
    used on its heads alone) enter the split region where the axis
    splits the heads, and `wk`/`wv` too where it keeps the KV heads
    whole (after their FSDP gather: their gradient summed over `model`,
    then reduce-scattered over `data`)."""
    B, S, d = x.shape
    hd = cfg.head_dim
    split = tp is not None and tp.heads_split
    wk, wv = lp["wk"], lp["wv"]
    if tp is not None and tp.heads is not None:
        # every KV head on every rank, each rank's heads reading some:
        # each rank's gradient of them is a share, summed over `model`
        wk, wv = tp.enter(wk), tp.enter(wv)
    q = (x @ lp["wq"].reshape(d, -1)).view(B, S, -1, hd)
    k = (x @ wk.reshape(d, -1)).view(B, S, -1, hd)
    v = (x @ wv.reshape(d, -1)).view(B, S, -1, hd)
    if cfg.qk_norm:
        q = rms_norm(q, model_enter(lp["q_norm"], tp, split), cfg.norm_eps)
        k = rms_norm(k, model_enter(lp["k_norm"], tp, split), cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_out(o, lp):
    """o [B,S,H,HD] -> [B,S,d] through wo [H,HD,d]."""
    B, S = o.shape[:2]
    wo = lp["wo"]
    return o.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])


def _same(x):
    return x


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """One rank's place on a mesh's `model` axis, and the axis's
    collectives: `reduce(t)` sums `t` over the axis, `gather(t, dim)`
    concatenates the ranks' `t` on `dim` in rank order, `enter(t)` marks
    where a replicated activation enters the split region (the serving
    engine binds the first two to in-place collectives with no gradient
    and `enter` to the identity; a meshed train step binds all three to
    differentiable ones, `enter` summing the gradient over the axis).
    Heads and KV heads are split when the axis divides the KV heads
    (`kv_split`, the `kv_heads` KV pool rule: the rank-local config
    counts the rank's heads). Otherwise the rank holds every KV head
    (`wk`/`wv` whole) and its config counts every head; `heads` is the
    rank's [lo, hi) of the query heads its `wq`/`wo` shards hold when
    the axis divides them (None: whole), and its decode and chunked-
    prefill attention gathers q's heads over `model` (`gather_heads`),
    attends over every head and keeps its own (`own_heads`). Its pools
    then hold `pool`, its block of each tier's slots (the `pages` rule:
    the ranks' partial attentions gathered with `gather` and merged,
    `ops.shard_paged_attention`), or every slot (`pool` None: the
    `none` rule). The MLP's hidden dim is split when
    `mlp_split`; the vocabulary when `vocab` is the rank's [lo, hi) rows
    (None: held whole); a moe model's padded experts when `experts` is
    the rank's [lo, hi) of them (None: every expert, at the MLP's
    split).

    A training rank meets three shapes of attention and recurrence
    (`heads_split`, `recurrent_split`): its heads and KV heads split
    (`kv_split`); its query heads split over every KV head (`heads`
    set: `wk`/`wv` whole, their gradient a share each rank's heads
    give, summed over `model`); or its heads whole, where every model
    rank runs the attention, or a recurrent block, whole and alike,
    with no enter and no sum. A training rank also holds FSDP blocks
    over `data`:
    `data_dims` gives, by the leaf's path in the parameter tree
    ("layers/wq", "enc_layers/ln1/w", "shared_attn/wq", "embed"), the
    dim of its block (of one layer's weights, for a stacked leaf),
    `gather_data(t, dim)` gathers a block whole; a leaf not named is
    whole on `data`. `model_dims` likewise names the leaves it holds a
    block of on `model` and the dim (a recurrent block gathers those its
    heads do not follow, `model_whole`). `rows` = (this
    rank's index, the axis size) on `data` when the rank's rows (lanes,
    or a batch's rows) are one block of a stream split over the axis,
    which moe routing must see whole (`models.moe`):
    `gather_rows(t, dim)` concatenates every data rank's `t` in rank
    order (a serve binds it to a collective with no gradient, a train
    step to `gather_data`, whose backward gives each rank its own
    rows' gradient summed); None: the rank holds every row."""

    size: int
    rank: int
    mlp_split: bool
    vocab: Optional[Tuple[int, int]]
    reduce: Callable[[torch.Tensor], torch.Tensor]
    gather: Callable[[torch.Tensor, int], torch.Tensor]
    enter: Callable[[torch.Tensor], torch.Tensor] = _same
    data_dims: Dict[str, int] = dataclasses.field(default_factory=dict,
                                                  compare=False)
    model_dims: Dict[str, int] = dataclasses.field(default_factory=dict,
                                                   compare=False)
    gather_data: Optional[Callable[[torch.Tensor, int], torch.Tensor]] = None
    experts: Optional[Tuple[int, int]] = None
    rows: Optional[Tuple[int, int]] = None
    gather_rows: Optional[Callable[[torch.Tensor, int], torch.Tensor]] = None
    kv_split: bool = True
    heads: Optional[Tuple[int, int]] = None
    pool: Optional[PoolShard] = None

    @property
    def heads_split(self) -> bool:
        """Whether the rank's attention projections hold a block of the
        query heads (then the output projection's partial is summed
        over `model`)."""
        return self.kv_split or self.heads is not None

    @property
    def recurrent_split(self) -> bool:
        """Whether a recurrent block (Mamba2, mLSTM, sLSTM) runs the
        rank's block of its heads, which are the config's heads and KV
        heads alike (`ModelConfig.rank_local` then counts the rank's);
        else every model rank runs the block whole."""
        return self.kv_split

    @property
    def imp_split(self) -> bool:
        """Whether the rank's decode importance is its share of the
        whole (its KV heads' mass, or its slots' placed among zeros),
        summed over `model`; under the `none` rule every rank computes
        the whole."""
        return self.kv_split or self.pool is not None

    @classmethod
    def of(cls, cfg: ModelConfig, size: int, rank: int, reduce,
           gather, **more) -> "TensorParallel":
        """Rank `rank` of a `model` axis of `size` over the whole
        model's `cfg` (the sharding rules' splits); `more`: `enter`,
        `data_dims`, `model_dims` and `gather_data` for a meshed train step,
        `gather_rows` for a moe model's routing over `data`, `pool` for
        a serve's pools under the `pages` rule."""
        per = cfg.vocab // size
        E = cfg.moe.num_experts_padded if cfg.moe is not None else 0
        kv_split = splits(cfg.kv_heads, size)
        nh = cfg.num_heads // size
        heads = (rank * nh, (rank + 1) * nh) \
            if not kv_split and splits(cfg.num_heads, size) else None
        return cls(size=size, rank=rank, mlp_split=splits(cfg.d_ff, size),
                   kv_split=kv_split, heads=heads,
                   vocab=(rank * per, (rank + 1) * per)
                   if splits(cfg.vocab, size) else None,
                   experts=(rank * E // size, (rank + 1) * E // size)
                   if E and splits(E, size) else None,
                   reduce=reduce, gather=gather, **more)

    @classmethod
    def serving(cls, cfg: ModelConfig, mesh, coord, reduce, gather,
                gather_rows=None, geo=None) -> "TensorParallel":
        """A serving rank's (a meshed engine's, a dry-run rank's) over the
        whole model's `cfg`, every family: rank `coord["model"]` of
        `mesh` (anything with axis sizes: a `DeviceMesh`, an
        `AbstractMesh`) with its serve-mode blocks on `model`
        (`model_dims`, which a recurrent block gathers or multiplies
        by, `models.ssm`, `models.xlstm`), `reduce` and `gather` over
        `model`, `gather_rows` over the batch axes (a moe model's
        routing) and, for a cache of `geo`'s tiers under the `pages`
        KV pool rule, its block of the pools' slots (`pool`, whose
        exchange is `reduce`)."""
        from repro_torch.bridge import param_specs
        from repro_torch.kvcache.paged import PoolShard
        from repro_torch.launch.mesh import mesh_axis_sizes
        from repro_torch.launch.shardings import _kv_shard_axis, pool_slots
        from repro_torch.training.train_step import layer_dims
        size = mesh_axis_sizes(mesh)["model"]
        pool = None
        if geo is not None and _kv_shard_axis(geo, mesh) == "pages":
            pool = PoolShard(*pool_slots(geo, mesh, coord["model"]),
                             exchange=reduce)
        return cls.of(cfg, size, coord["model"], reduce=reduce,
                      gather=gather, gather_rows=gather_rows, pool=pool,
                      model_dims=layer_dims(
                          cfg, param_specs(cfg, mesh, "serve"), "model"))


def model_sum(x, tp: Optional[TensorParallel], split: bool = True):
    """A row-parallel partial sum `x` summed over the `model` axis when
    `tp` is given and the dim is `split`; else `x`."""
    return tp.reduce(x) if tp is not None and split else x


def model_enter(x, tp: Optional[TensorParallel], split: bool = True):
    """`x` entering the `model`-split region (`TensorParallel.enter`)
    when `tp` is given and the dim is `split`; else `x`."""
    return tp.enter(x) if tp is not None and split else x


def gather_heads(q, tp: Optional[TensorParallel]):
    """q [B, S, h, HD] of the rank's query heads as every head's,
    gathered over `model` (`TensorParallel.heads`); else `q`."""
    if tp is None or tp.heads is None:
        return q
    return tp.gather(q, 2)


def own_heads(o, tp: Optional[TensorParallel]):
    """o [B, S, H, HD] over every query head cut to the rank's own
    (`TensorParallel.heads`), which its `wo` shard projects; else `o`."""
    if tp is None or tp.heads is None:
        return o
    lo, hi = tp.heads
    return o[:, :, lo:hi]


def rank_kv(k, v, cfg: ModelConfig, tp: Optional[TensorParallel]):
    """The K/V [B, S, KH, HD] (every KV head, under a rule that keeps
    them whole) that the rank's query heads read through the flash
    kernel, whose KV heads must divide the call's heads: head h reads
    KV head h // G. The KV heads the rank's heads span when they start
    and end on a KV head's boundary or lie in one KV head (internlm2 at
    16 ranks: 1 head, KV head rank // 2; qwen3-32b at 16: 4 heads, one
    KV head); else each of the rank's heads' KV head, repeated to its
    heads. (k, v) themselves where the rank runs every head."""
    if tp is None or tp.heads is None:
        return k, v
    lo, hi = tp.heads
    G = cfg.q_per_kv
    if lo % G == 0 and hi % G == 0 or lo // G == (hi - 1) // G:
        first, last = lo // G, (hi - 1) // G + 1
        return k[:, :, first:last], v[:, :, first:last]
    idx = torch.arange(lo, hi, device=k.device) // G
    return k[:, :, idx], v[:, :, idx]


def data_whole(tree, tp: Optional[TensorParallel], at: str = "",
               names=None):
    """`tree` (a dict of weights, nested dicts recursed) at path `at` of
    the parameter tree ("" the root), with each of its leaves (those
    named in `names`, if given) whole on the `data` axis: a leaf the
    rank holds an FSDP block of (`TensorParallel.data_dims`) is
    gathered; `tree` itself when the rank holds none."""
    if tp is None or not tp.data_dims:
        return tree
    out = dict(tree)
    for k, v in tree.items():
        path = _path(at, k)
        if names is not None and k not in names:
            continue
        if isinstance(v, dict):
            out[k] = data_whole(v, tp, path)
        elif path in tp.data_dims:
            out[k] = tp.gather_data(v, tp.data_dims[path])
    return out


def _path(at: str, name: str) -> str:
    return f"{at}/{name}" if at else name


def model_whole(tree, tp: Optional[TensorParallel], at: str, names):
    """`tree` with its leaves `names` whole on the `model` axis: a leaf
    the rank holds a block of (`TensorParallel.model_dims`) is gathered
    (`gather`: in training, its backward hands the rank its own slice of
    a gradient every model rank holds whole, so the block must use the
    whole leaf alike on every rank)."""
    if tp is None or not tp.model_dims:
        return tree
    dims = {k: tp.model_dims.get(_path(at, k)) for k in names}
    return {k: v if dims.get(k) is None else tp.gather(v, dims[k])
            for k, v in tree.items()}


def model_part(x, tp: Optional[TensorParallel], dim: int):
    """This rank's block on `dim` of `x`, whole on every model rank
    (an activation of a part run whole, or a leaf held whole): the
    block the rank's heads follow, rank-major. It enters the split
    region (`enter`), so its gradient, which the rank gives only for
    its block, is summed over `model`. `x` itself without `tp`."""
    if tp is None:
        return x
    n = x.shape[dim] // tp.size
    return tp.enter(x).narrow(dim, tp.rank * n, n)


def model_own(tree, tp: Optional[TensorParallel], at: str, name: str,
              dim: int):
    """The rank's block on `dim` of the leaf `name` of `tree` (at path
    `at`): the leaf itself where the rank holds that block
    (`TensorParallel.model_dims`), else cut from the whole
    (`model_part`)."""
    t = tree[name]
    if tp is None or tp.model_dims.get(_path(at, name)) == dim % t.dim():
        return t
    return model_part(model_whole(tree, tp, at, (name,))[name], tp, dim)


def model_cols(x, tree, tp: Optional[TensorParallel], at: str, name: str,
               mm=torch.matmul):
    """`mm(x, w)` over the whole of the leaf `w = tree[name]` (at path
    `at`) whose last dim the rank may hold a block of
    (`TensorParallel.model_dims`): then the rank's block of the product,
    gathered over `model` (the product crosses, not the weight)."""
    w = tree[name]
    if tp is None or tp.model_dims.get(_path(at, name)) != w.dim() - 1:
        return mm(x, w)
    return tp.gather(mm(x, w), -1)


def model_rows(x, tree, tp: Optional[TensorParallel], at: str, name: str,
               mm=torch.matmul):
    """`mm(x, w)` over the whole of the leaf `w = tree[name]` [n, k]
    whose rows the rank may hold a block of (`TensorParallel.
    model_dims`): then its block of `x`'s last dim times it, the
    partial summed over `model`."""
    w = tree[name]
    if tp is None or tp.model_dims.get(_path(at, name)) != 0:
        return mm(x, w)
    n = w.shape[0]
    return tp.reduce(mm(x.narrow(-1, tp.rank * n, n), w))


def split_rms_norm(x, w, eps: float, tp: Optional[TensorParallel]):
    """`rms_norm` over a last dim split over the `model` axis: x [..., n]
    is the rank's block of the whole [..., n x size] and `w` its block
    of the weight; the mean of squares is summed over the axis (forward
    and backward: each rank's block feeds every rank's norm). On one
    model rank, or without `tp`, `rms_norm` itself."""
    if tp is None or tp.size == 1:
        return rms_norm(x, w, eps)
    dtype = x.dtype
    xf = x.float()
    ss = tp.enter(tp.reduce(xf.square().sum(dim=-1, keepdim=True)))
    var = ss / (x.shape[-1] * tp.size)
    return (xf * torch.rsqrt(var + eps)).to(dtype) * w


#: the weights of an attention block and of a dense MLP block
ATTN_LEAVES = ("attn_norm", "wq", "wk", "wv", "wo", "q_norm", "k_norm")
MLP_LEAVES = ("mlp_norm", "w_gate", "w_up", "w_down")


def full_attn_block(h, lp, cfg: ModelConfig, positions, tp=None,
                    at: str = "layers"):
    """Pre-norm attention block over a full sequence (prefill); also
    returns the post-RoPE (k, v). `attention` takes K/V with KH heads:
    the flash kernel reads them un-repeated on the card, the CPU path
    repeats them per query head. `at`: the weights' path in the
    parameter tree (a training rank's FSDP blocks, `data_whole`). A
    rank that holds every KV head attends at its own query heads over
    the KV heads they read (`rank_kv`) and returns every KV head's
    (k, v); one whose axis splits no head runs the block whole, its
    input entering nothing and its output summed over nothing."""
    lp = data_whole(lp, tp, at, ATTN_LEAVES)
    split = tp is not None and tp.heads_split
    x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    q, k, v = attn_qkv(model_enter(x, tp, split), lp, cfg, positions,
                       tp=tp)
    o = attention(q, *rank_kv(k, v, cfg, tp))
    return h + model_sum(attn_out(o, lp), tp, split), (k, v)


def dense_mlp_block(h, lp, cfg: ModelConfig, tp=None, at: str = "layers"):
    lp = data_whole(lp, tp, at, MLP_LEAVES)
    split = tp is not None and tp.mlp_split
    x = rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
    y = swiglu(model_enter(x, tp, split), lp["w_gate"], lp["w_up"],
               lp["w_down"])
    return h + model_sum(y, tp, split)


def dense_blocks(params, cfg: ModelConfig, tp=None):
    """(attention weights, FFN) per layer of a dense model."""
    def block(lp):
        return lp, lambda h, group_size=None: dense_mlp_block(h, lp, cfg,
                                                              tp)
    return [block(lp) for lp in layers_of(params["layers"])]


def remat_call(remat: bool, fn, *args):
    """fn(*args); with `remat`, under activation checkpointing
    (`torch.utils.checkpoint`, non-reentrant): the block keeps only its
    inputs and recomputes its activations in the backward, where the
    reference wraps its scan bodies in `jax.checkpoint`. The values are
    the same either way."""
    if remat:
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def embed_tokens(params, cfg: ModelConfig, tokens, tp=None):
    return embed_rows(params, tokens, tp).to(cfg.dtype)


def embed_rows(params, tokens, tp=None):
    """The embedding's rows of `tokens`, in the parameters' dtype: on a
    rank whose `tp` splits the vocabulary, its rows looked up where the
    token falls in them (zero elsewhere) and summed over `model`."""
    embed = data_whole(params, tp, "", ("embed",))["embed"]
    if tp is None or tp.vocab is None:
        return embed[tokens.long()]
    lo, hi = tp.vocab
    local = tokens.long() - lo
    mine = (local >= 0) & (local < hi - lo)
    rows = embed[local.clamp(0, hi - lo - 1)]
    return tp.reduce(rows.masked_fill(~mine[..., None], 0))


def unembed_weight(params, cfg: ModelConfig, tp=None):
    """The unembedding [d, V] (tied: `embed`'s transpose), whole on the
    `data` axis; a rank's vocabulary columns when `tp` splits them."""
    name = "embed" if cfg.tie_embeddings else "unembed"
    w = data_whole(params, tp, "", (name,))[name]
    return w.T if cfg.tie_embeddings else w


def unembed(params, cfg: ModelConfig, h, tp=None):
    split = tp is not None and tp.vocab is not None
    logits = model_enter(h, tp, split) @ unembed_weight(params, cfg, tp)
    if split:
        logits = tp.gather(logits, -1)
    return logits


def decoder_forward(params, cfg: ModelConfig, tokens, blocks,
                    input_embeds: Optional[torch.Tensor] = None, *,
                    return_hidden: bool = False, remat: bool = False,
                    tp=None, attn_at=None):
    """tokens [B,S] (or `input_embeds` [B,S,d], which the vlm family
    builds from patch and token embeddings) -> (logits [B,S,V], the
    post-RoPE (k, v) stacked [L,B,S,KH,HD] for prefill cache
    population). With `return_hidden`: the final-norm hidden states
    [B,S,d] alone (training's path; `remat` checkpoints each layer).
    `attn_at`: each block's attention weights' path in the parameter
    tree (default "layers"; `Model.attn_paths`)."""
    h = embed_tokens(params, cfg, tokens, tp) if input_embeds is None \
        else input_embeds
    S = h.shape[1]
    positions = torch.arange(S, device=h.device)[None, :]

    def layer(h, lp, ffn, at):
        h, kv = full_attn_block(h, lp, cfg, positions, tp, at)
        return ffn(h), kv
    ks, vs = [], []
    for l, (lp, ffn) in enumerate(blocks):
        at = "layers" if attn_at is None else attn_at[l]
        h, (k, v) = remat_call(remat, layer, h, lp, ffn, at)
        if not return_hidden:
            ks.append(k)
            vs.append(v)
    h = final_norm(params, cfg, h, tp)
    if return_hidden:
        return h
    return unembed(params, cfg, h, tp), (torch.stack(ks), torch.stack(vs))


def final_norm(params, cfg: ModelConfig, h, tp=None):
    """The final RMSNorm (its weight whole on the `data` axis)."""
    return rms_norm(h, data_whole(params, tp, "", ("final_norm",))[
        "final_norm"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# Paged decode step
# ---------------------------------------------------------------------------

def allocate_token_page(cache: PagedKVCache,
                        write_slot: torch.Tensor) -> PagedKVCache:
    """Register the logical page receiving this step's token in the page
    table / owner maps (before `tier_lists`, so the fresh page is
    visible to attention). Returns new tables; pools are untouched."""
    L, B = write_slot.shape
    hbm_pages = cache.hbm_owner.shape[2]
    host_pages = cache.host_owner.shape[2]
    T = cache.k_hbm.shape[3]
    max_pages = cache.page_table.shape[2]
    dev = write_slot.device
    logical = (cache.length // T).clamp_max(max_pages - 1)       # [B]
    lidx = torch.arange(L, device=dev)[:, None].expand(L, B)
    bidx = torch.arange(B, device=dev)[None, :].expand(L, B)
    lg = logical[None, :].expand(L, B)
    page_table = cache.page_table.clone()
    page_table[lidx, bidx, lg.long()] = write_slot
    in_hbm = write_slot < hbm_pages
    hslot = write_slot.clamp(0, hbm_pages - 1).long()
    hbm_owner = cache.hbm_owner.clone()
    hbm_owner[lidx, bidx, hslot] = torch.where(
        in_hbm, lg, cache.hbm_owner[lidx, bidx, hslot])
    eslot = (write_slot - hbm_pages).clamp(0, host_pages - 1).long()
    host_owner = cache.host_owner.clone()
    host_owner[lidx, bidx, eslot] = torch.where(
        ~in_hbm, lg, cache.host_owner[lidx, bidx, eslot])
    return dataclasses.replace(cache, page_table=page_table,
                               hbm_owner=hbm_owner, host_owner=host_owner)


def mask_write_visible(cache: PagedKVCache, logical_page_mask):
    """Force the page receiving this step's token visible in a Quest
    mask (the step's own K/V lands there), or None."""
    if logical_page_mask is None:
        return None
    T = cache.k_hbm.shape[3]
    logical = (cache.length // T).clamp_max(cache.page_table.shape[2] - 1)
    pages = torch.arange(logical_page_mask.shape[-1], device=logical.device)
    return logical_page_mask | (pages[None, None, :] == logical[None, :, None])


def _bump_valid(valid, slot, offset, T, *, hbm: bool, hbm_pages: int):
    """Account for the token written this step in the tier valid counts."""
    B = valid.shape[0]
    in_tier = (slot < hbm_pages) if hbm else (slot >= 0)
    s = slot.clamp(0, valid.shape[1] - 1).long()
    bidx = torch.arange(B, device=valid.device)
    cur = valid[bidx, s]
    out = valid.clone()
    out[bidx, s] = torch.where(in_tier, torch.maximum(cur, offset + 1), cur)
    return out


def paged_attend(q, pools, lists, slot, offset, cfg: ModelConfig,
                 tp: Optional[TensorParallel] = None):
    """This step's query q [B, 1, H, HD] against one layer's two tiers,
    the token just written at (slot, offset) counted valid: (o
    [B, 1, H, HD], per-page importance [B, Ph + Pe]) from the paged
    kernel on the card. `lists`: `tier_lists`' whole lists of the layer;
    on a rank whose pools hold its block of each tier's slots
    (`tp.pool`, the `pages` rule) the kernel reads its slots, the ranks'
    partials merge (`ops.shard_paged_attention`) and the importance is
    the rank's slots' mass at their places among zeros."""
    B = q.shape[0]
    T = pools[0].shape[2]
    hl, hv, el, ev = lists
    Ph, Pe = hl.shape[-1], el.shape[-1]
    qg = q[:, 0].reshape(B, cfg.kv_heads, cfg.q_per_kv, cfg.head_dim)
    hv_new = _bump_valid(hv, slot, offset, T, hbm=True, hbm_pages=Ph)
    ev_new = _bump_valid(ev, slot - Ph, offset, T, hbm=False, hbm_pages=Ph)
    shard = tp.pool if tp is not None else None
    if shard is None:
        o, imp = ops.tiered_paged_attention(qg.contiguous(), *pools, hl,
                                            hv_new, el, ev_new)
    else:
        o, (imp_h, imp_e) = ops.shard_paged_attention(
            qg.contiguous(), *pools, *shard.lists(hl, hv_new, el, ev_new),
            tp.gather)
        imp = shard.place(imp_h, imp_e, Ph, Pe)
    return o.reshape(B, 1, cfg.num_heads, cfg.head_dim), imp


def decode_attend(q, k, v, pools, lists, slot, offset, cfg: ModelConfig,
                  tp: Optional[TensorParallel] = None, active=None):
    """One layer's decode attention over its two tiers (a hybrid site, an
    encdec decoder layer): this token's k/v [B, 1, KH, HD] written
    first (it sees itself; under the `pages` rule by the rank that
    holds its slot), then q [B, 1, h, HD] against the pools
    (`paged_attend`; q gathered to every head and the output cut back
    to the rank's where `tp.heads` is set). `active`: see
    `decoder_decode_step`. Returns (o [B, 1, h, HD], the importance)."""
    shard = tp.pool if tp is not None else None
    q = gather_heads(q, tp)
    mine = slot if shard is None else \
        shard.local_slots(slot, lists[0].shape[-1])
    write_token_layer(*pools, mine, offset, k[:, 0], v[:, 0], active=active)
    o, imp = paged_attend(q, pools, lists, slot, offset, cfg, tp)
    return own_heads(o, tp), imp


def _update_cache_after_step(cache, imp, write_slot):
    """Fold the step's importance stats into the cache and bump length
    (tables were already updated by allocate_token_page; pools in
    place)."""
    max_pages = cache.page_table.shape[2]
    owner = torch.cat([cache.hbm_owner, cache.host_owner], dim=2)
    owner_safe = owner.clamp(0, max_pages - 1).long()
    mass = torch.zeros_like(cache.importance).scatter_add_(
        2, owner_safe, torch.where(owner >= 0, imp, 0.0))
    ema = IMPORTANCE_EMA
    importance = (1 - ema) * cache.importance + ema * mass
    return dataclasses.replace(cache, length=cache.length + 1,
                               importance=importance)


def decoder_decode_step(params, cfg: ModelConfig, cache: PagedKVCache,
                        token: torch.Tensor, write_slot: torch.Tensor,
                        blocks, logical_page_mask=None, active=None,
                        pool_ready=None, all_lanes: bool = False,
                        tp=None) -> Tuple[torch.Tensor, PagedKVCache]:
    """One decode step over the two-tier paged cache.

    token: [B] int32. write_slot: [L, B] physical slot receiving this
    token's page (slot >= hbm_pages means host pool). active (bool [B],
    optional): only those lanes' K/V stay in the pools — the serve
    loop's inactive lanes keep their pools as they were, and
    `control.lane_merge` then keeps their old tables. Their rows feed
    no output of an active lane unless `all_lanes` (the moe family,
    whose routing groups all B lanes): then every lane writes its token
    and attends over it as in the reference's step, and the rows an
    inactive lane overwrote are put back after the layer's attention.
    Otherwise the inactive lanes' rows are never written. pool_ready (a
    CUDA event, optional): the current stream waits on it just before
    the step first touches the pools (layer 0's token write), so the
    step's embedding and first projections overlap a migration commit
    that is still copying pages. `tp`: a rank's `TensorParallel` (see
    the module docstring). Returns (logits [B, V], updated cache).
    """
    B = token.shape[0]
    T = cache.k_hbm.shape[3]
    Ph = cache.hbm_owner.shape[2]
    shard = tp.pool if tp is not None else None
    pos = cache.length                        # [B]
    offset = pos % T
    h = embed_tokens(params, cfg, token[:, None], tp)    # [B,1,d]

    cache = allocate_token_page(cache, write_slot)
    logical_page_mask = mask_write_visible(cache, logical_page_mask)
    hl, hv, el, ev = cache.tier_lists(logical_page_mask=logical_page_mask)

    put_back = all_lanes and active is not None
    imps = []
    for l, (lp, ffn) in enumerate(blocks):
        slot = write_slot[l]
        pools = (cache.k_hbm[l], cache.v_hbm[l], cache.k_host[l],
                 cache.v_host[l])
        x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        q, k, v = attn_qkv(x, lp, cfg, pos[:, None])
        q = gather_heads(q, tp)
        if l == 0 and pool_ready is not None:
            torch.cuda.current_stream(token.device).wait_event(pool_ready)
        # write this token's k/v BEFORE attending (it must see itself);
        # under the pages rule only the rank that holds the slot writes
        mine = slot if shard is None else shard.local_slots(slot, Ph)
        if put_back:
            old = read_token_layer(*pools, mine, offset)
            write_token_layer(*pools, mine, offset, k[:, 0], v[:, 0])
        else:
            write_token_layer(*pools, mine, offset, k[:, 0], v[:, 0],
                              active=active)
        o, imp = paged_attend(q, pools, (hl[l], hv[l], el[l], ev[l]), slot,
                              offset, cfg, tp)
        if put_back:
            write_token_layer(*pools, mine, offset, *old, active=~active)
        h = h + model_sum(attn_out(own_heads(o, tp), lp), tp,
                          tp is not None and tp.heads_split)
        # decode routes the B lanes (every data rank's) as one group
        h = ffn(h, B if tp is None or tp.rows is None else B * tp.rows[1])
        imps.append(imp)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = unembed(params, cfg, h, tp)[:, 0]
    # the importance sums over KV heads (or slots, under the pages
    # rule): each model rank holds a share
    imp = model_sum(torch.stack(imps), tp, tp is not None and tp.imp_split)
    cache = _update_cache_after_step(cache, imp, write_slot)
    return logits, cache


# ---------------------------------------------------------------------------
# Chunked prefill (Sarathi-style) into the paged cache at an offset
# ---------------------------------------------------------------------------

def prefill_chunk_attn(hcur, lp, cfg: ModelConfig, pools, pos, page,
                       offset, valid, lanes, seen, tp=None,
                       hbm_pages: Optional[int] = None):
    """One layer's chunked-prefill attention block over the paged pools.

    hcur: [R, C, d] residual stream of the R prefilling lanes `lanes`;
    pools: (k_hbm_l, v_hbm_l, k_host_l, v_host_l) [B, P, ...], written
    in place; pos/page/offset/valid: [R, C]. Writes the slice's K/V at
    static-placement slots (slot == logical page), then attends
    causally against the lanes' pools flattened in slot order — which
    is logical token order while a lane is prefilling, because the
    migration planner only touches lanes that have started decoding.
    `seen` = (HBM slots, host slots) read from the front of each tier:
    those that can hold a prefix the slice sees (the causal mask gives
    the later ones weight zero). `tp`: a rank's `TensorParallel`.
    `hbm_pages`: the HBM tier's slots (default: the HBM pool's), which
    a rank's pools under the `pages` rule (`tp.pool`) hold a block of:
    it writes the tokens whose slot it holds, attends over its own seen
    slots at their keys' global positions (`prefix_chunk_partial`), and
    the ranks' partials merge exactly (`ref.merge_over`, plain PyTorch,
    in rank order).
    """
    R = pos.shape[0]
    T = pools[0].shape[2]
    shard = tp.pool if tp is not None else None
    Ph = pools[0].shape[1] if hbm_pages is None else hbm_pages
    x = rms_norm(hcur, lp["attn_norm"], cfg.norm_eps)
    q, k, v = attn_qkv(x, lp, cfg, pos)
    q = gather_heads(q, tp)
    mine = page if shard is None else shard.local_slots(page, Ph)
    write_tokens_layer(*pools, mine, offset, k, v, valid, lanes=lanes)
    n_h, n_e = seen
    if shard is not None:
        # the rank's seen slots of each tier, from the front of its block
        (lo_h, hi_h), (lo_e, hi_e) = shard.hbm, shard.host
        n_h = max(min(n_h, hi_h) - lo_h, 0)
        n_e = max(min(n_e, hi_e) - lo_e, 0)
    keys, vals = lane_pages(pools, lanes, (n_h, n_e))  # [R, n_h + n_e, ...]
    S = keys.shape[1] * T
    keys, vals = (repeat_kv(x.reshape(R, S, cfg.kv_heads, cfg.head_dim),
                            cfg.q_per_kv) for x in (keys, vals))
    if shard is None:
        o = prefix_chunk_attention(q, keys, vals, pos)
    else:
        dev = pos.device
        kpos = torch.cat([torch.arange(lo_h * T, (lo_h + n_h) * T,
                                       device=dev),
                          torch.arange((Ph + lo_e) * T,
                                       (Ph + lo_e + n_e) * T, device=dev)])
        o = ref.merge_over(
            [prefix_chunk_partial(q, keys, vals, pos, kpos)],
            tp.gather)[0].to(q.dtype)
    return hcur + model_sum(attn_out(own_heads(o, tp), lp), tp,
                            tp is not None and tp.heads_split)


def lane_pages(pools, lanes: torch.Tensor, seen):
    """(keys, vals), each [R, n_h + n_e, T, KH, HD] on the lanes' device:
    lane r's first n_h HBM slots, then its first n_e host slots, of the
    pools (k_hbm_l, v_hbm_l, k_host_l, v_host_l) — the tiers
    concatenated in slot order, as the reference does — gathered by one
    row copy (a host pool may lie in pinned host memory)."""
    kh, vh, ke, ve = pools
    n_h, n_e = seen
    R, n = lanes.shape[0], n_h + n_e
    row = kh.shape[2:]
    keys = torch.empty((R, n) + row, dtype=kh.dtype, device=lanes.device)
    vals = torch.empty_like(keys)
    if n:
        at = (lanes.to(torch.int32).repeat_interleave(n),
              torch.arange(n, dtype=torch.int32,
                           device=lanes.device).repeat(R))
        ops.copy_rows(
            (keys.view(R * n, *row), (None,), Split(kh, ke, 1, n_h), at),
            (vals.view(R * n, *row), (None,), Split(vh, ve, 1, n_h), at))
    return keys, vals


def chunk_coords(page_tokens: int, chunk: int, start: torch.Tensor,
                 n_valid: torch.Tensor):
    """Page coordinates for a `chunk`-token slice at lane offsets
    `start` [B] with `n_valid` [B] real tokens: (pos, page, offset,
    valid), all [B, C]."""
    ar = torch.arange(chunk, dtype=start.dtype, device=start.device)
    pos = start[:, None] + ar[None, :]
    valid = ar[None, :] < n_valid[:, None]
    page = (pos // page_tokens).to(torch.int32)
    offset = (pos % page_tokens).to(torch.int32)
    return pos, page, offset, valid


def decoder_prefill_chunk(params, cfg: ModelConfig, cache: PagedKVCache,
                          tokens: torch.Tensor, start: torch.Tensor,
                          n_valid: torch.Tensor, blocks,
                          end: Optional[int] = None, tp=None,
                          ) -> Tuple[torch.Tensor, PagedKVCache]:
    """Consume a [B, C] prompt slice directly into the paged cache.

    Token j of lane b sits at absolute position start[b] + j and is
    real while j < n_valid[b]. All B lanes run the forward at fixed
    shapes, as in the reference: a lane with n_valid 0 writes nothing,
    and its logits rows are discarded by every caller. So the host never
    reads `n_valid`, and a CUDA graph can hold the call. `end` (a host
    int, optional; None: the whole pools, as the reference reads them)
    limits the slots the attention reads to the first `end` of each
    lane's slot order — the caller knows it without reading the device.
    A row at position p sees the keys at slots p and before (the causal
    mask), so every row whose position is below `end` gets the values
    the whole pools give. The dense family needs that of the real rows
    alone (a bound on every lane's start + n_valid); the moe family,
    whose routing groups all B x C rows, idle lanes, decoding lanes and
    padding slots included, needs it of every row (a bound on every
    lane's start + C). `tp`: a rank's `TensorParallel`. Returns (logits
    [B, C, V], updated cache); the logits at slice index n_valid-1 are
    those of the last consumed prompt position.
    """
    B, C = tokens.shape
    T = cache.k_hbm.shape[3]
    Ph, Pe = cache.hbm_owner.shape[2], cache.host_owner.shape[2]
    pages = Ph + Pe if end is None else min(-(-end // T), Ph + Pe)
    seen = (min(pages, Ph), max(pages - Ph, 0))
    pos, page, offset, valid = chunk_coords(T, C, start, n_valid)
    lanes = torch.arange(B, device=tokens.device)
    h = embed_tokens(params, cfg, tokens, tp)
    for l, (lp, ffn) in enumerate(blocks):
        pools = (cache.k_hbm[l], cache.v_hbm[l], cache.k_host[l],
                 cache.v_host[l])
        h = prefill_chunk_attn(h, lp, cfg, pools, pos, page, offset, valid,
                               lanes, seen, tp, Ph)
        h = ffn(h)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = unembed(params, cfg, h, tp).to(cfg.dtype)
    cache = allocate_prompt_pages(cache, pos, valid, n_valid)
    return logits, cache


# ---------------------------------------------------------------------------
# Encoder-decoder (whisper)
# ---------------------------------------------------------------------------

def _ln(x, p, eps):
    return layer_norm(x, p["w"], p["b"], eps)


def _proj(x, w):
    """x [B,S,d] through w [d,H,HD] -> [B,S,H,HD]."""
    B, S, d = x.shape
    return (x @ w.reshape(d, -1)).view(B, S, w.shape[1], w.shape[2])


def _mlp(x, mp, tp=None):
    """The encdec MLP: GELU (tanh) between two biased projections. On a
    rank (`tp`) whose MLP is split (`mlp_split`): its hidden units,
    column- then row-parallel, and `b_out` added once after the sum."""
    split = tp is not None and tp.mlp_split
    y = gelu(model_enter(x, tp, split) @ mp["w_in"] + mp["b_in"]) \
        @ mp["w_out"]
    return model_sum(y, tp, split) + mp["b_out"]


def _encdec_attn(x_q, x_kv, lp, cfg: ModelConfig, *, causal: bool,
                 tp=None):
    """Attention with no RoPE and no norm inside (the caller's LN):
    whole-sequence `attention`, which runs the flash kernel on the card
    (K/V with KH heads, read un-repeated). On a rank (`tp`) whose axis
    splits the heads (`heads_split`; heads and KV heads alike, G = 1):
    its heads, `x_q` entering the split region (and self-attention's
    keys with it; a cross-attention's `x_kv` has entered already: the
    caller enters the encoder output once for every layer), the output
    projection's partial summed over `model`. Else every head, whole
    on every rank."""
    split = tp is not None and tp.heads_split
    xq = model_enter(x_q, tp, split)
    xkv = xq if x_kv is x_q else x_kv
    q, k, v = _proj(xq, lp["wq"]), _proj(xkv, lp["wk"]), \
        _proj(xkv, lp["wv"])
    return model_sum(attn_out(attention(q, k, v, causal=causal), lp), tp,
                     split)


def _root(params, tp, name):
    """The root leaf (or dict) `name` of `params`, whole on `data`."""
    return data_whole(params, tp, "", (name,))[name]


def encoder_forward(params, cfg: ModelConfig, frames: torch.Tensor,
                    remat: bool = False, tp=None):
    """frames: [B, F, d] precomputed frame embeddings (conv stub) ->
    encoder output [B, F, d]; `remat` checkpoints each layer. `tp`: a
    training rank's (heads and MLP split over `model` where the axis
    divides them, each layer's FSDP blocks gathered inside it)."""
    F = frames.shape[1]
    h = frames.to(cfg.dtype) + _root(params, tp, "enc_pos")[:F][None].to(
        cfg.dtype)

    def layer(h, lp):
        lp = data_whole(lp, tp, "enc_layers")
        x = _ln(h, lp["ln1"], cfg.norm_eps)
        h = h + _encdec_attn(x, x, lp["attn"], cfg, causal=False, tp=tp)
        x = _ln(h, lp["ln2"], cfg.norm_eps)
        return h + _mlp(x, lp["mlp"], tp)
    for lp in layers_of(params["enc_layers"]):
        h = remat_call(remat, layer, h, lp)
    return _ln(h, _root(params, tp, "enc_final"), cfg.norm_eps)


def encdec_cross_mlp(h, lp, enc, cfg: ModelConfig, tp=None):
    """A decoder layer after its self-attention: cross-attention over
    the static encoder output (its K/V recomputed from `enc`, as the
    reference does), then the MLP. `tp`: a rank's (the cross-attention's
    K/V from its heads of `enc`, which has entered the split region)."""
    x = _ln(h, lp["ln2"], cfg.norm_eps)
    h = h + _encdec_attn(x, enc, lp["cross_attn"], cfg, causal=False,
                         tp=tp)
    x = _ln(h, lp["ln3"], cfg.norm_eps)
    return h + _mlp(x, lp["mlp"], tp)


def encdec_forward(params, cfg: ModelConfig, tokens, enc_embeds, *,
                   return_hidden: bool = False, remat: bool = False,
                   tp=None):
    """Teacher-forced decode over the encoder output. tokens [B,S] ->
    (logits [B,S,V], the decoder's self-attention (k, v) stacked
    [L,B,S,KH,HD], encoder output [B,F,d]). With `return_hidden`: the
    decoder's final-norm hidden states [B,S,d] alone (`remat`
    checkpoints each encoder and decoder layer). `tp`: a training
    rank's (the module docstring): its heads, its MLP hidden units and
    its vocabulary rows where the axis divides them (each whole on
    every rank where it does not)."""
    enc = encoder_forward(params, cfg, enc_embeds, remat=remat, tp=tp)
    split = tp is not None and tp.heads_split
    # entered once: every layer's share of its gradient sums before the
    # one sum over `model` (and, at one rank, in the unmeshed order)
    enc_in = model_enter(enc, tp, split)
    S = tokens.shape[1]
    h = (embed_rows(params, tokens, tp)
         + _root(params, tp, "dec_pos")[:S][None]).to(cfg.dtype)

    def layer(h, lp, enc):
        lp = data_whole(lp, tp, "dec_layers")
        sa = lp["self_attn"]
        x = model_enter(_ln(h, lp["ln1"], cfg.norm_eps), tp, split)
        q, k, v = _proj(x, sa["wq"]), _proj(x, sa["wk"]), _proj(x, sa["wv"])
        h = h + model_sum(attn_out(attention(q, k, v, causal=True), sa), tp,
                          split)
        return encdec_cross_mlp(h, lp, enc, cfg, tp), (k, v)
    ks, vs = [], []
    for lp in layers_of(params["dec_layers"]):
        h, (k, v) = remat_call(remat, layer, h, lp, enc_in)
        if not return_hidden:
            ks.append(k)
            vs.append(v)
    h = _ln(h, _root(params, tp, "dec_final"), cfg.norm_eps)
    if return_hidden:
        return h
    return unembed(params, cfg, h, tp), (torch.stack(ks), torch.stack(vs)), \
        enc


def encdec_decode_step(params, cfg: ModelConfig, cache: PagedKVCache,
                       enc: torch.Tensor, token: torch.Tensor,
                       write_slot: torch.Tensor, logical_page_mask=None,
                       active=None, tp=None
                       ) -> Tuple[torch.Tensor, PagedKVCache]:
    """One decoder step: self-attention over the paged cache (the paged
    kernel on the card, one launch per tier per layer, G = H / KH), then
    dense cross-attention over the static encoder output `enc` and the
    MLP. Arguments as `decoder_decode_step`'s. `tp`: a serving rank's,
    over its rank-local `cfg` and shards: its heads where the axis
    splits them (the self-attention's output projection and the
    cross-attention's summed over `model`), else every head over its
    pools' slots (`pages`) or the whole pools (`none`); its MLP hidden
    units and vocabulary rows where the axis divides them; `enc` whole.
    Returns (logits [B, V], updated cache)."""
    T = cache.k_hbm.shape[3]
    pos = cache.length
    offset = pos % T
    split = tp is not None and tp.heads_split
    cache = allocate_token_page(cache, write_slot)
    logical_page_mask = mask_write_visible(cache, logical_page_mask)
    hl, hv, el, ev = cache.tier_lists(logical_page_mask=logical_page_mask)
    h = (embed_rows(params, token, tp)
         + params["dec_pos"][pos.long()]).to(cfg.dtype)[:, None]
    imps = []
    for l, lp in enumerate(layers_of(params["dec_layers"])):
        sa = lp["self_attn"]
        pools = (cache.k_hbm[l], cache.v_hbm[l], cache.k_host[l],
                 cache.v_host[l])
        x = _ln(h, lp["ln1"], cfg.norm_eps)
        q, k, v = _proj(x, sa["wq"]), _proj(x, sa["wk"]), _proj(x, sa["wv"])
        o, imp = decode_attend(q, k, v, pools, (hl[l], hv[l], el[l], ev[l]),
                               write_slot[l], offset, cfg, tp, active)
        h = h + model_sum(attn_out(o, sa), tp, split)
        h = encdec_cross_mlp(h, lp, enc, cfg, tp)
        imps.append(imp)
    h = _ln(h, params["dec_final"], cfg.norm_eps)
    logits = unembed(params, cfg, h, tp)[:, 0]
    imp = model_sum(torch.stack(imps), tp, tp is not None and tp.imp_split)
    cache = _update_cache_after_step(cache, imp, write_slot)
    return logits, cache
