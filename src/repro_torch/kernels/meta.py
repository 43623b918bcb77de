"""The hand-written kernels as opaque operators for tensors on the meta
device (PyTorch's shape-only device), which the one-card dry run
(`launch.dryrun`) runs the model on.

`ops.tier_attention`, `ops.flash_attention` (and its gradient),
`ops.copy_rows`, `ops.grad_sumsq` and `ops.adamw_apply` route a meta
tensor here: each call is ONE operator in
the `repro_torch` namespace at the shapes the kernel would be launched
with, so `launch.op_cost` sees one op per launch and prices it by the
kernel's own formula instead of counting the plain version's ops. Each
operator has a fake implementation (`torch.library.register_fake`: the
output shapes, no data) and no other: called on real tensors it raises.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

Tensor = torch.Tensor


def _meta_only(name: str):
    raise RuntimeError(f"repro_torch::{name} exists for meta tensors only; "
                       f"real tensors launch the kernel or its plain version")


@torch.library.custom_op("repro_torch::paged_attention", mutates_args=())
def paged_attention(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                    page_list: Tensor, page_valid: Tensor
                    ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(out [B, KH, G, HD], m, l [B, KH, G], page_lse [B, KH, G, N])."""
    _meta_only("paged_attention")


@paged_attention.register_fake
def _(q, k_pool, v_pool, page_list, page_valid):
    B, KH, G, _ = q.shape
    f32 = dict(dtype=torch.float32)
    return (q.new_empty(q.shape), q.new_empty((B, KH, G), **f32),
            q.new_empty((B, KH, G), **f32),
            q.new_empty((B, KH, G, page_list.shape[1]), **f32))


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention(q: Tensor, k: Tensor, v: Tensor, causal: bool) -> Tensor:
    """q [B, Sq, H, D], k/v [B, Sk, KH, D] -> out [B, Sq, H, D]."""
    _meta_only("flash_attention")


@flash_attention.register_fake
def _(q, k, v, causal):
    return q.new_empty(q.shape)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def flash_attention_bwd(q: Tensor, k: Tensor, v: Tensor, out: Tensor,
                        dout: Tensor, causal: bool
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """(dq, dk, dv), shaped as (q, k, v)."""
    _meta_only("flash_attention_bwd")


@flash_attention_bwd.register_fake
def _(q, k, v, out, dout, causal):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _flash_context(ctx, inputs, output):
    q, k, v, causal = inputs
    ctx.save_for_backward(q, k, v, output)
    ctx.causal = causal


def _flash_backward(ctx, dout):
    q, k, v, out = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, ctx.causal)
    return dq, dk, dv, None


flash_attention.register_autograd(_flash_backward,
                                  setup_context=_flash_context)


@torch.library.custom_op("repro_torch::page_copy", mutates_args=())
def page_copy(index: Tensor, pairs: int, row_bytes: int) -> None:
    """`pairs` pairs of `index.shape[0]` row copies of `row_bytes` each
    (the pools are not passed: a meta tensor holds no data to move)."""
    _meta_only("page_copy")


@page_copy.register_fake
def _(index, pairs, row_bytes):
    return None


@torch.library.custom_op("repro_torch::grad_sumsq", mutates_args=())
def grad_sumsq(grads: List[Tensor]) -> Tensor:
    """Each gradient's sum of squares, f32 [len(grads)]."""
    _meta_only("grad_sumsq")


@grad_sumsq.register_fake
def _(grads):
    return grads[0].new_empty((len(grads),), dtype=torch.float32)


@torch.library.custom_op("repro_torch::adamw_apply",
                         mutates_args=("params_out", "m_out", "v_out"))
def adamw_apply(grads: List[Tensor], params: List[Tensor], m: List[Tensor],
                v: List[Tensor], params_out: List[Tensor],
                m_out: List[Tensor], v_out: List[Tensor]) -> None:
    """The AdamW step of every leaf into the `*_out` tensors (the inputs
    themselves for a donated state). The scalars are left out: a meta
    tensor holds no values."""
    _meta_only("adamw_apply")


@adamw_apply.register_fake
def _(grads, params, m, v, params_out, m_out, v_out):
    return None
