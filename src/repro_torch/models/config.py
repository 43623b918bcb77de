"""Architecture configuration (the port's copy, torch dtypes).

The fields the six families (dense, moe, vlm, encdec, and the
recurrent hybrid/ssm and xlstm) read are kept. `ModelConfig.rank_local`
gives the counts one rank of a mesh's `model` axis computes (what
else the rank needs, its vocabulary slice and the axis's collectives,
is `transformer.TensorParallel`, held by the rank's `Model`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    #: MoE every `interleave`-th layer (1 = every layer); the other
    #: layers use a dense FFN of size d_ff
    interleave: int = 1
    capacity_factor: float = 1.25
    #: llama4-style always-on shared expert (the size of one expert)
    shared_expert: bool = False
    #: pad the physical expert count up to this multiple; the padded
    #: experts are masked out of routing, the model is unchanged
    pad_experts_to: int = 0
    #: token-group size of the capacity dispatch ([G, S, E, C] grows
    #: with group^2 / E)
    group_size: int = 1024
    #: a rank-local config's share of the expert leaves
    #: (`ModelConfig.rank_local`): the padded experts it holds and their
    #: hidden width (None: all of them, at `d_ff`). Routing still runs
    #: over the whole model's `num_experts` and `num_experts_padded`.
    #: A rank's bookkeeping, not the architecture: a whole config prints
    #: as the reference's
    local_experts: Optional[int] = dataclasses.field(default=None,
                                                     repr=False)
    expert_d_ff: Optional[int] = dataclasses.field(default=None,
                                                   repr=False)

    @property
    def num_experts_padded(self) -> int:
        if self.pad_experts_to <= 0:
            return self.num_experts
        p = self.pad_experts_to
        return -(-self.num_experts // p) * p


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64          # N: per-channel state size (Mamba2)
    conv_width: int = 4
    expand: int = 2              # inner dim = expand * d_model
    chunk: int = 128             # chunked-scan block length
    #: hybrid (zamba2): a weight-shared attention block after every
    #: `attn_every`-th SSM block; 0 disables attention entirely
    attn_every: int = 0
    #: a rank-local config's `model` axis (`ModelConfig.rank_local`):
    #: a block computes its `num_heads` heads (the whole model's over
    #: `shards`) and their 1/shards of the inner width. A rank's
    #: bookkeeping, not the architecture
    shards: int = dataclasses.field(default=1, repr=False)


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    #: every `slstm_every`-th block is an sLSTM block, the rest mLSTM
    slstm_every: int = 4
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128
    #: a rank-local config's `model` axis, as `SSMConfig.shards` (the
    #: mLSTM's inner width and the sLSTM's d_model split with the heads)
    shards: int = dataclasses.field(default=1, repr=False)


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    enc_layers: int
    #: encoder input length (frames after the stubbed conv frontend)
    enc_positions: int = 1500
    #: learned decoder position table size (>= longest decode shape)
    dec_positions: int = 40960


@dataclasses.dataclass(frozen=True)
class FrontendStub:
    """Modality frontend stub: the caller provides precomputed frame or
    patch embeddings of shape [batch, num_embeddings, d_model]."""
    kind: str                    # "audio" | "vision"
    num_embeddings: int          # frames or patches


def splits(n: int, size: int) -> bool:
    """Whether a dim of `n` splits over an axis of `size` (the sharding
    rules' test: divisible, and at least one element a rank)."""
    return n % size == 0 and n >= size


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | vlm | encdec | ssm | xlstm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qk_norm: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.bfloat16
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    encdec: Optional[EncDecConfig] = None
    frontend: Optional[FrontendStub] = None
    #: KV page size in tokens for the two-tier paged cache
    kv_page_tokens: int = 16
    #: the tokenizer's end-of-sequence id (None = budget-only stops)
    eos_id: Optional[int] = None

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)
        if self.num_heads % max(self.kv_heads, 1):
            raise ValueError(
                f"num_heads {self.num_heads} is not a multiple of "
                f"kv_heads {self.kv_heads}")
        if self.eos_id is not None and not 0 <= self.eos_id < self.vocab:
            raise ValueError(
                f"eos_id {self.eos_id} outside vocab {self.vocab}")

    def rank_local(self, size: int) -> "ModelConfig":
        """The config one rank of a `model` axis of `size` runs: local
        counts of heads, KV heads and, when the axis divides it, MLP
        hidden units (else the MLP is held whole), so the transformer
        code reads them as it reads a whole model's. `head_dim`,
        `d_model` and `vocab` are unchanged. A moe model's expert leaves
        follow the sharding rules' priority (`experts` before `mlp`):
        the padded experts split when the axis divides them, each
        expert's hidden width whole; else every expert at the split (or
        whole) `d_ff` of the dense and shared MLPs. The recurrent
        families' heads are the same `num_heads` (their KV heads): where
        the axis divides them a Mamba2, mLSTM or sLSTM block computes the
        local heads over 1/size of its inner width (`SSMConfig.shards`,
        `XLSTMConfig.shards` = size); otherwise the block runs whole on
        every rank (`shards` 1).

        An axis that does not divide the KV heads (the `pages` and
        `none` KV pool rules) keeps both head counts whole: the rank
        holds every KV head. A serving rank's decode and chunked-prefill
        attention run over every query head (q gathered over `model`
        where the axis splits the query heads), which is the geometry
        the config describes; its `start` and a training rank's
        attention run its own query heads over the KV heads they read
        (`transformer.rank_kv`), or every head where the axis does not
        divide them. Which query heads the rank's `wq`/`wo` shards hold
        is its `TensorParallel.heads`: a config of fewer query heads
        than KV heads (1 over 2 at size 4 on 4 over 2) is not a GQA
        config."""
        kv_split = splits(self.kv_heads, size)
        heads = self.num_heads // size if kv_split else self.num_heads
        d_ff = self.d_ff // size if splits(self.d_ff, size) else self.d_ff
        moe = self.moe
        if moe is not None:
            E = moe.num_experts_padded
            moe = dataclasses.replace(
                moe, local_experts=E // size if splits(E, size) else E,
                expert_d_ff=self.d_ff if splits(E, size) else d_ff)
        more = {k: dataclasses.replace(getattr(self, k),
                                       shards=size if kv_split else 1)
                for k in ("ssm", "xlstm") if getattr(self, k) is not None}
        return dataclasses.replace(
            self, num_heads=heads,
            kv_heads=self.kv_heads // size if kv_split else self.kv_heads,
            d_ff=d_ff, moe=moe, **more)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.kv_heads

    def attention_layer_ids(self) -> Tuple[int, ...]:
        """Layers that own a KV cache: none of an ssm or xlstm model,
        the shared-attention sites of a hybrid one (after every
        `attn_every`-th block), every (decoder) layer otherwise."""
        if self.family in ("ssm", "xlstm"):
            return ()
        if self.family == "hybrid":
            if self.ssm is None or self.ssm.attn_every <= 0:
                raise ValueError("a hybrid model needs ssm.attn_every > 0")
            return tuple(range(self.ssm.attn_every - 1, self.num_layers,
                               self.ssm.attn_every))
        return tuple(range(self.num_layers))

    def param_count(self) -> int:
        """Approximate parameter count (the reference's formula, used
        for the 6ND roofline maths)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab, self.num_layers
        h, kh, hd = self.num_heads, self.kv_heads, self.head_dim
        attn = d * h * hd + 2 * d * kh * hd + h * hd * d
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family in ("ssm", "xlstm"):
            inner = (self.ssm.expand if self.ssm else
                     self.xlstm.expand) * d
            blk = 2 * d * inner + inner * d + inner * 8  # rough
            return L * blk + emb
        mlp = 3 * d * f
        if self.moe:
            moe_layers = len(range(self.moe.interleave - 1, L,
                                   self.moe.interleave))
            dense_layers = L - moe_layers
            moe_mlp = moe_layers * (self.moe.num_experts * 3 * d * f
                                    + d * self.moe.num_experts
                                    + (3 * d * f if self.moe.shared_expert
                                       else 0))
            body = L * attn + dense_layers * mlp + moe_mlp
        elif self.family == "hybrid":
            inner = self.ssm.expand * d
            ssm_blk = 2 * d * inner + inner * d
            # the shared attention block and its MLP count once
            body = L * ssm_blk + attn + mlp
        else:
            body = L * (attn + mlp)
        if self.encdec:
            body += self.encdec.enc_layers * (attn + mlp) + L * attn  # cross
        return body + emb

    def active_param_count(self) -> int:
        """Active params per token (moe: only the routed experts)."""
        if not self.moe:
            return self.param_count()
        d, f, L = self.d_model, self.d_ff, self.num_layers
        full = self.param_count()
        moe_layers = len(range(self.moe.interleave - 1, L,
                               self.moe.interleave))
        all_experts = moe_layers * self.moe.num_experts * 3 * d * f
        active_experts = moe_layers * self.moe.top_k * 3 * d * f
        return full - all_experts + active_experts
