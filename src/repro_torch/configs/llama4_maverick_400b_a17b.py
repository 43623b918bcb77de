"""llama4-maverick-400b-a17b — MoE, 128 experts top-1, interleaved
dense/MoE layers, shared expert [hf:meta-llama/Llama-4-Scout-17B-16E;
unverified].

The backbone is the text transformer; interleave 2 (every other layer
MoE) gives the ~400B total / ~17B active split with 48 layers x 128
experts. The full config does not fit one card; its smoke config is the
port's interleave-2 + shared-expert case.
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, kv_heads=8,
    d_ff=8192, vocab=202048, head_dim=128, rope_theta=5e5,
    moe=MoEConfig(num_experts=128, top_k=1, interleave=2,
                  capacity_factor=1.25, shared_expert=True),
)


def smoke_config():
    return ModelConfig(
        name="llama4-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, kv_heads=2,
        d_ff=64, vocab=256, head_dim=16,
        moe=MoEConfig(num_experts=4, top_k=1, interleave=2,
                      capacity_factor=1.25, shared_expert=True))
