"""granite-moe-3b-a800m — MoE, 40 experts top-8
[hf:ibm-granite/granite-3.0-3b-a800m-base; hf]."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, kv_heads=8,
    d_ff=512, vocab=49155, head_dim=64, rope_theta=1e6,
    moe=MoEConfig(num_experts=40, top_k=8, interleave=1,
                  capacity_factor=1.25, pad_experts_to=48,
                  group_size=512),
)


def smoke_config():
    return ModelConfig(
        name="granite-moe-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, kv_heads=2,
        d_ff=32, vocab=256, head_dim=16,
        moe=MoEConfig(num_experts=4, top_k=2, interleave=1,
                      capacity_factor=1.25))
