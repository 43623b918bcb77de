"""zamba2-1.2b — hybrid Mamba2 backbone + ONE weight-shared attention
block applied periodically [arXiv:2411.15242; hf]. ssm_state=64.

attn_every=19 -> shared-attn sites at blocks 18 and 37 (two
applications, as in Zamba2-1.2B). Only those sites own KV caches —
the most placement-friendly of the repo's architectures.
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, kv_heads=32,
    d_ff=8192, vocab=32000, head_dim=64,
    ssm=SSMConfig(state_dim=64, conv_width=4, expand=2, chunk=128,
                  attn_every=19),
)


def smoke_config():
    return ModelConfig(
        name="zamba2-smoke", family="hybrid",
        num_layers=4, d_model=64, num_heads=4, kv_heads=4,
        d_ff=128, vocab=256, head_dim=16,
        ssm=SSMConfig(state_dim=16, conv_width=4, expand=2, chunk=8,
                      attn_every=2))
