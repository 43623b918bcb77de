"""granite-8b — llama-arch dense GQA, code model [arXiv:2405.04324; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b", family="dense",
    num_layers=36, d_model=4096, num_heads=32, kv_heads=8,
    d_ff=14336, vocab=49152, head_dim=128, rope_theta=1e6,
)


def smoke_config():
    return ModelConfig(
        name="granite-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, kv_heads=2,
        d_ff=96, vocab=256, head_dim=16)
