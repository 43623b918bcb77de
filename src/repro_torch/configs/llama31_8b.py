"""llama-3.1-8b — the paper's own evaluation model (Section IV-A)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama31-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, kv_heads=8,
    d_ff=14336, vocab=128256, head_dim=128, rope_theta=5e5,
    eos_id=128001,                     # <|end_of_text|>
)


def smoke_config():
    return ModelConfig(
        name="llama31-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, kv_heads=2,
        d_ff=96, vocab=256, head_dim=16,
        eos_id=2)                      # reduced-vocab stand-in
