"""qwen3-32b — dense GQA with qk RMSNorm [hf:Qwen/Qwen3-8B; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=64, kv_heads=8,
    d_ff=25600, vocab=151936, head_dim=128, qk_norm=True,
    rope_theta=1e6,
    eos_id=151645,                     # <|im_end|>
)


def smoke_config():
    return ModelConfig(
        name="qwen3-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, kv_heads=2,
        d_ff=128, vocab=256, head_dim=16, qk_norm=True,
        eos_id=2)                      # reduced-vocab stand-in
