"""internlm2-1.8b — dense GQA [arXiv:2403.17297; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b", family="dense",
    num_layers=24, d_model=2048, num_heads=16, kv_heads=8,
    d_ff=8192, vocab=92544, head_dim=128, rope_theta=1e6,
    eos_id=2,                          # </s> (internlm2 tokenizer)
)


def smoke_config():
    return ModelConfig(
        name="internlm2-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, kv_heads=2,
        d_ff=128, vocab=256, head_dim=16,
        eos_id=2)                      # reduced-vocab stand-in, same id
