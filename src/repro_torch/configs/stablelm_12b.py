"""stablelm-12b — dense GQA [hf:stabilityai/stablelm-2-1_6b; hf].

Note: stablelm-2-12b uses parallel attention/FFN residuals
in some variants; we implement the standard sequential pre-norm block
with the assigned dimensions — shape- and FLOP-identical.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b", family="dense",
    num_layers=40, d_model=5120, num_heads=32, kv_heads=8,
    d_ff=13824, vocab=100352, head_dim=160, rope_theta=1e6,
)


def smoke_config():
    return ModelConfig(
        name="stablelm-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, kv_heads=2,
        d_ff=96, vocab=256, head_dim=16)
