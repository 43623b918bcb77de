"""internvl2-2b — VLM: InternViT frontend STUBBED (patch embeddings via
input_specs), InternLM2-2b backbone [arXiv:2404.16821; hf]."""
from repro_torch.models.config import FrontendStub, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    num_layers=24, d_model=2048, num_heads=16, kv_heads=8,
    d_ff=8192, vocab=92553, head_dim=128, rope_theta=1e6,
    frontend=FrontendStub(kind="vision", num_embeddings=256),
)


def smoke_config():
    return ModelConfig(
        name="internvl2-smoke", family="vlm",
        num_layers=2, d_model=64, num_heads=4, kv_heads=2,
        d_ff=128, vocab=256, head_dim=16,
        frontend=FrontendStub(kind="vision", num_embeddings=16))
