"""whisper-tiny — enc-dec, conv frontend STUBBED (input_specs provides
precomputed frame embeddings) [arXiv:2212.04356; unverified]."""
from repro_torch.models.config import EncDecConfig, FrontendStub, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="encdec",
    num_layers=4, d_model=384, num_heads=6, kv_heads=6,
    d_ff=1536, vocab=51865, head_dim=64, tie_embeddings=True,
    encdec=EncDecConfig(enc_layers=4, enc_positions=1500),
    frontend=FrontendStub(kind="audio", num_embeddings=1500),
)


def smoke_config():
    return ModelConfig(
        name="whisper-smoke", family="encdec",
        num_layers=2, d_model=64, num_heads=4, kv_heads=4,
        d_ff=128, vocab=256, head_dim=16, tie_embeddings=True,
        encdec=EncDecConfig(enc_layers=2, enc_positions=64),
        frontend=FrontendStub(kind="audio", num_embeddings=64))
