"""xlstm-125m — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

No KV cache: recurrent state only (sub-quadratic). The paper's
placement technique does not apply to it.
"""
from repro_torch.models.config import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="xlstm",
    num_layers=12, d_model=768, num_heads=4, kv_heads=4,
    d_ff=0, vocab=50304, head_dim=192,
    xlstm=XLSTMConfig(slstm_every=4, expand=2, conv_width=4, chunk=128),
)


def smoke_config():
    return ModelConfig(
        name="xlstm-smoke", family="xlstm",
        num_layers=2, d_model=64, num_heads=4, kv_heads=4,
        d_ff=0, vocab=256, head_dim=16,
        xlstm=XLSTMConfig(slstm_every=2, expand=2, conv_width=4, chunk=8))
