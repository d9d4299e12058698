"""xlstm-125m [arXiv:2405.04517] — sLSTM + mLSTM blocks (attention-free).

12L d_model=768 4H (kv=4) d_ff=0 (xLSTM blocks carry their own projection
factor instead of an FFN) vocab=50304.  Every ``slstm_every``-th block is
sLSTM, the rest mLSTM; the recurrent state is O(1) in sequence length.
"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    rope="none",
    norm="layernorm",
    act="gelu",
    xlstm=XLSTMConfig(slstm_every=4, proj_factor=2.0),
    fl_client_axis="data",
    fsdp=False,
    citation="arXiv:2405.04517",
)
