"""zamba2-1.2b [arXiv:2411.15242] — hybrid: a Mamba2 backbone and one
shared attention block applied before every group of ``attn_every`` layers
(weights reused at each application).

38L d_model=2048 32H (MHA, kv=32) d_ff=8192 vocab=32000 ssm_state=64; the
shared attention uses a 4096-token sliding window.
"""
from repro_torch.configs.base import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    rope="1d",
    norm="rmsnorm",
    act="silu",
    ssm=SSMConfig(state_dim=64, conv_width=4, expand=2, chunk=256),
    hybrid=HybridConfig(attn_every=6),
    sliding_window=4096,      # for the shared attention block only
    fl_client_axis="data",
    fsdp=False,
    citation="arXiv:2411.15242",
)
