"""deepseek-67b [arXiv:2401.02954] — dense llama-architecture.

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.
Cross-silo FL (clients on the pod axis), FSDP x TP sharding.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    rope="1d",
    norm="rmsnorm",
    act="silu",
    sliding_window=8192,      # ring-buffer window of long-context decode
    fl_client_axis="pod",
    fsdp=True,
    citation="arXiv:2401.02954",
)
