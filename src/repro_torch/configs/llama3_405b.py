"""llama3-405b [arXiv:2407.21783] — dense GQA flagship.

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.
Cross-silo FL, FSDP x TP.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    rope="1d",
    norm="rmsnorm",
    act="silu",
    sliding_window=8192,
    fl_client_axis="pod",
    fsdp=True,
    citation="arXiv:2407.21783",
)
