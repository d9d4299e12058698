"""chatglm3-6b [arXiv:2406.12793] — dense, 2d-RoPE, aggressive GQA (kv=2).

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    rope="2d",                # GLM-style two-stream rotary
    norm="rmsnorm",
    act="silu",
    sliding_window=8192,
    fl_client_axis="data",
    fsdp=False,
    citation="arXiv:2406.12793",
)
