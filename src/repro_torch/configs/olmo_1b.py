"""olmo-1b [arXiv:2402.00838] — dense with NON-PARAMETRIC LayerNorm.

16L d_model=2048 16H (MHA, kv=16) d_ff=8192 vocab=50304.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    rope="1d",
    norm="nonparam",          # OLMo: LayerNorm without scale/bias params
    act="silu",
    sliding_window=8192,
    tie_embeddings=True,
    fl_client_axis="data",
    fsdp=False,
    citation="arXiv:2402.00838",
)
