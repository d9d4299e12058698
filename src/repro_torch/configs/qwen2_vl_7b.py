"""qwen2-vl-7b [arXiv:2409.12191] — VLM backbone with M-RoPE.

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
The vision encoder (ViT) and projector are not modelled: a batch carries
the interleaved text and patch embeddings (``embeds``) and the 3-axis
(temporal, height, width) M-RoPE position ids (``positions``).
"""
from repro_torch.configs.base import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    rope="mrope",
    norm="rmsnorm",
    act="silu",
    vlm=VLMConfig(num_vision_tokens=1024),
    sliding_window=8192,
    pad_heads_to=16,
    fl_client_axis="data",
    fsdp=False,
    citation="arXiv:2409.12191",
)
