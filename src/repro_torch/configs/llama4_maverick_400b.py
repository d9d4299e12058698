"""llama4-maverick-400b-a17b [hf:meta-llama/Llama-4-Scout-17B-16E] — MoE,
top-1 routing with a shared expert (the text path).

48L d_model=5120 40H (GQA kv=8) padded to 48 heads, d_ff=8192, MoE 128
experts top-1, vocab=202048.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    rope="1d",
    norm="rmsnorm",
    act="silu",
    moe=MoEConfig(num_experts=128, top_k=1, expert_d_ff=8192, shared_expert=True),
    sliding_window=8192,
    pad_heads_to=16,
    fl_client_axis="pod",
    fsdp=True,
    citation="hf:meta-llama/Llama-4-Scout-17B-16E",
)
