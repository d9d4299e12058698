"""arctic-480b [hf:Snowflake/snowflake-arctic-base] — dense-MoE hybrid.

35L d_model=7168 56H (GQA kv=8) padded to 64 heads, MoE 128 experts top-2
with expert d_ff=4864 PLUS an always-on dense residual FFN branch,
vocab=32000.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    rope="1d",
    norm="rmsnorm",
    act="silu",
    moe=MoEConfig(num_experts=128, top_k=2, expert_d_ff=4864, dense_d_ff=4864),
    sliding_window=8192,
    pad_heads_to=16,
    fl_client_axis="pod",
    fsdp=True,
    citation="hf:Snowflake/snowflake-arctic-base",
)
