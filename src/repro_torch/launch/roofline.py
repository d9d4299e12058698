"""Roofline terms and analytic model sizes: the port's counterpart of the
reference's ``launch/hlo_analysis.py`` (its ``roofline_terms``,
``model_flops``, ``param_count`` and ``active_param_count``, ported line for
line), with the H100's rates in place of the TPU's:

  compute    = FLOPs / (chips * PEAK_FLOPS[dtype])
  memory     = bytes / (chips * HBM_BW)
  collective = wire bytes / (chips * LINK_BW)

Rates of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 989e12 FLOP/s bf16 on the tensor cores, 67e12 FLOP/s f32 outside
them, 3.35e12 B/s of HBM, and NVLink 4's 900 GB/s counted as 450e9 B/s per
direction.  The FLOPs and bytes come from ``launch.cost.CostCounter``.
"""
from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12             # bytes/s per card
LINK_BW = 450e9              # NVLink bytes/s per direction per card


def roofline_terms(*, flops: float, bytes_accessed: float, wire_bytes: float,
                   chips: int, dtype: str = "bfloat16") -> dict:
    compute = flops / (chips * PEAK_FLOPS[dtype])
    memory = bytes_accessed / (chips * HBM_BW)
    collective = wire_bytes / (chips * LINK_BW)
    dom = max(("compute", compute), ("memory", memory),
              ("collective", collective), key=lambda kv: kv[1])[0]
    return {
        "compute_s": compute,
        "memory_s": memory,
        "collective_s": collective,
        "bottleneck": dom,
    }


def model_flops(cfg, shape, *, training: bool) -> float:
    """MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE) for training;
    2 N D for inference (D = processed tokens)."""
    n = active_param_count(cfg)
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        return 6.0 * n * d
    if shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        return 2.0 * n * d
    d = shape.global_batch * 1          # one decoded token per sequence
    return 2.0 * n * d


def param_count(cfg) -> float:
    """Total parameters (analytic, as the reference counts them)."""
    d, l, v = cfg.d_model, cfg.num_layers, cfg.vocab_size
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    attn = d * hd * (h + 2 * kv) + h * hd * d
    if cfg.family == "hybrid":
        m = cfg.ssm
        d_in = m.expand * d
        nh = m.num_ssm_heads or max(1, d_in // 64)
        mixer = d * (2 * d_in + 2 * m.state_dim + nh) + d_in * d
        ffn = 3 * d * cfg.d_ff
        shared_attn = attn
        return l * (mixer + ffn) + shared_attn + 2 * v * d
    if cfg.family == "ssm":
        f = int(cfg.xlstm.proj_factor * d)
        per = d * 2 * f + 3 * f * (f // cfg.num_heads) * cfg.num_heads + f * d
        return l * per + 2 * v * d
    if cfg.moe:
        m = cfg.moe
        ffn = m.num_experts * 3 * d * m.expert_d_ff + d * m.num_experts
        if m.dense_d_ff:
            ffn += 3 * d * m.dense_d_ff
        if m.shared_expert:
            ffn += 3 * d * m.expert_d_ff
    else:
        ffn = (3 if cfg.act == "silu" else 2) * d * cfg.d_ff
    n = l * (attn + ffn) + 2 * v * d
    if cfg.family == "encdec":
        n += cfg.encoder.num_layers * (attn + (2 * d * cfg.d_ff)) + l * attn
    return n


def active_param_count(cfg) -> float:
    """Parameters touched per token (MoE: top_k of num_experts)."""
    n = param_count(cfg)
    if cfg.moe:
        m = cfg.moe
        every = m.num_experts * 3 * cfg.d_model * m.expert_d_ff * cfg.num_layers
        act = m.top_k * 3 * cfg.d_model * m.expert_d_ff * cfg.num_layers
        n = n - every + act
    return n
