"""Architecture configuration dataclasses (the port's own copy).

A field-for-field copy of the reference's ``configs/base.py`` (with the
four input shapes, :data:`INPUT_SHAPES`) so that a
``meta.json`` written by either package rebuilds the same config.  Configs
are pure data; models are assembled from them by ``repro_torch.models``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_d_ff: int
    dense_d_ff: int = 0          # arctic-style dense residual branch (0 = none)
    shared_expert: bool = False  # llama4-style always-on shared expert
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64          # N (per-head state size)
    conv_width: int = 4
    expand: int = 2              # d_inner = expand * d_model
    num_ssm_heads: int = 0       # 0 -> d_inner // 64
    chunk: int = 256             # chunked-scan block length


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 4         # every k-th block is sLSTM, rest mLSTM
    proj_factor: float = 2.0


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style audio encoder over precomputed frame embeddings."""
    num_layers: int = 12
    frames: int = 1500


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """zamba2-style: Mamba2 backbone + one shared attention block applied
    every ``attn_every`` layers."""
    attn_every: int = 6


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    """qwen2-vl: interleaved text+patch embeddings with 3-axis M-RoPE ids."""
    num_vision_tokens: int = 1024


# Nested sub-config classes by ModelConfig field name (checkpoint metadata
# round-trips them through plain dicts).
_SUB_CONFIGS = {"moe": MoEConfig, "ssm": SSMConfig, "xlstm": XLSTMConfig,
                "encoder": EncoderConfig, "hybrid": HybridConfig,
                "vlm": VLMConfig}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    rope: str = "1d"              # 1d | 2d | mrope | none
    norm: str = "rmsnorm"         # rmsnorm | layernorm | nonparam
    act: str = "silu"             # silu (SwiGLU) | gelu (plain MLP)
    head_dim: int = 0             # 0 -> d_model // num_heads
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    encoder: Optional[EncoderConfig] = None
    hybrid: Optional[HybridConfig] = None
    vlm: Optional[VLMConfig] = None
    # Ring-buffer KV window for long-context decode; None = full attention.
    sliding_window: Optional[int] = None
    # --- distribution (recorded for checkpoint compatibility) -------------
    fl_client_axis: str = "data"
    fsdp: bool = False
    # Pad the attention-head count up to a multiple of this (0 = off).
    pad_heads_to: int = 0
    remat: str = "block"
    param_dtype: str = "bfloat16"
    citation: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def padded_num_heads(self) -> int:
        """Head count after padding to ``pad_heads_to`` (== num_heads when
        off)."""
        p = self.pad_heads_to
        if not p or self.num_heads % p == 0:
            return self.num_heads
        return (self.num_heads + p - 1) // p * p

    @property
    def padded_num_kv_heads(self) -> int:
        """KV heads must divide the padded head count; MHA archs pad KV
        alongside Q."""
        h = self.padded_num_heads
        kv = self.num_kv_heads
        return kv if h % kv == 0 else h

    # -- (de)serialization: the checkpoint metadata format -----------------
    def to_dict(self) -> dict:
        """JSON-safe dict (nested sub-configs included), the inverse of
        :meth:`from_dict`."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfig":
        """Rebuild a config from :meth:`to_dict` output (e.g. a checkpoint's
        ``meta.json``).  Unknown keys fail loudly rather than being dropped."""
        d = dict(d)
        for key, sub_cls in _SUB_CONFIGS.items():
            if d.get(key) is not None:
                d[key] = sub_cls(**d[key])
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"ModelConfig.from_dict: unknown field(s) {sorted(unknown)} "
                f"— checkpoint written by an incompatible version?")
        return cls(**d)

    def reduced(self, **overrides) -> "ModelConfig":
        """The smoke-test variant: 2 layers, d_model<=256, <=4 experts."""
        small = dict(
            num_layers=2,
            d_model=min(self.d_model, 256),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 2),
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            head_dim=64,
            param_dtype="float32",
            fsdp=False,
            remat="none",
        )
        if self.num_kv_heads == self.num_heads:     # MHA archs stay MHA
            small["num_kv_heads"] = small["num_heads"]
        if self.moe:
            small["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=min(self.moe.top_k, 2),
                expert_d_ff=128, dense_d_ff=128 if self.moe.dense_d_ff else 0)
        if self.ssm:
            small["ssm"] = dataclasses.replace(self.ssm, state_dim=16, chunk=32)
        if self.encoder:
            small["encoder"] = dataclasses.replace(self.encoder, num_layers=2, frames=64)
        if self.sliding_window:
            small["sliding_window"] = 64
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # 'train' | 'prefill' | 'decode'


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
