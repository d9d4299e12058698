"""whisper-small [arXiv:2212.04356] — encoder-decoder audio transformer.

12L (encoder + decoder) d_model=768 12H (kv=12, i.e. MHA) d_ff=3072
vocab=51865.  The mel-spectrogram and conv feature extractor are not
modelled: a batch carries precomputed frame embeddings ``enc_embeds``
[B, 1500, 768].  The decoder's self-attention may run over a sliding
window; its cross-attention always reads the fixed 1500-frame encoder
output.
"""
from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    rope="none",              # whisper uses learned/sinusoidal abs positions
    norm="layernorm",
    act="gelu",
    encoder=EncoderConfig(num_layers=12, frames=1500),
    sliding_window=8192,      # decoder self-attention window
    pad_heads_to=16,
    fl_client_axis="data",
    fsdp=False,
    citation="arXiv:2212.04356",
)
