"""Flash-decode on the card: the wrapper of ``csrc/decode_attention.cu``.

Replaces the TPU kernel ``repro/kernels/decode_attention.py::_decode_kernel``
(its ``pallas_call`` in ``decode_attention``).  On an H100 the kernel is
bound by bytes: it must read each sequence's valid K/V prefix once, and
does 4 flops per K/V value pair.  Its design (one block per (kv head,
sequence), a two-stage ``cp.async`` ring of cache tiles, a walk that stops
at ``lengths[b]`` read on the device) is described in the source.  Unlike
the Pallas kernel it takes any cache length S: there is no block_k to
divide it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

launches = 0    # kernel launches since the caller last reset it

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_shapes(q, k, v, lengths=None) -> None:
    """The reference's shape errors (``ValueError``), for either path."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(
            f"decode_attention: expected q [B,1,H,hd] and k/v [B,S,KV,hd], "
            f"got q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, one, h, hd = q.shape
    if one != 1:
        raise ValueError(
            f"decode_attention: q must carry a single decode step, got "
            f"q {tuple(q.shape)} (expected [B, 1, H, hd])")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(
            f"decode_attention: cache k {tuple(k.shape)} / v {tuple(v.shape)} "
            f"must both be [B={b}, S, KV, hd={hd}]")
    kvh = k.shape[2]
    if kvh == 0 or h % kvh != 0:
        raise ValueError(
            f"decode_attention: query heads H={h} must be a multiple of "
            f"kv heads KV={kvh} (q {tuple(q.shape)}, k {tuple(k.shape)})")
    if lengths is not None and tuple(lengths.shape) != (b,):
        raise ValueError(
            f"decode_attention: lengths must be [B]={b} valid-slot counts, "
            f"got {tuple(lengths.shape)}")


def decode_attention(q, k, v, lengths=None):
    """Launch the CUDA kernel: q [B,1,H,hd], k/v [B,S,KV,hd] on one CUDA
    device, float32 or bfloat16, contiguous; ``lengths`` int32 [B] or None.
    Returns a new [B,1,H,hd] tensor of q's type."""
    global launches
    check_shapes(q, k, v, lengths)
    tensors = [q, k, v] + ([] if lengths is None else [lengths])
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError(
            f"decode_attention kernel: every tensor must lie on one CUDA "
            f"device, got {[str(t.device) for t in tensors]}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"decode_attention kernel: q/k/v must share float32 or bfloat16, "
            f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if lengths is not None and lengths.dtype != torch.int32:
        raise ValueError(
            f"decode_attention kernel: lengths must be int32, got "
            f"{lengths.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode_attention kernel: inputs must be contiguous")
    b, _, h, hd = q.shape
    s_len, kvh = k.shape[1], k.shape[2]
    if hd % 8:
        raise ValueError(
            f"decode_attention kernel: head_dim must be a multiple of 8 "
            f"(16-byte cache copies), got {hd}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(
            "decode_attention kernel: q/k/v must be 16-byte aligned")
    out = torch.empty_like(q)
    fn = _build.launcher("decode_attention")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             None if lengths is None else lengths.data_ptr(), out.data_ptr(),
             b, s_len, h, kvh, hd, _DTYPES[q.dtype], 1.0 / math.sqrt(hd),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attention")
    launches += 1
    return out
