"""Kernel dispatch by tensor device.

A CPU tensor goes to the plain PyTorch version in :mod:`ref`; a CUDA tensor
launches the hand-written kernel or raises.  There is no fallback between
the two and no switch: the device of the data decides.
"""
from __future__ import annotations

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import masked_matmul as _mm
from repro_torch.kernels import ref


def _route(name: str, t) -> bool:
    """True for the CUDA kernel, False for the plain CPU version."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel for device {t.device} (expected "
                     f"a cpu or cuda tensor)")


def decode_attention(q, k, v, lengths=None):
    """q [B,1,H,hd] against the cache k/v [B,S,KV,hd]; ``lengths`` (int32
    [B]) valid slots per sequence, all S when None."""
    _da.check_shapes(q, k, v, lengths)
    if _route("decode_attention", q):
        return _da.decode_attention(q, k, v, lengths)
    return ref.decode_attention_ref(q, k, v, lengths)


def masked_matmul(x, w, block_mask):
    """x [M,K] @ w [K,N] with the 128-column blocks whose mask entry is not
    > 0 skipped and written as zeros."""
    _mm.check_shapes(x, w, block_mask)
    if _route("masked_matmul", x):
        return _mm.masked_matmul(x, w, block_mask)
    return ref.masked_matmul_ref(x, w, block_mask)
