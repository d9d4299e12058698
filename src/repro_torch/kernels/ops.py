"""Kernel dispatch by tensor device.

A CPU tensor goes to the plain PyTorch version in :mod:`ref`; a CUDA tensor
launches the hand-written kernel or raises.  There is no fallback between
the two and no switch: the device of the data decides.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import masked_matmul as _mm
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as _ss


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


def _forward_only(name: str, *tensors) -> None:
    """K4 and K6 have no backward, as the reference's Pallas kernels have no
    VJP: refuse an input that autograd would differentiate."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is forward-only (attn_impl='pallas' scores and "
            f"evaluates); training differentiates the plain path, "
            f"attn_impl='xla'")


def flash_attention(q, k, v, *, causal=True, window=None):
    """K4: q [B,Sq,H,hd] attends k/v [B,Skv,KV,hd] (query head h reads kv
    head h % KV) with a causal mask and an optional sliding ``window``;
    forward only.  Any Sq and Skv."""
    _fa.check_shapes(q, k, v, window)
    _forward_only("flash_attention", q, k, v)
    if _route("flash_attention", q):
        return _fa.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal,
                                   window=window)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window)


def ssd_scan(x, bmat, cmat, dt, a_log, d, dt_bias, *, chunk=128):
    """K6: the Mamba2 SSD scan, x [B,S,nh,p], bmat/cmat [B,S,N], dt
    [B,S,nh], a_log/d/dt_bias [nh] -> y [B,S,nh,p]; forward only.  Any S;
    ``chunk`` is the reference's argument (the kernel runs its own chunk,
    the plain version one step at a time).  The kernel reads x, B, C and dt
    in place when their steps are rows of one stride, as the ``torch.split``
    views of a fused projection are; any other layout is copied first."""
    _ss.check_shapes(x, bmat, cmat, dt, a_log, d, dt_bias, chunk)
    _forward_only("ssd_scan", x, bmat, cmat, dt, a_log, d, dt_bias)
    if _route("ssd_scan", x):
        return _ss.ssd_scan(*_ss.readable(x, bmat, cmat, dt),
                            *(t.contiguous() for t in (a_log, d, dt_bias)),
                            chunk=chunk)
    return ref.ssd_scan_ref(x, bmat, cmat, dt, a_log, d, dt_bias)


def masked_matmul_fwd(x, w, block_mask):
    """K1, not differentiable: x [M,K] @ w [K,N] with the 128-column blocks
    whose mask entry is not > 0 skipped and written as zeros."""
    _mm.check_shapes(x, w, block_mask)
    if _route("masked_matmul", x):
        return _mm.masked_matmul(x, w, block_mask)
    return ref.masked_matmul_ref(x, w, block_mask)


def masked_matmul_dx(dy, w, block_mask):
    """K2: dy [M,N] @ w [K,N].T over the kept column blocks of w."""
    _mm.check_shapes_dx(dy, w, block_mask)
    if _route("masked_matmul_dx", dy):
        return _mm.masked_matmul_dx(dy, w, block_mask)
    return ref.masked_matmul_dx_ref(dy, w, block_mask)


def masked_matmul_dw(x, dy, block_mask):
    """K3: x [M,K].T @ dy [M,N], pruned column blocks exact zeros."""
    _mm.check_shapes_dw(x, dy, block_mask)
    if _route("masked_matmul_dw", x):
        return _mm.masked_matmul_dw(x, dy, block_mask)
    return ref.masked_matmul_dw_ref(x, dy, block_mask)


_masked_depth = 0   # MaskedMatmul forwards running (see inside_masked_matmul)


def inside_masked_matmul() -> bool:
    """True while :class:`MaskedMatmul`'s forward runs: a selective
    checkpoint policy (``remat="dots"``) reads it to recompute the masked
    product rather than save it."""
    return _masked_depth > 0


class MaskedMatmul(torch.autograd.Function):
    """The differentiable masked matmul, the counterpart of the reference's
    ``jax.custom_vjp`` around its three Pallas kernels: the forward is K1,
    the backward K2 for ``x`` and K3 for ``w``; ``block_mask`` gets no
    gradient.  Every product dispatches by device, so CPU tensors run the
    plain versions through the same Function."""

    @staticmethod
    def forward(ctx, x, w, block_mask):
        global _masked_depth
        ctx.save_for_backward(x, w, block_mask)
        _masked_depth += 1
        try:
            return masked_matmul_fwd(x, w, block_mask)
        finally:
            _masked_depth -= 1

    @staticmethod
    def backward(ctx, dy):
        x, w, block_mask = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = masked_matmul_dx(dy, w, block_mask)
        if ctx.needs_input_grad[1]:
            dw = masked_matmul_dw(x, dy, block_mask)
        return dx, dw, None


def masked_matmul(x, w, block_mask):
    """x [M,K] @ w [K,N] with the 128-column blocks whose mask entry is not
    > 0 skipped and written as zeros; differentiable in ``x`` and ``w``."""
    _mm.check_shapes(x, w, block_mask)
    return MaskedMatmul.apply(x, w, block_mask)
