"""Kernel dispatch by tensor device.

A CPU tensor goes to the plain PyTorch version in :mod:`ref` (its result
made contiguous, the kernels' layout); a CUDA tensor launches the
hand-written kernel or raises.  There is no fallback between the two and
no switch: the device of the data decides.  A meta tensor (no data: shapes
and dtypes only, for counting a step's work) gets an empty output of the
kernel's shape, and nothing is computed.

While a cost counter is active (``launch.cost.CostCounter`` sets
:data:`counter`), each entry point reports its kernel's work, the
wrapper's ``work(...)`` from the shapes, and the counter ignores the
operations inside the call (the plain version's on the CPU), so each
kernel is counted once, by its formula, on every device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import masked_matmul as _mm
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as _ss

counter = None  # the active launch.cost.CostCounter, if any


def _route(name: str, t) -> str:
    """``"cuda"`` for the CUDA kernel, ``"cpu"`` for the plain version,
    ``"meta"`` for an empty output of the kernel's shape."""
    if t.device.type in ("cuda", "cpu", "meta"):
        return t.device.type
    raise ValueError(f"{name}: no kernel for device {t.device} (expected "
                     f"a cpu, cuda or meta tensor)")


def _counted(name: str, work, fn, *args):
    """``fn(*args)``, its work reported to the active counter, if any."""
    if counter is None:
        return fn(*args)
    with counter.kernel(name, *work()):
        return fn(*args)


def decode_attention(q, k, v, lengths=None):
    """q [B,1,H,hd] against the cache k/v [B,S,KV,hd]; ``lengths`` (int32
    [B]) valid slots per sequence, all S when None."""
    _da.check_shapes(q, k, v, lengths)
    b, _, h, hd = q.shape
    return _counted(
        "decode_attention",
        lambda: _da.work(b, h, k.shape[2], hd, q.element_size(),
                         b * k.shape[1], with_lengths=lengths is not None),
        _decode_attention, q, k, v, lengths)


def _decode_attention(q, k, v, lengths):
    route = _route("decode_attention", q)
    if route == "meta":
        return torch.empty_like(q)
    if route == "cuda":
        return _da.decode_attention(q, k, v, lengths)
    return ref.decode_attention_ref(q, k, v, lengths).contiguous()


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
    b, sq, h, hd = q.shape
    return _counted(
        "flash_attention",
        lambda: _fa.work(b, sq, k.shape[1], h, k.shape[2], hd,
                         q.element_size(), causal=causal, window=window),
        _flash_attention, q, k, v, causal, window)


def _flash_attention(q, k, v, causal, window):
    route = _route("flash_attention", q)
    if route == "meta":
        return torch.empty_like(q)
    if route == "cuda":
        return _fa.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal,
                                   window=window)
    return ref.flash_attention_ref(q, k, v, causal=causal,
                                   window=window).contiguous()


def ssd_scan(x, bmat, cmat, dt, a_log, d, dt_bias, *, chunk=128):
    """K6: the Mamba2 SSD scan, x [B,S,nh,p], bmat/cmat [B,S,N], dt
    [B,S,nh], a_log/d/dt_bias [nh] -> y [B,S,nh,p]; forward only.  Any S;
    ``chunk`` is the reference's argument (the kernel runs its own chunk,
    the plain version one step at a time).  The kernel reads x, B, C and dt
    in place when their steps are rows of one stride, as the ``torch.split``
    views of a fused projection are; any other layout is copied first."""
    _ss.check_shapes(x, bmat, cmat, dt, a_log, d, dt_bias, chunk)
    _forward_only("ssd_scan", x, bmat, cmat, dt, a_log, d, dt_bias)
    return _counted("ssd_scan",
                    lambda: _ss.work(*x.shape, bmat.shape[2],
                                     x.element_size()),
                    _ssd_scan, x, bmat, cmat, dt, a_log, d, dt_bias, chunk)


def _ssd_scan(x, bmat, cmat, dt, a_log, d, dt_bias, chunk):
    route = _route("ssd_scan", x)
    if route == "meta":
        return torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if route == "cuda":
        return _ss.ssd_scan(*_ss.readable(x, bmat, cmat, dt),
                            *(t.contiguous() for t in (a_log, d, dt_bias)),
                            chunk=chunk)
    return ref.ssd_scan_ref(x, bmat, cmat, dt, a_log, d,
                            dt_bias).contiguous()


def masked_matmul_fwd(x, w, block_mask):
    """K1, not differentiable: x [M,K] @ w [K,N] with the 128-column blocks
    whose mask entry is not > 0 skipped and written as zeros."""
    _mm.check_shapes(x, w, block_mask)
    return _counted("masked_matmul",
                    lambda: _mm.work("fwd", *x.shape, w.shape[1],
                                     x.element_size()),
                    _masked_matmul, "fwd", x, w, block_mask)


def masked_matmul_dx(dy, w, block_mask):
    """K2: dy [M,N] @ w [K,N].T over the kept column blocks of w."""
    _mm.check_shapes_dx(dy, w, block_mask)
    return _counted("masked_matmul_dx",
                    lambda: _mm.work("dx", dy.shape[0], *w.shape,
                                     dy.element_size()),
                    _masked_matmul, "dx", dy, w, block_mask)


def masked_matmul_dw(x, dy, block_mask):
    """K3: x [M,K].T @ dy [M,N], pruned column blocks exact zeros."""
    _mm.check_shapes_dw(x, dy, block_mask)
    return _counted("masked_matmul_dw",
                    lambda: _mm.work("dw", *x.shape, dy.shape[1],
                                     x.element_size()),
                    _masked_matmul, "dw", x, dy, block_mask)


def _masked_matmul(kind: str, a, b, block_mask):
    """K1 (x @ w), K2 (dy @ w.T) or K3 (x.T @ dy) by the device of ``a``."""
    name = {"fwd": "masked_matmul", "dx": "masked_matmul_dx",
            "dw": "masked_matmul_dw"}[kind]
    route = _route(name, a)
    if route == "meta":
        rows = a.shape[1] if kind == "dw" else a.shape[0]
        cols = b.shape[0] if kind == "dx" else b.shape[1]
        return torch.empty((rows, cols), dtype=a.dtype, device=a.device)
    if route == "cuda":
        return getattr(_mm, name)(a, b, block_mask)
    return getattr(ref, name + "_ref")(a, b, block_mask).contiguous()


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
