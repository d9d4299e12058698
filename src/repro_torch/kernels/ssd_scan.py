"""The Mamba2 SSD scan on the card: the wrapper of ``csrc/ssd_scan.cu``.

Replaces the TPU kernel ``repro/kernels/ssd_scan.py::_ssd_kernel`` (its
``pallas_call`` in ``ssd_scan``).  On an H100 the kernel is bound by
operations, run in f32 as the Pallas kernel runs them.  The TPU kernel
keeps the whole state [nh, p, N] and a [chunk, chunk, nh] decay tensor in
VMEM; here one block per (16 rows of p, head, batch) keeps its f32 state
slice in shared memory and walks the sequence in sub-chunks of 32 steps
(the kernel's own chunk; the ``chunk`` argument is accepted for signature
parity, since the result does not depend on it beyond f32 rounding).  Any
S works, a partial last chunk included.  The source describes the design.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0    # kernel launches since the caller last reset it

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STATE_DIMS = (64,)    # N the kernel is instantiated for (zamba2)


def check_shapes(x, bmat, cmat, dt, a_log, d, dt_bias, chunk=128) -> None:
    """Shape errors (``ValueError``) naming the shapes, for either path."""
    if x.ndim != 4 or bmat.ndim != 3 or cmat.ndim != 3 or dt.ndim != 3:
        raise ValueError(
            f"ssd_scan: expected x [B,S,nh,p], bmat/cmat [B,S,N], dt [B,S,nh],"
            f" got x {tuple(x.shape)}, bmat {tuple(bmat.shape)}, cmat "
            f"{tuple(cmat.shape)}, dt {tuple(dt.shape)}")
    b, s, nh, _ = x.shape
    if bmat.shape != cmat.shape or tuple(bmat.shape[:2]) != (b, s):
        raise ValueError(
            f"ssd_scan: bmat {tuple(bmat.shape)} / cmat {tuple(cmat.shape)} "
            f"must both be [B={b}, S={s}, N]")
    if tuple(dt.shape) != (b, s, nh):
        raise ValueError(f"ssd_scan: dt {tuple(dt.shape)} must be "
                         f"[B={b}, S={s}, nh={nh}]")
    for name, t in (("a_log", a_log), ("d", d), ("dt_bias", dt_bias)):
        if tuple(t.shape) != (nh,):
            raise ValueError(f"ssd_scan: {name} {tuple(t.shape)} must be "
                             f"[nh={nh}]")
    if int(chunk) < 1:
        raise ValueError(f"ssd_scan: chunk must be >= 1, got {chunk}")


def ssd_scan(x, bmat, cmat, dt, a_log, d, dt_bias, *, chunk: int = 128):
    """Launch the CUDA kernel: x [B,S,nh,p], bmat/cmat [B,S,N], dt [B,S,nh]
    of one type (float32 or bfloat16), a_log/d/dt_bias [nh] float32, all
    contiguous on one CUDA device, N in :data:`STATE_DIMS`.  Returns a new
    y [B,S,nh,p] of x's type."""
    global launches
    check_shapes(x, bmat, cmat, dt, a_log, d, dt_bias, chunk)
    tensors = (x, bmat, cmat, dt, a_log, d, dt_bias)
    if any(t.device.type != "cuda" or t.device != x.device for t in tensors):
        raise ValueError(
            f"ssd_scan kernel: every tensor must lie on one CUDA device, got "
            f"{[str(t.device) for t in tensors]}")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype
                                     for t in (bmat, cmat, dt)):
        raise ValueError(
            f"ssd_scan kernel: x/bmat/cmat/dt must share float32 or bfloat16,"
            f" got {x.dtype}, {bmat.dtype}, {cmat.dtype}, {dt.dtype}")
    if any(t.dtype != torch.float32 for t in (a_log, d, dt_bias)):
        raise ValueError("ssd_scan kernel: a_log/d/dt_bias must be float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_scan kernel: inputs must be contiguous")
    b, s, nh, p = x.shape
    n = bmat.shape[2]
    if n not in STATE_DIMS:
        raise ValueError(f"ssd_scan kernel: state size N must be one of "
                         f"{STATE_DIMS}, got {n}")
    if any(t.data_ptr() % 16 for t in (bmat, cmat)):
        raise ValueError("ssd_scan kernel: bmat/cmat must be 16-byte aligned")
    y = torch.empty_like(x)
    fn = _build.launcher("ssd_scan")
    err = fn(x.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), dt.data_ptr(),
             a_log.data_ptr(), d.data_ptr(), dt_bias.data_ptr(), y.data_ptr(),
             b, s, nh, p, n, _DTYPES[x.dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ssd_scan")
    launches += 1
    return y
