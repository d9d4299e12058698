"""The Mamba2 SSD scan on the card: the wrapper of ``csrc/ssd_scan.cu``.

Replaces the TPU kernel ``repro/kernels/ssd_scan.py::_ssd_kernel`` (its
``pallas_call`` in ``ssd_scan``).  The kernel runs the state-space-duality
chunked form in three launches over chunks of :data:`KERNEL_CHUNK` steps:
each chunk's own state (a product on the tensor cores), the states passed
from chunk to chunk in series, then each chunk's output from its inputs and
the state entering it.  The ``chunk`` argument is accepted for signature
parity: the result does not depend on the chunk beyond f32 rounding.  Any S
works, a partial last chunk and S < chunk included; N = 64 and p any
multiple of 8 (the kernel runs sub-heads of 64 columns of p).  x, B, C and dt are read
in place when their steps are rows of one stride (the ``torch.split`` views
of a fused projection are), see :func:`row_strides`.  The source describes
the design.
"""
from __future__ import annotations

import functools
import types

import torch

from repro_torch.kernels import _build

launches = 0    # kernel calls (one launcher call runs the three passes)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STATE_DIMS = (64,)    # N the kernel is instantiated for (zamba2)
HEAD_DIM_STEP = 8     # p must be a multiple of it
# The chunk Q the kernel runs per input type (the source's ``kChunk``); the
# CPU replay of its schedule reads it, and ``chip_smoke.py`` holds the
# library's own (:func:`library_chunk`) to it.
KERNEL_CHUNK = types.MappingProxyType({torch.float32: 64, torch.bfloat16: 128})


def work(b: int, s: int, nh: int, p: int, n: int, elt: int
         ) -> tuple[int, int]:
    """(flops, HBM bytes) of the function, not of one way to compute it: x,
    B, C, dt read and y written once, a_log/d/dt_bias (f32) read; the
    sequential recurrence's 4 B S nh p N flops (the state update dt x B^T
    and decay, and y = C H: two multiply-adds per state element a step)."""
    return (4 * b * s * nh * p * n,
            elt * (2 * b * s * nh * p + 2 * b * s * n + b * s * nh)
            + 3 * 4 * nh)


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


def _row_stride(t, aligned: bool):
    """The elements between two steps of ``t`` [B, S, ...] when step ``s``
    of batch ``b`` starts at ``(b*S + s) * row`` and each step's elements
    are contiguous (rows on 16 bytes when ``aligned``), else None."""
    b, s = t.shape[:2]
    width = 1
    for size, stride in reversed(list(zip(t.shape[2:], t.stride()[2:]))):
        if size > 1 and stride != width:
            return None
        width *= size
    if s > 1:
        row = t.stride(1)
        if b > 1 and t.stride(0) != s * row:
            return None
    else:
        row = t.stride(0) if b > 1 else width
    if row < width:
        return None
    if aligned and (row * t.element_size() % 16 or t.data_ptr() % 16):
        return None
    return row


def row_strides(x, bmat, cmat, dt):
    """(x, bmat, cmat, dt row strides in elements) when the kernel can read
    the four in place, else None: each one's steps are rows of one stride,
    each step contiguous, and the rows of x, B and C start on 16 bytes."""
    rows = (_row_stride(x, True), _row_stride(bmat, True),
            _row_stride(cmat, True), _row_stride(dt, False))
    return None if None in rows else rows


def readable(x, bmat, cmat, dt):
    """The four inputs as the kernel reads them: each as it is when its
    layout allows (:func:`row_strides`), else a contiguous copy."""
    out = []
    for t, aligned in ((x, True), (bmat, True), (cmat, True), (dt, False)):
        if _row_stride(t, aligned) is None:
            t = t.clone(memory_format=torch.contiguous_format)
        out.append(t)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def library_chunk(dtype) -> int:
    """The chunk Q the built kernel runs for ``dtype``: the workspace is
    sized by it."""
    return _build.launcher("ssd_scan_chunk")(_DTYPES[dtype])


def ssd_scan(x, bmat, cmat, dt, a_log, d, dt_bias, *, chunk: int = 128):
    """Launch the CUDA kernel: x [B,S,nh,p], bmat/cmat [B,S,N], dt [B,S,nh]
    of one type (float32 or bfloat16), laid out as :func:`row_strides`
    takes, a_log/d/dt_bias [nh] float32 contiguous, all on one CUDA device,
    N in :data:`STATE_DIMS`, p a multiple of :data:`HEAD_DIM_STEP`.
    Returns a new contiguous y [B,S,nh,p] of x's type."""
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
    if not all(t.is_contiguous() for t in (a_log, d, dt_bias)):
        raise ValueError("ssd_scan kernel: a_log/d/dt_bias must be contiguous")
    b, s, nh, p = x.shape
    n = bmat.shape[2]
    if n not in STATE_DIMS or p % HEAD_DIM_STEP:
        raise ValueError(f"ssd_scan kernel: state size N must be one of "
                         f"{STATE_DIMS} and head dim p a multiple of "
                         f"{HEAD_DIM_STEP}, got N={n}, p={p}")
    rows = row_strides(x, bmat, cmat, dt)
    if rows is None:
        raise ValueError(
            "ssd_scan kernel: x/bmat/cmat/dt must be rows of one stride per "
            "step with each step contiguous, and x/bmat/cmat rows on 16 "
            f"bytes; got strides {x.stride()}, {bmat.stride()}, "
            f"{cmat.stride()}, {dt.stride()}")
    nc1 = -(-s // library_chunk(x.dtype)) - 1
    nsh = nh * -(-p // 64)             # sub-heads of 64 columns of p
    state = torch.empty((b, nc1, nsh, 64, n), dtype=torch.float32,
                        device=x.device)
    totals = torch.empty((b, nc1, nsh), dtype=torch.float32, device=x.device)
    y = torch.empty((b, s, nh, p), dtype=x.dtype, device=x.device)
    fn = _build.launcher("ssd_scan")
    err = fn(x.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), dt.data_ptr(),
             a_log.data_ptr(), d.data_ptr(), dt_bias.data_ptr(), y.data_ptr(),
             state.data_ptr() if nc1 else None,
             totals.data_ptr() if nc1 else None, b, s, nh, p, n,
             _DTYPES[x.dtype], *rows,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ssd_scan")
    launches += 1
    return y
