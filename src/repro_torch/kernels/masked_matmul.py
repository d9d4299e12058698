"""FedAP masked matmul on the card: the wrapper of ``csrc/masked_matmul.cu``.

Replaces the forward TPU kernel
``repro/kernels/masked_matmul.py::_masked_mm_kernel`` (its ``pallas_call``
in ``_fwd_call``).  On an H100, at the decode shapes (M = serving slots) the
kernel is bound by bytes: the kept 128-column blocks of ``w`` are streamed
once and the pruned ones are never read, so FedAP's pruning shows up as
bytes not moved.  The design (8-row M tiles x 32-column slices, 16-byte
loads of ``w`` in flight, x staged in shared memory) is described in the
source.  Any M is taken: the wrapper pads nothing.

Forward only: serving runs under ``torch.inference_mode()``.  The backward
kernels (``_masked_dx_kernel``, ``_masked_dw_kernel``) and the
``torch.autograd.Function`` come with the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0    # kernel launches since the caller last reset it

BLOCK_N = 128   # mask granularity: one mask entry per 128 columns of w
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_shapes(x, w, block_mask) -> None:
    """The reference's public ``ValueError``s on rank, contraction, K/N
    alignment to 128 and mask shape (M may be any size)."""
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError(f"masked_matmul expects 2-D operands, got "
                         f"x.shape={tuple(x.shape)} w.shape={tuple(w.shape)}")
    m, kdim = x.shape
    k2, n = w.shape
    if kdim != k2:
        raise ValueError(f"masked_matmul contraction mismatch: x.shape="
                         f"{tuple(x.shape)} vs w.shape={tuple(w.shape)} "
                         f"(K {kdim} != {k2})")
    if n % BLOCK_N or kdim % BLOCK_N:
        raise ValueError(
            f"masked_matmul shapes must be block-aligned: x.shape="
            f"{tuple(x.shape)} w.shape={tuple(w.shape)} need K and N to be "
            f"multiples of {BLOCK_N} (mask masked_dense's plain product "
            f"instead)")
    if tuple(block_mask.shape) != (n // BLOCK_N,):
        raise ValueError(
            f"masked_matmul block_mask must have shape (N // block_n,) = "
            f"({n // BLOCK_N},), got {tuple(block_mask.shape)} for w.shape="
            f"{tuple(w.shape)} block_n={BLOCK_N}")


def masked_matmul(x, w, block_mask):
    """Launch the CUDA kernel: x [M,K] @ w [K,N] on one CUDA device,
    float32 or bfloat16, contiguous, with ``block_mask`` float32 [N/128]
    (column block j is computed iff ``block_mask[j] > 0``, else zero).
    Returns a new [M,N] tensor of x's type."""
    global launches
    check_shapes(x, w, block_mask)
    tensors = (x, w, block_mask)
    if any(t.device.type != "cuda" or t.device != x.device for t in tensors):
        raise ValueError(
            f"masked_matmul kernel: every tensor must lie on one CUDA device, "
            f"got {[str(t.device) for t in tensors]}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise ValueError(
            f"masked_matmul kernel: x and w must share float32 or bfloat16, "
            f"got {x.dtype}, {w.dtype}")
    if block_mask.dtype != torch.float32:
        raise ValueError(
            f"masked_matmul kernel: block_mask must be float32, got "
            f"{block_mask.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("masked_matmul kernel: inputs must be contiguous")
    if w.data_ptr() % 16:
        raise ValueError("masked_matmul kernel: w must be 16-byte aligned")
    m, kdim = x.shape
    n = w.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    fn = _build.launcher("masked_matmul")
    err = fn(x.data_ptr(), w.data_ptr(), block_mask.data_ptr(), y.data_ptr(),
             m, kdim, n, _DTYPES[x.dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "masked_matmul")
    launches += 1
    return y
