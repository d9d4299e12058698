"""Flash attention on the card: the wrapper of ``csrc/flash_attention.cu``.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::_flash_kernel``
(its ``pallas_call`` in ``flash_attention``,
``repro/kernels/flash_attention.py:102``): blocked online-softmax GQA
attention over a whole sequence, forward only.  On an H100 it is bound by
operations (4 flops per visible (query, key, head-dim) triple, each K/V
tile reused by every row of a query tile).  Two paths:

* bf16 (scoring): a warp-specialised ``wgmma`` kernel.  TMA brings Q once
  and K/V tiles of 128 keys through an ``mbarrier`` ring straight from the
  [B,S,KV,hd] layout; two consumer warpgroups of 64 query rows run
  S = Q K^T on the tensor cores, mask only the kv tiles that the causal
  diagonal, the window's edge or the ragged end cut, and add P V as two
  bf16 products (P split into P_hi + P_lo, so P keeps ~16 bits) into one
  f32 accumulator.
* f32: f32 has no tensor-core path without TF32 rounding, so a SIMT f32
  kernel (64-row query tiles, 32-key kv tiles, conflict-free 16-byte
  shared-memory vectors).

Both skip the kv tiles that the causal mask or the window hides, and take
any Sq and Skv: there are no block sizes to divide them, the ragged tails
are masked.  The designs are described in the source.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import _build

launches = 0    # kernel launches since the caller last reset it

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)    # head sizes the kernel is instantiated for (zamba2, olmo-1b)


@functools.lru_cache(maxsize=None)
def visible_pairs(sq: int, skv: int, causal: bool, window) -> int:
    """How many (query, key) pairs the mask lets through: query ``i`` sees
    key ``j`` iff ``j <= i`` (causal) and ``j > i - window`` (a window),
    positions from 0 on both sides (``ref.visible``'s count, from shapes
    alone)."""
    total = 0
    for i in range(sq):
        hi = min(i, skv - 1) if causal else skv - 1
        lo = 0 if window is None else max(0, i - int(window) + 1)
        total += max(0, hi - lo + 1)
    return total


def work(b: int, sq: int, skv: int, h: int, kvh: int, hd: int, elt: int, *,
         causal: bool = True, window=None) -> tuple[int, int]:
    """(flops, HBM bytes) of one call: q, k, v read once and the output
    written once; 4 flops per visible (query, key, head-dim) triple (QK^T
    and PV)."""
    pairs = visible_pairs(sq, skv, bool(causal),
                          None if window is None else int(window))
    return (4 * b * h * hd * pairs,
            elt * (2 * b * sq * h * hd + 2 * b * skv * kvh * hd))


def check_shapes(q, k, v, window=None) -> None:
    """The reference's shape errors (``ValueError``), for either path."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(
            f"flash_attention: expected q [B,Sq,H,hd] and k/v [B,Skv,KV,hd], "
            f"got q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, _, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(
            f"flash_attention: k {tuple(k.shape)} / v {tuple(v.shape)} must "
            f"both be [B={b}, Skv, KV, hd={hd}]")
    kvh = k.shape[2]
    if kvh == 0 or h % kvh != 0:
        raise ValueError(
            f"flash_attention: query heads H={h} must be a multiple of "
            f"kv heads KV={kvh} (q {tuple(q.shape)}, k {tuple(k.shape)})")
    if window is not None and int(window) < 1:
        raise ValueError(f"flash_attention: window must be >= 1 or None, "
                         f"got {window}")


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """Launch the CUDA kernel: q [B,Sq,H,hd], k/v [B,Skv,KV,hd] on one CUDA
    device, float32 or bfloat16, contiguous, hd in :data:`HEAD_DIMS`.
    Returns a new [B,Sq,H,hd] tensor of q's type."""
    global launches
    check_shapes(q, k, v, window)
    tensors = (q, k, v)
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError(
            f"flash_attention kernel: every tensor must lie on one CUDA "
            f"device, got {[str(t.device) for t in tensors]}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention kernel: q/k/v must share float32 or bfloat16, "
            f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention kernel: inputs must be contiguous")
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head_dim must be one of "
                         f"{HEAD_DIMS}, got {hd}")
    # 16-byte vector loads, and TMA for the bf16 wgmma path
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("flash_attention kernel: q/k/v must be 16-byte "
                         "aligned")
    if any(t.stride(i) * t.element_size() % 16 for t in tensors
           for i in range(3)):
        raise ValueError("flash_attention kernel: q/k/v rows must be a "
                         "multiple of 16 bytes apart")
    out = torch.empty_like(q)
    fn = _build.launcher("flash_attention")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
             skv, h, kvh, hd, _DTYPES[q.dtype], int(bool(causal)),
             0 if window is None else int(window), 1.0 / math.sqrt(hd),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    launches += 1
    return out
