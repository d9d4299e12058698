"""Flash-decode on the card: the wrapper of ``csrc/decode_attention.cu``.

Replaces the TPU kernel ``repro/kernels/decode_attention.py::_decode_kernel``
(its ``pallas_call`` in ``decode_attention``).  On an H100 the kernel is
bound by bytes: it must read each sequence's valid K/V prefix once, and
does 4 flops per K/V value pair.  At serving's shape (8 sequences x 16 kv
heads) one block per (kv head, sequence) would leave the card under one
wave, so the cache is split (split-S flash-decoding): :func:`decode_splits`
cuts the S cache rows into splits of at most ``SPLIT_ROWS`` (4 splits of
128 at S = 512), a number fixed by S and never by ``lengths``, which stays
on the device.  Each split's warps stream their rows with 16-byte loads
into registers (the lane layout of :func:`decode_layout`) and keep the
online softmax there.  Only the splits that hold rows of a sequence run;
a sequence held by one split (every length up to 128: all of serving's)
is written by it directly, and otherwise the last of its splits to finish
merges their (m, l, acc) in split order (bitwise reproducible), in the
same launch.  The merge's workspace and arrival counters are kept across
calls.  Unlike the Pallas kernel it takes any cache length S (there is no
block_k to divide it); head_dim is capped at 256 in f32 and 512 in bf16
(two 16-byte vectors a lane).
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import _build

launches = 0    # kernel launches since the caller last reset it

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SPLIT_ROWS = 128      # the most cache rows a split holds
# (device index, stream) -> (floats, counters, f32 workspace, int32 counters)
_scratch: dict = {}
# workspaces a larger one replaced: a captured graph (``core.programs``) may
# still address them, so they are never freed
_retired: list = []


def decode_splits(s: int) -> int:
    """How many splits the S cache rows are cut into: ``ceil(S /
    SPLIT_ROWS)``, at least 1 (4 at S = 512).  Split ``i`` covers cache rows
    ``[i * rows, (i + 1) * rows)``, ``rows = ceil(s / splits)``, cut at S
    and at the sequence's length."""
    return max(1, -(-s // SPLIT_ROWS))


def decode_layout(hd: int, elt: int, g: int) -> tuple[int, int, int]:
    """The kernel's layout for head_dim ``hd`` of ``elt``-byte elements and
    G query rows per kv head: (query rows a block: 1, or 4 when G > 1;
    lanes a cache row: a power of two, each lane holding one or two 16-byte
    vectors of it; row steps whose loads a warp issues at once).  The
    library checks it against its kernel's once per shape."""
    chunks = hd * elt // 16
    u = 1 if chunks <= 32 else 2
    lanes = 1
    while lanes * u < chunks:
        lanes *= 2
    gb = 1 if g == 1 else 4
    return gb, lanes, (8 if gb == 1 else 4) // u


@functools.lru_cache(maxsize=None)
def _plan(s: int, hd: int, dtype: int, g: int) -> tuple[int, int]:
    """(splits, query rows a block) for a launch, once the library has
    confirmed, once per shape, that its kernel runs :func:`decode_layout`."""
    layout = decode_layout(hd, 4 if dtype == 0 else 2, g)
    _build.check(_build.launcher("decode_attention_layout")(hd, g, dtype,
                                                            *layout),
                 f"decode_attention layout {layout} for hd={hd} G={g}")
    return decode_splits(s), layout[0]


def _workspace(device, stream: int, floats: int, counters: int):
    """The merge's f32 workspace (at least ``floats``) and int32 arrival
    counters (at least ``counters``, zero), kept across calls on ``stream``
    so that no launch allocates; stream order keeps two launches apart, and
    the kernel leaves the counters at zero."""
    have = _scratch.get((device.index, stream))
    if have is None or have[0] < floats or have[1] < counters:
        if have is not None:
            _retired.append(have)
        have = (floats, counters,
                torch.empty(floats, dtype=torch.float32, device=device),
                torch.zeros(counters, dtype=torch.int32, device=device))
        _scratch[(device.index, stream)] = have
    return have[2], have[3]


def work(b: int, h: int, kvh: int, hd: int, elt: int, lens_sum: int, *,
         with_lengths: bool = True) -> tuple[int, int]:
    """(flops, HBM bytes) of one call: q read and the output written once,
    each sequence's attended K/V rows (``lens_sum`` over the batch) read
    once, ``lengths`` (int32) read; 4 flops per attended (row, head-dim)
    pair of each query head.  The lengths lie on the device, so a count
    from shapes alone passes all S rows of every sequence: the most the
    call can attend."""
    return (4 * lens_sum * h * hd,
            elt * (2 * b * h * hd + 2 * lens_sum * kvh * hd)
            + (4 * b if with_lengths else 0))


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
    max_hd = 64 * 16 // q.element_size()    # 64 16-byte vectors a row
    if hd % 8 or hd > max_hd:
        raise ValueError(
            f"decode_attention kernel: head_dim must be a multiple of 8 "
            f"(16-byte cache copies) and at most {max_hd} in {q.dtype}, "
            f"got {hd}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(
            "decode_attention kernel: q/k/v must be 16-byte aligned")
    splits, gb = _plan(s_len, hd, _DTYPES[q.dtype], h // kvh)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    out = torch.empty_like(q)
    ws = arrivals = None
    if splits > 1:
        ws, arrivals = _workspace(q.device, stream, splits * b * h * (hd + 2),
                                  kvh * -(-(h // kvh) // gb) * b)
    fn = _build.launcher("decode_attention")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             None if lengths is None else lengths.data_ptr(), out.data_ptr(),
             None if ws is None else ws.data_ptr(),
             None if arrivals is None else arrivals.data_ptr(), b, s_len, h,
             kvh, hd, splits, _DTYPES[q.dtype], 1.0 / math.sqrt(hd), stream)
    _build.check(err, "decode_attention")
    launches += 1
    return out
