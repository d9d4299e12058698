"""FedAP masked matmul on the card: the wrappers of ``csrc/masked_matmul.cu``.

Three kernels, one per TPU kernel of ``repro/kernels/masked_matmul.py``:

* K1 :func:`masked_matmul` — ``y = x @ w``, replacing ``_masked_mm_kernel``
  (``_fwd_call``, ``repro/kernels/masked_matmul.py:122``).  Three paths:

  - decode (M <= 64, either type): bound by bytes, each element of ``w``
    feeding at most M multiply-adds.  A streaming split-K GEMV: a block owns
    64 columns and one of :func:`decode_plan`'s shares of the contraction
    (5 at K = 2048, N = 8192 on 132 SMs: 640 blocks, 320 with half the
    column blocks kept), a number fixed by the shapes and the SM count,
    never by the mask.  Its slice of ``w`` streams through a ring of 32-row
    stages filled by 16-byte ``cp.async``, its slice of ``x`` is staged
    once, and in bf16 the products run on the tensor cores (``mma.sync``,
    f32 sums); the last block of a column tile to finish sums the shares'
    f32 partials in split order (bitwise reproducible).  The partials and the
    arrival counters live in a workspace kept across calls per (device,
    stream, N), so a call allocates nothing but its output and never syncs.
  - bf16 at M > 64 (masked scoring, M = 8192): bound by operations, ~2700
    flops per byte against the ~295 at which the bf16 tensor cores meet
    device memory.  A warp-specialised ``wgmma`` GEMM fed by TMA through a
    4-stage ``mbarrier`` ring (256x128 tiles, a persistent grid), so the
    products run on the tensor cores with f32 sums.
  - f32 at M > 64 (training): bound by operations, but f32 has no
    tensor-core path without TF32 rounding, so a SIMT f32 GEMM: 256x128
    tiles, 8x16 sums per thread, a 2-stage ``cp.async`` ring of 64-deep
    untransposed tiles, and a persistent grid (fixed by the shapes) whose
    blocks take the kept tiles by rank and run one ring across them.  Its
    operands are read MN-major, so a first launch writes x^T into a
    workspace (:func:`xt_pitch`): x read K-major from padded rows made the
    same kind of body slower (``PERF.md``).
* K2 :func:`masked_matmul_dx` — ``dx = dy @ w.T`` over the kept N-blocks,
  replacing ``_masked_dx_kernel`` (``_dx_call``).  At training's shape
  (M = 512, K = 2048, N = 8192, f32) it is bound by operations like K1, but
  dx is small (32 tiles of 256x128 for 132 SMs) while its contraction is
  the long dimension.  So the kept N-blocks are split :func:`dx_splits`
  ways (4 there: 128 blocks, one per SM): each block counts the kept
  blocks on the device, takes its balanced share by rank, runs a SIMT f32
  GEMM (8x16 sums per thread, a 3-stage cp.async ring of untransposed
  32-deep tiles) and writes an f32 partial tile to a workspace; a second
  kernel sums the partials in split order (bitwise reproducible) and casts
  once.  What bounds it is the f32 SIMT rate, plus a fixed cost per call
  for the partial stores and the sum (``PERF.md``).
* K3 :func:`masked_matmul_dw` — ``dw = x.T @ dy`` with pruned column
  blocks written as exact zeros, replacing ``_masked_dw_kernel``
  (``_dw_call``).  It runs K1's f32 GEMM body on ``x`` as it lies (``x.T``
  read MN-major), in f32 and bf16; the persistent walk over its 512 tiles
  (at training's shape) hides its short 512-deep contraction's fill and
  drain.

Pruned blocks are never read, so FedAP's saving shows up as work not done.
Any M is taken: the wrappers pad nothing.  The differentiable op over the
three is :class:`repro_torch.kernels.ops.MaskedMatmul`.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build

launches = 0     # K1 launches since the caller last reset it
dx_launches = 0  # K2 launches since the caller last reset it
dw_launches = 0  # K3 launches since the caller last reset it

BLOCK_N = 128   # mask granularity: one mask entry per 128 columns of w
DX_ROWS, DX_COLS = 256, 128   # K2's dx tile (the launcher checks it)
DECODE_MAX_M = 64   # K1 runs its decode body up to this M
GV_COLS = 64        # columns of w a decode block owns
GV_BK = 32          # rows of w a decode ring stage holds
GV_X_BYTES = 65536  # the most f32 x a decode block stages
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (device index, stream, N) -> int32 decode workspace: arrival counters, then
# f32 partials
_scratch: dict = {}
# workspaces a larger one replaced: a captured graph (``core.programs``) may
# still address them, so they are never freed
_retired: list = []


def decode_plan(m: int, k: int, n: int, sms: int) -> tuple[int, int]:
    """(splits, stages per split) of K1's decode body (M <= 64), from the
    shapes and the SM count only, never from the mask: the K/``GV_BK``
    ring stages are cut into splits of ``per`` stages, as deep as lets 4
    blocks of ``GV_COLS`` columns run per SM with every column block kept
    (2 with half kept), shallower where a split's staged x (``8 * mt``
    rows of f32, ``mt`` = 1, 2, 4 or 8) would pass ``GV_X_BYTES``.  Split ``s`` contracts over the rows
    ``[s * per * GV_BK, min((s + 1) * per * GV_BK, K))``; the grid is
    ``(N // GV_COLS, splits)``.  (5, 13) at M = 8, K = 2048, N = 8192 on
    132 SMs.  The library's ``gv_plan`` is the same rule."""
    mt = 1 if m <= 8 else 2 if m <= 16 else 4 if m <= 32 else 8
    stages = k // GV_BK
    cap = GV_X_BYTES // (GV_BK * 8 * mt * 4)
    want = -(-4 * sms // (n // GV_COLS))
    want = max(1, min(stages, max(want, -(-stages // cap))))
    per = -(-stages // want)
    return -(-stages // per), per


def xt_pitch(m: int) -> int:
    """Row pitch (elements) of the x^T workspace [K, pitch] of K1 in f32 at
    M > 64: M rounded up to 4, so that 16-byte copies of its rows stay
    aligned."""
    return -(-m // 4) * 4


def decode_counters(n: int) -> int:
    """int32 arrival counters at the head of the decode workspace: one per
    ``GV_COLS``-column tile, rounded up to 16 bytes."""
    return -(-(n // GV_COLS) // 4) * 4


@functools.lru_cache(maxsize=None)
def _decode_splits(m: int, k: int, n: int, index: int) -> int:
    """:func:`decode_plan`'s split count on device ``index``, confirmed
    once per shape against the library's own."""
    sms = _build.sm_count(index)
    splits = decode_plan(m, k, n, sms)[0]
    lib = _build.launcher("masked_matmul_decode_splits")(m, k, n, sms)
    if lib != splits:  # lint: static-branch (an int from the library)
        raise RuntimeError(f"masked_matmul: the library splits M={m} K={k} "
                           f"N={n} on {sms} SMs {lib} ways, the host "
                           f"{splits}")
    return splits


def _workspace(device, stream: int, n: int, elems: int):
    """The decode workspace for N = ``n`` (at least ``elems`` int32
    elements, zero at allocation), kept across calls on ``stream`` so that
    no launch allocates; stream order keeps two launches apart, and the
    kernel leaves the counters at zero.  One per N, so that the counters
    always sit where no partial was ever written."""
    key = (device.index, stream, n)
    have = _scratch.get(key)
    if have is None or have.numel() < elems:
        if have is not None:
            _retired.append(have)
        have = torch.zeros(elems, dtype=torch.int32, device=device)
        _scratch[key] = have
    return have


def dx_splits(m: int, k: int, n: int, sms: int) -> int:
    """How many ways K2 splits its contraction: enough blocks of
    ``DX_ROWS x DX_COLS`` dx tiles for one per SM, at most one split per
    N-block.  A function of the shapes and the SM count only, never of the
    mask (4 at M = 512, K = 2048, N = 8192 on 132 SMs: 128 blocks).  Split
    ``z`` contracts over the kept N-blocks of ranks ``[z * kept // splits,
    (z + 1) * kept // splits)`` in mask order, counted on the device."""
    tiles = -(-m // DX_ROWS) * (k // DX_COLS)
    return max(1, min(n // BLOCK_N, sms // max(tiles, 1)))


def work(kind: str, m: int, k: int, n: int, elt: int,
         kept_blocks: int | None = None) -> tuple[int, int]:
    """(flops, HBM bytes) of one call of K1 (``kind="fwd"``), K2 (``"dx"``)
    or K3 (``"dw"``) at x [M,K], w [K,N] with ``elt``-byte operands: the
    kept 128-column blocks are read, the others are not, every output
    element is written once, the mask is read (f32), and only kept blocks
    cost multiply-adds.  ``kept_blocks=None`` counts all N/128 blocks: the
    mask's values lie on the device, so that is the upper bound a count
    from shapes alone can give."""
    blocks = n // BLOCK_N
    kept = blocks if kept_blocks is None else kept_blocks
    kn = BLOCK_N * kept
    any_kept = 1 if kept else 0
    elems = {"fwd": m * k * any_kept + k * kn + m * n,      # x, w kept, y
             "dx": m * kn + k * kn + m * k,                # dy, w kept, dx
             "dw": m * k * any_kept + m * kn + k * n}[kind]  # x, dy, dw
    return 2 * m * k * kn, elt * elems + 4 * blocks


def _check_blocks(kdim: int, n: int, block_mask) -> None:
    """K and N multiples of 128, and one mask entry per 128 columns."""
    if n % BLOCK_N or kdim % BLOCK_N:
        raise ValueError(
            f"masked_matmul shapes must be block-aligned: w.shape="
            f"{(kdim, n)} needs K and N to be multiples of {BLOCK_N} "
            f"(mask masked_dense's plain product instead)")
    if tuple(block_mask.shape) != (n // BLOCK_N,):
        raise ValueError(
            f"masked_matmul block_mask must have shape (N // block_n,) = "
            f"({n // BLOCK_N},), got {tuple(block_mask.shape)} for w.shape="
            f"{(kdim, n)} block_n={BLOCK_N}")


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
    _check_blocks(kdim, n, block_mask)


def check_shapes_dx(dy, w, block_mask) -> None:
    """dy [M,N] against w [K,N] for ``dx = dy @ w.T``."""
    if dy.ndim != 2 or w.ndim != 2 or dy.shape[1] != w.shape[1]:
        raise ValueError(f"masked_matmul_dx expects dy [M,N] and w [K,N], got "
                         f"dy.shape={tuple(dy.shape)} w.shape="
                         f"{tuple(w.shape)}")
    _check_blocks(w.shape[0], w.shape[1], block_mask)


def check_shapes_dw(x, dy, block_mask) -> None:
    """x [M,K] against dy [M,N] for ``dw = x.T @ dy``."""
    if x.ndim != 2 or dy.ndim != 2 or x.shape[0] != dy.shape[0]:
        raise ValueError(f"masked_matmul_dw expects x [M,K] and dy [M,N], got "
                         f"x.shape={tuple(x.shape)} dy.shape="
                         f"{tuple(dy.shape)}")
    _check_blocks(x.shape[1], dy.shape[1], block_mask)


def _check_operands(name, a, b, block_mask) -> None:
    tensors = (a, b, block_mask)
    if any(t.device.type != "cuda" or t.device != a.device for t in tensors):
        raise ValueError(
            f"{name} kernel: every tensor must lie on one CUDA device, "
            f"got {[str(t.device) for t in tensors]}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise ValueError(
            f"{name} kernel: both operands must share float32 or bfloat16, "
            f"got {a.dtype}, {b.dtype}")
    if block_mask.dtype != torch.float32:
        raise ValueError(
            f"{name} kernel: block_mask must be float32, got "
            f"{block_mask.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} kernel: inputs must be contiguous")
    # 16-byte vector loads, and TMA for the bf16 wgmma path
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError(f"{name} kernel: operands must be 16-byte aligned")
    if any(t.stride(0) * t.element_size() % 16 for t in (a, b)):
        raise ValueError(f"{name} kernel: operand rows must be a multiple of "
                         f"16 bytes apart")


def masked_matmul(x, w, block_mask):
    """K1: x [M,K] @ w [K,N] on one CUDA device, float32 or bfloat16,
    contiguous, with ``block_mask`` float32 [N/128] (column block j is
    computed iff ``block_mask[j] > 0``, else zero).  Returns a new [M,N]
    tensor of x's type."""
    global launches
    check_shapes(x, w, block_mask)
    _check_operands("masked_matmul", x, w, block_mask)
    m, kdim = x.shape
    n = w.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ws = None
    if m <= DECODE_MAX_M:
        splits = _decode_splits(m, kdim, n, x.device.index)
        if splits > 1:
            ws = _workspace(x.device, stream, n,
                            decode_counters(n) + splits * m * n)
    elif x.dtype == torch.float32:
        ws = torch.empty(kdim * xt_pitch(m), dtype=torch.float32,
                         device=x.device)
    err = _build.launcher("masked_matmul")(
        x.data_ptr(), w.data_ptr(), block_mask.data_ptr(), y.data_ptr(),
        None if ws is None else ws.data_ptr(), m, kdim, n, _DTYPES[x.dtype],
        stream)
    _build.check(err, "masked_matmul")
    launches += 1
    return y


def masked_matmul_dx(dy, w, block_mask):
    """K2: dy [M,N] @ w [K,N].T over the kept column blocks of w only.
    Returns a new [M,K] tensor of dy's type."""
    global dx_launches
    check_shapes_dx(dy, w, block_mask)
    _check_operands("masked_matmul_dx", dy, w, block_mask)
    m, n = dy.shape
    kdim = w.shape[0]
    splits = dx_splits(m, kdim, n, _build.sm_count(dy.device.index))
    dx = torch.empty((m, kdim), dtype=dy.dtype, device=dy.device)
    ws = (torch.empty((splits, m, kdim), dtype=torch.float32,
                      device=dy.device) if splits > 1 else None)
    err = _build.launcher("masked_matmul_dx")(
        dy.data_ptr(), w.data_ptr(), block_mask.data_ptr(), dx.data_ptr(),
        None if ws is None else ws.data_ptr(), m, kdim, n, splits, DX_ROWS,
        DX_COLS, _DTYPES[dy.dtype],
        torch.cuda.current_stream(dy.device).cuda_stream)
    _build.check(err, "masked_matmul_dx")
    dx_launches += 1
    return dx


def masked_matmul_dw(x, dy, block_mask):
    """K3: x [M,K].T @ dy [M,N] with the pruned column blocks written as
    exact zeros.  Returns a new [K,N] tensor of x's type."""
    global dw_launches
    check_shapes_dw(x, dy, block_mask)
    _check_operands("masked_matmul_dw", x, dy, block_mask)
    m, kdim = x.shape
    n = dy.shape[1]
    dw = torch.empty((kdim, n), dtype=x.dtype, device=x.device)
    err = _build.launcher("masked_matmul_dw")(
        x.data_ptr(), dy.data_ptr(), block_mask.data_ptr(), dw.data_ptr(), m,
        kdim, n, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "masked_matmul_dw")
    dw_launches += 1
    return dw
