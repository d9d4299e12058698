"""K1's decode GEMV and the GEMM body of K1 (f32) and K3, replayed on the CPU.

``csrc/masked_matmul.cu`` runs only on the card.  This file replays, in
plain PyTorch, what its two schedules do, with the wrapper's own rules
(``masked_matmul.decode_plan`` on an H100's 132 SMs and on smaller counts):

* K1 at decode (M <= 64, ``masked_gemv_kernel``): a grid of ``(N / 64,
  splits)`` blocks; block (tile, s) takes 64 columns and ring stages ``[s *
  per, (s + 1) * per)`` (32 rows of w each, the last split cut at K); warp
  ``wp`` sums rows ``wp + 8j`` of each stage, stage after stage; the 8
  warps' sums are added in warp order, then the splits' partials in split
  order.  A pruned column tile is written as exact zeros and nothing of it
  is read.
* The GEMM body (``masked_gemm_kernel``): 256x128 tiles, ``min(tiles,
  SMs)`` persistent blocks, block ``b`` taking the kept tiles of ranks ``b,
  b + grid, ...`` (kept tile ``r`` is row tile ``r % ptiles`` of the ``r //
  ptiles``-th kept column block) and writing the zeros of the pruned tiles
  ``b, b + grid, ...``; a 2-stage ring of 64-deep stages whose producer
  runs ahead across tile boundaries, its cursor checked against what the
  consumer expects in every slot; both operands read MN-major, rows past P
  or R zero-filled, each output written once.  K3 feeds it x as it lies
  (A = x.T); K1 in f32 first writes x^T into a [K, ``xt_pitch(M)``]
  workspace (``transpose_kernel``), zero columns past M.

Each replay is held to the port's plain version (``ref``) and to the JAX
package's Pallas kernels in interpret mode, in f32 at 1e-5 relative to
max(1, max |reference|): the sums run in another order.  Inputs come from
numpy seeds.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.masked_matmul import masked_matmul as pallas_mm
from repro_torch.kernels import masked_matmul as k1
from repro_torch.kernels import ref
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5
BLOCK_N = 128                       # mask block
SMS = 132                           # an H100's SMs
GV_WARPS = 8                        # the decode block's warps
GM_ROWS, GM_COLS = 256, 128        # the GEMM body's tile
GM_BK, GM_STAGES = 64, 2            # its ring: stage depth, stages


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()) if want.size else 0.0)
    np.testing.assert_allclose(got, want, atol=TOL * scale, rtol=0)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _kept(mask, j):
    return float(mask[j]) > 0                      # NaN is pruned


def _pad_rows(a, mult=8):
    out = np.zeros((-(-a.shape[0] // mult) * mult, a.shape[1]), np.float32)
    out[:a.shape[0]] = a
    return out


# ---------------------------------------------------------------------------
# K1 at decode
# ---------------------------------------------------------------------------

def replay_decode(x, w, mask, sms=SMS):
    """K1's decode arithmetic on x [M,K], w [K,N], mask [N/128] (f32
    tensors).  Returns y [M,N] and the grid."""
    m, kdim = x.shape
    n = w.shape[1]
    cols = k1.GV_COLS
    splits, per = k1.decode_plan(m, kdim, n, sms)
    stages = kdim // k1.GV_BK
    grid = (n // cols, splits)
    y = torch.full((m, n), float("nan"))
    for tile in range(grid[0]):
        c = slice(tile * cols, (tile + 1) * cols)
        if not _kept(mask, tile * cols // BLOCK_N):
            y[:, c] = 0.0                          # split 0 writes the zeros
            continue
        parts = []
        for s in range(splits):
            nst = min(per, stages - s * per)
            assert nst >= 1                        # no split is empty
            warp = torch.zeros((GV_WARPS, m, cols))
            for t in range(s * per, s * per + nst):
                for j in range(k1.GV_BK // GV_WARPS):
                    rows = t * k1.GV_BK + j * GV_WARPS + torch.arange(GV_WARPS)
                    warp += x[:, rows].T[:, :, None] * w[rows, c][:, None, :]
            part = warp[0]
            for v in range(1, GV_WARPS):
                part = part + warp[v]
            parts.append(part)
        out = parts[0]
        for part in parts[1:]:
            out = out + part
        y[:, c] = out
    return y, grid


def _pallas_fwd(x, w, mask):
    m = x.shape[0]
    return np.asarray(pallas_mm(jnp.asarray(_pad_rows(x)), jnp.asarray(w),
                                jnp.asarray(mask), block_m=8,
                                interpret=True))[:m]


K, N = 512, 768                     # 16 ring stages, 12 column tiles, 6 mask blocks
MASKS = {
    "ones": [1, 1, 1, 1, 1, 1],
    "rate0.5": [1, 0, 1, 0, 0, 1],
    "zeros": [0, 0, 0, 0, 0, 0],
    "one-kept": [0, 0, 0, 1, 0, 0],
}
# SM counts that give one split per stage (16), 3 splits of 6, 6, 4 stages,
# and one split (two at M = 64, whose staged x caps a split at 8 stages)
DECODE_SMS = {132: (16, 1), 8: (3, 6), 2: (1, 16)}


@pytest.mark.parametrize("sms", list(DECODE_SMS))
@pytest.mark.parametrize("m", [1, 5, 8, 64])
@pytest.mark.parametrize("label", list(MASKS))
def test_decode_replay_matches_plain_and_pallas(label, m, sms):
    x, w = _rand((m, K), 51 + m), _rand((K, N), 52) / 16
    mask = np.asarray(MASKS[label], np.float32)
    got, grid = replay_decode(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(mask), sms=sms)
    want_plan = DECODE_SMS[sms] if m < 64 or sms != 2 else (2, 8)
    assert k1.decode_plan(m, K, N, sms) == want_plan
    assert grid == (N // k1.GV_COLS, want_plan[0])
    want = ref.masked_matmul_ref(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(mask))
    _close(got.numpy(), want.numpy())
    _close(got.numpy(), _pallas_fwd(x, w, mask))
    pruned = np.repeat(~(mask > 0), BLOCK_N)
    assert torch.equal(got[:, pruned], torch.zeros_like(got[:, pruned]))


def test_decode_grid_depends_on_shapes_and_sms_only():
    """The plan takes no mask; at serving's shape (M = 8, K = 2048, N =
    8192) on 132 SMs it is 5 splits of 13 stages: 640 blocks with every
    column block kept, 320 with half kept, at least 2 per SM either way."""
    assert list(inspect.signature(k1.decode_plan).parameters) == [
        "m", "k", "n", "sms"]
    assert k1.decode_plan(8, 2048, 8192, SMS) == (5, 13)
    tiles = 8192 // k1.GV_COLS
    assert tiles * 5 >= 4 * SMS and tiles // 2 * 5 >= 2 * SMS
    x, w = _rand((8, K), 3), _rand((K, N), 4)
    grids = {replay_decode(torch.from_numpy(x), torch.from_numpy(w),
                           torch.tensor(mk, dtype=torch.float32))[1]
             for mk in MASKS.values()}
    assert grids == {(N // k1.GV_COLS, 16)}


@pytest.mark.parametrize("m", [1, 8, 9, 16, 17, 33, 64])
@pytest.mark.parametrize("kdim,n", [(2048, 8192), (128, 128), (8192, 2048),
                                    (512, 768)])
@pytest.mark.parametrize("sms", [132, 8, 1])
def test_decode_plan_covers_the_contraction(m, kdim, n, sms):
    """Every stage in exactly one split, none empty; a split's staged x
    within ``GV_X_BYTES``; no split deeper than the 4-blocks-per-SM target
    allows."""
    splits, per = k1.decode_plan(m, kdim, n, sms)
    stages = kdim // k1.GV_BK
    assert 1 <= splits <= stages and (splits - 1) * per < stages <= splits * per
    mt = 1 if m <= 8 else 2 if m <= 16 else 4 if m <= 32 else 8
    assert per * k1.GV_BK * 8 * mt * 4 <= k1.GV_X_BYTES
    want = min(stages, -(-4 * sms // (n // k1.GV_COLS)))
    assert per <= -(-stages // want)
    assert k1.decode_counters(n) % 4 == 0
    assert k1.decode_counters(n) >= n // k1.GV_COLS


# ---------------------------------------------------------------------------
# The GEMM body: K1 in f32 at M > 64 (A = x, K-major) and K3 (A = x.T,
# MN-major), B MN-major for both
# ---------------------------------------------------------------------------

def replay_gemm(a, b, mask, p_len=None, sms=SMS):
    """C[P,Q] = A @ B of the GEMM body, A(p, r) = a[r, p] (a [R, >= P]),
    B(r, q) = b[r, q] (b [R, Q]); ``p_len`` defaults to a's columns.
    Returns C, the grid and each block's kept tiles."""
    r_len = a.shape[0]
    p_len = a.shape[1] if p_len is None else p_len
    q_len = b.shape[1]
    bk, stages = GM_BK, GM_STAGES
    ptiles = -(-p_len // GM_ROWS)
    nb = q_len // GM_COLS
    tiles = ptiles * nb
    nst = -(-r_len // bk)
    grid = min(tiles, sms)
    kcol = [j for j in range(nb) if _kept(mask, j)]
    ktiles = len(kcol) * ptiles
    c = torch.zeros((p_len, q_len))
    writes = torch.zeros((p_len, q_len), dtype=torch.int32)
    walks = []

    def origin(r):                                  # kept tile of rank r
        return (r % ptiles) * GM_ROWS, kcol[r // ptiles] * GM_COLS

    for blk in range(grid):
        for t in range(blk, tiles, grid):           # pruned tiles: zeros
            if not _kept(mask, t // ptiles):
                p0, q0 = (t % ptiles) * GM_ROWS, (t // ptiles) * GM_COLS
                writes[p0:p0 + GM_ROWS, q0:q0 + GM_COLS] += 1
        mine = len(range(blk, ktiles, grid))
        walks.append(mine)
        total = mine * nst
        ring = [None] * stages
        cursor = [blk, 0]                           # producer: tile rank, stage

        def load(slot):
            lt, ls = cursor
            p0, q0 = origin(lt)
            r0 = ls * bk
            at = torch.zeros((GM_ROWS, bk))        # rows past P or R: zero fill
            bt = torch.zeros((bk, GM_COLS))
            p1, r1 = min(p0 + GM_ROWS, p_len), min(r0 + bk, r_len)
            at[:p1 - p0, :r1 - r0] = a[r0:r1, p0:p1].T
            bt[:r1 - r0] = b[r0:r1, q0:q0 + GM_COLS]
            ring[slot] = (lt, ls, at, bt)
            cursor[1] += 1
            if cursor[1] == nst:
                cursor[:] = [lt + grid, 0]

        for s in range(stages - 1):
            if s < total:
                load(s)
        ct, cs = blk, 0
        acc = torch.zeros((GM_ROWS, GM_COLS))
        for g in range(total):
            if g + stages - 1 < total:
                load((g + stages - 1) % stages)
            lt, ls, at, bt = ring[g % stages]
            assert (lt, ls) == (ct, cs)            # the slot holds what is summed
            for k in range(bk):
                acc = acc + at[:, k, None] * bt[None, k, :]
            cs += 1
            if cs == nst:
                p0, q0 = origin(ct)
                p1 = min(p0 + GM_ROWS, p_len)
                c[p0:p1, q0:q0 + GM_COLS] = acc[:p1 - p0]
                writes[p0:p1, q0:q0 + GM_COLS] += 1
                acc = torch.zeros((GM_ROWS, GM_COLS))
                cs, ct = 0, ct + grid
    assert torch.equal(writes, torch.ones_like(writes))   # each output once
    return c, grid, walks


def _pallas_dw(x, dy, w, mask):
    """dw from ``jax.vjp`` of the Pallas ``masked_matmul`` (K3's
    ``_dw_call``), M padded to the 8-row block with zero rows."""
    xp, dyp = _pad_rows(x), _pad_rows(dy)
    _, vjp = jax.vjp(lambda ww: pallas_mm(jnp.asarray(xp), ww,
                                          jnp.asarray(mask), block_m=8,
                                          interpret=True), jnp.asarray(w))
    return np.asarray(vjp(jnp.asarray(dyp))[0])


GEMM_MASKS = {"ones": [1, 1, 1, 1], "rate0.5": [0, 1, 1, 0],
              "zeros": [0, 0, 0, 0], "nan-pruned": [1, float("nan"), 0, 1]}


@pytest.mark.parametrize("sms", [132, 3])
@pytest.mark.parametrize("label", list(GEMM_MASKS))
def test_k1_f32_gemm_replay_matches_plain_and_pallas(label, sms):
    """K1 in f32 at a ragged M = 301 (P: two row tiles, the second 45 rows;
    x^T's pitch 304) over K = 128, N = 512 (8 tiles; 3 SMs: a persistent
    walk of 3, 3 and 2 tiles, fewer when pruned)."""
    m, kdim, n = 301, 128, 512
    x, w = _rand((m, kdim), 61), _rand((kdim, n), 62) / 8
    mask = np.asarray(GEMM_MASKS[label], np.float32)
    assert k1.xt_pitch(m) == 304
    xt = torch.zeros((kdim, k1.xt_pitch(m)))        # transpose_kernel's output
    xt[:, :m] = torch.from_numpy(x).T
    got, grid, _ = replay_gemm(xt, torch.from_numpy(w), torch.from_numpy(mask),
                               p_len=m, sms=sms)
    assert grid == min(8, sms)
    want = ref.masked_matmul_ref(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(mask))
    _close(got.numpy(), want.numpy())
    if not np.isnan(mask).any():
        _close(got.numpy(), _pallas_fwd(x, w, mask))
    pruned = np.repeat(~(mask > 0), BLOCK_N)
    assert torch.equal(got[:, pruned], torch.zeros_like(got[:, pruned]))


@pytest.mark.parametrize("sms", [132, 4])
@pytest.mark.parametrize("label", list(GEMM_MASKS))
def test_k3_gemm_replay_matches_plain_and_pallas(label, sms):
    """K3 at a ragged M = 100 (R: 2 stages, the second 36 rows deep) with K
    = 384 (P: two row tiles, the second 128 rows), N = 512: x read as it
    lies (A = x.T, MN-major)."""
    m, kdim, n = 100, 384, 512
    x, dy = _rand((m, kdim), 71), _rand((m, n), 72)
    w = _rand((kdim, n), 73)
    mask = np.asarray(GEMM_MASKS[label], np.float32)
    got, grid, walks = replay_gemm(torch.from_numpy(x), torch.from_numpy(dy),
                                   torch.from_numpy(mask), sms=sms)
    assert grid == min(8, sms)
    want = ref.masked_matmul_dw_ref(torch.from_numpy(x), torch.from_numpy(dy),
                                    torch.from_numpy(mask))
    _close(got.numpy(), want.numpy())
    if not np.isnan(mask).any():
        _close(got.numpy(), _pallas_dw(x, dy, w, mask))
    pruned = np.repeat(~(mask > 0), BLOCK_N)
    assert torch.equal(got[:, pruned], torch.zeros_like(got[:, pruned]))
    kept_tiles = 2 * int((mask > 0).sum())
    assert sum(walks) == kept_tiles                  # kept tiles, each once
    assert max(walks) - min(walks) <= 1               # spread evenly


@pytest.mark.parametrize("kept", [64, 32, 7, 1, 0])
def test_gemm_walk_at_the_training_shapes(kept):
    """K1 (M = 512: 2 row tiles) and K3 (P = K = 2048: 8 row tiles) over N =
    8192 on 132 SMs, with ``kept`` of the 64 column blocks kept: the grid
    is fixed by the shapes (128 and 132 blocks), and the kept tiles are
    dealt out by rank, so every block's walk is within one tile of the
    others' (all kept, K3: 116 blocks walk 4 tiles and 16 walk 3)."""
    for ptiles in (2, 8):
        tiles = ptiles * 64
        grid = min(tiles, SMS)
        assert grid == (128 if ptiles == 2 else 132)
        walks = [len(range(b, ptiles * kept, grid)) for b in range(grid)]
        assert sum(walks) == ptiles * kept
        assert max(walks) - min(walks) <= 1
        if kept == 64 and ptiles == 8:
            assert walks.count(4) == 116 and walks.count(3) == 16
