"""K2's split contraction and K5's split-S flash-decoding, replayed on the CPU.

``csrc/masked_matmul.cu`` (K2, ``masked_dx_split_kernel``) and
``csrc/decode_attention.cu`` (K5, ``decode_split_kernel``) run only on the
card.  This file replays, in plain PyTorch, what their schedules do, with the
wrappers' own split rules and layout (``masked_matmul.dx_splits`` on an
H100's 132 SMs, ``decode_attention.decode_splits`` and ``decode_layout``),
and the kernels' share and split-length arithmetic (``dx_share``,
``split_rows`` below):

* K2: ``dx_splits`` splits per output tile; split ``s`` contracts over the
  kept N-blocks of ranks ``dx_share(s, splits, kept)`` in mask order, one
  contraction step at a time, into an f32 partial that starts at zero (an
  empty share stays zero); the partials are summed in split order.
* K5: ``decode_splits`` splits of ``split_rows`` cache rows, of which the
  first ``ceil(lengths[b] / rows)`` hold rows; inside a split, 4 warps take
  row steps of ``32 / P`` rows (``P`` lanes a row, 16-byte vectors) in
  batches of ``NB`` steps, each (warp, row group) keeps its own online
  softmax; row groups merge by the xor butterfly, warps in order, the used
  splits in order (one used split is written as it is), and ``acc / max(l,
  1e-30)`` is written; a length of 0 gives zeros.  A split past
  ``lengths[b]``, and a row at or past it, is never read.

Each replay is held to the port's plain version (``ref``) and to the JAX
package's Pallas kernels in interpret mode, in f32 at 1e-5 relative to
max(1, max |reference|): the sums run in another order.  Inputs come from
numpy seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.masked_matmul import masked_matmul as pallas_mm
from repro_torch.kernels import decode_attention as k5
from repro_torch.kernels import masked_matmul as k2
from repro_torch.kernels import ref
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5
BLOCK_N = 128                       # mask block
WARPS = 4                           # K5's warps per block
SMS = 132                           # an H100's SMs


def dx_share(split, splits, kept):
    """``masked_dx_split_kernel``'s share: ranks ``[lo, hi)`` of the kept
    N-blocks that split ``split`` contracts over."""
    return split * kept // splits, (split + 1) * kept // splits


def split_rows(s, splits):
    """``decode_split_kernel``'s split length: split ``i`` covers cache rows
    ``[i * rows, (i + 1) * rows)``, cut at S and at the length."""
    return -(-s // splits)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()) if want.size else 0.0)
    np.testing.assert_allclose(got, want, atol=TOL * scale, rtol=0)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

def replay_dx(dy, w, mask, sms=SMS):
    """K2's arithmetic on dy [M,N], w [K,N], mask [N/128] (f32 tensors)."""
    m, n = dy.shape
    kdim = w.shape[0]
    splits = k2.dx_splits(m, kdim, n, sms)
    kept_blocks = [j for j in range(n // BLOCK_N) if float(mask[j]) > 0]
    parts = []
    for s in range(splits):
        lo, hi = dx_share(s, splits, len(kept_blocks))
        part = torch.zeros((m, kdim), dtype=torch.float32)
        for j in kept_blocks[lo:hi]:
            for r in range(j * BLOCK_N, (j + 1) * BLOCK_N):
                part += dy[:, r, None] * w[None, :, r]
        parts.append(part)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out, splits


def _pallas_dx(dy, w, mask):
    """dx from ``jax.vjp`` of the Pallas ``masked_matmul`` (K2's
    ``_dx_call``), M padded to the 8-row block with zero rows."""
    m = dy.shape[0]
    mp = -(-m // 8) * 8
    dyp = np.zeros((mp, dy.shape[1]), np.float32)
    dyp[:m] = dy
    x = jnp.zeros((mp, w.shape[0]), jnp.float32)
    _, vjp = jax.vjp(lambda a: pallas_mm(a, jnp.asarray(w), jnp.asarray(mask),
                                         block_m=8, interpret=True), x)
    return np.asarray(vjp(jnp.asarray(dyp))[0])[:m]


K, N = 256, 768                     # 2 dx tiles, 6 mask blocks
MASKS = {
    "ones": [1, 1, 1, 1, 1, 1],
    "rate0.5": [1, 0, 1, 0, 0, 1],
    "zeros": [0, 0, 0, 0, 0, 0],
    "one-kept": [0, 0, 0, 1, 0, 0],
    "five-kept": [1, 1, 0, 1, 1, 1],
    "nan-pruned": [1, float("nan"), 1, 1, 0, 1],
}
# SM counts that give 6 splits (one per N-block: fewer kept than splits),
# 4 (5 kept: not divisible) and 1
SPLITS = {132: 6, 8: 4, 2: 1}


@pytest.mark.parametrize("sms", list(SPLITS))
@pytest.mark.parametrize("m", [17, 5])
@pytest.mark.parametrize("label", list(MASKS))
def test_dx_replay_matches_plain_and_pallas(label, m, sms):
    dy, w = _rand((m, N), 41), _rand((K, N), 42) / 16
    mask = np.asarray(MASKS[label], np.float32)
    got, splits = replay_dx(torch.from_numpy(dy), torch.from_numpy(w),
                            torch.from_numpy(mask), sms=sms)
    assert splits == SPLITS[sms]
    want = ref.masked_matmul_dx_ref(torch.from_numpy(dy), torch.from_numpy(w),
                                    torch.from_numpy(mask))
    _close(got.numpy(), want.numpy())
    if not np.isnan(mask).any():
        _close(got.numpy(), _pallas_dx(dy, w, mask))
    if not (mask > 0).any():
        assert torch.equal(got, torch.zeros_like(got))   # exact zeros


def test_dx_splits_at_the_training_shape():
    """4 splits of 32 tiles give one block on each of 128 of the 132 SMs;
    ragged M keeps the tile count; a larger M needs no split."""
    assert k2.dx_splits(512, 2048, 8192, SMS) == 4
    assert k2.dx_splits(500, 2048, 8192, SMS) == 4
    assert k2.dx_splits(4096, 2048, 8192, SMS) == 1
    assert k2.dx_splits(8, 128, 256, SMS) == 2      # at most one per N-block


@pytest.mark.parametrize("kept,splits", [(0, 4), (1, 4), (3, 4), (7, 4),
                                         (64, 4), (5, 5), (64, 3)])
def test_dx_shares_cover_the_kept_blocks_once(kept, splits):
    bounds = [dx_share(s, splits, kept) for s in range(splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == kept
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    sizes = [hi - lo for lo, hi in bounds]
    assert max(sizes) - min(sizes) <= 1


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------

def _merge(a, b):
    """Two online-softmax states (m, l, acc) -> one, as the kernel merges
    row groups (symmetric: either order gives the same bits)."""
    (m1, l1, a1), (m2, l2, a2) = a, b
    mn = torch.maximum(m1, m2)
    f1, f2 = torch.exp(m1 - mn), torch.exp(m2 - mn)
    return mn, l1 * f1 + l2 * f2, a1 * f1[..., None] + a2 * f2[..., None]


def _ordered(states):
    """Merge states in order, from m = -1e30, as the warp and split merges
    do; returns (m, l, acc)."""
    mx = torch.full_like(states[0][0], -1e30)
    for m, _, _ in states:
        mx = torch.maximum(mx, m)
    lsum = torch.zeros_like(states[0][1])
    asum = torch.zeros_like(states[0][2])
    for m, l, a in states:
        f = torch.exp(m - mx)
        lsum = lsum + l * f
        asum = asum + a * f[..., None]
    return mx, lsum, asum


def replay_decode(q, k, v, lengths, elt=4):
    """K5's arithmetic on q [B,1,H,hd], k/v [B,S,KV,hd] (f32), lengths int
    [B] or None, with the lane layout of a kernel of ``elt``-byte elements.
    Returns [B,1,H,hd] and the split count."""
    b, _, h, hd = q.shape
    s_len, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / np.sqrt(hd)
    splits = k5.decode_splits(s_len)
    rows = split_rows(s_len, splits)
    _, p, nb = k5.decode_layout(hd, elt, g)
    r = 32 // p                                   # rows a warp step
    lens = (torch.full((b,), s_len) if lengths is None
            else lengths.long().clamp(0, s_len))
    qg = q[:, 0].reshape(b, g, kvh, hd).transpose(1, 2)           # [B,KV,G,hd]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)                 # [B,KV,S,hd]
    empty = (torch.full((b, kvh, g), -1e30), torch.zeros((b, kvh, g)),
             torch.zeros((b, kvh, g, hd)))
    partials = []
    for s in range(splits):
        r0 = s * rows
        r1 = torch.clamp(torch.clamp(lens, max=min(r0 + rows, s_len)), min=r0)
        steps = -(-(min(r0 + rows, s_len) - r0) // r)
        groups = []
        for warp in range(WARPS):
            per_rg = []
            for rg in range(r):
                m, l, acc = (t.clone() for t in empty)
                for st0 in range(warp * nb, steps, WARPS * nb):
                    for st in range(st0, st0 + nb):
                        row = r0 + st * r + rg
                        valid = row < r1                           # [B]
                        if row >= s_len or not valid.any():
                            continue
                        kr = torch.where(valid[:, None, None], kt[:, :, row], 0.0)
                        vr = torch.where(valid[:, None, None], vt[:, :, row], 0.0)
                        sc = (qg * kr[:, :, None]).sum(-1) * scale  # [B,KV,G]
                        m_new = torch.maximum(m, sc)
                        alpha, pr = torch.exp(m - m_new), torch.exp(sc - m_new)
                        upd = (m_new, l * alpha + pr,
                               acc * alpha[..., None] + pr[..., None]
                               * vr[:, :, None])
                        keep = valid[:, None, None]
                        m = torch.where(keep, upd[0], m)
                        l = torch.where(keep, upd[1], l)
                        acc = torch.where(keep[..., None], upd[2], acc)
                per_rg.append((m, l, acc))
            off = 1                                   # the xor butterfly
            while off < r:
                per_rg = [_merge(per_rg[i], per_rg[i ^ off]) for i in range(r)]
                off *= 2
            groups.append(per_rg[0])
        partials.append(_ordered(groups))
    outs = []
    for i in range(b):
        used = -(-int(lens[i]) // rows) if rows else 0   # splits with rows
        if used == 0:
            outs.append(torch.zeros((kvh, g, hd)))
            continue
        mine = [tuple(t[i] for t in part) for part in partials[:used]]
        _, lsum, asum = mine[0] if used == 1 else _ordered(mine)
        outs.append(asum / lsum.clamp_min(1e-30)[..., None])
    out = torch.stack(outs)                                       # [B,KV,G,hd]
    return out.transpose(1, 2).reshape(b, 1, h, hd), splits


def _decode_inputs(b, s, kvh, g, hd, lengths, seed):
    """q, k, v (numpy f32); cache rows at or past each length hold NaN (K)
    and 1e4 (V), as ``chip_smoke.py`` fills them."""
    q = _rand((b, 1, g * kvh, hd), seed)
    k = _rand((b, s, kvh, hd), seed + 1)
    v = _rand((b, s, kvh, hd), seed + 2)
    stale_k, stale_v = k.copy(), v.copy()
    if lengths is not None:
        for i, n in enumerate(lengths):
            stale_k[i, n:] = np.nan
            stale_v[i, n:] = 1e4
    return q, k, v, stale_k, stale_v


def _pallas(q, k, v, lengths):
    s = k.shape[1]
    block = max(d for d in range(1, min(s, 512) + 1) if s % d == 0)
    return np.asarray(pallas_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if lengths is None else jnp.asarray(lengths, jnp.int32),
        block_k=block, interpret=True))


def _edges(s, splits):
    """Lengths at the edges of the split schedule: 0, S, a split boundary,
    one row into the next split, one row short of a boundary, 1."""
    rows = split_rows(s, splits)
    return [0, s, rows, rows + 1, 2 * rows - 1, 1]


# b, S, KV, G, hd
DECODE = [
    (6, 256, 2, 1, 32),         # R = 4 rows a step (f32), 8 (bf16)
    (6, 500, 2, 1, 32),         # S = 500: 4 splits of 125
    (6, 301, 2, 1, 32),         # ragged last split: 101, 101, 99 rows
    (6, 256, 1, 4, 64),         # G = 4: one K/V row for 4 query rows
    (6, 200, 2, 3, 64),         # G = 3 in a 4-row block
]


@pytest.mark.parametrize("elt", [4, 2], ids=["f32-lanes", "bf16-lanes"])
@pytest.mark.parametrize("b,s,kvh,g,hd", DECODE,
                         ids=[f"B{c[0]}-S{c[1]}-KV{c[2]}-G{c[3]}-hd{c[4]}"
                              for c in DECODE])
def test_decode_replay_matches_plain_and_pallas(b, s, kvh, g, hd, elt):
    splits = k5.decode_splits(s)
    lengths = _edges(s, splits)
    q, k, v, sk, sv = _decode_inputs(b, s, kvh, g, hd, lengths, seed=s + hd)
    lt = torch.tensor(lengths, dtype=torch.int32)
    got, n = replay_decode(*(torch.from_numpy(a) for a in (q, sk, sv)), lt,
                           elt=elt)
    assert n == splits > 1
    assert torch.isfinite(got).all()                 # stale rows never read
    want = ref.decode_attention_ref(*(torch.from_numpy(a) for a in (q, sk, sv)),
                                    lt)
    _close(got.numpy(), want.numpy())
    _close(got.numpy(), _pallas(q, k, v, lengths))
    assert torch.equal(got[0], torch.zeros_like(got[0]))   # length 0


@pytest.mark.parametrize("s", [256, 500])
def test_decode_replay_without_lengths(s):
    b, kvh, g, hd = 2, 2, 2, 32
    q, k, v, _, _ = _decode_inputs(b, s, kvh, g, hd, None, seed=s)
    got, _ = replay_decode(*(torch.from_numpy(a) for a in (q, k, v)), None)
    _close(got.numpy(), ref.decode_attention_ref(
        *(torch.from_numpy(a) for a in (q, k, v))).numpy())
    _close(got.numpy(), _pallas(q, k, v, None))


def test_decode_replay_at_the_serving_shape():
    """8 slots, S = 512, 16 kv heads of 128: 4 splits of 128 rows, ragged
    lengths with stale NaN/1e4 rows, f32 lanes (one row a step)."""
    b, s, kvh, g, hd = 8, 512, 16, 1, 128
    assert k5.decode_splits(s) == 4 and split_rows(s, 4) == 128
    lengths = [0, 512, 128, 129, 1, 300, 127, 449]
    q, _, _, sk, sv = _decode_inputs(b, s, kvh, g, hd, lengths, seed=7)
    lt = torch.tensor(lengths, dtype=torch.int32)
    args = [torch.from_numpy(a) for a in (q, sk, sv)]
    got, _ = replay_decode(*args, lt)
    assert torch.isfinite(got).all()
    _close(got.numpy(), ref.decode_attention_ref(*args, lt).numpy())


def test_decode_splits_depend_on_shapes_only():
    assert k5.decode_splits(512) == 4                 # 512 blocks at serving
    assert k5.decode_splits(500) == 4 and split_rows(500, 4) == 125
    assert k5.decode_splits(129) == 2 and split_rows(129, 2) == 65
    assert k5.decode_splits(128) == 1 and k5.decode_splits(8) == 1
    assert k5.decode_splits(0) == 1 and split_rows(0, 1) == 0


@pytest.mark.parametrize("hd,elt,g,want", [
    (128, 2, 1, (1, 16, 8)),    # serving: bf16, 2 rows a warp step
    (128, 4, 1, (1, 32, 8)),    # the f32 parity decode: 1 row a step
    (128, 2, 4, (4, 16, 4)),    # G > 1: 4 query rows a block
    (32, 4, 1, (1, 8, 8)),
    (512, 2, 1, (1, 32, 4)),    # two vectors a lane
    (96, 2, 3, (4, 16, 4)),     # 12 vectors a row: 16 lanes, 4 idle
])
def test_decode_layout(hd, elt, g, want):
    assert k5.decode_layout(hd, elt, g) == want
