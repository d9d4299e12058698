"""The bf16 tensor-core flash attention (K4), its schedule replayed on the CPU.

``src/repro_torch/kernels/csrc/flash_attention.cu`` runs bf16 attention as
wgmma products only on the card.  This file replays, in plain PyTorch and at
the kernel's own tile sizes, what that kernel does:

* 128-row query tiles, each split between two consumers of 64 rows; the
  block loads only the 64-key kv tiles that some of its rows see;
* each consumer classifies every loaded kv tile against its own rows as
  hidden (skipped), fully visible (no mask) or masked, with the kernel's
  formulas (``seen_keys``, ``classify``), checked here against the exact
  mask;
* S from bf16 operands with f32 sums, the scale applied after the product
  (folded with log2(e)), an online softmax in base 2 from a running max of
  -1e30;
* P split into P_hi + P_lo, both bf16, each multiplied with V and added into
  one f32 accumulator; rows past Sq or Skv zero-filled as TMA fills them.

The replay is held to the port's plain version (``ref.flash_attention_ref``)
under ``chip_smoke.py``'s per-element bf16 rule, and to the JAX package's
Pallas kernel in interpret mode in f32 at 2e-5, for causal attention with
windows None / 300 / 4096, ragged Sq and Skv, and one non-causal case.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import ref
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

BQ, ROWS, BK = 128, 64, 64          # query tile, consumer rows, kv tile
HIDDEN, FULL, MASKED = 0, 1, 2
LOG2E = 1.4426950408889634
BF16_STEP = 2.0 ** -7               # chip_smoke.py's per-element bf16 rule
F32_TOL = 2e-5                      # the f32 allowance of that rule


def seen_keys(lo, hi, skv, causal, window):
    """The kernel's ``seen_keys``: keys [kmin, kmax] some row in [lo, hi]
    sees (empty when kmin > kmax)."""
    kmin = max(0, lo - window + 1) if window > 0 else 0
    kmax = min(hi, skv - 1) if causal else skv - 1
    return kmin, kmax


def classify(lo, hi, k0, k1, skv, causal, window):
    """The kernel's ``classify`` of rows [lo, hi] against keys [k0, k1]."""
    if hi < lo:
        return HIDDEN
    kmin, kmax = seen_keys(lo, hi, skv, causal, window)
    if kmin > kmax or k0 > kmax or k1 < kmin:
        return HIDDEN
    full = (k1 < skv and (not causal or k1 <= lo)
            and (window <= 0 or k0 > hi - window))
    return FULL if full else MASKED


def visible(qpos, kpos, skv, causal, window):
    qpos, kpos = torch.broadcast_tensors(qpos, kpos)
    ok = kpos < skv
    if causal:
        ok = ok & (kpos <= qpos)
    if window > 0:
        ok = ok & (kpos > qpos - window)
    return ok


def _rows(x, start, n):
    """x[:, :, start:start + n] with the rows past the end as zeros (TMA's
    out-of-bounds fill)."""
    part = x[:, :, start:start + n]
    pad = n - part.shape[2]
    return torch.nn.functional.pad(part, (0, 0, 0, pad)) if pad else part


def emulate(q, k, v, *, causal=True, window=None):
    """The bf16 kernel's arithmetic on q [B,Sq,H,hd], k/v [B,Skv,KV,hd]
    (float32 tensors holding bf16 values).  Returns the f32 output before
    its final bf16 rounding and the count of each tile kind."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    win = 0 if window is None else int(window)
    scale_log2 = np.float32(np.float32(1.0 / math.sqrt(hd))
                            * np.float32(LOG2E))
    heads = torch.tensor([i % kvh for i in range(h)])
    qh = q.transpose(1, 2)                                 # [B,H,Sq,hd]
    kh = k[:, :, heads].transpose(1, 2)                    # [B,H,Skv,hd]
    vh = v[:, :, heads].transpose(1, 2)
    out = torch.zeros((b, h, sq, hd), dtype=torch.float32)
    kinds = {HIDDEN: 0, FULL: 0, MASKED: 0}
    for q0 in range(0, sq, BQ):
        kmin, kmax = seen_keys(q0, min(q0 + BQ, sq) - 1, skv, causal, win)
        kt_begin = kmin // BK
        kt_end = kmax // BK + 1 if kmin <= kmax else kt_begin
        for lo in (q0, q0 + ROWS):
            hi = min(lo + ROWS - 1, sq - 1)
            rows = torch.arange(lo, lo + ROWS)
            valid = rows < sq
            qt = _rows(qh, lo, ROWS)
            m = torch.full((b, h, ROWS), -1e30)
            l = torch.zeros((b, h, ROWS))
            o = torch.zeros((b, h, ROWS, hd))
            for kt in range(kt_begin, kt_end):
                k0 = kt * BK
                kind = classify(lo, hi, k0, k0 + BK - 1, skv, causal, win)
                kinds[kind] += 1
                vis = visible(rows[:, None], torch.arange(k0, k0 + BK)[None],
                              skv, causal, win)
                if kind == HIDDEN:
                    assert not vis[valid].any(), (lo, k0)
                    continue
                if kind == FULL:
                    assert vis[valid].all(), (lo, k0)
                t = (qt @ _rows(kh, k0, BK).transpose(-1, -2)) * scale_log2
                if kind == MASKED:
                    t = t.masked_fill(~vis, -math.inf)
                m_new = torch.maximum(m, t.amax(-1))
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(t - m_new[..., None])
                l = l * alpha + p.sum(-1)
                p_hi = p.to(torch.bfloat16).float()
                p_lo = (p - p_hi).to(torch.bfloat16).float()
                vt = _rows(vh, k0, BK)
                o = o * alpha[..., None] + p_hi @ vt + p_lo @ vt
                m = m_new
            res = o / l.clamp_min(1e-30)[..., None]
            out[:, :, lo:lo + ROWS] = res[:, :, valid]
    return out.transpose(1, 2), kinds


def _inputs(b, sq, skv, h, kvh, hd, seed):
    """Standard normal q, k, v rounded to bf16 (what the kernel reads)."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(torch.bfloat16) for shape in ((b, sq, h, hd), (b, skv, kvh, hd),
                                              (b, skv, kvh, hd))]


def _block(n):
    """A Pallas block size that divides n (its kernel takes no ragged end)."""
    return max(d for d in range(1, min(n, 1024) + 1) if n % d == 0)


# b, Sq, Skv, H, KV, hd, window, causal
CASES = [
    (2, 384, 384, 4, 2, 64, None, True),       # GQA, whole tiles
    (2, 640, 640, 2, 1, 128, 300, True),       # a window inside the tiles
    (1, 4352, 4352, 1, 1, 64, 4096, True),     # zamba2's window, cut
    (2, 200, 200, 2, 2, 128, None, True),      # ragged S
    (2, 333, 250, 2, 1, 64, 300, True),        # ragged, rows past Skv
    (2, 100, 300, 2, 2, 64, None, True),       # Sq < Skv, one half-empty tile
    (2, 130, 260, 2, 1, 128, None, False),     # non-causal, ragged
]
IDS = [f"B{c[0]}-Sq{c[1]}-Skv{c[2]}-H{c[3]}-KV{c[4]}-hd{c[5]}-w{c[6]}"
       f"{'' if c[7] else '-noncausal'}" for c in CASES]


@pytest.mark.parametrize("b,sq,skv,h,kvh,hd,window,causal", CASES, ids=IDS)
def test_bf16_schedule_matches_the_plain_version(b, sq, skv, h, kvh, hd,
                                                 window, causal):
    q, k, v = _inputs(b, sq, skv, h, kvh, hd, seed=sq + skv + hd)
    got, kinds = emulate(q.float(), k.float(), v.float(), causal=causal,
                         window=window)
    got = got.to(torch.bfloat16).float()
    want = ref.flash_attention_ref(q, k, v, causal=causal,
                                   window=window).float()
    allowed = BF16_STEP * want.abs() + F32_TOL * max(
        1.0, float(want.abs().max()))
    worst = float(((got - want).abs() / allowed).max())
    assert worst <= 1.0, (worst, kinds)
    assert kinds[FULL] + kinds[MASKED] > 0
    if window is not None and sq > window + BQ:
        assert kinds[HIDDEN] > 0 and kinds[FULL] > kinds[MASKED], kinds


@pytest.mark.parametrize("b,sq,skv,h,kvh,hd,window,causal", CASES, ids=IDS)
def test_f32_schedule_matches_pallas(b, sq, skv, h, kvh, hd, window, causal):
    q, k, v = (t.float() for t in _inputs(b, sq, skv, h, kvh, hd,
                                          seed=sq + skv + hd + 1))
    got, _ = emulate(q, k, v, causal=causal, window=window)
    want = pallas_flash(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                        causal=causal, window=window, block_q=_block(sq),
                        block_k=_block(skv), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=F32_TOL)


@pytest.mark.parametrize("skv,causal,window", [
    (300, True, 0), (300, True, 1), (300, True, 100), (300, False, 70),
    (1000, True, 4096), (97, True, 130), (97, False, 0)])
def test_tile_kinds_are_exact(skv, causal, window):
    """``seen_keys`` spans exactly the keys some row sees, and ``classify``
    calls a tile hidden only when no row sees any of its keys and fully
    visible only when every row sees every key, for every row range the
    kernel forms (including ranges cut by Sq) and every kv tile."""
    sq = 320
    for lo in range(0, sq, ROWS):
        for hi in (lo + ROWS - 1, min(lo + ROWS - 1, sq - 1), lo + 5, lo - 1):
            rows = torch.arange(lo, hi + 1)
            keys = torch.arange(0, max(skv, 1) + 2 * BK)
            vis = visible(rows[:, None], keys[None], skv, causal, window)
            kmin, kmax = seen_keys(lo, hi, skv, causal, window)
            seen = vis.any(0).nonzero().flatten()
            if len(seen):
                assert (int(seen.min()), int(seen.max())) == (kmin, kmax)
                assert len(seen) == kmax - kmin + 1
            else:
                assert kmin > kmax or hi < lo
            for k0 in range(0, skv + BK, BK):
                part = vis[:, k0:k0 + BK]
                kind = classify(lo, hi, k0, k0 + BK - 1, skv, causal, window)
                assert kind == (HIDDEN if not part.any() else
                                FULL if part.all() else MASKED), (lo, hi, k0)
