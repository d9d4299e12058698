"""K6's chunked SSD scan, replayed on the CPU.

``csrc/ssd_scan.cu`` runs only on the card.  This file replays, in plain
PyTorch, the arithmetic of its three passes at the kernel's own chunk
(``ssd_scan.KERNEL_CHUNK``), with the splits its tensor-core products use:

* pass 1: per chunk c < nc-1 and head, cum = the prefix sum of la = -dtv
  exp(a_log) in the chunk (steps past S count dtv = 0), total_c = cum_{Q-1},
  and S_c = (w x)^T B with w_j = exp(total_c - cum_j) dtv_j;
* pass 2: H_c = exp(total_c) H_{c-1} + S_c, the state entering chunk c + 1;
* pass 3: y = 2^(c2_i) C H^T + G X + D x with c2 = cum log2(e) and
  G_ij = (C B^T)_ij 2^(c2_i - c2_j) dtv_j for j <= i, else 0.

In bf16 a product of two bf16 inputs is exact in f32, and an f32-valued
operand (w x, G, H) is split v = hi + lo, both bf16 (two products).  In f32
every product is 3xTF32: each operand split big + small (tf32, rounded to
nearest, ties away), three products.  The replay is held to the port's
plain version (``ref.ssd_scan_ref``), its chunked scan
(``layers._ssd_chunk_scan``) and the JAX package's Pallas kernel in
interpret mode: f32 at 2e-4 relative to max(1, max |plain|)
(``tests/test_kernels.py``'s number), bf16 per element at 2^-7 |plain|
(one bf16 step: both sides round once to bf16) plus that allowance.
Inputs come from numpy seeds.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as k6
from repro_torch.models import layers
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 2e-4
BF16_STEP = 2.0 ** -7
LOG2E = 1.4426950408889634
NH, P, N = 2, 64, 64          # zamba2's p and N (the kernel takes p = 8k, N = 64)


def bf16_split(v):
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def tf32(v):
    """Round f32 to tf32 (10 mantissa bits), to nearest, ties away from 0:
    ``cvt.rna.tf32.f32``."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(v):
    big = tf32(v)
    return big, tf32(v - big)


def product(a, b, kind, a_split=False, b_split=False):
    """a @ b as the kernel's tensor cores sum it (in f32): ``kind`` "bf16"
    splits the f32-valued side(s) into hi + lo; "f32" is 3xTF32.  The
    ``*_unsplit`` kinds drop the splits (bf16 hi parts only; one tf32
    product), which the kernel does not do."""
    if kind == "f32_unsplit":
        return tf32(a) @ tf32(b)
    if kind == "f32":
        (ab, as_), (bb, bs) = tf32_split(a), tf32_split(b)
        return as_ @ bb + ab @ bs + ab @ bb
    (ahi, alo), (bhi, blo) = bf16_split(a), bf16_split(b)
    out = ahi @ bhi
    if kind == "bf16_unsplit":
        return out
    if a_split:
        out = out + alo @ bhi
    if b_split:
        out = out + ahi @ blo
    return out


def replay(x, bmat, cmat, dt, a_log, d, dt_bias, split=True):
    """The kernel's three passes on CPU tensors -> y in x's type (with
    ``split=False``, without the splits of its f32-valued operands)."""
    kind = "bf16" if x.dtype == torch.bfloat16 else "f32"
    kind = kind if split else kind + "_unsplit"
    q = k6.KERNEL_CHUNK[x.dtype]
    bsz, s, nh, p = x.shape
    n = bmat.shape[-1]
    nc = -(-s // q)
    pad = nc * q - s
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
    bf = torch.nn.functional.pad(bmat.float(), (0, 0, 0, pad))
    cf = torch.nn.functional.pad(cmat.float(), (0, 0, 0, pad))
    dtv = ref.softplus(dt.float() + dt_bias)
    dtv = torch.nn.functional.pad(dtv, (0, 0, 0, pad))        # dtv = 0 past S
    la = -dtv * torch.exp(a_log)
    y = torch.empty((bsz, nc * q, nh, p))
    for b in range(bsz):
        cum = la[b].reshape(nc, q, nh).cumsum(1)                # [nc, Q, nh]
        total = cum[:, -1]                                      # [nc, nh]
        dv = dtv[b].reshape(nc, q, nh)
        xc = xf[b].reshape(nc, q, nh, p)
        bc, cc = bf[b].reshape(nc, q, n), cf[b].reshape(nc, q, n)
        states = torch.zeros((nc, nh, p, n))                    # entering chunk c
        h = torch.zeros((nh, p, n))
        for c in range(nc - 1):                                 # passes 1, 2
            w = torch.exp(total[c] - cum[c]) * dv[c]            # [Q, nh]
            for hd in range(nh):
                s_c = product((xc[c, :, hd] * w[:, hd, None]).T, bc[c], kind,
                              a_split=True)
                h[hd] = torch.exp(total[c, hd]) * h[hd] + s_c
            states[c + 1] = h
        mask = torch.ones((q, q), dtype=torch.bool).tril()
        for c in range(nc):                                     # pass 3
            cb = product(cc[c], bc[c].T, kind)
            c2 = cum[c] * LOG2E                                 # f32, as the kernel
            for hd in range(nh):
                diff = c2[:, None, hd] - c2[None, :, hd]
                g = torch.where(mask, torch.exp2(torch.where(mask, diff, 0.0))
                                * (cb * dv[c, None, :, hd]), 0.0)
                acc = torch.zeros((q, p))
                if c > 0:
                    acc = product(cc[c], states[c, hd].T, kind, b_split=True) \
                        * torch.exp2(c2[:, hd, None])
                acc = acc + product(g, xc[c, :, hd], kind, a_split=True)
                y[b, c * q:(c + 1) * q, hd] = acc + d[hd] * xc[c, :, hd]
    return y[:, :s].to(x.dtype)


def _inputs(b, s, seed, dtype, slow=False, p=P):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, NH, p))
    bm, cm = rng.standard_normal((b, s, N)), rng.standard_normal((b, s, N))
    dt = (0.5 if slow else 1.0) * rng.standard_normal((b, s, NH))
    a_log = np.zeros(NH) if slow else 0.1 * rng.standard_normal(NH)
    d = rng.standard_normal(NH)
    dt_bias = (np.linspace(-7.0, -3.0, NH) if slow
               else rng.standard_normal(NH))
    big = [torch.from_numpy(a.astype(np.float32)).to(dtype)
           for a in (x, bm, cm, dt)]
    small = [torch.from_numpy(a.astype(np.float32)) for a in (a_log, d, dt_bias)]
    return big + small


def _hold(got, want, dtype):
    """|got - want| <= 2e-4 max(1, max |want|), plus 2^-7 |want| in bf16."""
    got, want = got.float(), want.float()
    allowed = TOL * max(1.0, float(want.abs().max()))
    if dtype == torch.bfloat16:
        allowed = allowed + BF16_STEP * want.abs()
    err = (got - want).abs()
    assert bool((err <= allowed).all()), float((err / allowed).max())


def _chunk(s, chunk=128):
    """``apply_mamba2``'s chunk for ``layers._ssd_chunk_scan``."""
    c = min(chunk, s)
    return c if s % c == 0 else math.gcd(s, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("offset", ["Q-1", "Q", "Q+1", "3Q+5"])
def test_replay_matches_the_sequential_definition(offset, b, dtype):
    q = k6.KERNEL_CHUNK[dtype]
    s = {"Q-1": q - 1, "Q": q, "Q+1": q + 1, "3Q+5": 3 * q + 5}[offset]
    args = _inputs(b, s, 100 + s + b, dtype)
    _hold(replay(*args), ref.ssd_scan_ref(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("p", [32, 96])
def test_replay_at_other_head_dims(p, dtype):
    """The kernel takes any p that is a multiple of 8, as sub-heads of 64
    columns (the rows of p are independent, so this changes no sum)."""
    q = k6.KERNEL_CHUNK[dtype]
    args = _inputs(1, q + 1, 400 + p, dtype, p=p)
    _hold(replay(*args), ref.ssd_scan_ref(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_replay_carries_a_slow_decay_across_chunks(dtype):
    """a_log 0, dt_bias -7..-3: the state lives for 20 to 1000 steps, so
    what passes 1 and 2 carry from chunk to chunk decides y."""
    q = k6.KERNEL_CHUNK[dtype]
    s = 4 * q + 3
    args = _inputs(1, s, 7, dtype, slow=True)
    want = ref.ssd_scan_ref(*args)
    tail = ref.ssd_scan_ref(*(t[:, s - q:] for t in args[:4]), *args[4:])
    assert float((want[:, s - q:].float() - tail.float()).abs().max()) > 0.5
    _hold(replay(*args), want, dtype)


@pytest.mark.parametrize("s", ["Q-1", "Q+1", "2Q"])
def test_f32_replay_matches_chunked_scan_and_pallas(s):
    """f32: the replay against the port's chunked scan and the JAX Pallas
    kernel in interpret mode (chunk = S when S is not a multiple of 64)."""
    q = k6.KERNEL_CHUNK[torch.float32]
    s = {"Q-1": q - 1, "Q+1": q + 1, "2Q": 2 * q}[s]
    args = _inputs(2, s, 200 + s, torch.float32)
    got = replay(*args)
    _hold(got, layers._ssd_chunk_scan(*args, _chunk(s)), torch.float32)
    jargs = [jnp.asarray(a.numpy()) for a in args]
    chunk = 64 if s % 64 == 0 else s
    want = pallas_ssd(*jargs, chunk=chunk, interpret=True)
    _hold(got, torch.from_numpy(np.array(want)), torch.float32)
    _hold(got, torch.from_numpy(np.array(jref.ssd_scan_ref(*jargs))),
          torch.float32)


def test_bf16_replay_matches_pallas():
    """bf16 inputs: the replay against the JAX Pallas kernel (interpret
    mode), both rounding y once to bf16."""
    q = k6.KERNEL_CHUNK[torch.bfloat16]
    args = _inputs(1, 2 * q, 300, torch.bfloat16)
    jargs = [jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
             for a in args[:4]] + [jnp.asarray(a.numpy()) for a in args[4:]]
    want = pallas_ssd(*jargs, chunk=64, interpret=True)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    _hold(replay(*args), want.to(torch.bfloat16), torch.bfloat16)


def test_splits_are_what_the_precision_needs():
    """The replay's splits are not decoration: without them (bf16 w x, G
    and H; single tf32 products) the slow-decay inputs miss the kernel
    checks' tolerance in both types, with them they hold; and each split
    recovers its operand to the precision the tolerance needs."""
    for dtype in (torch.float32, torch.bfloat16):
        q = k6.KERNEL_CHUNK[dtype]
        args = _inputs(1, 2 * q + 3, 7, dtype, slow=True)
        want = ref.ssd_scan_ref(*args)
        _hold(replay(*args), want, dtype)
        with pytest.raises(AssertionError):
            _hold(replay(*args, split=False), want, dtype)
    v = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (64, 64)).astype(np.float32))
    hi, lo = bf16_split(v)
    assert float((hi + lo - v).abs().max()) < 2.0 ** -15 * float(v.abs().max())
    big, small = tf32_split(v)
    assert float((big + small - v).abs().max()) < 2.0 ** -20 * float(
        v.abs().max())
    w = v.T.contiguous()
    exact = (v.double() @ w.double()).float()
    one = tf32(v) @ tf32(w)
    three = product(v, w, "f32")
    scale = float(exact.abs().max())
    assert float((one - exact).abs().max()) > TOL * scale / 10
    assert float((three - exact).abs().max()) < 1e-6 * scale


# ---------------------------------------------------------------------------
# strided inputs: the kernel reads apply_mamba2's split views in place
# ---------------------------------------------------------------------------

def _split_views(b, s, dtype, seed=11):
    """x, B, C, dt as ``apply_mamba2`` has them: x, B, C are ``torch.split``
    views of the conv output [B, S, nh*p + 2N], dt one of the fused
    projection [B, S, 2 nh*p + 2N + nh]."""
    rng = np.random.default_rng(seed)

    def rand(width):
        return torch.from_numpy(rng.standard_normal((b, s, width)).astype(
            np.float32)).to(dtype)

    xi, bm, cm = torch.split(rand(NH * P + 2 * N), [NH * P, N, N], dim=-1)
    dt = torch.split(rand(2 * NH * P + 2 * N + NH), [2 * NH * P + 2 * N, NH],
                     dim=-1)[1]
    return xi.reshape(b, s, NH, P), bm, cm, dt


def _as_the_kernel_reads(t, row):
    """``t`` [B, S, ...] read as the kernel reads it: step s of batch b
    starts ``(b*S + s) * row`` elements past the first, its elements
    contiguous."""
    inner = t.shape[2:]
    strides = [1] * len(inner)
    for i in range(len(inner) - 2, -1, -1):
        strides[i] = strides[i + 1] * inner[i + 1]
    return torch.as_strided(t, t.shape, (t.shape[1] * row, row, *strides),
                            t.storage_offset())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_strided_views_equal_contiguous_inputs(dtype):
    """The split views with the row strides that ``row_strides`` gives the
    kernel address the views' own elements, so the kernel's schedule
    (the replay) on what it reads equals it on contiguous copies.  On the
    CPU ``ops.ssd_scan`` runs the plain version, which must agree too; the
    kernel itself reads the views on the card (``chip_smoke.py``)."""
    views = _split_views(2, 70, dtype)
    rest = _inputs(1, 1, 12, torch.float32)[4:]
    assert not any(t.is_contiguous() for t in views)
    rows = k6.row_strides(*views)
    read = [_as_the_kernel_reads(t, r) for t, r in zip(views, rows)]
    assert all(torch.equal(a, b) for a, b in zip(read, views))
    contiguous = [t.contiguous() for t in views]
    assert torch.equal(replay(*read, *rest), replay(*contiguous, *rest))
    got = ops.ssd_scan(*views, *rest)
    assert torch.equal(got, ops.ssd_scan(*contiguous, *rest))


def test_the_kernel_reads_split_views_in_place():
    """``row_strides`` takes the split views (one row stride each: the
    width of the tensor they were split from) and ``readable`` passes them
    on uncopied; steps that are not rows of one stride, and rows of x, B, C
    off 16 bytes, are copied."""
    views = _split_views(2, 9, torch.bfloat16)
    conv, proj = NH * P + 2 * N, 2 * NH * P + 2 * N + NH
    assert k6.row_strides(*views) == (conv, conv, conv, proj)
    kept = k6.readable(*views)
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(kept, views))
    x = views[0]
    swapped = x.transpose(0, 1).contiguous().transpose(0, 1)    # [B,S] swapped
    assert k6.row_strides(swapped, *views[1:]) is None
    copied = k6.readable(swapped, *views[1:])[0]
    assert copied.is_contiguous() and torch.equal(copied, x)
    odd = torch.zeros((2, 9, conv + 1), dtype=torch.bfloat16)  # 2-byte rows
    xo, bo, co = torch.split(odd[..., :conv], [NH * P, N, N], dim=-1)
    assert k6.row_strides(xo.reshape(2, 9, NH, P), bo, co, views[3]) is None
    assert all(t.is_contiguous() for t in k6.readable(
        xo.reshape(2, 9, NH, P), bo, co, views[3])[:3])
