"""The port's kernels on CPU tensors against the JAX Pallas kernels.

K1-K3 (``masked_matmul`` forward and its differentiable backward) and K5
(``decode_attention``).

On a CPU tensor ``repro_torch.kernels.ops`` runs the plain PyTorch version
(``repro_torch.kernels.ref``); the same numpy inputs go through the JAX
Pallas kernels in interpret mode and through ``repro.kernels.ref``.
Tolerance 1e-5 in f32: the two sides sum in another order.  The CUDA
kernels themselves are held against the same plain versions on the card by
``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.masked_matmul import masked_matmul as pallas_mm
from repro_torch.kernels import ops, ref
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=1e-5, rtol=1e-5)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _port(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


class TestDecodeAttention:
    @pytest.mark.parametrize("b,s,h,kv,hd", [
        (2, 256, 4, 2, 32),       # GQA, G=2
        (2, 128, 8, 8, 64),       # MHA (olmo's grouping)
        (1, 256, 8, 1, 64),       # MQA, G=8
    ])
    def test_matches_pallas_without_lengths(self, b, s, h, kv, hd):
        q, k, v = (_rand((b, 1, h, hd), 0), _rand((b, s, kv, hd), 1),
                   _rand((b, s, kv, hd), 2))
        want = pallas_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             block_k=128, interpret=True)
        got = ops.decode_attention(*_port(q, k, v))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(
            ref.decode_attention_ref(*_port(q, k, v)).numpy(),
            np.asarray(jref.decode_attention_ref(q, k, v)), **TOL)

    @pytest.mark.parametrize("lengths", [[1, 128, 200, 256], [37, 256, 5, 129]])
    def test_ragged_lengths_match_pallas(self, lengths):
        b, s, h, kv, hd = 4, 256, 4, 2, 32
        q, k, v = (_rand((b, 1, h, hd), 3), _rand((b, s, kv, hd), 4),
                   _rand((b, s, kv, hd), 5))
        lens = np.asarray(lengths, np.int32)
        want = pallas_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(lens), block_k=128, interpret=True)
        got = ops.decode_attention(*_port(q, k, v, lens))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jref.decode_attention_ref(
                q, k, v, jnp.asarray(lens))), **TOL)

    def test_grouping_is_g_major(self):
        """Query head h reads kv head h % KV (the [g, kv] order), not the
        repeat_interleave order h // G: with H=4, KV=2 heads 0 and 2 see kv
        head 0, heads 1 and 3 see kv head 1."""
        b, s, h, kv, hd = 1, 16, 4, 2, 8
        q = _rand((b, 1, h, hd), 6)
        k = _rand((b, s, kv, hd), 7)
        v = np.zeros((b, s, kv, hd), np.float32)
        v[:, :, 1] = 1.0
        got = ops.decode_attention(*_port(q, k, v)).numpy()
        np.testing.assert_allclose(got[0, 0, [0, 2]], 0.0, atol=1e-6)
        np.testing.assert_allclose(got[0, 0, [1, 3]], 1.0, atol=1e-6)
        want = pallas_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             block_k=16, interpret=True)
        np.testing.assert_allclose(got, np.asarray(want), **TOL)

    def test_cache_length_not_a_multiple_of_128(self):
        """The port takes any S (the CUDA kernel has no block_k)."""
        b, s, h, kv, hd = 2, 100, 4, 2, 32
        q, k, v = (_rand((b, 1, h, hd), 8), _rand((b, s, kv, hd), 9),
                   _rand((b, s, kv, hd), 10))
        lens = np.asarray([100, 41], np.int32)
        want = pallas_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(lens), block_k=50, interpret=True)
        got = ops.decode_attention(*_port(q, k, v, lens))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    def test_stale_rows_never_attended(self):
        """Garbage past each valid prefix — huge values, and NaN, which
        the kernel never reads — leaves the output untouched."""
        b, s, h, kv, hd = 2, 64, 4, 2, 32
        q, k, v = (_rand((b, 1, h, hd), 11), _rand((b, s, kv, hd), 12),
                   _rand((b, s, kv, hd), 13))
        lens = np.asarray([40, 7], np.int32)
        clean = ops.decode_attention(*_port(q, k, v, lens))
        stale = np.arange(s)[None, :, None, None] >= lens[:, None, None, None]
        for fill_k, fill_v in ((1e4, -1e4), (np.nan, np.nan)):
            dirty = ops.decode_attention(*_port(
                q, np.where(stale, fill_k, k), np.where(stale, fill_v, v),
                lens))
            assert torch.equal(clean, dirty)

    def test_zero_length_gives_zero_like_the_kernel(self):
        b, s, h, kv, hd = 2, 128, 4, 2, 32
        q, k, v = (_rand((b, 1, h, hd), 14), _rand((b, s, kv, hd), 15),
                   _rand((b, s, kv, hd), 16))
        lens = np.asarray([0, 9], np.int32)
        got = ops.decode_attention(*_port(q, k, v, lens)).numpy()
        want = pallas_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(lens), block_k=128, interpret=True)
        assert np.all(got[0] == 0.0)
        np.testing.assert_allclose(got, np.asarray(want), **TOL)

    def test_full_lengths_equal_no_lengths(self):
        b, s, h, kv, hd = 2, 64, 4, 2, 32
        q, k, v = _port(_rand((b, 1, h, hd), 17), _rand((b, s, kv, hd), 18),
                        _rand((b, s, kv, hd), 19))
        full = ops.decode_attention(q, k, v,
                                    torch.full((b,), s, dtype=torch.int32))
        assert torch.equal(full, ops.decode_attention(q, k, v))

    @pytest.mark.parametrize("q_shape,k_shape,lens_shape,match", [
        ((2, 2, 4, 32), (2, 8, 2, 32), None, "single decode step"),
        ((2, 1, 3, 32), (2, 8, 2, 32), None, "multiple of kv heads"),
        ((2, 1, 4, 32), (2, 8, 2, 32), (3,), "lengths"),
        ((2, 1, 4, 32), (2, 8, 2, 16), None, "cache"),
    ])
    def test_value_errors(self, q_shape, k_shape, lens_shape, match):
        q, k = torch.zeros(q_shape), torch.zeros(k_shape)
        lens = None if lens_shape is None else torch.ones(
            lens_shape, dtype=torch.int32)
        with pytest.raises(ValueError, match=match):
            ops.decode_attention(q, k, k, lens)


class TestMaskedMatmul:
    @pytest.mark.parametrize("m", [8, 128])
    @pytest.mark.parametrize("mask", [[1, 0, 1, 0], [1, 1, 1, 1], [0, 0, 0, 0]])
    def test_matches_pallas(self, m, mask):
        k, n = 256, 512
        x, w = _rand((m, k), 20), _rand((k, n), 21) / 16
        bm = np.asarray(mask, np.float32)
        want = pallas_mm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bm),
                         block_m=min(m, 128), interpret=True)
        got = ops.masked_matmul(*_port(x, w, bm))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    @pytest.mark.parametrize("m", [1, 5, 13])
    def test_any_m_matches_ref(self, m):
        """The port takes any M, with no padding; the JAX side pads to 8."""
        k, n = 128, 384
        x, w = _rand((m, k), 22), _rand((k, n), 23) / 11
        bm = np.asarray([0, 1, 1], np.float32)
        got = ops.masked_matmul(*_port(x, w, bm))
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jref.masked_matmul_ref(x, w, bm)), **TOL)
        mp = -(-m // 8) * 8
        xp = np.zeros((mp, k), np.float32)
        xp[:m] = x
        pal = pallas_mm(jnp.asarray(xp), jnp.asarray(w), jnp.asarray(bm),
                        block_m=8, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(pal)[:m], **TOL)

    def test_pruned_blocks_exact_zero_even_over_garbage(self):
        """A pruned block is written as 0 without reading w: non-finite
        weights there never reach the output."""
        x, w = _rand((8, 128), 24), _rand((128, 256), 25)
        w[:, 128:] = np.nan
        got = ops.masked_matmul(*_port(x, w, np.asarray([1, 0], np.float32)))
        assert torch.all(got[:, 128:] == 0.0)
        assert torch.isfinite(got).all()

    def test_value_errors_name_the_shapes(self):
        w = torch.zeros(256, 256)
        with pytest.raises(ValueError, match=r"\(5, 100\)"):
            ops.masked_matmul(torch.zeros(5, 100), torch.zeros(100, 256),
                              torch.ones(2))
        with pytest.raises(ValueError, match="block_mask"):
            ops.masked_matmul(torch.zeros(8, 256), w, torch.ones(3))
        with pytest.raises(ValueError, match="contraction"):
            ops.masked_matmul(torch.zeros(8, 128), w, torch.ones(2))
        with pytest.raises(ValueError, match="2-D"):
            ops.masked_matmul(torch.zeros(2, 8, 256), w, torch.ones(2))


class TestOpsDispatch:
    def test_cpu_tensors_take_the_plain_version(self):
        x, w = _port(_rand((4, 128), 26), _rand((128, 256), 27))
        bm = torch.tensor([1.0, 0.0])
        assert torch.equal(ops.masked_matmul(x, w, bm),
                           ref.masked_matmul_ref(x, w, bm))
        q, k, v = _port(_rand((2, 1, 4, 32), 28), _rand((2, 16, 2, 32), 29),
                        _rand((2, 16, 2, 32), 30))
        assert torch.equal(ops.decode_attention(q, k, v),
                           ref.decode_attention_ref(q, k, v))


class TestMaskedMatmulVJP:
    """The differentiable op: K1 forward, K2 ``dx`` and K3 ``dw`` backward
    (their plain versions on the CPU), against ``jax.vjp`` of the Pallas
    ``masked_matmul`` (interpret mode; the JAX side pads M to 8 rows, whose
    zero rows add nothing to ``dw``) and the float64 oracle
    ``masked_matmul_vjp_ref64``.  Tolerance 1e-5 relative to max(1, max
    |reference|): f32 sums over up to 512 terms in another order."""

    K, N = 256, 512

    @staticmethod
    def _close(got, want):
        want = np.asarray(want)
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0)

    @pytest.mark.parametrize("m", [5, 17, 64])
    @pytest.mark.parametrize("mask", [[1, 0, 1, 0], [1, 1, 1, 1],
                                      [0, 0, 0, 0]])
    def test_gradients_match_jax_vjp_and_f64(self, m, mask):
        x, w = _rand((m, self.K), 31), _rand((self.K, self.N), 32) / 16
        dy = _rand((m, self.N), 33)
        bm = np.asarray(mask, np.float32)
        mp = -(-m // 8) * 8
        xp, dyp = np.zeros((mp, self.K), np.float32), np.zeros(
            (mp, self.N), np.float32)
        xp[:m], dyp[:m] = x, dy
        y_j, vjp = jax.vjp(lambda a, b: pallas_mm(
            a, b, jnp.asarray(bm), block_m=8, interpret=True),
            jnp.asarray(xp), jnp.asarray(w))
        dx_j, dw_j = vjp(jnp.asarray(dyp))
        dx64, dw64 = jref.masked_matmul_vjp_ref64(x, w, bm, dy)

        xt, wt = (t.requires_grad_(True) for t in _port(x, w))
        y = ops.masked_matmul(xt, wt, torch.from_numpy(bm))
        y.backward(torch.from_numpy(dy))
        self._close(y.detach().numpy(), np.asarray(y_j)[:m])
        for got, want_j, want64 in ((xt.grad, np.asarray(dx_j)[:m], dx64),
                                    (wt.grad, dw_j, dw64)):
            self._close(got.numpy(), want_j)
            self._close(got.numpy(), want64)
        # the plain versions themselves, called directly
        dyt, wd = _port(dy, w)
        self._close(ref.masked_matmul_dx_ref(dyt, wd, torch.from_numpy(bm))
                    .numpy(), dx64)
        self._close(ref.masked_matmul_dw_ref(xt.detach(), dyt,
                                             torch.from_numpy(bm)).numpy(),
                    dw64)
        # a pruned filter gets an exactly-zero gradient
        pruned = np.repeat(bm, 128) == 0
        assert np.all(wt.grad.numpy()[:, pruned] == 0.0)

    def test_pruned_blocks_are_never_read_backward(self):
        """K2 skips pruned blocks of ``w`` and K3 writes their ``dw`` without
        reading ``dy`` there: garbage in those blocks reaches nothing."""
        x, w, dy = _rand((8, 128), 34), _rand((128, 256), 35), _rand((8, 256),
                                                                    36)
        w[:, 128:] = np.nan
        dy[:, 128:] = np.nan
        bm = torch.tensor([1.0, 0.0])
        dx = ops.masked_matmul_dx(*_port(dy, w), bm)
        dw = ops.masked_matmul_dw(*_port(x, dy), bm)
        assert torch.isfinite(dx).all()
        assert torch.all(dw[:, 128:] == 0.0) and torch.isfinite(dw).all()

    def test_block_mask_gets_no_gradient(self):
        x, w = (t.requires_grad_(True) for t in _port(_rand((4, 128), 37),
                                                      _rand((128, 256), 38)))
        bm = torch.ones(2, requires_grad=True)
        ops.masked_matmul(x, w, bm).sum().backward()
        assert bm.grad is None and x.grad is not None and w.grad is not None

    def test_value_errors(self):
        w = torch.zeros(256, 512)
        with pytest.raises(ValueError, match="masked_matmul_dx expects"):
            ops.masked_matmul_dx(torch.zeros(4, 256), w, torch.ones(4))
        with pytest.raises(ValueError, match="block_mask"):
            ops.masked_matmul_dx(torch.zeros(4, 512), w, torch.ones(3))
        with pytest.raises(ValueError, match="masked_matmul_dw expects"):
            ops.masked_matmul_dw(torch.zeros(4, 256), torch.zeros(5, 512),
                                 torch.ones(4))
        with pytest.raises(ValueError, match="block-aligned"):
            ops.masked_matmul_dw(torch.zeros(4, 100), torch.zeros(4, 512),
                                 torch.ones(4))
        with pytest.raises(ValueError, match=r"\(5, 100\)"):
            ops.masked_matmul(torch.zeros(5, 100, requires_grad=True),
                              torch.zeros(100, 256), torch.ones(2))
