"""Full-sequence scoring through the Pallas path: K4, K6 and olmo-1b.

The port's plain versions of ``flash_attention`` (K4) and ``ssd_scan`` (K6),
which ``repro_torch.kernels.ops`` runs for CPU tensors, against the JAX
Pallas kernels in interpret mode and against ``repro.kernels.ref``, on the
cases of the reference's ``tests/test_kernels.py``; the attention block
with a window; and ``LM(attn_impl="pallas")`` on olmo-1b's reduced config
against the JAX ``LM(attn_impl="pallas")``, dense and masked.

Tolerances are the reference tests' own: K4 2e-5 in f32 and 2e-2 in bf16
(both sides round the output to bf16 once), K6 2e-4 (the chunked Pallas
form against the sequential definition); layers and logits 1e-5 in f32.
The CUDA kernels are held against the same plain versions on the card by
``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
from repro.models import layers as jax_layers
from repro.models.lm import LM as JaxLM
from repro_torch import interop
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models import layers
from repro_torch.models.lm import LM
from repro_torch.serving import load_servable
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

OLMO_SMALL = jax_get_config("olmo-1b").reduced()
F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)
SSD = dict(atol=2e-4, rtol=2e-4)
LOGITS = dict(atol=1e-5, rtol=1e-5)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _both(arrays, dtype):
    """The same values as JAX and torch arrays of ``dtype`` (bf16 rounds
    the same way on both sides)."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([jnp.asarray(a, jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


class TestFlashAttentionPlain:
    @pytest.mark.parametrize("b,s,h,kv,hd", [
        (1, 256, 4, 4, 64),     # MHA
        (2, 512, 8, 2, 64),     # GQA 4:1
        (1, 256, 8, 1, 128),    # MQA
        (2, 384, 6, 3, 32),     # S = 3 * 128
    ])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_causal_matches_pallas(self, b, s, h, kv, hd, dtype):
        (jq, jk, jv), (q, k, v) = _both(
            [_rand((b, s, h, hd), 0), _rand((b, s, kv, hd), 1),
             _rand((b, s, kv, hd), 2)], dtype)
        want = pallas_flash(jq, jk, jv, causal=True, block_q=128, block_k=128,
                            interpret=True)
        got = ops.flash_attention(q, k, v, causal=True)
        assert got.dtype == q.dtype
        tol = BF16 if dtype == "bfloat16" else F32
        np.testing.assert_allclose(_f32(got), _f32(want), **tol)
        np.testing.assert_allclose(
            _f32(got), _f32(jref.flash_attention_ref(jq, jk, jv, causal=True)),
            **tol)

    @pytest.mark.parametrize("window", [64, 128, 256])
    def test_sliding_window_matches_pallas(self, window):
        (jq, jk, jv), (q, k, v) = _both(
            [_rand((1, 512, 4, 64), 3), _rand((1, 512, 2, 64), 4),
             _rand((1, 512, 2, 64), 5)], "float32")
        want = pallas_flash(jq, jk, jv, causal=True, window=window,
                            block_q=128, block_k=128, interpret=True)
        got = ops.flash_attention(q, k, v, causal=True, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)

    @pytest.mark.parametrize("sq,skv", [(256, 256), (128, 512)])
    def test_non_causal_and_cross_lengths_match_pallas(self, sq, skv):
        (jq, jk, jv), (q, k, v) = _both(
            [_rand((2, sq, 4, 64), 6), _rand((2, skv, 2, 64), 7),
             _rand((2, skv, 2, 64), 8)], "float32")
        want = pallas_flash(jq, jk, jv, causal=False, block_q=128,
                            block_k=128, interpret=True)
        got = ops.flash_attention(q, k, v, causal=False)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)

    @pytest.mark.parametrize("sq,skv,window", [
        (128, 256, None),       # Sq != Skv, causal, positions from 0
        (200, 200, None),       # ragged S (the reference ops falls back)
        (300, 200, 100),        # ragged, windowed, rows past Skv
    ])
    def test_ragged_and_uneven_match_the_reference_ref(self, sq, skv, window):
        (jq, jk, jv), (q, k, v) = _both(
            [_rand((2, sq, 4, 32), 9), _rand((2, skv, 2, 32), 10),
             _rand((2, skv, 2, 32), 11)], "float32")
        got = ops.flash_attention(q, k, v, causal=True, window=window)
        want = np.asarray(jref.flash_attention_ref(jq, jk, jv, causal=True,
                                                   window=window))
        seen = np.isfinite(want)          # jax: a row with no key is NaN
        np.testing.assert_allclose(got.numpy()[seen], want[seen], **F32)
        assert np.all(got.numpy()[~seen] == 0.0)

    def test_a_row_with_no_visible_key_is_zero(self):
        """Query 2 of 3 against 2 keys with a window of 1 sees only key 2,
        which does not exist: its row is 0 (the kernels' max(l, 1e-30))."""
        q, k, v = (torch.from_numpy(_rand(s, i))
                   for i, s in enumerate([(1, 3, 2, 32), (1, 2, 1, 32),
                                          (1, 2, 1, 32)]))
        out = ops.flash_attention(q, k, v, causal=True, window=1)
        assert torch.all(out[:, 2] == 0)
        assert torch.isfinite(out).all()
        torch.testing.assert_close(out[:, 1, 0], v[:, 1, 0], **F32)


class TestSSDScanPlain:
    @pytest.mark.parametrize("b,s,nh,p,n,chunk", [
        (2, 256, 4, 8, 16, 64),
        (1, 512, 2, 16, 8, 128),
        (3, 128, 8, 4, 4, 32),
    ])
    def test_matches_pallas_and_the_sequential_ref(self, b, s, nh, p, n,
                                                   chunk):
        args = [_rand((b, s, nh, p), 20), _rand((b, s, n), 21),
                _rand((b, s, n), 22), _rand((b, s, nh), 23),
                _rand((nh,), 24, 0.1), _rand((nh,), 25), _rand((nh,), 26)]
        jargs, targs = _both(args, "float32")
        got = ops.ssd_scan(*targs, chunk=chunk).numpy()
        want = pallas_ssd(*jargs, chunk=chunk, interpret=True)
        np.testing.assert_allclose(got, np.asarray(want), **SSD)
        np.testing.assert_allclose(got, np.asarray(jref.ssd_scan_ref(*jargs)),
                                   **SSD)

    def test_ragged_length_matches_the_reference_ref(self):
        b, s, nh, p, n = 2, 200, 3, 8, 16
        args = [_rand((b, s, nh, p), 30), _rand((b, s, n), 31),
                _rand((b, s, n), 32), _rand((b, s, nh), 33),
                _rand((nh,), 34, 0.1), _rand((nh,), 35), _rand((nh,), 36)]
        jargs, targs = _both(args, "float32")
        got = ops.ssd_scan(*targs, chunk=64)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jref.ssd_scan_ref(*jargs)), **SSD)

    def test_bf16_keeps_the_type_and_an_f32_state(self):
        args = [_rand((1, 64, 2, 8), 40), _rand((1, 64, 16), 41),
                _rand((1, 64, 16), 42), _rand((1, 64, 2), 43),
                _rand((2,), 44, 0.1), _rand((2,), 45), _rand((2,), 46)]
        jargs, targs = _both(args[:4], "bfloat16")
        f32 = [torch.from_numpy(a) for a in args[4:]]
        got = ops.ssd_scan(*targs, *f32, chunk=32)
        assert got.dtype == torch.bfloat16
        want = jref.ssd_scan_ref(*jargs, *(jnp.asarray(a) for a in args[4:]))
        np.testing.assert_allclose(_f32(got), _f32(want), **BF16)


class TestForwardOnly:
    def test_flash_attention_refuses_autograd(self):
        q = torch.zeros((1, 8, 2, 32), requires_grad=True)
        kv = torch.zeros((1, 8, 2, 32))
        with pytest.raises(RuntimeError, match="attn_impl='xla'"):
            ops.flash_attention(q, kv, kv)
        with torch.no_grad():
            assert ops.flash_attention(q, kv, kv).shape == q.shape

    def test_ssd_scan_refuses_autograd(self):
        x = torch.zeros((1, 8, 2, 4))
        bc = torch.zeros((1, 8, 16))
        dt = torch.zeros((1, 8, 2))
        a_log = torch.zeros(2, requires_grad=True)
        one = torch.ones(2)
        with pytest.raises(RuntimeError, match="attn_impl='xla'"):
            ops.ssd_scan(x, bc, bc, dt, a_log, one, one)
        with torch.inference_mode():
            assert ops.ssd_scan(x, bc, bc, dt, a_log, one, one).shape == x.shape

    def test_pallas_lm_refuses_gradients_and_xla_trains(self):
        cfg = ModelConfig.from_dict(OLMO_SMALL.to_dict())
        params = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        for leaf in params["layers"]["attn"].values():
            leaf.requires_grad_(True)
        x = torch.zeros((1, 8), dtype=torch.int64)
        with pytest.raises(RuntimeError, match="forward-only"):
            LM(cfg, attn_impl="pallas", device="cpu").loss_and_acc(params, x, x)
        loss, _ = LM(cfg, attn_impl="xla", device="cpu").loss_and_acc(
            params, x, x)
        loss.backward()
        assert params["layers"]["attn"]["wq"].grad is not None

    @pytest.mark.parametrize("bad, match", [
        (dict(window=0), "window must be >= 1"),
        (dict(kv_heads=3), "multiple of kv heads"),
    ])
    def test_flash_shape_errors(self, bad, match):
        q = torch.zeros((1, 8, 4, 32))
        kv = torch.zeros((1, 8, bad.get("kv_heads", 2), 32))
        with pytest.raises(ValueError, match=match):
            ops.flash_attention(q, kv, kv, window=bad.get("window"))

    def test_ssd_shape_errors(self):
        x = torch.zeros((1, 8, 2, 4))
        bc = torch.zeros((1, 8, 16))
        with pytest.raises(ValueError, match=r"dt \(1, 8, 3\)"):
            ops.ssd_scan(x, bc, bc, torch.zeros((1, 8, 3)), torch.zeros(2),
                         torch.zeros(2), torch.zeros(2))
        with pytest.raises(ValueError, match="chunk must be >= 1"):
            ops.ssd_scan(x, bc, bc, torch.zeros((1, 8, 2)), torch.zeros(2),
                         torch.zeros(2), torch.zeros(2), chunk=0)


class TestAttentionLayers:
    @pytest.mark.parametrize("window", [None, 5, 12])
    @pytest.mark.parametrize("q_offset", [0, 7])
    def test_attention_equals_attention_ref(self, window, q_offset):
        q, k, v = _rand((2, 12, 4, 16), 50), _rand((2, 20, 2, 16), 51), \
            _rand((2, 20, 2, 16), 52)
        want = jax_layers.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=True,
                                        window=window, q_offset=q_offset)
        got = layers.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=True, window=window, q_offset=q_offset)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)

    def test_long_attention_is_blocked_over_rows_with_the_same_result(self):
        q, k, v = (torch.from_numpy(_rand((1, 1100, 2, 8), i))
                   for i in (53, 54, 55))
        got = layers.attention(q, k, v, causal=True, window=300)
        want = ref.flash_attention_ref(q, k, v, causal=True, window=300)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)

    @pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
    @pytest.mark.parametrize("window", [None, 48])
    def test_attention_block_matches_jax(self, attn_impl, window):
        cfg = OLMO_SMALL
        jparams = jax.jit(JaxLM(cfg).init)(jax.random.key(1))
        jlayer = jax.tree.map(lambda a: a[0], jparams["layers"]["attn"])
        x = _rand((2, 128, cfg.d_model), 56)
        pos = jax_layers.default_positions(2, 128, cfg.rope)
        want = jax_layers.attention_block(jlayer, jnp.asarray(x), pos, cfg,
                                          window=window, attn_impl=attn_impl)
        tlayer = interop.params_from_jax(jax.tree.map(np.asarray, jlayer),
                                         "cpu")
        got = layers.attention_block(
            tlayer, torch.from_numpy(x), torch.from_numpy(np.array(pos)),
            ModelConfig.from_dict(cfg.to_dict()), window=window,
            attn_impl=attn_impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)


@pytest.fixture(scope="module")
def olmo():
    jm = JaxLM(OLMO_SMALL, attn_impl="pallas")
    jparams = jax.jit(jm.init)(jax.random.key(0))
    params = interop.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    model = LM(ModelConfig.from_dict(OLMO_SMALL.to_dict()), attn_impl="pallas",
               device="cpu")
    return jm, jparams, model, params


class TestOlmoScoring:
    @pytest.mark.parametrize("masked", [False, True])
    def test_pallas_lm_matches_jax(self, olmo, masked):
        jm, jparams, model, params = olmo
        rng = np.random.default_rng(60)
        x = rng.integers(0, OLMO_SMALL.vocab_size, (2, 128)).astype(np.int32)
        y = rng.integers(0, OLMO_SMALL.vocab_size, (2, 128)).astype(np.int32)
        jmasks = masks = None
        if masked:
            jmasks = jm.filter_masks(jparams, jm.decide_kept(jparams, 0.5))
            masks = interop.masks_from_jax(jax.tree.map(np.asarray, jmasks),
                                           "cpu")
        jlogits, _ = jm.apply(jparams, {"tokens": jnp.asarray(x)},
                              masks=jmasks)
        jl, ja = jm.loss_and_acc(jparams, jnp.asarray(x), jnp.asarray(y),
                                 masks=jmasks)
        with torch.no_grad():
            logits = model.apply(params, {"tokens": torch.from_numpy(x)},
                                 masks=masks)
            loss, acc = model.loss_and_acc(params, torch.from_numpy(x),
                                           torch.from_numpy(y), masks=masks)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **LOGITS)
        np.testing.assert_allclose(float(loss), float(jl), **LOGITS)
        assert float(acc) == pytest.approx(float(ja))

    def test_pallas_equals_xla_on_the_port(self, olmo):
        _, _, model, params = olmo
        xla = LM(model.cfg, attn_impl="xla", device="cpu")
        x = torch.from_numpy(np.random.default_rng(61).integers(
            0, OLMO_SMALL.vocab_size, (2, 96)).astype(np.int64))
        with torch.no_grad():
            torch.testing.assert_close(model.apply(params, {"tokens": x}),
                                       xla.apply(params, {"tokens": x}),
                                       atol=1e-5, rtol=1e-5)

    def test_window_bounds_dense_attention_as_in_jax(self, olmo):
        jm, jparams, model, params = olmo
        x = np.random.default_rng(62).integers(
            0, OLMO_SMALL.vocab_size, (1, 128)).astype(np.int32)
        jlogits, _ = jm.apply(jparams, {"tokens": jnp.asarray(x)}, window=32)
        with torch.no_grad():
            logits = model.apply(params, {"tokens": torch.from_numpy(x)},
                                 window=32)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **LOGITS)

    @pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
    def test_load_servable_threads_attn_impl(self, olmo, attn_impl):
        jm, jparams, _, _ = olmo
        src = {"params": jax.tree.map(np.asarray, jparams),
               "kept": jm.decide_kept(jparams, 0.5), "mode": "mask",
               "model_config": OLMO_SMALL}
        kwargs = {} if attn_impl == "pallas" else {"attn_impl": attn_impl}
        for mode in ("dense", "masked", "shrunk"):
            sv = load_servable(src, mode, device="cpu", **kwargs)
            assert sv.model.attn_impl == attn_impl
        with pytest.raises(ValueError, match="attn_impl"):
            load_servable(src, "dense", attn_impl="flash", device="cpu")
