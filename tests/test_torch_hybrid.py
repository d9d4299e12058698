"""The hybrid family (zamba2: Mamba2 + a shared sliding-window attention)
against the JAX package.

zamba2-1.2b's reduced config with 4 layers and ``attn_every=2`` at S = 128:
two shared-attention applications, a window of 64 that cuts, and a chunk
of 32 that reaches the Pallas ``ssd_scan`` on the JAX side.  JAX
``LM.init`` -> ``interop.params_from_jax`` -> the port on the CPU, with
``attn_impl="xla"`` (the chunked scan, plain attention) and ``"pallas"``
(the JAX Pallas kernels in interpret mode; the port's plain versions of K4
and K6), with and without FedAP masks.

Tolerance 1e-4 on logits and layers: K6's own tests hold the chunked form
to the sequential definition at 2e-4, and the port's plain K6 is the
sequential one.  The worst case measured here is 4.4e-5 (pallas, logits
of magnitude up to 4.3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import HybridConfig
from repro.core import pruning_lm as jax_pruning
from repro.models import layers as jax_layers
from repro.models.lm import LM as JaxLM
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import pruning_lm
from repro_torch.models import layers
from repro_torch.models.lm import LM
from repro_torch.serving import DecodeEngine, ServeConfig, load_servable
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ZAMBA = jax_get_config("zamba2-1.2b").reduced(
    num_layers=4, hybrid=HybridConfig(attn_every=2))
TOL = dict(atol=1e-4, rtol=1e-4)
SEQ = 128


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_init(cfg, seed):
    """The JAX model's params, initialised under one jit (eager init of the
    stacked layers takes several seconds more)."""
    return jax.jit(JaxLM(cfg).init)(jax.random.key(seed))


def _port_cfg(cfg):
    return ModelConfig.from_dict(cfg.to_dict())


@pytest.fixture(scope="module")
def world():
    jparams = _jax_init(ZAMBA, 0)
    params = interop.params_from_jax(_np_tree(jparams), "cpu")
    x = np.random.default_rng(0).integers(
        0, ZAMBA.vocab_size, (2, SEQ)).astype(np.int32)
    jm = JaxLM(ZAMBA)
    kept = jm.decide_kept(jparams, 0.5)
    jmasks = jm.filter_masks(jparams, kept)
    return jparams, params, x, kept, jmasks


def test_the_reduced_config_exercises_the_slice():
    model = LM(_port_cfg(ZAMBA), device="cpu")
    assert model.hybrid_groups() == [(0, 2), (2, 4)]
    assert ZAMBA.sliding_window < SEQ
    assert min(ZAMBA.ssm.chunk, SEQ) == 32 and SEQ % 32 == 0


class TestConfig:
    def test_zamba2_config_copy_round_trips(self):
        full = jax_get_config("zamba2-1.2b")
        assert get_config("zamba2-1.2b").to_dict() == full.to_dict()
        assert get_config("zamba2-1.2b").reduced(
            num_layers=4, hybrid=HybridConfig(attn_every=2)).to_dict() == \
            ZAMBA.to_dict()
        back = ModelConfig.from_dict(full.to_dict())
        assert back == get_config("zamba2-1.2b")
        assert back.ssm.state_dim == 64 and back.hybrid.attn_every == 6

    def test_full_width_shapes(self):
        cfg = get_config("zamba2-1.2b")
        meta = layers.mamba2_meta(cfg)
        assert meta == {"d_in": 4096, "nh": 64, "p": 64, "n": 64}
        assert len(LM(cfg, device="cpu").hybrid_groups()) == 7


class TestHybridLM:
    @pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
    @pytest.mark.parametrize("masked", [False, True])
    def test_apply_and_loss_match_jax(self, world, attn_impl, masked):
        jparams, params, x, _, jmasks = world
        jm = JaxLM(ZAMBA, attn_impl=attn_impl)
        model = LM(_port_cfg(ZAMBA), attn_impl=attn_impl, device="cpu")
        masks = (interop.masks_from_jax(_np_tree(jmasks), "cpu")
                 if masked else None)
        jmasks = jmasks if masked else None
        y = np.roll(x, -1, axis=1)
        jlogits, aux = jax.jit(lambda p, t, m: jm.apply(
            p, {"tokens": t}, masks=m))(jparams, jnp.asarray(x), jmasks)
        jl, ja = jax.jit(lambda p, a, b, m: jm.loss_and_acc(
            p, a, b, masks=m))(jparams, jnp.asarray(x), jnp.asarray(y), jmasks)
        with torch.no_grad():
            logits = model.apply(params, {"tokens": torch.from_numpy(x)},
                                 masks=masks)
            loss, acc = model.loss_and_acc(params, torch.from_numpy(x),
                                           torch.from_numpy(y), masks=masks)
        assert float(aux) == 0.0
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
        np.testing.assert_allclose(float(loss), float(jl), **TOL)
        assert float(acc) == pytest.approx(float(ja), abs=1.0 / x.size)

    def test_pallas_equals_xla_on_the_port(self, world):
        _, params, x, _, _ = world
        tokens = {"tokens": torch.from_numpy(x)}
        with torch.no_grad():
            a = LM(_port_cfg(ZAMBA), attn_impl="pallas",
                   device="cpu").apply(params, tokens)
            b = LM(_port_cfg(ZAMBA), attn_impl="xla",
                   device="cpu").apply(params, tokens)
        torch.testing.assert_close(a, b, **TOL)

    def test_masked_equals_shrunk(self, world):
        jparams, params, x, kept, _ = world
        model = LM(_port_cfg(ZAMBA), device="cpu")
        tkept = interop.kept_from_jax(_np_tree(kept), "cpu")
        masks = model.filter_masks(params, tkept)
        shrunk = model.shrink_params(params, tkept)
        small = LM(dataclasses.replace(_port_cfg(ZAMBA),
                                       d_ff=int(tkept["mlp"].shape[1])),
                   device="cpu")
        tokens = {"tokens": torch.from_numpy(x)}
        with torch.no_grad():
            torch.testing.assert_close(model.apply(params, tokens, masks=masks),
                                       small.apply(shrunk, tokens),
                                       atol=1e-5, rtol=1e-5)

    def test_xla_path_trains_with_remat(self, world):
        _, params, x, _, _ = world
        cfg = dataclasses.replace(_port_cfg(ZAMBA), remat="block")
        p = interop.params_from_jax(interop.params_to_numpy(params), "cpu")
        for leaf in (p["layers"]["mamba"]["in_proj"],
                     p["shared_attn"]["attn"]["wq"]):
            leaf.requires_grad_(True)
        xt = torch.from_numpy(x[:, :64])
        loss, _ = LM(cfg, device="cpu").loss_and_acc(p, xt, xt)
        loss.backward()
        assert torch.isfinite(p["layers"]["mamba"]["in_proj"].grad).all()
        assert p["shared_attn"]["attn"]["wq"].grad.abs().sum() > 0

    def test_decode_engine_refuses_the_hybrid(self, world):
        """As the reference's engine does: the hybrid's decode state has no
        per-slot cache index (it is served by ``lockstep_decode``, held
        against the reference in ``test_torch_hybrid_decode.py``)."""
        _, params, _, _, _ = world
        model = LM(_port_cfg(ZAMBA), device="cpu")
        with pytest.raises(ValueError, match="scanned-KV"):
            DecodeEngine(model, params, ServeConfig(
                slots=1, cache_len=8, max_prompt=4, max_new_tokens=4),
                device="cpu")


class TestMamba2Layer:
    @pytest.mark.parametrize("impl", ["xla", "pallas"])
    @pytest.mark.parametrize("seq", [SEQ, 96])
    def test_apply_mamba2_matches_jax(self, world, impl, seq):
        jparams, params, _, _, _ = world
        jlayer = jax.tree.map(lambda a: a[1], jparams["layers"]["mamba"])
        tlayer = {k: v[1] for k, v in params["layers"]["mamba"].items()}
        meta = layers.mamba2_meta(_port_cfg(ZAMBA))
        x = np.random.default_rng(3).standard_normal(
            (2, seq, ZAMBA.d_model)).astype(np.float32)
        want = jax_layers.apply_mamba2(jlayer, jnp.asarray(x), meta, ZAMBA,
                                       impl=impl)
        with torch.no_grad():
            got = layers.apply_mamba2(tlayer, torch.from_numpy(x), meta,
                                      _port_cfg(ZAMBA), impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    def test_chunk_scan_matches_the_sequential_definition(self):
        rng = np.random.default_rng(4)
        b, s, nh, p, n = 2, 96, 3, 8, 16
        args = [torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
                for sh in ((b, s, nh, p), (b, s, n), (b, s, n), (b, s, nh))]
        a_log, d, bias = (torch.from_numpy(
            rng.standard_normal(nh).astype(np.float32) * sc)
            for sc in (0.1, 1.0, 1.0))
        from repro_torch.kernels import ref

        want = ref.ssd_scan_ref(*args, a_log, d, bias)
        for chunk in (32, 48, 96):
            got = layers._ssd_chunk_scan(*args, a_log, d, bias, chunk)
            torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)

    def test_short_chunks_track_an_f64_recurrence_closer(self):
        """The chunked form takes exp(cum_i - cum_j) from prefix sums of
        log-decays; over 256 steps they reach |cum| ~ 10^2 and each decay
        loses ~|cum| 2^-24 in f32, so the 32-step sub-chunks of the K6
        kernel stay closer to the exact recurrence than the reference's
        256-step chunks: the kernel's own chunk costs no accuracy."""
        rng = np.random.default_rng(5)
        b, s, nh, p, n = 1, 512, 2, 16, 32
        x, bm, cm, dt = (torch.from_numpy(rng.standard_normal(sh))
                         for sh in ((b, s, nh, p), (b, s, n), (b, s, n),
                                    (b, s, nh)))
        zero, one = torch.zeros(nh), torch.ones(nh)
        dtv = torch.nn.functional.softplus(dt)
        a = torch.exp(-dtv)
        h = torch.zeros((b, nh, p, n), dtype=torch.float64)
        ys = []
        for t in range(s):
            h = h * a[:, t, :, None, None] + (x[:, t] * dtv[:, t, :, None])[
                ..., None] * bm[:, t, None, None, :]
            ys.append(torch.einsum("bn,bhpn->bhp", cm[:, t], h))
        exact = torch.stack(ys, 1) + x
        f32 = [t.float() for t in (x, bm, cm, dt)]
        errs = {c: float((layers._ssd_chunk_scan(*f32, zero, one, zero, c)
                          .double() - exact).abs().max() / exact.abs().max())
                for c in (32, 256)}
        assert errs[32] < errs[256] < 2e-4, errs

    def test_init_keeps_the_ssm_scalars_in_f32(self):
        cfg = dataclasses.replace(_port_cfg(ZAMBA), param_dtype="bfloat16")
        params = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        jp = jax.eval_shape(JaxLM(dataclasses.replace(
            ZAMBA, param_dtype="bfloat16")).init, jax.random.key(0))
        flat = dict(zip(*_flat(params)))
        jflat = dict(zip(*_flat(jp)))
        assert set(flat) == set(jflat)
        for key, t in flat.items():
            assert tuple(t.shape) == tuple(jflat[key].shape), key
            want = torch.float32 if key[-1] in ("A_log", "D", "dt_bias") \
                else torch.bfloat16
            assert t.dtype == want, key
            assert str(jflat[key].dtype) == str(want).split(".")[-1], key


def _flat(tree, prefix=()):
    keys, leaves = [], []
    for k, v in tree.items():
        if isinstance(v, dict):
            ks, ls = _flat(v, prefix + (k,))
            keys += ks
            leaves += ls
        else:
            keys.append(prefix + (k,))
            leaves.append(v)
    return keys, leaves


class TestInteropAndPruning:
    def test_bf16_hybrid_tree_round_trips_leaf_for_leaf(self):
        cfg = dataclasses.replace(ZAMBA, param_dtype="bfloat16")
        jp = _np_tree(_jax_init(cfg, 1))
        port = interop.params_from_jax(jp, "cpu")
        assert port["layers"]["mamba"]["A_log"].dtype == torch.float32
        assert port["layers"]["mamba"]["in_proj"].dtype == torch.bfloat16
        assert port["shared_attn"]["attn"]["wq"].dtype == torch.bfloat16
        back = interop.params_to_numpy(port)
        for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
            np.testing.assert_array_equal(np.asarray(a, np.float32), b)

    def test_kept_masks_and_shrink_equal_jax(self, world):
        jparams, params, _, kept, jmasks = world
        model = LM(_port_cfg(ZAMBA), device="cpu")
        got = model.decide_kept(params, 0.5)
        np.testing.assert_array_equal(got["mlp"], np.asarray(kept["mlp"]))
        masks = model.filter_masks(params, got)
        np.testing.assert_array_equal(masks["mlp"].numpy(),
                                      np.asarray(jmasks["mlp"]))
        shrunk = pruning_lm.shrink_ffn_at(params, got["mlp"])
        jshrunk = jax_pruning.shrink_ffn_at(jparams, kept["mlp"])
        for a, b in zip(jax.tree.leaves(interop.params_to_numpy(shrunk)),
                        jax.tree.leaves(_np_tree(jshrunk))):
            np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("mode", ["dense", "masked", "shrunk"])
    def test_load_servable_builds_a_pallas_hybrid_model(self, world, mode):
        jparams, _, x, kept, _ = world
        src = {"params": _np_tree(jparams), "kept": _np_tree(kept),
               "mode": "mask", "model_config": ZAMBA}
        sv = load_servable(src, mode, device="cpu")
        assert sv.model.attn_impl == "pallas" and sv.model.hybrid
        assert sv.params["layers"]["mamba"]["D"].dtype == torch.float32
        want_ff = ZAMBA.d_ff if mode != "shrunk" else kept["mlp"].shape[1]
        assert sv.model.cfg.d_ff == want_ff
        with torch.no_grad():
            logits = sv.model.apply(sv.params,
                                    {"tokens": torch.from_numpy(x[:, :64])},
                                    masks=sv.masks)
        assert logits.shape == (2, 64, ZAMBA.vocab_size)
        assert torch.isfinite(logits).all()
