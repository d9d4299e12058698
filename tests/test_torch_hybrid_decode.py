"""The hybrid family's decode (zamba2: Mamba2 recurrence + the shared
attention over one ring-buffer KV cache per group) against the JAX package.

zamba2-1.2b's reduced config with 4 layers and ``attn_every=2`` (two
shared-attention applications), window 64: 96 decode steps pass the window,
so the attention caches run as ring buffers (``lengths = index + 1 > S``).
JAX ``LM.init`` -> ``interop.params_from_jax`` -> the port on the CPU (the
plain version of K5); the JAX side decodes with ``attn_impl="xla"``, whose
attended slots (``<= index``) the port's ``lengths = index + 1`` follow for
both index forms.

Masked decode: the reference's hybrid ``decode_step`` drops ``masks=``, so
the port's masked decode (dense params, FedAP masks) is held against JAX
decoding the mask-zeroed params, which a mask-mode checkpoint holds.

Tolerance ``TOL`` = 1e-4 (absolute and relative) on logits, as the scoring
tests use; the worst measured over 96 steps is ~4e-5 on logits of magnitude
up to ~4.  The decode against the JAX full-sequence ``apply`` (the chunked
SSD scan, plain windowed attention) is held to the same 1e-4.  A single
mixer step and its new state are held to 1e-5: one step sums products of
at most 2048 terms.
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
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.models.lm import LM
from repro_torch.serving import load_servable, lockstep_decode
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ZAMBA = jax_get_config("zamba2-1.2b").reduced(
    num_layers=4, hybrid=HybridConfig(attn_every=2))
TOL = dict(atol=1e-4, rtol=1e-4)
STEP_TOL = dict(atol=1e-5, rtol=1e-5)
STEPS = 96            # past the 64-row window: the ring regime
B = 2


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_cfg(cfg):
    return ModelConfig.from_dict(cfg.to_dict())


@pytest.fixture(scope="module")
def world():
    """JAX params (and their port copy), a token stream, the rate-0.5 FedAP
    decision and its mask-zeroed and shrunk params."""
    jm = JaxLM(ZAMBA)
    jparams = jax.jit(jm.init)(jax.random.key(0))
    tokens = np.random.default_rng(0).integers(
        0, ZAMBA.vocab_size, (B, STEPS)).astype(np.int32)
    kept = jm.decide_kept(jparams, 0.5)
    pm = jm.param_masks(jparams, kept)
    zeroed = jax.tree.map(lambda p, m: p * m, jparams, pm)
    return {"jparams": jparams,
            "params": interop.params_from_jax(_np_tree(jparams), "cpu"),
            "tokens": tokens, "kept": kept,
            "masks": interop.masks_from_jax(
                _np_tree(jm.filter_masks(jparams, kept)), "cpu"),
            "zeroed": zeroed,
            "jshrunk": jax_pruning.shrink_ffn_at(jparams, kept["mlp"])}


_STEPS = {}


def _jax_step(cfg):
    """The JAX model and its jitted decode step, one per config (so each
    compiles once per cache structure)."""
    if cfg not in _STEPS:
        jm = JaxLM(cfg)
        _STEPS[cfg] = (jm, jax.jit(jm.decode_step))
    return _STEPS[cfg]


def _jax_decode(cfg, jparams, tokens, index0, cache=None):
    """JAX decode of ``tokens`` [B,T] from a fresh cache (index ``index0``)
    or ``cache``: logits [T,B,V] and the final cache."""
    jm, step = _jax_step(cfg)
    if cache is None:
        cache = jm.init_cache(tokens.shape[0], tokens.shape[1])
        cache["index"] = jnp.asarray(index0, jnp.int32)
    outs = []
    for t in range(tokens.shape[1]):
        logits, cache = step(jparams, cache,
                             {"tokens": jnp.asarray(tokens[:, t:t + 1])})
        outs.append(np.asarray(logits[:, 0]))
    return np.stack(outs), cache


def _port_decode(model, params, tokens, index0, cache=None, masks=None):
    if cache is None:
        cache = model.init_cache(tokens.shape[0], tokens.shape[1])
        cache["index"] = torch.as_tensor(np.asarray(index0, np.int32))
    outs = []
    with torch.no_grad():
        for t in range(tokens.shape[1]):
            logits, cache = model.decode_step(
                params, cache,
                {"tokens": torch.from_numpy(tokens[:, t:t + 1])}, masks=masks)
            outs.append(logits[:, 0].numpy())
    return np.stack(outs), cache


class TestMamba2Step:
    def test_init_state_matches_jax(self):
        meta = layers.mamba2_meta(_port_cfg(ZAMBA))
        for dtype, jdtype in ((torch.float32, jnp.float32),
                              (torch.bfloat16, jnp.bfloat16)):
            conv, h = layers.mamba2_init_state(3, meta, _port_cfg(ZAMBA),
                                               dtype, "cpu")
            jconv, jh = jax_layers.mamba2_init_state(3, meta, ZAMBA, jdtype)
            assert tuple(conv.shape) == jconv.shape and conv.dtype == dtype
            assert tuple(h.shape) == jh.shape and h.dtype == torch.float32
            assert str(jh.dtype) == "float32"
            assert not conv.any() and not h.any()

    def test_decode_steps_match_jax_from_a_random_state(self, world):
        """Four steps of layer 1's mixer from a random conv buffer and SSM
        state: the output and the state updated in place match the JAX
        function's returned state."""
        cfg = _port_cfg(ZAMBA)
        meta = layers.mamba2_meta(cfg)
        jlayer = jax.tree.map(lambda a: a[1],
                              world["jparams"]["layers"]["mamba"])
        tlayer = {k: v[1]
                  for k, v in world["params"]["layers"]["mamba"].items()}
        rng = np.random.default_rng(1)
        conv0 = rng.standard_normal(
            (B, cfg.ssm.conv_width - 1, meta["d_in"] + 2 * meta["n"]))
        h0 = rng.standard_normal((B, meta["nh"], meta["p"], meta["n"]))
        jstate = (jnp.asarray(conv0, jnp.float32),
                  jnp.asarray(h0, jnp.float32))
        state = (torch.tensor(conv0, dtype=torch.float32),
                 torch.tensor(h0, dtype=torch.float32))
        storage = [t.data_ptr() for t in state]
        for _ in range(4):
            x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
            want, jstate = jax_layers.mamba2_decode(jlayer, jnp.asarray(x),
                                                    jstate, meta, ZAMBA)
            with torch.no_grad():
                got = layers.mamba2_decode(tlayer, torch.from_numpy(x), state,
                                           meta, cfg)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **STEP_TOL)
            for t, w in zip(state, jstate):
                np.testing.assert_allclose(t.numpy(), np.asarray(w),
                                           **STEP_TOL)
        assert [t.data_ptr() for t in state] == storage


class TestHybridDecode:
    def test_cache_matches_jax_shapes_and_dtypes(self):
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(ZAMBA, param_dtype=dtype)
            for window in (None, 32):
                want = JaxLM(cfg).init_cache(3, 100, window=window)
                got = LM(_port_cfg(cfg), device="cpu").init_cache(
                    3, 100, window=window)
                assert jax.tree.structure(want) == jax.tree.structure(got)
                for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
                    assert tuple(g.shape) == w.shape
                    assert str(g.dtype).split(".")[-1] == str(w.dtype)
        cache = LM(_port_cfg(ZAMBA), device="cpu").init_cache(2, 100)
        assert cache["shared_attn"]["k"].shape[:3] == (2, 2,
                                                       ZAMBA.sliding_window)

    @pytest.mark.parametrize("index0", [0, [0, 5]],
                             ids=["lockstep", "per-slot"])
    @pytest.mark.parametrize("mode", ["dense", "masked", "shrunk"])
    def test_steps_match_jax_decode_into_the_ring(self, world, mode, index0):
        """96 steps, past the window, logits step by step; the caches the
        two packages hold at the end agree too."""
        tokens = world["tokens"]
        cfg, jparams, params, masks = ZAMBA, world["jparams"], \
            world["params"], None
        if mode == "masked":
            jparams, masks = world["zeroed"], world["masks"]
        elif mode == "shrunk":
            jparams = world["jshrunk"]
            cfg = dataclasses.replace(ZAMBA,
                                      d_ff=world["kept"]["mlp"].shape[1])
            params = interop.params_from_jax(_np_tree(jparams), "cpu")
        want, jcache = _jax_decode(cfg, jparams, tokens, index0)
        got, cache = _port_decode(LM(_port_cfg(cfg), device="cpu"), params,
                                  tokens, index0, masks=masks)
        assert STEPS > ZAMBA.sliding_window
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_array_equal(cache["index"].numpy(),
                                      np.asarray(jcache["index"]))
        for name in ("conv", "h"):
            np.testing.assert_allclose(cache["mamba"][name].numpy(),
                                       np.asarray(jcache["mamba"][name]),
                                       **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(cache["shared_attn"][name].numpy(),
                                       np.asarray(jcache["shared_attn"][name]),
                                       **TOL)

    def test_masks_reach_the_port_decode(self, world):
        """The port applies ``masks=`` (unlike the reference's hybrid decode,
        ROADMAP R5): masked decode of the dense params differs from dense."""
        model = LM(_port_cfg(ZAMBA), device="cpu")
        tokens = world["tokens"][:, :4]
        dense, _ = _port_decode(model, world["params"], tokens, 0)
        masked, _ = _port_decode(model, world["params"], tokens, 0,
                                 masks=world["masks"])
        assert np.abs(dense - masked).max() > 1e-2

    def test_decode_matches_jax_apply(self, world):
        """Token-by-token decode reproduces the JAX full-sequence forward
        over the same 96 tokens: the ring of 64 rows attends exactly the
        window's keys."""
        tokens = world["tokens"]
        jm = JaxLM(ZAMBA)
        full, _ = jax.jit(lambda p, t: jm.apply(p, {"tokens": t}))(
            world["jparams"], jnp.asarray(tokens))
        got, _ = _port_decode(LM(_port_cfg(ZAMBA), device="cpu"),
                              world["params"], tokens, 0)
        np.testing.assert_allclose(got.transpose(1, 0, 2), np.asarray(full),
                                   **TOL)

    def test_start_from_a_jax_mid_stream_cache(self, world):
        """A JAX cache 70 steps in (past the window) converts leaf for leaf
        and both packages decode on from it alike."""
        tokens = world["tokens"]
        jm = JaxLM(ZAMBA)
        jcache = jm.init_cache(B, STEPS)
        _, jcache = _jax_decode(ZAMBA, world["jparams"], tokens[:, :70], 0,
                                cache=jcache)
        cache = interop.cache_from_jax(_np_tree(jcache), "cpu")
        assert cache["index"].dtype == torch.int32
        assert int(cache["index"]) == 70
        assert cache["mamba"]["h"].dtype == torch.float32
        want, _ = _jax_decode(ZAMBA, world["jparams"], tokens[:, 70:], 0,
                              cache=jcache)
        got, _ = _port_decode(LM(_port_cfg(ZAMBA), device="cpu"),
                              world["params"], tokens[:, 70:], 0, cache=cache)
        np.testing.assert_allclose(got, want, **TOL)
        with pytest.raises(ValueError, match="decode cache"):
            interop.cache_from_jax({"k": np.zeros(2)}, "cpu")


def _reference_greedy(cfg, jparams, prompt, n_new, cache_len):
    """The reference's lockstep loop (``serve_lockstep``): prefill one token a
    step, feed the argmax, record the argmax of each decode step."""
    jm, step = _jax_step(cfg)
    cache = jm.init_cache(prompt.shape[0], cache_len)
    for t in range(prompt.shape[1]):
        logits, cache = step(jparams, cache,
                             {"tokens": jnp.asarray(prompt[:, t:t + 1])})
    tok = jnp.argmax(logits[:, -1], -1)[:, None]
    out = []
    for _ in range(n_new):
        logits, cache = step(jparams, cache, {"tokens": tok.astype(jnp.int32)})
        tok = jnp.argmax(logits[:, -1], -1)[:, None]
        out.append(np.asarray(tok[:, 0]))
    return np.stack(out, 1)


class TestLockstep:
    def test_tokens_equal_the_reference_loop(self, world):
        """40 prompt tokens and 40 new ones (80 steps, past the window)."""
        prompt = world["tokens"][:, :40]
        want = _reference_greedy(ZAMBA, world["jparams"], prompt, 40, 80)
        timings = {}
        got, steps = lockstep_decode(LM(_port_cfg(ZAMBA), device="cpu"),
                                     world["params"], torch.from_numpy(prompt),
                                     40, timings=timings)
        assert steps == 80 and got.dtype == torch.int64
        assert set(timings) == {"prefill_s", "decode_s"}
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("mode", ["dense", "masked", "shrunk"])
    def test_load_servable_decodes_each_mode(self, world, mode):
        """``load_servable`` builds the hybrid in each mode and it decodes
        through ``lockstep_decode``: masked and shrunk decode the same pruned
        model (the reference loop on the shrunk params gives the tokens)."""
        src = {"params": _np_tree(world["jparams"]),
               "kept": _np_tree(world["kept"]), "mode": "mask",
               "model_config": ZAMBA}
        sv = load_servable(src, mode, device="cpu")
        prompt = world["tokens"][:, :24]
        got, steps = lockstep_decode(sv.model, sv.params,
                                     torch.from_numpy(prompt), 16,
                                     masks=sv.masks, cache_len=64)
        assert steps == 40 and got.shape == (B, 16)
        if mode == "dense":
            cfg, jparams = ZAMBA, world["jparams"]
        else:
            cfg = dataclasses.replace(ZAMBA,
                                      d_ff=world["kept"]["mlp"].shape[1])
            jparams = world["jshrunk"]
        want = _reference_greedy(cfg, jparams, prompt, 16, 64)
        np.testing.assert_array_equal(got.numpy(), want)

    def test_refuses_bad_arguments(self, world):
        model = LM(_port_cfg(ZAMBA), device="cpu")
        with pytest.raises(ValueError, match="prompt"):
            lockstep_decode(model, world["params"], torch.zeros(3), 4)
        with pytest.raises(ValueError, match="n_new"):
            lockstep_decode(model, world["params"],
                            torch.zeros((1, 2), dtype=torch.int32), 0)
