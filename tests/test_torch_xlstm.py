"""The ssm family (xlstm: mLSTM blocks with an sLSTM block every 4th layer)
against the JAX package: the blocks, the LM's forward, loss gradient and
decode, lockstep serving, ``load_servable`` and the refusals.

xlstm-125m's reduced config with 4 layers (``reduced()`` alone gives 2,
which with ``slstm_every=4`` hold no sLSTM block): layers 0-2 are mLSTM,
layer 3 sLSTM; d = 256, f = 512, 4 heads of 128.  JAX ``LM.init`` ->
``interop.params_from_jax`` -> the port on the CPU, in f32 unless a test
says bf16.

Tolerances:
* one block on one input (``apply_mlstm`` at S = 32, one chunk, and S =
  128, two; ``apply_slstm``): 1e-5 of max(1, max |jax|); one decode step of
  a cell and its state: 1e-5 absolute and relative;
* the LM (logits of the forward and of 64 decode steps, every state tensor
  of the cache): 1e-4 absolute and relative; the loss gradient: 2e-4 of
  each leaf's max |grad|.  The exponential gates amplify f32 rounding
  through the layers: the worst measured is 7.8e-5 on logits of magnitude
  up to 5.1, and 7.4e-5 of a leaf's max on the gradient, and the JAX
  package's own decode and forward differ by ~9e-5 on these logits.  The
  port's decode is held to its own forward at 1e-4 absolute;
* bf16: one block on the same bf16 input within 2^-6 of max(1, max |jax|)
  (a bf16 step is 2^-7 of the value; the worst measured is one step,
  0.031 at 4.2).  Through the LM, bf16 roundings compound chaotically (the
  JAX forward under jit and eagerly differ by up to 0.23 on logits of
  magnitude 5; a max over logits moves ~2x with the tokens), so the LM is
  held, in RMS over the logits of a forward at S = 128 and of 64 decode
  steps, to round no worse than the reference: the port's bf16 logits lie
  within 1.25x the JAX bf16 logits' RMS distance from the f32 logits of the
  same bf16 params, and within 1.5x of it from the JAX bf16 logits.
  Measured over six token draws: the port's distance 0.027-0.037 against
  the reference's 0.028-0.036 (ratio <= 1.09), the two bf16 runs 0.024-
  0.029 apart.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import pruning_lm as jax_pruning
from repro.core.plan import RunResult as JaxRunResult
from repro.models import layers as jax_layers
from repro.models.lm import LM as JaxLM
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import load_servable as jax_load_servable
from repro_torch import interop
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import pruning_lm
from repro_torch.core.plan import RunResult
from repro_torch.models import layers
from repro_torch.models.lm import LM
from repro_torch.serving import (
    DecodeEngine,
    ServeConfig,
    load_servable,
    lockstep_decode,
)
from repro_torch.utils.tree import tree_leaves, tree_map
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

XL = jax_get_config("xlstm-125m").reduced(num_layers=4)
BLOCK_TOL = 1e-5
STEP_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = 2e-4
BF16_BLOCK_TOL = 2.0 ** -6
BF16_RATIO = 1.25
BF16_APART = 1.5
SEQ, STEPS, B = 128, 64, 2


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_cfg(cfg):
    return ModelConfig.from_dict(cfg.to_dict())


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rms(a) -> float:
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


def _rel(got, want) -> float:
    """max |got - want| over max(1, max |want|)."""
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


_JAX = {}


def _jax(cfg):
    """The JAX model of ``cfg`` with its jitted init, apply and decode step,
    built once per config."""
    if cfg not in _JAX:
        jm = JaxLM(cfg)
        _JAX[cfg] = {
            "model": jm,
            "params": jax.jit(jm.init)(jax.random.key(0)),
            "apply": jax.jit(lambda p, t: jm.apply(p, {"tokens": t})[0]),
            "step": jax.jit(jm.decode_step)}
    return _JAX[cfg]


@pytest.fixture(scope="module")
def world():
    """The f32 JAX params, their port copy and a token stream."""
    j = _jax(XL)
    tokens = np.random.default_rng(0).integers(
        0, XL.vocab_size, (B, SEQ + 1)).astype(np.int32)
    return {"jparams": j["params"],
            "params": interop.params_from_jax(_np_tree(j["params"]), "cpu"),
            "tokens": tokens}


def _jax_decode(cfg, tokens, cache=None):
    """JAX decode of ``tokens`` [B,T] from a fresh cache or ``cache``:
    logits [T,B,V] and the final cache."""
    j = _jax(cfg)
    if cache is None:
        cache = j["model"].init_cache(tokens.shape[0], tokens.shape[1])
    outs = []
    for t in range(tokens.shape[1]):
        logits, cache = j["step"](j["params"], cache,
                                  {"tokens": jnp.asarray(tokens[:, t:t + 1])})
        outs.append(_f32(logits[:, 0]))
    return np.stack(outs), cache


def _port_decode(model, params, tokens, cache=None):
    if cache is None:
        cache = model.init_cache(tokens.shape[0], tokens.shape[1])
    outs = []
    with torch.no_grad():
        for t in range(tokens.shape[1]):
            logits, cache = model.decode_step(
                params, cache, {"tokens": torch.from_numpy(tokens[:, t:t + 1])})
            outs.append(_f32(logits[:, 0]))
    return np.stack(outs), cache


class TestConfig:
    def test_config_copy_and_layer_kinds(self):
        assert "xlstm-125m" in ARCH_NAMES
        full = get_config("xlstm-125m")
        assert full.to_dict() == jax_get_config("xlstm-125m").to_dict()
        assert full.reduced(num_layers=4).to_dict() == XL.to_dict()
        model = LM(_port_cfg(XL), device="cpu")
        assert [model._is_slstm(i) for i in range(4)] == [False] * 3 + [True]
        assert layers.mlstm_meta(model.cfg) == {"f": 512, "nh": 4, "hd": 128}
        assert not any(LM(full, device="cpu")._is_slstm(i)
                       for i in (0, 1, 2, 4, 5, 6, 8, 9, 10))

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_init_layouts_and_dtypes_match_jax(self, dtype):
        """Leaf for leaf the JAX tree's shapes and dtypes: ``w_if`` and the
        sLSTM ``bias`` stay f32 in a bf16 model."""
        cfg = dataclasses.replace(XL, param_dtype=dtype)
        want = jax.eval_shape(JaxLM(cfg).init, jax.random.key(0))
        got = LM(_port_cfg(cfg), device="cpu").init(
            torch.Generator().manual_seed(0))
        assert jax.tree.structure(want) == jax.tree.structure(got)
        for w, g in zip(jax.tree.leaves(want), tree_leaves(got)):
            assert tuple(g.shape) == w.shape
            assert str(g.dtype).split(".")[-1] == str(w.dtype)
        assert got["blocks"]["l0"]["cell"]["w_if"].dtype == torch.float32
        assert got["blocks"]["l3"]["cell"]["bias"].dtype == torch.float32

    def test_bf16_tree_round_trips_leaf_for_leaf(self):
        jp = _np_tree(_jax(dataclasses.replace(
            XL, param_dtype="bfloat16"))["params"])
        port = interop.params_from_jax(jp, "cpu")
        assert port["blocks"]["l0"]["cell"]["up"].dtype == torch.bfloat16
        back = interop.params_to_numpy(port)
        for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
            np.testing.assert_array_equal(np.asarray(a, np.float32), b)


class TestBlocks:
    @pytest.mark.parametrize("seq", [32, 128], ids=["one-chunk", "two-chunks"])
    @pytest.mark.parametrize("layer", ["l0", "l3"], ids=["mlstm", "slstm"])
    def test_block_matches_jax(self, world, layer, seq):
        cfg = _port_cfg(XL)
        meta = layers.mlstm_meta(cfg)
        fn, jfn = ((layers.apply_mlstm, jax_layers.apply_mlstm) if layer == "l0"
                   else (layers.apply_slstm, jax_layers.apply_slstm))
        x = np.random.default_rng(1).standard_normal(
            (B, seq, XL.d_model)).astype(np.float32)
        want = jax.jit(lambda p, x: jfn(p, x, meta, XL))(
            world["jparams"]["blocks"][layer]["cell"], jnp.asarray(x))
        with torch.no_grad():
            got = fn(world["params"]["blocks"][layer]["cell"],
                     torch.from_numpy(x), meta, cfg)
        assert got.shape == (B, seq, XL.d_model)
        assert _rel(got, want) <= BLOCK_TOL

    def test_both_refuse_a_sequence_off_the_chunk(self, world):
        """S = 100 > 64 is not a multiple of the chunk: the reference's
        reshape fails; the port says why."""
        meta = layers.mlstm_meta(_port_cfg(XL))
        x = np.zeros((1, 100, XL.d_model), np.float32)
        with pytest.raises(TypeError, match="reshape"):
            jax_layers.apply_mlstm(world["jparams"]["blocks"]["l0"]["cell"],
                                   jnp.asarray(x), meta, XL)
        with pytest.raises(ValueError, match="multiple of the scan's chunk"):
            layers.apply_mlstm(world["params"]["blocks"]["l0"]["cell"],
                               torch.from_numpy(x), meta, _port_cfg(XL))

    @pytest.mark.parametrize("layer", ["l0", "l3"], ids=["mlstm", "slstm"])
    def test_bf16_block_matches_jax(self, layer):
        cfg = dataclasses.replace(XL, param_dtype="bfloat16")
        jp = _jax(cfg)["params"]["blocks"][layer]["cell"]
        params = interop.params_from_jax(_np_tree(jp), "cpu")
        meta = layers.mlstm_meta(_port_cfg(cfg))
        fn, jfn = ((layers.apply_mlstm, jax_layers.apply_mlstm) if layer == "l0"
                   else (layers.apply_slstm, jax_layers.apply_slstm))
        x = jnp.asarray(np.random.default_rng(2).standard_normal(
            (B, SEQ, XL.d_model)), jnp.bfloat16)
        want = jax.jit(lambda p, x: jfn(p, x, meta, cfg))(jp, x)
        with torch.no_grad():
            got = fn(params, interop.params_from_jax({"x": x}, "cpu")["x"],
                     meta, _port_cfg(cfg))
        assert got.dtype == torch.bfloat16
        assert _rel(got, want) <= BF16_BLOCK_TOL

    def test_init_states_match_jax(self):
        meta = layers.mlstm_meta(_port_cfg(XL))
        for got, want in (
                (layers.mlstm_init_state(3, meta, "cpu"),
                 jax_layers.mlstm_init_state(3, meta, jnp.bfloat16)),
                (layers.slstm_init_state(3, XL.d_model, "cpu"),
                 jax_layers.slstm_init_state(3, XL.d_model, jnp.bfloat16))):
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.dtype == torch.float32 and str(w.dtype) == "float32"
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    @pytest.mark.parametrize("layer", ["l0", "l3"], ids=["mlstm", "slstm"])
    def test_decode_steps_match_jax_from_a_random_state(self, world, layer):
        """Four steps of one cell from a random state (the mLSTM's m around
        0, where its stabiliser is active): the output and the state,
        updated in place, match the JAX function's returned state."""
        cfg = _port_cfg(XL)
        meta = layers.mlstm_meta(cfg)
        rng = np.random.default_rng(3)
        if layer == "l0":
            fn, jfn = layers.mlstm_decode, jax_layers.mlstm_decode
            shapes = [(B, 4, 128, 128), (B, 4, 128), (B, 4)]
        else:
            fn, jfn = layers.slstm_decode, jax_layers.slstm_decode
            shapes = [(B, XL.d_model)] * 4
        init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        if layer == "l3":
            init[1] = np.abs(init[1]) + 0.5            # the normaliser n > 0
        state = tuple(torch.tensor(a) for a in init)
        jstate = tuple(jnp.asarray(a) for a in init)
        storage = [t.data_ptr() for t in state]
        jcell = world["jparams"]["blocks"][layer]["cell"]
        cell = world["params"]["blocks"][layer]["cell"]
        for _ in range(4):
            x = rng.standard_normal((B, 1, XL.d_model)).astype(np.float32)
            want, jstate = jfn(jcell, jnp.asarray(x), jstate, meta, XL)
            with torch.no_grad():
                got = fn(cell, torch.from_numpy(x), state, meta, cfg)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **STEP_TOL)
            for t, w in zip(state, jstate):
                np.testing.assert_allclose(t.numpy(), np.asarray(w),
                                           **STEP_TOL)
        assert [t.data_ptr() for t in state] == storage


class TestLM:
    def test_logits_match_jax(self, world):
        tokens = world["tokens"][:, :SEQ]
        want = _jax(XL)["apply"](world["jparams"], jnp.asarray(tokens))
        with torch.no_grad():
            got = LM(_port_cfg(XL), device="cpu").apply(
                world["params"], {"tokens": torch.from_numpy(tokens)})
        assert got.shape == (B, SEQ, XL.vocab_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    def test_loss_gradient_matches_jax(self, world):
        tokens = world["tokens"]
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        jm = _jax(XL)["model"]
        jl, jg = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, batch)))(
            world["jparams"])
        params = tree_map(lambda t: t.clone().requires_grad_(True),
                          world["params"])
        loss = LM(_port_cfg(XL), device="cpu").loss(
            params, {k: torch.from_numpy(v) for k, v in batch.items()})
        loss.backward()
        np.testing.assert_allclose(float(loss), float(jl), **STEP_TOL)
        for got, want in zip(tree_leaves(params), jax.tree.leaves(jg)):
            want = np.asarray(want)
            err = np.abs(got.grad.numpy() - want).max()
            assert err <= GRAD_TOL * np.abs(want).max()

    def test_remat_is_ignored_as_in_the_reference(self, world):
        """The full config keeps ``remat="block"``; the ssm branch takes no
        checkpoint and raises on no remat setting."""
        tokens = torch.from_numpy(world["tokens"][:, :32])
        with torch.no_grad():
            plain = LM(_port_cfg(XL), device="cpu").apply(
                world["params"], {"tokens": tokens})
            for remat in ("block", "dots"):
                got = LM(_port_cfg(dataclasses.replace(XL, remat=remat)),
                         device="cpu").apply(world["params"],
                                             {"tokens": tokens})
                torch.testing.assert_close(got, plain, atol=0, rtol=0)

    def test_masks_are_refused_in_both_packages(self, world):
        masks = {"mlp": np.ones((4, 128), np.float32)}
        tokens = world["tokens"][:, :32]
        jm, model = _jax(XL)["model"], LM(_port_cfg(XL), device="cpu")
        with pytest.raises(ValueError, match="scanned stack"):
            jm.apply(world["jparams"], {"tokens": tokens}, masks=masks)
        with pytest.raises(ValueError, match="scanned stack"):
            jm.decode_step(world["jparams"], jm.init_cache(B, 4),
                           {"tokens": tokens[:, :1]}, masks=masks)
        tmasks = interop.masks_from_jax(masks, "cpu")
        with pytest.raises(ValueError, match="scanned stack"):
            model.apply(world["params"],
                        {"tokens": torch.from_numpy(tokens)}, masks=tmasks)
        with pytest.raises(ValueError, match="scanned stack"):
            model.decode_step(world["params"], model.init_cache(B, 4),
                              {"tokens": torch.from_numpy(tokens[:, :1])},
                              masks=tmasks)

    def test_fedap_seam_is_refused_in_both_packages(self, world):
        """The family has no FFN: the FedAP decision refuses it."""
        with pytest.raises(ValueError, match="family ssm"):
            jax_pruning.ffn_kept_indices(world["jparams"], XL, 0.5)
        with pytest.raises(ValueError, match="family ssm"):
            _jax(XL)["model"].decide_kept(world["jparams"], 0.5)
        with pytest.raises(ValueError, match="family ssm"):
            pruning_lm.ffn_kept_indices(world["params"], _port_cfg(XL), 0.5)
        with pytest.raises(ValueError, match="family ssm"):
            LM(_port_cfg(XL), device="cpu").decide_kept(world["params"], 0.5)


class TestDecode:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_cache_matches_jax_structure_and_dtypes(self, dtype):
        cfg = dataclasses.replace(XL, param_dtype=dtype)
        want = JaxLM(cfg).init_cache(3, 100)
        got = LM(_port_cfg(cfg), device="cpu").init_cache(3, 100)
        assert jax.tree.structure(want) == jax.tree.structure(got)
        for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            assert tuple(g.shape) == w.shape
            assert str(g.dtype).split(".")[-1] == str(w.dtype)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    def test_steps_match_jax_decode(self, world):
        """64 steps, logits step by step; every state tensor of the cache
        at the end, each updated in its own storage."""
        tokens = world["tokens"][:, :STEPS]
        want, jcache = _jax_decode(XL, tokens)
        model = LM(_port_cfg(XL), device="cpu")
        cache = model.init_cache(B, STEPS)
        storage = [t.data_ptr() for t in tree_leaves(cache)[1:]]
        got, cache = _port_decode(model, world["params"], tokens, cache)
        np.testing.assert_allclose(got, want, **TOL)
        assert jax.tree.structure(jcache) == jax.tree.structure(cache)
        assert int(cache["index"]) == STEPS
        for g, w in zip(tree_leaves(cache), jax.tree.leaves(jcache)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        assert [t.data_ptr() for t in tree_leaves(cache)[1:]] == storage

    def test_start_from_a_jax_mid_stream_cache(self, world):
        """A JAX cache 40 steps in converts leaf for leaf, tuples kept, and
        both packages decode on from it alike."""
        tokens = world["tokens"][:, :STEPS]
        _, jcache = _jax_decode(XL, tokens[:, :40])
        cache = interop.cache_from_jax(_np_tree(jcache), "cpu")
        assert cache["index"].dtype == torch.int32
        assert int(cache["index"]) == 40
        assert isinstance(cache["l0"], tuple) and len(cache["l3"]) == 4
        assert all(t.dtype == torch.float32 for t in tree_leaves(cache)[1:])
        want, jcache = _jax_decode(XL, tokens[:, 40:], cache=jcache)
        got, cache = _port_decode(LM(_port_cfg(XL), device="cpu"),
                                  world["params"], tokens[:, 40:], cache)
        np.testing.assert_allclose(got, want, **TOL)
        for g, w in zip(tree_leaves(cache), jax.tree.leaves(jcache)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)

    def test_decode_reproduces_the_port_apply(self, world):
        tokens = world["tokens"][:, :STEPS]
        model = LM(_port_cfg(XL), device="cpu")
        got, _ = _port_decode(model, world["params"], tokens)
        with torch.no_grad():
            full = model.apply(world["params"],
                               {"tokens": torch.from_numpy(tokens)})
        np.testing.assert_allclose(got.transpose(1, 0, 2), full.numpy(),
                                   atol=1e-4, rtol=0)

    def test_bf16_rounds_no_worse_than_the_reference(self):
        """bf16 forward (S = 128) and 64 decode steps: the port's logits
        and the JAX package's, each against the f32 logits of the same bf16
        params."""
        cfg = dataclasses.replace(XL, param_dtype="bfloat16")
        j = _jax(cfg)
        params = interop.params_from_jax(_np_tree(j["params"]), "cpu")
        model = LM(_port_cfg(cfg), device="cpu")
        exact = LM(_port_cfg(XL), device="cpu")
        p32 = tree_map(lambda t: t.float(), params)
        tokens = np.random.default_rng(4).integers(
            0, XL.vocab_size, (B, SEQ)).astype(np.int32)
        with torch.no_grad():
            got = model.apply(params, {"tokens": torch.from_numpy(tokens)})
            truth = exact.apply(p32, {"tokens": torch.from_numpy(tokens)})
        assert got.dtype == torch.bfloat16
        want = j["apply"](j["params"], jnp.asarray(tokens))
        dec, _ = _port_decode(model, params, tokens[:, :STEPS])
        jdec, _ = _jax_decode(cfg, tokens[:, :STEPS])
        dec_truth, _ = _port_decode(exact, p32, tokens[:, :STEPS])
        for port, ref, f32 in ((got, want, truth), (dec, jdec, dec_truth)):
            port, ref, f32 = _f32(port), _f32(ref), _f32(f32)
            ref_err = _rms(ref - f32)
            assert _rms(port - f32) <= BF16_RATIO * ref_err
            assert _rms(port - ref) <= BF16_APART * ref_err


def _reference_greedy(jparams, prompt, n_new):
    """The reference's lockstep loop (``serve_lockstep``): prefill one token a
    step, feed the argmax, record the argmax of each decode step."""
    j = _jax(XL)
    cache = j["model"].init_cache(prompt.shape[0], prompt.shape[1] + n_new)
    for t in range(prompt.shape[1]):
        logits, cache = j["step"](jparams, cache,
                                  {"tokens": jnp.asarray(prompt[:, t:t + 1])})
    tok = jnp.argmax(logits[:, -1], -1)[:, None]
    out = []
    for _ in range(n_new):
        logits, cache = j["step"](jparams, cache,
                                  {"tokens": tok.astype(jnp.int32)})
        tok = jnp.argmax(logits[:, -1], -1)[:, None]
        out.append(np.asarray(tok[:, 0]))
    return np.stack(out, 1)


class TestServing:
    def test_lockstep_tokens_equal_the_reference_loop(self, world):
        prompt = world["tokens"][:, :24]
        want = _reference_greedy(world["jparams"], prompt, 24)
        got, steps = lockstep_decode(LM(_port_cfg(XL), device="cpu"),
                                     world["params"], torch.from_numpy(prompt),
                                     24)
        assert steps == 48 and got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)

    def test_decode_engine_refuses_a_real_xlstm_in_both_packages(self,
                                                                 world):
        scfg = dict(slots=1, cache_len=8, max_prompt=4, max_new_tokens=4)
        with pytest.raises(ValueError, match="scanned-KV"):
            JaxEngine(_jax(XL)["model"], world["jparams"],
                      JaxServeConfig(**scfg))
        with pytest.raises(ValueError, match="lockstep_decode"):
            DecodeEngine(LM(_port_cfg(XL), device="cpu"), world["params"],
                         ServeConfig(**scfg), device="cpu")

    @pytest.mark.parametrize("saver", ["jax", "port"])
    def test_load_servable_scores_a_checkpoint_to_the_jax_loss(
            self, world, tmp_path, saver):
        """A dense checkpoint written by either package scores through the
        port's ``load_servable`` -> ``loss_and_acc`` to the JAX loss and
        token accuracy; the reference's ``load_servable`` reads it too."""
        if saver == "jax":
            JaxRunResult(params=world["jparams"], history={"round": [1]},
                         artifacts={}, state={}).save(tmp_path / "ckpt",
                                                      model_config=XL)
        else:
            RunResult(params=world["params"], history={"round": [1]},
                      artifacts={}, state={}).save(
                tmp_path / "ckpt", model_config=get_config(
                    "xlstm-125m").reduced(num_layers=4))
        sv = load_servable(tmp_path / "ckpt", "dense", device="cpu")
        jsv = jax_load_servable(tmp_path / "ckpt", "dense")
        assert sv.mode == jsv.mode == "dense" and sv.masks is None
        assert sv.model.cfg.to_dict() == jsv.model.cfg.to_dict()
        x, y = world["tokens"][:, :-1], world["tokens"][:, 1:]
        jloss, jacc = jsv.model.loss_and_acc(jsv.params, jnp.asarray(x),
                                             jnp.asarray(y))
        with torch.no_grad():
            loss, acc = sv.model.loss_and_acc(sv.params, torch.from_numpy(x),
                                              torch.from_numpy(y))
        np.testing.assert_allclose(float(loss), float(jloss), **STEP_TOL)
        np.testing.assert_allclose(float(acc), float(jacc), atol=1e-6)
