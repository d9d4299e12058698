"""The encdec family (whisper-small reduced) of the port against the JAX
package.

whisper's reduced config with its own head layout: 2 encoder and 2 decoder
layers, d 256, 12 heads padded to 16 with KV padded alongside (MHA: 16
over 16) of 64, d_ff 512, vocab 512, 64 encoder frames, layernorm, GELU,
no rope.  (``reduced()`` alone keeps 4 heads, padded to 16 over 4 kv
heads: a GQA layout the model never has.)  JAX ``LM.init`` (jitted) ->
``interop.params_from_jax`` -> the port on the CPU, f32 with TF32 off.

* the encoder (``_encode``: ``enc_pos``, bidirectional attention, FFN,
  ``norm_enc``), the logits and the loss within 1e-5, the loss's gradient
  within 1e-5 of each leaf's max;
* ``init_cache``'s ``self``/``cross``/``index`` tree and ``prefill_cross``'s
  cross K/V, then the decode step's logits step by step against the JAX
  decode (``attn_impl="xla"``: the port attends the valid prefix);
* ``lockstep_decode`` with encoder frames: its tokens equal the reference
  script's ``serve_lockstep`` loop (``prefill_cross`` once, then the
  prompt);
* ``attn_impl="pallas"`` (K4's plain version here, causal on the decoder
  and without the mask on the cross-attention at Sq != Skv) against
  ``"xla"``;
* ``load_servable`` dense scoring of either package's checkpoint;
* the refusals, each as the reference refuses: ``masks=``,
  ``DecodeEngine``, ``loss_and_acc`` (so ``FederatedTrainer``),
  ``fedap_lm``, and ``load_servable``'s masked and shrunk modes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import pruning_lm as jax_pruning
from repro.core.plan import RunResult as JaxRunResult
from repro.models.lm import LM as JaxLM
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import load_servable as jax_load_servable
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import pruning_lm
from repro_torch.core.plan import RunResult, TrainPlan
from repro_torch.core.rounds import FederatedTrainer, feddumap_config
from repro_torch.data.pipeline import build_lm_federated_data
from repro_torch.data.synthetic import TokenSpec
from repro_torch.models.lm import LM
from repro_torch.serving import (DecodeEngine, ServeConfig, load_servable,
                                 lockstep_decode)
from repro_torch.utils.tree import tree_leaves, tree_map
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CFG = jax_get_config("whisper-small").reduced(num_heads=12, num_kv_heads=12)
TOL = 1e-5
B, SEQ = 2, 24


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel(got, want) -> float:
    """max |got - want| over max(1, max |want|)."""
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _port_cfg():
    return ModelConfig.from_dict(CFG.to_dict())


@pytest.fixture(scope="module")
def world():
    jm = JaxLM(CFG)
    jparams = jax.jit(jm.init)(jax.random.key(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, CFG.vocab_size, (B, SEQ + 1)).astype(np.int32)
    frames = rng.standard_normal(
        (B, CFG.encoder.frames, CFG.d_model)).astype(np.float32)
    return {"jm": jm, "jparams": jparams,
            "params": interop.params_from_jax(_np_tree(jparams), "cpu"),
            "model": LM(_port_cfg(), device="cpu"), "tokens": tokens,
            "frames": frames,
            "batch": {"tokens": tokens[:, :-1], "labels": tokens[:, 1:],
                      "enc_embeds": frames}}


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


class TestConfig:
    def test_registry_and_reduced_layout(self):
        cfg = get_config("whisper-small")
        assert cfg.to_dict() == jax_get_config("whisper-small").to_dict()
        assert (cfg.padded_num_heads, cfg.padded_num_kv_heads,
                cfg.resolved_head_dim) == (16, 16, 64)
        small = _port_cfg()
        assert (small.num_layers, small.encoder.num_layers,
                small.encoder.frames, small.padded_num_heads,
                small.padded_num_kv_heads) == (2, 2, 64, 16, 16)
        assert cfg.reduced().padded_num_kv_heads == 4

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_param_tree_matches_jax(self, world, dtype):
        """The unstacked ``encoder``/``decoder`` trees leaf for leaf; no
        encdec leaf is one that the reference keeps in f32, so a bf16 cast
        casts every leaf (a layernorm bias is not the sLSTM cell's)."""
        params = world["model"].init(torch.Generator().manual_seed(0))
        assert jax.tree.structure(_np_tree(world["jparams"])) == \
            jax.tree.structure(params)
        for w, g in zip(jax.tree.leaves(world["jparams"]),
                        tree_leaves(params)):
            assert tuple(g.shape) == w.shape
        assert set(params["decoder"]["l0"]) == {
            "attn", "norm_a", "xattn", "norm_x", "mlp", "norm_f"}
        cast = interop.params_from_jax(_np_tree(world["jparams"]), "cpu",
                                       getattr(torch, dtype))
        assert {t.dtype for t in tree_leaves(cast)} == {getattr(torch, dtype)}
        # the padded heads' wo rows are zero in the cross-attention too
        wo = params["decoder"]["l1"]["xattn"]["wo"]
        assert float(wo[CFG.num_heads:].abs().max()) == 0.0


class TestForward:
    def test_encoder_equals_jax(self, world):
        want = jax.jit(world["jm"]._encode)(
            world["jparams"], {"enc_embeds": jnp.asarray(world["frames"])})
        with torch.no_grad():
            got = world["model"]._encode(
                world["params"],
                {"enc_embeds": torch.from_numpy(world["frames"])})
        assert _rel(got, want) <= TOL

    def test_logits_and_loss_equal_jax(self, world):
        batch = world["batch"]
        want, _ = jax.jit(world["jm"].apply)(world["jparams"], _j(batch))
        jl = float(jax.jit(world["jm"].loss)(world["jparams"], _j(batch)))
        with torch.no_grad():
            got = world["model"].apply(world["params"], _t(batch))
            loss = float(world["model"].loss(world["params"], _t(batch)))
        assert _rel(got, want) <= TOL
        assert abs(loss - jl) <= TOL * jl

    def test_loss_gradient_equals_jax(self, world):
        batch = world["batch"]
        jg = jax.jit(jax.grad(world["jm"].loss))(world["jparams"], _j(batch))
        params = tree_map(lambda t: t.clone().requires_grad_(True),
                          world["params"])
        world["model"].loss(params, _t(batch)).backward()
        got = [t.grad for t in tree_leaves(params)]
        want = jax.tree.leaves(jg)
        assert len(got) == len(want) and all(g is not None for g in got)
        for g, w in zip(got, want):
            w = np.asarray(w)
            err = float(np.abs(g.numpy() - w).max())
            assert err <= TOL * max(float(np.abs(w).max()), 1e-30), err

    def test_pallas_equals_xla(self, world):
        """K4's path (its plain version on the CPU): causal on the decoder's
        self-attention, no mask on the cross-attention (Sq = 24, Skv = 64);
        the encoder's attention is the plain one either way."""
        batch = _t(world["batch"])
        pallas = LM(_port_cfg(), attn_impl="pallas", device="cpu")
        with torch.no_grad():
            want = world["model"].apply(world["params"], batch)
            got = pallas.apply(world["params"], batch)
        assert _rel(got, want) <= TOL


def _jax_decode(world, steps):
    jm = world["jm"]
    step = jax.jit(jm.decode_step)
    cache = jm.init_cache(B, 32)
    cache = jm.prefill_cross(world["jparams"], cache,
                             {"enc_embeds": jnp.asarray(world["frames"])})
    outs = []
    for t in range(steps):
        logits, cache = step(world["jparams"], cache, {
            "tokens": jnp.asarray(world["tokens"][:, t:t + 1])})
        outs.append(_f32(logits[:, 0]))
    return np.stack(outs), cache


class TestDecode:
    def test_cache_and_prefill_cross_equal_jax(self, world):
        jm, model = world["jm"], world["model"]
        want = jm.init_cache(B, 32)
        got = model.init_cache(B, 32)
        assert jax.tree.structure(want) == jax.tree.structure(got)
        for w, g in zip(jax.tree.leaves(want), tree_leaves(got)):
            assert tuple(g.shape) == w.shape
        assert tuple(got["cross"]["k"].shape) == (2, B, 64, 16, 64)
        want = jm.prefill_cross(world["jparams"], want,
                                {"enc_embeds": jnp.asarray(world["frames"])})
        out = model.prefill_cross(
            world["params"], got,
            {"enc_embeds": torch.from_numpy(world["frames"])})
        assert out["cross"]["k"] is got["cross"]["k"]        # in place
        for side in ("k", "v"):
            assert _rel(got["cross"][side], want["cross"][side]) <= TOL
        assert not got["cross"]["k"].requires_grad

    def test_steps_match_jax_decode(self, world):
        want, jcache = _jax_decode(world, SEQ)
        model = world["model"]
        cache = model.init_cache(B, 32)
        model.prefill_cross(world["params"], cache, {
            "enc_embeds": torch.from_numpy(world["frames"])})
        got = []
        with torch.no_grad():
            for t in range(SEQ):
                logits, cache = model.decode_step(world["params"], cache, {
                    "tokens": torch.from_numpy(world["tokens"][:, t:t + 1])})
                got.append(_f32(logits[:, 0]))
        assert _rel(np.stack(got), want) <= TOL
        for g, w in zip(tree_leaves(cache), jax.tree.leaves(jcache)):
            assert _rel(g, w) <= TOL
        # the JAX cache, taken mid-stream, converts leaf for leaf
        carried = interop.cache_from_jax(_np_tree(jcache), "cpu")
        assert set(carried) == {"self", "cross", "index"}
        assert int(carried["index"]) == SEQ

    def test_decode_carries_on_the_full_sequence_logits(self, world):
        """Teacher-forced decode equals the full-sequence forward."""
        model = world["model"]
        cache = model.init_cache(B, 32)
        model.prefill_cross(world["params"], cache, {
            "enc_embeds": torch.from_numpy(world["frames"])})
        with torch.no_grad():
            full = model.apply(world["params"], _t(world["batch"]))
            for t in range(SEQ):
                logits, cache = model.decode_step(world["params"], cache, {
                    "tokens": torch.from_numpy(world["tokens"][:, t:t + 1])})
                assert _rel(logits[:, 0], full[:, t]) <= TOL

    def test_lockstep_tokens_equal_the_reference_loop(self, world):
        """The reference script's ``serve_lockstep``: cross K/V once, the
        prompt a token a step, then greedy argmax (run with the JAX
        model)."""
        rng = np.random.default_rng(5)
        prompt = rng.integers(0, CFG.vocab_size, (3, 4)).astype(np.int32)
        frames = rng.standard_normal(
            (3, CFG.encoder.frames, CFG.d_model)).astype(np.float32)
        n_new = 12
        jm = world["jm"]
        step = jax.jit(jm.decode_step)
        extra = {"enc_embeds": jnp.asarray(frames)}
        cache = jm.prefill_cross(world["jparams"], jm.init_cache(3, 16),
                                 extra)
        for t in range(prompt.shape[1]):
            logits, cache = step(world["jparams"], cache, {
                "tokens": jnp.asarray(prompt[:, t:t + 1]), **extra})
        want, tok = [], jnp.argmax(logits[:, -1], -1)[:, None]
        for _ in range(n_new):
            logits, cache = step(world["jparams"], cache,
                                 {"tokens": tok.astype(jnp.int32), **extra})
            tok = jnp.argmax(logits[:, -1], -1)[:, None]
            want.append(np.asarray(tok[:, 0]))
        got, steps = lockstep_decode(world["model"], world["params"],
                                     torch.from_numpy(prompt), n_new,
                                     enc_embeds=torch.from_numpy(frames))
        assert steps == 4 + n_new
        np.testing.assert_array_equal(got.numpy(), np.stack(want, 1))
        with pytest.raises(ValueError, match="enc_embeds"):
            lockstep_decode(world["model"], world["params"],
                            torch.from_numpy(prompt), n_new)


class TestServing:
    @pytest.mark.parametrize("saver", ["jax", "port"])
    def test_load_servable_dense_scores_as_jax(self, world, tmp_path, saver):
        if saver == "jax":
            JaxRunResult(params=world["jparams"], history={"round": [1]},
                         artifacts={}, state={}).save(tmp_path / "ckpt",
                                                      model_config=CFG)
        else:
            RunResult(params=world["params"], history={"round": [1]},
                      artifacts={}, state={}).save(
                tmp_path / "ckpt",
                model_config=get_config("whisper-small").reduced(
                    num_heads=12, num_kv_heads=12))
        sv = load_servable(tmp_path / "ckpt", device="cpu")
        jsv = jax_load_servable(tmp_path / "ckpt")
        assert sv.mode == jsv.mode == "dense" and sv.masks is None
        assert sv.model.attn_impl == "pallas"
        batch = world["batch"]
        want = float(jax.jit(jsv.model.loss)(jsv.params, _j(batch)))
        with torch.no_grad():
            got = float(sv.model.loss(sv.params, _t(batch)))
        assert abs(got - want) <= TOL * want

    @pytest.mark.parametrize("mode", ["masked", "shrunk"])
    def test_load_servable_refuses_masked_and_shrunk(self, world, mode):
        """Without a decision both packages ask for a pruned checkpoint;
        with one, the reference fails on the missing ``layers`` stack and
        the port says why."""
        art = {"params": _np_tree(world["jparams"]), "model_config": CFG}
        with pytest.raises(ValueError, match="pruned checkpoint"):
            jax_load_servable(art, mode)
        with pytest.raises(ValueError, match="pruned checkpoint"):
            load_servable(art, mode, device="cpu")
        kept = {"mlp": np.arange(256)[None].repeat(2, 0)}
        with pytest.raises(KeyError):
            jax_load_servable({**art, "kept": kept}, mode)
        with pytest.raises(ValueError, match="family 'encdec'"):
            load_servable({**art, "kept": kept}, mode, device="cpu")


class TestRefusals:
    def test_masks_are_refused_in_both_packages(self, world):
        batch = world["batch"]
        masks = {"mlp": np.ones((2, CFG.d_ff), np.float32)}
        with pytest.raises(ValueError, match="not family 'encdec'"):
            world["jm"].apply(world["jparams"], _j(batch),
                              masks=jax.tree.map(jnp.asarray, masks))
        with pytest.raises(ValueError, match="not family 'encdec'"):
            world["model"].apply(world["params"], _t(batch),
                                 masks=_t(masks))
        cache = world["model"].init_cache(B, 8)
        with pytest.raises(ValueError, match="not family 'encdec'"):
            world["model"].decode_step(world["params"], cache, {
                "tokens": torch.zeros((B, 1), dtype=torch.int32)},
                masks=_t(masks))

    def test_decode_engine_is_refused_in_both_packages(self, world):
        scfg = dict(slots=2, cache_len=8, max_prompt=4, max_new_tokens=4)
        with pytest.raises(ValueError, match="'encdec'"):
            JaxEngine(world["jm"], world["jparams"], JaxServeConfig(**scfg))
        with pytest.raises(ValueError, match="'encdec'"):
            DecodeEngine(world["model"], world["params"],
                         ServeConfig(**scfg), device="cpu")

    def test_loss_and_acc_and_the_trainer_are_refused(self, world):
        """The trainer's contract is ``loss_and_acc(params, tokens,
        labels)``: the reference raises ``KeyError`` on the missing
        encoder frames, the port a ``ValueError`` that names them, so
        ``FederatedTrainer`` refuses the family at its first step."""
        x, y = world["tokens"][:, :-1], world["tokens"][:, 1:]
        with pytest.raises(KeyError, match="enc_embeds"):
            world["jm"].loss_and_acc(world["jparams"], jnp.asarray(x),
                                     jnp.asarray(y))
        with pytest.raises(ValueError, match="enc_embeds"):
            world["model"].loss_and_acc(world["params"], torch.from_numpy(x),
                                        torch.from_numpy(y))
        data = build_lm_federated_data(num_clients=2, spec=TokenSpec(
            vocab_size=CFG.vocab_size, num_topics=4, seq_len=9,
            num_sequences=32))
        trainer = FederatedTrainer(
            world["model"], data,
            feddumap_config(num_clients=2, clients_per_round=1,
                            batch_size=2, server_batch_size=2),
            device="cpu")
        with pytest.raises(ValueError, match="enc_embeds"):
            trainer.run(TrainPlan.standard(1), params=world["params"])

    def test_fedap_is_refused_in_both_packages(self, world):
        for fn in ("fedap_lm", "ffn_kept_indices"):
            with pytest.raises(ValueError, match="family encdec"):
                getattr(jax_pruning, fn)(world["jparams"], CFG, 0.5)
            with pytest.raises(ValueError, match="family encdec"):
                getattr(pruning_lm, fn)(world["params"], _port_cfg(), 0.5)
