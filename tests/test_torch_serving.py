"""The port's DecodeEngine and load_servable against the JAX package.

Same params (converted with ``interop``), same ragged prompts: the port's
continuous-batching engine on the CPU must emit the JAX engine's tokens and
uids exactly, dense and masked; a checkpoint directory written by the JAX
``RunResult.save`` must serve through the port's ``load_servable`` in every
mode.  Also held: eos, interleaved submission, backpressure, config
validation and the in-wave non-finite guard.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.core import pruning_lm as jax_pruning
from repro.core.plan import RunResult
from repro.models.lm import LM as JaxLM
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import load_servable as jax_load_servable
from repro_torch import interop
from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import CheckpointError
from repro_torch.models.lm import LM
from repro_torch.serving import (
    DecodeEngine,
    QueueFull,
    Servable,
    ServeConfig,
    load_servable,
)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CFG = JaxModelConfig(name="dense-tiny", family="dense", rope="1d",
                     norm="rmsnorm", act="silu", param_dtype="float32",
                     remat="none", num_layers=2, d_model=128, num_heads=4,
                     num_kv_heads=2, d_ff=512, vocab_size=2048)
SCFG = dict(slots=2, cache_len=8, max_prompt=4, max_new_tokens=4,
            steps_per_wave=3)


def ragged_prompts(n, max_prompt, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(1, max_prompt + 1)))
            .astype(np.int32) for _ in range(n)]


@pytest.fixture(scope="module")
def world():
    """JAX model/params/keep decision/masks and their port twins."""
    jmodel = JaxLM(CFG)
    jparams = jmodel.init(jax.random.key(0))
    kept = jmodel.decide_kept(jparams, 0.5)
    jmasks = jmodel.filter_masks(jparams, kept)
    model = LM(ModelConfig.from_dict(CFG.to_dict()), device="cpu")
    params = interop.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    masks = interop.masks_from_jax(jax.tree.map(np.asarray, jmasks), "cpu")
    return jmodel, jparams, kept, jmasks, model, params, masks


def _same(port_done, jax_done):
    assert [c.uid for c in port_done] == [c.uid for c in jax_done]
    for a, b in zip(port_done, jax_done):
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens))
        assert a.status == b.status


class TestEngineMatchesJax:
    @pytest.mark.parametrize("mode", ["dense", "masked"])
    def test_tokens_and_uids_equal(self, world, mode):
        jmodel, jparams, _, jmasks, model, params, masks = world
        masked = mode == "masked"
        prompts = ragged_prompts(5, 4, CFG.vocab_size, seed=3)
        want = JaxEngine(jmodel, jparams, JaxServeConfig(**SCFG),
                         masks=jmasks if masked else None).run(prompts)
        eng = DecodeEngine(model, params, ServeConfig(**SCFG),
                           masks=masks if masked else None, device="cpu")
        got = eng.run(prompts)
        _same(got, want)
        assert eng.steps % SCFG["steps_per_wave"] == 0 and eng.steps > 0

    def test_eos_stops_early_like_jax(self, world):
        jmodel, jparams, _, _, model, params, _ = world
        first = DecodeEngine(model, params, ServeConfig(**SCFG),
                             device="cpu").run([np.asarray([7])])[0].tokens[0]
        scfg = {**SCFG, "eos_id": int(first), "steps_per_wave": 2}
        prompts = [np.asarray([7], np.int32), np.asarray([11, 3], np.int32)]
        got = DecodeEngine(model, params, ServeConfig(**scfg),
                           device="cpu").run(prompts)
        want = JaxEngine(jmodel, jparams, JaxServeConfig(**scfg)).run(prompts)
        _same(got, want)
        assert got[0].tokens[-1] == first and len(got[0].tokens) == 1

    def test_interleaved_submission_like_jax(self, world):
        jmodel, jparams, _, _, model, params, _ = world
        scfg = {**SCFG, "steps_per_wave": 2}
        prompts = ragged_prompts(4, 4, CFG.vocab_size, seed=5)

        def drive(eng):
            eng.submit(prompts[0])
            done = list(eng.step_wave())
            for p in prompts[1:]:
                eng.submit(p)
            while eng.pending:
                done.extend(eng.step_wave())
            return sorted(done, key=lambda c: c.uid)

        _same(drive(DecodeEngine(model, params, ServeConfig(**scfg),
                                 device="cpu")),
              drive(JaxEngine(jmodel, jparams, JaxServeConfig(**scfg))))

    def test_masked_engine_equals_shrunk_engine(self, world):
        _, _, kept, _, model, params, masks = world
        shrunk = model.shrink_params(params, kept)
        s_model = LM(dataclasses.replace(model.cfg,
                                         d_ff=kept["mlp"].shape[1]),
                     device="cpu")
        prompts = ragged_prompts(5, 4, CFG.vocab_size, seed=6)
        got_m = DecodeEngine(model, params, ServeConfig(**SCFG), masks=masks,
                             device="cpu").run(prompts)
        got_s = DecodeEngine(s_model, shrunk, ServeConfig(**SCFG),
                             device="cpu").run(prompts)
        _same(got_m, got_s)


class TestEngineProtocol:
    def test_queue_full_raises(self, world):
        *_, model, params, _ = world
        eng = DecodeEngine(model, params, ServeConfig(**SCFG, max_queue=3),
                           device="cpu")
        ps = ragged_prompts(4, 4, CFG.vocab_size, seed=7)
        for p in ps[:3]:
            assert eng.submit(p) is not None
        with pytest.raises(QueueFull, match="max_queue=3"):
            eng.submit(ps[3])
        assert len(eng.run()) == 3

    def test_queue_full_reject_counts(self, world):
        *_, model, params, _ = world
        eng = DecodeEngine(model, params,
                           ServeConfig(**SCFG, max_queue=2, on_full="reject"),
                           device="cpu")
        uids = [eng.submit(p) for p in ragged_prompts(5, 4, CFG.vocab_size)]
        assert uids[2:] == [None, None, None] and eng.rejected == 3
        done = eng.run()
        assert [c.uid for c in done] == [0, 1]
        assert all(c.status == "ok" for c in done)

    @pytest.mark.parametrize("kwargs,match", [
        (dict(slots=2, cache_len=6, max_prompt=4, max_new_tokens=4),
         "cache_len"),
        (dict(max_queue=0), "max_queue"),
        (dict(on_full="drop"), "on_full"),
        (dict(slots=0), "slots"),
        (dict(steps_per_wave=0), "steps_per_wave"),
        (dict(max_prompt=0), "max_prompt"),
    ])
    def test_config_validation(self, kwargs, match):
        with pytest.raises(ValueError, match=match):
            ServeConfig(**kwargs)
        with pytest.raises(ValueError, match=match):   # same rule in JAX
            JaxServeConfig(**kwargs)

    def test_prompt_length_checked(self, world):
        *_, model, params, _ = world
        eng = DecodeEngine(model, params, ServeConfig(**SCFG), device="cpu")
        with pytest.raises(ValueError, match="prompt length"):
            eng.submit(np.arange(5, dtype=np.int32))

    def test_unservable_family_rejected(self, world):
        *_, model, params, _ = world
        other = dataclasses.replace(model.cfg, family="ssm")
        fake = dataclasses.make_dataclass("Fake", ["cfg", "device"])(
            other, model.device)
        with pytest.raises(ValueError, match="scanned-KV"):
            DecodeEngine(fake, params, ServeConfig(**SCFG), device="cpu")

    def test_non_finite_embedding_errors_only_its_request(self, world):
        """One embedding row is NaN: only the request whose prompt holds
        that token completes with status="error"; every other request —
        including the ones that reuse its slot and KV page afterwards —
        emits what a clean run emits."""
        jmodel, jparams, _, _, model, params, _ = world
        prompts = ragged_prompts(6, 4, CFG.vocab_size, seed=8)
        clean = DecodeEngine(model, params, ServeConfig(**SCFG),
                             device="cpu").run(prompts)
        _same(clean, JaxEngine(jmodel, jparams,
                               JaxServeConfig(**SCFG)).run(prompts))
        elsewhere = set(np.concatenate(
            [p for p in prompts[1:]] + [c.tokens for c in clean]).tolist())
        bad_tok = next(int(t) for t in prompts[0] if int(t) not in elsewhere)
        poisoned = dict(params)
        poisoned["embed"] = params["embed"].clone()
        poisoned["embed"][bad_tok] = float("nan")
        got = DecodeEngine(model, poisoned, ServeConfig(**SCFG),
                           device="cpu").run(prompts)
        assert [c.uid for c in got] == [c.uid for c in clean]
        assert got[0].status == "error"
        assert len(got[0].tokens) <= len(clean[0].tokens)
        for a, b in zip(got[1:], clean[1:]):
            assert a.status == "ok"
            np.testing.assert_array_equal(a.tokens, b.tokens)

    def test_nan_logits_retire_slot_not_batch(self, world):
        """``NaNLogits`` poisons one slot's logits in the wave: that request
        completes with status="error" (a prefix of its clean tokens), every
        co-batched request emits its clean tokens, and the port's
        completions equal the reference engine's under the same fault
        (``test_reliability.py``'s serving lock)."""
        from repro.reliability import NaNLogits as JaxNaNLogits
        from repro_torch.reliability import NaNLogits

        jmodel, jparams, _, _, model, params, _ = world
        prompts = ragged_prompts(4, 4, CFG.vocab_size, seed=9)
        clean = {c.uid: c for c in DecodeEngine(
            model, params, ServeConfig(**SCFG), device="cpu").run(prompts)}
        got = DecodeEngine(model, params, ServeConfig(**SCFG), device="cpu",
                           faults=(NaNLogits(slot=0, n_out=1),)).run(prompts)
        want = JaxEngine(jmodel, jparams, JaxServeConfig(**SCFG),
                         faults=(JaxNaNLogits(slot=0, n_out=1),)).run(prompts)
        _same(got, want)
        errs = {c.uid for c in got if c.status == "error"}
        assert errs, "no slot was retired"
        for c in got:
            if c.uid in errs:
                assert len(c.tokens) <= len(clean[c.uid].tokens)
                np.testing.assert_array_equal(
                    c.tokens, clean[c.uid].tokens[:len(c.tokens)])
            else:
                np.testing.assert_array_equal(c.tokens, clean[c.uid].tokens)


def masked_run_result(params, kept, fmasks, mode="mask"):
    art = {"mode": mode, "p_star": 0.5, "layer_rates": [0.5, 0.5],
           "kept": dict(kept)}
    if fmasks is not None:
        art["filter_masks"] = dict(fmasks)
    return RunResult(params=params, history={"round": [2]},
                     artifacts={"prune": art}, state={})


class TestLoadServable:
    @pytest.mark.parametrize("mode", ["auto", "masked", "shrunk", "dense"])
    def test_jax_checkpoint_serves_the_same_tokens(self, tmp_path, world,
                                                   mode):
        jmodel, jparams, kept, jmasks, *_ = world
        zeroed = jax.tree.map(jnp.multiply, jparams,
                              jmodel.param_masks(jparams, kept))
        masked_run_result(zeroed, kept, jmasks).save(tmp_path / "ckpt",
                                                     model_config=CFG)
        sv = load_servable(tmp_path / "ckpt", mode, device="cpu")
        jsv = jax_load_servable(tmp_path / "ckpt", mode)
        assert isinstance(sv, Servable)
        assert sv.mode == jsv.mode
        assert sv.model.cfg.to_dict() == jsv.model.cfg.to_dict()
        assert (sv.masks is None) == (jsv.masks is None)
        prompts = ragged_prompts(3, 4, CFG.vocab_size, seed=9)
        got = DecodeEngine(sv.model, sv.params, ServeConfig(**SCFG),
                           masks=sv.masks, device="cpu").run(prompts)
        want = JaxEngine(jsv.model, jsv.params, JaxServeConfig(**SCFG),
                         masks=jsv.masks).run(prompts)
        _same(got, want)

    def test_shrink_mode_checkpoint_loads_shrunk(self, tmp_path, world):
        """Already compacted params: the recorded (dense) d_ff is replaced
        by the param shapes, and re-shrinking is a no-op."""
        _, jparams, kept, *_ = world
        shrunk = jax_pruning.shrink_ffn_at(jparams, kept["mlp"])
        masked_run_result(shrunk, kept, None, mode="shrink").save(
            tmp_path / "ckpt", model_config=CFG)
        sv = load_servable(tmp_path / "ckpt", device="cpu")
        jsv = jax_load_servable(tmp_path / "ckpt")
        assert sv.mode == "shrunk"
        assert sv.model.cfg.d_ff == int(np.asarray(kept["mlp"]).shape[-1])
        prompts = ragged_prompts(2, 4, CFG.vocab_size, seed=10)
        _same(DecodeEngine(sv.model, sv.params, ServeConfig(**SCFG),
                           device="cpu").run(prompts),
              JaxEngine(jsv.model, jsv.params,
                        JaxServeConfig(**SCFG)).run(prompts))

    def test_in_memory_run_result_with_a_jax_config(self, world):
        """A RunResult object with the JAX package's ModelConfig."""
        _, jparams, kept, jmasks, *_ = world
        sv = load_servable(masked_run_result(jparams, kept, jmasks), "auto",
                           model_config=CFG, device="cpu")
        assert sv.mode == "masked" and sv.masks is not None
        assert isinstance(sv.model.cfg, ModelConfig)

    def test_missing_config_is_loud(self, tmp_path, world):
        _, jparams, *_ = world
        RunResult(params=jparams, history={}, artifacts={}, state={}).save(
            tmp_path / "ckpt")
        with pytest.raises(ValueError, match="model_config"):
            load_servable(tmp_path / "ckpt", device="cpu")

    def test_pruned_mode_needs_a_decision(self, tmp_path, world):
        _, jparams, *_ = world
        RunResult(params=jparams, history={}, artifacts={}, state={}).save(
            tmp_path / "ckpt", model_config=CFG)
        assert load_servable(tmp_path / "ckpt", device="cpu").mode == "dense"
        with pytest.raises(ValueError, match="kept-filter"):
            load_servable(tmp_path / "ckpt", "masked", device="cpu")

    @pytest.mark.parametrize("damage,match", [
        ("format", "not a repro checkpoint"), ("arrays", "partial"),
        ("zip", "corrupted"), ("empty", "missing meta.json")])
    def test_checkpoint_errors(self, tmp_path, world, damage, match):
        _, jparams, *_ = world
        ckpt = tmp_path / "ckpt"
        RunResult(params=jparams, history={}, artifacts={}, state={}).save(
            ckpt, model_config=CFG)
        if damage == "format":
            (ckpt / "meta.json").write_text('{"format": "other"}')
        elif damage == "arrays":
            (ckpt / "arrays.npz").unlink()
        elif damage == "zip":
            (ckpt / "arrays.npz").write_bytes(b"not a zip")
        else:
            (ckpt / "meta.json").unlink()
        with pytest.raises(CheckpointError, match=match):
            load_servable(ckpt, device="cpu")

    def test_bad_serve_mode(self, world):
        with pytest.raises(ValueError, match="serve_mode"):
            load_servable({}, "fast", device="cpu")
