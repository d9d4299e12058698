"""The vlm family (qwen2-vl-7b reduced) of the port against the JAX package.

qwen2-vl's reduced config: 2 layers, d 256, 4 heads padded to 16 over 2 kv
heads of 64, d_ff 512, vocab 512, M-RoPE.  JAX ``LM.init`` (jitted) ->
``interop.params_from_jax`` -> the port on the CPU, f32 with TF32 off.

* ``apply_rope("mrope")`` with three different position streams (equal
  streams would hide a section that reads the wrong one), and each
  section moved by its own stream only;
* logits from tokens and from ``embeds`` with Qwen2-VL-style positions (a
  text run, a grid of patches whose h/w streams follow the grid, text
  resuming past the maximum) within 1e-5 of max(1, max |logit|), the loss
  with a ``loss_mask`` that is 0 on the patches within 1e-6, its gradient
  within 1e-5 of each leaf's max;
* the decode step through the embeds path, step by step, from a scalar
  index and from per-slot fill levels, against the JAX decode
  (``attn_impl="xla"``: the port attends the valid prefix for both index
  forms), and the cache tree;
* ``DecodeEngine`` completions token for token against the JAX engine;
* ``load_servable`` logits in dense, masked and shrunk modes against the
  JAX servable's;
* ``ffn_kept_indices``, ``prune_lm_ffn`` and ``fedap_lm``: the kept indices
  equal and the pruned model's logits;
* the lockstep loop's one-hot step input, as the reference's loop builds
  it, tokens equal to that loop's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import pruning_lm as jax_pruning
from repro.models import layers as jax_layers
from repro.models.lm import LM as JaxLM
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import load_servable as jax_load_servable
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import pruning_lm
from repro_torch.models import layers
from repro_torch.models.lm import LM
from repro_torch.serving import (DecodeEngine, ServeConfig, load_servable,
                                 lockstep_decode)
from repro_torch.utils.tree import tree_leaves, tree_map
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CFG = jax_get_config("qwen2-vl-7b").reduced()
LOGIT_TOL = 1e-5
LOSS_TOL = 1e-6
GRAD_TOL = 1e-5
B = 2
TEXT, GRID, AFTER = 4, (4, 4), 12          # 4 text, a 4 x 4 grid, 12 text
SEQ = TEXT + GRID[0] * GRID[1] + AFTER


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


def vl_positions(b, text, grid, after):
    """[3, b, S] M-RoPE ids as Qwen2-VL builds them: text takes t = h = w =
    i; the grid that starts at s0 takes t = s0, h = s0 + row, w = s0 + col;
    the text after it resumes at the maximum + 1."""
    gh, gw = grid
    t_ids = list(range(text))
    h_ids, w_ids = list(t_ids), list(t_ids)
    s0 = text
    for r in range(gh):
        for c in range(gw):
            t_ids.append(s0)
            h_ids.append(s0 + r)
            w_ids.append(s0 + c)
    nxt = max(t_ids[-1], h_ids[-1], w_ids[-1]) + 1
    for i in range(after):
        for ids in (t_ids, h_ids, w_ids):
            ids.append(nxt + i)
    pos = np.asarray([t_ids, h_ids, w_ids], np.int32)
    return np.broadcast_to(pos[:, None], (3, b, pos.shape[1])).copy()


@pytest.fixture(scope="module")
def world():
    jm = JaxLM(CFG)
    jparams = jax.jit(jm.init)(jax.random.key(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, CFG.vocab_size, (B, SEQ + 1)).astype(np.int32)
    embeds = rng.standard_normal((B, SEQ, CFG.d_model)).astype(np.float32)
    loss_mask = np.ones((B, SEQ), np.float32)
    loss_mask[:, TEXT:TEXT + GRID[0] * GRID[1]] = 0.0
    return {"jm": jm, "jparams": jparams,
            "params": interop.params_from_jax(_np_tree(jparams), "cpu"),
            "model": LM(ModelConfig.from_dict(CFG.to_dict()), device="cpu"),
            "tokens": tokens, "embeds": embeds, "loss_mask": loss_mask,
            "positions": vl_positions(B, TEXT, GRID, AFTER)}


def _embeds_batch(world):
    return {"embeds": world["embeds"], "positions": world["positions"],
            "labels": world["tokens"][:, 1:], "loss_mask": world["loss_mask"]}


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


class TestConfig:
    def test_registry_and_reduced_layout(self):
        cfg = get_config("qwen2-vl-7b")
        assert cfg.to_dict() == jax_get_config("qwen2-vl-7b").to_dict()
        assert (cfg.padded_num_heads, cfg.padded_num_kv_heads,
                cfg.resolved_head_dim) == (32, 4, 128)
        small = cfg.reduced()
        assert (small.padded_num_heads, small.padded_num_kv_heads,
                small.resolved_head_dim) == (16, 2, 64)

    def test_param_tree_matches_jax(self, world):
        params = world["model"].init(torch.Generator().manual_seed(0))
        assert jax.tree.structure(_np_tree(world["jparams"])) == \
            jax.tree.structure(params)
        for w, g in zip(jax.tree.leaves(world["jparams"]),
                        tree_leaves(params)):
            assert tuple(g.shape) == w.shape


class TestMRope:
    @pytest.mark.parametrize("hd", [64, 128])
    def test_three_streams_equal_jax(self, hd):
        """Three different streams, per-slot offsets, hd 64 (sections 32,
        16, 16) and 128 (64, 32, 32)."""
        rng = np.random.default_rng(1)
        x = rng.standard_normal((3, 5, 4, hd)).astype(np.float32)
        pos = rng.integers(0, 4000, (3, 3, 5)).astype(np.int32)
        assert len({tuple(p.ravel()) for p in pos}) == 3
        want = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                     "mrope")
        got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                "mrope")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)

    @pytest.mark.parametrize("hd", [64, 128])
    def test_each_section_reads_its_own_stream(self, hd):
        """Moving stream i moves head_dim section i only."""
        rng = np.random.default_rng(2)
        x = torch.from_numpy(rng.standard_normal((2, 3, 2, hd))
                             .astype(np.float32))
        pos = torch.from_numpy(rng.integers(0, 100, (3, 2, 3))
                               .astype(np.int32))
        base = layers.apply_rope(x, pos, "mrope")
        bounds = np.cumsum([0] + layers.mrope_sections(hd))
        assert list(np.diff(bounds)) == [hd // 2, hd // 4, hd // 4]
        for i in range(3):
            moved = pos.clone()
            moved[i] += 7
            diff = (layers.apply_rope(x, moved, "mrope") - base).abs()
            changed = diff.amax(dim=(0, 1, 2)) > 0
            inside = torch.zeros(hd, dtype=torch.bool)
            inside[bounds[i]:bounds[i + 1]] = True
            assert bool(changed[inside].all())
            assert not bool(changed[~inside].any())


class TestForward:
    def test_logits_from_tokens_equal_jax(self, world):
        x = world["tokens"][:, :-1]
        want, _ = jax.jit(lambda p, t: world["jm"].apply(p, {"tokens": t}))(
            world["jparams"], jnp.asarray(x))
        with torch.no_grad():
            got = world["model"].apply(world["params"],
                                       {"tokens": torch.from_numpy(x)})
        assert _rel(got, want) <= LOGIT_TOL

    def test_logits_from_embeds_and_positions_equal_jax(self, world):
        batch = _embeds_batch(world)
        want, _ = jax.jit(world["jm"].apply)(world["jparams"], _j(batch))
        with torch.no_grad():
            got = world["model"].apply(world["params"], _t(batch))
        assert _rel(got, want) <= LOGIT_TOL
        # the positions matter: the default arange gives other logits
        with torch.no_grad():
            plain = world["model"].apply(world["params"], _t(
                {"embeds": world["embeds"]}))
        assert _rel(plain, got) > 1e-3

    def test_loss_with_a_loss_mask_equals_jax(self, world):
        batch = _embeds_batch(world)
        want = float(jax.jit(world["jm"].loss)(world["jparams"], _j(batch)))
        with torch.no_grad():
            got = float(world["model"].loss(world["params"], _t(batch)))
        assert abs(got - want) <= LOSS_TOL * abs(want)

    def test_loss_gradient_equals_jax(self, world):
        batch = _embeds_batch(world)
        jg = jax.jit(jax.grad(world["jm"].loss))(world["jparams"], _j(batch))
        params = tree_map(lambda t: t.clone().requires_grad_(True),
                          world["params"])
        world["model"].loss(params, _t(batch)).backward()
        # ``embed`` is not read when embeds come in: no gradient reaches it
        # (JAX's is zeros)
        assert params["embed"].grad is None
        assert float(np.abs(np.asarray(jg["embed"])).max()) == 0.0
        got = [torch.zeros_like(t) if t.grad is None else t.grad
               for t in tree_leaves(params)]
        want = jax.tree.leaves(jg)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            w = np.asarray(w)
            scale = float(np.abs(w).max())
            err = float(np.abs(g.numpy() - w).max())
            assert err <= GRAD_TOL * max(scale, 1e-30), (err, scale)


def _decode_jax(world, start, steps, masks=None):
    jm = JaxLM(CFG)
    step = jax.jit(jm.decode_step)
    cache = jm.init_cache(B, 40)
    if start is not None:
        cache["index"] = jnp.asarray(start)
    outs = []
    for t in range(steps):
        logits, cache = step(world["jparams"], cache,
                             _j(_step_batch(world, t, start)))
        outs.append(_f32(logits[:, 0]))
    return np.stack(outs), cache


def _step_batch(world, t, start):
    off = 0 if start is None else start[:, None]
    pos = world["positions"][:, :, t:t + 1] + off
    return {"embeds": world["embeds"][:, t:t + 1], "positions": pos}


class TestDecode:
    def test_cache_matches_jax(self, world):
        want = JaxLM(CFG).init_cache(3, 100)
        got = world["model"].init_cache(3, 100)
        assert jax.tree.structure(want) == jax.tree.structure(got)
        for w, g in zip(jax.tree.leaves(want), tree_leaves(got)):
            assert tuple(g.shape) == w.shape
        assert tuple(got["k"].shape) == (2, 3, 100, 2, 64)

    @pytest.mark.parametrize("index", ["lockstep", "per-slot"])
    def test_embeds_steps_match_jax_decode(self, world, index):
        """The whole embeds sequence, a step at a time with its M-RoPE
        positions (shifted by each slot's fill level in per-slot form),
        and the final cache from JAX's mid-stream cache onwards."""
        start = None if index == "lockstep" else np.array([0, 5], np.int32)
        want, jcache = _decode_jax(world, start, SEQ)
        model = world["model"]
        cache = model.init_cache(B, 40)
        if start is not None:
            cache["index"] = torch.from_numpy(start)
        got = []
        with torch.no_grad():
            for t in range(SEQ):
                logits, cache = model.decode_step(
                    world["params"], cache, _t(_step_batch(world, t, start)))
                got.append(_f32(logits[:, 0]))
        assert _rel(np.stack(got), want) <= LOGIT_TOL
        for g, w in zip(tree_leaves(cache), jax.tree.leaves(jcache)):
            assert _rel(g, w) <= LOGIT_TOL
        # a cache taken from JAX mid-stream carries on as the port's own
        carried = interop.cache_from_jax(_np_tree(jcache), "cpu")
        assert set(carried) == {"k", "v", "index"}


SCFG = dict(slots=4, cache_len=24, max_prompt=8, max_new_tokens=12,
            steps_per_wave=4)


def _prompts(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, int(rng.integers(1, 9)))
            .astype(np.int32) for _ in range(n)]


def _same(port_done, jax_done):
    assert [c.uid for c in port_done] == [c.uid for c in jax_done]
    for a, b in zip(port_done, jax_done):
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens))
        assert a.status == b.status == "ok"


def _kept(world, rate=0.5):
    return pruning_lm.ffn_kept_indices(world["params"], CFG, rate, align=128)


class TestServing:
    def test_engine_tokens_equal_jax(self, world):
        """7 ragged prompts over 4 slots; the waves feed tokens."""
        prompts = _prompts(7, 11)
        want = JaxEngine(world["jm"], world["jparams"],
                         JaxServeConfig(**SCFG)).run(prompts)
        got = DecodeEngine(world["model"], world["params"],
                           ServeConfig(**SCFG), device="cpu").run(prompts)
        _same(got, want)

    @pytest.mark.parametrize("mode", ["dense", "masked", "shrunk"])
    def test_load_servable_logits_equal_jax(self, world, mode):
        kept = _kept(world)
        art = {"params": world["jparams"], "kept": {"mlp": kept},
               "mode": "mask", "model_config": CFG}
        jsv = jax_load_servable(art, mode)
        sv = load_servable({**art, "params": _np_tree(world["jparams"])},
                           mode, device="cpu")
        assert sv.mode == jsv.mode == mode
        assert sv.model.cfg.to_dict() == jsv.model.cfg.to_dict()
        assert sv.model.cfg.d_ff == (256 if mode == "shrunk" else 512)
        x = world["tokens"][:, :-1]
        want, _ = jsv.model.apply(jsv.params, {"tokens": jnp.asarray(x)},
                                  masks=jsv.masks)
        with torch.no_grad():
            got = sv.model.apply(sv.params, {"tokens": torch.from_numpy(x)},
                                 masks=sv.masks)
        assert _rel(got, want) <= LOGIT_TOL
        if mode == "masked":
            np.testing.assert_array_equal(sv.masks["mlp"].numpy(),
                                          np.asarray(jsv.masks["mlp"]))


class TestPruning:
    @pytest.mark.parametrize("rate", [0.25, 0.5, 0.8])
    def test_kept_indices_equal_jax(self, world, rate):
        want = jax_pruning.ffn_kept_indices(world["jparams"], CFG, rate,
                                            align=128)
        np.testing.assert_array_equal(_kept(world, rate), np.asarray(want))
        assert world["model"].decide_kept(world["params"], rate)["mlp"] \
            .tolist() == np.asarray(want).tolist()

    def test_prune_lm_ffn_and_fedap_lm_equal_jax(self, world):
        for fn in ("prune_lm_ffn", "fedap_lm"):
            jp, jcfg, jinfo = getattr(jax_pruning, fn)(world["jparams"], CFG,
                                                       0.5)
            p, cfg, info = getattr(pruning_lm, fn)(world["params"],
                                                   _port_cfg(), 0.5)
            assert cfg.to_dict() == jcfg.to_dict() and cfg.d_ff == 256
            for g, w in zip(tree_leaves(p), jax.tree.leaves(jp)):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            assert info == jinfo == {"kept": 256, "of": 512,
                                     "realized_rate": 0.5}


def _port_cfg():
    return ModelConfig.from_dict(CFG.to_dict())


def test_lockstep_tokens_equal_the_reference_loop(world):
    """``lockstep_decode`` on a vlm model feeds each step the one-hot
    embedding of its token, as the reference's ``serve_lockstep`` loop:
    the tokens equal that loop's (run here with the JAX model)."""
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, CFG.vocab_size, (3, 6)).astype(np.int32)
    n_new = 10
    jm = world["jm"]
    step = jax.jit(jm.decode_step)
    cache = jm.init_cache(3, 6 + n_new)

    def step_input(tok):
        return {"embeds": jax.nn.one_hot(tok[:, 0], CFG.d_model,
                                         dtype=jnp.float32)[:, None]}

    for t in range(prompt.shape[1]):
        logits, cache = step(world["jparams"], cache,
                             step_input(jnp.asarray(prompt[:, t:t + 1])))
    want, tok = [], jnp.argmax(logits[:, -1], -1)[:, None]
    for _ in range(n_new):
        logits, cache = step(world["jparams"], cache, step_input(tok))
        tok = jnp.argmax(logits[:, -1], -1)[:, None]
        want.append(np.asarray(tok[:, 0]))
    got, steps = lockstep_decode(world["model"], world["params"],
                                 torch.from_numpy(prompt), n_new)
    assert steps == 6 + n_new
    np.testing.assert_array_equal(got.numpy(), np.stack(want, 1))
    # ids >= d_model embed as zeros in both loops (vocab 512 > d 256)
    assert int(prompt.max()) >= CFG.d_model
