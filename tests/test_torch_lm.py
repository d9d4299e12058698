"""The port's dense LM (training forward and gradients, decode) and FedAP
pruning against the JAX package.

JAX ``LM.init`` -> ``interop.params_from_jax`` -> the port on the CPU, on
the tiny dense config of ``tests/test_serving.py`` and on olmo-1b's reduced
config (MHA, non-parametric LayerNorm, tied embeddings).  Per-slot decode is
held against the JAX Pallas path (interpret mode), lockstep decode against
the JAX XLA path (the port attends the valid prefix for both index forms).
Logit tolerance 1e-5 (f32, another summation order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.core import pruning_lm as jax_pruning
from repro.models import layers as jax_layers
from repro.models.lm import LM as JaxLM
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import pruning_lm
from repro_torch.models import layers
from repro_torch.models.lm import LM
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=1e-5, rtol=1e-5)

TINY = JaxModelConfig(name="dense-tiny", family="dense", rope="1d",
                      norm="rmsnorm", act="silu", param_dtype="float32",
                      remat="none", num_layers=2, d_model=128, num_heads=4,
                      num_kv_heads=2, d_ff=512, vocab_size=2048)
OLMO_SMALL = jax_get_config("olmo-1b").reduced()


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_cfg(cfg):
    return ModelConfig.from_dict(cfg.to_dict())


@pytest.fixture(scope="module", params=["dense-tiny", "olmo-reduced"])
def world(request):
    cfg = TINY if request.param == "dense-tiny" else OLMO_SMALL
    jparams = JaxLM(cfg).init(jax.random.key(0))
    model = LM(_port_cfg(cfg), device="cpu")
    return cfg, jparams, model, interop.params_from_jax(_np_tree(jparams),
                                                        "cpu")


def _tokens(rng, b, vocab):
    return rng.integers(0, vocab, (b, 1)).astype(np.int32)


def _decode_both(cfg, jparams, model, params, *, start, attn_impl,
                 jmasks=None, masks=None, steps=4):
    """Run the same teacher-forced tokens through both decode steps; yield
    (jax logits, port logits) per step and finally the two caches."""
    jm = JaxLM(cfg, attn_impl=attn_impl)
    b, s_len = 3, 8
    jc = jm.init_cache(b, s_len)
    pc = model.init_cache(b, s_len)
    if start is not None:
        jc["index"] = jnp.asarray(start, jnp.int32)
        pc["index"] = torch.tensor(start, dtype=torch.int32)
    rng = np.random.default_rng(1)
    out = []
    for _ in range(steps):
        tok = _tokens(rng, b, cfg.vocab_size)
        jl, jc = jm.decode_step(jparams, jc, {"tokens": jnp.asarray(tok)},
                                masks=jmasks)
        pl, pc = model.decode_step(params, pc, {"tokens": torch.from_numpy(tok)},
                                   masks=masks)
        out.append((np.asarray(jl), pl.numpy()))
    return out, jc, pc


class TestDecodeStep:
    @pytest.mark.parametrize("index", ["scalar", "per-slot"])
    def test_logits_and_cache_match_jax(self, world, index):
        cfg, jparams, model, params = world
        start = None if index == "scalar" else [0, 2, 5]
        impl = "xla" if index == "scalar" else "pallas"
        steps, jc, pc = _decode_both(cfg, jparams, model, params,
                                     start=start, attn_impl=impl)
        for want, got in steps:
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(pc["k"].numpy(), np.asarray(jc["k"]), **TOL)
        np.testing.assert_allclose(pc["v"].numpy(), np.asarray(jc["v"]), **TOL)
        np.testing.assert_array_equal(pc["index"].numpy(),
                                      np.asarray(jc["index"]))

    def test_ring_buffer_wraps_like_jax(self, world):
        """Past the cache length the writes wrap (index mod S) and every
        slot is attended — lockstep against the JAX XLA path."""
        cfg, jparams, model, params = world
        steps, _, _ = _decode_both(cfg, jparams, model, params,
                                   start=[6, 9, 15], attn_impl="pallas",
                                   steps=3)
        for want, got in steps:
            np.testing.assert_allclose(got, want, **TOL)

    def test_masked_decode_matches_jax(self, world):
        cfg, jparams, model, params = world
        jm = JaxLM(cfg)
        kept = jm.decide_kept(jparams, 0.5)
        jmasks = jm.filter_masks(jparams, kept)
        masks = interop.masks_from_jax(_np_tree(jmasks), "cpu")
        steps, _, _ = _decode_both(cfg, jparams, model, params,
                                   start=[1, 0, 4], attn_impl="pallas",
                                   jmasks=jmasks, masks=masks)
        for want, got in steps:
            np.testing.assert_allclose(got, want, **TOL)

    def test_masked_equals_shrunk(self, world):
        """Masked decode at dense shapes == decode of the compacted model."""
        cfg, _, model, params = world
        kept = model.decide_kept(params, 0.5)
        masks = model.filter_masks(params, kept)
        shrunk = model.shrink_params(params, kept)
        s_model = LM(dataclasses.replace(model.cfg,
                                         d_ff=kept["mlp"].shape[1]),
                     device="cpu")
        b, s_len = 2, 8
        cm, cs = model.init_cache(b, s_len), s_model.init_cache(b, s_len)
        rng = np.random.default_rng(2)
        for _ in range(4):
            tok = torch.from_numpy(_tokens(rng, b, cfg.vocab_size))
            lm_, cm = model.decode_step(params, cm, {"tokens": tok},
                                        masks=masks)
            ls_, cs = s_model.decode_step(shrunk, cs, {"tokens": tok})
            np.testing.assert_allclose(lm_.numpy(), ls_.numpy(), **TOL)

    def test_non_dense_family_is_refused(self):
        """A family name that no model has is refused by name (the port runs
        all six of the reference's: ``tests/test_torch_vlm.py`` and
        ``tests/test_torch_encdec.py`` hold the last two)."""
        cfg = dataclasses.replace(_port_cfg(TINY), family="rnn",
                                  name="rnn-tiny")
        with pytest.raises(ValueError, match="'rnn'"):
            LM(cfg, device="cpu")


class TestPruning:
    def test_kept_indices_and_masks_equal_jax(self, world):
        cfg, jparams, model, params = world
        jm = JaxLM(cfg)
        for rate in (0.25, 0.5, 0.8):
            jkept = jm.decide_kept(jparams, rate)
            kept = model.decide_kept(params, rate)
            np.testing.assert_array_equal(kept["mlp"], np.asarray(jkept["mlp"]))
            np.testing.assert_array_equal(
                model.filter_masks(params, kept)["mlp"].numpy(),
                np.asarray(jm.filter_masks(jparams, jkept)["mlp"]))
        jpm = jax.tree.leaves(_np_tree(jm.param_masks(jparams, jkept)))
        pm = jax.tree.leaves(interop.params_to_numpy(
            model.param_masks(params, kept)))
        assert len(jpm) == len(pm)
        for a, b in zip(jpm, pm):
            np.testing.assert_array_equal(a, b)

    def test_shrink_equals_jax(self, world):
        cfg, jparams, model, params = world
        kept = model.decide_kept(params, 0.5)
        want = _np_tree(jax_pruning.shrink_ffn_at(jparams, kept["mlp"]))
        got = interop.params_to_numpy(model.shrink_params(params, kept))
        for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            np.testing.assert_array_equal(a, b)

    def test_ties_rank_the_later_index_first(self):
        """Equal scores everywhere: the reference's flipped stable argsort
        keeps the highest indices; the port keeps the same ones."""
        cfg = dataclasses.replace(TINY, d_ff=256)
        ones = {"layers": {"mlp": {
            "wi": np.ones((2, 128, 256), np.float32),
            "wg": np.ones((2, 128, 256), np.float32),
            "wo": np.ones((2, 256, 128), np.float32)}}}
        want = jax_pruning.ffn_kept_indices(
            jax.tree.map(jnp.asarray, ones), cfg, 0.5)
        got = pruning_lm.ffn_kept_indices(
            interop.params_from_jax(ones, "cpu"), _port_cfg(cfg), 0.5)
        np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(got[0], np.arange(128, 256))

    @pytest.mark.parametrize("d,rate,align", [
        (512, 0.5, 128), (512, 0.3, 128), (100, 0.5, 128), (512, 0.0, None)])
    def test_aligned_keep_equals_jax(self, d, rate, align):
        assert pruning_lm._aligned_keep(d, rate, align) == \
            jax_pruning._aligned_keep(d, rate, align)

    @pytest.mark.parametrize("d,rate,align,match", [
        (512, 1.0, 128, "must be in"), (300, 0.1, 128, "exceeds")])
    def test_aligned_keep_errors(self, d, rate, align, match):
        with pytest.raises(ValueError, match=match):
            pruning_lm._aligned_keep(d, rate, align)


class TestLayers:
    @pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "nonparam"])
    def test_norms_equal_jax(self, kind):
        rng = np.random.default_rng(3)
        x = rng.standard_normal((2, 3, 64)).astype(np.float32) * 3 + 1
        p = {"scale": rng.standard_normal(64).astype(np.float32),
             "bias": rng.standard_normal(64).astype(np.float32)}
        want = jax_layers.apply_norm(jax.tree.map(jnp.asarray, p),
                                     jnp.asarray(x), kind)
        got = layers.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                                torch.from_numpy(x), kind)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    @pytest.mark.parametrize("kind", ["1d", "2d", "mrope"])
    def test_rope_equals_jax(self, kind):
        """Interleaved-pair rotation with f32 angles, per-slot offsets."""
        rng = np.random.default_rng(4)
        x = rng.standard_normal((3, 1, 4, 64)).astype(np.float32)
        off = np.asarray([0, 17, 300], np.int32)
        jpos = jax_layers.default_positions(3, 1, kind) + \
            jnp.asarray(off)[None, :, None]
        pos = layers.default_positions(3, 1, kind) + \
            torch.from_numpy(off)[None, :, None]
        np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
        want = jax_layers.apply_rope(jnp.asarray(x), jpos, kind)
        got = layers.apply_rope(torch.from_numpy(x), pos, kind)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    def test_mrope_not_ported_yet(self):
        """M-RoPE is ported: with three different streams (the t, h and w
        ids of a patch grid) each head_dim section turns by its own stream,
        as in the reference, and an unknown kind is still refused."""
        rng = np.random.default_rng(5)
        x = rng.standard_normal((2, 6, 4, 64)).astype(np.float32)
        pos = np.stack([np.full((2, 6), 3), np.arange(12).reshape(2, 6),
                        np.arange(12).reshape(2, 6) % 4]).astype(np.int32)
        want = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), "mrope")
        got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                "mrope")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        one = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[:1])
                                .expand(3, 2, 6), "mrope")
        assert float((one[..., 32:] - got[..., 32:]).abs().max()) > 1e-3
        np.testing.assert_array_equal(one[..., :32].numpy(),
                                      got[..., :32].numpy())
        with pytest.raises(ValueError, match="3d"):
            layers.apply_rope(torch.zeros(1, 1, 1, 8),
                              layers.default_positions(1, 1, "mrope"), "3d")

    @pytest.mark.parametrize("act", ["silu", "gelu"])
    @pytest.mark.parametrize("masked", [False, True])
    def test_apply_mlp_equals_jax(self, act, masked):
        rng = np.random.default_rng(6)
        x = rng.standard_normal((3, 1, 128)).astype(np.float32)
        p = {"wi": rng.standard_normal((128, 256)).astype(np.float32) / 11,
             "wo": rng.standard_normal((256, 128)).astype(np.float32) / 16}
        if act == "silu":
            p["wg"] = rng.standard_normal((128, 256)).astype(np.float32) / 11
        mask = None
        if masked:
            mask = (rng.random(256) > 0.5).astype(np.float32)
            mask[128:] = 0.0                  # one block fully pruned
        want = jax_layers.apply_mlp(
            jax.tree.map(jnp.asarray, p), jnp.asarray(x), act,
            None if mask is None else jnp.asarray(mask))
        got = layers.apply_mlp(
            {k: torch.from_numpy(v) for k, v in p.items()},
            torch.from_numpy(x), act,
            None if mask is None else torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    def test_masked_dense_unaligned_masks_the_plain_product(self):
        rng = np.random.default_rng(5)
        x = rng.standard_normal((3, 96)).astype(np.float32)
        w = rng.standard_normal((96, 200)).astype(np.float32)
        mask = (rng.random(200) > 0.5).astype(np.float32)
        want = jax_layers.masked_dense(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(mask))
        got = layers.masked_dense(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


class TestFullSequence:
    """``LM.apply`` / ``loss_and_acc`` and their gradients, the path
    federated training differentiates, against the JAX LM (the masked FFN
    through the Pallas kernels in interpret mode on the JAX side, through
    ``MaskedMatmul`` over the plain versions here)."""

    @pytest.mark.parametrize("masked", [False, True])
    def test_logits_loss_and_grads_match_jax(self, world, masked):
        from repro_torch.core import engine

        cfg, jparams, model, params = world
        jm = JaxLM(cfg)
        rng = np.random.default_rng(7)
        x = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
        y = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
        jmasks = masks = None
        if masked:
            jmasks = jm.filter_masks(jparams, jm.decide_kept(jparams, 0.5))
            masks = interop.masks_from_jax(_np_tree(jmasks), "cpu")
        jlogits, _ = jm.apply(jparams, {"tokens": jnp.asarray(x)},
                              masks=jmasks)
        logits = model.apply(params, {"tokens": torch.from_numpy(x)},
                             masks=masks)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)

        def jloss(p):
            return jm.loss_and_acc(p, jnp.asarray(x), jnp.asarray(y),
                                   masks=jmasks)

        (jl, ja), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
        (loss, acc), grads = engine.value_and_grad_aux(
            lambda p: model.loss_and_acc(p, torch.from_numpy(x),
                                         torch.from_numpy(y), masks=masks),
            params)
        np.testing.assert_allclose(float(loss), float(jl), **TOL)
        assert float(acc) == pytest.approx(float(ja))
        for got, want in zip(jax.tree.leaves(interop.params_to_numpy(grads)),
                             jax.tree.leaves(_np_tree(jg))):
            np.testing.assert_allclose(got, want, **TOL)

    def test_loss_mask_and_labels(self, world):
        cfg, jparams, model, params = world
        rng = np.random.default_rng(8)
        b = {"tokens": rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32),
             "loss_mask": (rng.random((2, 8)) > 0.3).astype(np.float32)}
        want = JaxLM(cfg).loss(jparams, jax.tree.map(jnp.asarray, b))
        got = model.loss(params, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(got), float(want), **TOL)

    def test_remat_block_equals_none(self):
        from repro_torch.core import engine

        cfg = _port_cfg(TINY)
        plain = LM(cfg, device="cpu")
        remat = LM(dataclasses.replace(cfg, remat="block"), device="cpu")
        params = plain.init(torch.Generator().manual_seed(3))
        masks = plain.filter_masks(params, plain.decide_kept(params, 0.5))
        x = torch.randint(0, cfg.vocab_size, (2, 8),
                          generator=torch.Generator().manual_seed(4))

        def run(model):
            return engine.value_and_grad_aux(
                lambda p: model.loss_and_acc(p, x, x, masks=masks), params)

        (l0, _), g0 = run(plain)
        (l1, _), g1 = run(remat)
        assert float(l0) == float(l1)
        for a, b in zip(jax.tree.leaves(interop.params_to_numpy(g0)),
                        jax.tree.leaves(interop.params_to_numpy(g1))):
            np.testing.assert_allclose(a, b, atol=1e-7, rtol=0)
        # remat="dots": the same loss and gradients
        (l2, _), g2 = run(LM(dataclasses.replace(cfg, remat="dots"),
                             device="cpu"))
        assert float(l0) == float(l2)
        for a, b in zip(jax.tree.leaves(interop.params_to_numpy(g0)),
                        jax.tree.leaves(interop.params_to_numpy(g2))):
            np.testing.assert_allclose(a, b, atol=1e-7, rtol=0)

    @pytest.mark.parametrize("masked", [False, True])
    def test_remat_dots_gradient_matches_jax_dots(self, world, masked):
        """remat="dots" against the JAX LM's ``dots_with_no_batch_dims_
        saveable`` checkpoint: logits equal remat="none", the loss and every
        gradient leaf within 1e-5 of JAX's (dense and kernel-masked)."""
        from repro_torch.core import engine

        cfg, jparams, model, params = world
        dots_j = dataclasses.replace(cfg, remat="dots")
        dots = LM(_port_cfg(dots_j), device="cpu")
        rng = np.random.default_rng(12)
        b = {"tokens": rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)}
        kept = model.decide_kept(params, 0.5) if masked else None
        masks = model.filter_masks(params, kept) if masked else None
        jmasks = (jax_pruning.ffn_filter_masks(jparams, kept) if masked
                  else None)
        bt = {k: torch.from_numpy(v) for k, v in b.items()}
        with torch.no_grad():
            assert torch.equal(dots.apply(params, bt, masks=masks),
                               model.apply(params, bt, masks=masks))
        (loss, _), grads = engine.value_and_grad_aux(
            lambda p: (dots.loss(p, bt, masks=masks), torch.zeros(())),
            params)
        jloss, jg = jax.value_and_grad(
            lambda p: JaxLM(dots_j).loss(p, jax.tree.map(jnp.asarray, b),
                                         masks=jmasks))(jparams)
        np.testing.assert_allclose(float(loss), float(jloss), **TOL)
        for got, want in zip(jax.tree.leaves(interop.params_to_numpy(grads)),
                             jax.tree.leaves(_np_tree(jg))):
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

    def test_remat_dots_backward_recomputes_no_mm(self):
        """Counted in the backward by a ``TorchDispatchMode``: "dots" runs as
        many ``aten.mm`` as "none" (the 2-D products are saved, not
        recomputed) and recomputes the attention's ``aten.bmm`` as "block"
        does; kernel-masked, it recomputes the masked product's plain
        version, 2 a layer (K1 on the card), and nothing else."""
        from torch.utils._python_dispatch import TorchDispatchMode

        from repro_torch.core import engine

        class Count(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.n = {}

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                self.n[func] = self.n.get(func, 0) + 1
                return func(*args, **(kwargs or {}))

        cfg = _port_cfg(TINY)
        params = LM(cfg, device="cpu").init(torch.Generator().manual_seed(3))
        x = torch.randint(0, cfg.vocab_size, (2, 8),
                          generator=torch.Generator().manual_seed(4))
        mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
        for masked in (False, True):
            masks = None
            if masked:
                plain = LM(cfg, device="cpu")
                masks = plain.filter_masks(params,
                                           plain.decide_kept(params, 0.5))
            counts = {}
            for remat in ("none", "block", "dots"):
                model = LM(dataclasses.replace(cfg, remat=remat),
                           device="cpu")
                with torch.enable_grad():
                    q, leaves = engine._detached_leaves(params)
                    loss = model.loss_and_acc(q, x, x, masks=masks)[0]
                    with Count() as c:
                        torch.autograd.grad(loss, leaves)
                counts[remat] = c.n
            extra = 2 * cfg.num_layers if masked else 0
            assert counts["dots"][mm] == counts["none"][mm] + extra
            assert counts["block"][mm] > counts["dots"][mm]
            assert counts["dots"][bmm] == counts["block"][bmm] > \
                counts["none"][bmm]

    @pytest.mark.parametrize("h,kv", [(4, 2), (4, 4), (8, 1)])
    def test_attention_equals_attention_ref(self, h, kv):
        rng = np.random.default_rng(9)
        q = rng.standard_normal((2, 12, h, 16)).astype(np.float32)
        k = rng.standard_normal((2, 12, kv, 16)).astype(np.float32)
        v = rng.standard_normal((2, 12, kv, 16)).astype(np.float32)
        want = jax_layers.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=True)
        got = layers.attention(*(torch.from_numpy(a) for a in (q, k, v)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


class TestConfigAndInterop:
    def test_config_copy_round_trips(self):
        for cfg in (TINY, OLMO_SMALL, jax_get_config("olmo-1b")):
            assert _port_cfg(cfg).to_dict() == cfg.to_dict()
        assert get_config("olmo-1b").to_dict() == \
            jax_get_config("olmo-1b").to_dict()
        assert get_config("olmo-1b").reduced().to_dict() == \
            OLMO_SMALL.to_dict()
        with pytest.raises(ValueError, match="unknown field"):
            ModelConfig.from_dict({**TINY.to_dict(), "bogus": 1})

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_interop_round_trips_exactly(self, dtype):
        cfg = dataclasses.replace(TINY, param_dtype=dtype)
        jp = _np_tree(JaxLM(cfg).init(jax.random.key(1)))
        port = interop.params_from_jax(jp, "cpu")
        assert port["embed"].dtype == getattr(torch, dtype)
        assert tuple(port["layers"]["attn"]["wq"].shape) == (2, 128, 4, 32)
        back = interop.params_to_numpy(port)
        for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
            np.testing.assert_array_equal(np.asarray(a, np.float32), b)

    def test_registry_equals_the_reference(self):
        """The port registers the reference's ten architectures, in its
        order, each config equal field for field."""
        from repro.configs import ARCH_NAMES as JAX_ARCH_NAMES

        from repro_torch.configs import ARCH_NAMES

        assert ARCH_NAMES == JAX_ARCH_NAMES
        for arch in ARCH_NAMES:
            assert get_config(arch).to_dict() == \
                jax_get_config(arch).to_dict(), arch
            assert get_config(arch).reduced().to_dict() == \
                jax_get_config(arch).reduced().to_dict(), arch

    def test_chatglm3_reduced_logits_equal_jax(self):
        """chatglm3-6b reduced: GLM's 2d rope (two streams, one per half of
        head_dim) over GQA (4 heads over 2 kv heads), logits within 1e-5 of
        max(1, max |logit|) from default and from two different position
        streams, and its decode steps."""
        cfg = jax_get_config("chatglm3-6b").reduced()
        assert (cfg.rope, cfg.num_heads, cfg.num_kv_heads) == ("2d", 4, 2)
        jm = JaxLM(cfg)
        jp = jax.jit(jm.init)(jax.random.key(3))
        model = LM(get_config("chatglm3-6b").reduced(), device="cpu")
        params = interop.params_from_jax(_np_tree(jp), "cpu")
        rng = np.random.default_rng(7)
        tok = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
        pos = np.stack([np.arange(32).reshape(2, 16),
                        rng.integers(0, 64, (2, 16))]).astype(np.int32)
        for batch in ({"tokens": tok}, {"tokens": tok, "positions": pos}):
            want, _ = jax.jit(jm.apply)(jp, jax.tree.map(jnp.asarray, batch))
            with torch.no_grad():
                got = model.apply(params, {k: torch.from_numpy(v)
                                           for k, v in batch.items()})
            want = np.asarray(want)
            scale = max(1.0, float(np.abs(want).max()))
            assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * scale
        jc, pc = jm.init_cache(2, 8), model.init_cache(2, 8)
        step = jax.jit(jm.decode_step)
        for t in range(4):
            jl, jc = step(jp, jc, {"tokens": jnp.asarray(tok[:, t:t + 1])})
            with torch.no_grad():
                pl, pc = model.decode_step(
                    params, pc, {"tokens": torch.from_numpy(tok[:, t:t + 1])})
            np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)

    def test_kept_and_masks_cross(self):
        jm = JaxLM(TINY)
        jp = jm.init(jax.random.key(2))
        kept = jm.decide_kept(jp, 0.5)
        masks = jm.filter_masks(jp, kept)
        pk = interop.kept_from_jax(kept, "cpu")
        pmk = interop.masks_from_jax(masks, "cpu")
        assert pk["mlp"].dtype == torch.int64
        assert pmk["mlp"].dtype == torch.float32
        np.testing.assert_array_equal(pk["mlp"].numpy(), np.asarray(kept["mlp"]))
        np.testing.assert_array_equal(pmk["mlp"].numpy(),
                                      np.asarray(masks["mlp"]))
