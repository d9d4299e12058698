"""The moe family (arctic-480b, llama4-maverick) against the JAX package:
padded attention heads, the MoE layer and its auxiliary losses, the LM's
logits, loss and gradient, decode, ``DecodeEngine`` serving,
``load_servable``, FedAP's expert pruning and the refusals.

The reduced configs (``reduced()``: 2 layers, d 256, 4 experts of 128, 4
heads of 64 padded to 16 over 2 kv heads; arctic top-2 with a dense
residual FFN of 128, llama4 top-1 with a shared expert), f32 with TF32 off.
JAX ``LM.init`` -> ``interop.params_from_jax`` -> the port on the CPU.

Tolerances:
* ``apply_moe``: the output and both auxiliary losses within 1e-6 of
  max(1, max |jax|); the gradients within 1e-5 of each leaf's max |grad|;
  bf16 within 2^-6 of max(1, max |jax|) (one bf16 step is 2^-7);
* the attention block, the LM's logits and decode logits: 1e-5 of max(1,
  max |jax|); the loss and token accuracy 1e-6; the loss gradient 1e-5 of
  each leaf's max |grad|;
* expert scores 1e-6 relative; kept experts equal.
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
from repro_torch.serving import DecodeEngine, ServeConfig, load_servable
from repro_torch.utils.tree import tree_leaves, tree_map
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCHS = ("arctic-480b", "llama4-maverick-400b-a17b")
CFGS = {a: jax_get_config(a).reduced() for a in ARCHS}
MOE_TOL = 1e-6
GRAD_TOL = 1e-5
LOGIT_TOL = 1e-5
LOSS_TOL = 1e-6
BF16_TOL = 2.0 ** -6
B, SEQ = 2, 32


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_cfg(cfg):
    return ModelConfig.from_dict(cfg.to_dict())


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel(got, want) -> float:
    """max |got - want| over max(1, max |want|)."""
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _leaf_err(got, want) -> float:
    """max |got - want| over the leaf's max |want| (0 for an all-zero leaf
    matched exactly)."""
    got, want = _f32(got), _f32(want)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    return err / scale if scale > 0 else err


_JAX = {}


def _jax(cfg):
    """The JAX model of ``cfg`` with its jitted init, apply and decode
    step, built once per config."""
    if cfg not in _JAX:
        jm = JaxLM(cfg)
        _JAX[cfg] = {
            "model": jm,
            "params": jax.jit(jm.init)(jax.random.key(0)),
            "apply": jax.jit(lambda p, t: jm.apply(p, {"tokens": t})),
            "step": jax.jit(jm.decode_step)}
    return _JAX[cfg]


@pytest.fixture(scope="module", params=ARCHS)
def world(request):
    cfg = CFGS[request.param]
    j = _jax(cfg)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, SEQ + 1)).astype(np.int32)
    return {"cfg": cfg, "jparams": j["params"],
            "params": interop.params_from_jax(_np_tree(j["params"]), "cpu"),
            "model": LM(_port_cfg(cfg), device="cpu"), "tokens": tokens}


@pytest.fixture(scope="module")
def grads(world):
    """The loss gradient of both packages at the world's params, once per
    arch: (JAX loss, JAX gradient tree, port loss, port params with
    ``.grad``)."""
    cfg, tokens = world["cfg"], world["tokens"]
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    jm = _jax(cfg)["model"]
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, batch)))(
        world["jparams"])
    params = tree_map(lambda t: t.clone().requires_grad_(True),
                      world["params"])
    loss = world["model"].loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return float(jl), jg, float(loss.detach()), params


class TestConfig:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_config_copies(self, arch):
        assert arch in ARCH_NAMES
        full = get_config(arch)
        assert full.to_dict() == jax_get_config(arch).to_dict()
        assert full.reduced().to_dict() == CFGS[arch].to_dict()
        assert (full.padded_num_heads, full.padded_num_kv_heads) == {
            "arctic-480b": (64, 8),
            "llama4-maverick-400b-a17b": (48, 8)}[arch]

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("arch", ARCHS)
    def test_init_layouts_and_dtypes_match_jax(self, arch, dtype):
        """Leaf for leaf the JAX tree's shapes and dtypes, the router f32
        in a bf16 model; the padded heads' ``wo`` rows zero."""
        cfg = dataclasses.replace(CFGS[arch], param_dtype=dtype)
        want = jax.eval_shape(JaxLM(cfg).init, jax.random.key(0))
        got = LM(_port_cfg(cfg), device="cpu").init(
            torch.Generator().manual_seed(0))
        assert jax.tree.structure(want) == jax.tree.structure(got)
        for w, g in zip(jax.tree.leaves(want), tree_leaves(got)):
            assert tuple(g.shape) == w.shape
            assert str(g.dtype).split(".")[-1] == str(w.dtype)
        attn = got["layers"]["attn"]
        assert tuple(attn["wq"].shape) == (2, 256, 16, 64)
        assert tuple(attn["wk"].shape) == (2, 256, 2, 64)
        assert got["layers"]["moe"]["router"].dtype == torch.float32
        assert float(attn["wo"][:, 4:].abs().max()) == 0.0
        assert float(attn["wo"][:, :4].abs().min()) > 0.0
        assert float(attn["wq"][:, :, 4:].abs().max()) > 0.0

    def test_mha_pads_kv_with_the_heads_as_the_reference(self):
        """12 of 12 heads (whisper's) padded to 16: KV no longer divides H,
        so it pads along; the reference's shapes and zero rows."""
        cfg = dataclasses.replace(CFGS["arctic-480b"], num_heads=12,
                                  num_kv_heads=12)
        want = jax.jit(lambda k: jax_layers.init_attention(
            k, cfg, jnp.float32)[0])(jax.random.key(0))
        got = layers.init_attention(_port_cfg(cfg), torch.float32,
                                    torch.Generator().manual_seed(0), "cpu")
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: v.shape for k, v in want.items()}
        assert tuple(got["wk"].shape) == (256, 16, 64)
        np.testing.assert_array_equal(got["wo"][12:].numpy(),
                                      np.asarray(want["wo"][12:]))
        assert float(got["wo"][:12].abs().min()) > 0

    def test_bf16_cast_keeps_the_reference_f32_leaves(self, world):
        """``params_from_jax(dtype=bf16)`` of an f32 tree: the router stays
        f32, every other leaf is cast (a layernorm's bias included)."""
        port = interop.params_from_jax(_np_tree(world["jparams"]), "cpu",
                                       dtype=torch.bfloat16)
        assert port["layers"]["moe"]["router"].dtype == torch.float32
        torch.testing.assert_close(port["layers"]["moe"]["router"],
                                   world["params"]["layers"]["moe"]["router"],
                                   atol=0, rtol=0)
        others = [t for t in tree_leaves(port)
                  if t is not port["layers"]["moe"]["router"]]
        assert others and all(t.dtype == torch.bfloat16 for t in others)
        tree = {"cell": {"bias": np.zeros(4, np.float32),
                         "w_if": np.zeros(4, np.float32)},
                "norm": {"bias": np.zeros(4, np.float32)},
                "mamba": {"A_log": np.zeros(4, np.float32),
                          "D": np.ones(4, np.float32),
                          "dt_bias": np.zeros(4, np.float32),
                          "conv": np.zeros(4, np.float32)}}
        got = interop.params_from_jax(tree, "cpu", dtype=torch.bfloat16)
        assert {k: {n: str(t.dtype) for n, t in v.items()}
                for k, v in got.items()} == {
            "cell": {"bias": "torch.float32", "w_if": "torch.float32"},
            "norm": {"bias": "torch.bfloat16"},
            "mamba": {"A_log": "torch.float32", "D": "torch.float32",
                      "dt_bias": "torch.float32", "conv": "torch.bfloat16"}}


def _moe_case(world, rng, *, cf=None, router=None, dup=False):
    """A MoE layer's JAX params and input, with an optional capacity factor,
    router, and duplicated token rows."""
    cfg = world["cfg"]
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
    jp = jax.tree.map(lambda a: a[0], world["jparams"]["layers"]["moe"])
    if router is not None:
        jp = {**jp, "router": jnp.asarray(router, jnp.float32)}
    x = rng.standard_normal((B, 8, cfg.d_model)).astype(np.float32)
    if dup:
        x[1] = x[0]                       # equal rows: equal gates
    return cfg, jp, x


def _moe_cases(world):
    rng = np.random.default_rng(5)
    d, e = world["cfg"].d_model, world["cfg"].moe.num_experts
    return {"plain": _moe_case(world, rng),
            "capacity-drops": _moe_case(world, rng, cf=0.5),
            "tied-gates": _moe_case(world, rng,
                                    router=np.zeros((d, e), np.float32)),
            "tied-tokens": _moe_case(world, rng, cf=0.5, dup=True)}


class TestMoELayer:
    @pytest.mark.parametrize("case", ["plain", "capacity-drops",
                                      "tied-gates", "tied-tokens"])
    def test_output_and_aux_match_jax(self, world, case):
        """``tied-gates``: a zero router gives every expert the same
        probability, so both top-k selections meet ties throughout;
        ``tied-tokens``: duplicated rows give equal gates where the
        capacity cuts (each expert takes 8 of 16 routed picks)."""
        cfg, jp, x = _moe_cases(world)[case]
        want, jaux = jax.jit(lambda p, x: jax_layers.apply_moe(p, x, cfg))(
            jp, jnp.asarray(x))
        p = interop.params_from_jax(_np_tree(jp), "cpu")
        with torch.no_grad():
            got, aux = layers.apply_moe(p, torch.from_numpy(x),
                                        _port_cfg(cfg))
        assert got.shape == x.shape and got.dtype == torch.float32
        assert _rel(got, want) <= MOE_TOL
        for key in ("load_balance", "router_z"):
            assert aux[key].dtype == torch.float32 and aux[key].ndim == 0
            assert _rel(aux[key], jaux[key]) <= MOE_TOL, key

    @pytest.mark.parametrize("case", ["plain", "capacity-drops",
                                      "tied-tokens"])
    def test_gradients_match_jax(self, world, case):
        """d/d(params, x) of sum(y * r) + load_balance + router_z: the
        router's gradient comes through the gate scale and both losses."""
        cfg, jp, x = _moe_cases(world)[case]
        r = np.random.default_rng(6).standard_normal(x.shape).astype(
            np.float32)

        def jloss(p, x):
            y, aux = jax_layers.apply_moe(p, x, cfg)
            return jnp.sum(y * r) + aux["load_balance"] + aux["router_z"]

        jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp,
                                                            jnp.asarray(x))
        p = tree_map(lambda t: t.clone().requires_grad_(True),
                     interop.params_from_jax(_np_tree(jp), "cpu"))
        xt = torch.from_numpy(x).requires_grad_(True)
        y, aux = layers.apply_moe(p, xt, _port_cfg(cfg))
        ((y * torch.from_numpy(r)).sum() + aux["load_balance"]
         + aux["router_z"]).backward()
        assert float(p["router"].grad.abs().max()) > 0
        for g, w in zip(tree_leaves(p), jax.tree.leaves(jgp)):
            assert _leaf_err(g.grad, w) <= GRAD_TOL
        assert _leaf_err(xt.grad, jgx) <= GRAD_TOL

    def test_bf16_matches_jax(self, world):
        """bf16 activations and experts, the router f32: the scatter-add in
        bf16, the gate math in f32."""
        cfg, jp, x = _moe_cases(world)["capacity-drops"]
        jp16 = {k: (v if k == "router" else jax.tree.map(
            lambda a: a.astype(jnp.bfloat16), v)) for k, v in jp.items()}
        x16 = jnp.asarray(x, jnp.bfloat16)
        want, jaux = jax.jit(lambda p, x: jax_layers.apply_moe(p, x, cfg))(
            jp16, x16)
        p = interop.params_from_jax(_np_tree(jp16), "cpu")
        assert p["router"].dtype == torch.float32
        with torch.no_grad():
            got, aux = layers.apply_moe(
                p, interop.params_from_jax({"x": x16}, "cpu")["x"],
                _port_cfg(cfg))
        assert got.dtype == torch.bfloat16
        assert _rel(got, want) <= BF16_TOL
        for key in aux:
            assert _rel(aux[key], jaux[key]) <= MOE_TOL

    def test_top_k_orders_ties_as_jax(self):
        x = np.array([[1.0, 3.0, 3.0, 0.0, 3.0], [2.0, 2.0, 2.0, 2.0, 2.0]],
                     np.float32)
        jv, ji = jax.lax.top_k(jnp.asarray(x), 3)
        v, i = layers.top_k(torch.from_numpy(x), 3)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


class TestAttention:
    def test_block_matches_the_reference_tiled_path(self, world):
        """The reference tiles K/V to the padded 16 heads; the port passes
        GQA K/V (2 heads) to the plain attention and to K4's plain version:
        both equal the tiled path."""
        cfg = world["cfg"]
        jp = jax.tree.map(lambda a: a[0], world["jparams"]["layers"]["attn"])
        x = np.random.default_rng(7).standard_normal(
            (B, SEQ, cfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(SEQ, dtype=np.int32),
                              (1, B, SEQ)).copy()
        want = jax.jit(lambda p, x: jax_layers.attention_block(
            p, x, jnp.asarray(pos), cfg))(jp, jnp.asarray(x))
        p = interop.params_from_jax(_np_tree(jp), "cpu")
        for impl in ("xla", "pallas"):
            with torch.no_grad():
                got = layers.attention_block(p, torch.from_numpy(x),
                                             torch.from_numpy(pos),
                                             _port_cfg(cfg), attn_impl=impl)
            assert _rel(got, want) <= LOGIT_TOL, impl

    def test_decode_at_64_heads_over_8(self):
        """arctic's head layout (56 heads padded to 64 over 8 kv heads, G =
        8) at d 256, hd 32: four steps of ``attention_decode`` on a ragged
        per-slot cache against the reference's step."""
        cfg = jax_get_config("arctic-480b").reduced(
            num_heads=56, num_kv_heads=8, head_dim=32)
        assert (cfg.padded_num_heads, cfg.padded_num_kv_heads) == (64, 8)
        jp, _ = jax_layers.init_attention(jax.random.key(1), cfg, jnp.float32)
        p = interop.params_from_jax(_np_tree(jp), "cpu")
        rng = np.random.default_rng(8)
        b, s = 3, 16
        ck = rng.standard_normal((b, s, 8, 32)).astype(np.float32)
        cv = rng.standard_normal((b, s, 8, 32)).astype(np.float32)
        idx = np.array([0, 5, 11], np.int32)
        jk, jv = jnp.asarray(ck), jnp.asarray(cv)
        tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
        jstep = jax.jit(lambda p, x, k, v, i, pos: jax_layers.attention_decode(
            p, x, k, v, i, pos, cfg))
        for step in range(4):
            x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
            pos = (idx + step)[None, :, None]
            want, jk, jv = jstep(jp, jnp.asarray(x), jk, jv,
                                 jnp.asarray(idx + step), jnp.asarray(pos))
            with torch.no_grad():
                got = layers.attention_decode(
                    p, torch.from_numpy(x), tk, tv,
                    torch.from_numpy(idx + step), torch.from_numpy(pos),
                    _port_cfg(cfg))
            assert _rel(got, want) <= LOGIT_TOL
            assert _rel(tk, jk) <= LOGIT_TOL and _rel(tv, jv) <= LOGIT_TOL

    def test_padded_heads_take_a_gradient_in_both_packages(self, grads):
        """ROADMAP R12: the padded heads' ``wo`` rows are zero at init only;
        their gradient (out_head^T dy) is not zero, in the reference as in
        the port, and the two are equal."""
        _, jg, _, params = grads
        jwo = np.asarray(jg["layers"]["attn"]["wo"])
        gwo = params["layers"]["attn"]["wo"].grad
        assert np.abs(jwo[:, 4:]).sum() > 0
        assert float(gwo[:, 4:].abs().sum()) > 0
        assert _leaf_err(gwo[:, 4:], jwo[:, 4:]) <= GRAD_TOL


class TestLM:
    def test_logits_match_jax(self, world):
        tokens = world["tokens"][:, :SEQ]
        want, _ = _jax(world["cfg"])["apply"](world["jparams"],
                                              jnp.asarray(tokens))
        with torch.no_grad():
            got = world["model"].apply(world["params"],
                                       {"tokens": torch.from_numpy(tokens)})
        assert got.shape == (B, SEQ, world["cfg"].vocab_size)
        assert _rel(got, want) <= LOGIT_TOL

    def test_loss_and_acc_add_the_aux_as_jax(self, world):
        """``loss`` (with and without a loss mask) and ``loss_and_acc``
        within 1e-6 of JAX; the auxiliary loss is in both."""
        cfg, tokens = world["cfg"], world["tokens"]
        jm = _jax(cfg)["model"]
        x, y = tokens[:, :-1], tokens[:, 1:]
        mask = (np.random.default_rng(9).random(x.shape) > 0.3).astype(
            np.float32)
        _, jaux = _jax(cfg)["apply"](world["jparams"], jnp.asarray(x))
        assert float(jaux) > 0
        jl, jacc = jax.jit(jm.loss_and_acc)(world["jparams"], jnp.asarray(x),
                                            jnp.asarray(y))
        jlm = jax.jit(jm.loss)(world["jparams"], {
            "tokens": x, "labels": y, "loss_mask": mask})
        with torch.no_grad():
            loss, acc = world["model"].loss_and_acc(
                world["params"], torch.from_numpy(x), torch.from_numpy(y))
            lm_ = world["model"].loss(world["params"], {
                "tokens": torch.from_numpy(x), "labels": torch.from_numpy(y),
                "loss_mask": torch.from_numpy(mask)})
            logits = world["model"].apply(world["params"],
                                          {"tokens": torch.from_numpy(x)})
        ce = float(torch.nn.functional.cross_entropy(
            logits.reshape(-1, cfg.vocab_size).float(),
            torch.from_numpy(y).long().reshape(-1)))
        assert abs(float(loss) - float(jl)) <= LOSS_TOL * float(jl)
        assert abs(float(lm_) - float(jlm)) <= LOSS_TOL * float(jlm)
        assert abs(float(acc) - float(jacc)) <= LOSS_TOL
        assert abs(float(loss) - ce - float(jaux)) <= 1e-5

    def test_loss_gradient_matches_jax(self, grads):
        """Every leaf, the router's included (through the gate scale and
        both auxiliary losses)."""
        jl, jg, loss, params = grads
        assert abs(loss - jl) <= LOSS_TOL * jl
        assert float(params["layers"]["moe"]["router"].grad.abs().max()) > 0
        for got, want in zip(tree_leaves(params), jax.tree.leaves(jg)):
            assert _leaf_err(got.grad, want) <= GRAD_TOL

    def test_remat_block_gives_the_same_loss_and_gradient(self, world):
        """``remat="block"`` (the full configs' setting) recomputes each
        layer, its aux included: the loss and gradient are the plain
        run's."""
        tokens = torch.from_numpy(world["tokens"])
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        grads = []
        for remat in ("none", "block"):
            model = LM(_port_cfg(dataclasses.replace(world["cfg"],
                                                     remat=remat)),
                       device="cpu")
            params = tree_map(lambda t: t.clone().requires_grad_(True),
                              world["params"])
            loss = model.loss(params, batch)
            loss.backward()
            grads.append((loss.detach(), [t.grad for t in
                                          tree_leaves(params)]))
        torch.testing.assert_close(grads[0][0], grads[1][0], atol=0, rtol=0)
        for a, b in zip(grads[0][1], grads[1][1]):
            torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)

    def test_masks_and_the_unit_seam_are_refused_in_both_packages(self,
                                                                  world):
        cfg, tokens = world["cfg"], world["tokens"][:, :8]
        masks = {"mlp": np.ones((2, 128), np.float32)}
        jm, model = _jax(cfg)["model"], world["model"]
        with pytest.raises(ValueError, match="unsupported for MoE"):
            jm.apply(world["jparams"], {"tokens": tokens}, masks=masks)
        with pytest.raises(ValueError, match="unsupported for MoE"):
            jm.decode_step(world["jparams"], jm.init_cache(B, 4),
                           {"tokens": tokens[:, :1]}, masks=masks)
        tmasks = interop.masks_from_jax(masks, "cpu")
        with pytest.raises(ValueError, match="unsupported for MoE"):
            model.apply(world["params"],
                        {"tokens": torch.from_numpy(tokens)}, masks=tmasks)
        with pytest.raises(ValueError, match="unsupported for MoE"):
            model.decode_step(world["params"], model.init_cache(B, 4),
                              {"tokens": torch.from_numpy(tokens[:, :1])},
                              masks=tmasks)
        with pytest.raises(ValueError, match="family moe"):
            jm.decide_kept(world["jparams"], 0.5)
        with pytest.raises(ValueError, match="family moe"):
            model.decide_kept(world["params"], 0.5)


def _jax_decode(cfg, tokens, index=None):
    """JAX decode of ``tokens`` [B,T] from a fresh cache (a per-slot index
    vector when ``index`` is given): logits [T,B,V]."""
    j = _jax(cfg)
    cache = j["model"].init_cache(tokens.shape[0], 40)
    if index is not None:
        cache["index"] = jnp.asarray(index)
    outs = []
    for t in range(tokens.shape[1]):
        logits, cache = j["step"](j["params"], cache,
                                  {"tokens": jnp.asarray(tokens[:, t:t + 1])})
        outs.append(_f32(logits[:, 0]))
    return np.stack(outs)


class TestDecode:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_cache_matches_jax(self, world, dtype):
        cfg = dataclasses.replace(world["cfg"], param_dtype=dtype)
        want = JaxLM(cfg).init_cache(3, 100)
        got = LM(_port_cfg(cfg), device="cpu").init_cache(3, 100)
        assert jax.tree.structure(want) == jax.tree.structure(got)
        for w, g in zip(jax.tree.leaves(want), tree_leaves(got)):
            assert tuple(g.shape) == w.shape
            assert str(g.dtype).split(".")[-1] == str(w.dtype)
        assert tuple(got["k"].shape) == (2, 3, 100, 2, 64)

    @pytest.mark.parametrize("index", ["lockstep", "per-slot"])
    def test_steps_match_jax_decode(self, world, index):
        """24 steps, logits step by step, from a scalar index or from
        per-slot fill levels (slots at 0, 3, 7)."""
        tokens = np.random.default_rng(10).integers(
            0, world["cfg"].vocab_size, (3, 24)).astype(np.int32)
        start = None if index == "lockstep" else np.array([0, 3, 7],
                                                          np.int32)
        want = _jax_decode(world["cfg"], tokens, start)
        model = world["model"]
        cache = model.init_cache(3, 40)
        if start is not None:
            cache["index"] = torch.from_numpy(start)
        got = []
        with torch.no_grad():
            for t in range(tokens.shape[1]):
                logits, cache = model.decode_step(
                    world["params"], cache,
                    {"tokens": torch.from_numpy(tokens[:, t:t + 1])})
                got.append(_f32(logits[:, 0]))
        assert _rel(np.stack(got), want) <= LOGIT_TOL


def _prompts(n, cfg, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, int(rng.integers(1, 9)))
            .astype(np.int32) for _ in range(n)]


SCFG = dict(slots=4, cache_len=24, max_prompt=8, max_new_tokens=12,
            steps_per_wave=4)


def _same(port_done, jax_done):
    assert [c.uid for c in port_done] == [c.uid for c in jax_done]
    for a, b in zip(port_done, jax_done):
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens))
        assert a.status == b.status == "ok"


class TestServing:
    def test_engine_tokens_equal_jax(self, world):
        """7 ragged prompts over 4 slots: slots go idle, freeze and take new
        requests, and each step routes the 4 slots' tokens together."""
        prompts = _prompts(7, world["cfg"], 11)
        want = JaxEngine(_jax(world["cfg"])["model"], world["jparams"],
                         JaxServeConfig(**SCFG)).run(prompts)
        got = DecodeEngine(world["model"], world["params"],
                           ServeConfig(**SCFG), device="cpu").run(prompts)
        _same(got, want)

    @pytest.mark.parametrize("saver", ["jax", "port"])
    def test_load_servable_dense_scores_to_the_jax_loss(self, world,
                                                        tmp_path, saver):
        """A checkpoint written by either package loads ``auto`` -> dense
        and scores (``attn_impl="pallas"``: K4's plain version here) to
        the JAX logits, loss and accuracy."""
        cfg = world["cfg"]
        if saver == "jax":
            JaxRunResult(params=world["jparams"], history={"round": [1]},
                         artifacts={}, state={}).save(tmp_path / "ckpt",
                                                      model_config=cfg)
        else:
            RunResult(params=world["params"], history={"round": [1]},
                      artifacts={}, state={}).save(
                tmp_path / "ckpt", model_config=get_config(cfg.name)
                .reduced())
        sv = load_servable(tmp_path / "ckpt", device="cpu")
        jsv = jax_load_servable(tmp_path / "ckpt")
        assert sv.mode == jsv.mode == "dense" and sv.masks is None
        assert sv.model.attn_impl == "pallas"
        assert sv.model.cfg.to_dict() == jsv.model.cfg.to_dict()
        x, y = world["tokens"][:, :-1], world["tokens"][:, 1:]
        for a, b in zip(jax.tree.leaves(jsv.params),
                        jax.tree.leaves(world["jparams"])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        jl, jacc = jax.jit(_jax(cfg)["model"].loss_and_acc)(
            world["jparams"], jnp.asarray(x), jnp.asarray(y))
        want, _ = _jax(cfg)["apply"](world["jparams"], jnp.asarray(x))
        with torch.no_grad():
            loss, acc = sv.model.loss_and_acc(sv.params, torch.from_numpy(x),
                                              torch.from_numpy(y))
            logits = sv.model.apply(sv.params, {"tokens": torch.from_numpy(x)})
        assert _rel(logits, want) <= LOGIT_TOL
        assert abs(float(loss) - float(jl)) <= LOSS_TOL * float(jl)
        assert abs(float(acc) - float(jacc)) <= LOSS_TOL

    def test_expert_pruned_checkpoint_loads_at_its_kept_count(
            self, world, tmp_path):
        """Params pruned to 2 of 4 experts, saved with the unpruned config:
        the servable's config routes over 2, and serves JAX's tokens."""
        cfg = world["cfg"]
        jp, jcfg, _ = jax_pruning.prune_lm_experts(world["jparams"], cfg, 0.5)
        JaxRunResult(params=jp, history={"round": [1]}, artifacts={},
                     state={}).save(tmp_path / "ckpt", model_config=cfg)
        sv = load_servable(tmp_path / "ckpt", "dense", device="cpu")
        assert sv.model.cfg.moe.num_experts == jcfg.moe.num_experts == 2
        prompts = _prompts(5, cfg, 12)
        want = JaxEngine(JaxLM(jcfg), jp, JaxServeConfig(**SCFG)).run(prompts)
        _same(DecodeEngine(sv.model, sv.params, ServeConfig(**SCFG),
                           device="cpu").run(prompts), want)


# 16 experts, so that fedap_lm's floor of 8 leaves something to prune
E16 = {a: dataclasses.replace(c, moe=dataclasses.replace(c.moe,
                                                         num_experts=16))
       for a, c in CFGS.items()}


@pytest.fixture(scope="module")
def world16():
    """Each reduced config with 16 experts: the 4-expert params with a new
    router and expert stacks drawn with numpy at the init's scales."""
    rng = np.random.default_rng(14)
    out = {}
    for arch, cfg in E16.items():
        jp = _np_tree(_jax(CFGS[arch])["params"])
        d, f = cfg.d_model, cfg.moe.expert_d_ff

        def draw(*shape, scale):
            return (rng.standard_normal((2,) + shape) * scale).astype(
                np.float32)

        moe = {**jp["layers"]["moe"], "router": draw(d, 16, scale=d ** -.5),
               "wi": draw(16, d, f, scale=d ** -.5),
               "wg": draw(16, d, f, scale=d ** -.5),
               "wo": draw(16, f, d, scale=f ** -.5)}
        jp = {**jp, "layers": {**jp["layers"], "moe": moe}}
        out[arch] = (cfg, jp, interop.params_from_jax(jp, "cpu"))
    return out


_APPLY = {}


def _japply(cfg):
    """The jitted JAX forward of ``cfg``, once per config."""
    if cfg not in _APPLY:
        jm = JaxLM(cfg)
        _APPLY[cfg] = jax.jit(lambda q, t: jm.apply(q, {"tokens": t})[0])
    return _APPLY[cfg]


class TestExpertPruning:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_scores_match_jax(self, world16, arch):
        _, jp, p = world16[arch]
        want = np.asarray(jax_pruning.expert_scores(jp["layers"]))
        got = pruning_lm.expert_scores(p["layers"]).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)

    @pytest.mark.parametrize("arch, rate", [
        ("arctic-480b", 0.25), ("arctic-480b", 0.5), ("arctic-480b", 0.9),
        ("llama4-maverick-400b-a17b", 0.5)])
    def test_kept_experts_and_pruned_model_match_jax(self, world16, arch,
                                                     rate):
        """``prune_lm_experts`` and ``fedap_lm`` at one rate: the same kept
        experts per layer (read back from the router), the same config and
        info, and the pruned model's logits."""
        cfg, jp, p = world16[arch]
        tokens = np.random.default_rng(13).integers(
            0, cfg.vocab_size, (B, 16)).astype(np.int32)
        for jfn, fn in ((jax_pruning.prune_lm_experts,
                         pruning_lm.prune_lm_experts),
                        (jax_pruning.fedap_lm, pruning_lm.fedap_lm)):
            jpp, jcfg, jinfo = jfn(jp, cfg, rate)
            pp, pcfg, info = fn(p, _port_cfg(cfg), rate)
            assert pcfg.to_dict() == jcfg.to_dict() and info == jinfo
            for got, want in zip(tree_leaves(pp), jax.tree.leaves(jpp)):
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            want_logits = _japply(jcfg)(jpp, jnp.asarray(tokens))
            with torch.no_grad():
                got_logits = LM(pcfg, device="cpu").apply(
                    pp, {"tokens": torch.from_numpy(tokens)})
            assert _rel(got_logits, want_logits) <= LOGIT_TOL
        keep = {0.25: 12, 0.5: 8, 0.9: 8}[rate]
        assert pcfg.moe.num_experts == keep

    def test_tied_scores_keep_what_jax_keeps(self, world16):
        """Experts 2 and 5 made copies of 1 and 4 in every layer: their
        scores tie, and the reversed stable sort keeps the later index."""
        cfg, jp, _ = world16["arctic-480b"]
        moe = {k: (v.copy() if k in pruning_lm.EXPERT_AXIS else v)
               for k, v in jp["layers"]["moe"].items()}
        for name in ("wi", "wg", "wo"):
            moe[name][:, 2], moe[name][:, 5] = moe[name][:, 1], moe[name][:, 4]
        moe["router"][:, :, 2] = moe["router"][:, :, 1]
        moe["router"][:, :, 5] = moe["router"][:, :, 4]
        jp = {**jp, "layers": {**jp["layers"], "moe": moe}}
        p = interop.params_from_jax(jp, "cpu")
        scores = pruning_lm.expert_scores(p["layers"])
        assert bool((scores[:, 2] == scores[:, 1]).all())
        for rate in (0.25, 0.5, 0.9):
            jpp, _, _ = jax_pruning.prune_lm_experts(jp, cfg, rate)
            pp, _, _ = pruning_lm.prune_lm_experts(p, _port_cfg(cfg), rate)
            np.testing.assert_array_equal(
                pp["layers"]["moe"]["router"].numpy(),
                np.asarray(jpp["layers"]["moe"]["router"]))

    def test_leaf_at_a_time_equals_the_whole_prune(self, world16):
        """``take_experts`` on each leaf in turn (what a caller does to let
        each dense leaf go) builds ``fedap_lm``'s params."""
        cfg, _, p = world16["llama4-maverick-400b-a17b"]
        pcfg = _port_cfg(cfg)
        want, _, _ = pruning_lm.fedap_lm(p, pcfg, 0.5)
        idx = pruning_lm.expert_kept_indices(
            p, pcfg, 0.5, min_keep=pruning_lm.fedap_min_keep(pcfg))
        moe = dict(p["layers"]["moe"])
        for name in pruning_lm.EXPERT_AXIS:
            moe[name] = pruning_lm.take_experts(moe.pop(name), name, idx)
        for a, b in zip(tree_leaves(moe), tree_leaves(want["layers"]["moe"])):
            torch.testing.assert_close(a, b, atol=0, rtol=0)

    def test_refusals_match_jax(self, world16):
        cfg, jp, p = world16["arctic-480b"]
        for rate in (1.0, -0.1):
            with pytest.raises(ValueError, match="must be in"):
                jax_pruning.prune_lm_experts(jp, cfg, rate)
            with pytest.raises(ValueError, match="must be in"):
                pruning_lm.prune_lm_experts(p, _port_cfg(cfg), rate)
        dense = jax_get_config("olmo-1b").reduced()
        with pytest.raises(ValueError, match="not a MoE config"):
            jax_pruning.prune_lm_experts(jp, dense, 0.5)
        with pytest.raises(ValueError, match="not a MoE config"):
            pruning_lm.prune_lm_experts(p, _port_cfg(dense), 0.5)

    def test_prune_lm_ffn_and_fedap_lm_on_a_dense_stack(self):
        """The dense branch of ``fedap_lm``: ``prune_lm_ffn``'s params,
        config and info equal the reference's."""
        cfg = jax_get_config("olmo-1b").reduced(vocab_size=256)
        jp = _jax(cfg)["params"]
        p = interop.params_from_jax(_np_tree(jp), "cpu")
        for jfn, fn in ((jax_pruning.prune_lm_ffn, pruning_lm.prune_lm_ffn),
                        (jax_pruning.fedap_lm, pruning_lm.fedap_lm)):
            jpp, jcfg, jinfo = jfn(jp, cfg, 0.5)
            pp, pcfg, info = fn(p, _port_cfg(cfg), 0.5)
            assert pcfg.to_dict() == jcfg.to_dict() and info == jinfo
            for got, want in zip(tree_leaves(pp), jax.tree.leaves(jpp)):
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
