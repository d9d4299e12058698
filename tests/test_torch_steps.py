"""The batch-dict FL step (``repro_torch.launch.steps``) and the model API
(``repro_torch.models.api``) against the JAX package.

* ``input_specs``: shapes and dtypes equal the reference's for all ten
  archs x four ``INPUT_SHAPES`` (abstract), and the concrete arrays of
  every reduced arch equal them value for value (one seed, one numpy
  generator, the same draw order); ``decode_cache_len`` and
  ``fl_batch_specs`` too.
* ``make_fl_train_step``: against the JAX step over the reference test's
  dict softmax model (3 rounds) and a reduced olmo-1b in kernel mode with a
  FedAP mask injected by ``with_masks`` between two rounds, within 1e-5 a
  round; against the port's own ``FederatedTrainer.round_step`` bitwise; a
  reduced whisper-small (2 + 2 layers) trained 2 rounds on ``enc_embeds``
  + tokens within 1e-5 of JAX; ``with_masks``' three refusals.
* ``make_prefill_step``/``make_decode_step`` against ``LM.apply`` /
  ``LM.decode_step`` and the JAX prefill step.

The JAX steps run under ``jax.jit``; each reduced model is jitted once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import INPUT_SHAPES as JAX_SHAPES
from repro.configs.base import InputShape as JaxInputShape
from repro.core.ref_engine import SoftmaxRegression
from repro.launch import steps as jsteps
from repro.models import api as japi
from repro.models.cnn import softmax_xent_acc
from repro_torch import interop
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import INPUT_SHAPES, InputShape
from repro_torch.core import engine
from repro_torch.core.rounds import FederatedTrainer, FLConfig
from repro_torch.data.pipeline import FederatedData
from repro_torch.launch import steps
from repro_torch.models import api
from repro_torch.utils.tree import tree_leaves, tree_map
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5


def _np(t):
    return np.asarray(t.detach().cpu().float() if t.dtype == torch.bfloat16
                      else t.detach().cpu())


def _assert_trees_close(got, want, atol=TOL, what=""):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w), what
    for a, b in zip(g, w):
        np.testing.assert_allclose(_np(a), np.asarray(b, np.float32),
                                   atol=atol, rtol=0, err_msg=what)


# ---------------------------------------------------------------------------
# input_specs, decode_cache_len, fl_batch_specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_specs_abstract_match_the_reference(arch):
    for name, shape in INPUT_SHAPES.items():
        want = japi.input_specs(jax_get_config(arch), JAX_SHAPES[name])
        got = api.input_specs(get_config(arch), shape)
        assert sorted(got) == sorted(want), (arch, name)
        for k, v in got.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == want[k].shape, (arch, name, k)
            assert str(v.dtype).removeprefix("torch.") == \
                str(want[k].dtype), (arch, name, k)
        assert api.decode_cache_len(get_config(arch), shape) == \
            japi.decode_cache_len(jax_get_config(arch), JAX_SHAPES[name])


SMALL = {"train": (16, 4), "prefill": (24, 2), "decode": (32, 3)}


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("kind", sorted(SMALL))
def test_input_specs_concrete_equal_the_reference(arch, kind):
    seq, b = SMALL[kind]
    cfg_j = jax_get_config(arch).reduced()
    want = japi.input_specs(cfg_j, JaxInputShape("s", seq, b, kind),
                            abstract=False, seed=5)
    got = api.input_specs(get_config(arch).reduced(),
                          InputShape("s", seq, b, kind), abstract=False,
                          seed=5, device="cpu")
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_array_equal(_np(v), np.asarray(want[k]))
        assert str(v.dtype).removeprefix("torch.") == str(want[k].dtype)


def _run_cfgs(**kw):
    return jsteps.FLRunConfig(**kw), steps.FLRunConfig(**kw)


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2-vl-7b",
                                  "whisper-small"])
def test_fl_batch_specs_equal_the_reference(arch):
    run_j, run_t = _run_cfgs(local_steps=2, server_tau=3, server_batch=2,
                             algorithm="feddyn")
    shape_j, shape_t = (JaxInputShape("t", 16, 6, "train"),
                        InputShape("t", 16, 6, "train"))
    cfg_j, cfg_t = jax_get_config(arch).reduced(), get_config(arch).reduced()
    for abstract in (True, False):
        want = jsteps.fl_batch_specs(cfg_j, shape_j, 3, run_j,
                                     abstract=abstract, seed=2)
        got = steps.fl_batch_specs(cfg_t, shape_t, 3, run_t,
                                   abstract=abstract, seed=2, device="cpu")
        assert set(got) == set(want)
        for part in ("client", "server"):
            assert sorted(got[part]) == sorted(want[part])
            for k, v in got[part].items():
                assert tuple(v.shape) == want[part][k].shape, (part, k)
                if not abstract:
                    np.testing.assert_array_equal(
                        _np(v), np.asarray(want[part][k]))
        for k in ("sizes", "d_round", "d_server", "n0", "sel"):
            assert tuple(got[k].shape) == want[k].shape
            if not abstract:
                np.testing.assert_array_equal(_np(got[k]),
                                              np.asarray(want[k]))


# ---------------------------------------------------------------------------
# make_fl_train_step against the JAX step and against round_step
# ---------------------------------------------------------------------------

DIM, CLASSES, CLIENTS, STEPS, BATCH, TAU, SBATCH = 6, 4, 3, 2, 5, 3, 5


class JaxDictSoftmax:
    """The reference test's dict softmax model (``test_engine_diff``)."""

    def __init__(self):
        self._np = SoftmaxRegression(dim=DIM, num_classes=CLASSES)

    def init(self, rng):
        return jax.tree.map(jnp.asarray, self._np.init(seed=7))

    def apply(self, params, batch):
        return batch["x"] @ params["w"] + params["b"], jnp.zeros(())

    def loss(self, params, batch):
        return softmax_xent_acc(self.apply(params, batch)[0],
                                batch["labels"])[0]


def _xent_acc(logits, y):
    logp = torch.log_softmax(logits, -1)
    loss = -torch.gather(logp, -1, y.long()[..., None]).mean()
    return loss, (logits.argmax(-1) == y).float().mean()


class DictSoftmax:
    """The same model on the port's batch-dict contract."""

    def init(self, generator):
        p = SoftmaxRegression(dim=DIM, num_classes=CLASSES).init(seed=7)
        return {k: torch.as_tensor(np.asarray(v)) for k, v in p.items()}

    def apply_with_aux(self, params, batch):
        return batch["x"] @ params["w"] + params["b"], None

    def loss(self, params, batch):
        return _xent_acc(self.apply_with_aux(params, batch)[0],
                         batch["labels"])[0]


class XYSoftmax(DictSoftmax):
    """... and on the simulation trainer's ``loss_and_acc(p, x, y)``."""

    def loss_and_acc(self, params, x, y):
        return _xent_acc(x @ params["w"] + params["b"], y)


def _softmax_rounds():
    rng = np.random.default_rng(42)
    rounds = []
    for _ in range(3):
        rounds.append({
            "client": {"x": rng.standard_normal((CLIENTS, STEPS, BATCH, DIM))
                       .astype(np.float32),
                       "labels": rng.integers(0, CLASSES, (CLIENTS, STEPS,
                                                           BATCH))
                       .astype(np.int32)},
            "server": {"x": rng.standard_normal((TAU, SBATCH, DIM))
                       .astype(np.float32),
                       "labels": rng.integers(0, CLASSES, (TAU, SBATCH))
                       .astype(np.int32)},
            "sizes": np.asarray([40.0, 25.0, 35.0], np.float32),
            "d_round": np.float32(0.3), "d_server": np.float32(0.02),
            "n0": np.float32(500.0)})
    return rounds


def _torch_batch(b):
    return tree_map(lambda a: torch.as_tensor(np.asarray(a)), b)


def test_train_step_matches_the_jax_step_and_round_step():
    kw = dict(lr=0.08, local_steps=STEPS, server_tau=TAU,
              server_batch=SBATCH)
    run_j, run_t = _run_cfgs(**kw)
    init_j, step_j = jsteps.make_fl_train_step(None, run_j, CLIENTS,
                                               model=JaxDictSoftmax())
    init_t, step_t = steps.make_fl_train_step(None, run_t, CLIENTS,
                                              model=DictSoftmax())
    sj = init_j(jax.random.key(0))
    st = init_t(torch.Generator())
    # the simulation wiring of the same algorithm, from tuple batches
    data = FederatedData(
        client_x=np.zeros((CLIENTS, STEPS * BATCH, DIM), np.float32),
        client_y=np.zeros((CLIENTS, STEPS * BATCH), np.int64),
        sizes=np.asarray([40.0, 25.0, 35.0], np.float32),
        client_dists=np.full((CLIENTS, CLASSES), 0.25, np.float32),
        server_x=np.zeros((TAU * SBATCH, DIM), np.float32),
        server_y=np.zeros((TAU * SBATCH,), np.int64),
        server_dist=np.full((CLASSES,), 0.25, np.float32),
        test_x=np.zeros((4, DIM), np.float32),
        test_y=np.zeros((4,), np.int64))
    trainer = FederatedTrainer(XYSoftmax(), data, FLConfig(
        num_clients=CLIENTS, clients_per_round=CLIENTS, local_epochs=1,
        batch_size=BATCH, lr=0.08, lr_decay=1.0, use_server_update=True,
        local_momentum="restart", server_momentum=True,
        server_batch_size=SBATCH), device="cpu")
    ss = engine.init_round_state(XYSoftmax().init(None),
                                 trainer.backend().eng)
    for r, b in enumerate(_softmax_rounds()):
        sj, tj = jax.jit(step_j)(sj, jax.tree.map(jnp.asarray, b))
        st, tt = step_t(st, _torch_batch(b))
        tup = dict(b, client=(b["client"]["x"], b["client"]["labels"]),
                   server=(b["server"]["x"], b["server"]["labels"]))
        ss, ms = trainer.round_step(ss, tup)
        _assert_trees_close(st["params"], sj["params"], what=f"round {r}")
        _assert_trees_close(st["server_m"], sj["server_m"],
                            what=f"round {r}")
        assert abs(float(tt) - float(tj)) <= TOL
        for a, c in zip(tree_leaves(st), tree_leaves(ss)):
            assert torch.equal(a, c), f"round {r}: round_step differs"
        assert torch.equal(tt, ms["tau_eff"])


OLMO_T = get_config("olmo-1b").reduced(vocab_size=256, d_ff=512)
OLMO_J = jax_get_config("olmo-1b").reduced(vocab_size=256, d_ff=512)
SHAPE_T, SHAPE_J = (InputShape("t", 16, 4, "train"),
                    JaxInputShape("t", 16, 4, "train"))


def test_kernel_mode_step_with_a_mask_matches_jax_and_round_step():
    """Reduced olmo-1b, FLRunConfig(use_masks, masked_compute="kernel"):
    round 1 on all-ones masks, ``with_masks`` injects a decision, round 2;
    the port against JAX at 1e-5 and against ``round_step`` bitwise, and
    every state tensor keeps its storage through the injection."""
    kw = dict(lr=3e-3, local_steps=2, server_tau=2, server_batch=2,
              use_masks=True, masked_compute="kernel")
    run_j, run_t = _run_cfgs(**kw)
    init_j, step_j = jsteps.make_fl_train_step(OLMO_J, run_j, 2)
    model_j = japi.build_model(OLMO_J)
    pj = model_j.init(jax.random.key(1))
    sj = init_j(jax.random.key(1),
                filter_masks=model_j.filter_masks(pj, {}))
    model_t = api.build_model(OLMO_T, device="cpu")
    init_t, step_t = steps.make_fl_train_step(OLMO_T, run_t, 2,
                                              model=model_t)
    pt = interop.params_from_jax(pj, device="cpu")
    st = init_t(torch.Generator().manual_seed(0),
                filter_masks=model_t.filter_masks(pt, {}))
    tree_map(lambda dst, src: dst.copy_(src), st["params"], pt)
    trainer = FederatedTrainer(model_t, _lm_data(), FLConfig(
        num_clients=2, clients_per_round=2, local_epochs=1, batch_size=2,
        lr=3e-3, lr_decay=1.0, local_momentum="restart",
        server_momentum=True, server_batch_size=2, masked_compute="kernel"),
        device="cpu")
    ss = tree_map(torch.clone, st)
    ptrs = [t.data_ptr() for t in tree_leaves(st)]
    bj = jsteps.fl_batch_specs(OLMO_J, SHAPE_J, 2, run_j, abstract=False,
                               seed=4)
    bt = steps.fl_batch_specs(OLMO_T, SHAPE_T, 2, run_t, abstract=False,
                              seed=4, device="cpu")
    tup = dict(bt, client=(bt["client"]["tokens"], bt["client"]["labels"]),
               server=(bt["server"]["tokens"], bt["server"]["labels"]))
    rng = np.random.default_rng(0)
    kept = {"mlp": np.sort(np.stack([rng.choice(512, 256, replace=False)
                                     for _ in range(2)]), axis=1)}
    step_j = jax.jit(step_j)
    for r in range(2):
        if r == 1:
            sj = jsteps.with_masks(sj, model_j.param_masks(sj["params"], kept),
                                   model_j.filter_masks(sj["params"], kept))
            fm = model_t.filter_masks(st["params"], kept)
            st = steps.with_masks(st, model_t.param_masks(st["params"], kept),
                                  fm)
            ss = steps.with_masks(ss, model_t.param_masks(ss["params"], kept),
                                  fm)
        sj, tj = step_j(sj, bj)
        st, tt = step_t(st, bt)
        ss, _ = trainer.round_step(ss, tup)
        _assert_trees_close(st["params"], sj["params"], what=f"round {r}")
        assert abs(float(tt) - float(tj)) <= TOL
        for a, c in zip(tree_leaves(st), tree_leaves(ss)):
            assert torch.equal(a, c), f"round {r}: round_step differs"
    assert [t.data_ptr() for t in tree_leaves(st)] == ptrs
    wi = st["params"]["layers"]["mlp"]["wi"]
    assert int((wi.abs().sum(1) == 0).sum()) == 2 * 256


QWEN_T = get_config("qwen2-vl-7b").reduced()
QWEN_J = jax_get_config("qwen2-vl-7b").reduced()


def test_vlm_step_on_embeds_matches_jax():
    """Reduced qwen2-vl-7b through the step on its ``embeds`` + 3-stream
    ``positions`` batch: the token embedding table is not read, and its
    gradient is zero (``jax.grad``'s), not an autograd error; two rounds
    against the jitted JAX step at 1e-5."""
    run_j, run_t = _run_cfgs(lr=3e-3, local_steps=1, server_tau=1,
                             server_batch=2)
    init_j, step_j = jsteps.make_fl_train_step(QWEN_J, run_j, 2)
    sj = init_j(jax.random.key(3))
    init_t, step_t = steps.make_fl_train_step(QWEN_T, run_t, 2,
                                              device="cpu")
    st = init_t(torch.Generator().manual_seed(0))
    tree_map(lambda dst, src: dst.copy_(src), st["params"],
             interop.params_from_jax(sj["params"], device="cpu"))
    bj = jsteps.fl_batch_specs(QWEN_J, SHAPE_J, 2, run_j, abstract=False,
                               seed=5)
    bt = steps.fl_batch_specs(QWEN_T, SHAPE_T, 2, run_t, abstract=False,
                              seed=5, device="cpu")
    assert "embeds" in bt["client"] and "tokens" not in bt["client"]
    embed = st["params"]["embed"].clone()
    step_j = jax.jit(step_j)
    for r in range(2):
        sj, tj = step_j(sj, bj)
        st, tt = step_t(st, bt)
        _assert_trees_close(st["params"], sj["params"], what=f"round {r}")
        assert abs(float(tt) - float(tj)) <= TOL
    assert torch.equal(st["params"]["embed"], embed)


def _lm_data():
    z = np.zeros
    return FederatedData(
        client_x=z((2, 4, 16), np.int32), client_y=z((2, 4, 16), np.int32),
        sizes=np.ones(2, np.float32),
        client_dists=np.full((2, 4), 0.25, np.float32),
        server_x=z((4, 16), np.int32), server_y=z((4, 16), np.int32),
        server_dist=np.full((4,), 0.25, np.float32),
        test_x=z((2, 16), np.int32), test_y=z((2, 16), np.int32))


def test_with_masks_refusals():
    run_plain = steps.FLRunConfig()
    init_p, _ = steps.make_fl_train_step(None, run_plain, 2,
                                         model=DictSoftmax())
    with pytest.raises(ValueError, match="no mask slot"):
        steps.with_masks(init_p(torch.Generator()), {})
    init_k, _ = steps.make_fl_train_step(None, steps.FLRunConfig(
        use_masks=True, masked_compute="kernel"), 2, model=DictSoftmax())
    with pytest.raises(ValueError, match="filter_masks slot"):
        steps.with_masks(init_k(torch.Generator(), filter_masks={}), {})
    init_m, _ = steps.make_fl_train_step(None, steps.FLRunConfig(
        use_masks=True), 2, model=DictSoftmax())
    with pytest.raises(ValueError, match="no filter_masks slot"):
        steps.with_masks(init_m(torch.Generator()), {}, filter_masks={})


WHISPER_T = get_config("whisper-small").reduced(num_heads=12,
                                                num_kv_heads=12)
WHISPER_J = jax_get_config("whisper-small").reduced(num_heads=12,
                                                    num_kv_heads=12)


def test_whisper_trains_through_the_step_like_jax():
    """encdec trains on batch dicts (enc_embeds + tokens): 2 FedDUM rounds
    of a reduced whisper-small, each within 1e-5 of the JAX step."""
    kw = dict(lr=3e-3, local_steps=1, server_tau=2, server_batch=2)
    run_j, run_t = _run_cfgs(**kw)
    init_j, step_j = jsteps.make_fl_train_step(WHISPER_J, run_j, 2)
    sj = init_j(jax.random.key(2))
    init_t, step_t = steps.make_fl_train_step(WHISPER_T, run_t, 2,
                                              device="cpu")
    st = init_t(torch.Generator().manual_seed(0))
    tree_map(lambda dst, src: dst.copy_(src), st["params"],
             interop.params_from_jax(sj["params"], device="cpu"))
    shape_j, shape_t = (JaxInputShape("t", 8, 4, "train"),
                        InputShape("t", 8, 4, "train"))
    step_j = jax.jit(step_j)
    for r in range(2):
        bj = jsteps.fl_batch_specs(WHISPER_J, shape_j, 2, run_j,
                                   abstract=False, seed=10 + r)
        bt = steps.fl_batch_specs(WHISPER_T, shape_t, 2, run_t,
                                  abstract=False, seed=10 + r, device="cpu")
        assert set(bt["client"]) == {"enc_embeds", "tokens", "labels"}
        sj, tj = step_j(sj, bj)
        st, tt = step_t(st, bt)
        _assert_trees_close(st["params"], sj["params"], what=f"round {r}")
        assert abs(float(tt) - float(tj)) <= TOL
        assert all(bool(torch.isfinite(t).all())
                   for t in tree_leaves(st["params"]))


def test_prefill_and_decode_steps():
    model, prefill = steps.make_prefill_step(OLMO_T, device="cpu")
    _, decode = steps.make_decode_step(OLMO_T, device="cpu")
    jmodel, jprefill = jsteps.make_prefill_step(OLMO_J)
    pj = jmodel.init(jax.random.key(3))
    params = interop.params_from_jax(pj, device="cpu")
    batch = api.input_specs(OLMO_T, InputShape("p", 12, 2, "prefill"),
                            abstract=False, seed=1, device="cpu")
    jbatch = japi.input_specs(OLMO_J, JaxInputShape("p", 12, 2, "prefill"),
                              abstract=False, seed=1)
    with torch.no_grad():
        got = prefill(params, batch)
        assert torch.equal(got, model.apply(params, batch)[:, -1, :])
        np.testing.assert_allclose(_np(got), np.asarray(jprefill(pj, jbatch)),
                                   atol=TOL, rtol=0)
        cache = model.init_cache(2, 16)
        twin = model.init_cache(2, 16)
        step = {"tokens": batch["tokens"][:, :1]}
        logits, cache = decode(params, cache, step)
        want, twin = model.decode_step(params, twin, step)
        assert torch.equal(logits, want)
        assert int(cache["index"]) == 1
