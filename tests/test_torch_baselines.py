"""The port's ``core/baselines.py`` and plan events against the reference.

* Every config recipe gives the reference's ``FLConfig``, field for field.
* Data-sharing and Hybrid-FL transform a federated dataset array-equal to
  the reference's transforms of the same dataset.
* ``unstructured_magnitude_mask`` equals the reference's on the same
  params; the FedDF and FedKT hooks give the JAX hooks' params within
  1e-5 from the same params and seed (both distill on the same numpy
  draws; FedDF's teacher is the student's own start, where its KL has a
  zero gradient, so it barely moves in either package), and the HRank
  hook keeps the reference's filters.
* ``TrainPlan.with_callback`` and ``chunk_lengths`` equal the reference's
  event for event.
* A ``Snapshot`` is a copy that later rounds leave as it was; a Callback's
  return restarts the momentum and client state and keeps the round count
  and masks; a mask prune keeps every state tensor's storage, FedDyn's
  client state included.

The CNN is SimpleCNN at 8x8x3 with params drawn in numpy in the JAX
layouts (``interop.cnn_params_from_jax`` carries them across).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jax_baselines
from repro.core import plan as jax_plan
from repro.data.pipeline import build_federated_data as jax_build
from repro.data.synthetic import SyntheticSpec as JaxSpec
from repro.models import cnn as jax_cnn
from repro_torch import interop
from repro_torch.core import baselines, plan
from repro_torch.core.engine import FedDynConfig
from repro_torch.core.plan import Callback, Eval, Prune, Scan, Snapshot, TrainPlan
from repro_torch.core.rounds import FederatedTrainer, FLConfig
from repro_torch.data.pipeline import build_federated_data
from repro_torch.data.synthetic import SyntheticSpec
from repro_torch.models import cnn
from repro_torch.utils.tree import tree_leaves, tree_map
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SHAPE = (8, 8, 3)
SPEC = dict(num_classes=10, image_shape=SHAPE, train_size=1600,
            test_size=200, noise_scale=0.45)
WORLD = dict(num_clients=8, server_fraction=0.1, device_pool=400)
RECIPES = ("fedavg_config", "feddu_config", "server_momentum_config",
           "device_momentum_config", "fedda_config", "fedprox_config",
           "feddyn_config")


@pytest.fixture(scope="module")
def worlds():
    return (jax_build(spec=JaxSpec(**SPEC), **WORLD),
            build_federated_data(spec=SyntheticSpec(**SPEC), **WORLD))


@pytest.fixture(scope="module")
def cnn_params():
    """SimpleCNN params in the JAX layouts, He-normal from numpy."""
    model = jax_cnn.SimpleCNN(num_classes=10, image_shape=SHAPE)
    rng = np.random.default_rng(5)

    def leaf(s):
        if len(s.shape) > 1:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) * np.sqrt(2.0 / fan_in)
                    ).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return model, jax.tree.map(leaf, jax.eval_shape(model.init,
                                                    jax.random.key(0)))


def _port_model():
    return cnn.SimpleCNN(num_classes=10, image_shape=SHAPE, device="cpu")


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _plain(v):
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


@pytest.mark.parametrize("recipe", RECIPES)
def test_recipe_equals_the_reference_field_for_field(recipe):
    kw = dict(num_clients=12, clients_per_round=3, seed=5, lr=0.05)
    got = _fields(getattr(baselines, recipe)(**kw))
    want = _fields(getattr(jax_baselines, recipe)(**kw))
    for name, value in got.items():
        assert _plain(value) == _plain(want[name]), name


@pytest.mark.parametrize("transform", ["data_sharing", "hybrid_fl"])
def test_data_transforms_are_array_equal(worlds, transform):
    jdata, data = worlds
    if transform == "data_sharing":
        got = baselines.apply_data_sharing(data, np.random.default_rng(3))
        want = jax_baselines.apply_data_sharing(jdata,
                                                np.random.default_rng(3))
        assert got.client_x.shape[1] == data.client_x.shape[1] + (
            data.server_x.shape[0] // data.client_x.shape[0])
    else:
        got = baselines.apply_hybrid_fl(data)
        want = jax_baselines.apply_hybrid_fl(jdata)
        assert got.client_x.shape[0] == data.client_x.shape[0] + 1
    for f in dataclasses.fields(got):
        a, b = np.asarray(getattr(got, f.name)), np.asarray(getattr(want,
                                                                    f.name))
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


def test_unstructured_magnitude_mask_equals_the_reference():
    rng = np.random.default_rng(0)
    tree = {"a": {"w": rng.standard_normal((5, 7)).astype(np.float32)},
            "b": np.round(rng.standard_normal(13), 1).astype(np.float32)}
    for rate in (0.0, 0.3, 0.5, 0.99):
        got = baselines.unstructured_magnitude_mask(
            interop.params_from_jax(tree, "cpu"), rate)
        want = jax_baselines.unstructured_magnitude_mask(
            jax.tree.map(jnp.asarray, tree), rate)
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("mode", ["feddf", "fedkt"])
def test_distillation_hook_matches_jax(worlds, cnn_params, mode):
    jdata, data = worlds
    jmodel, params = cnn_params
    kw = dict(mode=mode, steps=3, batch=8, lr=0.05, seed=4)
    want = jax_baselines.make_distillation_round_end(jmodel, jdata, **kw)(
        None, 1, jax.tree.map(jnp.asarray, params))
    got = baselines.make_distillation_round_end(_port_model(), data, **kw)(
        None, 1, interop.cnn_params_from_jax(params, "cpu"))
    moved = 0.0
    for g, w, p0 in zip(jax.tree.leaves(interop.cnn_params_to_numpy(got)),
                        jax.tree.leaves(want), jax.tree.leaves(params)):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=0)
        moved = max(moved, float(np.abs(np.asarray(w) - p0).max()))
    # the teacher is the student's own start: FedKT's hard labels pull it
    # away, FedDF's KL has a zero gradient there in both packages
    assert moved > 1e-4 if mode == "fedkt" else moved < 1e-6


class _Trainer:
    model = None


def test_hrank_hook_keeps_the_reference_filters(worlds, cnn_params):
    jdata, data = worlds
    jmodel, params = cnn_params
    kw = dict(rate=0.4, prune_round=2, probe=16)
    jt, pt = _Trainer(), _Trainer()
    jhook = jax_baselines.make_hrank_pruning_hook(jmodel, jdata, **kw)
    hook = baselines.make_hrank_pruning_hook(_port_model(), data, **kw)
    port_params = interop.cnn_params_from_jax(params, "cpu")
    assert hook(pt, 1, port_params) is None and pt.model is None
    want = jhook(jt, 2, jax.tree.map(jnp.asarray, params))
    got = interop.cnn_params_to_numpy(hook(pt, 2, port_params))
    assert pt.model is not None
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got["conv1"]["w"].shape[-1] == 32 - int(0.4 * 32)


def _events(p):
    return [(type(e).__name__, e.rounds if type(e).__name__ == "Scan" else
             getattr(e, "name", None)) for e in p.events]


@pytest.mark.parametrize("rounds,every,eval_every",
                         [(6, 1, 2), (7, 3, 2), (5, 2, 0), (4, 4, 1)])
def test_with_callback_and_chunk_lengths_equal_the_reference(rounds, every,
                                                             eval_every):
    def fn(trainer, t, params):
        return None

    got = TrainPlan.with_callback(rounds, fn, every=every,
                                  eval_every=eval_every)
    want = jax_plan.TrainPlan.with_callback(rounds, fn, every=every,
                                            eval_every=eval_every)
    assert _events(got) == _events(want)
    assert all(e.fn is fn for e in got.events if isinstance(e, Callback))
    assert got.chunk_lengths() == want.chunk_lengths()
    mixed = (Scan(2), Eval(), Snapshot(), Scan(1), Scan(2), Callback(fn))
    jmixed = (jax_plan.Scan(2), jax_plan.Eval(), jax_plan.Snapshot(),
              jax_plan.Scan(1), jax_plan.Scan(2), jax_plan.Callback(fn))
    assert TrainPlan(mixed).chunk_lengths() == \
        jax_plan.TrainPlan(jmixed).chunk_lengths() == (2, 3)


def _trainer(data, **kw):
    cfg = FLConfig(num_clients=8, clients_per_round=2, local_epochs=1,
                   batch_size=10, server_batch_size=16, lr=0.05,
                   local_momentum="restart", server_momentum=True, **kw)
    return FederatedTrainer(_port_model(), data, cfg, device="cpu")


def test_snapshot_is_unchanged_by_later_rounds(worlds):
    _, data = worlds
    params = _port_model().init(torch.Generator().manual_seed(0))
    res = _trainer(data).run(TrainPlan(Scan(1), Snapshot(), Scan(2)),
                             params=params)
    one = _trainer(data).run(TrainPlan(Scan(1)), params=params)
    snap = res.artifacts["snapshot"]
    assert snap["round"] == 1
    for s, a, b in zip(tree_leaves(snap["params"]), tree_leaves(one.params),
                       tree_leaves(res.params)):
        assert torch.equal(s, a)
        assert s.data_ptr() != b.data_ptr()
    assert not all(torch.equal(s, b) for s, b in zip(
        tree_leaves(snap["params"]), tree_leaves(res.params)))


def test_callback_restart_keeps_round_count_and_masks(worlds):
    _, data = worlds
    trainer = _trainer(data, algorithm="feddyn",
                       feddyn=FedDynConfig(alpha=0.1))
    params = trainer.model.init(torch.Generator().manual_seed(1))
    seen = []

    def fn(tr, t, p):
        seen.append((tr, t))
        assert all(a.data_ptr() != b.data_ptr() for a, b in zip(
            tree_leaves(p), tree_leaves(backend_state[0]["params"])))
        return tree_map(lambda x: x * 0.5, p)

    backend = trainer.backend(use_masks=True)
    backend_state = []
    run_rounds = backend.run_rounds

    def spy(state, t, n):
        state, mets = run_rounds(state, t, n)
        backend_state[:] = [state]
        return state, mets

    backend.run_rounds = spy
    kept = {"conv2": np.arange(0, 64, 2)}
    backend.prune_decision = lambda state, init: type(
        "D", (), {"kept": kept, "summary": lambda self: {
            "p_star": 0.5, "layer_rates": {}, "kept_counts": {}}})()
    res = trainer.run(TrainPlan(Scan(1), Prune(mode="mask"), Scan(1),
                                Callback(fn), Snapshot()), params=params)
    assert seen == [(trainer, 2)]
    state = res.state
    assert float(state["round"]) == 2.0
    assert float(state["masks"]["conv2"]["w"][1::2].abs().sum()) == 0.0
    assert float(state["masks"]["conv2"]["w"][0::2].min()) == 1.0
    for k in ("server_m", "client_state"):
        assert all(float(t.abs().sum()) == 0.0
                   for t in tree_leaves(state[k])), k
    snap = res.artifacts["snapshot"]["params"]
    assert float(snap["conv2"]["w"][1::2].abs().sum()) == 0.0


def test_mask_prune_keeps_every_state_tensor_in_place_with_client_state(
        worlds):
    _, data = worlds
    trainer = _trainer(data, algorithm="feddyn",
                       feddyn=FedDynConfig(alpha=0.1))
    backend = trainer.backend(use_masks=True)
    params = trainer.model.init(torch.Generator().manual_seed(2))
    state, _ = backend.run_rounds(backend.init_state(params), 0, 1)
    assert any(float(h.abs().sum()) > 0
               for h in tree_leaves(state["client_state"]))
    before = [(t.data_ptr(), tuple(t.shape)) for t in tree_leaves(state)]
    new_state, _ = backend.apply_prune(state, "mask",
                                       {"conv1": np.arange(16)})
    assert [(t.data_ptr(), tuple(t.shape))
            for t in tree_leaves(new_state)] == before
    assert all(float(h.abs().sum()) == 0.0
               for h in tree_leaves(new_state["client_state"]))
    state, _ = backend.run_rounds(new_state, 1, 1)
    assert [(t.data_ptr(), tuple(t.shape))
            for t in tree_leaves(state)] == before
    h = state["client_state"]["per_client"]["h"]["conv1"]["w"]
    assert h.shape[0] == 8 and float(h[:, 16:].abs().sum()) == 0.0


def test_plan_events_mirror_the_reference():
    assert plan.Event.__args__ == (Scan, Eval, Prune, Snapshot, Callback)
    with pytest.raises(TypeError, match="not a TrainPlan event"):
        TrainPlan(Scan(1), "eval")
