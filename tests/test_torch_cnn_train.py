"""The port's FedDUMAP trainer on the paper's CNNs against the JAX trainer.

``FederatedTrainer.run`` of ``fedap_plan(4, prune_round=2, ...)`` on
SimpleCNN in the three FedAP forms, mask, shrink and mask-then-shrink
(``shrink_round=3``: masks at round 2, the state compacted with its
momentum at round 3), and one ResNet18-GN mask run (GroupNorm's mask mode
only approximates a shrink, so port and JAX are compared in the same mode).
The world is the quickstart's (20 clients, server data p = 0.08) at 8x8x3.
Both trainers start from the same params and see the same batches: the
port is fed the JAX key chain's draws (``k, sub = split(k)`` per round,
then ``engine.sample_round_batches``), as ``tests/test_torch_train.py``
does.  Tolerance 1e-5 a round on the test-split loss and accuracy and on
tau_eff, and on the final params; p*, layer rates and kept filters equal.

ResNet18 (width 8) is not comparable round by round at 1e-5 by any two
float32 implementations: its trajectory depends on the last bits of its
sums (the port's own run moves its first round's test loss by 1.3e-2
between 1 and 8 CPU threads).  At 8x8 its last stage is 1x1 and GroupNorm
there normalises groups of 8 values that FedAP partly zeroes (gradients
reach ~22, against ~1 elsewhere); at 12x12 and 16x16 ReLU inputs within
~1e-7 of 0 flip within ~10 local steps.  Its gradients at the same params
are held at 1e-5 in ``tests/test_torch_cnn.py``.  Here its mask run is held
to the JAX decision made from the port's own state at the prune (same
rates and params in, the same p*, layer rates and kept filters out), to
finite rounds, and to the masks it must keep.
Both packages decide for themselves (the HRank selection on server data).
The JAX probe runs under ``jax.jit`` on the probe rows; its shrink and
mask-then-shrink runs replay the mask run's decision, since all three
plans hold the same state at the prune round.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import engine as jax_engine
from repro.core import fedap as jax_fedap
from repro.core import pruning as jax_pruning
from repro.core.backend import LocalScanBackend, sim_sample_kw
from repro.core.plan import fedap_plan as jax_fedap_plan
from repro.core.pruning import FedAPConfig as JaxFedAPConfig
from repro.core.rounds import FederatedTrainer as JaxTrainer
from repro.core.rounds import feddumap_config as jax_feddumap_config
from repro.data.pipeline import build_federated_data as jax_build
from repro.data.synthetic import SyntheticSpec as JaxSpec
from repro.models import cnn as jax_cnn
from repro_torch import interop
from repro_torch.core import fedap
from repro_torch.core.backend import PlanExecutor
from repro_torch.core.plan import Prune, Scan, TrainPlan, fedap_plan
from repro_torch.core.pruning import FedAPConfig
from repro_torch.core.rounds import FederatedTrainer, feddumap_config
from repro_torch.data.pipeline import build_federated_data
from repro_torch.data.synthetic import SyntheticSpec
from repro_torch.models import cnn
from repro_torch.utils.tree import tree_leaves
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SHAPE = (8, 8, 3)
WORLD = dict(num_clients=20, server_fraction=0.08, device_pool=2000)
CFG = dict(num_clients=20, clients_per_round=4, local_epochs=1,
           batch_size=10, server_batch_size=32, lr=0.05, lr_decay=0.99)
AP = dict(probe_size=16, participants=3, min_rate=0.3)
ROUNDS, PRUNE_ROUND, SHRINK_ROUND = 4, 2, 3
PLANS = {"mask": dict(mode="mask"), "shrink": dict(mode="shrink"),
         "mask-then-shrink": dict(mode="mask", shrink_round=SHRINK_ROUND)}
MODELS = {"simplecnn": ("SimpleCNN", {}, SHAPE),
          "resnet18": ("ResNet18", {"width": 8, "num_classes": 10}, SHAPE)}
RESNET = MODELS["resnet18"]


def _spec(shape):
    return dict(num_classes=10, image_shape=shape, train_size=3000,
                test_size=400, noise_scale=0.5)


def _random_params(model, seed):
    """He-normal weights drawn with numpy in the JAX layouts, biases 0 and
    GroupNorm scales 1 (the JAX init itself runs op by op: ~17 s for
    ResNet18 here)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        if len(s.shape) > 1:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) * np.sqrt(2.0 / fan_in)
                    ).astype(np.float32)
        ones = "scale" in jax.tree_util.keystr(path)
        return np.full(s.shape, 1.0 if ones else 0.0, np.float32)

    shapes = jax.eval_shape(model.init, jax.random.key(0))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_probe():
    """participant_rate jitted per model, on the probe rows only."""
    rate, cache = jax_fedap.participant_rate, {}

    def probe(m, p, p0, x, y, c):
        if id(m) not in cache:
            cache[id(m)] = (m, jax.jit(
                lambda p, p0, x, y: rate(m, p, p0, x, y, c)))
        return cache[id(m)][1](p, p0, x[:c.probe_size], y[:c.probe_size])

    return probe


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX trainer's runs, its per-round draws and the start params."""
    cfg = jax_feddumap_config(fedap=JaxFedAPConfig(**AP), **CFG)
    out = {}
    patch = pytest.MonkeyPatch()
    patch.setattr(jax_fedap, "participant_rate", _jax_probe())
    try:
        for name, (cls, kw_m, shape) in MODELS.items():
            if name != "simplecnn":
                model = getattr(jax_cnn, cls)(image_shape=shape, **kw_m)
                out[name, "params0"] = _random_params(model, 1)
                continue
            data = jax_build(spec=JaxSpec(**_spec(shape)), **WORLD)
            key = jax.random.key(cfg.seed)
            dev, kw = data.device_arrays(), sim_sample_kw(cfg, data)
            draws = []
            for _ in range(ROUNDS):
                key, sub = jax.random.split(key)
                draws.append(jax.tree.map(np.asarray, jax_engine.
                                          sample_round_batches(sub, dev,
                                                               **kw)))
            out[name, "draws"] = draws
            model = getattr(jax_cnn, cls)(image_shape=shape, **kw_m)
            params0 = _random_params(model, 1)
            out[name, "params0"] = params0
            out[name, "widths"] = {
                l.name: jax_pruning.get_path(params0, l.weight).shape[
                    l.filter_axis] for l in model.prune_spec(params0).layers}
            for plan_name, plan_kw in PLANS.items():
                out[name, plan_name] = JaxTrainer(model, data, cfg).run(
                    jax_fedap_plan(ROUNDS, prune_round=PRUNE_ROUND,
                                   **plan_kw), params=params0)
                if plan_name == "mask":
                    art = out[name, "mask"].artifacts["prune"]
                    decision = jax_fedap.FedAPDecision(
                        kept=art["kept"], p_star=art["p_star"],
                        layer_rates=art["layer_rates"])
                    patch.setattr(LocalScanBackend, "prune_decision",
                                  lambda self, state, init, d=decision: d)
            patch.undo()
            patch.setattr(jax_fedap, "participant_rate", _jax_probe())
    finally:
        patch.undo()
    return out


def _port_trainer(name):
    cls, kw, shape = MODELS[name]
    data = build_federated_data(spec=SyntheticSpec(**_spec(shape)), **WORLD)
    cfg = feddumap_config(fedap=FedAPConfig(**AP), **CFG)
    model = getattr(cnn, cls)(image_shape=shape, device="cpu", **kw)
    return FederatedTrainer(model, data, cfg, device="cpu")


@pytest.fixture(scope="module")
def port_runs(jax_runs):
    """The port's runs: SimpleCNN fed the JAX draws in every plan, and
    ResNet18's mask run on its own draws with the inputs of its decision
    recorded (``"resnet18", "decided"``)."""
    out = {}
    params0 = interop.cnn_params_from_jax(jax_runs["simplecnn", "params0"],
                                          "cpu")
    for plan_name, plan_kw in PLANS.items():
        out["simplecnn", plan_name] = _port_trainer("simplecnn").run(
            fedap_plan(ROUNDS, prune_round=PRUNE_ROUND, **plan_kw),
            params=params0, batches=lambda t: jax_runs["simplecnn", "draws"][t])
    decided = {}
    finish = fedap._finish_decision

    def record(model, data, cfg, params, rates, sizes, degrees):
        decided.update(params=interop.cnn_params_to_numpy(params),
                       rates=np.asarray(rates), sizes=np.asarray(sizes),
                       degrees=np.asarray(degrees))
        return finish(model, data, cfg, params, rates, sizes, degrees)

    patch = pytest.MonkeyPatch()
    patch.setattr(fedap, "_finish_decision", record)
    try:
        out["resnet18", "mask"] = _port_trainer("resnet18").run(
            fedap_plan(ROUNDS, prune_round=PRUNE_ROUND, mode="mask"),
            params=interop.cnn_params_from_jax(
                jax_runs["resnet18", "params0"], "cpu"))
    finally:
        patch.undo()
    out["resnet18", "decided"] = decided
    return out


RUNS = [("simplecnn", "mask"), ("simplecnn", "shrink"),
        ("simplecnn", "mask-then-shrink")]


@pytest.mark.parametrize("run", RUNS, ids=["-".join(r) for r in RUNS])
class TestTrainerMatchesJax:
    def test_history_per_round(self, jax_runs, port_runs, run):
        want, got = jax_runs[run].history, port_runs[run].history
        assert got["round"] == want["round"] == [1, 2, 3, 4]
        for key in ("loss", "acc", "tau_eff"):
            np.testing.assert_allclose(got[key], want[key], atol=1e-5,
                                       rtol=0, err_msg=key)

    def test_prune_decision(self, jax_runs, port_runs, run):
        want = jax_runs[run].artifacts["prune"]
        got = port_runs[run].artifacts["prune"]
        assert set(got["kept"]) == set(want["kept"])
        for k in got["kept"]:
            np.testing.assert_array_equal(got["kept"][k], want["kept"][k])
        assert got["kept_counts"] == want["kept_counts"]
        assert got["p_star"] == want["p_star"]
        assert got["layer_rates"] == want["layer_rates"]
        widths = jax_runs[run[0], "widths"]
        assert any(c < widths[k] for k, c in got["kept_counts"].items())

    def test_final_params(self, jax_runs, port_runs, run):
        want = jax.tree.leaves(jax_runs[run].params)
        got = jax.tree.leaves(interop.cnn_params_to_numpy(
            port_runs[run].params))
        assert [g.shape for g in got] == [w.shape for w in want]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=0)


@pytest.mark.parametrize("check", ["rounds", "decision", "masks"])
def test_resnet18_mask_run(port_runs, check):
    """ResNet18-GN in mask mode: finite rounds with the prune applied, the
    JAX decision from the port's state at the prune equal to the port's,
    and afterwards every pruned filter's weights, bias, GroupNorm scale and
    bias and the next conv's inputs held at 0."""
    got = port_runs["resnet18", "mask"]
    if check == "rounds":
        assert got.history["round"] == [1, 2, 3, 4]
        assert all(np.isfinite(got.history[k]).all()
                   for k in ("loss", "acc", "tau_eff"))
        assert got.artifacts["prune"]["mode"] == "mask"
    elif check == "decision":
        d = port_runs["resnet18", "decided"]
        cls, kw, shape = RESNET
        a = got.artifacts["prune"]
        own = float(jax_pruning.aggregate_rates(d["rates"], d["sizes"],
                                                d["degrees"]))
        own = float(np.clip(np.float32(own), AP["min_rate"], 0.9))
        assert abs(np.float32(own) - np.float32(a["p_star"])) <= \
            np.spacing(np.float32(a["p_star"]))
        patch = pytest.MonkeyPatch()
        patch.setattr(jax_fedap, "aggregate_rates",
                      lambda *args, **k: np.float32(a["p_star"]))
        try:
            want = jax_fedap._finish_decision(
                getattr(jax_cnn, cls)(image_shape=shape, **kw),
                jax_build(spec=JaxSpec(**_spec(shape)), **WORLD),
                JaxFedAPConfig(**AP), d["params"], d["rates"], d["sizes"],
                d["degrees"])
        finally:
            patch.undo()
        assert a["p_star"] == want.p_star
        assert a["layer_rates"] == want.layer_rates
        for k in a["kept"]:
            np.testing.assert_array_equal(a["kept"][k], want.kept[k])
    else:
        kept = got.artifacts["prune"]["kept"]
        pruned = 0
        for name, idx in kept.items():
            blk = got.params[name.split(".")[0]]
            gone = np.setdiff1d(np.arange(blk["conv1"]["w"].shape[0]), idx)
            pruned += len(gone)
            for t in (blk["conv1"]["w"][gone], blk["conv1"]["b"][gone],
                      blk["gn1"]["scale"][gone], blk["gn1"]["bias"][gone],
                      blk["conv2"]["w"][:, gone]):
                assert float(t.abs().sum()) == 0.0, name
        assert pruned > 0


def test_mask_then_shrink_compacts_to_the_first_decision(port_runs,
                                                         jax_runs):
    res = port_runs["simplecnn", "mask-then-shrink"]
    first, shrink = res.artifacts["prune"], res.artifacts["shrink"]
    assert shrink["reused"] == "prune" and shrink["mode"] == "shrink"
    assert shrink["kept_counts"] == first["kept_counts"]
    assert shrink["p_star"] == first["p_star"]
    for k, idx in first["kept"].items():
        assert res.params[k]["w"].shape[0] == len(idx)
    assert "masks" in res.state        # all ones at the shrunk shapes
    assert all(bool((m == 1).all()) for m in tree_leaves(res.state["masks"]))
    want = jax_runs["simplecnn", "mask-then-shrink"].artifacts["shrink"]
    assert shrink["kept_counts"] == want["kept_counts"]


def test_mask_prune_keeps_every_state_tensor_in_place():
    """Prune(mode="mask") on a CNN writes into the live round state: every
    tensor keeps its storage and shape, and training goes on in them."""
    trainer = _port_trainer("simplecnn")
    backend = trainer.backend(use_masks=True)
    params = trainer.model.init(torch.Generator().manual_seed(0))
    state, _ = backend.run_rounds(backend.init_state(params), 0, 1)
    before = [(t.data_ptr(), tuple(t.shape)) for t in tree_leaves(state)]
    kept = {"conv2": np.arange(0, 64, 2)}
    new_state, art = backend.apply_prune(state, "mask", kept)
    assert [(t.data_ptr(), tuple(t.shape))
            for t in tree_leaves(new_state)] == before
    assert set(art) == {"filter_masks"}
    assert float(art["filter_masks"]["conv2"].sum()) == 32
    assert float(new_state["params"]["conv3"]["w"][:, 1::2].abs().sum()) == 0
    state, _ = backend.run_rounds(new_state, 1, 1)
    assert [(t.data_ptr(), tuple(t.shape))
            for t in tree_leaves(state)] == before
    assert float(state["params"]["conv2"]["w"][1::2].abs().sum()) == 0


def test_compaction_gathers_the_momentum():
    """A reuse-shrink keeps the masked state's server momentum at the kept
    indices (new tensors); a plain shrink restarts it at zero."""
    trainer = _port_trainer("simplecnn")
    backend = trainer.backend(use_masks=True)
    params = trainer.model.init(torch.Generator().manual_seed(1))
    kept = {"conv1": np.arange(16), "conv3": np.arange(1, 64, 3)}
    state, _ = backend.run_rounds(backend.init_state(params), 0, 1)
    state, _ = backend.apply_prune(state, "mask", kept)
    state, _ = backend.run_rounds(state, 1, 1)
    m = state["server_m"]
    want = m["conv3"]["w"][kept["conv3"]].clone()
    compact, art = backend.apply_prune(state, "shrink", kept,
                                       compact_existing=True)
    assert art["params_before"] is state["params"]
    torch.testing.assert_close(compact["server_m"]["conv3"]["w"], want,
                               rtol=0, atol=0)
    assert compact["server_m"]["conv3"]["w"].data_ptr() != \
        m["conv3"]["w"].data_ptr()
    restart, _ = backend.apply_prune(state, "shrink", kept)
    assert all(float(t.abs().sum()) == 0
               for t in tree_leaves(restart["server_m"]))
    assert float(compact["round"]) == float(state["round"]) == 2.0


def test_reuse_validation():
    with pytest.raises(ValueError, match="needs mode='shrink'"):
        Prune(mode="mask", reuse="prune")
    with pytest.raises(ValueError, match="shrink_round"):
        fedap_plan(4, prune_round=2, mode="shrink", shrink_round=3)
    with pytest.raises(ValueError, match="shrink_round must be"):
        fedap_plan(4, prune_round=2, shrink_round=2)
    plan = fedap_plan(4, prune_round=2, shrink_round=3)
    assert [type(e).__name__ for e in plan.events] == [
        "Scan", "Eval", "Scan", "Eval", "Prune", "Scan", "Eval", "Prune",
        "Scan", "Eval"]
    assert plan.events[-3] == Prune(mode="shrink", reuse="prune",
                                    name="shrink")
    trainer = _port_trainer("simplecnn")
    with pytest.raises(ValueError, match="found no earlier prune"):
        PlanExecutor(trainer.backend()).run(
            TrainPlan(Scan(1), Prune(mode="shrink", reuse="prune")),
            params=trainer.model.init(torch.Generator().manual_seed(0)))
