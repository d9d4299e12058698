"""The paper's evaluation on the port against the JAX trainer.

* FedDyn with client dropout 0.25 and FedDUMAP with the HRank pruning
  hook, each a ``FederatedTrainer`` run on a small SimpleCNN world (16
  clients at 8x8x3, 4 a round), against the JAX trainer.  Both start from
  the same params and see the same batches: the port is fed the JAX key
  chain's draws (``k, sub = split(k)`` per round, then
  ``engine.sample_round_batches``, its ``"active"`` vector included), as
  ``tests/test_torch_cnn_train.py`` does.  Tolerance 1e-5 a round on the
  test-split loss and accuracy and on tau_eff, and on the final params and
  FedDyn's per-client and shared ``h`` (carried across by
  ``interop.round_state_from_jax(cnn=True)``); the HRank run's shrunk
  shapes equal.
* ``experiments.run_one`` for all 16 algorithms of ``suite_main`` at a
  tiny world (2 rounds, prune at round 1) finishes with finite histories
  and the reference's record keys.
"""
import jax
import numpy as np
import pytest

from repro.core import baselines as jax_baselines
from repro.core import engine as jax_engine
from repro.core.backend import sim_sample_kw
from repro.core.engine import FedDynConfig as JaxFedDynConfig
from repro.core.plan import TrainPlan as JaxTrainPlan
from repro.core.rounds import FederatedTrainer as JaxTrainer
from repro.core.rounds import feddumap_config as jax_feddumap_config
from repro.data.pipeline import build_federated_data as jax_build
from repro.data.synthetic import SyntheticSpec as JaxSpec
from repro.models import cnn as jax_cnn
from repro_torch import experiments, interop
from repro_torch.core import baselines
from repro_torch.core.engine import FedDynConfig
from repro_torch.core.plan import TrainPlan
from repro_torch.core.rounds import FederatedTrainer, feddumap_config
from repro_torch.data.pipeline import build_federated_data
from repro_torch.data.synthetic import SyntheticSpec
from repro_torch.models import cnn
from repro_torch.utils.tree import tree_leaves
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SHAPE = (8, 8, 3)
SPEC = dict(num_classes=10, image_shape=SHAPE, train_size=2600,
            test_size=300, noise_scale=0.45)
WORLD = dict(num_clients=16, server_fraction=0.1, device_pool=1600)
COMMON = dict(num_clients=16, clients_per_round=4, local_epochs=1,
              batch_size=10, server_batch_size=16, lr=0.05, lr_decay=0.99)
ROUNDS, PRUNE_ROUND = 3, 1
RUNS = {
    "feddyn-dropout": dict(
        jax=lambda: jax_baselines.feddyn_config(
            **COMMON, dropout_rate=0.25,
            feddyn=JaxFedDynConfig(alpha=0.05)),
        port=lambda: baselines.feddyn_config(
            **COMMON, dropout_rate=0.25, feddyn=FedDynConfig(alpha=0.05))),
    "feddumap-hrank": dict(
        jax=lambda: jax_feddumap_config(**COMMON),
        port=lambda: feddumap_config(**COMMON)),
}
RECORD_KEYS = {"tag", "algo", "model", "p", "server_niid", "rounds", "seed",
               "base_seed", "cell_index", "final_acc", "best_acc", "history",
               "mflops_before", "mflops_after", "wall_s"}


def _params0():
    model = jax_cnn.SimpleCNN(num_classes=10, image_shape=SHAPE)
    rng = np.random.default_rng(2)

    def leaf(s):
        if len(s.shape) > 1:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) * np.sqrt(2.0 / fan_in)
                    ).astype(np.float32)
        return np.zeros(s.shape, np.float32)

    return jax.tree.map(leaf, jax.eval_shape(model.init, jax.random.key(0)))


def _plan(name, pkg, model, data):
    if name == "feddyn-dropout":
        return pkg.TrainPlan.standard(ROUNDS)
    hook = pkg.baselines.make_hrank_pruning_hook(
        model, data, rate=0.4, prune_round=PRUNE_ROUND, probe=16)
    return pkg.TrainPlan.with_callback(ROUNDS, hook, eval_every=1)


class _Jax:
    TrainPlan, baselines = JaxTrainPlan, jax_baselines


class _Port:
    TrainPlan, baselines = TrainPlan, baselines


@pytest.fixture(scope="module")
def runs():
    params0 = _params0()
    jdata = jax_build(spec=JaxSpec(**SPEC), **WORLD)
    data = build_federated_data(spec=SyntheticSpec(**SPEC), **WORLD)
    out = {}
    for name, cfgs in RUNS.items():
        jcfg = cfgs["jax"]()
        jmodel = jax_cnn.SimpleCNN(num_classes=10, image_shape=SHAPE)
        want = JaxTrainer(jmodel, jdata, jcfg).run(
            _plan(name, _Jax, jmodel, jdata), params=params0)
        key = jax.random.key(jcfg.seed)
        dev, kw = jdata.device_arrays(), sim_sample_kw(jcfg, jdata)
        draws = []
        for _ in range(ROUNDS):
            key, sub = jax.random.split(key)
            draws.append(jax.tree.map(np.asarray, jax_engine.
                                      sample_round_batches(sub, dev, **kw)))
        model = cnn.SimpleCNN(num_classes=10, image_shape=SHAPE,
                              device="cpu")
        got = FederatedTrainer(model, data, cfgs["port"](), device="cpu").run(
            _plan(name, _Port, model, data),
            params=interop.cnn_params_from_jax(params0, "cpu"),
            batches=lambda t, d=draws: d[t])
        out[name] = (want, got, draws)
    return out


@pytest.mark.parametrize("name", list(RUNS))
def test_trainer_matches_jax_per_round(runs, name):
    want, got, draws = runs[name]
    assert got.history["round"] == want.history["round"] == [1, 2, 3]
    for key in ("loss", "acc", "tau_eff"):
        np.testing.assert_allclose(got.history[key], want.history[key],
                                   atol=1e-5, rtol=0, err_msg=key)
    jp = jax.tree.leaves(want.params)
    gp = jax.tree.leaves(interop.cnn_params_to_numpy(got.params))
    assert [g.shape for g in gp] == [w.shape for w in jp]
    for g, w in zip(gp, jp):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=0)
    if name == "feddyn-dropout":
        assert any(0 < d["active"].sum() < len(d["active"]) for d in draws)
        want_cs = interop.round_state_from_jax(
            {"client_state": jax.tree.map(np.asarray,
                                          want.state["client_state"])},
            "cpu", cnn=True)["client_state"]
        got_cs = tree_leaves(got.state["client_state"])
        assert any(float(h.abs().sum()) > 0 for h in got_cs)
        for g, w in zip(got_cs, tree_leaves(want_cs)):
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5,
                                       rtol=0)
    else:
        assert got.params["conv1"]["w"].shape[0] == 32 - int(0.4 * 32)
        assert all(float(m.abs().sum()) > 0
                   for m in tree_leaves(got.state["server_m"]))


@pytest.fixture(scope="module")
def tiny_records(tmp_path_factory):
    out = tmp_path_factory.mktemp("paper_torch")
    patch = pytest.MonkeyPatch()
    patch.setattr(experiments, "NUM_CLIENTS", 8)
    patch.setattr(experiments, "DEVICE_POOL", 400)
    patch.setattr(experiments, "SPEC", SyntheticSpec(
        num_classes=10, image_shape=SHAPE, train_size=1600, test_size=200,
        noise_scale=0.45))
    patch.setattr(experiments, "COMMON", dict(
        num_clients=8, clients_per_round=2, local_epochs=1, batch_size=10,
        lr=0.1, lr_decay=0.99))
    try:
        return {algo: experiments.run_one(
            f"tiny_{algo}", algo=algo, rounds=2, prune_round=1,
            out_dir=out, device="cpu") for algo in experiments.MAIN_ALGOS}
    finally:
        patch.undo()


@pytest.mark.parametrize("algo", experiments.MAIN_ALGOS)
def test_run_one_finishes_with_the_reference_record(tiny_records, algo):
    rec = tiny_records[algo]
    pruned = algo in ("fedap", "fedduap", "feddumap")
    assert set(rec) == RECORD_KEYS | {"device"} | (
        {"fedap"} if pruned else set())
    assert rec["device"] == "cpu" and rec["algo"] == algo
    assert rec["history"]["round"] == [2]
    assert all(np.isfinite(rec["history"][k]).all()
               for k in ("loss", "acc", "tau_eff"))
    if algo == "hrank":
        assert rec["mflops_after"] < rec["mflops_before"]
    elif not pruned:
        assert rec["mflops_after"] == rec["mflops_before"]


def test_mesh_backend_raises_naming_its_slice(tiny_records, tmp_path,
                                             monkeypatch):
    """``run_one(backend="mesh")`` at a world of one (gloo, this process)
    is bitwise the local run of the module's tiny world, FedDUMAP with its
    prune; an unknown backend is refused."""
    import torch.distributed as dist

    monkeypatch.setattr(experiments, "NUM_CLIENTS", 8)
    monkeypatch.setattr(experiments, "DEVICE_POOL", 400)
    monkeypatch.setattr(experiments, "SPEC", SyntheticSpec(
        num_classes=10, image_shape=SHAPE, train_size=1600, test_size=200,
        noise_scale=0.45))
    monkeypatch.setattr(experiments, "COMMON", dict(
        num_clients=8, clients_per_round=2, local_epochs=1, batch_size=10,
        lr=0.1, lr_decay=0.99))
    fresh = not dist.is_initialized()
    try:
        # the local record's tag: the cell's seed is the tag's hash
        rec = experiments.run_one("tiny_feddumap", algo="feddumap",
                                  rounds=2, prune_round=1, backend="mesh",
                                  out_dir=tmp_path, device="cpu")
    finally:
        if fresh and dist.is_initialized():
            dist.destroy_process_group()
    local = tiny_records["feddumap"]
    for k in ("round", "loss", "acc", "tau_eff"):
        assert rec["history"][k] == local["history"][k], k
    assert rec["fedap"] == local["fedap"]
    with pytest.raises(ValueError, match="backend must be one of"):
        experiments.run_one("x", backend="tpu", device="cpu")
    with pytest.raises(ValueError, match="backend must be one of"):
        experiments.suite_scenario_matrix("smoke", backends=("tpu",),
                                          device="cpu")
    assert experiments.cell_seed(0, 3) == experiments.cell_seed(0, 3) != \
        experiments.cell_seed(0, 4)
