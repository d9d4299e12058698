"""The port's health guard and device faults against the reference.

Mirrors ``tests/test_reliability.py::TestHealthGuards`` on the port's
``round_core``, in the reference test's own world (``ref_engine.
SoftmaxRegression``: 6 features, 4 classes; 3 clients x 2 steps of 5, 3
server steps of 5, 3 rounds, numpy seed 42; selections ``SELS`` over 6
clients), rebuilt value for value.  Client 2 (slot 1 of round 1) is the
victim of ``NaNGrad``.  For every ``GUARD_TABLE`` row (FedAvg with FedDU
and with FedDA, FedDyn with FedDUM) the guarded port round is held to:

* ``ref_engine.ref_round`` in float64 WITHOUT the fault and the guard but
  with the victim inactive (``active=0``): rejection is dropout;
* the JAX ``round_core`` with the reference's own fault and guard (one
  jitted scan a row).

Tolerance 1e-5 a round, as the reference holds.  Then: ``skip_round``
leaves params, momentum and client state bitwise as the round found them
while the counter advances; a round where every client goes bad is
discarded; a guard that never fires changes nothing (1e-6); a rejected
FedDyn client's ``h`` row is untouched; and the trainer records the
guard's health a round.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jax_engine
from repro.core import ref_engine
from repro.core.ref_engine import SoftmaxRegression
from repro.models.cnn import softmax_xent_acc as jax_xent
from repro.reliability import NaNGrad as JaxNaNGrad
from repro_torch.core import engine
from repro_torch.core.engine import EngineConfig, FedDynConfig
from repro_torch.models.cnn import softmax_xent_acc
from repro_torch.reliability import CorruptUpdate, NaNGrad
from repro_torch.utils.tree import tree_leaves, tree_map
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

DIM, CLASSES = 6, 4
CLIENTS, STEPS, BATCH = 3, 2, 5
TAU, SBATCH = 3, 5
ROUNDS = 3
N_TOTAL = 6
SELS = np.asarray([[4, 1, 3], [0, 2, 5], [5, 0, 2]], np.int32)
VICTIM = 2             # client id; slot 1 of round 1's selection
FAULT_ROUND = 1

MODES = {
    "feddu": dict(use_server_update=True, local_momentum="none",
                  server_momentum=False),
    "feddum": dict(use_server_update=True, local_momentum="restart",
                   server_momentum=True),
    "fedda": dict(use_server_update=True, local_momentum="communicated",
                  server_momentum=True),
}
ALGOS = {
    "fedavg": ({}, {}),
    "feddyn": (dict(algorithm="feddyn",
                    feddyn=jax_engine.FedDynConfig(alpha=0.05)),
               dict(algorithm="feddyn", feddyn=FedDynConfig(alpha=0.05))),
}
GUARD_TABLE = [("fedavg", "feddu"), ("fedavg", "fedda"),
               ("feddyn", "feddum")]
IDS = [f"{a}-{m}" for a, m in GUARD_TABLE]


@pytest.fixture(scope="module")
def world():
    """``test_reliability.eng_world``'s model, params and rounds."""
    model = SoftmaxRegression(dim=DIM, num_classes=CLASSES)
    rng = np.random.default_rng(42)
    params = model.init(seed=7)

    def batches(lead):
        x = rng.standard_normal(lead + (DIM,)).astype(np.float32)
        y = rng.integers(0, CLASSES, lead).astype(np.int32)
        return x, y

    rounds = []
    for r in range(ROUNDS):
        cx, cy = batches((CLIENTS, STEPS, BATCH))
        sx, sy = batches((TAU, SBATCH))
        rounds.append({
            "client": (cx, cy),
            "sizes": np.asarray([40.0, 25.0, 35.0], np.float32),
            "sel": SELS[r],
            "server": (sx, sy),
            "d_round": np.float32(0.3),
            "d_server": np.float32(0.02),
            "n0": np.float32(500.0),
        })
    return model, params, rounds


def _cfgs(algo, mode, **kw):
    """(JAX, port) engine configs of one row."""
    jkw, pkw = ALGOS[algo]
    base = dict(lr=0.08, lr_decay=0.97, **MODES[mode])
    return (jax_engine.EngineConfig(**base, **jkw, **kw.get("jax", {})),
            EngineConfig(**base, **pkw, **kw.get("port", {})))


def _port(t):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), t)


def _port_fns():
    def la(p, b):
        return softmax_xent_acc(b[0] @ p["w"] + p["b"], b[1])

    def grad_fn(p, b):
        return engine.grad(lambda q: la(q, b)[0], p)

    return grad_fn, la


def _run_port(cfg, params, rounds):
    """Per-round copies of the port's state, and its tau_eff and health."""
    grad_fn, la_fn = _port_fns()
    state = engine.init_round_state(_port(params), cfg, num_clients=N_TOTAL)
    states = [tree_map(torch.clone, state)]
    taus, health = [], []
    for b in rounds:
        state, met = engine.round_core(cfg, grad_fn, la_fn, state, _port(b))
        states.append(tree_map(torch.clone, state))
        taus.append(float(met["tau_eff"]))
        health.append(float(met["health"]))
    return states, np.asarray(taus), np.asarray(health)


def _jax_la(params, b):
    return jax_xent(b[0] @ params["w"] + params["b"], b[1])


def _jax_grad(params, b):
    return jax.grad(lambda p: _jax_la(p, b)[0])(params)


def _jax_history(cfg, params, rounds):
    """Per-round (params, client_state), tau_eff and health of the JAX
    engine under one jitted scan."""
    state0 = jax_engine.init_round_state(jax.tree.map(jnp.asarray, params),
                                         cfg, num_clients=N_TOTAL)
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs),
                           *[jax.tree.map(jnp.asarray, b) for b in rounds])

    @jax.jit
    def run(state, batches):
        def body(st, b):
            st, met = jax_engine.round_core(cfg, _jax_grad, _jax_la, st, b)
            return st, (st["params"], st.get("client_state", {}),
                        met["tau_eff"], met["health"])
        return jax.lax.scan(body, state, batches)

    _, (p, cs, taus, health) = run(state0, stacked)
    hist = [jax.tree.map(lambda a, r=r: np.asarray(a[r]), (p, cs))
            for r in range(len(rounds))]
    return hist, np.asarray(taus), np.asarray(health)


def _close(got, want, what, atol=1e-5):
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol,
                                   err_msg=what)


def _bitwise(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


class TestGuardParity:
    @pytest.mark.parametrize("algo,mode", GUARD_TABLE, ids=IDS)
    def test_reject_matches_surviving_client_oracle(self, world, algo, mode):
        """A guarded round with the victim's model NaN'd equals the f64
        oracle round run without the fault but with the victim dropped."""
        model, params, rounds = world
        jcfg, cfg = _cfgs(algo, mode, port=dict(
            guard="reject_client",
            faults=(NaNGrad(client=VICTIM, round=FAULT_ROUND),)))
        states, taus, health = _run_port(cfg, params, rounds)
        np.testing.assert_array_equal(health, [0.0, 1.0, 0.0])

        ref = ref_engine.ref_init_state(params, jcfg, num_clients=N_TOTAL)
        ref_taus = []
        for r, b in enumerate(rounds):
            b = dict(b, active=np.asarray(
                [0.0 if (r == FAULT_ROUND and c == VICTIM) else 1.0
                 for c in SELS[r]], np.float32))
            ref, met = ref_engine.ref_round(jcfg, model.np_grad,
                                            model.np_loss_and_acc, ref, b)
            ref_taus.append(met["tau_eff"])
            what = f"{algo}-{mode} vs the surviving-client oracle, round {r}"
            _close(states[r + 1]["params"], ref["params"], f"params {what}")
            if algo == "feddyn":
                _close(states[r + 1]["client_state"], ref["client_state"],
                       f"client_state {what}")
        np.testing.assert_allclose(taus, ref_taus, atol=1e-5)

    @pytest.mark.parametrize("algo,mode", GUARD_TABLE, ids=IDS)
    def test_matches_jax_guarded_round(self, world, algo, mode):
        """The same fault and guard through the JAX ``round_core``."""
        _, params, rounds = world
        kw = dict(guard="reject_client")
        jcfg, cfg = _cfgs(algo, mode, port=dict(
            kw, faults=(NaNGrad(client=VICTIM, round=FAULT_ROUND),)),
            jax=dict(kw, faults=(JaxNaNGrad(client=VICTIM,
                                            round=FAULT_ROUND),)))
        states, taus, health = _run_port(cfg, params, rounds)
        jhist, jtaus, jhealth = _jax_history(jcfg, params, rounds)
        np.testing.assert_array_equal(health, jhealth)
        for r in range(ROUNDS):
            what = f"{algo}-{mode} vs JAX, round {r}"
            _close(states[r + 1]["params"], jhist[r][0], f"params {what}")
            _close(states[r + 1].get("client_state", {}), jhist[r][1],
                   f"client_state {what}")
        np.testing.assert_allclose(taus, jtaus, atol=1e-5)


class TestGuardSemantics:
    @pytest.mark.parametrize("algo,mode", GUARD_TABLE, ids=IDS)
    def test_skip_round_is_bitwise_noop(self, world, algo, mode):
        """Under ``skip_round`` one rejection discards the round: params,
        server and communicated momentum and client state bitwise as the
        round found them, tau_eff 0, the counter advanced, and training
        goes on after it."""
        _, params, rounds = world
        _, cfg = _cfgs(algo, mode, port=dict(
            guard="skip_round",
            faults=(NaNGrad(client=VICTIM, round=FAULT_ROUND),)))
        states, taus, health = _run_port(cfg, params, rounds)
        np.testing.assert_array_equal(health, [0.0, 1.0, 0.0])
        assert taus[FAULT_ROUND] == 0.0
        before, after = states[FAULT_ROUND], states[FAULT_ROUND + 1]
        for k in ("params", "server_m", "global_m", "client_state"):
            if k in before:
                assert _bitwise(after[k], before[k]), \
                    f"skipped round moved {k}"
        assert float(after["round"]) == float(before["round"]) + 1
        assert float(states[-1]["round"]) == float(ROUNDS)
        assert not _bitwise(states[-1]["params"], after["params"])

    def test_fully_bad_round_discarded(self, world):
        """``reject_client`` with every selected client non-finite: no
        survivor, so the round is a no-op, not a NaN model."""
        _, params, rounds = world
        _, cfg = _cfgs("fedavg", "feddu", port=dict(
            guard="reject_client",
            faults=(CorruptUpdate(scale=float("nan"), round=FAULT_ROUND),)))
        states, taus, health = _run_port(cfg, params, rounds)
        np.testing.assert_array_equal(health, [0.0, float(CLIENTS), 0.0])
        assert taus[FAULT_ROUND] == 0.0
        for st in states:
            assert all(torch.isfinite(t).all() for t in tree_leaves(st))
        assert _bitwise(states[FAULT_ROUND + 1]["params"],
                        states[FAULT_ROUND]["params"])

    @pytest.mark.parametrize("algo,mode", GUARD_TABLE, ids=IDS)
    def test_guard_on_no_fault_matches_guard_off(self, world, algo, mode):
        """A guard that never fires changes nothing: its delta-form sum
        divided at the end agrees with the unguarded round to 1e-6."""
        _, params, rounds = world
        _, off = _cfgs(algo, mode)
        on = dataclasses.replace(off, guard="reject_client")
        s_off, t_off, h_off = _run_port(off, params, rounds)
        s_on, t_on, h_on = _run_port(on, params, rounds)
        np.testing.assert_array_equal(h_off, 0.0)
        np.testing.assert_array_equal(h_on, 0.0)
        for a, b in zip(s_off, s_on):
            for x, y in zip(tree_leaves(a), tree_leaves(b)):
                np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-6)
        np.testing.assert_allclose(t_off, t_on, atol=1e-6)

    def test_feddyn_rejected_client_h_row_unchanged(self, world):
        """A rejected FedDyn client's correction row is left exactly as it
        was; the survivors' rows move."""
        _, params, rounds = world
        _, cfg = _cfgs("feddyn", "feddum", port=dict(
            guard="reject_client",
            faults=(NaNGrad(client=VICTIM, round=FAULT_ROUND),)))
        states, _, _ = _run_port(cfg, params, rounds)
        before = states[FAULT_ROUND]["client_state"]["per_client"]["h"]
        after = states[FAULT_ROUND + 1]["client_state"]["per_client"]["h"]
        for b, a in zip(tree_leaves(before), tree_leaves(after)):
            assert torch.equal(a[VICTIM], b[VICTIM])
            for c in SELS[FAULT_ROUND]:
                if c != VICTIM:
                    assert not torch.equal(a[c], b[c])
            assert torch.isfinite(a).all()


def test_guarded_trainer_records_health():
    """End to end through the trainer's own sampler: an all-clients NaN
    round is discarded and ``history["health"]`` says which and how many
    (``TestKillAndResume.test_guarded_trainer_records_health``)."""
    from repro_torch.core.plan import Eval, Scan, TrainPlan
    from repro_torch.core.rounds import FederatedTrainer, feddumap_config
    from repro_torch.data.pipeline import build_federated_data
    from repro_torch.data.synthetic import SyntheticSpec
    from repro_torch.models.cnn import SimpleCNN

    spec = SyntheticSpec(num_classes=10, image_shape=(8, 8, 3),
                         train_size=1600, test_size=100, noise_scale=0.5)
    data = build_federated_data(num_clients=6, server_fraction=0.1,
                                device_pool=600, spec=spec)
    model = SimpleCNN(num_classes=10, image_shape=(8, 8, 3),
                      channels=(4, 8, 8), fc_width=16, device="cpu")
    kw = dict(num_clients=6, clients_per_round=3, local_epochs=1,
              batch_size=10, lr=0.05)
    cfg = feddumap_config(**kw, guard="reject_client", faults=(
        CorruptUpdate(scale=float("nan"), round=1),))
    res = FederatedTrainer(model, data, cfg, device="cpu").run(
        TrainPlan(Scan(3), Eval()))
    assert res.history["health"] == [0.0, 3.0, 0.0]
    assert all(torch.isfinite(t).all() for t in tree_leaves(res.params))
    res_off = FederatedTrainer(model, data, feddumap_config(**kw),
                               device="cpu").run(TrainPlan(Scan(3), Eval()))
    assert res_off.history["health"] == [0.0, 0.0, 0.0]
