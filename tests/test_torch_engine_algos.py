"""The port's client algorithms and client dropout against the reference.

The FedProx, FedDyn and dropout rows of ``tests/test_engine_diff.py``'s
``PARITY_TABLE`` on the port's ``round_core``: FedProx and FedDyn crossed
with the six momentum modes, with and without FedAP masks, and the three
dropout rows (FedAvg, FedProx, FedDyn under FedDUM; round 1 drops every
client).  The reference test's own tiny model (``ref_engine.
SoftmaxRegression``: 6 features, 4 classes), world (3 clients x 2 steps of
5, 3 server steps of 5, 3 rounds, numpy seed 42), client selections
``SELS`` over 6 clients and dropout vectors ``ACTIVES`` are rebuilt here
value for value.  Every row runs through three legs from one state:

* the port's ``round_core``, on a round state carried across by
  ``interop.round_state_from_jax``;
* the JAX ``round_core`` under ``lax.scan`` + ``jit`` (one program a row);
* ``repro.core.ref_engine.ref_round`` in float64 numpy.

Tolerance 1e-5 a round on params, server momentum, tau_eff and FedDyn's
per-client and shared ``h``, as the reference's own table holds; pruned
coordinates stay exactly zero.  Then the exact limits: FedProx at mu = 0 is
bitwise FedAvg, FedDyn at alpha = 0 is FedAvg within 1e-6 with ``h`` at 0,
an all-dropped round aggregates to the broadcast point exactly, dropped
clients' ``h`` rows are untouched, and the dropout draw is seeded.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jax_engine
from repro.core import ref_engine
from repro.core.ref_engine import SoftmaxRegression
from repro.models.cnn import softmax_xent_acc as jax_xent
from repro_torch import interop
from repro_torch.core import engine
from repro_torch.core.engine import EngineConfig, FedDynConfig, FedProxConfig
from repro_torch.models.cnn import softmax_xent_acc
from repro_torch.utils.tree import tree_leaves, tree_map
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

DIM, CLASSES = 6, 4
CLIENTS, STEPS, BATCH = 3, 2, 5
TAU, SBATCH = 3, 5
ROUNDS = 3
N_TOTAL = 6
SELS = np.asarray([[4, 1, 3], [0, 2, 5], [5, 0, 2]], np.int32)
ACTIVES = np.asarray([[1, 0, 1], [0, 0, 0], [1, 1, 1]], np.float32)

MODES = {
    "fedavg": dict(use_server_update=False, local_momentum="none",
                   server_momentum=False),
    "feddu": dict(use_server_update=True, local_momentum="none",
                  server_momentum=False),
    "server_momentum": dict(use_server_update=True, local_momentum="none",
                            server_momentum=True),
    "device_momentum": dict(use_server_update=True, local_momentum="restart",
                            server_momentum=False),
    "feddum": dict(use_server_update=True, local_momentum="restart",
                   server_momentum=True),
    "fedda": dict(use_server_update=True, local_momentum="communicated",
                  server_momentum=True),
}
ALGOS = {
    "fedavg": ({}, {}),
    "fedprox": (dict(algorithm="fedprox",
                     fedprox=jax_engine.FedProxConfig(mu=0.05)),
                dict(algorithm="fedprox", fedprox=FedProxConfig(mu=0.05))),
    "feddyn": (dict(algorithm="feddyn",
                    feddyn=jax_engine.FedDynConfig(alpha=0.05)),
               dict(algorithm="feddyn", feddyn=FedDynConfig(alpha=0.05))),
}
ROWS = [(algo, mode, use_masks, False)
        for algo in ("fedprox", "feddyn") for mode in MODES
        for use_masks in (False, True)] + [
    ("fedavg", "feddum", False, True),
    ("fedprox", "feddum", False, True),
    ("feddyn", "feddum", False, True),
]


def _row_id(row):
    algo, mode, use_masks, dropout = row
    return (f"{algo}-{mode}" + ("-masked" if use_masks else "")
            + ("-dropout" if dropout else ""))


@pytest.fixture(scope="module")
def world():
    """``test_engine_diff.world``'s model, params and rounds."""
    model = SoftmaxRegression(dim=DIM, num_classes=CLASSES)
    rng = np.random.default_rng(42)
    params = model.init(seed=7)

    def batches(lead):
        x = rng.standard_normal(lead + (DIM,)).astype(np.float32)
        y = rng.integers(0, CLASSES, lead).astype(np.int32)
        return x, y

    rounds = []
    for _ in range(ROUNDS):
        cx, cy = batches((CLIENTS, STEPS, BATCH))
        sx, sy = batches((TAU, SBATCH))
        rounds.append({
            "client": (cx, cy),
            "sizes": np.asarray([40.0, 25.0, 35.0], np.float32),
            "server": (sx, sy),
            "d_round": np.float32(0.3),
            "d_server": np.float32(0.02),
            "n0": np.float32(500.0),
        })
    return model, params, rounds


def _masks():
    rng = np.random.default_rng(3)
    return {"w": (rng.random((DIM, CLASSES)) > 0.4).astype(np.float32),
            "b": (rng.random((CLASSES,)) > 0.4).astype(np.float32)}


def _rounds(rounds, dropout):
    out = []
    for r, b in enumerate(rounds):
        b = dict(b, sel=SELS[r])
        if dropout:
            b["active"] = ACTIVES[r]
        out.append(b)
    return out


def _jax_la(params, b):
    return jax_xent(b[0] @ params["w"] + params["b"], b[1])


def _jax_grad(params, b):
    return jax.grad(lambda p: _jax_la(p, b)[0])(params)


def _port_fns():
    def la(p, b):
        return softmax_xent_acc(b[0] @ p["w"] + p["b"], b[1])

    def grad_fn(p, b):
        return engine.grad(lambda q: la(q, b)[0], p)

    return grad_fn, la


def _jax_history(cfg, state0, rounds):
    """Per-round (params, server_m, client_state, tau_eff) of the JAX engine
    under one jitted scan."""
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs),
                           *[jax.tree.map(jnp.asarray, b) for b in rounds])

    @jax.jit
    def run(state, batches):
        def body(st, b):
            st, met = jax_engine.round_core(cfg, _jax_grad, _jax_la, st, b)
            return st, (st["params"], st["server_m"],
                        st.get("client_state", {}), met["tau_eff"])
        return jax.lax.scan(body, state, batches)

    _, hist = run(jax.tree.map(jnp.asarray, state0), stacked)
    return [jax.tree.map(lambda a, r=r: np.asarray(a[r]), hist)
            for r in range(len(rounds))]


def _port(t):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), t)


def _close(got, want, what):
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   err_msg=what)


@pytest.mark.parametrize("algo,mode,use_masks,dropout", ROWS,
                         ids=[_row_id(r) for r in ROWS])
def test_round_core_matches_jax_and_f64_oracle(world, algo, mode, use_masks,
                                               dropout):
    model, params, rounds = world
    jkw, pkw = ALGOS[algo]
    base = dict(lr=0.08, lr_decay=0.97, use_masks=use_masks, **MODES[mode])
    jcfg, cfg = jax_engine.EngineConfig(**base, **jkw), EngineConfig(**base,
                                                                     **pkw)
    rounds = _rounds(rounds, dropout)
    masks = _masks() if use_masks else None

    jstate = jax_engine.init_round_state(jax.tree.map(jnp.asarray, params),
                                         jcfg, num_clients=N_TOTAL)
    if masks is not None:
        jstate["masks"] = jax.tree.map(jnp.asarray, masks)
    state = interop.round_state_from_jax(jax.tree.map(np.asarray, jstate),
                                         "cpu")
    jhist = _jax_history(jcfg, jstate, rounds)
    ref = ref_engine.ref_init_state(params, jcfg, masks=masks,
                                    num_clients=N_TOTAL)
    grad_fn, la_fn = _port_fns()
    row = _row_id((algo, mode, use_masks, dropout))
    for r, b in enumerate(rounds):
        state, met = engine.round_core(cfg, grad_fn, la_fn, state, _port(b))
        ref, ref_met = ref_engine.ref_round(jcfg, model.np_grad,
                                            model.np_loss_and_acc, ref, b)
        jp, jm, jcs, jtau = jhist[r]
        for leg, (want_p, want_m, want_cs, want_tau) in {
                "jax": (jp, jm, jcs, jtau),
                "f64": (ref["params"], ref["server_m"],
                        ref.get("client_state", {}), ref_met["tau_eff"]),
        }.items():
            what = f"[{row}] vs {leg} at round {r}"
            _close(state["params"], want_p, f"params {what}")
            _close(state["server_m"], want_m, f"server_m {what}")
            _close(state.get("client_state", {}), want_cs,
                   f"client_state {what}")
            np.testing.assert_allclose(float(met["tau_eff"]), want_tau,
                                       atol=1e-5, err_msg=f"tau {what}")
    assert float(state["round"]) == ROUNDS
    if algo == "feddyn":
        assert any(float(h.abs().sum()) > 0
                   for h in tree_leaves(state["client_state"]))
    if masks is not None:
        for leaf, m in zip(tree_leaves(state["params"]),
                           jax.tree.leaves(masks)):
            assert np.all(leaf.numpy()[m == 0] == 0.0)


def _run_port(cfg, params, rounds, n=ROUNDS):
    grad_fn, la_fn = _port_fns()
    state = engine.init_round_state(_port(params), cfg,
                                    num_clients=N_TOTAL)
    taus = []
    for b in rounds[:n]:
        state, met = engine.round_core(cfg, grad_fn, la_fn, state, _port(b))
        taus.append(float(met["tau_eff"]))
    return state, taus


def test_fedprox_mu0_is_bitwise_fedavg(world):
    _, params, rounds = world
    base = dict(lr=0.08, lr_decay=0.97, **MODES["feddum"])
    rounds = _rounds(rounds, False)
    s_avg, t_avg = _run_port(EngineConfig(**base), params, rounds)
    s_px, t_px = _run_port(EngineConfig(
        algorithm="fedprox", fedprox=FedProxConfig(mu=0.0), **base),
        params, rounds)
    for a, b in zip(tree_leaves(s_avg["params"]), tree_leaves(s_px["params"])):
        assert torch.equal(a, b)
    assert t_avg == t_px


def test_feddyn_alpha0_reduces_to_fedavg(world):
    _, params, rounds = world
    base = dict(lr=0.08, lr_decay=0.97, **MODES["feddum"])
    rounds = _rounds(rounds, False)
    s_avg, _ = _run_port(EngineConfig(**base), params, rounds)
    s_dy, _ = _run_port(EngineConfig(
        algorithm="feddyn", feddyn=FedDynConfig(alpha=0.0), **base),
        params, rounds)
    for a, b in zip(tree_leaves(s_avg["params"]), tree_leaves(s_dy["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    assert all(float(h.abs().sum()) == 0.0
               for h in tree_leaves(s_dy["client_state"]))


@pytest.mark.parametrize("algo", ["fedavg", "fedprox", "feddyn"])
def test_all_dropped_round_is_an_exact_noop(world, algo):
    """Round 1 of ACTIVES drops every client.  Without a server update the
    FedAvg/FedProx round leaves every state tensor as it was; FedDyn's
    client state is untouched and its params move by exactly the server
    correction -h_shared/alpha, the reference's arithmetic (the
    aggregation itself returns the broadcast point)."""
    _, params, rounds = world
    rounds = _rounds(rounds, True)
    cfg = EngineConfig(lr=0.08, lr_decay=0.97, **MODES["fedavg"],
                       **ALGOS[algo][1])
    state, _ = _run_port(cfg, params, rounds, n=1)
    before = tree_map(torch.clone, state)
    grad_fn, la_fn = _port_fns()
    state, _ = engine.round_core(cfg, grad_fn, la_fn, state,
                                 _port(rounds[1]))
    assert float(state["round"]) == float(before["round"]) + 1
    for k in ("server_m", "client_state"):
        for a, b in zip(tree_leaves(state.get(k, {})),
                        tree_leaves(before.get(k, {}))):
            assert torch.equal(a, b), k
    if algo == "feddyn":
        hs = before["client_state"]["shared"]["h"]
        assert any(float(h.abs().sum()) > 0 for h in tree_leaves(hs))
        want = tree_map(lambda p, h: (p.float() - h / 0.05).to(p.dtype),
                        before["params"], hs)
    else:
        want = before["params"]
    for a, b in zip(tree_leaves(state["params"]), tree_leaves(want)):
        assert torch.equal(a, b)


def test_dropped_clients_h_rows_are_untouched(world):
    """ACTIVES[0] = [1, 0, 1] over SELS[0] = [4, 1, 3]: rows 4 and 3 move,
    row 1 (dropped) and the unselected rows stay zero."""
    _, params, rounds = world
    rounds = _rounds(rounds, True)
    cfg = EngineConfig(lr=0.08, lr_decay=0.97, **MODES["feddum"],
                       **ALGOS["feddyn"][1])
    state, _ = _run_port(cfg, params, rounds, n=1)
    for h in tree_leaves(state["client_state"]["per_client"]):
        moved = [bool(h[i].abs().sum() > 0) for i in range(N_TOTAL)]
        assert moved == [False, False, False, True, True, False]


def test_draw_round_indices_emits_a_seeded_dropout_draw():
    kw = dict(num_clients=10, n_k=20, n0=30, clients_per_round=6,
              batch_size=5, local_steps=4, server_batch=5, server_tau=2)

    def draw(rate, seed=0):
        gen = torch.Generator().manual_seed(seed)
        return engine.draw_round_indices(gen, dropout_rate=rate, **kw)

    plain, drop = draw(0.0), draw(0.5)
    assert len(plain) == 3 and len(drop) == 4
    for a, b in zip(plain, drop):       # drawn after the others
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(drop, draw(0.5)))
    active = drop[3]
    assert active.dtype == torch.float32 and active.shape == (6,)
    assert set(active.tolist()) <= {0.0, 1.0}
    rates = [float(draw(0.25, s)[3].mean()) for s in range(200)]
    assert abs(np.mean(rates) - 0.75) < 0.03

    rng = np.random.default_rng(0)
    data = {"client_x": torch.from_numpy(rng.standard_normal((10, 20, 3))
                                         .astype(np.float32)),
            "client_y": torch.zeros((10, 20), dtype=torch.int32),
            "sizes": torch.full((10,), 20.0),
            "client_dists": torch.full((10, 4), 0.25),
            "p_bar": torch.full((4,), 0.25), "d_server": torch.tensor(0.0),
            "server_x": torch.zeros((30, 3)),
            "server_y": torch.zeros(30, dtype=torch.int32)}
    skw = {k: v for k, v in kw.items() if k not in ("num_clients", "n_k",
                                                     "n0")}
    batch = engine.sample_round_batches(data, *drop, dropout_rate=0.5, **skw)
    assert torch.equal(batch["active"], active)
    assert "active" not in engine.sample_round_batches(data, *plain, **skw)
    with pytest.raises(ValueError, match="active vector"):
        engine.sample_round_batches(data, *plain, dropout_rate=0.5, **skw)


def test_masks_broadcast_over_feddyn_leading_axis():
    """``apply_masks`` and the in-place ``mask_`` take a param-shaped mask
    over FedDyn's ``[N, ...]`` leaves as the reference's ``apply_masks``
    broadcasts it."""
    masks = _masks()
    rng = np.random.default_rng(9)
    h = {"w": rng.standard_normal((N_TOTAL, DIM, CLASSES)).astype(np.float32),
         "b": rng.standard_normal((N_TOTAL, CLASSES)).astype(np.float32)}
    want = jax_engine.apply_masks(jax.tree.map(jnp.asarray, h),
                                  jax.tree.map(jnp.asarray, masks))
    got = engine.apply_masks(_port(h), _port(masks))
    inplace = _port(h)
    assert engine.mask_(inplace, _port(masks)) is inplace
    for g, i, w in zip(tree_leaves(got), tree_leaves(inplace),
                       jax.tree.leaves(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(i.numpy(), np.asarray(w))
