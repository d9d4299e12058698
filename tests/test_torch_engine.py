"""The port's round engine against the JAX engine and the float64 oracle.

On explicit LM batches (the tiny dense config of ``test_lm_executor.py``,
128-aligned so the masked FFN products run ``masked_matmul`` forward and
backward), every row runs for two rounds through three legs:

* ``repro_torch.core.engine.round_core``, started from the JAX round state
  carried across by ``interop.round_state_from_jax``;
* the JAX ``round_core`` under ``lax.scan`` + ``jit`` (its Pallas kernels in
  interpret mode);
* ``repro.core.ref_engine.ref_round`` — the round arithmetic in float64
  numpy around the port's own f32 gradient, so a disagreement is engine
  wiring, not model float noise.

Rows: the six momentum modes of ``test_engine_diff.MODES`` with FedAP
masks in kernel mode (one layer keeps two whole 128-unit blocks and prunes
two, the other keeps a scattered half), plus FedAvg without masks.
Tolerance 1e-5 per round on params, server momentum and tau_eff, as the
reference's own engine locks; pruned coordinates stay exactly zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.core import engine as jax_engine
from repro.core import ref_engine
from repro.core.backend import model_fns as jax_model_fns
from repro.core.engine import EngineConfig as JaxEngineConfig
from repro.core.pruning_lm import ffn_param_masks as jax_param_masks
from repro.models.lm import LM as JaxLM
from repro_torch import interop
from repro_torch.configs.base import ModelConfig
from repro_torch.core import engine
from repro_torch.core.backend import model_fns
from repro_torch.core.engine import EngineConfig
from repro_torch.models.lm import LM
from repro_torch.utils.tree import tree_leaves, tree_map
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TINY = dict(name="dense-tiny", family="dense", rope="1d", norm="rmsnorm",
            act="silu", param_dtype="float32", remat="none",
            num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
            d_ff=512, vocab_size=2048)
CLIENTS, STEPS, BATCH, TAU, SBATCH, SEQ, ROUNDS = 2, 2, 2, 2, 2, 8, 2

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
ROWS = [(mode, True) for mode in MODES] + [("fedavg", False)]


@pytest.fixture(scope="module")
def world():
    jmodel = JaxLM(JaxModelConfig(**TINY))
    jparams = jmodel.init(jax.random.key(1))
    rng = np.random.default_rng(17)

    def toks(lead):
        t = rng.integers(0, TINY["vocab_size"], lead + (SEQ + 1,))
        return (t[..., :-1].astype(np.int32), t[..., 1:].astype(np.int32))

    rounds = [{"client": toks((CLIENTS, STEPS, BATCH)),
               "sizes": np.asarray([30.0, 20.0], np.float32),
               "server": toks((TAU, SBATCH)),
               "d_round": np.float32(0.3), "d_server": np.float32(0.02),
               "n0": np.float32(50.0)} for _ in range(ROUNDS)]
    # layer 0 keeps blocks 0-1 whole (blocks 2-3 fully pruned: the kernels
    # skip them); layer 1 keeps a scattered half of its units
    kept = np.stack([np.arange(256), np.sort(rng.choice(512, 256, False))])
    return jmodel, jparams, rounds, {"mlp": kept}


def _port_grad_fns(model):
    """numpy-f64 grad / loss_and_acc around the port's f32 model, for the
    oracle."""
    def to_port(p):
        return tree_map(lambda a: torch.tensor(np.asarray(a, np.float32)),
                        jax.tree.map(np.asarray, p))

    def batch(b):
        return torch.from_numpy(np.asarray(b[0])), torch.from_numpy(
            np.asarray(b[1]))

    def np_grad(p, b):
        x, y = batch(b)
        g = engine.grad(lambda q: model.loss_and_acc(q, x, y)[0], to_port(p))
        return tree_map(lambda t: t.numpy().astype(np.float64), g)

    def np_la(p, b):
        with torch.no_grad():
            loss, acc = model.loss_and_acc(to_port(p), *batch(b))
        return float(loss), float(acc)

    return np_grad, np_la


@pytest.mark.parametrize("mode,use_masks", ROWS,
                         ids=[f"{m}-kernel-masked" if u else m
                              for m, u in ROWS])
def test_round_core_matches_jax_and_f64_oracle(world, mode, use_masks):
    jmodel, jparams, rounds, kept = world
    kw = dict(lr=0.05, lr_decay=0.97, use_masks=use_masks,
              masked_compute="kernel", **MODES[mode])
    jcfg, cfg = JaxEngineConfig(**kw), EngineConfig(**kw)
    model = LM(ModelConfig(**TINY), device="cpu")

    # JAX leg: round_core under scan + jit, per-round history
    masks = fmasks = None
    jstate = jax_engine.init_round_state(
        jparams, jcfg, filter_masks=(jmodel.filter_masks(jparams, {})
                                     if use_masks else None))
    if use_masks:
        masks = jax_param_masks(jparams, kept)
        fmasks = jmodel.filter_masks(jparams, kept)
        jstate["masks"], jstate["filter_masks"] = masks, fmasks
    port_state = interop.round_state_from_jax(jax.tree.map(np.asarray,
                                                           jstate), "cpu")
    jgrad, jla = jax_model_fns(jmodel, jcfg)
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs),
                           *[jax.tree.map(jnp.asarray, b) for b in rounds])

    @jax.jit
    def run(state, batches):
        def body(st, b):
            st, met = jax_engine.round_core(jcfg, jgrad, jla, st, b)
            return st, (met["tau_eff"], st["params"], st["server_m"])
        return jax.lax.scan(body, state, batches)

    _, (jtaus, jphist, jmhist) = run(jstate, stacked)

    # oracle leg: f64 round arithmetic around the port's gradient
    np_grad, np_la = _port_grad_fns(model)
    ref = ref_engine.ref_init_state(jax.tree.map(np.asarray, jparams),
                                    jcfg, masks=masks)

    # port leg: round_core in place, snapshot per round
    grad_fn, la_fn = model_fns(model, cfg)
    for r, b in enumerate(rounds):
        port_state, met = engine.round_core(
            cfg, grad_fn, la_fn, port_state,
            tree_map(lambda a: torch.from_numpy(np.array(a)), b))
        ref, ref_met = ref_engine.ref_round(jcfg, np_grad, np_la, ref, b)
        legs = {"jax": (jax.tree.leaves(jax.tree.map(lambda l: l[r], jphist)),
                        jax.tree.leaves(jax.tree.map(lambda l: l[r], jmhist)),
                        float(jtaus[r])),
                "f64": (jax.tree.leaves(ref["params"]),
                        jax.tree.leaves(ref["server_m"]),
                        ref_met["tau_eff"])}
        for leg, (want_p, want_m, want_tau) in legs.items():
            for got, want in zip(tree_leaves(port_state["params"]), want_p):
                np.testing.assert_allclose(
                    got.numpy(), np.asarray(want), atol=1e-5,
                    err_msg=f"[{mode}] params vs {leg} at round {r}")
            for got, want in zip(tree_leaves(port_state["server_m"]),
                                 want_m):
                np.testing.assert_allclose(
                    got.numpy(), np.asarray(want), atol=1e-5,
                    err_msg=f"[{mode}] server_m vs {leg} at round {r}")
            np.testing.assert_allclose(float(met["tau_eff"]), want_tau,
                                       atol=1e-5, err_msg=f"[{mode}] tau_eff")
    assert float(port_state["round"]) == ROUNDS
    if use_masks:
        for got, m in zip(tree_leaves(port_state["params"]),
                          jax.tree.leaves(masks)):
            assert np.all(got.numpy()[np.asarray(m) == 0] == 0.0)


def test_sample_round_batches_gathers_the_given_indices():
    """The port samples nothing itself: injected indices gather exactly the
    rows the reference's sampler gathers for the same indices."""
    from repro_torch.data.pipeline import build_lm_federated_data
    from repro_torch.data.synthetic import TokenSpec

    data = build_lm_federated_data(
        num_clients=4, spec=TokenSpec(vocab_size=256, num_topics=8,
                                      seq_len=9, num_sequences=96))
    d = data.device_arrays("cpu")
    sel, idx, sidx = np.asarray([2, 0]), np.asarray([[1, 4, 0, 3]] * 2), \
        np.asarray([0, 2])
    b = engine.sample_round_batches(d, sel, idx, sidx, clients_per_round=2,
                                    batch_size=2, local_steps=2,
                                    server_batch=1, server_tau=2)
    np.testing.assert_array_equal(b["client"][0][0, 1, 0].numpy(),
                                  data.client_x[2, 0])
    np.testing.assert_array_equal(b["server"][1][1, 0].numpy(),
                                  data.server_y[2])
    assert b["sizes"].tolist() == [float(data.sizes[2]),
                                   float(data.sizes[0])]
    gen = torch.Generator().manual_seed(0)
    sel, idx, sidx = engine.draw_round_indices(
        gen, num_clients=4, n_k=int(data.client_x.shape[1]),
        n0=int(data.server_x.shape[0]), clients_per_round=3, batch_size=2,
        local_steps=8, server_batch=2, server_tau=1)
    assert len(set(sel.tolist())) == 3
    n_k = data.client_x.shape[1]
    for row in idx:   # without-replacement epochs: each epoch a permutation
        assert sorted(row[:n_k].tolist()) == list(range(n_k))


def test_unported_switches_raise():
    from repro_torch.reliability import KillAfterChunk, NaNGrad

    # the guard and device faults are ported: accepted as the reference
    # accepts them; an unknown guard or a host fault raises as there
    for guard in ("off", "reject_client", "skip_round"):
        assert EngineConfig(guard=guard).guard == guard
    fault = NaNGrad(client=0, round=1)
    assert EngineConfig(guard="reject_client", faults=(fault,)).faults == \
        (fault,)
    with pytest.raises(ValueError, match="guard"):
        EngineConfig(guard="maybe")
    with pytest.raises(ValueError, match="host"):
        EngineConfig(faults=(KillAfterChunk(1),))
    with pytest.raises(ValueError, match="DEVICE faults"):
        EngineConfig(faults=(object(),))
    with pytest.raises(ValueError, match="filter_masks"):
        engine.init_round_state({"w": torch.zeros(2)},
                                EngineConfig(use_masks=True,
                                             masked_compute="kernel"))
