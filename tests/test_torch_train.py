"""The port's FedDUMAP trainer against the JAX trainer, end to end.

``FederatedTrainer.run(fedap_plan(4, prune_round=2, mode=...))`` on the
tiny dense LM and synthetic token world of ``test_lm_executor.py``, with
FedDU + FedDUM + FedAP and ``masked_compute="kernel"``.  Both trainers start
from the same JAX-initialized params and see the same batches: the port is
fed the JAX key chain's draws (``k, sub = split(k)`` per round, then
``engine.sample_round_batches``), since torch generators cannot reproduce
``jax.random``.  Tolerance 1e-5 per round on the test-split loss and
accuracy and on tau_eff, and on the final params; kept units must be equal
and p* within 1e-5.

The JAX FedAP decision probes each participant through ``participant_rate``,
which its host path runs op by op (about 13 s per participant on this CPU);
the fixture runs it under ``jax.jit``, as the reference's own sharded
decision does.  The JAX shrink run replays the mask run's decision: both
plans hold the same state at the prune round.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.core import engine as jax_engine
from repro.core import fedap as jax_fedap
from repro.core.backend import LocalScanBackend, sim_sample_kw
from repro.core.plan import fedap_plan as jax_fedap_plan
from repro.core.pruning import FedAPConfig as JaxFedAPConfig
from repro.core.rounds import FederatedTrainer as JaxTrainer
from repro.core.rounds import feddumap_config as jax_feddumap_config
from repro.data.pipeline import build_lm_federated_data as jax_build
from repro.data.synthetic import TokenSpec as JaxTokenSpec
from repro.models.lm import LM as JaxLM
from repro_torch import interop
from repro_torch.configs.base import ModelConfig
from repro_torch.core.backend import LocalBackend
from repro_torch.core.plan import fedap_plan
from repro_torch.core.pruning import FedAPConfig
from repro_torch.core.rounds import FederatedTrainer, feddumap_config
from repro_torch.data.pipeline import build_lm_federated_data
from repro_torch.data.synthetic import TokenSpec
from repro_torch.models.lm import LM
from repro_torch.utils.tree import tree_leaves
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TINY = dict(name="dense-tiny", family="dense", rope="1d", norm="rmsnorm",
            act="silu", param_dtype="float32", remat="none",
            num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
            d_ff=512, vocab_size=2048)
SPEC = dict(vocab_size=2048, num_topics=16, seq_len=17, num_sequences=256)
CFG = dict(num_clients=8, clients_per_round=4, local_epochs=1, batch_size=4,
           server_batch_size=8, lr=3e-3, lr_decay=1.0,
           masked_compute="kernel")
AP = dict(align=128, min_rate=0.5, probe_size=4, participants=2)
ROUNDS, PRUNE_ROUND = 4, 2


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX trainer's mask and shrink runs, its per-round draws and its
    initial params."""
    data = jax_build(num_clients=8, spec=JaxTokenSpec(**SPEC))
    cfg = jax_feddumap_config(fedap=JaxFedAPConfig(**AP), **CFG)
    model = JaxLM(JaxModelConfig(**TINY))
    patch = pytest.MonkeyPatch()
    patch.setattr(jax_fedap, "participant_rate",
                  jax.jit(jax_fedap.participant_rate, static_argnums=(0, 5)))
    try:
        mask = JaxTrainer(model, data, cfg).run(
            jax_fedap_plan(ROUNDS, prune_round=PRUNE_ROUND, mode="mask"))
        art = mask.artifacts["prune"]
        decision = jax_fedap.FedAPDecision(
            kept=art["kept"], p_star=art["p_star"],
            layer_rates=art["layer_rates"])
        patch.setattr(LocalScanBackend, "prune_decision",
                      lambda self, state, init_params: decision)
        shrink = JaxTrainer(model, data, cfg).run(
            jax_fedap_plan(ROUNDS, prune_round=PRUNE_ROUND, mode="shrink"))
    finally:
        patch.undo()
    key = jax.random.key(cfg.seed)
    dev, kw = data.device_arrays(), sim_sample_kw(cfg, data)
    draws = []
    for _ in range(ROUNDS):
        key, sub = jax.random.split(key)
        draws.append(jax.tree.map(
            np.asarray, jax_engine.sample_round_batches(sub, dev, **kw)))
    params0 = jax.tree.map(np.asarray, model.init(jax.random.key(cfg.seed)))
    return {"mask": mask, "shrink": shrink, "draws": draws,
            "params0": params0}


def _port_trainer():
    data = build_lm_federated_data(num_clients=8, spec=TokenSpec(**SPEC))
    cfg = feddumap_config(fedap=FedAPConfig(**AP), **CFG)
    return FederatedTrainer(LM(ModelConfig(**TINY), device="cpu"), data, cfg,
                            device="cpu")


@pytest.fixture(scope="module")
def port_runs(jax_runs):
    out = {}
    for mode in ("mask", "shrink"):
        out[mode] = _port_trainer().run(
            fedap_plan(ROUNDS, prune_round=PRUNE_ROUND, mode=mode),
            params=interop.params_from_jax(jax_runs["params0"], "cpu"),
            batches=lambda t: jax_runs["draws"][t])
    return out


@pytest.mark.parametrize("mode", ["mask", "shrink"])
class TestTrainerMatchesJax:
    def test_history_per_round(self, jax_runs, port_runs, mode):
        want, got = jax_runs[mode].history, port_runs[mode].history
        assert got["round"] == want["round"] == [1, 2, 3, 4]
        for key in ("loss", "acc", "tau_eff"):
            np.testing.assert_allclose(got[key], want[key], atol=1e-5,
                                       rtol=0, err_msg=key)

    def test_prune_decision(self, jax_runs, port_runs, mode):
        want = jax_runs[mode].artifacts["prune"]
        got = port_runs[mode].artifacts["prune"]
        np.testing.assert_array_equal(got["kept"]["mlp"],
                                      np.asarray(want["kept"]["mlp"]))
        assert got["kept_counts"] == want["kept_counts"]
        assert got["layer_rates"] == pytest.approx(want["layer_rates"])
        assert got["mode"] == mode
        np.testing.assert_allclose(got["p_star"], want["p_star"], atol=1e-5)

    def test_final_params(self, jax_runs, port_runs, mode):
        want = jax.tree.leaves(jax_runs[mode].params)
        got = tree_leaves(port_runs[mode].params)
        assert [tuple(g.shape) for g in got] == [w.shape for w in want]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                       rtol=0)


def test_mask_state_keeps_pruned_units_at_zero(port_runs):
    res = port_runs["mask"]
    kept = res.artifacts["prune"]["kept"]["mlp"]
    unit = np.zeros((TINY["num_layers"], TINY["d_ff"]), bool)
    np.put_along_axis(unit, kept, True, axis=1)
    wi = res.params["layers"]["mlp"]["wi"].numpy()
    assert np.all(wi.transpose(0, 2, 1)[~unit] == 0.0)
    np.testing.assert_array_equal(res.state["filter_masks"]["mlp"].numpy(),
                                  unit.astype(np.float32))


def test_mask_prune_keeps_every_state_tensor_in_place():
    """Prune(mode="mask") writes into the live round state: every tensor
    keeps its storage and shape (the eager analogue of the reference's
    zero added programs)."""
    trainer = _port_trainer()
    backend = trainer.backend(use_masks=True)
    model = trainer.model
    params = model.init(torch.Generator().manual_seed(0))
    state, _ = backend.run_rounds(backend.init_state(params), 0, 1)
    before = [(t.data_ptr(), tuple(t.shape)) for t in tree_leaves(state)]
    kept = model.decide_kept(state["params"], 0.5)
    new_state, art = backend.apply_prune(state, "mask", kept)
    assert [(t.data_ptr(), tuple(t.shape))
            for t in tree_leaves(new_state)] == before
    assert set(art) == {"filter_masks"}
    assert all(float(t.abs().sum()) == 0.0
               for t in tree_leaves(new_state["server_m"]))
    # and training goes on in the same tensors
    state, _ = backend.run_rounds(new_state, 1, 1)
    assert [(t.data_ptr(), tuple(t.shape))
            for t in tree_leaves(state)] == before


def test_own_sampler_is_seeded_and_finite():
    """Without injected batches the trainer draws from its own seeded
    generator: two trainers with one seed train identically."""
    runs = [_port_trainer().run(2) for _ in range(2)]
    assert runs[0].history["loss"] == runs[1].history["loss"]
    assert all(np.isfinite(runs[0].history["loss"]))
    for a, b in zip(tree_leaves(runs[0].params), tree_leaves(runs[1].params)):
        assert torch.equal(a, b)


def test_trainer_refuses_a_model_on_another_device():
    trainer = _port_trainer()
    meta = LM(ModelConfig(**TINY), device="cpu")
    meta.device = torch.device("meta")
    with pytest.raises(ValueError, match="model lives on"):
        FederatedTrainer(meta, trainer.data, trainer.cfg, device="cpu")
    # the guard and faults are ported: accepted, and routed as in the
    # reference (device faults to the engine, host faults to the executor)
    from repro_torch.core.rounds import engine_config
    from repro_torch.reliability import KillAfterChunk, NaNGrad

    guarded = dataclasses.replace(
        trainer.cfg, guard="reject_client",
        faults=(NaNGrad(client=0, round=1), KillAfterChunk(2)))
    eng = engine_config(guarded)
    assert (eng.guard, eng.faults) == ("reject_client",
                                       (NaNGrad(client=0, round=1),))
    with pytest.raises(ValueError, match="guard"):
        dataclasses.replace(trainer.cfg, guard="sometimes")
    with pytest.raises(ValueError, match="fault"):
        dataclasses.replace(trainer.cfg, faults=(object(),))
    with pytest.raises(TypeError, match="masks="):
        LocalBackend(type("NoMasks", (), {"loss_and_acc":
                                          lambda self, p, x, y: None})(),
                     trainer.data, trainer.cfg, use_masks=True, device="cpu")
