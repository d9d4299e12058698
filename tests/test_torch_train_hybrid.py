"""FedDUMAP training of the hybrid (zamba2) against the JAX trainer.

``FederatedTrainer.run(fedap_plan(4, prune_round=2, mode=...))`` on
zamba2-1.2b's reduced config (4 layers, ``attn_every=2``: two groups of
Mamba2 layers behind the shared attention) with ``attn_impl="xla"`` (the
chunked SSD scan and plain attention, which have a backward), FedDU +
FedDUM + FedAP and ``masked_compute="kernel"``: after the prune every
layer's ``wi`` and ``wg`` products run ``ops.MaskedMatmul`` (K1 forward,
K2/K3 backward; their plain versions here).  Both trainers start from the
same JAX-initialised params and see the same batches (the JAX key chain's
draws, as in ``tests/test_torch_train.py``).

Tolerance 1e-5 a round on the test-split loss, accuracy and tau_eff and on
the final params, the dense trainer test's; kept units equal and p* within
1e-5.  The chunked scan needs no more: the worst measured is 1.0e-6 on the
loss (of ~6.7) and 1.2e-7 on the params.

The JAX FedAP probe runs under ``jax.jit``, on the probe rows sliced before
the call so that the server and the clients share one compiled program; the
JAX shrink run replays the mask run's decision (both hold the same state at
the prune round).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import HybridConfig
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
from repro_torch.core.plan import fedap_plan
from repro_torch.core.pruning import FedAPConfig
from repro_torch.core.rounds import FederatedTrainer, feddumap_config
from repro_torch.data.pipeline import build_lm_federated_data
from repro_torch.data.synthetic import TokenSpec
from repro_torch.kernels import masked_matmul as k1
from repro_torch.models.lm import LM
from repro_torch.utils.tree import tree_leaves
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ZAMBA = jax_get_config("zamba2-1.2b").reduced(
    num_layers=4, hybrid=HybridConfig(attn_every=2))
SPEC = dict(vocab_size=ZAMBA.vocab_size, num_topics=16, seq_len=17,
            num_sequences=256)
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
    model = JaxLM(ZAMBA)
    probe = jax.jit(jax_fedap.participant_rate, static_argnums=(0, 5))
    patch = pytest.MonkeyPatch()
    patch.setattr(jax_fedap, "participant_rate",
                  lambda m, p, p0, x, y, c: probe(m, p, p0, x[:c.probe_size],
                                                  y[:c.probe_size], c))
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


@pytest.fixture(scope="module")
def port_runs(jax_runs):
    """The port's runs; ``launches`` counts the masked products' launches
    of each run (0 on the CPU, where the plain versions run)."""
    out = {}
    for mode in ("mask", "shrink"):
        data = build_lm_federated_data(num_clients=8, spec=TokenSpec(**SPEC))
        cfg = feddumap_config(fedap=FedAPConfig(**AP), **CFG)
        model = LM(ModelConfig.from_dict(ZAMBA.to_dict()), attn_impl="xla",
                   device="cpu")
        out[mode] = FederatedTrainer(model, data, cfg, device="cpu").run(
            fedap_plan(ROUNDS, prune_round=PRUNE_ROUND, mode=mode),
            params=interop.params_from_jax(jax_runs["params0"], "cpu"),
            batches=lambda t: jax_runs["draws"][t])
    return out


@pytest.mark.parametrize("mode", ["mask", "shrink"])
class TestHybridTrainerMatchesJax:
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
        assert got["kept_counts"]["mlp"] < ZAMBA.d_ff
        np.testing.assert_allclose(got["p_star"], want["p_star"], atol=1e-5)

    def test_final_params(self, jax_runs, port_runs, mode):
        want = jax.tree.leaves(jax_runs[mode].params)
        got = tree_leaves(port_runs[mode].params)
        assert [tuple(g.shape) for g in got] == [w.shape for w in want]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                       rtol=0)


def test_masked_round_sends_every_ffn_through_masked_matmul(jax_runs,
                                                            monkeypatch):
    """After a mask prune, each gradient evaluation of the hybrid sends
    every layer's ``wi`` and ``wg`` through ``ops.MaskedMatmul``: 2 x L
    products forward (K1) and 2 x L each backward (K2, K3)."""
    from repro_torch.kernels import ops

    counts = {"fwd": 0, "dx": 0, "dw": 0}
    for name, key in (("masked_matmul_fwd", "fwd"), ("masked_matmul_dx", "dx"),
                      ("masked_matmul_dw", "dw")):
        def counted(*args, _fn=getattr(ops, name), _key=key):
            counts[_key] += 1
            return _fn(*args)
        monkeypatch.setattr(ops, name, counted)
    data = build_lm_federated_data(num_clients=8, spec=TokenSpec(**SPEC))
    cfg = feddumap_config(fedap=FedAPConfig(**AP), **CFG)
    trainer = FederatedTrainer(
        LM(ModelConfig.from_dict(ZAMBA.to_dict()), device="cpu"), data, cfg,
        device="cpu")
    backend = trainer.backend(use_masks=True)
    kw = backend.sample_kw
    params = interop.params_from_jax(jax_runs["params0"], "cpu")
    state = backend.init_state(params)
    kept = trainer.model.decide_kept(state["params"], 0.5)
    state, _ = backend.apply_prune(state, "mask", kept)
    before = k1.launches
    state, _ = backend.run_rounds(state, 0, 1)
    grads = kw["clients_per_round"] * kw["local_steps"] + kw["server_tau"]
    want = grads * 2 * ZAMBA.num_layers
    assert counts == {"fwd": want, "dx": want, "dw": want}
    assert k1.launches == before       # no kernel launch on the CPU
    assert all(torch.isfinite(t).all() for t in tree_leaves(state["params"]))
