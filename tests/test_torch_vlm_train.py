"""FedDU + FedDUM training of the vlm family (qwen2-vl-7b reduced) with a
FedAP mask prune, against the JAX trainer.

``fedap_plan(2, prune_round=1, mode="mask")`` through the local backend with
``feddumap_config(masked_compute="kernel")``, on qwen2-vl's reduced config
(2 layers, d 256, 4 heads padded to 16 over 2 kv heads of 64, d_ff 512,
M-RoPE over the default positions: the trainer's batches are tokens).  Both
trainers start from the same JAX-initialised params and see the same
batches: the port is fed the JAX key chain's draws, as in
``tests/test_torch_train.py``; the JAX FedAP probe runs under ``jax.jit``
there too.  After the prune the FFN's up/gate products run the masked
matmul (K1-K3's plain versions here) at the dense shapes.

Tolerances: round 1's test loss, token accuracy and tau_eff within 1e-5;
the kept units equal and p* within 1e-5; round 2 and the final params
within 1e-5 as well.
"""
import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import engine as jax_engine
from repro.core import fedap as jax_fedap
from repro.core.backend import sim_sample_kw
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
from repro_torch.models.lm import LM
from repro_torch.utils.tree import tree_leaves
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

QWEN = jax_get_config("qwen2-vl-7b").reduced()
SPEC = dict(vocab_size=QWEN.vocab_size, num_topics=16, seq_len=17,
            num_sequences=128)
CFG = dict(num_clients=8, clients_per_round=4, local_epochs=1, batch_size=4,
           server_batch_size=8, lr=3e-3, lr_decay=1.0,
           masked_compute="kernel")
AP = dict(align=128, min_rate=0.5, probe_size=4, participants=2)
ROUNDS, PRUNE_ROUND = 2, 1
TOL = 1e-5


@pytest.fixture(scope="module")
def jax_run():
    """The JAX trainer's run, its per-round draws and its start params."""
    data = jax_build(num_clients=8, spec=JaxTokenSpec(**SPEC))
    cfg = jax_feddumap_config(fedap=JaxFedAPConfig(**AP), **CFG)
    model = JaxLM(QWEN)
    params0 = jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.key(cfg.seed)))
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_fedap, "participant_rate",
                      jax.jit(jax_fedap.participant_rate,
                              static_argnums=(0, 5)))
        res = JaxTrainer(model, data, cfg).run(
            jax_fedap_plan(ROUNDS, prune_round=PRUNE_ROUND, mode="mask"),
            params=params0)
    key = jax.random.key(cfg.seed)
    dev, kw = data.device_arrays(), sim_sample_kw(cfg, data)
    draws = []
    for _ in range(ROUNDS):
        key, sub = jax.random.split(key)
        draws.append(jax.tree.map(
            np.asarray, jax_engine.sample_round_batches(sub, dev, **kw)))
    return {"res": res, "draws": draws, "params0": params0}


@pytest.fixture(scope="module")
def port_run(jax_run):
    data = build_lm_federated_data(num_clients=8, spec=TokenSpec(**SPEC))
    cfg = feddumap_config(fedap=FedAPConfig(**AP), **CFG)
    model = LM(ModelConfig.from_dict(QWEN.to_dict()), device="cpu")
    return FederatedTrainer(model, data, cfg, device="cpu").run(
        fedap_plan(ROUNDS, prune_round=PRUNE_ROUND, mode="mask"),
        params=interop.params_from_jax(jax_run["params0"], "cpu"),
        batches=lambda t: jax_run["draws"][t])


def test_first_round_matches_jax(jax_run, port_run):
    want, got = jax_run["res"].history, port_run.history
    assert got["round"] == want["round"] == [1, 2]
    for key in ("loss", "acc", "tau_eff"):
        assert abs(got[key][0] - want[key][0]) <= TOL, key


def test_prune_decision_matches_jax(jax_run, port_run):
    want = jax_run["res"].artifacts["prune"]
    got = port_run.artifacts["prune"]
    np.testing.assert_array_equal(got["kept"]["mlp"],
                                  np.asarray(want["kept"]["mlp"]))
    assert got["kept_counts"] == want["kept_counts"]
    assert got["mode"] == "mask"
    assert abs(got["p_star"] - want["p_star"]) <= TOL
    assert got["kept_counts"]["mlp"] < QWEN.d_ff       # it pruned


def test_second_round_and_final_params_match_jax(jax_run, port_run):
    want, got = jax_run["res"], port_run
    for key in ("loss", "acc", "tau_eff"):
        assert abs(got.history[key][1] - want.history[key][1]) <= TOL, key
    want_p, got_p = jax.tree.leaves(want.params), tree_leaves(got.params)
    assert [tuple(g.shape) for g in got_p] == [w.shape for w in want_p]
    for g, w in zip(got_p, want_p):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=0)
    # the masked units stay exactly zero after the prune's round
    kept = got.artifacts["prune"]["kept"]["mlp"]
    pruned = np.setdiff1d(np.arange(QWEN.d_ff), kept[0])
    assert float(np.abs(got.params["layers"]["mlp"]["wi"][0][:, pruned]
                        .numpy()).max()) == 0.0
