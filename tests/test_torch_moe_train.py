"""FedDU + FedDUM training of the moe family (arctic-480b reduced) against
the JAX trainer.

Two rounds of ``feddumap_config`` (FedDU's dynamic server update, FedDUM's
two-sided momentum) through the local backend, each followed by an Eval,
with a Snapshot of the params after round 1, on arctic-480b's reduced
config (2 layers, d 256, 4 experts of 128 top-2 with a dense residual FFN,
4 heads padded to 16).  Both trainers start from the same JAX-initialised
params and see the same batches: the port is fed the JAX key chain's
draws, as in ``tests/test_torch_train.py``.  Every gradient carries the
router's share through the gate scale and the auxiliary losses; nothing in
the port's ``core/`` is family-specific (the model's ``loss_and_acc`` is
the whole seam).

Tolerances: the params after each round and each round's tau_eff within
1e-5, the dense trainer test's (measured: 1.2e-7 and 4e-9).  Each Eval's
test loss and token accuracy are held within 1e-5 (absolute, and relative
to the loss) to the JAX model's evaluation of the port's own params after
that round.  Against the JAX trainer's Evals they differ more (4.6e-5 and
1.4e-4 in loss): routing is discontinuous (each expert keeps its top-C
tokens of the test batch, the rest are dropped), so params 1e-7 apart can
route a token differently; the JAX trainer itself moves by 1.1e-4 to
3.3e-4 in loss when its start params are rounded once more.

A ``Prune`` event is refused by both trainers: FedAP's unit decision
(``decide_kept``) refuses the family, whose FedAP prunes whole experts
(``pruning_lm.fedap_lm``).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import engine as jax_engine
from repro.core import fedap as jax_fedap
from repro.core import plan as jax_plan
from repro.core.backend import sim_sample_kw
from repro.core.pruning import FedAPConfig as JaxFedAPConfig
from repro.core.rounds import FederatedTrainer as JaxTrainer
from repro.core.rounds import feddumap_config as jax_feddumap_config
from repro.data.pipeline import build_lm_federated_data as jax_build
from repro.data.synthetic import TokenSpec as JaxTokenSpec
from repro.models.lm import LM as JaxLM
from repro_torch import interop
from repro_torch.configs.base import ModelConfig
from repro_torch.core import fedap, plan
from repro_torch.core.pruning import FedAPConfig
from repro_torch.core.rounds import FederatedTrainer, feddumap_config
from repro_torch.data.pipeline import build_lm_federated_data
from repro_torch.data.synthetic import TokenSpec
from repro_torch.models.lm import LM
from repro_torch.utils.tree import tree_leaves
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCTIC = jax_get_config("arctic-480b").reduced()
SPEC = dict(vocab_size=ARCTIC.vocab_size, num_topics=16, seq_len=33,
            num_sequences=128)
CFG = dict(num_clients=8, clients_per_round=4, local_epochs=1, batch_size=4,
           server_batch_size=8, lr=3e-3, lr_decay=1.0)
AP = dict(align=128, min_rate=0.5, probe_size=2, participants=1)
ROUNDS = 2
STEP = 1e-5
EVAL_TOL = dict(atol=1e-5, rtol=1e-5)


def _plan(p):
    """Round 1, Eval, Snapshot, round 2, Eval in package ``p``'s events."""
    return p.TrainPlan(p.Scan(1), p.Eval(), p.Snapshot(), p.Scan(1),
                       p.Eval())


def _max_diff(a, b) -> float:
    return max(float(np.abs(np.asarray(x, np.float32)
                            - np.asarray(y, np.float32)).max())
               for x, y in zip(a, b))


@pytest.fixture(scope="module")
def jax_run():
    """The JAX trainer's run, its per-round draws, its start params and
    the JAX model's evaluation on the test set (jitted)."""
    data = jax_build(num_clients=8, spec=JaxTokenSpec(**SPEC))
    cfg = jax_feddumap_config(**CFG)
    model = JaxLM(ARCTIC)
    params0 = jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.key(cfg.seed)))
    res = JaxTrainer(model, data, cfg).run(_plan(jax_plan), params=params0)
    key = jax.random.key(cfg.seed)
    dev, kw = data.device_arrays(), sim_sample_kw(cfg, data)
    draws = []
    for _ in range(ROUNDS):
        key, sub = jax.random.split(key)
        draws.append(jax.tree.map(
            np.asarray, jax_engine.sample_round_batches(sub, dev, **kw)))
    evaluate = jax.jit(lambda p: model.loss_and_acc(p, dev["test_x"],
                                                    dev["test_y"]))
    return {"res": res, "draws": draws, "params0": params0,
            "evaluate": evaluate}


def _port_trainer(ap=None):
    data = build_lm_federated_data(num_clients=8, spec=TokenSpec(**SPEC))
    kw = dict(CFG, fedap=ap) if ap else CFG
    model = LM(ModelConfig.from_dict(ARCTIC.to_dict()), device="cpu")
    return FederatedTrainer(model, data, feddumap_config(**kw), device="cpu")


@pytest.fixture(scope="module")
def port_run(jax_run):
    return _port_trainer().run(
        _plan(plan), params=interop.params_from_jax(jax_run["params0"], "cpu"),
        batches=lambda t: jax_run["draws"][t])


def _eval_matches_jax_on_the_port_params(jax_run, got, params, r):
    """The port's Eval after round ``r`` + 1 against the JAX model's
    loss and accuracy on the port's params of that round."""
    jloss, jacc = jax_run["evaluate"](jax.tree.map(
        np.asarray, interop.params_to_numpy(params)))
    assert abs(got.history["loss"][r] - float(jloss)) <= STEP * float(jloss)
    assert abs(got.history["acc"][r] - float(jacc)) <= STEP


def test_first_round_matches_jax(jax_run, port_run):
    want, got = jax_run["res"], port_run
    assert got.history["round"] == want.history["round"] == [1, 2]
    assert got.artifacts["snapshot"]["round"] == 1
    assert _max_diff(tree_leaves(got.artifacts["snapshot"]["params"]),
                     jax.tree.leaves(want.artifacts["snapshot"]["params"])
                     ) <= STEP
    assert abs(got.history["tau_eff"][0] - want.history["tau_eff"][0]) <= STEP
    _eval_matches_jax_on_the_port_params(
        jax_run, got, got.artifacts["snapshot"]["params"], 0)


def test_second_round_and_final_params_match_jax(jax_run, port_run):
    want, got = jax_run["res"], port_run
    assert abs(got.history["tau_eff"][1] - want.history["tau_eff"][1]) <= STEP
    _eval_matches_jax_on_the_port_params(jax_run, got, got.params, 1)
    want_p, got_p = jax.tree.leaves(want.params), tree_leaves(got.params)
    assert [tuple(g.shape) for g in got_p] == [w.shape for w in want_p]
    assert _max_diff(got_p, want_p) <= STEP
    # the run moved the router and the padded heads' wo rows (ROADMAP R12)
    start = jax_run["params0"]["layers"]
    for leaf in (got.params["layers"]["moe"]["router"].numpy()
                 - start["moe"]["router"],
                 got.params["layers"]["attn"]["wo"][:, 4:].numpy()):
        assert np.abs(leaf).max() > 1e-6


def test_prune_event_is_refused_by_both_trainers(jax_run, monkeypatch):
    """FedAP's unit decision at a Prune event refuses the family in both
    packages (``decide_kept`` -> ``ffn_kept_indices``); the probe's rate is
    fixed on both sides (its value does not matter to the refusal)."""
    monkeypatch.setattr(jax_fedap, "participant_rate", lambda *a: 0.5)
    monkeypatch.setattr(fedap, "participant_rate",
                        lambda *a, **k: torch.tensor(0.5))
    data = jax_build(num_clients=8, spec=JaxTokenSpec(**SPEC))
    trainer = JaxTrainer(JaxLM(ARCTIC), data, jax_feddumap_config(
        fedap=JaxFedAPConfig(**AP), **CFG))
    with pytest.raises(ValueError, match="family moe"):
        trainer.run(jax_plan.TrainPlan(jax_plan.Prune(mode="mask"),
                                       jax_plan.Scan(1)),
                    params=jax_run["params0"])
    with pytest.raises(ValueError, match="family moe"):
        _port_trainer(FedAPConfig(**AP)).run(
            plan.TrainPlan(plan.Prune(mode="mask"), plan.Scan(1)),
            params=interop.params_from_jax(jax_run["params0"], "cpu"),
            batches=lambda t: jax_run["draws"][t])
