"""FedDU + FedDUM training of the ssm family (xlstm) against the JAX trainer.

Two rounds of ``feddumap_config`` (FedDU's dynamic server update, FedDUM's
two-sided momentum) through the local backend, each followed by an Eval,
with a Snapshot of the params after round 1, on xlstm-125m's reduced
config with 4 layers (three mLSTM blocks and one sLSTM block).  Both
trainers start from the same JAX-initialised params and see the same
batches: the port is fed the JAX key chain's draws, as in
``tests/test_torch_train.py``.  Nothing in the port's ``core/`` is
family-specific: the model's ``loss_and_acc`` is the whole seam.

Tolerances.  Round 1 (one round from one state on the same batches): the
params and tau_eff within 1e-5, the dense trainer test's (measured: 1.9e-7
and 4e-9); the test loss and token accuracy within 1e-4 absolute and
relative, the LM's logit tolerance (``tests/test_torch_xlstm.py``;
measured 2.9e-5 on a loss of 6.87): this model's loss moves ~1e-3 for a
5e-7 RMS change of its first mLSTM block's projections.  Round 2 and the
final params: within the reference's own response to f32 rounding,
measured here by running the JAX trainer again from the start params
rounded once more (each entry times 1 +- 2^-24).  That moves the JAX
trajectory at round 2 by 8.1e-2 in loss, 6.6e-3 in tau_eff and 2.4e-4 in
the params, against 6.3e-3, 0 and 4.8e-5 between the packages (the
exponential gates amplify the round's difference).  Each is held to the
larger of 1e-5 and that response.

A ``Prune`` event is refused by both trainers: FedAP prunes FFN units,
and the family has no FFN.  The refusal comes from the kept-unit
selection, after the FedAP probe, whose rate is fixed on the JAX side for
that test (its JAX compile costs a minute; the port runs its own probe).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

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
from repro_torch.core import plan
from repro_torch.core.pruning import FedAPConfig
from repro_torch.core.rounds import FederatedTrainer, feddumap_config
from repro_torch.data.pipeline import build_lm_federated_data
from repro_torch.data.synthetic import TokenSpec
from repro_torch.models.lm import LM
from repro_torch.utils.tree import tree_leaves
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

XL = jax_get_config("xlstm-125m").reduced(num_layers=4)
SPEC = dict(vocab_size=XL.vocab_size, num_topics=16, seq_len=33,
            num_sequences=128)
CFG = dict(num_clients=8, clients_per_round=4, local_epochs=1, batch_size=4,
           server_batch_size=8, lr=3e-3, lr_decay=1.0)
AP = dict(align=128, min_rate=0.5, probe_size=2, participants=1)
ROUNDS = 2
STEP = 1e-5                  # round 1: params and tau_eff
EVAL_TOL = dict(atol=1e-4, rtol=1e-4)


def _plan(p):
    """Round 1, Eval, Snapshot, round 2, Eval in package ``p``'s events."""
    return p.TrainPlan(p.Scan(1), p.Eval(), p.Snapshot(), p.Scan(1),
                       p.Eval())


def _max_diff(a, b) -> float:
    return max(float(np.abs(np.asarray(x, np.float32)
                            - np.asarray(y, np.float32)).max())
               for x, y in zip(a, b))


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX trainer's run, its run from the start params rounded once
    more, its per-round draws and its start params."""
    data = jax_build(num_clients=8, spec=JaxTokenSpec(**SPEC))
    cfg = jax_feddumap_config(**CFG)
    model = JaxLM(XL)
    trainer = JaxTrainer(model, data, cfg)
    params0 = jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.key(cfg.seed)))
    res = trainer.run(_plan(jax_plan), params=params0)
    rng = np.random.default_rng(0)
    rounded = jax.tree.map(
        lambda a: jnp.asarray(a * (1 + 2.0 ** -24 * rng.choice(
            [-1.0, 1.0], a.shape)).astype(np.float32)), params0)
    other = trainer.run(_plan(jax_plan), params=rounded)
    key = jax.random.key(cfg.seed)
    dev, kw = data.device_arrays(), sim_sample_kw(cfg, data)
    draws = []
    for _ in range(ROUNDS):
        key, sub = jax.random.split(key)
        draws.append(jax.tree.map(
            np.asarray, jax_engine.sample_round_batches(sub, dev, **kw)))
    return {"res": res, "rounded": other, "draws": draws, "params0": params0}


def _port_trainer(ap=None):
    data = build_lm_federated_data(num_clients=8, spec=TokenSpec(**SPEC))
    kw = dict(CFG, fedap=ap) if ap else CFG
    model = LM(ModelConfig.from_dict(XL.to_dict()), device="cpu")
    return FederatedTrainer(model, data, feddumap_config(**kw), device="cpu")


@pytest.fixture(scope="module")
def port_run(jax_runs):
    return _port_trainer().run(
        _plan(plan), params=interop.params_from_jax(jax_runs["params0"], "cpu"),
        batches=lambda t: jax_runs["draws"][t])


def test_first_round_matches_jax(jax_runs, port_run):
    want, got = jax_runs["res"], port_run
    assert got.history["round"] == want.history["round"] == [1, 2]
    assert got.artifacts["snapshot"]["round"] == 1
    assert _max_diff(tree_leaves(got.artifacts["snapshot"]["params"]),
                     jax.tree.leaves(want.artifacts["snapshot"]["params"])
                     ) <= STEP
    assert abs(got.history["tau_eff"][0] - want.history["tau_eff"][0]) <= STEP
    for key in ("loss", "acc"):
        np.testing.assert_allclose(got.history[key][0], want.history[key][0],
                                   **EVAL_TOL, err_msg=key)


def test_second_round_within_the_reference_f32_response(jax_runs,
                                                        port_run):
    want, other, got = jax_runs["res"], jax_runs["rounded"], port_run
    for key in ("loss", "acc", "tau_eff"):
        spread = abs(other.history[key][1] - want.history[key][1])
        diff = abs(got.history[key][1] - want.history[key][1])
        assert np.isfinite(got.history[key][1])
        assert diff <= max(STEP, spread), (key, diff, spread)
    want_p = jax.tree.leaves(want.params)
    got_p = tree_leaves(got.params)
    assert [tuple(g.shape) for g in got_p] == [w.shape for w in want_p]
    spread = _max_diff(jax.tree.leaves(other.params), want_p)
    assert _max_diff(got_p, want_p) <= max(STEP, spread)
    assert _max_diff(want_p, jax.tree.leaves(jax_runs["params0"])) > 1e-4


def test_prune_event_is_refused_by_both_trainers(jax_runs, monkeypatch):
    """FedAP's decision at a Prune event refuses the family in both
    packages (``pruning_lm.ffn_kept_indices``)."""
    monkeypatch.setattr(jax_fedap, "participant_rate", lambda *a: 0.5)
    data = jax_build(num_clients=8, spec=JaxTokenSpec(**SPEC))
    trainer = JaxTrainer(JaxLM(XL), data, jax_feddumap_config(
        fedap=JaxFedAPConfig(**AP), **CFG))
    with pytest.raises(ValueError, match="family ssm"):
        trainer.run(jax_plan.TrainPlan(jax_plan.Prune(mode="mask"),
                                       jax_plan.Scan(1)),
                    params=jax_runs["params0"])
    with pytest.raises(ValueError, match="family ssm"):
        _port_trainer(FedAPConfig(**AP)).run(
            plan.TrainPlan(plan.Prune(mode="mask"), plan.Scan(1)),
            params=interop.params_from_jax(jax_runs["params0"], "cpu"),
            batches=lambda t: jax_runs["draws"][t])
