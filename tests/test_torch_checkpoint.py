"""The port's run checkpoints, resume and fault plumbing.

Mirrors ``tests/test_reliability.py``'s ``TestCheckpointStore``,
``TestFaultPlan`` and the local leg of ``TestKillAndResume`` on the port:

* the checkpoint store (atomic write, ``LATEST``, named errors, plan specs,
  ``TrainPlan`` checkpoint settings, ``RunResult.save``);
* kill and resume on the reference test's tiny SimpleCNN world (8x8x3, 6
  clients, 3 a round): a run killed by ``KillAfterChunk(2)`` and resumed
  from disk in a fresh trainer equals the uninterrupted run bit for bit:
  history (but ``time``), params and the trainer's generator state; also
  with a mask prune before the kill and a ``Prune(reuse=)`` shrink after
  it, which reads its decision from the restored artifacts;
* both directions between the packages: the reference's
  ``load_checkpoint`` reads the port's snapshot array for array, and the
  port resumes a snapshot the JAX trainer wrote for the tiny dense LM
  (same layouts), fed the JAX draws replayed from the snapshot's key data,
  matching the uninterrupted JAX run to 1e-5 a round;
* ``RunResult.save`` read by the reference's ``load_artifact`` and served
  by the port's ``load_servable``.
"""
import json
import os
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.core import engine as jax_engine
from repro.core.backend import sim_sample_kw as jax_sample_kw
from repro.core.plan import Eval as JaxEval
from repro.core.plan import Scan as JaxScan
from repro.core.plan import TrainPlan as JaxTrainPlan
from repro.core.plan import load_artifact as jax_load_artifact
from repro.core.rounds import FederatedTrainer as JaxTrainer
from repro.core.rounds import feddumap_config as jax_feddumap_config
from repro.data.pipeline import build_lm_federated_data as jax_build_lm
from repro.data.synthetic import TokenSpec as JaxTokenSpec
from repro.models.lm import LM as JaxLM
from repro.reliability import KillAfterChunk as JaxKillAfterChunk
from repro.reliability import SimulatedCrash as JaxSimulatedCrash
from repro.reliability import load_checkpoint as jax_load_checkpoint
from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import EngineConfig
from repro_torch.core.plan import (
    Callback,
    CheckpointError,
    Eval,
    Prune,
    RunResult,
    Scan,
    Snapshot,
    TrainPlan,
    load_artifact,
)
from repro_torch.core.pruning import FedAPConfig
from repro_torch.core.rounds import FederatedTrainer, FLConfig, feddumap_config
from repro_torch.data.pipeline import build_federated_data
from repro_torch.data.pipeline import build_lm_federated_data
from repro_torch.data.synthetic import SyntheticSpec, TokenSpec
from repro_torch.models.cnn import SimpleCNN
from repro_torch.models.lm import LM
from repro_torch.reliability import (
    CorruptUpdate,
    FaultPlan,
    KillAfterChunk,
    NaNGrad,
    SimulatedCrash,
    latest_checkpoint,
    load_checkpoint,
    plan_from_spec,
    plan_spec,
    save_checkpoint,
)
from repro_torch.serving import DecodeEngine, ServeConfig, load_servable
from repro_torch.utils.tree import tree_leaves
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

# ---------------------------------------------------------------------------
# The checkpoint store
# ---------------------------------------------------------------------------


class TestCheckpointStore:
    def _payload(self, cursor):
        return {
            "cursor": cursor,
            "state": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                      "h": torch.tensor([1.5, -2.25], dtype=torch.bfloat16),
                      "nested": {"b": np.float32(2.5), "n": None}},
            "generator_state": torch.Generator().manual_seed(3).get_state(),
            "history": {"acc": [0.1, 0.2], "round": [1, 2]},
            "plan": [{"type": "Scan", "rounds": 2}],
            "meta": ("tuple", 3),
        }

    def test_round_trip_and_latest(self, tmp_path):
        save_checkpoint(tmp_path, self._payload(1))
        p2 = save_checkpoint(tmp_path, self._payload(2))
        assert latest_checkpoint(tmp_path) == pathlib.Path(p2)
        back = load_checkpoint(tmp_path)
        want = self._payload(2)
        assert back["cursor"] == 2
        np.testing.assert_array_equal(back["state"]["w"],
                                      want["state"]["w"].numpy())
        # bfloat16 crosses as float32 on disk and comes back as bfloat16
        assert back["state"]["h"].dtype == torch.bfloat16
        assert torch.equal(back["state"]["h"], want["state"]["h"])
        assert back["state"]["nested"]["n"] is None
        assert back["meta"] == ("tuple", 3)       # tuples survive as tuples
        assert back["history"]["acc"] == [0.1, 0.2]
        gen = torch.Generator()
        gen.set_state(torch.from_numpy(back["generator_state"]))
        assert torch.equal(gen.get_state(), want["generator_state"])
        # atomic writes leave no temp debris
        assert not [p for p in os.listdir(tmp_path) if ".tmp" in p]

    def test_reference_reads_the_port_format(self, tmp_path):
        save_checkpoint(tmp_path, self._payload(1))
        back = jax_load_checkpoint(tmp_path)
        np.testing.assert_array_equal(back["state"]["w"],
                                      np.arange(6, dtype=np.float32)
                                      .reshape(2, 3))
        np.testing.assert_array_equal(back["state"]["h"], [1.5, -2.25])

    def test_named_errors(self, tmp_path):
        with pytest.raises(CheckpointError, match="no run checkpoint"):
            load_checkpoint(tmp_path / "nowhere")
        step = pathlib.Path(save_checkpoint(tmp_path, self._payload(1)))
        (step / "arrays.npz").unlink()
        with pytest.raises(CheckpointError, match="partial"):
            load_checkpoint(tmp_path)
        assert issubclass(CheckpointError, ValueError)
        with pytest.raises(CheckpointError, match="cannot checkpoint"):
            save_checkpoint(tmp_path, {"cursor": 0, "x": object()})

    def test_plan_spec_round_trip(self):
        plan = TrainPlan(Eval(), Scan(2), Snapshot(name="s"), Scan(1),
                         Prune(mode="mask"),
                         Prune(mode="shrink", reuse="prune", name="shrink"),
                         Eval(name="final"))
        spec = plan_spec(plan)
        rebuilt = plan_from_spec(spec, checkpoint_every=1,
                                 checkpoint_dir="d")
        assert plan_spec(rebuilt) == spec and rebuilt == plan
        assert rebuilt.checkpoint_every == 1

    def test_callback_plans_need_the_original(self):
        spec = plan_spec(TrainPlan(Scan(1), Callback(lambda *_: None,
                                                     name="cb")))
        with pytest.raises(CheckpointError, match="Callback"):
            plan_from_spec(spec)

    def test_trainplan_checkpoint_validation(self, tmp_path):
        with pytest.raises(ValueError, match="checkpoint_dir"):
            TrainPlan(Scan(1), checkpoint_every=2)
        with pytest.raises(ValueError, match="checkpoint_every"):
            TrainPlan(Scan(1), checkpoint_every=0, checkpoint_dir=tmp_path)
        p = TrainPlan(Scan(1), checkpoint_dir=tmp_path)
        assert p.checkpoint_every == 1
        q = TrainPlan(Scan(1)).with_checkpointing(tmp_path, every=2)
        assert (q.checkpoint_every, str(q.checkpoint_dir)) == \
            (2, str(tmp_path))
        # equality is over the schedule, not the durability settings
        assert TrainPlan(Scan(1)) == p

    def test_run_result_save_is_atomic_and_errors_named(self, tmp_path):
        res = RunResult(params={"w": torch.ones(2, dtype=torch.bfloat16)},
                        state={}, history={"acc": [torch.tensor(0.5)]},
                        artifacts={})
        out = tmp_path / "artifact"
        res.save(out)
        assert not [p for p in os.listdir(out) if ".tmp" in p]
        art = load_artifact(out)
        assert art["params"]["w"].dtype == np.float32
        np.testing.assert_array_equal(art["params"]["w"], [1.0, 1.0])
        assert art["history"] == {"acc": [0.5]}
        with pytest.raises(CheckpointError, match="meta.json"):
            load_artifact(tmp_path / "empty")
        (out / "arrays.npz").write_bytes(b"garbage")
        with pytest.raises(CheckpointError, match="corrupt"):
            load_artifact(out)


# ---------------------------------------------------------------------------
# Fault-plan plumbing
# ---------------------------------------------------------------------------


class TestFaultPlan:
    def test_device_host_split_and_hashability(self):
        plan = FaultPlan(NaNGrad(client=0, round=1), KillAfterChunk(2),
                         CorruptUpdate(scale=2.0))
        assert [type(f).__name__ for f in plan.device] == \
            ["NaNGrad", "CorruptUpdate"]
        assert [type(f).__name__ for f in plan.host] == ["KillAfterChunk"]
        hash(plan)                     # rides in the frozen EngineConfig
        hash(EngineConfig(guard="skip_round", faults=plan.device))
        with pytest.raises(ValueError):
            KillAfterChunk(0)

    def test_config_validation(self):
        with pytest.raises(ValueError, match="guard"):
            FLConfig(guard="sometimes")
        with pytest.raises(ValueError, match="fault"):
            FLConfig(faults=("not a fault",))
        with pytest.raises(ValueError, match="guard"):
            EngineConfig(guard="maybe")
        with pytest.raises(ValueError, match="host"):
            EngineConfig(faults=(KillAfterChunk(1),))

    def test_device_faults_hit_only_their_client_and_round(self):
        params = {"w": torch.zeros(3)}
        rnd = torch.tensor(1.0)
        nan = NaNGrad(client=4, round=1)
        for sel, r, hit in ((4, 1.0, True), (3, 1.0, False),
                            (4, 0.0, False)):
            out = nan.apply_client({"w": torch.ones(3)}, params,
                                   torch.tensor(sel), torch.tensor(r))
            assert bool(torch.isnan(out["w"]).all()) == hit
        up = CorruptUpdate(scale=10.0, client=2)
        out = up.apply_client({"w": torch.full((3,), 0.5)},
                              {"w": torch.full((3,), 0.25)},
                              torch.tensor(2), rnd)
        assert torch.equal(out["w"], torch.full((3,), 2.75))


# ---------------------------------------------------------------------------
# Kill and resume on the tiny SimpleCNN world
# ---------------------------------------------------------------------------


CHANNELS = (4, 8, 8)


@pytest.fixture(scope="module")
def tiny_world():
    spec = SyntheticSpec(num_classes=10, image_shape=(8, 8, 3),
                         train_size=1600, test_size=100, noise_scale=0.5)
    data = build_federated_data(num_clients=6, server_fraction=0.1,
                                device_pool=600, spec=spec)
    model = SimpleCNN(num_classes=10, image_shape=(8, 8, 3),
                      channels=CHANNELS, fc_width=16, device="cpu")
    return data, model


CFG = dict(num_clients=6, clients_per_round=3, local_epochs=1,
           batch_size=10, lr=0.05,
           fedap=FedAPConfig(min_rate=0.3, probe_size=8, participants=2))
PLANS = {
    "scan": (Scan(2), Eval(), Scan(2), Eval(), Scan(2), Eval()),
    # the kill falls between a mask prune and the shrink that reuses its
    # decision, which then comes from the restored artifacts
    "prune": (Scan(1), Eval(), Prune(mode="mask"), Scan(1), Eval(),
              Snapshot(name="mid"),
              Prune(mode="shrink", reuse="prune", name="shrink"), Scan(1),
              Eval()),
}


def _trainer(world, **kw):
    data, model = world
    return FederatedTrainer(model, data, feddumap_config(**CFG, **kw),
                            device="cpu")


def _histories_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if k != "time":     # wall clock is the one permitted difference
            assert a[k] == b[k], f"history[{k!r}] diverged"


class TestKillAndResume:
    @pytest.mark.parametrize("plan", sorted(PLANS))
    def test_resume_is_bit_identical(self, tiny_world, tmp_path, plan):
        """Kill after chunk 2, resume from disk in a FRESH trainer: history,
        params and the generator state equal the uninterrupted run's."""
        events = PLANS[plan]
        ref = _trainer(tiny_world)
        full = ref.run(TrainPlan(*events))
        ckpt = tmp_path / "ckpt"
        with pytest.raises(SimulatedCrash):
            _trainer(tiny_world, faults=(KillAfterChunk(2),)).run(
                TrainPlan(*events, checkpoint_dir=ckpt))
        fresh = _trainer(tiny_world)
        res = fresh.resume(ckpt)
        _histories_equal(res.history, full.history)
        assert [tuple(t.shape) for t in tree_leaves(res.params)] == \
            [tuple(t.shape) for t in tree_leaves(full.params)]
        for a, b in zip(tree_leaves(res.params), tree_leaves(full.params)):
            assert torch.equal(a, b)
        assert torch.equal(fresh.generator.get_state(),
                           ref.generator.get_state())
        if plan == "prune":
            np.testing.assert_array_equal(
                res.artifacts["shrink"]["kept"]["conv1"],
                full.artifacts["shrink"]["kept"]["conv1"])
            # the reused decision really pruned (min_rate 0.3)
            assert sum(res.artifacts["shrink"]["kept_counts"].values()) < \
                sum(CHANNELS)

    def test_resumed_run_does_not_redie(self, tiny_world, tmp_path):
        """KillAfterChunk counts chunks over the whole run: resuming with
        the fault still configured does not crash again."""
        ckpt = tmp_path / "ckpt"
        kill = dict(faults=(KillAfterChunk(1),))
        with pytest.raises(SimulatedCrash):
            _trainer(tiny_world, **kill).run(
                TrainPlan(Scan(1), Scan(1), Eval(), checkpoint_dir=ckpt))
        res = _trainer(tiny_world, **kill).resume(ckpt)
        assert res.history["round"] == [2]

    def test_resume_wrong_backend_fails(self, tiny_world, tmp_path):
        ckpt = tmp_path / "ckpt"
        with pytest.raises(SimulatedCrash):
            _trainer(tiny_world, faults=(KillAfterChunk(1),)).run(
                TrainPlan(Scan(1), Scan(1), checkpoint_dir=ckpt))
        meta_path = latest_checkpoint(ckpt) / "meta.json"
        meta = json.loads(meta_path.read_text())
        meta["payload"]["__dict__"]["backend"] = {"__value__": "mesh"}
        meta_path.write_text(json.dumps(meta))
        with pytest.raises(CheckpointError, match="backend"):
            _trainer(tiny_world).resume(ckpt)

    def test_resume_plan_mismatch_fails(self, tiny_world, tmp_path):
        ckpt = tmp_path / "ckpt"
        with pytest.raises(SimulatedCrash):
            _trainer(tiny_world, faults=(KillAfterChunk(1),)).run(
                TrainPlan(Scan(1), Scan(1), checkpoint_dir=ckpt))
        with pytest.raises(CheckpointError, match="plan"):
            _trainer(tiny_world).resume(ckpt,
                                        plan=TrainPlan(Scan(3), Eval()))

    def test_callback_plan_resumes_with_the_original(self, tiny_world,
                                                     tmp_path):
        seen = []

        def hook(trainer, t, params):
            seen.append(t)

        events = (Scan(1), Callback(hook, name="cb"), Scan(1), Scan(1),
                  Callback(hook, name="cb"))
        ckpt = tmp_path / "ckpt"
        with pytest.raises(SimulatedCrash):
            _trainer(tiny_world, faults=(KillAfterChunk(2),)).run(
                TrainPlan(*events, checkpoint_dir=ckpt))
        with pytest.raises(CheckpointError, match="Callback"):
            _trainer(tiny_world).resume(ckpt)
        seen.clear()
        _trainer(tiny_world).resume(ckpt, plan=TrainPlan(*events))
        assert seen == [3]

    def test_reference_reads_the_port_run_checkpoint(self, tiny_world,
                                                     tmp_path):
        """``repro.reliability.load_checkpoint`` reads the port's snapshot:
        the same keys, every array equal."""
        ckpt = tmp_path / "ckpt"
        with pytest.raises(SimulatedCrash):
            _trainer(tiny_world, faults=(KillAfterChunk(2),)).run(
                TrainPlan(*PLANS["prune"], checkpoint_dir=ckpt))
        port, ref = load_checkpoint(ckpt), jax_load_checkpoint(ckpt)
        assert port["backend"] == ref["backend"] == "local"
        assert port["t"] == ref["t"] == 2 and port["plan"] == ref["plan"]
        assert port["history"] == ref["history"]
        # JAX trees hold None as no leaf (the plan spec's reuse=None)
        leaves_p = [x for x in tree_leaves(port) if x is not None]
        leaves_r = jax.tree.leaves(ref)
        assert len(leaves_p) == len(leaves_r)
        n_arrays = 0
        for a, b in zip(leaves_p, leaves_r):
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b)
                n_arrays += 1
            else:
                assert a == b
        assert n_arrays > 20      # state, init params, prune artifacts


# ---------------------------------------------------------------------------
# The port resumes a snapshot the JAX trainer wrote (tiny dense LM)
# ---------------------------------------------------------------------------

TINY = dict(name="dense-tiny", family="dense", rope="1d", norm="rmsnorm",
            act="silu", param_dtype="float32", remat="none",
            num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
            d_ff=512, vocab_size=2048)
SPEC = dict(vocab_size=2048, num_topics=16, seq_len=17, num_sequences=256)
LM_CFG = dict(num_clients=8, clients_per_round=4, local_epochs=1,
              batch_size=4, server_batch_size=8, lr=3e-3, lr_decay=1.0)
LM_ROUNDS = 3


def test_port_resumes_a_reference_checkpoint(tmp_path):
    """The JAX trainer is killed after chunk 2; the port resumes its
    snapshot (round state in the same layouts, the JAX draws replayed from
    the snapshot's key data) and matches the uninterrupted JAX run to 1e-5
    a round: test loss, accuracy and tau_eff, then the final params."""
    jdata = jax_build_lm(num_clients=8, spec=JaxTokenSpec(**SPEC))
    jmodel = JaxLM(JaxModelConfig(**TINY))
    events = [e for _ in range(LM_ROUNDS) for e in (JaxScan(1), JaxEval())]
    full = JaxTrainer(jmodel, jdata, jax_feddumap_config(**LM_CFG)).run(
        JaxTrainPlan(events))
    ckpt = tmp_path / "jax-ckpt"
    with pytest.raises(JaxSimulatedCrash):
        JaxTrainer(jmodel, jdata, jax_feddumap_config(
            **LM_CFG, faults=(JaxKillAfterChunk(2),))).run(
            JaxTrainPlan(events, checkpoint_dir=ckpt))

    payload = load_checkpoint(ckpt)
    assert "generator_state" not in payload and payload["t"] == 2
    key = jax.random.wrap_key_data(jax.numpy.asarray(payload["key_data"]))
    kw = jax_sample_kw(jax_feddumap_config(**LM_CFG), jdata)
    dev = jdata.device_arrays()
    draws = {}
    for t in range(payload["t"], LM_ROUNDS):
        key, sub = jax.random.split(key)
        draws[t] = jax.tree.map(
            np.asarray, jax_engine.sample_round_batches(sub, dev, **kw))

    data = build_lm_federated_data(num_clients=8, spec=TokenSpec(**SPEC))
    trainer = FederatedTrainer(LM(ModelConfig(**TINY), device="cpu"), data,
                               feddumap_config(**LM_CFG), device="cpu")
    with pytest.raises(CheckpointError, match="batches="):
        trainer.resume(ckpt)
    res = trainer.resume(ckpt, batches=lambda t: draws[t])
    want = full.history
    assert res.history["round"] == want["round"] == [1, 2, 3]
    for k in ("loss", "acc", "tau_eff"):
        np.testing.assert_allclose(res.history[k], want[k], atol=1e-5,
                                   rtol=0, err_msg=k)
    for g, w in zip(tree_leaves(res.params), jax.tree.leaves(full.params)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


# ---------------------------------------------------------------------------
# RunResult.save -> the reference's load_artifact and the port's servable
# ---------------------------------------------------------------------------


def test_run_result_save_loads_in_both_packages(tmp_path):
    cfg = ModelConfig(**TINY)
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    kept = model.decide_kept(params, 0.5)
    fmasks = model.filter_masks(params, kept)
    res = RunResult(
        params=params, state={}, history={"round": [1], "acc": [0.25]},
        artifacts={"prune": {"kept": kept, "filter_masks": fmasks,
                             "mode": "mask", "p_star": 0.5,
                             "layer_rates": {"mlp": 0.5},
                             "kept_counts": {"mlp": 256}}})
    out = tmp_path / "run"
    res.save(out, model_config=cfg)

    art = jax_load_artifact(out)
    assert art["mode"] == "mask" and art["model_config"].d_ff == cfg.d_ff
    for a, b in zip(jax.tree.leaves(art["params"]), tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(art["kept"]["mlp"]),
                                  kept["mlp"])
    np.testing.assert_array_equal(np.asarray(art["filter_masks"]["mlp"]),
                                  fmasks["mlp"].numpy())
    assert art["meta"]["prune"]["kept_counts"] == {"mlp": 256}

    sv = load_servable(out, device="cpu", attn_impl="xla")
    direct = load_servable(res, model_config=cfg, device="cpu",
                           attn_impl="xla")
    assert sv.mode == direct.mode == "masked"
    scfg = ServeConfig(slots=2, cache_len=8, max_prompt=4, max_new_tokens=4,
                       steps_per_wave=3)
    prompts = [np.asarray([5, 9, 2], np.int32), np.asarray([7], np.int32)]
    got = DecodeEngine(sv.model, sv.params, scfg, masks=sv.masks,
                       device="cpu").run(prompts)
    want = DecodeEngine(direct.model, direct.params, scfg,
                        masks=direct.masks, device="cpu").run(prompts)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_plan_runs_with_deterministic_cudnn(tiny_world):
    """The executor restricts cuDNN to deterministic algorithms for the
    plan (a resume is bit-identical only for a deterministic run) and
    restores the setting after it."""
    seen = []
    cudnn = torch.backends.cudnn
    before = cudnn.deterministic
    _trainer(tiny_world).run(TrainPlan(Scan(1), Callback(
        lambda trainer, t, params: seen.append(cudnn.deterministic))))
    assert seen == [True] and cudnn.deterministic == before
