"""The multi-device backend (``MeshBackend``), its placement rules and the
sharded FedAP decision, against the port's local backend, the reference's
float64 oracle (``repro.core.ref_engine``) and the reference's specs.

The reference's own mesh tests fail under the installed jax (ROADMAP R1),
so these hold the semantics instead: mesh equals local equals the oracle.

* Placements: ``LM.axes()`` equals the reference's logical-axis tree, and
  ``param_specs``/``fl_state_specs``/``fl_sim_batch_specs``/
  ``fl_batch_partition_specs``/``cache_specs`` equal the reference's
  ``PartitionSpec``s leaf for leaf as DTensor placements, for every arch,
  on the reference test's duck-typed 16 x 16 and 2 x 16 x 16 meshes.
* A world of one (gloo over a ``HashStore``, in this process): a FedDUMAP
  mask-then-shrink plan in kernel mode bitwise equal to the local backend,
  a kill and resume bitwise equal to the uninterrupted run, and the
  checkpoint refused across backends.
* Two spawned gloo ranks (``_torch_mesh_worker``): the 6 momentum modes,
  FedProx, FedDyn, dropout (an all-dropped round included) and the
  reject_client guard, each within 1e-5 a round of the local backend and of
  the oracle; C = 3 over 2 ranks bitwise local (the replicated fallback);
  a sharded eval of 7 test rows (padded to 8) equal to local within 1e-6;
  ``fedap_decision_sharded`` with ragged probes (a 5-sample server pool
  against a probe of 8) equal to the host decision; ``DecodeEngine(mesh=)``
  (2 of 4 slots a rank; a moe model keeps all 4) returning the mesh-less
  engine's completions on every rank.
"""
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

import _torch_mesh_worker as W
from repro.configs import get_config as jax_get_config
from repro.configs.base import InputShape as JaxInputShape
from repro.core import ref_engine
from repro.core.engine import EngineConfig as JaxEngineConfig
from repro.core.engine import FedDynConfig as JaxFedDynConfig
from repro.core.engine import FedProxConfig as JaxFedProxConfig
from repro.core.ref_engine import SoftmaxRegression
from repro.launch import steps as jsteps
from repro.models.api import build_model as jax_build_model
from repro.reliability.faults import NaNGrad as JaxNaNGrad
from repro.sharding import fl_specs as jfl
from repro.sharding import specs as jspecs
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import InputShape
from repro_torch.core import fedap
from repro_torch.core.plan import CheckpointError, TrainPlan, fedap_plan
from repro_torch.core.pruning import FedAPConfig
from repro_torch.core.rounds import FederatedTrainer, feddumap_config
from repro_torch.data.pipeline import build_lm_federated_data
from repro_torch.data.synthetic import TokenSpec
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import steps
from repro_torch.models.lm import LM
from repro_torch.reliability.faults import KillAfterChunk, SimulatedCrash
from repro_torch.sharding import fl_specs, specs
from repro_torch.utils.arrays import pad_rows_with_first
from repro_torch.utils.tree import tree_leaves, tree_map
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5


class FakeMesh:
    """The reference test's duck-typed mesh: only ``shape`` is read."""

    def __init__(self, shape: dict):
        self.shape = shape


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _ref_placements(p, names):
    return specs.to_placements(tuple(p), names)


def _ref_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, P))


def _assert_same_placements(got, want, names, what=""):
    g = tree_leaves(got)
    w = _ref_leaves(want)
    assert len(g) == len(w), what
    for a, b in zip(g, w):
        assert a.placements == _ref_placements(b, names), (what, a, b)


# ---------------------------------------------------------------------------
# placements against the reference's PartitionSpecs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_and_state_placements_equal_the_reference(arch):
    jmodel = jax_build_model(jax_get_config(arch))
    model = LM(get_config(arch), device="cpu")
    axes = model.axes()
    flat = jax.tree.leaves(jmodel.axes(), is_leaf=lambda x: isinstance(
        x, tuple))
    assert specs._axes_leaves(axes) == [tuple(a) for a in flat]
    shapes = model.param_shapes()
    jshapes = jmodel.param_shapes()
    assert [tuple(s.shape) for s in tree_leaves(shapes)] == \
        [s.shape for s in jax.tree.leaves(jshapes)]
    for mname, shape in MESHES.items():
        plan = specs.make_plan(FakeMesh(shape), get_config(arch))
        jplan = jspecs.make_plan(FakeMesh(shape), jax_get_config(arch))
        assert (plan.client_axes, plan.fsdp_axes, plan.batch_axes,
                plan.num_clients) == (jplan.client_axes, jplan.fsdp_axes,
                                      jplan.batch_axes, jplan.num_clients)
        names = tuple(shape)
        # the federated state's params with a leading dim of 32 clients
        led = tree_map(lambda s: torch.empty((32,) + tuple(s.shape),
                                             device="meta"), shapes)
        jled = jax.tree.map(lambda s: jax.ShapeDtypeStruct(
            (32,) + s.shape, s.dtype), jshapes)
        for lead, (sh, jsh) in ((False, (shapes, jshapes)),
                                (True, (led, jled))):
            _assert_same_placements(
                specs.param_specs(sh, axes, plan, client_leading=lead),
                jspecs.param_specs(jsh, jmodel.axes(), jplan,
                                   client_leading=lead), names,
                f"{arch} {mname} params client_leading={lead}")
        state = {"params": shapes, "server_m": shapes, "masks": shapes,
                 "round": torch.zeros(()),
                 "filter_masks": {"mlp": torch.empty((2, 64))},
                 "client_state": {"per_client": {"h": {
                     "w": torch.empty((32, 3))}}, "shared": {"h": shapes}}}
        jstate = dict(state, params=jshapes, server_m=jshapes, masks=jshapes,
                      client_state={"per_client": {"h": {
                          "w": jax.ShapeDtypeStruct((32, 3), np.float32)}},
                          "shared": {"h": jshapes}})
        for model_axes in (axes, None):
            _assert_same_placements(
                fl_specs.fl_state_specs(state, model_axes, plan,
                                        client_axes=plan.client_axes),
                jfl.fl_state_specs(jstate, None if model_axes is None
                                   else jmodel.axes(), jplan,
                                   client_axes=jplan.client_axes),
                names, f"{arch} {mname} state")


@pytest.mark.parametrize("mname", sorted(MESHES))
def test_batch_placements_equal_the_reference(mname):
    shape = MESHES[mname]
    names = tuple(shape)
    for arch in ("olmo-1b", "qwen2-vl-7b", "whisper-small", "llama3-405b"):
        plan = specs.make_plan(FakeMesh(shape), get_config(arch))
        jplan = jspecs.make_plan(FakeMesh(shape), jax_get_config(arch))
        for c in (3, 16, 32, 64):
            for sb in (None, 5, 32):
                for act in (False, True):
                    got = fl_specs.fl_sim_batch_specs(
                        c, plan, server_batch=sb, with_active=act)
                    want = jfl.fl_sim_batch_specs(c, jplan, server_batch=sb,
                                                  with_active=act)
                    assert sorted(got) == sorted(want)
                    for k in got:
                        _assert_same_placements(got[k], want[k], names, k)
        run_j, run_t = (jsteps.FLRunConfig(local_steps=2, server_batch=64),
                        steps.FLRunConfig(local_steps=2, server_batch=64))
        bj = jsteps.fl_batch_specs(jax_get_config(arch),
                                   JaxInputShape("t", 128, 256, "train"), 32,
                                   run_j)
        bt = steps.fl_batch_specs(get_config(arch),
                                  InputShape("t", 128, 256, "train"), 32,
                                  run_t)
        got = fl_specs.fl_batch_partition_specs(bt, plan)
        want = jfl.fl_batch_partition_specs(bj, jplan)
        for part in ("client", "server"):
            for k in got[part]:
                _assert_same_placements(got[part][k], want[part][k], names,
                                        f"{arch} {part} {k}")
        serve = {k: v[0] for k, v in bt["server"].items()}
        jserve = {k: v for k, v in jsteps.fl_batch_specs(
            jax_get_config(arch), JaxInputShape("t", 128, 256, "train"), 32,
            jsteps.FLRunConfig(server_batch=64))["server"].items()}
        jserve = {k: jax.ShapeDtypeStruct(v.shape[1:], v.dtype)
                  for k, v in jserve.items()}
        for k, v in fl_specs.serve_batch_specs(serve, plan).items():
            assert v.placements == _ref_placements(
                jfl.serve_batch_specs(jserve, jplan)[k], names)
        cache = {"k": torch.empty((2, 32, 64, get_config(
            arch).padded_num_kv_heads, 8), device="meta"),
                 "index": torch.empty((32,), device="meta")}
        jcache = {k: jax.ShapeDtypeStruct(tuple(v.shape), np.float32)
                  for k, v in cache.items()}
        for k, v in specs.cache_specs(cache, plan, get_config(arch)).items():
            assert v.placements == _ref_placements(
                jspecs.cache_specs(jcache, jplan, jax_get_config(arch))[k],
                names)


def test_client_dim_sharding():
    plan = specs.make_plan(FakeMesh(MESHES["2x16x16"]), get_config("olmo-1b"))
    from torch.distributed.tensor import Replicate, Shard

    got = fl_specs.client_dim_sharding(plan, plan.client_axes, 64)
    assert got.placements == (Shard(0), Shard(0), Replicate())
    got = fl_specs.client_dim_sharding(plan, plan.client_axes, 7)
    assert got.placements == (Replicate(),) * 3


def test_pad_rows_with_first():
    a = np.arange(6).reshape(3, 2)
    np.testing.assert_array_equal(pad_rows_with_first(a, 5)[3:], [a[0], a[0]])
    assert pad_rows_with_first(a, 3) is a
    with pytest.raises(ValueError, match="target_rows"):
        pad_rows_with_first(a, 2)
    with pytest.raises(ValueError, match="empty"):
        pad_rows_with_first(a[:0], 2)


# ---------------------------------------------------------------------------
# a world of one, in this process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world_of_one():
    """The process group ``make_host_mesh`` starts (gloo, one rank),
    destroyed after the module."""
    fresh = not dist.is_initialized()
    mesh = lmesh.make_host_mesh(device="cpu")
    yield mesh
    if fresh and dist.is_initialized():
        dist.destroy_process_group()


def test_host_mesh_and_production_mesh(world_of_one):
    assert world_of_one.mesh_dim_names == ("data", "model")
    assert tuple(world_of_one.shape) == (1, 1)
    assert "gloo" in str(dist.get_backend())
    with pytest.raises(ValueError, match="256 ranks"):
        lmesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="512 ranks"):
        lmesh.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        lmesh.make_host_mesh(data=2, device="cpu")


TINY_LM = get_config("olmo-1b").reduced(vocab_size=256, d_ff=512)


def _lm_trainer(backend, **kw):
    model = LM(TINY_LM, device="cpu")
    data = build_lm_federated_data(
        num_clients=4, server_fraction=0.25,
        spec=TokenSpec(vocab_size=256, num_topics=8, seq_len=17,
                       num_sequences=45))
    fl = feddumap_config(num_clients=4, clients_per_round=2, batch_size=4,
                         server_batch_size=4, local_epochs=1, lr=3e-3,
                         lr_decay=1.0, masked_compute="kernel",
                         fedap=FedAPConfig(align=128, min_rate=0.5,
                                           probe_size=4, participants=2),
                         **kw)
    return model, FederatedTrainer(model, data, fl, device="cpu",
                                   backend=backend)


def test_world_of_one_is_bitwise_the_local_backend(world_of_one):
    """FedDUMAP, kernel mode, a mask prune at round 1 then a shrink to the
    same decision at 2: history and final state bitwise the local run's,
    and the mask injection keeps every state tensor's storage."""
    model, _ = _lm_trainer("local")
    params = model.init(torch.Generator().manual_seed(0))
    plan = fedap_plan(3, prune_round=1, mode="mask", shrink_round=2)
    runs = {}
    for backend in ("local", "mesh"):
        runs[backend] = _lm_trainer(backend)[1].run(plan, params=params)
    a, b = runs["local"], runs["mesh"]
    assert a.history["loss"] == b.history["loss"]
    assert a.history["acc"] == b.history["acc"]
    assert a.history["tau_eff"] == b.history["tau_eff"]
    assert a.artifacts["prune"]["kept_counts"] == \
        b.artifacts["prune"]["kept_counts"]
    for x, y in zip(tree_leaves(a.state), tree_leaves(b.state)):
        assert torch.equal(x, y)

    _, trainer = _lm_trainer("mesh")
    be = trainer.backend(use_masks=True)
    state = be.init_state(params)
    be.run_rounds(state, 0, 1)
    ptrs = [t.data_ptr() for t in tree_leaves(state)]
    kept = be.prune_decision(state, params).kept
    state, _ = be.apply_prune(state, "mask", kept)
    assert [t.data_ptr() for t in tree_leaves(state)] == ptrs
    assert be.reductions > 0 and be.world == 1


def test_mesh_kill_and_resume_is_bitwise(world_of_one, tmp_path):
    model, _ = _lm_trainer("mesh")
    params = model.init(torch.Generator().manual_seed(0))
    def plan(d):
        return TrainPlan(*fedap_plan(4, prune_round=2, mode="mask").events,
                         checkpoint_every=1, checkpoint_dir=str(tmp_path / d))

    whole = _lm_trainer("mesh")[1].run(plan("whole"), params=params)
    _, killed = _lm_trainer("mesh", faults=(KillAfterChunk(2),))
    with pytest.raises(SimulatedCrash):
        killed.run(plan("ckpt"), params=params)
    resumed = _lm_trainer("mesh")[1].resume(tmp_path / "ckpt")
    assert resumed.history["loss"] == whole.history["loss"]
    for x, y in zip(tree_leaves(resumed.state), tree_leaves(whole.state)):
        assert torch.equal(x, y)
    with pytest.raises(CheckpointError, match="'mesh' backend"):
        _lm_trainer("local")[1].resume(tmp_path / "ckpt")
    local_dir = tmp_path / "local"
    _lm_trainer("local")[1].run(TrainPlan(
        *TrainPlan.standard(1).events, checkpoint_every=1,
        checkpoint_dir=str(local_dir)), params=params)
    with pytest.raises(CheckpointError, match="'local' backend"):
        _lm_trainer("mesh")[1].resume(local_dir)


def test_fl_llm_example_runs_on_the_mesh_backend():
    proc = subprocess.run(
        [sys.executable, str(W.__file__).replace(
            "tests/_torch_mesh_worker.py", "examples/fl_llm_train_torch.py"),
         "--backend", "mesh", "--scale", "tiny", "--rounds", "2",
         "--prune-round", "1", "--clients", "4", "--device", "cpu"],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(W.__file__).replace(
            "tests/_torch_mesh_worker.py", "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[-1].startswith("FedAP: p*=") and "round   2" in lines[-2]


# ---------------------------------------------------------------------------
# two gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return W.run_world(tmp_path_factory.mktemp("mesh2"), world=2)


def _ref_history(case, clients=4, sbatch=6):
    data, rounds = W.softmax_world(clients, sbatch)
    rounds = W.case_rounds(case, rounds)
    mode, extra, _, guard = W.CASES[case]
    cfg = W.case_config(case, clients, sbatch)
    kw = dict(lr=cfg.lr, lr_decay=cfg.lr_decay, guard=cfg.guard,
              algorithm=cfg.algorithm, **W.MODES[mode])
    if cfg.algorithm == "fedprox":
        kw["fedprox"] = JaxFedProxConfig(mu=cfg.fedprox.mu)
    if cfg.algorithm == "feddyn":
        kw["feddyn"] = JaxFedDynConfig(alpha=cfg.feddyn.alpha)
    if guard:
        f = cfg.faults[0]
        kw["faults"] = (JaxNaNGrad(client=f.client, round=f.round),)
    jcfg = JaxEngineConfig(**kw)
    m = SoftmaxRegression(dim=W.DIM, num_classes=W.CLASSES)
    p0 = {k: v.numpy() for k, v in W.Softmax().init().items()}
    state = ref_engine.ref_init_state(p0, jcfg, num_clients=W.N_TOTAL)
    hist = []
    for b in rounds:
        state, met = ref_engine.ref_round(jcfg, m.np_grad,
                                          m.np_loss_and_acc, state, b)
        hist.append((state["params"], state["server_m"],
                     float(met["tau_eff"])))
    return hist


def _assert_matches_local_and_the_oracle(mesh, case):
    local = W.engine_history(case, "local")
    ref = _ref_history(case)
    for r in range(W.ROUNDS):
        for leg, (p, m, tau) in (("local", local[r]), ("oracle", ref[r])):
            for k in ("w", "b"):
                np.testing.assert_allclose(
                    mesh[r][0][k].numpy(), np.asarray(p[k]), atol=TOL,
                    rtol=0, err_msg=f"{case} params vs {leg}, round {r}")
                np.testing.assert_allclose(
                    mesh[r][1][k].numpy(), np.asarray(m[k]), atol=TOL,
                    rtol=0, err_msg=f"{case} server_m vs {leg}, round {r}")
            assert abs(mesh[r][2] - tau) <= TOL, (case, leg, r)


@pytest.mark.parametrize("case", sorted(W.CASES))
def test_two_ranks_match_local_and_the_oracle(two_ranks, case):
    mesh = two_ranks["cases"][case]
    _assert_matches_local_and_the_oracle(mesh, case)
    if case == "guard":   # the NaN client was scrubbed, the round went on
        assert all(np.isfinite(h[0]["w"].numpy()).all() for h in mesh)


def test_two_ranks_split_the_round(two_ranks):
    rank, world, clients, rows, weight = two_ranks["split"]
    assert (rank, world, clients) == (0, 2, (0, 1))
    assert rows == slice(0, 3) and weight == 0.5


@pytest.mark.parametrize("how", ["moe", "opt"])
def test_two_ranks_whole_server_batches_match_local_and_the_oracle(
        two_ranks, how):
    """The clients split while every rank takes each server batch whole:
    the default for a model flagged ``moe`` (its auxiliary loss is not a
    mean over rows), or asked for with ``shard_server=False``."""
    assert two_ranks["moe_split"] == (0, 2, (0, 1), None, 1.0)
    _assert_matches_local_and_the_oracle(two_ranks["whole_server"][how],
                                         "feddum")


def test_replicated_fallback_is_bitwise_local(two_ranks):
    """C = 3 over 2 ranks does not divide, nor does a server batch of 5:
    every rank runs the whole round, bitwise the local backend."""
    mesh = two_ranks["replicated"]
    local = W.engine_history("feddum", "local", clients=3, sbatch=5)
    for (pm, mm, tm), (pl, ml, tl) in zip(mesh, local):
        for k in pm:
            assert torch.equal(pm[k], pl[k]) and torch.equal(mm[k], ml[k])
        assert tm == tl


def test_sharded_eval_with_an_odd_test_split(two_ranks):
    loss, acc = two_ranks["eval"]
    want_loss, want_acc = W.evaluate("local", 7)
    assert abs(loss - want_loss) <= 1e-6 and abs(acc - want_acc) <= 1e-6


def test_sharded_decision_with_ragged_probes_is_the_host_decision(
        two_ranks, world_of_one):
    model, data, params, init = W.lm_world()
    cfg = FedAPConfig(align=128, min_rate=0.0, probe_size=8, participants=3)
    host = fedap.fedap_decision(model, data, cfg, params, init_params=init,
                                rng=np.random.default_rng(0))
    for got in (two_ranks["decision"], W.sharded_decision(world_of_one),
                W.sharded_decision(None)):
        assert abs(got["p_star"] - host.p_star) <= 1e-6
        assert {k: v.tolist() for k, v in got["kept"].items()} == \
            {k: v.tolist() for k, v in host.kept.items()}


@pytest.mark.parametrize("key", sorted(W.SERVED))
def test_two_ranks_serve_the_mesh_less_tokens(two_ranks, key):
    """``DecodeEngine(mesh=)`` at 2 ranks: each rank decodes its 2 of 4
    slots (a moe model keeps all 4 on both) and every rank returns the
    mesh-less engine's completions, token for token (a reduced olmo-1b
    dense and masked, qwen2-vl-7b fed tokens, arctic-480b)."""
    got = two_ranks["serving"][key]
    want = W.serve(*W.SERVED[key])
    assert got["split"] == ((0, 4) if key == "moe" else (0, 2))
    assert got["same_on_ranks"]
    assert got["done"] == want["done"] and got["steps"] == want["steps"]


def test_two_ranks_round_collectives_equal_the_budget(two_ranks):
    """``analysis.op_lint``'s LM world on the mesh backend at 2 ranks, its
    8 clients' data rank-local: the round's collectives equal
    ``op_budget.json``'s record (3 all-reduces, one per ``_reduce`` call
    and dtype: the selected clients' sizes and label distributions from
    their owners, the FedAvg sum's leaves, the server step's gradient with
    the gate's accuracy; and one reduce-scatter of the rank's clients'
    int32 samples from their owners), and a changed count fails."""
    from repro_torch.analysis import op_lint

    got = two_ranks["mesh_round"]
    assert got == {"c10d.allreduce_": 3, "c10d._reduce_scatter_base_": 1}
    assert op_lint.check_mesh_budget(got) == []
    assert op_lint.check_mesh_budget(dict(got, **{"c10d.allgather_": 1}))

