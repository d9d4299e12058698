"""The mesh backend's data placement: rank-local clients, FedDyn's ``h`` and
test split, one shared device dataset, and the mesh engine's gather inside
its wave, against the port's local backend, the reference's float64 oracle
(``repro.core.ref_engine``) and the reference's ``loss_and_acc``.

The reference's own mesh tests fail under the installed jax (ROADMAP R1),
so these hold its semantics instead.

* Two spawned gloo ranks (``_torch_mesh_worker.data_main``): each rank's
  device dataset holds exactly its 4 of 8 clients and its block of the
  test split; FedDUMAP, FedDyn (``h`` rank-local) and dropout rounds the
  trainer draws, within 1e-5 a round of the local backend and of the
  oracle fed the same draws; 7 clients over 2 ranks (and 3 a round)
  replicated and bitwise local; a SimpleCNN's 101-row test split
  evaluated sharded and with ``shard_eval=False``, within 1e-6 of the JAX
  model's ``loss_and_acc`` on the whole split; a FedDyn run killed after
  its second chunk resumed bitwise, its checkpoint holding the whole
  ``h``; ``DecodeEngine(mesh=)`` with the all-gather in the wave serving
  the mesh-less tokens at ``{"admit": 1, "wave": 1}``; the round's, the
  sharded eval's and the wave's collectives against ``op_budget.json``.
* In this process: a trainer's backends share one dataset, and the data
  cache is refused in ``backend_opts``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_worker as W
from repro.core import ref_engine
from repro.core.engine import EngineConfig as JaxEngineConfig
from repro.core.engine import FedDynConfig as JaxFedDynConfig
from repro.core.ref_engine import SoftmaxRegression
from repro.models import cnn as jax_cnn
from repro_torch import interop
from repro_torch.analysis import op_lint
from repro_torch.core import engine
from repro_torch.core.backend import sim_sample_kw
from repro_torch.core.rounds import FederatedTrainer
from repro_torch.utils.tree import tree_map
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return W.run_world(tmp_path_factory.mktemp("mesh_data"), world=2,
                       timeout=400.0, main="data_main")


def _drawn_batches(case, clients=4, n=W.DATA_N):
    """The rounds the trainer draws, gathered from the whole dataset on
    the CPU: what every rank of the mesh trains on."""
    data = W.data_world(n)
    cfg = W.data_config(case, clients, n)
    kw = sim_sample_kw(cfg, data)
    gen = torch.Generator().manual_seed(cfg.seed)
    d = data.device_arrays("cpu")
    out = []
    for _ in range(W.ROUNDS):
        src = engine.draw_round_indices(gen, num_clients=n, n_k=W.DATA_NK,
                                        n0=W.DATA_N0, **kw)
        b = engine.sample_round_batches(d, *src, **kw)
        out.append(tree_map(lambda t: t.numpy(), b))
    return out


def _oracle(case):
    cfg = W.data_config(case)
    kw = dict(lr=cfg.lr, lr_decay=cfg.lr_decay, algorithm=cfg.algorithm,
              use_server_update=cfg.use_server_update,
              local_momentum=cfg.local_momentum,
              server_momentum=cfg.server_momentum)
    if cfg.algorithm == "feddyn":
        kw["feddyn"] = JaxFedDynConfig(alpha=cfg.feddyn.alpha)
    jcfg = JaxEngineConfig(**kw)
    m = SoftmaxRegression(dim=W.DIM, num_classes=W.CLASSES)
    p0 = {k: v.numpy() for k, v in W.Softmax().init().items()}
    state = ref_engine.ref_init_state(p0, jcfg, num_clients=W.DATA_N)
    hist = []
    for b in _drawn_batches(case):
        b = dict(b, client=tuple(b["client"]), server=tuple(b["server"]))
        state, met = ref_engine.ref_round(jcfg, m.np_grad, m.np_loss_and_acc,
                                          state, b)
        h = (state["client_state"]["per_client"]["h"]
             if cfg.algorithm == "feddyn" else None)
        hist.append((state["params"], state["server_m"],
                     float(met["tau_eff"]), h))
    return hist


def test_each_rank_stores_its_block_of_clients(ranks):
    """8 clients over 2 ranks: each rank's client_x, client_y, sizes and
    client_dists hold exactly its 4 clients; its test split its block of
    the split padded to 10 rows, with row 0 kept beside it."""
    assert ranks["blocks"] == [True, True]
    for case in W.DATA_CASES:
        _, info = ranks["cases"][case]
        assert info["rows"] == {"client_x": 4, "client_y": 4, "sizes": 4,
                                "client_dists": 4, "test_x": 5}
        assert info["keys"] == 1 and info["scatters"] > 0
    assert ranks["cases"]["feddyn"][1]["h_rows"] == 4


@pytest.mark.parametrize("case", sorted(W.DATA_CASES))
def test_rank_local_rounds_match_local_and_the_oracle(ranks, case):
    mesh, _ = ranks["cases"][case]
    local, info = W.data_history(case, "local")
    assert info["rows"]["client_x"] == W.DATA_N
    ref = _oracle(case)
    if case == "dropout":   # the draws drop some clients, not all
        acts = [b["active"] for b in _drawn_batches(case)]
        assert 0 < sum(a.sum() for a in acts) < W.ROUNDS * 4
    for r in range(W.ROUNDS):
        for leg, (p, m, tau, h) in (("local", local[r]), ("oracle", ref[r])):
            for k in ("w", "b"):
                np.testing.assert_allclose(
                    mesh[r][0][k].numpy(), np.asarray(p[k]), atol=TOL,
                    rtol=0, err_msg=f"{case} params vs {leg}, round {r}")
                np.testing.assert_allclose(
                    mesh[r][1][k].numpy(), np.asarray(m[k]), atol=TOL,
                    rtol=0, err_msg=f"{case} server_m vs {leg}, round {r}")
                if h is not None:   # FedDyn's whole h, gathered
                    np.testing.assert_allclose(
                        mesh[r][3][k].numpy(), np.asarray(h[k]), atol=TOL,
                        rtol=0, err_msg=f"{case} h vs {leg}, round {r}")
            assert abs(mesh[r][2] - tau) <= TOL, (case, leg, r)


def test_clients_that_do_not_divide_stay_replicated_and_bitwise(ranks):
    """7 clients over 2 ranks: every rank stores all of them and fetches
    nothing; with 3 a round and server batches of 5 (no split either) the
    run is bitwise local."""
    mesh, info = ranks["replicated"]
    local, _ = W.data_history("feddumap", "local", clients=3, n=7, sbatch=5)
    assert info["rows"]["client_x"] == 7 and info["scatters"] == 0
    for (pm, mm, tm, _), (pl, ml, tl, _) in zip(mesh, local):
        for k in pm:
            assert torch.equal(pm[k], pl[k]) and torch.equal(mm[k], ml[k])
        assert tm == tl


def _jax_eval():
    model, data, params = W.cnn_eval_world()
    jm = jax_cnn.SimpleCNN(num_classes=10, image_shape=(8, 8, 3),
                           channels=(4, 8, 8), fc_width=16)
    pj = jax.tree.map(jnp.asarray, interop.cnn_params_to_numpy(params))
    loss, acc = jax.jit(jm.loss_and_acc)(pj, jnp.asarray(data.test_x),
                                         jnp.asarray(data.test_y))
    return float(loss), float(acc)


@pytest.mark.parametrize("how", ["sharded", "whole"])
def test_eval_of_an_odd_test_split_matches_jax(ranks, how):
    """101 test rows over 2 ranks: sharded (51 a rank, one row-0 copy
    subtracted back out) and ``shard_eval=False`` (every rank the whole
    split) both within 1e-6 of the JAX model on the whole split, twice
    over the same params (the second Eval is the program's second call)."""
    want = _jax_eval()
    got = ranks["eval"][how]
    assert len(got) == 2 and got[0] == got[1]
    for g, w in zip(got[0], want):
        assert abs(g - w) <= 1e-6, (how, got, want)
    assert ranks["eval"]["blocks"] == [True, True]


def test_killed_feddyn_run_resumes_bitwise_with_the_whole_h(ranks):
    got = ranks["resume"]
    assert got["crashed"] and got["same"]
    assert got["h_rows"] == {"w": W.DATA_N, "b": W.DATA_N}
    assert got["h_equal"]


def test_mesh_engine_gathers_inside_its_wave(ranks):
    """The 2-rank engine (2 of 4 slots a rank) returns the mesh-less
    engine's completions with one program each for admit and wave, and
    its wave records exactly one all-gather."""
    got = ranks["engine"]
    want = W.serve("olmo-1b", False)
    assert got["done"] == want["done"]
    assert got["programs"] == {"admit": 1, "wave": 1}
    assert got["wave"] == ["c10d._allgather_base_"]


def test_mesh_programs_equal_the_budget(ranks):
    got = ranks["budget"]
    assert got["mesh_eval"] == {"c10d.allreduce_": 1}
    assert got["mesh_wave"] == {"c10d._allgather_base_": 1}
    for program in op_lint.MESH_PROGRAMS:
        assert op_lint.check_mesh_budget(got[program],
                                         program=program) == []
    assert op_lint.check_mesh_budget({"c10d.allreduce_": 2},
                                     program="mesh_eval")


def test_trainer_backends_share_one_dataset():
    """Both mask modes and a backend on injected batches read the same
    device tensors."""
    trainer = FederatedTrainer(W.Softmax(), W.data_world(),
                               W.data_config("feddumap"), device="cpu")
    plain = trainer.backend(use_masks=False)
    masked = trainer.backend(use_masks=True)
    injected = trainer.backend(batches=lambda t: None)
    assert plain is not masked
    ptrs = {be.device_data()["client_x"].data_ptr()
            for be in (plain, masked, injected)}
    assert len(ptrs) == 1


@pytest.mark.parametrize("key", ["data_cache", "mesh", "use_masks"])
def test_backend_opts_refuse_trainer_managed_arguments(key):
    with pytest.raises(ValueError, match="trainer-managed"):
        FederatedTrainer(W.Softmax(), W.data_world(),
                         W.data_config("feddumap"), device="cpu",
                         backend="mesh", backend_opts={key: {}})
