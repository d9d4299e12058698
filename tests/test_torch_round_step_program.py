"""The round at explicit batches and the mesh round as keyed programs.

* ``FederatedTrainer.round_step`` runs the backend's round program
  (``LocalBackend.step``): 3 rounds of the tiny dense LM world of
  ``test_torch_train.py`` (FedDUMAP, ``masked_compute="kernel"``), fed the
  JAX key chain's draws, within ``TOL`` = 1e-5 a round of the reference's
  jitted ``round_step`` (its compiled ``round_core``), with and without
  the keep-mask slot; one program key over the rounds, every state tensor
  in its storage, each round's metrics tensors of their own.
* ``launch.steps``' ``train_step`` keeps one key over rounds of one batch
  shape (its values are held to JAX in ``test_torch_steps.py``).
* ``MeshBackend`` at 2 spawned gloo ranks (``_torch_mesh_worker.
  program_main``): three softmax cases within 1e-5 a round of the local
  backend and of the reference's float64 oracle, one key each and one
  all-reduce per ``_reduce`` call (the FedAvg sum, each server step, FedDyn's
  rows); the LM world of ``analysis.op_lint`` in kernel mode for 3 rounds
  within 1e-5 of the local backend, its all-reduces a round equal to
  ``op_budget.json``; and ``_reduce`` over two dtypes: sums exact, one
  all-reduce per dtype, the same flat buffers on the second call.

The JAX round runs under ``jax.jit``, compiled once per mask mode.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import _torch_mesh_worker as W
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.core import engine as jax_engine
from repro.core.backend import sim_sample_kw
from repro.core.pruning import FedAPConfig as JaxFedAPConfig
from repro.core.rounds import FederatedTrainer as JaxTrainer
from repro.core.rounds import feddumap_config as jax_feddumap_config
from repro.data.pipeline import build_lm_federated_data as jax_build
from repro.data.synthetic import TokenSpec as JaxTokenSpec
from repro.models.lm import LM as JaxLM
from repro_torch import interop
from repro_torch.analysis import op_lint
from repro_torch.configs.base import ModelConfig
from repro_torch.core import engine
from repro_torch.core.pruning import FedAPConfig
from repro_torch.core.rounds import FederatedTrainer, feddumap_config
from repro_torch.data.pipeline import build_lm_federated_data
from repro_torch.data.synthetic import TokenSpec
from repro_torch.launch import steps
from repro_torch.models.lm import LM
from repro_torch.utils.tree import tree_leaves, tree_map
from test_torch_mesh import _ref_history
from test_torch_steps import DictSoftmax, _softmax_rounds, _torch_batch
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5
ROUNDS = 3
TINY = dict(name="dense-tiny", family="dense", rope="1d", norm="rmsnorm",
            act="silu", param_dtype="float32", remat="none",
            num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
            d_ff=512, vocab_size=2048)
SPEC = dict(vocab_size=2048, num_topics=16, seq_len=17, num_sequences=256)
CFG = dict(num_clients=8, clients_per_round=4, local_epochs=1, batch_size=4,
           server_batch_size=8, lr=3e-3, lr_decay=1.0,
           masked_compute="kernel")
AP = dict(align=128, min_rate=0.5, probe_size=4, participants=2)


@pytest.fixture(scope="module")
def jax_world():
    """The JAX trainer and its model, the key chain's draws and the
    initial params (numpy)."""
    data = jax_build(num_clients=8, spec=JaxTokenSpec(**SPEC))
    cfg = jax_feddumap_config(fedap=JaxFedAPConfig(**AP), **CFG)
    model = JaxLM(JaxModelConfig(**TINY))
    key = jax.random.key(cfg.seed)
    dev, kw = data.device_arrays(), sim_sample_kw(cfg, data)
    draws = []
    for _ in range(ROUNDS):
        key, sub = jax.random.split(key)
        draws.append(jax.tree.map(
            np.asarray, jax_engine.sample_round_batches(sub, dev, **kw)))
    params0 = jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.key(cfg.seed)))
    return {"trainer": JaxTrainer(model, data, cfg), "model": model,
            "draws": draws, "params0": params0}


def _port_trainer():
    data = build_lm_federated_data(num_clients=8, spec=TokenSpec(**SPEC))
    cfg = feddumap_config(fedap=FedAPConfig(**AP), **CFG)
    return FederatedTrainer(LM(ModelConfig(**TINY), device="cpu"), data, cfg,
                            device="cpu")


def _jax_state(world, use_masks: bool):
    jt = world["trainer"]
    eng = dataclasses.replace(jt.engine_config, use_masks=use_masks)
    fm = (world["model"].filter_masks(world["params0"], {})
          if use_masks else None)
    return jax_engine.init_round_state(world["params0"], eng,
                                       filter_masks=fm), eng


@pytest.mark.parametrize("use_masks", [False, True],
                         ids=["plain", "kernel-masks"])
def test_round_step_matches_the_jax_round_step(jax_world, use_masks):
    jt = jax_world["trainer"]
    sj, _ = _jax_state(jax_world, use_masks)
    run = (jt.round_step if not use_masks
           else jt._compiled(use_masks=True).round_core)
    trainer = _port_trainer()
    be = trainer.backend(use_masks=use_masks)
    st = be.init_state(interop.params_from_jax(jax_world["params0"], "cpu"))
    ptrs = [t.data_ptr() for t in tree_leaves(st)]
    metric_ids, kept = set(), []
    for r, batch in enumerate(jax_world["draws"]):
        sj, mj = run(sj, batch)
        st, mt = trainer.round_step(st, batch)
        for what in ("params", "server_m"):
            for g, w in zip(tree_leaves(st[what]),
                            jax.tree.leaves(sj[what])):
                np.testing.assert_allclose(
                    g.numpy(), np.asarray(w), atol=TOL, rtol=0,
                    err_msg=f"round {r}: {what}")
        assert abs(float(mt["tau_eff"]) - float(mj["tau_eff"])) <= TOL
        metric_ids |= {id(v) for v in mt.values()}
        kept.append(mt)     # alive, so no id is reused by a later round
    assert "masks" in st if use_masks else "masks" not in st
    assert be.chunk._cache_size() == 1
    assert [t.data_ptr() for t in tree_leaves(st)] == ptrs
    assert len(metric_ids) == ROUNDS * len(mt)


def test_round_step_is_the_round_program():
    """The explicit batch takes the same program as a sampled round: the
    result of ``round_step`` equals ``round_core`` run eagerly on a copy of
    the state, bitwise."""
    trainer = _port_trainer()
    be = trainer.backend()
    params = trainer.model.init(torch.Generator().manual_seed(0))
    batch = tree_map(torch.clone, be.round_batch(0))
    st, twin = be.init_state(params), be.init_state(params)
    st, met = trainer.round_step(st, batch)
    _, want = engine.round_core(be.eng, be.grad_fn, be.la_fn, twin, batch)
    for a, b in zip(tree_leaves(st), tree_leaves(twin)):
        assert torch.equal(a, b)
    assert torch.equal(met["tau_eff"], want["tau_eff"])


def test_train_step_keeps_one_key_over_rounds():
    run = steps.FLRunConfig(lr=0.08, local_steps=2, server_tau=3,
                            server_batch=5)
    init, step = steps.make_fl_train_step(None, run, 3, model=DictSoftmax())
    state = init(torch.Generator())
    ptrs = [t.data_ptr() for t in tree_leaves(state)]
    taus = []
    for b in _softmax_rounds():
        state, tau = step(state, _torch_batch(b))
        taus.append(tau)
    assert step.program._cache_size() == 1
    assert [t.data_ptr() for t in tree_leaves(state)] == ptrs
    assert len({id(t) for t in taus}) == 3


# ---------------------------------------------------------------------------
# the mesh round program at 2 gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_ranks(tmp_path_factory):
    return W.run_world(tmp_path_factory.mktemp("mesh_program"), world=2,
                       main="program_main")


@pytest.mark.parametrize("case", W.PROGRAM_CASES)
def test_mesh_round_program_matches_local_and_the_oracle(mesh_ranks, case):
    hist, programs = mesh_ranks["cases"][case]
    local = W.engine_history(case, "local")
    ref = _ref_history(case)
    for r in range(W.ROUNDS):
        for leg, (p, m, tau) in (("local", local[r]), ("oracle", ref[r])):
            for k in ("w", "b"):
                np.testing.assert_allclose(
                    hist[r][0][k].numpy(), np.asarray(p[k]), atol=TOL,
                    rtol=0, err_msg=f"{case} params vs {leg}, round {r}")
                np.testing.assert_allclose(
                    hist[r][1][k].numpy(), np.asarray(m[k]), atol=TOL,
                    rtol=0, err_msg=f"{case} server_m vs {leg}, round {r}")
            assert abs(hist[r][2] - tau) <= TOL, (case, leg, r)
    # one all-reduce for the FedAvg sum (the guard's totals ride in its
    # f32 buffer), one per server step, one for FedDyn's new rows
    want = 1 + W.TAU + (case == "feddyn")
    assert programs == {"keys": 1, "reductions": [want] * W.ROUNDS}


def test_mesh_lm_rounds_match_local_at_the_budgeted_collectives(mesh_ranks):
    mesh, keys, reductions = mesh_ranks["lm"]["mesh"]
    local, local_keys, _ = mesh_ranks["lm"]["local"]
    for r, ((pm, tm), (pl, tl)) in enumerate(zip(mesh, local)):
        for a, b in zip(tree_leaves(pm), tree_leaves(pl)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL,
                                       rtol=0, err_msg=f"round {r}")
        assert abs(tm - tl) <= TOL
    per_round = op_lint.load_budget()["mesh_round"]["collectives"]
    assert keys == local_keys == 1
    assert reductions == len(mesh) * per_round["c10d.allreduce_"]


def test_mesh_reduce_packs_one_buffer_per_dtype(mesh_ranks):
    """Rank r holds 1 + r, 2r (bf16) and arange(4) + r: each call sums the
    two ranks exactly, in one all-reduce per dtype, through the same flat
    buffers both times."""
    (first, n1, bufs1), (second, n2, bufs2) = mesh_ranks["reduce"]
    want = [torch.full((3,), 3.0), torch.full((2, 2), 2.0,
                                              dtype=torch.bfloat16),
            2 * torch.arange(4.0) + 1]
    for got, w in zip(first, want):
        assert got.dtype == w.dtype and torch.equal(got, w)
    for got, w in zip(second, want):
        assert torch.equal(got, 2 * w)
    assert (n1, n2) == (2, 4) and bufs1 == bufs2 and len(bufs1) == 2
