"""Tensor parallelism over the ``model`` mesh axis (``repro_torch.sharding.
tp``, ``LM.shard``, the ``mesh=`` steps of ``launch.steps``) against the
JAX package's pod-scale steps, which run the whole model.

The model is a small dense LM in f32 (2 layers, d_model 256, head_dim 64,
d_ff 512, vocab 512) in two head layouts: H 4 over KV 2 (olmo-1b's: the kv
heads split over a 2-way model axis, each rank holding every query group
of its kv head) and H 4 over KV 1 (chatglm3-6b's: the kv head whole on
every rank, each rank holding its block of query groups).  The JAX init's
params reach each rank's block through ``interop.shard_params_from_jax``.

* Shard then gather is the identity: every dense arch's ``param_shapes()``
  on the meta device at 2, 4 and 16 model ranks (each rank's bytes equal to
  ``dryrun.sharded_bytes``), and the test models' values; the ranks are
  threads of this process (``sharding.tp.ThreadGroup``).
* Two gloo ranks on a ``(1, 2)`` mesh (one spawn, ``_torch_mesh_worker.
  tp_main``): the prefill step's logits within 1e-5 of the JAX step's and
  8 greedy decode tokens equal (logits within 1e-5); two kernel-mode
  FedDUMAP train steps with a FedAP mask injected between them within
  1e-5 a step, tau_eff within 1e-6 (the gate's accuracy is equal); the
  sharded FedAP decision and its masks equal to the unsharded ones; a NaN
  planted in one rank's block of one client's model rejected on both
  ranks, the round within 1e-5 of the JAX round that rejects that client.
* Four gloo ranks on a ``(2, 2)`` mesh: one step within 1e-5 of JAX, its
  clients and server rows split over ``data``.
* A world of one (gloo, in this process): the sharded steps bitwise the
  unsharded ones.
* The dry run: olmo-1b's three shapes on 16 x 16 record the collectives
  the design gives (formulas below), and none on a world of one.
* A non-dense family on a wider ``model`` axis, an FSDP axis wider than
  one, and a head split short of the [g, kv] grouping, each raise.
* The tensor-parallel programs' collectives equal ``op_budget.json``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jax_get_config
from repro.configs.base import InputShape as JaxInputShape
from repro.core import engine as jengine
from repro.core import pruning_lm as jpruning
from repro.launch import steps as jsteps
from repro.models import api as japi
from repro.reliability.faults import NaNGrad
from repro_torch.analysis import op_lint
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import INPUT_SHAPES, InputShape
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.api import build_model
from repro_torch.models.lm import LM
from repro_torch.sharding import specs
from repro_torch.sharding.tp import ThreadGroup
from repro_torch.utils.tree import tree_leaves
import _torch_mesh_worker as W
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5          # f32 against JAX, absolute, a leaf or a logit
TAU_TOL = 1e-6      # tau_eff against JAX (the gate's accuracy is equal)
CASES = tuple(W.TP_CASES)


def _np(t):
    return np.asarray(t.detach().cpu())


def _close(got, want, what=""):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w), what
    for a, b in zip(g, w):
        np.testing.assert_allclose(_np(a), np.asarray(b, np.float32),
                                   atol=TOL, rtol=0, err_msg=what)


def _jax_cfg(case):
    arch, h, kv = W.TP_CASES[case]
    return jax_get_config(arch).reduced(num_heads=h, num_kv_heads=kv,
                                        d_ff=512)


_JAX_STEPS: dict = {}


def _jax_step(cfg, run, *, faults=()):
    """The reference's ``make_fl_train_step`` wiring with device faults in
    its engine config (``jsteps.make_fl_train_step`` takes none), jitted
    once per (config, run, faults)."""
    key = (cfg, run, faults)
    if key not in _JAX_STEPS:
        _JAX_STEPS[key] = _make_jax_step(cfg, run, faults)
    return _JAX_STEPS[key]


def _make_jax_step(cfg, run, faults):
    model = japi.build_model(cfg)
    eng = dataclasses.replace(jsteps.engine_config(run), faults=faults)

    def loss_fn(p, b, fm):
        return model.loss(p, b) if fm is None else model.loss(p, b, masks=fm)

    def la_base(p, b, fm):
        return jsteps.loss_and_accuracy(model, p, b, masks=fm)

    grad_fn, la_fn = jengine.build_model_fns(eng, loss_fn, la_base)

    def step(state, batch):
        state, met = jengine.round_core(eng, grad_fn, la_fn, state, batch)
        return state, met

    return model, eng, jax.jit(step)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX params and tokens, both spawns' results and the JAX runs."""
    tmp = tmp_path_factory.mktemp("tp")
    inputs = {"tokens": np.random.default_rng(0).integers(
        0, 512, (2, W.TP_SEQ)).astype(np.int64)}
    jparams = {}
    for i, case in enumerate(CASES):
        model = japi.build_model(_jax_cfg(case))
        jparams[case] = jax.jit(model.init)(jax.random.key(11 + i))
        inputs[case] = {"params": jax.tree.map(np.asarray, jparams[case])}
    torch.save(inputs, tmp / "tp_inputs.pt")
    two = W.run_world(tmp, world=2, main="tp_main")
    four = W.run_world(tmp, world=4, main="tp4_main")
    return inputs, jparams, two, four


def _jax_train(case, pj, kept=None):
    """The JAX rounds of ``tp_train``: round 0, then ``kept`` injected and
    round 1; (params and tau_eff of each round)."""
    cfg = _jax_cfg(case)
    run = jsteps.FLRunConfig(**W.TP_RUN)
    model, eng, step = _jax_step(cfg, run)
    state = jengine.init_round_state(pj, eng,
                                     filter_masks=model.filter_masks(pj, {}),
                                     num_clients=W.TP_CLIENTS)
    batch = jsteps.fl_batch_specs(cfg, JaxInputShape(*W.TP_SHAPES["train"]),
                                  W.TP_CLIENTS, run, abstract=False, seed=4)
    out = []
    for r in range(1 if kept is None else 2):
        if r == 1:
            state = jsteps.with_masks(
                state, model.param_masks(state["params"], kept),
                model.filter_masks(state["params"], kept))
        state, met = step(state, batch)
        out.append((state["params"], float(met["tau_eff"])))
    return out


@pytest.mark.parametrize("case", CASES)
def test_prefill_and_greedy_decode_match_jax(world, case):
    inputs, jparams, two, _ = world
    got = two[case]["serve"]
    cfg = _jax_cfg(case)
    pj = jparams[case]
    tokens = jnp.asarray(inputs["tokens"], jnp.int32)
    _, prefill = jsteps.make_prefill_step(cfg)
    np.testing.assert_allclose(_np(got["prefill"]),
                               np.asarray(prefill(pj, {"tokens": tokens})),
                               atol=TOL, rtol=0)
    model, decode = jsteps.make_decode_step(cfg)
    decode = jax.jit(decode)
    cache = model.init_cache(2, W.TP_SEQ)
    tok = tokens[:, :1]
    for i in range(W.TP_DECODE):
        logits, cache = decode(pj, cache, {"tokens": tok})
        np.testing.assert_allclose(_np(got["logits"][i]),
                                   np.asarray(logits[:, -1]), atol=TOL,
                                   rtol=0, err_msg=f"step {i}")
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        assert np.array_equal(_np(got["tokens"][i]), np.asarray(tok[:, 0])), \
            f"greedy token of step {i}"


@pytest.mark.parametrize("case", CASES)
def test_two_kernel_mode_steps_match_jax(world, case):
    """Round 0, the sharded FedAP decision injected with ``with_masks``,
    round 1: each within 1e-5 of the JAX step's, tau_eff within 1e-6."""
    _, jparams, two, _ = world
    got = two[case]["train"]
    want = _jax_train(case, jparams[case], {"mlp": got["kept"][0]})
    for r, (params, tau) in enumerate(want):
        _close(got["params"][r], params, what=f"{case} round {r}")
        assert abs(got["tau"][r] - tau) <= TAU_TOL
        assert got["health"][r] == [0.0, 0.0]
    assert got["shard"] == (None, False, 1.0)       # one client group


@pytest.mark.parametrize("case", CASES)
def test_sharded_fedap_decision_is_the_unsharded_one(world, case):
    """The decision from the ranks' blocks (scores gathered over the model
    group) equals the unsharded one on the gathered params and the
    reference's; its param and filter masks are the whole masks' blocks."""
    _, _, two, _ = world
    got = two[case]["train"]
    mine, plain = got["kept"]
    assert np.array_equal(mine, plain)
    assert mine.shape[1] == 256                     # 0.5 of 512, aligned
    whole = got["params"][0]
    jkept = jpruning.ffn_kept_indices(
        jax.tree.map(lambda t: jnp.asarray(_np(t)), whole), _jax_cfg(case),
        0.5)
    assert np.array_equal(np.asarray(jkept), mine)
    for a, b in zip(tree_leaves(got["masks"][0]), tree_leaves(got["masks"][1])):
        assert torch.equal(a, b)
    assert torch.equal(*got["filter_masks"])


@pytest.mark.parametrize("case", CASES)
def test_nan_in_one_rank_block_is_rejected_on_both_ranks(world, case):
    """``guard="reject_client"``: client 0's model NaN in model rank 0's
    block only.  Both ranks reject it (health 1 on each), and the round is
    the JAX round with that client's whole model NaN."""
    inputs, jparams, two, _ = world
    got = two[case]["guard"]
    assert got["health"] == [[1.0, 1.0]]
    cfg = _jax_cfg(case)
    run = jsteps.FLRunConfig(**dict(W.TP_RUN, use_masks=False,
                                    masked_compute="params",
                                    guard="reject_client"))
    _, eng, step = _jax_step(cfg, run, faults=(NaNGrad(client=0, round=0),))
    state = jengine.init_round_state(jparams[case], eng,
                                     num_clients=W.TP_CLIENTS)
    batch = jsteps.fl_batch_specs(cfg, JaxInputShape(*W.TP_SHAPES["train"]),
                                  W.TP_CLIENTS, run, abstract=False, seed=4)
    state, met = step(state, batch)
    assert float(met["health"]) == 1.0
    _close(got["params"][0], state["params"], what=f"{case} guarded round")
    assert abs(got["tau"][0] - float(met["tau_eff"])) <= TAU_TOL


@pytest.mark.parametrize("case", CASES)
def test_four_ranks_on_a_2x2_mesh_match_jax(world, case):
    """Clients and each server step's rows split over ``data`` (one of
    each a rank), the model over ``model``: one step within 1e-5."""
    _, jparams, _, four = world
    got = four[case]
    [(params, tau)] = _jax_train(case, jparams[case])
    _close(got["params"][0], params, what=f"{case} on (2, 2)")
    assert abs(got["tau"][0] - tau) <= TAU_TOL
    assert got["health"][0] == [0.0] * 4
    assert got["shard"] == ((0,), True, 0.5)        # rank 0's block


def test_tensor_parallel_programs_equal_the_budget(world):
    got = world[2]["collectives"]
    assert got.pop("lint") == []
    for program in op_lint.TP_PROGRAMS:
        assert op_lint.check_mesh_budget(got[program],
                                         program=program) == []


# ---------------------------------------------------------------------------
# shard and gather, by threads of this process

DENSE = tuple(a for a in ARCH_NAMES if get_config(a).family == "dense")


def _mesh(m):
    return dryrun.ShapeMesh({"data": 1, "model": m})


def _rank_models(cfg, m, device="cpu"):
    plan = specs.make_plan(_mesh(m), cfg)
    whole = LM(cfg, device=device)
    return plan, [whole.shard(plan, {"data": 0, "model": r}, g)
                  for r, g in enumerate(ThreadGroup.ranks(m))]


def _round_trip(cfg, m, tree):
    """Each rank's block of ``tree`` and the tree gathered back, per rank."""
    plan, models = _rank_models(cfg, m)
    kv = cfg.padded_num_kv_heads

    def rank(model):
        axes = model.axes()
        mine = specs.shard_tree(tree, model.block_specs(), plan,
                                model._coords, axes=axes, kv_heads=kv)
        back = specs.gather_tree(mine, model.block_specs(), plan,
                                 {"model": model.tp.group}, axes=axes,
                                 kv_heads=kv)
        return mine, back

    return plan, models, ThreadGroup.run([lambda md=md: rank(md)
                                          for md in models])


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("m", [2, 4, 16])
def test_shard_then_gather_is_the_identity_on_the_meta_device(arch, m):
    cfg = get_config(arch)
    if arch == "deepseek-67b" and m == 16:
        # 64 heads over 16 ranks with its 8 kv heads whole: 4 query heads
        # a rank cannot hold every group of a kv head
        with pytest.raises(ValueError, match=r"\[g, kv\] grouping"):
            _rank_models(cfg, m)
        return
    whole = LM(cfg, device="cpu").param_shapes()
    plan, models, got = _round_trip(cfg, m, whole)
    spec = models[0].block_specs()
    want = dryrun.sharded_bytes(whole, spec, plan)
    for model, (mine, back) in zip(models, got):
        assert sum(t.numel() * t.element_size()
                   for t in tree_leaves(mine)) == want
        assert [tuple(t.shape) for t in tree_leaves(mine)] == \
            [tuple(t.shape) for t in tree_leaves(model.param_shapes())]
        assert [tuple(t.shape) for t in tree_leaves(back)] == \
            [tuple(t.shape) for t in tree_leaves(whole)]


@pytest.mark.parametrize("case,m", [("kv_split", 2), ("kv_whole", 2),
                                    ("kv_whole", 4)])
def test_shard_then_gather_is_the_identity_on_values(case, m):
    cfg = W.tp_config(case)
    whole = LM(cfg, device="cpu").init(torch.Generator().manual_seed(5))
    _, models, got = _round_trip(cfg, m, whole)
    for mine, back in got:
        for a, b in zip(tree_leaves(back), tree_leaves(whole)):
            assert torch.equal(a, b)
    # the kv-split layout holds, per rank, every query group of its kv head
    lay = models[1].tp
    if case == "kv_split" and m == 2:
        assert lay.kv and lay.kv_heads == 1
        mine = got[1][0]["layers"]["attn"]["wq"]
        assert torch.equal(mine, whole["layers"]["attn"]["wq"][:, :, [1, 3]])


# ---------------------------------------------------------------------------
# a world of one: bitwise the unsharded steps


@pytest.fixture(scope="module")
def one_rank():
    started = not dist.is_initialized()
    mesh = make_host_mesh(device="cpu")
    yield mesh
    if started:
        dist.destroy_process_group()


@pytest.mark.parametrize("case", CASES)
def test_world_of_one_is_bitwise_the_unsharded_steps(one_rank, case):
    cfg = W.tp_config(case)
    run = steps.FLRunConfig(**W.TP_RUN)
    shape = InputShape(*W.TP_SHAPES["train"])
    batch = steps.fl_batch_specs(cfg, shape, W.TP_CLIENTS, run,
                                 abstract=False, seed=4, device="cpu")
    states, taus = [], []
    for mesh in (None, one_rank):
        init, step = steps.make_fl_train_step(cfg, run, W.TP_CLIENTS,
                                              device="cpu", mesh=mesh)
        model = build_model(cfg, device="cpu", mesh=mesh)
        params = model.init(torch.Generator().manual_seed(1))
        state = init(torch.Generator().manual_seed(1),
                     filter_masks=model.filter_masks(params, {}))
        got = []
        for r in range(3):
            if r == 1:
                kept = model.decide_kept(state["params"], 0.5)
                state = steps.with_masks(
                    state, model.param_masks(state["params"], kept),
                    model.filter_masks(state["params"], kept))
            state, tau = step(state, batch)
            got.append(float(tau))
        states.append(state)
        taus.append(got)
        if mesh is not None:
            assert step.program._cache_size() == 1
    assert taus[0] == taus[1]
    for a, b in zip(tree_leaves(states[0]), tree_leaves(states[1])):
        assert torch.equal(a, b)
    params = states[0]["params"]
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, 512, (2, W.TP_SEQ)))
    outs = []
    for mesh in (None, one_rank):
        model, prefill = steps.make_prefill_step(cfg, device="cpu",
                                                 mesh=mesh)
        _, decode = steps.make_decode_step(cfg, device="cpu", mesh=mesh)
        with torch.no_grad():
            got = [prefill(params, {"tokens": tokens})]
            cache = model.init_cache(2, W.TP_SEQ)
            for i in range(W.TP_DECODE):
                logits, cache = decode(params, cache,
                                       {"tokens": tokens[:, i:i + 1]})
                got.append(logits)
        outs.append(got + tree_leaves(cache))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the dry run's collectives


def test_dryrun_records_the_designed_collectives():
    """olmo-1b on 16 x 16, rank 0's part.  Train (bf16, remat "block", one
    client a rank, 2 server rows a rank): a gradient's forward all-reduces
    the embedding, each layer's attention and FFN output and the loss's
    three (1 + 2L + 3), its backward each layer's two inputs and the head's
    (2L + 1) and, recomputing each layer up to its last saved input, each
    attention output again (L); the server step's accuracy two more; the
    client axis sums FedAvg's f32 sum and the server gradient (bf16) with
    the gate's accuracy (f32): (5L + 5) + (5L + 7) + 3.  Prefill and
    decode: 1 + 2L all-reduces, the logits gathered over model and over
    the batch's rows.  A world of one records none."""
    cfg = get_config("olmo-1b")
    L = cfg.num_layers
    want = {"train_4k": {"all-reduce": 10 * L + 15},
            "prefill_32k": {"all-reduce": 1 + 2 * L, "all-gather": 2},
            "decode_32k": {"all-reduce": 1 + 2 * L, "all-gather": 2}}
    for shape, counts in want.items():
        rec = dryrun.dryrun_pair("olmo-1b", shape)
        assert rec["counted"] == "rank 0's part"
        assert rec["collective_counts"] == counts, shape
        assert set(rec["collective_bytes_by_kind"]) == set(counts)
        assert rec["collective_wire_bytes_per_device"] > 0
        got = dryrun.count_step(cfg, INPUT_SHAPES[shape],
                                {"data": 1, "model": 1})
        assert got["rank"]
        assert got["counter"].totals.collective_counts == {}


def test_filter_masks_follow_the_params_in_the_tp_state():
    """``fl_state_specs(filter_axes=)``: the kernel mode's filter masks
    split like the FFN's units (a rank's columns), replicated without it
    as the reference places them."""
    from repro_torch.sharding import fl_specs

    cfg = W.tp_config("kv_split")
    model = build_model(cfg, device="cpu", mesh=_mesh(2))
    state = {"filter_masks": {"mlp": torch.ones((2, 512))}}
    plan = model._plan
    got = fl_specs.fl_state_specs(state, model.axes(), plan,
                                  filter_axes=model.filter_axes())
    assert got["filter_masks"]["mlp"].parts == (None, "model")
    assert fl_specs.fl_state_specs(state, model.axes(), plan)[
        "filter_masks"]["mlp"].parts == ()
    params = model.init(torch.Generator().manual_seed(0))
    assert model.filter_masks(params, {})["mlp"].shape == (2, 256)


def test_refusals():
    with pytest.raises(ValueError, match="dense family"):
        build_model(get_config("arctic-480b"), device="cpu",
                    mesh=_mesh(2))
    with pytest.raises(ValueError, match="FSDP"):
        build_model(get_config("deepseek-67b"), device="cpu",
                    mesh=dryrun.ShapeMesh({"data": 16, "model": 16}))
    rec = dryrun.dryrun_pair("deepseek-67b", "decode_32k")
    assert rec["ok"] and "FSDP" in rec["collectives_pending"]
    # 4 query heads over 4 ranks with their 2 kv heads whole: a rank's one
    # head is not every group of the kv heads it would hold
    with pytest.raises(ValueError, match=r"\[g, kv\] grouping"):
        build_model(W.tp_config("kv_split"), device="cpu", mesh=_mesh(4))
    # (1, m): deepseek-67b runs tensor-parallel only
    model = build_model(get_config("deepseek-67b"), device="cpu",
                        mesh=_mesh(4))
    assert model.tp.kv and model.tp.kv_heads == 2
