"""The eval programs: ``core.backend.eval_program``, the one program over a
model's ``loss_and_acc`` that every backend over the model shares (the
reference's ``eval_program``), and the mesh backend's sharded eval at a
gloo world of one, against the JAX model's ``loss_and_acc``.

A SimpleCNN of 8x8x3 images with a 101-row test split (the worker's
``cnn_eval_world``): ``LocalBackend.evaluate`` within 1e-6 of the JAX
model on the whole split; ``MeshBackend`` with ``shard_eval`` True and
False bitwise the local backend's at a world of one; one program per model
across backends, a key per (params, split) that a shrink's new params
renew, the clear hook, the entry gone with its model, no autograd graph.
"""
import gc

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

import _torch_mesh_worker as W
from repro.models import cnn as jax_cnn
from repro_torch import interop
from repro_torch.core import backend as be_mod
from repro_torch.core.rounds import FederatedTrainer, FLConfig
from repro_torch.launch import mesh as lmesh
from repro_torch.utils.tree import tree_leaves
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CFG = FLConfig(num_clients=8, clients_per_round=4, local_epochs=1,
               batch_size=10)


@pytest.fixture(scope="module")
def world():
    """The CNN eval world and the JAX model's (loss, acc) on its split."""
    model, data, params = W.cnn_eval_world()
    jm = jax_cnn.SimpleCNN(num_classes=10, image_shape=(8, 8, 3),
                           channels=(4, 8, 8), fc_width=16)
    pj = jax.tree.map(jnp.asarray, interop.cnn_params_to_numpy(params))
    want = jax.jit(jm.loss_and_acc)(pj, jnp.asarray(data.test_x),
                                    jnp.asarray(data.test_y))
    return model, data, params, tuple(float(v) for v in want)


@pytest.fixture(scope="module")
def world_of_one():
    fresh = not dist.is_initialized()
    mesh = lmesh.make_host_mesh(device="cpu")
    yield mesh
    if fresh and dist.is_initialized():
        dist.destroy_process_group()


def _backend(model, data, backend="local", **opts):
    return FederatedTrainer(model, data, CFG, device="cpu", backend=backend,
                            backend_opts=opts or None).backend()


def test_local_evaluate_matches_jax_through_the_program(world):
    model, data, params, want = world
    be = _backend(model, data)
    prog = be_mod.eval_program(model, "cpu")
    before = prog._cache_size()
    state = be.init_state(params)
    for _ in range(2):
        loss, acc = be.evaluate(state)
        assert abs(float(loss) - want[0]) <= 1e-6
        assert abs(float(acc) - want[1]) <= 1e-6
    assert prog._cache_size() == before + 1   # one key: same params, split


def test_one_eval_program_per_model_across_backends(world, world_of_one):
    model, data, params, _ = world
    progs = set()
    for backend, opts in (("local", {}), ("local", {}),
                          ("mesh", {"shard_eval": False})):
        be = _backend(model, data, backend, **opts)
        be.evaluate(be.init_state(params))
        progs.add(id(be._eval_program() if backend == "mesh"
                     else be_mod.eval_program(model, "cpu")))
    assert progs == {id(be_mod.eval_program(model, "cpu"))}
    other = W.cnn_eval_world()[0]
    assert be_mod.eval_program(other, "cpu") is not \
        be_mod.eval_program(model, "cpu")


def test_mesh_shard_eval_on_and_off_are_bitwise_local(world, world_of_one):
    model, data, params, want = world
    local = _backend(model, data)
    got = {"local": local.evaluate(local.init_state(params))}
    for flag in (True, False):
        be = _backend(model, data, "mesh", shard_eval=flag)
        assert be.shard_eval is flag and be.world == 1
        got[flag] = be.evaluate(be.init_state(params))
        # the sharded program is the mesh's own, with its all-reduce
        assert (be._eval_program() is be_mod.eval_program(model, "cpu")) \
            is not flag
    for k in (True, False):
        assert all(torch.equal(a, b) for a, b in zip(got[k], got["local"]))
    assert abs(float(got[True][0]) - want[0]) <= 1e-6


def test_a_shrink_makes_a_new_key(world):
    model, data, params, _ = world
    be = _backend(model, data)
    prog = be_mod.eval_program(model, "cpu")
    state = be.init_state(params)
    be.evaluate(state)
    n = prog._cache_size()
    be.evaluate(state)
    assert prog._cache_size() == n
    kept = be.prune_decision(state, params).kept
    state, _ = be.apply_prune(state, "shrink", kept)
    loss, _ = be.evaluate(state)
    assert prog._cache_size() == n + 1 and torch.isfinite(loss)


def test_eval_builds_no_graph_and_the_cache_clears(world):
    model, data, params, _ = world
    be = _backend(model, data)
    state = be.init_state(params)
    for p in tree_leaves(state["params"]):
        p.requires_grad_(True)
    loss, acc = be.evaluate(state)
    assert not loss.requires_grad and not acc.requires_grad
    prog = be_mod.eval_program(model, "cpu")
    be_mod.clear_eval_programs()
    assert be_mod.eval_program(model, "cpu") is not prog


def test_the_entry_goes_with_its_model():
    model = W.cnn_eval_world()[0]
    be_mod.eval_program(model, "cpu")
    key = (id(model), "cpu")
    assert key in be_mod._EVAL_PROGRAMS
    del model
    gc.collect()
    assert key not in be_mod._EVAL_PROGRAMS
