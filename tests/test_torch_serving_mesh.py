"""``DecodeEngine(mesh=)``: the slot pool split over a mesh axis, against
the mesh-less port engine and the reference's mesh-less engine.

The reference's own mesh engine fails under the installed jax (ROADMAP R1:
its slot reset raises ``ShardingTypeError``), so the mesh engine is held to
the mesh-less engines token for token, as the reference's
``test_mesh_engine_matches_local`` holds its own:

* a gloo world of one (``make_host_mesh(device="cpu")`` in this process):
  a reduced olmo-1b dense and masked, and a reduced qwen2-vl-7b, each
  against the port's and the reference's mesh-less engines;
* a reduced arctic-480b (moe): every rank keeps every slot (routing couples
  them), and the engine equals the mesh-less one;
* the refusals: a slot count that does not divide over the axis, a mesh
  without the axis.

The two-rank case runs in the one spawn of ``tests/_torch_mesh_worker.py``
(``test_torch_mesh.py::test_two_ranks_serve_the_mesh_less_tokens``).
"""
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jax_get_config
from repro.models.lm import LM as JaxLM
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import ServeConfig as JaxServeConfig
from repro_torch import interop
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as lmesh
from repro_torch.models.lm import LM
from repro_torch.serving import DecodeEngine, ServeConfig
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SCFG = dict(slots=4, cache_len=24, max_prompt=8, max_new_tokens=12,
            steps_per_wave=4)


class FakeMesh:
    """A duck-typed mesh: only ``shape`` is read before the refusal."""

    def __init__(self, shape: dict):
        self.shape = shape


@pytest.fixture(scope="module")
def world_of_one():
    fresh = not dist.is_initialized()
    mesh = lmesh.make_host_mesh(device="cpu")
    yield mesh
    if fresh and dist.is_initialized():
        dist.destroy_process_group()


def _world(arch):
    cfg = jax_get_config(arch).reduced()
    jm = JaxLM(cfg)
    jparams = jax.jit(jm.init)(jax.random.key(0))
    model = LM(ModelConfig.from_dict(cfg.to_dict()), device="cpu")
    params = interop.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     "cpu")
    return cfg, jm, jparams, model, params


@pytest.fixture(scope="module")
def olmo():
    return _world("olmo-1b")


def _prompts(n, vocab, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(1, 9))).astype(np.int32)
            for _ in range(n)]


def _same(got, want):
    assert [c.uid for c in got] == [c.uid for c in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens))
        assert a.status == b.status == "ok"


@pytest.mark.parametrize("mode", ["dense", "masked"])
def test_world_of_one_matches_both_mesh_less_engines(world_of_one, olmo,
                                                     mode):
    cfg, jm, jparams, model, params = olmo
    masks = jmasks = None
    if mode == "masked":
        kept = jm.decide_kept(jparams, 0.5)
        jmasks = jm.filter_masks(jparams, kept)
        masks = interop.masks_from_jax(jax.tree.map(np.asarray, jmasks),
                                       "cpu")
    prompts = _prompts(7, cfg.vocab_size, 3)
    want = JaxEngine(jm, jparams, JaxServeConfig(**SCFG),
                     masks=jmasks).run(prompts)
    local = DecodeEngine(model, params, ServeConfig(**SCFG), masks=masks,
                         device="cpu")
    eng = DecodeEngine(model, params, ServeConfig(**SCFG), masks=masks,
                       mesh=world_of_one, device="cpu")
    assert (eng._lo, eng._n) == (0, SCFG["slots"])
    assert eng._group is not None        # split: the gather runs
    got = eng.run(prompts)
    _same(got, want)
    _same(local.run(prompts), want)
    assert eng.steps == local.steps > 0


def test_world_of_one_vlm_matches_both_mesh_less_engines(world_of_one):
    cfg, jm, jparams, model, params = _world("qwen2-vl-7b")
    prompts = _prompts(6, cfg.vocab_size, 11)
    want = JaxEngine(jm, jparams, JaxServeConfig(**SCFG)).run(prompts)
    _same(DecodeEngine(model, params, ServeConfig(**SCFG), mesh=world_of_one,
                       device="cpu").run(prompts), want)
    _same(DecodeEngine(model, params, ServeConfig(**SCFG),
                       device="cpu").run(prompts), want)


def test_moe_keeps_every_slot_on_every_rank(world_of_one):
    """Routing couples a step's slots, so a moe engine does not split them
    and gathers nothing."""
    from repro_torch.configs import get_config

    cfg = get_config("arctic-480b").reduced()
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    prompts = _prompts(6, cfg.vocab_size, 5)
    eng = DecodeEngine(model, params, ServeConfig(**SCFG), mesh=world_of_one,
                       device="cpu")
    assert (eng._lo, eng._n, eng._group) == (0, SCFG["slots"], None)
    _same(eng.run(prompts),
          DecodeEngine(model, params, ServeConfig(**SCFG),
                       device="cpu").run(prompts))


def test_refusals(olmo):
    _, _, _, model, params = olmo
    with pytest.raises(ValueError, match="must divide over the 3-way"):
        DecodeEngine(model, params, ServeConfig(**SCFG),
                     mesh=FakeMesh({"data": 3, "model": 1}), device="cpu")
    with pytest.raises(ValueError, match="no axis 'rows'"):
        DecodeEngine(model, params, ServeConfig(**SCFG),
                     mesh=FakeMesh({"data": 2, "model": 1}),
                     mesh_axis="rows", device="cpu")
