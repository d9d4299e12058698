"""The port's programs (``repro_torch.core.programs``) on the CPU.

* ``DecodeEngine`` keeps two programs, admit and wave: after 5 ragged
  requests over 2 slots ``program_counts()`` is ``{"admit": 1, "wave": 1}``
  for dense, masked and shrunk checkpoints, with the completions still
  token for token the JAX engine's.
* ``lower_wave()`` leaves the engine's state, steps and completions as
  they were, and ``analysis.op_lint`` reads its operation record.
* ``LocalBackend.chunk`` (the round program): a mask ``Prune`` keeps its
  count, a shrink adds one; every round leaves each state tensor in its
  storage.
* Graph semantics emulated on the CPU (``fake_graphs``: a capture runs the
  function and puts its inputs back, as a capture executes nothing; a
  replay recomputes into the capture's static outputs; a key runs eagerly
  first, is captured and replayed at its second call): the metrics of n
  rounds are n distinct tensors, the launch counters move by the capture's
  change on every replay and not for the capture itself, a replay under an
  active ``CostCounter`` raises, and ``lower`` captures without touching
  its inputs.
"""
import contextlib
import dataclasses
import gc
import weakref

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.core import pruning_lm as jax_pruning
from repro.models.lm import LM as JaxLM
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import ServeConfig as JaxServeConfig
from repro_torch import interop
from repro_torch.analysis import compile_budget, op_lint
from repro_torch.configs.base import ModelConfig
from repro_torch.core import programs
from repro_torch.core.rounds import FederatedTrainer
from repro_torch.kernels import masked_matmul as k1
from repro_torch.launch.cost import CostCounter
from repro_torch.models.lm import LM
from repro_torch.serving import DecodeEngine, ServeConfig
from repro_torch.utils.tree import tree_leaves, tree_map
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CFG = JaxModelConfig(name="dense-tiny", family="dense", rope="1d",
                     norm="rmsnorm", act="silu", param_dtype="float32",
                     remat="none", num_layers=2, d_model=128, num_heads=4,
                     num_kv_heads=2, d_ff=512, vocab_size=2048)
# the reference compile budget's serving session
SCFG = dict(slots=2, cache_len=12, max_prompt=4, max_new_tokens=4,
            steps_per_wave=4)


def ragged_prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, size=int(rng.integers(1, 5)))
            .astype(np.int32) for _ in range(n)]


@pytest.fixture(scope="module")
def world():
    """JAX model/params/keep decision/masks and their port twins."""
    jmodel = JaxLM(CFG)
    jparams = jmodel.init(jax.random.key(0))
    kept = jmodel.decide_kept(jparams, 0.5)
    jmasks = jmodel.filter_masks(jparams, kept)
    model = LM(ModelConfig.from_dict(CFG.to_dict()), device="cpu")
    params = interop.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    masks = interop.masks_from_jax(jax.tree.map(np.asarray, jmasks), "cpu")
    return jmodel, jparams, kept, jmasks, model, params, masks


def _engines(world, mode):
    """(JAX engine, port engine) over the same ``mode`` checkpoint."""
    jmodel, jparams, kept, jmasks, model, params, masks = world
    if mode == "shrunk":
        jparams = jax_pruning.shrink_ffn_at(jparams, kept["mlp"])
        cfg = dataclasses.replace(CFG, d_ff=int(kept["mlp"].shape[-1]))
        jmodel = JaxLM(cfg)
        model = LM(ModelConfig.from_dict(cfg.to_dict()), device="cpu")
        params = interop.params_from_jax(jax.tree.map(np.asarray, jparams),
                                         "cpu")
    jm = jmasks if mode == "masked" else None
    m = masks if mode == "masked" else None
    return (JaxEngine(jmodel, jparams, JaxServeConfig(**SCFG), masks=jm),
            DecodeEngine(model, params, ServeConfig(**SCFG), masks=m,
                         device="cpu"))


def _same(port_done, jax_done):
    assert [c.uid for c in port_done] == [c.uid for c in jax_done]
    for a, b in zip(port_done, jax_done):
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens))
        assert a.status == b.status


@pytest.mark.parametrize("mode", ["dense", "masked", "shrunk"])
def test_two_programs_across_admissions_tokens_equal_jax(world, mode):
    jeng, eng = _engines(world, mode)
    prompts = ragged_prompts(5)
    want = jeng.run(prompts)
    counts = []
    for p in prompts:
        eng.submit(p)
    done = []
    while eng.pending:
        done.extend(eng.step_wave())
        counts.append(eng.program_counts())
    _same(sorted(done, key=lambda c: c.uid), want)
    assert len(counts) > 2      # slots were reused across waves
    assert all(c == {"admit": 1, "wave": 1} for c in counts)
    assert eng.program_counts() == jeng.program_counts()


def test_lower_wave_changes_nothing_and_op_lint_reads_it(world):
    *_, model, params, masks = world
    prompts = ragged_prompts(5, seed=1)

    def engine():
        eng = DecodeEngine(model, params, ServeConfig(**SCFG), masks=masks,
                           device="cpu")
        for p in prompts:
            eng.submit(p)
        return eng

    twin, eng = engine(), engine()
    done_t, done_e = twin.step_wave(), eng.step_wave()
    before = tree_map(torch.clone, eng._state)
    steps, counts = eng.steps, eng.program_counts()
    low = eng.lower_wave()
    assert low.graph is None            # nothing is captured on the CPU
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(eng._state), tree_leaves(before)))
    assert (eng.steps, eng.program_counts()) == (steps, counts)
    assert op_lint.check_stream("lowered wave", low.ops) == []
    n5 = sum(name == "kernel:decode_attention" for name, _ in low.ops)
    n1 = sum(name == "kernel:masked_matmul" for name, _ in low.ops)
    assert n5 == SCFG["steps_per_wave"] * CFG.num_layers
    assert n1 == 2 * n5         # wi and wg of every layer through K1
    assert low.totals.kernel_calls["decode_attention"] == n5
    done_t += twin.run()
    done_e += eng.run()
    assert len(done_e) == len(prompts)
    _same(sorted(done_e, key=lambda c: c.uid),
          sorted(done_t, key=lambda c: c.uid))


def _cnn_trainer(**over):
    data, cfg = compile_budget.make_world("cnn")
    cfg = dataclasses.replace(cfg, **over)
    model = compile_budget._fresh_model("cnn", "cpu")
    return (FederatedTrainer(model, data, cfg, device="cpu"),
            model.init(torch.Generator().manual_seed(0)))


def _ptrs(state):
    return [t.data_ptr() for t in tree_leaves(state)]


def test_mask_prune_keeps_the_round_program_a_shrink_adds_one():
    tr, params = _cnn_trainer()
    be = tr.backend(use_masks=True)
    state = be.init_state(params)
    ptrs = _ptrs(state)
    state, _ = be.run_rounds(state, 0, 2)
    assert be.chunk._cache_size() == 1 and _ptrs(state) == ptrs
    kept = be.prune_decision(state, params).kept
    state, _ = be.apply_prune(state, "mask", kept)
    assert _ptrs(state) == ptrs
    state, _ = be.run_rounds(state, 2, 1)
    assert be.chunk._cache_size() == 1 and _ptrs(state) == ptrs
    state, _ = be.apply_prune(state, "shrink", kept, compact_existing=True)
    state, _ = be.run_rounds(state, 3, 2)
    assert be.chunk._cache_size() == 2


def test_a_replaced_state_tensor_goes_back_to_its_storage():
    """Communicated momentum makes a new ``global_m`` every round; the
    round program copies it back into the state's tensor."""
    tr, params = _cnn_trainer(local_momentum="communicated")
    be = tr.backend()
    state = be.init_state(params)
    ptrs, gm = _ptrs(state), tree_leaves(state["global_m"])
    state, _ = be.run_rounds(state, 0, 2)
    assert _ptrs(state) == ptrs
    assert all(a is b for a, b in zip(tree_leaves(state["global_m"]), gm))
    assert any(bool(t.abs().sum() > 0) for t in gm)
    assert be.chunk._cache_size() == 1


def test_dropping_an_owner_drops_its_programs_without_the_collector(world):
    """A program holds its owner's method weakly: no reference cycle keeps
    a dropped engine's or backend's captures (and, on the card, their
    memory pools) alive until the cyclic collector runs."""
    *_, model, params, _ = world
    tr, cnn_params = _cnn_trainer()
    gc.disable()
    try:
        eng = DecodeEngine(model, params, ServeConfig(**SCFG), device="cpu")
        be = tr.backend()
        refs = [weakref.ref(p) for p in (eng._wave_program,
                                         eng._admit_program, be.chunk)]
        del eng
        tr._backends.clear()
        del be
        assert [r() for r in refs] == [None, None, None]
    finally:
        gc.enable()


def test_settle_copies_replaced_leaves_back():
    a, b, c = torch.zeros(3), torch.ones(2), torch.zeros(1)
    tree = {"x": a, "y": [b, (c,)]}
    old = tree_leaves(tree)
    tree["x"] = torch.full((3,), 5.0)
    tree["y"][1] = (torch.full((1,), 7.0),)
    out = programs.settle(tree, old)
    assert out is tree and tree["x"] is a and tree["y"][0] is b
    assert tree["y"][1][0] is c
    assert a.tolist() == [5.0] * 3 and c.tolist() == [7.0]


# ---------------------------------------------------------------------------
# graph semantics, emulated on the CPU


class _FakeGraph:
    """A capture's replay: the function recomputed on the captured inputs,
    its results copied into the static outputs."""

    def __init__(self):
        self.fn = self.args = self.out = None

    def replay(self):
        before = programs._counts()     # a replay runs no wrapper
        new = self.fn(*self.args)
        programs._add_counts(b - a for a, b in zip(programs._counts(),
                                                   before))
        tree_map(lambda o, n: o.copy_(n) if isinstance(o, torch.Tensor)
                 else None, self.out, new)


@pytest.fixture
def fake_graphs(monkeypatch):
    """Programs that capture on the CPU: the capture runs the function on
    its inputs and then puts them back (a capture executes nothing), and a
    replay recomputes into the static outputs."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda graph, stream=None: contextlib.nullcontext())
    monkeypatch.setattr(programs, "capture_stream", lambda device: None)
    monkeypatch.setattr(programs.Program, "_on_capture_stream",
                        lambda self, args: self.fn(*args))
    real = programs.Program._capture

    def capture(self, args):
        saved = tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                         else x, args)
        cap = real(self, args)
        tree_map(lambda a, s: a.copy_(s) if isinstance(a, torch.Tensor)
                 else None, args, saved)
        cap.graph.fn, cap.graph.args, cap.graph.out = self.fn, args, cap.out
        return cap

    monkeypatch.setattr(programs.Program, "_capture", capture)

    def capturing(prog):
        prog.capture = True
        return prog

    return capturing


def test_metrics_of_n_rounds_are_distinct_tensors(fake_graphs):
    # 4 of 8 clients a round: each round's selection (and tau_eff) differs
    tr, params = _cnn_trainer(clients_per_round=4)
    be = fake_graphs(tr.backend().chunk) and tr.backend()
    ref = _cnn_trainer(clients_per_round=4)[0].backend()   # an eager twin
    ref.generator = torch.Generator().manual_seed(123)
    be.generator = torch.Generator().manual_seed(123)
    _, want = ref.run_rounds(ref.init_state(params), 0, 3)
    state = be.init_state(params)
    state, mets = be.run_rounds(state, 0, 3)
    assert be.chunk._cache_size() == 1 and be.chunk.replays == 2
    ids = {id(m[k]) for m in mets for k in m}
    assert len(ids) == 3 * len(mets[0])
    assert [{k: float(v) for k, v in m.items()} for m in mets] == \
        [{k: float(v) for k, v in m.items()} for m in want]
    assert len({float(m["tau_eff"]) for m in mets}) == 3


def test_replays_add_the_captured_launches(fake_graphs):
    def fn(x):
        k1.launches += 2        # as two K1 wrappers on the card would
        return {"y": x * 2}

    prog = fake_graphs(programs.Program(fn, name="toy", device="cpu"))
    x = torch.arange(3.0)
    n = k1.launches
    prog(x)                     # the first call runs eagerly
    assert k1.launches == n + 2 and prog.captures == 0
    prog(x)                     # the second captures, then replays
    assert k1.launches == n + 4 and (prog.captures, prog.replays) == (1, 1)
    prog(x)
    assert k1.launches == n + 6 and prog.replays == 2
    assert prog._cache_size() == 1
    prog(torch.arange(3.0))     # another storage: another capture
    assert prog._cache_size() == 2 and k1.launches == n + 8


def test_a_replay_under_a_cost_counter_raises(fake_graphs):
    prog = fake_graphs(programs.Program(lambda x: x + 1, name="toy",
                                        device="cpu"))
    x = torch.ones(2)
    prog(x)
    with CostCounter(), pytest.raises(RuntimeError, match="CostCounter"):
        prog(x)
    with CostCounter(), pytest.raises(RuntimeError, match="CostCounter"):
        prog.lower(x)
    eager = programs.Program(lambda x: x + 1, name="toy", device="cpu")
    with CostCounter() as counter:      # nothing captured: counted
        eager(x)
    assert counter.totals.op_bytes > 0


def test_lower_captures_without_running_on_its_inputs(fake_graphs):
    def fn(x):
        x.add_(1)

    prog = fake_graphs(programs.Program(fn, name="toy", device="cpu"))
    x = torch.zeros(2)
    cap = prog.lower(x)
    assert x.tolist() == [0.0, 0.0] and prog._cache_size() == 1
    assert prog.lower(x) is cap
    prog(x)                     # a replay of the lowered capture
    assert x.tolist() == [1.0, 1.0] and prog.replays == 1
