"""The port's program budget (``repro_torch.analysis.compile_budget``)
against its JSON and against the reference's.

All 23 of the reference's scenarios run on the CPU (the mesh ones on an
in-process gloo world of one, destroyed after them), and every count and
per-event timeline equals ``src/repro_torch/analysis/compile_budget.json``.
That JSON equals the reference's ``src/repro/analysis/compile_budget.json``
scenario for scenario, except where an entry records the reference's count
(``reference_programs``) and says why in its ``note``:
``*/two_chunk_lengths``, 1 program against 2.
"""
import json
import pathlib

import pytest
import torch.distributed as dist

from repro_torch.analysis import compile_budget
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

REFERENCE = (pathlib.Path(__file__).resolve().parents[1]
             / "src/repro/analysis/compile_budget.json")


def _scenarios(budget):
    return budget["scenarios"]


def test_every_scenario_within_budget_and_timelines_equal_the_json():
    results = compile_budget._run_all(compile_budget.scenarios(), None,
                                      "cpu")
    assert not dist.is_initialized()    # the gloo world of one is gone
    budget = _scenarios(compile_budget.load_budget())
    assert [r.name for r in results] == list(budget)
    for r in results:
        entry = budget[r.name]
        assert r.programs == entry["programs"], r.name
        assert [f"{ev}={n}" for ev, n in r.timeline] == entry["timeline"], \
            r.name


def test_the_json_equals_the_reference_but_for_noted_differences():
    port = _scenarios(compile_budget.load_budget())
    ref = _scenarios(json.loads(REFERENCE.read_text()))
    assert set(port) == set(ref) and len(port) == 23
    differ = []
    for name, want in ref.items():
        got = port[name]
        if "reference_programs" in got:
            differ.append(name)
            assert got["reference_programs"] == want["programs"] \
                != got["programs"], name
            assert "reference" in got["note"], name
        else:
            assert got["programs"] == want["programs"], name
            assert got["timeline"] == want["timeline"], name
    assert sorted(differ) == ["local/two_chunk_lengths",
                              "mesh/two_chunk_lengths"]
    assert all(port[n]["programs"] == 1 for n in differ)


def test_check_names_the_event_that_exceeded_the_budget():
    [sc] = [s for s in compile_budget.scenarios()
            if s.name == "local/prune_shrink"]
    budget = {"scenarios": {sc.name: {"programs": 1}}}
    [err] = compile_budget.check(budget, [sc])
    assert "2 program(s), budget says 1" in err
    assert "first exceeded after event#3:Scan(rounds=2)" in err
    assert compile_budget.expected_programs(sc.name) == 2
    missing = compile_budget.check({"scenarios": {}}, [sc])
    assert missing and "missing from compile_budget.json" in missing[0]


@pytest.mark.parametrize("kind", ["cnn", "lm"])
def test_worlds_are_the_references(kind):
    data, cfg = compile_budget.make_world(kind)
    assert data.client_x.shape[0] == 8 and cfg.num_clients == 8
    model = compile_budget._fresh_model(kind, "cpu")
    if kind == "lm":
        c = model.cfg
        assert (c.num_layers, c.d_model, c.d_ff) == (2, 128, 512)
        assert cfg.clients_per_round == 4
    else:
        assert cfg.clients_per_round == 8 and cfg.batch_size == 10
