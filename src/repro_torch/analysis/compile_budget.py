"""Program-budget sentinel: the port's counterpart of the reference's
``analysis/compile_budget.py``.

The reference compiles one scan-chunk program per distinct (chunk length x
parameter shape) and the serving engine exactly two programs.  The port's
programs are ``core.programs.Program`` objects: on the card a
CUDA graph per key (the state's storages and shapes), on the CPU a count
of keys.  This module runs the reference's canonical plans (Scan / Eval /
Prune mask and shrink / Snapshot, on the local backend and on the mesh
backend, for the CNN and the transformer-LM worlds, with and without the
health guard) and the serving sessions, samples ``LocalBackend.chunk.
_cache_size()`` after every plan event (``DecodeEngine.program_counts()``
after every wave), and diffs the counts against ``compile_budget.json``.
An unexpected capture fails naming the scenario and the event after which
the count jumped.

The counts equal the reference's scenario by scenario, except where the
port's design differs; each such entry in the JSON carries the reference's
count (``reference_programs``) and a ``note`` saying why.  The one today:
``*/two_chunk_lengths`` is 1 program here and 2 in the reference, because
a chunk is a run of captured rounds, so one round graph replays for any
chunk length.  The mesh scenarios run on the process group there is (an
in-process gloo world of one on the CPU, started and destroyed here).

``device="cuda"`` runs the scenarios on the card with real captures, the
mesh ones too: their rounds are captured with the NCCL all-reduces inside
(``MeshBackend``), over the process group of the caller (``chip_smoke.py``
runs them on its mesh phase's NCCL world of one), or a world of one
started here.

Regenerate the baseline after an intended change with::

    PYTHONPATH=src python -m repro_torch.analysis.compile_budget --update
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Callable

BUDGET_PATH = pathlib.Path(__file__).with_name("compile_budget.json")


def load_budget(path: pathlib.Path | str | None = None) -> dict:
    with open(path or BUDGET_PATH) as f:
        return json.load(f)


def expected_programs(scenario: str,
                      path: pathlib.Path | str | None = None) -> int:
    """The budgeted program count of a named scenario."""
    return int(load_budget(path)["scenarios"][scenario]["programs"])


# ---------------------------------------------------------------------------
# canonical worlds and plans (the reference's, scenario for scenario)


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    backend: str                       # "local" | "mesh"
    plan_factory: Callable[[], Any]    # () -> TrainPlan (kind="plan" only)
    masked_compute: str = "params"
    world: str = "cnn"                 # "cnn" | "lm" (make_world kind)
    kind: str = "plan"                 # "plan" | "serving"
    serve_mode: str = "dense"          # serving: dense | masked | shrunk
    guard: str = "off"                 # EngineConfig.guard
    note: str = ""


def _plans():
    from repro_torch.core.plan import Eval, Prune, Scan, Snapshot, TrainPlan

    return {
        # one chunk length, no prune: one program
        "scan_eval": lambda: TrainPlan(
            Eval(), Scan(2), Eval(), Scan(2), Eval()),
        # a mask prune writes into the state's tensors: still one program
        "prune_mask": lambda: TrainPlan(
            Eval(), Scan(2), Eval(), Prune(mode="mask"), Snapshot(),
            Scan(2), Eval()),
        # a shrink makes a state of new shapes: one program more
        "prune_shrink": lambda: TrainPlan(
            Scan(2), Prune(mode="shrink"), Scan(2), Eval()),
        # mask now, compact later: pre- and post-shrink programs
        "mask_then_shrink": lambda: TrainPlan(
            Scan(2), Prune(mode="mask"), Scan(2),
            Prune(mode="shrink", reuse="prune", name="shrink"),
            Scan(2), Eval()),
        # a second chunk length
        "two_chunk_lengths": lambda: TrainPlan(
            Scan(2), Snapshot(), Scan(1), Eval()),
    }


_TWO_LENGTHS = ("a chunk is a run of captured rounds, so one round graph "
                "replays for any chunk length: 1 program where the "
                "reference compiles a scan per length (2)")


def scenarios() -> list[Scenario]:
    out = []
    for backend in ("local", "mesh"):
        for pname, factory in _plans().items():
            note = _TWO_LENGTHS if pname == "two_chunk_lengths" else ""
            out.append(Scenario(f"{backend}/{pname}", backend, factory,
                                note=note))
        out.append(Scenario(f"{backend}/prune_mask_kernel", backend,
                            _plans()["prune_mask"],
                            masked_compute="kernel",
                            note="masked_compute=kernel routes the masked "
                                 "products through the masked_matmul "
                                 "kernels"))
        out.append(Scenario(f"{backend}/lm_prune_mask", backend,
                            _plans()["prune_mask"], world="lm",
                            note="transformer LM; the FFN keep-masks are "
                                 "written into the state's mask tensors"))
        out.append(Scenario(f"{backend}/lm_prune_mask_kernel", backend,
                            _plans()["prune_mask"],
                            masked_compute="kernel", world="lm",
                            note="transformer LM with the masked FFN "
                                 "products through the masked_matmul "
                                 "kernels (K1-K3)"))
    for backend in ("local", "mesh"):
        for guard in ("reject_client", "skip_round"):
            out.append(Scenario(
                f"{backend}/guard_{guard.split('_')[0]}", backend,
                _plans()["scan_eval"], guard=guard,
                note=f"guard={guard!r} health guard on: its checks and the "
                     f"round's discard are device data-flow inside the one "
                     f"round program"))
    for mode in ("dense", "masked", "shrunk"):
        out.append(Scenario(
            f"serving/decode_{mode}", "local", None, world="lm",
            kind="serving", serve_mode=mode,
            note=f"DecodeEngine over a {mode} checkpoint: admit + wave "
                 f"programs, none added across admission waves"))
    return out


def make_world(kind: str = "cnn"):
    """``(data, cfg)`` of the canonical tiny world for ``kind``: ``"cnn"``,
    8 clients of 8x8x3 synthetic images (a (4, 8, 8)-channel SimpleCNN);
    ``"lm"``, 8 clients of topic-sharded 16-token sequences (a 2-layer d 128
    transformer with a 128-aligned d_ff 512 FFN)."""
    from repro_torch.core.pruning import FedAPConfig
    from repro_torch.core.rounds import feddumap_config

    if kind == "lm":
        from repro_torch.data.pipeline import build_lm_federated_data
        from repro_torch.data.synthetic import TokenSpec

        data = build_lm_federated_data(
            num_clients=8,
            spec=TokenSpec(vocab_size=2048, num_topics=16, seq_len=17,
                           num_sequences=256))
        apcfg = FedAPConfig(prune_round=2, align=128, probe_size=4,
                            participants=2, min_rate=0.5)
        cfg = feddumap_config(num_clients=8, clients_per_round=4,
                              local_epochs=1, batch_size=4,
                              server_batch_size=8, lr=3e-3, lr_decay=1.0,
                              fedap=apcfg)
        return data, cfg
    if kind != "cnn":
        raise ValueError(f"unknown world kind {kind!r}")
    from repro_torch.data.pipeline import build_federated_data
    from repro_torch.data.synthetic import SyntheticSpec

    spec = SyntheticSpec(num_classes=10, image_shape=(8, 8, 3),
                         train_size=1700, test_size=100, noise_scale=0.5)
    data = build_federated_data(num_clients=8, server_fraction=0.1,
                                device_pool=640, spec=spec)
    apcfg = FedAPConfig(prune_round=2, probe_size=8, participants=7,
                        min_rate=0.5)
    cfg = feddumap_config(num_clients=8, clients_per_round=8, local_epochs=1,
                          batch_size=10, lr=0.05, fedap=apcfg)
    return data, cfg


def _fresh_model(kind: str, device):
    """A new model per scenario (a new trainer, backend and programs)."""
    if kind == "lm":
        from repro_torch.configs.base import ModelConfig
        from repro_torch.models.lm import LM

        return LM(ModelConfig(name="dense-tiny", family="dense", rope="1d",
                              norm="rmsnorm", act="silu",
                              param_dtype="float32", remat="none",
                              num_layers=2, d_model=128, num_heads=4,
                              num_kv_heads=2, d_ff=512, vocab_size=2048),
                  device=device)
    from repro_torch.models.cnn import SimpleCNN

    return SimpleCNN(num_classes=10, image_shape=(8, 8, 3),
                     channels=(4, 8, 8), fc_width=16, device=device)


# ---------------------------------------------------------------------------
# recording execution


class _RecordingBackend:
    """A delegating backend that samples the round program's count after
    every plan event."""

    def __init__(self, inner):
        self._inner = inner
        self.timeline: list[tuple[str, int]] = []
        self._n = 0

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _record(self, label: str):
        self._n += 1
        self.timeline.append((f"event#{self._n}:{label}",
                              int(self._inner.chunk._cache_size())))

    def run_rounds(self, state, t, n):
        out = self._inner.run_rounds(state, t, n)
        self._record(f"Scan(rounds={n})")
        return out

    def apply_prune(self, state, mode, kept, **kw):
        out = self._inner.apply_prune(state, mode, kept, **kw)
        self._record(f"Prune(mode={mode!r})")
        return out

    def evaluate(self, state):
        out = self._inner.evaluate(state)
        self._record("Eval")
        return out

    def snapshot_artifact(self, state, t):
        out = self._inner.snapshot_artifact(state, t)
        self._record("Snapshot")
        return out


@dataclasses.dataclass
class ScenarioResult:
    name: str
    programs: int
    timeline: list[tuple[str, int]]


def _run_serving_scenario(sc: Scenario, device) -> ScenarioResult:
    """More requests than slots through a DecodeEngine; the program count
    (admit + wave) sampled after every wave, so an admission or retirement
    that captured again shows as a jump at its wave."""
    import numpy as np
    import torch

    from repro_torch.core import pruning_lm
    from repro_torch.models.lm import LM
    from repro_torch.serving import DecodeEngine, ServeConfig
    from repro_torch.utils.tree import tree_map

    model = _fresh_model("lm", device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    masks = None
    if sc.serve_mode != "dense":
        kept = model.decide_kept(params, 0.5)
        if sc.serve_mode == "masked":
            masks = model.filter_masks(params, kept)
            params = tree_map(torch.mul, params,
                              model.param_masks(params, kept))
        else:
            idx = kept["mlp"]
            params = pruning_lm.shrink_ffn_at(params, idx)
            model = LM(dataclasses.replace(
                model.cfg, d_ff=int(np.asarray(idx).shape[-1])),
                device=device)
    eng = DecodeEngine(
        model, params,
        ServeConfig(slots=2, cache_len=12, max_prompt=4, max_new_tokens=4,
                    steps_per_wave=4),
        masks=masks, device=device)
    rng = np.random.default_rng(0)
    for _ in range(5):     # 5 ragged requests over 2 slots: reuse, ragged
        eng.submit(rng.integers(                       # admission waves
            0, model.cfg.vocab_size,
            size=int(rng.integers(1, 5))).astype(np.int32))
    timeline, wave = [], 0
    while eng.pending:
        eng.step_wave()
        wave += 1
        timeline.append((f"wave#{wave}",
                         sum(eng.program_counts().values())))
    return ScenarioResult(sc.name, sum(eng.program_counts().values()),
                          timeline)


def run_scenario(sc: Scenario, world=None, device="cpu") -> ScenarioResult:
    import torch

    from repro_torch.core.backend import PlanExecutor
    from repro_torch.core.rounds import FederatedTrainer

    if sc.kind == "serving":
        return _run_serving_scenario(sc, device)
    data, cfg = world if world is not None else make_world(sc.world)
    if sc.masked_compute != "params":
        cfg = dataclasses.replace(cfg, masked_compute=sc.masked_compute)
    if sc.guard != "off":
        cfg = dataclasses.replace(cfg, guard=sc.guard)
    model = _fresh_model(sc.world, device)
    plan = sc.plan_factory()
    tr = FederatedTrainer(model, data, cfg, device=device,
                          backend=sc.backend)
    be = tr.backend(use_masks=plan.uses_masks)
    rec = _RecordingBackend(be)
    params0 = model.init(
        torch.Generator(device=model.device).manual_seed(cfg.seed))
    PlanExecutor(rec, trainer=tr).run(plan, params=params0)
    return ScenarioResult(sc.name, int(be.chunk._cache_size()),
                          rec.timeline)


def _run_all(scenario_list, world, device) -> list[ScenarioResult]:
    """Every scenario, the worlds built once each; a process group the mesh
    scenarios start (a gloo world of one) is destroyed after them."""
    import torch.distributed as dist

    worlds = {} if world is None else {"cnn": world}
    started = not dist.is_initialized()
    try:
        results = []
        for sc in scenario_list:
            if sc.world not in worlds:
                worlds[sc.world] = make_world(sc.world)
            results.append(run_scenario(sc, worlds[sc.world], device))
        return results
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# check / update


def check(budget: dict | None = None,
          scenario_list: list[Scenario] | None = None, world=None,
          device="cpu") -> list[str]:
    """Run every scenario (or ``scenario_list``) on ``device`` and diff the
    counts against the baseline; returns failure messages (empty: within
    budget).  ``world`` is the shared CNN world, if given."""
    budget = budget if budget is not None else load_budget()
    expected = budget["scenarios"]
    todo = scenario_list if scenario_list is not None else scenarios()
    errors = [f"{sc.name}: scenario missing from compile_budget.json — "
              f"regenerate with --update if this is intentional"
              for sc in todo if sc.name not in expected]
    for res in _run_all([sc for sc in todo if sc.name in expected], world,
                        device):
        want = int(expected[res.name]["programs"])
        if res.programs != want:
            culprit = next(
                (ev for ev, count in res.timeline if count > want), None)
            detail = (f" first exceeded after {culprit}" if culprit
                      else " (fewer programs than budgeted — update the "
                           "baseline if the plan changed)")
            errors.append(
                f"{res.name}: {res.programs} program(s), budget says "
                f"{want};{detail}. timeline={res.timeline}")
    return errors


def update(path: pathlib.Path | str | None = None) -> dict:
    """Re-measure every scenario on the CPU into the baseline; an entry
    keeps its ``reference_programs`` (the reference's differing count)."""
    old = (load_budget(path) if pathlib.Path(path or BUDGET_PATH).exists()
           else {"scenarios": {}})
    budget = {
        "_comment": [
            "Expected program counts per canonical plan and serving",
            "scenario: round-program captures (keys on the CPU) and the",
            "engine's admit + wave.  Checked by `python -m",
            "repro_torch.analysis.compile_budget` and",
            "tests/test_torch_compile_budget.py; an entry whose count",
            "differs from the reference's compile_budget.json holds the",
            "reference's as reference_programs and says why in its note.",
            "Regenerate only for intended plan/engine changes:",
            "PYTHONPATH=src python -m repro_torch.analysis.compile_budget "
            "--update",
        ],
        "scenarios": {},
    }
    todo = scenarios()
    for sc, res in zip(todo, _run_all(todo, None, "cpu")):
        entry = {"programs": res.programs,
                 "timeline": [f"{ev}={count}" for ev, count in res.timeline]}
        if sc.note:
            entry["note"] = sc.note
        ref = old["scenarios"].get(sc.name, {}).get("reference_programs")
        if ref is not None:
            entry["reference_programs"] = ref
        budget["scenarios"][res.name] = entry
    with open(path or BUDGET_PATH, "w") as f:
        json.dump(budget, f, indent=2)
        f.write("\n")
    return budget


def main(argv: list[str] | None = None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(prog="repro_torch.analysis.compile_budget",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--update", action="store_true",
                    help="re-measure and overwrite compile_budget.json")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    if args.update:
        budget = update()
        for name, entry in budget["scenarios"].items():
            print(f"  {name}: {entry['programs']} program(s)")
        print(f"wrote {BUDGET_PATH}")
        return 0
    errors = check()
    for e in errors:
        print(f"FAIL {e}")
    print(f"repro_torch.analysis.compile_budget: "
          f"{len(errors)} violation(s) across {len(scenarios())} scenarios")
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
