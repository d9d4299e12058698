"""Training plans and the checkpoint reader.

The port's copy of the reference's ``core/plan.py``:

* the schedule language of the trainer — :class:`Scan` (rounds),
  :class:`Eval` (score the global model), :class:`Prune` (FedAP as an
  event, in ``mask`` or ``shrink`` form), :class:`Snapshot` (a copy of the
  params as an artifact), :class:`Callback` (a host hook at a segment
  boundary: the distillation and pruning baselines), the
  :class:`TrainPlan` that orders them (and, as an execution setting, where
  and how often the executor checkpoints the run), the paper's
  :func:`fedap_plan`, and the :class:`RunResult` an execution returns;
* ``repro-checkpoint-v1`` directories (``meta.json`` + ``arrays.npz``):
  :meth:`RunResult.save` writes one and :func:`load_artifact` reads one,
  in the reference's format, so a run saved by either package loads into
  the other.  Arrays come back as host numpy; :mod:`repro_torch.interop`
  moves them to a device.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import zipfile
from typing import Any, Callable, Iterable, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


class CheckpointError(ValueError):
    """A checkpoint directory is partial, corrupted, or mismatched.

    Subclasses :class:`ValueError` so ``except ValueError`` callers keep
    working.
    """


@dataclasses.dataclass(frozen=True)
class Scan:
    """``rounds`` federated rounds."""

    rounds: int

    def __post_init__(self):
        if self.rounds < 1:
            raise ValueError(f"Scan.rounds must be >= 1, got {self.rounds}")


@dataclasses.dataclass(frozen=True)
class Eval:
    """Evaluate the global model on the test split; appends to history.
    ``history["round"]`` records the rounds completed at the Eval."""

    name: str = "eval"


@dataclasses.dataclass(frozen=True)
class Prune:
    """FedAP (Algorithm 3) at this point of the schedule.

    mode="mask":   shapes stay: keep-masks are written into the round
                   state (its tensors keep their storage) and applied every
                   round; with ``FLConfig(masked_compute="kernel")`` the
                   masked FFN products run the ``masked_matmul`` kernels.
    mode="shrink": the pruned model is re-materialized at its smaller
                   shapes.
    Both restart the server momentum.

    ``reuse`` (mode="shrink" only) names an EARLIER Prune event whose
    kept-index decision this event compacts the state to: no second FedAP
    run, and the momentum buffers are gathered at the kept indices instead
    of restarted.  This is the mask-now-shrink-later pattern
    (``fedap_plan(..., shrink_round=K)``).
    """

    mode: str = "mask"
    name: str = "prune"
    reuse: str | None = None

    def __post_init__(self):
        if self.mode not in ("mask", "shrink"):
            raise ValueError(f"Prune.mode must be 'mask' or 'shrink', "
                             f"got {self.mode!r}")
        if self.reuse is not None and self.mode != "shrink":
            raise ValueError(
                "Prune.reuse compacts to an earlier event's decision and "
                f"needs mode='shrink', got mode={self.mode!r}")


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """Copy the current global params into ``RunResult.artifacts[name]``
    as ``{"round", "params"}``.  The round state is updated in place, so
    the copy is taken at the event: later rounds leave it unchanged."""

    name: str = "snapshot"


@dataclasses.dataclass(frozen=True)
class Callback:
    """A host callback at a segment boundary (distillation, the pruning
    baselines, ...).  ``fn(trainer, t, params)`` gets the completed-round
    count ``t`` and a COPY of the params, and may return replacement
    params: a non-None return restarts the round state (momentum and
    client state from zero) with the round count and any mask decision
    kept."""

    fn: Callable
    name: str = "callback"


Event = Union[Scan, Eval, Prune, Snapshot, Callback]
_EVENTS = (Scan, Eval, Prune, Snapshot, Callback)


class TrainPlan:
    """An ordered schedule of :data:`Event` items, e.g.
    ``TrainPlan(Scan(30), Eval(), Prune(mode="mask"), Scan(30), Eval())``.
    Iterables flatten, so sub-schedules splice in place.

    ``checkpoint_dir`` makes the executor durably snapshot the run (round
    state, generator state, plan cursor, history and artifacts) every
    ``checkpoint_every`` completed Scan chunks (default 1), so a killed
    run continues bit-identically through
    ``FederatedTrainer.resume(checkpoint_dir)``.  Checkpointing is an
    execution setting, not part of the schedule: plan equality ignores
    it."""

    def __init__(self, *events: Event | Iterable[Event],
                 checkpoint_every: int | None = None, checkpoint_dir=None):
        flat: list = []
        for e in events:
            if isinstance(e, _EVENTS):
                flat.append(e)
            else:
                flat.extend(e)
        for e in flat:
            if not isinstance(e, _EVENTS):
                raise TypeError(f"not a TrainPlan event: {e!r}")
        self.events: tuple = tuple(flat)
        if checkpoint_every is not None and checkpoint_dir is None:
            raise ValueError("checkpoint_every without checkpoint_dir: "
                             "there is nowhere to write the snapshots")
        if checkpoint_every is None and checkpoint_dir is not None:
            checkpoint_every = 1
        if checkpoint_every is not None and checkpoint_every < 1:
            raise ValueError(f"checkpoint_every must be >= 1, "
                             f"got {checkpoint_every}")
        self.checkpoint_every = checkpoint_every
        self.checkpoint_dir = checkpoint_dir

    def with_checkpointing(self, directory, *, every: int = 1) -> "TrainPlan":
        """A copy of this plan that checkpoints into ``directory`` every
        ``every`` completed Scan chunks."""
        return TrainPlan(self.events, checkpoint_every=every,
                         checkpoint_dir=directory)

    def __repr__(self):
        return f"TrainPlan({', '.join(map(repr, self.events))})"

    def __eq__(self, other):
        return isinstance(other, TrainPlan) and self.events == other.events

    @property
    def total_rounds(self) -> int:
        return sum(e.rounds for e in self.events if isinstance(e, Scan))

    @property
    def uses_masks(self) -> bool:
        """True iff the plan schedules a mask-mode prune: the round state
        then carries all-ones masks from round 0."""
        return any(isinstance(e, Prune) and e.mode == "mask"
                   for e in self.events)

    def compiled(self) -> tuple:
        """The events with consecutive Scan segments merged."""
        out: list = []
        for e in self.events:
            if isinstance(e, Scan) and out and isinstance(out[-1], Scan):
                out[-1] = Scan(out[-1].rounds + e.rounds)
            else:
                out.append(e)
        return tuple(out)

    def chunk_lengths(self) -> tuple:
        """The distinct Scan lengths after merging (the reference compiles
        one scan program per length; the port runs rounds eagerly)."""
        return tuple(sorted({e.rounds for e in self.compiled()
                             if isinstance(e, Scan)}))

    @classmethod
    def standard(cls, num_rounds: int, *, eval_every: int = 1) -> "TrainPlan":
        """``num_rounds`` of training with an Eval every ``eval_every``
        rounds (and after the last)."""
        if eval_every < 1:
            raise ValueError(f"eval_every must be >= 1, got {eval_every}")
        events: list = []
        t = 0
        while t < num_rounds:
            n = min(eval_every - (t % eval_every), num_rounds - t)
            events.append(Scan(n))
            t += n
            if t % eval_every == 0 or t == num_rounds:
                events.append(Eval())
        return cls(events)

    @classmethod
    def with_callback(cls, num_rounds: int, fn: Callable, *,
                      every: int = 1, eval_every: int = 1,
                      name: str = "callback") -> "TrainPlan":
        """Training with ``fn`` called every ``every`` rounds (and after the
        last) as a :class:`Callback`; the hook gates itself on the round
        count it receives.  ``eval_every=0`` schedules no Eval."""
        events: list = []
        t = 0
        while t < num_rounds:
            stops = [t + every - (t % every)]
            if eval_every:
                stops.append(t + eval_every - (t % eval_every))
            stop = min(min(stops), num_rounds)
            events.append(Scan(stop - t))
            t = stop
            if eval_every and (t % eval_every == 0 or t == num_rounds):
                events.append(Eval())
            if t % every == 0 or t == num_rounds:
                events.append(Callback(fn, name=name))
        return cls(events)


def fedap_plan(num_rounds: int, *, prune_round: int, mode: str = "mask",
               eval_every: int = 1,
               shrink_round: int | None = None) -> TrainPlan:
    """The paper's FedDUMAP schedule: train, FedAP once at ``prune_round``,
    keep training, with an Eval every ``eval_every`` rounds.

    ``shrink_round=K`` (mask mode only) is the mask-now-shrink-later form:
    the decision at ``prune_round`` is applied as masks, and at round ``K``
    ``Prune(mode="shrink", reuse="prune")`` compacts the state, momentum
    included, to the same kept filters, so the rounds after ``K`` train the
    smaller model."""
    if not 0 < prune_round <= num_rounds:
        raise ValueError(f"prune_round must be in (0, {num_rounds}], "
                         f"got {prune_round}")
    if eval_every < 1:
        raise ValueError(f"eval_every must be >= 1, got {eval_every}")
    if shrink_round is not None:
        if mode != "mask":
            raise ValueError("shrink_round schedules a follow-up compaction "
                             "of a MASK prune; use mode='mask' (got "
                             f"mode={mode!r})")
        if not prune_round < shrink_round <= num_rounds:
            raise ValueError(
                f"shrink_round must be in (prune_round={prune_round}, "
                f"{num_rounds}], got {shrink_round}")
    events: list = []
    t = 0
    while t < num_rounds:
        stops = [t + eval_every - (t % eval_every), num_rounds]
        if t < prune_round:
            stops.append(prune_round)
        if shrink_round is not None and t < shrink_round:
            stops.append(shrink_round)
        stop = min(stops)
        events.append(Scan(stop - t))
        t = stop
        if t % eval_every == 0 or t == num_rounds:
            events.append(Eval())
        if t == prune_round:
            events.append(Prune(mode=mode))
        if shrink_round is not None and t == shrink_round:
            events.append(Prune(mode="shrink", reuse="prune", name="shrink"))
    return TrainPlan(events)


@dataclasses.dataclass
class RunResult:
    """What a plan execution returns.

    params     final global params (mask mode: pruned coordinates are 0)
    history    {"round", "acc", "loss", "tau_eff", "time"} per Eval, and
               "health" per round
    artifacts  per-event outputs keyed by event name (``#k`` suffixes on
               repeats): Prune -> {"p_star", "layer_rates", "kept",
               "kept_counts", "mode", "filter_masks" | "params_before"},
               and ``"reused"`` for a ``Prune(reuse=)`` compaction;
               Snapshot -> {"round", "params"}; those of a resumed run's
               earlier chunks come back from its checkpoint as numpy
    state      the final round state
    """

    params: Any
    history: dict
    artifacts: dict
    state: dict

    def save(self, path, *, model_config=None, params=None) -> None:
        """Write the run as a ``repro-checkpoint-v1`` directory, the format
        of the reference's ``RunResult.save``: ``arrays.npz`` (the params
        and the last Prune event's kept units and filter masks, under
        '/'-joined paths) and ``meta.json`` (the prune mode, p*, layer
        rates and kept counts, the history, and ``model_config`` when
        given, a :class:`ModelConfig` of either package).  ``params``
        overrides the final params (e.g. a ``Snapshot`` artifact's).

        Leaves may be tensors on any device or numpy arrays (artifacts
        restored from a run checkpoint); bfloat16 is written as float32,
        which holds every bfloat16 value.  Each file is written to a temp
        file, fsynced and renamed into place, so a crash never leaves a
        half-written file for :func:`load_artifact`."""
        out = pathlib.Path(path)
        out.mkdir(parents=True, exist_ok=True)
        prune_name, prune_art = None, None
        for name, art in self.artifacts.items():
            if isinstance(art, dict) and "kept" in art:
                prune_name, prune_art = name, art

        arrays = _flatten_arrays({"params": params if params is not None
                                  else self.params})
        meta: dict = {
            "format": "repro-checkpoint-v1",
            "history": _json_safe(self.history),
            "model_config": (model_config.to_dict()
                             if model_config is not None else None),
            "prune": None,
        }
        if prune_art is not None:
            kept = prune_art.get("kept") or {}
            arrays.update(_flatten_arrays({"kept": dict(kept)}))
            fmasks = prune_art.get("filter_masks")
            if fmasks:
                arrays.update(_flatten_arrays({"masks": dict(fmasks)}))
            meta["prune"] = _json_safe({
                "event": prune_name,
                "mode": prune_art.get("mode"),
                "p_star": prune_art.get("p_star"),
                "layer_rates": prune_art.get("layer_rates"),
                "kept_counts": prune_art.get(
                    "kept_counts",
                    {k: int(_host(v).shape[-1]) for k, v in kept.items()}),
            })
        tmp = out / f".arrays.npz.tmp-{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, **{k: _host(v) for k, v in arrays.items()})
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, out / "arrays.npz")
        tmp = out / f".meta.json.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=2)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, out / "meta.json")


def _host(x) -> np.ndarray:
    """A tensor (any device; bfloat16 as float32) or array as host numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _flatten_arrays(tree, prefix: str = "") -> dict:
    """Nested dicts of arrays -> flat {'a/b/c': leaf}; keys must be
    '/'-free."""
    flat: dict = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            k = str(k)
            if "/" in k:
                raise ValueError(f"checkpoint keys may not contain '/': {k!r}")
            flat.update(_flatten_arrays(v, f"{prefix}{k}/"))
        return flat
    flat[prefix[:-1]] = tree
    return flat


def _json_safe(x):
    """numpy or torch scalars and arrays -> python, recursively."""
    if isinstance(x, dict):
        return {str(k): _json_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_json_safe(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return _host(x).tolist()
    return x


def _unflatten_arrays(flat: dict) -> dict:
    """{'a/b/c': leaf} -> nested dicts."""
    tree: dict = {}
    for key, leaf in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


def load_artifact(path) -> dict:
    """Load a checkpoint directory.

    Returns ``{"params", "kept", "filter_masks", "mode", "model_config",
    "history", "meta"}``: ``kept``/``filter_masks`` are None for a dense
    (never-pruned) run, ``model_config`` is a :class:`ModelConfig` or None
    when the save recorded none.  Partial, corrupted or foreign directories
    raise :class:`CheckpointError` naming what is wrong.
    """
    p = pathlib.Path(path)
    if not (p / "meta.json").exists():
        raise CheckpointError(
            f"{p}: not a checkpoint directory (missing meta.json)")
    try:
        with open(p / "meta.json") as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointError(f"{p}: unreadable meta.json ({e})") from e
    if meta.get("format") != "repro-checkpoint-v1":
        raise CheckpointError(f"{p}: not a repro checkpoint "
                              f"(format={meta.get('format')!r})")
    if not (p / "arrays.npz").exists():
        raise CheckpointError(
            f"{p}: partial checkpoint (meta.json present but arrays.npz "
            f"missing — interrupted or incomplete save)")
    try:
        with np.load(p / "arrays.npz") as z:
            tree = _unflatten_arrays({k: z[k] for k in z.files})
    except (zipfile.BadZipFile, OSError, ValueError) as e:
        raise CheckpointError(f"{p}: corrupted arrays.npz ({e})") from e

    prune = meta.get("prune") or {}
    return {
        "params": tree.get("params", {}),
        "kept": tree.get("kept"),
        "filter_masks": tree.get("masks"),
        "mode": prune.get("mode"),
        "model_config": (ModelConfig.from_dict(meta["model_config"])
                         if meta.get("model_config") else None),
        "history": meta.get("history", {}),
        "meta": meta,
    }
