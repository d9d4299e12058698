"""Durable chunk-boundary run checkpoints: atomic write, exact resume.

Counterpart of the reference's ``reliability/checkpoint.py``, in the same
on-disk format (``repro-run-checkpoint-v1``), so each package reads the
other's snapshots.  A checkpoint holds what the
:class:`~repro_torch.core.backend.PlanExecutor` needs to continue a killed
run bit-identically: the round state, the trainer's ``torch.Generator``
state (the reference stores its JAX key data instead), the plan cursor
(an index into ``plan.compiled()``), the completed-round and chunk
counters, the history and artifacts so far, the run's ``init_params`` (the
Lipschitz reference of later Prune events) and the plan's spec.

Layout: a directory ``step-NNNN`` (NNNN the cursor) holding
``arrays.npz`` (every array leaf under its '/'-joined path in the payload)
and ``meta.json`` (the payload's JSON skeleton), and a ``LATEST`` file
naming the newest snapshot.  Tensors are written from any device as host
numpy; a bfloat16 tensor as float32 (exact), marked in the skeleton so the
port reads it back as bfloat16 (the reference reads its float32 values).

Durability: the snapshot is written into a hidden temp directory, both
files fsynced, renamed into place with ``os.replace``, then ``LATEST`` is
replaced through its own temp file.  A crash mid-write leaves a stale
``LATEST`` or a dangling ``.tmp-*`` directory, which :func:`load_checkpoint`
ignores.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import zipfile
from typing import Any

import numpy as np
import torch

from repro_torch.core.plan import (
    Callback,
    CheckpointError,
    Eval,
    Prune,
    Scan,
    Snapshot,
    TrainPlan,
    _host,
)

RUN_FORMAT = "repro-run-checkpoint-v1"


# ---------------------------------------------------------------------------
# (skeleton, arrays): payloads mix arrays, scalars and strings


def _encode(obj: Any, path: str, arrays: dict) -> Any:
    """Split a mixed tree into a JSON skeleton and a flat array dict."""
    if isinstance(obj, dict):
        enc = {}
        for k, v in obj.items():
            k = str(k)
            if "/" in k:
                raise CheckpointError(
                    f"checkpoint keys may not contain '/': {k!r}")
            enc[k] = _encode(v, f"{path}/{k}", arrays)
        return {"__dict__": enc}
    if isinstance(obj, (list, tuple)):
        return {"__seq__": [_encode(v, f"{path}/{i}", arrays)
                            for i, v in enumerate(obj)],
                "tuple": isinstance(obj, tuple)}
    if isinstance(obj, torch.Tensor):
        arrays[path] = _host(obj)
        if obj.dtype == torch.bfloat16:
            return {"__array__": path, "dtype": "bfloat16"}
        return {"__array__": path}
    if hasattr(obj, "ndim") and hasattr(obj, "dtype"):   # numpy array leaf
        arrays[path] = np.asarray(obj)
        return {"__array__": path}
    if isinstance(obj, np.generic):
        obj = obj.item()
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"__value__": obj}
    raise CheckpointError(
        f"cannot checkpoint {type(obj).__name__} at {path!r}")


def _decode(skel: Any, arrays: dict) -> Any:
    if "__dict__" in skel:
        return {k: _decode(v, arrays) for k, v in skel["__dict__"].items()}
    if "__seq__" in skel:
        seq = [_decode(v, arrays) for v in skel["__seq__"]]
        return tuple(seq) if skel.get("tuple") else seq
    if "__array__" in skel:
        try:
            arr = arrays[skel["__array__"]]
        except KeyError as e:
            raise CheckpointError(
                f"checkpoint arrays.npz is missing {skel['__array__']!r} "
                f"(partial or corrupted snapshot)") from e
        if skel.get("dtype") == "bfloat16":
            return torch.from_numpy(arr).to(torch.bfloat16)
        return arr
    return skel["__value__"]


# ---------------------------------------------------------------------------
# Plan (de)serialization: resume rebuilds the schedule


def plan_spec(plan: TrainPlan) -> list[dict]:
    """A JSON-able description of the plan's events.  A Callback records
    only its name (a function cannot round-trip through a checkpoint), so
    resuming a Callback plan needs the plan object passed to ``resume``,
    which is validated against this spec."""
    spec = []
    for e in plan.events:
        if isinstance(e, Scan):
            spec.append({"type": "Scan", "rounds": e.rounds})
        elif isinstance(e, Eval):
            spec.append({"type": "Eval", "name": e.name})
        elif isinstance(e, Prune):
            spec.append({"type": "Prune", "mode": e.mode, "name": e.name,
                         "reuse": e.reuse})
        elif isinstance(e, Snapshot):
            spec.append({"type": "Snapshot", "name": e.name})
        elif isinstance(e, Callback):
            spec.append({"type": "Callback", "name": e.name})
        else:  # pragma: no cover — TrainPlan validates event types
            raise TypeError(f"unknown plan event: {e!r}")
    return spec


def plan_from_spec(spec: list[dict], *, checkpoint_every: int | None = None,
                   checkpoint_dir=None) -> TrainPlan:
    """Rebuild a TrainPlan from :func:`plan_spec` output.  A Callback
    event cannot be rebuilt: raises :class:`CheckpointError` asking for the
    original plan."""
    events = []
    for s in spec:
        t = s.get("type")
        if t == "Scan":
            events.append(Scan(s["rounds"]))
        elif t == "Eval":
            events.append(Eval(name=s["name"]))
        elif t == "Prune":
            events.append(Prune(mode=s["mode"], name=s["name"],
                                reuse=s.get("reuse")))
        elif t == "Snapshot":
            events.append(Snapshot(name=s["name"]))
        elif t == "Callback":
            raise CheckpointError(
                f"the checkpointed plan contains a Callback event "
                f"({s.get('name')!r}) whose function cannot be restored "
                f"from disk: pass the original plan: "
                f"trainer.resume(dir, plan=plan)")
        else:
            raise CheckpointError(f"unknown event type in checkpoint "
                                  f"plan spec: {t!r}")
    return TrainPlan(events, checkpoint_every=checkpoint_every,
                     checkpoint_dir=checkpoint_dir)


# ---------------------------------------------------------------------------
# Atomic write / load


def _fsync_write(path: pathlib.Path, write_fn) -> None:
    with open(path, "wb") as f:
        write_fn(f)
        f.flush()
        os.fsync(f.fileno())


def save_checkpoint(directory, payload: dict) -> pathlib.Path:
    """Atomically persist one executor snapshot; returns its directory
    (``step-NNNN``, NNNN = ``payload["cursor"]``)."""
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    name = f"step-{int(payload['cursor']):04d}"
    tmp = d / f".tmp-{name}-{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    arrays: dict = {}
    skel = _encode(payload, "", arrays)
    _fsync_write(tmp / "arrays.npz", lambda f: np.savez(f, **arrays))
    meta = {"format": RUN_FORMAT, "payload": skel}
    _fsync_write(tmp / "meta.json",
                 lambda f: f.write(json.dumps(meta, indent=2).encode()))

    final = d / name
    if final.exists():               # same-cursor overwrite (a re-run)
        shutil.rmtree(final)
    os.replace(tmp, final)
    ptr_tmp = d / ".LATEST.tmp"
    _fsync_write(ptr_tmp, lambda f: f.write(name.encode()))
    os.replace(ptr_tmp, d / "LATEST")
    return final


def latest_checkpoint(directory) -> pathlib.Path | None:
    """The snapshot directory ``LATEST`` names, or None if the directory
    holds no complete checkpoint yet."""
    d = pathlib.Path(directory)
    ptr = d / "LATEST"
    if not ptr.exists():
        return None
    step = d / ptr.read_text().strip()
    if not (step / "meta.json").exists():
        return None
    return step


def load_checkpoint(path) -> dict:
    """Load a run checkpoint: ``path`` is a checkpoint root (``LATEST`` is
    followed) or one ``step-NNNN`` snapshot.  Arrays come back as host
    numpy (bfloat16 leaves as CPU tensors).  Partial, foreign or corrupted
    snapshots raise :class:`CheckpointError`."""
    p = pathlib.Path(path)
    if not (p / "meta.json").exists():
        step = latest_checkpoint(p)
        if step is None:
            raise CheckpointError(
                f"{p}: no run checkpoint found (no LATEST pointer and no "
                f"meta.json: was the run configured with checkpoint_dir?)")
        p = step
    try:
        with open(p / "meta.json") as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointError(f"{p}: unreadable meta.json ({e})") from e
    if meta.get("format") != RUN_FORMAT:
        raise CheckpointError(
            f"{p}: not a {RUN_FORMAT} checkpoint "
            f"(format={meta.get('format')!r})")
    arrays_path = p / "arrays.npz"
    if not arrays_path.exists():
        raise CheckpointError(f"{p}: partial checkpoint (missing "
                              f"arrays.npz)")
    try:
        with np.load(arrays_path) as z:
            arrays = {k: z[k] for k in z.files}
    except (zipfile.BadZipFile, OSError, ValueError) as e:
        raise CheckpointError(f"{p}: corrupted arrays.npz ({e})") from e
    return _decode(meta["payload"], arrays)
