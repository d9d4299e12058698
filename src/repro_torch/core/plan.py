"""Reader of ``repro-checkpoint-v1`` directories (``meta.json`` +
``arrays.npz``), as written by the reference's ``RunResult.save``.

A port of the reference's ``core/plan.py`` loader (``load_artifact`` and
its helpers), so a checkpoint saved by the JAX package loads straight into
the port.  Arrays come back as host numpy; :mod:`repro_torch.interop` moves
them to a device.
"""
from __future__ import annotations

import json
import pathlib
import zipfile

import numpy as np

from repro_torch.configs.base import ModelConfig


class CheckpointError(ValueError):
    """A checkpoint directory is partial, corrupted, or mismatched.

    Subclasses :class:`ValueError` so ``except ValueError`` callers keep
    working.
    """


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
