"""Host-side (NumPy) array plumbing: padding at data-placement and
decision time, apart from :mod:`repro_torch.utils.tree`'s device trees."""
from __future__ import annotations

import numpy as np


def pad_rows_with_first(a: np.ndarray, target_rows: int) -> np.ndarray:
    """Pad ``a`` along axis 0 to ``target_rows`` with copies of row 0.

    The padding of every "pad, then mask or correct the pad back out" path:
    the rank-sharded test split (the mesh backend's eval subtracts the
    padded rows' row-0 contribution exactly) and the ragged FedAP probe
    stack (``fedap_decision_sharded`` masks padded rows out of the Fisher
    and Lipschitz statistics).  Row 0, not zeros, keeps padded rows well
    behaved through any model forward.  ``a`` must be non-empty and
    ``target_rows >= len(a)``."""
    a = np.asarray(a)
    if a.shape[0] == 0:
        raise ValueError("cannot pad an empty array with copies of row 0")
    pad = target_rows - a.shape[0]
    if pad < 0:
        raise ValueError(
            f"target_rows={target_rows} < existing rows {a.shape[0]}")
    if pad == 0:
        return a
    return np.concatenate(
        [a, np.broadcast_to(a[:1], (pad,) + a.shape[1:])])
