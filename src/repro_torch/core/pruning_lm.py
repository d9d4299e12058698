"""FedAP for the dense LM: structured pruning of the stacked FFN units.

Counterpart of the reference's ``core/pruning_lm.py`` for dense stacks.
Hidden units of the FFN (columns of ``wi``/``wg``, rows of ``wo``) are the
filter-like axis; every layer keeps the same number of units (the stack is
``[L, ...]``), rounded up to the 128-lane boundary, chosen per layer by the
product of weight norms ``||wi_col|| * ||wg_col|| * ||wo_row||``.

Kept indices are host numpy ``[L, keep]`` rows (the decision is static);
masks and gathered params are tensors on the params' device.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def _aligned_keep(d: int, rate: float, align: int | None,
                  *, layer: str = "layer") -> int:
    """Uniform kept count for one stack: ``d - floor(rate * d)``, rounded UP
    to the alignment boundary (realized rate <= requested rate).  A rate or
    alignment that would keep 0 units or overflow the width fails here,
    naming the rate, the alignment and the layer."""
    rate = float(rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(
            f"prune rate for {layer} must be in [0, 1), got {rate} "
            f"(rate >= 1 would keep 0 of the {d} units)")
    keep = d - int(np.floor(rate * d))
    if align and d >= align:
        aligned = int(np.ceil(keep / align) * align)
        if aligned > d:
            raise ValueError(
                f"{layer}: the {align}-lane-aligned kept count {aligned} "
                f"exceeds the layer width {d} (width is not a multiple of "
                f"the alignment; rate={rate} keeps {keep} unaligned units)")
        keep = aligned
    if not 1 <= keep <= d:
        raise ValueError(
            f"{layer}: kept count {keep} outside [1, {d}] "
            f"(rate={rate}, align={align})")
    return keep


def ffn_unit_scores(layers: Any, act: str) -> torch.Tensor:
    """[L, d_ff] product-norm scores for stacked dense FFN layers (f32)."""
    mlp = layers["mlp"]
    s_in = torch.linalg.vector_norm(mlp["wi"].float(), dim=1)          # [L, ff]
    if "wg" in mlp:
        s_in = s_in * torch.linalg.vector_norm(mlp["wg"].float(), dim=1)
    s_out = torch.linalg.vector_norm(mlp["wo"].float(), dim=2)         # [L, ff]
    return s_in * s_out


def ffn_kept_indices(params: Any, cfg: ModelConfig, rate: float,
                     *, align: int | None = 128) -> np.ndarray:
    """[L, keep] kept-unit index rows, sorted per layer (host numpy).

    The highest scores are kept.  Ties order as the reference's
    ``argsort(scores)[:, ::-1]`` over a stable ascending sort: the LATER
    index of two equal scores ranks first.
    """
    if cfg.family not in ("dense", "vlm", "hybrid"):
        raise ValueError(f"prune_lm_ffn does not apply to family {cfg.family}")
    scores = ffn_unit_scores(params["layers"], cfg.act).cpu().numpy()
    d_ff = scores.shape[1]
    keep = _aligned_keep(d_ff, rate, align, layer=f"mlp stack (d_ff={d_ff})")
    idx = np.argsort(scores, axis=1, kind="stable")[:, ::-1][:, :keep]
    return np.sort(idx, axis=1)


def _index_rows(idx, device) -> torch.Tensor:
    """[L, keep] kept rows (numpy, list or tensor) as int64 on ``device``."""
    if isinstance(idx, torch.Tensor):
        return idx.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(idx, dtype=np.int64), device=device)


def shrink_ffn_at(params: Any, idx: Any) -> Any:
    """Gather the kept FFN units at the [L, keep] index rows — wi/wg columns
    and wo rows.  Applies to the param tree and to any tree sharing its
    structure."""
    layers = params["layers"]
    wi = layers["mlp"]["wi"]
    rows = _index_rows(idx, wi.device)                      # [L, keep]
    n_l, d, _ = wi.shape
    keep = rows.shape[1]
    cols = rows[:, None, :].expand(n_l, d, keep)
    mlp = dict(layers["mlp"])
    mlp["wi"] = torch.gather(wi, 2, cols)
    if "wg" in mlp:
        mlp["wg"] = torch.gather(layers["mlp"]["wg"], 2, cols)
    wo = layers["mlp"]["wo"]
    mlp["wo"] = torch.gather(wo, 1, rows[:, :, None].expand(n_l, keep,
                                                            wo.shape[2]))
    new_layers = dict(layers)
    new_layers["mlp"] = mlp
    new_params = dict(params)
    new_params["layers"] = new_layers
    return new_params


def _unit_masks(params: Any, kept: Any) -> torch.Tensor | None:
    """[L, d_ff] 0/1 kept-unit masks from ``{"mlp": [L, keep]}``; None when
    no decision is in force."""
    idx = kept.get("mlp") if kept else None
    if idx is None:
        return None
    wi = params["layers"]["mlp"]["wi"]
    m = torch.zeros((wi.shape[0], wi.shape[2]), dtype=torch.float32,
                    device=wi.device)
    return m.scatter_(1, _index_rows(idx, wi.device), 1.0)


def ffn_filter_masks(params: Any, kept: Any) -> dict:
    """``{"mlp": [L, d_ff] 0/1}`` filter keep-masks for masked decode (all
    ones when no decision is in force)."""
    m = _unit_masks(params, kept)
    if m is None:
        wi = params["layers"]["mlp"]["wi"]
        m = torch.ones((wi.shape[0], wi.shape[2]), dtype=torch.float32,
                       device=wi.device)
    return {"mlp": m}


def ffn_param_masks(params: Any, kept: Any) -> Any:
    """Param-structured 0/1 masks with zeros on exactly the coordinates
    :func:`shrink_ffn_at` slices away (wi/wg columns and the coupled wo
    rows); masking the params with them equals shrinking them."""
    def ones(tree):
        if isinstance(tree, dict):
            return {k: ones(v) for k, v in tree.items()}
        return torch.ones(tree.shape, dtype=torch.float32, device=tree.device)

    masks = ones(params)
    unit = _unit_masks(params, kept)
    if unit is None:
        return masks
    mlp = masks["layers"]["mlp"]
    mlp["wi"] = mlp["wi"] * unit[:, None, :]
    if "wg" in mlp:
        mlp["wg"] = mlp["wg"] * unit[:, None, :]
    mlp["wo"] = mlp["wo"] * unit[:, :, None]
    return masks
