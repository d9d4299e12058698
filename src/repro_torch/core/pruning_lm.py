"""FedAP for the LM zoo: structured pruning of the stacked layers.

Counterpart of the reference's ``core/pruning_lm.py``.  The filter-like
axes are:

* FFN hidden units (columns of ``wi``/``wg``, rows of ``wo``) of a dense,
  vlm or hybrid stack: every layer keeps the same number of units (the
  stack is ``[L, ...]``), rounded up to the 128-lane boundary, chosen per
  layer by the product of weight norms ``||wi_col|| * ||wg_col|| *
  ||wo_row||``;
* whole experts of a MoE stack: the router column's norm times the expert
  matrices' norms, every layer keeping the same count of experts (at least
  ``top_k``).

Kept indices are host numpy ``[L, keep]`` rows (the decision is static);
masks and gathered params are tensors on the params' device.  Ties rank as
the reference's ``argsort(scores)[:, ::-1]`` over a stable ascending sort
ranks them: the LATER index of two equal scores first.
"""
from __future__ import annotations

from typing import Any

import dataclasses

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


def _split(tp) -> bool:
    return tp is not None and tp.mlp


def ffn_unit_scores(layers: Any, act: str, tp=None) -> torch.Tensor:
    """[L, d_ff] product-norm scores for stacked dense FFN layers (f32).
    ``tp`` (a ``sharding.tp.TPLayout`` splitting the units): the layers are
    a rank's units, and the scores of the whole d_ff are gathered from the
    ranks."""
    mlp = layers["mlp"]
    s_in = torch.linalg.vector_norm(mlp["wi"].float(), dim=1)          # [L, ff]
    if "wg" in mlp:
        s_in = s_in * torch.linalg.vector_norm(mlp["wg"].float(), dim=1)
    s_out = torch.linalg.vector_norm(mlp["wo"].float(), dim=2)         # [L, ff]
    scores = s_in * s_out
    return tp.group.all_gather(scores, 1) if _split(tp) else scores


def ffn_kept_indices(params: Any, cfg: ModelConfig, rate: float,
                     *, align: int | None = 128, tp=None) -> np.ndarray:
    """[L, keep] kept-unit index rows, sorted per layer (host numpy).

    The highest scores are kept.  Ties order as the reference's
    ``argsort(scores)[:, ::-1]`` over a stable ascending sort: the LATER
    index of two equal scores ranks first.  Under ``tp`` the decision is
    the whole d_ff's (the scores gathered, the aligned count of the whole),
    every rank taking the same one.
    """
    if cfg.family not in ("dense", "vlm", "hybrid"):
        raise ValueError(f"prune_lm_ffn does not apply to family {cfg.family}")
    scores = ffn_unit_scores(params["layers"], cfg.act, tp).cpu().numpy()
    d_ff = scores.shape[1]
    keep = _aligned_keep(d_ff, rate, align, layer=f"mlp stack (d_ff={d_ff})")
    return _top_rows(scores, keep)


def _top_rows(scores: np.ndarray, keep: int) -> np.ndarray:
    """[L, keep] indices of each row's ``keep`` highest scores, sorted; of
    two equal scores the later index ranks first, as the reference's
    reversed stable argsort ranks them."""
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


def _unit_masks(params: Any, kept: Any, tp=None) -> torch.Tensor | None:
    """[L, d_ff] 0/1 kept-unit masks from ``{"mlp": [L, keep]}``; None when
    no decision is in force.  Under ``tp`` the rank's columns of the whole
    d_ff's masks (``kept`` indexes the whole)."""
    idx = kept.get("mlp") if kept else None
    if idx is None:
        return None
    wi = params["layers"]["mlp"]["wi"]
    ff = wi.shape[2]
    ways = tp.group.size if _split(tp) else 1
    m = torch.zeros((wi.shape[0], ff * ways), dtype=torch.float32,
                    device=wi.device)
    m.scatter_(1, _index_rows(idx, wi.device), 1.0)
    if ways == 1:
        return m
    lo = tp.group.rank * ff
    return m[:, lo:lo + ff].contiguous()


def ffn_filter_masks(params: Any, kept: Any, tp=None) -> dict:
    """``{"mlp": [L, d_ff] 0/1}`` filter keep-masks for masked decode (all
    ones when no decision is in force); a rank's columns under ``tp``."""
    m = _unit_masks(params, kept, tp)
    if m is None:
        wi = params["layers"]["mlp"]["wi"]
        m = torch.ones((wi.shape[0], wi.shape[2]), dtype=torch.float32,
                       device=wi.device)
    return {"mlp": m}


def ffn_param_masks(params: Any, kept: Any, tp=None) -> Any:
    """Param-structured 0/1 masks with zeros on exactly the coordinates
    :func:`shrink_ffn_at` slices away (wi/wg columns and the coupled wo
    rows); masking the params with them equals shrinking them.  Under
    ``tp``: a rank's block of them."""
    def ones(tree):
        if isinstance(tree, dict):
            return {k: ones(v) for k, v in tree.items()}
        return torch.ones(tree.shape, dtype=torch.float32, device=tree.device)

    masks = ones(params)
    unit = _unit_masks(params, kept, tp)
    if unit is None:
        return masks
    mlp = masks["layers"]["mlp"]
    mlp["wi"] = mlp["wi"] * unit[:, None, :]
    if "wg" in mlp:
        mlp["wg"] = mlp["wg"] * unit[:, None, :]
    mlp["wo"] = mlp["wo"] * unit[:, :, None]
    return masks


def prune_lm_ffn(params: Any, cfg: ModelConfig, rate: float,
                 *, align: int | None = 128) -> tuple[Any, ModelConfig, dict]:
    """Structurally shrink the FFN hidden dim of a scanned dense/vlm/hybrid
    stack.  Returns (new params, new config, info)."""
    idx = ffn_kept_indices(params, cfg, rate, align=align)
    d_ff = int(params["layers"]["mlp"]["wi"].shape[2])
    keep = int(idx.shape[1])
    new_params = shrink_ffn_at(params, idx)
    new_cfg = dataclasses.replace(cfg, d_ff=keep)
    return new_params, new_cfg, {"kept": keep, "of": d_ff,
                                 "realized_rate": 1.0 - keep / d_ff}


def _expert_norms(w: torch.Tensor) -> torch.Tensor:
    """[L, E] f32 Frobenius norms of the [L, E, a, b] expert matrices, a
    layer and a group of experts at a time: the f32 copy of a bf16 stack
    never forms whole (arctic-480b's ``wi`` is 17.8 GB in bf16)."""
    n_l, e = w.shape[:2]
    per = max(1, 2 ** 28 // (w.shape[2] * w.shape[3]))
    out = torch.empty((n_l, e), dtype=torch.float32, device=w.device)
    for layer in range(n_l):
        for a in range(0, e, per):
            out[layer, a:a + per] = torch.linalg.vector_norm(
                w[layer, a:a + per].float(), dim=(1, 2))
    return out


def expert_scores(layers: Any) -> torch.Tensor:
    """[L, E] scores for stacked MoE layers (f32): the router column's norm
    (the expected routing mass under random inputs) times the norms of the
    expert's ``wi`` and ``wo``."""
    moe = layers["moe"]
    with torch.no_grad():
        r = torch.linalg.vector_norm(moe["router"].float(), dim=1)    # [L, E]
        return r * _expert_norms(moe["wi"]) * _expert_norms(moe["wo"])


def fedap_min_keep(cfg: ModelConfig) -> int:
    """The floor on kept experts that :func:`fedap_lm` sets: 8, or four per
    routed slot (``4 top_k``)."""
    return max(8, cfg.moe.top_k * 4)


def expert_kept_indices(params: Any, cfg: ModelConfig, rate: float, *,
                        align: int | None = None,
                        min_keep: int | None = None) -> np.ndarray:
    """[L, keep] kept-expert index rows, sorted per layer (host numpy): the
    highest :func:`expert_scores`, ``E - floor(rate E)`` of them (rounded up
    to ``align``), at least ``min_keep``, at least ``top_k`` and at most
    E."""
    if not cfg.moe:
        raise ValueError("not a MoE config")
    scores = expert_scores(params["layers"]).cpu().numpy()
    e = scores.shape[1]
    keep = _aligned_keep(e, rate, align, layer=f"moe expert stack (E={e})")
    if min_keep:
        keep = max(keep, min_keep)
    keep = min(max(keep, cfg.moe.top_k), e)
    return _top_rows(scores, keep)


# the expert axis of each leaf of a MoE stack ([L, ...] leading)
EXPERT_AXIS = {"router": 2, "wi": 1, "wg": 1, "wo": 1}


def take_experts(leaf: torch.Tensor, name: str, idx: Any) -> torch.Tensor:
    """One MoE leaf (``router``, ``wi``, ``wg`` or ``wo``) at the kept
    [L, keep] expert rows: a new tensor, gathered a layer at a time into it
    (no index tensor of the output's size forms)."""
    axis = EXPERT_AXIS[name]
    rows = _index_rows(idx, leaf.device)
    shape = list(leaf.shape)
    shape[axis] = rows.shape[1]
    out = torch.empty(shape, dtype=leaf.dtype, device=leaf.device)
    with torch.no_grad():
        for layer in range(leaf.shape[0]):
            torch.index_select(leaf[layer], axis - 1, rows[layer],
                               out=out[layer])
    return out


def prune_lm_experts(params: Any, cfg: ModelConfig, rate: float,
                     *, align: int | None = None,
                     min_keep: int | None = None
                     ) -> tuple[Any, ModelConfig, dict]:
    """Remove whole experts from a scanned MoE stack: the router columns
    and expert matrices at the kept rows (the always-on ``dense``/``shared``
    FFNs stay whole).  Returns (new params, new config with
    ``moe.num_experts`` = the kept count, info)."""
    idx = expert_kept_indices(params, cfg, rate, align=align,
                              min_keep=min_keep)
    layers = params["layers"]
    e = int(layers["moe"]["router"].shape[2])
    keep = int(idx.shape[1])
    moe = dict(layers["moe"])
    for name in EXPERT_AXIS:
        moe[name] = take_experts(layers["moe"][name], name, idx)
    new_cfg = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, num_experts=keep))
    return {**params, "layers": {**layers, "moe": moe}}, new_cfg, {
        "kept": keep, "of": e, "realized_rate": 1.0 - keep / e}


def fedap_lm(params: Any, cfg: ModelConfig, p_star: float,
             *, align: int | None = 128) -> tuple[Any, ModelConfig, dict]:
    """FedAP entry point for the LM zoo, by family: whole experts of a MoE
    stack (no alignment, at least :func:`fedap_min_keep`), FFN units of the
    others."""
    if cfg.moe:
        return prune_lm_experts(params, cfg, p_star, align=None,
                                min_keep=fedap_min_keep(cfg))
    return prune_lm_ffn(params, cfg, p_star, align=align)
