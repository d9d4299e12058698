"""Checkpoint -> servable (model, params, masks) for the decode engine.

Counterpart of the reference's ``serving/checkpoint.py``.  The three serving
modes of a FedAP-pruned LM:

* ``dense``   — decode the params as saved;
* ``masked``  — dense shapes, FFN up/gate products through the
                block-skipping ``masked_matmul`` kernel (fully pruned
                128-column blocks of ``wi``/``wg`` are never read);
* ``shrunk``  — structurally compacted params (``shrink_ffn_at``) decode at
                the smaller d_ff.

``masked`` and ``shrunk`` give the same logits up to float reassociation.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch import device as _device
from repro_torch import interop
from repro_torch.configs.base import ModelConfig

SERVE_MODES = ("auto", "dense", "masked", "shrunk")


@dataclasses.dataclass(frozen=True)
class Servable:
    """What :func:`load_servable` hands to ``DecodeEngine``: build the
    engine as ``DecodeEngine(s.model, s.params, cfg, masks=s.masks,
    device=s.model.device)``."""

    model: Any
    params: Any
    masks: Optional[dict]
    mode: str


def _infer_d_ff(params) -> int | None:
    """The FFN width of stacked ``layers`` params; None for a tree without
    them (the ssm family's ``blocks``)."""
    layers = params.get("layers") if isinstance(params, dict) else None
    if isinstance(layers, dict) and "mlp" in layers:
        return int(layers["mlp"]["wi"].shape[-1])
    return None


def _infer_experts(params) -> int | None:
    """The expert count of a stacked MoE ``layers`` tree (its router's
    width); None for a tree without one."""
    layers = params.get("layers") if isinstance(params, dict) else None
    if isinstance(layers, dict) and "moe" in layers:
        return int(layers["moe"]["router"].shape[-1])
    return None


def _port_config(cfg) -> ModelConfig:
    """The port's ModelConfig for ``cfg`` (a config of either package)."""
    if cfg is None or isinstance(cfg, ModelConfig):
        return cfg
    return ModelConfig.from_dict(cfg.to_dict())


def load_servable(source, serve_mode: str = "auto", *, model_config=None,
                  attn_impl: str = "pallas", device="cuda") -> Servable:
    """Build a servable on ``device`` from ``source``: a checkpoint
    directory (``repro-checkpoint-v1``, as either package saves it), a
    :func:`repro_torch.core.plan.load_artifact`-shaped dict, or a
    ``RunResult``-shaped object (``.params`` + ``.artifacts``).

    ``serve_mode="auto"`` picks ``masked`` for a mask-mode prune decision,
    ``shrunk`` for a shrink-mode one, ``dense`` otherwise.  ``model_config``
    overrides (or supplies) the recorded config; its ``d_ff`` (and a moe
    config's expert count) is re-derived from the param shapes, so a config
    recorded before a shrink or an expert prune still loads.  A moe
    checkpoint serves ``dense``: its FedAP prunes whole experts
    (``pruning_lm.fedap_lm``), which leaves a dense stack at the kept count.
    An encdec checkpoint serves ``dense`` only: its blocks are not a
    stacked FFN, so ``masked`` and ``shrunk`` raise, as they fail in the
    reference.
    ``attn_impl`` goes to every ``LM`` built: the default ``"pallas"`` scores
    through the ``flash_attention``/``ssd_scan`` kernels, as the reference's
    does (decode runs ``decode_attention`` either way).
    """
    from repro_torch.models.lm import LM

    if serve_mode not in SERVE_MODES:
        raise ValueError(
            f"serve_mode must be one of {SERVE_MODES}, got {serve_mode!r}")
    dev = _device.resolve(device)

    if hasattr(source, "artifacts") and hasattr(source, "params"):
        art: dict = {"params": source.params, "kept": None,
                     "filter_masks": None, "mode": None, "model_config": None}
        for entry in source.artifacts.values():
            if isinstance(entry, dict) and "kept" in entry:
                art["kept"] = dict(entry["kept"] or {})
                art["filter_masks"] = (dict(entry["filter_masks"])
                                       if entry.get("filter_masks") else None)
                art["mode"] = entry.get("mode")
    elif isinstance(source, dict):
        art = source
    else:
        from repro_torch.core.plan import load_artifact

        art = load_artifact(source)

    cfg = _port_config(model_config or art.get("model_config"))
    if cfg is None:
        raise ValueError(
            "no model config: the checkpoint was saved without one — pass "
            "model_config=")
    params = interop.params_from_jax(art["params"], dev)
    kept = art.get("kept")
    mode = serve_mode
    if mode == "auto":
        mode = ("dense" if kept is None
                else "shrunk" if art.get("mode") == "shrink" else "masked")

    # trust the param shapes over the recorded d_ff (a shrink-mode run's
    # params are already compacted relative to its training-time config)
    d_ff = _infer_d_ff(params)
    if d_ff is not None and d_ff != cfg.d_ff:
        cfg = dataclasses.replace(cfg, d_ff=d_ff)
    experts = _infer_experts(params)
    if cfg.moe and experts is not None and experts != cfg.moe.num_experts:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, num_experts=experts))

    if mode == "dense":
        return Servable(LM(cfg, attn_impl=attn_impl, device=dev), params, None, mode)

    if kept is None:
        raise ValueError(
            f"serve_mode={mode!r} needs a pruned checkpoint, but this one "
            f"carries no kept-filter decision (train with a Prune event, "
            f"or serve dense)")
    if cfg.family == "encdec":
        raise ValueError(
            f"serve_mode={mode!r} needs a stacked FFN to mask or shrink; "
            f"family 'encdec' ({cfg.name}) serves dense")

    if mode == "masked":
        model = LM(cfg, attn_impl=attn_impl, device=dev)
        masks = art.get("filter_masks")
        if masks is None:
            masks = model.filter_masks(params, kept)
        else:
            masks = interop.masks_from_jax(masks, dev)
        return Servable(model, params, masks, mode)

    # shrunk: compact (a no-op if the checkpoint is already shrink-mode —
    # its kept width equals the param width)
    from repro_torch.core import pruning_lm

    idx = kept["mlp"]
    width = int(idx.shape[-1])
    if width != d_ff:
        params = pruning_lm.shrink_ffn_at(params, idx)
        cfg = dataclasses.replace(cfg, d_ff=width)
    return Servable(LM(cfg, attn_impl=attn_impl, device=dev), params, None, mode)
