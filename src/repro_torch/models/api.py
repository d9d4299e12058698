"""The model-building API and the input batch of every (arch x shape).

Counterpart of the reference's ``models/api.py``.  :func:`input_specs` says
what each input shape means per family: meta-device tensors
(``abstract=True``: shapes and dtypes, no storage) or concrete arrays drawn
from ``np.random.default_rng(seed)`` in the reference's order, so they equal
the reference's value for value.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models.lm import DTYPES, LM


def build_model(cfg: ModelConfig, *, attn_impl: str = "xla",
                device="cuda", mesh=None) -> LM:
    """The model; with ``mesh`` (a ``DeviceMesh`` with a ``"model"`` dim,
    or a mesh known by its shape, whose collectives are then recorded),
    this rank's block of it (:meth:`LM.shard`) under
    ``sharding.specs.make_plan(mesh, cfg)``.  A family other than dense on
    a ``model`` dim wider than one, and an FSDP axis wider than one, raise
    (ROADMAP queue 1)."""
    model = LM(cfg, attn_impl=attn_impl, device=device)
    if mesh is None:
        return model
    from repro_torch.sharding import tp
    from repro_torch.sharding.specs import (axis_sizes, make_plan,
                                            mesh_coords)

    plan = make_plan(mesh, cfg)
    if cfg.family != "dense" and axis_sizes(mesh).get("model", 1) == 1 \
            and plan.axis_size(plan.fsdp_axes) == 1:
        return model            # nothing of it is split
    return model.shard(plan, mesh_coords(mesh), tp.group_of(mesh, ("model",)))


def _pos_streams(cfg: ModelConfig) -> int:
    return {"none": 1, "1d": 1, "2d": 2, "mrope": 3}[cfg.rope]


def decode_cache_len(cfg: ModelConfig, shape: InputShape) -> int:
    """Visible context during decode: long_500k uses the sliding window
    (ring buffer) for archs that have one."""
    if shape.name == "long_500k" and cfg.sliding_window:
        return min(shape.seq_len, cfg.sliding_window)
    return shape.seq_len


def input_specs(cfg: ModelConfig, shape: InputShape, *, abstract: bool = True,
                seed: int = 0, device="cuda") -> dict[str, Any]:
    """The batch dict of (cfg, shape).

    abstract=True   meta-device tensors (shapes and dtypes only);
    abstract=False  random tensors on ``device`` (default CUDA): integers in
                    ``[0, vocab)`` (positions in ``[0, seq_len)``), floats
                    standard normal, the vlm ``loss_mask`` 1 where a uniform
                    draw exceeds 0.25.
    """
    b, s = shape.global_batch, shape.seq_len
    dtype = DTYPES[cfg.param_dtype]
    dev = torch.device("meta") if abstract else _device.resolve(device)
    rng = np.random.default_rng(seed)

    def arr(shp, dt, high=None):
        if abstract:
            return torch.empty(shp, dtype=dt, device=dev)
        if not dt.is_floating_point:
            a = rng.integers(0, high or cfg.vocab_size, shp)
        else:
            a = rng.standard_normal(shp)
        return torch.from_numpy(a).to(device=dev, dtype=dt)

    s_tok = 1 if shape.kind == "decode" else s
    batch: dict[str, Any] = {}
    if cfg.family == "vlm":
        batch["embeds"] = arr((b, s_tok, cfg.d_model), dtype)
        batch["positions"] = arr((_pos_streams(cfg), b, s_tok), torch.int32,
                                 high=s)
    elif cfg.family == "encdec":
        batch["enc_embeds"] = arr((b, cfg.encoder.frames, cfg.d_model), dtype)
        batch["tokens"] = arr((b, s_tok), torch.int32)
    else:
        batch["tokens"] = arr((b, s_tok), torch.int32)

    if shape.kind == "train":
        batch["labels"] = arr((b, s_tok), torch.int32)
        if cfg.family == "vlm":
            # vision-token positions are excluded from the LM loss
            if abstract:
                batch["loss_mask"] = torch.empty((b, s_tok),
                                                 dtype=torch.float32,
                                                 device=dev)
            else:
                batch["loss_mask"] = torch.from_numpy(
                    rng.random((b, s_tok)) > 0.25).to(device=dev,
                                                     dtype=torch.float32)
    return batch
