"""The dense decoder LM, functional: params are dicts of tensors.

Counterpart of the reference's ``models/lm.py`` for the ``dense`` family
(llama-style decoder: GQA + RoPE 1d/2d + SwiGLU or GELU MLP), with the
decode step, the KV cache and the FedAP pruning seam.  Layer params are
stacked along a leading ``[L, ...]`` axis as in the reference, so a JAX
param tree converts leaf for leaf (:mod:`repro_torch.interop`).

Params: ``{"embed" [V,d], "unembed" [d,V] (untied only), "norm_out",
"layers": {"attn": {wq, wk, wv, wo}, "norm_a", "norm_f",
"mlp": {wi, wg, wo}}}``.
"""
from __future__ import annotations

import math

import torch

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class LM:
    """``init``, ``init_cache`` and ``decode_step`` of a dense decoder, on
    ``device`` (default ``"cuda"``, which raises when CUDA is missing)."""

    def __init__(self, cfg: ModelConfig, *, device="cuda"):
        if cfg.family != "dense":
            raise ValueError(
                f"repro_torch.models.LM ports the 'dense' family only so far, "
                f"not {cfg.family!r} ({cfg.name})")
        if cfg.param_dtype not in DTYPES:
            raise ValueError(f"param_dtype must be one of {sorted(DTYPES)}, "
                             f"got {cfg.param_dtype!r}")
        self.cfg = cfg
        self.device = _device.resolve(device)
        self.dtype = DTYPES[cfg.param_dtype]

    # -- init -----------------------------------------------------------------
    def init(self, generator: torch.Generator) -> dict:
        """Random params drawn from ``generator`` (which must live on this
        model's device): normal with the reference's per-tensor scales."""
        cfg = self.cfg
        params = {"embed": L._init_normal(
            (cfg.vocab_size, cfg.d_model), 1.0 / math.sqrt(cfg.d_model),
            self.dtype, generator, self.device)}
        if not cfg.tie_embeddings:
            params["unembed"] = L._init_normal(
                (cfg.d_model, cfg.vocab_size), 1.0 / math.sqrt(cfg.d_model),
                self.dtype, generator, self.device)
        params["norm_out"] = L.init_norm(cfg, self.dtype, self.device)
        params["layers"] = L.init_layer_stack(cfg, cfg.num_layers, self.dtype,
                                              generator, self.device)
        return params

    # -- forward pieces ---------------------------------------------------------
    def _head(self, params, x):
        cfg = self.cfg
        x = L.apply_norm(params.get("norm_out", {}), x, cfg.norm)
        if cfg.tie_embeddings:
            return x @ params["embed"].T
        return x @ params["unembed"]

    # -- FedAP seam -------------------------------------------------------------
    def decide_kept(self, params, p_star, *, align=128) -> dict:
        """``{"mlp": [L, keep]}`` kept-unit index rows (host numpy) from the
        aggregate prune rate — weight-norm product scores, a uniform
        ``align``-lane kept count (:mod:`repro_torch.core.pruning_lm`)."""
        from repro_torch.core import pruning_lm

        return {"mlp": pruning_lm.ffn_kept_indices(
            params, self.cfg, float(p_star), align=align)}

    def filter_masks(self, params, kept) -> dict:
        """``{"mlp": [L, d_ff] 0/1}`` keep-masks for masked decode."""
        from repro_torch.core import pruning_lm

        return pruning_lm.ffn_filter_masks(params, kept)

    def param_masks(self, params, kept) -> dict:
        """Param-structured 0/1 masks (wi/wg columns + wo rows)."""
        from repro_torch.core import pruning_lm

        return pruning_lm.ffn_param_masks(params, kept)

    def shrink_params(self, params, kept) -> dict:
        """Gather the kept FFN units (params or any tree of the same
        structure)."""
        from repro_torch.core import pruning_lm

        idx = kept.get("mlp") if kept else None
        return params if idx is None else pruning_lm.shrink_ffn_at(params, idx)

    # -- decode -----------------------------------------------------------------
    def init_cache(self, batch_size: int, cache_len: int) -> dict:
        """``{"k", "v": [L, B, S, KV, hd], "index": 0-d int32}`` zeros, with
        S = ``cache_len`` (a ring buffer once the index passes S)."""
        cfg = self.cfg
        shape = (cfg.num_layers, batch_size, cache_len,
                 cfg.padded_num_kv_heads, cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=self.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=self.dtype, device=self.device),
                "index": torch.zeros((), dtype=torch.int32,
                                     device=self.device)}

    def decode_step(self, params, cache, batch, *, masks=None):
        """One-token decode.  ``batch["tokens"]`` [B,1].  Returns (logits
        [B,1,V], cache).

        ``cache["index"]`` is a 0-d tensor (lockstep decode) or an int32 [B]
        tensor (continuous batching: per-slot fill levels, which the rope
        positions, the cache writes and the attended prefix all follow).
        The K/V pages are updated in place and the returned cache holds the
        same tensors with ``index + 1``.

        ``masks`` (optional) ``{"mlp": [L, d_ff] 0/1}`` routes every layer's
        FFN through the block-skipping masked path; the logits equal the
        shrunk model's.
        """
        cfg = self.cfg
        x = params["embed"][batch["tokens"]]
        idx = cache["index"]
        off = idx if idx.ndim == 0 else idx[None, :, None]
        pos = L.default_positions(x.shape[0], 1, cfg.rope,
                                  device=x.device) + off
        lp = params["layers"]
        for i in range(cfg.num_layers):
            layer = {k: {n: t[i] for n, t in v.items()} for k, v in lp.items()}
            h = L.apply_norm(layer.get("norm_a", {}), x, cfg.norm)
            x = x + L.attention_decode(layer["attn"], h, cache["k"][i],
                                       cache["v"][i], idx, pos, cfg)
            h = L.apply_norm(layer.get("norm_f", {}), x, cfg.norm)
            x = x + L.apply_mlp(layer["mlp"], h, cfg.act,
                                None if masks is None else masks["mlp"][i])
        cache = {**cache, "index": idx + 1}
        return self._head(params, x), cache
