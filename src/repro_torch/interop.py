"""Carry parameter trees between the JAX package and the port.

Trees are nested dicts with numpy-convertible leaves on the JAX side (what
``np.asarray`` makes of a JAX array, or a checkpoint's ``arrays.npz``) and
tensors on the port side.  The LM keeps the SAME layouts (``wq [d,H,hd]``,
``wo [H,hd,d]``, stacked ``[L, ...]`` layers), so leaves compare one for
one; the paper's CNNs hold conv kernels as OIHW where the reference holds
HWIO (:func:`cnn_params_from_jax`, :func:`cnn_params_to_numpy`,
``round_state_from_jax(cnn=True)``).
bfloat16 leaves cross bit-exactly in both directions (as raw 16-bit words
into the port; as float32, which holds every bfloat16 value, out of it).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.utils.tree import tree_map


def _leaf_to_torch(leaf, device, dtype):
    if isinstance(leaf, torch.Tensor):
        return leaf.to(device=device, dtype=dtype or leaf.dtype)
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":          # ml_dtypes' numpy bfloat16
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


# Leaves the reference keeps in f32 whatever the model's dtype, by the end
# of their path: the MoE router, the Mamba2 mixer's A_log, D and dt_bias,
# the mLSTM gate projection w_if and the sLSTM cell's bias.
F32_LEAVES = (("router",), ("A_log",), ("D",), ("dt_bias",), ("w_if",),
              ("cell", "bias"))


def _keeps_f32(path: tuple) -> bool:
    return any(path[-len(end):] == end for end in F32_LEAVES)


def params_from_jax(tree, device="cuda", dtype=None) -> dict:
    """A JAX/numpy param tree of any family (``embed``, ``norm_out``,
    ``layers/{attn:{wq,wk,wv,wo}, norm_a, norm_f, mlp:{wi,wg,wo}}`` of the
    stacked families, ``blocks/l<i>`` of ssm, ``enc_pos``, ``norm_enc``,
    ``encoder/l<i>`` and ``decoder/l<i>`` (with ``xattn``, ``norm_x``) of
    encdec, ...), walked leaf for leaf, as tensors on ``device``, cast to
    ``dtype`` when given, except the leaves that the reference keeps in f32
    in a model of any dtype (:data:`F32_LEAVES`; a layernorm's ``bias`` is
    not the sLSTM cell's): those keep their own dtype."""
    dev = _device.resolve(device)

    def convert(node, path):
        if isinstance(node, dict):
            return {k: convert(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(convert(v, path) for v in node)
        keep = dtype is None or _keeps_f32(path)
        return _leaf_to_torch(node, dev, None if keep else dtype)

    return convert(tree, ())


def shard_params_from_jax(tree, model, device="cuda", dtype=None) -> dict:
    """A JAX/numpy param tree of the whole model, as :func:`params_from_jax`
    makes it, cut to the block of a rank's ``model`` (``LM.shard``): every
    leaf through ``sharding.specs.shard_tree`` under the model's plan, its
    query heads in the [g, kv] grouping."""
    from repro_torch.sharding.specs import shard_tree

    whole = params_from_jax(tree, "cpu", dtype)
    if model.tp is None:
        return tree_map(lambda t: t.to(_device.resolve(device)), whole)
    mine = shard_tree(whole, model.block_specs(), model._plan,
                      model._coords, axes=model.axes(),
                      kv_heads=model.cfg.padded_num_kv_heads)
    return tree_map(lambda t: t.clone(memory_format=torch.contiguous_format)
                    .to(_device.resolve(device)), mine)


def _hwio_to_oihw(t: torch.Tensor, lead: int = 0) -> torch.Tensor:
    """A conv kernel HWIO -> OIHW behind ``lead`` leading axes (FedDyn's
    per-client ``[N, ...]``); a leaf of another rank is returned as is."""
    if t.ndim - lead != 4:
        return t
    perm = tuple(range(lead)) + tuple(lead + i for i in (3, 2, 0, 1))
    return t.permute(*perm).contiguous()


def cnn_params_from_jax(tree, device="cuda") -> dict:
    """A paper-CNN param tree of the reference (conv kernels HWIO) as the
    port's on ``device``: every 4-D leaf, a conv kernel, is transposed to
    OIHW; every other leaf (biases, GroupNorm scales, dense and ``fc1``'s
    ``[spatial, C, out]`` weights) is copied as it is."""
    dev = _device.resolve(device)
    return tree_map(lambda x: _hwio_to_oihw(_leaf_to_torch(x, dev, None)),
                    tree)


def cnn_params_to_numpy(tree) -> dict:
    """The inverse of :func:`cnn_params_from_jax`: host numpy in the
    reference's layouts (conv kernels OIHW -> HWIO)."""
    def leaf(a):
        return np.ascontiguousarray(a.transpose(2, 3, 1, 0)) if a.ndim == 4 \
            else a

    return tree_map(leaf, params_to_numpy(tree))


def cache_from_jax(cache, device="cuda") -> dict:
    """A JAX decode cache (``LM.init_cache``'s tree as numpy or JAX arrays,
    e.g. one taken mid-stream) as the port's, leaf for leaf on ``device``,
    every leaf keeping its dtype: dense, moe and vlm ``{"k", "v",
    "index"}``, hybrid ``{"mamba": {"conv", "h"}, "shared_attn": {"k",
    "v"}, "index"}``, ssm ``{"l<i>": (C, N, m) | (c, n, h, m), "index"}``
    (the recurrent states stay tuples) or encdec ``{"self": {"k", "v"},
    "cross": {"k", "v"}, "index"}``."""
    if not isinstance(cache, dict) or "index" not in cache:
        raise ValueError(f"not a decode cache (a dict with an 'index' leaf): "
                         f"{type(cache).__name__}")
    return params_from_jax(cache, device)


def params_to_numpy(tree) -> dict:
    """The inverse of :func:`params_from_jax`: tensors -> host numpy
    (bfloat16 as float32, exact)."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return tree_map(leaf, tree)


def kept_from_jax(kept, device="cuda") -> dict:
    """FedAP kept-unit index rows ``{"mlp": [L, keep]}`` as int64 tensors."""
    dev = _device.resolve(device)
    return tree_map(lambda leaf: _leaf_to_torch(leaf, dev, torch.int64), kept)


def masks_from_jax(masks, device="cuda") -> dict:
    """FedAP filter keep-masks ``{"mlp": [L, d_ff]}`` as float32 tensors."""
    dev = _device.resolve(device)
    return tree_map(lambda leaf: _leaf_to_torch(leaf, dev, torch.float32),
                    masks)


ROUND_STATE_KEYS = ("params", "server_m", "global_m", "masks", "filter_masks",
                    "client_state", "round")


def round_state_from_jax(state, device="cuda", *, cnn: bool = False) -> dict:
    """A reference engine round state (``{"params", "server_m",
    ["global_m"], ["masks"], ["filter_masks"], ["client_state"],
    "round"}``, as numpy or JAX arrays) as tensors on ``device``, every
    leaf keeping its dtype, so the port's ``round_core`` and the
    reference's can start from one state.  ``cnn=True`` converts a paper
    CNN's state: every param-structured conv leaf HWIO -> OIHW, FedDyn's
    per-client ``h`` with its leading ``[N]`` axis kept in front."""
    unknown = set(state) - set(ROUND_STATE_KEYS)
    if unknown:
        raise ValueError(f"round state keys {sorted(unknown)} are not ported "
                         f"yet (known: {ROUND_STATE_KEYS})")
    out = params_from_jax(state, device)
    if not cnn:
        return out
    for k in ("params", "server_m", "global_m", "masks"):
        if k in out:
            out[k] = tree_map(_hwio_to_oihw, out[k])
    if "client_state" in out:
        cs = out["client_state"]
        cs["per_client"] = tree_map(lambda t: _hwio_to_oihw(t, 1),
                                    cs["per_client"])
        cs["shared"] = tree_map(_hwio_to_oihw, cs["shared"])
    return out
