"""Logical axes -> placements over a device mesh.

Counterpart of the reference's ``sharding/specs.py``, with the same rules:
the mesh is ``(data, model)`` or ``(pod, data, model)``; FL clients live on
``data`` (x ``pod``) for the archs up to ~10B (``fl_client_axis="data"``),
and on ``pod`` for the cross-silo giants, whose params are FSDP-sharded
over ``data``; tensor parallelism shards head, FFN, vocab, expert and SSM
dims over ``model``.  A dim that does not divide its mesh axes stays
replicated, and no mesh axis shards two dims of one tensor.

A :class:`Spec` holds a tensor's per-dim mesh axes (``parts``, the
reference's ``PartitionSpec`` entries) and the DTensor placements they
mean, one per mesh dim (``Shard(d)`` or ``Replicate()``), as
``torch.distributed.tensor.distribute_tensor`` takes them.  The mesh may be
a ``DeviceMesh`` or anything whose ``shape`` maps axis names to sizes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

# logical axis -> candidate mesh-axis role
_TP_AXES = {"vocab", "heads", "kv_heads", "mlp", "expert_mlp", "experts",
            "ssm_inner"}
_FSDP_AXES = {"embed"}


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` in the mesh's dim order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def to_placements(parts: tuple, names: tuple) -> tuple:
    """DTensor placements (one per mesh dim in ``names``) of per-dim mesh
    axes ``parts`` (None, an axis name, or a tuple of names)."""
    out = []
    for name in names:
        dims = [d for d, p in enumerate(parts)
                if p == name or (isinstance(p, tuple) and name in p)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Spec:
    """One tensor's placement: ``parts[d]`` the mesh axes sharding tensor
    dim ``d`` (None: none), ``placements`` the DTensor placements."""

    parts: tuple
    placements: tuple


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    mesh: Any
    multi_pod: bool
    client_axes: tuple          # mesh axes hosting FL clients
    fsdp_axes: tuple            # mesh axes for parameter FSDP
    tp_axes: tuple              # mesh axes for tensor parallelism
    batch_axes: tuple           # mesh axes sharding the within-client batch
    num_clients: int

    @property
    def axis_names(self) -> tuple:
        return tuple(axis_sizes(self.mesh))

    def axis_size(self, names: tuple) -> int:
        sizes = axis_sizes(self.mesh)
        s = 1
        for n in names:
            s *= sizes[n]
        return s

    def spec(self, parts) -> Spec:
        parts = tuple(parts)
        return Spec(parts, to_placements(parts, self.axis_names))


def make_plan(mesh, cfg: ModelConfig) -> MeshPlan:
    multi_pod = "pod" in axis_sizes(mesh)
    if cfg.fl_client_axis == "data":
        client_axes = ("pod", "data") if multi_pod else ("data",)
        fsdp_axes = ()
        batch_axes = ()
    elif cfg.fl_client_axis == "pod":
        client_axes = ("pod",) if multi_pod else ()
        fsdp_axes = ("data",) if cfg.fsdp else ()
        batch_axes = ("data",)
    else:
        client_axes = ()
        fsdp_axes = ("data",) if cfg.fsdp else ()
        batch_axes = ("data",) if not multi_pod else ("pod", "data")
    plan = MeshPlan(mesh=mesh, multi_pod=multi_pod, client_axes=client_axes,
                    fsdp_axes=fsdp_axes, tp_axes=("model",),
                    batch_axes=batch_axes, num_clients=1)
    return dataclasses.replace(plan,
                               num_clients=plan.axis_size(client_axes))


def _axis(axes: tuple):
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def _divisible(dim: int, plan: MeshPlan, axes: tuple) -> bool:
    return dim % plan.axis_size(axes) == 0 if axes else True


def _parts_for(shape: tuple, logical: tuple, plan: MeshPlan, *,
               client_leading: bool) -> list:
    """Per-dim mesh axes of one tensor from its logical axis names."""
    parts: list = []
    used: set = set()
    offset = 0
    if client_leading:
        ca = plan.client_axes
        if ca and _divisible(shape[0], plan, ca):
            parts.append(_axis(ca))
            used.update(ca)
        else:
            parts.append(None)
        offset = 1
    for i, name in enumerate(logical):
        dim = shape[offset + i]
        target: Optional[tuple] = None
        if name in _TP_AXES:
            target = plan.tp_axes
        elif name in _FSDP_AXES and plan.fsdp_axes:
            target = plan.fsdp_axes
        if (target and not used.intersection(target)
                and _divisible(dim, plan, target)):
            parts.append(_axis(target))
            used.update(target)
        else:
            parts.append(None)
    return parts


def _axes_leaves(axes: Any) -> list:
    """The logical-axis tuples of an axes tree (dicts in sorted key order,
    as :func:`tree_leaves` lists the params)."""
    if isinstance(axes, dict):
        return [a for k in sorted(axes) for a in _axes_leaves(axes[k])]
    return [tuple(axes)]


def param_specs(shapes: Any, axes: Any, plan: MeshPlan, *,
                client_leading: bool = False) -> Any:
    """The :class:`Spec` tree of a param tree.  ``shapes``: tensors (meta
    ones do); ``axes``: the model's logical-axis tree (``LM.axes()``).
    ``client_leading``: every leaf carries a leading FL-client dim."""
    s_leaves = tree_leaves(shapes)
    a_leaves = _axes_leaves(axes)
    if len(s_leaves) != len(a_leaves):
        raise ValueError(f"param/axes tree mismatch: {len(s_leaves)} vs "
                         f"{len(a_leaves)}")
    return tree_unflatten(shapes, [
        plan.spec(_parts_for(tuple(s.shape), ax, plan,
                             client_leading=client_leading))
        for s, ax in zip(s_leaves, a_leaves)])


def batch_specs(batch: Any, plan: MeshPlan, *,
                client_leading: bool = False) -> Any:
    """The leading client dim over the client axes (if present), then the
    batch dim over ``batch_axes``; everything else replicated."""
    def one(leaf):
        shp = tuple(leaf.shape)
        parts: list = []
        i = 0
        if client_leading:
            ca = plan.client_axes
            ok = ca and shp[0] % plan.axis_size(ca) == 0
            parts.append(_axis(ca) if ok else None)
            i = 1
            if len(shp) > 1:        # [C, steps, b, ...]: steps unsharded
                parts.append(None)
                i = 2
        ba = plan.batch_axes
        if i < len(shp) and ba and shp[i] % plan.axis_size(ba) == 0:
            parts.append(_axis(ba))
            i += 1
        while i < len(shp):
            parts.append(None)
            i += 1
        return plan.spec(parts[: len(shp)])

    return tree_map(one, batch)


def cache_specs(cache_shapes: Any, plan: MeshPlan, cfg: ModelConfig) -> Any:
    """Decode caches: [L, B, S, KV, hd] with B over the client and batch
    axes and the kv heads over ``model`` when they divide; SSM states
    alike."""
    all_batch = plan.client_axes + plan.batch_axes
    kvh = cfg.padded_num_kv_heads

    def fits(dim, axes):
        return axes and dim % plan.axis_size(axes) == 0

    def one(leaf):
        shp = tuple(leaf.shape)
        nd = len(shp)
        parts = [None] * nd
        if nd == 5:        # [L, B, S, KV, hd]
            if fits(shp[1], all_batch):
                parts[1] = _axis(all_batch)
            if shp[3] == kvh and fits(shp[3], plan.tp_axes):
                parts[3] = plan.tp_axes[0]
        elif nd == 4:      # [B, S, KV, hd] or [L, B, ...] ssm
            if fits(shp[0], all_batch):
                parts[0] = _axis(all_batch)
            elif fits(shp[1], all_batch):
                parts[1] = _axis(all_batch)
            if shp[2] == kvh and fits(shp[2], plan.tp_axes):
                parts[2] = plan.tp_axes[0]
        elif nd >= 1:
            if fits(shp[0], all_batch):
                parts[0] = _axis(all_batch)
            elif nd > 1 and fits(shp[1], all_batch):
                parts[1] = _axis(all_batch)
        return plan.spec(parts)

    return tree_map(one, cache_shapes)


# ---------------------------------------------------------------------------
# a rank's block of every leaf
# ---------------------------------------------------------------------------

def mesh_coords(mesh) -> dict:
    """``{axis name: this rank's coordinate}`` on each named dim of
    ``mesh``: a ``DeviceMesh``'s own coordinate, or rank 0's of a mesh
    known only by its shape (the dry run's)."""
    names = tuple(axis_sizes(mesh))
    get = getattr(mesh, "get_coordinate", None)
    coord = get() if get is not None else None
    if coord is None:
        return {n: 0 for n in names}
    return dict(zip(names, coord))


def _block(part, plan: MeshPlan, coords: dict) -> tuple[int, int]:
    """(this rank's block index, the number of blocks) of a dim split over
    ``part`` (an axis name or a tuple of them, the first the slowest)."""
    idx, ways = 0, 1
    for a in (part if isinstance(part, tuple) else (part,)):
        n = plan.axis_size((a,))
        idx, ways = idx * n + coords[a], ways * n
    return idx, ways


def head_index(num_heads: int, num_kv: int, ways: int, block: int):
    """The query heads a rank of a ``ways``-way split of ``"heads"`` holds,
    in its local order, as global indices; None for the contiguous block.

    Query head ``h = g * KV + kv`` attends kv head ``kv`` (the [g, kv]
    grouping of the attention and of K4/K5).  Where ``ways`` divides KV, the
    rank holds its block of kv heads, so it takes every ``g`` for them:
    heads ``g * KV + kv`` for kv in its block, ``g`` major.  Otherwise the
    K/V stay replicated and the contiguous block is the rank's block of
    ``g`` for every kv.  Either way its heads keep the [g, kv] grouping over
    the kv heads it holds."""
    if num_kv % ways or num_kv == num_heads:
        return None
    per = num_kv // ways
    g = torch.arange(num_heads // num_kv)
    kv = torch.arange(block * per, (block + 1) * per)
    return (g[:, None] * num_kv + kv[None, :]).reshape(-1)


def _take(leaf, spec: Spec, logical, plan, coords, kv_heads):
    for d, part in enumerate(spec.parts):
        if part is None:
            continue
        idx, ways = _block(part, plan, coords)
        rows = None
        if logical is not None and logical[d] == "heads" and kv_heads:
            rows = head_index(leaf.shape[d], kv_heads, ways, idx)
        if rows is None:
            per = leaf.shape[d] // ways
            leaf = leaf.narrow(d, idx * per, per)
        else:
            leaf = leaf.index_select(d, rows.to(leaf.device))
    return leaf


def _leaf_axes(tree, axes) -> list:
    leaves = tree_leaves(tree)
    if axes is None:
        return [None] * len(leaves)
    out = _axes_leaves(axes)
    if len(out) != len(leaves):
        raise ValueError(f"tree/axes mismatch: {len(leaves)} vs {len(out)}")
    return out


def shard_tree(tree: Any, spec_tree: Any, plan: MeshPlan, coords: dict, *,
               axes: Any = None, kv_heads: int | None = None) -> Any:
    """This rank's block of every leaf of ``tree`` under its :class:`Spec`:
    along each split dim, block ``coords`` of the dim's mesh axes (a
    contiguous narrow: a view; meta tensors give the block's shape).
    With ``axes`` (the tree's logical-axis tree) and the model's padded
    ``kv_heads``, a ``"heads"`` dim takes the grouped heads of
    :func:`head_index` (a copy) where the split divides KV."""
    out = [_take(t, s, ax, plan, coords, kv_heads) for t, s, ax in zip(
        tree_leaves(tree), tree_leaves(spec_tree), _leaf_axes(tree, axes))]
    return tree_unflatten(tree, out)


def gather_tree(tree: Any, spec_tree: Any, plan: MeshPlan, groups: dict, *,
                axes: Any = None, kv_heads: int | None = None) -> Any:
    """The inverse of :func:`shard_tree` over the process groups: every
    split dim gathered whole from the ranks of ``groups[axis]`` (a
    ``sharding.tp.TPGroup``; one mesh axis a dim), the grouped heads put
    back in their places.  A collective: every rank of each group calls
    it."""
    def one(leaf, spec, logical):
        for d, part in enumerate(spec.parts):
            if part is None or plan.axis_size(
                    part if isinstance(part, tuple) else (part,)) == 1:
                continue        # not split, or over axes of one rank
            if isinstance(part, tuple):
                raise ValueError(f"gather_tree gathers one mesh axis a dim, "
                                 f"not {part}")
            group = groups[part]
            whole = group.all_gather(leaf, d)
            if logical is not None and logical[d] == "heads" and kv_heads \
                    and head_index(whole.shape[d], kv_heads, group.size,
                                   0) is not None:
                rows = torch.cat([head_index(whole.shape[d], kv_heads,
                                             group.size, r)
                                  for r in range(group.size)])
                whole = whole.index_select(d, torch.argsort(rows).to(
                    whole.device))
            leaf = whole
        return leaf

    out = [one(t, s, ax) for t, s, ax in zip(
        tree_leaves(tree), tree_leaves(spec_tree), _leaf_axes(tree, axes))]
    return tree_unflatten(tree, out)
