"""Placements of the FL step's state and batch trees.

Counterpart of the reference's ``sharding/fl_specs.py``, as
:class:`~repro_torch.sharding.specs.Spec` trees with the same rules.  The
mesh backend (``core.backend.MeshBackend``) reads
:func:`fl_sim_batch_specs` to split a round: a client-leading leaf sharded
over the client axes means each rank trains its block of the round's
clients, and a server batch sharded on its row dim means each server step
is a partial gradient per rank, summed over the ranks.
:func:`client_dim_sharding` is the one rule for every client-leading array
(the federated dataset, FedDyn's per-client ``h``, the FedAP probe stack),
and :func:`client_rows` the block of it a rank holds.
"""
from __future__ import annotations

from typing import Any

from repro_torch.sharding.specs import (
    MeshPlan,
    _axis,
    axis_sizes,
    param_specs,
)
from repro_torch.utils.tree import tree_map


def fl_state_specs(state_shapes: Any, model_axes: Any, plan: MeshPlan, *,
                   client_axes: tuple = (), filter_axes: Any = None) -> Any:
    """Round state ``{params, server_m, [global_m], [masks],
    [filter_masks], [client_state], round}``: every param-structured slot
    follows the params' model placement (TP/FSDP, replicated over the
    client axes); ``round`` and the kernel mode's ``filter_masks`` (every
    rank needs the whole block mask) are replicated.

    ``client_state``: leaves under ``per_client`` lead with the total
    client count and shard over ``client_axes`` (replicated when it does
    not divide); ``shared`` leaves follow the params.

    ``model_axes=None`` (simulation models publish no axis tree) replicates
    every param-structured slot: the batch's client axis is what shards.

    ``filter_axes`` (the model's ``filter_axes()``): the filter masks follow
    them, as the tensor-parallel step keeps them (a rank's units of each
    row); None replicates them, as the reference does."""
    def replicated(v):
        return tree_map(lambda leaf: plan.spec(()), v)

    def per_client_spec(leaf):
        dim = leaf.shape[0] if len(leaf.shape) else 0
        return client_dim_sharding(plan, client_axes, dim)

    def shared_spec(v):
        if model_axes is None:
            return replicated(v)
        return param_specs(v, model_axes, plan)

    def one(k, v):
        if k == "round":
            return plan.spec(())
        if k == "client_state":
            return {"per_client": tree_map(per_client_spec, v["per_client"]),
                    "shared": shared_spec(v["shared"])}
        if k == "filter_masks" and filter_axes is not None:
            return param_specs(v, filter_axes, plan)
        if k == "filter_masks" or model_axes is None:
            return replicated(v)
        return param_specs(v, model_axes, plan)

    return {k: one(k, v) for k, v in state_shapes.items()}


def client_dim_sharding(plan: MeshPlan, client_axes: tuple,
                        leading_dim: int):
    """The Spec of an array whose leading dim is the FL-client axis: over
    ``client_axes`` when the dim divides their size, else replicated.  One
    rule for every client-leading placement (the federated dataset,
    FedDyn's per-client ``h``, the FedAP probe stack), so they never
    disagree."""
    if client_axes and leading_dim % plan.axis_size(client_axes) == 0:
        return plan.spec((_axis(client_axes),))
    return plan.spec(())


def client_rank(mesh, client_axes: tuple) -> tuple[int, int]:
    """(this rank's index, the count) along ``mesh``'s client axes (a
    ``DeviceMesh``: its coordinate is this process's)."""
    names = tuple(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    rank, size = 0, 1
    for ax in client_axes:
        n = mesh.size(names.index(ax))
        rank = rank * n + coord[names.index(ax)]
        size *= n
    return rank, size


def client_plan(mesh, client_axes: tuple) -> MeshPlan:
    """A plan of ``mesh`` whose only split is the FL clients over
    ``client_axes`` (what the client-leading rules read)."""
    return MeshPlan(mesh=mesh, multi_pod="pod" in axis_sizes(mesh),
                    client_axes=tuple(client_axes), fsdp_axes=(),
                    tp_axes=(), batch_axes=(), num_clients=1)


def client_rows(plan: MeshPlan, client_axes: tuple,
                leading_dim: int) -> range | None:
    """The rows of a client-leading array of ``leading_dim`` rows that this
    rank holds under :func:`client_dim_sharding`: its contiguous block of
    ``leading_dim / ranks`` where the array is split over more than one
    rank, None where every rank holds every row (the dim does not divide,
    or the client axes have one rank)."""
    size = plan.axis_size(client_axes) if client_axes else 1
    if size == 1 or not any(client_dim_sharding(
            plan, client_axes, leading_dim).parts):
        return None
    rank, _ = client_rank(plan.mesh, client_axes)
    per = leading_dim // size
    return range(rank * per, (rank + 1) * per)


def fl_sim_batch_specs(clients_per_round: int, plan: MeshPlan, *,
                       server_batch: int | None = None,
                       with_active: bool = False) -> dict:
    """The simulation round batch (``engine.sample_round_batches``):

      client  (x [C, steps, b, ...], y [C, steps, b]): C over the client
              axes, so each rank trains its block of clients and the FedAvg
              sums are partial sums plus one sum over the ranks;
      sizes   [C]: alongside the client dim;
      server  (x [tau, b, ...], y [tau, b]): with ``server_batch`` given
              and dividing the client axes, each step's rows b over them
              (partial server gradients, summed over the ranks); else
              replicated;
      the non-IID scalars and ``sel``: replicated.

    A ``clients_per_round`` that does not divide the client axes falls
    back to replication."""
    ca = _axis(plan.client_axes)
    size = plan.axis_size(plan.client_axes) if plan.client_axes else 1
    ok = bool(plan.client_axes) and clients_per_round % size == 0
    cspec = plan.spec((ca,) if ok else ())
    sok = (bool(plan.client_axes) and server_batch is not None
           and server_batch % size == 0)
    sspec = plan.spec((None, ca) if sok else ())
    rep = plan.spec(())
    specs = {"client": (cspec, cspec), "sizes": cspec,
             "server": (sspec, sspec), "d_round": rep, "d_server": rep,
             "n0": rep, "sel": rep}
    if with_active:
        specs["active"] = cspec
    return specs


def fl_batch_partition_specs(batch_shapes: Any, plan: MeshPlan) -> Any:
    """The batch-dict step's batch ``{client, server, sizes, d_round,
    d_server, n0}``: client leaves [C, steps, b_c, ...] with C over the
    client axes and b_c over the batch axes (positions [C, steps, P, b_c,
    S]); server leaves [tau, b, ...] with b over every non-model axis
    (positions [tau, P, b, S])."""
    ca = _axis(plan.client_axes)
    ba = _axis(plan.batch_axes)
    server_axes = plan.client_axes + plan.batch_axes
    sa = _axis(server_axes)

    def one_client(leaf, bdim):
        nd = len(leaf.shape)
        parts = [None] * nd
        if plan.client_axes and \
                leaf.shape[0] % plan.axis_size(plan.client_axes) == 0:
            parts[0] = ca
        if plan.batch_axes and nd > bdim and \
                leaf.shape[bdim] % plan.axis_size(plan.batch_axes) == 0:
            parts[bdim] = ba
        return plan.spec(parts)

    def one_server(leaf, bdim=1):
        nd = len(leaf.shape)
        parts = [None] * nd
        if nd > bdim and server_axes and \
                leaf.shape[bdim] % plan.axis_size(server_axes) == 0:
            parts[bdim] = sa
        return plan.spec(parts)

    rep = plan.spec(())
    out = {
        "client": {k: one_client(v, 3 if k == "positions" else 2)
                   for k, v in batch_shapes["client"].items()},
        "server": {k: one_server(v, 2 if k == "positions" else 1)
                   for k, v in batch_shapes["server"].items()},
        "sizes": rep, "d_round": rep, "d_server": rep, "n0": rep,
    }
    for k in ("sel", "active"):
        if k in batch_shapes:
            out[k] = rep
    return out


def serve_batch_specs(batch_shapes: dict, plan: MeshPlan) -> dict:
    """Inference batches: the batch dim over every non-model axis
    (``positions`` [P, B, S] at dim 1, every other leaf at dim 0)."""
    axes = plan.client_axes + plan.batch_axes
    a = _axis(axes)

    def one(leaf, bdim):
        nd = len(leaf.shape)
        parts = [None] * nd
        if axes and nd > bdim and \
                leaf.shape[bdim] % plan.axis_size(axes) == 0:
            parts[bdim] = a
        return plan.spec(parts)

    return {k: one(v, 1 if k == "positions" else 0)
            for k, v in batch_shapes.items()}
