"""FedAP as a plan event: the Algorithm 3 decision.

Counterpart of the host path of the reference's ``core/fedap.py``:
per-participant expected rates from the empirical-Fisher eigen-gap (the
server and ``cfg.participants`` sampled devices, one after another), the
Formula 15 aggregate clipped to ``[min_rate, max_rate]``, then the kept
units: a model with a ``decide_kept`` seam (the scanned LM) picks them
from the aggregate rate; a model that publishes a ``PruneSpec`` (the
paper's CNNs) goes through the global magnitude threshold, per-layer
rates and HRank filter selection on a server probe batch.  The participant
draw is numpy, so it equals the reference's for the same seed.

Per-sample gradients are computed one sample at a time (the reference
vmaps them): at olmo-1b's width each is a 4.71 GB tree.

:func:`fedap_decision_sharded` is the mesh backend's step 1: the
participants split over the ranks, each rank probes its own, the rates are
all-gathered, and every rank finishes the same decision.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import numpy as np
import torch

import torch.distributed as dist

from repro_torch.core import engine, niid
from repro_torch.core.pruning import (
    FedAPConfig,
    PruneSpec,
    aggregate_rates,
    expected_rate_from_spectrum,
    feature_map_ranks,
    fisher_spectrum,
    global_threshold,
    lipschitz_estimate,
    per_layer_rates,
    select_filters,
)
from repro_torch.sharding import fl_specs
from repro_torch.utils.arrays import pad_rows_with_first
from repro_torch.utils.tree import tree_leaves, tree_map


def participant_rate(model, params, init_params, x, y,
                     cfg: FedAPConfig) -> torch.Tensor:
    """p*_k for one participant from its local probe data (the first
    ``cfg.probe_size`` samples of ``x``/``y``)."""
    probe = (x[: cfg.probe_size], y[: cfg.probe_size])

    def loss_one(p, xi, yi):
        return model.loss_and_acc(p, xi[None], yi[None])[0]

    def per_sample_grads(p, batch):
        return [engine.grad(loss_one, p, xi, yi) for xi, yi in zip(*batch)]

    eigs = fisher_spectrum(per_sample_grads, params, probe)

    def grad_fn(p, batch):
        return engine.grad(
            lambda q: model.loss_and_acc(q, batch[0], batch[1])[0], p)

    lip = lipschitz_estimate(grad_fn, params, init_params, probe)
    return expected_rate_from_spectrum(eigs, lip, cfg.max_rate)


def participant_rate_padded(model, params, init_params, x, y, row_mask,
                            n_valid: int, cfg: FedAPConfig) -> torch.Tensor:
    """p*_k from a PADDED probe: ``x``/``y`` hold ``n_valid`` real samples
    then padding rows (copies; their values never matter), ``row_mask`` the
    matching [rows] 0/1 validity.  Padded rows add nothing: their
    per-sample gradients are zeroed before the Gram products (the spectrum
    is the valid one plus exact zeros, skipped by ``valid=n_valid``), and
    the Lipschitz estimate differentiates the validity-weighted mean loss.
    With every row valid this is :func:`participant_rate` up to summation
    order."""
    def loss_one(p, xi, yi):
        return model.loss_and_acc(p, xi[None], yi[None])[0]

    def per_sample_grads(p, batch):
        bx, by, bm = batch
        return [tree_map(lambda t, mi=mi: t.mul_(mi),
                         engine.grad(loss_one, p, xi, yi))
                for xi, yi, mi in zip(bx, by, bm)]

    batch = (x, y, row_mask)
    eigs = fisher_spectrum(per_sample_grads, params, batch, n_valid=n_valid)

    def grad_fn(p, b):
        bx, by, bm = b

        def masked_loss(q):
            losses = torch.stack([loss_one(q, xi, yi)
                                  for xi, yi in zip(bx, by)])
            return (losses * bm).sum() / float(n_valid)
        return engine.grad(masked_loss, p)

    lip = lipschitz_estimate(grad_fn, params, init_params, batch)
    return expected_rate_from_spectrum(eigs, lip, cfg.max_rate,
                                       valid=n_valid)


@dataclasses.dataclass
class FedAPDecision:
    """The output of Algorithm 3: which units each prunable layer keeps."""

    kept: dict[str, np.ndarray]        # layer -> sorted kept indices [keep]
                                       # (stacks: [L, keep] kept-unit rows)
    p_star: float                      # Formula-15 aggregate rate
    layer_rates: dict[str, float]      # per-layer rate

    def summary(self) -> dict[str, Any]:
        """JSON-friendly view (kept reduced to per-layer counts)."""
        return {"p_star": self.p_star, "layer_rates": dict(self.layer_rates),
                "kept_counts": {k: int(np.asarray(v).shape[-1])
                                for k, v in self.kept.items()}}


def _draw_participants(data, cfg: FedAPConfig, rng: np.random.Generator
                       ) -> np.ndarray:
    """The probed client subset (index 0 of the rate vectors is always the
    server), clamped to the available clients with a warning."""
    num_clients = data.client_x.shape[0]
    draw = min(cfg.participants, num_clients)
    if draw < cfg.participants:
        warnings.warn(
            f"FedAPConfig.participants={cfg.participants} exceeds the "
            f"{num_clients} available clients; probing all {num_clients} "
            "instead (every client's local data contributes a rate)",
            stacklevel=3)
    return rng.choice(num_clients, size=draw, replace=False)


def _finish_decision(model, data, cfg: FedAPConfig, params: Any, rates,
                     sizes, degrees) -> FedAPDecision:
    """Algorithm 3 after step 1: Formula 15 and the ``[min_rate,
    max_rate]`` clip, then the model's ``decide_kept`` or, for a
    ``PruneSpec`` model, the global magnitude threshold, per-layer rates and
    HRank selection on the first ``cfg.probe_size`` server samples."""
    p_star = aggregate_rates(rates, sizes, degrees, cfg.eps)
    p_star = torch.clamp(p_star, cfg.min_rate, cfg.max_rate)
    if hasattr(model, "decide_kept"):
        kept = {k: np.asarray(v) for k, v in
                model.decide_kept(params, float(p_star),
                                  align=cfg.align).items()}
        widths = {k: int(m.shape[-1])
                  for k, m in model.filter_masks(params, kept).items()}
        return FedAPDecision(
            kept=kept, p_star=float(p_star),
            layer_rates={k: 1.0 - v.shape[-1] / widths[k]
                         for k, v in kept.items()})

    spec: PruneSpec = model.prune_spec(params)
    layer_rates = per_layer_rates(params, spec,
                                  global_threshold(params, spec, p_star))
    dev = tree_leaves(params)[0].device
    probe_x = torch.as_tensor(np.asarray(data.server_x[: cfg.probe_size]),
                              device=dev)
    scores = _probe_scores(model, params, spec, probe_x)
    kept = {l.name: select_filters(scores[l.name],
                                   float(layer_rates[l.name]),
                                   align=cfg.align)
            for l in spec.layers}
    return FedAPDecision(kept=kept, p_star=float(p_star),
                         layer_rates={k: float(v)
                                      for k, v in layer_rates.items()})


def _probe_scores(model, params, spec: PruneSpec, probe_x
                  ) -> dict[str, np.ndarray]:
    """{layer name: [d_l] HRank scores} from one forward of the probe
    batch, as host float32 arrays."""
    with torch.no_grad():
        fmaps = model.feature_maps(params, probe_x)
        return {l.name: feature_map_ranks(fmaps[l.feature_key or l.name])
                .cpu().numpy() for l in spec.layers}


def fedap_decision(model, data, cfg: FedAPConfig, params: Any, *,
                   init_params: Any, rng: np.random.Generator | None = None
                   ) -> FedAPDecision:
    """Algorithm 3: expected rates -> Formula 15 -> kept units.  A pure
    decision on the params' device; applying it is the executor's job.
    ``init_params`` are the params the run started from (the Lipschitz
    estimate's second point)."""
    rng = np.random.default_rng(0) if rng is None else rng
    dev = tree_leaves(params)[0].device
    p_bar = niid.global_distribution(data.client_dists, data.sizes)

    def on_dev(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    ids = _draw_participants(data, cfg, rng)
    rates = [participant_rate(model, params, init_params,
                              on_dev(data.server_x), on_dev(data.server_y),
                              cfg)]
    sizes = [float(data.server_x.shape[0])]
    degrees = [niid.non_iid_degree(data.server_dist, p_bar)]
    for k in ids:
        rates.append(participant_rate(model, params, init_params,
                                      on_dev(data.client_x[k]),
                                      on_dev(data.client_y[k]), cfg))
        sizes.append(float(data.sizes[k]))
        degrees.append(niid.non_iid_degree(data.client_dists[k], p_bar))
    return _finish_decision(model, data, cfg, params,
                            torch.stack([r.cpu() for r in rates]),
                            torch.tensor(sizes), torch.stack(degrees))


def fedap_decision_sharded(model, data, cfg: FedAPConfig, params: Any, *,
                           init_params: Any,
                           rng: np.random.Generator | None = None,
                           mesh=None, client_axes: tuple = ("data",)
                           ) -> FedAPDecision:
    """Algorithm 3 with step 1 split over the ranks of ``mesh``'s client
    axes (the mesh backend's Prune; every other mesh dim must have size 1).

    The probes (the server's first, then each drawn client's, as
    :func:`fedap_decision` draws them) are cut to ``cfg.probe_size`` rows
    and padded to the widest with copies of their own first row
    (:func:`~repro_torch.utils.arrays.pad_rows_with_first`).  Rank r probes
    its contiguous block of participants: :func:`participant_rate` for
    rectangular probes (the host path's step 1 verbatim), or
    :func:`participant_rate_padded` with a row mask when they are ragged.
    The rates are all-gathered, and every rank runs the same steps 2-4
    (``_finish_decision``), so every rank makes the host path's decision up
    to float tolerance, and exactly it where the probes are rectangular.
    ``mesh=None`` probes everything here."""
    rng = np.random.default_rng(0) if rng is None else rng
    dev = tree_leaves(params)[0].device
    p_bar = niid.global_distribution(data.client_dists, data.sizes)
    ids = _draw_participants(data, cfg, rng)

    probe = cfg.probe_size
    n0, n_k = data.server_x.shape[0], data.client_x.shape[1]
    takes = np.asarray([min(probe, n0)] + [min(probe, n_k)] * len(ids))
    p_max = int(takes.max())
    ragged = bool((takes != p_max).any())
    pools = ([(data.server_x, data.server_y)]
             + [(data.client_x[k], data.client_y[k]) for k in ids])
    rank, world = ((0, 1) if mesh is None
                   else fl_specs.client_rank(mesh, client_axes))
    if world > 1 and dist.get_world_size() != world:
        raise ValueError(
            f"fedap_decision_sharded gathers over the process group, which "
            f"has {dist.get_world_size()} ranks, but the mesh's client axes "
            f"{client_axes} have {world}: other mesh dims must have size 1")
    n_part = len(pools)
    per = -(-n_part // world)
    # the stack padded to a multiple of the ranks: client_rows' block
    block = (None if mesh is None else fl_specs.client_rows(
        fl_specs.client_plan(mesh, client_axes), client_axes, per * world))
    block = range(per * world) if block is None else block
    mine = range(block.start, min(block.stop, n_part))

    def probe_rows(a, take):
        return torch.as_tensor(pad_rows_with_first(np.asarray(a[:take]),
                                                   p_max), device=dev)

    local = torch.zeros((per,), dtype=torch.float32, device=dev)
    for j, i in enumerate(mine):
        (xa, ya), take = pools[i], int(takes[i])
        x, y = probe_rows(xa, take), probe_rows(ya, take)
        if ragged:
            row_mask = (torch.arange(p_max, device=dev) < take).float()
            r = participant_rate_padded(model, params, init_params, x, y,
                                        row_mask, take, cfg)
        else:
            r = participant_rate(model, params, init_params, x, y, cfg)
        local[j] = r.to(dev)
    if world > 1:
        parts = [torch.empty_like(local) for _ in range(world)]
        dist.all_gather(parts, local)
        local = torch.cat(parts)
    rates = local[:n_part].cpu()
    sizes = torch.tensor([float(n0)] + [float(data.sizes[k]) for k in ids])
    degrees = torch.stack(
        [niid.non_iid_degree(data.server_dist, p_bar)]
        + [niid.non_iid_degree(data.client_dists[k], p_bar) for k in ids])
    return _finish_decision(model, data, cfg, params, rates, sizes, degrees)
