"""Baseline FL algorithms of the paper's evaluation (Section 4).

Counterpart of the reference's ``core/baselines.py``.  Every baseline runs
on the same :class:`~repro_torch.core.rounds.FederatedTrainer` engine:

  FedAvg        — plain local SGD + weighted averaging [5].
  FedProx       — FedAvg with a proximal pull toward the round-start model.
  FedDyn        — per-client dynamic regularization (engine client state).
  Data-sharing  — server data is shipped to the devices and mixed into the
                  local datasets [1].
  Hybrid-FL     — the server takes part as one more (big) client [11].
  ServerM       — FedDU + server-side momentum only [25].
  DeviceM       — FedDU + device-side restart momentum only [75].
  FedDA         — two-sided momentum with COMMUNICATED buffers [32].
  FedDF         — ensemble distillation on server data [22].
  FedKT         — knowledge transfer with hard pseudo-labels [4].
  IMC           — unstructured global magnitude pruning at the prune round
                  [62]; the mask is kept.
  PruneFL       — unstructured magnitude pruning, re-evaluated
                  periodically [33].
  HRank         — structured rank-based pruning at one FIXED rate for every
                  layer [34].

The unstructured baselines keep dense shapes (mask only); HRank shrinks
the model.  The distillation and pruning factories return callbacks
``fn(trainer, t, params) -> new params | None`` for
``TrainPlan.with_callback(rounds, fn, eval_every=...)``.

The data transforms are numpy, array-equal to the reference's.  The
distillation steps are torch autograd steps on the model's device; their
sample indices come from ``np.random.default_rng(seed)`` as the
reference's do, so both packages distill on the same samples.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.engine import grad
from repro_torch.core.pruning import (
    PruneSpec,
    feature_map_ranks,
    select_filters,
    shrink_params,
)
from repro_torch.core.rounds import FLConfig
from repro_torch.data.pipeline import FederatedData
from repro_torch.utils.tree import tree_leaves, tree_map


# ---------------------------------------------------------------------------
# Optimization baselines — FLConfig recipes
# ---------------------------------------------------------------------------

def fedavg_config(**kw) -> FLConfig:
    kw.setdefault("use_server_update", False)
    return FLConfig(**kw)


def feddu_config(**kw) -> FLConfig:
    kw.setdefault("use_server_update", True)
    return FLConfig(**kw)


def server_momentum_config(**kw) -> FLConfig:
    kw.setdefault("use_server_update", True)
    kw.setdefault("server_momentum", True)
    kw.setdefault("local_momentum", "none")
    return FLConfig(**kw)


def device_momentum_config(**kw) -> FLConfig:
    kw.setdefault("use_server_update", True)
    kw.setdefault("server_momentum", False)
    kw.setdefault("local_momentum", "restart")
    return FLConfig(**kw)


def fedda_config(**kw) -> FLConfig:
    kw.setdefault("use_server_update", True)
    kw.setdefault("server_momentum", True)
    kw.setdefault("local_momentum", "communicated")
    return FLConfig(**kw)


def fedprox_config(**kw) -> FLConfig:
    """FedProx: FedAvg plus a proximal pull toward the round-start global
    model in every local step."""
    kw.setdefault("use_server_update", False)
    kw.setdefault("algorithm", "fedprox")
    return FLConfig(**kw)


def feddyn_config(**kw) -> FLConfig:
    """FedDyn: per-client dynamic regularization, a gradient correction
    carried in the engine's client state across rounds."""
    kw.setdefault("use_server_update", False)
    kw.setdefault("algorithm", "feddyn")
    return FLConfig(**kw)


# ---------------------------------------------------------------------------
# Data-placement baselines — transform the federated dataset
# ---------------------------------------------------------------------------

def apply_data_sharing(data: FederatedData,
                       rng: np.random.Generator) -> FederatedData:
    """Data-sharing [1]: the server data is split evenly over the clients
    and appended to their local sets; training is plain FedAvg (the server
    keeps its copy)."""
    n_clients = data.client_x.shape[0]
    per = data.server_x.shape[0] // n_clients
    if per == 0:
        return data
    perm = rng.permutation(data.server_x.shape[0])
    sx, sy = np.asarray(data.server_x)[perm], np.asarray(data.server_y)[perm]
    new_x = np.concatenate(
        [np.asarray(data.client_x),
         sx[: per * n_clients].reshape(n_clients, per, *sx.shape[1:])],
        axis=1)
    new_y = np.concatenate(
        [np.asarray(data.client_y),
         sy[: per * n_clients].reshape(n_clients, per)], axis=1)
    num_classes = data.client_dists.shape[1]
    dists = np.stack([np.bincount(y, minlength=num_classes)
                      for y in new_y]).astype(np.float32)
    dists /= dists.sum(1, keepdims=True)
    return FederatedData(
        client_x=new_x, client_y=new_y, sizes=data.sizes + per,
        client_dists=dists, server_x=data.server_x, server_y=data.server_y,
        server_dist=data.server_dist, test_x=data.test_x, test_y=data.test_y)


def apply_hybrid_fl(data: FederatedData) -> FederatedData:
    """Hybrid-FL [11]: the server data becomes one more ordinary client,
    tiled or cut to the common client size."""
    n_k = data.client_x.shape[1]
    sx, sy = np.asarray(data.server_x), np.asarray(data.server_y)
    reps = int(np.ceil(n_k / sx.shape[0]))
    sx = np.tile(sx, (reps,) + (1,) * (sx.ndim - 1))[:n_k]
    sy = np.tile(sy, reps)[:n_k]
    num_classes = data.client_dists.shape[1]
    sdist = np.bincount(sy, minlength=num_classes).astype(np.float32)
    sdist /= sdist.sum()
    return FederatedData(
        client_x=np.concatenate([np.asarray(data.client_x), sx[None]], axis=0),
        client_y=np.concatenate([np.asarray(data.client_y), sy[None]], axis=0),
        sizes=np.concatenate([data.sizes, [n_k]]),
        client_dists=np.concatenate([data.client_dists, sdist[None]], axis=0),
        server_x=data.server_x, server_y=data.server_y,
        server_dist=data.server_dist, test_x=data.test_x, test_y=data.test_y)


# ---------------------------------------------------------------------------
# Distillation baselines — a server phase after each aggregation
# ---------------------------------------------------------------------------

def make_distillation_round_end(model, data: FederatedData, *,
                                mode: str = "feddf", steps: int = 20,
                                batch: int = 64, lr: float = 0.01,
                                seed: int = 0):
    """FedDF [22] / FedKT [4] server phase as a per-round Callback: the
    global model takes ``steps`` SGD steps toward the predictions of the
    pre-update global model (the teacher, fixed over the steps) on server
    images: the KL divergence to its softmax (``"feddf"``) or the cross
    entropy to its argmax (``"fedkt"``).  As in the reference, the teacher
    is the model itself: the client models are not kept."""
    if mode not in ("feddf", "fedkt"):
        raise ValueError(f"mode must be 'feddf' or 'fedkt', got {mode!r}")
    rng = np.random.default_rng(seed)
    sx = np.asarray(data.server_x)

    def loss(p, x, t_logits):
        lg = model.apply(p, x)
        if mode == "fedkt":
            lp = F.log_softmax(lg, dim=-1)
            return -lp.gather(1, t_logits.argmax(-1)[:, None]).mean()
        return (F.softmax(t_logits, dim=-1)
                * (F.log_softmax(t_logits, dim=-1)
                   - F.log_softmax(lg, dim=-1))).sum(-1).mean()

    def distill_steps(params, teacher, xs):
        p = tree_map(torch.clone, params)
        for x in xs:
            with torch.no_grad():
                t_logits = model.apply(teacher, x)
            g = grad(loss, p, x, t_logits)
            with torch.no_grad():
                tree_map(lambda pi, gi: pi.sub_((lr * gi).to(pi.dtype)), p, g)
        return p

    def hook(trainer, t, params):
        idx = rng.integers(0, sx.shape[0], steps * batch)
        dev = tree_leaves(params)[0].device
        xs = torch.as_tensor(sx[idx].reshape(steps, batch, *sx.shape[1:]),
                             device=dev)
        return distill_steps(params, params, xs)

    return hook


# ---------------------------------------------------------------------------
# Pruning baselines — Callback factories
# ---------------------------------------------------------------------------

def unstructured_magnitude_mask(params, rate: float):
    """Global magnitude mask at ``rate`` (IMC / PruneFL): 1 where
    ``|w| >= `` the value at sorted index ``floor(rate * n)`` of all
    weights' magnitudes, in each leaf's dtype."""
    flat = torch.cat([x.detach().abs().reshape(-1).float()
                      for x in tree_leaves(params)])
    k = int(np.clip(rate * flat.numel(), 0, flat.numel() - 1))
    thr = torch.sort(flat).values[k]
    return tree_map(lambda x: (x.abs() >= thr).to(x.dtype), params)


def make_unstructured_pruning_hook(*, rate: float, prune_round: int,
                                   refresh_every: int | None = None):
    """IMC (``refresh_every=None``) / PruneFL (periodic re-evaluation)
    hook.  The mask multiplies the params after every round from
    ``prune_round`` on: shapes (and device FLOPs) do not change."""
    state = {"mask": None}

    def hook(trainer, t, params):
        # t is the number of COMPLETED rounds when the callback fires
        redo = (t == prune_round) or (
            refresh_every and state["mask"] is not None
            and (t - prune_round) % refresh_every == 0 and t > prune_round)
        if redo:
            state["mask"] = unstructured_magnitude_mask(params, rate)
        if state["mask"] is not None:
            return tree_map(lambda p, m: p * m, params, state["mask"])
        return None

    return hook


def make_hrank_pruning_hook(model, data: FederatedData, *, rate: float,
                            prune_round: int, probe: int = 64,
                            align: int | None = None):
    """HRank [34]: structured, rank-based, one FIXED rate for every layer
    (FedAP's foil).  At ``prune_round`` the feature-map ranks of the first
    ``probe`` server images choose the kept filters, the trainer's model
    becomes ``model.with_pruned(kept)`` and the hook returns the shrunk
    params, so the rounds after it train the smaller model from a fresh
    round state."""

    def hook(trainer, t, params):
        if t != prune_round:   # t = completed rounds at the callback
            return None
        spec: PruneSpec = model.prune_spec(params)
        dev = tree_leaves(params)[0].device
        with torch.no_grad():
            fmaps = model.feature_maps(
                params, torch.as_tensor(np.asarray(data.server_x[:probe]),
                                        device=dev))
        kept = {}
        for layer in spec.layers:
            scores = feature_map_ranks(fmaps[layer.feature_key or layer.name])
            kept[layer.name] = select_filters(scores, rate, align=align)
        new_params = shrink_params(params, spec, kept)
        trainer.model = model.with_pruned(kept)
        return new_params

    return hook
