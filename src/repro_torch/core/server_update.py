"""FedDU: dynamic server update on shared server data (paper Formulas 4-7).

Counterpart of the reference's ``core/server_update.py``:

    w^t        = w^{t-1/2} - tau_eff^{t-1} * eta * g0_bar(w^{t-1/2})        (4)
    g0_bar     = (1/tau) * sum_{i=1..tau} g0(w^{t-1/2, i})                  (6)
    tau_eff^t  = f'(acc) * n0*D(Pbar') / (n0*D(Pbar') + n'*D(P0))
                 * C * decay^t * tau                                        (7)

Scalars are float32 tensors, computed in the reference's order.  Trees are
nested dicts of tensors; :func:`feddu_apply` writes into ``out`` when given
(which may be ``w_half`` itself), so the round engine updates in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def f_prime(acc, kind: str = "1-acc", eps: float = 1e-8) -> torch.Tensor:
    """f'(acc), the accuracy gate of the server update: ``1 - acc`` (the
    paper's choice, Table 3) or ``1/(acc+eps)``."""
    acc = _f32(acc)
    if kind == "1-acc":
        return 1.0 - acc
    if kind == "inv":
        return 1.0 / (acc + eps)
    raise ValueError(f"unknown f'(acc) kind: {kind}")


@dataclasses.dataclass(frozen=True)
class FedDUConfig:
    """Hyper-parameters of the dynamic server update (Formula 7)."""

    C: float = 1.0
    decay: float = 0.99
    f_prime_kind: str = "1-acc"
    eps: float = 1e-8
    # Static override for the ablation FedDU-S (Table 2); None = dynamic.
    static_tau_eff: float | None = None


def tau_eff(cfg: FedDUConfig, *, acc, round_idx, n0, n_prime, d_round,
            d_server, tau) -> torch.Tensor:
    """Formula 7, a float32 0-d tensor.

    n0: server samples; n_prime: samples on this round's selected devices;
    d_round: D(Pbar'^t); d_server: D(P0); tau: server iterations per round.
    """
    if cfg.static_tau_eff is not None:
        return _f32(cfg.static_tau_eff)
    acc = _f32(acc)
    dev = acc.device
    n0, n_prime = _f32(n0).to(dev), _f32(n_prime).to(dev)
    num = n0 * _f32(d_round).to(dev)
    den = num + n_prime * _f32(d_server).to(dev) + cfg.eps
    gate = f_prime(acc, cfg.f_prime_kind, cfg.eps)
    t = _f32(round_idx).to(dev)
    return gate * (num / den) * cfg.C * (cfg.decay ** t) * tau


def normalized_server_gradient(params: Any, server_batches: Sequence,
                               grad_fn: Callable, eta: float) -> Any:
    """g0_bar (Formula 6): ``tau = len(server_batches)`` SGD steps from
    ``params`` on the server data, returned as the mean per-step gradient
    ``(w_start - w_end) / (tau eta)`` in float32 (the telescoping identity,
    exact for plain SGD, so no per-step gradient is kept).  ``params`` are
    not modified."""
    if len(server_batches) == 0:
        return tree_map(lambda p: torch.zeros_like(p), params)
    w = params
    for batch in server_batches:
        g = grad_fn(w, batch)
        w = tree_map(lambda p, gi: (p - eta * gi).to(p.dtype), w, g)
    return _mean_step(params, w, len(server_batches), eta)


def normalized_server_gradient_scan(params: Any, server_batch_stack: Any,
                                    grad_fn: Callable, eta: float) -> Any:
    """:func:`normalized_server_gradient` over a stacked batch tree whose
    leaves lead with the tau axis (the reference's ``lax.scan`` form)."""
    tau = tree_leaves(server_batch_stack)[0].shape[0]
    w = params
    for i in range(tau):
        g = grad_fn(w, tree_map(lambda t: t[i], server_batch_stack))
        w = tree_map(lambda p, gi: (p - eta * gi).to(p.dtype), w, g)
    return _mean_step(params, w, tau, eta)


def _mean_step(w_start, w_end, tau: int, eta: float):
    return tree_map(lambda a, b: (a.float() - b.float()) / (tau * eta),
                    w_start, w_end)


def feddu_apply(w_half, g0_bar, t_eff, eta, *, out=None):
    """Formula 4: ``w^t = w^{t-1/2} - tau_eff * eta * g0_bar``, computed in
    f32 and cast to each leaf's dtype; into ``out`` when given."""
    scale = _f32(t_eff) * eta

    def one(p, g, o=None):
        r = torch.sub(p.float(), scale * g, out=o)
        return r if o is not None else r.to(p.dtype)

    if out is None:
        return tree_map(one, w_half, g0_bar)
    return tree_map(one, w_half, g0_bar, out)
