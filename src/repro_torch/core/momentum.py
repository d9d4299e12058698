"""FedDUM: decoupled two-sided momentum (paper Section 3.3).

Counterpart of the reference's ``core/momentum.py``: devices restart SGDM
from zero momentum every round (Formula 11, in the round engine), and the
server smooths the pseudo-gradient

    g(w^{t-1}) = w^{t-1} - (w^{t-1/2} - tau_eff * eta * g0_bar)        (12)

with SGDM (Formula 8).  The sign is the descent-consistent one the
reference documents (its Formula 12 reads "+" as printed, a typo).

Both tree functions write into ``out`` when given (which may alias an
input), so the round engine updates its state in place.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.utils.tree import tree_map


@dataclasses.dataclass(frozen=True)
class FedDUMConfig:
    beta_server: float = 0.9   # beta  in Formula 8
    beta_local: float = 0.9    # beta' in Formula 11
    eta_server: float = 1.0    # eta   in Formula 8


def server_pseudo_gradient(w_prev, w_half_plus_server, *, out=None):
    """Formula 12 (descent-consistent form): ``w^{t-1} - proposed`` in
    f32."""
    def one(a, b, o=None):
        return torch.sub(a.float(), b.float(), out=o)

    if out is None:
        return tree_map(one, w_prev, w_half_plus_server)
    return tree_map(one, w_prev, w_half_plus_server, out)


def server_momentum_step(w_prev, m, pseudo_grad, cfg: FedDUMConfig, *,
                         out=None):
    """Formula 8: ``m = beta m + (1-beta) g``; ``w = w_prev - eta_s m``
    (f32, cast to each param's dtype).  Returns ``(w, m)``; with
    ``out=(w_out, m_out)`` the results are written there (``w_out`` may be
    ``w_prev`` and ``m_out`` may be ``m``)."""
    beta = cfg.beta_server

    def new_m(mi, g, o=None):
        return torch.mul(mi, beta, out=o).add_((1.0 - beta) * g)

    def new_w(p, mi, o=None):
        r = torch.sub(p.float(), cfg.eta_server * mi, out=o)
        return r if o is not None else r.to(p.dtype)

    if out is None:
        m2 = tree_map(new_m, m, pseudo_grad)
        return tree_map(new_w, w_prev, m2), m2
    w_out, m_out = out
    m2 = tree_map(new_m, m, pseudo_grad, m_out)
    return tree_map(new_w, w_prev, m2, w_out), m2
