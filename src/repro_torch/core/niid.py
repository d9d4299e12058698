"""Non-IID degree quantification (paper Formulas 2-3).

Counterpart of the reference's ``core/niid.py``.  The non-IID degree of a
dataset is the Jensen-Shannon divergence between its label distribution
P_k and the global device-data distribution P_bar:

    D(P_k) = 1/2 KL(P_k || P_m) + 1/2 KL(P_bar || P_m),   P_m = (P_k + P_bar)/2

Inputs may be tensors or numpy arrays; results are float32 tensors on the
inputs' device (the CPU for numpy).
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def kl_divergence(p, q) -> torch.Tensor:
    """KL(p || q) over the last axis, safe for zero entries (0 log 0 = 0)."""
    p, q = _f32(p), _f32(q)
    ratio = torch.log(p.clamp_min(_EPS)) - torch.log(q.clamp_min(_EPS))
    return torch.where(p > 0, p * ratio, 0.0).sum(-1)


def js_divergence(p, q) -> torch.Tensor:
    p, q = _f32(p), _f32(q)
    m = 0.5 * (p + q)
    return 0.5 * kl_divergence(p, m) + 0.5 * kl_divergence(q, m)


def label_distribution(labels, num_classes: int) -> torch.Tensor:
    """Empirical P_k from integer labels."""
    counts = torch.bincount(torch.as_tensor(labels).reshape(-1).long(),
                            minlength=num_classes).float()
    return counts / counts.sum().clamp_min(1.0)


def global_distribution(client_dists, client_sizes) -> torch.Tensor:
    """P_bar = sum_k n_k P_k / sum_k n_k over all devices.

    client_dists [N, num_classes]; client_sizes [N].
    """
    w = _f32(client_sizes)
    w = w / w.sum().clamp_min(1.0)
    return torch.einsum("k,kc->c", w, _f32(client_dists).to(w.device))


def non_iid_degree(p_k, p_bar) -> torch.Tensor:
    """D(P_k), Formula 2: higher is further from the global distribution."""
    return js_divergence(p_k, p_bar)


def round_distribution(client_dists, client_sizes, selected) -> torch.Tensor:
    """P_bar'^t: the distribution of the data held by the devices selected
    in round t (Formula 7); ``selected`` indexes the clients."""
    sel = torch.as_tensor(selected).long()
    return global_distribution(_f32(client_dists)[sel], _f32(client_sizes)[sel])
