"""FedAP, layer-adaptive structured pruning (paper Section 3.4, Algorithm 3):
the parts of the reference's ``core/pruning.py`` that the LM decision uses.

Step 1: every participant k derives an expected pruning rate p*_k from the
eigen-gap of an empirical-Fisher spectrum (the first ascending index m with
lambda_{m+1} - lambda_m > 4 L_k gives p*_k = m / d).  The spectrum is that
of the Gram matrix (1/n) G G^T of the [n, P] per-sample gradients, which
shares the Fisher's nonzero eigenvalues.  Step 2 aggregates the rates with
non-IID-degree weights (Formula 15).  The scanned LM then picks kept FFN
units from the aggregate rate itself (``LM.decide_kept``); the global
magnitude threshold and HRank selection of the CNN path come with the CNN
slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.utils.tree import tree_leaves


def fisher_spectrum(per_sample_grad_fn: Callable, params: Any,
                    probe_batch: Any) -> torch.Tensor:
    """Empirical-Fisher eigenvalues via the Gram trick, ascending, clipped
    at 0.

    ``per_sample_grad_fn(params, batch)`` returns the list of the n
    per-sample gradient trees.  The reference concatenates them into one
    [n, P] matrix; here ``G G^T`` is summed leaf by leaf in f32 from dot
    products, so no second copy of the gradients is made.  The two agree
    up to summation order.
    """
    grads = [tree_leaves(g) for g in per_sample_grad_fn(params, probe_batch)]
    n = len(grads)
    dev = grads[0][0].device
    gram = torch.zeros((n, n), dtype=torch.float32, device=dev)
    for leaf in range(len(grads[0])):
        flat = [g[leaf].reshape(-1).float() for g in grads]
        for i in range(n):
            for j in range(i + 1):
                gram[i, j] += torch.dot(flat[i], flat[j])
    gram = torch.tril(gram) + torch.tril(gram, -1).T
    eigs = torch.linalg.eigvalsh(gram / n)
    return eigs.clamp_min(0.0)


def lipschitz_estimate(grad_fn: Callable, params_a: Any, params_b: Any,
                       batch: Any) -> torch.Tensor:
    """L_k ~= ||grad(a) - grad(b)|| / ||a - b||: a finite-difference
    estimate of the Lipschitz constant of the base function B_k."""
    ga = tree_leaves(grad_fn(params_a, batch))
    gb = tree_leaves(grad_fn(params_b, batch))
    num = torch.sqrt(sum(torch.sum(torch.square(x - y))
                         for x, y in zip(ga, gb)))
    del ga, gb
    den = torch.sqrt(sum(torch.sum(torch.square(x.float() - y.float()))
                         for x, y in zip(tree_leaves(params_a),
                                         tree_leaves(params_b))))
    return num / den.clamp_min(1e-12)


def expected_rate_from_spectrum(eigs: torch.Tensor, lipschitz,
                                max_rate: float = 0.9) -> torch.Tensor:
    """p*_k = m / d for the FIRST ascending index m with eig[m+1] - eig[m]
    > 4 L (the modes below the first spectral gap are the prunable
    complement of the inertial manifold); 0 when no gap clears the bar."""
    d = eigs.shape[0]
    gaps = eigs[1:] - eigs[:-1]
    idx = torch.arange(1, d, dtype=torch.int32, device=eigs.device)
    ok = gaps > 4.0 * torch.as_tensor(lipschitz, dtype=torch.float32,
                                      device=eigs.device)
    m = int(torch.where(ok, idx, d).min()) if d > 1 else d
    m = 0 if m >= d else m
    rate = (torch.tensor(m, dtype=torch.float32)
            / torch.tensor(d, dtype=torch.float32))
    return torch.clamp(rate, 0.0, max_rate)


def aggregate_rates(rates, sizes, niid, eps: float = 1e-8) -> torch.Tensor:
    """Formula 15: ``sum_k w_k p*_k`` with ``w_k`` proportional to
    ``n_k / (D(P_k) + eps)``, returned as float32.

    Summed in float64, so equal rates aggregate to exactly that rate: the
    kept count ``d - floor(p* d)`` jumps where ``p* d`` is an integer, which
    equal eigen-gap rates (multiples of 1/probe_size) hit, and a float32
    sum lands on either side of it by the last bit of its weights.  (The
    reference sums in float32.)"""
    w = (torch.as_tensor(sizes, dtype=torch.float64)
         / (torch.as_tensor(niid, dtype=torch.float64) + eps))
    w = w / w.sum()
    return (w * torch.as_tensor(rates, dtype=torch.float64)).sum().float()


@dataclasses.dataclass(frozen=True)
class FedAPConfig:
    prune_round: int = 30          # paper: pruning happens once, at round 30
    eps: float = 1e-8              # Formula 15
    align: int | None = None       # kept counts rounded up to this multiple
    max_rate: float = 0.9
    min_rate: float = 0.0          # compression-budget floor on p* (0 = off)
    probe_size: int = 32
    participants: int = 8          # devices (beyond the server) probed for p*_k

    def __post_init__(self):
        if not 0.0 <= self.min_rate <= self.max_rate:
            raise ValueError(f"need 0 <= min_rate <= max_rate, got "
                             f"min_rate={self.min_rate} max_rate={self.max_rate}")
        if self.participants < 0:
            raise ValueError(
                f"participants must be >= 0, got {self.participants}")
        if self.probe_size < 1:
            raise ValueError(f"probe_size must be >= 1, got {self.probe_size}")
        if self.prune_round < 1:
            raise ValueError(
                f"prune_round must be >= 1, got {self.prune_round}")
