"""FedAP, layer-adaptive structured pruning (paper Section 3.4, Algorithm 3).

The port's copy of the reference's ``core/pruning.py``.  The pipeline runs
once, on the server, at the prune round:

1. every participant k derives an expected pruning rate p*_k from the
   eigen-gap of an empirical-Fisher spectrum (the first ascending index m
   with lambda_{m+1} - lambda_m > 4 L_k gives p*_k = m / d).  The spectrum
   is that of the Gram matrix (1/n) G G^T of the [n, P] per-sample
   gradients, which shares the Fisher's nonzero eigenvalues;
2. Formula 15 aggregates the rates with non-IID-degree weights;
3. a global magnitude threshold V = |v_(floor(R p*))| over every prunable
   weight turns p* into per-layer rates p*_l = #{|w| < V in l} / q_l;
4. within each layer the filters of lowest HRank feature-map rank (on
   server data) go: the top d_l - floor(p*_l d_l) are kept.

Steps 3-4 run on models that publish a :class:`PruneSpec` (the paper's
CNNs): each prunable layer names its weight, its filter axis and every
coupled tensor and axis that shrinks with it.  The scanned LM picks its
kept FFN units from p* itself (``LM.decide_kept``).  Axes are the port's
layouts: a conv's filters are OIHW axis 0 and the next conv's inputs axis 1.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.utils.tree import tree_leaves, tree_map

Path = tuple


# ---------------------------------------------------------------------------
# Tree path addressing and the prune spec
# ---------------------------------------------------------------------------

def get_path(tree: Any, path: Path):
    """The leaf at ``path`` (dict keys and sequence indices)."""
    node = tree
    for key in path:
        try:
            if not isinstance(node, (dict, list, tuple)):
                raise TypeError
            node = node[key]
        except (KeyError, IndexError, TypeError):
            raise KeyError(f"no leaf at path {tuple(path)!r}") from None
    return node


def set_path(tree: Any, path: Path, value: Any):
    """A tree equal to ``tree`` but for ``value`` at ``path``: the dicts and
    sequences on the path are new, every other node and leaf is shared."""
    path = tuple(path)
    get_path(tree, path)
    if not path:
        return value
    head, rest = path[0], path[1:]
    new = set_path(tree[head], rest, value)
    if isinstance(tree, dict):
        return {**tree, head: new}
    items = list(tree)
    items[head] = new
    return type(tree)(items)


@dataclasses.dataclass(frozen=True)
class CoupledParam:
    path: Path
    axis: int


@dataclasses.dataclass(frozen=True)
class PrunableLayer:
    """One structurally prunable layer.

    weight:      the tensor holding the filters (conv kernel [O, I, kh, kw],
                 dense [in, out], ...).
    filter_axis: the output-filter axis of ``weight``.
    coupled:     tensors sliced along the same filter dimension (this
                 layer's bias, the NEXT layer's input axis, norm scales).
    feature_key: key under which the model reports this layer's feature
                 maps (default: ``name``).
    """

    name: str
    weight: Path
    filter_axis: int
    coupled: tuple[CoupledParam, ...] = ()
    feature_key: str | None = None


@dataclasses.dataclass(frozen=True)
class PruneSpec:
    layers: tuple[PrunableLayer, ...]


def fisher_spectrum(per_sample_grad_fn: Callable, params: Any,
                    probe_batch: Any, *, n_valid=None) -> torch.Tensor:
    """Empirical-Fisher eigenvalues via the Gram trick, ascending, clipped
    at 0.

    ``per_sample_grad_fn(params, batch)`` returns the list of the n
    per-sample gradient trees.  The reference concatenates them into one
    [n, P] matrix; here ``G G^T`` is summed leaf by leaf in f32 from dot
    products, so no second copy of the gradients is made.  The two agree
    up to summation order.

    ``n_valid`` (a padded probe whose padded rows' gradients are zero)
    normalises by the valid rows: the spectrum is then the valid rows' plus
    exact zeros, which :func:`expected_rate_from_spectrum`'s ``valid=``
    skips.
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
    eigs = torch.linalg.eigvalsh(gram / (n if n_valid is None
                                         else float(n_valid)))
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
                                max_rate: float = 0.9, *,
                                valid=None) -> torch.Tensor:
    """p*_k = m / d for the FIRST ascending index m with eig[m+1] - eig[m]
    > 4 L (the modes below the first spectral gap are the prunable
    complement of the inertial manifold); 0 when no gap clears the bar.

    ``valid`` searches only a padded spectrum's last ``valid`` entries (the
    padded rows' zero eigenvalues sort first), with the indices re-based
    and the gap at the pad|valid boundary excluded: the search the unpadded
    spectrum gets."""
    d_pad = eigs.shape[0]
    d = d_pad if valid is None else int(valid)
    gaps = eigs[1:] - eigs[:-1]
    idx = torch.arange(1, d_pad, dtype=torch.int32,
                       device=eigs.device) - (d_pad - d)
    ok = (gaps > 4.0 * torch.as_tensor(lipschitz, dtype=torch.float32,
                                       device=eigs.device)) & (idx >= 1)
    m = int(torch.where(ok, idx, d).min()) if d_pad > 1 else d
    m = 0 if m >= d else m
    rate = (torch.tensor(m, dtype=torch.float32)
            / torch.tensor(d, dtype=torch.float32))
    return torch.clamp(rate, 0.0, max_rate)


def aggregate_rates(rates, sizes, niid, eps: float = 1e-8) -> torch.Tensor:
    """Formula 15: ``sum_k w_k p*_k`` with ``w_k`` proportional to
    ``n_k / (D(P_k) + eps)``, returned as float32.

    Summed in float64, so equal rates aggregate to exactly that rate: the
    kept count ``d - floor(p* d)`` and the global threshold's index
    ``floor(p* R)`` jump where ``p* d`` or ``p* R`` is an integer, which
    equal eigen-gap rates (multiples of 1/probe_size) hit, and a float32
    sum lands on either side of it by the last bit of its weights.  (The
    reference sums in float32; its weights' last bits come from the non-IID
    degrees' logarithms, which no two libraries round alike.)"""
    w = (torch.as_tensor(sizes, dtype=torch.float64)
         / (torch.as_tensor(niid, dtype=torch.float64) + eps))
    w = w / w.sum()
    return (w * torch.as_tensor(rates, dtype=torch.float64)).sum().float()


# ---------------------------------------------------------------------------
# Step 3 — global magnitude threshold -> per-layer rates
# ---------------------------------------------------------------------------

def global_threshold(params: Any, spec: PruneSpec, p_star) -> torch.Tensor:
    """V = |v_(floor(R p*))| over all prunable weights (Alg. 3 lines 6-7).

    The index is the reference's ``(p* as f32 * R).astype(int32)``: the
    product is rounded to float32 before it is truncated, which can land
    one above the float64 product's floor."""
    vals = torch.cat([get_path(params, l.weight).float().abs().reshape(-1)
                      for l in spec.layers])
    r = vals.numel()
    prod = (torch.as_tensor(p_star, dtype=torch.float32).cpu()
            * torch.tensor(r, dtype=torch.float32))
    k = min(max(int(prod.to(torch.int32)), 0), r - 1)
    return torch.sort(vals).values[k]


def per_layer_rates(params: Any, spec: PruneSpec, threshold
                    ) -> dict[str, torch.Tensor]:
    """p*_l = #{|w| < V} / q_l per layer (Alg. 3 lines 9-11), float32 (as
    the reference rounds it: the count times 1/q_l)."""
    out = {}
    for l in spec.layers:
        w = get_path(params, l.weight).float().abs()
        out[l.name] = _mean((w < threshold).to(torch.float32),
                            tuple(range(w.ndim)))
    return out


def _mean(x: torch.Tensor, dims: tuple) -> torch.Tensor:
    """The reference's float32 mean: the sum times the float32 reciprocal
    of the count (what XLA makes of ``jnp.mean``), not the sum divided by
    the count, which differs in the last bit for some counts."""
    n = math.prod(x.shape[d] for d in dims)
    inv = torch.reciprocal(torch.tensor(float(n), dtype=torch.float32,
                                        device=x.device))
    return x.sum(dim=dims) * inv


# ---------------------------------------------------------------------------
# Step 4 — HRank filter selection
# ---------------------------------------------------------------------------

def feature_map_scores(fmap: torch.Tensor) -> torch.Tensor:
    """Per-sample HRank scores [B, d_l], HIGHER = keep.

    * conv maps [B, d, H, W] (channels at axis 1): the matrix rank of each
      sample's [H, W] map, with the reference's tolerance
      ``max(s) * max(H, W) * 1e-6`` on float32 singular values;
    * features [B, ..., d] (filters last): the mean |activation| per
      neuron over the middle axes (activation energy).
    """
    fmap = fmap.float()
    if fmap.ndim >= 4:
        maps = fmap.reshape(fmap.shape[0], fmap.shape[1], fmap.shape[2], -1)
        s = torch.linalg.svdvals(maps)                      # [B, d, min]
        tol = s.amax(dim=-1, keepdim=True) * max(maps.shape[-2:]) * 1e-6
        return (s > tol).sum(dim=-1).to(torch.float32)
    flat = fmap.reshape(fmap.shape[0], -1, fmap.shape[-1])
    return _mean(flat.abs(), (1,))


def feature_map_ranks(fmap: torch.Tensor) -> torch.Tensor:
    """HRank score per filter [d_l]: the batch mean of
    :func:`feature_map_scores` (conv ranks are small integers, so their
    float32 sums are exact, and the mean is rounded as the reference
    rounds it) or, for dense features, the mean |activation| over the batch
    and middle axes."""
    fmap = fmap.float()
    if fmap.ndim >= 4:
        return _mean(feature_map_scores(fmap), (0,))
    flat = fmap.reshape(fmap.shape[0], -1, fmap.shape[-1])
    return _mean(flat.abs(), (0, 1))


def select_filters(scores, rate, *, align: int | None = None,
                   min_keep: int = 1) -> np.ndarray:
    """Keep the d_l - floor(rate d_l) filters with the HIGHEST scores (Alg.
    3 lines 13-14), the kept count rounded up to a multiple of ``align``
    when given.  Returns a sorted numpy index array.

    Ties (conv ranks tie often) are broken by the reference's own numpy
    call, ``np.argsort(scores)[::-1]``, on a host float32 copy: a torch
    sort would keep another set."""
    if isinstance(scores, torch.Tensor):
        scores = scores.detach().cpu().numpy()
    scores = np.asarray(scores, np.float32)
    d = scores.shape[0]
    keep = max(d - int(np.floor(float(rate) * d)), min_keep)
    if align is not None and d >= align:
        keep = min(d, int(np.ceil(keep / align) * align))
    order = np.argsort(scores)[::-1]
    return np.sort(order[:keep])


# ---------------------------------------------------------------------------
# Structural shrink and the masked (fixed-shape) forms
# ---------------------------------------------------------------------------

def _index(kept, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(kept), dtype=torch.long, device=device)


def shrink_params(params: Any, spec: PruneSpec,
                  kept: Mapping[str, np.ndarray]) -> Any:
    """The smaller model (Alg. 3 line 15): each pruned layer's filter axis
    and every coupled tensor's axis gathered at the kept indices, into new
    tensors (the input tree is not modified)."""
    for l in spec.layers:
        if l.name not in kept:
            continue
        for path, axis in ((l.weight, l.filter_axis),
                           *((c.path, c.axis) for c in l.coupled)):
            t = get_path(params, path)
            params = set_path(params, path, torch.index_select(
                t, axis, _index(kept[l.name], t.device)))
    return params


def filter_masks(params: Any, spec: PruneSpec,
                 kept: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """A [d_l] float32 0/1 keep-mask per layer (all ones where ``kept``
    has no entry), on the params' device."""
    masks = {}
    for l in spec.layers:
        w = get_path(params, l.weight)
        d = w.shape[l.filter_axis]
        m = np.zeros((d,), np.float32)
        m[np.asarray(kept.get(l.name, np.arange(d)))] = 1.0
        masks[l.name] = torch.from_numpy(m).to(w.device)
    return masks


def mask_axis(m: torch.Tensor, axis: int, idx) -> torch.Tensor:
    """``m`` times a 0/1 vector along ``axis`` that keeps ``idx``."""
    d = m.shape[axis]
    keep = np.zeros((d,), np.float32)
    keep[np.asarray(idx)] = 1.0
    shape = [1] * m.ndim
    shape[axis] = d
    return m * torch.from_numpy(keep).to(m.device).reshape(shape)


def param_masks(params: Any, spec: PruneSpec,
                kept: Mapping[str, np.ndarray]) -> Any:
    """Param-structured float32 0/1 masks, the fixed-shape dual of
    :func:`shrink_params`: zeros on exactly the coordinates the shrink
    would slice away (each weight's filter axis and every coupled axis).

    The zeroed set is closed under the coupling, so on a
    normalisation-free model a masked forward and its gradients on the kept
    coordinates are those of the shrunk model, and the masked coordinates'
    gradients are zero.  GroupNorm models normalise over the zeroed
    channels, so masking only approximates their shrink."""
    masks = tree_map(lambda p: torch.ones(p.shape, dtype=torch.float32,
                                          device=p.device), params)
    for l in spec.layers:
        if l.name not in kept:
            continue
        idx = np.asarray(kept[l.name])
        for path, axis in ((l.weight, l.filter_axis),
                           *((c.path, c.axis) for c in l.coupled)):
            masks = set_path(masks, path,
                             mask_axis(get_path(masks, path), axis, idx))
    return masks


def model_flops_fraction(params_before: Any, params_after: Any) -> float:
    """Ratio of parameter counts after/before: a crude FLOP-reduction proxy
    (matmul FLOPs scale linearly in each pruned dimension)."""
    a = sum(int(x.numel()) for x in tree_leaves(params_after))
    b = sum(int(x.numel()) for x in tree_leaves(params_before))
    return a / b


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


# ---------------------------------------------------------------------------
# End to end
# ---------------------------------------------------------------------------

def fedap_rates(*, spectra: Sequence[torch.Tensor],
                lipschitzes: Sequence, sizes, niid, params: Any,
                spec: PruneSpec, cfg: FedAPConfig
                ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Steps 1-3: per-participant rates -> Formula 15 -> per-layer rates."""
    rates = torch.stack([
        expected_rate_from_spectrum(e, l, cfg.max_rate).cpu()
        for e, l in zip(spectra, lipschitzes)])
    p_star = aggregate_rates(rates, sizes, niid, cfg.eps)
    thr = global_threshold(params, spec, p_star)
    return p_star, per_layer_rates(params, spec, thr)


def fedap_prune(params: Any, spec: PruneSpec, layer_rates: Mapping,
                feature_maps: Mapping[str, torch.Tensor], cfg: FedAPConfig
                ) -> tuple[Any, dict[str, np.ndarray]]:
    """Step 4 and the shrink: (pruned params, kept-index map)."""
    kept = {}
    for l in spec.layers:
        fkey = l.feature_key or l.name
        if fkey not in feature_maps:
            continue
        kept[l.name] = select_filters(feature_map_ranks(feature_maps[fkey]),
                                      float(layer_rates[l.name]),
                                      align=cfg.align)
    return shrink_params(params, spec, kept), kept
