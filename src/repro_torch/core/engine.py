"""The federated round engine: one implementation of the paper's round
(steps 2-5 of Section 3.1), eager, on one device.

Counterpart of the reference's ``core/engine.py``: every momentum mode
(none / restart / communicated local momentum, FedDUM server momentum),
the FedDU dynamic server update, FedAP masks in ``"params"`` and
``"kernel"`` compute modes, the client algorithms FedAvg, FedProx and
FedDyn, client dropout (``batch["active"]``), the health guard
(``cfg.guard``) and device-fault injection (``cfg.faults``).

``client_state`` (present iff ``cfg.algorithm != "fedavg"``) is keyed by
the algorithm, as in the reference:

  "fedprox"  ``{"per_client": {}, "shared": {}}``: the proximal pull
             ``mu (theta - theta_global)`` needs only the round-start
             params;
  "feddyn"   ``{"per_client": {"h": [N, ...] per param}, "shared": {"h":
             param tree}}``, f32: the ALPHA-SCALED correction ``h'_k =
             alpha h_k``.  The local gradient is ``g + alpha (theta -
             theta_global) - h'_k``, the update ``h'_k <- h'_k - alpha
             act_k (theta_k^end - theta_global)``, and the server
             correction ``w_half - h'/alpha`` (skipped at ``alpha == 0``).

Differences from the reference, each for memory at the width of a real
model (olmo-1b in f32 is 4.71 GB per param-sized tree):

* Clients train one after another instead of under ``vmap``.  FedAvg is a
  running f32 sum ``sum_k w_k theta_k`` with ``w = sizes / sum(sizes)``
  fixed before the first client, so the round holds one client's params,
  momentum and gradient at a time, not ``C`` of each.  With
  ``batch["active"]`` the sum runs in the reference's delta form, ``base +
  sum_k w_k (theta_k - base)`` with ``w = sizes act / max(sum, 1e-12)``,
  so an all-dropped round aggregates to ``base`` exactly.
* FedDyn's per-client ``h`` stays on the device; each selected client's
  row is gathered inside the client loop, written back with an in-place
  indexed copy, and ``sum_k act_k drift_k`` is a running sum, as FedAvg.
* :func:`round_core` updates the round state IN PLACE and returns it;
  temporaries are dropped as soon as they are dead.  Nothing is donated or
  copied behind the caller's back, so a caller that wants to keep a state
  passes a copy.
* The health guard.  Its weights ``sizes act ok / max(sum, 1e-12)``
  depend on clients not trained yet, so a guarded round sums
  ``sum_k sizes_k act_k ok_k (theta_k - base)`` and its total and divides
  once at the end.  A discarded round must leave the state as the round
  found it, though the round writes in place: the server step computes
  each leaf's new value into a temporary and keeps ``torch.where(discard,
  old, new)``, FedDyn's shared ``h`` is updated on a copy, the selected
  clients' rows of its per-client ``h`` are kept before the client loop,
  and the FedDU proposal no longer overwrites ``w_half`` (its fallback):
  one param-sized tree more than an unguarded round.

Batches are pytrees, as in the reference: ``(x, y)`` tuples for the
simulation models, dicts (``tokens``, ``labels``, ``embeds``,
``positions``, ``loss_mask``, ``enc_embeds``) for the batch-dict step of
``launch.steps``; a round indexes clients, local steps and server steps
through every leaf's leading dims.  Model access is two callables over an
opaque step batch:

  grad_fn(params, batch[, filter_masks])          -> grads tree
  loss_and_acc_fn(params, batch[, filter_masks])  -> (loss, acc)

the filter masks being passed iff ``use_masks`` and
``masked_compute == "kernel"`` (:func:`build_model_fns`).  The Formula-7
accuracy gate comes from the FIRST server step's own forward.

A :class:`RoundShard` runs the round as one rank of several (the mesh
backend, ``core.backend.MeshBackend``): the rank trains its own clients
and sums the round's client sums over the ranks (FedAvg's ``w_half``,
communicated momentum, FedDyn's drift and rows of ``h``, the guard's
totals) before anything divides them, and each server step's gradient may
be a partial one over the rank's rows, summed over the ranks.  Clients keep
their weights from the whole round's ``sizes``, so at a world of one the
round is bitwise the unsharded one.  Where a rank stores only its own
clients' rows (``RoundShard.owned``), the round's gather and FedDyn's rows
of ``h`` come from their owners through masked sums over the ranks.

Randomness is an input: :func:`sample_round_batches` gathers one round's
batches at given client and sample indices, and :func:`draw_round_indices`
draws those indices (and the dropout draw) from a ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core import niid
from repro_torch.core.momentum import (
    FedDUMConfig,
    server_momentum_step,
    server_pseudo_gradient,
)
from repro_torch.core.server_update import FedDUConfig, feddu_apply, tau_eff
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

@dataclasses.dataclass(frozen=True)
class FedProxConfig:
    """FedProx's proximal term: local grad = g + mu * (theta - theta_global).
    mu = 0 is bit-identical to FedAvg (the term multiplies to exact zero)."""

    mu: float = 0.01

    def __post_init__(self):
        if self.mu < 0:
            raise ValueError(f"FedProx mu must be >= 0, got {self.mu}")


@dataclasses.dataclass(frozen=True)
class FedDynConfig:
    """FedDyn's dynamic regularizer (alpha-scaled; see the module
    docstring).  alpha = 0 reduces to FedAvg: the correction state stays
    exactly zero and the server division is skipped."""

    alpha: float = 0.01

    def __post_init__(self):
        if self.alpha < 0:
            raise ValueError(f"FedDyn alpha must be >= 0, got {self.alpha}")


ALGORITHMS = ("fedavg", "fedprox", "feddyn")

GUARD_MODES = ("off", "reject_client", "skip_round")


@dataclasses.dataclass(frozen=True)
class RoundShard:
    """One rank's part of a round.

    ``reduce(tensors)`` sums each tensor of a list over the ranks, in place.
    ``clients`` are the positions in the round batch of the clients this
    rank trains; ``batch["client"]`` then holds exactly their rows, while
    ``sizes``, ``sel`` and ``active`` stay whole.  ``None``: every rank
    trains every client and the client sums are not reduced (the replicated
    fallback).  ``server_rows`` are this rank's rows of every server step's
    batch, whose gradient (and the gate accuracy) is then taken over them,
    scaled by ``server_weight`` (the rows' share of the batch) and summed
    over the ranks: the gradient of the batch's mean loss, for a loss that
    is a mean over rows.  ``None``: whole batches on every rank.

    ``owned`` are the global client ids whose rows this rank stores (the
    rank-local device dataset, FedDyn's per-client ``h``), of
    ``num_clients`` in all; ``None``: every rank stores every client.  A
    round then fetches the rows it needs from their owners at fixed shapes:
    each rank fills a ``[C, ...]`` buffer with the selected rows it owns
    and zeros elsewhere, and a sum over the ranks (each element has one
    non-zero contributor, so the sum is exact) gives the rows whole, with
    ``reduce``, or this rank's block of them, with ``scatter(tensors)``
    (which returns the summed tensors' rows at ``clients``).

    ``model`` (a ``sharding.tp.TPGroup``): the ranks that each hold a block
    of every param (tensor parallelism over the ``model`` mesh axis), whose
    guard verdicts span them all: a NaN may sit in one rank's block only.
    Everything else of the round is elementwise on the blocks, or reads
    losses and accuracies that the model already reduced over them."""

    reduce: Callable
    clients: range | None = None
    server_rows: slice | None = None
    server_weight: float = 1.0
    owned: range | None = None
    num_clients: int | None = None
    scatter: Callable | None = None
    model: Any = None


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Algorithm switches of the round: FedAvg / FedDU / FedDUM / FedDA /
    FedDUMAP (FedAP prunes between rounds, as a plan event), and the client
    algorithms FedProx / FedDyn."""

    lr: float = 0.1                 # eta: local AND server SGD step size
    lr_decay: float = 1.0           # per-round geometric decay (paper 4.1)
    use_server_update: bool = True  # FedDU (Formulas 4-7)
    local_momentum: str = "none"    # none | restart | communicated
    server_momentum: bool = False   # FedDUM server SGDM (Formulas 8/12)
    use_masks: bool = False         # FedAP masks in the round state
    masked_compute: str = "params"  # params | kernel
    algorithm: str = "fedavg"       # fedavg | fedprox | feddyn
    guard: str = "off"              # off | reject_client | skip_round
    faults: tuple = ()              # device-fault injection (tests)
    feddu: FedDUConfig = dataclasses.field(default_factory=FedDUConfig)
    feddum: FedDUMConfig = dataclasses.field(default_factory=FedDUMConfig)
    fedprox: FedProxConfig = dataclasses.field(default_factory=FedProxConfig)
    feddyn: FedDynConfig = dataclasses.field(default_factory=FedDynConfig)

    def __post_init__(self):
        if self.local_momentum not in ("none", "restart", "communicated"):
            raise ValueError(f"unknown local_momentum: {self.local_momentum}")
        if self.masked_compute not in ("params", "kernel"):
            raise ValueError(
                f"unknown masked_compute: {self.masked_compute!r} "
                "(expected 'params' or 'kernel')")
        if self.algorithm not in ALGORITHMS:
            raise ValueError(f"unknown algorithm: {self.algorithm!r} "
                             f"(expected one of {ALGORITHMS})")
        if self.guard not in GUARD_MODES:
            raise ValueError(f"unknown guard: {self.guard!r} "
                             f"(expected one of {GUARD_MODES})")
        for f in self.faults:
            if not hasattr(f, "apply_client"):
                raise ValueError(
                    f"EngineConfig.faults takes DEVICE faults (objects with "
                    f"an apply_client hook, e.g. reliability.NaNGrad); got "
                    f"{f!r}: host faults like KillAfterChunk belong to the "
                    f"executor (pass them via FLConfig.faults)")


def _zeros_like_f32(tree):
    return tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                          device=t.device), tree)


def init_client_state(params: Any, cfg: EngineConfig,
                      num_clients: int | None) -> dict:
    """The algorithm-keyed ``client_state`` (see the module docstring), f32
    zeros on the params' device; per-client leaves lead with
    ``[num_clients]``, the TOTAL client count."""
    if cfg.algorithm == "fedprox":
        return {"per_client": {}, "shared": {}}
    if num_clients is None:
        raise ValueError(
            "algorithm='feddyn' keeps per-client correction state in the "
            "round state: pass num_clients=N (the TOTAL client count) to "
            "init_round_state")
    return {
        "per_client": {"h": tree_map(
            lambda p: torch.zeros((num_clients,) + tuple(p.shape),
                                  dtype=torch.float32, device=p.device),
            params)},
        "shared": {"h": _zeros_like_f32(params)},
    }


def init_round_state(params: Any, cfg: EngineConfig,
                     filter_masks: Any = None,
                     num_clients: int | None = None) -> dict:
    """``{"params", "server_m", ["global_m"], ["masks"], ["filter_masks"],
    ["client_state"], "round"}`` on the params' device.  ``params`` is
    held, not copied.  Masks start as all ones (a no-op round), so a prune
    event only changes their contents.  ``filter_masks`` (required iff
    ``use_masks`` and ``masked_compute == "kernel"``) is copied.
    ``num_clients`` (required iff ``algorithm == "feddyn"``) sizes the
    per-client leaves of ``client_state``."""
    dev = tree_leaves(params)[0].device
    state = {"params": params, "server_m": _zeros_like_f32(params),
             "round": torch.zeros((), dtype=torch.float32, device=dev)}
    if cfg.local_momentum == "communicated":
        state["global_m"] = _zeros_like_f32(params)
    if cfg.algorithm != "fedavg":
        state["client_state"] = init_client_state(params, cfg, num_clients)
    if cfg.use_masks:
        state["masks"] = tree_map(
            lambda p: torch.ones(p.shape, dtype=torch.float32,
                                 device=p.device), params)
        if cfg.masked_compute == "kernel":
            if filter_masks is None:
                raise ValueError(
                    "masked_compute='kernel' needs filter_masks in the round "
                    "state: pass the model's all-ones filter masks to "
                    "init_round_state")
            state["filter_masks"] = tree_map(
                lambda m: torch.as_tensor(m, dtype=torch.float32,
                                          device=dev).clone(), filter_masks)
    return state


def apply_masks(tree: Any, masks: Any) -> Any:
    """A param-structured tree times its 0/1 keep-masks, into new tensors
    (dtype kept)."""
    return tree_map(lambda x, m: (x * m).to(x.dtype), tree, masks)


def mask_(tree: Any, masks: Any) -> Any:
    """A param-structured tree times its 0/1 keep-masks, in place (the
    in-place form of :func:`apply_masks`); returns ``tree``.  A leaf with
    leading axes (FedDyn's ``[N, ...]`` per-client ``h``) takes its mask
    broadcast over them."""
    tree_map(lambda x, m: x.mul_(m), tree, masks)
    return tree


def _detached_leaves(params):
    q = tree_map(lambda t: t.detach().requires_grad_(True), params)
    return q, tree_leaves(q)


def _grads(value, leaves) -> list:
    """d value / d leaves; a leaf the value does not use gets zeros, as
    ``jax.grad`` gives it (a vlm batch of ``embeds`` never reads the token
    embedding table)."""
    grads = torch.autograd.grad(value, leaves, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for g, t in zip(grads, leaves)]


def grad(loss_fn: Callable, params: Any, *args) -> Any:
    """The gradient tree of the scalar ``loss_fn(params, *args)`` (the
    counterpart of ``jax.grad``); ``params`` are not modified."""
    with torch.enable_grad():
        q, leaves = _detached_leaves(params)
        loss = loss_fn(q, *args)
        return tree_unflatten(params, _grads(loss, leaves))


def value_and_grad_aux(fn: Callable, params: Any, *args):
    """``((value, aux), grads)`` of ``fn(params, *args) -> (value, aux)``,
    differentiating the value (``jax.value_and_grad(has_aux=True)``)."""
    with torch.enable_grad():
        q, leaves = _detached_leaves(params)
        value, aux = fn(q, *args)
        grads = _grads(value, leaves)
    return (value.detach(), aux.detach()), tree_unflatten(params, grads)


def build_model_fns(cfg: EngineConfig, loss_fn: Callable,
                    la_fn: Callable) -> tuple[Callable, Callable]:
    """``(grad_fn, loss_and_acc_fn)`` in the arity :func:`round_core`
    expects, from ``loss_fn(params, batch, filter_masks)`` and
    ``la_fn(params, batch, filter_masks)``: 3-argument with the filter
    masks in kernel mode, else 2-argument with ``filter_masks=None``."""
    if cfg.use_masks and cfg.masked_compute == "kernel":
        def grad_fn(p, b, fm):
            return grad(loss_fn, p, b, fm)

        def loss_and_acc_fn(p, b, fm):
            return la_fn(p, b, fm)
    else:
        def grad_fn(p, b):
            return grad(loss_fn, p, b, None)

        def loss_and_acc_fn(p, b):
            return la_fn(p, b, None)
    return grad_fn, loss_and_acc_fn


def local_train(cfg: EngineConfig, grad_fn: Callable, params: Any, m: Any,
                batches, lr, anchor: Any = None,
                h: Any = None) -> tuple[Any, Any]:
    """E local epochs on ONE client (Formula 11 when momentum is on),
    updating ``params`` and the f32 momentum ``m`` IN PLACE (``m`` is None
    without local momentum).  ``batches`` is a sequence of step batches;
    ``lr`` a 0-d f32 tensor.

    ``anchor`` is the broadcast round-start model (required for FedProx
    and FedDyn), ``h`` this client's alpha-scaled FedDyn correction, fixed
    over the local epochs.  The corrected gradient feeds the momentum
    recursion like any other, so both compose with every momentum mode."""
    use_m = cfg.local_momentum != "none"
    beta = cfg.feddum.beta_local
    if cfg.algorithm == "fedprox":
        mu = cfg.fedprox.mu

        def corrected(g, p):
            return tree_map(lambda gi, pi, ai: gi.add_(
                (pi - ai).mul_(mu).to(gi.dtype)), g, p, anchor)
    elif cfg.algorithm == "feddyn":
        alpha = cfg.feddyn.alpha

        def corrected(g, p):
            return tree_map(lambda gi, pi, ai, hi: gi.add_(
                (pi - ai).mul_(alpha).to(gi.dtype)).sub_(hi.to(gi.dtype)),
                g, p, anchor, h)
    else:
        def corrected(g, p):
            return g
    for batch in batches:
        g = corrected(grad_fn(params, batch), params)
        if use_m:
            tree_map(lambda mi, gi: mi.mul_(beta).add_(
                gi.float().mul_(1.0 - beta)), m, g)
            del g
            tree_map(lambda p, mi: p.sub_((lr * mi).to(p.dtype)), params, m)
        else:
            tree_map(lambda p, gi: p.sub_(gi.mul_(lr)), params, g)
            del g
    return params, m


def _take(tree, i):
    """Entry ``i`` of every leaf's leading dim."""
    return tree_map(lambda x: x[i], tree)


def _add_weighted(acc, tree, w):
    """``acc + w * tree`` in f32, consuming ``tree`` (its buffer becomes
    the sum when ``acc`` is None and it is already f32)."""
    if acc is None:
        return tree_map(lambda t: t.float().mul_(w), tree)
    tree_map(lambda a, t: a.add_(t.float().mul_(w)), acc, tree)
    return acc


def round_core(cfg: EngineConfig, grad_fn: Callable, loss_and_acc_fn: Callable,
               state: dict, batch: dict,
               shard: RoundShard | None = None) -> tuple[dict, dict]:
    """One federated round (paper steps 2-5) on ``state``, IN PLACE.

    batch (tensors on the state's device):
      client    pytree, leading dims [C, steps, ...] — per-client batches
      sizes     [C] f32 n_k
      server    pytree, leading dim [tau, ...] — server SGD batches
      d_round   D(Pbar'^t), non-IID degree of this round's selection
      d_server  D(P0), non-IID degree of the server data
      n0        number of server samples
      sel       [C] the selected clients' global indices (optional;
                required for FedDyn, which indexes client_state by it)
      active    [C] 0/1 (optional): client dropout; the FedAvg sum runs in
                delta form and dropped clients' state is left as it was

    ``cfg.faults`` (device faults, for tests) rewrite each client's trained
    model before anything reads it.  ``cfg.guard != "off"`` adds the health
    guard: a client whose model (and, with communicated momentum, its
    momentum) is not finite everywhere is scrubbed back to the broadcast
    point and weighs zero, and a non-finite FedDU proposal (model, tau_eff
    or gate accuracy) falls back to the aggregate ``w_half``.  A round with
    no surviving client (``"reject_client"``), or with any rejection
    (``"skip_round"``), is discarded: params, momentum and client state
    stay bit-identical to the round start, and the round counter still
    advances.  The guard's decisions are 0-d device tensors: a guarded
    round reads nothing to the host.

    ``shard`` runs the round as one rank of several (:class:`RoundShard`).

    Returns ``(state, {"tau_eff", "server_acc", "health"})`` as 0-d f32
    tensors; ``health`` counts the rejected active clients plus 1 for a
    rejected server step (0 with the guard off).
    """
    with torch.no_grad():
        return _round(cfg, grad_fn, loss_and_acc_fn, state, batch, shard)


def owned_rows(sel: torch.Tensor, owned: range):
    """``(held [C] bool, local [C] long)``: which of the selected global
    client ids ``sel`` this rank stores (``owned``), and each one's row in
    the rank's arrays (clamped into them where it is not held)."""
    local = sel.long() - owned.start
    held = (local >= 0) & (local < len(owned))
    return held, local.clamp(0, len(owned) - 1)


def from_owners(shard: RoundShard, rows: list, held: torch.Tensor) -> list:
    """Rows ``[C, ...]`` (one list entry per tensor) that each rank filled
    from its own arrays at the selected clients (``held`` marks the ones
    it owns), summed over the ranks with every other row zeroed: each
    element has one non-zero contributor, so the sum is exact.  Returns
    the whole rows where every rank trains every client
    (``shard.clients`` None), else this rank's block of them."""
    rows = [r.masked_fill(~held.view((-1,) + (1,) * (r.dim() - 1)), 0)
            for r in rows]
    if shard.clients is None:
        shard.reduce(rows)
        return rows
    return shard.scatter(rows)


def write_owned(tree, rows, held: torch.Tensor, local: torch.Tensor
                ) -> None:
    """Each leaf's selected rows ``rows[c]`` written to ``local[c]`` where
    ``held[c]`` (a rank's own clients), the other rows left as they are:
    one row at a time in order, so a row a clamped index also points at
    keeps the held value whatever the order (fixed shapes, no host
    read)."""
    def one(x, r):
        for c in range(r.shape[0]):
            i = local[c:c + 1]
            x.index_copy_(0, i, torch.where(held[c], r[c:c + 1],
                                            x.index_select(0, i)))

    tree_map(one, tree, rows)


def _all_finite(*trees, group=None) -> torch.Tensor:
    """0-d bool tensor: every element of every leaf is finite (on every
    rank of ``group``, whose ranks hold blocks of the leaves)."""
    ok = torch.stack([torch.isfinite(t).all() for tree in trees
                      for t in tree_leaves(tree)]).all()
    if group is None:
        return ok
    from repro_torch.sharding.tp import all_true

    return all_true(ok, group)


def _where_(cond, a, b) -> None:
    """``a <- torch.where(cond, a, b)`` leaf by leaf, in place (``cond`` a
    0-d bool tensor; each leaf of ``b`` has its ``a`` leaf's dtype)."""
    tree_map(lambda x, y: torch.where(cond, x, y, out=x), a, b)


def _round(cfg, grad_fn, loss_and_acc_fn, state, batch, shard=None):
    if cfg.use_masks:
        masks = state["masks"]

        def _m(t):
            return mask_(t, masks)

        # kernel mode: filter masks thread into the model, whose masked FFN
        # products run the masked_matmul kernels forward and backward; the
        # param masks still scrub grads/params/momentum as in "params" mode
        extra = ((state["filter_masks"],)
                 if cfg.masked_compute == "kernel" else ())
        base_grad, base_la = grad_fn, loss_and_acc_fn

        def grad_fn(p, b):
            return _m(base_grad(p, b, *extra))

        def loss_and_acc_fn(p, b):
            return base_la(p, b, *extra)
    else:
        def _m(t):
            return t

    params = _m(state["params"])
    lr = cfg.lr * (cfg.lr_decay ** state["round"])

    # (2)-(4) local epochs client after client, FedAvg as a running sum;
    # with an "active" vector or the guard in the delta form around the
    # broadcast point
    client = batch["client"]
    local_steps = tree_leaves(client)[0].shape[1]
    sizes = batch["sizes"].float()
    clients = range(sizes.shape[0])
    reduce = None   # sums over the ranks of the client sums
    if shard is not None and shard.clients is not None:
        clients, reduce = shard.clients, shard.reduce
    active = batch.get("active")
    act = active.float() if active is not None else None
    guard = cfg.guard != "off"
    blocks = None if shard is None else shard.model   # the guard's verdicts
    delta_form = guard or act is not None
    communicated = cfg.local_momentum == "communicated"
    if guard:
        # the weights need every client's verdict: sum sizes act ok
        # (theta - base) and its total, divide once after the loop
        zero = torch.zeros((), dtype=torch.float32, device=lr.device)
        w_total = survivors = rejected = zero
    elif act is not None:
        w = sizes * act
        w = w / torch.clamp(w.sum(), min=1e-12)
    else:
        w = sizes / sizes.sum()
    feddyn = cfg.algorithm == "feddyn"
    anchor = params if cfg.algorithm != "fedavg" else None
    if communicated:
        m0 = _m(state["global_m"])
    if feddyn:
        if "sel" not in batch:
            raise ValueError(
                "algorithm='feddyn' needs batch['sel'] (the selected "
                "clients' global indices) to gather per-client state: "
                "sample_round_batches emits it")
        sel = batch["sel"].long()
        h_all = state["client_state"]["per_client"]["h"]
        alpha = cfg.feddyn.alpha
        drift_sum = None
        owned = None if shard is None else shard.owned
        if owned is not None:
            # rank-local h: this rank's clients' rows from their owners
            held, local = owned_rows(sel, owned)
            h_keep = tree_map(lambda x: x.index_select(0, local), h_all)
            h_mine = tree_unflatten(h_all, from_owners(
                shard, tree_leaves(h_keep), held))
            pos = {c: j for j, c in enumerate(clients)}
        if guard:   # the selected rows as the round found them
            h_rows = (h_keep if owned is not None else
                      tree_map(lambda x: x.index_select(0, sel), h_all))
    if cfg.faults:
        sel_ids = batch.get("sel")
        if sel_ids is None:
            sel_ids = torch.arange(sizes.shape[0], device=lr.device)
    w_half = new_global_m = None
    new_rows = {}   # sharded FedDyn: this rank's clients' new rows of h
    for j, c in enumerate(clients):
        p = tree_map(torch.clone, params)
        if communicated:
            m = tree_map(torch.clone, m0)
        elif cfg.local_momentum == "restart":
            m = _zeros_like_f32(params)
        else:
            m = None
        h = None
        if feddyn and owned is not None:
            h = _m(tree_map(lambda x: x[pos[c]], h_mine))
        elif feddyn:
            row = sel[c:c + 1]
            h = _m(tree_map(lambda x: x.index_select(0, row)[0], h_all))
        mine = _take(client, j)
        steps = [_take(mine, s) for s in range(local_steps)]
        p, m = local_train(cfg, grad_fn, p, m, steps, lr, anchor=anchor,
                           h=h)
        for f in cfg.faults:
            p = f.apply_client(p, params, sel_ids[c], state["round"])
        if guard:
            # a rejected client is scrubbed back to the broadcast point
            # before anything reads it: zero weight alone keeps NaN
            ok = _all_finite(*((p, m) if communicated else (p,)),
                             group=blocks)
            _where_(ok, p, params)
            if communicated:
                _where_(ok, m, m0)
            okf = ok.float()
            a0 = act[c] if act is not None else 1.0
            a_c = okf * a0
            rejected = rejected + (1.0 - okf) * a0
            survivors = survivors + a_c
            wc = sizes[c] * a_c
            w_total = w_total + wc
        else:
            a_c = act[c] if act is not None else None
            wc = w[c]
        if feddyn or delta_form:
            d = tree_map(lambda a, b: a.float() - b.float(), p, params)
        if feddyn:
            # h_k <- h_k - alpha act_k (theta_k - anchor), written back to
            # the client's row; sum_k act_k drift_k for the shared h
            coef = alpha if a_c is None else a_c * alpha
            tree_map(lambda hk, dk: hk.sub_(dk * coef), h, d)
            if reduce is None and owned is None:
                tree_map(lambda x, hk: x.index_copy_(0, row, hk[None]),
                         h_all, h)
            else:
                new_rows[c] = h
            if a_c is None:
                ad = d if drift_sum is not None else tree_map(torch.clone, d)
            else:
                ad = tree_map(lambda dk: dk * a_c, d)
            if drift_sum is None:
                drift_sum = ad
            else:
                tree_map(torch.Tensor.add_, drift_sum, ad)
            del h, ad
        if delta_form:
            w_half = _add_weighted(w_half, d, wc)
        else:
            w_half = _add_weighted(w_half, p, wc)
        d = None
        if communicated:
            if delta_form:
                new_global_m = _add_weighted(
                    new_global_m, tree_map(lambda a, b: a - b, m, m0), wc)
            else:
                new_global_m = _add_weighted(new_global_m, m, wc)
        del p, m
    if reduce is not None:
        # the ranks' partial sums, summed before anything divides them
        trees = [w_half] + ([new_global_m] if communicated else []) + (
            [drift_sum] if feddyn else [])
        if guard:
            totals = torch.stack([w_total, survivors, rejected])
            reduce(tree_leaves(trees) + [totals])
            w_total, survivors, rejected = totals.unbind(0)
        else:
            reduce(tree_leaves(trees))
        if feddyn:
            # each selected client's new row comes from the one rank that
            # trained it: the others add zeros
            rows = tree_map(lambda x: torch.zeros(
                (sel.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                device=x.device), h_all)
            for c, hc in new_rows.items():
                tree_map(lambda r, hk: r[c].copy_(hk), rows, hc)
            reduce(tree_leaves(rows))
            if owned is None:
                tree_map(lambda x, r: x.index_copy_(0, sel, r), h_all, rows)
            else:   # the rows back to their owners
                write_owned(h_all, rows, held, local)
            del rows, new_rows
    elif feddyn and owned is not None:
        # every rank trained every client: each keeps the rows it owns
        rows = tree_unflatten(h_all, [
            torch.stack(r) for r in zip(*(tree_leaves(new_rows[c])
                                          for c in clients))])
        write_owned(h_all, rows, held, local)
        del rows, new_rows
    if delta_form:
        if guard:
            total = torch.clamp(w_total, min=1e-12)
            tree_map(lambda a: a.div_(total), w_half)
            if communicated:
                tree_map(lambda a: a.div_(total), new_global_m)
        # base + sum_k w_k (theta_k - base): an all-dropped round is base
        w_half = tree_map(lambda a, b: a.add_(b.float()).to(b.dtype),
                          w_half, params)
        if communicated:
            tree_map(torch.Tensor.add_, new_global_m, m0)
    else:
        w_half = tree_map(lambda a, p: a.to(p.dtype), w_half, params)

    if feddyn:
        # the server average h and the pull of w_half toward the implicit
        # consensus point, before the FedDU server update (on a copy of
        # the shared h under the guard, which may discard the round)
        hs = _m(state["client_state"]["shared"]["h"])
        hs_new = tree_map(torch.clone, hs) if guard else hs
        n_total = (tree_leaves(h_all)[0].shape[0] if owned is None
                   else shard.num_clients)
        tree_map(lambda h_, s_: h_.sub_(s_.mul_(alpha / n_total)), hs_new,
                 drift_sum)
        del drift_sum
        if alpha > 0:
            w_half = tree_map(lambda wh, h_: (wh.float() - h_ / alpha)
                              .to(wh.dtype), w_half, hs_new)
        _m(h_all)
        _m(hs_new)

    # (5a) FedDU dynamic server update (Formulas 4-7); acc from the FIRST
    # server step's own forward
    if cfg.use_server_update:
        server = batch["server"]
        tau = tree_leaves(server)[0].shape[0]
        server_rows = None if shard is None else shard.server_rows
        w_end = tree_map(torch.clone, w_half)
        acc = None
        for i in range(tau):
            step = _take(server, i)
            if server_rows is not None:   # rows lead every leaf
                step = tree_map(lambda x: x[server_rows], step)
            (_, acc_i), g = value_and_grad_aux(loss_and_acc_fn, w_end, step)
            if server_rows is not None:
                # this rank's share of the batch mean, summed over the ranks
                wt = shard.server_weight
                if wt != 1.0:
                    tree_map(lambda t: t.mul_(wt), g)
                sums = tree_leaves(g)
                if acc is None:
                    acc_i = acc_i.float() * wt
                    sums.append(acc_i)
                shard.reduce(sums)
            g = _m(g)
            if acc is None:
                acc = acc_i.float()
            tree_map(lambda pi, gi: pi.sub_(gi.mul_(lr)), w_end, g)
            del g
        # Formula 6 by the telescoping identity, written over w_end
        g0 = tree_map(lambda a, b: torch.sub(a.float(), b.float(), out=b)
                      .div_(tau * lr), w_half, w_end)
        t_eff = tau_eff(cfg.feddu, acc=acc, round_idx=state["round"],
                        n0=batch["n0"], n_prime=batch["sizes"].sum(),
                        d_round=batch["d_round"], d_server=batch["d_server"],
                        tau=tau)
        # under the guard w_half stays: it is the proposal's fallback
        proposed = feddu_apply(w_half, g0, t_eff, lr,
                               out=None if guard else w_half)
        del g0, w_end
    else:
        proposed = w_half
        t_eff = torch.zeros((), dtype=torch.float32, device=lr.device)
        acc = torch.zeros((), dtype=torch.float32, device=lr.device)

    if guard:
        # the server check: a non-finite proposal, tau_eff or gate accuracy
        # falls back to w_half; then the round's verdict
        server_ok = torch.ones((), dtype=torch.bool, device=lr.device)
        if cfg.use_server_update:
            server_ok = (torch.isfinite(t_eff) & torch.isfinite(acc)
                         & _all_finite(proposed, group=blocks))
            _where_(server_ok, proposed, w_half)
            t_eff = torch.where(server_ok, t_eff, 0.0)
            acc = torch.where(server_ok, acc, 0.0)
        discard = ~(survivors > 0)
        if cfg.guard == "skip_round":
            discard = discard | (rejected > 0) | ~server_ok
        health = rejected + (~server_ok).float()
        t_eff = torch.where(discard, 0.0, t_eff)
        acc = torch.where(discard, 0.0, acc)
    else:
        health = torch.zeros((), dtype=torch.float32, device=lr.device)

    # (5b) FedDUM server momentum on the pseudo-gradient (Formulas 8/12);
    # under the guard a leaf at a time into temporaries, kept unless the
    # round is discarded
    if cfg.server_momentum:
        pseudo = server_pseudo_gradient(params, proposed, out=proposed)
        if guard:
            def step(p, mi, g):
                w2, m2 = server_momentum_step(p, mi, g, cfg.feddum)
                _where_(discard, mi, m2)
                _where_(discard, p, w2)

            tree_map(step, params, state["server_m"], pseudo)
        else:
            server_momentum_step(params, state["server_m"], pseudo,
                                 cfg.feddum, out=(params, state["server_m"]))
    elif guard:
        _where_(discard, params, proposed)
    else:
        tree_map(lambda p, q: p.copy_(q), params, proposed)
    del proposed, w_half

    _m(params)
    _m(state["server_m"])
    if communicated:
        if guard:
            _where_(discard, m0, new_global_m)   # into the old buffer
            new_global_m = m0
        state["global_m"] = _m(new_global_m)
    if feddyn and guard:
        _where_(discard, hs, hs_new)
        if owned is None:
            tree_map(lambda x, old: x.index_copy_(0, sel, torch.where(
                discard, old, x.index_select(0, sel))), h_all, h_rows)
        else:
            write_owned(h_all, h_rows, held & discard, local)
    state["round"].add_(1.0)
    return state, {"tau_eff": t_eff, "server_acc": acc, "health": health}


# ---------------------------------------------------------------------------
# Sampling: indices drawn from a torch.Generator, gathered on the device
# ---------------------------------------------------------------------------

def epoch_indices(generator: torch.Generator, n: int, count: int) -> torch.Tensor:
    """``count`` sample indices drawn as repeated without-replacement epochs
    over ``n`` samples (the paper's epoch semantics)."""
    reps = -(-count // n)
    dev = generator.device
    return torch.cat([torch.randperm(n, generator=generator, device=dev)
                      for _ in range(reps)])[:count]


def draw_round_indices(generator: torch.Generator, *, num_clients: int,
                       n_k: int, n0: int, clients_per_round: int,
                       batch_size: int, local_steps: int, server_batch: int,
                       server_tau: int, dropout_rate: float = 0.0) -> tuple:
    """One round's draws on the generator's device: ``(sel [C], idx
    [C, local_steps * batch_size], sidx [server_tau * server_batch])`` —
    ``C`` distinct clients, and per client and for the server, sample
    indices in without-replacement epochs (the semantics of the
    reference's ``sample_clients`` / ``epoch_indices``, not its draws).

    ``dropout_rate`` > 0 appends ``active [C]``: each selected client stays
    (1.0) unless a uniform draw falls below the rate (0.0), drawn after the
    others, so the draws at rate 0 are unchanged."""
    dev = generator.device
    sel = torch.randperm(num_clients, generator=generator,
                         device=dev)[:clients_per_round]
    count = local_steps * batch_size
    idx = torch.stack([epoch_indices(generator, n_k, count)
                       for _ in range(clients_per_round)])
    sidx = epoch_indices(generator, n0, server_tau * server_batch)
    if not dropout_rate:
        return sel, idx, sidx
    active = (torch.rand(clients_per_round, generator=generator, device=dev)
              >= dropout_rate).to(torch.float32)
    return sel, idx, sidx, active


def sample_round_batches(data: dict, sel, idx, sidx, active=None, *,
                         clients_per_round: int, batch_size: int,
                         local_steps: int, server_batch: int,
                         server_tau: int, dropout_rate: float = 0.0,
                         shard: RoundShard | None = None) -> dict:
    """One round's :func:`round_core` batch gathered from the device-resident
    dataset (``FederatedData.device_arrays``) at the given indices: ``sel``
    [C] clients, ``idx`` [C, local_steps * batch_size] samples of each,
    ``sidx`` [server_tau * server_batch] server samples, and ``active``
    [C] 0/1, the dropout draw, which the batch carries as ``"active"``
    (required iff ``dropout_rate`` > 0, the rate it was drawn at).

    ``shard`` (one rank's part of a round, :class:`RoundShard`) gathers
    only the clients at ``shard.clients`` into ``"client"``; the
    per-client vectors stay whole.  Where the rank stores only its own
    clients (``shard.owned``), each selected client's samples, size and
    label distribution come from the rank that stores it
    (:func:`from_owners`: one sum over the ranks for the sizes and
    distributions, every rank's need of them being whole, and one for the
    samples, which hands each rank its block), at fixed shapes."""
    if bool(dropout_rate) != (active is not None):
        raise ValueError(
            f"dropout_rate={dropout_rate} needs an active vector iff it is "
            f"above 0 (got active={'None' if active is None else 'given'})")
    sel = torch.as_tensor(sel, device=data["sizes"].device).long()
    idx = torch.as_tensor(idx, device=sel.device).long()
    sidx = torch.as_tensor(sidx, device=sel.device).long()
    clients = None if shard is None else shard.clients
    owned = None if shard is None else shard.owned
    if owned is None:
        mine = (slice(None) if clients is None
                else slice(clients.start, clients.stop))
        cx = data["client_x"][sel[mine, None], idx[mine]]
        cy = data["client_y"][sel[mine, None], idx[mine]]
        sizes, dists = data["sizes"][sel], data["client_dists"][sel]
    else:
        held, local = owned_rows(sel, owned)
        sizes, dists = from_owners(
            dataclasses.replace(shard, clients=None),
            [data["sizes"][local], data["client_dists"][local]], held)
        cx, cy = from_owners(shard, [data["client_x"][local[:, None], idx],
                                     data["client_y"][local[:, None], idx]],
                             held)
    n = cx.shape[0]
    cx = cx.reshape(n, local_steps, batch_size, *cx.shape[2:])
    cy = cy.reshape(n, local_steps, batch_size, *cy.shape[2:])
    sx = data["server_x"][sidx].reshape(server_tau, server_batch,
                                        *data["server_x"].shape[1:])
    sy = data["server_y"][sidx].reshape(server_tau, server_batch,
                                        *data["server_y"].shape[1:])
    p_round = niid.global_distribution(dists, sizes)
    batch = {
        "client": (cx, cy),
        "sizes": sizes,
        "server": (sx, sy),
        "d_round": niid.non_iid_degree(p_round, data["p_bar"]),
        "d_server": data["d_server"],
        # a fill on the device: a host-made tensor is a copy that a CUDA
        # graph capture refuses
        "n0": torch.full((), float(data["server_y"].shape[0]),
                         dtype=torch.float32, device=sel.device),
        "sel": sel.to(torch.int32),
    }
    if active is not None:
        batch["active"] = torch.as_tensor(active, device=sel.device).to(
            torch.float32)
    return batch
