"""The batch-dict FL step: the paper's round over any model family.

Counterpart of the reference's ``launch/steps.py``.  ``train_step`` is the
same round as the simulation trainer's, :func:`repro_torch.core.engine.
round_core` (``FederatedTrainer.round_step`` runs it from tuple batches; a
test holds the two equal), wired to a model over batch dicts:

    local E steps        per-client restart-SGDM (FedDUM Formula 11);
    aggregate            the FedAvg weighted mean over the clients;
    FedDU server update  tau server SGD steps on the shared batch, scaled by
                         tau_eff (Formulas 6-7);
    FedDUM server SGDM   pseudo-gradient momentum (Formulas 8/12).

A batch dict carries whatever the family reads (``tokens``, ``labels``,
``embeds`` + 3-stream ``positions`` + ``loss_mask`` for vlm,
``enc_embeds`` for encdec), so this is the step that trains every family,
the encdec one included (``FederatedTrainer`` feeds tokens and labels
only).  :func:`loss_and_accuracy` fuses the Formula-7 accuracy gate into
the first server gradient's forward.

State between rounds is ``{params, server_m, [masks], [filter_masks],
[client_state], round}``; clients are stateless.  With ``use_masks`` the
FedAP keep-masks ride in the state, and :func:`with_masks` injects a
decision into the live state: every state tensor keeps its storage and
shape.  The state is updated in place, as ``round_core`` updates it.

Where the reference's callers jit ``train_step``, the port runs it as one
``core.programs.Program`` (:class:`TrainStep`): the batch is copied into
input buffers kept per shapes, and on the card the first round on a state
runs eagerly, the second is captured as a CUDA graph and later rounds of
the same shapes replay it.

``fl_batch_specs`` builds the (arch x shape) train batch over C clients:
meta-device tensors, or seeded arrays equal to the reference's.

With ``mesh=`` (a ``(data, model)`` mesh) each step is one rank's part of
the reference's SPMD program: the dense family tensor-parallel over
``model`` (``build_model(mesh=)``, ``sharding.tp``), every state tensor the
rank's block under ``fl_state_specs``.  The train step takes the whole
batch and keeps the rank's block under ``fl_batch_partition_specs``
(clients over the client axes, each server step's rows over them too,
replicated over ``model``); its client and server sums run over the
client axes (``RoundShard``), the guard's verdicts over ``model``.  The
serve steps take the whole batch, run the rank's rows (``serve_batch_specs``)
and return the whole logits, as the reference's global array is.  On a
world of one every step is bitwise the unsharded one.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core import programs
from repro_torch.core.engine import (
    EngineConfig,
    FedDynConfig,
    FedProxConfig,
    RoundShard,
    build_model_fns,
    init_round_state,
    round_core,
)
from repro_torch.core.momentum import FedDUMConfig
from repro_torch.core.server_update import FedDUConfig
from repro_torch.models.api import build_model, input_specs
from repro_torch.models.lm import argmax_of, loss_and_acc_of
from repro_torch.sharding import fl_specs, tp
from repro_torch.sharding.specs import make_plan, mesh_coords, shard_tree
from repro_torch.utils.tree import tree_leaves


@dataclasses.dataclass(frozen=True)
class FLRunConfig:
    lr: float = 1e-3              # eta' (local) and eta (server SGD)
    beta_local: float = 0.9       # FedDUM Formula 11
    beta_server: float = 0.9      # FedDUM Formula 8
    eta_server: float = 1.0
    local_steps: int = 1          # local iterations per round (E*n_k/B)
    server_tau: int = 1           # server iterations per round
    server_batch: int = 32
    feddu: FedDUConfig = dataclasses.field(default_factory=FedDUConfig)
    use_server_update: bool = True
    use_momentum: bool = True
    # FedAP keep-masks ride in the round state: a prune changes their
    # contents only (with_masks).
    use_masks: bool = False
    # "kernel" also threads filter masks into the model, so masked FFN
    # products run the masked_matmul kernels forward and backward;
    # "params" masks the tree only.
    masked_compute: str = "params"
    algorithm: str = "fedavg"     # fedavg | fedprox | feddyn
    guard: str = "off"            # off | reject_client | skip_round
    fedprox: FedProxConfig = dataclasses.field(default_factory=FedProxConfig)
    feddyn: FedDynConfig = dataclasses.field(default_factory=FedDynConfig)


def token_accuracy(model, params, batch) -> torch.Tensor:
    logits = model.apply(params, batch)
    ok = (argmax_of(logits, getattr(model, "tp", None))
          == batch["labels"]).float()
    mask = batch.get("loss_mask")
    if mask is not None:
        return (ok * mask).sum() / mask.sum().clamp_min(1.0)
    return ok.mean()


def loss_and_accuracy(model, params, batch, masks=None):
    """(loss, token accuracy) from one forward: the Formula-7 accuracy gate
    fused into the first server gradient.  ``model.apply_with_aux(params,
    batch[, masks=])`` gives (logits, aux or None); ``masks``
    (masked_compute="kernel" only) goes to it, None keeps the plain call."""
    if masks is None:
        logits, aux = model.apply_with_aux(params, batch)
    else:
        logits, aux = model.apply_with_aux(params, batch, masks=masks)
    return loss_and_acc_of(logits, aux, batch, getattr(model, "tp", None))


def engine_config(run: FLRunConfig) -> EngineConfig:
    """The FLRunConfig -> EngineConfig wiring (held against the simulation
    trainer's FLConfig wiring by the port's tests)."""
    return EngineConfig(
        lr=run.lr, lr_decay=1.0,
        use_server_update=run.use_server_update,
        local_momentum="restart" if run.use_momentum else "none",
        server_momentum=run.use_momentum,
        use_masks=run.use_masks,
        masked_compute=run.masked_compute,
        algorithm=run.algorithm,
        guard=run.guard,
        fedprox=run.fedprox,
        feddyn=run.feddyn,
        feddu=run.feddu,
        feddum=FedDUMConfig(beta_server=run.beta_server,
                            beta_local=run.beta_local,
                            eta_server=run.eta_server))


def make_fl_train_step(cfg: ModelConfig, run: FLRunConfig, num_clients: int,
                       *, model: Any = None, device="cuda", mesh=None):
    """Returns ``(init_state(generator, filter_masks=None), train_step(state,
    batch) -> (state, tau_eff))``.

    ``model`` overrides ``build_model(cfg, device=device)`` (anything with
    ``init(generator)``, ``loss(params, batch[, masks=])`` and
    ``apply_with_aux(params, batch[, masks=])``).  ``init_state`` draws the
    params from the generator; in kernel mode it needs the model's all-ones
    ``filter_masks``.  ``train_step`` updates ``state`` in place.

    ``mesh``: the rank's part of the step (see the module docstring); the
    model is ``build_model(cfg, device=, mesh=)`` unless given (then a
    model sharded over the same mesh), ``init_state`` draws the rank's
    block and takes its filter masks (``model.filter_masks(params, {})``).

    batch:
      client  pytree with leading [C, steps, ...] dims
      server  pytree with leading [tau, ...] dim
      sizes   [C] f32 n_k
      d_round, d_server: 0-d f32 (non-IID degrees, Formula 2)
      n0      0-d f32
      sel     [C] int (FedDyn only: the clients' slots in client_state)
    """
    if model is None:
        model = build_model(cfg, device=device, mesh=mesh)
    eng = engine_config(run)

    def loss_fn(p, b, fm):
        if fm is None:
            return model.loss(p, b)
        return model.loss(p, b, masks=fm)

    def la_base(p, b, fm):
        return loss_and_accuracy(model, p, b, masks=fm)

    grad_fn, la_fn = build_model_fns(eng, loss_fn, la_base)

    def init_state(generator: torch.Generator, filter_masks=None) -> dict:
        return init_round_state(model.init(generator), eng,
                                filter_masks=filter_masks,
                                num_clients=num_clients)

    return init_state, TrainStep(eng, grad_fn, la_fn, mesh=mesh, model=model)


class TrainStep:
    """``train_step(state, batch) -> (state, tau_eff)``: one ``round_core``
    on ``state`` (in place) through the step program :attr:`program` (a
    CUDA graph per state and batch shapes on the card, keys counted on the
    CPU), made at the first call on the device of the state's tensors;
    ``tau_eff`` is a tensor of its own.  :meth:`body` is the program's
    eager body (what ``launch.dryrun`` counts) on the batch that
    :meth:`local` gives.

    With ``mesh``, :meth:`local` keeps the rank's block of the batch and
    sets the round's :class:`~repro_torch.core.engine.RoundShard`: the
    clients and the server rows it holds where the client axes split them,
    their sums packed into one all-reduce per dtype over those axes
    (``sharding.tp.packed_all_reduce``), and the ``model`` group of the
    guard.  The program then captures the collectives inside its graph
    (``capture_error_mode="thread_local"``, as the mesh round's)."""

    def __init__(self, eng: EngineConfig, grad_fn, la_fn, *, mesh=None,
                 model=None):
        self.eng, self.grad_fn, self.la_fn = eng, grad_fn, la_fn
        self._inputs = programs.InputBuffers()
        self.program = None
        self.shard = None
        self.mesh = mesh
        if mesh is not None:
            self.plan = make_plan(mesh, model.cfg)
            self._coords = mesh_coords(mesh)
            self._model_group = model.tp.group if model.tp else None
            ca = self.plan.client_axes
            self._clients = (tp.group_of(mesh, ca) if ca and
                             self.plan.axis_size(ca) > 1 else None)
            if self.plan.batch_axes and \
                    self.plan.axis_size(self.plan.batch_axes) > 1:
                raise ValueError(
                    f"{model.cfg.name} splits each client's batch over "
                    f"{self.plan.batch_axes}: FSDP over 'data' is queued in "
                    f"ROADMAP queue 1")
            self._buckets: dict = {}

    def _reduce(self, tensors) -> None:
        tp.packed_all_reduce(tensors, self._clients, self._buckets)

    def local(self, batch: dict) -> dict:
        """The rank's block of ``batch`` (views), with :attr:`shard` set for
        it; ``batch`` itself without a mesh."""
        if self.mesh is None:
            return batch
        plan = self.plan
        parts = fl_specs.fl_batch_partition_specs(batch, plan)
        mine = shard_tree(batch, parts, plan, self._coords)
        clients = server_rows = None
        weight = 1.0
        if self._clients is not None:
            n, c = self._clients.size, batch["sizes"].shape[0]
            if any(parts["client"][k].parts[0] for k in parts["client"]):
                per = c // n
                clients = range(self._clients.rank * per,
                                (self._clients.rank + 1) * per)
            if any(any(p.parts) for p in parts["server"].values()):
                server_rows, weight = slice(None), 1.0 / n
        self.shard = RoundShard(
            reduce=self._reduce, clients=clients, server_rows=server_rows,
            server_weight=weight, model=self._model_group)
        return mine

    def body(self, state: dict, batch: dict) -> dict:
        """One ``round_core`` with every state tensor left in the storage it
        started in; returns the round's metrics."""
        old = tree_leaves(state)
        _, met = round_core(self.eng, self.grad_fn, self.la_fn, state, batch,
                            self.shard)
        programs.settle(state, old)
        return met

    def __call__(self, state: dict, batch: dict):
        if self.program is None:
            kw = ({} if self.mesh is None
                  else {"capture_error_mode": "thread_local"})
            self.program = programs.Program(
                self.body, name="fl_step",
                device=tree_leaves(state["params"])[0].device, **kw)
        met = self.program(state, self._inputs(self.local(batch)))
        return state, met["tau_eff"].clone()


def with_masks(state: dict, masks: Any, filter_masks: Any = None) -> dict:
    """Inject FedAP keep-masks into a running masked round state, in place
    (the batch-dict analogue of ``Prune(mode="mask")``): momentum and
    client state restart, params are masked, and every state tensor keeps
    its storage and shape.  ``filter_masks`` swaps the kernel mode's filter
    masks too (required when the state has a ``filter_masks`` slot)."""
    from repro_torch.core.backend import masked_round_state

    if "masks" not in state:
        raise ValueError("state has no mask slot — build the step with "
                         "FLRunConfig(use_masks=True)")
    if "filter_masks" in state and filter_masks is None:
        raise ValueError(
            "state carries a filter_masks slot (masked_compute='kernel') — "
            "pass filter_masks=model.filter_masks(...) so the kernel path "
            "prunes the same filters the param masks zero")
    if filter_masks is not None and "filter_masks" not in state:
        raise ValueError(
            "filter_masks given but the state has no filter_masks slot — "
            "build the step with FLRunConfig(masked_compute='kernel')")
    return masked_round_state(state, masks, filter_masks=filter_masks)


class _Whole:
    """The serve steps' placement on a mesh: the rank's rows of a batch
    (``serve_batch_specs``), and the whole logits from the ranks' vocab
    columns and rows."""

    def __init__(self, model, mesh):
        self.model, self.mesh = model, mesh
        if mesh is not None:
            self.plan, self.coords = make_plan(mesh, model.cfg), mesh_coords(
                mesh)
            axes = self.plan.client_axes + self.plan.batch_axes
            self.rows = (tp.group_of(mesh, axes) if axes and
                         self.plan.axis_size(axes) > 1 else None)

    @staticmethod
    def rows_of(batch: dict) -> int:
        return (batch["tokens"] if "tokens" in batch
                else batch["embeds"]).shape[0]

    def batch(self, batch: dict) -> dict:
        if self.mesh is None:
            return batch
        return shard_tree(batch, fl_specs.serve_batch_specs(batch, self.plan),
                          self.plan, self.coords)

    def logits(self, logits: torch.Tensor, rows: int) -> torch.Tensor:
        layout = self.model.tp
        if layout is not None and layout.vocab:
            logits = tp.gather_model(logits, layout)
        if self.mesh is not None and self.rows is not None \
                and logits.shape[0] != rows:
            logits = self.rows.all_gather(logits, 0)
        return logits


def make_prefill_step(cfg: ModelConfig, *, device="cuda", mesh=None,
                      attn_impl: str = "xla", model: Any = None):
    """``(model, prefill_step(params, batch) -> next-token logits [B, V])``.
    ``mesh``: the model is the rank's block, ``params`` its params, and the
    step takes the whole batch and returns the whole logits.  ``model``
    overrides ``build_model(cfg, device=, mesh=, attn_impl=)`` (the dry
    run's on the meta device)."""
    if model is None:
        model = build_model(cfg, device=device, mesh=mesh,
                            attn_impl=attn_impl)
    place = _Whole(model, mesh)

    def prefill_step(params, batch):
        rows = place.rows_of(batch)
        logits = model.apply(params, place.batch(batch))[:, -1, :]
        return place.logits(logits, rows)

    return model, prefill_step


def make_decode_step(cfg: ModelConfig, *, device="cuda", mesh=None,
                     model: Any = None):
    """``(model, decode_step(params, cache, batch[, masks]) -> (logits,
    cache))``.  ``mesh``: the model is the rank's block, ``params``,
    ``cache`` (``model.init_cache`` of the whole batch size) and ``masks``
    (its filter masks) its own, and the step takes the whole batch and
    returns the whole logits.  ``model`` overrides ``build_model``."""
    if model is None:
        model = build_model(cfg, device=device, mesh=mesh)
    place = _Whole(model, mesh)

    def decode_step(params, cache, batch, masks=None):
        rows = place.rows_of(batch)
        logits, cache = model.decode_step(params, cache, place.batch(batch),
                                          masks=masks)
        return place.logits(logits, rows), cache

    return model, decode_step


# ---------------------------------------------------------------------------
# FL batch construction for (arch x shape)
# ---------------------------------------------------------------------------

def fl_batch_specs(cfg: ModelConfig, shape: InputShape, num_clients: int,
                   run: FLRunConfig, *, abstract: bool = True, seed: int = 0,
                   device="cuda"):
    """The train-shape batch: the global batch split over C clients, the
    server batch alongside (tau leading dim).  Concrete leaves broadcast one
    draw over the repeated dims (views, as the reference's
    ``broadcast_to``)."""
    c = num_clients
    b_c = max(1, shape.global_batch // c)
    base = input_specs(cfg, shape, abstract=abstract, seed=seed,
                       device=device)
    dev = torch.device("meta") if abstract else next(iter(base.values())).device

    def reshard_client(leaf):
        # [B, ...] -> [C, steps, b_c, ...]
        shp = (c, run.local_steps, b_c) + tuple(leaf.shape[1:])
        return leaf[: c * b_c].reshape((c, 1, b_c) + tuple(leaf.shape[1:])) \
            .expand(shp)

    def reshard_positions(leaf):
        # [P, B, S] -> [C, steps, P, b_c, S]
        p = leaf.shape[0]
        shp = (c, run.local_steps, p, b_c) + tuple(leaf.shape[2:])
        tiled = leaf[:, : c * b_c].reshape((p, c, b_c) + tuple(
            leaf.shape[2:])).transpose(0, 1)[:, None]
        return tiled.expand(shp)

    client = {k: reshard_positions(v) if k == "positions"
              else reshard_client(v) for k, v in base.items()}
    server_base = input_specs(cfg, dataclasses.replace(
        shape, global_batch=run.server_batch), abstract=abstract,
        seed=seed + 1, device=device)
    server = {k: v.expand((run.server_tau,) + tuple(v.shape))
              for k, v in server_base.items()}

    def scalar(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    batch = {
        "client": client,
        "server": server,
        "sizes": torch.ones((c,), dtype=torch.float32, device=dev),
        "d_round": scalar(0.3),
        "d_server": scalar(0.01),
        "n0": scalar(2048.0),
    }
    if run.algorithm == "feddyn":
        # full participation: client k <- slot k of client_state
        batch["sel"] = torch.arange(c, dtype=torch.int32, device=dev)
    return batch
