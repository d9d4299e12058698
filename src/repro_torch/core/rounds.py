"""The simulation trainer: configuration and the user-facing facade.

Counterpart of the reference's ``core/rounds.py``.
One round (Section 3.1): select a device subset, each device runs E local
epochs (SGD, or restart-SGDM for FedDUM; FedProx and FedDyn correct the
local gradient), the server aggregates with FedAvg weights n_k/n' (dropped
clients weigh 0), then updates on its shared data with the dynamic tau_eff
(FedDU), optionally through server momentum (FedDUM).  FedAP prunes as a
``Prune`` event of the plan::

    trainer = FederatedTrainer(model, data, feddumap_config(...),
                               device="cuda")
    res = trainer.run(fedap_plan(60, prune_round=30, mode="mask"))
    res.history["acc"], res.artifacts["prune"]["kept"]

A plan with ``checkpoint_dir`` is snapshotted at chunk boundaries, and a
killed run continues with ``FederatedTrainer(...).resume(checkpoint_dir)``.

``backend="mesh"`` runs the same rounds with the clients split over the
ranks of a ``torch.distributed`` device mesh (:class:`~repro_torch.core.
backend.MeshBackend`): a world of one by default, more ranks under
``torchrun``.  ``round_step`` runs one round at explicit batches, the
engine as ``launch.steps.make_fl_train_step`` runs it.

The round engine is :mod:`repro_torch.core.engine`, the schedule loop
:class:`repro_torch.core.backend.PlanExecutor`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import device as _device
from repro_torch.core.backend import LocalBackend, MeshBackend, PlanExecutor
from repro_torch.core.engine import (
    ALGORITHMS,
    GUARD_MODES,
    EngineConfig,
    FedDynConfig,
    FedProxConfig,
)
from repro_torch.core.momentum import FedDUMConfig
from repro_torch.core.plan import CheckpointError, RunResult, TrainPlan
from repro_torch.core.pruning import FedAPConfig
from repro_torch.core.server_update import FedDUConfig
from repro_torch.reliability import checkpoint as ckpt
from repro_torch.reliability.faults import device_faults

_BACKENDS = {"local": LocalBackend, "mesh": MeshBackend}


@dataclasses.dataclass(frozen=True)
class FLConfig:
    num_clients: int = 100
    clients_per_round: int = 10
    local_epochs: int = 5          # E
    batch_size: int = 10           # B
    lr: float = 0.1                # eta (local and server SGD)
    lr_decay: float = 0.99         # per-round learning-rate decay (paper 4.1)
    seed: int = 0
    # Feature switches — FedDUMAP = server update + restart momentum (+FedAP).
    use_server_update: bool = True       # FedDU
    local_momentum: str = "none"         # none | restart | communicated
    server_momentum: bool = False
    # Client algorithm: "fedavg", "fedprox" (proximal pull toward the
    # round-start model) or "feddyn" (per-client correction state).
    algorithm: str = "fedavg"
    # Each selected client drops this round with this probability; dropped
    # clients weigh 0 in FedAvg and their client state is untouched.
    dropout_rate: float = 0.0
    # The health guard: "reject_client" drops non-finite clients (and
    # discards a round none survives), "skip_round" discards a round on any
    # rejection.  faults: reliability fault events (tests), routed to the
    # engine (device faults) and the executor (host faults).
    guard: str = "off"
    faults: tuple = ()
    # "params" zeroes the parameter tree only (full-density products);
    # "kernel" threads filter masks into the model, so masked FFN products
    # run the masked_matmul kernels forward and backward.
    masked_compute: str = "params"
    # Server data per round: tau = server_epochs * floor(n0 / B_server).
    server_epochs: int = 1
    server_batch_size: int = 32
    feddu: FedDUConfig = dataclasses.field(default_factory=FedDUConfig)
    feddum: FedDUMConfig = dataclasses.field(default_factory=FedDUMConfig)
    fedap: FedAPConfig = dataclasses.field(default_factory=FedAPConfig)
    fedprox: FedProxConfig = dataclasses.field(default_factory=FedProxConfig)
    feddyn: FedDynConfig = dataclasses.field(default_factory=FedDynConfig)

    def __post_init__(self):
        if self.local_momentum not in ("none", "restart", "communicated"):
            raise ValueError(
                f"unknown local_momentum: {self.local_momentum!r} "
                "(expected 'none', 'restart' or 'communicated')")
        if self.masked_compute not in ("params", "kernel"):
            raise ValueError(
                f"unknown masked_compute: {self.masked_compute!r} "
                "(expected 'params' or 'kernel')")
        if not 1 <= self.clients_per_round <= self.num_clients:
            raise ValueError(
                f"clients_per_round must be in [1, num_clients="
                f"{self.num_clients}], got {self.clients_per_round}")
        for name in ("local_epochs", "batch_size", "server_epochs",
                     "server_batch_size"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got "
                                 f"{getattr(self, name)}")
        if self.lr <= 0:
            raise ValueError(f"lr must be > 0, got {self.lr}")
        if self.lr_decay <= 0:
            raise ValueError(f"lr_decay must be > 0, got {self.lr_decay}")
        if self.algorithm not in ALGORITHMS:
            raise ValueError(f"unknown algorithm: {self.algorithm!r} "
                             f"(expected one of {ALGORITHMS})")
        if not 0.0 <= self.dropout_rate < 1.0:
            raise ValueError(f"dropout_rate must be in [0, 1), got "
                             f"{self.dropout_rate}")
        if self.guard not in GUARD_MODES:
            raise ValueError(f"unknown guard: {self.guard!r} "
                             f"(expected one of {GUARD_MODES})")
        for f in self.faults:
            if not (hasattr(f, "apply_client") or hasattr(f, "chunks")):
                raise ValueError(
                    f"FLConfig.faults entries must be reliability fault "
                    f"events (NaNGrad / CorruptUpdate / KillAfterChunk), "
                    f"got {f!r}")


def feddumap_config(**kw) -> FLConfig:
    """The full method: FedDU + FedDUM (+FedAP via a plan Prune event)."""
    kw.setdefault("use_server_update", True)
    kw.setdefault("local_momentum", "restart")
    kw.setdefault("server_momentum", True)
    return FLConfig(**kw)


def engine_config(cfg: FLConfig) -> EngineConfig:
    """The FLConfig -> EngineConfig wiring."""
    return EngineConfig(
        lr=cfg.lr, lr_decay=cfg.lr_decay,
        use_server_update=cfg.use_server_update,
        local_momentum=cfg.local_momentum,
        server_momentum=cfg.server_momentum,
        masked_compute=cfg.masked_compute,
        algorithm=cfg.algorithm,
        guard=cfg.guard,
        faults=device_faults(cfg.faults),
        feddu=cfg.feddu, feddum=cfg.feddum,
        fedprox=cfg.fedprox, feddyn=cfg.feddyn)


class FederatedTrainer:
    """Binds (model, data, config) to a backend on ``device`` (default
    ``"cuda"``, which raises when CUDA is missing) and runs TrainPlans.

    backend: ``"local"`` (one device) or ``"mesh"`` (the clients split over
        the ranks of ``mesh``, by default ``launch.mesh.make_host_mesh``:
        every rank of the process group, or a world of one started here);
        ``backend_opts`` go to :class:`MeshBackend` (``shard_server``,
        which by default follows the model; ``shard_eval``, default True,
        False evaluating the whole test split on every rank, the
        reference's baseline of its sharded eval).  Every backend of the
        trainer (both mask modes, and those on injected ``batches``)
        shares one device-resident dataset.

    model: ``init(generator)``, ``loss_and_acc(params, x, y[, masks=])``
        and, for Prune events, the FedAP seam (``decide_kept``,
        ``filter_masks``, ``param_masks``, ``shrink_params``), e.g.
        :class:`repro_torch.models.lm.LM` on the same device;
    data: :class:`repro_torch.data.pipeline.FederatedData`.
    """

    def __init__(self, model, data, cfg: FLConfig, *, device="cuda",
                 backend: str = "local", mesh=None,
                 backend_opts: dict | None = None):
        if backend not in _BACKENDS:
            raise ValueError(f"backend must be one of {tuple(_BACKENDS)}, "
                             f"got {backend!r}")
        if backend == "local" and (mesh is not None or backend_opts):
            raise ValueError("mesh= and backend_opts= belong to "
                             "backend='mesh'")
        reserved = {"mesh", "use_masks", "data_cache"} & set(
            backend_opts or {})
        if reserved:
            raise ValueError(
                f"backend_opts may not override trainer-managed backend "
                f"arguments {sorted(reserved)}; use the mesh= trainer "
                f"parameter / plan-driven masking instead")
        self.device = _device.resolve(device)
        model_dev = getattr(model, "device", self.device)
        if torch.device(model_dev) != self.device:
            raise ValueError(f"the model lives on {model_dev}, the trainer "
                             f"on {self.device}")
        self.model, self.data, self.cfg = model, data, cfg
        self.backend_name = backend
        self._mesh = mesh
        self._backend_opts = dict(backend_opts or {})
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)
        self._backends: dict = {}
        # every backend of this trainer reads ONE device-resident dataset
        self._data_cache: dict = {}

    def backend(self, *, use_masks: bool = False,
                batches: Callable | None = None) -> LocalBackend:
        """The backend for a mask mode (cached when it samples its own
        batches); every one shares the trainer's device-resident
        dataset."""
        kw = {"data_cache": self._data_cache}
        if self.backend_name == "mesh":
            if self._mesh is None:
                # one mesh for every backend instance of this trainer
                from repro_torch.launch.mesh import make_host_mesh
                self._mesh = make_host_mesh(device=self.device)
            kw.update(self._backend_opts, mesh=self._mesh)
        cls = _BACKENDS[self.backend_name]
        if batches is not None:
            return cls(self.model, self.data, self.cfg, use_masks=use_masks,
                       device=self.device, batches=batches, **kw)
        if use_masks not in self._backends:
            self._backends[use_masks] = cls(
                self.model, self.data, self.cfg, use_masks=use_masks,
                device=self.device, generator=self.generator, **kw)
        return self._backends[use_masks]

    def round_step(self, state: dict, batch: dict):
        """One round of ``engine.round_core`` on ``state`` (in place) at an
        explicit batch (numpy or tensors; ``(x, y)`` tuples), with this
        trainer's engine config (masks on iff the state has a mask slot);
        returns ``(state, metrics)``.  The round the batch-dict step of
        ``launch.steps`` runs.  It goes through the backend's round program
        (``LocalBackend.step``), as the reference's ``round_step`` is its
        compiled ``round_core``: on the card the first round on a state
        runs eagerly, the second is captured and later rounds of the same
        batch shapes replay."""
        be = self.backend(use_masks="masks" in state)
        return state, be.step(state, batch)

    def run(self, plan: TrainPlan | int, *, eval_every: int = 1,
            params=None, batches: Callable | None = None) -> RunResult:
        """Execute a plan (an ``int`` builds the standard train+eval plan
        for that many rounds).  ``params`` default to ``model.init`` from a
        generator seeded with ``cfg.seed``; they are not modified.
        ``batches`` (optional) is a per-round batch source ``batches(t)``
        that replaces the trainer's own sampling (round ``t`` counts from
        0 over the run).  A plan's ``Callback`` events receive this
        trainer."""
        if isinstance(plan, int):
            plan = TrainPlan.standard(plan, eval_every=eval_every)
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.cfg.seed)
            params = self.model.init(gen)
        backend = self.backend(use_masks=plan.uses_masks, batches=batches)
        return PlanExecutor(backend, trainer=self,
                            faults=self.cfg.faults).run(plan, params=params)

    def resume(self, checkpoint_dir, *, plan: TrainPlan | None = None,
               batches: Callable | None = None) -> RunResult:
        """Continue a killed run from its chunk-boundary checkpoints,
        bit-identically to the uninterrupted run: the round state, this
        trainer's generator state, the plan cursor and the history come
        back from the newest snapshot.

        ``plan=None`` rebuilds the schedule from the checkpoint's plan spec
        (checkpointing on, into the same directory).  A plan with
        :class:`~repro_torch.core.plan.Callback` events cannot be rebuilt
        from disk: pass the original plan, which is checked against the
        spec.  ``batches`` is the per-round batch source of :meth:`run`,
        continued at the restored round; a checkpoint without a generator
        state (a run on injected batches, or one the reference package
        wrote) needs it."""
        payload = ckpt.load_checkpoint(checkpoint_dir)
        if payload.get("backend") != self.backend_name:
            raise CheckpointError(
                f"checkpoint was written by the {payload.get('backend')!r} "
                f"backend but this trainer runs {self.backend_name!r}: "
                f"resume on the same backend (bit-identity is per-backend)")
        if plan is None:
            plan = ckpt.plan_from_spec(
                payload["plan"],
                checkpoint_every=payload.get("checkpoint_every"),
                checkpoint_dir=payload.get("checkpoint_dir", checkpoint_dir))
        elif ckpt.plan_spec(plan) != list(payload["plan"]):
            raise CheckpointError(
                "the plan passed to resume() does not match the plan the "
                "checkpoint was written under: resuming would replay a "
                "different schedule")
        backend = self.backend(use_masks=plan.uses_masks, batches=batches)
        return PlanExecutor(backend, trainer=self,
                            faults=self.cfg.faults).run(plan, resume=payload)
