"""The plan executor and the local backend it drives.

Counterpart of the reference's ``core/backend.py`` for one device.  A
:class:`~repro_torch.core.plan.TrainPlan` says WHAT happens (Scan / Eval /
Prune / Snapshot / Callback); :class:`PlanExecutor` owns the schedule loop
(history, artifacts, the Prune decision/apply split, the Callback restart)
and drives :class:`LocalBackend`, which runs the rounds of
:func:`repro_torch.core.engine.round_core` eagerly.

Where the reference compiles a scan chunk, the port runs one eager round
after another, and a ``Prune(mode="mask")`` writes the masks into the
existing state tensors (``copy_``/``mul_``/``zero_``): every state tensor
keeps its storage and shape, the eager analogue of the reference's "zero
added programs".  A shrink gathers the kept indices into new tensors, so it
reads the old state before anything is reused.  The state changes in
place, so a ``Snapshot`` or a ``Callback`` gets a copy of the params taken
at the event (the reference loans its immutable arrays and copies them
lazily).

Fault tolerance lives in the executor, as in the reference: a plan with
``checkpoint_dir`` is snapshotted at chunk boundaries
(:mod:`repro_torch.reliability.checkpoint`), ``run(resume=payload)``
continues a killed run bit-identically, and host faults
(``reliability.KillAfterChunk``) raise ``SimulatedCrash`` after the
chunk's checkpoint write.  A resume is bit-identical only if the run is
deterministic, and on the GPU cuDNN's default choice is not: for the
paper's SimpleCNN on an H100 it picks gradient kernels that sum with
atomics (``dgrad_engine``, ``wgrad_alg0_engine``), one step's gradients
differed by 6e-8 over three calls and two runs of a 3-round plan by 2e-3.
So the executor runs its plan with cuDNN restricted to deterministic
algorithms (:func:`deterministic_cudnn`; no measurable cost a round
there).  The mesh backend comes with a later slice.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import engine, pruning
from repro_torch.core.engine import EngineConfig
from repro_torch.core.plan import (
    Callback,
    CheckpointError,
    Eval,
    Prune,
    RunResult,
    Scan,
    Snapshot,
    TrainPlan,
)
from repro_torch.reliability import checkpoint as ckpt
from repro_torch.reliability.faults import SimulatedCrash, host_faults
from repro_torch.utils.tree import tree_map


def model_fns(model, eng: EngineConfig):
    """``(grad_fn, loss_and_acc_fn)`` for ``round_core`` from a model with
    ``loss_and_acc(params, x, y[, masks=])`` over ``(x, y)`` batches."""
    accepts_masks = "masks" in inspect.signature(model.loss_and_acc).parameters
    if eng.use_masks and eng.masked_compute == "kernel" and not accepts_masks:
        raise TypeError(
            f"masked_compute='kernel' needs the model's loss_and_acc to "
            f"accept masks=, but {type(model).__name__}.loss_and_acc does not")

    if accepts_masks:
        def la_fn(p, b, fm):
            return model.loss_and_acc(p, b[0], b[1], masks=fm)
    else:
        def la_fn(p, b, fm):
            return model.loss_and_acc(p, b[0], b[1])

    def loss_fn(p, b, fm):
        return la_fn(p, b, fm)[0]

    return engine.build_model_fns(eng, loss_fn, la_fn)


def sim_sample_kw(cfg, data) -> dict:
    """The sampling shape of one simulated round."""
    n_k = int(data.client_x.shape[1])
    n0 = int(data.server_x.shape[0])
    return dict(
        clients_per_round=cfg.clients_per_round,
        batch_size=cfg.batch_size,
        local_steps=max(1, n_k // cfg.batch_size) * cfg.local_epochs,
        server_batch=cfg.server_batch_size,
        server_tau=max(1, n0 // cfg.server_batch_size) * cfg.server_epochs,
        dropout_rate=float(cfg.dropout_rate),
    )


# The Prune apply goes through a small model seam: a model that publishes
# its own mask and shrink builders (the scanned LM, whose stacked [L, ...]
# layers are pruned by per-layer index rows) is called there; a PruneSpec
# model (the paper's CNNs) takes the spec-driven builders of
# ``core.pruning``.  ``kept`` is the decision's host-side index map.

def param_masks_for(model, params, kept):
    """Param-structured 0/1 masks for ``state["masks"]``."""
    if hasattr(model, "param_masks"):
        return model.param_masks(params, kept)
    return pruning.param_masks(params, model.prune_spec(params), kept)


def filter_masks_for(model, params, kept):
    """Per-layer filter keep-masks (the model's ``masks=``)."""
    if hasattr(model, "filter_masks"):
        return model.filter_masks(params, kept)
    return pruning.filter_masks(params, model.prune_spec(params), kept)


def shrink_params_for(model, params, kept):
    """A params-structured tree (params or a momentum buffer) gathered at
    the kept indices, into new tensors."""
    if hasattr(model, "shrink_params"):
        return model.shrink_params(params, kept)
    return pruning.shrink_params(params, model.prune_spec(params), kept)


def init_filter_masks(model, params):
    """All-ones filter masks (kernel mode): the state holds them from round
    0, so a prune only changes their contents."""
    return filter_masks_for(model, params, {})


def masked_round_state(state: dict, masks: Any, filter_masks: Any = None
                       ) -> dict:
    """Inject FedAP keep-masks into a live masked round state, IN PLACE:
    server (and communicated) momentum and the FedProx/FedDyn client state
    restart at zero, the masks and filter masks are copied into their
    tensors, and the params are masked.  No state tensor changes storage or
    shape."""
    with torch.no_grad():
        for k in ("server_m", "global_m", "client_state"):
            if k in state:
                tree_map(torch.Tensor.zero_, state[k])
        tree_map(lambda dst, m: dst.copy_(m), state["masks"], masks)
        engine.mask_(state["params"], state["masks"])
        if filter_masks is not None:
            tree_map(lambda dst, m: dst.copy_(m), state["filter_masks"],
                     filter_masks)
    return state


class LocalBackend:
    """Rounds on one device, eagerly, with the whole federated dataset
    resident there.

    ``batches`` (optional) is a per-round batch source: ``batches(t)``
    returns round ``t``'s ``round_core`` batch (0-based over the run; numpy
    or tensors).  Without it, rounds sample with :func:`engine.
    draw_round_indices` from ``generator``.
    """

    name = "local"

    def __init__(self, model, data, cfg, *, use_masks: bool = False,
                 device, generator: torch.Generator | None = None,
                 batches: Callable | None = None):
        from repro_torch.core.rounds import engine_config

        self.model, self.data, self.cfg = model, data, cfg
        self.device = torch.device(device)
        self.eng = dataclasses.replace(engine_config(cfg),
                                       use_masks=use_masks)
        self.sample_kw = sim_sample_kw(cfg, data)
        self.grad_fn, self.la_fn = model_fns(model, self.eng)
        self.generator = generator
        self.batches = batches
        self._data = None

    @property
    def _kernel_masks(self) -> bool:
        return self.eng.use_masks and self.eng.masked_compute == "kernel"

    @property
    def _num_clients(self) -> int:
        """The total client count: sizes FedDyn's per-client state."""
        return int(self.data.client_x.shape[0])

    def device_data(self) -> dict:
        if self._data is None:
            self._data = self.data.device_arrays(self.device)
        return self._data

    def init_state(self, params) -> dict:
        """A fresh round state over a COPY of ``params`` (kernel mode: with
        all-ones filter masks, whose contents a prune event replaces)."""
        fmasks = (init_filter_masks(self.model, params)
                  if self._kernel_masks else None)
        return engine.init_round_state(tree_map(torch.clone, params),
                                       self.eng, filter_masks=fmasks,
                                       num_clients=self._num_clients)

    def restore_state(self, state: dict) -> dict:
        """A checkpointed round state (host numpy) back on the device, each
        leaf keeping its dtype: f32 round-trips through npz bit-exactly."""
        return tree_map(lambda a: _tensor(a, self.device), state)

    def snapshot(self, state: dict):
        """A copy of the global params: later rounds leave it unchanged."""
        return tree_map(torch.clone, state["params"])

    def snapshot_artifact(self, state: dict, t: int) -> dict:
        """A ``Snapshot`` artifact, its params copied now (the reference
        defers its copy to the next donating call; the port's rounds write
        the state in place, so a deferred copy would see them)."""
        return {"round": t, "params": self.snapshot(state)}

    def replace_params(self, state: dict, params) -> dict:
        """The Callback contract: replacement params (copied) start a new
        round state, momentum and client state at zero, with the round
        count kept and an earlier mask decision kept in force.  Params at
        new shapes (a structured prune) make every tensor new."""
        new_state = engine.init_round_state(
            tree_map(torch.clone, params), self.eng,
            filter_masks=state.get("filter_masks"),
            num_clients=self._num_clients)
        new_state["round"] = state["round"]
        if "masks" in state:
            new_state["masks"] = state["masks"]
            engine.mask_(new_state["params"], state["masks"])
        return new_state

    def round_batch(self, t: int) -> dict:
        """Round ``t``'s batch: from the injected source, or drawn."""
        if self.batches is not None:
            return tree_map(lambda a: _tensor(a, self.device),
                            self.batches(t))
        d = self.device_data()
        kw = self.sample_kw
        draws = engine.draw_round_indices(
            self.generator, num_clients=int(d["client_x"].shape[0]),
            n_k=int(d["client_x"].shape[1]),
            n0=int(d["server_x"].shape[0]), **kw)
        return engine.sample_round_batches(d, *draws, **kw)

    def run_rounds(self, state: dict, t: int, n: int):
        """Rounds ``t .. t+n-1`` on ``state`` (in place); returns (state,
        per-round metrics)."""
        mets = []
        for r in range(t, t + n):
            state, met = engine.round_core(self.eng, self.grad_fn,
                                           self.la_fn, state,
                                           self.round_batch(r))
            mets.append(met)
        return state, mets

    def evaluate(self, state):
        d = self.device_data()
        with torch.no_grad():
            return self.model.loss_and_acc(state["params"], d["test_x"],
                                           d["test_y"])

    def prune_decision(self, state, init_params):
        from repro_torch.core import fedap

        return fedap.fedap_decision(
            self.model, self.data, self.cfg.fedap, state["params"],
            init_params=init_params,
            rng=np.random.default_rng(self.cfg.seed))

    def apply_prune(self, state: dict, mode: str, kept, *,
                    compact_existing: bool = False):
        """mask: write keep-masks into the live state (momentum restarts);
        shrink: a new state over the smaller model.  ``compact_existing``
        (the mask-now-shrink-later follow-up) gathers the momentum buffers
        at the kept indices too instead of restarting them, so masked then
        shrunk training goes on as shrink-from-the-start training would on
        a normalisation-free model.  A shrink restarts the FedDyn client
        state as zeros at the shrunk shapes: the old ``h`` lives in the
        pre-prune coordinates."""
        params = state["params"]
        if mode == "mask":
            masks = param_masks_for(self.model, params, kept)
            fmasks = filter_masks_for(self.model, params, kept)
            new_state = masked_round_state(
                state, masks,
                filter_masks=fmasks if self._kernel_masks else None)
            return new_state, {"filter_masks": fmasks}
        new_params = shrink_params_for(self.model, params, kept)
        fm = (init_filter_masks(self.model, new_params)
              if self._kernel_masks else None)
        new_state = engine.init_round_state(new_params, self.eng,
                                            filter_masks=fm,
                                            num_clients=self._num_clients)
        if compact_existing:
            for k in ("server_m", "global_m"):
                if k in state:
                    new_state[k] = shrink_params_for(self.model, state[k],
                                                     kept)
        new_state["round"] = state["round"]
        return new_state, {"params_before": params}


def _tensor(a, device) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.array(a))
    return a.to(device)


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN restricted to its deterministic algorithms inside the block
    (``torch.backends.cudnn.deterministic``, restored after)."""
    cudnn = torch.backends.cudnn
    before = cudnn.deterministic
    cudnn.deterministic = True
    try:
        yield
    finally:
        cudnn.deterministic = before


class PlanExecutor:
    """Executes a :class:`TrainPlan` against a backend: history rows record
    the completed-round count at each Eval (a Callback receives it too),
    artifact keys get ``#k`` suffixes on repeats, and a Callback that
    returns params restarts the round state through the backend.
    ``trainer`` is what a Callback receives as its first argument;
    ``faults`` may hold host faults (``reliability.KillAfterChunk``), the
    others are ignored here."""

    def __init__(self, backend: LocalBackend, *, trainer=None, faults=()):
        self.backend = backend
        self.trainer = trainer
        self._host_faults = host_faults(faults)

    def run(self, plan: TrainPlan, *, params=None,
            resume: dict | None = None) -> RunResult:
        """Run ``plan`` from ``params`` (which are not modified; they are
        the Lipschitz estimate's start point of any Prune decision), or
        continue it from ``resume``, a ``reliability.load_checkpoint``
        payload: the round state, history, artifacts, counters and the
        backend generator's state come back from it, and the events before
        its cursor are skipped."""
        backend = self.backend
        gen = backend.generator
        if resume is not None:
            if params is not None:
                raise ValueError("run(resume=...) restores the params from "
                                 "the checkpoint: pass no params=")
            if gen is not None:
                if resume.get("generator_state") is None:
                    raise CheckpointError(
                        "the checkpoint holds no torch.Generator state (a "
                        "run on injected batches, or one of the reference "
                        "package, which keeps a JAX key): resume it with "
                        "batches=")
                gen.set_state(_tensor(resume["generator_state"], "cpu"))
            params = tree_map(lambda a: _tensor(a, backend.device),
                              resume["init_params"])
            state = backend.restore_state(resume["state"])
            history = {k: list(v) for k, v in resume["history"].items()}
            artifacts: dict = dict(resume["artifacts"])
            t = int(resume["t"])
            last_tau = float(resume["last_tau"])
            chunks_done = int(resume["chunks_done"])
            start = int(resume["cursor"])
            t0 = time.perf_counter() - float(resume.get("elapsed", 0.0))
        else:
            if params is None:
                raise ValueError("run() needs params= (or resume=)")
            state = backend.init_state(params)
            history = {"round": [], "acc": [], "loss": [], "tau_eff": [],
                       "time": [], "health": []}
            artifacts = {}
            t0 = time.perf_counter()
            t = 0
            last_tau = 0.0
            chunks_done = 0
            start = 0
        ckpt_dir = plan.checkpoint_dir

        def record(name, value):
            k, i = name, 1
            while k in artifacts:
                k = f"{name}#{i}"
                i += 1
            artifacts[k] = value

        def write_checkpoint(cursor):
            ckpt.save_checkpoint(ckpt_dir, {
                "state": state,
                "generator_state": None if gen is None else gen.get_state(),
                "cursor": cursor, "t": t, "chunks_done": chunks_done,
                "last_tau": last_tau, "history": history,
                "artifacts": artifacts, "init_params": params,
                "plan": ckpt.plan_spec(plan),
                "checkpoint_every": plan.checkpoint_every,
                "checkpoint_dir": str(ckpt_dir),
                "backend": backend.name,
                "elapsed": time.perf_counter() - t0,
            })

        with deterministic_cudnn():
            for idx, ev in enumerate(plan.compiled()):
                if idx < start:     # resumed: this event already ran
                    continue
                if isinstance(ev, Scan):
                    state, mets = backend.run_rounds(state, t, ev.rounds)
                    t += ev.rounds
                    last_tau = float(mets[-1]["tau_eff"])
                    history["health"].extend(float(m["health"]) for m in mets)
                    chunks_done += 1
                    if (ckpt_dir is not None
                            and chunks_done % plan.checkpoint_every == 0):
                        write_checkpoint(idx + 1)
                    # after the checkpoint write, where a preemption between
                    # chunks lands; counted over the whole run, so a resumed
                    # run past the fault does not die again
                    for f in self._host_faults:
                        if f.chunks == chunks_done:
                            raise SimulatedCrash(
                                f"injected kill after chunk {chunks_done} "
                                f"(round {t})")
                elif isinstance(ev, Eval):
                    loss, acc = backend.evaluate(state)
                    history["round"].append(t)
                    history["acc"].append(float(acc))
                    history["loss"].append(float(loss))
                    history["tau_eff"].append(last_tau)
                    history["time"].append(time.perf_counter() - t0)
                elif isinstance(ev, Snapshot):
                    record(ev.name, backend.snapshot_artifact(state, t))
                elif isinstance(ev, Prune):
                    state, art = self._prune(ev, state, params, artifacts)
                    record(ev.name, art)
                elif isinstance(ev, Callback):
                    maybe = ev.fn(self.trainer, t, backend.snapshot(state))
                    if maybe is not None:
                        state = backend.replace_params(state, maybe)
                else:  # pragma: no cover — TrainPlan validates event types
                    raise TypeError(f"unknown plan event: {ev!r}")
        return RunResult(params=state["params"], history=history,
                         artifacts=artifacts, state=state)

    def _prune(self, ev: Prune, state: dict, init_params, artifacts: dict):
        """Decision + apply of one Prune event -> (new state, artifact).
        ``Prune(reuse=name)`` compacts to the most recent artifact under
        ``name`` (repeats are recorded as ``name#k``) with no second
        decision."""
        backend = self.backend
        if ev.reuse is None:
            decision = backend.prune_decision(state, init_params)
            art = decision.summary()
            art["kept"] = decision.kept
            art["mode"] = ev.mode
            new_state, extra = backend.apply_prune(state, ev.mode,
                                                   decision.kept)
            art.update(extra)
            return new_state, art
        src = None
        for k, v in artifacts.items():
            if (k.split("#", 1)[0] == ev.reuse and isinstance(v, dict)
                    and "kept" in v):
                src = v
        if src is None:
            raise ValueError(
                f"Prune(reuse={ev.reuse!r}) found no earlier prune artifact "
                f"named {ev.reuse!r} (have: {sorted(artifacts)})")
        kept = src["kept"]
        new_state, extra = backend.apply_prune(state, ev.mode, kept,
                                               compact_existing=True)
        art = {"mode": ev.mode, "reused": ev.reuse, "kept": kept,
               "kept_counts": {k: int(np.asarray(v).shape[-1])
                               for k, v in kept.items()},
               "p_star": src.get("p_star"),
               "layer_rates": src.get("layer_rates"), **extra}
        return new_state, art
