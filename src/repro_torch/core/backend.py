"""The plan executor and the backends it drives.

Counterpart of the reference's ``core/backend.py``.  A
:class:`~repro_torch.core.plan.TrainPlan` says WHAT happens (Scan / Eval /
Prune / Snapshot / Callback); :class:`PlanExecutor` owns the schedule loop
(history, artifacts, the Prune decision/apply split, the Callback restart)
and drives a backend: :class:`LocalBackend`, which runs the rounds of
:func:`repro_torch.core.engine.round_core` on one device, or
:class:`MeshBackend`, the same rounds with the clients split over the ranks
of a ``torch.distributed`` device mesh.

Where the reference compiles a scan chunk, the port runs each round
through one round program (``LocalBackend.chunk``, a
:class:`~repro_torch.core.programs.Program`, on either backend): on the
card the first round
on a state runs eagerly, the second is captured as a CUDA graph and
replayed, and every later round on that state is one replay, whatever the
chunk's length.  The
round's indices are drawn outside the program, as before, and copied into
input buffers kept across rounds; the gather of the batch runs inside it.
Evaluation runs one eval program per model (:func:`eval_program`; the
mesh's sharded one has its all-reduce inside), captured on the card at the
second Eval on the same params.
A ``Prune(mode="mask")`` writes the masks into the existing state tensors
(``copy_``/``mul_``/``zero_``): every state tensor keeps its storage and
shape, so the capture replays on, the reference's "zero added programs".
A shrink gathers the kept indices into new tensors (it reads the old state
before anything is reused), and the new state is a new program, as a
``Callback``'s new params and a resumed state are.  The state changes in
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
there).
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
import time
import weakref
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import engine, programs, pruning
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
from repro_torch.launch.mesh import all_gather, reduce_scatter
from repro_torch.reliability import checkpoint as ckpt
from repro_torch.reliability.faults import SimulatedCrash, host_faults
from repro_torch.utils.tree import tree_leaves, tree_map


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


# The eval programs: one per (model, device) per process, shared by every
# backend over that model (the reference's ``_EVAL_CACHE``).  An entry
# holds its model weakly and goes with it, and the program's CUDA graphs
# and their memory pool with the entry.
_EVAL_PROGRAMS: dict = {}


def clear_eval_programs() -> None:
    """Drop every eval program (and its captures)."""
    _EVAL_PROGRAMS.clear()


def eval_program(model, device) -> programs.Program:
    """The one :class:`~repro_torch.core.programs.Program` over
    ``model.loss_and_acc(params, x, y)`` (under ``torch.no_grad``) on
    ``device``: its key is the params' and the split's tensors, so a
    shrink's params make a new key, and on the card the second Eval on the
    same params captures it."""
    key = (id(model), str(torch.device(device)))
    entry = _EVAL_PROGRAMS.get(key)
    if entry is None:
        ref = weakref.ref(model, lambda _: _EVAL_PROGRAMS.pop(key, None))

        def body(params, x, y):
            with torch.no_grad():
                return ref().loss_and_acc(params, x, y)

        entry = _EVAL_PROGRAMS[key] = (ref, programs.Program(
            body, name="eval", device=device))
    return entry[1]


class LocalBackend:
    """Rounds on one device, with the whole federated dataset resident
    there, each round through the round program :attr:`chunk` (captured on
    the card: see the module docstring).

    ``batches`` (optional) is a per-round batch source: ``batches(t)``
    returns round ``t``'s ``round_core`` batch (0-based over the run; numpy
    or tensors).  Without it, rounds sample with :func:`engine.
    draw_round_indices` from ``generator``.  An explicit batch
    (``FederatedTrainer.round_step``) runs the same program
    (:meth:`step`).  Evaluation runs :func:`eval_program`, the one program
    per model that every backend over the model shares (outside the
    compile budget, as the reference keeps its eval program).

    ``data_cache`` (a dict, optional) holds the device-resident dataset
    under ``"local"``: the trainer passes one to all its backends, so they
    share one copy on the device.
    """

    name = "local"
    is_writer = True    # writes the plan's checkpoints

    def __init__(self, model, data, cfg, *, use_masks: bool = False,
                 device, generator: torch.Generator | None = None,
                 batches: Callable | None = None,
                 data_cache: dict | None = None):
        from repro_torch.core.rounds import engine_config

        self.model, self.data, self.cfg = model, data, cfg
        self.device = torch.device(device)
        self.eng = dataclasses.replace(engine_config(cfg),
                                       use_masks=use_masks)
        self.sample_kw = sim_sample_kw(cfg, data)
        self.grad_fn, self.la_fn = model_fns(model, self.eng)
        self.generator = generator
        self.batches = batches
        self._data_cache = {} if data_cache is None else data_cache
        self._inputs = programs.InputBuffers()  # a round's inputs, by shapes
        self.chunk = programs.Program(self._round_body, name="round",
                                      device=self.device,
                                      **self._program_kw())

    def _program_kw(self) -> dict:
        """The round program's extra arguments (the mesh's counters)."""
        return {}

    @property
    def _kernel_masks(self) -> bool:
        return self.eng.use_masks and self.eng.masked_compute == "kernel"

    @property
    def _num_clients(self) -> int:
        """The total client count (the round's draw is over it)."""
        return int(self.data.client_x.shape[0])

    @property
    def _h_rows(self) -> int:
        """Rows of FedDyn's per-client state this backend holds."""
        return self._num_clients

    def _data_key(self):
        return "local"

    def _place_data(self) -> dict:
        return self.data.device_arrays(self.device)

    def device_data(self) -> dict:
        """The device-resident dataset, placed once per data cache."""
        key = self._data_key()
        d = self._data_cache.get(key)
        if d is None:
            d = self._data_cache[key] = self._place_data()
        return d

    def init_state(self, params) -> dict:
        """A fresh round state over a COPY of ``params`` (kernel mode: with
        all-ones filter masks, whose contents a prune event replaces)."""
        fmasks = (init_filter_masks(self.model, params)
                  if self._kernel_masks else None)
        return engine.init_round_state(tree_map(torch.clone, params),
                                       self.eng, filter_masks=fmasks,
                                       num_clients=self._h_rows)

    def restore_state(self, state: dict) -> dict:
        """A checkpointed round state (host numpy) back on the device, each
        leaf keeping its dtype: f32 round-trips through npz bit-exactly."""
        return tree_map(lambda a: _tensor(a, self.device), state)

    def whole_state(self, state: dict) -> dict:
        """The round state with every per-client row in it (what a
        checkpoint and ``RunResult.state`` hold): ``state`` itself here,
        where every row is on this device."""
        return state

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
            num_clients=self._h_rows)
        new_state["round"] = state["round"]
        if "masks" in state:
            new_state["masks"] = state["masks"]
            engine.mask_(new_state["params"], state["masks"])
        return new_state

    def round_batch(self, t: int) -> dict:
        """Round ``t``'s batch: from the injected source, or drawn.  Where a
        mesh splits the clients, ``"client"`` holds only this rank's (every
        rank draws the same indices)."""
        return self._batch(self._source(t))

    def _source(self, t: int):
        """Round ``t``'s inputs: the injected batch, or the drawn indices
        (``draw_round_indices``' tuple)."""
        if self.batches is not None:
            return tree_map(lambda a: _tensor(a, self.device),
                            self.batches(t))
        d = self.device_data()
        return engine.draw_round_indices(
            self.generator, num_clients=self._num_clients,
            n_k=int(d["client_x"].shape[1]),
            n0=int(d["server_x"].shape[0]), **self.sample_kw)

    def _batch(self, src) -> dict:
        """The ``round_core`` batch of a round's inputs (the gather at the
        drawn indices, a tuple, or an explicit batch dict's rows of this
        rank)."""
        shard = self._round_shard()
        mine = shard.clients if shard is not None else None
        if not isinstance(src, dict):
            return engine.sample_round_batches(self.device_data(), *src,
                                               **self.sample_kw,
                                               shard=shard)
        batch = dict(src)
        if mine is not None:
            batch["client"] = tree_map(lambda x: x[mine.start:mine.stop],
                                       batch["client"])
        return batch

    def _round_inputs(self, t: int):
        """Round ``t``'s inputs copied into buffers kept across rounds (one
        set per structure and shapes), so that every round on a state runs
        the round program on the same storages."""
        return self._inputs(self._source(t))

    def step(self, state: dict, batch: dict) -> dict:
        """One round on ``state`` (in place) at an explicit ``round_core``
        batch (numpy or tensors), through the round program: the batch is
        copied into the input buffers of its shapes.  Returns the round's
        metrics, tensors of their own."""
        src = tree_map(lambda a: _tensor(a, self.device), batch)
        met = self.chunk(state, self._inputs(src))
        return tree_map(torch.clone, met)

    def _round_body(self, state: dict, inputs) -> dict:
        """The round program: the batch gathered from ``inputs``, one
        ``round_core`` on ``state`` in place, every state tensor left in the
        storage it started in; returns the round's metrics."""
        old = tree_leaves(state)
        _, met = engine.round_core(self.eng, self.grad_fn, self.la_fn, state,
                                   self._batch(inputs), self._round_shard())
        programs.settle(state, old)
        return met

    def barrier(self) -> None:
        """Wait for the other ranks (none here)."""

    def _round_shard(self):
        return None

    def run_rounds(self, state: dict, t: int, n: int):
        """Rounds ``t .. t+n-1`` on ``state`` (in place), each through the
        round program; returns (state, per-round metrics), each round's
        metrics tensors of its own (a replay overwrites the program's)."""
        mets = []
        for r in range(t, t + n):
            met = self.chunk(state, self._round_inputs(r))
            mets.append(tree_map(torch.clone, met))
        return state, mets

    def _eval_program(self) -> programs.Program:
        return eval_program(self.model, self.device)

    def _eval_args(self, state) -> tuple:
        """The eval program's inputs: the params and the test split."""
        d = self.device_data()
        return state["params"], d["test_x"], d["test_y"]

    def evaluate(self, state):
        """(loss, acc) of the params on the test split, through the eval
        program (tensors of their own: a replay overwrites the
        program's)."""
        out = self._eval_program()(*self._eval_args(state))
        return tuple(t.clone() for t in out)

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
                                            num_clients=self._h_rows)
        if compact_existing:
            for k in ("server_m", "global_m"):
                if k in state:
                    new_state[k] = shrink_params_for(self.model, state[k],
                                                     kept)
        new_state["round"] = state["round"]
        return new_state, {"params_before": params}


class MeshBackend(LocalBackend):
    """The same rounds with the FL clients split over the ranks of a device
    mesh (``launch.mesh``; a world of one by default), the counterpart of
    the reference's ``MeshBackend``.

    * Each round's C clients split over the mesh's client axes (``data``, x
      ``pod``) by position in the round batch, as
      ``sharding.fl_specs.fl_sim_batch_specs`` places them: rank r trains
      its block of C / ranks clients, and ``round_core`` sums the FedAvg
      partial sums (and communicated momentum, FedDyn's drift and rows of
      ``h``, the guard's totals) over the ranks before it divides them
      (:class:`~repro_torch.core.engine.RoundShard`).  A C that does not
      divide runs replicated: every rank trains every client.
    * Each server step's rows split the same way: the step's gradient is
      a partial gradient over the rank's rows, weighted by their share and
      summed over the ranks, and so is the first step's gate accuracy.
      That is the gradient of the batch mean for a loss that is a mean over
      the rows (the CNNs' and the LM's).  The moe family's auxiliary loss
      is not, so a model with ``moe`` set takes whole server batches on
      every rank.  ``shard_server`` (the reference's switch) overrides that
      choice; by default it follows the model, and True is refused for
      moe.
    * The data and FedDyn's ``h`` are rank-local, as the reference places
      them: where the client count N divides the client ranks, each rank
      stores only its block of clients (``FederatedData.device_arrays(
      mesh=)``, ``fl_specs.client_rows``), and FedDyn's per-client ``h``
      holds the same block (``fl_state_specs``).  The round program fetches
      its clients' samples, sizes, label distributions and rows of ``h``
      from their owners (masked sums over the ranks: a reduce-scatter for
      the samples and rows a rank trains on, an all-reduce for the [C]
      vectors every rank needs), and sends the new rows of ``h`` back to
      them.  Where N does not divide (or at a world of one) every rank
      holds everything and none of that runs.  Every rank draws the same
      round indices from a generator seeded alike.  :meth:`whole_state`
      gathers ``h`` whole for a checkpoint and ``RunResult.state``.
    * Evaluation: with ``shard_eval`` (the default) the test split's rows
      split over the ranks, padded with row-0 copies to a multiple of them
      at placement; the padded rows' contribution is subtracted back out
      exactly, ``mean = (mean_pad n_pad - k f(row 0)) / n``, one
      all-reduce inside the eval program.  ``shard_eval=False`` runs
      :func:`eval_program` on the whole test split on every rank.
    * ``Prune`` events: the decision is ``fedap.fedap_decision_sharded``
      (participants split, rates all-gathered, the same decision on every
      rank); a mask goes in through ``launch.steps.with_masks`` (every
      state tensor keeps its storage and shape); a shrink runs on each
      rank as on one device, ``h`` restarting rank-local at the shrunk
      shapes.
    * Rank 0 writes the plan's checkpoints; every rank reads them back.
    * The round program (:attr:`chunk`) and the sharded eval program are
      the local backend's kind, with their collectives inside: on a CUDA
      mesh a key's first call runs eagerly (the NCCL communicator exists
      from the process group's start), the second is captured on
      ``programs.capture_stream`` and later calls replay, each collective
      a node of the graph.  gloo (the CPU) never captures and counts keys.
      :meth:`_reduce` packs each call's tensors into one flat buffer per
      dtype, kept across rounds, runs one ``dist.all_reduce`` on it and
      unpacks it in place; :meth:`_scatter` packs them the same way for
      one reduce-scatter per dtype.

    Other mesh dims than the client axes must have size 1.  At a world of
    one every sum over the ranks is a copy, and the run is bitwise the
    local backend's.  ``reductions`` counts the all-reduces and
    ``scatters`` the reduce-scatters, a replay adding those its capture
    recorded; ``reduce_seconds`` is the host time of the eager all-reduce
    calls only (a replay runs no Python).  ``data_cache`` holds the placed
    dataset under ``("mesh", mesh, shard_eval)``.
    """

    name = "mesh"

    def __init__(self, model, data, cfg, *, use_masks: bool = False,
                 device, generator: torch.Generator | None = None,
                 batches: Callable | None = None, mesh=None,
                 data_cache: dict | None = None,
                 shard_server: bool | None = None, shard_eval: bool = True):
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.sharding import fl_specs
        from repro_torch.sharding.specs import MeshPlan, axis_sizes

        self.reductions = 0         # the programs count these
        self.scatters = 0
        self.reduce_seconds = 0.0
        super().__init__(model, data, cfg, use_masks=use_masks,
                         device=device, generator=generator,
                         batches=batches, data_cache=data_cache)
        self.mesh = (mesh if mesh is not None
                     else make_host_mesh(device=self.device))
        if self.mesh.device_type != self.device.type:
            raise ValueError(f"the mesh is a {self.mesh.device_type} mesh, "
                             f"the backend runs on {self.device}")
        axes = axis_sizes(self.mesh)
        if "data" not in axes:
            raise ValueError(
                f"MeshBackend needs a 'data' mesh axis to host FL clients; "
                f"got axes {tuple(axes)}")
        client_axes = ("pod", "data") if "pod" in axes else ("data",)
        wide = {k: n for k, n in axes.items()
                if k not in client_axes and n != 1}
        if wide:
            raise ValueError(f"MeshBackend splits clients only: mesh dims "
                             f"{wide} beyond the client axes {client_axes} "
                             f"must have size 1")
        moe = bool(getattr(model, "moe", False))
        if shard_server is None:
            shard_server = not moe
        if shard_server and moe:
            raise ValueError(
                "shard_server=True takes a server loss that is a mean over "
                "the batch's rows; the moe family's auxiliary loss is not")
        self.shard_eval = bool(shard_eval)
        self.plan = MeshPlan(
            mesh=self.mesh, multi_pod="pod" in axes, client_axes=client_axes,
            fsdp_axes=(), tp_axes=(("model",) if "model" in axes else ()),
            batch_axes=(), num_clients=1)
        self.rank, self.world = fl_specs.client_rank(self.mesh, client_axes)
        specs = fl_specs.fl_sim_batch_specs(
            cfg.clients_per_round, self.plan,
            server_batch=cfg.server_batch_size if shard_server else None,
            with_active=bool(self.sample_kw["dropout_rate"]))
        r, w = self.rank, self.world
        clients = server_rows = None
        weight = 1.0
        if specs["sizes"].parts:          # the clients split over the ranks
            per = cfg.clients_per_round // w
            clients = range(r * per, (r + 1) * per)
        if specs["server"][0].parts:      # each server step's rows too
            per = cfg.server_batch_size // w
            server_rows = slice(r * per, (r + 1) * per)
            weight = per / cfg.server_batch_size
        # this rank's block of the clients' rows (data and FedDyn's h)
        self._owned = fl_specs.client_rows(self.plan, client_axes,
                                           self._num_clients)
        self._shard = engine.RoundShard(
            reduce=self._reduce, clients=clients, server_rows=server_rows,
            server_weight=weight, owned=self._owned,
            num_clients=self._num_clients, scatter=self._scatter)
        self._buckets: dict = {}    # (dtype, sizes) -> flat buffer
        self._eval = None

    def _program_kw(self) -> dict:
        return {"counters": ((self, "reductions"), (self, "scatters")),
                "capture_error_mode": "thread_local"}

    @property
    def _h_rows(self) -> int:
        return (self._num_clients if self._owned is None
                else len(self._owned))

    @property
    def is_writer(self) -> bool:
        return self.rank == 0

    def barrier(self) -> None:
        dist.barrier()

    def _data_key(self):
        return ("mesh", self.mesh, self.shard_eval)

    def _place_data(self) -> dict:
        return self.data.device_arrays(
            self.device, mesh=self.mesh, client_axes=self.plan.client_axes,
            shard_test=self.shard_eval)

    def _reduce(self, tensors) -> None:
        """Each tensor summed over the ranks, in place: per dtype, the
        tensors packed into one flat buffer (kept per dtype and sizes, so a
        captured round addresses the same one every replay), one
        ``dist.all_reduce`` on it, and each tensor copied back out."""
        from repro_torch.sharding.tp import TPGroup, packed_all_reduce

        t0 = time.perf_counter()
        self.reductions += packed_all_reduce(
            tensors, TPGroup(None, self.rank, self.world), self._buckets)
        if not (self.device.type == "cuda"
                and torch.cuda.is_current_stream_capturing()):
            self.reduce_seconds += time.perf_counter() - t0

    def _scatter(self, tensors) -> list:
        """Each ``[C, ...]`` tensor summed over the ranks, of which this
        rank gets its block of rows (``RoundShard.clients``, C / ranks
        rows), as new tensors: per dtype, the tensors' rows packed rank
        block by rank block into one buffer, one reduce-scatter on it, and
        each block cut back out."""
        w = self.world
        groups: dict = {}
        for i, t in enumerate(tensors):
            groups.setdefault(t.dtype, []).append(i)
        out = [None] * len(tensors)
        for dtype, ids in groups.items():
            ts = [tensors[i] for i in ids]
            flat = torch.cat([t.reshape(w, -1) for t in ts], 1)
            mine = torch.empty(flat.shape[1], dtype=dtype, device=flat.device)
            reduce_scatter(mine, flat.reshape(-1))
            parts = mine.split([t.numel() // w for t in ts])
            for i, t, part in zip(ids, ts, parts):
                out[i] = part.view((t.shape[0] // w,) + tuple(t.shape[1:]))
        self.scatters += len(groups)
        return out

    def _round_shard(self):
        return self._shard

    def restore_state(self, state: dict) -> dict:
        """A checkpointed round state (whole ``h``) back on the device, with
        this rank's rows of FedDyn's per-client ``h``."""
        own = self._owned
        if own is not None and "client_state" in state:
            per = state["client_state"]["per_client"]
            state = dict(state, client_state=dict(
                state["client_state"], per_client=tree_map(
                    lambda a: a[own.start:own.stop], per)))
        return super().restore_state(state)

    def whole_state(self, state: dict) -> dict:
        """The round state with FedDyn's per-client ``h`` gathered whole from
        the ranks (a collective: every rank calls it); ``state`` itself
        where every rank holds every row."""
        if self._owned is None or "client_state" not in state:
            return state
        cs = state["client_state"]

        def gather(x):
            whole = torch.empty((self._num_clients,) + tuple(x.shape[1:]),
                                dtype=x.dtype, device=x.device)
            all_gather(whole, x.contiguous())
            return whole

        return dict(state, client_state=dict(
            cs, per_client=tree_map(gather, cs["per_client"])))

    def _eval_program(self) -> programs.Program:
        """``shard_eval=False``: :func:`eval_program` on the whole split;
        else the sharded program (:meth:`_sharded_eval_body`), captured on
        the card as the round is, its all-reduce inside."""
        if not self.shard_eval:
            return eval_program(self.model, self.device)
        if self._eval is None:
            self._eval = programs.Program(self._sharded_eval_body,
                                          name="eval", device=self.device,
                                          **self._program_kw())
        return self._eval

    def _sharded_eval_body(self, params, x, y, x0, y0):
        """(loss, acc) of the whole test split from this rank's block ``x,
        y`` of the split padded to ``n_pad`` rows with row-0 copies (``x0,
        y0``): the block's means weighted by its share and summed over the
        ranks, then the padded rows' contribution subtracted exactly."""
        n = int(self.data.test_x.shape[0])
        n_pad = x.shape[0] * self.world
        with torch.no_grad():
            loss, acc = self.model.loss_and_acc(params, x, y)
            wt = x.shape[0] / n_pad
            sums = torch.stack([loss.float() * wt, acc.float() * wt])
            self._reduce([sums])
            loss, acc = sums.unbind(0)
            if n_pad != n:
                k = float(n_pad - n)
                l0, a0 = self.model.loss_and_acc(params, x0, y0)
                loss = (loss * n_pad - k * l0) / n
                acc = (acc * n_pad - k * a0) / n
        return loss, acc

    def _eval_args(self, state) -> tuple:
        """The params and this rank's block of the test split, with row 0
        beside it where the split is sharded."""
        args = super()._eval_args(state)
        if not self.shard_eval:
            return args
        d = self.device_data()
        return args + (d["test_x0"], d["test_y0"])

    def prune_decision(self, state, init_params):
        from repro_torch.core import fedap

        return fedap.fedap_decision_sharded(
            self.model, self.data, self.cfg.fedap, state["params"],
            init_params=init_params,
            rng=np.random.default_rng(self.cfg.seed),
            mesh=self.mesh, client_axes=self.plan.client_axes)

    def apply_prune(self, state: dict, mode: str, kept, *,
                    compact_existing: bool = False):
        """mask: ``launch.steps.with_masks`` into the live state; shrink:
        as on one device, on every rank (``h`` rank-local at the shrunk
        shapes).  The shrink stays eager: a captured program's outputs
        live in its pool, so a second apply of the same decision would
        overwrite the state the first one returned (ROADMAP G5)."""
        if mode != "mask":
            return super().apply_prune(state, mode, kept,
                                       compact_existing=compact_existing)
        from repro_torch.launch.steps import with_masks

        params = state["params"]
        masks = param_masks_for(self.model, params, kept)
        fmasks = filter_masks_for(self.model, params, kept)
        state = with_masks(state, masks,
                           filter_masks=fmasks if self._kernel_masks else None)
        return state, {"filter_masks": fmasks}


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
            # every rank gathers the per-client rows it holds; one writer
            # (rank 0 of a mesh) saves them, the others wait for the file
            whole = backend.whole_state(state)
            if not backend.is_writer:
                backend.barrier()
                return
            ckpt.save_checkpoint(ckpt_dir, {
                "state": whole,
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
            backend.barrier()

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
                         artifacts=artifacts,
                         state=backend.whole_state(state))

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
