"""Continuous-batching decode engine over the flash-decode kernel.

Counterpart of the reference's ``serving/engine.py``: a trained (optionally
FedAP-pruned) checkpoint is served from a fixed pool of decode slots.

* **Slot pool.**  ``ServeConfig.slots`` decode slots are the batch axis of
  one model cache; each slot owns a KV page and a fill level
  (``cache["index"]`` is an int32 ``[slots]`` tensor).  Attention over a page
  is limited to its own valid prefix (the ``decode_attention`` kernel's
  ``lengths``), so stale rows of a page's previous occupant never leak.
* **Lockstep waves.**  A wave is ``steps_per_wave`` decode steps.  Prompts
  prefill through the same step, one token per step; the step input then
  switches from the prompt buffer to the previous argmax, on the device.
* **On-device done-mask.**  A slot that reaches ``max_new_tokens`` (or
  ``eos_id``) clears its ``active`` bit and freezes.  Nothing inside a step
  reads a tensor to the host: the host reads ``active`` once per wave, then
  retires finished requests and admits queued ones into the freed slots.
* **Health guard.**  A slot whose logits go non-finite is retired on the
  device (``error`` bit) and completes with ``status="error"``;
  ``max_queue``/``on_full`` bound the host admission queue.  Serving
  faults (``faults=``, e.g. ``reliability.NaNLogits``) poison a slot's
  logits on the device just before that guard, for tests.

* **Mesh serving** (optional): ``mesh=`` (a ``launch.mesh`` ``DeviceMesh``)
  splits the slot pool over the mesh axis ``mesh_axis``.  Each rank owns
  ``slots / n`` slots (the rows of every state tensor and KV page at its
  coordinate on that axis, the split ``sharding.specs.cache_specs`` and
  ``sharding.fl_specs.serve_batch_specs`` give) and decodes only those;
  params and masks are replicated.  The host protocol is SPMD: every rank
  calls ``submit``/``step_wave``/``run`` with the same arguments, so the
  queue, the uids and the admission order agree.  The wave program ends
  with one all-gather over the axis: every slot's ``active`` bit, count,
  error bit and tokens, as one int32 row a slot (NCCL has no bool), into
  a buffer kept across waves, so every rank returns the same completions
  from the same one host read a wave.

* **Two programs.**  As the reference compiles exactly two programs, the
  engine keeps two ``core.programs.Program`` objects, and on
  the card each is a CUDA graph: ``admit`` (one fixed-shape write of an
  ``[slots]`` admit mask, ``[slots, max_prompt]`` prompts and ``[slots]``
  lengths, which the host fills in one pinned buffer and copies in once)
  and ``wave`` (``steps_per_wave`` steps, every state tensor left in the
  storage it started in).  Each runs eagerly the first time, is captured
  the second and replayed from then on, for every later admission and
  wave (:meth:`DecodeEngine.program_counts`);
  :meth:`DecodeEngine.lower_wave` gives the wave program and one wave's
  recorded operations without running it on the engine's state.  On the
  CPU both run eagerly and count their keys.  On a mesh the wave's
  all-gather is a node of its graph.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import programs
from repro_torch.launch.mesh import all_gather
from repro_torch.sharding import fl_specs, specs
from repro_torch.utils.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine shape knobs.

    slots           decode-slot pool == batch of the decode step
    cache_len       per-slot KV page length (max prompt+generated context)
    max_prompt      admission pads prompts to this many tokens
    max_new_tokens  per-request generation budget
    eos_id          stop token (-1: never stop early)
    steps_per_wave  decode steps between host syncs
    max_queue       bound on the host admission queue (None: unbounded)
    on_full         what ``submit`` does at the bound: "raise" a
                    :class:`QueueFull`, or "reject" (drop the request,
                    count it in ``DecodeEngine.rejected``, return None)
    """

    slots: int = 8
    cache_len: int = 64
    max_prompt: int = 16
    max_new_tokens: int = 16
    eos_id: int = -1
    steps_per_wave: int = 8
    max_queue: Optional[int] = None
    on_full: str = "raise"

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {self.slots}")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(
                f"max_queue must be None or >= 1, got {self.max_queue}")
        if self.on_full not in ("raise", "reject"):
            raise ValueError(
                f"on_full must be 'raise' or 'reject', got {self.on_full!r}")
        if not 1 <= self.max_prompt <= self.cache_len:
            raise ValueError(
                f"max_prompt must be in [1, cache_len={self.cache_len}], "
                f"got {self.max_prompt}")
        if self.max_prompt + self.max_new_tokens - 1 > self.cache_len:
            raise ValueError(
                f"cache_len={self.cache_len} cannot hold max_prompt="
                f"{self.max_prompt} + max_new_tokens={self.max_new_tokens} "
                f"- 1 context tokens")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        if self.steps_per_wave < 1:
            raise ValueError(
                f"steps_per_wave must be >= 1, got {self.steps_per_wave}")


class QueueFull(RuntimeError):
    """``submit`` hit ``ServeConfig.max_queue`` with ``on_full="raise"``."""


@dataclasses.dataclass(frozen=True)
class Completion:
    """One finished request: ``tokens`` are the generated ids (prompt
    excluded), in generation order.  ``status`` is ``"ok"``, or ``"error"``
    when the health guard retired the slot (non-finite logits); an error
    completion carries the tokens generated before the fault."""

    uid: int
    prompt: np.ndarray
    tokens: np.ndarray
    status: str = "ok"


# Families whose decode cache is the stacked [L, B, S, KV, hd] KV pages (a
# vlm wave feeds tokens, as the reference's engine does).
_SERVABLE_FAMILIES = ("dense", "moe", "vlm")


class DecodeEngine:
    """Continuous-batching argmax decoding over ``model.decode_step``.

    ``masks`` (optional) is the FedAP filter keep-mask tree
    (``{"mlp": [L, d_ff]}``): every step then routes the FFN up/gate
    products through the block-skipping ``masked_matmul`` kernel.  A moe
    model's routing couples the slots of a step (each expert takes its
    top-C of the batch's tokens), so idle and frozen slots take part in it
    with what they hold, exactly as in the reference's engine.  The
    model, params and masks must live on ``device`` (default ``"cuda"``).
    ``faults`` keeps the serving faults of a fault tuple (objects with an
    ``apply_logits`` hook) and ignores the others.

    ``mesh`` (optional) splits the slots over ``mesh_axis`` (see the module
    docstring); ``slots`` must divide over that axis.  Ranks on the mesh's
    other axes hold the same slots.  A moe model's slots do not split: its
    routing couples them (each expert's top-C is taken over all slots, as
    the reference's GSPMD program computes it), so every rank serves every
    slot and no collective runs.
    """

    def __init__(self, model, params, cfg: ServeConfig | None = None, *,
                 masks=None, mesh=None, mesh_axis: str = "data",
                 device="cuda", faults: tuple = ()):
        if model.cfg.family not in _SERVABLE_FAMILIES:
            raise ValueError(
                f"DecodeEngine serves the scanned-KV families "
                f"{_SERVABLE_FAMILIES}, not {model.cfg.family!r} (ssm/"
                f"hybrid/encdec decode state has no per-slot cache index; "
                f"serve it with repro_torch.serving.lockstep_decode)")
        self.device = _device.resolve(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}")
        self.model = model
        self.cfg = cfg or ServeConfig()
        self._params = params
        self._masks = masks
        self._faults = tuple(f for f in faults if hasattr(f, "apply_logits"))
        # the slots this rank owns: [lo, lo + n); the axis group gathers the
        # wave's results (None: every slot is this rank's, nothing gathered)
        self._lo, self._n, self._group = 0, self.cfg.slots, None
        if mesh is not None:
            self._split(mesh, mesh_axis)
        self._state = self._init_state()
        # the admit program's input: per slot of this rank [admit, length,
        # prompt...], filled on the host (pinned on the card) after the
        # wave's host read and copied in once
        width = 2 + self.cfg.max_prompt
        self._adm = torch.zeros((self._n, width), dtype=torch.int32,
                                device=self.device)
        self._adm_host = torch.zeros(
            (self._n, width), dtype=torch.int32,
            pin_memory=self.device.type == "cuda")
        self._admit_program = programs.Program(
            self._admit_body, name="admit", device=self.device)
        # on a split mesh the wave ends with the all-gather of every slot's
        # [active, n_out, error, out...] row into buffers kept across waves
        wave_kw = {}
        if self._group is not None:
            width = 3 + self.cfg.max_new_tokens
            self._rows = torch.zeros((self._n, width), dtype=torch.int32,
                                     device=self.device)
            self._gathered = torch.zeros((self.cfg.slots, width),
                                         dtype=torch.int32,
                                         device=self.device)
            # NCCL's watchdog thread queries events during a capture
            wave_kw["capture_error_mode"] = "thread_local"
        self._wave_program = programs.Program(
            self._wave_body, name="wave", device=self.device, **wave_kw)
        self._occupants: list[Optional[tuple[int, np.ndarray]]] = \
            [None] * self.cfg.slots
        self._queue: collections.deque = collections.deque()
        self._next_uid = 0
        self.rejected = 0   # requests dropped by on_full="reject"
        self.steps = 0      # decode steps run (each one model.decode_step)

    # -- mesh ----------------------------------------------------------------
    def _split(self, mesh, axis: str) -> None:
        """This rank's slots from the mesh's placement trees: the pages'
        ``cache_specs`` and the slot state's ``serve_batch_specs`` must
        shard the slot dim (dim 1 of ``[L, slots, S, KV, hd]``, dim 0 of
        the rest) over ``axis``; the rank's coordinate there picks its
        block."""
        sizes = specs.axis_sizes(mesh)
        if axis not in sizes:
            raise ValueError(f"mesh has no axis {axis!r}: {tuple(sizes)}")
        n = sizes[axis]
        if self.cfg.slots % n:
            raise ValueError(f"slots={self.cfg.slots} must divide over the "
                             f"{n}-way mesh axis {axis!r}")
        if self.model.moe:      # routing couples the slots: keep them whole
            return
        plan = specs.make_plan(mesh, self.model.cfg)
        shapes = self._make_state(self.model.on_meta(), self.cfg.slots)
        cache = shapes.pop("cache")
        placed = [(leaf, spec, 1 if leaf.ndim == 5 else 0) for leaf, spec in
                  zip(tree_leaves(cache),
                      tree_leaves(specs.cache_specs(cache, plan,
                                                self.model.cfg)))]
        placed += [(shapes[k], spec, 0) for k, spec in
                   fl_specs.serve_batch_specs(shapes, plan).items()]
        for leaf, spec, dim in placed:
            on = [d for d, p in enumerate(spec.parts)
                  if p == axis or (isinstance(p, tuple) and axis in p)]
            if on != [dim]:
                raise ValueError(
                    f"the placement of a {tuple(leaf.shape)} state tensor "
                    f"shards dims {on} over {axis!r}, not its slot dim "
                    f"{dim} ({spec.parts})")
        self._n = self.cfg.slots // n
        self._lo = mesh.get_local_rank(axis) * self._n
        self._group = mesh.get_group(axis)

    def _gather(self, state: dict) -> None:
        """Every slot's ``[active, n_out, error, out...]`` row, gathered
        from the ranks that own them over the axis group into
        ``_gathered`` (slot order), through ``_rows``."""
        torch.cat([state["active"][:, None].to(torch.int32),
                   state["n_out"][:, None],
                   state["error"][:, None].to(torch.int32), state["out"]],
                  1, out=self._rows)
        all_gather(self._gathered, self._rows, group=self._group)

    # -- state (every state tensor is made and updated in inference mode) --
    def _make_state(self, model, slots: int) -> dict:
        c, dev = self.cfg, model.device

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        cache = model.init_cache(slots, c.cache_len)
        cache["index"] = zeros(slots)
        return {
            "cache": cache,
            "active": zeros(slots, dtype=torch.bool),
            "last_tok": zeros(slots),
            "prompt": zeros(slots, c.max_prompt),
            "prompt_len": torch.ones((slots,), dtype=torch.int32,
                                     device=dev),
            "n_out": zeros(slots),
            "out": zeros(slots, c.max_new_tokens),
            "error": zeros(slots, dtype=torch.bool),
        }

    @torch.inference_mode()
    def _init_state(self) -> dict:
        """The state of this rank's slots (all of them without a mesh)."""
        return self._make_state(self.model, self._n)

    def _admit(self, slots: list, prompts: np.ndarray, plens: np.ndarray):
        """Write queued requests into freed slots through the admit program:
        the host fills the admit buffer for this rank's slots (the others'
        rows stay 0: not admitted) and copies it to the device once."""
        host = self._adm_host.numpy()
        host[:] = 0
        for slot, prompt, plen in zip(slots, prompts, plens):
            if self._lo <= slot < self._lo + self._n:
                host[slot - self._lo] = (1, plen, *prompt)
        self._adm.copy_(self._adm_host, non_blocking=True)
        self._admit_program(self._state, self._adm)

    @torch.inference_mode()
    def _admit_body(self, state: dict, adm: torch.Tensor) -> None:
        """The admit program: every slot whose admit flag is set restarts
        with its prompt, in place.  A slot's cache page is not cleared —
        index 0 regrows the valid prefix, so the previous occupant's rows
        are only attended after being overwritten."""
        on = adm[:, 0] > 0
        prompt = adm[:, 2:]
        state["cache"]["index"].masked_fill_(on, 0)
        state["active"].logical_or_(on)
        torch.where(on[:, None], prompt, state["prompt"], out=state["prompt"])
        torch.where(on, adm[:, 1], state["prompt_len"],
                    out=state["prompt_len"])
        torch.where(on, prompt[:, 0], state["last_tok"],
                    out=state["last_tok"])
        state["n_out"].masked_fill_(on, 0)
        state["error"].masked_fill_(on, False)

    def _step(self, state: dict, params, masks) -> dict:
        """One lockstep decode step for every slot (done slots frozen).
        Reads nothing back to the host."""
        c = self.cfg
        cache = state["cache"]
        idx = cache["index"]                         # [B] pre-step fill
        active = state["active"]
        logits, cache = self.model.decode_step(
            params, cache, {"tokens": state["last_tok"][:, None]},
            masks=masks)
        for f in self._faults:
            logits = f.apply_logits(logits, state)
        logits = logits[:, 0]
        # health guard: a slot with non-finite logits is retired (error
        # bit, frozen) instead of emitting garbage tokens
        ok = torch.isfinite(logits).all(-1)
        bad = active & ~ok
        live = active & ok
        # frozen (and newly errored) slots keep their fill level: their page
        # write landed on a slot that stays invalid
        cache["index"] = torch.where(live, cache["index"], idx)
        sampled = torch.argmax(logits, -1).to(torch.int32)

        consumed = idx + 1                           # tokens seen after step
        in_prefill = consumed < state["prompt_len"]  # next input from prompt
        nxt_prompt = torch.gather(
            state["prompt"], 1,
            torch.clamp(consumed, max=c.max_prompt - 1).long()[:, None])[:, 0]
        emitted = live & (consumed >= state["prompt_len"])
        pos = torch.clamp(state["n_out"], 0, c.max_new_tokens - 1).long()
        out = state["out"]
        prev = torch.gather(out, 1, pos[:, None])
        out.scatter_(1, pos[:, None],
                     torch.where(emitted[:, None], sampled[:, None], prev))
        n_out = state["n_out"] + emitted.to(torch.int32)
        finished = emitted & ((n_out >= c.max_new_tokens) |
                              (sampled == c.eos_id))
        last_tok = torch.where(
            live, torch.where(in_prefill, nxt_prompt, sampled),
            state["last_tok"])
        return {
            "cache": cache,
            "active": active & ~finished & ~bad,
            "last_tok": last_tok,
            "prompt": state["prompt"],
            "prompt_len": state["prompt_len"],
            "n_out": n_out,
            "out": out,
            "error": state["error"] | bad,
        }

    def _wave(self) -> None:
        """One wave through the wave program (a graph replay on the card
        once captured), with no host sync."""
        self._wave_program(self._state, self._params, self._masks)
        self.steps += self.cfg.steps_per_wave

    @torch.inference_mode()
    def _wave_body(self, state: dict, params, masks) -> None:
        """The wave program: ``steps_per_wave`` decode steps, each state
        tensor then copied back into the storage it started in where a step
        replaced it (the fill levels, the counts, the flags)."""
        old = tree_leaves(state)
        for _ in range(self.cfg.steps_per_wave):
            state = self._step(state, params, masks)
        programs.settle(state, old)
        if self._group is not None:
            self._gather(state)

    # -- host protocol ----------------------------------------------------
    def submit(self, prompt) -> Optional[int]:
        """Queue a request; returns its uid (completion order may differ
        from submission order).  At a full ``max_queue`` either raises
        :class:`QueueFull` (``on_full="raise"``) or drops the request and
        returns None (``on_full="reject"``, counted in ``rejected``)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if not 1 <= prompt.shape[0] <= self.cfg.max_prompt:
            raise ValueError(
                f"prompt length {prompt.shape[0]} outside [1, "
                f"max_prompt={self.cfg.max_prompt}]")
        if (self.cfg.max_queue is not None
                and len(self._queue) >= self.cfg.max_queue):
            if self.cfg.on_full == "raise":
                raise QueueFull(
                    f"admission queue at max_queue={self.cfg.max_queue} "
                    f"(drain with step_wave/run, or use on_full='reject')")
            self.rejected += 1
            return None
        uid = self._next_uid
        self._next_uid += 1
        self._queue.append((uid, prompt))
        return uid

    @property
    def pending(self) -> int:
        """Queued + in-flight request count."""
        return len(self._queue) + sum(o is not None for o in self._occupants)

    def step_wave(self) -> list[Completion]:
        """Admit into free slots, run one wave, retire finished requests.
        The building block of :meth:`run`, for callers that interleave
        submission with decoding."""
        slots, prompts, plens = [], [], []
        for slot in range(self.cfg.slots):
            if self._occupants[slot] is None and self._queue:
                uid, prompt = self._queue.popleft()
                padded = np.zeros((self.cfg.max_prompt,), np.int32)
                padded[:prompt.shape[0]] = prompt
                slots.append(slot)
                prompts.append(padded)
                plens.append(prompt.shape[0])
                self._occupants[slot] = (uid, prompt)
        if slots:
            self._admit(slots, np.stack(prompts),
                        np.asarray(plens, np.int32))
        self._wave()
        # the wave's only host sync: the done-mask (then, for finished
        # slots, their token counts and output rows); on a split mesh every
        # slot's, which the wave gathered from the ranks that own them
        st = self._state
        if self._group is None:
            active = st["active"].cpu().numpy()
        else:
            active = self._gathered[:, 0].cpu().numpy()
        done = [slot for slot, occ in enumerate(self._occupants)
                if occ is not None and not active[slot]]
        if not done:
            return []
        if self._group is None:
            n_out = st["n_out"].cpu().numpy()
            out = st["out"].cpu().numpy()
            error = st["error"].cpu().numpy()
        else:
            rows = self._gathered[:, 1:].cpu().numpy()
            n_out, error, out = rows[:, 0], rows[:, 1], rows[:, 2:]
        completions = []
        for slot in done:
            uid, prompt = self._occupants[slot]
            completions.append(
                Completion(uid, prompt, out[slot, :n_out[slot]].copy(),
                           status="error" if error[slot] else "ok"))
            self._occupants[slot] = None
        return completions

    def run(self, prompts=None) -> list[Completion]:
        """Serve until the queue and every slot drain; returns completions
        sorted by uid.  ``prompts`` (optional) are submitted first."""
        for p in (prompts or []):
            self.submit(p)
        done: list[Completion] = []
        while self.pending:
            done.extend(self.step_wave())
        return sorted(done, key=lambda comp: comp.uid)

    # -- introspection -----------------------------------------------------
    def lower_wave(self) -> "LoweredWave":
        """The wave program for the current state, without running it on
        that state: ``ops`` is one wave's operation record
        (``launch.cost.CostCounter(record=True)``, which
        ``analysis.op_lint`` reads), taken over a copy of the state; on the
        card ``graph`` is the captured ``torch.cuda.CUDAGraph`` (made now if
        the engine has not run a wave on this state yet), None on the CPU.
        The engine's state, steps and completions do not change."""
        from repro_torch.launch.cost import CostCounter

        with torch.inference_mode():
            copy = tree_map(torch.clone, self._state)
        with CostCounter(record=True) as counter:
            self._wave_body(copy, self._params, self._masks)
        cap = self._wave_program.lower(
            self._state, self._params, self._masks,
            scratch=(copy, self._params, self._masks))
        return LoweredWave(ops=counter.ops, totals=counter.totals,
                           graph=None if cap is None else cap.graph)

    def program_counts(self) -> dict:
        """Programs of the session's two entry points: captures on the card,
        keys on the CPU; ``{"admit": 1, "wave": 1}`` however many requests
        are admitted and retired."""
        return {"admit": self._admit_program._cache_size(),
                "wave": self._wave_program._cache_size()}


@dataclasses.dataclass(frozen=True)
class LoweredWave:
    """:meth:`DecodeEngine.lower_wave`'s result: one wave's recorded
    operations (``(name, dtypes)`` in order) and counted work, and its
    CUDA graph on the card (None on the CPU)."""

    ops: list
    totals: object
    graph: object = None
