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

Where the reference compiles two programs (admit, wave), the port runs
eagerly; capturing the wave as a CUDA graph is later work.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import device as _device


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
    """

    def __init__(self, model, params, cfg: ServeConfig | None = None, *,
                 masks=None, device="cuda", faults: tuple = ()):
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
        self._state = self._init_state()
        self._occupants: list[Optional[tuple[int, np.ndarray]]] = \
            [None] * self.cfg.slots
        self._queue: collections.deque = collections.deque()
        self._next_uid = 0
        self.rejected = 0   # requests dropped by on_full="reject"
        self.steps = 0      # decode steps run (each one model.decode_step)

    # -- state (every state tensor is made and updated in inference mode) --
    @torch.inference_mode()
    def _init_state(self) -> dict:
        c, dev = self.cfg, self.device

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        cache = self.model.init_cache(c.slots, c.cache_len)
        cache["index"] = zeros(c.slots)
        return {
            "cache": cache,
            "active": zeros(c.slots, dtype=torch.bool),
            "last_tok": zeros(c.slots),
            "prompt": zeros(c.slots, c.max_prompt),
            "prompt_len": torch.ones((c.slots,), dtype=torch.int32,
                                     device=dev),
            "n_out": zeros(c.slots),
            "out": zeros(c.slots, c.max_new_tokens),
            "error": zeros(c.slots, dtype=torch.bool),
        }

    @torch.inference_mode()
    def _admit(self, slots: list, prompts: np.ndarray, plens: np.ndarray):
        """Write queued requests into freed slots: one host-to-device copy
        of the padded prompts.  A slot's cache page is not cleared — index 0
        regrows the valid prefix, so the previous occupant's rows are only
        attended after being overwritten."""
        st = self._state
        dev = self.device
        rows = torch.as_tensor(slots, dtype=torch.int64).to(dev)
        prm = torch.from_numpy(prompts).to(dev)
        st["cache"]["index"][rows] = 0
        st["active"][rows] = True
        st["prompt"][rows] = prm
        st["prompt_len"][rows] = torch.from_numpy(plens).to(dev)
        st["last_tok"][rows] = prm[:, 0]
        st["n_out"][rows] = 0
        st["error"][rows] = False

    def _step(self, state: dict) -> dict:
        """One lockstep decode step for every slot (done slots frozen).
        Reads nothing back to the host."""
        c = self.cfg
        cache = state["cache"]
        idx = cache["index"]                         # [B] pre-step fill
        active = state["active"]
        logits, cache = self.model.decode_step(
            self._params, cache, {"tokens": state["last_tok"][:, None]},
            masks=self._masks)
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
        self.steps += 1
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

    @torch.inference_mode()
    def _wave(self) -> None:
        """``steps_per_wave`` decode steps, with no host sync."""
        for _ in range(self.cfg.steps_per_wave):
            self._state = self._step(self._state)

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
        # slots, their token counts and output rows)
        active = self._state["active"].cpu().numpy()
        done = [slot for slot, occ in enumerate(self._occupants)
                if occ is not None and not active[slot]]
        if not done:
            return []
        n_out = self._state["n_out"].cpu().numpy()
        out = self._state["out"].cpu().numpy()
        error = self._state["error"].cpu().numpy()
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
