"""Deterministic fault injection: every recovery claim gets a repro.

Counterpart of the reference's ``reliability/faults.py``.  A
:class:`FaultPlan` is an ordered, hashable tuple of fault events for hooks
at three levels of the stack:

* **device faults** (:class:`NaNGrad`, :class:`CorruptUpdate`) rewrite a
  matching client's uploaded model inside ``round_core``.  The port's
  engine trains one client at a time, so a fault sees one client's tree:
  ``apply_client(local, params, sel_c, round_)`` with ``sel_c`` the
  client's global index and ``round_`` the round counter, both 0-d device
  tensors.  The hit test stays on the device (``torch.where``), so a fault
  adds no host sync to a round;
* **host faults** (:class:`KillAfterChunk`) fire in the
  :class:`~repro_torch.core.backend.PlanExecutor` schedule loop, raising
  :class:`SimulatedCrash` after the chunk's checkpoint write;
* **serving faults** (:class:`NaNLogits`) poison one decode slot's logits
  inside the wave, driving the engine's non-finite-logit slot retirement.

Faults are frozen dataclasses (hashable), so a device-fault tuple can ride
in the frozen :class:`~repro_torch.core.engine.EngineConfig`.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.utils.tree import tree_map


class SimulatedCrash(RuntimeError):
    """Raised by the executor when a :class:`KillAfterChunk` fault fires,
    after the chunk's checkpoint write (where a preemption between chunks
    would land), so ``FederatedTrainer.resume`` can continue the run."""


class FaultPlan(tuple):
    """An ordered, hashable collection of fault events:
    ``FaultPlan(NaNGrad(client=3, round=5), KillAfterChunk(2))``, passed
    (or a plain tuple) as ``FLConfig(faults=...)``; the trainer routes the
    device faults into the engine config and the host faults into the
    executor."""

    def __new__(cls, *faults):
        return super().__new__(cls, faults)

    @property
    def device(self) -> tuple:
        return device_faults(self)

    @property
    def host(self) -> tuple:
        return host_faults(self)


@dataclasses.dataclass(frozen=True)
class NaNGrad:
    """Client ``client``'s uploaded model becomes all-NaN at global round
    ``round`` (the client must be selected that round for the fault to
    land)."""

    client: int
    round: int

    def apply_client(self, local, params, sel, round_):
        """Rewrites ``local`` (the engine's own copy of one client's model)
        in place on a hit; returns it."""
        hit = (sel == self.client) & (round_ == float(self.round))
        return tree_map(lambda l: l.copy_(torch.where(hit, torch.nan, l)),
                        local)


@dataclasses.dataclass(frozen=True)
class CorruptUpdate:
    """Scale a client's update around the broadcast round-start model:
    ``theta_k <- theta_global + scale * (theta_k - theta_global)``, in f32.
    ``client=None`` / ``round=None`` match every client / every round.
    Large scales (1e6) model a diverged or byzantine upload that is still
    finite in f32; ``scale=nan`` makes every matched client non-finite."""

    scale: float = 1e6
    client: int | None = None
    round: int | None = None

    def _hit(self, sel, round_):
        hit = torch.ones((), dtype=torch.bool, device=round_.device)
        if self.client is not None:
            hit = hit & (sel == self.client)
        if self.round is not None:
            hit = hit & (round_ == float(self.round))
        return hit

    def apply_client(self, local, params, sel, round_):
        """Rewrites ``local`` in place on a hit; returns it."""
        hit = self._hit(sel, round_)

        def one(l, p):
            p32 = p.float()
            return l.copy_(torch.where(
                hit, p32 + self.scale * (l.float() - p32), l.float()))

        return tree_map(one, local, params)


@dataclasses.dataclass(frozen=True)
class KillAfterChunk:
    """Host fault: the executor raises :class:`SimulatedCrash` once
    ``chunks`` Scan chunks have completed, counted over the WHOLE run, so a
    resumed run that restored more completed chunks does not die again.
    The chunk's checkpoint (if configured) is written first."""

    chunks: int

    def __post_init__(self):
        if self.chunks < 1:
            raise ValueError(f"chunks must be >= 1, got {self.chunks}")


@dataclasses.dataclass(frozen=True)
class NaNLogits:
    """Serving fault: slot ``slot``'s logits become NaN on the decode step
    where its emitted-token count equals ``n_out`` (at most once per
    occupancy: the slot retires, and admission clears its error bit)."""

    slot: int
    n_out: int = 0

    def apply_logits(self, logits, state):
        """``logits`` [B, ...] with the hit slot's row NaN, on the device."""
        hit = ((torch.arange(logits.shape[0], device=logits.device)
                == self.slot)
               & (state["n_out"] == self.n_out) & state["active"])
        hit = hit.reshape((-1,) + (1,) * (logits.ndim - 1))
        return torch.where(hit, torch.nan, logits.float()).to(logits.dtype)


def device_faults(faults) -> tuple:
    """The subset of ``faults`` that runs inside ``round_core``."""
    return tuple(f for f in (faults or ()) if hasattr(f, "apply_client"))


def host_faults(faults) -> tuple:
    """The subset of ``faults`` the executor's schedule loop handles."""
    return tuple(f for f in (faults or ()) if hasattr(f, "chunks"))
