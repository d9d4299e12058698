"""Fault tolerance for the federated stack.

Three legs, as in the reference: the health guard in the round
(``EngineConfig.guard``), chunk-boundary checkpoints and resume
(:mod:`repro_torch.reliability.checkpoint`), and deterministic fault
injection (:mod:`repro_torch.reliability.faults`).
"""
from repro_torch.core.plan import CheckpointError
from repro_torch.reliability.checkpoint import (
    RUN_FORMAT,
    latest_checkpoint,
    load_checkpoint,
    plan_from_spec,
    plan_spec,
    save_checkpoint,
)
from repro_torch.reliability.faults import (
    CorruptUpdate,
    FaultPlan,
    KillAfterChunk,
    NaNGrad,
    NaNLogits,
    SimulatedCrash,
    device_faults,
    host_faults,
)

__all__ = [
    "CheckpointError",
    "CorruptUpdate",
    "FaultPlan",
    "KillAfterChunk",
    "NaNGrad",
    "NaNLogits",
    "RUN_FORMAT",
    "SimulatedCrash",
    "device_faults",
    "host_faults",
    "latest_checkpoint",
    "load_checkpoint",
    "plan_from_spec",
    "plan_spec",
    "save_checkpoint",
]
