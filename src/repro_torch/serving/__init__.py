"""Serving: the continuous-batching decode engine, the lockstep decode loop
and checkpoint loading."""
from repro_torch.serving.checkpoint import SERVE_MODES, Servable, load_servable
from repro_torch.serving.engine import (
    Completion,
    DecodeEngine,
    QueueFull,
    ServeConfig,
)
from repro_torch.serving.lockstep import LockstepSession, lockstep_decode

__all__ = ["SERVE_MODES", "Completion", "DecodeEngine", "LockstepSession",
           "QueueFull", "Servable", "ServeConfig", "load_servable",
           "lockstep_decode"]
