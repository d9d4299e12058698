"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`, defaulting to CUDA.

    Raises when CUDA is asked for and missing: the port never falls back to
    the CPU on its own.  Pass ``device="cpu"`` to run the plain PyTorch
    versions of the kernels (what the CPU tests do).
    """
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but CUDA is not available; "
            f"pass device='cpu' to run the plain PyTorch path")
    return dev
