"""PyTorch/CUDA port of the FedDUMAP reproduction (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its layout
(``configs/``, ``kernels/``, ``models/``, ``core/``, ``data/``,
``serving/``, ``utils/``) so each
module has a counterpart under the same name.  It imports ``torch``, numpy
and the standard library only — never JAX and nothing of ``repro``.

Every entry point takes ``device=`` and defaults to ``"cuda"``; on a machine
without a GPU the default raises instead of running on the CPU.  The
hand-written CUDA kernels live in ``kernels/csrc`` and are built with
``nvcc`` at first use (``kernels/_build.py``).
"""
