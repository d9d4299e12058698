"""Hand-written CUDA kernels (``csrc/``), their wrappers, the plain PyTorch
versions (:mod:`ref`) and the device dispatch (:mod:`ops`)."""
