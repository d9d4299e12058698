"""Launch-side entry points: the batch-dict FL step (``steps``) and the
device meshes over ``torch.distributed`` (``mesh``)."""
