"""Helpers over nested dicts of tensors (the port's param trees)."""
from repro_torch.utils.tree import (tree_leaves, tree_map, tree_size,
                                    tree_unflatten)

__all__ = ["tree_leaves", "tree_map", "tree_size", "tree_unflatten"]
