"""Weight bridge between the JAX package's parameter tree and the port.

The port's parameter dict has the JAX pytree's nesting, key names,
shapes and layouts, so the bridge is a leaf-by-leaf copy through numpy.
The JAX side hands its tree over as numpy arrays (for example
``jax.tree_util.tree_map(np.asarray, params)``); this module imports
nothing of JAX.
"""
from typing import Any, Dict, Optional

import numpy as np
import torch

from ._device import DeviceLike, resolve_device

__all__ = ["from_numpy_tree", "to_numpy_tree", "tree_map"]


def from_numpy_tree(tree: Dict[str, Any], device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """A nested dict of numpy arrays -> the same nesting of tensors on
    ``device`` (``None`` means the CUDA device), cast to ``dtype`` when
    given (floating leaves only)."""
    device = resolve_device(device)

    def leaf(a):
        t = torch.from_numpy(np.array(a))   # a writable, contiguous copy
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return tree_map(leaf, tree)


def to_numpy_tree(params: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse: tensors -> numpy arrays on the host, same nesting.
    bf16 leaves come back as float32 (numpy has no bfloat16)."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return tree_map(leaf, params)


def tree_map(fn, tree):
    """``fn`` over the leaves of a nested dict, same nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)
