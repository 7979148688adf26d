"""Weight bridge between the JAX package's parameter tree and the port.

The port's parameter dict has the JAX pytree's nesting, key names,
shapes and layouts, so the bridge is a leaf-by-leaf copy through numpy.
The JAX side hands its tree over as numpy arrays (for example
``jax.tree_util.tree_map(np.asarray, params)``); this module imports
nothing of JAX.

:func:`tree_leaves`, :func:`tree_flatten` and :func:`tree_unflatten`
walk a tree in JAX's leaf order: dict keys sorted (as strings, so
``layer_10`` comes before ``layer_2``) at every level, lists and tuples
in order. A flat weight list of the JAX model (``get_weights``) is
therefore the port's in the same order.

A weight-only int8 leaf (:class:`~elephas_tpu_torch.models.quantization.
QTensor`) is a node of two leaves, ``data`` then ``scale``, as the JAX
pytree node is. The JAX package's own ``QTensor`` (its children mapped
to numpy) is recognised by its ``data`` and ``scale`` attributes and
becomes the port's.
"""
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ._device import DeviceLike, resolve_device

__all__ = ["from_numpy_tree", "to_numpy_tree", "tree_map", "tree_leaves",
           "tree_flatten", "tree_unflatten"]


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


def _is_qtensor(node) -> bool:
    """A quantized weight of either package: ``data`` and ``scale``
    attributes on something that is not itself an array (a tensor's
    ``.data`` and an ndarray's buffer do not count)."""
    return (not isinstance(node, (torch.Tensor, np.ndarray))
            and hasattr(node, "data") and hasattr(node, "scale"))


def _qtensor(data, scale):
    # imported here: the models package imports this module
    from .models.quantization import QTensor
    return QTensor(data, scale)


def tree_map(fn, tree):
    """``fn`` over the leaves of a nested dict, same nesting (a
    quantized weight's ``data`` and ``scale`` are two leaves)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if _is_qtensor(tree):
        return _qtensor(fn(tree.data), fn(tree.scale))
    return fn(tree)


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)`` in JAX's leaf order; ``treedef`` is the
    tree with every leaf replaced by ``None``."""
    leaves: List[Any] = []

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node, key=str)}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(x) for x in node)
        if _is_qtensor(node):
            return _qtensor(walk(node.data), walk(node.scale))
        leaves.append(node)
        return None

    return leaves, walk(tree)


def tree_leaves(tree) -> List[Any]:
    """The leaves of a nested dict/list/tuple in JAX's leaf order."""
    return tree_flatten(tree)[0]


def tree_unflatten(treedef, leaves):
    """The inverse of :func:`tree_flatten`."""
    leaves = list(leaves)
    places = len(tree_leaves(treedef))
    if len(leaves) != places:
        raise ValueError(f"{len(leaves)} leaves for a tree of {places}")
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node, key=str)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(x) for x in node)
        if _is_qtensor(node):
            return _qtensor(build(node.data), build(node.scale))
        return next(it)

    return build(treedef)
