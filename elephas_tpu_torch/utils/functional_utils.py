"""Parameter algebra for lists of weight arrays and trees of tensors.

The counterpart of ``elephas_tpu/utils/functional_utils.py``. Workers
ship weight *deltas* (weights before training minus weights after) and
the parameter server folds them into the master weights. The list forms
work on numpy arrays, the wire currency; the ``tree_*`` forms map over
nested dicts of tensors (the port's parameter trees, the JAX package's
pytrees).
"""
from typing import Any, List, Sequence

import numpy as np

from ..weights import tree_map

Params = List[np.ndarray]


def add_params(param_list_left: Sequence[np.ndarray],
               param_list_right: Sequence[np.ndarray]) -> Params:
    """Elementwise sum of two lists of weight arrays."""
    return [x + y for x, y in zip(param_list_left, param_list_right)]


def subtract_params(param_list_left: Sequence[np.ndarray],
                    param_list_right: Sequence[np.ndarray]) -> Params:
    """Elementwise difference of two lists of weight arrays (left - right)."""
    return [x - y for x, y in zip(param_list_left, param_list_right)]


def get_neutral(array_list: Sequence[np.ndarray]) -> Params:
    """Zero-valued arrays with the same shapes/dtypes as the input list."""
    return [np.zeros_like(x) for x in array_list]


def divide_by(array_list: Sequence[np.ndarray], num_workers: int) -> Params:
    """Divide every array in the list by a scalar (worker count)."""
    return [x / num_workers for x in array_list]


def _zip_map(fn, left: Any, right: Any) -> Any:
    if isinstance(left, dict):
        return {k: _zip_map(fn, v, right[k]) for k, v in left.items()}
    return fn(left, right)


def tree_add(left: Any, right: Any) -> Any:
    """Elementwise sum of two trees of tensors."""
    return _zip_map(lambda x, y: x + y, left, right)


def tree_subtract(left: Any, right: Any) -> Any:
    """Elementwise difference of two trees of tensors (left - right)."""
    return _zip_map(lambda x, y: x - y, left, right)


def tree_zeros_like(tree: Any) -> Any:
    """Zero tree with the same structure, shapes and dtypes (numpy
    leaves stay numpy, tensors stay on their device)."""
    import torch

    return tree_map(lambda x: np.zeros_like(x) if isinstance(x, np.ndarray)
                    else torch.zeros_like(x), tree)


def tree_divide(tree: Any, denominator) -> Any:
    """Divide every leaf by a scalar."""
    return tree_map(lambda x: x / denominator, tree)


def tree_scale(tree: Any, factor) -> Any:
    """Multiply every leaf by a scalar."""
    return tree_map(lambda x: x * factor, tree)
