"""Loss functions.

The counterpart of ``elephas_tpu/models/losses.py``. Every loss maps
``(y_true, y_pred)`` to a per-sample loss vector of shape ``(batch,)``;
reductions (weighted means over real samples) happen in the training
and evaluation steps, so padded rows contribute nothing. The
cross-entropies clip and renormalise exactly as the JAX package does
(``EPS``).
"""
import math
from typing import Callable, Dict, Optional, Union

import torch

EPS = 1e-7


def _reduce_sample(x):
    """Mean over all non-batch axes -> per-sample scalar."""
    if x.ndim <= 1:
        return x
    return torch.mean(x.reshape(x.shape[0], -1), dim=-1)


def mean_squared_error(y_true, y_pred):
    return _reduce_sample(torch.square(y_pred - y_true))


def mean_absolute_error(y_true, y_pred):
    return _reduce_sample(torch.abs(y_pred - y_true))


def mean_absolute_percentage_error(y_true, y_pred):
    diff = torch.abs((y_true - y_pred) / torch.clamp(torch.abs(y_true),
                                                     min=EPS))
    return 100.0 * _reduce_sample(diff)


def mean_squared_logarithmic_error(y_true, y_pred):
    first = torch.log(torch.clamp(y_pred, min=EPS) + 1.0)
    second = torch.log(torch.clamp(y_true, min=EPS) + 1.0)
    return _reduce_sample(torch.square(first - second))


def log_cosh(y_true, y_pred):
    x = y_pred - y_true
    return _reduce_sample(x + torch.log1p(torch.exp(-2.0 * x)) - math.log(2.0))


def cosine_similarity(y_true, y_pred):
    def _norm(v):
        flat = v.reshape(v.shape[0], -1)
        return flat / torch.clamp(torch.linalg.norm(flat, dim=-1,
                                                    keepdim=True), min=EPS)

    return -torch.sum(_norm(y_true) * _norm(y_pred), dim=-1)


def huber(y_true, y_pred, delta: float = 1.0):
    err = y_pred - y_true
    abs_err = torch.abs(err)
    quadratic = torch.clamp(abs_err, max=delta)
    linear = abs_err - quadratic
    return _reduce_sample(0.5 * torch.square(quadratic) + delta * linear)


def binary_crossentropy(y_true, y_pred):
    p = torch.clamp(y_pred, EPS, 1.0 - EPS)
    bce = -(y_true * torch.log(p) + (1.0 - y_true) * torch.log(1.0 - p))
    return _reduce_sample(bce)


def categorical_crossentropy(y_true, y_pred):
    p = torch.clamp(y_pred, EPS, 1.0)
    p = p / torch.sum(p, dim=-1, keepdim=True)
    ce = -torch.sum(y_true * torch.log(p), dim=-1)
    return _reduce_sample(ce) if ce.ndim > 1 else ce


def sparse_categorical_crossentropy(y_true, y_pred):
    p = torch.clamp(y_pred, EPS, 1.0)
    p = p / torch.sum(p, dim=-1, keepdim=True)
    labels = y_true.long()
    if labels.ndim == p.ndim:  # trailing singleton label dim
        labels = labels[..., 0]
    picked = torch.gather(p, -1, labels[..., None])[..., 0]
    ce = -torch.log(picked)
    return _reduce_sample(ce) if ce.ndim > 1 else ce


_LOSSES: Dict[str, Callable] = {
    "mean_squared_error": mean_squared_error,
    "mse": mean_squared_error,
    "mean_absolute_error": mean_absolute_error,
    "mae": mean_absolute_error,
    "mean_absolute_percentage_error": mean_absolute_percentage_error,
    "mape": mean_absolute_percentage_error,
    "mean_squared_logarithmic_error": mean_squared_logarithmic_error,
    "msle": mean_squared_logarithmic_error,
    "logcosh": log_cosh,
    "log_cosh": log_cosh,
    "cosine_proximity": cosine_similarity,
    "cosine_similarity": cosine_similarity,
    "huber": huber,
    "binary_crossentropy": binary_crossentropy,
    "categorical_crossentropy": categorical_crossentropy,
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
}


def get(identifier: Union[str, Callable],
        custom_objects: Optional[Dict[str, Callable]] = None) -> Callable:
    """Resolve a loss from a name or callable."""
    if callable(identifier):
        return identifier
    if custom_objects and identifier in custom_objects:
        return custom_objects[identifier]
    if identifier in _LOSSES:
        return _LOSSES[identifier]
    raise ValueError(f"Unknown loss: {identifier!r}")


def serialize(identifier: Union[str, Callable]) -> str:
    if isinstance(identifier, str):
        return identifier
    for name, fn in _LOSSES.items():
        if fn is identifier:
            return name
    return getattr(identifier, "__name__", str(identifier))
