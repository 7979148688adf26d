"""Metric functions.

The counterpart of ``elephas_tpu/models/metrics.py``. Metrics map
``(y_true, y_pred)`` to per-sample values; the trainers report
sample-weighted means, so distributed evaluation equals single-process
evaluation. ``'acc'``/``'accuracy'`` is resolved against the compiled
loss (Keras semantics).
"""
from typing import Callable, Dict, List, Optional, Union

import torch

from . import losses as losses_mod


def binary_accuracy(y_true, y_pred):
    match = (y_true > 0.5) == (y_pred > 0.5)
    return torch.mean(match.float().reshape(match.shape[0], -1), dim=-1)


def categorical_accuracy(y_true, y_pred):
    return (torch.argmax(y_true, dim=-1)
            == torch.argmax(y_pred, dim=-1)).float()


def sparse_categorical_accuracy(y_true, y_pred):
    labels = y_true.long()
    if labels.ndim == y_pred.ndim:
        labels = labels[..., 0]
    return (labels == torch.argmax(y_pred, dim=-1)).float()


_METRICS: Dict[str, Callable] = {
    "binary_accuracy": binary_accuracy,
    "categorical_accuracy": categorical_accuracy,
    "sparse_categorical_accuracy": sparse_categorical_accuracy,
    "mean_squared_error": losses_mod.mean_squared_error,
    "mse": losses_mod.mean_squared_error,
    "mean_absolute_error": losses_mod.mean_absolute_error,
    "mae": losses_mod.mean_absolute_error,
    "mean_absolute_percentage_error": losses_mod.mean_absolute_percentage_error,
    "mape": losses_mod.mean_absolute_percentage_error,
    "mean_squared_logarithmic_error": losses_mod.mean_squared_logarithmic_error,
    "msle": losses_mod.mean_squared_logarithmic_error,
    "cosine_similarity": losses_mod.cosine_similarity,
    "logcosh": losses_mod.log_cosh,
}


def resolve_accuracy(loss_name: Optional[str]) -> Callable:
    """Pick the accuracy flavor matching the compiled loss (Keras semantics)."""
    if loss_name == "sparse_categorical_crossentropy":
        return sparse_categorical_accuracy
    if loss_name == "binary_crossentropy":
        return binary_accuracy
    if loss_name == "categorical_crossentropy":
        return categorical_accuracy
    return categorical_accuracy


def get(identifier: Union[str, Callable], loss=None,
        custom_objects: Optional[Dict[str, Callable]] = None) -> Callable:
    """Resolve a metric from a name or callable."""
    if callable(identifier):
        return identifier
    if custom_objects and identifier in custom_objects:
        return custom_objects[identifier]
    if identifier in ("acc", "accuracy"):
        loss_name = loss if isinstance(loss, str) else getattr(loss, "__name__", None)
        return resolve_accuracy(loss_name)
    if identifier in _METRICS:
        return _METRICS[identifier]
    raise ValueError(f"Unknown metric: {identifier!r}")


def serialize(identifier: Union[str, Callable]) -> str:
    if isinstance(identifier, str):
        return identifier
    for name, fn in _METRICS.items():
        if fn is identifier:
            return name
    return getattr(identifier, "__name__", str(identifier))


def resolve_metrics(metrics: Optional[List], loss=None,
                    custom_objects: Optional[Dict] = None):
    """Resolve a metrics list to (names, callables)."""
    metrics = metrics or []
    names, fns = [], []
    for m in metrics:
        names.append(serialize(m) if not isinstance(m, str) else m)
        fns.append(get(m, loss=loss, custom_objects=custom_objects))
    return names, fns
