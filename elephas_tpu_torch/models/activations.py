"""Activation function registry.

The counterpart of ``elephas_tpu/models/activations.py``: the same
names, resolvable at model-deserialization time, with ``custom_objects``
lookup for user functions. Each function is the JAX package's formula
in torch ops (``gelu`` is the tanh approximation, as ``jax.nn.gelu``'s
default; ``leaky_relu`` has slope 0.01).
"""
from typing import Callable, Dict, Optional, Union

import torch
import torch.nn.functional as F


def linear(x):
    return x


def relu(x):
    return torch.relu(x)


def sigmoid(x):
    return torch.sigmoid(x)


def tanh(x):
    return torch.tanh(x)


def softmax(x):
    return torch.softmax(x, dim=-1)


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def elu(x):
    return F.elu(x)


def selu(x):
    return F.selu(x)


def gelu(x):
    return F.gelu(x, approximate="tanh")


def swish(x):
    return F.silu(x)


def leaky_relu(x):
    return F.leaky_relu(x, 0.01)


def exponential(x):
    return torch.exp(x)


def hard_sigmoid(x):
    return torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


_ACTIVATIONS: Dict[str, Callable] = {
    "linear": linear,
    "relu": relu,
    "sigmoid": sigmoid,
    "tanh": tanh,
    "softmax": softmax,
    "softplus": softplus,
    "elu": elu,
    "selu": selu,
    "gelu": gelu,
    "swish": swish,
    "silu": swish,
    "leaky_relu": leaky_relu,
    "exponential": exponential,
    "hard_sigmoid": hard_sigmoid,
}


def get(identifier: Union[str, Callable, None],
        custom_objects: Optional[Dict[str, Callable]] = None) -> Callable:
    """Resolve an activation from a name, callable or None (= linear)."""
    if identifier is None:
        return linear
    if callable(identifier):
        return identifier
    if custom_objects and identifier in custom_objects:
        return custom_objects[identifier]
    if identifier in _ACTIVATIONS:
        return _ACTIVATIONS[identifier]
    raise ValueError(f"Unknown activation: {identifier!r}")


def serialize(fn: Union[str, Callable, None]) -> Optional[str]:
    """Name under which an activation is persisted in model JSON."""
    if fn is None:
        return None
    if isinstance(fn, str):
        return fn
    for name, known in _ACTIVATIONS.items():
        if known is fn:
            return name
    return getattr(fn, "__name__", None)
