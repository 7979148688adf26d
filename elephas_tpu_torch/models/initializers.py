"""Weight initializers (Keras-compatible defaults: glorot_uniform kernels,
zeros biases).

The counterpart of ``elephas_tpu/models/initializers.py``: the same
names, fans and distributions. Each takes a ``torch.Generator`` in place
of a JAX key and draws on the generator's device,
``fn(generator, shape, dtype=torch.float32)``. The draws cannot equal
``jax.random``'s; weights cross between the packages through
``get_weights``/``set_weights``.
"""
from typing import Callable, Dict, Sequence, Union

import numpy as np
import torch


def _fans(shape: Sequence[int]):
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels: (kh, kw, in, out)
    receptive = int(np.prod(shape[:-2]))
    return shape[-2] * receptive, shape[-1] * receptive


def _uniform(gen, shape, dtype, limit):
    u = torch.rand(tuple(shape), generator=gen, device=gen.device,
                   dtype=dtype)
    return u * (2.0 * limit) - limit


def _normal(gen, shape, dtype):
    return torch.randn(tuple(shape), generator=gen, device=gen.device,
                       dtype=dtype)


def zeros(gen, shape, dtype=torch.float32):
    return torch.zeros(tuple(shape), dtype=dtype, device=gen.device)


def ones(gen, shape, dtype=torch.float32):
    return torch.ones(tuple(shape), dtype=dtype, device=gen.device)


def glorot_uniform(gen, shape, dtype=torch.float32):
    fan_in, fan_out = _fans(shape)
    return _uniform(gen, shape, dtype, float(np.sqrt(6.0 / (fan_in + fan_out))))


def glorot_normal(gen, shape, dtype=torch.float32):
    fan_in, fan_out = _fans(shape)
    return float(np.sqrt(2.0 / (fan_in + fan_out))) * _normal(gen, shape, dtype)


def he_uniform(gen, shape, dtype=torch.float32):
    fan_in, _ = _fans(shape)
    return _uniform(gen, shape, dtype, float(np.sqrt(6.0 / fan_in)))


def he_normal(gen, shape, dtype=torch.float32):
    fan_in, _ = _fans(shape)
    return float(np.sqrt(2.0 / fan_in)) * _normal(gen, shape, dtype)


def lecun_normal(gen, shape, dtype=torch.float32):
    fan_in, _ = _fans(shape)
    return float(np.sqrt(1.0 / fan_in)) * _normal(gen, shape, dtype)


def random_uniform(gen, shape, dtype=torch.float32):
    return _uniform(gen, shape, dtype, 0.05)


def random_normal(gen, shape, dtype=torch.float32):
    return 0.05 * _normal(gen, shape, dtype)


def truncated_normal(gen, shape, dtype=torch.float32):
    t = torch.empty(tuple(shape), dtype=dtype, device=gen.device)
    return 0.05 * torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                              generator=gen)


def orthogonal(gen, shape, dtype=torch.float32):
    """Orthogonal matrix via QR (recurrent-kernel standard: preserves
    activation norms through the recurrence)."""
    if len(shape) < 2:
        return random_normal(gen, shape, dtype)
    rows = shape[0]
    cols = 1
    for d in shape[1:]:
        cols *= int(d)
    n = max(rows, cols)
    q, r = torch.linalg.qr(_normal(gen, (n, n), torch.float32))
    # sign correction makes the distribution uniform over O(n)
    q = q * torch.sign(torch.diagonal(r))
    return q[:rows, :cols].reshape(tuple(shape)).to(dtype)


_INITIALIZERS: Dict[str, Callable] = {
    "zeros": zeros,
    "ones": ones,
    "glorot_uniform": glorot_uniform,
    "glorot_normal": glorot_normal,
    "he_uniform": he_uniform,
    "he_normal": he_normal,
    "lecun_normal": lecun_normal,
    "random_uniform": random_uniform,
    "random_normal": random_normal,
    "truncated_normal": truncated_normal,
    "orthogonal": orthogonal,
}


def get(identifier: Union[str, Callable]) -> Callable:
    if callable(identifier):
        return identifier
    if identifier in _INITIALIZERS:
        return _INITIALIZERS[identifier]
    raise ValueError(f"Unknown initializer: {identifier!r}")
