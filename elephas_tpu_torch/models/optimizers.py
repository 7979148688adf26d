"""Optimizers: named configs that lower to functional transforms.

The counterpart of ``elephas_tpu/models/optimizers.py``. Each optimizer
is a named hyperparameter bundle whose :meth:`Optimizer.to_transform`
returns a :class:`Transform` with ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``, written with the
optax formulas the JAX package lowers to, so the same gradients give the
same updates:

- Adam: the moments update first, then the step count, and the bias
  correction divides by ``1 - b**count`` with the incremented count;
  ``eps`` sits outside the square root (``eps_root = 0``).
- AdamW: the decoupled decay ``weight_decay * p`` is added to the Adam
  update before the ``-learning_rate`` scale; by default only leaves of
  rank >= 2 decay (biases and norm scales do not), ``decay_1d=True``
  decays every leaf.
- ``clipvalue`` clamps elementwise, then ``clipnorm`` rescales by the
  global norm over all leaves, both before the update rule.

- RMSprop: ``nu = (1 - rho) * g * g + rho * nu``, the update
  ``g * rsqrt(nu + eps)`` (eps inside the root, optax's default), then
  the ``-learning_rate`` scale, then momentum when set.

- Adagrad: optax's ``adagrad`` with its initial accumulator 0.1, the
  update ``g * rsqrt(sum + eps)`` (0 where the sum is 0).
- Adadelta: optax's ``adadelta``, the running squared update in the
  numerator.
- Nadam: optax's ``nadam`` (Adam with ``nesterov=True``): the first
  moment corrected with ``count + 1`` blended with the gradient
  corrected with ``count``.
- Adafactor: optax's ``adafactor``: factored second moments for a leaf
  whose two largest dimensions reach ``min_dim_size_to_factor`` (row
  and column means of ``g * g + 1e-30``), a full one otherwise, the
  decay ``1 - (count + 1) ** -0.8``; then the block-RMS clip at 1, the
  learning rate (none by default), the parameter's RMS (at least 1e-3)
  and the weight decay when set. Its state keeps optax's
  ``FactoredState``: the count, then the row, column and full second
  moments of every leaf, each a ``(1,)`` zero placeholder where the
  leaf does not use it.
- Lion: ``sign((1 - b1) * g + b1 * m)``, then ``m = (1 - b2) * g + b2
  * m``; decayed weights (rank >= 2 only) before the learning rate.
- LAMB: the Adam update plus decayed weights (rank >= 2 only), scaled by
  the trust ratio ``|p| / |u|`` (1 where either is 0).

``optax.adamw(3e-4)`` (the JAX bench's optimizer) is
``AdamW(3e-4, epsilon=1e-8, weight_decay=1e-4, decay_1d=True)`` here.

The learning rate is a float or a schedule of
:mod:`~elephas_tpu_torch.models.schedules` (or its serialized dict),
which the update evaluates at its own count before the increment, as
optax's ``scale_by_schedule`` does; that count is one more state leaf.

A transform takes any tree of tensors (nested dicts in JAX leaf order,
lists, tuples) and returns updates in the structure of ``grads``; the
state holds flat lists in leaf order. ``serialize``/``deserialize`` use
the JAX package's ``{"class_name", "config"}`` form, so an optimizer
config crosses between the packages.
"""
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch

from ..weights import tree_flatten, tree_leaves, tree_unflatten
from . import schedules

__all__ = ["Transform", "Optimizer", "SGD", "Adam", "AdamW", "RMSprop",
           "Adagrad", "Adadelta", "Nadam", "Adafactor", "Lion", "LAMB",
           "get", "serialize", "deserialize", "opt_state_leaves",
           "opt_state_from_leaves"]

class Transform(NamedTuple):
    """A functional gradient transformation (optax's shape)."""
    init: Callable
    update: Callable


def _on_trees(init_fn, update_fn) -> Transform:
    """Lift list-of-leaves functions to trees: the state is built from
    the leaves of ``params``; updates come back shaped like ``grads``."""
    def init(params):
        return init_fn(tree_leaves(params))

    def update(grads, state, params=None):
        leaves, treedef = tree_flatten(grads)
        p = None if params is None else tree_leaves(params)
        updates, state = update_fn(leaves, state, p)
        return tree_unflatten(treedef, updates), state

    return Transform(init, update)


def _stateless(fn) -> Transform:
    return Transform(lambda params: (), lambda g, s, p=None: (fn(g, p), s))


def _chain(*txs: Transform) -> Transform:
    def init(params):
        return tuple(t.init(params) for t in txs)

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(txs, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return Transform(init, update)


def _clip(max_delta: float) -> Transform:
    return _stateless(lambda g, p: [x.clamp(-max_delta, max_delta)
                                    for x in g])


def _clip_by_global_norm(max_norm: float) -> Transform:
    def clip(g, p):
        norm = torch.sqrt(sum(torch.sum(x.float() * x.float()) for x in g))
        # no host sync: the select happens on the device
        return [torch.where(norm < max_norm, x,
                            (x / norm.to(x.dtype)) * max_norm) for x in g]
    return _stateless(clip)


def _trace(decay: float, nesterov: bool) -> Transform:
    """Momentum: ``t = g + decay * t``; Nesterov adds ``decay * t`` once
    more to the update."""
    def init(params):
        return [torch.zeros_like(p) for p in params]

    def update(g, state, params=None):
        new = [x + decay * t for x, t in zip(g, state)]
        out = ([x + decay * t for x, t in zip(g, new)] if nesterov
               else new)
        return out, new

    return Transform(init, update)


def _scale_by_adam(b1: float, b2: float, eps: float,
                   mu_dtype: Optional[torch.dtype],
                   nesterov: bool = False) -> Transform:
    def init(params):
        return {"count": 0,
                "mu": [torch.zeros_like(p, dtype=mu_dtype or p.dtype)
                       for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    def update(g, state, params=None):
        # b1 in the moment's dtype, as JAX's weak-typed scalar is (this
        # rounds b1 itself when mu is bf16)
        mu = [(1 - b1) * x + m * torch.tensor(b1, dtype=m.dtype)
              for x, m in zip(g, state["mu"])]
        nu = [(1 - b2) * (x * x) + b2 * n for x, n in zip(g, state["nu"])]
        count = state["count"] + 1
        c1, c2 = 1 - b1 ** count, 1 - b2 ** count
        if nesterov:
            c1_next = 1 - b1 ** (count + 1)
            mu_hat = [b1 * (m / c1_next) + (1 - b1) * (x / c1)
                      for m, x in zip(mu, g)]
        else:
            mu_hat = [m / c1 for m in mu]
        out = [m / (torch.sqrt(n / c2) + eps) for m, n in zip(mu_hat, nu)]
        if mu_dtype is not None:
            mu = [m.to(mu_dtype) for m in mu]
        return out, {"count": count, "mu": mu, "nu": nu}

    return Transform(init, update)


def _scale_by_rms(decay: float, eps: float) -> Transform:
    def init(params):
        return [torch.zeros_like(p) for p in params]

    def update(g, state, params=None):
        nu = [(1 - decay) * (x * x) + decay * n for x, n in zip(g, state)]
        return [torch.rsqrt(n + eps) * x for x, n in zip(g, nu)], nu

    return Transform(init, update)


def _add_decayed_weights(weight_decay: float, masked: bool) -> Transform:
    """``g + weight_decay * p``; with ``masked``, only rank >= 2 leaves
    (the JAX package's ``_decay_mask_fn``)."""
    def fn(g, p):
        return [x + weight_decay * w if (w.ndim >= 2 or not masked) else x
                for x, w in zip(g, p)]
    return _stateless(fn)


def _scale(step: float) -> Transform:
    return _stateless(lambda g, p: [step * x for x in g])


def _scale_by_schedule(step_fn: Callable[[int], float]) -> Transform:
    """``step_fn(count) * g`` at the count before this update (optax's
    ``scale_by_schedule``); the count is its state."""
    def init(params):
        return {"count": 0}

    def update(g, state, params=None):
        step = step_fn(state["count"])
        return [step * x for x in g], {"count": state["count"] + 1}

    return Transform(init, update)


def _scale_by_rss(initial: float, eps: float) -> Transform:
    def init(params):
        return [torch.full_like(p, initial) for p in params]

    def update(g, state, params=None):
        sums = [x * x + t for x, t in zip(g, state)]
        out = [torch.where(t > 0, torch.rsqrt(t + eps), 0.0) * x
               for x, t in zip(g, sums)]
        return out, sums

    return Transform(init, update)


def _scale_by_adadelta(rho: float, eps: float) -> Transform:
    def init(params):
        return {"e_g": [torch.zeros_like(p) for p in params],
                "e_x": [torch.zeros_like(p) for p in params]}

    def update(g, state, params=None):
        e_g = [(1 - rho) * (x * x) + rho * t
               for x, t in zip(g, state["e_g"])]
        out = [torch.sqrt(ex + eps) / torch.sqrt(eg + eps) * x
               for x, eg, ex in zip(g, e_g, state["e_x"])]
        e_x = [(1 - rho) * (u * u) + rho * t
               for u, t in zip(out, state["e_x"])]
        return out, {"e_g": e_g, "e_x": e_x}

    return Transform(init, update)


def _factored_dims(shape, min_dim_size_to_factor: int):
    """optax's choice: the two largest axes ``(d1, d0)`` when the second
    largest reaches ``min_dim_size_to_factor``, else None."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


def _scale_by_factored_rms(min_dim_size_to_factor: int,
                           decay_rate: float = 0.8,
                           eps: float = 1e-30) -> Transform:
    """optax's ``scale_by_factored_rms``; the state is optax's
    ``FactoredState`` as a tuple in its field order (``count``, then the
    row, column and full moments of every leaf, ``(1,)`` zeros where a
    leaf does not use one)."""
    def dims(p):
        return _factored_dims(tuple(p.shape), min_dim_size_to_factor)

    def init(params):
        rows, cols, full = [], [], []
        for p in params:
            holder = p.new_zeros((1,))
            d = dims(p)
            if d is None:
                rows.append(holder)
                cols.append(holder)
                full.append(torch.zeros_like(p))
            else:
                d1, d0 = d
                rows.append(p.new_zeros(tuple(np.delete(p.shape, d0))))
                cols.append(p.new_zeros(tuple(np.delete(p.shape, d1))))
                full.append(holder)
        return (0, rows, cols, full)

    def update(g, state, params=None):
        count, v_rows, v_cols, vs = state
        t = np.float32(count + 1)
        decay = float(np.float32(1.0) - t ** np.float32(-decay_rate))
        out, rows, cols, full = [], [], [], []
        for x, p, v_row, v_col, v in zip(g, params, v_rows, v_cols, vs):
            holder = p.new_zeros((1,))
            d = dims(p)
            grad_sqr = x * x + eps
            if d is None:
                v = decay * v + (1.0 - decay) * grad_sqr
                out.append(x * v.pow(-0.5))
                rows.append(holder)
                cols.append(holder)
                full.append(v)
                continue
            d1, d0 = d
            v_row = decay * v_row + (1.0 - decay) * grad_sqr.mean(dim=d0)
            v_col = decay * v_col + (1.0 - decay) * grad_sqr.mean(dim=d1)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_col_mean = v_row.mean(dim=reduced_d1, keepdim=True)
            row_factor = (v_row / row_col_mean).pow(-0.5)
            col_factor = v_col.pow(-0.5)
            out.append(x * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1))
            rows.append(v_row)
            cols.append(v_col)
            full.append(holder)
        return out, (count + 1, rows, cols, full)

    return Transform(init, update)


def _clip_by_block_rms(threshold: float) -> Transform:
    return _stateless(lambda g, p: [
        x / torch.clamp(torch.sqrt(torch.mean(x * x)) / threshold, min=1.0)
        for x in g])


def _safe_rms(x: torch.Tensor, min_rms: float) -> torch.Tensor:
    rms = torch.sqrt(torch.mean(x * x))
    return torch.where(rms <= min_rms, torch.full_like(rms, min_rms), rms)


def _scale_by_param_block_rms(min_scale: float = 1e-3) -> Transform:
    return _stateless(lambda g, p: [x * _safe_rms(w, min_scale)
                                    for x, w in zip(g, p)])


def _scale_by_lion(b1: float, b2: float) -> Transform:
    def init(params):
        return {"count": 0, "mu": [torch.zeros_like(p) for p in params]}

    def update(g, state, params=None):
        out = [torch.sign((1.0 - b1) * x + b1 * m)
               for x, m in zip(g, state["mu"])]
        mu = [(1 - b2) * x + b2 * m for x, m in zip(g, state["mu"])]
        return out, {"count": state["count"] + 1, "mu": mu}

    return Transform(init, update)


def _scale_by_trust_ratio() -> Transform:
    def scale(u, p):
        p_norm = torch.linalg.vector_norm(p)
        u_norm = torch.linalg.vector_norm(u)
        ratio = torch.where((p_norm == 0) | (u_norm == 0),
                            torch.ones_like(p_norm), p_norm / u_norm)
        return u * ratio
    return _stateless(lambda g, p: [scale(u, w) for u, w in zip(g, p)])


def _coerce_lr(learning_rate):
    """A float stays a float; a schedule or its serialized dict resolves
    to a schedule."""
    if isinstance(learning_rate, schedules.LearningRateSchedule):
        return learning_rate
    if isinstance(learning_rate, dict):
        return schedules.deserialize(learning_rate)
    return float(learning_rate)


def _dtype_name(dtype) -> Optional[str]:
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(dtype)


class Optimizer:
    """Base class: a named hyperparameter bundle lowering to a
    :class:`Transform`."""

    def __init__(self, learning_rate=0.01, clipnorm=None, clipvalue=None):
        self.learning_rate = _coerce_lr(learning_rate)
        self.clipnorm = float(clipnorm) if clipnorm is not None else None
        self.clipvalue = (float(clipvalue) if clipvalue is not None
                          else None)

    def _rule(self) -> List[Transform]:
        raise NotImplementedError

    def _lr_config(self):
        if isinstance(self.learning_rate, schedules.LearningRateSchedule):
            return schedules.serialize(self.learning_rate)
        return self.learning_rate

    def _scale_lr(self, flip_sign: bool = True) -> Transform:
        """The learning-rate scale, ``-lr`` (or ``+lr``), a schedule's
        value at the count before the update."""
        lr = self.learning_rate
        if isinstance(lr, schedules.LearningRateSchedule):
            sign = -1.0 if flip_sign else 1.0
            return _scale_by_schedule(lambda count: sign * lr(count))
        return _scale(-lr if flip_sign else lr)

    def _clip_config(self) -> Dict:
        config = {}
        if self.clipnorm is not None:
            config["clipnorm"] = self.clipnorm
        if self.clipvalue is not None:
            config["clipvalue"] = self.clipvalue
        return config

    def to_transform(self) -> Transform:
        """Clipping (value, then global norm), then the update rule."""
        pre = []
        if self.clipvalue is not None:
            pre.append(_clip(self.clipvalue))
        if self.clipnorm is not None:
            pre.append(_clip_by_global_norm(self.clipnorm))
        tx = _chain(*pre, *self._rule())
        return _on_trees(tx.init, tx.update)

    @classmethod
    def from_config(cls, config: Dict) -> "Optimizer":
        return cls(**config)


class SGD(Optimizer):
    def __init__(self, learning_rate: float = 0.01, momentum: float = 0.0,
                 nesterov: bool = False, **kwargs):
        if "lr" in kwargs:
            learning_rate = kwargs.pop("lr")
        super().__init__(learning_rate, **kwargs)
        self.momentum = float(momentum)
        self.nesterov = bool(nesterov)

    def _rule(self):
        rule = [_trace(self.momentum, self.nesterov)] if self.momentum else []
        return rule + [self._scale_lr()]

    def get_config(self):
        return {"learning_rate": self._lr_config(),
                "momentum": self.momentum, "nesterov": self.nesterov,
                **self._clip_config()}


class Adam(Optimizer):
    """``mu_dtype="bfloat16"`` stores the first moment in bf16 (the
    second stays in the parameters' dtype); None keeps both moments at
    the parameters' dtype."""

    def __init__(self, learning_rate: float = 0.001, beta_1: float = 0.9,
                 beta_2: float = 0.999, epsilon: float = 1e-7,
                 mu_dtype=None, **kwargs):
        if "lr" in kwargs:
            learning_rate = kwargs.pop("lr")
        super().__init__(learning_rate, **kwargs)
        self.beta_1, self.beta_2 = float(beta_1), float(beta_2)
        self.epsilon = float(epsilon)
        # a dtype NAME, so the config stays JSON-serializable
        self.mu_dtype = _dtype_name(mu_dtype)

    def _adam(self, nesterov: bool = False) -> Transform:
        mu = None if self.mu_dtype is None else getattr(torch, self.mu_dtype)
        return _scale_by_adam(self.beta_1, self.beta_2, self.epsilon, mu,
                              nesterov)

    def _rule(self):
        return [self._adam(), self._scale_lr()]

    def get_config(self):
        return {"learning_rate": self._lr_config(), "beta_1": self.beta_1,
                "beta_2": self.beta_2, "epsilon": self.epsilon,
                "mu_dtype": self.mu_dtype, **self._clip_config()}


class AdamW(Adam):
    """``decay_1d=False`` (default) decays only rank >= 2 parameters
    (biases and norm scales excluded); ``decay_1d=True`` decays every
    leaf, as ``optax.adamw`` without a mask does."""

    def __init__(self, learning_rate: float = 0.001,
                 weight_decay: float = 0.004, decay_1d: bool = False,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.weight_decay = float(weight_decay)
        self.decay_1d = bool(decay_1d)

    def _rule(self):
        return [self._adam(),
                _add_decayed_weights(self.weight_decay, not self.decay_1d),
                self._scale_lr()]

    def get_config(self):
        return {**super().get_config(), "weight_decay": self.weight_decay,
                "decay_1d": self.decay_1d}


class RMSprop(Optimizer):
    """optax's ``rmsprop(learning_rate, decay=rho, eps=epsilon,
    momentum=momentum or None)``, as the JAX package lowers it."""

    def __init__(self, learning_rate: float = 0.001, rho: float = 0.9,
                 momentum: float = 0.0, epsilon: float = 1e-7, **kwargs):
        if "lr" in kwargs:
            learning_rate = kwargs.pop("lr")
        super().__init__(learning_rate, **kwargs)
        self.rho, self.momentum = float(rho), float(momentum)
        self.epsilon = float(epsilon)

    def _rule(self):
        rule = [_scale_by_rms(self.rho, self.epsilon), self._scale_lr()]
        return rule + ([_trace(self.momentum, False)] if self.momentum
                       else [])

    def get_config(self):
        return {"learning_rate": self._lr_config(), "rho": self.rho,
                "momentum": self.momentum, "epsilon": self.epsilon,
                **self._clip_config()}


class Adagrad(Optimizer):
    """optax's ``adagrad(learning_rate, eps=epsilon)``, initial
    accumulator 0.1."""

    def __init__(self, learning_rate: float = 0.001, epsilon: float = 1e-7,
                 **kwargs):
        if "lr" in kwargs:
            learning_rate = kwargs.pop("lr")
        super().__init__(learning_rate, **kwargs)
        self.epsilon = float(epsilon)

    def _rule(self):
        return [_scale_by_rss(0.1, self.epsilon), self._scale_lr()]

    def get_config(self):
        return {"learning_rate": self._lr_config(), "epsilon": self.epsilon,
                **self._clip_config()}


class Adadelta(Optimizer):
    """optax's ``adadelta(learning_rate, rho=rho, eps=epsilon)``."""

    def __init__(self, learning_rate: float = 0.001, rho: float = 0.95,
                 epsilon: float = 1e-7, **kwargs):
        if "lr" in kwargs:
            learning_rate = kwargs.pop("lr")
        super().__init__(learning_rate, **kwargs)
        self.rho, self.epsilon = float(rho), float(epsilon)

    def _rule(self):
        # optax's zero weight decay in front adds 0 * p: left out
        return [_scale_by_adadelta(self.rho, self.epsilon), self._scale_lr()]

    def get_config(self):
        return {"learning_rate": self._lr_config(), "rho": self.rho,
                "epsilon": self.epsilon, **self._clip_config()}


class Nadam(Adam):
    """optax's ``nadam``: Adam with Nesterov momentum."""

    def _rule(self):
        return [self._adam(nesterov=True), self._scale_lr()]


class Adafactor(Optimizer):
    """optax's ``adafactor``: ``learning_rate=None`` (the default) scales
    by no learning rate, only by each parameter's RMS."""

    def __init__(self, learning_rate=None, min_dim_size_to_factor: int = 128,
                 weight_decay_rate: float = 0.0, **kwargs):
        if "lr" in kwargs:
            learning_rate = kwargs.pop("lr")
        super().__init__(
            learning_rate if learning_rate is not None else 0.0, **kwargs)
        self._use_default_lr = learning_rate is None
        self.min_dim_size_to_factor = int(min_dim_size_to_factor)
        self.weight_decay_rate = float(weight_decay_rate)

    def _rule(self):
        rule = [_scale_by_factored_rms(self.min_dim_size_to_factor),
                _clip_by_block_rms(1.0)]
        if not self._use_default_lr:
            rule.append(self._scale_lr(flip_sign=False))
        rule.append(_scale_by_param_block_rms())
        if self.weight_decay_rate:
            rule.append(_add_decayed_weights(self.weight_decay_rate, False))
        return rule + [_scale(-1.0)]

    def get_config(self):
        return {"learning_rate": (None if self._use_default_lr
                                  else self._lr_config()),
                "min_dim_size_to_factor": self.min_dim_size_to_factor,
                "weight_decay_rate": self.weight_decay_rate,
                **self._clip_config()}


class Lion(Optimizer):
    """optax's ``lion``; a non-zero ``weight_decay`` decays only rank >= 2
    parameters."""

    def __init__(self, learning_rate: float = 1e-4, beta_1: float = 0.9,
                 beta_2: float = 0.99, weight_decay: float = 0.0, **kwargs):
        if "lr" in kwargs:
            learning_rate = kwargs.pop("lr")
        super().__init__(learning_rate, **kwargs)
        self.beta_1, self.beta_2 = float(beta_1), float(beta_2)
        self.weight_decay = float(weight_decay)

    def _rule(self):
        # a zero decay adds 0 * p: left out
        decay = ([_add_decayed_weights(self.weight_decay, True)]
                 if self.weight_decay else [])
        return [_scale_by_lion(self.beta_1, self.beta_2), *decay,
                self._scale_lr()]

    def get_config(self):
        return {"learning_rate": self._lr_config(), "beta_1": self.beta_1,
                "beta_2": self.beta_2, "weight_decay": self.weight_decay,
                **self._clip_config()}


class LAMB(Optimizer):
    """optax's ``lamb``; a non-zero ``weight_decay`` decays only rank >= 2
    parameters."""

    def __init__(self, learning_rate: float = 1e-3, beta_1: float = 0.9,
                 beta_2: float = 0.999, epsilon: float = 1e-6,
                 weight_decay: float = 0.0, **kwargs):
        if "lr" in kwargs:
            learning_rate = kwargs.pop("lr")
        super().__init__(learning_rate, **kwargs)
        self.beta_1, self.beta_2 = float(beta_1), float(beta_2)
        self.epsilon = float(epsilon)
        self.weight_decay = float(weight_decay)

    def _rule(self):
        decay = ([_add_decayed_weights(self.weight_decay, True)]
                 if self.weight_decay else [])
        return [_scale_by_adam(self.beta_1, self.beta_2, self.epsilon, None),
                *decay, _scale_by_trust_ratio(), self._scale_lr()]

    def get_config(self):
        return {"learning_rate": self._lr_config(), "beta_1": self.beta_1,
                "beta_2": self.beta_2, "epsilon": self.epsilon,
                "weight_decay": self.weight_decay, **self._clip_config()}


_OPTIMIZERS = {
    "SGD": SGD, "sgd": SGD,
    "Adam": Adam, "adam": Adam,
    "AdamW": AdamW, "adamw": AdamW,
    "RMSprop": RMSprop, "rmsprop": RMSprop,
    "Adagrad": Adagrad, "adagrad": Adagrad,
    "Adadelta": Adadelta, "adadelta": Adadelta,
    "Nadam": Nadam, "nadam": Nadam,
    "Adafactor": Adafactor, "adafactor": Adafactor,
    "Lion": Lion, "lion": Lion,
    "LAMB": LAMB, "lamb": LAMB,
}


def _lookup(name: str):
    cls = _OPTIMIZERS.get(name)
    if cls is None:
        raise ValueError(f"Unknown optimizer: {name!r}")
    return cls


def serialize(optimizer: Optimizer) -> Dict:
    return {"class_name": type(optimizer).__name__,
            "config": optimizer.get_config()}


def deserialize(config: Dict) -> Optimizer:
    """An optimizer from the JAX package's serialized form,
    ``{"class_name": ..., "config": {...}}``."""
    return _lookup(config["class_name"]).from_config(
        config.get("config", {}))


def opt_state_leaves(state) -> List[torch.Tensor]:
    """An optimizer state's leaves in optax's flatten order, which is
    the order of the JAX package's ``jax.tree_util.tree_leaves(opt_state)``
    for the same optimizer: clipping and a float learning rate
    contribute none (a schedule its count); Adam and AdamW give the step
    count (an int32 0-d tensor, optax's ``count``), then every first
    moment, then every second moment, each in the parameters' leaf
    order; the other rules give their states in optax's field order
    likewise (Adafactor's ``FactoredState`` with its ``(1,)``
    placeholders)."""
    return [torch.tensor(leaf, dtype=torch.int32) if isinstance(leaf, int)
            else leaf for leaf in tree_leaves(state)]


def opt_state_from_leaves(template, leaves) -> Any:
    """The inverse of :func:`opt_state_leaves`: ``template`` (a fresh
    ``init`` of the same transform over the same parameters) with its
    leaves replaced, in order, by ``leaves`` (numpy arrays, bfloat16
    bits as ``|V2``), each in the template leaf's dtype and on its
    device. The count comes back a Python int."""
    from ..utils.checkpoint import tensor_from_host

    ref, treedef = tree_flatten(template)
    if len(ref) != len(leaves):
        raise ValueError(f"{len(leaves)} optimizer-state leaves for a "
                         f"state of {len(ref)}: the optimizers differ")
    out = []
    for like, leaf in zip(ref, leaves):
        out.append(int(leaf) if isinstance(like, int)
                   else tensor_from_host(leaf, like))
    return tree_unflatten(treedef, out)


def get(identifier: Union[str, Dict, Optimizer]) -> Optimizer:
    """Resolve an optimizer from a name, serialized dict or instance."""
    if isinstance(identifier, Optimizer):
        return identifier
    if isinstance(identifier, dict):
        return deserialize(identifier)
    if isinstance(identifier, str):
        return _lookup(identifier)()
    raise ValueError(f"Cannot interpret optimizer: {identifier!r}")
