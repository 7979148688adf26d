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

``optax.adamw(3e-4)`` (the JAX bench's optimizer) is
``AdamW(3e-4, epsilon=1e-8, weight_decay=1e-4, decay_1d=True)`` here.

A transform takes any tree of tensors (nested dicts in JAX leaf order,
lists, tuples) and returns updates in the structure of ``grads``; the
state holds flat lists in leaf order. ``serialize``/``deserialize`` use
the JAX package's ``{"class_name", "config"}`` form, so an optimizer
config crosses between the packages. Learning-rate schedules and the
other optimizers of the JAX package (Adagrad, Adadelta, Nadam,
Adafactor, Lion, LAMB) are not ported yet and raise.
"""
from typing import Callable, Dict, List, NamedTuple, Optional, Union

import torch

from ..weights import tree_flatten, tree_leaves, tree_unflatten

__all__ = ["Transform", "Optimizer", "SGD", "Adam", "AdamW", "RMSprop",
           "get", "serialize", "deserialize"]

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
                   mu_dtype: Optional[torch.dtype]) -> Transform:
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
        out = [(m / c1) / (torch.sqrt(n / c2) + eps)
               for m, n in zip(mu, nu)]
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


def _coerce_lr(learning_rate) -> float:
    if isinstance(learning_rate, (int, float)):
        return float(learning_rate)
    raise NotImplementedError("learning-rate schedules are not ported yet; "
                              "pass a float")


def _dtype_name(dtype) -> Optional[str]:
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(dtype)


class Optimizer:
    """Base class: a named hyperparameter bundle lowering to a
    :class:`Transform`."""

    def __init__(self, learning_rate: float = 0.01, clipnorm=None,
                 clipvalue=None):
        self.learning_rate = _coerce_lr(learning_rate)
        self.clipnorm = float(clipnorm) if clipnorm is not None else None
        self.clipvalue = (float(clipvalue) if clipvalue is not None
                          else None)

    def _rule(self) -> List[Transform]:
        raise NotImplementedError

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
        return rule + [_scale(-self.learning_rate)]

    def get_config(self):
        return {"learning_rate": self.learning_rate,
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

    def _adam(self) -> Transform:
        mu = None if self.mu_dtype is None else getattr(torch, self.mu_dtype)
        return _scale_by_adam(self.beta_1, self.beta_2, self.epsilon, mu)

    def _rule(self):
        return [self._adam(), _scale(-self.learning_rate)]

    def get_config(self):
        return {"learning_rate": self.learning_rate, "beta_1": self.beta_1,
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
                _scale(-self.learning_rate)]

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
        rule = [_scale_by_rms(self.rho, self.epsilon),
                _scale(-self.learning_rate)]
        return rule + ([_trace(self.momentum, False)] if self.momentum
                       else [])

    def get_config(self):
        return {"learning_rate": self.learning_rate, "rho": self.rho,
                "momentum": self.momentum, "epsilon": self.epsilon,
                **self._clip_config()}


_OPTIMIZERS = {"SGD": SGD, "sgd": SGD, "Adam": Adam, "adam": Adam,
               "AdamW": AdamW, "adamw": AdamW, "RMSprop": RMSprop,
               "rmsprop": RMSprop}
#: names the JAX package knows that this port does not carry yet
_NOT_PORTED = {"Adagrad", "Adadelta", "Nadam", "Adafactor", "Lion", "LAMB"}


def _lookup(name: str):
    cls = _OPTIMIZERS.get(name)
    if cls is not None:
        return cls
    if name in _NOT_PORTED or name in {n.lower() for n in _NOT_PORTED}:
        raise NotImplementedError(f"optimizer {name!r} is not ported yet "
                                  "(ROADMAP Queue 1 item 3)")
    raise ValueError(f"Unknown optimizer: {name!r}")


def serialize(optimizer: Optimizer) -> Dict:
    return {"class_name": type(optimizer).__name__,
            "config": optimizer.get_config()}


def deserialize(config: Dict) -> Optimizer:
    """An optimizer from the JAX package's serialized form,
    ``{"class_name": ..., "config": {...}}``."""
    return _lookup(config["class_name"]).from_config(
        config.get("config", {}))


def get(identifier: Union[str, Dict, Optimizer]) -> Optimizer:
    """Resolve an optimizer from a name, serialized dict or instance."""
    if isinstance(identifier, Optimizer):
        return identifier
    if isinstance(identifier, dict):
        return deserialize(identifier)
    if isinstance(identifier, str):
        return _lookup(identifier)()
    raise ValueError(f"Cannot interpret optimizer: {identifier!r}")
