"""Learning-rate schedules: serializable functions of the step count.

The counterpart of ``elephas_tpu/models/schedules.py``, which lowers
each schedule to an optax schedule. Here each is a plain function of
the step count, ``schedule(count) -> float``, computed in float32 as
the optax schedule computes it. An optimizer evaluates it at optax's
count, the number of updates before this one (0 at the first update),
on the host: the count is a Python int of the optimizer state, so no
device value is read.

A schedule passes as the ``learning_rate`` of any optimizer of
:mod:`~elephas_tpu_torch.models.optimizers` and serializes to the JAX
package's ``{"class_name", "config"}`` form, so a scheduled optimizer
config crosses between the packages.
"""
from typing import Dict, List, Union

import numpy as np

__all__ = ["LearningRateSchedule", "ExponentialDecay", "CosineDecay",
           "PiecewiseConstantDecay", "WarmupCosine", "serialize",
           "deserialize", "get"]

_f32 = np.float32


def _cosine(init: float, decay_steps: int, alpha: float, count: int):
    """``optax.cosine_decay_schedule(init, decay_steps, alpha)(count)``."""
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay_steps}.")
    c = _f32(min(count, decay_steps))
    cosine = _f32(0.5) * (_f32(1) + np.cos(_f32(np.pi) * c
                                           / _f32(decay_steps)))
    return _f32(init) * (_f32(1 - alpha) * cosine + _f32(alpha))


class LearningRateSchedule:
    """Base class: a named hyperparameter bundle, callable on the step
    count."""

    def __call__(self, step: int) -> float:
        raise NotImplementedError

    def get_config(self) -> Dict:
        raise NotImplementedError

    @classmethod
    def from_config(cls, config: Dict) -> "LearningRateSchedule":
        return cls(**config)


class ExponentialDecay(LearningRateSchedule):
    """``lr = initial * decay_rate ** (step / decay_steps)``
    (``staircase`` floors the exponent)."""

    def __init__(self, initial_learning_rate: float, decay_steps: int,
                 decay_rate: float, staircase: bool = False):
        self.initial_learning_rate = float(initial_learning_rate)
        self.decay_steps = int(decay_steps)
        self.decay_rate = float(decay_rate)
        self.staircase = bool(staircase)

    def __call__(self, step: int) -> float:
        init = self.initial_learning_rate
        if self.decay_steps <= 0 or self.decay_rate == 0:
            return init  # optax's constant schedule
        if step <= 0:
            return float(_f32(init))
        p = _f32(step) / _f32(self.decay_steps)
        if self.staircase:
            p = np.floor(p)
        return float(_f32(init) * np.power(_f32(self.decay_rate), p))

    def get_config(self):
        return {"initial_learning_rate": self.initial_learning_rate,
                "decay_steps": self.decay_steps,
                "decay_rate": self.decay_rate,
                "staircase": self.staircase}


class CosineDecay(LearningRateSchedule):
    """Cosine anneal from the initial rate to ``alpha * initial`` over
    ``decay_steps``."""

    def __init__(self, initial_learning_rate: float, decay_steps: int,
                 alpha: float = 0.0):
        self.initial_learning_rate = float(initial_learning_rate)
        self.decay_steps = int(decay_steps)
        self.alpha = float(alpha)

    def __call__(self, step: int) -> float:
        return float(_cosine(self.initial_learning_rate, self.decay_steps,
                             self.alpha, step))

    def get_config(self):
        return {"initial_learning_rate": self.initial_learning_rate,
                "decay_steps": self.decay_steps, "alpha": self.alpha}


class PiecewiseConstantDecay(LearningRateSchedule):
    """``values[i]`` while ``step <= boundaries[i]``, the last value past
    the last boundary (``len(values) == len(boundaries) + 1``)."""

    def __init__(self, boundaries: List[int], values: List[float]):
        if len(values) != len(boundaries) + 1:
            raise ValueError("need len(values) == len(boundaries) + 1")
        self.boundaries = [int(b) for b in boundaries]
        self.values = [float(v) for v in values]

    def __call__(self, step: int) -> float:
        return float(_f32(self.values[sum(step > b
                                          for b in self.boundaries)]))

    def get_config(self):
        return {"boundaries": self.boundaries, "values": self.values}


class WarmupCosine(LearningRateSchedule):
    """Linear warmup from 0 to ``peak_learning_rate`` over
    ``warmup_steps``, then cosine decay to ``end_learning_rate`` by
    ``decay_steps`` (optax's ``warmup_cosine_decay_schedule``)."""

    def __init__(self, peak_learning_rate: float, warmup_steps: int,
                 decay_steps: int, end_learning_rate: float = 0.0):
        self.peak_learning_rate = float(peak_learning_rate)
        self.warmup_steps = int(warmup_steps)
        self.decay_steps = int(decay_steps)
        self.end_learning_rate = float(end_learning_rate)

    def __call__(self, step: int) -> float:
        peak, warmup = self.peak_learning_rate, self.warmup_steps
        alpha = 0.0 if peak == 0.0 else self.end_learning_rate / peak
        # optax evaluates both pieces and selects
        after = _cosine(peak, self.decay_steps - warmup, alpha,
                        step - warmup)
        if step >= warmup:
            return float(after)
        if warmup <= 0:
            return 0.0
        frac = _f32(1) - _f32(min(max(step, 0), warmup)) / _f32(warmup)
        return float(_f32(-peak) * frac + _f32(peak))

    def get_config(self):
        return {"peak_learning_rate": self.peak_learning_rate,
                "warmup_steps": self.warmup_steps,
                "decay_steps": self.decay_steps,
                "end_learning_rate": self.end_learning_rate}


_SCHEDULES = {cls.__name__: cls for cls in
              (ExponentialDecay, CosineDecay, PiecewiseConstantDecay,
               WarmupCosine)}


def serialize(schedule: LearningRateSchedule) -> Dict:
    return {"class_name": type(schedule).__name__,
            "config": schedule.get_config()}


def deserialize(config: Dict) -> LearningRateSchedule:
    cls = _SCHEDULES.get(config.get("class_name"))
    if cls is None:
        raise ValueError(f"Unknown schedule: {config.get('class_name')!r}")
    return cls.from_config(config.get("config", {}))


def get(identifier: Union[Dict, LearningRateSchedule]
        ) -> LearningRateSchedule:
    if isinstance(identifier, LearningRateSchedule):
        return identifier
    if isinstance(identifier, dict):
        return deserialize(identifier)
    raise ValueError(f"Cannot interpret schedule: {identifier!r}")
