"""Step timing: the part of ``elephas_tpu/utils/tracing.py`` that
``TransformerModel.fit_tokens`` and the sync trainers need.

:class:`StepTimer` keeps per-step wall times. The JAX package also
publishes each step to its metrics registry; that waits for the port of
``obs/``.
"""
import time
from typing import List, Optional

__all__ = ["StepTimer"]


class StepTimer:
    """Collects per-step wall times (``durations``, seconds)."""

    def __init__(self):
        self.durations: List[float] = []
        self._start: Optional[float] = None

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self) -> None:
        self.durations.append(time.perf_counter() - self._start)
        self._start = None

    @property
    def total(self) -> float:
        return sum(self.durations)
