"""Engine-loop continuous profiler: where does the loop's wall time go?

The serving engines' ``serving_step_latency_seconds`` says how long a
step took; it cannot say WHY. This module adds per-iteration phase
accounting inside the engine loop — weight-swap apply, admission
scheduling, prefill compute, the decode dispatch, host-side token
emission — published as ``serving_loop_utilization{phase}`` callback
gauges over a rolling window: the fraction of recent wall time each
phase consumed. Time no phase claims (the HTTP server's idle sleep,
lock waits between steps) shows up as ``idle``, so a loop at 95% idle
and a loop at 95% prefill are finally distinguishable on one scrape.

Jit compiles are tracked SEPARATELY in the JAX package
(``serving_jit_compiles_total`` + ``serving_jit_compile_seconds``,
attributed to a ``jit`` phase) from JAX's own monitoring stream. The
port runs eagerly and has no such stream: the two series exist and
stay at zero unless a caller feeds :meth:`LoopProfiler.record_compile`.

Cost: two ``perf_counter`` reads and one uncontended lock acquisition
per section, a handful of sections per engine step. Measured by the
``slo_plane`` bench row at <2% tokens/s against a profiler-less engine
— cheap enough to leave on in production, which is the whole point of a
*continuous* profiler.

Copied into the port from ``elephas_tpu/obs/profiler.py``; its
relative imports resolve to the port's own copies. The one change: the
JAX compile listener is gone (the port never imports JAX), so
``track_jit`` installs nothing.
"""
import threading
import time
import weakref
from collections import deque
from typing import Dict, Optional

from .metrics import MetricsRegistry

__all__ = ["LoopProfiler", "PHASES"]

#: the phase vocabulary (a fixed label domain): ``swap`` = staged
#: weight-swap apply, ``admit`` = admission scheduling (queue pops,
#: capacity math — prefill excluded), ``prefill`` = admission prefill /
#: shipped-KV install, ``decode`` = the device step dispatch, ``emit``
#: = host-side token bookkeeping, ``jit`` = XLA compiles (tracked
#: separately so they never masquerade as the phase they interrupted),
#: ``idle`` = wall time no section claimed.
PHASES = ("swap", "admit", "prefill", "decode", "emit", "jit", "idle")

# the profiler the CURRENT THREAD is running under (engine loops are
# single-threaded by design)
_tls = threading.local()


class _Section:
    """Reusable per-phase context manager (see
    :meth:`LoopProfiler.section`): plain enter/exit, no generator
    machinery, engine-loop thread only."""

    __slots__ = ("_prof", "_phase")

    def __init__(self, prof: "LoopProfiler", phase: str):
        self._prof = prof
        self._phase = phase

    def __enter__(self):
        prof = self._prof
        _tls.profiler = prof    # compiles inside a section attribute
        # correctly even on threads that never tick (a direct
        # submit(admit=True) admission prefill)
        prof._stack.append([self._phase, prof._clock(), 0.0])
        return self

    def __exit__(self, *exc):
        prof = self._prof
        now = prof._clock()
        ph, st, child = prof._stack.pop()
        dur = now - st
        cur = prof._cur
        cur[ph] = cur.get(ph, 0.0) + (dur - child if dur > child
                                      else 0.0)
        if prof._stack:
            prof._stack[-1][2] += dur
        return False


class LoopProfiler:
    """Rolling-window phase accounting for one engine loop.

    The owning loop calls :meth:`tick` once per iteration (the engines
    do it at the top of ``step()``) and wraps its work in
    :meth:`section` blocks. Sections nest; a parent's time EXCLUDES its
    children's, so ``admit`` never double-counts the ``prefill`` it
    contains. Utilization is computed over the iterations of the last
    ``window_s`` seconds: per phase, seconds-in-phase over wall seconds
    — including the idle gap between iterations, which is what makes
    the numbers read as a utilization breakdown instead of a busy-time
    breakdown.

    :param registry: destination for ``serving_loop_utilization{phase}``
        (callback gauges — always live), ``serving_jit_compiles_total``
        and ``serving_jit_compile_seconds``. Normally the engine's own
        registry.
    :param window_s: rolling utilization window. Short enough that a
        compile storm is visible while it is happening; long enough
        that one slow iteration doesn't dominate.
    :param track_jit: kept for the JAX signature; the port has no
        compile listener to attach.
    :param clock: injectable time source for tests.
    """

    def __init__(self, registry: MetricsRegistry,
                 window_s: float = 30.0, track_jit: bool = True,
                 clock=time.perf_counter):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.window_s = float(window_s)
        #: aggregation granularity: iterations fold into ~64 coarse
        #: buckets per window (see tick) — the always-on cost bound
        self._bucket_s = self.window_s / 64.0
        self._clock = clock
        self._lock = threading.Lock()
        self._stack: list = []          # [phase, start, child_seconds]
        self._cur: Dict[str, float] = {}
        self._sections: Dict[str, _Section] = {}
        self._iter_start: Optional[float] = None
        # (t_end, wall_s, {phase: seconds}) per completed iteration
        self._ring: deque = deque()
        self._m_compiles = registry.counter(
            "serving_jit_compiles_total",
            "XLA backend compiles observed on the engine loop (a "
            "post-hot-swap/scale-up storm is visible here instead of "
            "masquerading as decode latency)").labels()
        self._m_compile_s = registry.histogram(
            "serving_jit_compile_seconds",
            "wall time per XLA backend compile on the engine loop"
            ).labels()
        ref = weakref.ref(self)
        fam = registry.gauge(
            "serving_loop_utilization",
            "fraction of recent engine-loop wall time spent per phase "
            "(rolling window; phases sum to <= 1, remainder = idle)",
            labels=("phase",))
        for ph in PHASES:
            fam.labels(phase=ph).set_function(
                lambda ph=ph: (p.utilization().get(ph, 0.0)
                               if (p := ref()) is not None else 0.0))

    # ------------------------------------------------------------ driving
    def tick(self) -> None:
        """Close the previous iteration (its wall time runs up to NOW,
        so inter-iteration idle lands in it) and open a new one. Also
        binds this thread to this profiler for compile attribution.

        Iterations AGGREGATE into coarse time buckets (window/64): a
        kHz engine loop folds ~thousands of iterations into each
        bucket instead of ringing one dict per iteration — per-step
        the common case is a few float adds into the open bucket, and
        the ring stays ~64 entries whatever the step rate (per-
        iteration ringing was measured at ~2-3% tokens/s from
        allocation/GC churn alone; bucketing is what holds the <2%
        budget that keeps the profiler always-on).

        Threading contract: :meth:`tick` / :meth:`section` /
        :meth:`record_compile` belong to the ONE thread driving the
        engine loop (the engine itself is serialized by its owner —
        the server's lock — so this adds no new requirement); only
        the bucket ring is locked."""
        now = self._clock()
        if self._iter_start is not None:
            wall = now - self._iter_start
            if wall > 0:
                cur = self._cur
                with self._lock:
                    ring = self._ring
                    # bucket = [t_start, t_end, wall, iters, {phase: s}]
                    if ring and now - ring[-1][0] < self._bucket_s:
                        b = ring[-1]
                        b[1] = now
                        b[2] += wall
                        b[3] += 1
                        phases = b[4]
                        for ph, s in cur.items():
                            phases[ph] = phases.get(ph, 0.0) + s
                    else:
                        ring.append([now - wall, now, wall, 1,
                                     dict(cur)])
                        self._prune_locked(now)
                cur.clear()
        else:
            # first tick: sections recorded OUTSIDE any iteration (a
            # direct-submit admission before the loop started) have no
            # wall to attribute against — drop them (their compiles
            # stayed counted on the jit series)
            self._cur.clear()
        self._iter_start = now
        _tls.profiler = self

    def section(self, phase: str) -> "_Section":
        """The reusable context manager attributing a block's wall
        time to ``phase`` (exclusive of nested sections and of compile
        time recorded while it ran). One `_Section` object per phase,
        created on first use and reused forever: a plain
        ``__enter__``/``__exit__`` pair costs a fraction of a
        ``@contextmanager`` generator, which at sub-millisecond step
        times is the difference between <1% and ~2% overhead. A phase
        never nests within itself on the single engine-loop thread
        (see :meth:`tick`), so reuse is safe."""
        sec = self._sections.get(phase)
        if sec is None:
            sec = self._sections[phase] = _Section(self, phase)
        return sec

    def record_compile(self, seconds: float) -> None:
        """One XLA compile observed (the JAX listener's entry point;
        callable directly by tests): counted, histogrammed, attributed
        to the ``jit`` phase and excluded from the enclosing section."""
        seconds = float(seconds)
        self._m_compiles.inc()
        self._m_compile_s.observe(seconds)
        self._cur["jit"] = self._cur.get("jit", 0.0) + seconds
        if self._stack:
            self._stack[-1][2] += seconds

    def _prune_locked(self, now: float) -> None:
        while self._ring and self._ring[0][1] < now - self.window_s:
            self._ring.popleft()

    def _window_locked(self, now: float):
        """(total wall, total iterations, {phase: seconds}) over the
        live buckets — call under the lock."""
        self._prune_locked(now)
        wall, iters = 0.0, 0
        phases: Dict[str, float] = {}
        for _, _, w, n, ph in self._ring:
            wall += w
            iters += n
            for k, s in ph.items():
                phases[k] = phases.get(k, 0.0) + s
        return wall, iters, phases

    # ------------------------------------------------------------- reading
    def utilization(self) -> Dict[str, float]:
        """``{phase: fraction}`` over the rolling window (``idle``
        included; empty window → all zeros)."""
        now = self._clock()
        with self._lock:
            wall, _, phases = self._window_locked(now)
        out = {ph: 0.0 for ph in PHASES}
        if wall <= 0:
            return out
        busy = 0.0
        for ph, s in phases.items():
            out[ph] = s / wall
        for ph, f in out.items():
            if ph != "idle":
                busy += f
        out["idle"] = max(0.0, 1.0 - busy)
        return out

    def snapshot(self) -> Dict:
        """JSON-able rolling-window summary for ``/stats``: the
        utilization split plus window coverage and compile totals."""
        now = self._clock()
        with self._lock:
            wall, iters, phases = self._window_locked(now)
        util = self.utilization()
        return {"window_s": self.window_s,
                "iterations": iters,
                "wall_s": round(wall, 6),
                "utilization": {ph: round(f, 6)
                                for ph, f in util.items()},
                "jit_compiles": int(self._m_compiles.value),
                "jit_compile_s": round(self._m_compile_s.sum, 6)}
