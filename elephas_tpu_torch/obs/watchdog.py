"""Engine-loop watchdog: liveness for the thread that owns the device.

The serving stack's health surfaces all assume the engine loop is
*running*: ``/health`` only flips when the loop **raised**, and the
membership prober only evicts a replica once its ``/ready`` probe
times out ``evict_after`` consecutive times. A loop that is merely
*stuck* — a decode step wedged in a runaway XLA compile, a deadlocked
host callback, a fault-injected stall — passes both for the whole
probe-timeout window while every queued request silently ages out.

This module closes that gap with crash-only discipline, in three
escalating stages:

1. **Detect.** The engine loop calls :meth:`EngineWatchdog.beat` once
   per iteration (idle iterations included — an idle loop still beats
   every idle-sleep, so only a loop genuinely stuck *inside* an
   iteration goes quiet). A monitor thread notices the beat age
   exceeding ``stall_after_s`` and emits a trace-stamped
   ``engine.stalled`` event, with *attribution* read best-effort off
   the engine's :class:`~.profiler.LoopProfiler` — the open section's
   phase and age (``decode`` for a wedged step, ``jit`` for a compile
   storm, ``prefill`` for a pathological prompt), plus the iteration
   age off the profiler's own stamp.
2. **Shed traffic.** ``on_stall`` flips the owning server's ``/ready``
   to 503 ``{"status": "stalled"}``. The replica stays *reachable*, so
   the fleet membership prober evicts it as ``unready`` — draining
   semantics: it keeps its in-flight work (which may yet finish) and
   only new submits route away — instead of waiting out
   ``evict_after`` probe timeouts to declare it dead. A beat arriving
   after the stall emits ``engine.recovered`` (with the measured
   stall length), ``on_recover`` un-flips readiness, and the replica
   rejoins through the normal probe hysteresis.
3. **Abort.** Past the hard bound ``abort_after_s`` the process is no
   longer trusted to recover: ``engine.stall_aborted`` is emitted
   (and the event log's JSONL sink, if any, flushes with it) and
   ``abort_fn`` runs — by default :func:`os._exit`, the crash-only
   exit that turns a zombie into a clean death the replica supervisor
   (``fleet/pool.py``) can see, restart, and re-admit. In-process
   test/bench fleets leave ``abort_after_s=None`` (aborting the
   process would kill every sibling replica sharing it).

Metrics (on the engine's registry): ``serving_engine_stalls_total``,
``serving_engine_stall_seconds`` (per-stall length, observed at
recovery), and the 0/1 ``serving_engine_stalled`` gauge — the series a
burn-rate alert or the fleet prober can read without parsing events.

``docs/sources/serving-operations.md`` ("Surviving replica crashes")
has the runbook: choosing the bounds, what each event means, and how
the supervisor composes with the abort path.

Copied into the port from ``elephas_tpu/obs/watchdog.py``
(host-only: no JAX); its relative imports resolve to the port's own
copies.
"""
import os
import threading
import time
from typing import Callable, Dict, Optional

from .context import new_root, use_context
from .events import emit as emit_event

__all__ = ["EngineWatchdog"]


def _default_abort() -> None:
    # os._exit, not sys.exit: the abort fires on a MONITOR thread while
    # the engine loop is wedged (possibly holding locks, possibly stuck
    # in native code) — unwinding/atexit could block forever, which is
    # exactly the zombie state the hard bound exists to end
    os._exit(70)   # EX_SOFTWARE: internal software error


class EngineWatchdog:
    """Stall detector for one engine loop.

    :param stall_after_s: beat age that declares the loop stalled
        (``engine.stalled`` + ``on_stall``). Set it comfortably above
        the longest *healthy* iteration — a cold-start XLA compile is
        the usual ceiling (tens of seconds on large models), a warm
        fleet's steps are milliseconds.
    :param abort_after_s: beat age past which the process aborts
        (crash-only hard bound). ``None`` (the default) never aborts —
        correct for in-process multi-replica pools where the process
        is shared. Must exceed ``stall_after_s``.
    :param on_stall / on_recover: callbacks fired exactly once per
        stall episode, outside the watchdog lock, with the event's
        attribute dict. The owning server flips its readiness here.
        Exceptions are swallowed — a broken callback must not kill the
        monitor.
    :param registry: metrics destination (normally the engine's own
        registry). ``None`` skips metrics entirely.
    :param profiler: the engine's :class:`~.profiler.LoopProfiler`,
        read best-effort at stall time for phase attribution. Optional.
    :param poll_interval_s: monitor thread cadence (default
        ``stall_after_s / 4``, floored at 10 ms) — detection latency
        is at most one interval past the bound.
    :param clock: injectable monotonic time source for tests.
    :param abort_fn: what the hard bound runs (default
        :func:`os._exit`). Tests inject a recorder.
    """

    def __init__(self, stall_after_s: float = 10.0,
                 abort_after_s: Optional[float] = None,
                 on_stall: Optional[Callable[[Dict], None]] = None,
                 on_recover: Optional[Callable[[Dict], None]] = None,
                 registry=None, profiler=None,
                 poll_interval_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 abort_fn: Callable[[], None] = _default_abort):
        if stall_after_s <= 0:
            raise ValueError(
                f"stall_after_s must be > 0, got {stall_after_s}")
        if abort_after_s is not None and abort_after_s <= stall_after_s:
            raise ValueError(
                f"abort_after_s ({abort_after_s}) must exceed "
                f"stall_after_s ({stall_after_s}) — the soft bound "
                "must get its chance to shed traffic first")
        self.stall_after_s = float(stall_after_s)
        self.abort_after_s = (None if abort_after_s is None
                              else float(abort_after_s))
        self.on_stall = on_stall
        self.on_recover = on_recover
        self.profiler = profiler
        self._clock = clock
        self._abort_fn = abort_fn
        self.poll_interval_s = (max(0.01, self.stall_after_s / 4.0)
                                if poll_interval_s is None
                                else float(poll_interval_s))
        self._lock = threading.Lock()
        self._last_beat: Optional[float] = None   # None until first beat
        self._stalled = False
        self._stalled_since: Optional[float] = None
        self._aborting = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if registry is not None:
            self._m_stalls = registry.counter(
                "serving_engine_stalls_total",
                "engine-loop stall episodes detected by the watchdog "
                "(beat age exceeded stall_after_s)").labels()
            self._m_stall_s = registry.histogram(
                "serving_engine_stall_seconds",
                "length of each engine-loop stall episode, observed "
                "at recovery").labels()
            self._m_stalled = registry.gauge(
                "serving_engine_stalled",
                "1 while the watchdog currently considers the engine "
                "loop stalled, else 0").labels()
            self._m_stalled.set(0.0)
        else:
            self._m_stalls = self._m_stall_s = self._m_stalled = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "EngineWatchdog":
        """Start the monitor thread (idempotent)."""
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="engine-watchdog")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            self.check_once()

    # -------------------------------------------------------------- driving
    def beat(self) -> None:
        """One engine-loop iteration completed — called by the loop
        every pass, idle included (the loop heartbeat is the liveness
        signal; the profiler's ``tick`` only fires inside ``step()``,
        so an idle engine's iteration stamp going stale is healthy).
        The fast path is one clock read and one store; the transition
        path (recovery) locks."""
        now = self._clock()
        self._last_beat = now
        if self._stalled:
            self._recover(now)

    def _recover(self, now: float) -> None:
        with self._lock:
            if not self._stalled:
                return            # a concurrent beat already recovered
            self._stalled = False
            since = self._stalled_since
            self._stalled_since = None
        stalled_for = None if since is None else max(0.0, now - since)
        if self._m_stalled is not None:
            self._m_stalled.set(0.0)
            if stalled_for is not None:
                self._m_stall_s.observe(stalled_for)
        attrs = {"stalled_for_s": (None if stalled_for is None
                                   else round(stalled_for, 6)),
                 "stall_after_s": self.stall_after_s}
        # fresh trace root (the autoscaler convention): control-plane
        # events join the event log on their own queryable id
        with use_context(new_root()):
            emit_event("engine.recovered", **attrs)
        if self.on_recover is not None:
            try:
                self.on_recover(attrs)
            except Exception:  # noqa: BLE001 — a broken callback must
                pass           # not kill the recovery path

    # ------------------------------------------------------------- checking
    def check_once(self, now: Optional[float] = None) -> Optional[str]:
        """One monitor pass (the thread's body; callable directly for
        deterministic tests). Returns ``"stalled"`` / ``"aborted"``
        when this pass transitioned, else ``None``."""
        if now is None:
            now = self._clock()
        last = self._last_beat
        if last is None:
            return None       # loop not started yet: nothing to judge
        age = now - last
        if age <= self.stall_after_s:
            return None
        transitioned = None
        with self._lock:
            if not self._stalled:
                self._stalled = True
                self._stalled_since = last
                transitioned = "stalled"
        if transitioned == "stalled":
            attrs = dict(self._attribution(), beat_age_s=round(age, 6),
                         stall_after_s=self.stall_after_s)
            if self._m_stalls is not None:
                self._m_stalls.inc()
                self._m_stalled.set(1.0)
            with use_context(new_root()):
                emit_event("engine.stalled", **attrs)
            if self.on_stall is not None:
                try:
                    self.on_stall(attrs)
                except Exception:  # noqa: BLE001
                    pass
        if (self.abort_after_s is not None
                and age > self.abort_after_s):
            with self._lock:
                if self._aborting:
                    return transitioned
                self._aborting = True
            with use_context(new_root()):
                emit_event("engine.stall_aborted",
                           beat_age_s=round(age, 6),
                           abort_after_s=self.abort_after_s,
                           **self._attribution())
            self._abort_fn()
            return "aborted"
        return transitioned

    def _attribution(self) -> Dict:
        """Best-effort stall attribution off the profiler: the loop is
        stuck, so its open-section stack is frozen mid-write at worst —
        reads are racy by design and guarded accordingly."""
        out: Dict = {}
        prof = self.profiler
        if prof is None:
            return out
        try:
            # the profiler's OWN clock (perf_counter by default) — its
            # stamps are not comparable to this watchdog's monotonic
            now = prof._clock()
            stack = prof._stack
            if stack:
                phase, started, _ = stack[-1]
                out["phase"] = phase
                out["phase_age_s"] = round(max(0.0, now - started), 6)
            start = prof._iter_start
            if start is not None:
                out["iteration_age_s"] = round(max(0.0, now - start), 6)
        except Exception:  # noqa: BLE001 — attribution is garnish
            pass
        return out

    # -------------------------------------------------------------- reading
    @property
    def stalled(self) -> bool:
        return self._stalled

    def status(self) -> Dict:
        """JSON-able snapshot for ``/stats``."""
        now = self._clock()
        last = self._last_beat
        return {"stalled": self._stalled,
                "beat_age_s": (None if last is None
                               else round(max(0.0, now - last), 6)),
                "stall_after_s": self.stall_after_s,
                "abort_after_s": self.abort_after_s}
