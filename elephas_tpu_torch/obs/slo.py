"""Declarative serving SLOs evaluated as multi-window burn rates.

The autoscaler, the canary controller, and any human operator each
need the same answer — "is this replica meeting its objectives?" — and
before this module each re-derived it privately from raw counters.
This is the one shared derivation: a few declarative
:class:`SLOObjective`\\ s (availability, TTFT tail, shed rate) evaluated
off the engine's EXISTING registry (no new instrumentation duty on the
hot path), with alerting by the multi-window burn-rate method of the
Google SRE workbook.

**Burn rate**: over a trailing window, the fraction of requests that
violated the objective divided by the error budget (``1 - target``).
Burn 1.0 = spending budget exactly at the sustainable rate; burn 10 =
ten times too fast. An alert FIRES only when both the fast window
(minutes — is it happening *now*?) and the slow window (is it
*sustained*?) exceed the threshold, which is what kills the two classic
failure modes of threshold alerting: the single blip that pages at 3am
(fast-only) and the slow leak nobody notices (slow-only). Recovery is
judged on the fast window alone — the slow window stays polluted long
after the incident ends, and holding the alert on it would mask a
relapse. A window holding NO new samples yields no verdict at all
(burn ``None``) and the state machine HOLDS: absence of evidence is
neither an incident nor a recovery, which is what keeps sparse
traffic — request cadence slower than the fast window — from flapping
a live alert off and on between requests.

Transitions are an explicit state machine: ``ok -> firing`` emits one
``slo.burn_rate_exceeded`` event, ``firing -> ok`` one
``slo.recovered`` — each under a fresh trace context so the whole
incident joins on one id in the event log, the canary-rollout
convention. Steady states emit nothing: an alert stream that repeats
itself every evaluation is a log, not an alert.

Latency objectives reduce to availability form — "fraction of requests
with TTFT <= bound" — read straight off the histogram's cumulative
buckets (:meth:`~.metrics.Histogram.count_le`), so the p95 objective
costs one locked bucket scan per evaluation, not a quantile sort.

Per-replica snapshots (:meth:`SLOTracker.status`) ride the replica's
``/stats`` and ``GET /slo``; the fleet membership prober lifts them and
the router's ``GET /slo`` aggregates with worst-replica attribution
(:meth:`~elephas_tpu.fleet.membership.ReplicaMembership.slo_summary`).

Copied into the port from ``elephas_tpu/obs/slo.py``
(host-only: no JAX); its relative imports resolve to the port's own
copies.
"""
import math
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .context import new_root, use_context
from .events import emit as emit_event
from .metrics import MetricsRegistry

__all__ = ["SLOObjective", "SLOTracker"]

#: default counter names for the availability / shed-rate objectives —
#: the serving engines' own families
_GOOD_DEFAULT = "serving_requests_finished_total"
_BAD_DEFAULT = ("serving_requests_shed_total",
                "serving_requests_expired_total",
                "serving_requests_timed_out_total")


class SLOObjective:
    """One objective: a reduction of a registry to ``(good, total)``
    cumulative counts plus a target good-fraction. Use the
    classmethod constructors; the generic ctor exists for custom
    reductions (``reduce_fn(registry) -> (good, total)``)."""

    def __init__(self, name: str, kind: str, target: float,
                 reduce_fn: Callable[[MetricsRegistry],
                                     Tuple[float, float]],
                 detail: Optional[Dict] = None):
        if not 0.0 < float(target) < 1.0:
            raise ValueError(f"target must be in (0, 1), got {target} "
                             f"for objective {name!r} (a target of 1.0 "
                             "has zero error budget — every bad event "
                             "is an infinite burn)")
        self.name = str(name)
        self.kind = str(kind)
        self.target = float(target)
        self._reduce = reduce_fn
        self.detail = dict(detail or {})

    def reduce(self, registry: MetricsRegistry) -> Tuple[float, float]:
        return self._reduce(registry)

    # ------------------------------------------------------- constructors
    @staticmethod
    def _counter_value(registry, name) -> float:
        fam = registry.get(name)
        if fam is None:
            return 0.0
        try:
            return float(fam.labels().value)
        except ValueError:
            # labeled family: sum the children (tenant-labeled sheds)
            return float(sum(c.value for c in fam.series().values()))

    @classmethod
    def availability(cls, name: str = "availability",
                     target: float = 0.999,
                     good: str = _GOOD_DEFAULT,
                     bad: Sequence[str] = _BAD_DEFAULT) -> "SLOObjective":
        """At least ``target`` of terminated requests ended well:
        ``good`` counter vs the sum of ``bad`` counters (sheds,
        queued-deadline expiries, mid-decode timeouts by default)."""
        bad = tuple(bad)

        def reduce_fn(reg):
            g = cls._counter_value(reg, good)
            b = sum(cls._counter_value(reg, n) for n in bad)
            return g, g + b

        return cls(name, "availability", target, reduce_fn,
                   {"good_metric": good, "bad_metrics": list(bad)})

    @classmethod
    def latency(cls, name: str, metric: str, bound_s: float,
                target: float = 0.95) -> "SLOObjective":
        """At least ``target`` of observations in histogram ``metric``
        are <= ``bound_s`` — the budgeted form of "TTFT p95 under
        250 ms". ``bound_s`` should sit on a bucket boundary of the
        histogram (it is effectively rounded up to the next one)."""
        bound_s = float(bound_s)

        def reduce_fn(reg):
            fam = reg.get(metric)
            if fam is None:
                return 0.0, 0.0
            child = fam.labels()
            return child.count_le(bound_s)

        return cls(name, "latency", target, reduce_fn,
                   {"metric": metric, "bound_s": bound_s})

    @classmethod
    def shed_rate(cls, name: str = "shed_rate",
                  max_rate: float = 0.01,
                  shed: str = "serving_requests_shed_total",
                  finished: str = _GOOD_DEFAULT) -> "SLOObjective":
        """Admission sheds stay under ``max_rate`` of terminated
        requests — availability with the budget spelled as the thing
        the operator actually bounds."""
        if not 0.0 < float(max_rate) < 1.0:
            raise ValueError(f"max_rate must be in (0, 1), "
                            f"got {max_rate}")

        def reduce_fn(reg):
            g = cls._counter_value(reg, finished)
            b = cls._counter_value(reg, shed)
            return g, g + b

        return cls(name, "shed_rate", 1.0 - float(max_rate), reduce_fn,
                   {"shed_metric": shed, "max_rate": float(max_rate)})


class SLOTracker:
    """Evaluate objectives as fast/slow burn rates with an alert state
    machine.

    :param objectives: the :class:`SLOObjective` set (names unique).
    :param registry: the registry the objectives READ — and where the
        tracker's own ``slo_burn_rate{objective,window}`` gauges and
        ``slo_alerts_total{objective}`` counter land, so one scrape
        carries the signal and its derivation.
    :param fast_window_s / slow_window_s: the two burn windows. The
        ratio (default 5x) is what separates "blip" from "sustained".
    :param burn_threshold: burn rate both windows must exceed to fire.
        1.0 = alert exactly at budget-spend rate; production typically
        pages somewhere in 2–14x depending on window length.
    :param eval_interval_s: cadence :meth:`maybe_evaluate` honors (the
        serving engine loop calls it every iteration — cheap clock
        check, evaluation only when due).
    :param min_window_samples: minimum events a window's delta must
        hold before its burn rate can TRANSITION the state machine
        (either direction). One bad request in an otherwise-empty
        window is a burn of 1/budget — the classic small-N page — and
        one lucky fast request mid-incident is not a recovery; below
        this floor the evaluation holds the current state. Burn rates
        are still computed and reported regardless.
    :param name: this tracker's identity on events/snapshots (the
        replica name in a fleet).
    :param clock: injectable monotonic time source (tests drive the
        windows without sleeping).
    :param event_log: emit destination (the process default log when
        None — where every other serving event goes).
    """

    def __init__(self, objectives: Sequence[SLOObjective],
                 registry: MetricsRegistry,
                 fast_window_s: float = 60.0,
                 slow_window_s: float = 300.0,
                 burn_threshold: float = 2.0,
                 eval_interval_s: float = 1.0,
                 min_window_samples: int = 2,
                 name: str = "serving",
                 clock=time.monotonic, event_log=None):
        objectives = list(objectives)
        if not objectives:
            raise ValueError("need at least one objective")
        names = [o.name for o in objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"objective names must be unique: {names}")
        if not 0 < float(fast_window_s) <= float(slow_window_s):
            raise ValueError("need 0 < fast_window_s <= slow_window_s")
        if burn_threshold <= 0:
            raise ValueError("burn_threshold must be > 0")
        if min_window_samples < 1:
            raise ValueError("min_window_samples must be >= 1")
        self.min_window_samples = int(min_window_samples)
        self.objectives = objectives
        self.registry = registry
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.burn_threshold = float(burn_threshold)
        self.eval_interval_s = float(eval_interval_s)
        self.name = str(name)
        self._clock = clock
        self._emit = (event_log.emit if event_log is not None
                      else emit_event)
        self._lock = threading.Lock()
        # (t, {objective: (good, total)}) — cumulative samples; pruned
        # past the slow window (one older sample kept as the edge)
        self._ring: deque = deque()
        self._state: Dict[str, Dict] = {
            o.name: {"state": "ok", "alerts": 0, "since": None}
            for o in objectives}
        self._last: Optional[Dict] = None
        self._last_eval: Optional[float] = None
        self._m_burn = registry.gauge(
            "slo_burn_rate",
            "error-budget burn rate per objective and window "
            "(1.0 = spending the budget exactly at the sustainable "
            "rate)", labels=("objective", "window"))
        self._m_alerts = registry.counter(
            "slo_alerts_total",
            "burn-rate alerts fired per objective (each also a "
            "slo.burn_rate_exceeded event)", labels=("objective",))

    # ----------------------------------------------------------- evaluate
    def maybe_evaluate(self) -> Optional[Dict]:
        """:meth:`evaluate` when ``eval_interval_s`` has elapsed since
        the last one; otherwise a no-op returning None. The engine
        loop's per-iteration hook."""
        now = self._clock()
        if (self._last_eval is not None
                and now - self._last_eval < self.eval_interval_s):
            return None
        return self.evaluate()

    def evaluate(self) -> Dict:
        """One evaluation: sample every objective's cumulative
        (good, total), compute fast/slow burn over the sample ring,
        advance the alert state machines, emit transition events (each
        under a fresh trace context), and return the snapshot."""
        now = self._clock()
        vals = {o.name: o.reduce(self.registry)
                for o in self.objectives}
        transitions: List[Tuple[str, SLOObjective, float, float]] = []
        with self._lock:
            self._ring.append((now, vals))
            while (len(self._ring) >= 2
                   and self._ring[1][0] <= now - self.slow_window_s):
                self._ring.popleft()
            objectives: Dict[str, Dict] = {}
            firing: List[str] = []
            for o in self.objectives:
                good, total = vals[o.name]
                fast = self._burn_locked(o, vals, now,
                                         self.fast_window_s)
                slow = self._burn_locked(o, vals, now,
                                         self.slow_window_s)
                st = self._state[o.name]
                thr = self.burn_threshold
                # minimum-evidence gating, both directions: a window
                # whose delta holds no samples (burn None) — or fewer
                # than min_window_samples — HOLDS the current state.
                # Without it, sparse traffic flaps a live alert off on
                # every empty evaluation, one bad request in a quiet
                # window pages at 1/budget burn, and one lucky fast
                # request mid-incident "recovers" a real regression.
                n = self.min_window_samples
                fast_v = (fast[0] if fast is not None
                          and fast[1] >= n else None)
                slow_v = (slow[0] if slow is not None
                          and slow[1] >= n else None)
                if (st["state"] == "ok" and fast_v is not None
                        and slow_v is not None and fast_v >= thr
                        and slow_v >= thr):
                    st["state"] = "firing"
                    st["alerts"] += 1
                    st["since"] = now
                    self._m_alerts.labels(objective=o.name).inc()
                    transitions.append(("slo.burn_rate_exceeded", o,
                                        fast_v, slow_v))
                elif (st["state"] == "firing" and fast_v is not None
                        and fast_v < thr):
                    st["state"] = "ok"
                    st["since"] = now
                    transitions.append(("slo.recovered", o, fast_v,
                                        slow_v))
                self._m_burn.labels(objective=o.name, window="fast").set(
                    math.nan if fast is None else fast[0])
                self._m_burn.labels(objective=o.name, window="slow").set(
                    math.nan if slow is None else slow[0])
                if st["state"] == "firing":
                    firing.append(o.name)
                objectives[o.name] = dict(
                    kind=o.kind, target=o.target, state=st["state"],
                    burn_fast=(None if fast is None
                               else round(fast[0], 4)),
                    burn_slow=(None if slow is None
                               else round(slow[0], 4)),
                    threshold=thr, good=good, total=total,
                    alerts=st["alerts"], **o.detail)
            self._last = {"name": self.name,
                          "evaluated_at": time.time(),
                          "fast_window_s": self.fast_window_s,
                          "slow_window_s": self.slow_window_s,
                          "firing": firing,
                          "objectives": objectives}
            self._last_eval = now
            snapshot = self._last
        for event, o, fast, slow in transitions:
            # fresh root per transition: the alert, whatever acts on it
            # (an autoscaler decision, an operator's trace pull), and
            # the recovery all join on queryable ids
            with use_context(new_root()):
                self._emit(event, objective=o.name, kind=o.kind,
                           target=o.target,
                           burn_fast=(None if fast is None
                                      else round(fast, 4)),
                           burn_slow=(None if slow is None
                                      else round(slow, 4)),
                           threshold=self.burn_threshold,
                           source=self.name, **o.detail)
        return snapshot

    def _burn_locked(self, obj: SLOObjective, vals: Dict, now: float,
                     window: float) -> Optional[Tuple[float, float]]:
        """``(burn rate, samples in delta)`` over ``window``: bad
        fraction of the windowed delta over the error budget. The
        reference sample is the newest one at or before the window
        edge (the oldest sample when history is shorter — a young
        tracker burns on what it has seen rather than reporting
        nothing). ``None`` when the window holds no new samples at all
        — the state machine treats that as "no evidence" and holds,
        never as burn 0."""
        ref = None
        for t, sample in self._ring:
            if t <= now - window:
                ref = sample
            else:
                break
        if ref is None:
            ref = self._ring[0][1]
        g0, t0 = ref[obj.name]
        g1, t1 = vals[obj.name]
        dt = t1 - t0
        if dt <= 0:
            return None
        bad_frac = min(1.0, max(0.0, (dt - (g1 - g0)) / dt))
        budget = 1.0 - obj.target
        if budget <= 0:
            return (math.inf if bad_frac > 0 else 0.0), dt
        return bad_frac / budget, dt

    # ------------------------------------------------------------ reading
    def status(self) -> Dict:
        """The last evaluation's snapshot (evaluating once if none has
        happened yet) — the ``/slo`` payload and the ``slo`` block the
        membership prober lifts off ``/stats``."""
        with self._lock:
            last = self._last
        return last if last is not None else self.evaluate()

    def firing(self) -> List[str]:
        """Names of objectives currently in the firing state."""
        with self._lock:
            return [n for n, st in self._state.items()
                    if st["state"] == "firing"]
