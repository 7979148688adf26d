"""Thread-safe, dependency-free metrics registry with Prometheus
text-format exposition.

The repo grew four incompatible ways to count things (supervisor
reports, ``DecodeEngine.stats``, the ``/stats`` JSON route, FaultPlan
hit counts, ``StepTimer``); this module is the one currency they all
convert to. Three metric types, modeled on the Prometheus data model:

- :class:`Counter` — monotonically increasing total (``_total`` names)
- :class:`Gauge` — a value that goes up and down (queue depth); may be
  backed by a zero-arg callback so the live value is read at scrape
  time instead of being pushed on every mutation
- :class:`Histogram` — observations bucketed at fixed boundaries, plus
  a bounded sample window for nearest-rank quantile snapshots (the
  same :func:`percentile` helper ``StepTimer.summary`` uses, so bench
  numbers and production metrics share one percentile definition)

Every metric belongs to a :class:`MetricsRegistry`. Labeled series are
created through ``family.labels(route="/v1/generate", status="200")``;
label cardinality is bounded (:data:`MAX_LABEL_SETS` series per metric)
so a label mistake (request id as a label value) fails loudly instead
of eating memory forever. Each process has a default registry
(:func:`default_registry`) for process-wide telemetry (parameter-server
RPCs, fault injections, training step times); components whose counters
back an exact per-instance surface (``DecodeEngine.stats``) construct
their own injectable instance instead.

``registry.render()`` emits Prometheus exposition text (format 0.0.4):
the ``GET /metrics`` routes on :class:`~elephas_tpu.serving_http.
ServingServer` and the parameter-server HTTP front-end serve it
verbatim, so one fleet scrape config covers training, the parameter
plane, and serving.

No dependencies beyond the stdlib — this must be importable from the
fault-injection layer and the wire clients without dragging anything in.

Copied into the port from ``elephas_tpu/obs/metrics.py``
(host-only: no JAX); its relative imports resolve to the port's own
copies.
"""
import math
import re
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_registry", "percentile", "counter_baseline",
           "since_baseline", "observe_scrape", "DEFAULT_BUCKETS",
           "SCRAPE_SIZE_BUCKETS", "MAX_LABEL_SETS"]

#: latency-oriented default bucket boundaries (seconds) — spans a fast
#: decode step (~1ms) through a multi-second prefill compile
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0)

#: exposition-size bucket boundaries (bytes) for the scrape
#: self-observation histograms — 1 KiB through 4 MiB
SCRAPE_SIZE_BUCKETS = (1 << 10, 4 << 10, 16 << 10, 64 << 10, 256 << 10,
                       1 << 20, 4 << 20)

#: hard bound on distinct label sets per metric family — a label value
#: drawn from an unbounded domain (request id, raw URL) must fail fast,
#: not grow the process forever
MAX_LABEL_SETS = 64

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile: the smallest sample value such that at
    least ``q`` of the sample is <= it (rank ``ceil(q*n)``, 1-based).
    Unlike the old ``durations[n // 2]`` indexing this is unbiased for
    small n — the p50 of two samples is the lower one, not the max.
    """
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    vals = sorted(values)
    if not vals:
        raise ValueError("percentile of an empty sample")
    rank = max(1, math.ceil(q * len(vals)))
    return vals[rank - 1]


def counter_baseline(*metrics) -> Dict[int, float]:
    """``id()``-keyed snapshot of the metrics' current values. A
    component sharing an injected registry snapshots its counters at
    construction so its own stats surface can report per-instance
    deltas (:func:`since_baseline`) while the scraped series keep
    pooled process-lifetime totals — the serving engines' contract."""
    return {id(m): m.value for m in metrics}


def since_baseline(baseline: Dict[int, float], metric) -> float:
    """The metric's growth since :func:`counter_baseline` captured it
    (its full value if it was not in the baseline)."""
    return metric.value - baseline.get(id(metric), 0.0)


def observe_scrape(registry: "MetricsRegistry", site: str,
                   duration_s: float, size_bytes: int) -> None:
    """Self-observation for a ``/metrics`` render call site: exposition
    cost (wall time + text size) recorded into the SAME registry the
    scrape served, labeled by ``site`` so co-resident surfaces
    (serving server, PS front-end, fleet router) stay distinct series.
    A sample naturally lands one scrape late — the render it measures
    already left the building — which is exactly right: the question it
    answers is "is exposition itself getting expensive at this
    cardinality", a trend, not a per-scrape receipt."""
    registry.histogram(
        "obs_scrape_duration_seconds",
        "wall time of one /metrics exposition render, by call site",
        labels=("site",)).labels(site=site).observe(float(duration_s))
    registry.histogram(
        "obs_scrape_size_bytes",
        "exposition text bytes produced per /metrics render, by call "
        "site", labels=("site",),
        buckets=SCRAPE_SIZE_BUCKETS).labels(site=site).observe(
        float(size_bytes))


def _fmt(value: float) -> str:
    """Prometheus sample-value formatting: integral values render
    without a trailing ``.0`` (matches what scrapers emit back).
    NaN/±Inf use the exposition-format literals — one bad observation
    (a user gauge computing 0/0) must not make every scrape raise."""
    f = float(value)
    if math.isnan(f):
        return "NaN"
    if f == math.inf:
        return "+Inf"
    if f == -math.inf:
        return "-Inf"
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _escape_label(value: str) -> str:
    return (value.replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _escape_help(text: str) -> str:
    return text.replace("\\", r"\\").replace("\n", r"\n")


def _labels_text(names: Tuple[str, ...], values: Tuple[str, ...],
                 extra: Optional[Tuple[str, str]] = None) -> str:
    pairs = [(n, v) for n, v in zip(names, values)]
    if extra is not None:
        pairs.append(extra)
    if not pairs:
        return ""
    inner = ",".join(f'{n}="{_escape_label(v)}"' for n, v in pairs)
    return "{" + inner + "}"


class Counter:
    """Monotonic counter. ``inc`` rejects negative amounts."""

    kind = "counter"

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up, got inc({amount})")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _render(self, name, labelnames, labelvalues, lines):
        lines.append(f"{name}{_labels_text(labelnames, labelvalues)} "
                     f"{_fmt(self.value)}")

    def _snapshot(self):
        return {"value": self.value}


class Gauge:
    """A value that moves both ways. ``set_function`` attaches a
    zero-arg callback read at scrape/snapshot time — the idiomatic way
    to export a live queue depth without touching the metric on every
    enqueue/dequeue."""

    kind = "gauge"

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set_function(self, fn: Callable[[], float]) -> "Gauge":
        with self._lock:
            self._fn = fn
        return self

    @property
    def value(self) -> float:
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        try:
            return float(fn())
        except Exception:
            # a broken user callback (0/0, dead object) must not take
            # down every render()/snapshot() — NaN is the exposition
            # format's "no meaningful value"
            return math.nan

    def _render(self, name, labelnames, labelvalues, lines):
        lines.append(f"{name}{_labels_text(labelnames, labelvalues)} "
                     f"{_fmt(self.value)}")

    def _snapshot(self):
        return {"value": self.value}


class Histogram:
    """Observations in fixed cumulative buckets plus sum/count, with a
    bounded window of recent raw samples for :meth:`quantile` snapshots
    (nearest-rank over the window — an estimate of the *recent*
    distribution, which is what a dashboard or a bench wants; the
    buckets carry the full history for real Prometheus quantiles).

    With ``exemplars=True``, each observation made under an active
    trace context (or with an explicit ``trace_id=``) remembers the
    LAST trace id per bucket — a p99 outlier becomes one click from its
    flight-recorder timeline. Exemplars are exposed in
    :meth:`_snapshot` always, and rendered in OpenMetrics exemplar
    syntax only when the caller opts in (``render(exemplars=True)``):
    classic 0.0.4 scrapers must never see the suffix."""

    kind = "histogram"

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS,
                 window: int = 1024, exemplars: bool = False):
        uppers = sorted(float(b) for b in buckets)
        if not uppers:
            raise ValueError("histogram needs at least one bucket bound")
        if len(set(uppers)) != len(uppers):
            raise ValueError(f"duplicate bucket bounds in {buckets}")
        self._uppers = uppers
        self._lock = threading.Lock()
        self._bucket_counts = [0] * (len(uppers) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0
        self._window: Optional[deque] = (deque(maxlen=int(window))
                                         if window else None)
        # bucket index -> {"trace_id", "value", "at"} (last writer wins)
        self._exemplars: Optional[Dict[int, Dict]] = (
            {} if exemplars else None)

    def observe(self, value: float,
                trace_id: Optional[str] = None) -> None:
        value = float(value)
        if self._exemplars is not None and trace_id is None:
            # imported lazily-at-call? No: module-level import would be
            # fine (stdlib-only), but the late lookup keeps the hot
            # path of exemplar-less histograms completely untouched
            from .context import current_trace_id

            trace_id = current_trace_id()
        with self._lock:
            i = 0
            for i, upper in enumerate(self._uppers):
                if value <= upper:
                    break
            else:
                i = len(self._uppers)
            self._bucket_counts[i] += 1
            self._sum += value
            self._count += 1
            if self._window is not None:
                self._window.append(value)
            if self._exemplars is not None and trace_id is not None:
                self._exemplars[i] = {"trace_id": str(trace_id),
                                      "value": value, "at": time.time()}

    @contextmanager
    def time(self):
        """Observe the wall time of the wrapped block."""
        start = time.perf_counter()
        try:
            yield
        finally:
            self.observe(time.perf_counter() - start)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> Optional[float]:
        """Nearest-rank quantile over the recent-sample window (None
        before the first observation). Shares :func:`percentile` with
        ``StepTimer.summary`` by design."""
        with self._lock:
            window = list(self._window) if self._window else []
        if not window:
            return None
        return percentile(window, q)

    def count_le(self, bound: float) -> Tuple[int, int]:
        """``(observations <= bound, total observations)`` read under
        ONE lock — the atomic pair a latency SLO needs (a racing read
        of count then buckets could see more totals than bucketed
        samples and report phantom breaches). ``bound`` should sit on
        a bucket boundary; an off-boundary bound is rounded UP to the
        next one (bucketed data cannot resolve finer, and rounding
        down would silently tighten the objective — over-reporting
        violations)."""
        bound = float(bound)
        with self._lock:
            # cumulative count through the FIRST bucket whose upper
            # covers the bound; a bound above the top finite bucket
            # counts every finite bucket (+Inf samples exceed any
            # finite bound by definition)
            good = 0
            for upper, n in zip(self._uppers, self._bucket_counts):
                good += n
                if upper >= bound - 1e-12:
                    break
            return good, self._count

    def _render(self, name, labelnames, labelvalues, lines,
                exemplars: bool = False):
        with self._lock:
            counts = list(self._bucket_counts)
            total, sum_ = self._count, self._sum
            ex = (dict(self._exemplars)
                  if exemplars and self._exemplars else {})
        cum = 0
        for i, (upper, n) in enumerate(zip(self._uppers, counts)):
            cum += n
            line = (f"{name}_bucket"
                    f"{_labels_text(labelnames, labelvalues, ('le', _fmt(upper)))}"
                    f" {cum}")
            e = ex.get(i)
            if e is not None:
                # OpenMetrics exemplar syntax (opt-in — see class doc)
                line += (f' # {{trace_id="{_escape_label(e["trace_id"])}"'
                         f'}} {_fmt(e["value"])} {repr(e["at"])}')
            lines.append(line)
        line = (f"{name}_bucket"
                f"{_labels_text(labelnames, labelvalues, ('le', '+Inf'))}"
                f" {total}")
        e = ex.get(len(self._uppers))
        if e is not None:
            line += (f' # {{trace_id="{_escape_label(e["trace_id"])}"'
                     f'}} {_fmt(e["value"])} {repr(e["at"])}')
        lines.append(line)
        base = _labels_text(labelnames, labelvalues)
        lines.append(f"{name}_sum{base} {_fmt(sum_)}")
        lines.append(f"{name}_count{base} {total}")

    def _snapshot(self):
        with self._lock:
            counts = list(self._bucket_counts)
            total, sum_ = self._count, self._sum
            ex = dict(self._exemplars) if self._exemplars else None
        out = {"count": total, "sum": sum_,
               "buckets": {_fmt(u): c
                           for u, c in zip(self._uppers, counts)},
               "buckets_inf": counts[-1]}
        if ex:
            uppers = self._uppers + [math.inf]
            out["exemplars"] = {_fmt(uppers[i]): e
                                for i, e in sorted(ex.items())}
        p50, p99 = self.quantile(0.5), self.quantile(0.99)
        if p50 is not None:
            out["p50"] = p50
            out["p99"] = p99
        return out


class MetricFamily:
    """One named metric and its labeled children. With no label names
    the family proxies straight to a single default child, so
    ``registry.counter("x_total").inc()`` just works."""

    def __init__(self, name: str, help_text: str,
                 labelnames: Tuple[str, ...], factory: Callable[[], object],
                 kind: str, spec: Optional[tuple] = None):
        self.name = name
        self.help = help_text
        self.labelnames = labelnames
        self.kind = kind
        #: kind-specific construction parameters (histogram buckets +
        #: window) — compared on re-registration so a conflicting spec
        #: fails loudly instead of silently keeping the first one's
        self.spec = spec
        self._factory = factory
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}

    def labels(self, **labelvalues):
        """The child series for this label set (created on first use).
        Raises once the family holds :data:`MAX_LABEL_SETS` distinct
        label sets — unbounded label domains are a bug, not a workload."""
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} takes labels "
                f"{list(self.labelnames)}, got {sorted(labelvalues)}")
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if len(self._children) >= MAX_LABEL_SETS:
                    raise ValueError(
                        f"metric {self.name!r} would exceed "
                        f"{MAX_LABEL_SETS} label sets with "
                        f"{dict(zip(self.labelnames, key))!r} — a label "
                        "value is probably drawn from an unbounded "
                        "domain (request id, raw path); normalize it")
                child = self._factory()
                self._children[key] = child
        return child

    # ------------------------------------------------ label-less proxying
    def _default(self):
        if self.labelnames:
            raise ValueError(
                f"metric {self.name!r} has labels "
                f"{list(self.labelnames)}; call .labels(...) first")
        with self._lock:
            child = self._children.get(())
            if child is None:
                child = self._children[()] = self._factory()
        return child

    def inc(self, amount: float = 1.0):
        return self._default().inc(amount)

    def dec(self, amount: float = 1.0):
        return self._default().dec(amount)

    def set(self, value: float):
        return self._default().set(value)

    def set_function(self, fn: Callable[[], float]):
        self._default().set_function(fn)
        return self

    def observe(self, value: float, trace_id: Optional[str] = None):
        return self._default().observe(value, trace_id=trace_id)

    def time(self):
        return self._default().time()

    def quantile(self, q: float):
        return self._default().quantile(q)

    @property
    def value(self):
        return self._default().value

    @property
    def count(self):
        return self._default().count

    @property
    def sum(self):
        return self._default().sum

    def series(self) -> Dict[Tuple[str, ...], object]:
        """Snapshot of label-values -> child (for tests/snapshot)."""
        with self._lock:
            return dict(self._children)

    def _render(self, lines: List[str], exemplars: bool = False):
        lines.append(f"# HELP {self.name} {_escape_help(self.help)}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        for key, child in sorted(self.series().items()):
            if self.kind == "histogram":
                child._render(self.name, self.labelnames, key, lines,
                              exemplars=exemplars)
            else:
                child._render(self.name, self.labelnames, key, lines)


class MetricsRegistry:
    """A namespace of metric families. Re-requesting a name returns the
    existing family when the type and label names match (so hot paths
    can look metrics up by name instead of threading handles around) and
    raises on a conflicting redefinition."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, MetricFamily] = {}

    # -------------------------------------------------------- constructors
    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> MetricFamily:
        return self._register(name, help, labels, Counter, "counter")

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> MetricFamily:
        return self._register(name, help, labels, Gauge, "gauge")

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  window: int = 1024,
                  exemplars: bool = False) -> MetricFamily:
        spec = (tuple(float(b) for b in buckets), int(window),
                bool(exemplars))
        return self._register(
            name, help, labels,
            lambda: Histogram(buckets=buckets, window=window,
                              exemplars=exemplars), "histogram",
            spec=spec)

    def _register(self, name, help_text, labelnames, factory, kind,
                  spec=None):
        if not _NAME_RE.match(name or ""):
            raise ValueError(f"invalid metric name {name!r}")
        labelnames = tuple(labelnames)
        for ln in labelnames:
            if not _LABEL_RE.match(ln) or ln.startswith("__"):
                raise ValueError(f"invalid label name {ln!r} "
                                 f"for metric {name!r}")
        if kind == "histogram" and "le" in labelnames:
            raise ValueError("'le' is reserved for histogram buckets")
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind} with labels {list(fam.labelnames)}; "
                        f"cannot re-register as {kind} with labels "
                        f"{list(labelnames)}")
                if fam.spec != spec:
                    # a histogram whose caller asked for different
                    # buckets/window would silently get the first
                    # registrant's — its quantiles would be garbage
                    raise ValueError(
                        f"metric {name!r} already registered with "
                        f"parameters {fam.spec}; cannot re-register "
                        f"with {spec}")
                return fam
            fam = MetricFamily(name, help_text, labelnames, factory, kind,
                               spec=spec)
            self._families[name] = fam
            return fam

    # ------------------------------------------------------------- access
    def get(self, name: str) -> Optional[MetricFamily]:
        with self._lock:
            return self._families.get(name)

    def families(self) -> List[MetricFamily]:
        with self._lock:
            return [self._families[n] for n in sorted(self._families)]

    # --------------------------------------------------------- exposition
    def render(self, exemplars: bool = False) -> str:
        """Prometheus text exposition (format 0.0.4) of every family,
        name-sorted for deterministic scrapes/diffs. ``exemplars=True``
        appends OpenMetrics exemplar suffixes on buckets of histograms
        registered with ``exemplars=True`` — opt-in because the suffix
        is not part of the classic 0.0.4 grammar."""
        lines: List[str] = []
        for fam in self.families():
            fam._render(lines, exemplars=exemplars)
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> Dict[str, Dict]:
        """JSON-able dump of every series — what ``bench.py`` embeds in
        its BENCH record so perf trajectories carry distributions, not
        just scalars."""
        out: Dict[str, Dict] = {}
        for fam in self.families():
            series = []
            for key, child in sorted(fam.series().items()):
                entry = {"labels": dict(zip(fam.labelnames, key))}
                entry.update(child._snapshot())
                series.append(entry)
            out[fam.name] = {"type": fam.kind, "help": fam.help,
                             "series": series}
        return out


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The per-process registry. Cross-cutting telemetry (parameter
    plane, fault injections, training step times) lands here; serving
    engines default to their own injectable registries because their
    counters back an exact per-engine ``stats`` surface."""
    return _DEFAULT
