"""Hierarchical spans with Dapper-style tail-based retention.

``obs/context.py`` gives every request a W3C trace context and
``obs/trace.py`` records FLAT slow-span samples; this module adds the
missing structure: a :class:`Span` carries a parent span id, so one
request's work — router dispatch, prefill worker, KV wire transfer,
decode engine admission, kvtier promote/demote — assembles into one
TREE rooted at the request. The active :class:`TraceContext`'s
``span_id`` doubles as the *current span id*: :func:`start_span`
installs a child context for the block it wraps, so the existing
``traceparent`` forwarding (router ``_headers()``, disagg KV wire
trace frames, parameter-server clients) propagates parent span ids
across processes for free.

Retention is tail-based (the Dapper/production-tracing pattern the
SNIPPETS exemplars assume): keeping every trace at production rates is
memory nobody has, and the traces worth reading are precisely the bad
ones. :meth:`SpanStore.finish` therefore keeps a full tree only when
the request violated its SLO bound, errored, or ranks among the
slowest-k seen; everything else drops at completion. Retained trace
ids flow into latency-histogram exemplars (``obs/metrics.py``), so a
``/metrics`` p99 bucket links straight to a readable tree on
``GET /debug/traces``.

The whole plane sits behind :func:`set_span_plane_enabled` — the
``trace_plane`` bench row A/Bs tokens/s with it on vs off and holds
the overhead under 2%.

``obs/critical_path.py`` consumes these trees; the stage taxonomy
(``prefill``, ``kv_wire``, ``spill_promote``, ...) lives there.

Copied into the port from ``elephas_tpu/obs/spans.py``
(host-only: no JAX); its relative imports resolve to the port's own
copies.
"""
import threading
import time
from collections import OrderedDict
from contextlib import contextmanager
from typing import Dict, List, Optional

from .context import (TraceContext, current_context, reset_context,
                      set_context)

__all__ = [
    "Span",
    "SpanStore",
    "add_span",
    "current_span_id",
    "default_span_store",
    "set_span_plane_enabled",
    "span_plane_enabled",
    "start_span",
]

#: global switch for the whole span plane (the bench A/B knob). OFF
#: means start_span() degrades to a no-op context manager and
#: add_span()/SpanStore.finish() return immediately.
_enabled = True


def set_span_plane_enabled(on: bool) -> None:
    global _enabled
    _enabled = bool(on)


def span_plane_enabled() -> bool:
    return _enabled


class Span:
    """One timed node of a request's trace tree.

    ``start`` is wall-clock (``time.time()``) so spans recorded in
    different processes line up on one axis; ``duration_s`` is
    measured with ``perf_counter`` where the span is live-timed.
    ``stage`` names the critical-path bucket the interval bills to
    (see ``obs/critical_path.py``); structural spans leave it None
    and attribution walks up to the nearest staged ancestor.
    """

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "stage",
                 "start", "duration_s", "attrs")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str], name: str,
                 stage: Optional[str], start: float, duration_s: float,
                 attrs: Optional[dict] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.stage = stage
        self.start = float(start)
        self.duration_s = float(duration_s)
        self.attrs = dict(attrs or {})

    @property
    def end(self) -> float:
        return self.start + self.duration_s

    def to_dict(self) -> dict:
        d = {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "stage": self.stage,
            "start": self.start,
            "duration_s": self.duration_s,
        }
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Span":
        return cls(d["trace_id"], d["span_id"], d.get("parent_id"),
                   d.get("name", "?"), d.get("stage"),
                   d.get("start", 0.0), d.get("duration_s", 0.0),
                   d.get("attrs"))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Span({self.name!r} stage={self.stage} "
                f"span={self.span_id} parent={self.parent_id} "
                f"dur={self.duration_s:.6f})")


class SpanStore:
    """Bounded per-process span store with tail-based retention.

    Spans accumulate per trace id while the request is in flight
    (bounded: the oldest in-progress trace is evicted — and counted —
    when ``max_traces`` is exceeded). :meth:`finish` is the retention
    decision point: the engine calls it at retirement with the
    request's measured latency/TTFT and outcome, and the tree is
    either moved to the bounded retained ring (reason recorded) or
    dropped.

    Slowest-k is decided against the retained ring itself: a finished
    trace that is slower than the fastest ``slowest_k``-retained one
    displaces it. SLO bounds may be installed by the serving layer
    (``slo_ttft_bound_s`` / ``slo_latency_bound_s``); exceeding either
    marks the finish as violated even when the caller did not.
    """

    def __init__(self, max_traces: int = 256,
                 max_spans_per_trace: int = 256,
                 retain_max: int = 64, slowest_k: int = 8):
        self.max_traces = int(max_traces)
        self.max_spans_per_trace = int(max_spans_per_trace)
        self.retain_max = int(retain_max)
        self.slowest_k = int(slowest_k)
        self.slo_ttft_bound_s: Optional[float] = None
        self.slo_latency_bound_s: Optional[float] = None
        self._lock = threading.Lock()
        # trace_id -> list[Span] for in-flight traces
        self._active: "OrderedDict[str, List[Span]]" = OrderedDict()
        # trace_id -> {"trace_id","reason","latency_s","ttft_s","spans"}
        self._retained: "OrderedDict[str, dict]" = OrderedDict()
        self.finished_total = 0
        self.retained_total: Dict[str, int] = {}
        self.dropped_total = 0
        #: in-flight traces evicted before finish() (store overflow)
        self.evicted_unfinished_total = 0

    # -- recording ---------------------------------------------------
    def add(self, span: Span) -> None:
        if not _enabled:
            return
        with self._lock:
            ret = self._retained.get(span.trace_id)
            if ret is not None:
                # late span for an already-retained trace (e.g. the
                # losing hedge arm still decoding): graft it on
                if len(ret["spans"]) < self.max_spans_per_trace:
                    ret["spans"].append(span)
                return
            spans = self._active.get(span.trace_id)
            if spans is None:
                spans = self._active[span.trace_id] = []
                while len(self._active) > self.max_traces:
                    self._active.popitem(last=False)
                    self.evicted_unfinished_total += 1
            if len(spans) < self.max_spans_per_trace:
                spans.append(span)

    # -- retention ---------------------------------------------------
    def finish(self, trace_id: str, latency_s: Optional[float] = None,
               ttft_s: Optional[float] = None, violated: bool = False,
               errored: bool = False) -> Optional[str]:
        """Decide the fate of ``trace_id``'s tree; returns the
        retention reason, or None if the trace was dropped."""
        if not _enabled:
            return None
        with self._lock:
            spans = self._active.pop(trace_id, None)
            prev = self._retained.get(trace_id)
            if spans is None and prev is None:
                return None
            if self.slo_ttft_bound_s is not None and ttft_s is not None \
                    and ttft_s > self.slo_ttft_bound_s:
                violated = True
            if self.slo_latency_bound_s is not None \
                    and latency_s is not None \
                    and latency_s > self.slo_latency_bound_s:
                violated = True
            if prev is not None:
                # second finish on the same trace (hedged duplicate):
                # merge; the trace stays retained
                if spans:
                    prev["spans"].extend(
                        spans[:self.max_spans_per_trace - len(prev["spans"])])
                if latency_s is not None:
                    prev["latency_s"] = max(prev.get("latency_s") or 0.0,
                                            latency_s)
                return prev["reason"]
            self.finished_total += 1
            reason = None
            if errored:
                reason = "error"
            elif violated:
                reason = "slo_violation"
            elif latency_s is not None and self._is_slowest_k(latency_s):
                reason = "slowest_k"
            if reason is None:
                self.dropped_total += 1
                return None
            self._retain(trace_id, spans or [], reason, latency_s, ttft_s)
            return reason

    def _is_slowest_k(self, latency_s: float) -> bool:
        slow = [r for r in self._retained.values()
                if r["reason"] == "slowest_k"]
        if len(slow) < self.slowest_k:
            return True
        floor = min(slow, key=lambda r: r.get("latency_s") or 0.0)
        if latency_s > (floor.get("latency_s") or 0.0):
            # displace the fastest of the slowest-k
            self._retained.pop(floor["trace_id"], None)
            return True
        return False

    def _retain(self, trace_id: str, spans: List[Span], reason: str,
                latency_s: Optional[float],
                ttft_s: Optional[float]) -> None:
        self._retained[trace_id] = {
            "trace_id": trace_id, "reason": reason,
            "latency_s": latency_s, "ttft_s": ttft_s, "spans": spans,
        }
        self.retained_total[reason] = self.retained_total.get(reason, 0) + 1
        while len(self._retained) > self.retain_max:
            self._retained.popitem(last=False)

    # -- reading -----------------------------------------------------
    def spans_of(self, trace_id: str) -> List[Span]:
        with self._lock:
            ret = self._retained.get(trace_id)
            if ret is not None:
                return list(ret["spans"])
            return list(self._active.get(trace_id, ()))

    def retained(self, limit: int = 0) -> List[dict]:
        """Retained traces, newest first, spans as dicts."""
        with self._lock:
            out = []
            for rec in reversed(self._retained.values()):
                out.append({
                    "trace_id": rec["trace_id"],
                    "reason": rec["reason"],
                    "latency_s": rec["latency_s"],
                    "ttft_s": rec["ttft_s"],
                    "spans": [s.to_dict() for s in rec["spans"]],
                })
                if limit and len(out) >= limit:
                    break
            return out

    def retained_ids(self) -> List[str]:
        with self._lock:
            return list(self._retained.keys())

    def stats(self) -> dict:
        with self._lock:
            return {
                "active_traces": len(self._active),
                "retained_traces": len(self._retained),
                "finished_total": self.finished_total,
                "retained_total": dict(self.retained_total),
                "dropped_total": self.dropped_total,
                "evicted_unfinished_total": self.evicted_unfinished_total,
                "slo_ttft_bound_s": self.slo_ttft_bound_s,
                "slo_latency_bound_s": self.slo_latency_bound_s,
            }

    def clear(self) -> None:
        with self._lock:
            self._active.clear()
            self._retained.clear()


_default_store = SpanStore()


def default_span_store() -> SpanStore:
    """The per-process store every in-process component shares (one
    engine + router + prefill tier in one process -> one tree)."""
    return _default_store


def current_span_id() -> Optional[str]:
    ctx = current_context()
    return None if ctx is None else ctx.span_id


@contextmanager
def start_span(name: str, stage: Optional[str] = None,
               store: Optional[SpanStore] = None, **attrs):
    """Run a block as a child span of the current trace context.

    Installs a child :class:`TraceContext` for the block, so nested
    ``start_span`` calls and any outbound ``traceparent`` header built
    inside parent to THIS span. Without an active context the block
    runs untraced (spans belong to requests; stray background work
    must not mint root traces)."""
    if not _enabled:
        yield None
        return
    parent = current_context()
    if parent is None:
        yield None
        return
    ctx = parent.child()
    token = set_context(ctx)
    t0_wall = time.time()
    t0 = time.perf_counter()
    try:
        yield ctx
    finally:
        dur = time.perf_counter() - t0
        reset_context(token)
        (store or _default_store).add(Span(
            ctx.trace_id, ctx.span_id, parent.span_id, name, stage,
            t0_wall, dur, attrs or None))


def add_span(name: str, start: float, duration_s: float,
             stage: Optional[str] = None,
             ctx: Optional[TraceContext] = None,
             parent_id: Optional[str] = None,
             span_id: Optional[str] = None,
             store: Optional[SpanStore] = None,
             **attrs) -> Optional[str]:
    """Record a span after the fact (for stages measured from
    timestamps rather than wrapped live, e.g. admission wait =
    submit->admit, decode = first token->retirement).

    ``ctx`` defaults to the current context; with neither, no-op.
    ``parent_id`` defaults to the context's span id; pass
    ``span_id=ctx.span_id`` (with an explicit parent) to make the
    context's own id a materialized span. Returns the span id."""
    if not _enabled:
        return None
    if ctx is None:
        ctx = current_context()
    if ctx is None:
        return None
    if span_id is None:
        span_id = ctx.child().span_id
        if parent_id is None:
            parent_id = ctx.span_id
    (store or _default_store).add(Span(
        ctx.trace_id, span_id, parent_id, name, stage,
        start, duration_s, attrs or None))
    return span_id
