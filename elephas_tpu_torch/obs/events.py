"""Structured event log + per-request flight recorder.

Metrics (:mod:`.metrics`) answer "how much / how fast, in aggregate";
this module answers "what happened to *this* request". Two pieces:

- :class:`EventLog` — a thread-safe, dependency-free structured log:
  a bounded in-memory ring of ``{"event", "at", "trace_id", ...attrs}``
  dicts plus an optional JSONL sink. Every event is stamped with the
  active trace id (:func:`~.context.current_trace_id`; ``None`` when no
  context is installed), which is what makes a fault injection, a PS
  RPC, and a serving anomaly joinable after the fact (the Pivot
  Tracing insight: events that carry the request's identity make
  aggregates attributable). A per-process default instance
  (:func:`default_event_log`) backs the module-level :func:`emit` /
  :func:`recent_events` — the analog of the default metrics registry.

- :class:`FlightRecorder` — a bounded map of request id → lifecycle
  timeline, kept by the serving engines: queued, admitted (with queue
  wait), prefill (with duration), sampled decode steps, and the
  terminal outcome (finished / expired / timed_out / cancelled). Every
  event carries the trace id captured at submit, so the timeline the
  serving server exposes at ``GET /v1/requests/<id>/trace`` joins
  slow-span ring entries, fault events, and PS RPC events on one id.

Both structures are rings: oldest entries fall off, memory is bounded
by construction, and losing ancient history is the intended trade — the
operator's question is "what happened just now", not "ever".

Copied into the port from ``elephas_tpu/obs/events.py``
(host-only: no JAX); its relative imports resolve to the port's own
copies.
"""
import json
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional

from .context import current_trace_id

__all__ = ["EventLog", "FlightRecorder", "default_event_log", "emit",
           "recent_events", "clear_events", "EVENT_RING_SIZE"]

#: default event-ring capacity (per EventLog instance)
EVENT_RING_SIZE = 2048


class EventLog:
    """Bounded in-memory structured event ring with an optional JSONL
    sink.

    :param capacity: ring size — the newest ``capacity`` events are
        retained, oldest fall off.
    :param sink_path: when set, every event is also appended to this
        file as one JSON line (best-effort: a full disk or revoked
        permission disables the sink rather than failing emitters).
    :param sink_max_bytes: byte budget for the sink file. When an
        append would push it past the budget, the file rolls over ONCE
        to ``<sink_path>.1`` (replacing any previous rollover) and a
        fresh file starts — under sustained traffic disk usage is
        bounded by ~2x the budget instead of growing forever. ``None``
        (the default) keeps the old unbounded behavior. Rotation
        failures follow the sink contract: disable, never fail the
        emitter.
    """

    def __init__(self, capacity: int = EVENT_RING_SIZE,
                 sink_path: Optional[str] = None,
                 sink_max_bytes: Optional[int] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if sink_max_bytes is not None and sink_max_bytes < 1:
            raise ValueError(f"sink_max_bytes must be None or >= 1, "
                             f"got {sink_max_bytes}")
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=int(capacity))
        self._sink_path = sink_path
        self._sink_max_bytes = (None if sink_max_bytes is None
                                else int(sink_max_bytes))
        self._sink_bytes = 0      # bytes written to the CURRENT file
        self._sink = None

    def emit(self, event: str, **attrs) -> Dict:
        """Record one event, stamped with the wall time and the active
        trace id (``None`` outside any context; pass ``trace_id=...``
        explicitly to stamp on behalf of another request — the flight
        recorder does, since engine-loop threads run without the
        request's context installed)."""
        record = {"event": str(event), "at": time.time(),
                  "trace_id": attrs.pop("trace_id", current_trace_id())}
        record.update(attrs)
        # one locked section covers both the ring append and the sink
        # write, so the JSONL file and recent() can never disagree on
        # event order
        with self._lock:
            self._ring.append(record)
            if self._sink_path is not None:
                line = self._sink_line(record)
                if line is not None:
                    self._write_sink_locked(line)
        return record

    def _sink_line(self, record: Dict) -> Optional[str]:
        try:
            return json.dumps(record, default=str)
        except (TypeError, ValueError):
            return None  # an unserializable attr must not kill the emitter

    def _write_sink_locked(self, line: str) -> None:
        # lazily opened, line-buffered append; any OSError permanently
        # disables the sink (the in-memory ring keeps working)
        try:
            if self._sink is None:
                self._sink = open(self._sink_path, "a",
                                  encoding="utf8", buffering=1)
                # resuming an existing file: respect what it already
                # holds, or the budget resets on every process restart
                self._sink_bytes = self._sink.tell()
            data = line + "\n"
            nbytes = len(data.encode("utf8"))
            if (self._sink_max_bytes is not None and self._sink_bytes
                    and self._sink_bytes + nbytes
                    > self._sink_max_bytes):
                self._rotate_sink_locked()
            self._sink.write(data)
            self._sink_bytes += nbytes
        except OSError:
            self._sink_path = None
            try:
                if self._sink is not None:
                    self._sink.close()
            except OSError:
                pass
            self._sink = None

    def _rotate_sink_locked(self) -> None:
        """Single ``.1`` rollover: the full file becomes
        ``<sink_path>.1`` (clobbering the previous rollover — one
        generation of history is the budget's contract) and a fresh
        file opens. Raises OSError to the caller's disable path on
        failure; the current-file byte count only resets once the
        fresh file is actually open."""
        import os

        self._sink.close()
        self._sink = None
        os.replace(self._sink_path, self._sink_path + ".1")
        self._sink = open(self._sink_path, "a", encoding="utf8",
                          buffering=1)
        self._sink_bytes = 0

    def recent(self, event: Optional[str] = None,
               trace_id: Optional[str] = None) -> List[Dict]:
        """Newest-last events, optionally filtered by event name and/or
        trace id — ``recent(trace_id=...)`` is the in-process "show me
        everything this request touched" query."""
        with self._lock:
            items = list(self._ring)
        return [e for e in items
                if (event is None or e["event"] == event)
                and (trace_id is None or e["trace_id"] == trace_id)]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def close(self) -> None:
        """Close the JSONL sink (the ring stays usable)."""
        with self._lock:
            if self._sink is not None:
                try:
                    self._sink.close()
                except OSError:
                    pass
                self._sink = None


_DEFAULT = EventLog()


def default_event_log() -> EventLog:
    """The per-process event log. Cross-cutting emitters (fault
    injection, PS RPC service, supervisor decisions) land here, the
    same way cross-cutting metrics land in the default registry."""
    return _DEFAULT


def emit(event: str, **attrs) -> Dict:
    """Emit into the process default event log."""
    return _DEFAULT.emit(event, **attrs)


def recent_events(event: Optional[str] = None,
                  trace_id: Optional[str] = None) -> List[Dict]:
    """Read the process default event log."""
    return _DEFAULT.recent(event=event, trace_id=trace_id)


def clear_events() -> None:
    _DEFAULT.clear()


class FlightRecorder:
    """Bounded per-request lifecycle timelines for a serving engine.

    One entry per request id: ``{"id", "trace_id", "events": [...]}``
    where every event is ``{"event", "at", "trace_id", ...attrs}`` —
    the trace id captured when the request was submitted, stamped on
    EVERY event so a timeline read in isolation still names its trace.
    Entries are capped at ``max_requests`` (oldest requests evict
    first, active or not — a recorder is a diagnostic ring, not the
    source of truth) and ``max_events`` events each (decode steps are
    already sampled by the engines; the cap is the backstop against a
    pathological emitter).

    Thread-safe: the serving lock serializes engine calls, but the HTTP
    trace routes read timelines without that lock by design.
    """

    #: timeline events that mean the request's lifecycle ended — an
    #: evicted entry whose LAST event is one of these was "retired",
    #: anything else was still in flight ("active") when truncated
    TERMINAL_EVENTS = frozenset(
        {"finished", "expired", "timed_out", "cancelled", "failed",
         "shed", "resumed_elsewhere"})

    def __init__(self, max_requests: int = 256, max_events: int = 64):
        if max_requests < 1 or max_events < 1:
            raise ValueError("max_requests and max_events must be >= 1")
        self.max_requests = int(max_requests)
        self.max_events = int(max_events)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[int, Dict]" = OrderedDict()
        #: eviction counts by state ("active" | "retired") — silent
        #: truncation otherwise reads as "request never existed"
        self.evictions: Dict[str, int] = {"active": 0, "retired": 0}
        self._eviction_counters: Dict[str, object] = {}

    def bind_eviction_counter(self, family) -> None:
        """Bind a ``flight_recorder_evictions_total`` counter family
        (labelled by ``state``); every future eviction increments the
        matching child alongside the local tally."""
        self._eviction_counters = {
            state: family.labels(state=state)
            for state in ("active", "retired")}

    def _evict_oldest_locked(self) -> None:
        _, entry = self._entries.popitem(last=False)
        events = entry["events"]
        last = events[-1]["event"] if events else None
        state = "retired" if last in self.TERMINAL_EVENTS else "active"
        self.evictions[state] += 1
        counter = self._eviction_counters.get(state)
        if counter is not None:
            counter.inc()

    def start(self, rid: int, trace_id: Optional[str] = None,
              **attrs) -> None:
        """Open a timeline for ``rid`` with its first event
        (``queued``), capturing the active trace id (or the explicit
        one) for every subsequent event."""
        tid = trace_id if trace_id is not None else current_trace_id()
        with self._lock:
            # the monotonic stamp backs age(): wall-clock "at" fields
            # are for humans, durations must survive a clock step
            self._entries[rid] = {"id": rid, "trace_id": tid,
                                  "mono": time.monotonic(),
                                  "events": deque(maxlen=self.max_events)}
            self._entries.move_to_end(rid)
            while len(self._entries) > self.max_requests:
                self._evict_oldest_locked()
        self.record(rid, "queued", **attrs)

    def record(self, rid: int, event: str, **attrs) -> None:
        """Append one event to ``rid``'s timeline (no-op for unknown or
        already-evicted ids — recording must never fail the hot path)."""
        with self._lock:
            entry = self._entries.get(rid)
            if entry is None:
                return
            record = {"event": str(event), "at": time.time(),
                      "trace_id": entry["trace_id"]}
            record.update(attrs)
            entry["events"].append(record)

    def trace_id(self, rid: int) -> Optional[str]:
        with self._lock:
            entry = self._entries.get(rid)
            return None if entry is None else entry["trace_id"]

    def age(self, rid: int) -> Optional[float]:
        """Seconds since ``rid``'s timeline opened (None when unknown)
        — lets engines without their own submit-time bookkeeping derive
        queue-wait durations from the timeline itself. Monotonic, so a
        system clock step cannot produce negative durations."""
        with self._lock:
            entry = self._entries.get(rid)
            if entry is None:
                return None
            return time.monotonic() - entry["mono"]

    def trace(self, rid: int) -> Optional[Dict]:
        """``rid``'s timeline as plain JSON-able data (a copy), or
        None for unknown/evicted ids."""
        with self._lock:
            entry = self._entries.get(rid)
            if entry is None:
                return None
            return {"id": entry["id"], "trace_id": entry["trace_id"],
                    "events": [dict(e) for e in entry["events"]]}

    def recent(self, limit: int = 32) -> List[Dict]:
        """The newest ``limit`` timelines, oldest first."""
        if limit <= 0:
            return []          # [-0:] would be the WHOLE list
        with self._lock:
            rids = list(self._entries)[-int(limit):]
        out = []
        for rid in rids:
            t = self.trace(rid)
            if t is not None:
                out.append(t)
        return out
