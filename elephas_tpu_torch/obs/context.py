"""Distributed trace context: ids, W3C ``traceparent``, propagation.

This is the piece ``obs.trace`` deliberately left out — the *identity*
of a request. A :class:`TraceContext` is a ``(trace_id, span_id)`` pair
in the W3C Trace Context format (32 + 16 lowercase hex digits), carried
across every boundary the framework owns:

- the serving front-end accepts an inbound ``traceparent`` header
  (generating a fresh root when absent or malformed — a bad header must
  never 500) and answers with ``X-Trace-Id``;
- the engines capture the context at ``submit`` and stamp every
  flight-recorder event with it (:mod:`.events`);
- the parameter-plane clients forward it (HTTP header, socket frame
  extension) and the servers restore it, so a PS RPC's events join the
  request that caused it.

Within a process the active context rides a :mod:`contextvars` variable:
it follows the request through nested calls on one thread, never leaks
between concurrent handler threads, and costs one contextvar read when
absent. Threads do NOT inherit it — code that hops threads captures
:func:`current_context` and restores it on the other side
(:class:`~elephas_tpu.parallel.supervisor.WorkerSupervisor` and the
serving engines do exactly that).

No tracing backend is assumed: the ids exist to make in-process
artifacts (flight-recorder timelines, slow-span ring entries, fault
events, PS RPC events) joinable with each other and with whatever
W3C-speaking edge sits in front of the fleet.

Copied into the port from ``elephas_tpu/obs/context.py``
(host-only: no JAX); its relative imports resolve to the port's own
copies.
"""
import contextlib
import contextvars
import os
import re
from typing import Optional

__all__ = ["TraceContext", "current_context", "current_trace_id",
           "set_context", "reset_context", "use_context", "new_root",
           "parse_traceparent", "TRACEPARENT_LEN"]

#: exact length of a version-00 traceparent header value:
#: ``00-<32 hex>-<16 hex>-<2 hex>`` — the socket frame extension relies
#: on this being fixed
TRACEPARENT_LEN = 55

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")

_current: contextvars.ContextVar = contextvars.ContextVar(
    "elephas_tpu_trace_context", default=None)


class TraceContext:
    """One request's identity: ``trace_id`` names the end-to-end
    request, ``span_id`` the current hop, ``flags`` the W3C trace-flags
    byte (bit 0 = sampled; this layer records unconditionally and keeps
    the flags only to round-trip them)."""

    __slots__ = ("trace_id", "span_id", "flags", "parent_id")

    def __init__(self, trace_id: str, span_id: str, flags: int = 1,
                 parent_id: Optional[str] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.flags = int(flags) & 0xFF
        #: span id this hop descends from (None at a root or across a
        #: wire — the remote side's parent is the traceparent's span_id
        #: itself). Not part of the header and excluded from equality;
        #: ``obs.spans`` uses it to parent-link span trees.
        self.parent_id = parent_id

    def to_traceparent(self) -> str:
        """The W3C header value (version 00)."""
        return f"00-{self.trace_id}-{self.span_id}-{self.flags:02x}"

    def child(self) -> "TraceContext":
        """Same trace, fresh span id — the hop a component makes before
        forwarding the context over a wire it owns. The child remembers
        this context's span id as its ``parent_id``."""
        return TraceContext(self.trace_id, os.urandom(8).hex(), self.flags,
                            parent_id=self.span_id)

    def __eq__(self, other):
        return (isinstance(other, TraceContext)
                and self.trace_id == other.trace_id
                and self.span_id == other.span_id
                and self.flags == other.flags)

    def __repr__(self):
        return f"TraceContext({self.to_traceparent()!r})"


def new_root() -> TraceContext:
    """A fresh root context (random non-zero ids)."""
    trace_id = os.urandom(16).hex()
    while trace_id == "0" * 32:          # all-zero ids are invalid per spec
        trace_id = os.urandom(16).hex()
    span_id = os.urandom(8).hex()
    while span_id == "0" * 16:
        span_id = os.urandom(8).hex()
    return TraceContext(trace_id, span_id, 1)


def parse_traceparent(header) -> Optional[TraceContext]:
    """Parse a ``traceparent`` header value; ``None`` for anything
    malformed (wrong shape, uppercase hex, all-zero ids, version ff) —
    the caller starts a new root instead of failing the request."""
    if not isinstance(header, str):
        return None
    m = _TRACEPARENT_RE.match(header.strip())
    if m is None:
        return None
    version, trace_id, span_id, flags = m.groups()
    if version == "ff":                   # forbidden by the spec
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return TraceContext(trace_id, span_id, int(flags, 16))


def current_context() -> Optional[TraceContext]:
    """The active context on this thread/task, or None."""
    return _current.get()


def current_trace_id() -> Optional[str]:
    """Just the active trace id (the stamp events and slow-span ring
    entries carry), or None outside any context."""
    ctx = _current.get()
    return None if ctx is None else ctx.trace_id


def set_context(ctx: Optional[TraceContext]):
    """Install ``ctx`` as the active context; returns a token for
    :func:`reset_context`. Threads don't inherit contextvars, so a
    worker/engine thread restoring a captured context calls this at the
    top of its unit of work."""
    return _current.set(ctx)


def reset_context(token) -> None:
    _current.reset(token)


@contextlib.contextmanager
def use_context(ctx: Optional[TraceContext]):
    """Run the block under ``ctx`` (``None`` = explicitly no context),
    restoring whatever was active before — exception-safe, so a raising
    request can never leak its identity onto the next one handled by
    the same thread."""
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)
