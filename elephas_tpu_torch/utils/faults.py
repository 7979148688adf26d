"""Deterministic fault injection: a seeded plan of failures at named sites.

Chaos testing for the distributed layers without monkeypatching: hot
paths (parameter client transport, PS apply/get, the async worker train
loop) call :func:`fault_site` with a stable site name; a
:class:`FaultPlan` — installed in-process via :func:`install_plan` or
through the ``ELEPHAS_TPU_FAULT_PLAN`` environment variable for spawned
processes — decides, deterministically, whether that particular hit
``drop``-s the message, ``delay``-s it, or ``error``-s out.

Determinism contract: every site keeps a per-plan hit counter, events
trigger on counter windows (``after``/``times``), and probabilistic
events (``p``) draw from a per-site RNG derived from the plan seed — so
the same plan against the same call sequence injects the same faults,
in-process or in a spawned test process.

Instrumented sites (the stable names tests target):

================================ ==============================================
``client.get_parameters``        each pull attempt on the PS client transport
``client.update_parameters``     each delta-push attempt before it is sent
``client.push_ack``              after the server applied a push, before the
                                 client observes the ack (``drop`` = lost ack:
                                 the idempotent-resend scenario)
``ps.get_weights``               each server-side weight read
``ps.apply_delta``               each server-side delta apply (``drop`` =
                                 delta silently discarded)
``worker.train``                 async worker entry, once per (re)start
``worker.epoch``                 each async worker local-epoch boundary
``serving.submit``               each ``DecodeEngine.submit`` admission
                                 attempt (``drop`` = deterministic shed:
                                 rejected as if the queue were full, the
                                 HTTP layer's 429)
``serving.step``                 each ``DecodeEngine.step`` device round
                                 trip (``delay`` = slow step, ``error`` =
                                 engine crash: the serving loop records it
                                 and ``/health`` turns red)
``serving.stream_write``         each streamed response line before its
                                 socket write (``drop`` = line lost on the
                                 wire, ``error`` = mid-stream client
                                 disconnect: the server aborts the request)
``serving.preempt``              each QoS preemption before the victim's
                                 KV parks (``delay`` = a slow park,
                                 ``drop``/``error`` = the parking path
                                 failing: the blocks free instead of
                                 parking and the request still re-queues —
                                 resume recomputes, the client request is
                                 never lost)
``disagg.prefill``               each prefill-worker job before its prefill
                                 runs (``delay`` = a slow prefill — the
                                 burst scenario, ``error`` = a prefill
                                 crash: the job retries on a sibling)
``disagg.ship``                  each KV-frame ship attempt before the
                                 socket write (``error`` = a mid-transfer
                                 failure: the dispatcher re-queues the
                                 prefill, never fails the client request)
================================ ==============================================

**Network chaos sites** (:func:`fault_network`) sit at the socket-level
wire chokepoints and are additionally keyed by *peer* — a
``FaultEvent`` with ``peer="127.0.0.1:8431"`` fires only for calls
whose peer string contains that substring, which is how a one-way
partition or a lagged link targets a single replica:

================================ ==============================================
``net.recv``                     every framed read (``recv_exact``)
``net.send``                     every framed write (``send_payload``)
``net.kv_send``                  every KV-frame write + ack read
``fleet.post_replica``           each router→replica POST attempt
``fleet.get_replica``            each router→replica GET attempt
``fleet.open_stream``            each router→replica stream open
``fleet.probe``                  each membership health probe
``disagg.kv_ship``               each KV shipper transfer, by receiver
================================ ==============================================

Network actions extend the base three: ``delay`` gains a ``jitter``
bound (uniform extra latency from the per-site seeded RNG), ``reset``
closes the socket mid-frame and raises :class:`InjectedReset`, and
``partition`` models a one-way partition: the call blackholes and
surfaces as :class:`InjectedPartition` (a :class:`TimeoutError`) after
``delay`` seconds standing in for the caller's socket-timeout wait —
keeping chaos tests fast while exercising the same exception paths a
real blackhole would. ``drop`` at a network site is the probabilistic
form of the same thing (a dropped frame IS a timeout to the caller),
except at send sites, where the bytes silently vanish.

With no plan installed :func:`fault_site` is a near-free attribute check.

Copied into the port from ``elephas_tpu/utils/faults.py``
(host-only: no JAX); its relative imports resolve to the port's own
copies.
"""
import json
import os
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..obs.events import emit as emit_event
from ..obs.metrics import default_registry

#: environment variable holding a plan for spawned processes: either an
#: inline JSON document or a path to a JSON file
ENV_VAR = "ELEPHAS_TPU_FAULT_PLAN"

_ACTIONS = ("drop", "delay", "error", "reset", "partition")


class InjectedFault(ConnectionError):
    """Raised for ``error`` events (and by call sites translating a
    ``drop`` into a lost request). Subclasses :class:`ConnectionError`
    so the parameter client's transient-retry machinery treats injected
    transport faults exactly like real network failures."""


class InjectedReset(ConnectionResetError):
    """Raised for ``reset`` events: a mid-frame connection reset. The
    socket (when the call site passed one) has already been closed, so
    the peer sees a truncated frame too."""


class InjectedPartition(TimeoutError):
    """Raised for ``partition`` (and network-site ``drop``) events: the
    bytes went into a black hole and the caller's wait surfaced as a
    timeout. Subclasses :class:`TimeoutError` (= ``socket.timeout``),
    which every transient-retry path already treats as retriable."""


class FaultEvent:
    """One scheduled fault: at site ``site``, starting at hit ``after``
    (0-based, per-site counter), for ``times`` consecutive hits
    (``None`` = every hit from ``after`` on), apply ``action``.

    ``p`` (0..1) makes the event probabilistic: eligible hits fire with
    probability ``p`` drawn from the plan's per-site seeded RNG — still
    deterministic for a fixed plan seed and call sequence.

    Network-site extras: ``peer`` restricts the event to calls whose
    peer string contains it (how a partition targets one replica);
    ``jitter`` adds uniform extra latency in ``[0, jitter]`` to a
    ``delay`` event, drawn from the same per-site seeded RNG.
    """

    __slots__ = ("site", "action", "after", "times", "delay", "message",
                 "p", "peer", "jitter")

    def __init__(self, site: str, action: str, after: int = 0,
                 times: Optional[int] = 1, delay: float = 0.05,
                 message: Optional[str] = None, p: Optional[float] = None,
                 peer: Optional[str] = None, jitter: float = 0.0):
        if action not in _ACTIONS:
            raise ValueError(f"action must be one of {_ACTIONS}, "
                             f"got {action!r}")
        if times is not None and times < 1:
            raise ValueError(f"times must be None or >= 1, got {times}")
        if jitter < 0.0:
            raise ValueError(f"jitter must be >= 0, got {jitter}")
        self.site = str(site)
        self.action = action
        self.after = int(after)
        self.times = None if times is None else int(times)
        self.delay = float(delay)
        self.message = message
        self.p = None if p is None else float(p)
        self.peer = None if peer is None else str(peer)
        self.jitter = float(jitter)

    def matches_peer(self, peer: Optional[str]) -> bool:
        """Peer-keyed events require a peer string containing theirs;
        unkeyed events match every call (peer known or not)."""
        if self.peer is None:
            return True
        return peer is not None and self.peer in peer

    def matches(self, hit: int) -> bool:
        """Is per-site hit index ``hit`` inside this event's window?"""
        if hit < self.after:
            return False
        return self.times is None or hit < self.after + self.times

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"site": self.site, "action": self.action}
        if self.after:
            d["after"] = self.after
        if self.times != 1:
            d["times"] = self.times
        if self.action == "delay":
            d["delay"] = self.delay
        if self.message is not None:
            d["message"] = self.message
        if self.p is not None:
            d["p"] = self.p
        if self.peer is not None:
            d["peer"] = self.peer
        if self.jitter:
            d["jitter"] = self.jitter
        if self.action == "partition":
            d["delay"] = self.delay
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultEvent":
        return cls(d["site"], d["action"], after=d.get("after", 0),
                   times=d.get("times", 1), delay=d.get("delay", 0.05),
                   message=d.get("message"), p=d.get("p"),
                   peer=d.get("peer"), jitter=d.get("jitter", 0.0))

    def __repr__(self):
        return f"FaultEvent({self.to_dict()!r})"


class FaultPlan:
    """A seeded, deterministic schedule of fault events keyed by site.

    Thread-safe: hit counters and the fired log live behind one lock
    (fault sites sit on concurrent worker/server threads by design).
    """

    def __init__(self, events: Sequence = (), seed: int = 0):
        self.events: List[FaultEvent] = [
            e if isinstance(e, FaultEvent) else FaultEvent.from_dict(e)
            for e in events]
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._hits: Dict[str, int] = {}
        self._rngs: Dict[str, Any] = {}
        self._fired: List[Tuple[str, int, str]] = []

    # ------------------------------------------------------------- dispatch
    def check(self, site: str,
              peer: Optional[str] = None) -> Optional[FaultEvent]:
        """Record one hit at ``site``; return the event to apply, if
        any. ``peer`` (when the call site knows it) gates peer-keyed
        events; the hit counter stays per-site, so windows count every
        call through the chokepoint regardless of peer."""
        with self._lock:
            hit = self._hits.get(site, 0)
            self._hits[site] = hit + 1
            for ev in self.events:
                if (ev.site != site or not ev.matches(hit)
                        or not ev.matches_peer(peer)):
                    continue
                if ev.p is not None and self._draw(site) >= ev.p:
                    continue
                self._fired.append((site, hit, ev.action))
                return ev
        return None

    def jitter_s(self, site: str, bound: float) -> float:
        """A deterministic jitter draw in ``[0, bound]`` from the
        site's seeded RNG stream (shared with ``p`` draws)."""
        if bound <= 0.0:
            return 0.0
        with self._lock:
            return self._draw(site) * bound

    def _draw(self, site: str) -> float:
        # per-site RNG stream seeded from (plan seed, crc32(site)): the
        # interleaving of OTHER sites' hits cannot perturb this site's
        # draw sequence, which is what makes `p` events reproducible
        rng = self._rngs.get(site)
        if rng is None:
            import numpy as np

            rng = np.random.default_rng(
                (self.seed, zlib.crc32(site.encode("utf8"))))
            self._rngs[site] = rng
        return float(rng.random())

    # -------------------------------------------------------- observability
    def hits(self, site: str) -> int:
        with self._lock:
            return self._hits.get(site, 0)

    def fired(self, site: Optional[str] = None) -> List[Tuple[str, int, str]]:
        """``(site, hit_index, action)`` triples of events that fired."""
        with self._lock:
            return [f for f in self._fired if site is None or f[0] == site]

    # -------------------------------------------------------- serialization
    def to_json(self) -> str:
        return json.dumps({"seed": self.seed,
                           "events": [e.to_dict() for e in self.events]})

    @classmethod
    def from_json(cls, doc: str) -> "FaultPlan":
        d = json.loads(doc)
        if isinstance(d, list):  # bare event list, seed 0
            return cls(events=d)
        return cls(events=d.get("events", ()), seed=d.get("seed", 0))


# ------------------------------------------------------------ global plan
_STATE_LOCK = threading.Lock()
_PLAN: Optional[FaultPlan] = None
_LOADED = False  # env examined (or a plan installed explicitly)


def install_plan(plan: Optional[FaultPlan]):
    """Install ``plan`` as this process's active plan (overrides the
    environment). ``None`` disables injection without re-reading the env."""
    global _PLAN, _LOADED
    with _STATE_LOCK:
        _PLAN = plan
        _LOADED = True


def clear_plan():
    """Drop the active plan AND the loaded flag, so the next
    :func:`fault_site` call re-examines ``ELEPHAS_TPU_FAULT_PLAN``."""
    global _PLAN, _LOADED
    with _STATE_LOCK:
        _PLAN = None
        _LOADED = False


def active_plan() -> Optional[FaultPlan]:
    """The live plan: explicitly installed, or lazily loaded from
    ``ELEPHAS_TPU_FAULT_PLAN`` (inline JSON, or a path to a JSON file)."""
    global _PLAN, _LOADED
    if _LOADED:
        return _PLAN
    with _STATE_LOCK:
        if not _LOADED:
            raw = os.environ.get(ENV_VAR)
            if raw:
                raw = raw.strip()
                if not (raw.startswith("{") or raw.startswith("[")):
                    with open(raw, "r", encoding="utf8") as f:
                        raw = f.read()
                _PLAN = FaultPlan.from_json(raw)
            _LOADED = True
    return _PLAN


def fault_site(name: str) -> bool:
    """The hook hot paths call. No plan: returns False (near-free).

    With a plan: ``error`` raises :class:`InjectedFault`, ``delay``
    sleeps the event's ``delay`` then returns False, ``drop`` returns
    True — the call site applies its lost-message semantics (skip the
    apply, eat the ack, ...); sites with no meaningful drop treat it
    as a no-op.
    """
    plan = _PLAN if _LOADED else active_plan()
    if plan is None:
        return False
    ev = plan.check(name)
    if ev is None:
        return False
    return _apply(plan, name, ev, None, None)


def fault_network(name: str, peer=None, sock=None) -> bool:
    """The network-chaos hook wire chokepoints call. Like
    :func:`fault_site` but peer-aware: ``peer`` is a string such as
    ``"127.0.0.1:8431"`` (or a zero-arg callable returning one,
    evaluated only when a plan is active — ``getpeername`` stays off
    the no-chaos hot path). ``sock``, when given, is closed by
    ``reset`` events so the far side sees the truncated frame.

    Returns True for a ``drop`` the call site can apply silently (send
    paths); raises :class:`InjectedPartition` for ``partition``,
    :class:`InjectedReset` for ``reset``, :class:`InjectedFault` for
    ``error``. Call sites that cannot drop silently (reads, HTTP
    round trips) convert a True return into a partition themselves.
    """
    plan = _PLAN if _LOADED else active_plan()
    if plan is None:
        return False
    peer_s = peer() if callable(peer) else peer
    ev = plan.check(name, peer=peer_s)
    if ev is None:
        return False
    return _apply(plan, name, ev, peer_s, sock)


def _apply(plan: FaultPlan, name: str, ev: FaultEvent,
           peer: Optional[str], sock) -> bool:
    # every fired event surfaces as a labeled series in the process
    # default registry — chaos runs are diagnosable from /metrics alone
    reg = default_registry()
    reg.counter(
        "faults_injected_total",
        "fault-plan events fired, by site and action",
        labels=("site", "action")).labels(
        site=name, action=ev.action).inc()
    if ev.action in ("reset", "partition") or peer is not None:
        # the network-chaos series keeps its own namespace so chaos
        # dashboards don't have to tell wire faults from logic faults
        reg.counter(
            "netchaos_injected_total",
            "network chaos events fired at wire chokepoints",
            labels=("site", "action")).labels(
            site=name, action=ev.action).inc()
    # ...and as a structured event carrying the ACTIVE trace id, so "did
    # a fault hit *this* request" is answerable after the fact (the
    # metric, by design, cannot carry per-request identity)
    emit_event("fault.injected", site=name, action=ev.action,
               **({"peer": peer} if peer is not None else {}))
    if ev.action == "delay":
        time.sleep(ev.delay + plan.jitter_s(name, ev.jitter))
        return False
    if ev.action == "error":
        raise InjectedFault(ev.message
                            or f"injected fault at site {name!r}")
    if ev.action == "reset":
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        raise InjectedReset(ev.message
                            or f"injected reset at site {name!r}")
    if ev.action == "partition":
        time.sleep(ev.delay)
        raise InjectedPartition(
            ev.message or f"injected partition at site {name!r}"
            + (f" toward {peer}" if peer else ""))
    return True  # drop
