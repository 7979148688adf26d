"""Parameter-server clients: pull weights, push deltas, probe health.

(Parity surface: ``elephas/parameter/client.py:13-91``; payloads are typed
ETPU tensor frames instead of pickle. Upgrades over the reference: network
timeouts, transient-failure retry with exponential backoff, and health
probes — the reference has no failure detection at all, SURVEY.md §5.)

Copied into the port from ``elephas_tpu/parameter/client.py``
(host-only: no JAX); its relative imports resolve to the port's own
copies. Only the single-server plane is copied: pull, push and health.
The JAX client's version and generation pulls, two-phase commit and
replication calls serve its sharded plane, its standbys and its
live-weight subscribers, which the port does not have yet (ROADMAP
Queue 1 item 4).
"""
import abc
import random
import socket
import threading
import time
import urllib.error
import urllib.request
import uuid
from typing import List, Optional

import numpy as np

from ..fleet.resilience import (RETRY_BACKOFF_BASE_S, RETRY_BACKOFF_MAX_S,
                                RETRY_MAX_RETRIES, backoff_pause_s)
from ..obs.context import current_context
from ..obs.metrics import default_registry
from ..utils.delta_compression import quantize_delta
from ..utils.faults import InjectedFault, fault_site
from ..utils.sockets import (determine_master, receive, recv_exact, send,
                             send_trace_context)
from ..utils.tensor_codec import (KIND_DELTA, KIND_DELTA_Q8, decode_weights,
                                  encode)

#: default network timeout (seconds) — a dead parameter server must surface
#: as an error in the training loop, not a hang
DEFAULT_TIMEOUT = 120.0

#: transient-failure policy: attempts = 1 + MAX_RETRIES, sleeping a
#: decorrelated-jittered pause between tries (see :func:`_retry_pause`).
#: The values live in :mod:`elephas_tpu.fleet.resilience` — the ONE
#: documented home for every retry/backoff constant in the tree — and
#: are re-exported here under their historical names.
MAX_RETRIES = RETRY_MAX_RETRIES
BACKOFF = RETRY_BACKOFF_BASE_S

#: ceiling on any single retry pause (seconds): jitter may triple the
#: previous pause, so without a cap a long retry budget could sleep
#: arbitrarily far past the point the server came back
BACKOFF_CAP = RETRY_BACKOFF_MAX_S

#: process-wide RNG for retry jitter — deliberately NOT seeded, and
#: shared so even same-process subscribers draw different pauses
_JITTER_RNG = random.Random()

_TRANSIENT = (ConnectionError, socket.timeout, urllib.error.URLError, OSError)


def _retry_pause(prev: float, base: float, cap: float = BACKOFF_CAP,
                 rng: random.Random = _JITTER_RNG) -> float:
    """Decorrelated-jitter backoff (the AWS architecture-blog variant):
    ``min(cap, uniform(base, prev * 3))``. Grows roughly exponentially
    in expectation but every draw is independent — a FLEET of subscribers
    whose shared parameter shard died does not retry in lockstep and
    stampede the freshly promoted standby the way the old deterministic
    ``base * 2**attempt`` schedule did. Thin wrapper over the shared
    :func:`~elephas_tpu.fleet.resilience.backoff_pause_s`."""
    return backoff_pause_s(prev, base=base, cap=cap, rng=rng)




class BaseParameterClient(abc.ABC):
    """Clients can retrieve current parameters and send delta updates."""

    client_type = "base"

    #: metrics destination for the retry loop — ``None`` (subclasses may
    #: set an injectable :class:`~elephas_tpu.obs.MetricsRegistry`; the
    #: process default registry is used otherwise, so in-memory test
    #: doubles that never call a transport __init__ still record)
    registry = None

    @classmethod
    def get_client(cls, client_type: str, port: int = 4000) -> "BaseParameterClient":
        try:
            return next(c for c in cls.__subclasses__()
                        if c.client_type == client_type)(port)
        except StopIteration:
            raise ValueError("Parameter server mode has to be either `http` or "
                             "`socket`, got {}".format(client_type))

    def _with_retry(self, op, describe: str):
        """Run ``op`` with exponential-backoff retry on transient network
        failures, bounded by an overall wall-clock deadline (default
        ``2 * timeout``) so a dead server fails the call in bounded time
        instead of timeout-times-attempts.

        Updates carry idempotency ids (stable across resends), so the
        server skips a delta whose first application's ack was lost.

        Every successful attempt's wall time lands in the
        ``ps_client_rpc_latency_seconds{op=...}`` histogram (the SAME
        series ``benchmarks/ps_rpc_bench.py`` reports percentiles from),
        retries in ``ps_client_rpc_retries_total`` and exhausted calls
        in ``ps_client_rpc_failures_total``.
        """
        latency, retries, failures = self._rpc_metrics(describe)
        deadline = time.monotonic() + (
            self.deadline if self.deadline is not None else 2 * self.timeout)
        pause = self.backoff
        for attempt in range(self.max_retries + 1):
            t0 = time.perf_counter()
            try:
                result = op()
            except _TRANSIENT as err:
                # 4xx means a protocol/caller bug, not a flaky network
                if (isinstance(err, urllib.error.HTTPError)
                        and err.code < 500):
                    raise
                # decorrelated jitter, not base * 2**attempt: a fleet of
                # subscribers that all lost the same shard must not
                # retry in lockstep and stampede the promoted standby
                pause = _retry_pause(pause, self.backoff)
                if (attempt == self.max_retries
                        or time.monotonic() + pause > deadline):
                    failures.inc()
                    raise ConnectionError(
                        f"{describe} failed after {attempt + 1} attempt(s): "
                        f"{err}") from err
                retries.inc()
                time.sleep(pause)
            else:
                latency.observe(time.perf_counter() - t0)
                return result

    def _rpc_metrics(self, describe: str):
        """(latency histogram, retries counter, failures counter)
        children for one op — resolved once and cached on the instance,
        keeping the per-RPC hot path to plain attribute reads (test
        doubles that never ran a transport ``__init__`` still work:
        the cache dict is created lazily)."""
        cache = getattr(self, "_rpc_metric_cache", None)
        if cache is None:
            cache = {}
            self._rpc_metric_cache = cache
        handles = cache.get(describe)
        if handles is None:
            reg = self.registry if self.registry is not None \
                else default_registry()
            handles = cache[describe] = (
                reg.histogram(
                    "ps_client_rpc_latency_seconds",
                    "successful PS client RPC attempt latency",
                    labels=("op",)).labels(op=describe),
                reg.counter(
                    "ps_client_rpc_retries_total",
                    "transient-failure retries in the PS client",
                    labels=("op",)).labels(op=describe),
                reg.counter(
                    "ps_client_rpc_failures_total",
                    "PS client calls that exhausted their retries",
                    labels=("op",)).labels(op=describe))
        return handles

    @staticmethod
    def _check_compression(compression):
        if compression not in (None, "int8"):
            raise ValueError("compression must be None or 'int8', "
                             f"got {compression!r}")
        return compression

    def _delta_frame(self, delta: List[np.ndarray]):
        """(arrays, kind) for a delta push, honoring ``compression``
        (``'int8'`` = per-tensor absmax quantization, ~4x fewer wire
        bytes; see :mod:`~elephas_tpu.utils.delta_compression`)."""
        if getattr(self, "compression", None) == "int8":
            return quantize_delta(delta), KIND_DELTA_Q8
        return delta, KIND_DELTA

    def update_parameters(self, delta: List[np.ndarray]):
        """Send a weight-delta update to the server."""
        arrays, kind = self._delta_frame(delta)
        return self.push_frame(arrays, kind)

    def push_frame(self, arrays: List[np.ndarray], kind: int,
                   update_id: Optional[str] = None):
        """Send an already-built update frame (``KIND_DELTA`` or
        ``KIND_DELTA_Q8`` arrays). Workers carrying error feedback call
        this with the frame :class:`ErrorFeedback` already built, so a
        compressed push quantizes exactly once. ``update_id`` names
        the push; ``None`` mints a fresh id per call. Not abstract:
        custom clients that only override ``update_parameters`` (e.g.
        in-memory test doubles without compression) never need it."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement push_frame")

    @abc.abstractmethod
    def get_parameters(self) -> List[np.ndarray]:
        """Retrieve the current master weights."""

    @abc.abstractmethod
    def health_check(self) -> bool:
        """True when the server answers its liveness probe."""

    def close(self):
        """Release any long-lived transport state (no-op by default;
        the socket client drops its persistent connection)."""

    def clone(self) -> "BaseParameterClient":
        """A client with the same configuration but its OWN transport
        state. Workers clone the driver's client so each holds its own
        persistent connection instead of serializing every RPC over one
        socket. Default: return self (stateless transports, in-memory
        test doubles)."""
        return self


class HttpClient(BaseParameterClient):
    """Talks to :class:`~elephas_tpu.parameter.server.HttpServer`."""

    client_type = "http"

    def __init__(self, port: int = 4000, timeout: float = DEFAULT_TIMEOUT,
                 max_retries: int = MAX_RETRIES, backoff: float = BACKOFF,
                 deadline: float = None, compression: str = None,
                 registry=None):
        self.master_url = determine_master(port=port)
        self.headers = {"Content-Type": "application/elephas-tpu"}
        self.timeout = timeout
        self.max_retries = max_retries
        self.backoff = backoff
        self.deadline = deadline
        self.compression = self._check_compression(compression)
        self.registry = registry

    def _headers(self) -> dict:
        """Per-RPC headers: the base set plus the active trace context
        as a W3C ``traceparent`` (read at call time, so one client
        instance serves many requests' contexts correctly)."""
        ctx = current_context()
        if ctx is None:
            return self.headers
        return dict(self.headers, traceparent=ctx.to_traceparent())

    def get_parameters(self) -> List[np.ndarray]:
        def op():
            if fault_site("client.get_parameters"):
                raise InjectedFault("pull request dropped")
            request = urllib.request.Request(
                f"http://{self.master_url}/parameters",
                headers=self._headers())
            with urllib.request.urlopen(request,
                                        timeout=self.timeout) as response:
                return decode_weights(response.read())
        return self._with_retry(op, "get_parameters")

    def push_frame(self, arrays: List[np.ndarray], kind: int,
                   update_id: Optional[str] = None):
        # the encoder's bytearray goes to urllib as-is — bytes-like with
        # a len() for Content-Length; a bytes() round would re-copy the
        # whole frame per push
        payload = encode(arrays, kind)
        # one id per logical update, stable across retries: the server
        # drops duplicates so a lost ack can't double-apply the delta
        if update_id is None:
            update_id = uuid.uuid4().hex

        def op():
            if fault_site("client.update_parameters"):
                raise InjectedFault("push request dropped")
            headers = dict(self._headers(), **{"X-Update-Id": update_id})
            request = urllib.request.Request(
                f"http://{self.master_url}/update", payload, headers=headers)
            with urllib.request.urlopen(request,
                                        timeout=self.timeout) as response:
                body = response.read()
            if fault_site("client.push_ack"):
                # the server already applied the delta; losing the ack
                # forces a resend of the SAME update id — the
                # idempotency-window scenario
                raise InjectedFault("push ack dropped")
            return body
        return self._with_retry(op, "update_parameters")

    def health_check(self) -> bool:
        try:
            request = urllib.request.Request(
                f"http://{self.master_url}/health", headers=self.headers)
            with urllib.request.urlopen(request, timeout=5.0) as response:
                return response.status == 200
        except _TRANSIENT:
            return False


class SocketClient(BaseParameterClient):
    """Talks to :class:`~elephas_tpu.parameter.server.SocketServer`.

    By default the client keeps ONE long-lived connection and runs every
    RPC over it (the server's per-connection handler loops on opcodes),
    so a batch-frequency worker pays the TCP+thread setup once, not
    twice per batch. A transient failure closes the connection and the
    retry path reconnects — surviving a parameter-server restart.
    ``persistent=False`` restores the reference-style
    connection-per-RPC behavior (and is the bench A/B baseline).
    """

    client_type = "socket"

    def __init__(self, port: int = 4000, timeout: float = DEFAULT_TIMEOUT,
                 max_retries: int = MAX_RETRIES, backoff: float = BACKOFF,
                 deadline: float = None, compression: str = None,
                 persistent: bool = True, registry=None):
        self.port = port
        self.timeout = timeout
        self.max_retries = max_retries
        self.backoff = backoff
        self.deadline = deadline
        self.compression = self._check_compression(compression)
        self.persistent = bool(persistent)
        self.registry = registry
        self._sock_lock = threading.RLock()   # one RPC on the wire at a time
        self._persistent_sock: socket.socket = None

    def clone(self) -> "SocketClient":
        return SocketClient(port=self.port, timeout=self.timeout,
                            max_retries=self.max_retries,
                            backoff=self.backoff, deadline=self.deadline,
                            compression=self.compression,
                            persistent=self.persistent,
                            registry=self.registry)

    def _connect(self, timeout=None) -> socket.socket:
        host = determine_master(port=self.port).split(":")[0]
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.settimeout(timeout if timeout is not None else self.timeout)
        sock.connect((host, self.port))
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def close(self):
        """Drop the persistent connection (a context-managed fit calls
        this on teardown; safe to call any time — the next RPC
        reconnects)."""
        with self._sock_lock:
            if self._persistent_sock is not None:
                try:
                    self._persistent_sock.close()
                except OSError:
                    pass
                self._persistent_sock = None

    def _run_op(self, fn):
        """Run ``fn(sock)`` on the persistent connection (establishing
        it if needed); any transient failure tears the connection down
        before re-raising, so ``_with_retry``'s next attempt starts
        from a fresh connect — including against a restarted server.

        With an active trace context, the RPC is prefixed with the
        backward-compatible ``b'T'`` traceparent frame, so the server
        restores the caller's context for that one RPC (old servers
        never see the frame from context-less callers, and servers
        without the extension only matter to new callers)."""
        ctx = current_context()

        def run(sock):
            if ctx is not None:
                send_trace_context(sock, ctx)
            return fn(sock)

        if not self.persistent:
            with self._connect() as sock:
                return run(sock)
        with self._sock_lock:
            if self._persistent_sock is None:
                self._persistent_sock = self._connect()
            try:
                return run(self._persistent_sock)
            except _TRANSIENT:
                self.close()
                raise

    def get_parameters(self) -> List[np.ndarray]:
        def op():
            if fault_site("client.get_parameters"):
                raise InjectedFault("pull request dropped")

            def rpc(sock):
                sock.sendall(b"g")
                # zero-copy pull: the arrays view this message's own
                # receive buffer (fresh per frame, nothing reuses it),
                # so a 100MB weight pull costs recv_into + header parse
                # — no per-tensor materialization. The buffer is a
                # bytearray, so the views stay writable for callers
                # that update weights in place.
                return receive(sock, copy=False)
            return self._run_op(rpc)
        return self._with_retry(op, "get_parameters")

    def push_frame(self, arrays: List[np.ndarray], kind: int,
                   update_id: Optional[str] = None):
        # stable across retries: the server drops a resent duplicate
        uid = (update_id or uuid.uuid4().hex).encode("ascii")

        def op():
            if fault_site("client.update_parameters"):
                raise InjectedFault("push request dropped")

            def rpc(sock):
                sock.sendall(b"U" + uid)
                send(sock, arrays, kind=kind)
                # hardened fixed-length read: a half-closed peer raises
                # ConnectionError (retried) instead of returning b""
                # and being misread as a bad ack
                ack = bytes(recv_exact(sock, 1))  # blocks until applied
                if ack == b"k" and fault_site("client.push_ack"):
                    # the server applied and acked; eat the ack so the
                    # retry resends the SAME id (idempotency scenario)
                    raise InjectedFault("push ack dropped")
                if ack == b"e":
                    # permanent rejection (wrong arity/shapes): fail
                    # fast — retrying would resend the same bad frame
                    raise ValueError(
                        "parameter server rejected the delta "
                        "(mismatched array count or shapes)")
                if ack != b"k":
                    raise ConnectionError("parameter server did not "
                                          "acknowledge the update")
            return self._run_op(rpc)
        return self._with_retry(op, "update_parameters")

    def health_check(self) -> bool:
        # deliberately a fresh short-timeout connection: the probe must
        # answer fast even while a long RPC holds the persistent socket
        try:
            with self._connect(timeout=5.0) as sock:
                sock.sendall(b"h")
                # recv_exact: EOF raises (caught below as unhealthy)
                # rather than comparing b"" and falling through oddly
                return bytes(recv_exact(sock, 1)) == b"k"
        except _TRANSIENT:
            return False
