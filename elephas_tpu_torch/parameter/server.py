"""Parameter servers: HTTP and raw-TCP weight services.

Async/hogwild training exchanges weight deltas through a parameter server
process on the coordinator host (the reference's Flask/raw-socket pair,
``elephas/parameter/server.py:42-233``). Differences here, by design:

- Payloads are typed ETPU tensor frames (:mod:`..utils.tensor_codec`),
  never pickle — nothing executable crosses the wire.
- The HTTP server is a stdlib ``ThreadingHTTPServer`` in a daemon thread
  (no Flask dependency, no fork: forking a process with a live JAX runtime
  is unsafe, and the weight state is plain numpy anyway).
- Locking policy is the reference's exactly: a writer-priority RWLock
  serializes pulls/pushes in ``asynchronous`` mode and is bypassed in
  ``hogwild`` mode (lock-free HOGWILD!-style updates).

Both servers hold the authoritative weights as a flat numpy list — the
wire currency — so no JAX device state lives on the serving threads.

The hot path is copy-frugal: pushes decode delta frames as zero-copy
views of the receive buffer (``apply_delta`` only reads them), and pulls
are served from a **cached encoded snapshot** — the wire payload is
rebuilt at most once per weight version (every applied delta bumps the
version) and repeated ``get_parameters`` traffic costs one ``sendall``
of the same immutable buffer, zero encode work (``encoded_weights``;
rebuilds are counted in ``encode_count``).

## Pipelined async push

``ps_pipeline=True`` double-buffers the reference-parity worker loops:
the delta push for batch/epoch *k* runs on a background thread over its
own connection while *k+1* computes. At most ONE push is in flight —
a pull can miss at most the single racing push (staleness bounded at
1) — and a push error is parked and re-raised at the worker's next
sync point, so supervisor crash/restart semantics are unchanged. The
overlapped device-resident schedule (``async_overlap=True``) already
pipelines through its communicator thread and subsumes this flag.

Copied into the port from ``elephas_tpu/parameter/server.py``
(host-only: no JAX); its relative imports resolve to the port's own
copies. Only the single-server plane is copied: pull, push, health,
metrics, snapshot and restore. The JAX server's two-phase commit,
replication with fencing epochs, and version and generation pulls
serve its sharded plane (``ps_shards > 1``), its standbys
(``ps_standby``) and its live-weight subscribers, which the port does
not have yet (ROADMAP Queue 1 item 4): here their socket opcodes drop
the connection as unknown, and their HTTP routes answer 404.
"""
import abc
import logging
import selectors
import socket
import struct
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np

_LOG = logging.getLogger(__name__)

from ..obs.context import (parse_traceparent, reset_context, set_context,
                           use_context)
from ..obs.events import emit as emit_event
from ..obs.metrics import default_registry, observe_scrape
from ..utils.faults import fault_site
from ..utils.functional_utils import subtract_params
from ..utils.rwlock import RWLock
from ..utils.sockets import (TRACE_OPCODE, determine_master,
                             receive_frame, receive_traceparent, recv_exact,
                             send_payload)
from ..utils.delta_compression import dequantize_delta
from ..utils.tensor_codec import KIND_DELTA_Q8, decode, encode_weights




def _decode_delta(payload: bytes):
    """Decode a delta push, dequantizing int8-compressed frames.

    Zero-copy decode: ``apply_delta`` only READS the delta
    (``subtract_params`` allocates the new weights) and the request body
    is this call's own buffer, so the views never outlive their frame.
    """
    arrays, kind = decode(payload, copy=False)
    if kind == KIND_DELTA_Q8:
        return dequantize_delta(arrays)
    return arrays


class BaseParameterServer(abc.ABC):
    """Holds master weights; serves pulls and applies pushed deltas."""

    def __init__(self, model: Dict[str, Any], port: int, mode: str, **kwargs):
        self.port = port
        self.mode = mode
        self.custom_objects = kwargs.get("custom_objects")
        #: which shard of a sharded parameter plane this server holds
        #: ("0" for the unsharded default) — a metric label, so one
        #: scrape splits RPC traffic per shard
        self.shard = str(kwargs.get("shard", 0))
        # ``model`` is the model_to_dict payload; the server only needs the
        # weight list (the architecture rides along for parity/save paths).
        self.model_config = model.get("model")
        self.weights: List[np.ndarray] = [np.asarray(w, dtype=np.float32)
                                          for w in model["weights"]]
        self.lock = RWLock()
        # cached encoded snapshot of the weights: get-heavy sync traffic
        # serves sendall(cached_bytes) with ZERO encode work. The cache
        # is invalidated by bumping _weights_version on every mutation
        # and rebuilt lazily, at most once per version; encode_count
        # counts actual rebuilds (the no-re-encode test hook).
        self._weights_version = 0
        self._enc_lock = threading.Lock()
        self._enc_cache: Optional[tuple] = None  # (version, payload)
        self.encode_count = 0
        #: applied-update counter — cheap liveness/progress signal surfaced
        #: through the health endpoints (own lock: hogwild bypasses the
        #: weight RWLock, and a bare += would lose increments across threads)
        self.num_updates = 0
        self._counter_lock = threading.Lock()
        # idempotency window: update ids already applied, so a client retry
        # whose first attempt's ack was lost cannot double-apply a delta.
        # Time-based retention (>= the client's worst-case retry horizon)
        # with a generous count cap — a busy cluster must not evict an id
        # before its retry can arrive.
        self._seen_ids: "OrderedDict[str, float]" = OrderedDict()
        self._seen_lock = threading.Lock()
        self._seen_ttl = 600.0
        self._seen_cap = 1 << 17
        # ids whose apply is still in flight: a duplicate resend arriving
        # while the original is mid-apply (the lost-ack retry scenario)
        # waits on the latch instead of racing past the _seen_ids check
        # and double-applying the delta
        self._in_flight: Dict[str, threading.Event] = {}
        # parameter-plane RPC metrics live in the PROCESS default
        # registry (labeled by transport/op): every PS in the process
        # pools into one scrape surface, exposed via the HTTP server's
        # /metrics route
        reg = default_registry()
        self._m_rpc_latency = reg.histogram(
            "ps_rpc_latency_seconds",
            "parameter-server RPC service time (receive through reply)",
            labels=("transport", "op", "shard"))
        self._m_rpc_total = reg.counter(
            "ps_rpc_total", "parameter-server RPCs served",
            labels=("transport", "op", "status", "shard"))
        self._m_rpc_bytes = reg.counter(
            "ps_rpc_bytes_total",
            "tensor payload bytes moved by PS RPCs",
            labels=("transport", "direction", "shard"))
        self._m_http_requests = reg.counter(
            "ps_http_requests_total",
            "PS HTTP requests by method, path, and status "
            "(the log_message replacement)",
            labels=("method", "path", "status"))

    # ---------------------------------------------------------- metrics
    def _obs_rpc(self, transport: str, op: str, status: str, t0: float,
                 bytes_in: int = 0, bytes_out: int = 0):
        """Record one served RPC (best-effort: dropped connections that
        never reach a reply are not counted as RPCs). Metrics stay
        id-free (an id label would be unbounded cardinality); the
        per-request identity goes to the structured event log instead —
        a ``ps.rpc`` event stamped with the caller's trace id (None for
        context-less callers), joinable against the serving side's
        flight-recorder timelines."""
        duration = time.perf_counter() - t0
        self._m_rpc_latency.labels(transport=transport, op=op,
                                   shard=self.shard).observe(duration)
        self._m_rpc_total.labels(transport=transport, op=op,
                                 status=status, shard=self.shard).inc()
        # the event carries the SAME duration the histogram observed,
        # so joining the two surfaces for one RPC is exact
        emit_event("ps.rpc", transport=transport, op=op, status=status,
                   duration_s=round(duration, 6))
        if bytes_in:
            self._m_rpc_bytes.labels(transport=transport, direction="in",
                                     shard=self.shard).inc(bytes_in)
        if bytes_out:
            self._m_rpc_bytes.labels(transport=transport, direction="out",
                                     shard=self.shard).inc(bytes_out)

    def get_weights(self) -> List[np.ndarray]:
        fault_site("ps.get_weights")
        if self.mode == "asynchronous":
            self.lock.acquire_read()
        try:
            return [w.copy() for w in self.weights]
        finally:
            if self.mode == "asynchronous":
                self.lock.release()

    def encoded_weights(self) -> bytes:
        """The current weights as one wire-encoded ETPU payload, served
        from a cached snapshot: invalidated when a delta lands (the
        version counter moves), rebuilt at most once per version —
        get-heavy sync traffic costs ``sendall(cached_bytes)`` and zero
        encode work. Concurrent getters serialize on the rebuild and
        then share the same immutable payload."""
        fault_site("ps.get_weights")
        with self._enc_lock:
            if self.mode == "asynchronous":
                self.lock.acquire_read()
            try:
                with self._counter_lock:
                    version = self._weights_version
                if (self._enc_cache is not None
                        and self._enc_cache[0] == version):
                    return self._enc_cache[1]
                # the encoder's bytearray is served as-is (bytes-like for
                # sendall/HTTP): nothing mutates it after this point —
                # invalidation REPLACES the cache tuple — and a bytes()
                # round would re-copy the whole payload per rebuild
                payload = encode_weights(self.weights)
                self.encode_count += 1
            finally:
                if self.mode == "asynchronous":
                    self.lock.release()
            self._enc_cache = (version, payload)
            return payload

    def snapshot(self) -> Dict[str, Any]:
        """Restartable server state: weights, the applied-update counter,
        and the idempotency window. A supervisor snapshots on every
        healthy probe so a crashed server can be rebuilt on the same
        port via :meth:`restore` — client retries after a lost ack stay
        deduplicated across the restart.

        The idempotency window is read BEFORE the weights: a delta that
        lands between the two reads is then present in the weights but
        absent from ``seen_ids``, so a post-restore resend re-applies it
        (at-least-once, a benign duplicate gradient). The reverse order
        would record the id without its weights — a resend after the
        restore would be deduplicated and the acked update silently
        lost."""
        with self._seen_lock:
            seen = list(self._seen_ids.items())
        with self._counter_lock:
            num_updates = self.num_updates
        weights = self.get_weights()  # honors the mode's locking policy
        return {"weights": weights, "num_updates": num_updates,
                "seen_ids": seen}

    def restore(self, snapshot: Dict[str, Any]):
        """Adopt a :meth:`snapshot` (typically on a fresh server before
        :meth:`start`, the kill→restart→reconnect recovery path)."""
        if self.mode == "asynchronous":
            self.lock.acquire_write()
        try:
            self.weights = [np.asarray(w, dtype=np.float32).copy()
                            for w in snapshot["weights"]]
            with self._counter_lock:
                self._weights_version += 1  # drops the cached encoding
        finally:
            if self.mode == "asynchronous":
                self.lock.release()
        with self._counter_lock:
            self.num_updates = int(snapshot.get("num_updates", 0))
        with self._seen_lock:
            self._seen_ids = OrderedDict(snapshot.get("seen_ids", ()))

    def _validate_delta(self, delta: List[np.ndarray]):
        """Arity/shape gate shared by apply and prepare: subtract_params
        zips the lists, so a short or mis-shaped delta would silently
        truncate/corrupt the served weights for every client until
        restart — validate BEFORE touching anything."""
        if len(delta) != len(self.weights):
            raise ValueError(
                f"delta has {len(delta)} arrays, model has "
                f"{len(self.weights)}")
        for i, (d, w) in enumerate(zip(delta, self.weights)):
            if tuple(np.shape(d)) != tuple(np.shape(w)):
                raise ValueError(
                    f"delta[{i}] shape {np.shape(d)} != weight shape "
                    f"{np.shape(w)}")

    def apply_delta(self, delta: List[np.ndarray],
                    update_id: Optional[str] = None):
        if fault_site("ps.apply_delta"):
            return  # drop: the delta is silently lost (still acked)
        self._validate_delta(delta)
        if update_id is None:
            # an anonymous push (the legacy 'u' opcode, no X-Update-Id
            # header) cannot be resent under its id: nothing to dedup
            self._apply(delta)
            return
        # claim the id before applying. A duplicate of a completed
        # apply returns immediately; a duplicate of an IN-FLIGHT apply
        # waits on its latch and re-checks — it must neither double-
        # apply nor ack before the first apply has actually landed.
        while True:
            with self._seen_lock:
                if update_id in self._seen_ids:
                    return  # duplicate resend from a client retry
                latch = self._in_flight.get(update_id)
                if latch is None:
                    latch = threading.Event()
                    self._in_flight[update_id] = latch
                    break  # we own the apply for this id
            latch.wait(timeout=60.0)
        try:
            self._apply(delta)
        except BaseException:
            # failed apply: release the claim WITHOUT recording the id,
            # so the client's resend retries the apply instead of being
            # acked for a delta that never landed
            with self._seen_lock:
                self._in_flight.pop(update_id, None)
            latch.set()
            raise
        now = time.monotonic()
        with self._seen_lock:
            self._seen_ids[update_id] = now
            self._in_flight.pop(update_id, None)
            while self._seen_ids and (
                    len(self._seen_ids) > self._seen_cap
                    or next(iter(self._seen_ids.values()))
                    < now - self._seen_ttl):
                self._seen_ids.popitem(last=False)
        latch.set()

    def _apply(self, delta: List[np.ndarray]):
        if self.mode == "asynchronous":
            self.lock.acquire_write()
        try:
            self.weights = subtract_params(self.weights, delta)
            # invalidate the encoded snapshot (under _counter_lock:
            # hogwild bypasses the RWLock, and a lost increment would
            # leave the cache serving stale weights forever)
            with self._counter_lock:
                self._weights_version += 1
        finally:
            if self.mode == "asynchronous":
                self.lock.release()
        with self._counter_lock:
            self.num_updates += 1

    @abc.abstractmethod
    def start(self):
        """Start serving."""

    @abc.abstractmethod
    def stop(self):
        """Stop serving."""


class HttpServer(BaseParameterServer):
    """HTTP parameter server: ``GET /parameters`` and ``POST /update``.

    (Parity surface: ``elephas/parameter/server.py:42-137``.)
    """

    def __init__(self, model: Dict[str, Any], port: int, mode: str, **kwargs):
        super().__init__(model, port, mode, **kwargs)
        self.master_url: Optional[str] = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                # quiet on stderr — requests are recorded as
                # ps_http_requests_total{method,path,status} instead,
                # so PS traffic is visible to a scrape, not a terminal
                pass

            def _route(self) -> str:
                # bounded label domain: arbitrary probed paths must not
                # mint new label sets
                if self.path.rstrip("/") in ("", "/"):
                    return "/"
                for known in ("/health", "/metrics", "/parameters",
                              "/update"):
                    if self.path.startswith(known):
                        return known
                return "other"

            def _record(self, status: int):
                server._m_http_requests.labels(
                    method=self.command, path=self._route(),
                    status=str(status)).inc()

            def _empty(self, status: int):
                # explicit empty body: a status line with no
                # Content-Length leaves clients to wait for EOF
                self._record(status)
                self.send_response(status)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_GET(self):
                # restore the caller's trace context (W3C traceparent
                # header) for this request, so ps.rpc events — and
                # anything else emitted while serving it — carry the
                # originating request's id; no header, no context
                with use_context(parse_traceparent(
                        self.headers.get("traceparent"))):
                    self._handle_get()

            def _handle_get(self):
                t0 = time.perf_counter()
                content_type = "application/elephas-tpu"
                if self.path.rstrip("/") in ("", "/"):
                    body = b"elephas_tpu"
                elif self.path.startswith("/health"):
                    # liveness + progress: workers and orchestrators probe
                    # this to detect a dead/stuck server (reference has no
                    # failure detection at all, SURVEY.md par.5)
                    body = (b'{"status": "ok", "mode": "%s", '
                            b'"num_updates": %d}'
                            % (server.mode.encode(), server.num_updates))
                elif self.path.startswith("/metrics"):
                    # Prometheus exposition of the process default
                    # registry: PS RPC counters, fault injections, and
                    # any training telemetry co-resident in this
                    # process. The render's own cost lands on
                    # obs_scrape_* (site="ps") — exposition at high
                    # cardinality must itself be visible.
                    body = default_registry().render().encode()
                    observe_scrape(default_registry(), "ps",
                                   time.perf_counter() - t0, len(body))
                    content_type = ("text/plain; version=0.0.4; "
                                    "charset=utf-8")
                elif self.path.startswith("/parameters"):
                    # cached encoded snapshot: no per-request encode (or
                    # weight copy) while the version is unchanged
                    body = server.encoded_weights()
                    server._obs_rpc("http", "get_weights", "ok", t0,
                                    bytes_out=len(body))
                else:
                    self._empty(404)
                    return
                # record BEFORE the body goes out, so a client that
                # scrapes /metrics right after this response already
                # sees its request counted
                self._record(200)
                self.send_response(200)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                with use_context(parse_traceparent(
                        self.headers.get("traceparent"))):
                    self._handle_post()

            def _reply(self, body: bytes):
                self._record(200)    # before the reply, like do_GET
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _read_delta(self, op: str, t0: float):
                """Decode the request body as a delta frame; answers the
                400 itself and returns None on a malformed payload."""
                length = int(self.headers.get("Content-Length", "0"))
                try:
                    return _decode_delta(self.rfile.read(length)), length
                except Exception:  # malformed -> clean 400, not a 500
                    server._obs_rpc("http", op, "bad_frame", t0)
                    self._empty(400)
                    return None

            def _handle_post(self):
                t0 = time.perf_counter()
                if self.path.startswith("/update"):
                    decoded = self._read_delta("apply_delta", t0)
                    if decoded is None:
                        return
                    delta, length = decoded
                    try:
                        server.apply_delta(
                            delta,
                            update_id=self.headers.get("X-Update-Id"))
                    except ValueError as err:  # wrong arity/shapes -> 400
                        _LOG.warning("rejected delta: %s", err)
                        server._obs_rpc("http", "apply_delta", "rejected",
                                        t0, bytes_in=length)
                        self._empty(400)
                        return
                    server._obs_rpc("http", "apply_delta", "ok", t0,
                                    bytes_in=length)
                    self._reply(b"Update done")
                else:
                    self._empty(404)

        host = determine_master(self.port).split(":")[0]
        self._httpd = ThreadingHTTPServer((host, self.port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        self.master_url = determine_master(self.port)

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(timeout=5)
            self._httpd = None
            self._thread = None


class SocketServer(BaseParameterServer):
    """Raw-TCP parameter server with a 1-byte opcode protocol:
    ``'g'`` = get weights, ``'u'`` = apply update, ``'U'`` = apply update
    with a 32-byte idempotency id (safe to resend), ``'h'`` = health
    probe, ``'T'`` = trace-context frame (55-byte ``traceparent``
    applying to the next RPC; a backward-compatible extension old
    clients simply never send). Any other opcode drops the connection.

    (Parity surface: ``elephas/parameter/server.py:140-233``; framing is the
    length-prefixed ETPU format instead of pickled payloads.)
    """

    def __init__(self, model: Dict[str, Any], port: int, mode: str, **kwargs):
        super().__init__(model, port, mode, **kwargs)
        self.socket: Optional[socket.socket] = None
        self.runs = False
        self.connections: List[threading.Thread] = []
        self.thread: Optional[threading.Thread] = None
        self._conn_lock = threading.Lock()

    def start(self):
        if self.thread is not None:
            self.stop()
        ready = threading.Event()
        self.thread = threading.Thread(target=self._serve, args=(ready,),
                                       daemon=True)
        self.thread.start()
        if not ready.wait(timeout=10):
            raise RuntimeError("SocketServer failed to start listening")

    def stop(self):
        self.runs = False
        if self.socket is not None:
            # unblock accept() with a self-connection, then close
            try:
                host = determine_master(self.port).split(":")[0]
                with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
                    s.settimeout(1.0)
                    s.connect((host, self.port))
            except OSError:
                pass
        if self.thread is not None:
            self.thread.join(timeout=5)
            self.thread = None
        # the serve thread is joined (or timed out) — snapshot under the
        # lock anyway so a straggling accept can't append to a list this
        # loop never sees
        with self._conn_lock:
            handlers, self.connections = self.connections, []
        for t in handlers:
            t.join(timeout=1)
        if self.socket is not None:
            try:
                self.socket.close()
            except OSError:
                pass
            self.socket = None

    def _serve(self, ready: threading.Event):
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        host = determine_master(self.port).split(":")[0]
        sock.bind((host, self.port))
        sock.listen(16)
        self.socket = sock
        self.runs = True
        ready.set()
        while self.runs:
            try:
                conn, _ = sock.accept()
            except OSError:
                break
            if not self.runs:
                conn.close()
                break
            t = threading.Thread(target=self._listen, args=(conn,), daemon=True)
            t.start()
            # prune finished handlers on every accept: a long run with
            # reconnecting clients must hold O(live connections) thread
            # objects, not one per connection ever made
            with self._conn_lock:
                self.connections = [c for c in self.connections
                                    if c.is_alive()]
                self.connections.append(t)
        try:
            sock.close()
        except OSError:
            pass

    #: between-RPC poll interval: a handler waiting on an idle persistent
    #: connection re-checks ``self.runs`` this often, so server stop()
    #: never strands handler threads. The wait is selectors-based (epoll) — the
    #: socket itself stays in blocking mode, because a socket timeout
    #: would disable the native C++ framing fast path for the RPC body
    #: (``utils/sockets._use_native``) and cap stalls the client's own
    #: configurable timeout is meant to govern.
    IDLE_TIMEOUT = 0.5

    def _listen(self, conn: socket.socket):
        # selectors (epoll/kqueue), not select.select: the latter raises
        # ValueError for fds >= FD_SETSIZE (1024), which a busy server
        # (many connections + file-backed data columns) can exceed
        sel = selectors.DefaultSelector()
        pending_ctx = None   # trace context for the NEXT RPC (b"T" frame)
        with conn, sel:
            sel.register(conn, selectors.EVENT_READ)
            while self.runs:
                try:
                    if not sel.select(timeout=self.IDLE_TIMEOUT):
                        continue  # idle persistent connection: poll runs
                    opcode = conn.recv(1)
                except OSError:
                    return
                if not opcode:
                    return
                if opcode == TRACE_OPCODE:
                    # trace-context frame extension: fixed-length
                    # traceparent applying to the one RPC that follows.
                    # Old clients never send it; a malformed payload
                    # parses to None and the stream stays in sync.
                    try:
                        pending_ctx = receive_traceparent(conn)
                    except (ConnectionError, OSError):
                        return
                    continue
                t0 = time.perf_counter()
                token = set_context(pending_ctx)
                pending_ctx = None
                try:
                    if opcode in (b"u", b"U"):
                        update_id = None
                        if opcode == b"U":
                            update_id = bytes(recv_exact(conn, 32)).decode(
                                "ascii", "replace")
                        # copy=False: the delta arrays view the receive
                        # buffer — safe here because apply_delta only
                        # READS them (subtract_params allocates the new
                        # weights), so the hot push path decodes with
                        # zero tensor copies
                        arrays, kind = receive_frame(conn, copy=False)
                        nbytes_in = sum(int(a.nbytes) for a in arrays)
                        delta = (dequantize_delta(arrays)
                                 if kind == KIND_DELTA_Q8 else arrays)
                        try:
                            self.apply_delta(delta, update_id=update_id)
                        except ValueError as err:
                            # the frame was fully read, so the stream is
                            # still in sync: NACK a validation-rejected
                            # delta so the client fails fast instead of
                            # retrying a permanent error
                            _LOG.warning("rejected delta: %s", err)
                            conn.sendall(b"e")
                            self._obs_rpc("socket", "apply_delta",
                                          "rejected", t0,
                                          bytes_in=nbytes_in)
                            continue
                        conn.sendall(b"k")  # ack: delta applied
                        self._obs_rpc("socket", "apply_delta", "ok", t0,
                                      bytes_in=nbytes_in)
                    elif opcode == b"g":
                        # cached encoded snapshot: repeated gets cost one
                        # sendall of the same immutable payload — no
                        # weight copy, no re-encode
                        payload = self.encoded_weights()
                        send_payload(conn, payload)
                        self._obs_rpc("socket", "get_weights", "ok", t0,
                                      bytes_out=len(payload))
                    elif opcode == b"h":
                        conn.sendall(b"k")  # alive
                        self._obs_rpc("socket", "health", "ok", t0)
                    else:
                        # unknown opcode = desynced or garbage stream;
                        # continuing would interpret payload bytes as
                        # opcodes — drop the connection instead
                        _LOG.warning("dropping connection: unknown "
                                     "opcode %r", opcode)
                        return
                except OSError:
                    # mid-RPC stall or client death: drop silently (the
                    # client's retry opens a fresh one); a half-read
                    # frame must never be applied
                    return
                except (ValueError, struct.error, KeyError) as err:
                    # corrupt/garbage frame (decode errors) or a
                    # validation-rejected delta: drop the connection,
                    # loudly — malformed input must not kill the handler
                    # thread, but repeated drops must be diagnosable
                    _LOG.warning("dropping connection after bad frame/"
                                 "delta: %s", err)
                    return
                finally:
                    # the context applies to exactly one RPC: the next
                    # opcode on this connection starts clean unless the
                    # client sends another b"T" frame
                    reset_context(token)
