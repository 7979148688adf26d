"""HTTP serving front-end: an online text/token server over
:class:`~elephas_tpu.serving_engine.DecodeEngine`.

Transport matches the framework's parameter servers
(``parameter/server.py``): stdlib ``ThreadingHTTPServer``, typed JSON
bodies, no web framework. Request handler threads only enqueue/poll;
ONE background engine thread drives ``step()``, so the device program
stays single-threaded while requests arrive, finish, and cancel
concurrently — continuous batching does the interleaving on-device.

Endpoints (JSON in/out):

- ``POST /v1/generate`` — ``{"prompt": [ids...]}`` or ``{"text": "..."}``
  plus optional ``max_new_tokens``, ``temperature``, ``top_k``,
  ``top_p``. Blocks until the request finishes; returns
  ``{"tokens": [...]}`` (and ``"text"`` when a tokenizer is attached).
  With ``"stream": true`` the response is newline-delimited JSON
  written as tokens are emitted — ``{"tokens": [...]}`` lines followed
  by a final ``{"status": "done"|"cancelled"}`` line (connection-close
  delimited).
- ``POST /v1/submit`` — same body; returns ``{"id": rid}`` immediately.
- ``GET /v1/result?id=N`` — ``{"status": "pending"}`` until done, then
  ``{"status": "done", "tokens": [...]}`` (one-shot, like
  ``DecodeEngine.result``).
- ``POST /v1/cancel`` — ``{"id": rid}`` → ``{"cancelled": bool}``.
- ``GET /stats`` — engine + server counters; ``GET /health`` — liveness
  (200 until the engine loop dies); ``GET /ready`` — readiness (503
  while warming and while draining; load balancers route on this one).
- ``GET /metrics`` — Prometheus text exposition of the engine/server
  registry plus the process default registry (step-latency histograms,
  queue gauges, per-route request latency, fault injections — the
  docs' observability page has the catalog). The JSON ``/stats`` reads
  the same registry, so the two surfaces cannot drift.
- ``GET /v1/requests/<id>/trace`` — the request's flight-recorder
  timeline (queued/admitted/prefill/sampled steps/terminal outcome,
  with per-stage durations), every event stamped with its trace id;
  ``GET /debug/trace/recent`` — the newest timelines (``?limit=``).

Distributed tracing (``docs/sources/tracing.md`` has the full story):
every request runs under a :mod:`~elephas_tpu.obs.context`
``TraceContext`` — the client's W3C ``traceparent`` header when present
and well-formed, a freshly-generated root otherwise (a malformed header
starts a new trace, never an error) — and every response carries
``X-Trace-Id``. The context is captured at submit, so the engine-loop
thread stamps the whole request lifetime with the same id, and
parameter-plane RPCs issued under it forward the id to the PS.

Overload safety (the serving-operations doc page has the full story):

- Admission control: construct the engine with ``max_queue`` /
  ``max_queued_tokens`` and an over-capacity submit answers **429**
  with a ``retry_after_ms`` backoff hint (and the standard
  ``Retry-After`` header derived from it) instead of queueing forever.
- Multi-tenant QoS: requests may carry ``tenant`` (body field or
  ``X-Tenant`` header — body wins) and ``priority``; with a
  :class:`~elephas_tpu.serving_qos.TenantQoS` on the engine these
  drive fair queueing, per-tenant quota 429s, and preemption, and the
  ``http_request_*`` series carry a ``tenant`` label.
- Deadlines: requests may carry ``deadline_ms`` (or inherit the
  server's ``default_deadline_ms``). Expired-while-queued answers
  **504** (shed before prefill); expired mid-decode returns the partial
  tokens with ``"timeout": true``.
- Oversized bodies answer **413** (``max_body_bytes``); unknown result
  ids answer **404**.
- Graceful drain: ``stop(drain_timeout)`` flips ``/ready`` to 503,
  rejects new submits with **503**, lets in-flight (including
  streaming) requests finish up to the timeout, then cancels the
  stragglers — replacing the abrupt shutdown that stranded streams.

The reference has no serving server at all (SURVEY.md §2: inference is
Spark ``mapPartitions``); this is the online half of the framework's
beyond-parity serving stack.

Copied into the port from ``elephas_tpu/serving_http.py``
(host-only: no JAX); its relative imports resolve to the port's own
copies, so it serves :class:`~elephas_tpu_torch.serving_engine.
DecodeEngine`. That engine's ``submit`` takes no ``deadline_ms``,
``tenant``, ``priority``, ``seed``, ``resume_from`` or ``session``
(later ROADMAP steps), so the capability probes in
:class:`ServingServer` answer a request carrying one with 400, and a
server-side ``default_deadline_ms`` is not applied; the engine has no
metrics registry or profiler either, so the server keeps its own
registry and its watchdog runs without stall attribution.
"""
import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, urlparse

from .obs.context import (current_context, new_root, parse_traceparent,
                          use_context)
from .obs.metrics import (MetricsRegistry, counter_baseline,
                          default_registry, observe_scrape,
                          since_baseline)
from .serving_engine import QueueFullError
from .utils.faults import fault_site

__all__ = ["ServingServer"]

_IDLE_SLEEP = 0.005


class QuietThreadingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that does not traceback-spam stderr when a
    client vanishes mid-response (a prober timing out on a busy /stats,
    a curl ^C mid-stream) — routine peer behavior, not a server error.
    Every other handler exception still prints. Shared with the fleet
    router's front end. The listen backlog is 128 (the standard
    library's default of 5 resets a burst of concurrent clients)."""

    request_queue_size = 128

    def handle_error(self, request, client_address):
        import sys

        exc = sys.exc_info()[1]
        if isinstance(exc, (BrokenPipeError, ConnectionResetError)):
            return
        super().handle_error(request, client_address)

#: the route label domain for http_* metrics — anything else is
#: "other", so a scanner probing random paths cannot grow label
#: cardinality past the registry's bound
_KNOWN_ROUTES = ("/health", "/ready", "/stats", "/metrics", "/slo",
                 "/v1/result", "/v1/generate", "/v1/submit",
                 "/v1/cancel", "/debug/trace/recent", "/debug/traces",
                 "/v1/requests/:id/trace")

#: per-request flight-recorder route: the id is normalized out of the
#: metrics label (unbounded domain) but parsed for the lookup
_TRACE_ROUTE_RE = re.compile(r"^/v1/requests/(\d+)/trace$")


def _route_label(path: str) -> str:
    if path in _KNOWN_ROUTES:
        return path
    if _TRACE_ROUTE_RE.match(path):
        return "/v1/requests/:id/trace"
    return "other"


class _HTTPError(Exception):
    """A route outcome with a specific status code: raised anywhere
    under a handler's dispatch, answered as ``code`` + JSON payload
    (the generic handler fallback answers 400, which overload responses
    like 429/503/504 must not collapse into). ``headers`` ride onto the
    response — the 429 path's standard ``Retry-After``."""

    def __init__(self, code: int, payload: Dict,
                 headers: Optional[Dict[str, str]] = None):
        super().__init__(payload.get("error", f"http {code}"))
        self.code = code
        self.payload = payload
        self.headers = headers or {}


def retry_after_header(retry_after_ms: int) -> Dict[str, str]:
    """The standard ``Retry-After`` header (integer seconds, >= 1)
    derived from a ``retry_after_ms`` backoff hint — shed responses
    carry BOTH: the JSON field keeps millisecond precision for aware
    clients, the header serves every off-the-shelf HTTP client and
    proxy. Shared with the fleet router's edge 429."""
    return {"Retry-After": str(max(1, -(-int(retry_after_ms) // 1000)))}


class ServingServer:
    """Serve a :class:`~elephas_tpu.serving_engine.DecodeEngine` over
    HTTP.

    :param engine: a constructed engine (any configuration — prefix
        caching, multi-step, paged, speculative, and their compositions
        all work; per-request sampling fields are rejected by the
        engine in speculative mode).
    :param host, port: bind address (port 0 picks a free port; see
        :attr:`port` after :meth:`start`).
    :param tokenizer: optional ``encode``/``decode`` object (e.g.
        :class:`~elephas_tpu.utils.text.ByteTokenizer`) enabling
        ``"text"`` requests and text in responses.
    :param default_max_new_tokens: used when a request omits the field.
    :param default_deadline_ms: server-side default deadline applied to
        every request that does not carry its own ``deadline_ms``
        (``None`` = no default; a request's explicit value always
        wins). The backstop against clients that would happily wait
        forever while the backlog grows.
    :param max_body_bytes: reject request bodies whose Content-Length
        exceeds this with 413 before reading a byte (default 1 MiB) —
        the header is a claim, not a license to buffer unbounded input.
    :param registry: metrics registry for the server's HTTP series
        (request latency by route and status, drain counters). Defaults
        to the ENGINE's registry so ``GET /metrics`` serves engine and
        server series from one store; the route also appends the
        process default registry (fault injections, parameter-plane
        clients, training timers living on the same host).
    :param slo: optional :class:`~elephas_tpu.obs.SLOTracker` over the
        engine's registry. The engine loop calls its
        ``maybe_evaluate`` once per iteration (a clock check when not
        due), ``GET /slo`` serves its snapshot, and ``/stats`` carries
        it as the ``slo`` block — which is what the fleet membership
        prober lifts for the router's fleet-level ``GET /slo``.
    :param watchdog: engine-loop stall watchdog
        (:class:`~elephas_tpu.obs.EngineWatchdog`): ``True`` (the
        default) builds one on the server registry riding the engine's
        profiler, ``False`` disables it, or pass a constructed
        instance (its ``on_stall``/``on_recover`` are bound to this
        server's readiness). The engine loop beats it once per
        iteration; a stall flips ``/ready`` to 503
        ``{"status": "stalled"}`` so the fleet prober evicts this
        replica as *draining* (in-flight work kept, new submits
        routed away) instead of waiting out probe timeouts, and a
        beat returning un-flips it. See ``watchdog_stall_s`` /
        ``watchdog_abort_s`` and the "Surviving replica crashes"
        runbook in ``docs/sources/serving-operations.md``.
    :param watchdog_stall_s: beat age that declares a stall (only for
        the server-built watchdog). Set above the longest healthy
        iteration — a cold XLA compile is the usual ceiling.
    :param watchdog_abort_s: hard bound: past this beat age the
        process aborts (crash-only discipline; the replica supervisor
        restarts it). ``None`` (default) never aborts — required for
        in-process multi-replica pools sharing one process.
    """

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 tokenizer=None, default_max_new_tokens: int = 64,
                 max_stored_results: int = 1024,
                 default_deadline_ms: Optional[float] = None,
                 max_body_bytes: int = 1 << 20,
                 registry: Optional[MetricsRegistry] = None,
                 slo=None, watchdog=True,
                 watchdog_stall_s: float = 10.0,
                 watchdog_abort_s: Optional[float] = None):
        self.engine = engine
        self.tokenizer = tokenizer
        # optional SLO tracker (obs/slo.py) over the engine's registry:
        # the engine loop drives its evaluation cadence, GET /slo and
        # the "slo" block in /stats serve its snapshot (which the
        # fleet membership prober lifts for router-level aggregation)
        self.slo = slo
        self.default_max_new_tokens = int(default_max_new_tokens)
        self.max_stored_results = int(max_stored_results)
        self.default_deadline_ms = (None if default_deadline_ms is None
                                    else float(default_deadline_ms))
        self.max_body_bytes = int(max_body_bytes)
        # engine capability probe: SSMEngine's submit has no deadline
        # support — the server default must not poison every request
        # with an unexpected kwarg, and a client's explicit deadline
        # must fail loudly, not be silently dropped
        import inspect

        try:
            submit_params = inspect.signature(engine.submit).parameters
            self._engine_has_deadline = "deadline_ms" in submit_params
            # same contract for multi-tenant QoS fields: an explicit
            # tenant/priority on an engine without them must fail
            # loudly, never be silently dropped
            self._engine_has_tenant = "tenant" in submit_params
            # crash-safe resume fields: per-request RNG seed and the
            # forced-prefix resume offset the fleet router submits when
            # it moves a killed replica's generation to a sibling
            self._engine_has_seed = "seed" in submit_params
            self._engine_has_resume = "resume_from" in submit_params
            # resumable-session tag (tiered KV): persists the trailing
            # chain at retirement so the next request in the session
            # admits as a chain hit
            self._engine_has_session = "session" in submit_params
        except (TypeError, ValueError):
            self._engine_has_deadline = True   # assume the full engine
            self._engine_has_tenant = True
            self._engine_has_seed = True
            self._engine_has_resume = True
            self._engine_has_session = True
        self._host, self._port = host, int(port)
        self._lock = threading.Lock()          # guards every engine call
        self._cond = threading.Condition(self._lock)
        # finished-but-unfetched outputs, insertion-ordered and capped:
        # a client that submits and never polls must not leak memory for
        # the life of the server (oldest results evict first)
        self._results: Dict[int, list] = {}
        self._tracked: set = set()             # rids the loop must watch
        self._streams: Dict[int, list] = {}    # live token feeds
        self._waiters: set = set()             # rids with a blocked handler
        self._failure: Optional[str] = None    # set when the loop dies
        self._stop = threading.Event()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._threads = []
        # readiness/drain state: /ready is 503 until the engine loop has
        # run once (warming) and again from begin_drain() on (draining);
        # /health stays the pure liveness signal throughout
        self._ready = False
        self._draining = False
        # HTTP-layer metrics live in the engine's registry by default so
        # /metrics is one consistent store (see the registry param)
        self.registry = reg = (registry
                               or getattr(engine, "registry", None)
                               or MetricsRegistry())
        # tenant rides the http families so one query answers "what is
        # tenant X experiencing at the edge" — "" for routes without a
        # request body; unconfigured tenant names fold into "other"
        # (the label domain is client-chosen and must stay bounded)
        self._m_http_latency = reg.histogram(
            "http_request_duration_seconds",
            "request wall time by route, status, and tenant",
            labels=("route", "status", "tenant"))
        self._m_http_requests = reg.counter(
            "http_requests_total",
            "requests served by route, status, and tenant",
            labels=("route", "status", "tenant"))
        self._m_drained = reg.counter(
            "serving_requests_drained_total",
            "in-flight requests cancelled at the drain deadline").labels()
        # per-server baseline, like the engines' counters: a new server
        # over a reused engine/registry must not report a predecessor's
        # drain totals in /stats (the scrape keeps pooled totals)
        self._drained_base = counter_baseline(self._m_drained)
        # set by stop(): the ENGINE LOOP enforces the drain deadline and
        # signals completion (it holds the lock across every step, so a
        # stop() thread polling for the lock could starve past its
        # drain budget while work it should cancel runs to completion)
        self._drain_deadline: Optional[float] = None
        self._drain_done: Optional[threading.Event] = None
        # engine-loop stall watchdog: the loop beats it once per
        # iteration (idle included), its monitor thread flips /ready to
        # the "stalled" 503 past watchdog_stall_s, and a returning beat
        # un-flips it (see the ctor docstring)
        self._stalled = False
        if watchdog is True:
            from .obs.watchdog import EngineWatchdog

            self.watchdog: Optional[EngineWatchdog] = EngineWatchdog(
                stall_after_s=watchdog_stall_s,
                abort_after_s=watchdog_abort_s, registry=reg,
                profiler=getattr(engine, "profiler", None))
        else:
            self.watchdog = watchdog or None
        if self.watchdog is not None:
            self.watchdog.on_stall = self._on_engine_stall
            self.watchdog.on_recover = self._on_engine_recover

    def _on_engine_stall(self, attrs: Dict) -> None:
        self._stalled = True

    def _on_engine_recover(self, attrs: Dict) -> None:
        self._stalled = False

    # ---------------------------------------------------------- lifecycle
    @property
    def port(self) -> int:
        return self._port

    @property
    def _n_drained(self) -> int:
        # registry-backed (the counter IS the store); kept as the
        # attribute the /stats route and drain tests always read
        return int(since_baseline(self._drained_base, self._m_drained))

    # ------------------------------------------------------------ metrics
    def _observe_http(self, path: str, status: int, t0: float,
                      tenant: Optional[str] = None):
        route = _route_label(path)
        dur = time.perf_counter() - t0
        labels = dict(route=route, status=str(int(status)),
                      tenant=self._tenant_label(tenant))
        self._m_http_latency.labels(**labels).observe(dur)
        self._m_http_requests.labels(**labels).inc()

    def _tenant_label(self, tenant: Optional[str]) -> str:
        """Bounded metrics label for a client-supplied tenant name:
        tenants the engine's QoS config knows keep their name, anything
        else folds to ``"other"`` (and requests without a tenant to
        ``""``) — client strings must never grow a label domain."""
        if not tenant:
            return ""
        qos = getattr(self.engine, "qos", None)
        return qos.label(tenant) if qos is not None else "other"

    def _metrics_text(self, exemplars: bool = False) -> str:
        """Prometheus exposition for ``GET /metrics``: the server
        registry, the engine's registry, and the process default
        registry (each rendered once — they are usually the same
        object), so one scrape covers serving AND the cross-cutting
        series (fault injections, PS clients, training step times) of
        this process regardless of which registry was injected where.
        The render's own cost lands on ``obs_scrape_*`` (one scrape
        late by construction — self-observation is a trend signal);
        ``exemplars`` opts into OpenMetrics exemplar suffixes
        (``?exemplars=1`` on the route)."""
        t0 = time.perf_counter()
        seen, text = [], ""
        for reg in (self.registry, getattr(self.engine, "registry", None),
                    default_registry()):
            if reg is None or any(reg is s for s in seen):
                continue
            seen.append(reg)
            text += reg.render(exemplars=exemplars)
        observe_scrape(self.registry, "serving",
                       time.perf_counter() - t0, len(text))
        return text

    def start(self):
        """Bind, start the HTTP threads and the engine-step loop."""
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):      # quiet, like the PS server
                pass

            def _trace_context(self):
                """The request's trace context: the client's
                ``traceparent`` when present and well-formed, a fresh
                root otherwise — a malformed header silently starts a
                new trace, never a 4xx/500."""
                ctx = parse_traceparent(self.headers.get("traceparent"))
                return ctx if ctx is not None else new_root()

            def _reply(self, code: int, body: bytes, content_type: str,
                       headers: Optional[Dict] = None):
                # record BEFORE the body goes out: a client must find
                # its own request already counted if it scrapes /metrics
                # right after reading this response
                server._observe_http(urlparse(self.path).path, code,
                                     getattr(self, "_t0", None)
                                     or time.perf_counter(),
                                     tenant=getattr(self, "_tenant",
                                                    None))
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                for name, value in (headers or {}).items():
                    self.send_header(name, value)
                ctx = current_context()
                if ctx is not None:
                    # the id the client joins its logs/timelines on —
                    # echoed for propagated traces, minted for roots
                    self.send_header("X-Trace-Id", ctx.trace_id)
                self.end_headers()
                self.wfile.write(body)

            def _json(self, code: int, payload: Dict,
                      headers: Optional[Dict] = None):
                self._reply(code, json.dumps(payload).encode(),
                            "application/json", headers=headers)

            def _body(self) -> Dict:
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except (TypeError, ValueError):
                    raise _HTTPError(400,
                                     {"error": "invalid Content-Length"})
                if length < 0:
                    # a negative length is truthy AND under the cap; it
                    # would reach read(-1) = read-to-EOF — the unbounded
                    # buffering this guard exists to prevent
                    raise _HTTPError(400,
                                     {"error": "invalid Content-Length"})
                if length > server.max_body_bytes:
                    # reject on the CLAIMED size, before reading a byte:
                    # trusting the header and buffering is exactly the
                    # unbounded-read this cap exists to prevent
                    raise _HTTPError(413, {
                        "error": f"request body of {length} bytes "
                                 f"exceeds max_body_bytes "
                                 f"{server.max_body_bytes}",
                        "max_body_bytes": server.max_body_bytes})
                if not length:
                    return {}
                return json.loads(self.rfile.read(length))

            def do_GET(self):
                self._t0 = time.perf_counter()
                url = urlparse(self.path)
                # every route runs under the request's trace context
                # (inbound traceparent or a fresh root), so responses
                # carry X-Trace-Id and anything emitted while handling
                # — events, spans, faults — is stamped with the id
                with use_context(self._trace_context()):
                    try:
                        self._get_routes(url)
                    except _HTTPError as err:
                        self._json(err.code, err.payload,
                                   headers=err.headers)

            def _get_routes(self, url):
                trace_route = _TRACE_ROUTE_RE.match(url.path)
                if url.path == "/metrics":
                    # Prometheus exposition: engine + server series
                    # (and the process default registry). Lock-free
                    # like /health — the registry takes per-family
                    # locks only. ?exemplars=1 opts into OpenMetrics
                    # exemplar suffixes (not part of the 0.0.4
                    # grammar, so never on by default).
                    want_ex = parse_qs(url.query).get(
                        "exemplars", ["0"])[0] in ("1", "true")
                    self._reply(
                        200,
                        server._metrics_text(exemplars=want_ex).encode(),
                        "text/plain; version=0.0.4; charset=utf-8")
                elif url.path == "/health":
                    # lock-free read: liveness must answer instantly
                    # even while the engine loop holds the lock
                    # across a prefill compile (attribute reads are
                    # atomic)
                    failure = server._failure
                    if failure is None:
                        self._json(200, {"status": "ok"})
                    else:
                        self._json(500, {"status": "error",
                                         "error": failure})
                elif url.path == "/ready":
                    # readiness ≠ liveness: a warming or draining
                    # server is alive but must not receive new
                    # traffic. Lock-free, like /health.
                    failure = server._failure
                    if failure is not None:
                        self._json(503, {"status": "failed",
                                         "error": failure})
                    elif server._draining or server._stop.is_set():
                        self._json(503, {"status": "draining"})
                    elif server._stalled:
                        # the watchdog declared the engine loop stuck:
                        # still reachable (this thread answered), so
                        # the fleet prober evicts this replica as
                        # UNREADY — draining semantics, in-flight work
                        # kept — instead of waiting out probe timeouts
                        self._json(503, {"status": "stalled"})
                    elif not server._ready:
                        self._json(503, {"status": "warming"})
                    else:
                        self._json(200, {"status": "ready"})
                elif url.path == "/stats":
                    with server._lock:
                        stats = dict(server.engine.stats)
                        stats["requests_drained"] = server._n_drained
                        stats["draining"] = server._draining
                    if server.watchdog is not None:
                        # outside the lock — the watchdog has its own
                        # (and "is the loop stuck" must not queue
                        # behind the stuck loop's lock)
                        stats["watchdog"] = server.watchdog.status()
                    if server.slo is not None:
                        # outside the lock: the tracker serves its
                        # last snapshot under its own lock, and the
                        # membership prober lifts this block onto the
                        # router's fleet /slo aggregation
                        stats["slo"] = server.slo.status()
                    self._json(200, stats)
                elif url.path == "/slo":
                    # the per-replica SLO surface: objective states +
                    # fast/slow burn rates. Lock-free like /health —
                    # an operator diagnosing a firing alert must not
                    # queue behind a busy engine loop.
                    if server.slo is None:
                        self._json(404, {
                            "error": "no SLO tracker configured on "
                                     "this server"})
                    else:
                        self._json(200, server.slo.status())
                elif url.path == "/v1/result":
                    rid = parse_qs(url.query).get("id")
                    try:
                        rid = int(rid[0]) if rid else None
                    except ValueError:
                        rid = None
                    if rid is None:
                        self._json(400,
                                   {"error": "missing/invalid id"})
                        return
                    self._json(200, server._poll(rid))
                elif trace_route is not None:
                    # per-request flight recorder: lock-free by design
                    # (the recorder has its own lock) — a timeline read
                    # must not queue behind a stepping engine
                    self._json(200, server._request_trace(
                        int(trace_route.group(1))))
                elif url.path == "/debug/trace/recent":
                    limit = parse_qs(url.query).get("limit")
                    try:
                        limit = int(limit[0]) if limit else 32
                    except ValueError:
                        limit = 32
                    self._json(200, server._recent_traces(limit))
                elif url.path == "/debug/traces":
                    # span-tree plane: tail-retained trees + critical-
                    # path attribution. Lock-free like the recorder
                    # routes — the span store has its own lock.
                    q = parse_qs(url.query)
                    tid = q.get("trace_id")
                    limit = q.get("limit")
                    try:
                        limit = int(limit[0]) if limit else 32
                    except ValueError:
                        limit = 32
                    self._json(200, server._debug_traces(
                        trace_id=tid[0] if tid else None, limit=limit))
                else:
                    self._json(404, {"error": "unknown path"})

            def do_POST(self):
                self._t0 = time.perf_counter()
                url = urlparse(self.path)
                # same contract as do_GET: the submit below runs with
                # the context installed, which is where the engine
                # captures it for the request's whole lifetime
                with use_context(self._trace_context()):
                    self._post_routes(url)

            def _post_routes(self, url):
                try:
                    body = self._body()
                except _HTTPError as err:      # oversize body -> 413
                    self._json(err.code, err.payload)
                    return
                except (ValueError, json.JSONDecodeError):
                    self._json(400, {"error": "invalid JSON body"})
                    return
                # the X-Tenant header is the body field's equal: merge
                # it in (body wins) so every downstream consumer —
                # engine QoS, metrics labels, a proxied replica — sees
                # ONE tenant regardless of how the client sent it
                hdr_tenant = self.headers.get("X-Tenant")
                if hdr_tenant and body.get("tenant") is None:
                    body["tenant"] = hdr_tenant
                self._tenant = body.get("tenant")
                # X-Deadline-Ms carries the REMAINING budget from an
                # upstream router; the tighter of header and body wins
                # — a deadline can only shrink as it propagates
                hdr_deadline = self.headers.get("X-Deadline-Ms")
                if hdr_deadline is not None:
                    try:
                        hdr_ms = float(hdr_deadline)
                    except ValueError:
                        self._json(400, {
                            "error": "invalid X-Deadline-Ms header "
                                     f"{hdr_deadline!r}"})
                        return
                    body_ms = body.get("deadline_ms")
                    if body_ms is None or hdr_ms < float(body_ms):
                        body["deadline_ms"] = hdr_ms
                try:
                    if url.path == "/v1/generate" and body.get("stream"):
                        # submit FIRST: validation errors still answer a
                        # clean 400 before any bytes of the stream
                        rid = server._submit(body, stream=True)
                        try:
                            self.send_response(200)
                            self.send_header("Content-Type",
                                             "application/x-ndjson")
                            ctx = current_context()
                            if ctx is not None:
                                self.send_header("X-Trace-Id",
                                                 ctx.trace_id)
                            self.end_headers()

                            def line(payload):
                                # chaos site: 'drop' loses this line on
                                # the wire (half-dead client), 'error'
                                # is a deterministic mid-stream client
                                # disconnect — the abort path below
                                if fault_site("serving.stream_write"):
                                    return
                                self.wfile.write(
                                    (json.dumps(payload) + "\n").encode())
                                self.wfile.flush()

                            server._run_stream(rid, line)
                        except Exception:  # noqa: BLE001 — client gone
                            # mid-stream: the status line is already on
                            # the wire, so no 400 can follow; cancel the
                            # in-flight request instead of decoding for
                            # nobody
                            server._abort_stream(rid)
                        finally:
                            # the 200 went out before the first token;
                            # the latency recorded here is the full
                            # stream duration
                            server._observe_http(
                                "/v1/generate", 200, self._t0,
                                tenant=getattr(self, "_tenant", None))
                        return
                    if url.path == "/v1/generate":
                        self._json(200, server._generate(body))
                    elif url.path == "/v1/submit":
                        self._json(200, {"id": server._submit(body)})
                    elif url.path == "/v1/cancel":
                        self._json(200, server._cancel(body))
                    else:
                        self._json(404, {"error": "unknown path"})
                except _HTTPError as err:
                    # overload/drain outcomes carry their own status:
                    # 429 shed, 503 draining, 504 expired, 413 oversize
                    self._json(err.code, err.payload,
                               headers=err.headers)
                except Exception as exc:  # noqa: BLE001 — malformed-but-
                    # valid-JSON payloads (wrong types/shapes) and engine
                    # validation errors all answer a clean 400, never a
                    # connection drop (the parameter server's convention)
                    self._json(400, {"error": str(exc)})

        self._httpd = QuietThreadingHTTPServer((self._host, self._port),
                                               Handler)
        self._port = self._httpd.server_address[1]
        self._threads = [
            threading.Thread(target=self._httpd.serve_forever, daemon=True),
            threading.Thread(target=self._engine_loop, daemon=True),
        ]
        for t in self._threads:
            t.start()
        if self.watchdog is not None:
            self.watchdog.start()
        return self

    def begin_drain(self):
        """Enter draining: ``/ready`` answers 503 and new submits are
        rejected with 503, while requests already in flight (including
        live streams) keep running. Idempotent; :meth:`stop` calls it
        first, but an orchestrator may flip it early so the load
        balancer stops routing here before the actual stop."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()

    def stop(self, drain_timeout: float = 0.0):
        """Shut down, draining gracefully for up to ``drain_timeout``
        seconds: new submits 503 immediately, in-flight and streaming
        requests run to completion, and whatever is still unfinished at
        the timeout is cancelled (streams get their terminal
        ``cancelled`` line rather than a severed socket). The default
        ``drain_timeout=0`` is the old abrupt behavior."""
        self.begin_drain()
        if (drain_timeout > 0 and self._failure is None
                and any(t.is_alive() for t in self._threads)):
            done = threading.Event()
            with self._cond:
                self._drain_deadline = time.monotonic() + float(
                    drain_timeout)
                self._drain_done = done
                self._check_drain_locked()   # maybe already drained
            # cushion past the deadline: after the loop cancels the
            # stragglers, their handlers still need a moment to write
            # terminal lines (a stalled client must not wedge stop)
            done.wait(timeout=float(drain_timeout) + 10)
        self._stop.set()
        if self.watchdog is not None:
            # before the loop joins: a stopping loop's beats ending is
            # shutdown, not a stall to alert on
            self.watchdog.stop()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        for t in self._threads:
            t.join(timeout=10)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ------------------------------------------------------------- engine
    def _result_info(self, rid: int) -> Optional[Dict]:
        """Fetch a finished request's outcome dict. The server is
        engine-agnostic: engines without deadline support (SSMEngine)
        only expose ``result()``, so their outputs are wrapped in a
        plain non-timeout outcome."""
        fn = getattr(self.engine, "result_info", None)
        if fn is not None:
            return fn(rid)
        out = self.engine.result(rid)
        if out is None:
            return None
        return {"tokens": out, "timeout": False, "expired": False}

    def _check_drain_locked(self):
        """Drain enforcement, run by whichever thread holds the lock
        (normally the engine loop, once per iteration): past the drain
        deadline every still-tracked request is cancelled, and the
        drain completes — waking :meth:`stop` — once no handler owes a
        client a response (``_tracked``: compute owed; ``_streams`` /
        ``_waiters``: a handler mid-reply)."""
        done = self._drain_done
        if done is None:
            return
        if self._failure is not None:
            # dead engine loop: nothing will ever finish — stop() must
            # not sit out its cushion (covers the race where the loop
            # died between stop()'s failure check and arming the event)
            self._drain_done = None
            done.set()
            return
        if (self._drain_deadline is not None
                and time.monotonic() >= self._drain_deadline
                and self._tracked):
            for rid in list(self._tracked):
                if self.engine.cancel(rid):
                    self._m_drained.inc()
            self._tracked.clear()
            self._cond.notify_all()
        if not (self._tracked or self._streams or self._waiters):
            self._drain_done = None
            done.set()

    def _engine_loop(self):
        """The single driver of the device program: steps whenever work
        is pending, harvests finished requests, wakes blocked waiters.
        If the engine itself raises, the failure is recorded (``/health``
        turns 500, new submits are rejected), every in-flight request is
        failed, and all blocked handlers are woken — a dead engine must
        answer errors, not hang its clients."""
        try:
            first_pass_done = False
            while not self._stop.is_set():
                with self._cond:
                    emitted = {}
                    if self.engine.pending:
                        emitted = self.engine.step()
                    for rid, toks in emitted.items():
                        if rid in self._streams:
                            self._streams[rid].extend(toks)
                    if emitted:
                        self._cond.notify_all()
                    finished = []
                    for rid in list(self._tracked):
                        out = self._result_info(rid)
                        if out is not None:
                            self._results[rid] = out
                            finished.append(rid)
                    if finished:
                        self._tracked.difference_update(finished)
                        while len(self._results) > self.max_stored_results:
                            # abandoned submits: evict oldest unfetched —
                            # but never a result a blocked /v1/generate
                            # handler or live stream is about to claim
                            victim = next(
                                (r for r in self._results
                                 if r not in self._waiters
                                 and r not in self._streams), None)
                            if victim is None:
                                break
                            self._results.pop(victim)
                        self._cond.notify_all()
                    self._check_drain_locked()
                    idle = not self.engine.pending
                if self.slo is not None:
                    # outside the serving lock (the tracker reads the
                    # registry under per-metric locks): one clock
                    # check per iteration, a real evaluation only when
                    # the tracker's interval elapsed. Best-effort: a
                    # broken objective must never read as engine death
                    try:
                        self.slo.maybe_evaluate()
                    except Exception:  # noqa: BLE001
                        pass
                if self.watchdog is not None:
                    # one beat per iteration, idle included — the LOOP
                    # heartbeat is the liveness signal (the profiler's
                    # iteration stamp goes stale on a healthy idle
                    # engine; it supplies stall ATTRIBUTION, not
                    # detection)
                    self.watchdog.beat()
                if not first_pass_done:
                    # ready only after a FULL first iteration — a loop
                    # whose very first step will crash must never show
                    # a 200 /ready window before it does
                    first_pass_done = True
                    self._ready = True
                if idle:
                    time.sleep(_IDLE_SLEEP)
                else:
                    # fairness yield: this loop holds the serving lock
                    # for the whole of every step, re-acquiring it
                    # microseconds after release — without an explicit
                    # scheduler yield, handler threads (submit, cancel,
                    # /stats) can starve on the lock for SECONDS while
                    # the batch is busy (observed: a 2s submit under a
                    # 50ms-step fault plan). sleep(0) parks this thread
                    # just long enough for a waiting acquirer to win.
                    time.sleep(0)
        except Exception as exc:  # noqa: BLE001 — record ANY engine death
            with self._cond:
                self._failure = f"{type(exc).__name__}: {exc}"
                self._tracked.clear()
                if self._drain_done is not None:
                    # a draining stop() must not wait out its cushion on
                    # a loop that can no longer finish anything
                    self._drain_done.set()
                    self._drain_done = None
                self._cond.notify_all()

    def _prompt_ids(self, body: Dict):
        if "prompt" in body:
            return [int(t) for t in body["prompt"]]
        if "text" in body:
            if self.tokenizer is None:
                raise ValueError('"text" requests need a tokenizer '
                                 "attached to the server")
            return self.tokenizer.encode(body["text"])
        raise ValueError('body needs "prompt" (token ids) or "text"')

    def _submit(self, body: Dict, stream: bool = False,
                waiter: bool = False) -> int:
        ids = self._prompt_ids(body)
        kwargs = {}
        for field in ("temperature", "top_k", "top_p"):
            if body.get(field) is not None:
                kwargs[field] = body[field]
        if body.get("deadline_ms") is not None:
            if not self._engine_has_deadline:
                # never drop a requested deadline silently
                raise ValueError("this engine does not support "
                                 "per-request deadlines")
            kwargs["deadline_ms"] = float(body["deadline_ms"])
        elif (self.default_deadline_ms is not None
                and self._engine_has_deadline):
            kwargs["deadline_ms"] = self.default_deadline_ms
        for field in ("tenant", "priority"):
            if body.get(field) is not None:
                if not self._engine_has_tenant:
                    # the deadline convention: an explicit QoS field on
                    # an engine without tenant support fails loudly
                    raise ValueError(f"this engine does not support "
                                     f"per-request {field}")
                kwargs[field] = body[field]
        if body.get("seed") is not None:
            if not self._engine_has_seed:
                raise ValueError("this engine does not support "
                                 "per-request seeds")
            kwargs["seed"] = int(body["seed"])
        if body.get("resume_from"):
            if not self._engine_has_resume:
                raise ValueError("this engine does not support "
                                 "mid-generation resume")
            kwargs["resume_from"] = int(body["resume_from"])
        if body.get("session") is not None:
            if not self._engine_has_session:
                raise ValueError("this engine does not support "
                                 "resumable sessions")
            kwargs["session"] = str(body["session"])
        with self._cond:
            if self._draining or self._stop.is_set():
                raise _HTTPError(503, {"error": "server is draining; "
                                                "not accepting new work",
                                       "draining": True})
            if self._failure is not None:
                raise ValueError(f"engine failed: {self._failure}")
            # admit=False: admission (and any prefill compile a new
            # prompt length triggers) happens in the engine loop's next
            # step, never while this handler holds the server-wide lock
            try:
                rid = self.engine.submit(
                    ids, int(body.get("max_new_tokens",
                                      self.default_max_new_tokens)),
                    admit=False, **kwargs)
            except QueueFullError as exc:
                # overload answers NOW, with a backoff hint — the whole
                # point of admission control is never to queue forever
                # (standard Retry-After header + the ms-precision JSON
                # field; a per-tenant quota breach sheds here too)
                raise _HTTPError(429, {
                    "error": str(exc),
                    "retry_after_ms": exc.retry_after_ms},
                    headers=retry_after_header(exc.retry_after_ms))
            self._tracked.add(rid)
            if stream:
                # registered under the SAME lock as submit, so the very
                # first engine-loop step already routes into the feed
                self._streams[rid] = []
            if waiter:
                # likewise: the eviction guard must see this rid as
                # waited-on before the engine loop can ever finish it
                self._waiters.add(rid)
            return rid

    def _run_stream(self, rid: int, write_line):
        """Relay a request's tokens to ``write_line`` as the engine
        emits them; terminates with a status line on completion,
        cancellation, or server shutdown. Writes happen OUTSIDE the
        condition lock — a stalled client must never hold up the
        server-wide lock on backpressure."""
        try:
            while True:
                stopping = False
                with self._cond:
                    while (not self._streams.get(rid)
                           and rid in self._tracked
                           and rid not in self._results):
                        self._cond.wait(timeout=0.5)
                        if self._stop.is_set():
                            stopping = True
                            break
                    toks = self._streams.get(rid) or []
                    if toks:
                        self._streams[rid] = []
                    info = self._results.pop(rid, None)  # fed via stream
                    gone = info is None and rid not in self._tracked
                if toks:
                    write_line({"tokens": toks})
                if info is not None:
                    if info.get("expired"):
                        write_line({"status": "expired"})
                    elif info.get("timeout"):
                        # partial output: what was streamed is what the
                        # deadline allowed
                        write_line({"status": "done", "timeout": True})
                    else:
                        write_line({"status": "done"})
                    return
                if stopping or (gone and not toks):
                    # lock-free like /health: the terminal status must
                    # not wait out a compile the engine loop is holding
                    # the lock across
                    failure = self._failure
                    if failure is not None:
                        write_line({"status": "error",
                                    "error": f"engine failed: {failure}"})
                    else:
                        write_line({"status": "cancelled"})
                    return
        finally:
            with self._cond:
                self._streams.pop(rid, None)
                # complete a waiting drain even if the engine loop (its
                # usual driver) is already dead
                self._check_drain_locked()
                self._cond.notify_all()   # a draining stop() waits on this

    def _abort_stream(self, rid: int):
        """Server-side teardown for a stream whose client went away:
        cancel the in-flight request and drop every trace of it."""
        with self._cond:
            self.engine.cancel(rid)
            self._tracked.discard(rid)
            self._results.pop(rid, None)
            self._streams.pop(rid, None)
            self._cond.notify_all()

    def _finish_payload(self, info: Dict) -> Dict:
        """Response body for a finished request. A mid-decode deadline
        is still a 200 — the client gets the partial tokens plus
        ``"timeout": true``; an expired-in-queue request instead raises
        the 504 (no work was ever done for it)."""
        if info.get("expired"):
            raise _HTTPError(504, {
                "status": "expired",
                "stage": info.get("stage", "queued"),
                "error": "deadline expired before the request reached "
                         "prefill (shed from the queue)"})
        out = {"status": "done", "tokens": info["tokens"]}
        if info.get("timeout"):
            out["timeout"] = True
        if self.tokenizer is not None:
            out["text"] = self.tokenizer.decode(info["tokens"])
        return out

    def _generate(self, body: Dict) -> Dict:
        rid = self._submit(body, waiter=True)
        with self._cond:
            # exit on completion OR when the rid vanishes (cancelled by
            # another client, or its result fetched/evicted) — a blocked
            # handler must never outlive its request
            try:
                while rid not in self._results and rid in self._tracked:
                    self._cond.wait(timeout=0.5)
                    if self._stop.is_set():
                        raise ValueError("server shutting down")
            finally:
                self._waiters.discard(rid)
                self._check_drain_locked()   # see _run_stream's finally
            if rid in self._results:
                return self._finish_payload(self._results.pop(rid))
            if self._failure is not None:
                return {"status": "error", "id": rid,
                        "error": f"engine failed: {self._failure}"}
            return {"status": "cancelled", "id": rid}

    def _poll(self, rid: int) -> Dict:
        with self._cond:
            if rid in self._results:
                return self._finish_payload(self._results.pop(rid))
            if rid in self._tracked:
                return {"status": "pending"}
            if self._failure is not None:
                return {"status": "error",
                        "error": f"engine failed: {self._failure}"}
            # unknown, never issued, or already fetched (results are
            # one-shot): a real 404, not a 200 the client must parse
            raise _HTTPError(404, {
                "status": "unknown",
                "error": f"no such request id {rid} (never issued, "
                         "cancelled, or its result was already "
                         "fetched)"})

    def _cancel(self, body: Dict) -> Dict:
        rid = int(body.get("id", -1))
        with self._cond:
            cancelled = self.engine.cancel(rid)
            self._tracked.discard(rid)
            self._results.pop(rid, None)
            self._cond.notify_all()   # wake a /v1/generate blocked on rid
            return {"cancelled": bool(cancelled)}

    # ------------------------------------------------------------ tracing
    def _request_trace(self, rid: int) -> Dict:
        """``GET /v1/requests/<id>/trace``: the engine's flight-recorder
        timeline for one request. Served WITHOUT the engine lock (the
        recorder is independently thread-safe): the whole point of the
        endpoint is answering "what happened to this request" while the
        engine is busy or wedged."""
        fn = getattr(self.engine, "request_trace", None)
        trace = None if fn is None else fn(rid)
        if trace is None:
            raise _HTTPError(404, {
                "status": "unknown",
                "error": f"no flight-recorder timeline for request id "
                         f"{rid} (never issued, or evicted from the "
                         "bounded ring)"})
        return trace

    def _recent_traces(self, limit: int) -> Dict:
        """``GET /debug/trace/recent``: the newest request timelines
        (bounded; ``?limit=`` caps at 256)."""
        fn = getattr(self.engine, "recent_traces", None)
        if fn is None:
            return {"requests": []}
        return {"requests": fn(max(1, min(int(limit), 256)))}

    def _debug_traces(self, trace_id: Optional[str] = None,
                      limit: int = 32) -> Dict:
        """``GET /debug/traces``: the tail-retained span TREES (SLO
        violations, errors, slowest-k) with their critical-path
        decompositions and the store's percentile attribution —
        "which plane ate the time" as one read. ``?trace_id=`` narrows
        to one tree (retained or still in flight)."""
        from .obs.critical_path import aggregate, decompose
        from .obs.spans import Span, default_span_store

        store = default_span_store()
        if trace_id:
            spans = store.spans_of(trace_id)
            traces = [{"trace_id": trace_id,
                       "spans": [s.to_dict() for s in spans]}]
        else:
            traces = store.retained(limit=max(1, min(int(limit), 256)))
        decomps = []
        for rec in traces:
            d = decompose([Span.from_dict(s) for s in rec["spans"]],
                          ttft_s=rec.get("ttft_s"),
                          total_s=rec.get("latency_s"))
            rec["critical_path"] = d
            if d is not None:
                decomps.append(d)
        return {
            "traces": traces,
            "aggregation": {
                "ttft": aggregate(decomps, window="ttft"),
                "total": aggregate(decomps, window="total"),
            },
            "store": store.stats(),
        }
