"""Elastic worker supervision for asynchronous training.

The reference (and this repo's previous ``_fit_async``) ran one
fire-and-forget thread per shard and aborted the whole fit on the first
worker exception, silently discarding every surviving worker's progress.
:class:`WorkerSupervisor` replaces that with the elastic-training shape
popularized by Horovod Elastic / TorchElastic, scaled to the
single-controller threading model:

- shards are *work items* on a queue, executed by a fixed set of worker
  slots (each slot maps round-robin onto a local device, exactly like
  the thread-per-shard dispatch it replaces);
- a failed item is handled by policy: ``reassign`` (default) re-queues
  the shard onto a surviving slot, bounded by ``max_worker_restarts``
  per shard; ``fail`` preserves the pre-supervisor semantics exactly
  (every dispatched shard still runs to completion — drains — and then
  the first error is raised); ``continue`` drops the shard and degrades
  gracefully as long as at least a ``min_workers`` fraction of shards
  completes (quorum), else :class:`QuorumLostError`;
- an optional parameter-server monitor probes PS health between
  failures and on a background cadence; a dead PS is restarted through
  the caller's ``ps_restart`` hook (snapshot-based, same port) and the
  failed shard is re-queued *without* consuming its restart budget —
  a PS outage is not the worker's fault;
- every decision is recorded in a :class:`SupervisorReport`
  (``restarts``/``reassigned_shards``/``lost_shards``/``ps_restarts``)
  so degradation is observable, never silent.

Copied into the port from ``elephas_tpu/parallel/supervisor.py``
(host-only: no JAX); its relative imports resolve to the port's own
copies.
"""
import logging
import queue
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..obs.context import current_context, current_trace_id, set_context
from ..obs.metrics import default_registry

_LOG = logging.getLogger(__name__)

POLICIES = ("reassign", "fail", "continue")


class QuorumLostError(RuntimeError):
    """Raised by ``on_worker_failure='continue'`` when fewer than the
    ``min_workers`` fraction of shards completed successfully."""


class SupervisorReport:
    """What the supervisor did, for ``training_histories``.

    :ivar restarts: shard re-executions after a worker failure
    :ivar reassigned_shards: shard indices re-queued (one entry per
        re-queue, so a twice-restarted shard appears twice)
    :ivar lost_shards: shard indices dropped under ``continue``
    :ivar completed_shards: shard indices that finished successfully
    :ivar ps_restarts: parameter-server restarts performed
    :ivar failures: ``(shard, attempt, repr(error))`` per observed failure
    :ivar trace_id: the trace id active when :meth:`WorkerSupervisor.run`
        started (None outside any context) — joins this fit's decisions
        to the fleet's event log / flight-recorder artifacts
    """

    def __init__(self):
        self.restarts = 0
        self.reassigned_shards: List[int] = []
        self.lost_shards: List[int] = []
        self.completed_shards: List[int] = []
        self.ps_restarts = 0
        self.failures: List[tuple] = []
        self.trace_id: Optional[str] = None

    def as_dict(self) -> Dict[str, Any]:
        return {"restarts": self.restarts,
                "reassigned_shards": list(self.reassigned_shards),
                "lost_shards": sorted(self.lost_shards),
                "completed_shards": sorted(self.completed_shards),
                "ps_restarts": self.ps_restarts,
                "failures": [(s, a, e) for s, a, e in self.failures],
                "trace_id": self.trace_id}


class WorkerSupervisor:
    """Dispatch shards to worker slots; survive failures by policy.

    :param run_shard: ``run_shard(slot, shard_idx, shard, attempt)``
        trains one shard. ``slot`` is the stable slot index (use it for
        round-robin device assignment); ``attempt`` is 0 for the first
        dispatch and grows with each re-queue.
    :param on_worker_failure: ``'reassign'`` | ``'fail'`` | ``'continue'``
    :param max_worker_restarts: per-shard re-queue budget under
        ``reassign``; exhausting it re-raises the shard's last error
    :param min_workers: quorum fraction (0..1] of shards that must
        complete under ``continue``
    :param num_slots: concurrent worker slots (default: one per shard)
    :param ps_probe: optional zero-arg health probe returning True when
        the parameter server is alive (call sites usually also snapshot
        server state inside a healthy probe)
    :param ps_restart: optional zero-arg hook restarting the parameter
        server (from the caller's latest snapshot, on the same port)
    :param ps_probe_interval: background probe cadence, seconds
    :param max_ps_restarts: bound on PS restarts per fit — a flapping
        server (dies again right after every restart) must eventually
        surface as worker failures handled by the policy, not restart
        forever
    :param on_item_failure: ``(shard_idx, attempt, error)`` observer
        fired for every worker failure the *policy* must act on (a
        PS-restart free retry resumes the worker's role and is not
        reported) — the fit driver uses it to remove the dead
        participant from the epoch aggregator so callbacks never stall
    """

    def __init__(self, run_shard: Callable[[int, int, Any, int], Any],
                 on_worker_failure: str = "reassign",
                 max_worker_restarts: int = 2, min_workers: float = 0.5,
                 num_slots: Optional[int] = None,
                 ps_probe: Optional[Callable[[], bool]] = None,
                 ps_restart: Optional[Callable[[], None]] = None,
                 ps_probe_interval: float = 2.0, max_ps_restarts: int = 5,
                 on_item_failure: Optional[Callable[[int, int, BaseException],
                                                    None]] = None):
        if on_worker_failure not in POLICIES:
            raise ValueError(
                f"on_worker_failure must be one of {POLICIES}, "
                f"got {on_worker_failure!r}")
        if not (0.0 < min_workers <= 1.0):
            raise ValueError(
                f"min_workers must be in (0, 1], got {min_workers}")
        if ps_probe_interval <= 0:
            # Event.wait(0) would turn the monitor into a busy loop
            raise ValueError(
                f"ps_probe_interval must be > 0, got {ps_probe_interval}")
        self.run_shard = run_shard
        self.policy = on_worker_failure
        self.max_worker_restarts = max(0, int(max_worker_restarts))
        self.min_workers = float(min_workers)
        self.num_slots = num_slots
        self.ps_probe = ps_probe
        self.ps_restart = ps_restart
        self.ps_probe_interval = float(ps_probe_interval)
        self.max_ps_restarts = max(0, int(max_ps_restarts))
        self.on_item_failure = on_item_failure
        self.report = SupervisorReport()
        self._queue: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        # PS supervision gets its own lock: a health probe (network
        # timeout) or snapshot (full weight copy) must serialize restarts
        # without stalling item bookkeeping under self._lock
        self._ps_lock = threading.Lock()
        # restart generation + timestamp: workers co-felled by ONE
        # outage all deserve the free retry, but only the first one's
        # probe still sees a dead server — the rest match on a recent
        # restart instead (once per shard per generation)
        self._ps_generation = 0
        self._ps_restart_time: Optional[float] = None
        self._shard_ps_gen: Dict[int, int] = {}
        self._trace_ctx = None             # captured by run()
        self._done = threading.Event()
        self._stop_monitor = threading.Event()
        self._outstanding = 0
        self._fatal: Optional[BaseException] = None
        # process-wide counters mirroring the per-fit report: the report
        # answers "what did THIS fit survive", the registry answers "how
        # often does this fleet member restart things" across fits
        reg = default_registry()
        self._m_failures = reg.counter(
            "supervisor_worker_failures_total",
            "worker failures observed by the supervisor")
        self._m_restarts = reg.counter(
            "supervisor_restarts_total",
            "shard re-executions after a worker failure")
        self._m_reassigned = reg.counter(
            "supervisor_shards_reassigned_total",
            "shard re-queues onto surviving slots")
        self._m_lost = reg.counter(
            "supervisor_shards_lost_total",
            "shards dropped under the 'continue' policy")
        self._m_completed = reg.counter(
            "supervisor_shards_completed_total",
            "shards that finished successfully")
        self._m_ps_restarts = reg.counter(
            "supervisor_ps_restarts_total",
            "parameter-server snapshot restarts performed")

    # ------------------------------------------------------------------ run
    def run(self, shards: Sequence) -> SupervisorReport:
        """Execute every shard; return the report. Raises the first
        fatal error (policy ``fail``, an exhausted restart budget, or a
        lost quorum) after running work has drained."""
        shards = list(shards)
        # the fit's trace context: stamped on the report and restored in
        # every slot/monitor thread (contextvars do not cross threads),
        # so fault events and PS RPCs fired by workers carry the
        # caller's trace id
        self._trace_ctx = current_context()
        self.report.trace_id = current_trace_id()
        if not shards:
            return self.report
        self._outstanding = len(shards)
        for idx, shard in enumerate(shards):
            self._queue.put((idx, shard, 0))
        n_slots = min(len(shards), self.num_slots or len(shards))
        slots = [threading.Thread(target=self._slot_loop, args=(s,),
                                  daemon=True,
                                  name=f"elephas-tpu-supervisor-{s}")
                 for s in range(n_slots)]
        monitor = None
        if self.ps_probe is not None and self.ps_restart is not None:
            monitor = threading.Thread(target=self._monitor_loop,
                                       daemon=True,
                                       name="elephas-tpu-ps-monitor")
            monitor.start()
        for t in slots:
            t.start()
        try:
            self._done.wait()
        finally:
            self._stop_monitor.set()
            for t in slots:
                t.join()
            if monitor is not None:
                monitor.join()
        if self._fatal is not None:
            raise self._fatal
        if self.policy == "continue":
            total = len(shards)
            ok = len(self.report.completed_shards)
            if ok < self.min_workers * total:
                raise QuorumLostError(
                    f"only {ok}/{total} shards completed — below the "
                    f"min_workers quorum of {self.min_workers:.0%}; lost "
                    f"shards: {sorted(self.report.lost_shards)}")
        return self.report

    # ---------------------------------------------------------- slot loop
    def _slot_loop(self, slot: int):
        set_context(self._trace_ctx)       # inherit the fit's context
        while not self._done.is_set():
            try:
                item = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            idx, shard, attempt = item
            try:
                self.run_shard(slot, idx, shard, attempt)
            except BaseException as err:  # noqa: BLE001 — policy decides
                self._on_failure(idx, shard, attempt, err)
            else:
                with self._lock:
                    self.report.completed_shards.append(idx)
                self._m_completed.inc()
                self._finish_item()

    def _finish_item(self):
        with self._lock:
            self._outstanding -= 1
            if self._outstanding <= 0:
                self._done.set()

    # ------------------------------------------------------------ failures
    def _on_failure(self, idx: int, shard, attempt: int,
                    err: BaseException):
        _LOG.warning("shard %d failed on attempt %d: %r", idx, attempt, err)
        self._m_failures.inc()
        with self._lock:
            self.report.failures.append((idx, attempt, repr(err)))

        # a dead parameter server is not the worker's fault: restart it
        # (caller-provided, snapshot-based) and re-run the shard without
        # consuming its restart budget — and without notifying
        # on_item_failure, so the retry keeps the worker's aggregator
        # seat (re-reported epochs are idempotent per member)
        if self._ps_recovered(err, idx):
            with self._lock:
                self.report.restarts += 1
                self.report.reassigned_shards.append(idx)
            self._m_restarts.inc()
            self._m_reassigned.inc()
            self._queue.put((idx, shard, attempt))
            return

        if self.on_item_failure is not None:
            try:
                self.on_item_failure(idx, attempt, err)
            except Exception:  # an observer must never mask the policy
                _LOG.exception("on_item_failure observer raised")

        if self.policy == "fail":
            # pre-supervisor semantics: the remaining dispatched shards
            # still run (drain), then the first error aborts the fit
            self._trip_fatal(err)
        elif self.policy == "reassign":
            if attempt < self.max_worker_restarts:
                with self._lock:
                    self.report.restarts += 1
                    self.report.reassigned_shards.append(idx)
                self._m_restarts.inc()
                self._m_reassigned.inc()
                self._queue.put((idx, shard, attempt + 1))
            else:
                _LOG.error("shard %d exhausted its %d restart(s)",
                           idx, self.max_worker_restarts)
                self._trip_fatal(err)
        else:  # continue: drop the shard, quorum checked at the end
            with self._lock:
                self.report.lost_shards.append(idx)
            self._m_lost.inc()
            self._finish_item()

    def _trip_fatal(self, err: BaseException):
        with self._lock:
            if self._fatal is None:
                self._fatal = err
        self._finish_item()

    # ----------------------------------------------------------- PS watch
    #: window after a restart in which a transport-failed worker is
    #: attributed to the outage that restart healed (client retries
    #: spanning the restart succeed on their own; only deadlines that
    #: expired just before/around it land here)
    _PS_GRACE_S = 10.0

    def _ps_recovered(self, err: BaseException, idx: int) -> bool:
        """If PS supervision is wired and the server is down (or was
        just restarted), give shard ``idx`` a free retry. True iff the
        failure is attributed to a PS outage.

        Only a TRANSPORT failure counts as a death signal — a worker
        that died of its own bug (shape mismatch, OOM) must not combine
        with timed-out probes on a busy-but-live server into a
        destructive snapshot restart. A live restart demands TWO failed
        probes (``confirm=2``); workers co-felled by the SAME outage
        arrive after the first one's restart and match on the recent
        restart generation instead (once per shard per generation, so a
        shard failing for its own reasons can't free-retry forever)."""
        if self.ps_probe is None or self.ps_restart is None:
            return False
        # transport errors only (the clients wrap exhausted retries in
        # ConnectionError): a broad OSError would misattribute local I/O
        # failures — a deleted shard file — to the PS outage
        if not isinstance(err, (ConnectionError, TimeoutError)):
            return False
        import time as _time

        with self._ps_lock:
            if (self._ps_restart_time is not None
                    and _time.monotonic() - self._ps_restart_time
                    < self._PS_GRACE_S
                    and self._shard_ps_gen.get(idx) != self._ps_generation):
                self._shard_ps_gen[idx] = self._ps_generation
                return True
        if self._try_restart("", confirm=2):
            with self._ps_lock:
                self._shard_ps_gen[idx] = self._ps_generation
            return True
        return False

    #: gap between confirmation probes (dead servers refuse instantly, so
    #: this mostly prices the overloaded-but-alive case)
    _CONFIRM_GAP_S = 0.3

    def _try_restart(self, context: str, confirm: int = 1) -> bool:
        """Probe under the PS lock and, if the server looks dead for
        ``confirm`` consecutive probes, restart it and record the
        restart. The one shared probe→restart→record sequence for both
        the worker-failure path and the background monitor."""
        import time as _time

        with self._ps_lock:
            # serialize probe+restart: concurrent failing workers must
            # trigger ONE restart, and the later ones must observe it.
            # The budget check lives INSIDE the lock: checked outside,
            # N concurrently-failing workers could each pass it and
            # overshoot max_ps_restarts by N-1 against a flapping server
            if self._ps_budget_spent():
                return False  # let the worker policy decide
            try:
                for i in range(max(1, confirm)):
                    if self.ps_probe():
                        return False
                    if i + 1 < confirm:
                        _time.sleep(self._CONFIRM_GAP_S)
                self.ps_restart()
                self._ps_generation += 1
                self._ps_restart_time = _time.monotonic()
                with self._lock:
                    self.report.ps_restarts += 1
                self._m_ps_restarts.inc()
                _LOG.warning("parameter server restarted from snapshot%s",
                             context)
                return True
            except Exception:
                _LOG.exception("parameter-server restart failed")
                return False

    def _ps_budget_spent(self) -> bool:
        with self._lock:
            return self.report.ps_restarts >= self.max_ps_restarts

    def _monitor_loop(self):
        """Background PS health cadence: catches a PS death even while
        every worker is busy inside a long RPC retry, so the restart
        lands before client deadlines expire.

        Restarting a live server is destructive (it rolls acked updates
        back to the latest snapshot), so the monitor demands TWO
        consecutive failed probes — plus :meth:`_try_restart`'s own
        under-lock confirmation — before acting; a single timed-out
        probe on a loaded but healthy server must not trigger it."""
        set_context(self._trace_ctx)       # inherit the fit's context
        suspect = 0
        while not self._stop_monitor.wait(self.ps_probe_interval):
            try:
                if self._ps_budget_spent():
                    _LOG.error(
                        "parameter server restarted %d times and keeps "
                        "dying — giving up on PS supervision; worker "
                        "failures now fall to the %r policy",
                        self.max_ps_restarts, self.policy)
                    return
                with self._ps_lock:
                    if self._done.is_set():
                        return
                    healthy = self.ps_probe()
                if healthy:
                    suspect = 0
                    continue
                suspect += 1
                if suspect < 2:
                    continue  # one blip is not evidence of death
                if self._try_restart(" (background probe)"):
                    suspect = 0
            except Exception:
                _LOG.exception("parameter-server monitor probe failed")
