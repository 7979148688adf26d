"""Asynchronous training workers.

The counterpart of ``elephas_tpu/worker.py`` for the parameter-server
modes. :class:`AsyncWorker` runs the reference's executor loop: pull
the global weights from the parameter server, train locally for one
epoch (or one batch), push the weight delta. Workers run as threads of
the driver process, each on the device its driver assigns (the master
model's device); the current CUDA device is set inside the worker's own
thread, since it is per-thread state.

- The reference loops (``frequency="epoch"`` and ``"batch"``) keep the
  reference's round trip: every pull is a ``set_weights`` (a
  host-to-device copy) and every push reads ``get_weights`` (a
  device-to-host copy, which waits for the device).
- With ``overlap=True`` (or ``accum_batches > 1``) the batch-frequency
  loop keeps the trainable parameters, the state and the optimizer
  state on the device between steps, accumulates the delta there for
  ``accum_batches`` steps, computes ``base - current`` on the device and
  makes one device-to-host copy per window; a background
  :class:`_AsyncCommunicator` thread pushes deltas and prefetches fresh
  global weights (double-buffered), and batches reach the device through
  :func:`~elephas_tpu_torch.utils.prefetch.prefetch_to_device`.

A worker keeps one model for its whole fit, so its optimizer state
survives every pull, as in the JAX package. The JAX package's
``SyncWorker`` has no caller there and is not ported.
"""
import queue
import threading
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .models import deserialize_optimizer
from .models.core import _trainable_copy, model_from_json, train_step
from .parameter import BaseParameterClient
from .utils.faults import fault_site
from .utils.functional_utils import subtract_params, tree_subtract
from .utils.prefetch import prefetch_to_device
from .utils.tensor_codec import KIND_DELTA as _KIND_DELTA
from .utils.tensor_codec import KIND_DELTA_Q8 as _KIND_DELTA_Q8
from .weights import tree_leaves, tree_map


class _AsyncCommunicator:
    """Background RPC thread owning the parameter-server client.

    Commands (``push`` a delta, ``pull`` fresh weights) execute FIFO off
    the compute thread, so device steps overlap wire I/O. Pulled weights
    land in a single-slot "latest" buffer the compute loop adopts at its
    next accumulation boundary — classic double buffering. A transport
    error parks the thread and re-raises on the compute thread's next
    interaction, preserving the client's failure-detection semantics.
    """

    #: max queued commands — a slower-than-compute server back-pressures
    #: the training loop instead of accumulating unbounded host copies of
    #: the weights in the queue
    MAX_QUEUED = 8

    def __init__(self, client: BaseParameterClient):
        self.client = client
        self._cmds: "queue.Queue" = queue.Queue(maxsize=self.MAX_QUEUED)
        self._latest: Optional[tuple] = None
        self._pushes_done = 0
        self._lock = threading.Lock()
        self._fresh = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="elephas-tpu-async-comm")
        self._thread.start()

    def _run(self):
        while True:
            cmd = self._cmds.get()
            if cmd is None:
                return
            kind, payload = cmd
            try:
                if kind == "push":
                    self.client.update_parameters(payload)
                    self._pushes_done += 1
                elif kind == "push_frame":
                    self.client.push_frame(*payload)
                    self._pushes_done += 1
                else:
                    weights = self.client.get_parameters()
                    with self._lock:
                        # tag the snapshot with how many of OUR pushes it
                        # reflects (FIFO: every push queued before this
                        # pull has executed) — the compute loop must not
                        # adopt a snapshot missing its own latest push,
                        # which would roll back local progress
                        self._latest = (weights, self._pushes_done)
                    self._fresh.set()
            except BaseException as err:  # surfaced on the compute thread
                self._error = err
                self._fresh.set()  # unblock a waiting take_latest
                return

    def _check(self):
        if self._error is not None:
            raise self._error

    def _put(self, cmd):
        # bounded put that can't deadlock against a dead comm thread:
        # re-check the error flag while waiting for queue space
        while True:
            self._check()
            try:
                self._cmds.put(cmd, timeout=0.5)
                return
            except queue.Full:
                continue

    def push(self, delta: List[np.ndarray]):
        self._put(("push", delta))

    def push_frame(self, arrays: List[np.ndarray], kind: int):
        """Queue an already-built update frame (compressed pushes: the
        worker's ErrorFeedback quantized once; no re-quantization on
        this thread)."""
        self._put(("push_frame", (arrays, kind)))

    def request_pull(self):
        self._put(("pull", None))

    def take_latest(self, block: bool = False,
                    timeout: Optional[float] = None
                    ) -> Optional[tuple]:
        """Consume the freshest pulled weights as ``(weights,
        pushes_reflected)``, or None if no pull completed since the last
        take. ``pushes_reflected`` counts this worker's own pushes the
        snapshot is guaranteed to include."""
        if block:
            self._fresh.wait(timeout)
        self._check()
        with self._lock:
            snapshot, self._latest = self._latest, None
            self._fresh.clear()
        return snapshot

    def close(self):
        """Drain queued pushes, stop the thread, re-raise any error."""
        if self._error is None:
            self._put(None)
        self._thread.join()
        self._check()


class _PipelinedPusher:
    """One-slot pipelined delta pusher for the reference-parity loops.

    The push for batch/epoch *k* runs on a background thread over its
    OWN cloned client (own persistent connection), overlapping the pull
    and gradient computation for *k+1*. ``submit`` first waits for the
    previous in-flight push — at most ONE push is outstanding, so a
    pull can miss at most the single racing push (bounded staleness 1,
    on top of what asynchronous SGD already tolerates). A push error is
    parked and re-raised at the next sync point (``submit``/``drain``),
    so the worker fails exactly as the blocking loop would and the
    supervisor's crash/restart semantics are unchanged.
    """

    def __init__(self, client: BaseParameterClient):
        self.client = client.clone()
        self._owns_client = self.client is not client
        self._slot: "queue.Queue" = queue.Queue(maxsize=1)
        self._idle = threading.Event()
        self._idle.set()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="elephas-tpu-ps-pipeline")
        self._thread.start()

    def _run(self):
        while True:
            item = self._slot.get()
            if item is None:
                return
            arrays, kind = item
            try:
                try:
                    self.client.push_frame(arrays, kind)
                except NotImplementedError:
                    # in-memory doubles implement only update_parameters;
                    # an uncompressed frame IS the delta list
                    self.client.update_parameters(arrays)
            except BaseException as err:  # noqa: BLE001 — re-raised at sync
                self._error = err
            finally:
                self._idle.set()

    def _sync(self):
        """Wait for the in-flight push; re-raise its error exactly once."""
        self._idle.wait()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def submit(self, arrays: List[np.ndarray], kind: int):
        """Hand a push to the background thread after the previous one
        lands — the caller blocks only when the wire is slower than
        compute (the same back-pressure the blocking loop has)."""
        self._sync()
        self._idle.clear()
        self._slot.put((arrays, kind))

    def drain(self):
        """Block until the wire is quiet (epoch boundaries, final flush)."""
        self._sync()

    def close(self):
        """Flush the in-flight push, stop the thread, release the
        cloned connection. Re-raises a parked error unless a prior sync
        already surfaced it (a finally-path close must not mask the
        loop's own exception with a second raise of the same error)."""
        try:
            self._sync()
        finally:
            self._slot.put(None)
            self._thread.join()
            if self._owns_client:
                self.client.close()


def _snapshot(params: Dict) -> Dict:
    """Detached copies of a parameter tree: the overlapped loop trains
    its leaves in place, so a window's base must not alias them."""
    return tree_map(lambda t: t.detach().clone(), params)


class AsyncWorker:
    """Asynchronous worker: exchanges weight deltas with a parameter server
    at epoch or batch frequency (parity: ``elephas/worker.py:52-131``).

    :param device: the device this worker's model lives on (``None``
        means the CUDA device); the driver passes the master model's
    :param overlap: run the batch-frequency loop with a background RPC
        thread and device-resident parameters (throughput configuration)
    :param accum_batches: accumulate the weight delta on the device for
        this many steps before pushing (1 = push every batch, as the
        reference does)
    :param pipeline: double-buffer pushes in the reference-parity loops:
        the delta push for batch/epoch *k* runs on a background thread
        (own connection) while *k+1* computes — one in-flight push max,
        staleness bounded at 1, push errors re-raised at the next sync
        point. Subsumed by ``overlap``/``accum_batches`` only at BATCH
        frequency (where the overlapped communicator runs and already
        pipelines); epoch-frequency fits keep the pusher regardless.
    :param epoch_event: optional ``(epoch_idx, mean_loss_or_None)`` hook
        fired after each local epoch — the driver aggregates these into
        real per-epoch callbacks across workers
    :param should_stop: optional predicate polled at epoch boundaries;
        True ends training early (EarlyStopping reaching into the
        workers)
    :param compute_dtype: the master's mixed-precision setting
        (``"bfloat16"`` or None), passed to the worker model's compile
    """

    def __init__(self, json_config: str, parameters: List[np.ndarray],
                 client: Union[BaseParameterClient, str],
                 train_config: Dict[str, Any], frequency: str,
                 master_optimizer, master_loss, master_metrics,
                 custom_objects: Optional[Dict] = None, port: int = 4000,
                 overlap: bool = False, accum_batches: int = 1,
                 pipeline: bool = False,
                 epoch_event=None, should_stop=None,
                 compute_dtype: Optional[str] = None,
                 device: DeviceLike = None):
        if isinstance(client, BaseParameterClient):
            # own transport state per worker: N workers must not
            # serialize their RPCs over the driver's one connection
            self.client = client.clone()
        else:
            self.client = BaseParameterClient.get_client(client, port)
        self.json = json_config
        self.parameters = parameters
        self.train_config = dict(train_config)
        self.frequency = frequency
        self.master_optimizer = master_optimizer
        self.master_loss = master_loss
        self.master_metrics = master_metrics
        self.custom_objects = custom_objects or {}
        self.compute_dtype = compute_dtype
        self.overlap = overlap
        self.accum_batches = max(1, int(accum_batches))
        self.pipeline = bool(pipeline)
        self._pusher: Optional[_PipelinedPusher] = None
        self.epoch_event = epoch_event
        self.should_stop = should_stop or (lambda: False)
        self.device = resolve_device(device)
        self.model = None
        # EF-SGD residual carrier when the client compresses pushes:
        # per-worker state, so each worker corrects its own rounding
        if getattr(self.client, "compression", None):
            from .utils.delta_compression import ErrorFeedback

            self._ef = ErrorFeedback()
        else:
            self._ef = None

    def _push(self, delta):
        """Push a delta, routing through error feedback when the wire
        quantizes (keeps the server-side sum unbiased). The EF preview
        frame IS the wire frame — one quantization pass per push. With
        ``pipeline=True`` the frame is handed to the background pusher
        instead of blocking the loop (EF still quantizes HERE, on the
        compute thread, so residuals stay ordered)."""
        if self._ef is not None:
            self._ef.apply(delta)
            if self._pusher is not None:
                self._pusher.submit(self._ef.last_frame, _KIND_DELTA_Q8)
            else:
                self.client.push_frame(self._ef.last_frame, _KIND_DELTA_Q8)
        elif self._pusher is not None:
            # uncompressed frame (compression implies EF above)
            self._pusher.submit(delta, _KIND_DELTA)
        else:
            self.client.update_parameters(delta)

    def _emit(self, epoch: int, loss: Optional[float]):
        if self.epoch_event is not None:
            self.epoch_event(epoch, loss)

    def train(self, x_train: np.ndarray, y_train: np.ndarray):
        if x_train.size == 0:
            return
        if self.device.type == "cuda":
            # the current device is per-thread state: set it in the
            # worker's own thread, so every tensor and launch of this
            # worker lands on its device
            with torch.cuda.device(self.device):
                return self._train_pinned(x_train, y_train)
        return self._train_pinned(x_train, y_train)

    def _train_pinned(self, x_train: np.ndarray, y_train: np.ndarray):
        fault_site("worker.train")  # chaos hook: crash/stall a worker
        # the overlapped schedule's communicator already pipelines, but
        # it only runs for BATCH frequency — epoch-frequency fits keep
        # the pusher even when overlap/accum flags are set, otherwise
        # ps_pipeline would be silently dropped there
        overlapped = (self.frequency == "batch"
                      and (self.overlap or self.accum_batches > 1))
        if self.pipeline and not overlapped:
            # this pusher is the lightweight upgrade for the
            # reference-parity loops
            self._pusher = _PipelinedPusher(self.client)
            try:
                return self._train_loops(x_train, y_train)
            finally:
                pusher, self._pusher = self._pusher, None
                pusher.close()
        return self._train_loops(x_train, y_train)

    def _train_loops(self, x_train: np.ndarray, y_train: np.ndarray):
        self.model = model_from_json(self.json, self.custom_objects,
                                     device=self.device)
        self.model.compile(optimizer=deserialize_optimizer(self.master_optimizer),
                           loss=self.master_loss, metrics=self.master_metrics,
                           custom_objects=self.custom_objects,
                           compute_dtype=self.compute_dtype)
        self.model.set_weights(self.parameters)

        train_config = dict(self.train_config)
        epochs = train_config.get("epochs", 1)
        batch_size = train_config.get("batch_size", 32)
        nb_train_sample = x_train.shape[0]
        nb_batch = int(np.ceil(nb_train_sample / float(batch_size)))
        batches = [(i * batch_size, min(nb_train_sample, (i + 1) * batch_size))
                   for i in range(nb_batch)]

        if self.frequency == "epoch":
            for epoch in range(epochs):
                if self.should_stop():
                    break
                fault_site("worker.epoch")  # chaos hook: die mid-fit
                weights_before = self.client.get_parameters()
                self.model.set_weights(weights_before)
                history = None
                if x_train.shape[0] > batch_size:
                    per_epoch = dict(train_config)
                    per_epoch["epochs"] = 1
                    history = self.model.fit(x_train, y_train, **per_epoch)
                weights_after = self.model.get_weights()
                self._push(subtract_params(weights_before, weights_after))
                loss = (history.history["loss"][-1]
                        if history and history.history.get("loss") else None)
                self._emit(epoch, loss)
        elif self.frequency == "batch":
            if self.overlap or self.accum_batches > 1:
                if x_train.shape[0] > batch_size:
                    self._train_batches_overlapped(x_train, y_train, epochs,
                                                   batches)
                else:
                    # too small to train, but still a participant: keep
                    # the driver's epoch aggregation complete
                    for epoch in range(epochs):
                        if self.should_stop():
                            break
                        self._emit(epoch, None)
                return
            for epoch in range(epochs):
                if self.should_stop():
                    break
                fault_site("worker.epoch")  # chaos hook: die mid-fit
                losses = []
                if x_train.shape[0] > batch_size:
                    for batch_start, batch_end in batches:
                        weights_before = self.client.get_parameters()
                        self.model.set_weights(weights_before)
                        vals = self.model.train_on_batch(
                            x_train[batch_start:batch_end],
                            y_train[batch_start:batch_end])
                        losses.append(vals[0] if isinstance(vals, list)
                                      else float(vals))
                        weights_after = self.model.get_weights()
                        self._push(
                            subtract_params(weights_before, weights_after))
                self._emit(epoch,
                           float(np.mean(losses)) if losses else None)
        else:
            raise ValueError(
                "frequency parameter can be `epoch` or `batch`, got {}".format(
                    self.frequency))

    def _train_batches_overlapped(self, x_train, y_train, epochs, batches):
        """Batch-frequency loop, device schedule: device-resident
        parameters and optimizer state, delta accumulation over
        ``accum_batches`` steps, and RPCs on a background thread
        (double-buffered weights).

        Semantics vs the reference loop: the pulled global weights a
        window trains from may be one push older than the server's very
        latest (the price of not blocking compute on the pull) — a
        staleness already inherent to asynchronous SGD.
        """
        model = self.model
        device = model.device
        entries = model._weight_entries()
        shapes = [tuple(model.params[ln][pn].shape) for ln, pn in entries]
        splits = np.cumsum([int(np.prod(s)) for s in shapes])[:-1]

        def as_params(weights):
            new = {ln: dict(lp) for ln, lp in model.params.items()}
            for (ln, pn), w in zip(entries, weights):
                new[ln][pn] = torch.as_tensor(
                    np.asarray(w), dtype=new[ln][pn].dtype).to(device)
            return new

        def as_weights(params):
            # the one device->host transfer per window: every leaf of the
            # delta in one flat buffer, split on the host
            flat = torch.cat([params[ln][pn].reshape(-1)
                              for ln, pn in entries]).cpu().numpy()
            return [a.reshape(s) for a, s in zip(np.split(flat, splits),
                                                 shapes)]

        x_all = model._prepare_x(x_train)
        y_all = model._prepare_y(y_train)
        step_args = (model, model._tx, model._loss_fn, model._metric_fns)
        gen = model._train_generator()

        def adopt(weights):
            model.params = as_params(weights)
            trainable, state = model._split_params(model.params)
            return _trainable_copy(trainable), state

        comm = _AsyncCommunicator(self.client)
        try:
            comm.request_pull()
            base_weights, _ = comm.take_latest(block=True)
            trainable, state = adopt(base_weights)
            opt_state = model._tx.init(tree_leaves(trainable))
            base = _snapshot(model._merge_params(trainable, state))

            window = 0
            pushes_issued = 0
            pending: Dict[int, List[np.ndarray]] = {}  # seq -> host delta
            for epoch in range(epochs):
                if self.should_stop():
                    break
                fault_site("worker.epoch")  # chaos hook: die mid-fit
                epoch_losses = []
                batch_iter = prefetch_to_device(
                    ((x_all[s:e], y_all[s:e]) for s, e in batches), size=2,
                    device=device)
                for xb, yb in batch_iter:
                    opt_state, stats = train_step(*step_args, trainable,
                                                  state, opt_state, xb, yb,
                                                  gen=gen)
                    # device scalar, no sync
                    epoch_losses.append(stats[0] / stats[1])
                    window += 1
                    if window < self.accum_batches:
                        continue
                    window = 0
                    with torch.no_grad():
                        current = model._merge_params(trainable, state)
                        host_delta = as_weights(tree_subtract(base, current))
                    if self._ef is not None:
                        # pending must hold what the server APPLIES (the
                        # dequantized push), or the snapshot correction
                        # drifts by the quantization error; the EF frame
                        # ships as-is (one quantization per push)
                        self._ef.apply(host_delta)
                        comm.push_frame(self._ef.last_frame,
                                        _KIND_DELTA_Q8)
                        applied = self._ef.last_on_wire
                    else:
                        comm.push(host_delta)
                        applied = host_delta
                    pushes_issued += 1
                    pending[pushes_issued] = applied
                    comm.request_pull()  # FIFO: pull sees our push applied
                    fresh = comm.take_latest(block=False)
                    if fresh is not None:
                        # adopt the snapshot (peer updates included),
                        # corrected by our own pushes it can't reflect
                        # yet — the server applies them regardless, so
                        # subtracting locally keeps our trajectory intact
                        # (1-worker case: adopted == current, exactly)
                        snap_weights, reflected = fresh
                        pending = {s: d for s, d in pending.items()
                                   if s > reflected}
                        adopted = [np.array(w) for w in snap_weights]
                        for d in pending.values():
                            adopted = [a - dd for a, dd in zip(adopted, d)]
                        trainable, state = adopt(adopted)
                    # else: the pull is not back yet; train on from the
                    # local state
                    base = _snapshot(model._merge_params(trainable, state))
                # one host sync per epoch: the mean loss for the driver's
                # aggregated epoch_end logs
                self._emit(epoch, float(torch.stack(epoch_losses)
                                        .double().mean()))
            # flush a partial window so no training is lost
            if window:
                with torch.no_grad():
                    current = model._merge_params(trainable, state)
                    host_delta = as_weights(tree_subtract(base, current))
                if self._ef is not None:
                    self._ef.apply(host_delta)
                    comm.push_frame(self._ef.last_frame, _KIND_DELTA_Q8)
                else:
                    comm.push(host_delta)
        finally:
            comm.close()
        model.params = model._merge_params(trainable, state)
