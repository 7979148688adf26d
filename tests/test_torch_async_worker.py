"""The port's ``AsyncWorker`` and its overlapped loop.

Mirrors ``tests/integration/test_async_overlap.py``'s unit cases with an
in-memory parameter-server double: one push per accumulation window, a
partial window flushed, an error on the communicator thread raised on
the compute thread, and ``close`` draining the queued pushes. Then the
port's worker against the JAX package's on the same weights at one
worker, where the order of pulls and pushes is fixed: the reference
batch loop with a stateful optimizer (Adam, whose moments must survive
every pull), histories and final weights within 1e-5; and the
overlapped loop (``accum_batches=4``) within 1e-4, also when the
server's weights move between pulls as other workers' pushes would move
them; the reference loop with its pushes on the pipelined pusher
(``pipeline=True``), and both loops with int8 ``delta_compression``
(error feedback, and the overlapped loop's correction by what the
server applied). No dropout: the two packages draw from different
random streams.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from elephas_tpu import worker as jworker
from elephas_tpu.models import Adam as JAdam
from elephas_tpu.models import Dense as JDense
from elephas_tpu.models import Sequential as JSequential
from elephas_tpu.models import serialize_optimizer as jserialize
from elephas_tpu.parameter import BaseParameterClient as JBaseClient
from elephas_tpu.utils import delta_compression as jdc
from elephas_tpu_torch import SGD, Adam, Dense, Sequential
from elephas_tpu_torch.models import serialize_optimizer
from elephas_tpu_torch.parameter import BaseParameterClient
from elephas_tpu_torch.utils import delta_compression as tdc
from elephas_tpu_torch.utils.tensor_codec import KIND_DELTA_Q8
from elephas_tpu_torch.worker import (AsyncWorker, _AsyncCommunicator,
                                      _PipelinedPusher)


def _recording(base, dc):
    class Recording(base):
        """In-memory parameter server double: applies deltas to a weight
        store and counts RPCs (threadsafe, like the real servers). With
        ``compression="int8"`` the worker pushes int8 frames, which the
        double dequantizes as the servers do."""

        client_type = f"_recording_test_double_{base.__module__}"

        def __init__(self, weights, fail_after_pulls=None,
                     compression=None):
            self.weights = [np.array(w) for w in weights]
            self.pulls = 0
            self.pushes = 0
            self.fail_after_pulls = fail_after_pulls
            self.compression = compression
            #: the largest int8 step (scale) any push used
            self.max_step = 0.0
            self._lock = threading.Lock()

        def get_parameters(self):
            if (self.fail_after_pulls is not None
                    and self.pulls >= self.fail_after_pulls):
                raise ConnectionError("parameter server unreachable")
            with self._lock:
                self.pulls += 1
                return [w.copy() for w in self.weights]

        def update_parameters(self, delta):
            with self._lock:
                self.pushes += 1
                self.weights = [w - d for w, d in zip(self.weights, delta)]

        def push_frame(self, arrays, kind, update_id=None):
            if kind == KIND_DELTA_Q8:
                self.max_step = max([self.max_step]
                                    + [float(a[0]) for a in arrays[1::2]])
                arrays = dc.dequantize_delta(arrays)
            self.update_parameters(arrays)

        def health_check(self):
            return True

        def clone(self):
            return self   # one store: the double is the whole server

    return Recording


Recording = _recording(BaseParameterClient, tdc)
JRecording = _recording(JBaseClient, jdc)


def _model(opt=None):
    model = Sequential([Dense(16, activation="relu", input_dim=20),
                        Dense(4, activation="softmax")], device="cpu")
    model.compile(opt or SGD(learning_rate=0.05), "categorical_crossentropy",
                  seed=0)
    return model


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 20), dtype=np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
    return x, y


def _worker(model, client, cls=AsyncWorker, optimizer=None, epochs=2,
            batch_size=16, **kw):
    return cls(model.to_json(), model.get_weights(), client,
               {"epochs": epochs, "batch_size": batch_size, "verbose": 0},
               "batch", optimizer or serialize_optimizer(model.optimizer),
               model.loss, list(model.metrics or []), **kw)


def test_accumulation_pushes_once_per_window():
    model = _model()
    x, y = _data(64)
    client = Recording(model.get_weights())
    worker = _worker(model, client, overlap=True, accum_batches=4,
                     device="cpu")
    worker.train(x, y)
    # 4 steps per epoch, 2 epochs: exactly 2 full windows of 4; the
    # reference loop would push 8 times
    assert client.pushes == 2
    # the server's sum of deltas is the worker's whole movement
    for w_server, w_local in zip(client.weights, worker.model.get_weights()):
        np.testing.assert_allclose(w_server, w_local, atol=1e-5)


def test_partial_window_flushes():
    model = _model()
    x, y = _data(48)
    client = Recording(model.get_weights())
    worker = _worker(model, client, epochs=1, overlap=True, accum_batches=4,
                     device="cpu")
    worker.train(x, y)
    # 3 steps < one window of 4: the partial window is still pushed
    assert client.pushes == 1
    for w_server, w_local in zip(client.weights, worker.model.get_weights()):
        np.testing.assert_allclose(w_server, w_local, atol=1e-5)


def test_comm_thread_error_propagates():
    model = _model()
    x, y = _data(64)
    client = Recording(model.get_weights(), fail_after_pulls=1)
    worker = _worker(model, client, overlap=True, accum_batches=2,
                     device="cpu")
    with pytest.raises(ConnectionError):
        worker.train(x, y)


def test_communicator_close_flushes_pending_pushes():
    client = Recording([np.zeros(4, np.float32)])
    comm = _AsyncCommunicator(client)
    for _ in range(5):
        comm.push([np.ones(4, np.float32)])
    comm.close()
    assert client.pushes == 5
    np.testing.assert_allclose(client.weights[0], -5.0)


def test_worker_model_lives_on_the_requested_device():
    model = _model()
    x, y = _data(48)
    client = Recording(model.get_weights())
    worker = _worker(model, client, epochs=1, device="cpu")
    worker.train(x, y)
    assert all(t.device.type == "cpu"
               for lp in worker.model.params.values() for t in lp.values())
    assert client.pushes == 3 and client.pulls == 3


def _jax_twin(model):
    jm = JSequential([JDense(16, activation="relu", input_dim=20),
                      JDense(4, activation="softmax")])
    jm.compile(JAdam(learning_rate=0.01), "categorical_crossentropy", seed=0)
    jm.set_weights(model.get_weights())
    return jm


def _with_peers(base):
    """A double whose weights move by a fixed step before every pull,
    as other workers' pushes would move them."""
    class WithPeers(base):
        def get_parameters(self):
            with self._lock:
                self.weights = [w - 0.002 for w in self.weights]
            return super().get_parameters()

    return WithPeers


def land_each_push(monkeypatch):
    """Make the pipelined pusher of both packages wait for each push to
    land before the loop goes on, so that the next pull sees it and the
    order of pulls and pushes is fixed (the pushes still run on the
    pusher's thread)."""
    for pusher in (jworker._PipelinedPusher, _PipelinedPusher):
        submit = pusher.submit

        def landed(self, arrays, kind, _submit=submit):
            _submit(self, arrays, kind)
            self._sync()

        monkeypatch.setattr(pusher, "submit", landed)


@pytest.mark.parametrize("overlap,accum,tol,peers,pipeline,compression", [
    pytest.param(False, 1, 1e-5, False, False, None,
                 id="False-1-1e-05-False"),
    pytest.param(True, 4, 1e-4, False, False, None,
                 id="True-4-0.0001-False"),
    pytest.param(True, 4, 1e-4, True, False, None, id="True-4-0.0001-True"),
    pytest.param(False, 1, 1e-5, False, True, None, id="pipeline"),
    pytest.param(False, 1, 1e-5, False, False, "int8", id="int8"),
    pytest.param(True, 4, 1e-4, False, False, "int8", id="overlap-int8")])
def test_matches_the_jax_worker(overlap, accum, tol, peers, pipeline,
                                compression, monkeypatch):
    """One worker, batch frequency, Adam at 0.01: the epoch losses the
    workers report and the server's final weights. With ``peers`` the
    server's weights also move before every pull, so the overlapped
    loop adopts snapshots that hold updates besides its own; each window
    then waits for its pull (in both packages), so that every window
    adopts one and the two runs take the same path. With ``pipeline``
    the reference loop hands its pushes to the pipelined pusher, each
    landing before the next pull. With ``compression="int8"`` every
    push is an int8 frame carrying the worker's error feedback, and the
    overlapped loop waits for its pulls as with ``peers`` (its path
    then depends on whether a pull is back: the snapshot it adopts
    lags its own weights by the quantization residual). The two
    packages' deltas differ in their last float32 bit (each is a
    difference of two weights), which now and then rounds an element
    to the neighbouring int8 step; error feedback carries the
    difference into the next push, so the server's weights then agree
    within the largest step (scale) any push used rather than ``tol``.
    """
    model = _model(Adam(learning_rate=0.01))
    jm = _jax_twin(model)
    x, y = _data(96, seed=1)
    runs = []
    wrap = _with_peers if peers else (lambda cls: cls)
    if peers or (compression and overlap):
        for comm in (jworker._AsyncCommunicator, _AsyncCommunicator):
            take = comm.take_latest
            monkeypatch.setattr(
                comm, "take_latest",
                lambda self, block=False, timeout=None, _take=take:
                _take(self, True, timeout))
    if pipeline:
        land_each_push(monkeypatch)
    for cls, client_cls, m, opt, kw in (
            (jworker.AsyncWorker, wrap(JRecording), jm,
             jserialize(jm.optimizer), {}),
            (AsyncWorker, wrap(Recording), model, None, {"device": "cpu"})):
        client = client_cls(model.get_weights(), compression=compression)
        losses = []
        worker = _worker(m, client, cls=cls, optimizer=opt, epochs=3,
                         overlap=overlap, accum_batches=accum,
                         pipeline=pipeline,
                         epoch_event=lambda e, loss: losses.append(loss),
                         **kw)
        if compression:
            assert worker._ef is not None
        worker.train(x, y)
        runs.append((losses, client.weights, client.pushes,
                     client.max_step))
    (jl, jw, jp, js), (tl, tw, tp, ts) = runs
    # 6 steps x 3 epochs: 18 pushes, or 4 windows of 4 and a flushed 2
    assert jp == tp == (18 if accum == 1 else 5)
    assert len(tl) == len(jl) == 3 and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=0, atol=tol)
    assert (js > 0 and ts > 0) if compression else js == ts == 0
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a, b, rtol=0, atol=max(tol, js))
