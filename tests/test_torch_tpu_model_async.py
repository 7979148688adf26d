"""The port's ``TPUModel`` in ``asynchronous`` and ``hogwild`` mode.

The 8 parameter-server cells of the reference's oracle sweep
(``tests/integration/test_end_to_end.py``: mode x transport x
``num_workers`` None or 2, frequency ``epoch``, on the conftest's
Dropout-0.2 classification model): distributed predict's argmax equals
the master network's, distributed evaluate is within 0.01 of the
master's. Then one worker against the JAX ``TPUModel`` on the same
weights, where the order is fixed (batch frequency, and epoch frequency
with one batch per epoch; Adam, no dropout): the per-epoch losses the
callbacks see and the final weights within 1e-5, also with
``ps_pipeline`` and with int8 ``delta_compression``. Then the
supervision and callback plumbing: ``EarlyStopping`` stops the workers
through ``_EpochAggregator`` (the worker whose report fires the stopping
epoch pushes no further epoch; the other is held in step by nothing, so
a worker made late at ``worker.epoch`` lets it run all 10 epochs, 12
updates in both packages), a worker killed at
``fault_site("worker.epoch")`` is re-run under
``on_worker_failure="reassign"`` with the supervisor's report in
``training_histories``, dropped under ``"continue"`` (or the fit raises
when the ``min_workers`` quorum is lost) and raised under ``"fail"``, as
in the JAX package; a parameter server stopped mid-fit is restarted
from its snapshot under ``ps_auto_restart``; and a ``TransformerModel``
refuses the async modes with the JAX package's message.
"""
import collections
import threading
import time
from math import isclose

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from elephas_tpu.models import Adam as JAdam
from elephas_tpu.models import Dense as JDense
from elephas_tpu.models import EarlyStopping as JEarlyStopping
from elephas_tpu.models import LambdaCallback as JLambdaCallback
from elephas_tpu.models import SGD as JSGD
from elephas_tpu.models import Sequential as JSequential
from elephas_tpu.parallel.supervisor import QuorumLostError as JQuorumLost
from elephas_tpu.tpu_model import TPUModel as JTPUModel
from elephas_tpu.utils import delta_compression as jdc
from elephas_tpu.utils import faults as jfaults
from elephas_tpu.utils.dataset_utils import to_dataset as jto_dataset
from elephas_tpu.worker import AsyncWorker as JAsyncWorker
from elephas_tpu_torch import SGD, Adam, Dense, Sequential, TPUModel, to_dataset
from elephas_tpu_torch.models.callbacks import EarlyStopping, LambdaCallback
from elephas_tpu_torch.models.transformer_model import TransformerModel
from elephas_tpu_torch.parallel.supervisor import QuorumLostError
from elephas_tpu_torch.utils import delta_compression as tdc
from elephas_tpu_torch.utils import faults as tfaults
from elephas_tpu_torch.utils.faults import FaultPlan, clear_plan, install_plan
from elephas_tpu_torch.utils.sockets import free_port
from elephas_tpu_torch.worker import AsyncWorker
from tests.test_torch_async_worker import land_each_push
from tests.test_torch_tpu_model import _classification_model
from tests.test_torch_train import _configs
from tests.torch_one_thread import one_thread

SWEEP = [(mode, transport, workers)
         for mode in ("asynchronous", "hogwild")
         for transport in ("http", "socket")
         for workers in (None, 2)]


@pytest.mark.parametrize("mode,parameter_server_mode,num_workers", SWEEP)
def test_training_classification(mode, parameter_server_mode, num_workers,
                                 mnist_data):
    x_train, y_train, x_test, y_test = mnist_data
    model = _classification_model()
    model.compile(SGD(learning_rate=0.1), "categorical_crossentropy", ["acc"],
                  seed=0)
    tpu_model = TPUModel(model, frequency="epoch", num_workers=num_workers,
                         mode=mode,
                         parameter_server_mode=parameter_server_mode,
                         port=free_port())
    tpu_model.fit(to_dataset(x_train[:1000], y_train[:1000]), epochs=3,
                  batch_size=64, verbose=0, validation_split=0.1)
    workers = num_workers or 1
    report = tpu_model.training_histories[-1]["supervisor"]
    assert report["completed_shards"] == list(range(workers))
    # one push per worker and epoch reached the server
    assert tpu_model.parameter_server.num_updates == 3 * workers

    predictions = tpu_model.predict(x_test)
    master_preds = tpu_model.master_network.predict(x_test)
    assert predictions.shape == (len(x_test), 10)
    np.testing.assert_array_equal(predictions.argmax(1),
                                  master_preds.argmax(1))
    evals = tpu_model.evaluate(x_test, y_test)
    master_evals = tpu_model.master_network.evaluate(x_test, y_test)
    assert isclose(evals[0], master_evals[0], abs_tol=0.01)
    assert isclose(evals[1], master_evals[1], abs_tol=0.01)


def _pair():
    model = Sequential([Dense(16, activation="relu", input_dim=20),
                        Dense(4, activation="softmax")], device="cpu")
    model.compile(Adam(learning_rate=0.01), "categorical_crossentropy",
                  seed=0)
    jm = JSequential([JDense(16, activation="relu", input_dim=20),
                      JDense(4, activation="softmax")])
    jm.compile(JAdam(learning_rate=0.01), "categorical_crossentropy", seed=0)
    jm.set_weights(model.get_weights())
    return model, jm


def record_int8_steps(monkeypatch):
    """Wrap both packages' ``quantize_delta`` (what error feedback
    calls) to record the largest int8 step (scale) of any push."""
    steps = [0.0]
    for dc in (jdc, tdc):
        def recording(delta, _quantize=dc.quantize_delta):
            frame = _quantize(delta)
            steps[0] = max([steps[0]] + [float(a[0]) for a in frame[1::2]])
            return frame

        monkeypatch.setattr(dc, "quantize_delta", recording)
    return steps


@pytest.mark.parametrize("frequency,transport,rows,batch,extra", [
    pytest.param("batch", "socket", 64, 16, {}, id="batch-socket-64-16"),
    # 40 rows, 8 held out: one batch of 32 a local epoch
    pytest.param("epoch", "http", 40, 32, {}, id="epoch-http-40-32"),
    pytest.param("batch", "socket", 64, 16, {"ps_pipeline": True},
                 id="pipeline"),
    pytest.param("batch", "http", 64, 16, {"delta_compression": "int8"},
                 id="int8")])
def test_one_worker_matches_the_jax_tpu_model(frequency, transport, rows,
                                              batch, extra, monkeypatch):
    """With ``ps_pipeline`` each push lands before the next pull (the
    order is then fixed); with int8 ``delta_compression`` the weights
    agree within the largest int8 step any push used, as in
    ``test_torch_async_worker.py::test_matches_the_jax_worker``."""
    if extra.get("ps_pipeline"):
        land_each_push(monkeypatch)
    steps = (record_int8_steps(monkeypatch)
             if extra.get("delta_compression") else [0.0])
    model, jm = _pair()
    rng = np.random.default_rng(4)
    x = rng.random((rows, 20), dtype=np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, rows)]
    runs = []
    for tpu_cls, net, cb_cls, ds in (
            (JTPUModel, jm, JLambdaCallback, jto_dataset),
            (TPUModel, model, LambdaCallback, to_dataset)):
        losses = []
        tpu_model = tpu_cls(net, mode="asynchronous", frequency=frequency,
                            parameter_server_mode=transport, num_workers=1,
                            port=free_port(), **extra)
        tpu_model.fit(ds(x, y), epochs=3, batch_size=batch,
                      validation_split=0.2, callbacks=[cb_cls(
                          on_epoch_end=lambda e, logs: losses.append(
                              logs["loss"]))])
        runs.append((losses, net.get_weights()))
    (jl, jw), (tl, tw) = runs
    assert len(tl) == len(jl) == 3
    assert (steps[0] > 0) == bool(extra.get("delta_compression"))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5)
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a, b, rtol=0, atol=max(1e-5, steps[0]))


def _small_model():
    model = Sequential([Dense(8, activation="relu", input_dim=4), Dense(1)],
                       device="cpu")
    model.compile(SGD(learning_rate=0.05), "mse", seed=0)
    return model


def _regression_data(n=128):
    rng = np.random.default_rng(0)
    x = rng.random((n, 4), dtype=np.float32)
    return x, (x @ rng.random((4, 1), dtype=np.float32)).astype(np.float32)


def _count_pushes(monkeypatch, *worker_classes):
    """Count each worker thread's pushes (both packages' workers push
    from their supervisor slot's thread)."""
    pushes = collections.Counter()
    for cls in worker_classes:
        def counted(self, delta, _push=cls._push):
            pushes[threading.current_thread().name] += 1
            return _push(self, delta)

        monkeypatch.setattr(cls, "_push", counted)
    return pushes


def _early_stopping_fit(package, plan=None):
    """2 workers, 10 epochs at epoch frequency, patience 0 and an
    unbeatable min_delta: epoch 1 stops the fit. Returns the epochs that
    fired, the stopped epoch, the thread whose report fired each epoch
    and the server's update count."""
    if package == "port":
        net, tpu_cls, ds = _small_model(), TPUModel, to_dataset
        es_cls, cb_cls, faults = EarlyStopping, LambdaCallback, tfaults
    else:
        net = JSequential([JDense(8, activation="relu", input_dim=4),
                           JDense(1)])
        net.compile(JSGD(learning_rate=0.05), "mse", seed=0)
        tpu_cls, ds, es_cls = JTPUModel, jto_dataset, JEarlyStopping
        cb_cls, faults = JLambdaCallback, jfaults
    x, y = _regression_data()
    tpu_model = tpu_cls(net, mode="asynchronous", frequency="epoch",
                        parameter_server_mode="http", port=free_port(),
                        num_workers=2)
    events, firer = [], {}

    def on_epoch_end(epoch, logs):
        events.append(epoch)
        firer[epoch] = threading.current_thread().name

    es = es_cls(monitor="loss", patience=0, min_delta=1e9)
    if plan is not None:
        faults.install_plan(plan)
    try:
        tpu_model.fit(ds(x, y), epochs=10, batch_size=32,
                      validation_split=0.0,
                      callbacks=[cb_cls(on_epoch_end=on_epoch_end), es])
    finally:
        if plan is not None:
            faults.clear_plan()
    return events, es.stopped_epoch, firer, \
        tpu_model.parameter_server.num_updates


def test_early_stopping_stops_the_workers(monkeypatch):
    """With an unbeatable min_delta, patience 0 stops after epoch 1 of
    10: the aggregator fires epoch 1 once both workers reported it, on
    the thread of the last to report, and that worker, which checks the
    stop flag as it starts an epoch, pushes no third epoch. The other
    worker is held in step by nothing and may have run ahead, so the
    server's count is only below the 20 updates of an unstopped fit."""
    pushes = _count_pushes(monkeypatch, AsyncWorker)
    events, stopped, firer, updates = _early_stopping_fit("port")
    assert stopped == 1
    assert events == [0, 1]   # epochs 2..9 never fired
    assert pushes[firer[1]] == 2
    assert updates == sum(pushes.values()) < 20


@pytest.mark.parametrize("package", ["port", "jax"])
def test_early_stopping_with_a_late_worker(package, monkeypatch):
    """The first worker to start an epoch sleeps 2 s there (a ``delay``
    at ``worker.epoch``): the other runs all 10 epochs meanwhile, then
    the late one pushes epochs 0 and 1, fires epoch 1 and stops. 12
    updates in both packages (the reference's design: no barrier holds
    the workers in step), past the 4-6 a lockstep fit would give."""
    pushes = _count_pushes(monkeypatch, AsyncWorker, JAsyncWorker)
    faults = tfaults if package == "port" else jfaults
    plan = faults.FaultPlan([{"site": "worker.epoch", "action": "delay",
                              "delay": 2.0}])
    events, stopped, firer, updates = _early_stopping_fit(package, plan)
    assert plan.fired("worker.epoch")
    assert stopped == 1 and events == [0, 1]
    assert pushes[firer[1]] == 2
    assert sorted(pushes.values()) == [2, 10]
    assert updates == 12


def test_worker_crash_is_reassigned():
    x, y = _regression_data(256)
    model = _small_model()
    tpu_model = TPUModel(model, mode="hogwild", frequency="epoch",
                         parameter_server_mode="socket", num_workers=2,
                         port=free_port(), on_worker_failure="reassign")
    before = tpu_model.evaluate(x, y)
    # the first worker to reach an epoch boundary dies there, before its
    # first push
    plan = FaultPlan([{"site": "worker.epoch", "action": "error",
                       "times": 1, "message": "injected worker crash"}])
    install_plan(plan)
    try:
        tpu_model.fit(to_dataset(x, y), epochs=2, batch_size=16,
                      validation_split=0.0)
    finally:
        clear_plan()
    assert plan.fired("worker.epoch")
    report = tpu_model.training_histories[-1]["supervisor"]
    assert report["restarts"] == 1 and len(report["reassigned_shards"]) == 1
    assert report["completed_shards"] == [0, 1]
    assert report["lost_shards"] == [] and len(report["failures"]) == 1
    # both shards pushed both epochs, the crashed one on its re-run
    assert tpu_model.parameter_server.num_updates == 4
    assert tpu_model.evaluate(x, y) < before


def _jax_small_model():
    jm = JSequential([JDense(8, activation="relu", input_dim=4), JDense(1)])
    jm.compile(JSGD(learning_rate=0.05), "mse", seed=0)
    return jm


@pytest.mark.parametrize("policy,min_workers", [
    ("continue", 0.5), ("continue", 1.0), ("fail", 0.5)])
def test_worker_crash_under_the_other_policies(policy, min_workers):
    """The first worker to reach an epoch boundary dies there, in both
    packages. ``continue`` drops its shard and the other completes, or,
    when the ``min_workers`` quorum is every shard, the fit raises
    ``QuorumLostError``; ``fail`` lets the other shard finish and raises
    the crash. The supervisor's report and the server's updates agree
    with the JAX package's."""
    x, y = _regression_data(256)
    results = []
    for cls, net, ds, faults, quorum in (
            (JTPUModel, _jax_small_model(), jto_dataset, jfaults,
             JQuorumLost),
            (TPUModel, _small_model(), to_dataset, tfaults,
             QuorumLostError)):
        tpu_model = cls(net, mode="hogwild", frequency="epoch",
                        parameter_server_mode="socket", num_workers=2,
                        port=free_port(), on_worker_failure=policy,
                        min_workers=min_workers)
        plan = faults.FaultPlan([{"site": "worker.epoch", "action": "error",
                                  "times": 1,
                                  "message": "injected worker crash"}])
        faults.install_plan(plan)
        raised = None
        try:
            tpu_model.fit(ds(x, y), epochs=2, batch_size=16,
                          validation_split=0.0)
        except (quorum, ConnectionError) as err:
            raised = ("quorum" if isinstance(err, quorum)
                      else "injected worker crash" in str(err))
        finally:
            faults.clear_plan()
        assert plan.fired("worker.epoch")
        report = tpu_model.training_histories[-1]["supervisor"]
        results.append((raised, report["restarts"],
                        len(report["lost_shards"]),
                        len(report["completed_shards"]),
                        len(report["failures"]),
                        tpu_model.parameter_server.num_updates))
    expected = {("continue", 0.5): (None, 0, 1, 1, 1, 2),
                ("continue", 1.0): ("quorum", 0, 1, 1, 1, 2),
                ("fail", 0.5): (True, 0, 0, 1, 1, 2)}[policy, min_workers]
    assert results[1] == results[0] == expected


@pytest.mark.parametrize("transport", ["socket", "http"])
def test_ps_death_mid_fit_is_survived_by_a_restart(transport):
    """``ps_auto_restart``: the server is stopped mid-fit; the health
    probe sees it, the server is rebuilt on the same port from its
    latest snapshot, the workers reconnect through the client's retry
    path, and the fit completes with the loss still falling (as
    ``tests/parallel/test_supervisor.py`` holds the JAX package)."""
    x, y = _regression_data(256)
    tpu_model = TPUModel(_small_model(), mode="asynchronous",
                         frequency="epoch", parameter_server_mode=transport,
                         num_workers=2, port=free_port(),
                         ps_auto_restart=True, ps_probe_interval=0.1)
    before = tpu_model.evaluate(x, y)
    # pace the workers so that the stop lands mid-fit
    install_plan(FaultPlan([{"site": "worker.epoch", "action": "delay",
                             "delay": 0.15, "times": None}]))
    original = tpu_model.parameter_server
    result = {}

    def run_fit():
        try:
            tpu_model.fit(to_dataset(x, y), epochs=8, batch_size=16,
                          validation_split=0.0)
            result["outcome"] = "completed"
        except Exception as err:  # noqa: BLE001 — read by the asserts
            result["outcome"] = err

    fit = threading.Thread(target=run_fit)
    try:
        fit.start()
        deadline = time.monotonic() + 30
        while original.num_updates < 2:
            assert time.monotonic() < deadline, "the fit never pushed"
            time.sleep(0.02)
        original.stop()
        fit.join(timeout=120)
    finally:
        clear_plan()
    assert not fit.is_alive(), "the fit hung after the server stopped"
    assert result.get("outcome") == "completed", result
    report = tpu_model.training_histories[-1]["supervisor"]
    assert report["ps_restarts"] >= 1 and report["restarts"] == 0
    assert tpu_model.parameter_server is not original
    assert tpu_model.evaluate(x, y) < before


def test_transformer_refuses_the_async_modes():
    tm = TransformerModel(_configs()[1], device="cpu").compile(
        SGD(0.5), seed=3)
    tokens = np.random.default_rng(0).integers(0, 64, (8, 17))
    for mode in ("asynchronous", "hogwild"):
        with pytest.raises(ValueError, match="LM families train "
                           "synchronously"):
            TPUModel(tm, mode=mode).fit(tokens, epochs=1)
