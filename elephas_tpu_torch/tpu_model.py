"""TPUModel: the distributed training, inference and evaluation API.

The counterpart of ``elephas_tpu/tpu_model.py``, on the master model's
device:

- ``mode="synchronous"``: ``sync_mode="average"`` (the default), the
  reference's model averaging, each worker training a full copy on its
  partition and the deltas averaged once (:class:`~elephas_tpu_torch.
  parallel.sync_trainer.SyncAverageTrainer`); ``sync_mode="step"``,
  per-step synchronous SGD (:class:`~elephas_tpu_torch.parallel.
  sync_trainer.SyncStepTrainer`).
- ``mode="asynchronous"`` (the default) and ``"hogwild"``: training
  through one parameter server (``parameter_server_mode`` ``"http"`` or
  ``"socket"``) with the reference's pull/train/push loop at ``epoch``
  or ``batch`` frequency (:class:`~elephas_tpu_torch.worker.
  AsyncWorker`), its overlapped device-resident loop
  (``async_overlap``, ``async_accum``), ``ps_pipeline``, int8
  ``delta_compression``, the elastic supervision policies and
  ``ps_auto_restart``. Workers are threads of this process; each builds
  its model on the master model's device (round-robin over the CUDA
  devices when the master is on one). Per-epoch callbacks fire when
  every worker has finished the epoch (:class:`_EpochAggregator`).

Distributed predict keeps the input order (contiguous chunks);
distributed evaluate is the sample-count-weighted reduction. A
:class:`~elephas_tpu_torch.models.transformer_model.TransformerModel`
goes to its own ``fit``/``predict``/``evaluate``, in synchronous mode
only, as in the JAX package.

``num_workers=None`` takes the dataset's partition count, which
defaults to the number of visible CUDA devices (1 on one card; the JAX
package's default is ``jax.device_count()``).

``save`` writes the master model and the distributed config into one
model file (:mod:`~elephas_tpu_torch.models.saving`: a zip where the JAX
package writes HDF5), optionally pushed with ``hadoop fs`` or to an
object store; :func:`load_tpu_model` rebuilds a :class:`TPUModel` or
:class:`TPUMatrixModel` from it, or from a file the JAX package wrote
(where ``h5py`` is installed). :class:`TPUMatrixModel` trains on
LabeledPoint datasets and predicts on the ``mllib`` types.

There is one process: the JAX package's multi-host hooks (the
coordinator's address broadcast and the barriers of its ``_fit_async``)
have no counterpart: the one process serves the parameter server. Not ported
yet, and raising ``NotImplementedError``: a sharded parameter plane
(``ps_shards > 1``) and hot standbys (``ps_standby``), ROADMAP Queue 1
item 4's remainder.
"""
import json
import subprocess
import threading
import time
import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional, Union
from uuid import uuid4

import numpy as np
import torch

from ._device import DeviceLike
from .data.dataset import Dataset
from .mllib.adapter import from_matrix, from_vector, to_matrix, to_vector
from .mllib.linalg import Matrix, Vector
from .models import deserialize_optimizer, serialize_optimizer
from .models import saving
from .models.core import BaseModel
from .models.transformer_model import TransformerModel
from .parameter.factory import (create_sharded_client, create_sharded_server,
                                get_transport)
from .utils.dataset_utils import lp_to_dataset, to_dataset
from .utils.serialization import model_to_dict
from .worker import AsyncWorker


def _temp_model_path(file_name: str) -> str:
    """Unique local staging filename carrying ``file_name``'s suffix —
    used for hadoop/object-store transfers in both directions."""
    return str(uuid4()) + "-temp-model-file." + file_name.split(".")[-1]


def _run_hadoop(cli, detail: str = ""):
    """Run a ``hadoop fs`` command, raising on ANY failure — a missing
    CLI or non-zero exit must never read as success (the reference
    swallows both, ``spark_model.py:127-134``)."""
    suffix = f" {detail}" if detail else ""
    try:
        proc = subprocess.run(cli, capture_output=True, text=True)
    except FileNotFoundError:
        raise RuntimeError(
            f"hadoop CLI not found — cannot run {' '.join(cli)}{suffix}")
    if proc.returncode != 0:
        raise RuntimeError(
            f"{' '.join(cli[:3])} failed (rc={proc.returncode}): "
            f"{proc.stderr.strip() or proc.stdout.strip()}{suffix}")


def _check_suffix(file_name: str):
    if not file_name.endswith((".h5", ".keras")):
        raise ValueError("File name must end with either '.h5' or '.keras'")


class _EpochAggregator:
    """Turns per-worker epoch completions into driver-level epoch_end.

    Each async worker reports ``(epoch, mean_loss)`` after its local
    epoch; when all participants have reported epoch k the aggregator
    fires ``on_epoch(k, logs)`` (on the last reporter's thread — workers
    train concurrently, so a worker can only reach epoch k+1 after
    emitting its own k event, which keeps firings ordered). ``on_epoch``
    returning True latches the stop flag every worker polls at its epoch
    boundaries — EarlyStopping that actually stops asynchronous training
    mid-run.

    A dead worker must not park every callback forever: the supervisor
    calls :meth:`remove_participant` when it declares a worker failed,
    which shrinks the quorum and immediately fires any epoch the
    survivors have already completed. (A copy of the JAX package's.)
    """

    def __init__(self, participants: int, on_epoch):
        self.participants = max(1, participants)
        self.on_epoch = on_epoch
        self._lock = threading.Lock()
        self._counts: Dict[int, int] = {}
        self._losses: Dict[int, List[float]] = {}
        self._fired: set = set()
        self._member_epochs: Dict[Any, set] = {}
        self._stop = threading.Event()

    def _fire_locked(self, epoch: int):
        # fire under the lock: callbacks mutate the master network,
        # and serializing here keeps reports cheap (callbacks are
        # epoch-granular)
        self._fired.add(epoch)
        losses = self._losses.pop(epoch, [])
        logs = {"loss": float(np.mean(losses))} if losses else {}
        if self.on_epoch(epoch, logs):
            self._stop.set()

    def report(self, epoch: int, loss: Optional[float], member=None):
        with self._lock:
            if epoch in self._fired:
                return  # late report for an epoch fired after a removal
            if member is not None:
                seen = self._member_epochs.setdefault(member, set())
                if epoch in seen:
                    # idempotent per member: a re-run of the same shard
                    # (after a PS restart) re-reports epochs it already
                    # counted — they must not stand in for other members
                    return
                seen.add(epoch)
            self._counts[epoch] = self._counts.get(epoch, 0) + 1
            if loss is not None:
                self._losses.setdefault(epoch, []).append(float(loss))
            if (self.participants <= 0
                    or self._counts[epoch] < self.participants):
                return
            self._fire_locked(epoch)

    def remove_participant(self, member=None):
        """A participant died: shrink the quorum and fire every pending
        epoch the survivors have already fully reported — the stall fix
        for EarlyStopping waiting on a dead worker.

        The dead member's own reports are retracted from unfired epochs
        first (its ``member`` key as passed to :meth:`report`): a count
        it contributed must not stand in for a live survivor still
        mid-epoch, or the epoch would fire early."""
        with self._lock:
            self.participants -= 1
            for epoch in self._member_epochs.pop(member, ()):
                if epoch not in self._fired and self._counts.get(epoch, 0):
                    self._counts[epoch] -= 1
            if self.participants <= 0:
                return  # nobody left; the supervisor policy decides
            for epoch in sorted(self._counts):
                if (epoch not in self._fired
                        and self._counts[epoch] >= self.participants):
                    self._fire_locked(epoch)

    def rejoin_if_empty(self) -> bool:
        """Re-register one participant iff every participant has been
        removed. A re-run normally reports no epoch events (its dead
        predecessor's role is gone), but when NOBODY is left reporting
        — single-worker fit, or a blip that felled every worker — the
        retry must take the role back or callbacks go silently dead for
        the rest of the fit."""
        with self._lock:
            if self.participants > 0:
                return False
            self.participants = 1
            return True

    def should_stop(self) -> bool:
        return self._stop.is_set()


class TPUModel:
    """Distributed model: train/predict/evaluate on the model's device.

    :param model: compiled and built
        :class:`~elephas_tpu_torch.models.Sequential`,
        :class:`~elephas_tpu_torch.models.Model` or
        :class:`~elephas_tpu_torch.models.TransformerModel`
    :param mode: ``asynchronous`` (default), ``synchronous`` or ``hogwild``
    :param frequency: ``epoch`` or ``batch`` — async update granularity
    :param parameter_server_mode: ``http`` or ``socket``
    :param num_workers: worker/partition count (defaults to dataset
        partitioning, which defaults to the CUDA device count)
    :param custom_objects: registry for custom layers/activations/losses
    :param batch_size: training/inference batch size default
    :param port: parameter-server port
    :param sync_mode: ``average`` (reference model-averaging semantics) or
        ``step`` (per-step sync SGD)
    :param async_overlap: batch frequency: the overlapped loop, with
        device-resident parameters and RPCs on a background thread
    :param async_accum: batch frequency: push one delta per this many
        steps, accumulated on the device (1 = every batch)
    :param delta_compression: ``None`` or ``"int8"`` (pushes quantized
        on the wire; each worker carries its error-feedback residual)
    :param on_worker_failure: async/hogwild failure policy —
        ``reassign`` (default: a failed worker's shard is re-run on a
        surviving slot, bounded by ``max_worker_restarts`` per shard),
        ``fail`` (fail-fast) or ``continue`` (drop the shard while at
        least a ``min_workers`` fraction of shards completes)
    :param ps_auto_restart: supervise the parameter server too: snapshot
        it while healthy and restart it from the latest snapshot on the
        same port if it dies mid-fit (probed every
        ``ps_probe_interval`` seconds); workers reconnect via retry
    :param ps_pipeline: double-buffer delta pushes in the
        reference-parity worker loops: the push for batch/epoch *k*
        overlaps computation of *k+1* (one in-flight push max, staleness
        bounded at 1, errors surfaced at the next sync point)
    :param ps_shards: ``1``; more raise ``NotImplementedError``
        (ROADMAP Queue 1 item 4)
    :param ps_standby: needs ``ps_shards >= 2``, so it raises too
    """

    def __init__(self, model, mode: str = "asynchronous",
                 frequency: str = "epoch", parameter_server_mode: str = "http",
                 num_workers: Optional[int] = None,
                 custom_objects: Optional[Dict] = None, batch_size: int = 32,
                 port: int = 4000, *args, **kwargs):
        self._training_histories: List = []
        self._master_network = model
        if not model.compiled:
            raise Exception(
                "Compile your model before initializing an elephas_tpu model "
                "with it")
        if not model.built:
            raise Exception(
                "Build your model (known input shape) before initializing an "
                "elephas_tpu model with it")
        self.mode = mode
        self.frequency = frequency
        self.num_workers = num_workers
        self.master_optimizer = serialize_optimizer(model.optimizer)
        self.master_loss = model.loss
        self.master_metrics = list(model.metrics or [])
        self.custom_objects = custom_objects or {}
        self.parameter_server_mode = parameter_server_mode
        self.batch_size = batch_size
        self.port = port
        self.sync_mode = kwargs.pop("sync_mode", "average")
        if self.sync_mode not in ("average", "step"):
            raise ValueError(
                "sync_mode must be 'average' or 'step', got "
                f"{self.sync_mode!r}")
        # async throughput knobs (batch frequency): background RPC overlap
        # + on-device delta accumulation window (1 = reference semantics)
        self.async_overlap = bool(kwargs.pop("async_overlap", False))
        self.async_accum = max(1, int(kwargs.pop("async_accum", 1)))
        # int8 delta compression on the PS wire (~4x fewer push bytes;
        # workers carry EF residuals so training stays unbiased)
        self.delta_compression = kwargs.pop("delta_compression", None)
        if self.delta_compression not in (None, "int8"):
            raise ValueError("delta_compression must be None or 'int8', "
                             f"got {self.delta_compression!r}")
        from .parallel.supervisor import POLICIES

        self.on_worker_failure = kwargs.pop("on_worker_failure", "reassign")
        if self.on_worker_failure not in POLICIES:
            raise ValueError(
                f"on_worker_failure must be one of {POLICIES}, "
                f"got {self.on_worker_failure!r}")
        self.max_worker_restarts = max(
            0, int(kwargs.pop("max_worker_restarts", 2)))
        self.min_workers = float(kwargs.pop("min_workers", 0.5))
        if not (0.0 < self.min_workers <= 1.0):
            # fail at construction, not mid-fit after the PS is up
            raise ValueError(
                f"min_workers must be in (0, 1], got {self.min_workers}")
        self.ps_auto_restart = bool(kwargs.pop("ps_auto_restart", False))
        self.ps_probe_interval = float(kwargs.pop("ps_probe_interval", 2.0))
        if self.ps_probe_interval <= 0:
            # fail at construction: 0 would busy-spin the PS monitor
            raise ValueError(
                f"ps_probe_interval must be > 0, got "
                f"{self.ps_probe_interval}")
        self.max_ps_restarts = max(0, int(kwargs.pop("max_ps_restarts", 5)))
        self.ps_shards = int(kwargs.pop("ps_shards", 1))
        if self.ps_shards < 1:
            raise ValueError(f"ps_shards must be >= 1, got {self.ps_shards}")
        self.ps_pipeline = bool(kwargs.pop("ps_pipeline", False))
        self.ps_standby = bool(kwargs.pop("ps_standby", False))
        if self.ps_standby and self.ps_shards < 2:
            raise ValueError(
                "ps_standby requires a sharded plane (ps_shards >= 2); "
                "single-server recovery is snapshot-restart")
        self.kwargs = kwargs

        self.serialized_model = None
        self.parameter_server = None
        self.client = None
        # an LM trains synchronously only (fit raises for the async
        # modes, as in the JAX package), so it gets no parameter server
        if (self.mode != "synchronous"
                and not isinstance(model, TransformerModel)):
            self.serialized_model = model_to_dict(model)
            # ps_shards > 1 and ps_standby raise NotImplementedError here
            self.parameter_server = create_sharded_server(
                self.parameter_server_mode, self.serialized_model,
                self.port, self.mode, self.ps_shards,
                standby=self.ps_standby,
                custom_objects=self.custom_objects)
            self.client = self._make_client()

        self._replica = None  # lazily-built worker replica for predict/eval
        self._replica_arch = None
        self._replica_src = None  # master params the replica last adopted

    # ------------------------------------------------------------------ admin
    def get_config(self) -> Dict:
        config = {
            "parameter_server_mode": self.parameter_server_mode,
            "mode": self.mode,
            "frequency": self.frequency,
            "num_workers": self.num_workers,
            "batch_size": self.batch_size,
        }
        if self.sync_mode != "average":
            config["sync_mode"] = self.sync_mode
        if self.async_overlap:
            config["async_overlap"] = True
        if self.async_accum != 1:
            config["async_accum"] = self.async_accum
        if self.on_worker_failure != "reassign":
            config["on_worker_failure"] = self.on_worker_failure
        if self.max_worker_restarts != 2:
            config["max_worker_restarts"] = self.max_worker_restarts
        if self.min_workers != 0.5:
            config["min_workers"] = self.min_workers
        if self.ps_auto_restart:
            config["ps_auto_restart"] = True
        if self.ps_probe_interval != 2.0:
            config["ps_probe_interval"] = self.ps_probe_interval
        if self.max_ps_restarts != 5:
            config["max_ps_restarts"] = self.max_ps_restarts
        if self.ps_shards != 1:
            config["ps_shards"] = self.ps_shards
        if self.ps_pipeline:
            config["ps_pipeline"] = True
        if self.ps_standby:
            config["ps_standby"] = True
        config.update(self.kwargs)
        return config

    @property
    def training_histories(self):
        return self._training_histories

    @property
    def master_compute_dtype(self) -> Optional[str]:
        """The master's compile-level mixed-precision dtype as its
        compile argument, read live so a recompile reaches the workers."""
        dt = getattr(self._master_network, "_compute_dtype", None)
        return "bfloat16" if dt == torch.bfloat16 else None

    @property
    def master_network(self):
        return self._master_network

    @master_network.setter
    def master_network(self, network):
        self._master_network = network

    def start_server(self):
        self.parameter_server.start()

    def _make_client(self):
        """A parameter client of the configured transport."""
        return create_sharded_client(
            self.parameter_server_mode, self.port, self.serialized_model,
            self.ps_shards, compression=self.delta_compression)

    def _ps_supervision(self):
        """(probe, restart) hooks for the worker supervisor's parameter-
        server watchdog. The probe snapshots the live server while it is
        healthy; restart rebuilds a server of the same transport on the
        same port from the latest snapshot and starts it — workers
        reconnect through the client retry path, with the idempotency
        window carried over so in-flight resends stay deduplicated."""
        state = {"snapshot": self.parameter_server.snapshot(),
                 "t": time.monotonic()}
        state["at"] = state["snapshot"]["num_updates"]
        # snapshotting copies every weight under the server's read lock;
        # during active training every probe would otherwise pay it, so
        # the copy cadence is floored well below the probe cadence (the
        # price: a restart rolls back at most this much progress)
        min_spacing = max(5 * self.ps_probe_interval, 2.0)

        def probe() -> bool:
            if not self.client.health_check():
                return False
            try:
                server = self.parameter_server
                now = time.monotonic()
                if (server.num_updates != state["at"]
                        and now - state["t"] >= min_spacing):
                    snap = server.snapshot()
                    state["snapshot"] = snap
                    state["at"] = snap["num_updates"]
                    state["t"] = now
            except Exception:
                pass  # keep serving the previous snapshot
            return True

        def restart():
            try:
                self.parameter_server.stop()  # release the port/threads
            except Exception:
                pass
            transport = get_transport(self.parameter_server_mode)
            server = transport.create_server(
                self.serialized_model, self.port, self.mode,
                custom_objects=self.custom_objects)
            server.restore(state["snapshot"])
            server.start()
            self.parameter_server = server

        return probe, restart

    def stop_server(self):
        if self.client is not None:
            self.client.close()  # drop the persistent PS connection
        self.parameter_server.stop()

    # ------------------------------------------------------------------- save
    def save(self, file_name: str, overwrite: bool = False,
             to_hadoop: bool = False):
        """Save the master model + distributed config in one model file,
        optionally pushing it to a Hadoop cluster (parity:
        ``elephas/spark_model.py:92-134``).

        ``file_name`` may also be an object-store URL (``gs://...``,
        ``s3://...``): the file is written locally and uploaded through
        the scheme's registered :mod:`~elephas_tpu_torch.utils.storage`
        adapter. A local file is replaced whatever ``overwrite`` says,
        as in the JAX package; an existing object raises unless
        ``overwrite``."""
        _check_suffix(file_name)
        from .utils.storage import get_store, is_remote

        remote_url = None
        if is_remote(file_name):
            if to_hadoop:
                raise ValueError("to_hadoop and an object-store URL are "
                                 "mutually exclusive")
            remote_url = file_name
            file_name = _temp_model_path(file_name)

        if to_hadoop:
            cluster_file_path = file_name
            file_name = _temp_model_path(file_name)

        entries = saving.model_entries(self._master_network)
        entries["distributed_config"] = saving.json_entry(json.dumps({
            "class_name": self.__class__.__name__,
            "config": self.get_config()}))
        saving.write_model_file(file_name, entries)

        if to_hadoop:
            cli = ["hadoop", "fs", "-moveFromLocal"]
            if overwrite:
                cli.append("-f")
            cli.extend([file_name, cluster_file_path])
            # a failed put must raise, not silently "succeed"
            _run_hadoop(cli, f"(local copy kept at {file_name})")
        elif remote_url is not None:
            store = get_store(remote_url)
            if not overwrite and store.exists(remote_url):
                Path(file_name).unlink()
                raise FileExistsError(
                    f"{remote_url} exists (pass overwrite=True)")
            try:
                store.put_file(file_name, remote_url)
            finally:
                Path(file_name).unlink(missing_ok=True)

    # ------------------------------------------------------------------- data
    @staticmethod
    def _as_dataset(data) -> Dataset:
        if isinstance(data, Dataset):
            ds = data
        elif isinstance(data, tuple) and len(data) == 2:
            ds = to_dataset(data[0], data[1])
        elif isinstance(data, np.ndarray):
            ds = Dataset((data,))
        elif isinstance(data, list):
            ds = Dataset.from_pairs(data)
        else:
            raise ValueError(f"Cannot interpret training data: {type(data)}")
        if not ds.is_columnar:
            ds = Dataset.from_pairs(ds.rows(), num_partitions=ds._num_partitions)
        return ds

    # -------------------------------------------------------------------- fit
    def fit(self, dataset: Union[Dataset, tuple], **kwargs):
        """Distributed training over a partitioned dataset.

        :param dataset: pair :class:`Dataset` or ``(features, labels)``
        :param epochs, batch_size, verbose, validation_split: as in Keras
        """
        if isinstance(self._master_network, TransformerModel):
            self._fit_transformer(dataset, **kwargs)
            return
        ds = self._as_dataset(dataset)
        if self.num_workers:
            ds = ds.repartition(self.num_workers)
        if self.mode in ("asynchronous", "synchronous", "hogwild"):
            self._fit(ds, **kwargs)
        else:
            raise ValueError(
                "Choose from one of the modes: asynchronous, synchronous "
                "or hogwild")

    def _fit(self, ds: Dataset, **kwargs):
        train_config = dict(kwargs)
        train_config.setdefault("batch_size", self.batch_size)
        self._refresh_replica()

        # per-epoch hooks for sync_mode='step' (its epoch loop runs
        # here) and the async modes (worker epoch events aggregated by
        # _EpochAggregator); one round-level epoch_end for model averaging
        from .models.callbacks import CallbackList

        cbs = CallbackList(train_config.pop("callbacks", None),
                           self._master_network)
        self._master_network.stop_training = False
        cbs.train_begin()
        histories_before = len(self._training_histories)
        try:
            if self.mode in ("asynchronous", "hogwild"):
                self._fit_async(ds, callbacks=cbs, **train_config)
            elif self.sync_mode == "step":
                self._fit_sync_step(ds, callbacks=cbs, **train_config)
            else:
                self._fit_sync_average(ds, **train_config)
                if cbs:
                    # the mean of each metric's final value across THIS
                    # fit's worker histories
                    sums: Dict[str, list] = {}
                    for hist in self._training_histories[histories_before:]:
                        for k, v in hist.items():
                            if v:
                                sums.setdefault(k, []).append(v[-1])
                    cbs.epoch_end(0, {k: float(np.mean(v))
                                      for k, v in sums.items()})
        finally:
            cbs.train_end()

    def _fit_transformer(self, data, epochs: int = 10,
                         batch_size: Optional[int] = None,
                         verbose: int = 0, validation_split: float = 0.1,
                         **kwargs):
        """Train the LM through its own ``fit`` (per-step synchronous SGD;
        callbacks, history and seed pass through). Parameter-server
        modes target the delta-exchange Keras-style models."""
        if self.mode != "synchronous":
            raise ValueError(
                "LM families train synchronously (per-step sync SGD "
                "over the device mesh); asynchronous/hogwild parameter-"
                "server modes apply to the Keras-style models")
        history = self._master_network.fit(
            self._extract_tokens(data), epochs=epochs,
            batch_size=batch_size or self.batch_size, verbose=verbose,
            validation_split=validation_split,
            callbacks=kwargs.pop("callbacks", None),
            seed=kwargs.get("seed", 0))
        self._training_histories.append(history)

    @staticmethod
    def _extract_tokens(data) -> np.ndarray:
        """Token rows from a Dataset / (tokens, labels) pair / array: LM
        targets are the shifted input, so any label column is ignored."""
        if isinstance(data, Dataset):
            return (data.columns[0] if data.is_columnar
                    else np.asarray(data.rows()))
        if isinstance(data, tuple) and len(data) == 2:
            data = data[0]
        return np.asarray(data)

    def _worker_metric_fns(self):
        from .models import metrics as metrics_mod

        return [metrics_mod.get(m, loss=self.master_loss,
                                custom_objects=self.custom_objects)
                for m in self.master_metrics]

    def _fit_sync_average(self, ds: Dataset, epochs: int = 10,
                          batch_size: int = 32, verbose: int = 0,
                          validation_split: float = 0.1, **kwargs):
        from .parallel.sync_trainer import SyncAverageTrainer

        trainer = SyncAverageTrainer(
            self._get_replica(), deserialize_optimizer(self.master_optimizer),
            self.master_loss, self._worker_metric_fns(), self.custom_objects)
        new_weights, histories = trainer.run(
            self._master_network.get_weights(), ds.partitions(),
            epochs=epochs, batch_size=batch_size,
            validation_split=validation_split, seed=kwargs.get("seed", 0))
        self._training_histories.extend(h for h in histories if h is not None)
        self._master_network.set_weights(new_weights)

    def _fit_sync_step(self, ds: Dataset, epochs: int = 10,
                       batch_size: int = 32, verbose: int = 0,
                       validation_split: float = 0.1, callbacks=None,
                       **kwargs):
        from .parallel.sync_trainer import SyncStepTrainer

        replica = self._get_replica()
        trainer = SyncStepTrainer(
            replica, deserialize_optimizer(self.master_optimizer),
            self.master_loss, self._worker_metric_fns(), self.custom_objects)
        x, y = ds.to_arrays()

        epoch_callback = None
        if callbacks:
            def epoch_callback(epoch_idx, logs):
                # the trainer synced the replica; the master adopts it so
                # callbacks observe the current weights
                self._master_network.set_weights(replica.get_weights())
                self._master_network._opt_state = replica._opt_state
                callbacks.epoch_end(epoch_idx, logs)
                return bool(self._master_network.stop_training)

        new_weights, history = trainer.fit(
            self._master_network.get_weights(), x, y, epochs=epochs,
            batch_size=batch_size, validation_split=validation_split,
            seed=kwargs.get("seed", 0), verbose=verbose,
            epoch_callback=epoch_callback)
        self._training_histories.append(history)
        if not (callbacks and epochs):
            self._master_network.set_weights(new_weights)
        # else: the master adopted each epoch's weights in epoch_callback,
        # and any callback mutation of them wins over the trainer result

    def _worker_devices(self) -> List[torch.device]:
        """The devices async workers run on, round-robin: every CUDA
        device when the master is on one (one on one card), else the
        master's own device."""
        device = self._master_network.device
        if device.type == "cuda":
            return [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        return [device]

    def _fit_async(self, ds: Dataset, epochs: int = 10, batch_size: int = 32,
                   verbose: int = 0, validation_split: float = 0.1,
                   callbacks=None, **kwargs):
        """Parameter-server training: start the server, run one
        :class:`AsyncWorker` per partition under a
        :class:`~elephas_tpu_torch.parallel.supervisor.WorkerSupervisor`,
        adopt the server's final weights, stop the server."""
        failure = None
        try:
            self.start_server()
            self._run_async_workers(ds, callbacks, {
                "epochs": epochs, "batch_size": batch_size,
                "verbose": verbose, "validation_split": validation_split})
            self._master_network.set_weights(self.client.get_parameters())
        except BaseException as err:
            failure = err
        try:
            self.stop_server()
        except Exception:
            if failure is None:
                raise
        if failure is not None:
            raise failure

    def _run_async_workers(self, ds: Dataset, callbacks, train_config):
        model_json = self._master_network.to_json()
        init = self._master_network.get_weights()
        shards = ds.partitions()

        # real per-epoch callbacks for async modes: workers emit epoch
        # events; when every participating (non-empty) worker finishes
        # epoch k, the driver pulls the live global weights off the PS
        # and fires epoch_end — so EarlyStopping observes current state
        # and can stop async training mid-run
        nonempty = [bool(shard[0].shape[0]) for shard in shards]
        aggregator = None
        cb_failure: Dict[str, BaseException] = {}
        if callbacks:
            participants = sum(nonempty)

            def on_epoch(epoch_idx, logs):
                try:
                    # cheap liveness probes first: on_epoch runs under
                    # the aggregator lock (including from the
                    # supervisor's failure path), so a dead PS must cost
                    # the probes, not a full pull-retry deadline, before
                    # degrading to the previous weights. Two chances: one
                    # timed-out probe on a busy-but-live server must not
                    # skip a pull.
                    if (self.client.health_check()
                            or self.client.health_check()):
                        self._master_network.set_weights(
                            self.client.get_parameters())
                    else:
                        warnings.warn(
                            "parameter server unreachable; callbacks see "
                            "the previous weights")
                except Exception as err:
                    warnings.warn(f"per-epoch weight pull failed ({err}); "
                                  "callbacks see the previous weights")
                try:
                    callbacks.epoch_end(epoch_idx, logs)
                except BaseException as err:  # noqa: BLE001
                    # a callback error must FAIL the fit, not leak into
                    # the reporting worker's thread (the supervisor would
                    # classify it as a worker crash and quietly reassign
                    # the shard, swallowing the exception)
                    cb_failure.setdefault("err", err)
                    return True  # stop every worker at its next epoch
                    # boundary; re-raised after the drain
                return bool(getattr(self._master_network, "stop_training",
                                    False))

            if participants:
                aggregator = _EpochAggregator(participants, on_epoch)

        devices = self._worker_devices()
        # shards whose aggregator seat was removed after a policy-level
        # failure; a re-run of one reports no epoch events (unless it
        # rejoins an emptied aggregator). A PS-restart free retry never
        # lands here, so it keeps its seat — per-member idempotent
        # reports make its re-reported epochs harmless.
        removed: set = set()
        removed_lock = threading.Lock()

        def run_shard(slot, shard_idx, shard, attempt):
            with removed_lock:
                attach = (aggregator is not None and nonempty[shard_idx]
                          and (shard_idx not in removed
                               or aggregator.rejoin_if_empty()))
                if attach:
                    # rejoining re-runs take the seat back (the
                    # sole-worker-crash case: without this, callbacks go
                    # silently dead for the fit)
                    removed.discard(shard_idx)
            x_w, y_w = shard
            worker = AsyncWorker(
                model_json, init, self.client, train_config, self.frequency,
                self.master_optimizer, self.master_loss, self.master_metrics,
                self.custom_objects, port=self.port,
                compute_dtype=self.master_compute_dtype,
                overlap=self.async_overlap, accum_batches=self.async_accum,
                pipeline=self.ps_pipeline,
                epoch_event=((lambda e, l, _m=shard_idx:
                              aggregator.report(e, l, member=_m))
                             if attach else None),
                should_stop=aggregator.should_stop if aggregator else None,
                device=devices[slot % len(devices)])
            try:
                worker.train(np.asarray(x_w), np.asarray(y_w))
            finally:
                worker.client.close()

        def on_item_failure(shard_idx, attempt, error):
            # a failed worker leaves the epoch aggregator (once per
            # shard, however many times its re-runs fail); removing it
            # fires any epoch the survivors already completed, so
            # callbacks never stall on the dead
            if aggregator is None or not nonempty[shard_idx]:
                return
            with removed_lock:
                if shard_idx in removed:
                    return
                removed.add(shard_idx)
            aggregator.remove_participant(member=shard_idx)

        ps_probe = ps_restart = None
        if self.ps_auto_restart:
            ps_probe, ps_restart = self._ps_supervision()

        if not shards:
            return
        from .parallel.supervisor import WorkerSupervisor

        supervisor = WorkerSupervisor(
            run_shard, on_worker_failure=self.on_worker_failure,
            max_worker_restarts=self.max_worker_restarts,
            min_workers=self.min_workers, ps_probe=ps_probe,
            ps_restart=ps_restart, ps_probe_interval=self.ps_probe_interval,
            max_ps_restarts=self.max_ps_restarts,
            on_item_failure=on_item_failure)
        try:
            supervisor.run(shards)
        except BaseException as run_err:
            # a captured callback error is the ROOT cause (it stopped
            # the workers); a drain-time worker error must not mask it
            if cb_failure:
                raise cb_failure["err"] from run_err
            raise
        finally:
            # the report must survive a failed fit too — which shards
            # failed/restarted is exactly what the operator needs when
            # run() raises
            self._training_histories.append(
                {"supervisor": supervisor.report.as_dict()})
        if cb_failure:
            raise cb_failure["err"]

    # ------------------------------------------------------------ predict/eval
    def _refresh_replica(self):
        """Drop the replica only when the master's architecture changed;
        weights and compute dtype are re-synced per call by
        :meth:`_get_replica`."""
        arch = self._master_network.to_json()
        if self._replica is not None and arch != self._replica_arch:
            self._replica = None
        self._replica_arch = arch

    def _get_replica(self) -> BaseModel:
        """A worker copy of the master network on its device (the master
        stays untouched during distributed execution, as with the
        reference's broadcast)."""
        from .models.core import model_from_json

        master = self._master_network
        if self._replica is None:
            self._replica = model_from_json(master.to_json(),
                                            self.custom_objects,
                                            device=master.device)
            self._replica_src = None
        # mixed precision is compile-level config: carry it over
        self._replica._compute_dtype = master._compute_dtype
        # sync only when the master's params dict changed (set_weights
        # and fit always swap it)
        if self._replica_src is not master.params:
            self._replica.set_weights(master.get_weights())
            self._replica_src = master.params
        return self._replica

    def predict(self, data: Union[Dataset, np.ndarray],
                batch_size: Optional[int] = None,
                out: Union[None, str, np.ndarray] = None) -> np.ndarray:
        """Distributed inference; returns predictions in input order.

        ``out``: stream predictions into a preallocated array or (as a
        string) a ``.npy`` file created with ``open_memmap``."""
        from .parallel.sync_trainer import build_sharded_predict

        if isinstance(self._master_network, TransformerModel):
            tokens = self._extract_tokens(data)
            if isinstance(out, str):
                out = np.lib.format.open_memmap(
                    out, mode="w+",
                    shape=(int(tokens.shape[0]), int(tokens.shape[1]),
                           int(self._master_network.config.vocab_size)),
                    dtype=np.float32)
            return self._master_network.predict(
                tokens, batch_size=batch_size or self.batch_size, out=out)
        if isinstance(data, Dataset):
            x = data.columns[0] if data.is_columnar else np.asarray(data.rows())
        else:
            x = np.asarray(data)
        replica = self._get_replica()
        if isinstance(out, str):
            out = np.lib.format.open_memmap(
                out, mode="w+",
                shape=(int(x.shape[0]),) + tuple(replica.output_shape),
                dtype=np.float32)
        return build_sharded_predict(replica)(
            x, batch_size=batch_size or max(self.batch_size, 256), out=out)

    def evaluate(self, x_test: np.ndarray, y_test: np.ndarray,
                 **kwargs) -> Union[List[float], float]:
        """Distributed evaluation: sample-count-weighted loss/metric means."""
        from .parallel.sync_trainer import build_sharded_evaluate

        if isinstance(self._master_network, TransformerModel):
            return self._master_network.evaluate(
                np.asarray(x_test),
                batch_size=kwargs.get("batch_size", self.batch_size))
        evaluate = build_sharded_evaluate(
            self._get_replica(), self.master_loss, self._worker_metric_fns(),
            self.custom_objects)
        return evaluate(np.asarray(x_test), np.asarray(y_test),
                        batch_size=kwargs.get("batch_size",
                                              max(self.batch_size, 256)))


class TPUMatrixModel(TPUModel):
    """Distributed model over LabeledPoint datasets and dense linalg types
    (capability mirror of ``SparkMLlibModel``,
    ``elephas/spark_model.py:311-352``)."""

    def __init__(self, model: BaseModel, mode: str = "asynchronous",
                 frequency: str = "epoch", parameter_server_mode: str = "http",
                 num_workers: int = 4, custom_objects: Optional[Dict] = None,
                 batch_size: int = 32, port: int = 4000, *args, **kwargs):
        super().__init__(model=model, mode=mode, frequency=frequency,
                         parameter_server_mode=parameter_server_mode,
                         num_workers=num_workers,
                         custom_objects=custom_objects,
                         batch_size=batch_size, port=port, *args, **kwargs)

    def fit(self, labeled_points: Dataset, epochs: int = 10,
            batch_size: int = 32, verbose: int = 0,
            validation_split: float = 0.1, categorical: bool = False,
            nb_classes: Optional[int] = None):
        """Train on a Dataset of LabeledPoints."""
        ds = lp_to_dataset(labeled_points, categorical, nb_classes)
        ds = ds.repartition(self.num_workers)
        self._fit(ds, epochs=epochs, batch_size=batch_size, verbose=verbose,
                  validation_split=validation_split)

    def predict(self, mllib_data: Union[Matrix, Vector]):
        """Predict on a dense Matrix or Vector, returning the same type."""
        if isinstance(mllib_data, Matrix):
            return to_matrix(self._master_network.predict(
                from_matrix(mllib_data)))
        if isinstance(mllib_data, Vector):
            return to_vector(self._master_network.predict(
                from_vector(mllib_data)[None, :])[0])
        raise ValueError(
            f"Provide either a Matrix or Vector, got {type(mllib_data)}")


def load_tpu_model(file_name: str, from_hadoop: bool = False,
                   custom_objects: Optional[Dict] = None,
                   device: DeviceLike = None
                   ) -> Union[TPUModel, TPUMatrixModel]:
    """Load a distributed model saved by :meth:`TPUModel.save` (this
    package's or the JAX package's), its master model on ``device``
    (None means the CUDA device; pass ``device="cpu"`` for the CPU)
    (parity: ``elephas/spark_model.py:355-389``). Object-store URLs
    (``gs://``, ``s3://``) download through the scheme's registered
    :mod:`~elephas_tpu_torch.utils.storage` adapter."""
    from .utils.storage import get_store, is_remote

    _check_suffix(file_name)
    remote = is_remote(file_name)
    if from_hadoop and remote:
        raise ValueError("from_hadoop and an object-store URL are "
                         "mutually exclusive")
    temp_download = from_hadoop or remote
    if from_hadoop:
        temp_file = _temp_model_path(file_name)
        _run_hadoop(["hadoop", "fs", "-copyToLocal", file_name, temp_file])
        file_name = temp_file
    elif remote:
        temp_file = _temp_model_path(file_name)
        get_store(file_name).get_file(file_name, temp_file)
        file_name = temp_file
    try:
        entries = saving.read_model_file(file_name)
    finally:
        if temp_download:
            Path(file_name).unlink()
    model = saving.model_from_file(entries, custom_objects, device)
    elephas_conf = json.loads(entries["distributed_config"])
    class_name = elephas_conf.get("class_name")
    config = elephas_conf.get("config")
    if class_name == TPUModel.__name__:
        return TPUModel(model=model, **config)
    if class_name == TPUMatrixModel.__name__:
        return TPUMatrixModel(model=model, **config)
    raise ValueError(f"Unknown distributed model class {class_name!r}")
