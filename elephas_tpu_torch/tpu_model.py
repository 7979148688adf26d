"""TPUModel: the distributed training, inference and evaluation API.

The counterpart of ``elephas_tpu/tpu_model.py`` for
``mode="synchronous"``, on the master model's device:

- ``sync_mode="average"`` (the default): the reference's model
  averaging, each worker training a full copy on its partition and the
  deltas averaged once (:class:`~elephas_tpu_torch.parallel.
  sync_trainer.SyncAverageTrainer`);
- ``sync_mode="step"``: per-step synchronous SGD
  (:class:`~elephas_tpu_torch.parallel.sync_trainer.SyncStepTrainer`).

Distributed predict keeps the input order (contiguous chunks);
distributed evaluate is the sample-count-weighted reduction. A
:class:`~elephas_tpu_torch.models.transformer_model.TransformerModel`
goes to its own ``fit``/``predict``/``evaluate``.

``num_workers=None`` takes the dataset's partition count, which
defaults to the number of visible CUDA devices (1 on one card; the JAX
package's default is ``jax.device_count()``).

Not ported yet, and raising ``NotImplementedError``:
``mode="asynchronous"`` (the JAX signature's default) and
``"hogwild"``, with the parameter server behind them
(``start_server``/``stop_server``), wait for ROADMAP Queue 1 item 4;
``save`` waits for the saving slice (Queue 1 item 3), which must pick a
format (the JAX package writes h5 through h5py). There is one process:
the JAX package's multi-host hooks have no counterpart.
"""
from typing import Dict, List, Optional, Union

import numpy as np

from .data.dataset import Dataset
from .models import deserialize_optimizer, serialize_optimizer
from .models.core import BaseModel
from .models.transformer_model import TransformerModel
from .utils.dataset_utils import to_dataset

_ASYNC = ("asynchronous", "hogwild")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 "
                               "item 4: async/hogwild training and the "
                               "parameter server)")


class TPUModel:
    """Distributed model: train/predict/evaluate on the model's device.

    :param model: compiled and built
        :class:`~elephas_tpu_torch.models.Sequential`,
        :class:`~elephas_tpu_torch.models.Model` or
        :class:`~elephas_tpu_torch.models.TransformerModel`
    :param mode: ``synchronous``; ``asynchronous`` (the default, as in
        the JAX signature) and ``hogwild`` raise ``NotImplementedError``
    :param num_workers: worker/partition count (defaults to dataset
        partitioning, which defaults to the CUDA device count)
    :param custom_objects: registry for custom layers/activations/losses
    :param batch_size: training/inference batch size default
    :param sync_mode: ``average`` (reference model-averaging semantics) or
        ``step`` (per-step sync SGD)
    """

    def __init__(self, model, mode: str = "asynchronous",
                 frequency: str = "epoch", parameter_server_mode: str = "http",
                 num_workers: Optional[int] = None,
                 custom_objects: Optional[Dict] = None, batch_size: int = 32,
                 port: int = 4000, *args, **kwargs):
        if mode in _ASYNC:
            raise _not_ported(f"mode={mode!r}")
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
        self.kwargs = kwargs

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
        config.update(self.kwargs)
        return config

    @property
    def training_histories(self):
        return self._training_histories

    @property
    def master_network(self):
        return self._master_network

    @master_network.setter
    def master_network(self, network):
        self._master_network = network

    def start_server(self):
        raise _not_ported("the parameter server")

    def stop_server(self):
        raise _not_ported("the parameter server")

    def save(self, file_name: str, overwrite: bool = False,
             to_hadoop: bool = False):
        raise NotImplementedError(
            "TPUModel.save is not ported yet (ROADMAP Queue 1 item 3: the "
            "saving slice chooses a format; the JAX package writes h5)")

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
        if self.mode != "synchronous":
            raise ValueError(
                "Choose from one of the modes: asynchronous, synchronous "
                "or hogwild")
        if isinstance(self._master_network, TransformerModel):
            self._fit_transformer(dataset, **kwargs)
            return
        ds = self._as_dataset(dataset)
        if self.num_workers:
            ds = ds.repartition(self.num_workers)
        self._fit(ds, **kwargs)

    def _fit(self, ds: Dataset, **kwargs):
        train_config = dict(kwargs)
        train_config.setdefault("batch_size", self.batch_size)
        self._refresh_replica()

        # per-epoch hooks for sync_mode='step' (its epoch loop runs
        # here); one round-level epoch_end for model averaging
        from .models.callbacks import CallbackList

        cbs = CallbackList(train_config.pop("callbacks", None),
                           self._master_network)
        self._master_network.stop_training = False
        cbs.train_begin()
        histories_before = len(self._training_histories)
        try:
            if self.sync_mode == "step":
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
        callbacks, history and seed pass through)."""
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
