"""Synchronous data-parallel training, on the model's device.

The counterpart of ``elephas_tpu/parallel/sync_trainer.py``, on one
device in this slice (data parallelism across several GPUs waits for
ROADMAP Queue 1 item 3's multi-GPU step):

- :class:`SyncAverageTrainer`: the reference's ``synchronous``
  semantics. Each worker trains a full copy of the model for all epochs
  on its partition, from the same start and with its own optimizer
  state; the new weights are the start minus the mean of the workers'
  deltas. The workers train in turn on the one device, the JAX
  package's own route for realistic partitions (``_run_per_batch``).
- :class:`SyncStepTrainer`: per-step synchronous SGD over the global
  batch.

BatchNormalization's moving statistics move with every step, as in the
JAX trainers; under the average they are averaged like the weights.
Conv models take the same per-batch loop as any other: the JAX
package's switch of conv models to a per-batch path works round an XLA
layout problem torch does not have, and its per-batch path computes the
arithmetic of its vmapped program, which is this loop's.

Both keep the JAX package's shard-size rules bit for bit: partitions
are padded to a common, batch-multiple length and the padding rows
carry sample weight 0; the validation split is the LAST fraction of
each partition; a partition no larger than one batch does not train
(its delta is zero, its history None); the delta mean runs over all
workers. Data lives on the device for the whole fit; batches are
sliced, shuffled (``torch.randperm`` with a device generator) and their
loss and metric sums accumulated there, and the host reads the sums
once per epoch.

:func:`build_sharded_predict` and :func:`build_sharded_evaluate` are the
order-preserving inference and sample-weighted evaluation of the
distributed API; on one device they are :meth:`BaseModel.predict` and
:meth:`BaseModel.evaluate` with the trainer's loss and metrics.
"""
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import losses as losses_mod
from ..models import metrics as metrics_mod
from ..models.core import (BaseModel, _trainable_copy, epoch_stats,
                           train_step)
from ..utils.tracing import StepTimer
from ..weights import tree_leaves


def _pad_to(arr: np.ndarray, size: int) -> np.ndarray:
    if arr.shape[0] == size:
        return arr
    pad = np.zeros((size - arr.shape[0],) + arr.shape[1:], dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def stack_shards(shards: Sequence[Tuple[np.ndarray, np.ndarray]],
                 pad_multiple: int = 1):
    """Stack uneven (x, y) shards into masked fixed-shape arrays.

    Returns ``(X, Y, SW, sizes)`` with leading worker axis; ``SW`` is 1.0
    for real samples, 0.0 for padding.
    """
    sizes = np.array([x.shape[0] for x, _ in shards], dtype=np.int64)
    target = int(max(1, sizes.max()))
    if pad_multiple > 1:
        target = int(-(-target // pad_multiple) * pad_multiple)
    xs, ys, ws = [], [], []
    for x, y in shards:
        n = x.shape[0]
        xs.append(_pad_to(np.asarray(x), target))
        ys.append(_pad_to(np.asarray(y), target))
        w = np.zeros(target, dtype=np.float32)
        w[:n] = 1.0
        ws.append(w)
    return np.stack(xs), np.stack(ys), np.stack(ws), sizes


def _epoch_permutation(n_pad: int, shuffle: bool, gen: torch.Generator,
                       device: torch.device) -> Optional[torch.Tensor]:
    """The epoch's visit order over the padded rows: a permutation drawn
    on the device, or None for the rows in order. Padding rows shuffle
    in with the rest; their weight is 0."""
    if not shuffle:
        return None
    return torch.randperm(n_pad, generator=gen, device=device)


def _run_epoch(model: BaseModel, tx, loss_fn, metric_fns, trainable, state,
               opt_state, x, y, sw, batch_size: int, perm, gen):
    """One epoch of masked steps over ``x`` (a batch-multiple of rows,
    on the device); returns ``(opt_state, summed stats)``."""
    if perm is not None:
        x, y, sw = x[perm], y[perm], sw[perm]
    totals = None
    for start in range(0, x.shape[0], batch_size):
        sl = slice(start, start + batch_size)
        opt_state, stats = train_step(model, tx, loss_fn, metric_fns,
                                      trainable, state, opt_state, x[sl],
                                      y[sl], sw[sl], gen)
        totals = stats if totals is None else totals + stats
    return opt_state, totals


def _metric_names(metric_fns) -> List[str]:
    return ["loss"] + [metrics_mod.serialize(fn) for fn in metric_fns]


def _worker_seed(seed: int, worker: int) -> int:
    return int(np.random.SeedSequence((seed, worker)).generate_state(1)[0])


class SyncAverageTrainer:
    """Local training on each partition + delta averaging."""

    def __init__(self, model: BaseModel, optimizer, loss, metrics=None,
                 custom_objects: Optional[Dict] = None):
        self.model = model
        self.tx = optimizer.to_transform()
        self.loss_fn = losses_mod.get(loss, custom_objects)
        self.metric_fns = list(metrics or [])

    def run(self, weights: List[np.ndarray],
            shards: Sequence[Tuple[np.ndarray, np.ndarray]],
            epochs: int, batch_size: int, validation_split: float = 0.0,
            shuffle: bool = True, seed: int = 0):
        """Train every worker and average their deltas.

        Returns ``(new_weights, histories)`` where histories is a list (one
        per worker) of Keras-style dicts, None for a worker that did not
        train.
        """
        model = self.model
        self.timer = timer = StepTimer()
        timer.start()
        model.set_weights(weights)
        params0 = model.params
        delta_sum = {ln: {pn: torch.zeros_like(t) for pn, t in lp.items()}
                     for ln, lp in params0.items()}
        stats: Dict[int, List[List[float]]] = {}
        for w, final, worker_stats in self.train_workers(
                params0, shards, epochs, batch_size, validation_split,
                shuffle, seed):
            with torch.no_grad():
                for ln, lp in delta_sum.items():
                    for pn, acc in lp.items():
                        acc += params0[ln][pn] - final[ln][pn]
            stats[w] = worker_stats.tolist()
        # mean over ALL workers: an inactive one adds zero
        with torch.no_grad():
            model.params = {ln: {pn: params0[ln][pn] - d / len(shards)
                                 for pn, d in lp.items()}
                            for ln, lp in delta_sum.items()}
        timer.stop()
        return model.get_weights(), self._history_dicts(stats, len(shards),
                                                        timer)

    def train_workers(self, params0: Dict,
                      shards: Sequence[Tuple[np.ndarray, np.ndarray]],
                      epochs: int, batch_size: int,
                      validation_split: float = 0.0, shuffle: bool = True,
                      seed: int = 0):
        """Train each worker in turn from ``params0`` (the model's params
        dict, on its device); :meth:`run` averages what this yields.

        Yields ``(worker, trained params, per-epoch stats)`` for each
        worker that trains; a partition no larger than one batch yields
        nothing (the skip-small rule). The stats are an
        ``(epochs, 1 + metrics)`` tensor of the loss and metric means.
        """
        model = self.model
        device = model.device
        # dtypes and label ranks exactly as single-process fit has them
        shards = [(model._prepare_x(x), model._prepare_y(y))
                  for x, y in shards]
        X, Y, SW, sizes = stack_shards(shards, pad_multiple=batch_size)
        train_counts = (sizes * (1.0 - validation_split)).astype(np.int64)
        ar = np.arange(X.shape[1])[None, :]
        SW_train = (SW * (ar < train_counts[:, None])).astype(np.float32)
        n_pad = X.shape[1]

        trainable0, state0 = model._split_params(params0)
        for w in range(len(shards)):
            if sizes[w] <= batch_size:
                continue
            x, y, sw = (torch.as_tensor(a[w], device=device)
                        for a in (X, Y, SW_train))
            gen = torch.Generator(device=device).manual_seed(
                _worker_seed(seed, w))
            trainable = _trainable_copy(trainable0)
            # each copy moves its own moving statistics, averaged with
            # the weights
            state = {ln: dict(lp) for ln, lp in state0.items()}
            opt_state = self.tx.init(tree_leaves(trainable))
            per_epoch = []
            for _ in range(int(epochs)):
                opt_state, totals = _run_epoch(
                    model, self.tx, self.loss_fn, self.metric_fns, trainable,
                    state, opt_state, x, y, sw, batch_size,
                    _epoch_permutation(n_pad, shuffle, gen, device), gen)
                per_epoch.append(epoch_stats(totals))
            yield (w, model._merge_params(trainable, state),
                   torch.stack(per_epoch))

    def _history_dicts(self, stats: Dict[int, List[List[float]]],
                       num_workers: int, timer: StepTimer):
        """Per-worker ``[epoch][loss, *metrics]`` -> Keras-style dicts
        (None for partitions the skip-small rule left untrained)."""
        names = _metric_names(self.metric_fns)
        history_dicts = []
        for w in range(num_workers):
            if w not in stats:
                history_dicts.append(None)
                continue
            hist = {name: [row[j] for row in stats[w]]
                    for j, name in enumerate(names)}
            hist["fit_time"] = [timer.total]
            history_dicts.append(hist)
        return history_dicts


class SyncStepTrainer:
    """Per-step synchronous SGD: one optimizer step per global batch."""

    def __init__(self, model: BaseModel, optimizer, loss, metrics=None,
                 custom_objects: Optional[Dict] = None):
        self.model = model
        self.optimizer = optimizer
        self.tx = optimizer.to_transform()
        self.loss_fn = losses_mod.get(loss, custom_objects)
        self.metric_fns = list(metrics or [])

    def fit(self, weights: List[np.ndarray], x: np.ndarray, y: np.ndarray,
            epochs: int, batch_size: int, validation_split: float = 0.0,
            shuffle: bool = True, seed: int = 0, verbose: int = 0,
            epoch_callback: Optional[Callable] = None):
        """Train; returns (new_weights, history dict).

        ``epoch_callback(epoch_idx, logs) -> bool`` fires after each epoch
        with that epoch's metric means, after the model's params and
        optimizer state were synced; returning True stops training.

        Each epoch's wall time lands in ``history['epoch_time']``: real
        time, because the host reads the epoch's stats (once an epoch)
        before the timer stops.
        """
        model = self.model
        model.set_weights(weights)
        x = model._prepare_x(x)
        y = model._prepare_y(y)
        if validation_split and 0.0 < validation_split < 1.0:
            split_at = int(x.shape[0] * (1.0 - validation_split))
            x, y = x[:split_at], y[:split_at]

        n = x.shape[0]
        nb = max(1, -(-n // batch_size))
        n_pad = nb * batch_size
        sw = np.zeros(n_pad, dtype=np.float32)
        sw[:n] = 1.0
        device = model.device
        x_d, y_d, sw_d = (torch.as_tensor(a, device=device)
                          for a in (_pad_to(x, n_pad), _pad_to(y, n_pad), sw))

        trainable, state = model._split_params(model.params)
        trainable = _trainable_copy(trainable)
        opt_state = self.tx.init(tree_leaves(trainable))
        gen = torch.Generator(device=device).manual_seed(seed)
        metric_names = _metric_names(self.metric_fns)

        self.timer = timer = StepTimer()
        history: Dict[str, List[float]] = {}
        for epoch_idx in range(int(epochs)):
            timer.start()
            opt_state, totals = _run_epoch(
                model, self.tx, self.loss_fn, self.metric_fns, trainable,
                state, opt_state, x_d, y_d, sw_d, batch_size,
                _epoch_permutation(n_pad, shuffle, gen, device), gen)
            vals = epoch_stats(totals).tolist()
            timer.stop()
            for name, val in zip(metric_names, vals):
                history.setdefault(name, []).append(val)
            if verbose:
                print(f"Epoch {epoch_idx + 1}/{epochs} - " + " - ".join(
                    f"{name}: {val:.4f}"
                    for name, val in zip(metric_names, vals)))
            if epoch_callback is not None:
                logs = dict(zip(metric_names, vals))
                model.params = model._merge_params(trainable, state)
                model._opt_state = opt_state
                if epoch_callback(epoch_idx, logs):
                    break

        history["epoch_time"] = list(timer.durations)
        model.params = model._merge_params(trainable, state)
        return model.get_weights(), history


def build_sharded_predict(model: BaseModel):
    """Order-preserving inference on the model's device: on one device,
    :meth:`BaseModel.predict` (contiguous batches, the last one padded,
    ``out=`` filled in place)."""
    def predict(x: np.ndarray, batch_size: int = 1024,
                out: Optional[np.ndarray] = None) -> np.ndarray:
        return model.predict(x, batch_size=batch_size, out=out)

    return predict


def build_sharded_evaluate(model: BaseModel, loss, metrics=None,
                           custom_objects=None):
    """Evaluation on the model's device with the given loss and metrics:
    the sample-count-weighted means of :meth:`BaseModel.evaluate`, so it
    equals single-process evaluation."""
    loss_fn = losses_mod.get(loss, custom_objects)
    metric_fns = list(metrics or [])

    def evaluate(x: np.ndarray, y: np.ndarray, batch_size: int = 1024):
        return model._evaluate(x, y, batch_size, loss_fn, metric_fns)

    return evaluate
