"""Keras-style training callbacks.

The counterpart of ``elephas_tpu/models/callbacks.py``: ``Callback``,
``CallbackList``, ``EarlyStopping``, ``ModelCheckpoint`` (the full
training state each epoch through :class:`~elephas_tpu_torch.utils.
checkpoint.CheckpointManager`) and ``LambdaCallback``.
"""
import math
import warnings
from typing import Callable, Dict, List, Optional

import numpy as np

__all__ = ["Callback", "CallbackList", "EarlyStopping", "LambdaCallback",
           "ModelCheckpoint"]


class Callback:
    """Base class; hook methods are no-ops."""

    def __init__(self):
        self.model = None

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs: Optional[Dict] = None):
        pass

    def on_train_end(self, logs: Optional[Dict] = None):
        pass

    def on_epoch_begin(self, epoch: int, logs: Optional[Dict] = None):
        pass

    def on_epoch_end(self, epoch: int, logs: Optional[Dict] = None):
        pass

    def on_batch_end(self, batch: int, logs: Optional[Dict] = None):
        pass


class CallbackList:
    """Dispatches hooks to a list of callbacks."""

    def __init__(self, callbacks: Optional[List[Callback]], model):
        self.callbacks = list(callbacks or [])
        for cb in self.callbacks:
            cb.set_model(model)

    def __bool__(self):
        return bool(self.callbacks)

    def train_begin(self, logs=None):
        for cb in self.callbacks:
            cb.on_train_begin(logs)

    def train_end(self, logs=None):
        for cb in self.callbacks:
            cb.on_train_end(logs)

    def epoch_begin(self, epoch, logs=None):
        for cb in self.callbacks:
            cb.on_epoch_begin(epoch, logs)

    def epoch_end(self, epoch, logs=None):
        for cb in self.callbacks:
            cb.on_epoch_end(epoch, logs)

    def batch_end(self, batch, logs=None):
        for cb in self.callbacks:
            cb.on_batch_end(batch, logs)


class EarlyStopping(Callback):
    """Stop training when a monitored metric stops improving.

    :param monitor: key in the epoch logs (e.g. ``val_loss``, ``loss``).
    :param patience: epochs without improvement before stopping.
    :param min_delta: minimum change to count as improvement.
    :param restore_best_weights: restore the best epoch's weights on stop.
    """

    def __init__(self, monitor: str = "val_loss", patience: int = 0,
                 min_delta: float = 0.0, mode: str = "min",
                 restore_best_weights: bool = False):
        super().__init__()
        if mode not in ("min", "max"):
            raise ValueError("mode must be 'min' or 'max'")
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.mode = mode
        self.restore_best_weights = restore_best_weights
        self.best = math.inf if mode == "min" else -math.inf
        self.wait = 0
        self.stopped_epoch: Optional[int] = None
        self._best_weights = None
        self._warned_missing = False

    def on_train_begin(self, logs=None):
        # a callback instance may be reused across fit() calls — stale
        # best/wait/weights from a previous run must not leak in
        self.best = math.inf if self.mode == "min" else -math.inf
        self.wait = 0
        self.stopped_epoch = None
        self._best_weights = None
        self._warned_missing = False

    def _improved(self, value: float) -> bool:
        if self.mode == "min":
            return value < self.best - self.min_delta
        return value > self.best + self.min_delta

    def on_epoch_end(self, epoch, logs=None):
        value = (logs or {}).get(self.monitor)
        if value is None:
            # metric absent (e.g. monitor='val_loss' with no validation
            # split): early stopping is inert — say so once
            if not self._warned_missing:
                warnings.warn(
                    f"EarlyStopping conditioned on {self.monitor!r}, which "
                    f"is not in the epoch logs {sorted(logs or {})} — it "
                    "will never trigger")
                self._warned_missing = True
            return
        if self._improved(float(value)):
            self.best = float(value)
            self.wait = 0
            if self.restore_best_weights:
                self._best_weights = [np.copy(w)
                                      for w in self.model.get_weights()]
        else:
            self.wait += 1
            # Keras semantics: stop once `patience` epochs pass without
            # improvement
            if self.wait >= self.patience:
                self.stopped_epoch = epoch
                self.model.stop_training = True

    def on_train_end(self, logs=None):
        # restore the best epoch's weights whether or not the stop
        # triggered (epochs may simply have run out mid-plateau)
        if self.restore_best_weights and self._best_weights is not None:
            self.model.set_weights(self._best_weights)


class ModelCheckpoint(Callback):
    """Save the full training state (params + optimizer state) every epoch
    via :class:`~elephas_tpu_torch.utils.checkpoint.CheckpointManager`.

    Resume with ``model.restore_training_state(directory)``.

    :param save_best_only: only write when ``monitor`` improves.
    :param block: ``False`` writes checkpoints on a background thread
        (state is copied to host memory first), so epochs never stall on
        checkpoint IO; the final write is flushed at ``on_train_end``.
    :param checkpoint_on_preemption: trap SIGTERM (a preemptible VM's
        eviction notice) for the duration of training and write one
        final checkpoint of the live state before exiting (manifest gets
        ``preempted: true``). Requires fit() to run in the main thread.
    """

    def __init__(self, directory: str, monitor: str = "loss",
                 save_best_only: bool = False, mode: str = "min",
                 max_to_keep: int = 3, block: bool = True,
                 checkpoint_on_preemption: bool = False):
        super().__init__()
        from ..utils.checkpoint import CheckpointManager

        if mode not in ("min", "max"):
            raise ValueError("mode must be 'min' or 'max'")
        self.manager = CheckpointManager(directory, max_to_keep=max_to_keep)
        self.monitor = monitor
        self.save_best_only = save_best_only
        self.mode = mode
        self.best = math.inf if mode == "min" else -math.inf
        self.block = block
        self.checkpoint_on_preemption = checkpoint_on_preemption
        self._uninstall_preemption = None
        self._cur_epoch = 0
        self._epoch_offset = 0
        self._warned_missing = False

    def on_train_begin(self, logs=None):
        # instance may be reused across fit() calls: reset the best and
        # number epochs after any already-checkpointed step
        self.best = math.inf if self.mode == "min" else -math.inf
        self._warned_missing = False
        self._cur_epoch = 0   # stale value from a previous fit would
        latest = self.manager.latest_step()  # stamp a phantom step
        self._epoch_offset = (latest + 1) if latest is not None else 0
        if self.checkpoint_on_preemption:
            from ..utils.checkpoint import install_preemption_checkpoint

            self._uninstall_preemption = install_preemption_checkpoint(
                self.manager,
                lambda: (self._epoch_offset + self._cur_epoch,
                         self.model.training_state()),
                model_json=self.model.to_json())

    def on_epoch_begin(self, epoch, logs=None):
        self._cur_epoch = epoch

    def on_epoch_end(self, epoch, logs=None):
        if self.save_best_only:
            value = (logs or {}).get(self.monitor)
            if value is None:
                # can't judge "best" without the metric — skip the save
                # (saving anyway would quietly degrade to save-always)
                if not self._warned_missing:
                    warnings.warn(
                        f"ModelCheckpoint(save_best_only=True) conditioned "
                        f"on {self.monitor!r}, which is not in the epoch "
                        f"logs {sorted(logs or {})} — no checkpoints will "
                        "be written")
                    self._warned_missing = True
                return
            improved = (float(value) < self.best if self.mode == "min"
                        else float(value) > self.best)
            if not improved:
                return
            self.best = float(value)
        self.manager.save(self._epoch_offset + epoch,
                          self.model.training_state(),
                          model_json=self.model.to_json(),
                          block=self.block)

    def on_train_end(self, logs=None):
        if self._uninstall_preemption is not None:
            self._uninstall_preemption()
            self._uninstall_preemption = None
        self.manager.wait_until_finished()


class LambdaCallback(Callback):
    """Ad-hoc callbacks from plain functions (Keras parity)."""

    def __init__(self, on_train_begin: Callable = None,
                 on_train_end: Callable = None,
                 on_epoch_begin: Callable = None,
                 on_epoch_end: Callable = None,
                 on_batch_end: Callable = None):
        super().__init__()
        self._hooks = {"train_begin": on_train_begin,
                       "train_end": on_train_end,
                       "epoch_begin": on_epoch_begin,
                       "epoch_end": on_epoch_end,
                       "batch_end": on_batch_end}

    def on_train_begin(self, logs=None):
        if self._hooks["train_begin"]:
            self._hooks["train_begin"](logs)

    def on_train_end(self, logs=None):
        if self._hooks["train_end"]:
            self._hooks["train_end"](logs)

    def on_epoch_begin(self, epoch, logs=None):
        if self._hooks["epoch_begin"]:
            self._hooks["epoch_begin"](epoch, logs)

    def on_epoch_end(self, epoch, logs=None):
        if self._hooks["epoch_end"]:
            self._hooks["epoch_end"](epoch, logs)

    def on_batch_end(self, batch, logs=None):
        if self._hooks["batch_end"]:
            self._hooks["batch_end"](batch, logs)
