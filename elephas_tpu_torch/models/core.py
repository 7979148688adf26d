"""Model core: Sequential and functional-graph models.

The counterpart of ``elephas_tpu/models/core.py``. A model is a
function over a parameter dict (``{layer_name: {param_name: tensor}}``)
plus a serializable architecture config; ``fit``, ``evaluate`` and
``predict`` are loops over it on the model's device (``device=None``
means the CUDA device; ``device="cpu"`` asks for the CPU).

- Weights cross between the packages as ordered flat lists of numpy
  arrays (``get_weights``/``set_weights``): each layer's
  ``weight_order`` first, then its other parameters sorted, layer by
  layer, exactly as the JAX package orders them.
- ``compile(compute_dtype="bfloat16")`` runs the forward and backward
  in bf16 over f32 parameters; the loss, metrics and optimizer stay f32.
- The training loop keeps the data on the device, shuffles there with a
  ``torch.Generator`` and sums the loss and metrics there: the host
  reads them once per epoch (and per batch only when callbacks are
  given, whose ``batch_end`` receives the batch loss).
- Trainable parameters and non-trainable state are kept apart
  (``_split_params``/``_merge_params``), as the trainers expect; no
  ported layer has state yet (BatchNormalization waits for ROADMAP
  Queue 1 item 3).

``save`` raises ``NotImplementedError`` until the saving slice; the JAX
package's checkpoint state API (``training_state``,
``restore_training_state``) is not here yet.
"""
import json
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..weights import tree_leaves, tree_map
from . import losses as losses_mod
from . import metrics as metrics_mod
from . import optimizers as optimizers_mod
from .layers import (InputLayer, KTensor, Layer, deserialize_layer,
                     serialize_layer)

_MODEL_UID = [0]


def _cast_floats(tree, dtype):
    """Cast every floating tensor of a nested dict (or a list of inputs)
    to ``dtype``; integer tensors are untouched."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_floats(t, dtype) for t in tree)
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                    tree)


def _auto_name(prefix: str) -> str:
    _MODEL_UID[0] += 1
    return f"{prefix}_{_MODEL_UID[0]}"


def _trainable_copy(tree: Dict) -> Dict:
    """Fresh leaves that record gradients: training updates them in
    place, and nobody else holds them."""
    return tree_map(lambda t: t.detach().clone().requires_grad_(), tree)


def train_step(model: "BaseModel", tx, loss_fn: Callable,
               metric_fns: Sequence[Callable], trainable: Dict, state: Dict,
               opt_state, xb: torch.Tensor, yb: torch.Tensor,
               swb: Optional[torch.Tensor] = None,
               gen: Optional[torch.Generator] = None):
    """One optimizer step on one batch, updating the leaves of
    ``trainable`` in place; returns ``(opt_state, stats)``.

    The loss is the batch mean, or with sample weights ``swb`` (1.0 for
    real rows, 0.0 for padding) ``sum(loss * swb) / max(sum(swb), 1)``,
    as the JAX trainers mask padded rows. ``stats`` is a device tensor
    ``[loss * count, count, sum of each metric over the counted rows]``,
    for sample-weighted epoch means."""
    leaves = tree_leaves(trainable)
    preds = model._apply_for_training(model._merge_params(trainable, state),
                                      xb, gen)
    per = loss_fn(yb, preds)
    if swb is None:
        count = per.new_full((), float(per.shape[0]))
        loss = per.mean()
    else:
        count = swb.sum()
        loss = (per * swb).sum() / count.clamp(min=1.0)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        updates, opt_state = tx.update(list(grads), opt_state, leaves)
        for p, u in zip(leaves, updates):
            p.add_(u)
        preds = preds.detach()
        stats = [loss.detach() * count, count]
        for fn in metric_fns:
            per_m = fn(yb, preds)
            stats.append((per_m if swb is None else per_m * swb).sum())
    return opt_state, torch.stack(stats)


def epoch_stats(totals: torch.Tensor) -> torch.Tensor:
    """Summed ``train_step`` stats -> the ``[loss, *metrics]`` means, on
    the device."""
    return torch.cat([totals[0:1], totals[2:]]) / totals[1].clamp(min=1.0)


class History:
    """Training history: dict of per-epoch metric lists (Keras-compatible)."""

    def __init__(self):
        self.history: Dict[str, List[float]] = {}

    def append(self, name: str, value: float):
        self.history.setdefault(name, []).append(float(value))


class BaseModel:
    """Shared machinery for Sequential and functional models."""

    def __init__(self, name: Optional[str] = None, device: DeviceLike = None):
        self.name = name or _auto_name(type(self).__name__.lower())
        self.device = resolve_device(device)
        self.params: Optional[Dict] = None
        self.built = False
        self.optimizer: Optional[optimizers_mod.Optimizer] = None
        self.loss = None
        self.metrics: List = []
        self.metrics_names: List[str] = ["loss"]
        self.custom_objects: Dict[str, Any] = {}
        self._loss_fn: Optional[Callable] = None
        self._metric_fns: List[Callable] = []
        self._opt_state = None
        self._tx = None
        self._rng_seed: Optional[int] = None
        self._dropout_gen: Optional[torch.Generator] = None
        #: mixed precision: compute dtype for forward/backward (params and
        #: optimizer state stay f32); set via compile(compute_dtype=...)
        self._compute_dtype: Optional[torch.dtype] = None
        #: callbacks set this mid-fit to end training after the epoch
        self.stop_training = False

    # ------------------------------------------------------------------ graph
    @property
    def layers(self) -> List[Layer]:
        raise NotImplementedError

    @property
    def output_shape(self) -> Tuple:
        raise NotImplementedError

    # ------------------------------------------------------------------ build
    def build(self, input_shape: Optional[Tuple] = None, seed: Optional[int] = None):
        raise NotImplementedError

    def _ensure_built(self, x: Optional[np.ndarray] = None):
        if not self.built:
            shape = tuple(np.asarray(x).shape[1:]) if x is not None else None
            self.build(input_shape=shape)

    def _seed(self) -> int:
        if self._rng_seed is None:
            self._rng_seed = int(np.random.SeedSequence().generate_state(1)[0])
        return self._rng_seed

    def _generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(self._seed())

    def _train_generator(self) -> torch.Generator:
        """The dropout stream of training, seeded from the model's seed
        and drawn from across fit calls."""
        if self._dropout_gen is None:
            self._dropout_gen = self._generator()
        return self._dropout_gen

    # ------------------------------------------------------------- params api
    def _weight_entries(self) -> List[Tuple[str, str]]:
        """Ordered (layer_name, param_name) pairs defining weight order."""
        entries = []
        for layer in self.layers:
            if not self.params or layer.name not in self.params:
                continue
            layer_params = self.params[layer.name]
            order = [k for k in layer.weight_order if k in layer_params]
            order += [k for k in sorted(layer_params) if k not in order]
            for key in order:
                entries.append((layer.name, key))
        return entries

    def get_weights(self) -> List[np.ndarray]:
        """Model weights as an ordered flat list of numpy arrays (copies)."""
        if self.params is None:
            raise ValueError("Model must be built before get_weights()")
        return [self.params[ln][pn].detach().to("cpu", copy=True).numpy()
                for ln, pn in self._weight_entries()]

    def set_weights(self, weights: Sequence[np.ndarray]):
        """Load weights from an ordered flat list of arrays."""
        if self.params is None:
            raise ValueError("Model must be built before set_weights()")
        entries = self._weight_entries()
        if len(entries) != len(weights):
            raise ValueError(
                f"Expected {len(entries)} weight arrays, got {len(weights)}")
        new_params = {ln: dict(lp) for ln, lp in self.params.items()}
        for (ln, pn), w in zip(entries, weights):
            current = new_params[ln][pn]
            w = torch.tensor(np.asarray(w), dtype=current.dtype,
                             device=self.device)
            if w.shape != current.shape:
                raise ValueError(
                    f"Shape mismatch for {ln}/{pn}: {tuple(w.shape)} vs "
                    f"{tuple(current.shape)}")
            new_params[ln][pn] = w
        # a new dict: replicas detect a weight change by its identity
        self.params = new_params

    def _split_params(self, params: Dict) -> Tuple[Dict, Dict]:
        """Split into (trainable, non-trainable) collections."""
        trainable, state = {}, {}
        for layer in self.layers:
            if layer.name not in params:
                continue
            non_trainable = set(getattr(layer, "non_trainable", ()))
            t = {k: v for k, v in params[layer.name].items() if k not in non_trainable}
            s = {k: v for k, v in params[layer.name].items() if k in non_trainable}
            if t:
                trainable[layer.name] = t
            if s:
                state[layer.name] = s
        return trainable, state

    @staticmethod
    def _merge_params(trainable: Dict, state: Dict) -> Dict:
        merged = {ln: dict(lp) for ln, lp in trainable.items()}
        for ln, lp in state.items():
            merged.setdefault(ln, {}).update(lp)
        return merged

    # ------------------------------------------------------------------ apply
    def apply(self, params: Dict, inputs, training: bool = False,
              gen: Optional[torch.Generator] = None):
        """Forward pass. Under mixed precision
        (``compile(compute_dtype='bfloat16')``) params and inputs cast
        down for the compute and predictions cast back to f32."""
        if self._compute_dtype is not None:
            params = _cast_floats(params, self._compute_dtype)
            inputs = _cast_floats(inputs, self._compute_dtype)
        y = self._apply_internal(params, inputs, training, gen)
        if self._compute_dtype is not None:
            y = _cast_floats(y, torch.float32)
        return y

    def _apply_internal(self, params, inputs, training, gen):
        raise NotImplementedError

    def _apply_for_training(self, params, inputs, gen):
        """Training forward with the compile-level mixed-precision casts:
        the entry point of every training objective (``fit`` and the
        sync trainers), so mixed precision holds on all paths."""
        return self.apply(params, inputs, training=True, gen=gen)

    # ---------------------------------------------------------------- compile
    def compile(self, optimizer="rmsprop", loss=None, metrics=None,
                custom_objects: Optional[Dict] = None, seed: Optional[int] = None,
                compute_dtype: Optional[str] = None):
        """Attach optimizer, loss and metrics; builds params if shapes known.

        :param compute_dtype: ``'bfloat16'`` enables mixed precision:
            forward/backward run in bf16 while parameters, optimizer
            state, loss and metrics stay f32.
        """
        custom_objects = {**self.custom_objects, **(custom_objects or {})}
        self.custom_objects = custom_objects
        if compute_dtype is not None:
            canonical = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
                         "float32": None, "fp32": None}
            if compute_dtype in ("float16", "fp16"):
                raise ValueError(
                    "compute_dtype='float16' needs loss scaling, which is "
                    "not implemented; use 'bfloat16' (f32-sized exponent, "
                    "no scaling needed)")
            if compute_dtype not in canonical:
                raise ValueError(
                    f"unsupported compute_dtype {compute_dtype!r}")
            self._compute_dtype = canonical[compute_dtype]
        else:
            self._compute_dtype = None
        self.optimizer = optimizers_mod.get(optimizer)
        if loss is None:
            raise ValueError("compile() requires a loss")
        self.loss = loss
        self._loss_fn = losses_mod.get(loss, custom_objects)
        self.metrics = list(metrics or [])
        names, fns = metrics_mod.resolve_metrics(self.metrics, loss=loss,
                                                 custom_objects=custom_objects)
        self.metrics_names = ["loss"] + names
        self._metric_fns = fns
        self._tx = self.optimizer.to_transform()
        self._opt_state = None
        if seed is not None:
            self._rng_seed = seed
            self._dropout_gen = None
        if not self.built:
            try:
                self.build()
            except (ValueError, TypeError):
                pass  # input shape unknown; built lazily at first fit
        return self

    @property
    def compiled(self) -> bool:
        return self._loss_fn is not None

    # ------------------------------------------------------------ data prep
    def _prepare_y(self, y: np.ndarray) -> np.ndarray:
        y = np.asarray(y)
        loss_name = losses_mod.serialize(self.loss) if self.loss is not None else ""
        if loss_name == "sparse_categorical_crossentropy":
            return y.astype(np.int32)
        y = y.astype(np.float32)
        out_rank = len(self.output_shape) + 1  # + batch dim
        if y.ndim == out_rank - 1:
            y = y[..., None]
        return y

    @staticmethod
    def _prepare_x(x: np.ndarray) -> np.ndarray:
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.integer):
            return x
        return x.astype(np.float32)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # -------------------------------------------------------------------- fit
    def fit(self, x, y, epochs: int = 1, batch_size: int = 32, verbose: int = 0,
            validation_split: float = 0.0, validation_data=None,
            shuffle: bool = True, callbacks=None, **kwargs) -> History:
        """Train with mini-batch SGD. Returns a Keras-style History.

        ``callbacks`` is a list of
        :class:`~elephas_tpu_torch.models.callbacks.Callback` objects; a
        callback may set ``model.stop_training = True`` (e.g.
        EarlyStopping) to end training after the current epoch.
        """
        if not self.compiled:
            raise RuntimeError("compile() the model before fit()")
        self._ensure_built(x)
        x = self._prepare_x(x)
        y = self._prepare_y(y)

        if validation_data is None and validation_split and 0.0 < validation_split < 1.0:
            split_at = int(x.shape[0] * (1.0 - validation_split))
            x, x_val = x[:split_at], x[split_at:]
            y, y_val = y[:split_at], y[split_at:]
            validation_data = (x_val, y_val)

        from .callbacks import CallbackList

        history = History()
        self.stop_training = False
        cbs = CallbackList(callbacks, self)
        cbs.train_begin()
        # train_end fires even when an epoch raises
        try:
            self._run_epochs(cbs, self._to_device(x), self._to_device(y),
                             int(epochs), batch_size, shuffle,
                             validation_data, verbose, history)
        finally:
            cbs.train_end()
        return history

    def _run_epochs(self, cbs, x, y, epochs, batch_size, shuffle,
                    validation_data, verbose, history):
        trainable, state = self._split_params(self.params)
        trainable = _trainable_copy(trainable)
        if self._opt_state is None:
            self._opt_state = self._tx.init(tree_leaves(trainable))
        opt_state = self._opt_state
        n = x.shape[0]
        shuffle_gen = self._generator()
        gen = self._train_generator()
        for epoch in range(epochs):
            cbs.epoch_begin(epoch)
            order = (torch.randperm(n, generator=shuffle_gen,
                                    device=self.device) if shuffle else None)
            totals = None
            for batch_idx, start in enumerate(range(0, n, batch_size)):
                if order is None:
                    xb, yb = x[start:start + batch_size], y[start:start + batch_size]
                else:
                    idx = order[start:start + batch_size]
                    xb, yb = x[idx], y[idx]
                opt_state, stats = train_step(
                    self, self._tx, self._loss_fn, self._metric_fns,
                    trainable, state, opt_state, xb, yb, gen=gen)
                totals = stats if totals is None else totals + stats
                if cbs:
                    cbs.batch_end(batch_idx, {"loss": float(stats[0] / stats[1]),
                                              "size": int(xb.shape[0])})
            if totals is not None:
                for name, value in zip(self.metrics_names,
                                       epoch_stats(totals).tolist()):
                    history.append(name, value)
            # sync model state each epoch so callbacks observe the weights
            self.params = self._merge_params(trainable, state)
            self._opt_state = opt_state
            if validation_data is not None:
                val_results = self.evaluate(validation_data[0], validation_data[1],
                                            batch_size=batch_size, verbose=0)
                val_results = (val_results if isinstance(val_results, list)
                               else [val_results])
                for name, value in zip(self.metrics_names, val_results):
                    history.append("val_" + name, value)
            if verbose:
                msg = " - ".join(f"{k}: {v[-1]:.4f}" for k, v in history.history.items())
                print(f"Epoch {epoch + 1}/{epochs} - {msg}")
            cbs.epoch_end(epoch, {k: v[-1] for k, v in history.history.items()
                                  if v})
            if cbs:
                # a callback may have replaced the weights: train on from
                # what it left behind
                trainable, state = self._split_params(self.params)
                trainable = _trainable_copy(trainable)
                opt_state = self._opt_state
            if self.stop_training:
                break
        self.params = self._merge_params(trainable, state)
        self._opt_state = opt_state

    def train_on_batch(self, x, y):
        """Single optimization step on one batch; returns [loss, *metrics]."""
        if not self.compiled:
            raise RuntimeError("compile() the model before train_on_batch()")
        self._ensure_built(x)
        trainable, state = self._split_params(self.params)
        trainable = _trainable_copy(trainable)
        if self._opt_state is None:
            self._opt_state = self._tx.init(tree_leaves(trainable))
        self._opt_state, stats = train_step(
            self, self._tx, self._loss_fn, self._metric_fns, trainable, state,
            self._opt_state, self._to_device(self._prepare_x(x)),
            self._to_device(self._prepare_y(y)), gen=self._train_generator())
        self.params = self._merge_params(trainable, state)
        vals = epoch_stats(stats).tolist()
        return vals if len(vals) > 1 else vals[0]

    # --------------------------------------------------------------- evaluate
    def evaluate(self, x, y, batch_size: int = 32, verbose: int = 0,
                 **kwargs) -> Union[List[float], float]:
        """Sample-weighted mean of loss and metrics over the dataset."""
        if not self.compiled:
            raise RuntimeError("compile() the model before evaluate()")
        self._ensure_built(x)
        return self._evaluate(x, y, batch_size, self._loss_fn,
                              self._metric_fns)

    @torch.no_grad()
    def _evaluate(self, x, y, batch_size: int, loss_fn: Callable,
                  metric_fns: List[Callable]) -> Union[List[float], float]:
        """:meth:`evaluate` with the given loss and metric functions (the
        distributed evaluate passes the trainer's); each chunk goes to the
        device on its own."""
        x, y = self._prepare_x(x), self._prepare_y(y)
        n = x.shape[0]
        sums = None
        for start in range(0, n, batch_size):
            xb = self._to_device(x[start:start + batch_size])
            yb = self._to_device(y[start:start + batch_size])
            preds = self.apply(self.params, xb, training=False)
            vals = torch.stack([loss_fn(yb, preds).sum()]
                               + [fn(yb, preds).sum() for fn in metric_fns])
            sums = vals if sums is None else sums + vals
        results = (sums / n).tolist() if sums is not None else [0.0]
        return results if len(results) > 1 else results[0]

    # ---------------------------------------------------------------- predict
    @torch.no_grad()
    def predict(self, x, batch_size: int = 32, verbose: int = 0,
                out: Optional[np.ndarray] = None, **kwargs) -> np.ndarray:
        """Forward inference in fixed-size batches (the last batch padded
        to the batch size, as in the JAX package); each batch goes to the
        device on its own.

        ``out``: optional preallocated array (e.g. a writable
        ``np.lib.format.open_memmap``) that receives the predictions in
        place, batch by batch; it is returned."""
        self._ensure_built(x)
        x = self._prepare_x(x)
        n = x.shape[0]
        outputs = []
        for start in range(0, n, batch_size):
            xb = self._to_device(x[start:start + batch_size])
            real = xb.shape[0]
            if real < batch_size and n > batch_size:
                pad = xb.new_zeros((batch_size - real,) + tuple(xb.shape[1:]))
                xb = torch.cat([xb, pad])
            res = self.apply(self.params, xb, training=False)[:real]
            if out is not None:
                out[start:start + real] = res.cpu().numpy()
            else:
                outputs.append(res)
        if out is not None:
            return out
        if not outputs:
            return np.zeros((0,) + tuple(self.output_shape), dtype=np.float32)
        return torch.cat(outputs).cpu().numpy()

    # ------------------------------------------------------------------- json
    def get_config(self) -> Dict:
        raise NotImplementedError

    def to_json(self, **kwargs) -> str:
        return json.dumps({"class_name": type(self).__name__,
                           "config": self.get_config()}, **kwargs)

    def save(self, filepath: str, overwrite: bool = True,
             include_optimizer: bool = True):
        raise NotImplementedError("model saving is not ported yet (ROADMAP "
                                  "Queue 1 item 3)")

    def summary(self) -> str:
        lines = [f'Model: "{self.name}"', "-" * 60]
        total = 0
        for layer in self.layers:
            count = 0
            if self.params and layer.name in self.params:
                count = sum(int(v.numel()) for v in self.params[layer.name].values())
            total += count
            lines.append(f"{layer.name:<30}{type(layer).__name__:<20}{count:>10,}")
        lines.append("-" * 60)
        lines.append(f"Total params: {total:,}")
        text = "\n".join(lines)
        print(text)
        return text


class Sequential(BaseModel):
    """Linear stack of layers (Keras Sequential analog)."""

    def __init__(self, layers: Optional[Sequence[Layer]] = None,
                 name: Optional[str] = None, device: DeviceLike = None):
        super().__init__(name=name, device=device)
        self._layers: List[Layer] = []
        for layer in layers or []:
            self.add(layer)

    @property
    def layers(self) -> List[Layer]:
        return self._layers

    def add(self, layer: Layer):
        if not isinstance(layer, Layer):
            raise TypeError(f"Sequential.add expects a Layer, got {type(layer)}")
        self._layers.append(layer)
        self.built = False
        return self

    def _declared_input_shape(self) -> Optional[Tuple]:
        for layer in self._layers:
            if isinstance(layer, InputLayer):
                return layer.shape
            if layer.input_spec is not None:
                return tuple(layer.input_spec)
            break
        return None

    def build(self, input_shape: Optional[Tuple] = None, seed: Optional[int] = None):
        if input_shape is None:
            input_shape = self._declared_input_shape()
        if input_shape is None:
            raise ValueError(
                "Cannot build Sequential model: supply input_shape/input_dim "
                "on the first layer or call build(input_shape=...)")
        if seed is not None:
            self._rng_seed = seed
        gen = self._generator()
        params = {}
        shape = tuple(input_shape)
        for layer in self._layers:
            layer_params = layer.build(gen, shape)
            if layer_params:
                params[layer.name] = layer_params
            shape = layer.compute_output_shape(shape)
        self._output_shape = shape
        self.params = params
        self.built = True
        self._opt_state = None
        return self

    @property
    def output_shape(self) -> Tuple:
        if not self.built:
            raise ValueError("Model not built")
        return self._output_shape

    def _apply_internal(self, params, inputs, training, gen):
        x = inputs
        for layer in self._layers:
            x = layer.call(params.get(layer.name, {}), x, training, gen)
        return x

    def get_config(self) -> Dict:
        return {"name": self.name,
                "layers": [serialize_layer(layer) for layer in self._layers]}

    @classmethod
    def from_config(cls, config: Dict, custom_objects: Optional[Dict] = None,
                    device: DeviceLike = None):
        model = cls(name=config.get("name"), device=device)
        for spec in config["layers"]:
            model.add(deserialize_layer(spec, custom_objects))
        model.custom_objects = custom_objects or {}
        for layer in model._layers:
            layer._custom_objects = model.custom_objects
        try:
            model.build()
        except ValueError:
            pass
        return model


class Model(BaseModel):
    """Functional-API model over a DAG of layer calls."""

    def __init__(self, inputs=None, outputs=None, name: Optional[str] = None,
                 device: DeviceLike = None):
        super().__init__(name=name, device=device)
        if inputs is None or outputs is None:
            raise ValueError("Model requires inputs= and outputs=")
        self.inputs: List[KTensor] = list(inputs) if isinstance(
            inputs, (list, tuple)) else [inputs]
        self.outputs: List[KTensor] = list(outputs) if isinstance(
            outputs, (list, tuple)) else [outputs]
        self._nodes = self._topo_sort()
        self.build()

    # each node: (ktensor, layer, input ktensors)
    def _topo_sort(self):
        order, seen = [], set()

        def visit(t: KTensor):
            if id(t) in seen:
                return
            seen.add(id(t))
            if t.history is None:
                raise ValueError("Disconnected tensor in graph")
            layer, parents = t.history
            for p in parents:
                visit(p)
            order.append((t, layer, parents))

        for out in self.outputs:
            visit(out)
        names = [layer.name for _, layer, _ in order]
        if len(names) != len(set(names)):
            raise ValueError("Layer reuse (shared layers) is not supported yet")
        return order

    @property
    def layers(self) -> List[Layer]:
        return [layer for _, layer, _ in self._nodes]

    def build(self, input_shape=None, seed: Optional[int] = None):
        if seed is not None:
            self._rng_seed = seed
        gen = self._generator()
        params = {}
        shapes: Dict[int, Tuple] = {}
        for t, layer, parents in self._nodes:
            if isinstance(layer, InputLayer):
                shapes[id(t)] = layer.shape
                continue
            in_shapes = [shapes[id(p)] for p in parents]
            arg = in_shapes if len(in_shapes) > 1 else in_shapes[0]
            layer_params = layer.build(gen, arg)
            if layer_params:
                params[layer.name] = layer_params
            shapes[id(t)] = layer.compute_output_shape(arg)
        self._output_shape = shapes[id(self.outputs[0])]
        self.params = params
        self.built = True
        self._opt_state = None
        return self

    @property
    def output_shape(self) -> Tuple:
        return self._output_shape

    def _apply_internal(self, params, inputs, training, gen):
        values: Dict[int, Any] = {}
        input_list = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        if len(input_list) != len(self.inputs):
            raise ValueError(f"Model expects {len(self.inputs)} inputs, "
                             f"got {len(input_list)}")
        # bind by the user-declared inputs= order, not graph-traversal order
        for placeholder, array in zip(self.inputs, input_list):
            values[id(placeholder)] = array
        for t, layer, parents in self._nodes:
            if isinstance(layer, InputLayer):
                if id(t) not in values:
                    raise ValueError(
                        f"Input tensor for layer {layer.name!r} missing from inputs=")
                continue
            args = [values[id(p)] for p in parents]
            arg = args if len(args) > 1 else args[0]
            values[id(t)] = layer.call(params.get(layer.name, {}), arg,
                                       training, gen)
        outs = [values[id(o)] for o in self.outputs]
        return outs if len(outs) > 1 else outs[0]

    def get_config(self) -> Dict:
        tensor_names: Dict[int, str] = {}
        layer_specs = []
        for t, layer, parents in self._nodes:
            tensor_names[id(t)] = layer.name
            spec = serialize_layer(layer)
            spec["name"] = layer.name
            spec["inbound"] = [tensor_names[id(p)] for p in parents]
            layer_specs.append(spec)
        return {
            "name": self.name,
            "layers": layer_specs,
            "input_layers": [t.history[0].name for t in self.inputs],
            "output_layers": [tensor_names[id(t)] for t in self.outputs],
        }

    @classmethod
    def from_config(cls, config: Dict, custom_objects: Optional[Dict] = None,
                    device: DeviceLike = None):
        produced: Dict[str, KTensor] = {}
        for spec in config["layers"]:
            layer = deserialize_layer(spec, custom_objects)
            if isinstance(layer, InputLayer):
                produced[layer.name] = layer._output
                continue
            inbound = [produced[name] for name in spec["inbound"]]
            produced[layer.name] = layer(inbound if len(inbound) > 1 else inbound[0])
        inputs = [produced[name] for name in config["input_layers"]]
        outputs = [produced[name] for name in config["output_layers"]]
        model = cls(inputs=inputs, outputs=outputs, name=config.get("name"),
                    device=device)
        model.custom_objects = custom_objects or {}
        for layer in model.layers:
            layer._custom_objects = model.custom_objects
        return model


def model_from_json(json_string: str, custom_objects: Optional[Dict] = None,
                    device: DeviceLike = None) -> BaseModel:
    """Rebuild a model from its JSON architecture config (the JAX
    package's JSON loads here too), on ``device``."""
    spec = json.loads(json_string)
    class_name = spec.get("class_name")
    config = spec.get("config", {})
    if class_name == "Sequential":
        return Sequential.from_config(config, custom_objects, device)
    if class_name in ("Model", "Functional"):
        return Model.from_config(config, custom_objects, device)
    if class_name in ("TransformerModel", "SSMModel"):
        raise NotImplementedError(f"{class_name} JSON is not ported yet "
                                  "(ROADMAP Queue 1 items 2 and 6)")
    raise ValueError(f"Unknown model class: {class_name!r}")
