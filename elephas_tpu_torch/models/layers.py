"""Layers: serializable building blocks whose parameters live outside
them.

The counterpart of ``elephas_tpu/models/layers.py``. Each layer is a
config object; parameters live in a dict of per-layer dicts of tensors
(``{layer_name: {param_name: tensor}}``), so a model is a function
``apply(params, x)``. Layers know how to

- ``build(generator, input_shape) -> params`` (shapes exclude the batch
  dim; the tensors land on the generator's device),
- ``compute_output_shape(input_shape)``,
- ``call(params, inputs, training, generator)``,
- round-trip through ``get_config``/``from_config``.

Auto-names (``dense``, ``dense_1``, ...) and configs follow the JAX
package's scheme, so a ``to_json()`` from either package loads in the
other. Calling a layer on a :class:`KTensor` records a node of a
functional graph.

Ported: ``InputLayer``, ``Dense``, ``Activation``, ``Dropout``,
``Flatten`` and ``Reshape``. The JAX package's other layers (Conv2D and
the pools, Embedding, LSTM/GRU, LayerNormalization/BatchNormalization,
the merges) raise ``NotImplementedError`` on deserialization (ROADMAP
Queue 1 item 3).
"""
import collections
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from . import activations as activations_mod
from . import initializers

_LAYER_UIDS: Dict[str, int] = collections.defaultdict(int)
# async workers build models on threads of their own
_UID_LOCK = threading.Lock()


def _unique_name(prefix: str) -> str:
    with _UID_LOCK:
        _LAYER_UIDS[prefix] += 1
        count = _LAYER_UIDS[prefix]
    return prefix if count == 1 else f"{prefix}_{count - 1}"


def reset_layer_uids():
    """Reset auto-naming counters (used by tests for determinism)."""
    _LAYER_UIDS.clear()


class KTensor:
    """Symbolic tensor flowing through the functional-API graph.

    ``shape`` excludes the batch dimension. ``history`` is the producing
    ``(layer, inbound KTensors)`` pair, or None for placeholders.
    """

    def __init__(self, shape: Tuple, history=None):
        self.shape = tuple(shape)
        self.history = history

    def __repr__(self):
        return f"KTensor(shape={self.shape})"


def Input(shape: Sequence[int], name: Optional[str] = None) -> KTensor:
    """Create a symbolic model input (batch dimension implicit)."""
    layer = InputLayer(shape=tuple(shape), name=name)
    return layer._output


class Layer:
    """Base layer. Subclasses override build/compute_output_shape/call."""

    #: ordering of weight arrays for get_weights()/set_weights()
    weight_order: Tuple[str, ...] = ()

    def __init__(self, name: Optional[str] = None, **kwargs):
        prefix = kwargs.pop("name_prefix", None) or type(self).__name__.lower()
        self.name = name or _unique_name(prefix)
        self.input_spec: Optional[Tuple] = kwargs.pop("input_shape", None)
        input_dim = kwargs.pop("input_dim", None)
        if input_dim is not None:
            self.input_spec = (input_dim,)
        self.built_input_shape: Optional[Tuple] = None
        self._custom_objects: Dict[str, Any] = {}

    # -- graph recording -----------------------------------------------------
    def __call__(self, inputs: Union[KTensor, List[KTensor]]):
        in_list = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        if not all(isinstance(t, KTensor) for t in in_list):
            raise TypeError(
                "Layers are called on symbolic KTensors (from Input(...)); to "
                "run data through a model use model.predict / model.apply.")
        shapes = [t.shape for t in in_list]
        out_shape = self.compute_output_shape(shapes if len(shapes) > 1 else shapes[0])
        return KTensor(out_shape, history=(self, list(in_list)))

    # -- to be overridden ----------------------------------------------------
    def build(self, gen: torch.Generator, input_shape) -> Dict[str, torch.Tensor]:
        self.built_input_shape = tuple(input_shape) if not isinstance(
            input_shape, list) else [tuple(s) for s in input_shape]
        return {}

    def compute_output_shape(self, input_shape):
        return tuple(input_shape)

    def call(self, params: Dict[str, torch.Tensor], inputs, training: bool,
             gen: Optional[torch.Generator]):
        raise NotImplementedError

    # -- serialization -------------------------------------------------------
    def get_config(self) -> Dict:
        config: Dict[str, Any] = {"name": self.name}
        if self.input_spec is not None:
            config["input_shape"] = list(self.input_spec)
        return config

    @classmethod
    def from_config(cls, config: Dict, custom_objects: Optional[Dict] = None):
        config = dict(config)
        if "input_shape" in config and config["input_shape"] is not None:
            config["input_shape"] = tuple(config["input_shape"])
        obj = cls(**config)
        obj._custom_objects = custom_objects or {}
        return obj

    def __repr__(self):
        return f"{type(self).__name__}(name={self.name!r})"


class InputLayer(Layer):
    def __init__(self, shape: Tuple, name: Optional[str] = None, **kwargs):
        super().__init__(name=name, name_prefix="input", **kwargs)
        self.shape = tuple(shape)
        self._output = KTensor(self.shape, history=(self, []))

    def compute_output_shape(self, input_shape):
        return self.shape

    def call(self, params, inputs, training, gen):
        return inputs

    def get_config(self):
        return {"name": self.name, "shape": list(self.shape)}

    @classmethod
    def from_config(cls, config, custom_objects=None):
        return cls(shape=tuple(config["shape"]), name=config.get("name"))


class Dense(Layer):
    """Fully-connected layer: ``y = act(x @ kernel + bias)``, the kernel
    laid out ``(in, out)`` as in the JAX package."""

    weight_order = ("kernel", "bias")

    def __init__(self, units: int, activation=None, use_bias: bool = True,
                 kernel_initializer="glorot_uniform", bias_initializer="zeros",
                 name: Optional[str] = None, **kwargs):
        super().__init__(name=name, **kwargs)
        self.units = int(units)
        self.activation = activation
        self.use_bias = bool(use_bias)
        self.kernel_initializer = kernel_initializer
        self.bias_initializer = bias_initializer

    def build(self, gen, input_shape):
        super().build(gen, input_shape)
        in_dim = int(input_shape[-1]) if len(input_shape) else 1
        params = {"kernel": initializers.get(self.kernel_initializer)(
            gen, (in_dim, self.units))}
        if self.use_bias:
            params["bias"] = initializers.get(self.bias_initializer)(
                gen, (self.units,))
        return params

    def compute_output_shape(self, input_shape):
        if not len(input_shape):
            return (self.units,)
        return tuple(input_shape[:-1]) + (self.units,)

    def call(self, params, inputs, training, gen):
        if inputs.ndim == 1:  # scalar feature per sample
            inputs = inputs[:, None]
        y = inputs @ params["kernel"]
        if self.use_bias:
            y = y + params["bias"]
        return activations_mod.get(self.activation, self._custom_objects)(y)

    def get_config(self):
        config = super().get_config()
        config.update({
            "units": self.units,
            "activation": activations_mod.serialize(self.activation),
            "use_bias": self.use_bias,
        })
        return config


class Activation(Layer):
    def __init__(self, activation, name: Optional[str] = None, **kwargs):
        super().__init__(name=name, **kwargs)
        self.activation = activation

    def call(self, params, inputs, training, gen):
        return activations_mod.get(self.activation, self._custom_objects)(inputs)

    def get_config(self):
        config = super().get_config()
        config["activation"] = activations_mod.serialize(self.activation)
        return config


class Dropout(Layer):
    """Inverted dropout: in training each unit is kept with probability
    ``1 - rate`` (a draw from ``gen``) and scaled by ``1 / (1 - rate)``;
    the identity in inference."""

    def __init__(self, rate: float, name: Optional[str] = None, **kwargs):
        super().__init__(name=name, **kwargs)
        self.rate = float(rate)

    def call(self, params, inputs, training, gen):
        if not training or self.rate <= 0.0:
            return inputs
        keep = 1.0 - self.rate
        mask = torch.rand(inputs.shape, generator=gen,
                          device=inputs.device) < keep
        return torch.where(mask, inputs / keep, torch.zeros_like(inputs))

    def get_config(self):
        config = super().get_config()
        config["rate"] = self.rate
        return config


class Flatten(Layer):
    def compute_output_shape(self, input_shape):
        size = 1
        for d in input_shape:
            size *= int(d)
        return (size,)

    def call(self, params, inputs, training, gen):
        return inputs.reshape(inputs.shape[0], -1)


class Reshape(Layer):
    def __init__(self, target_shape: Sequence[int], name: Optional[str] = None,
                 **kwargs):
        super().__init__(name=name, **kwargs)
        self.target_shape = tuple(target_shape)

    def compute_output_shape(self, input_shape):
        return self.target_shape

    def call(self, params, inputs, training, gen):
        return inputs.reshape((inputs.shape[0],) + self.target_shape)

    def get_config(self):
        config = super().get_config()
        config["target_shape"] = list(self.target_shape)
        return config


_LAYERS = {
    "InputLayer": InputLayer,
    "Dense": Dense,
    "Activation": Activation,
    "Dropout": Dropout,
    "Flatten": Flatten,
    "Reshape": Reshape,
}
#: layer classes of the JAX package that this port does not carry yet
_NOT_PORTED = {"Conv2D", "MaxPooling2D", "AveragePooling2D",
               "GlobalAveragePooling2D", "Embedding", "LSTM", "GRU",
               "LayerNormalization", "BatchNormalization", "Add",
               "Multiply", "Concatenate"}


def register_layer(cls, name: Optional[str] = None):
    """Register a custom Layer subclass for deserialization."""
    _LAYERS[name or cls.__name__] = cls
    return cls


def deserialize_layer(spec: Dict, custom_objects: Optional[Dict] = None) -> Layer:
    class_name = spec["class_name"]
    cls = None
    if custom_objects and class_name in custom_objects:
        cls = custom_objects[class_name]
    elif class_name in _LAYERS:
        cls = _LAYERS[class_name]
    elif class_name in _NOT_PORTED:
        raise NotImplementedError(f"layer {class_name!r} is not ported yet "
                                  "(ROADMAP Queue 1 item 3)")
    if cls is None:
        raise ValueError(f"Unknown layer class: {class_name!r}")
    return cls.from_config(spec.get("config", {}), custom_objects=custom_objects)


def serialize_layer(layer: Layer) -> Dict:
    return {"class_name": type(layer).__name__, "config": layer.get_config()}
