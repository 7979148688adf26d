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

Every layer of the JAX package is here, with its weight layout:

- ``Conv2D`` and the pools take NHWC inputs and keep the kernel HWIO;
  they run torch's NCHW ops on permuted views. ``padding="same"`` pads
  as XLA's SAME does, the odd row or column at the end (``F.pad`` with
  XLA's (lo, hi)), which torch's own ``"same"`` refuses at a stride
  above 1. MaxPooling2D pads with -inf, AveragePooling2D divides by the
  count of cells inside the image, as the JAX layer's second
  ``reduce_window`` over ones does. On the card the convolutions are
  cuDNN's, under torch's TF32 setting
  (``torch.backends.cudnn.allow_tf32``, True by default).
- ``Embedding`` casts its inputs to int32 and takes rows as
  ``jnp.take`` does: an index in [-n, 0) counts from the end, one
  outside [-n, n) gives a row of NaN.
- ``LSTM`` (gates i, f, g, o) and ``GRU`` (gates z, r, n, the reset
  gate applied before the recurrent product) project every timestep's
  input in one product and loop over time for the recurrent half. An
  LSTM with the default tanh/sigmoid pair on an f32 CUDA tensor runs
  cuDNN's LSTM (``torch._VF.lstm``: the same gate order, the one bias
  as ``b_ih`` and zeros as ``b_hh``); torch's and cuDNN's GRU apply the
  reset gate after the product, another function, so the GRU always
  loops.
- ``BatchNormalization`` normalizes over every axis but the last, with
  the biased batch variance; its moving statistics are non-trainable
  parameters the train step replaces with
  :meth:`BatchNormalization.moving_updates` (``m * moving + (1 - m) *
  batch``).
"""
import collections
import threading
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

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


def _pair(value) -> Tuple[int, int]:
    if isinstance(value, (tuple, list)):
        return int(value[0]), int(value[1])
    return int(value), int(value)


def _out_spatial(padding: str, size: int, k: int, s: int) -> int:
    if padding == "same":
        return -(-size // s)
    return (size - k) // s + 1


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial axis: (lo, hi), the odd cell
    at the end."""
    total = max((_out_spatial("same", size, k, s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _nchw(inputs: torch.Tensor, window, strides, padding: str,
          value: float = 0.0) -> torch.Tensor:
    """An NHWC tensor as an NCHW view, padded as XLA's SAME pads it
    when ``padding`` is "same"."""
    x = inputs.permute(0, 3, 1, 2)
    if padding == "same":
        h_lo, h_hi = _same_pads(x.shape[2], window[0], strides[0])
        w_lo, w_hi = _same_pads(x.shape[3], window[1], strides[1])
        if h_lo or h_hi or w_lo or w_hi:
            x = F.pad(x, (w_lo, w_hi, h_lo, h_hi), value=value)
    return x


class Conv2D(Layer):
    """2-D convolution over NHWC inputs with an HWIO kernel (the JAX
    layout, so ``get_weights`` crosses as it is)."""

    weight_order = ("kernel", "bias")

    def __init__(self, filters: int, kernel_size, strides=1,
                 padding: str = "valid", activation=None,
                 use_bias: bool = True,
                 kernel_initializer="glorot_uniform",
                 bias_initializer="zeros", name: Optional[str] = None,
                 **kwargs):
        super().__init__(name=name, **kwargs)
        self.filters = int(filters)
        self.kernel_size = _pair(kernel_size)
        self.strides = _pair(strides)
        self.padding = padding.lower()
        self.activation = activation
        self.use_bias = bool(use_bias)
        self.kernel_initializer = kernel_initializer
        self.bias_initializer = bias_initializer

    def build(self, gen, input_shape):
        super().build(gen, input_shape)
        in_ch = int(input_shape[-1])
        params = {"kernel": initializers.get(self.kernel_initializer)(
            gen, self.kernel_size + (in_ch, self.filters))}
        if self.use_bias:
            params["bias"] = initializers.get(self.bias_initializer)(
                gen, (self.filters,))
        return params

    def compute_output_shape(self, input_shape):
        h, w, _ = input_shape
        return (_out_spatial(self.padding, h, self.kernel_size[0],
                             self.strides[0]),
                _out_spatial(self.padding, w, self.kernel_size[1],
                             self.strides[1]),
                self.filters)

    def call(self, params, inputs, training, gen):
        x = _nchw(inputs, self.kernel_size, self.strides, self.padding)
        # HWIO -> OIHW
        y = F.conv2d(x, params["kernel"].permute(3, 2, 0, 1),
                     stride=self.strides).permute(0, 2, 3, 1)
        if self.use_bias:
            y = y + params["bias"]
        return activations_mod.get(self.activation, self._custom_objects)(y)

    def get_config(self):
        config = super().get_config()
        config.update({
            "filters": self.filters,
            "kernel_size": list(self.kernel_size),
            "strides": list(self.strides),
            "padding": self.padding,
            "activation": activations_mod.serialize(self.activation),
            "use_bias": self.use_bias,
        })
        return config


class _Pool2D(Layer):
    def __init__(self, pool_size=2, strides=None, padding: str = "valid",
                 name: Optional[str] = None, **kwargs):
        super().__init__(name=name, **kwargs)
        self.pool_size = _pair(pool_size)
        self.strides = _pair(strides) if strides is not None else self.pool_size
        self.padding = padding.lower()

    def compute_output_shape(self, input_shape):
        h, w, c = input_shape
        return (_out_spatial(self.padding, h, self.pool_size[0],
                             self.strides[0]),
                _out_spatial(self.padding, w, self.pool_size[1],
                             self.strides[1]), c)

    def get_config(self):
        config = super().get_config()
        config.update({"pool_size": list(self.pool_size),
                       "strides": list(self.strides), "padding": self.padding})
        return config


class MaxPooling2D(_Pool2D):
    def call(self, params, inputs, training, gen):
        x = _nchw(inputs, self.pool_size, self.strides, self.padding,
                  value=float("-inf"))
        return F.max_pool2d(x, self.pool_size, self.strides).permute(
            0, 2, 3, 1)


class AveragePooling2D(_Pool2D):
    """The window's sum over the count of its cells inside the image
    (SAME's padding cells do not count)."""

    def call(self, params, inputs, training, gen):
        def window_sums(x):
            x = _nchw(x, self.pool_size, self.strides, self.padding)
            return F.avg_pool2d(x, self.pool_size, self.strides,
                                divisor_override=1)

        counts = window_sums(inputs.new_ones((1,) + tuple(inputs.shape[1:3])
                                             + (1,)))
        return (window_sums(inputs) / counts).permute(0, 2, 3, 1)


class GlobalAveragePooling2D(Layer):
    def compute_output_shape(self, input_shape):
        return (input_shape[-1],)

    def call(self, params, inputs, training, gen):
        return inputs.mean(dim=(1, 2))


class Embedding(Layer):
    weight_order = ("embeddings",)

    def __init__(self, input_dim: int, output_dim: int,
                 embeddings_initializer="random_uniform",
                 name: Optional[str] = None, **kwargs):
        super().__init__(name=name, **kwargs)
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)
        self.embeddings_initializer = embeddings_initializer

    def build(self, gen, input_shape):
        super().build(gen, input_shape)
        return {"embeddings": initializers.get(self.embeddings_initializer)(
            gen, (self.input_dim, self.output_dim))}

    def compute_output_shape(self, input_shape):
        return tuple(input_shape) + (self.output_dim,)

    def call(self, params, inputs, training, gen):
        table = params["embeddings"]
        n = table.shape[0]
        idx = inputs.to(torch.int32).long()
        valid = (idx >= -n) & (idx < n)
        rows = table[torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)]
        return torch.where(valid[..., None], rows,
                           rows.new_full((), float("nan")))

    def get_config(self):
        config = super().get_config()
        config.update({"input_dim": self.input_dim, "output_dim": self.output_dim})
        return config


class _Recurrent(Layer):
    """Shared config of LSTM and GRU over ``(batch, time, features)``;
    ``gates`` blocks of ``units`` columns in each kernel."""

    weight_order = ("kernel", "recurrent_kernel", "bias")
    gates = 1

    def __init__(self, units: int, activation="tanh",
                 recurrent_activation="sigmoid",
                 return_sequences: bool = False, use_bias: bool = True,
                 kernel_initializer="glorot_uniform",
                 recurrent_initializer="orthogonal",
                 name: Optional[str] = None, **kwargs):
        super().__init__(name=name, **kwargs)
        self.units = int(units)
        self.activation = activation
        self.recurrent_activation = recurrent_activation
        self.return_sequences = bool(return_sequences)
        self.use_bias = bool(use_bias)
        self.kernel_initializer = kernel_initializer
        self.recurrent_initializer = recurrent_initializer

    def _bias(self, gen) -> torch.Tensor:
        return torch.zeros(self.gates * self.units, device=gen.device)

    def build(self, gen, input_shape):
        super().build(gen, input_shape)
        in_dim = int(input_shape[-1])
        width = self.gates * self.units
        params = {
            "kernel": initializers.get(self.kernel_initializer)(
                gen, (in_dim, width)),
            "recurrent_kernel": initializers.get(self.recurrent_initializer)(
                gen, (self.units, width)),
        }
        if self.use_bias:
            params["bias"] = self._bias(gen)
        return params

    def compute_output_shape(self, input_shape):
        t = input_shape[0]
        return ((t, self.units) if self.return_sequences
                else (self.units,))

    def _activations(self):
        return (activations_mod.get(self.activation, self._custom_objects),
                activations_mod.get(self.recurrent_activation,
                                    self._custom_objects))

    def _input_projection(self, params, inputs):
        """Every timestep's input half of the gates, one product."""
        xz = inputs @ params["kernel"]
        return xz + params["bias"] if self.use_bias else xz

    def _outputs(self, hs: List[torch.Tensor]):
        return torch.stack(hs, dim=1) if self.return_sequences else hs[-1]

    def get_config(self):
        config = super().get_config()
        config.update({
            "units": self.units,
            "activation": activations_mod.serialize(self.activation),
            "recurrent_activation": activations_mod.serialize(
                self.recurrent_activation),
            "return_sequences": self.return_sequences,
            "use_bias": self.use_bias,
        })
        return config


#: cuDNN's LSTM takes its weights as separate tensors here; it copies
#: them into its own buffer at each call and says so
_RNN_CHUNK_WARNING = "RNN module weights are not part of single contiguous"


class LSTM(_Recurrent):
    """Long short-term memory, gate order (i, f, g, o), forget-gate bias
    initialized to 1, orthogonal recurrent kernel."""

    gates = 4

    def _bias(self, gen):
        bias = super()._bias(gen)
        bias[self.units:2 * self.units] = 1.0
        return bias

    def cudnn_route(self, inputs: torch.Tensor) -> bool:
        """Whether :meth:`call` runs cuDNN's LSTM on ``inputs``: an f32
        CUDA tensor and the tanh/sigmoid pair cuDNN computes."""
        return (inputs.is_cuda and inputs.dtype == torch.float32
                and activations_mod.serialize(self.activation) == "tanh"
                and activations_mod.serialize(
                    self.recurrent_activation) == "sigmoid")

    def call(self, params, inputs, training, gen):
        if self.cudnn_route(inputs):
            return self._call_cudnn(params, inputs)
        act, rec_act = self._activations()
        u = self.units
        xz = self._input_projection(params, inputs)
        w_rec = params["recurrent_kernel"]
        h = inputs.new_zeros((inputs.shape[0], u))
        c = h
        hs = []
        for t in range(inputs.shape[1]):
            z = xz[:, t] + h @ w_rec
            i = rec_act(z[:, :u])
            f = rec_act(z[:, u:2 * u])
            g = act(z[:, 2 * u:3 * u])
            o = rec_act(z[:, 3 * u:])
            c = f * c + i * g
            h = o * act(c)
            hs.append(h)
        return self._outputs(hs)

    def _call_cudnn(self, params, inputs):
        warnings.filterwarnings("ignore", message=_RNN_CHUNK_WARNING)
        weights = [params["kernel"].t().contiguous(),
                   params["recurrent_kernel"].t().contiguous()]
        if self.use_bias:
            weights += [params["bias"], torch.zeros_like(params["bias"])]
        h0 = inputs.new_zeros((1, inputs.shape[0], self.units))
        out, h, _ = torch._VF.lstm(inputs, (h0, h0), weights, self.use_bias,
                                   1, 0.0, torch.is_grad_enabled(), False,
                                   True)
        return out if self.return_sequences else h[0]


class GRU(_Recurrent):
    """Gated recurrent unit, gate order (z, r, n), the reset gate applied
    to the state before the candidate's recurrent product (the JAX
    package's form; torch's and cuDNN's GRU compute another function)."""

    gates = 3

    def call(self, params, inputs, training, gen):
        act, rec_act = self._activations()
        u = self.units
        xz = self._input_projection(params, inputs)
        w_rz = params["recurrent_kernel"][:, :2 * u]
        w_n = params["recurrent_kernel"][:, 2 * u:]
        h = inputs.new_zeros((inputs.shape[0], u))
        hs = []
        for t in range(inputs.shape[1]):
            xz_t = xz[:, t]
            rz = xz_t[:, :2 * u] + h @ w_rz
            z = rec_act(rz[:, :u])
            r = rec_act(rz[:, u:])
            n = act(xz_t[:, 2 * u:] + (r * h) @ w_n)
            h = (1.0 - z) * n + z * h
            hs.append(h)
        return self._outputs(hs)


class LayerNormalization(Layer):
    weight_order = ("gamma", "beta")

    def __init__(self, epsilon: float = 1e-5, name: Optional[str] = None,
                 **kwargs):
        super().__init__(name=name, **kwargs)
        self.epsilon = float(epsilon)

    def build(self, gen, input_shape):
        super().build(gen, input_shape)
        dim = int(input_shape[-1])
        return {"gamma": initializers.ones(gen, (dim,)),
                "beta": initializers.zeros(gen, (dim,))}

    def call(self, params, inputs, training, gen):
        mean = inputs.mean(dim=-1, keepdim=True)
        var = inputs.var(dim=-1, correction=0, keepdim=True)
        normed = (inputs - mean) * torch.rsqrt(var + self.epsilon)
        return normed * params["gamma"] + params["beta"]

    def get_config(self):
        config = super().get_config()
        config["epsilon"] = self.epsilon
        return config


class BatchNormalization(Layer):
    """Batch normalization over every axis but the last. In training it
    normalizes by the batch's mean and biased variance, in inference by
    the moving statistics, which are non-trainable parameters the train
    step updates from :meth:`batch_stats`."""

    weight_order = ("gamma", "beta", "moving_mean", "moving_variance")
    non_trainable = ("moving_mean", "moving_variance")

    def __init__(self, momentum: float = 0.99, epsilon: float = 1e-3,
                 name: Optional[str] = None, **kwargs):
        super().__init__(name=name, **kwargs)
        self.momentum = float(momentum)
        self.epsilon = float(epsilon)

    def build(self, gen, input_shape):
        super().build(gen, input_shape)
        dim = int(input_shape[-1])
        return {"gamma": initializers.ones(gen, (dim,)),
                "beta": initializers.zeros(gen, (dim,)),
                "moving_mean": initializers.zeros(gen, (dim,)),
                "moving_variance": initializers.ones(gen, (dim,))}

    def call(self, params, inputs, training, gen):
        if training:
            mean, var = self.batch_stats(params, inputs)
        else:
            mean, var = params["moving_mean"], params["moving_variance"]
        normed = (inputs - mean) * torch.rsqrt(var + self.epsilon)
        return normed * params["gamma"] + params["beta"]

    def batch_stats(self, params, inputs):
        """The batch's mean and biased variance over every axis but the
        last."""
        axes = tuple(range(inputs.ndim - 1))
        return inputs.mean(dim=axes), inputs.var(dim=axes, correction=0)

    def moving_updates(self, params, inputs) -> Dict[str, torch.Tensor]:
        """The moving statistics after one training batch (no gradient):
        ``m * moving + (1 - m) * batch``."""
        with torch.no_grad():
            mean, var = self.batch_stats(params, inputs)
            m = self.momentum
            return {"moving_mean": m * params["moving_mean"] + (1 - m) * mean,
                    "moving_variance": (m * params["moving_variance"]
                                        + (1 - m) * var)}

    def get_config(self):
        config = super().get_config()
        config.update({"momentum": self.momentum, "epsilon": self.epsilon})
        return config


class _Merge(Layer):
    """Base for multi-input merge layers."""

    def compute_output_shape(self, input_shapes):
        return tuple(input_shapes[0])


class Add(_Merge):
    def call(self, params, inputs, training, gen):
        out = inputs[0]
        for t in inputs[1:]:
            out = out + t
        return out


class Multiply(_Merge):
    def call(self, params, inputs, training, gen):
        out = inputs[0]
        for t in inputs[1:]:
            out = out * t
        return out


class Concatenate(_Merge):
    def __init__(self, axis: int = -1, name: Optional[str] = None, **kwargs):
        super().__init__(name=name, **kwargs)
        self.axis = int(axis)

    def compute_output_shape(self, input_shapes):
        # axis counts the batch dim (Keras semantics): axis=0 is invalid,
        # axis>0 maps to index axis-1 of the batch-less symbolic shape.
        ref = list(input_shapes[0])
        if self.axis == 0:
            raise ValueError("Cannot concatenate along the batch axis (0)")
        idx = self.axis - 1 if self.axis > 0 else len(ref) + self.axis
        ref[idx] = sum(int(s[idx]) for s in input_shapes)
        return tuple(ref)

    def call(self, params, inputs, training, gen):
        return torch.cat(list(inputs), dim=self.axis)

    def get_config(self):
        config = super().get_config()
        config["axis"] = self.axis
        return config


_LAYERS = {
    "InputLayer": InputLayer,
    "Dense": Dense,
    "Activation": Activation,
    "Dropout": Dropout,
    "Flatten": Flatten,
    "Reshape": Reshape,
    "Conv2D": Conv2D,
    "MaxPooling2D": MaxPooling2D,
    "AveragePooling2D": AveragePooling2D,
    "GlobalAveragePooling2D": GlobalAveragePooling2D,
    "Embedding": Embedding,
    "LSTM": LSTM,
    "GRU": GRU,
    "LayerNormalization": LayerNormalization,
    "BatchNormalization": BatchNormalization,
    "Add": Add,
    "Multiply": Multiply,
    "Concatenate": Concatenate,
}


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
    if cls is None:
        raise ValueError(f"Unknown layer class: {class_name!r}")
    return cls.from_config(spec.get("config", {}), custom_objects=custom_objects)


def serialize_layer(layer: Layer) -> Dict:
    return {"class_name": type(layer).__name__, "config": layer.get_config()}
