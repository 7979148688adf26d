"""Weight-only int8 quantization for serving.

The counterpart of the weight half of ``elephas_tpu/models/
quantization.py`` (``QTensor``, ``quantize_weight``,
``quantize_lm_params``, ``dequantize_lm_params``); its KV wire codec
belongs to the disaggregated and tiered serving planes, not ported yet.

Decode reads every weight once per generated token, so int8 weights
halve the bytes of bf16 ones: symmetric per-output-channel absmax
scales, no activation quantization and no calibration data. The
transformer consumes every large weight through ``w.to(config.dtype)``
(``_qkv``, ``_mlp_apply``, the MoE experts, ``head_logits``), and
:meth:`QTensor.to` with a dtype dequantizes, so a quantized parameter
dict drops into ``forward``, ``decode_step``, ``generate`` and the
serving engine unchanged. Here the dequantization is a separate
elementwise pass per call (int8 -> f32 -> the compute dtype), where
XLA fuses it into the consuming matmul's operand read.

Scope: serving and inference only; training wants fp weights.
"""
from typing import Dict, Tuple

import torch

__all__ = ["QTensor", "quantize_weight", "quantize_lm_params",
           "dequantize_lm_params"]


class QTensor:
    """int8 ``data`` and broadcastable per-output-channel f32 ``scale``.

    Quacks like a tensor exactly as far as the transformer needs:
    ``.to(dtype)`` dequantizes (in f32, rounded once into ``dtype``),
    ``.to(device)`` moves both tensors, and ``shape``, ``ndim``,
    ``device`` and ``.T`` (the chunked-vocab loss transposes an untied
    quantized ``head``). The weight bridge treats it as a node of two
    leaves, ``data`` then ``scale``, as the JAX pytree node is."""

    __slots__ = ("data", "scale")

    def __init__(self, data, scale):
        self.data = data
        self.scale = scale

    def to(self, target, *args, **kwargs):
        if isinstance(target, torch.dtype):
            # dequantize in f32 and round ONCE into the compute dtype: a
            # bf16 scale would stack its rounding on int8's error
            return (self.data.to(torch.float32) * self.scale).to(target)
        return QTensor(self.data.to(target, *args, **kwargs),
                       self.scale.to(target, *args, **kwargs))

    @property
    def shape(self):
        return self.data.shape

    @property
    def ndim(self) -> int:
        return self.data.ndim

    @property
    def device(self):
        return self.data.device

    @property
    def T(self) -> "QTensor":
        return QTensor(self.data.T, self.scale.T)

    def __repr__(self) -> str:
        return (f"QTensor(shape={tuple(self.data.shape)}, "
                f"scale_shape={tuple(self.scale.shape)})")


def quantize_weight(w, reduce_axes: Tuple[int, ...]) -> QTensor:
    """Symmetric per-output-channel int8: the absmax over the contracted
    ``reduce_axes`` sets each output channel's scale. ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    w = torch.as_tensor(w).to(torch.float32)
    absmax = w.abs().amax(dim=tuple(reduce_axes), keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return QTensor(q, scale)


#: weight name -> contracted axes, per sublayer: wq/wk/wv (d, h, k)
#: contract d; wo (h, k, d) contracts (h, k); dense-MLP w1/w3 (d, ff)
#: and w2 (ff, d) their first dim; MoE w1 (E, d, f) and w2 (E, f, d)
#: the middle one (per-expert, per-output-channel scales)
_ATTN_AXES = {"wq": (0,), "wk": (0,), "wv": (0,), "wo": (0, 1)}
_MLP_AXES = {"w1": (0,), "w2": (0,), "w3": (0,)}
_MOE_AXES = {"w1": (1,), "w2": (1,)}


def _quantize_named(sub: Dict, axes: Dict) -> Dict:
    return {k: quantize_weight(v, axes[k]) if k in axes else v
            for k, v in sub.items()}


def quantize_lm_params(params: Dict) -> Dict:
    """The transformer LM's matmul weights as int8 :class:`QTensor`\\ s,
    driven by the tree alone (no config): attention projections,
    dense-MLP weights, MoE expert and shared-expert weights, and the
    untied ``head``. Embeddings (a gather table, and the tied head),
    norms, biases and MoE gates stay fp."""
    out = dict(params)
    for name, layer in params.items():
        if not name.startswith("layer_"):
            continue
        new_layer = dict(layer)
        new_layer["attn"] = _quantize_named(layer["attn"], _ATTN_AXES)
        if "mlp" in layer:
            new_layer["mlp"] = _quantize_named(layer["mlp"], _MLP_AXES)
        if "moe" in layer:
            moe = dict(layer["moe"])
            for k in ("w1", "w2"):
                moe[k] = quantize_weight(moe[k], _MOE_AXES[k])
            if "shared" in moe:
                moe["shared"] = _quantize_named(moe["shared"], _MLP_AXES)
            new_layer["moe"] = moe
        out[name] = new_layer
    if params.get("head") is not None:
        out["head"] = quantize_weight(params["head"], (0,))
    return out


def dequantize_lm_params(params: Dict) -> Dict:
    """Every :class:`QTensor` back to an f32 tensor (a round-trip and
    debugging aid)."""
    if isinstance(params, dict):
        return {k: dequantize_lm_params(v) for k, v in params.items()}
    if isinstance(params, QTensor):
        return params.to(torch.float32)
    return params
