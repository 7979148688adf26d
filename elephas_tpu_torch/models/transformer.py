"""Transformer LM in PyTorch: the inference subset of the JAX family.

The counterpart of ``elephas_tpu/models/transformer.py``. A pure
function over an explicit parameter dict whose nesting and layouts are
the JAX pytree's (``wq (d_model, H, hd)``, ``wo (H, hd, d_model)``), so
the weight bridge (:mod:`elephas_tpu_torch.weights`) is a leaf-by-leaf
copy. Numerics follow the JAX code line for line: the same einsum
layouts, the same f32 head, the same ``NEG_INF`` masking, the same RoPE
half-split. bfloat16 activations and matmuls by default over f32
parameters.

Ported here: the config, ``init_params``, the embedding, norms, RoPE,
ALiBi, the dense MLP (gelu or SwiGLU), single-device ``forward`` with
the flash kernel or the plain attention path, and ``prefill_cache``.
Not ported yet (they raise ``NotImplementedError``): mixture of experts,
the int8 KV cache, rematerialization, dropout, packed ``segment_ids``
and every mesh argument.
"""
import dataclasses
import math
from functools import partial
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from ..ops.attention import NEG_INF, attention, einsum
from ..ops.flash_attention import flash_attention

__all__ = ["TransformerConfig", "init_params", "forward", "prefill_cache",
           "init_kv_cache", "embed_apply", "head_logits",
           "resolve_attention_impl", "NEG_INF", "FLAGSHIP"]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The JAX package's config, field for field (see its docstrings).
    ``dtype``/``param_dtype`` are torch dtypes. Fields of features this
    slice does not port keep their defaults; setting them raises at the
    entry points."""
    vocab_size: int = 32000
    num_layers: int = 4
    num_heads: int = 8
    d_model: int = 512
    d_ff: int = 2048
    max_seq_len: int = 2048
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    #: ``auto`` picks the flash kernel on a CUDA device and the plain
    #: path on the CPU; ``flash`` / ``xla`` force one (``xla`` names the
    #: plain PyTorch path, as in the JAX package)
    attention_impl: str = "auto"
    num_experts: int = 0
    expert_top_k: int = 2
    moe_aux_weight: float = 0.01
    moe_dispatch: str = "auto"
    moe_capacity_factor: float = 1.25
    moe_shared_expert: bool = False
    remat: bool = False
    remat_policy: str = "full"
    positional: str = "learned"
    z_loss_weight: float = 0.0
    rope_theta: float = 10000.0
    attention_window: Optional[int] = None
    kv_cache_quant: bool = False
    mlp_variant: str = "gelu"
    norm: str = "layernorm"
    flash_block_q: Optional[int] = None
    flash_block_k: Optional[int] = None
    tied_embedding: bool = True
    label_smoothing: float = 0.0
    dropout_rate: float = 0.0
    loss_vocab_chunk: Optional[int] = None
    num_kv_heads: Optional[int] = None

    def __post_init__(self):
        if self.attention_impl not in ("auto", "flash", "xla"):
            raise ValueError("attention_impl must be 'auto', 'flash' or "
                             f"'xla', got {self.attention_impl!r}")
        if not 0.0 <= self.dropout_rate < 1.0:
            raise ValueError("dropout_rate must be in [0, 1)")
        if self.attention_window is not None and self.attention_window < 1:
            raise ValueError("attention_window must be >= 1")
        if self.mlp_variant not in ("gelu", "swiglu"):
            raise ValueError("mlp_variant must be 'gelu' or 'swiglu', "
                             f"got {self.mlp_variant!r}")
        if self.norm not in ("layernorm", "rmsnorm"):
            raise ValueError("norm must be 'layernorm' or 'rmsnorm', "
                             f"got {self.norm!r}")
        if self.positional not in ("learned", "rope", "sinusoidal",
                                   "alibi"):
            raise ValueError(
                "positional must be 'learned', 'rope', 'sinusoidal' or "
                f"'alibi', got {self.positional!r}")
        if self.positional == "rope" and self.head_dim % 2:
            raise ValueError("rope requires an even head_dim")
        if self.num_kv_heads is not None and (
                self.num_kv_heads < 1
                or self.num_heads % self.num_kv_heads):
            raise ValueError(
                f"num_kv_heads ({self.num_kv_heads}) must divide "
                f"num_heads ({self.num_heads})")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def kv_heads(self) -> int:
        """Effective number of key/value heads (GQA group count)."""
        return (self.num_kv_heads if self.num_kv_heads is not None
                else self.num_heads)


#: the repo's flagship LM config (``bench.py``'s LM rows): vocab 32000,
#: 8 layers, 16 heads, d_model 1024, d_ff 4096, learned positions,
#: layernorm, gelu, bf16 compute over f32 params;
#: ``TransformerConfig(**FLAGSHIP)``
FLAGSHIP = dict(vocab_size=32000, num_layers=8, num_heads=16, d_model=1024,
                d_ff=4096, max_seq_len=1024)


def check_ported(config: TransformerConfig) -> None:
    """Raise for the config features this port does not carry yet."""
    if config.num_experts > 1:
        raise NotImplementedError("mixture-of-experts layers are not "
                                  "ported yet")
    if config.kv_cache_quant:
        raise NotImplementedError("the int8 KV cache is not ported yet")
    if config.remat:
        raise NotImplementedError("rematerialization is a training "
                                  "feature; training is not ported yet")


def init_params(config: TransformerConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Dict:
    """The parameter dict, drawn from ``generator`` (on the generator's
    device) and placed on ``device``. Same nesting, shapes and scales as
    the JAX ``init_params``; the draws differ (another generator)."""
    check_ported(config)
    c = config
    device = resolve_device(device)

    def normal(shape, std=1.0):
        x = torch.randn(shape, generator=generator, dtype=c.param_dtype,
                        device=generator.device)
        return (x * std).to(device)

    def dense(shape, fan_in):
        return normal(shape, 1.0 / math.sqrt(fan_in))

    def ones():
        return torch.ones(c.d_model, dtype=c.param_dtype, device=device)

    def zeros(n):
        return torch.zeros(n, dtype=c.param_dtype, device=device)

    embed: Dict[str, Any] = {"tokens": normal((c.vocab_size, c.d_model),
                                              0.02)}
    if c.positional == "learned":
        embed["pos"] = normal((c.max_seq_len, c.d_model), 0.02)
    params: Dict[str, Any] = {
        "embed": embed,
        "final_ln": {"gamma": ones(), "beta": zeros(c.d_model)},
    }
    if not c.tied_embedding:
        params["head"] = dense((c.d_model, c.vocab_size), c.d_model)
    for i in range(c.num_layers):
        layer = {
            "ln1": {"gamma": ones(), "beta": zeros(c.d_model)},
            "attn": {
                "wq": dense((c.d_model, c.num_heads, c.head_dim), c.d_model),
                "wk": dense((c.d_model, c.kv_heads, c.head_dim), c.d_model),
                "wv": dense((c.d_model, c.kv_heads, c.head_dim), c.d_model),
                "wo": dense((c.num_heads, c.head_dim, c.d_model), c.d_model),
            },
            "ln2": {"gamma": ones(), "beta": zeros(c.d_model)},
            "mlp": {
                "w1": dense((c.d_model, c.d_ff), c.d_model),
                "b1": zeros(c.d_ff),
                "w2": dense((c.d_ff, c.d_model), c.d_ff),
                "b2": zeros(c.d_model),
            },
        }
        if c.mlp_variant == "swiglu":
            layer["mlp"]["w3"] = dense((c.d_model, c.d_ff), c.d_model)
        params[f"layer_{i}"] = layer
    return params


def _alibi_slope_list(num_heads: int) -> list:
    """Per-head geometric ALiBi slopes (Press et al.) as Python floats:
    for 2^n heads, 2^(-8i/n); other counts interpolate the way HF/ALiBi
    do."""
    def pow2_slopes(n):
        start = 2.0 ** (-8.0 / n)
        return [start ** (i + 1) for i in range(n)]

    n = 2 ** math.floor(math.log2(num_heads))
    slopes = pow2_slopes(n)
    if n < num_heads:
        slopes += pow2_slopes(2 * n)[0::2][:num_heads - n]
    return slopes


def _alibi_slopes(num_heads: int, device) -> torch.Tensor:
    return torch.tensor(_alibi_slope_list(num_heads), dtype=torch.float32,
                        device=device)


def _apply_rope(x: torch.Tensor, positions: torch.Tensor,
                config: TransformerConfig) -> torch.Tensor:
    """Rotate the head dimension of ``x`` (..., seq, head_dim) by the
    RoPE angles (RoFormer, half-split). Angles in f32; the rotation runs
    in x's dtype."""
    c = config
    half = c.head_dim // 2
    freqs = c.rope_theta ** (-torch.arange(half, dtype=torch.float32,
                                           device=x.device) * 2.0
                             / c.head_dim)
    angles = positions.to(torch.float32)[..., None] * freqs
    cos = torch.cos(angles).to(x.dtype)
    sin = torch.sin(angles).to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _layer_norm(x, gamma, beta, eps=1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return ((x - mean) * torch.rsqrt(var + eps)) * gamma + beta


def _rms_norm(x, gamma, eps=1e-5):
    ms = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(ms + eps) * gamma


def _norm(x, sub: Dict, c: TransformerConfig) -> torch.Tensor:
    """Config-selected normalization (rmsnorm ignores beta)."""
    if c.norm == "rmsnorm":
        return _rms_norm(x, sub["gamma"])
    return _layer_norm(x, sub["gamma"], sub["beta"])


def _sinusoidal_table(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """Parameter-free sin/cos position encoding: ``(..., d_model)``."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device) / half)
    angles = positions.to(torch.float32)[..., None] * freqs
    table = torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)
    if d_model % 2:
        table = F.pad(table, (0, 1))
    return table


def embed_apply(embed: Dict, tokens: torch.Tensor,
                config: TransformerConfig) -> torch.Tensor:
    """Token (+ positional) embedding -> activations in the compute
    dtype."""
    x = embed["tokens"][tokens]
    if config.positional == "learned":
        x = x + embed["pos"][:tokens.shape[1]]
    elif config.positional == "sinusoidal":
        x = x + _sinusoidal_table(
            torch.arange(tokens.shape[1], device=tokens.device),
            config.d_model)
    return x.to(config.dtype)


def head_logits(embed: Dict, final_ln: Dict, x: torch.Tensor,
                head: Optional[torch.Tensor] = None,
                norm: str = "layernorm") -> torch.Tensor:
    """Final norm + LM head (tied to the embedding unless ``head`` is
    given); f32 logits."""
    x = x.to(torch.float32)
    x = (_rms_norm(x, final_ln["gamma"]) if norm == "rmsnorm"
         else _layer_norm(x, final_ln["gamma"], final_ln["beta"]))
    if head is not None:
        return x @ head.to(torch.float32)
    return x @ embed["tokens"].T.to(torch.float32)


def _qkv(layer: Dict, h: torch.Tensor, c: TransformerConfig):
    """(B, T, D) compute-dtype activations -> q/k/v ``(B, heads, T, hd)``."""
    a = layer["attn"]
    return tuple(einsum("btd,dhk->bhtk", h, a[w].to(c.dtype))
                 for w in ("wq", "wk", "wv"))


def _attn_apply(layer: Dict, x: torch.Tensor, c: TransformerConfig,
                attn_fn) -> torch.Tensor:
    """Pre-LN attention sublayer with residual; ``attn_fn(q, k, v) -> o``
    supplies the attention implementation."""
    h = _norm(x, layer["ln1"], c).to(c.dtype)
    q, k, v = _qkv(layer, h, c)
    if c.positional == "rope":
        pos = torch.arange(x.shape[1], device=x.device)
        q = _apply_rope(q, pos, c)
        k = _apply_rope(k, pos, c)
    if (c.kv_heads != c.num_heads
            and not getattr(attn_fn, "handles_gqa", False)):
        groups = c.num_heads // c.kv_heads
        k = torch.repeat_interleave(k, groups, dim=1)
        v = torch.repeat_interleave(v, groups, dim=1)
    o = attn_fn(q, k, v)
    return x + einsum("bhtk,hkd->btd", o, layer["attn"]["wo"].to(c.dtype))


def _mlp_apply(layer: Dict, x: torch.Tensor,
               c: TransformerConfig) -> torch.Tensor:
    """Pre-LN dense MLP sublayer with residual (gelu or SwiGLU)."""
    h = _norm(x, layer["ln2"], c).to(c.dtype)
    mlp = layer["mlp"]
    if c.mlp_variant == "swiglu":
        gate = F.silu(h @ mlp["w1"].to(c.dtype) + mlp["b1"].to(c.dtype))
        h = gate * (h @ mlp["w3"].to(c.dtype))
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h @ mlp["w1"].to(c.dtype) + mlp["b1"].to(c.dtype),
                   approximate="tanh")
    h = h @ mlp["w2"].to(c.dtype) + mlp["b2"].to(c.dtype)
    return x + h


def resolve_attention_impl(config: TransformerConfig,
                           device: torch.device) -> str:
    """``"flash"`` or ``"xla"`` (the plain path) for single-device
    attention: ``auto`` picks flash on a CUDA device. ALiBi always takes
    the plain path, whose bias it needs (the JAX routing rule)."""
    if config.positional == "alibi":
        return "xla"
    if config.attention_impl == "auto":
        return "flash" if device.type == "cuda" else "xla"
    return config.attention_impl


def forward(params: Dict, tokens: torch.Tensor, config: TransformerConfig,
            mesh=None, seq_axis=None, batch_axis=None, model_axis=None,
            dropout_key=None, segment_ids=None) -> torch.Tensor:
    """Token ids ``(batch, seq)`` -> f32 logits ``(batch, seq, vocab)``
    on a single device: the device of ``params``. The mesh, dropout and
    packed-segment arguments of the JAX signature are not ported and
    raise when given."""
    if any(a is not None for a in (mesh, seq_axis, batch_axis,
                                   model_axis)):
        raise NotImplementedError("mesh parallelism is not ported yet")
    if dropout_key is not None:
        raise NotImplementedError("dropout is a training feature; "
                                  "training is not ported yet")
    if segment_ids is not None:
        raise NotImplementedError("packed segment_ids are not ported yet")
    check_ported(config)
    c = config
    device = params["embed"]["tokens"].device
    tokens = torch.as_tensor(tokens, device=device).long()
    x = embed_apply(params["embed"], tokens, c)
    if resolve_attention_impl(c, device) == "flash":
        attn_fn = partial(flash_attention, causal=True,
                          window=c.attention_window)
        # the kernel maps GQA heads itself: k/v stay narrow
        attn_fn.handles_gqa = True
    elif c.attention_window is not None or c.positional == "alibi":
        t = tokens.shape[1]
        q_pos = torch.arange(t, device=device)[:, None]
        k_pos = torch.arange(t, device=device)[None, :]
        mask = (k_pos <= q_pos)[None, None]
        if c.attention_window is not None:
            mask = mask & (k_pos > q_pos - c.attention_window)[None, None]
        bias = None
        if c.positional == "alibi":
            slopes = _alibi_slopes(c.num_heads, device)
            dist = (q_pos - k_pos).to(torch.float32)
            bias = (-slopes[:, None, None] * dist)[None]
        attn_fn = partial(attention, causal=False, mask=mask, bias=bias)
    else:
        attn_fn = partial(attention, causal=True)
    for i in range(c.num_layers):
        layer = params[f"layer_{i}"]
        x = _attn_apply(layer, x, c, attn_fn)
        x = _mlp_apply(layer, x, c)
    return head_logits(params["embed"], params["final_ln"], x,
                       head=params.get("head"), norm=c.norm)


def init_kv_cache(config: TransformerConfig, batch: int,
                  max_len: Optional[int] = None,
                  device: DeviceLike = None) -> Dict:
    """Per-layer ``(batch, kv_heads, max_len, head_dim)`` zero k/v in the
    compute dtype."""
    check_ported(config)
    c = config
    device = resolve_device(device)
    shape = (batch, c.kv_heads, max_len or c.max_seq_len, c.head_dim)
    return {f"layer_{i}": {"k": torch.zeros(shape, dtype=c.dtype,
                                            device=device),
                           "v": torch.zeros(shape, dtype=c.dtype,
                                            device=device)}
            for i in range(c.num_layers)}


def prefill_cache(params: Dict, tokens: torch.Tensor,
                  config: TransformerConfig,
                  max_len: int) -> Tuple[torch.Tensor, Dict]:
    """Batched prompt prefill: one forward pass over ``(batch, T)``
    prompt tokens that writes every position's k/v into a fresh decode
    cache and returns the last position's logits ``(batch, vocab)``.
    Attention here is the plain grouped einsum softmax, as in the JAX
    package (the flash kernel is not on this path)."""
    check_ported(config)
    c = config
    device = params["embed"]["tokens"].device
    tokens = torch.as_tensor(tokens, device=device).long()
    b, t = tokens.shape
    x = embed_apply(params["embed"], tokens, c)
    cache = init_kv_cache(c, b, max_len, device)
    positions = torch.arange(t, device=device)
    q_pos = positions[:, None]
    k_pos = positions[None, :]
    mask = k_pos <= q_pos
    if c.attention_window is not None:
        mask = mask & (k_pos > q_pos - c.attention_window)
    mask = mask[None, None, None]                        # (1, 1, 1, T, T)
    scale = 1.0 / math.sqrt(c.head_dim)
    groups = c.num_heads // c.kv_heads
    for i in range(c.num_layers):
        layer = params[f"layer_{i}"]
        h = _norm(x, layer["ln1"], c).to(c.dtype)
        q, k, v = _qkv(layer, h, c)
        if c.positional == "rope":
            q = _apply_rope(q, positions, c)
            k = _apply_rope(k, positions, c)
        cache[f"layer_{i}"]["k"][:, :, :t] = k
        cache[f"layer_{i}"]["v"][:, :, :t] = v
        qg = q.reshape(b, c.kv_heads, groups, t, c.head_dim)
        scores = einsum("bngqk,bntk->bngqt", qg, k) * scale
        if c.positional == "alibi":
            dist = (q_pos - k_pos).to(torch.float32)
            ab = (-_alibi_slopes(c.num_heads, device)[:, None, None]
                  * dist[None]).reshape(c.kv_heads, groups, t, t)
            scores = scores + ab[None]
        scores = torch.where(mask, scores, NEG_INF)
        weights = torch.softmax(scores, dim=-1)
        o = einsum("bngqt,bntk->bngqk", weights, v)
        o = o.reshape(b, c.num_heads, t, c.head_dim)
        x = x + einsum("bhtk,hkd->btd", o, layer["attn"]["wo"].to(c.dtype))
        x = _mlp_apply(layer, x, c)
    logits = head_logits(params["embed"], params["final_ln"], x[:, -1],
                         head=params.get("head"), norm=c.norm)
    return logits, cache
