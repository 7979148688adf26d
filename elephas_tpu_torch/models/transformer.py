"""Transformer LM in PyTorch: inference and single-device training.

The counterpart of ``elephas_tpu/models/transformer.py``. A pure
function over an explicit parameter dict whose nesting and layouts are
the JAX pytree's (``wq (d_model, H, hd)``, ``wo (H, hd, d_model)``), so
the weight bridge (:mod:`elephas_tpu_torch.weights`) is a leaf-by-leaf
copy. Numerics follow the JAX code line for line: the same einsum
layouts, the same f32 head, the same ``NEG_INF`` masking, the same RoPE
half-split. bfloat16 activations and matmuls by default over f32
parameters.

Ported here: the config, ``init_params``, the embedding, norms, RoPE,
ALiBi, the dense MLP (gelu or SwiGLU), residual dropout, single-device
``forward``/``forward_with_aux`` with the flash kernels (differentiable)
or the plain attention path, rematerialization (``remat_policy`` full
or dots) through ``torch.utils.checkpoint``, the LM losses
(``next_token_loss``, the chunked-vocab loss, z-loss, label smoothing)
in ``lm_loss``, the single-device ``make_train_step``, and
``prefill_cache``. Not ported yet (they raise ``NotImplementedError``):
mixture of experts, the int8 KV cache, packed ``segment_ids`` and every
mesh argument.

Random numbers: a dropout key is a ``torch.Generator``. Masks cannot
equal JAX's bits; a seed drawn per layer from the step's generator
(outside any checkpointed region) seeds the layer's own generator, so a
recomputed layer draws the same masks.
"""
import dataclasses
import math
from functools import partial
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from .._device import DeviceLike, resolve_device
from ..ops.attention import NEG_INF, attention, einsum
from ..ops.flash_attention import flash_attention
from ..weights import tree_flatten, tree_unflatten

__all__ = ["TransformerConfig", "init_params", "forward", "forward_with_aux",
           "lm_loss", "lm_loss_and_grads", "next_token_loss",
           "chunked_next_token_losses", "make_train_step", "prefill_cache",
           "init_kv_cache",
           "embed_apply", "head_logits", "resolve_attention_impl",
           "NEG_INF", "FLAGSHIP", "TRANSFORMER_TPUMODEL"]


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
        if not 0.0 <= self.label_smoothing < 1.0:
            raise ValueError("label_smoothing must be in [0, 1)")
        if self.remat_policy not in ("full", "dots"):
            raise ValueError("remat_policy must be 'full' or 'dots', "
                             f"got {self.remat_policy!r}")
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
#: the LM of ``examples/transformer_tpumodel.py`` (head dim 32):
#: ``TransformerConfig(**TRANSFORMER_TPUMODEL)``
TRANSFORMER_TPUMODEL = dict(vocab_size=512, num_layers=4, num_heads=8,
                            d_model=256, d_ff=512, max_seq_len=128)


def check_ported(config: TransformerConfig) -> None:
    """Raise for the config features this port does not carry yet."""
    if config.num_experts > 1:
        raise NotImplementedError("mixture-of-experts layers are not "
                                  "ported yet")
    if config.kv_cache_quant:
        raise NotImplementedError("the int8 KV cache is not ported yet")


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


def _dropout(x: torch.Tensor, rate: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout; identity when ``generator`` is None (inference)
    or ``rate`` is 0."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


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
                attn_fn, dropout_gen: Optional[torch.Generator] = None
                ) -> torch.Tensor:
    """Pre-LN attention sublayer with residual; ``attn_fn(q, k, v) -> o``
    supplies the attention implementation. ``dropout_gen`` enables
    residual dropout on the sublayer output (training only)."""
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
    out = einsum("bhtk,hkd->btd", o, layer["attn"]["wo"].to(c.dtype))
    return x + _dropout(out, c.dropout_rate, dropout_gen)


def _mlp_apply(layer: Dict, x: torch.Tensor, c: TransformerConfig,
               dropout_gen: Optional[torch.Generator] = None
               ) -> torch.Tensor:
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
    return x + _dropout(h, c.dropout_rate, dropout_gen)


def resolve_attention_impl(config: TransformerConfig,
                           device: torch.device) -> str:
    """``"flash"`` or ``"xla"`` (the plain path) for single-device
    attention: ``auto`` picks flash on a CUDA device. ALiBi always takes
    the plain path, whose bias it needs (the JAX routing rule). A head
    dim the kernels have no body for raises at the kernel's operand
    check (``SUPPORTED_HEAD_DIMS``), never falls back."""
    if config.positional == "alibi":
        return "xla"
    if config.attention_impl == "auto":
        return "flash" if device.type == "cuda" else "xla"
    return config.attention_impl


def _check_single_device(mesh, seq_axis, batch_axis, model_axis,
                         segment_ids) -> None:
    if any(a is not None for a in (mesh, seq_axis, batch_axis,
                                   model_axis)):
        raise NotImplementedError("mesh parallelism is not ported yet")
    if segment_ids is not None:
        raise NotImplementedError("packed segment_ids are not ported yet")


def _attention_fn(c: TransformerConfig, device: torch.device, t: int):
    """The single-device attention of a length-``t`` causal stack: the
    flash kernels (differentiable; GQA mapped in the kernel) or the
    plain path, with the window and ALiBi masks it needs."""
    if resolve_attention_impl(c, device) == "flash":
        attn_fn = partial(flash_attention, causal=True,
                          window=c.attention_window)
        # the kernels map GQA heads themselves: k/v stay narrow
        attn_fn.handles_gqa = True
        return attn_fn
    if c.attention_window is None and c.positional != "alibi":
        return partial(attention, causal=True)
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
    return partial(attention, causal=False, mask=mask, bias=bias)


def _remat_context(policy: str):
    """``context_fn`` for ``torch.utils.checkpoint``: ``full`` recomputes
    the whole block; ``dots`` saves every matmul output and recomputes
    the rest (``jax.checkpoint_policies.dots_saveable``)."""
    if policy == "full":
        return noop_context_fn
    dots = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default}

    def save_dots(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in dots
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return partial(create_selective_checkpoint_contexts, save_dots)


def _layer_seeds(generator: Optional[torch.Generator], rate: float,
                 n: int) -> List[Optional[int]]:
    """One dropout seed per layer, drawn from the step's generator (None
    without dropout) -- the counterpart of ``fold_in(key, i)``."""
    if generator is None or rate <= 0.0:
        return [None] * n
    return torch.randint(0, 2 ** 62, (n,), generator=generator,
                         device=generator.device).tolist()


def _hidden_with_aux(params: Dict, tokens: torch.Tensor,
                     config: TransformerConfig, mesh=None, seq_axis=None,
                     batch_axis=None, model_axis=None, dropout_key=None,
                     segment_ids=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block stack up to (but excluding) the LM head, on the device
    of ``params``: final hidden states ``(B, T, D)`` and the MoE aux loss
    (0: dense layers only). ``dropout_key`` (a ``torch.Generator``)
    enables residual dropout."""
    _check_single_device(mesh, seq_axis, batch_axis, model_axis,
                         segment_ids)
    if dropout_key is not None and not isinstance(dropout_key,
                                                  torch.Generator):
        raise TypeError(f"dropout_key must be a torch.Generator, got "
                        f"{type(dropout_key).__name__}")
    check_ported(config)
    c = config
    device = params["embed"]["tokens"].device
    tokens = torch.as_tensor(tokens, device=device).long()
    x = embed_apply(params["embed"], tokens, c)
    attn_fn = _attention_fn(c, device, tokens.shape[1])

    def layer_apply(layer, x, seed):
        gen = None
        if seed is not None:
            gen = torch.Generator(device=x.device)
            gen.manual_seed(seed)
        x = _attn_apply(layer, x, c, attn_fn, gen)
        return _mlp_apply(layer, x, c, gen)

    if c.remat:
        # recompute each block's activations in the backward pass instead
        # of keeping them live; the seed is an argument, so a recompute
        # rebuilds the same generator and draws the same masks
        layer_apply = partial(checkpoint, layer_apply, use_reentrant=False,
                              context_fn=_remat_context(c.remat_policy))
    seeds = _layer_seeds(dropout_key, c.dropout_rate, c.num_layers)
    for i in range(c.num_layers):
        x = layer_apply(params[f"layer_{i}"], x, seeds[i])
    return x, torch.zeros((), dtype=torch.float32, device=device)


def forward_with_aux(params: Dict, tokens: torch.Tensor,
                     config: TransformerConfig, mesh=None, seq_axis=None,
                     batch_axis=None, model_axis=None, dropout_key=None,
                     segment_ids=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Like :func:`forward` but also returns the summed MoE auxiliary
    loss (0 for the dense configs the port carries)."""
    x, aux = _hidden_with_aux(params, tokens, config, mesh, seq_axis,
                              batch_axis, model_axis, dropout_key,
                              segment_ids)
    return head_logits(params["embed"], params["final_ln"], x,
                       head=params.get("head"), norm=config.norm), aux


def forward(params: Dict, tokens: torch.Tensor, config: TransformerConfig,
            mesh=None, seq_axis=None, batch_axis=None, model_axis=None,
            dropout_key=None, segment_ids=None) -> torch.Tensor:
    """Token ids ``(batch, seq)`` -> f32 logits ``(batch, seq, vocab)``
    on a single device: the device of ``params``. ``dropout_key`` (a
    ``torch.Generator``) activates residual dropout (training). The mesh
    and packed-segment arguments of the JAX signature are not ported and
    raise when given."""
    logits, _ = forward_with_aux(params, tokens, config, mesh, seq_axis,
                                 batch_axis, model_axis, dropout_key,
                                 segment_ids)
    return logits


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor,
                    label_smoothing: float = 0.0) -> torch.Tensor:
    """Next-token cross-entropy, mean over all positions; with label
    smoothing, eps probability mass spreads uniformly over the vocab.
    (The packed-row ``weights`` of the JAX signature come with packed
    ``segment_ids``, not ported yet.)"""
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    ce_pos = -logp.gather(-1, targets[..., None])[..., 0]
    if label_smoothing:
        eps = label_smoothing
        ce_pos = (1.0 - eps) * ce_pos - eps * logp.mean(dim=-1)
    return ce_pos.mean()


def _vocab_chunk_step(h, e_chunk, m, s, tot):
    """One vocab chunk of the streamed logsumexp (the scan body)."""
    logits_c = h @ e_chunk.T
    m_new = torch.maximum(m, logits_c.amax(dim=-1))
    s = (s * torch.exp(m - m_new)
         + torch.exp(logits_c - m_new[..., None]).sum(dim=-1))
    return m_new, s, tot + logits_c.sum(dim=-1)


def chunked_next_token_losses(x: torch.Tensor, embed: Dict, final_ln: Dict,
                              tokens: torch.Tensor, chunk: int,
                              head: Optional[torch.Tensor] = None,
                              norm: str = "layernorm"
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Streamed LM loss pieces from the final hidden states:
    ``(cross_entropy, lse, mean_logits)`` without materializing ``(B, T,
    V)`` logits. The vocab axis goes in ``chunk``-wide slices, each under
    ``torch.utils.checkpoint`` (the rematerialized scan body of the JAX
    package), so a chunk's logits live only transiently in both passes.
    The last slice is the remainder: no padded vocab row enters the
    logsumexp."""
    h = x.to(torch.float32)
    h = (_rms_norm(h, final_ln["gamma"]) if norm == "rmsnorm"
         else _layer_norm(h, final_ln["gamma"], final_ln["beta"]))[:, :-1]
    targets = tokens[:, 1:].long()
    emb = (head.T if head is not None
           else embed["tokens"]).to(torch.float32)           # (V, D)
    v = emb.shape[0]
    m = torch.full(h.shape[:2], NEG_INF, dtype=torch.float32,
                   device=h.device)
    s = torch.zeros(h.shape[:2], dtype=torch.float32, device=h.device)
    tot = torch.zeros_like(s)
    for c0 in range(0, v, chunk):
        m, s, tot = checkpoint(_vocab_chunk_step, h, emb[c0:c0 + chunk], m,
                               s, tot, use_reentrant=False)
    lse = m + torch.log(s)                                   # (B, T')
    # target logit via a row gather: (B, T', D), not (B, T', V)
    picked = (h * emb[targets]).sum(dim=-1)
    return (lse - picked).mean(), lse, tot / v


def lm_loss(params: Dict, tokens: torch.Tensor, config: TransformerConfig,
            mesh=None, seq_axis=None, batch_axis=None, model_axis=None,
            dropout_key=None, segment_ids=None) -> torch.Tensor:
    """Next-token cross-entropy (mean over all positions), with the
    config's label smoothing and z-loss; the chunked-vocab loss when
    ``loss_vocab_chunk`` is set. Single device only."""
    c = config
    device = params["embed"]["tokens"].device
    tokens = torch.as_tensor(tokens, device=device).long()
    args = (mesh, seq_axis, batch_axis, model_axis, dropout_key,
            segment_ids)
    if c.loss_vocab_chunk:
        x, _ = _hidden_with_aux(params, tokens, c, *args)
        loss, lse, mean_logits = chunked_next_token_losses(
            x, params["embed"], params["final_ln"], tokens,
            int(c.loss_vocab_chunk), head=params.get("head"), norm=c.norm)
        if c.label_smoothing:
            # mean_v logp_v = mean_v logits_v - lse
            eps = c.label_smoothing
            loss = (1.0 - eps) * loss + eps * (lse - mean_logits).mean()
        if c.z_loss_weight:
            loss = loss + c.z_loss_weight * (lse * lse).mean()
        return loss
    logits, _ = forward_with_aux(params, tokens, c, *args)
    loss = next_token_loss(logits, tokens, label_smoothing=c.label_smoothing)
    if c.z_loss_weight:
        # PaLM-style z-loss: penalize the log-partition so logits don't
        # drift large; only predicting positions count
        z = torch.logsumexp(logits[:, :-1], dim=-1)
        loss = loss + c.z_loss_weight * (z * z).mean()
    return loss


def lm_loss_and_grads(params: Dict, tokens: torch.Tensor,
                      config: TransformerConfig, dropout_key=None
                      ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """``lm_loss`` and its gradient with respect to every parameter
    leaf, through autograd (the ``value_and_grad`` of the JAX step):
    ``(loss, grads)`` with the loss detached and ``grads`` in the leaf
    order of :func:`~elephas_tpu_torch.weights.tree_flatten`. A leaf the
    loss never reads (rmsnorm's beta) gets a zero gradient. The
    parameters themselves need not require gradients."""
    leaves, treedef = tree_flatten(params)
    # views of the same storage that autograd may differentiate
    live = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss = lm_loss(tree_unflatten(treedef, live), tokens, config,
                       dropout_key=dropout_key)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if gr is None else gr
             for p, gr in zip(leaves, grads)]
    return loss.detach(), grads


def make_train_step(config: TransformerConfig, tx, mesh=None,
                    data_axis: Optional[str] = "data",
                    model_axis: Optional[str] = "model",
                    seq_axis: Optional[str] = None,
                    zero_optimizer: bool = False, accum_steps: int = 1,
                    fsdp: bool = False, packed: bool = False):
    """The single-device ``(params, opt_state, tokens[, dropout_key]) ->
    (params, opt_state, loss)`` step, on the device of ``params``:
    ``lm_loss`` value and gradients through autograd (the flash kernels'
    backward on a CUDA device), then ``tx`` (a transform of
    :mod:`~elephas_tpu_torch.models.optimizers`: ``init(params)``,
    ``update(grads, state, params)``). ``dropout_key`` (a
    ``torch.Generator``) is read only when ``dropout_rate > 0``.

    Where JAX donates the parameter buffers, this step updates the
    parameters IN PLACE under ``torch.no_grad()`` and returns the same
    dict (the optimizer state is a new object). ``accum_steps > 1``
    splits the batch into that many microbatches, sums their gradients
    and divides once, as the JAX scan does. The mesh, ``fsdp``,
    ``zero_optimizer`` and ``packed`` variants are not ported and
    raise."""
    if mesh is not None or seq_axis is not None:
        raise NotImplementedError("mesh parallelism is not ported yet")
    if fsdp or zero_optimizer:
        raise NotImplementedError("fsdp and zero_optimizer shard over a "
                                  "mesh; not ported yet")
    if packed:
        raise NotImplementedError("packed segment_ids are not ported yet")
    accum_steps = max(1, int(accum_steps))
    use_dropout = config.dropout_rate > 0

    def step(params, opt_state, tokens, dropout_key=None):
        device = params["embed"]["tokens"].device
        tokens = torch.as_tensor(tokens, device=device)
        key = dropout_key if use_dropout else None
        if accum_steps > 1:
            if tokens.shape[0] % accum_steps:
                raise ValueError(
                    f"batch {tokens.shape[0]} does not split into "
                    f"{accum_steps} microbatches")
            loss, grads = 0.0, None
            for micro in tokens.reshape(accum_steps, -1,
                                        *tokens.shape[1:]):
                mloss, mgrads = lm_loss_and_grads(params, micro, config,
                                                  key)
                grads = (mgrads if grads is None
                         else [a + b for a, b in zip(grads, mgrads)])
                loss = loss + mloss
            grads = [gr / accum_steps for gr in grads]
            loss = loss / accum_steps
        else:
            loss, grads = lm_loss_and_grads(params, tokens, config, key)
        leaves = tree_flatten(params)[0]
        updates, opt_state = tx.update(grads, opt_state, leaves)
        with torch.no_grad():
            for p, u in zip(leaves, updates):
                p.add_(u)
        return params, opt_state, loss

    return step


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
