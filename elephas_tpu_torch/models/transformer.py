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
ALiBi, the dense MLP (gelu or SwiGLU), the mixture-of-experts layer on
one device (the f32 router, dense and capacity-routed dispatch, the
shared expert, the Switch aux loss), residual dropout, single-device
``forward``/``forward_with_aux`` with the flash kernels (differentiable)
or the plain attention path, packed rows (``segment_ids``: the segment
mask on the plain path and the boundary-masked loss),
rematerialization (``remat_policy`` full or dots) through
``torch.utils.checkpoint``, the LM losses (``next_token_loss``, the
chunked-vocab loss, z-loss, label smoothing, the MoE aux term) in
``lm_loss``, the single-device ``make_train_step`` (``packed`` too), and
the cached decode family with the optional int8 KV cache:
``prefill_cache`` (whole and chunked), ``decode_block``,
``decode_step``, ``generate`` and ``beam_search``. Weight-only int8
parameters (:mod:`.quantization`) run through every inference entry
point. Not ported yet (they raise ``NotImplementedError``): every mesh
argument, and with it expert parallelism.

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
from .quantization import quantize_weight

__all__ = ["TransformerConfig", "init_params", "forward", "forward_with_aux",
           "lm_loss", "lm_loss_and_grads", "value_and_grads",
           "apply_updates", "next_token_loss",
           "chunked_next_token_losses", "make_train_step", "prefill_cache",
           "init_kv_cache", "decode_block", "decode_step",
           "prefill_cache_chunked", "chunked_blocks", "generate",
           "beam_search",
           "embed_apply", "head_logits", "resolve_attention_impl",
           "segment_target_weights", "select_moe_dispatch",
           "NEG_INF", "FLAGSHIP", "TRANSFORMER_TPUMODEL", "PHI3_MINI",
           "OLMOE_1B_7B", "GEMMA_2B"]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The JAX package's config, field for field (see its docstrings).
    ``dtype``/``param_dtype`` are torch dtypes."""
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
        if self.num_experts > 1 and not (
                1 <= self.expert_top_k <= self.num_experts):
            raise ValueError("expert_top_k must be in [1, num_experts]")
        if self.moe_dispatch not in ("auto", "dense", "routed"):
            raise ValueError("moe_dispatch must be 'auto', 'dense' or "
                             f"'routed', got {self.moe_dispatch!r}")
        if self.moe_capacity_factor <= 0:
            raise ValueError("moe_capacity_factor must be positive")
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
#: ``microsoft/Phi-3-mini-4k-instruct``'s ``config.json``: vocab 32064,
#: 32 layers, 32 heads over 32 kv heads (MHA), hidden 3072 (head dim 96),
#: intermediate 8192 (SwiGLU), RMSNorm at eps 1e-5 (the repo's), RoPE
#: theta 10000, sliding window 2047, untied head; ``max_seq_len`` 2048 of
#: its 4096: ``TransformerConfig(**PHI3_MINI)``
PHI3_MINI = dict(vocab_size=32064, num_layers=32, num_heads=32,
                 num_kv_heads=32, d_model=3072, d_ff=8192, max_seq_len=2048,
                 positional="rope", rope_theta=10000.0,
                 attention_window=2047, mlp_variant="swiglu",
                 norm="rmsnorm", tied_embedding=False)
#: ``allenai/OLMoE-1B-7B-0924``'s ``config.json`` as far as the repo's
#: MoE layer expresses it: vocab 50304, 16 layers, 16 heads over 16 kv
#: heads (head dim 128), hidden 2048, 64 experts with top-8 routing and
#: an expert width of 1024, RMSNorm, RoPE theta 10000, untied head,
#: 4096 positions, router aux weight 0.01. Four departures: the repo's
#: experts are GELU with biases (two matrices, OLMoE's are SwiGLU), the
#: top-k gates are renormalized (OLMoE ``norm_topk_prob: false``), no
#: QK-norm, and routing by capacity with drops (OLMoE is dropless):
#: ``TransformerConfig(**OLMOE_1B_7B)``
OLMOE_1B_7B = dict(vocab_size=50304, num_layers=16, num_heads=16,
                   num_kv_heads=16, d_model=2048, d_ff=1024,
                   max_seq_len=4096, num_experts=64, expert_top_k=8,
                   moe_aux_weight=0.01, positional="rope",
                   rope_theta=10000.0, norm="rmsnorm",
                   tied_embedding=False)
#: ``google/gemma-2b``'s ``config.json``: vocab 256000, 18 layers, 8
#: heads over 1 kv head (multi-query), hidden 2048 (head dim 256),
#: intermediate 16384 (gated), RMSNorm, RoPE theta 10000, tied
#: embeddings; 2.51 B parameters (the tied embedding's 0.524 B plus 18 x
#: 110.1 M). The departures the repo's config forces: SwiGLU in place
#: of GeGLU (the same three matrices, SiLU in place of tanh-GELU, and
#: the repo's two MLP bias vectors, zero at initialization, 18 K
#: parameters a layer); no sqrt(d_model) scaling of the embedding; the
#: repo's RMSNorm (eps 1e-5 where Gemma has 1e-6, and ``x * g`` where
#: Gemma has ``x * (1 + g)``, the same function under another
#: parametrization); ``max_seq_len`` 2048 of its 8192:
#: ``TransformerConfig(**GEMMA_2B)``
GEMMA_2B = dict(vocab_size=256000, num_layers=18, num_heads=8,
                num_kv_heads=1, d_model=2048, d_ff=16384, max_seq_len=2048,
                positional="rope", rope_theta=10000.0, norm="rmsnorm",
                mlp_variant="swiglu", tied_embedding=True)


def init_params(config: TransformerConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Dict:
    """The parameter dict, drawn from ``generator`` (on the generator's
    device) and placed on ``device``. Same nesting, shapes and scales as
    the JAX ``init_params``; the draws differ (another generator)."""
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
        }
        if c.num_experts > 1:
            e = c.num_experts
            layer["moe"] = {
                "gate": dense((c.d_model, e), c.d_model),
                "w1": dense((e, c.d_model, c.d_ff), c.d_model),
                "b1": zeros((e, c.d_ff)),
                "w2": dense((e, c.d_ff, c.d_model), c.d_ff),
                "b2": zeros((e, c.d_model)),
            }
            if c.moe_shared_expert:
                layer["moe"]["shared"] = {
                    "w1": dense((c.d_model, c.d_ff), c.d_model),
                    "b1": zeros(c.d_ff),
                    "w2": dense((c.d_ff, c.d_model), c.d_ff),
                    "b2": zeros(c.d_model),
                }
        else:
            layer["mlp"] = {
                "w1": dense((c.d_model, c.d_ff), c.d_model),
                "b1": zeros(c.d_ff),
                "w2": dense((c.d_ff, c.d_model), c.d_ff),
                "b2": zeros(c.d_model),
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


def select_moe_dispatch(config: TransformerConfig) -> str:
    """``config.moe_dispatch`` resolved to ``'dense'`` or ``'routed'``:
    ``auto`` routes (FLOPs proportional to ``top_k``) above 4 experts,
    the JAX package's rule without a mesh."""
    if config.moe_dispatch != "auto":
        return config.moe_dispatch
    return "dense" if config.num_experts <= 4 else "routed"


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lower index (a stable descending sort; ``torch.topk`` promises no
    order among equal values)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_gates(h: torch.Tensor, moe: Dict, c: TransformerConfig):
    """The router in f32: softmax probabilities, exact top-k, and the
    Switch load-balancing aux loss ``E * sum_e f_e * P_e`` (f_e the
    share of tokens whose top choice is e, P_e e's mean probability).
    k = 1 scales by the raw probability (Switch); k > 1 renormalizes the
    selected probabilities (Mixtral). Returns ``(probs, gate_vals,
    topi, aux)``, ``gate_vals``/``topi`` of shape ``(..., top_k)``."""
    logits = h.to(torch.float32) @ moe["gate"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, topi = _top_k(probs, c.expert_top_k)
    if c.expert_top_k > 1:
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    lead = tuple(range(probs.ndim - 1))
    top1 = F.one_hot(torch.argmax(probs, dim=-1), c.num_experts).to(
        torch.float32)
    aux = c.num_experts * (top1.mean(dim=lead) * probs.mean(dim=lead)).sum()
    return probs, gate_vals, topi, aux


def _moe_block(h: torch.Tensor, moe: Dict, c: TransformerConfig,
               dispatch: Optional[str] = None):
    """Gated mixture-of-experts MLP over ``(B, T, D)``: ``(out, aux)``.
    Dense dispatch runs every expert on every token and lets the top-k
    gates zero the rest; routed dispatch (:func:`_moe_block_routed`)
    scatters tokens into per-expert capacity buffers."""
    if dispatch is None:
        dispatch = select_moe_dispatch(c)
    if dispatch == "routed":
        return _moe_block_routed(h, moe, c)
    _, gate_vals, topi, aux = _moe_gates(h, moe, c)
    # the top-k gate values back on the expert axis
    gates = torch.zeros(gate_vals.shape[:-1] + (c.num_experts,),
                        dtype=gate_vals.dtype, device=gate_vals.device)
    gates = gates.scatter(-1, topi, gate_vals).to(c.dtype)
    he = F.gelu(einsum("btd,edf->betf", h, moe["w1"].to(c.dtype))
                + moe["b1"].to(c.dtype)[None, :, None, :],
                approximate="tanh")
    out = (einsum("betf,efd->betd", he, moe["w2"].to(c.dtype))
           + moe["b2"].to(c.dtype)[None, :, None, :])
    return einsum("betd,bte->btd", out, gates), aux


def _shared_expert(h: torch.Tensor, shared: Dict,
                   c: TransformerConfig) -> torch.Tensor:
    """The always-on dense MLP added to the MoE combine (gelu, as the
    experts)."""
    g = F.gelu(h @ shared["w1"].to(c.dtype) + shared["b1"].to(c.dtype),
               approximate="tanh")
    return g @ shared["w2"].to(c.dtype) + shared["b2"].to(c.dtype)


def _routed_capacity(config: TransformerConfig, n_tokens: int) -> int:
    """Slots per expert buffer: ``ceil(cf * k * n_tokens / E)``, at least
    1, at most ``n_tokens``; it depends on the call's token count."""
    cap = int(math.ceil(config.moe_capacity_factor * config.expert_top_k
                        * n_tokens / config.num_experts))
    return min(max(cap, 1), n_tokens)


def _routed_dispatch(hf: torch.Tensor, gate_vals: torch.Tensor,
                     topi: torch.Tensor, w1, b1, w2, b2,
                     c: TransformerConfig, capacity: int) -> torch.Tensor:
    """Scatter -> expert MLP -> gather over all experts (the JAX
    function at ``expert_offset=0``). Assignments are flattened
    token-major, so earlier tokens (and, within a token, higher-ranked
    choices) win the capacity race; an assignment past its expert's
    capacity is dropped: it lands in a spare buffer row that no expert
    output reads back, and its gate is zeroed.

    The JAX function ranks assignments by a cumsum over their one-hot
    experts; here a stable sort by expert gives the same ranks, and the
    scatter and gather go through flat ``index_copy``/``index_select``
    (each a plain copy, with a plain copy or an ``index_add_`` as its
    gradient), where a cumsum down ``(N*k, E)`` and an accumulating
    ``index_put`` cost most of a routed layer on the card."""
    n, d = hf.shape
    k = c.expert_top_k
    e = w1.shape[0]
    experts = topi.reshape(n * k)
    # each assignment's place in its expert's buffer: the assignments to
    # that expert before it (a stable sort keeps them in token order)
    order = torch.argsort(experts, stable=True)
    counts = torch.bincount(experts, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    rank = (torch.arange(n * k, device=hf.device)
            - starts[experts[order]])
    pos = torch.empty_like(rank).scatter_(0, order, rank)
    keep = pos < capacity
    # slot (expert, position) of each assignment in a (E, capacity + 1)
    # buffer whose last row per expert takes the drops
    slot = experts * (capacity + 1) + torch.where(keep, pos, capacity)
    xs = hf.to(c.dtype)[:, None, :].expand(n, k, d).reshape(n * k, d)
    buf = torch.zeros((e * (capacity + 1), d), dtype=c.dtype,
                      device=hf.device).index_copy(0, slot, xs)
    buf = buf.reshape(e, capacity + 1, d)[:, :capacity]
    he = F.gelu(einsum("ecd,edf->ecf", buf, w1.to(c.dtype))
                + b1.to(c.dtype)[:, None, :], approximate="tanh")
    out_buf = (einsum("ecf,efd->ecd", he, w2.to(c.dtype))
               + b2.to(c.dtype)[:, None, :])
    # the spare rows read back as zeros
    out_buf = F.pad(out_buf, (0, 0, 0, 1)).reshape(e * (capacity + 1), d)
    gate_flat = (gate_vals.reshape(n * k)
                 * keep.to(gate_vals.dtype)).to(c.dtype)
    picked = out_buf.index_select(0, slot)
    return (picked * gate_flat[:, None]).reshape(n, k, d).sum(dim=1)


def _moe_block_routed(h: torch.Tensor, moe: Dict, c: TransformerConfig):
    """Capacity-factor routed dispatch (Switch Transformer section 2.2):
    per-token expert FLOPs scale with ``top_k``, not ``num_experts``."""
    b, t, d = h.shape
    hf = h.reshape(b * t, d)
    _, gate_vals, topi, aux = _moe_gates(hf, moe, c)
    out = _routed_dispatch(hf, gate_vals, topi, moe["w1"], moe["b1"],
                           moe["w2"], moe["b2"], c,
                           _routed_capacity(c, b * t))
    return out.reshape(b, t, d), aux


def _moe_apply(layer: Dict, x: torch.Tensor, c: TransformerConfig,
               dispatch: str, dropout_gen: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-LN MoE sublayer with residual (plus the shared expert):
    ``(x, aux)``."""
    h = _norm(x, layer["ln2"], c).to(c.dtype)
    out, aux = _moe_block(h, layer["moe"], c, dispatch=dispatch)
    if c.moe_shared_expert:
        out = out + _shared_expert(h, layer["moe"]["shared"], c)
    return x + _dropout(out, c.dropout_rate, dropout_gen), aux


def _ffn_cached(layer: Dict, x: torch.Tensor,
                c: TransformerConfig) -> torch.Tensor:
    """The feed-forward sublayer of the cached decode family: the dense
    MLP, or the MoE layer under DENSE dispatch whatever the config's
    setting (decode-time gating, as in the JAX package)."""
    if c.num_experts > 1:
        return _moe_apply(layer, x, c, "dense")[0]
    return _mlp_apply(layer, x, c)


def resolve_attention_impl(config: TransformerConfig,
                           device: torch.device) -> str:
    """``"flash"`` or ``"xla"`` (the plain path) for single-device
    attention: ``auto`` picks flash on a CUDA device. ALiBi always takes
    the plain path, whose bias it needs (the JAX routing rule). A head
    dim the kernels do not take raises at the kernel's operand check
    (``kernel_takes_head_dim``), never falls back."""
    if config.positional == "alibi":
        return "xla"
    if config.attention_impl == "auto":
        return "flash" if device.type == "cuda" else "xla"
    return config.attention_impl


def _check_single_device(mesh, seq_axis, batch_axis, model_axis) -> None:
    if any(a is not None for a in (mesh, seq_axis, batch_axis,
                                   model_axis)):
        raise NotImplementedError("mesh parallelism is not ported yet")


def _attention_fn(c: TransformerConfig, device: torch.device, t: int,
                  segment_ids: Optional[torch.Tensor] = None):
    """The single-device attention of a length-``t`` causal stack: the
    flash kernels (differentiable; GQA mapped in the kernel) or the
    plain path, with the window, ALiBi and segment masks it needs.
    Packed rows (``segment_ids``, ``(B, T)``, ids > 0, 0 = padding)
    always take the plain path: a query attends to the keys of its own
    non-pad segment, and a pad query, every key masked, gets the finite
    ``NEG_INF`` fill's uniform softmax, as in the JAX package."""
    if (segment_ids is None
            and resolve_attention_impl(c, device) == "flash"):
        attn_fn = partial(flash_attention, causal=True,
                          window=c.attention_window)
        # the kernels map GQA heads themselves: k/v stay narrow
        attn_fn.handles_gqa = True
        return attn_fn
    if (c.attention_window is None and c.positional != "alibi"
            and segment_ids is None):
        return partial(attention, causal=True)
    q_pos = torch.arange(t, device=device)[:, None]
    k_pos = torch.arange(t, device=device)[None, :]
    mask = (k_pos <= q_pos)[None, None]
    if c.attention_window is not None:
        mask = mask & (k_pos > q_pos - c.attention_window)[None, None]
    if segment_ids is not None:
        same = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        mask = mask & same & (segment_ids > 0)[:, None, None, :]
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
    of ``params``: final hidden states ``(B, T, D)`` and the summed MoE
    aux loss (0 for dense layers). ``dropout_key`` (a
    ``torch.Generator``) enables residual dropout; ``segment_ids``
    (packed rows) isolate documents on the plain attention path."""
    _check_single_device(mesh, seq_axis, batch_axis, model_axis)
    if dropout_key is not None and not isinstance(dropout_key,
                                                  torch.Generator):
        raise TypeError(f"dropout_key must be a torch.Generator, got "
                        f"{type(dropout_key).__name__}")
    c = config
    device = params["embed"]["tokens"].device
    tokens = torch.as_tensor(tokens, device=device).long()
    if segment_ids is not None:
        segment_ids = torch.as_tensor(segment_ids, device=device)
    x = embed_apply(params["embed"], tokens, c)
    attn_fn = _attention_fn(c, device, tokens.shape[1], segment_ids)
    dispatch = select_moe_dispatch(c) if c.num_experts > 1 else None
    zero = torch.zeros((), dtype=torch.float32, device=device)

    def layer_apply(layer, x, seed):
        gen = None
        if seed is not None:
            gen = torch.Generator(device=x.device)
            gen.manual_seed(seed)
        x = _attn_apply(layer, x, c, attn_fn, gen)
        if dispatch is not None:
            return _moe_apply(layer, x, c, dispatch, gen)
        return _mlp_apply(layer, x, c, gen), zero

    if c.remat:
        # recompute each block's activations in the backward pass instead
        # of keeping them live; the seed is an argument, so a recompute
        # rebuilds the same generator and draws the same masks
        layer_apply = partial(checkpoint, layer_apply, use_reentrant=False,
                              context_fn=_remat_context(c.remat_policy))
    seeds = _layer_seeds(dropout_key, c.dropout_rate, c.num_layers)
    aux_total = zero
    for i in range(c.num_layers):
        x, aux = layer_apply(params[f"layer_{i}"], x, seeds[i])
        aux_total = aux_total + aux
    return x, aux_total


def forward_with_aux(params: Dict, tokens: torch.Tensor,
                     config: TransformerConfig, mesh=None, seq_axis=None,
                     batch_axis=None, model_axis=None, dropout_key=None,
                     segment_ids=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Like :func:`forward` but also returns the summed MoE auxiliary
    (load-balancing) loss, 0.0 for dense configs."""
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
    ``torch.Generator``) activates residual dropout (training);
    ``segment_ids`` (packed rows, ids > 0, 0 = padding) keep attention
    within each segment. The mesh arguments of the JAX signature are
    not ported and raise when given."""
    logits, _ = forward_with_aux(params, tokens, config, mesh, seq_axis,
                                 batch_axis, model_axis, dropout_key,
                                 segment_ids)
    return logits


def _weighted_mean(x: torch.Tensor,
                   weights: Optional[torch.Tensor]) -> torch.Tensor:
    """The mean of ``x``, or its ``weights``-weighted mean (a zero total
    weight divides by 1)."""
    if weights is None:
        return x.mean()
    w = weights.to(x.dtype)
    return (x * w).sum() / torch.clamp(w.sum(), min=1.0)


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor,
                    label_smoothing: float = 0.0,
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token cross-entropy, mean over all positions (or a
    ``weights``-weighted mean: packed training zeroes cross-document and
    padding targets); with label smoothing, eps probability mass spreads
    uniformly over the vocab."""
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    ce_pos = -logp.gather(-1, targets[..., None])[..., 0]
    if label_smoothing:
        eps = label_smoothing
        ce_pos = (1.0 - eps) * ce_pos - eps * logp.mean(dim=-1)
    return _weighted_mean(ce_pos, weights)


def segment_target_weights(segment_ids: torch.Tensor) -> torch.Tensor:
    """Per-target weights of packed rows, ``(B, T) -> (B, T-1)`` f32:
    target t+1 counts only when positions t and t+1 belong to the same
    non-pad (id > 0) segment."""
    a, b = segment_ids[:, :-1], segment_ids[:, 1:]
    return ((a == b) & (b > 0)).to(torch.float32)


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
                              norm: str = "layernorm",
                              weights: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Streamed LM loss pieces from the final hidden states:
    ``(cross_entropy, lse, mean_logits)`` without materializing ``(B, T,
    V)`` logits. The vocab axis goes in ``chunk``-wide slices, each under
    ``torch.utils.checkpoint`` (the rematerialized scan body of the JAX
    package), so a chunk's logits live only transiently in both passes.
    The last slice is the remainder: no padded vocab row enters the
    logsumexp. ``weights`` make the cross-entropy a weighted mean."""
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
    return _weighted_mean(lse - picked, weights), lse, tot / v


def lm_loss(params: Dict, tokens: torch.Tensor, config: TransformerConfig,
            mesh=None, seq_axis=None, batch_axis=None, model_axis=None,
            dropout_key=None, segment_ids=None) -> torch.Tensor:
    """Next-token cross-entropy (mean over all positions, or over the
    targets ``segment_ids`` keep), with the config's label smoothing,
    z-loss and weighted MoE aux loss; the chunked-vocab loss when
    ``loss_vocab_chunk`` is set. Single device only."""
    c = config
    device = params["embed"]["tokens"].device
    tokens = torch.as_tensor(tokens, device=device).long()
    weights = None
    if segment_ids is not None:
        segment_ids = torch.as_tensor(segment_ids, device=device)
        weights = segment_target_weights(segment_ids)
    args = (mesh, seq_axis, batch_axis, model_axis, dropout_key,
            segment_ids)
    use_aux = c.num_experts > 1 and c.moe_aux_weight
    if c.loss_vocab_chunk:
        x, aux = _hidden_with_aux(params, tokens, c, *args)
        loss, lse, mean_logits = chunked_next_token_losses(
            x, params["embed"], params["final_ln"], tokens,
            int(c.loss_vocab_chunk), head=params.get("head"), norm=c.norm,
            weights=weights)
        if c.label_smoothing:
            # mean_v logp_v = mean_v logits_v - lse
            eps = c.label_smoothing
            loss = ((1.0 - eps) * loss
                    + eps * _weighted_mean(lse - mean_logits, weights))
        if use_aux:
            loss = loss + c.moe_aux_weight * aux
        if c.z_loss_weight:
            loss = loss + c.z_loss_weight * _weighted_mean(lse * lse,
                                                           weights)
        return loss
    logits, aux = forward_with_aux(params, tokens, c, *args)
    loss = next_token_loss(logits, tokens, label_smoothing=c.label_smoothing,
                           weights=weights)
    if use_aux:
        loss = loss + c.moe_aux_weight * aux
    if c.z_loss_weight:
        # PaLM-style z-loss: penalize the log-partition so logits don't
        # drift large; only predicting positions count
        z = torch.logsumexp(logits[:, :-1], dim=-1)
        loss = loss + c.z_loss_weight * _weighted_mean(z * z, weights)
    return loss


def value_and_grads(loss_fn, params: Dict
                    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """``loss_fn(params)`` and its gradient with respect to every leaf
    of ``params``, through autograd (JAX's ``value_and_grad``): ``(loss,
    grads)`` with the loss detached and ``grads`` in the leaf order of
    :func:`~elephas_tpu_torch.weights.tree_flatten`. A leaf the loss
    never reads (rmsnorm's beta) gets a zero gradient. The parameters
    themselves need not require gradients."""
    leaves, treedef = tree_flatten(params)
    # views of the same storage that autograd may differentiate
    live = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(treedef, live))
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if gr is None else gr
             for p, gr in zip(leaves, grads)]
    return loss.detach(), grads


def lm_loss_and_grads(params: Dict, tokens: torch.Tensor,
                      config: TransformerConfig, dropout_key=None,
                      segment_ids=None
                      ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """``lm_loss`` and its gradient (:func:`value_and_grads`), the JAX
    step's ``value_and_grad``."""
    return value_and_grads(
        lambda p: lm_loss(p, tokens, config, dropout_key=dropout_key,
                          segment_ids=segment_ids),
        params)


def apply_updates(tx, grads: List[torch.Tensor], opt_state,
                  params: Dict):
    """One step of ``tx`` (a transform of :mod:`~elephas_tpu_torch.
    models.optimizers`) on ``grads`` in :func:`~elephas_tpu_torch.
    weights.tree_flatten` order: ``params`` is updated IN PLACE (where
    JAX's ``optax.apply_updates`` makes new buffers); returns the new
    optimizer state."""
    leaves = tree_flatten(params)[0]
    updates, opt_state = tx.update(grads, opt_state, leaves)
    with torch.no_grad():
        for p, u in zip(leaves, updates):
            p.add_(u)
    return opt_state


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
    ``packed=True`` adds a trailing ``segment_ids`` argument (packed-row
    training: segment-isolated attention and the boundary-masked loss),
    the JAX positional signature ``(params, opt_state, tokens[,
    dropout_key], segment_ids)``.

    Where JAX donates the parameter buffers, this step updates the
    parameters IN PLACE under ``torch.no_grad()`` and returns the same
    dict (the optimizer state is a new object). ``accum_steps > 1``
    splits the batch (and the segments) into that many microbatches,
    sums their gradients and divides once, as the JAX scan does; the
    packed loss is then the mean of per-microbatch weighted means. The
    mesh, ``fsdp`` and ``zero_optimizer`` variants are not ported and
    raise."""
    if mesh is not None or seq_axis is not None:
        raise NotImplementedError("mesh parallelism is not ported yet")
    if fsdp or zero_optimizer:
        raise NotImplementedError("fsdp and zero_optimizer shard over a "
                                  "mesh; not ported yet")
    accum_steps = max(1, int(accum_steps))
    use_dropout = config.dropout_rate > 0
    packed = bool(packed)

    def step(params, opt_state, tokens, *extra):
        if len(extra) > 1 + packed or len(extra) < packed:
            raise TypeError(
                "the step takes (params, opt_state, tokens[, dropout_key]"
                + ("], segment_ids)" if packed else "])")
                + f"; got {3 + len(extra)} arguments")
        segment_ids = extra[-1] if packed else None
        dropout_key = extra[0] if len(extra) > packed else None
        device = params["embed"]["tokens"].device
        tokens = torch.as_tensor(tokens, device=device)
        if segment_ids is not None:
            segment_ids = torch.as_tensor(segment_ids, device=device)
        key = dropout_key if use_dropout else None
        if accum_steps > 1:
            if tokens.shape[0] % accum_steps:
                raise ValueError(
                    f"batch {tokens.shape[0]} does not split into "
                    f"{accum_steps} microbatches")
            micro = tokens.reshape(accum_steps, -1, *tokens.shape[1:])
            segs = (segment_ids.reshape(micro.shape)
                    if segment_ids is not None else [None] * accum_steps)
            loss, grads = 0.0, None
            for tk, sg in zip(micro, segs):
                mloss, mgrads = lm_loss_and_grads(params, tk, config, key,
                                                  sg)
                grads = (mgrads if grads is None
                         else [a + b for a, b in zip(grads, mgrads)])
                loss = loss + mloss
            grads = [gr / accum_steps for gr in grads]
            loss = loss / accum_steps
        else:
            loss, grads = lm_loss_and_grads(params, tokens, config, key,
                                            segment_ids)
        return params, apply_updates(tx, grads, opt_state, params), loss

    return step


def init_kv_cache(config: TransformerConfig, batch: int,
                  max_len: Optional[int] = None,
                  device: DeviceLike = None) -> Dict:
    """Per-layer ``(batch, kv_heads, max_len, head_dim)`` zero k/v in the
    compute dtype; with ``config.kv_cache_quant``, int8 ``k``/``v`` and
    f32 per-(position, head) absmax scales ``k_scale``/``v_scale`` of
    shape ``(batch, kv_heads, max_len, 1)``."""
    c = config
    device = resolve_device(device)
    shape = (batch, c.kv_heads, max_len or c.max_seq_len, c.head_dim)
    if c.kv_cache_quant:
        sshape = shape[:-1] + (1,)

        def layer():
            return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                    "k_scale": torch.zeros(sshape, dtype=torch.float32,
                                           device=device),
                    "v": torch.zeros(shape, dtype=torch.int8, device=device),
                    "v_scale": torch.zeros(sshape, dtype=torch.float32,
                                           device=device)}
    else:
        def layer():
            return {"k": torch.zeros(shape, dtype=c.dtype, device=device),
                    "v": torch.zeros(shape, dtype=c.dtype, device=device)}
    return {f"layer_{i}": layer() for i in range(c.num_layers)}


def _kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(..., head_dim)`` k or v -> int8 data and a ``(..., 1)`` f32
    absmax scale (the one int8 recipe, :func:`.quantization.
    quantize_weight`)."""
    q = quantize_weight(x, (-1,))
    return q.data, q.scale


def _dequantize_kv(q8: torch.Tensor, scale: torch.Tensor,
                   dtype) -> torch.Tensor:
    return (q8.to(torch.float32) * scale).to(dtype)


def _write_kv(lc: Dict, k: torch.Tensor, v: torch.Tensor, index,
              c: TransformerConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write new k/v ``(B, KVH, S, hd)`` into the layer cache ``lc`` at
    ``index`` (a slice tuple or an advanced index) in place, quantized
    under ``kv_cache_quant``; returns the k/v as attention reads them
    back: the written values, dequantized from int8 under the int8
    cache."""
    if not c.kv_cache_quant:
        for part, val in (("k", k), ("v", v)):
            lc[part][index] = val.to(lc[part].dtype)
        return k, v
    out = []
    for part, val in (("k", k), ("v", v)):
        q8, scale = _kv_quantize(val)
        lc[part][index] = q8
        lc[part + "_scale"][index] = scale
        out.append(_dequantize_kv(q8, scale, c.dtype))
    return tuple(out)


def _cache_kv(lc: Dict, c: TransformerConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A layer cache's whole k/v in the compute dtype (dequantized under
    the int8 cache)."""
    if c.kv_cache_quant:
        return (_dequantize_kv(lc["k"], lc["k_scale"], c.dtype),
                _dequantize_kv(lc["v"], lc["v_scale"], c.dtype))
    return lc["k"], lc["v"]


def prefill_cache(params: Dict, tokens: torch.Tensor,
                  config: TransformerConfig,
                  max_len: int) -> Tuple[torch.Tensor, Dict]:
    """Batched prompt prefill: one forward pass over ``(batch, T)``
    prompt tokens that writes every position's k/v into a fresh decode
    cache and returns the last position's logits ``(batch, vocab)``.
    Attention here is the plain grouped einsum softmax, as in the JAX
    package (the flash kernel is not on this path). Under the int8 cache
    it attends over the dequantized prompt k/v, so decode continues
    from the cache exactly as the step-by-step path would; MoE layers
    gate densely."""
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
        k, v = _write_kv(cache[f"layer_{i}"], k, v,
                         (slice(None), slice(None), slice(0, t)), c)
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
        x = _ffn_cached(layer, x, c)
    logits = head_logits(params["embed"], params["final_ln"], x[:, -1],
                         head=params.get("head"), norm=c.norm)
    return logits, cache


def decode_block(params: Dict, cache: Dict, tokens: torch.Tensor, pos0,
                 config: TransformerConfig) -> Tuple[torch.Tensor, Dict]:
    """Multi-token cached decode: ``(batch, S)`` tokens at positions
    ``pos0 .. pos0+S-1`` of an ongoing sequence read and write the k/v
    cache; returns (f32 logits ``(batch, S, vocab)``, the cache).
    ``pos0`` is a scalar or a ``(batch,)`` vector of per-row offsets.
    Each block slot ``j`` attends causally to cache positions ``<=
    pos0+j``; all S slots' k/v are written before attention.

    The JAX function returns an updated copy; here the S positions are
    written into ``cache`` IN PLACE and the same dict is returned. A
    position at or past the cache length is out of range and raises
    (the JAX scatter drops it). Under the int8 cache the new k/v are
    written as int8 and attention reads the whole cache dequantized;
    MoE layers gate densely."""
    c = config
    device = params["embed"]["tokens"].device
    tokens = torch.as_tensor(tokens, device=device).long()
    b, s = tokens.shape
    vec = getattr(pos0, "ndim", 0) == 1
    length = next(iter(cache.values()))["k"].shape[2]
    steps = torch.arange(s, device=device)
    if vec:
        pos0 = torch.as_tensor(pos0, device=device).long()
        blockpos = pos0[:, None] + steps[None, :]      # (B, S)
    else:
        start = int(pos0)
        if start + s > length:
            raise IndexError(f"positions {start}..{start + s - 1} exceed "
                             f"the cache length {length}")
        blockpos = start + steps                       # (S,)
    x = params["embed"]["tokens"][tokens]
    if c.positional == "learned":
        x = x + params["embed"]["pos"][blockpos]
    elif c.positional == "sinusoidal":
        x = x + _sinusoidal_table(blockpos, c.d_model)
    x = x.to(c.dtype)                                  # (B, S, D)
    kpos = torch.arange(length, device=device)
    qp = blockpos if vec else blockpos[None, :]        # (B|1, S)
    mask = kpos[None, None, :] <= qp[:, :, None]       # (B|1, S, L)
    if c.attention_window is not None:
        mask = mask & (kpos[None, None, :]
                       > qp[:, :, None] - c.attention_window)
    scale = 1.0 / math.sqrt(c.head_dim)
    rp = blockpos[:, None, :] if vec else blockpos     # rope positions
    if vec:
        widx = (torch.arange(b, device=device)[:, None, None],
                torch.arange(c.kv_heads, device=device)[None, :, None],
                blockpos[:, None, :])                  # -> (B, H, S)
    groups = c.num_heads // c.kv_heads
    slopes = (_alibi_slopes(c.num_heads, device)
              if c.positional == "alibi" else None)
    for i in range(c.num_layers):
        layer = params[f"layer_{i}"]
        h = _norm(x, layer["ln1"], c).to(c.dtype)
        q, k_new, v_new = _qkv(layer, h, c)            # (B, heads, S, hd)
        if c.positional == "rope":
            q = _apply_rope(q, rp, c)
            k_new = _apply_rope(k_new, rp, c)
        lc = cache[f"layer_{i}"]
        _write_kv(lc, k_new, v_new,
                  widx if vec else (slice(None), slice(None),
                                    slice(start, start + s)), c)
        ck, cv = _cache_kv(lc, c)
        qg = q.reshape(b, c.kv_heads, groups, s, c.head_dim)
        scores = einsum("bngsk,bntk->bngst", qg, ck) * scale
        if slopes is not None:
            dist = (qp[:, :, None] - kpos[None, None, :]).to(
                torch.float32)                         # (B|1, S, L)
            ab = (-slopes[None, :, None, None] * dist[:, None]).reshape(
                dist.shape[0], c.kv_heads, groups, s, length)
            scores = scores + ab
        scores = torch.where(mask[:, None, None], scores, NEG_INF)
        weights = torch.softmax(scores, dim=-1)
        o = einsum("bngst,bntk->bngsk", weights, cv)
        o = o.reshape(b, c.num_heads, s, c.head_dim)
        x = x + einsum("bhsk,hkd->bsd", o, layer["attn"]["wo"].to(c.dtype))
        x = _ffn_cached(layer, x, c)
    logits = head_logits(params["embed"], params["final_ln"], x,
                         head=params.get("head"), norm=c.norm)
    return logits, cache


def chunked_blocks(block_fn, cache, tokens, pos0: int, chunk: int):
    """Thread ``(logits, cache)`` through ``block_fn`` over
    ``chunk``-sized column slices of ``tokens`` ``(B, T)`` starting at
    position ``pos0``. ``block_fn(cache, block, start_pos, is_first) ->
    (logits, cache)``; returns the LAST block's logits and the final
    cache. :func:`prefill_cache_chunked` and the serving engine's
    chunked admission both ride it."""
    logits = None
    for start in range(0, tokens.shape[1], chunk):
        logits, cache = block_fn(cache, tokens[:, start:start + chunk],
                                 pos0 + start, start == 0)
    return logits, cache


def prefill_cache_chunked(params: Dict, tokens: torch.Tensor,
                          config: TransformerConfig, max_len: int,
                          chunk: int = 512) -> Tuple[torch.Tensor, Dict]:
    """Chunked prompt prefill: :func:`prefill_cache` in ``chunk``-sized
    :func:`decode_block` passes (peak attention memory O(chunk * T)
    instead of O(T^2)). Returns the last position's logits and the
    filled cache; the tail block is its natural size."""
    device = params["embed"]["tokens"].device
    tokens = torch.as_tensor(tokens, device=device).long()
    logits, cache = chunked_blocks(
        lambda cache, blk, pos, _first: decode_block(params, cache, blk,
                                                     pos, config),
        init_kv_cache(config, tokens.shape[0], max_len, device), tokens, 0,
        chunk)
    return logits[:, -1], cache


def decode_step(params: Dict, cache: Dict, tokens: torch.Tensor, pos,
                config: TransformerConfig) -> Tuple[torch.Tensor, Dict]:
    """One autoregressive step: token ids ``(batch,)`` at position
    ``pos`` (a scalar, or ``(batch,)`` per-row positions) -> (f32
    next-token logits ``(batch, vocab)``, the cache, written in place):
    the S = 1 case of :func:`decode_block`."""
    device = params["embed"]["tokens"].device
    tokens = torch.as_tensor(tokens, device=device)
    logits, cache = decode_block(params, cache, tokens[:, None], pos, config)
    return logits[:, 0], cache


def _filter_logits(logits: torch.Tensor, top_k: Optional[int],
                   top_p: Optional[float]) -> torch.Tensor:
    """Sampling filters: keep the top-k logits and/or the nucleus (the
    smallest set of tokens whose probability mass reaches ``top_p``,
    always keeping the most probable one); the rest drop to
    ``NEG_INF``."""
    if top_k is not None and top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits >= kth, logits, NEG_INF)
    if top_p is not None and top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        keep_sorted = torch.cat(
            [torch.ones_like(cum[..., :1], dtype=torch.bool),
             cum[..., :-1] < top_p], dim=-1)
        threshold = torch.where(keep_sorted, sorted_logits,
                                torch.inf).amin(dim=-1, keepdim=True)
        logits = torch.where(logits >= threshold, logits, NEG_INF)
    return logits


def generate(params: Dict, prompt, max_new_tokens: int,
             config: TransformerConfig, temperature: float = 0.0,
             key: Optional[torch.Generator] = None,
             top_k: Optional[int] = None, top_p: Optional[float] = None,
             repetition_penalty: float = 1.0, prompt_lengths=None,
             logits_processor=None) -> torch.Tensor:
    """Autoregressive generation: ``(batch, prompt_len)`` prompt ids ->
    ``(batch, max_new_tokens)`` int64 continuations, on the device of
    ``params``.

    The JAX package's jitted ``lax.scan`` becomes a host loop of
    :func:`decode_step` over one preallocated cache. Uniform prompts
    prefill in one :func:`prefill_cache` pass; with ``prompt_lengths``
    (right-padded ragged prompts) every row teacher-forces its own
    prompt token by token and its continuation starts at index 0 of the
    output. ``temperature=0`` is greedy argmax; otherwise categorical
    sampling from ``key``, a ``torch.Generator`` on the params' device
    (the JAX PRNG key's counterpart; the draws differ), after
    temperature scaling and the ``top_k``/``top_p`` filters.
    ``repetition_penalty > 1`` (CTRL) shrinks the logits of tokens in
    the prompt or emitted so far. ``logits_processor`` maps every
    step's ``(batch, vocab)`` logits before penalties and filters."""
    c = config
    device = params["embed"]["tokens"].device
    prompt = torch.as_tensor(prompt, device=device).long()
    batch, prompt_len = prompt.shape
    total = prompt_len + max_new_tokens
    if total > c.max_seq_len:
        raise ValueError(f"prompt_len + max_new_tokens = {total} exceeds "
                         f"max_seq_len = {c.max_seq_len}")
    if temperature > 0 and key is None:
        raise ValueError("sampling (temperature > 0) requires a "
                         "torch.Generator key")
    if top_k is not None and top_k < 1:
        raise ValueError("top_k must be >= 1")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError("top_p must be in (0, 1]")
    if repetition_penalty < 1.0:
        raise ValueError("repetition_penalty must be >= 1")
    if prompt_lengths is not None:
        lens = torch.as_tensor(prompt_lengths, device=device).long()
        if lens.shape != (batch,):
            raise ValueError("prompt_lengths must be (batch,)")
    else:
        lens = torch.full((batch,), prompt_len, device=device)
    if max_new_tokens == 0:
        return torch.zeros((batch, 0), dtype=torch.long, device=device)
    use_rep = repetition_penalty != 1.0
    rows = torch.arange(batch, device=device)
    seen = torch.zeros((batch, c.vocab_size), dtype=torch.bool,
                       device=device)
    if use_rep:
        valid = torch.arange(prompt_len, device=device)[None, :] < lens[:,
                                                                        None]
        seen[rows[:, None].expand_as(prompt)[valid], prompt[valid]] = True

    def next_token(logits):
        if logits_processor is not None:
            logits = logits_processor(logits)
        if use_rep:
            p = repetition_penalty
            penalized = torch.where(logits > 0, logits / p, logits * p)
            logits = torch.where(seen, penalized, logits)
        if temperature > 0:
            filtered = _filter_logits(logits / temperature, top_k, top_p)
            probs = torch.softmax(filtered, dim=-1)
            return torch.multinomial(probs, 1, generator=key)[:, 0]
        return torch.argmax(logits, dim=-1)

    def mark_seen(nxt, t):
        if use_rep:
            emitted = t + 1 >= lens
            seen[rows[emitted], nxt[emitted]] = True

    out = []
    if prompt_lengths is None:
        logits, cache = prefill_cache(params, prompt, c, total)
        nxt = next_token(logits)
        mark_seen(nxt, prompt_len - 1)
        out.append(nxt)
        for t in range(prompt_len, total - 1):
            logits, cache = decode_step(params, cache, nxt, t, c)
            nxt = next_token(logits)
            mark_seen(nxt, t)
            out.append(nxt)
        return torch.stack(out, dim=1)
    cache = init_kv_cache(c, batch, total, device)
    prev = prompt[:, 0]
    for t in range(total - 1):
        tok = torch.where(t < lens, prompt[:, min(t, prompt_len - 1)], prev)
        logits, cache = decode_step(params, cache, tok, t, c)
        prev = next_token(logits)
        mark_seen(prev, t)
        out.append(prev)
    sampled = torch.stack(out, dim=1)                  # (B, total - 1)
    idx = (lens[:, None] - 1) + torch.arange(max_new_tokens,
                                             device=device)[None, :]
    return torch.gather(sampled, 1, idx)


def beam_search(params: Dict, prompt, max_new_tokens: int,
                config: TransformerConfig, num_beams: int = 4,
                length_penalty: float = 0.0, eos_id: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam-search decoding: ``(batch, prompt_len)`` prompts ->
    ``(sequences, scores)``, sequences ``(batch, num_beams,
    max_new_tokens)`` sorted best-first. Beams ride the batch axis of
    one cache (the prompt prefills once per row and repeats across the
    beams), reordered by a beam gather each step. ``eos_id`` freezes
    finished beams (they may only emit eos, at no cost);
    ``length_penalty`` applies the GNMT normalization
    ``((5+L)/6)**alpha`` at ranking time."""
    c = config
    device = params["embed"]["tokens"].device
    prompt = torch.as_tensor(prompt, device=device).long()
    batch, prompt_len = prompt.shape
    total = prompt_len + max_new_tokens
    if total > c.max_seq_len:
        raise ValueError("prompt_len + max_new_tokens exceeds max_seq_len")
    if num_beams < 1:
        raise ValueError("num_beams must be >= 1")
    k, v = num_beams, c.vocab_size
    logits_row, cache_row = prefill_cache(params, prompt, c, total)
    logits = logits_row.repeat_interleave(k, dim=0)            # (B*K, V)
    cache = {name: {part: t.repeat_interleave(k, dim=0)
                    for part, t in lc.items()}
             for name, lc in cache_row.items()}
    scores = torch.full((batch, k), NEG_INF, dtype=torch.float32,
                        device=device)
    scores[:, 0] = 0.0              # only beam 0 is live (no ties)
    tokens = torch.zeros((batch, k, max_new_tokens), dtype=torch.long,
                         device=device)
    finished = torch.zeros((batch, k), dtype=torch.bool, device=device)
    if eos_id is not None:
        frozen = torch.full((v,), NEG_INF, dtype=torch.float32,
                            device=device)
        frozen[eos_id] = 0.0
    offsets = (torch.arange(batch, device=device) * k)[:, None]
    for t in range(max_new_tokens):
        logp = torch.log_softmax(logits, dim=-1).reshape(batch, k, v)
        if eos_id is not None:
            logp = torch.where(finished[..., None], frozen, logp)
        flat = (scores[..., None] + logp).reshape(batch, -1)   # (B, K*V)
        scores, top_flat = torch.topk(flat, k, dim=-1)
        beam_idx = top_flat // v
        token = top_flat % v
        tokens = torch.gather(tokens, 1, beam_idx[..., None].expand(
            -1, -1, max_new_tokens)).clone()
        tokens[:, :, t] = token
        finished = torch.gather(finished, 1, beam_idx)
        if eos_id is not None:
            finished = finished | (token == eos_id)
        gather = (beam_idx + offsets).reshape(-1)
        cache = {name: {part: a.index_select(0, gather)
                        for part, a in lc.items()}
                 for name, lc in cache.items()}
        logits, cache = decode_step(params, cache, token.reshape(-1),
                                    prompt_len + t, c)
    if eos_id is not None:
        first_eos = torch.argmax((tokens == eos_id).to(torch.int32), dim=-1)
        lengths = torch.where(finished, 1.0 + first_eos.to(torch.float32),
                              float(max_new_tokens))
    else:
        lengths = torch.full(scores.shape, float(max_new_tokens),
                             device=device)
    ranked = scores / ((5.0 + lengths) / 6.0) ** length_penalty
    order = torch.sort(-ranked, dim=1, stable=True).indices
    return (torch.gather(tokens, 1, order[..., None].expand(
                -1, -1, max_new_tokens)),
            torch.gather(ranked, 1, order))
