"""The port's transformer inference path against the JAX package.

Identical weights (the JAX ``init_params`` tree through the weight
bridge) and identical numpy inputs go through both packages across the
attention-variant matrix: ``forward`` (flash and plain attention),
``prefill_cache`` (logits and cache), and one ``decode_step_paged``
over a shuffled block pool (gather and the fused kernel's path; the JAX
side runs its Pallas kernels in interpret mode). f32 compute; atol 1e-4
on logits (two layers of f32 matmuls summed in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from elephas_tpu.models import paged_decode as jpd
from elephas_tpu.models import transformer as jtr
from elephas_tpu_torch.models import paged_decode as tpd
from elephas_tpu_torch.models import transformer as ttr
from elephas_tpu_torch.weights import from_numpy_tree
from tests.torch_one_thread import one_thread

_VARIANTS = {
    "base": {},
    "gqa": {"num_kv_heads": 2},
    "window": {"attention_window": 5},
    "alibi": {"positional": "alibi"},
    "sinusoidal": {"positional": "sinusoidal"},
    "rope": {"positional": "rope"},
    "rmsnorm": {"norm": "rmsnorm"},
    "swiglu": {"mlp_variant": "swiglu"},
    "untied_gqa_rope_window": {"tied_embedding": False, "num_kv_heads": 1,
                               "positional": "rope",
                               "attention_window": 7},
}
_BASE = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
             max_seq_len=48)


def _configs(variant, **extra):
    kw = dict(_BASE, **_VARIANTS[variant], **extra)
    return (jtr.TransformerConfig(dtype=jnp.float32, **kw),
            ttr.TransformerConfig(dtype=torch.float32, **kw))


def _params(jcfg, seed=0):
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, from_numpy_tree(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")


@pytest.mark.parametrize("impl", ["flash", "xla"])
@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_forward_matches_jax(variant, impl):
    jcfg, tcfg = _configs(variant, attention_impl=impl)
    jp, tp = _params(jcfg)
    tokens = np.random.default_rng(1).integers(0, 64, (2, 19))
    ref = np.asarray(jtr.forward(jp, jnp.asarray(tokens), jcfg))
    out = ttr.forward(tp, torch.from_numpy(tokens), tcfg)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_prefill_cache_matches_jax(variant):
    jcfg, tcfg = _configs(variant)
    jp, tp = _params(jcfg, seed=1)
    tokens = np.random.default_rng(2).integers(0, 64, (2, 13))
    ref_logits, ref_cache = jtr.prefill_cache(jp, jnp.asarray(tokens), jcfg,
                                              32)
    logits, cache = ttr.prefill_cache(tp, torch.from_numpy(tokens), tcfg, 32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=1e-4, rtol=0)
    for name, lc in ref_cache.items():
        for part in ("k", "v"):
            assert cache[name][part].shape == lc[part].shape
            np.testing.assert_allclose(cache[name][part].numpy(),
                                       np.asarray(lc[part]), atol=1e-5,
                                       rtol=0)


@pytest.mark.parametrize("kernel", ["gather", "fused"])
@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_decode_step_paged_matches_jax(variant, kernel):
    jcfg, tcfg = _configs(variant)
    jp, tp = _params(jcfg, seed=2)
    rng = np.random.default_rng(3)
    nb, bs, mb, b = 20, 8, 4, 3
    shape = (nb, jcfg.kv_heads, bs, jcfg.head_dim)
    pool_np = {f"layer_{i}": {p: rng.standard_normal(shape).astype(
        np.float32) for p in ("k", "v")} for i in range(jcfg.num_layers)}
    tables = rng.permutation(np.arange(1, nb))[:b * mb].reshape(b, mb)
    tables = tables.astype(np.int32)
    tables[2] = 0                                 # an inactive slot
    pos = np.asarray([5, 30, 0], np.int32)
    tokens = rng.integers(0, 64, b).astype(np.int32)

    jpool = jax.tree_util.tree_map(jnp.asarray, pool_np)
    ref_logits, ref_pool = jpd.decode_step_paged(
        jp, jpool, jnp.asarray(tables), jnp.asarray(tokens),
        jnp.asarray(pos), jcfg,
        kernel="pallas" if kernel == "fused" else "gather", interpret=True)
    tpool = from_numpy_tree(pool_np, device="cpu")
    logits, out_pool = tpd.decode_step_paged(
        tp, tpool, torch.from_numpy(tables), torch.from_numpy(tokens),
        torch.from_numpy(pos), tcfg, kernel=kernel)
    assert out_pool is tpool                      # updated in place
    ref_logits = np.asarray(ref_logits)
    np.testing.assert_allclose(logits.numpy()[:2], ref_logits[:2],
                               atol=1e-4, rtol=0)
    for name in pool_np:
        for part in ("k", "v"):
            np.testing.assert_allclose(out_pool[name][part].numpy()[1:],
                                       np.asarray(ref_pool[name][part])[1:],
                                       atol=1e-5, rtol=0)


def test_install_row_paged_matches_jax():
    jcfg, tcfg = _configs("gqa")
    rng = np.random.default_rng(4)
    row = {f"layer_{i}": {p: rng.standard_normal(
        (1, 2, 30, jcfg.head_dim)).astype(np.float32) for p in ("k", "v")}
        for i in range(jcfg.num_layers)}
    ids = np.asarray([5, 2, 7, 0], np.int32)
    ref = jpd.install_row_paged(jpd.init_paged_pool(jcfg, 9, 8),
                                jax.tree_util.tree_map(jnp.asarray, row),
                                jnp.asarray(ids), 3)
    out = tpd.install_row_paged(tpd.init_paged_pool(tcfg, 9, 8, "cpu"),
                                from_numpy_tree(row, device="cpu"), ids, 3)
    for name in row:
        for part in ("k", "v"):
            np.testing.assert_array_equal(out[name][part].numpy(),
                                          np.asarray(ref[name][part]))


def test_attention_impl_routing():
    cfg = ttr.TransformerConfig(**_BASE)
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert ttr.resolve_attention_impl(cfg, cpu) == "xla"
    assert ttr.resolve_attention_impl(cfg, cuda) == "flash"
    forced = dataclasses.replace(cfg, attention_impl="flash")
    assert ttr.resolve_attention_impl(forced, cpu) == "flash"
    alibi = dataclasses.replace(forced, positional="alibi")
    assert ttr.resolve_attention_impl(alibi, cuda) == "xla"


@pytest.mark.parametrize("impl", ["auto", "flash"])
@pytest.mark.parametrize("head_dim", [16, 32, 64, 48, 100])
def test_auto_routes_by_head_dim_on_cuda(head_dim, impl):
    """Under ``auto`` (or an explicit ``"flash"``) a CUDA device takes
    the flash kernels at every head dim; 48 (a multiple of 8, on the
    64-wide body) passes the CUDA operand check's head-dim rule, and at
    one the kernels do not take (100) the check raises with the head dim
    and the rule, so nothing falls back to the plain path. ``auto`` on
    the CPU takes the plain path."""
    from elephas_tpu_torch.ops.flash_attention import _kernel_operands
    cfg = ttr.TransformerConfig(**dict(_BASE, num_heads=2,
                                       d_model=2 * head_dim,
                                       attention_impl=impl))
    assert cfg.head_dim == head_dim
    assert ttr.resolve_attention_impl(cfg, torch.device("cuda")) == "flash"
    assert ttr.resolve_attention_impl(cfg, torch.device("cpu")) == (
        "xla" if impl == "auto" else "flash")
    q = torch.zeros((1, 2, 5, head_dim))
    if head_dim == 100:
        with pytest.raises(ValueError, match=r"head_dim 100: .*"
                           r"multiple of 8 from 8 to 256"):
            _kernel_operands(q, k=q, v=q)
    elif head_dim == 48:
        # the head dim is taken: what stops a CPU tensor is the device
        with pytest.raises(ValueError, match=r"for device cpu"):
            _kernel_operands(q, k=q, v=q)


@pytest.mark.parametrize("feature", ["moe", "quant"])
def test_unported_features_raise(feature):
    """MoE layers and the int8 KV cache are ported; paged mode refuses
    them, with the JAX package's messages."""
    over = {"moe": {"num_experts": 4},
            "quant": {"kv_cache_quant": True}}[feature]
    cfg = ttr.TransformerConfig(**_BASE, **over)
    ttr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jcfg = jtr.TransformerConfig(**_BASE, **over)
    with pytest.raises(ValueError) as want:
        jpd.validate_paged_config(jcfg)
    with pytest.raises(ValueError) as got:
        tpd.init_paged_pool(cfg, 4, 4, "cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("arg", ["mesh", "segment_ids", "dropout_key"])
def test_unported_forward_arguments_raise(arg):
    """Mesh arguments are not ported; a dropout key is ported as a
    ``torch.Generator``, and anything else (a JAX key) is refused.
    Packed segments are ported: one segment over the row is the
    unpacked forward."""
    cfg = ttr.TransformerConfig(**_BASE, dtype=torch.float32)
    params = ttr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    if arg == "segment_ids":
        torch.testing.assert_close(
            ttr.forward(params, tokens, cfg,
                        segment_ids=torch.ones((1, 4), dtype=torch.long)),
            ttr.forward(params, tokens, cfg), atol=1e-6, rtol=0)
        return
    error = TypeError if arg == "dropout_key" else NotImplementedError
    with pytest.raises(error):
        ttr.forward(params, tokens, cfg, **{arg: object()})
