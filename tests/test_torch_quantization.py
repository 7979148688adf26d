"""Weight-only int8 and the int8 KV cache in the port against the JAX
package.

Identical weights through the bridge and identical numpy-seeded inputs
at the small size (2 layers, d_model 32, 4 heads, vocab 64, f32):
``quantize_weight`` gives equal int8 data (halves round to even, as
``jnp.round`` does) and scales within 1e-6 relative; ``quantize_lm_params``
quantizes the same leaves as the JAX function (dense, SwiGLU, MoE with
the shared expert, the untied head), and its JAX tree crosses the
bridge both ways; ``forward`` and the chunked loss over a quantized
untied head (``QTensor.T``) within 1e-5; under ``kv_cache_quant`` the
cache after ``prefill_cache`` and ``decode_block`` (int8 data within one
step, at most 0.1% of entries off by one, scales within 1e-5 relative:
they come from computed activations)
and the logits within 1e-5; greedy tokens of the contiguous engine with
the int8 cache and int8 weights and of the paged engine with int8
weights equal the JAX engines', tie-aware (a divergence only at a top-2
logit gap below 1e-3); and the paged engine refusing ``kv_cache_quant``
with the JAX package's message.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from elephas_tpu.models import quantization as jq
from elephas_tpu.serving_engine import DecodeEngine as JaxEngine
from elephas_tpu_torch.models import quantization as tq
from elephas_tpu_torch.models import transformer as ttr
from elephas_tpu_torch.serving_engine import DecodeEngine
from elephas_tpu_torch.weights import (from_numpy_tree, to_numpy_tree,
                                       tree_leaves)
# one_thread is an autouse fixture: importing it applies it here
from tests.torch_lm_parity import (configs, jax_decode_block, jax_forward,
                                   jax_lm_loss, jax_prefill, one_thread,
                                   params)

_BASE = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
             max_seq_len=32)
_VARIANTS = {
    "untied_swiglu": dict(tied_embedding=False, mlp_variant="swiglu",
                          positional="rope", num_kv_heads=2,
                          norm="rmsnorm"),
    "moe_shared": dict(num_experts=4, expert_top_k=2, moe_dispatch="dense",
                       moe_shared_expert=True, tied_embedding=False),
    "learned": {},
}


def _configs(variant="learned", **extra):
    return configs(_BASE, _VARIANTS, variant, **extra)


def _qparams(tcfg, seed=0):
    """The JAX tree quantized by the JAX package, and its bridge."""
    jq_params = jq.quantize_lm_params(params(tcfg, seed)[0])
    return jq_params, from_numpy_tree(
        jax.tree_util.tree_map(np.asarray, jq_params), device="cpu")


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("shape,axes", [((32, 4, 8), (0,)),
                                        ((4, 8, 32), (0, 1)),
                                        ((3, 16, 24), (1,)),
                                        ((2, 4, 6, 8), (-1,))])
def test_quantize_weight_matches_jax(shape, axes):
    w = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    # exact halves after scaling: 127 sets the scale of its channel to 1
    w.reshape(-1)[:4] = [127.0, 63.5, -0.5, 2.5]
    want = jq.quantize_weight(jnp.asarray(w), axes)
    got = tq.quantize_weight(torch.from_numpy(w), axes)
    assert got.data.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_quantize_lm_params_takes_the_jax_leaves(variant):
    jcfg, tcfg = _configs(variant)
    jp, tp = params(tcfg, seed=2)
    want = jq.quantize_lm_params(jp)
    got = tq.quantize_lm_params(tp)

    def kinds(tree, qtype):
        if isinstance(tree, dict):
            return {k: kinds(v, qtype) for k, v in tree.items()}
        return "q8" if isinstance(tree, qtype) else "fp"

    assert kinds(got, tq.QTensor) == kinds(want, jq.QTensor)
    jleaves = jax.tree_util.tree_leaves(want)
    tleaves = tree_leaves(got)
    assert len(tleaves) == len(jleaves)
    for a, b in zip(jleaves, tleaves):
        assert b.dtype == {np.dtype(np.int8): torch.int8}.get(
            np.asarray(a).dtype, torch.float32)
        if b.dtype == torch.int8:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        else:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=0)
    # the JAX tree crosses the bridge, and back
    bridged = from_numpy_tree(jax.tree_util.tree_map(np.asarray, want),
                              device="cpu")
    assert kinds(bridged, tq.QTensor) == kinds(want, jq.QTensor)
    back = to_numpy_tree(bridged)
    for a, b in zip(jleaves, tree_leaves(back)):
        np.testing.assert_array_equal(b, np.asarray(a))
    deq = tq.dequantize_lm_params(bridged)
    for a, b in zip(jax.tree_util.tree_leaves(jq.dequantize_lm_params(want)),
                    tree_leaves(deq)):
        _close(b, a, 1e-6)


@pytest.mark.parametrize("variant,chunk", [("untied_swiglu", None),
                                           ("untied_swiglu", 24),
                                           ("moe_shared", 16)])
def test_forward_and_loss_over_int8_weights_match_jax(variant, chunk):
    jcfg, tcfg = _configs(variant, loss_vocab_chunk=chunk)
    jp, tp = _qparams(tcfg, seed=3)
    assert isinstance(tp["head"], tq.QTensor)
    tokens = np.random.default_rng(4).integers(0, 64, (2, 12)).astype(
        np.int32)
    _close(ttr.forward(tp, torch.from_numpy(tokens), tcfg),
           jax_forward(jp, jnp.asarray(tokens), jcfg), 1e-5)
    want = float(jax_lm_loss(jp, jnp.asarray(tokens), jcfg))
    assert abs(float(ttr.lm_loss(tp, torch.from_numpy(tokens), tcfg))
               - want) <= 1e-5


def _assert_cache_close(tc, jc):
    for name in jc:
        for part in ("k", "v"):
            got = tc[name][part].numpy().astype(np.int32)
            want = np.asarray(jc[name][part]).astype(np.int32)
            assert tc[name][part].dtype == torch.int8
            off = np.abs(got - want)
            assert off.max() <= 1 and (off > 0).mean() <= 1e-3, off.max()
            np.testing.assert_allclose(tc[name][part + "_scale"].numpy(),
                                       np.asarray(jc[name][part + "_scale"]),
                                       rtol=1e-5, atol=0)


@pytest.mark.parametrize("variant", ["untied_swiglu", "learned"])
def test_int8_cache_after_prefill_and_decode_matches_jax(variant):
    jcfg, tcfg = _configs(variant, kv_cache_quant=True)
    jp, tp = params(tcfg, seed=5)
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, 64, (2, 7)).astype(np.int32)
    jl, jc = jax_prefill(jp, jnp.asarray(prompt), jcfg, 16)
    tl, tc = ttr.prefill_cache(tp, torch.from_numpy(prompt), tcfg, 16)
    assert set(tc["layer_0"]) == {"k", "k_scale", "v", "v_scale"}
    assert tc["layer_0"]["k_scale"].shape == (2, tcfg.kv_heads, 16, 1)
    _close(tl, jl, 1e-5)
    _assert_cache_close(tc, jc)
    for pos in (7, np.array([8, 7])):
        block = rng.integers(0, 64, (2, 1)).astype(np.int32)
        jl, jc = jax_decode_block(jp, jc, jnp.asarray(block),
                                  jnp.asarray(pos), jcfg)
        tl, tc = ttr.decode_block(tp, tc, torch.from_numpy(block),
                                  torch.as_tensor(pos), tcfg)
        _close(tl, jl, 1e-5)
    _assert_cache_close(tc, jc)


def _run(eng, prompts, n):
    rids = [eng.submit(p, n) for p in prompts]
    while eng.pending:
        eng.step()
    return [eng.result(r) for r in rids]


def _assert_tie_aware(tp, tcfg, prompts, ref, out):
    """At a first divergence the reference's next-token logits, from
    ``prefill_cache`` (the decode path's own numerics: the dequantized
    cache and dense gating), have a top-2 gap below 1e-3."""
    for p, r, o in zip(prompts, ref, out):
        if r == o:
            continue
        i = next((j for j, (a, b) in enumerate(zip(r, o)) if a != b),
                 min(len(r), len(o)))
        ctx = torch.as_tensor([p + r[:i]])
        top2 = ttr.prefill_cache(tp, ctx, tcfg, ctx.shape[1])[0][0].topk(2)
        assert float(top2.values[0] - top2.values[1]) < 1e-3, (i, r, o)


_PROMPTS = [np.random.default_rng(7).integers(0, 64, n).tolist()
            for n in (5, 9, 3)]


@pytest.mark.parametrize("variant", ["untied_swiglu", "moe_shared"])
def test_contiguous_engine_with_int8_cache_and_weights_matches_jax(variant):
    jcfg, tcfg = _configs(variant, kv_cache_quant=True)
    jp, tp = _qparams(tcfg, seed=8)
    out = _run(DecodeEngine(tp, tcfg, max_slots=2, prefill_chunk=4,
                            device="cpu"), _PROMPTS, 8)
    ref = _run(JaxEngine(jp, jcfg, max_slots=2, prefill_chunk=4), _PROMPTS,
               8)
    _assert_tie_aware(tp, tcfg, _PROMPTS, ref, out)
    solo = [ttr.generate(tp, [p], 8, tcfg)[0].tolist() for p in _PROMPTS]
    _assert_tie_aware(tp, tcfg, _PROMPTS, solo, out)


@pytest.mark.parametrize("kernel", ["gather", "fused"])
def test_paged_engine_with_int8_weights_matches_jax(kernel):
    jcfg, tcfg = _configs("untied_swiglu")
    jp, tp = _qparams(tcfg, seed=9)
    out = _run(DecodeEngine(tp, tcfg, max_slots=2, paged=(24, 4),
                            kernel=kernel, device="cpu"), _PROMPTS, 8)
    ref = _run(JaxEngine(jp, jcfg, max_slots=2, paged=(24, 4)), _PROMPTS, 8)
    _assert_tie_aware(tp, tcfg, _PROMPTS, ref, out)


def test_paged_engine_refuses_the_int8_cache_with_the_jax_message():
    jcfg, tcfg = _configs(kv_cache_quant=True)
    jp, tp = params(tcfg)
    with pytest.raises(ValueError) as jerr:
        JaxEngine(jp, jcfg, paged=(16, 4))
    with pytest.raises(ValueError) as terr:
        DecodeEngine(tp, tcfg, paged=(16, 4), device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert "kv_cache_quant" in str(terr.value)


def test_int8_cache_bytes():
    """The int8 cache holds 1 byte an entry plus a 4-byte scale per
    (position, head): 132 / 256 of the bf16 cache's bytes at head dim
    128."""
    cfg = ttr.TransformerConfig(**{**_BASE, "num_heads": 1, "d_model": 128,
                                   "kv_cache_quant": True})

    def nbytes(c):
        cache = ttr.init_kv_cache(c, 2, 16, "cpu")
        return sum(t.numel() * t.element_size() for t in tree_leaves(cache))

    fp = nbytes(dataclasses.replace(cfg, kv_cache_quant=False))
    assert nbytes(cfg) * 256 == fp * 132
