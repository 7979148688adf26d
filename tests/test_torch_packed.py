"""Packed-row training in the port against the JAX package.

Identical weights through the bridge and identical numpy-seeded tokens
and segment ids at the small size (2 layers, d_model 32, vocab 64, f32,
both on the plain attention path, where JAX sends packed batches):
``segment_target_weights`` equal; ``forward`` with segments, pad
positions and a row of padding only included, within 1e-5 (learned
positions; RoPE with GQA and a window; ALiBi; a port config asking for
the flash kernels, which a packed batch bypasses); the weighted
``lm_loss`` within 1e-5, plain and chunked, with label smoothing and
z-loss; three ``make_train_step(packed=True)`` AdamW steps, with and
without ``accum_steps=2``, leaving every weight within 1e-5 of JAX's.
A pad query has every key masked: the finite ``NEG_INF`` fill gives it
a uniform softmax in both packages, never NaN.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from elephas_tpu.models import optimizers as jopt
from elephas_tpu.models import transformer as jtr
from elephas_tpu_torch.models import optimizers as topt
from elephas_tpu_torch.models import transformer as ttr
from elephas_tpu_torch.utils.text import ByteTokenizer
from elephas_tpu_torch.weights import tree_leaves
# one_thread is an autouse fixture: importing it applies it here
from tests.torch_lm_parity import (configs, jax_forward, jax_lm_loss,
                                   one_thread, params)

_BASE = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
             max_seq_len=24)
_VARIANTS = {
    "learned": {},
    "rope_gqa_window": dict(positional="rope", num_kv_heads=2,
                            mlp_variant="swiglu", norm="rmsnorm",
                            attention_window=5),
    "alibi": dict(positional="alibi"),
    "flash_asked": dict(attention_impl="flash"),
    "chunked_smooth_z": dict(loss_vocab_chunk=24, label_smoothing=0.1,
                             z_loss_weight=1e-3),
    "plain_smooth_z": dict(label_smoothing=0.1, z_loss_weight=1e-3),
}
_SHAPE = (4, 20)


def _configs(variant="learned", **extra):
    return configs(_BASE, _VARIANTS, variant, **extra)


def _packed(seed=0, shape=_SHAPE):
    """Tokens and segment ids: rows of several documents with trailing
    padding, one row of a single document, and one row of padding."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 64, shape).astype(np.int32)
    segs = np.zeros(shape, np.int32)
    segs[0] = [1] * 7 + [2] * 5 + [3] * 4 + [0] * 4
    segs[1] = [1] * 3 + [2] * 12 + [0] * 5
    segs[2] = 1
    # row 3 is padding only: every query sees every key masked
    return tokens, segs


def test_segment_target_weights_match_jax():
    _, segs = _packed()
    want = np.asarray(jtr.segment_target_weights(jnp.asarray(segs)))
    got = ttr.segment_target_weights(torch.from_numpy(segs))
    assert got.dtype == torch.float32 and got.shape == (4, 19)
    np.testing.assert_array_equal(got.numpy(), want)


def test_pack_documents_rows_match_jax():
    """The port's tokenizer packs documents into the same rows and ids."""
    from elephas_tpu.utils.text import ByteTokenizer as JaxTokenizer

    docs = ["the quick brown fox. ", "pack my box! ", "sphinx. "] * 5
    rows, segs = ByteTokenizer().pack_documents(docs, seq_len=32)
    jrows, jsegs = JaxTokenizer().pack_documents(docs, seq_len=32)
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_array_equal(segs, jsegs)


@pytest.mark.parametrize("variant", ["learned", "rope_gqa_window", "alibi",
                                     "flash_asked"])
def test_forward_with_segments_matches_jax(variant):
    jcfg, tcfg = _configs(variant)
    jp, tp = params(tcfg)
    tokens, segs = _packed(1)
    want = np.asarray(jax_forward(jp, jnp.asarray(tokens), jcfg,
                                  segment_ids=jnp.asarray(segs)))
    got = ttr.forward(tp, torch.from_numpy(tokens), tcfg,
                      segment_ids=torch.from_numpy(segs)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # a row of one document is the unpacked row
    alone = ttr.forward(tp, torch.from_numpy(tokens[2:3]), tcfg)
    np.testing.assert_allclose(got[2:3], alone.numpy(), atol=1e-5, rtol=0)


def test_pad_queries_get_a_uniform_softmax():
    """A query in a pad position attends nowhere: with every score at the
    finite NEG_INF its weights are uniform over the keys, in both
    packages, and the plain attention output is their mean."""
    from elephas_tpu.ops.attention import attention as jattention
    from elephas_tpu_torch.ops.attention import attention

    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(size=(1, 2, 6, 8)).astype(np.float32)
               for _ in range(3))
    mask = np.zeros((1, 1, 6, 6), bool)
    got = attention(*map(torch.from_numpy, (q, k, v)), causal=False,
                    mask=torch.from_numpy(mask)).numpy()
    want = np.asarray(jattention(*map(jnp.asarray, (q, k, v)),
                                 causal=False, mask=jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, np.broadcast_to(
        v.mean(axis=2, keepdims=True), got.shape), atol=1e-6, rtol=0)


@pytest.mark.parametrize("variant", ["learned", "plain_smooth_z",
                                     "chunked_smooth_z"])
def test_weighted_lm_loss_matches_jax(variant):
    jcfg, tcfg = _configs(variant)
    jp, tp = params(tcfg, seed=3)
    tokens, segs = _packed(4)
    want = float(jax_lm_loss(jp, jnp.asarray(tokens), jcfg,
                             segment_ids=jnp.asarray(segs)))
    got = float(ttr.lm_loss(tp, torch.from_numpy(tokens), tcfg,
                            segment_ids=torch.from_numpy(segs)))
    assert abs(got - want) <= 1e-5
    # the weights count only in-document targets
    unpacked = float(ttr.lm_loss(tp, torch.from_numpy(tokens), tcfg))
    assert abs(unpacked - got) > 1e-4


def test_next_token_loss_weights_match_jax():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(3, 9, 64)).astype(np.float32)
    tokens = rng.integers(0, 64, (3, 9)).astype(np.int32)
    weights = (rng.random((3, 8)) > 0.4).astype(np.float32)
    for w in (weights, np.zeros_like(weights)):
        want = float(jtr.next_token_loss(jnp.asarray(logits),
                                         jnp.asarray(tokens), 0.1,
                                         weights=jnp.asarray(w)))
        got = float(ttr.next_token_loss(torch.from_numpy(logits),
                                        torch.from_numpy(tokens), 0.1,
                                        weights=torch.from_numpy(w)))
        assert abs(got - want) <= 1e-6


@pytest.mark.parametrize("accum", [1, 2])
def test_packed_adamw_steps_match_jax(accum):
    jcfg, tcfg = _configs("rope_gqa_window")
    jp, tp = params(tcfg, seed=6)
    # epsilon 1e-3: Adam divides by sqrt(nu) + eps, so a near-zero
    # gradient whose last bits differ between the packages would move its
    # leaf by up to lr * |dg| / eps
    jo = jopt.AdamW(1e-2, weight_decay=0.1, epsilon=1e-3)
    to = topt.deserialize(jopt.serialize(jo))
    tx, ttx = jo.to_optax(), to.to_transform()
    jstep = jtr.make_train_step(jcfg, tx, accum_steps=accum, packed=True)
    tstep = ttr.make_train_step(tcfg, ttx, accum_steps=accum, packed=True)
    js, ts = tx.init(jp), ttx.init(tp)
    for i in range(3):
        tokens, segs = _packed(10 + i)
        jp, js, jl = jstep(jp, js, jnp.asarray(tokens), jnp.asarray(segs))
        out, ts, tl = tstep(tp, ts, torch.from_numpy(tokens),
                            torch.from_numpy(segs))
        assert out is tp
        assert abs(float(tl) - float(jl)) <= 1e-5
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5,
                                   rtol=0)


def test_packed_step_signature():
    """The trailing ``segment_ids`` argument, after an optional dropout
    key: a packed step without segments is refused."""
    _, tcfg = _configs()
    p0 = ttr.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tx = topt.SGD(0.1).to_transform()
    step = ttr.make_train_step(tcfg, tx, packed=True)
    tokens, segs = map(torch.from_numpy, _packed(7))
    with pytest.raises(TypeError):
        step(p0, tx.init(p0), tokens)
    _, _, a = step(p0, tx.init(p0), tokens, None, segs)
    assert np.isfinite(float(a))
