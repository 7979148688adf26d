"""The port's cached decode family against the JAX package's.

Identical weights through the bridge at the small size (2 layers,
d_model 32, vocab 64, max_seq_len 32, f32), identical numpy-seeded
inputs: ``decode_step`` and ``decode_block`` logits at a scalar and a
per-row ``pos0`` (learned positions, RoPE with GQA, ALiBi with a
window) within 1e-5; ``prefill_cache_chunked`` against the whole
prefill; greedy ``generate`` token-equal (uniform and ragged prompts,
top-k/top-p given with temperature 0, a repetition penalty, a logits
processor); ``beam_search`` sequences equal and scores within 1e-5.
Greedy comparisons are tie-aware: a row may diverge only where the JAX
reference's top-2 logit gap is below 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from elephas_tpu.models import transformer as jtr
from elephas_tpu_torch.models import transformer as ttr
from elephas_tpu_torch.weights import from_numpy_tree
from tests.torch_one_thread import one_thread

# the JAX functions jitted: one compile each instead of op-by-op dispatch
_jprefill = jax.jit(jtr.prefill_cache, static_argnums=(2, 3))
_jblock = jax.jit(jtr.decode_block, static_argnums=(4,))
_jstep = jax.jit(jtr.decode_step, static_argnums=(4,))
_jchunked = jax.jit(jtr.prefill_cache_chunked, static_argnums=(2, 3, 4))

_BASE = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
             max_seq_len=32)
_VARIANTS = {"learned": {},
             "rope_gqa": dict(positional="rope", num_kv_heads=2,
                              mlp_variant="swiglu", norm="rmsnorm"),
             "alibi_window": dict(positional="alibi", attention_window=5)}


def _model(variant="learned"):
    kw = {**_BASE, **_VARIANTS[variant]}
    jcfg = jtr.TransformerConfig(dtype=jnp.float32, **kw)
    tcfg = ttr.TransformerConfig(dtype=torch.float32, **kw)
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(3))
    tp = from_numpy_tree(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    return jp, jcfg, tp, tcfg


@pytest.fixture(scope="module")
def model():
    return _model()


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 64, shape).astype(np.int32)


def _assert_tie_aware(jp, jcfg, prompts, ref, out):
    """Token-equal rows, except a divergence at a provable argmax
    near-tie of the reference (top-2 gap < 1e-3)."""
    for p, r, o in zip(prompts, ref, out):
        r, o = list(map(int, r)), list(map(int, o))
        if r == o:
            continue
        i = next(j for j, (a, b) in enumerate(zip(r, o)) if a != b)
        ctx = jnp.asarray([list(p) + r[:i]])
        top2 = jax.lax.top_k(jtr.forward(jp, ctx, jcfg)[0, -1], 2)[0]
        assert float(top2[0] - top2[1]) < 1e-3, (i, r, o)


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per_row"])
def test_decode_block_and_step_match_jax(variant, per_row):
    jp, jcfg, tp, tcfg = _model(variant)
    prompt = _tokens(0, (3, 6))
    _, jcache = _jprefill(jp, jnp.asarray(prompt), jcfg, 32)
    _, tcache = ttr.prefill_cache(tp, torch.as_tensor(prompt), tcfg, 32)
    pos0 = np.asarray([6, 3, 5]) if per_row else 6
    block = _tokens(1, (3, 4))
    jl, jcache = _jblock(jp, jcache, jnp.asarray(block), jnp.asarray(pos0),
                         jcfg)
    tl, tcache = ttr.decode_block(tp, tcache, block, pos0, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    np.testing.assert_allclose(tcache["layer_1"]["k"].numpy(),
                               np.asarray(jcache["layer_1"]["k"]), atol=1e-5)
    pos = pos0 + 4
    step = _tokens(2, (3,))
    jl, _ = _jstep(jp, jcache, jnp.asarray(step), jnp.asarray(pos), jcfg)
    tl, _ = ttr.decode_step(tp, tcache, step, pos, tcfg)
    assert tl.shape == (3, 64)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)


def test_decode_block_rejects_positions_past_the_cache(model):
    _, _, tp, tcfg = model
    cache = ttr.init_kv_cache(tcfg, 1, 8, "cpu")
    with pytest.raises(IndexError):
        ttr.decode_block(tp, cache, _tokens(0, (1, 3)), 6, tcfg)


@pytest.mark.parametrize("chunk", [1, 4, 5, 32])
def test_prefill_cache_chunked_matches_whole_prefill(model, chunk):
    jp, jcfg, tp, tcfg = model
    prompt = _tokens(4, (2, 13))
    whole, wcache = ttr.prefill_cache(tp, torch.as_tensor(prompt), tcfg, 32)
    logits, cache = ttr.prefill_cache_chunked(tp, prompt, tcfg, 32,
                                              chunk=chunk)
    np.testing.assert_allclose(logits.numpy(), whole.numpy(), atol=1e-5)
    for name in wcache:
        for part in ("k", "v"):
            np.testing.assert_allclose(cache[name][part].numpy(),
                                       wcache[name][part].numpy(),
                                       atol=1e-5)
    jl, _ = _jchunked(jp, jnp.asarray(prompt), jcfg, 32, chunk)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-5)


_GREEDY = {"plain": {}, "filters": dict(top_k=3, top_p=0.5),
           "rep_penalty": dict(repetition_penalty=1.5)}


@pytest.mark.parametrize("kwargs", list(_GREEDY.values()), ids=list(_GREEDY))
@pytest.mark.parametrize("ragged", [False, True], ids=["uniform", "ragged"])
def test_greedy_generate_matches_jax(model, kwargs, ragged):
    jp, jcfg, tp, tcfg = model
    prompt = _tokens(5, (3, 9))
    lens = np.asarray([9, 4, 6], np.int32) if ragged else None
    ref = np.asarray(jtr.generate(jp, jnp.asarray(prompt), 12, jcfg,
                                  prompt_lengths=lens, **kwargs))
    out = ttr.generate(tp, prompt, 12, tcfg, prompt_lengths=lens, **kwargs)
    assert out.shape == (3, 12) and out.dtype == torch.long
    heads = ([p[:n] for p, n in zip(prompt, lens)] if ragged
             else list(prompt))
    _assert_tie_aware(jp, jcfg, heads, ref, out.numpy())


def test_generate_logits_processor_bans_tokens(model):
    jp, jcfg, tp, tcfg = model
    prompt = _tokens(6, (2, 5))
    banned = np.array(jtr.generate(jp, jnp.asarray(prompt), 1, jcfg))[:, 0]

    def jban(logits):
        return logits.at[:, banned].set(-jnp.inf)

    def tban(logits):
        logits = logits.clone()
        logits[:, torch.as_tensor(banned, dtype=torch.long)] = -torch.inf
        return logits

    ref = np.asarray(jtr.generate(jp, jnp.asarray(prompt), 6, jcfg,
                                  logits_processor=jban))
    out = ttr.generate(tp, prompt, 6, tcfg, logits_processor=tban).numpy()
    assert not np.isin(out, banned).any()
    _assert_tie_aware(jp, jcfg, list(prompt), ref, out)


def test_sampled_generate_is_seeded_and_top_k_1_is_greedy(model):
    _, _, tp, tcfg = model
    prompt = _tokens(7, (2, 6))

    def sample(seed, **kw):
        gen = torch.Generator().manual_seed(seed)
        return ttr.generate(tp, prompt, 8, tcfg, temperature=0.8, key=gen,
                            **kw)

    torch.testing.assert_close(sample(1), sample(1))
    torch.testing.assert_close(sample(2, top_k=1),
                               ttr.generate(tp, prompt, 8, tcfg))
    out = sample(3, top_k=5, top_p=0.9)
    assert out.shape == (2, 8) and int(out.max()) < 64
    with pytest.raises(ValueError, match="Generator"):
        ttr.generate(tp, prompt, 4, tcfg, temperature=1.0)
    with pytest.raises(ValueError, match="max_seq_len"):
        ttr.generate(tp, prompt, 40, tcfg)


@pytest.mark.parametrize("num_beams,length_penalty,eos",
                         [(1, 0.0, None), (3, 0.6, None), (4, 1.0, 7)])
def test_beam_search_matches_jax(model, num_beams, length_penalty, eos):
    jp, jcfg, tp, tcfg = model
    prompt = _tokens(8, (2, 7))
    if eos is not None:
        # an eos the beams really reach: the greedy run's third token
        eos = int(np.asarray(jtr.generate(jp, jnp.asarray(prompt), 3,
                                          jcfg))[0, 2])
    jseq, jscore = jtr.beam_search(jp, jnp.asarray(prompt), 8, jcfg,
                                   num_beams=num_beams,
                                   length_penalty=length_penalty, eos_id=eos)
    seq, score = ttr.beam_search(tp, prompt, 8, tcfg, num_beams=num_beams,
                                 length_penalty=length_penalty, eos_id=eos)
    assert seq.shape == (2, num_beams, 8)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jseq))
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore), atol=1e-5)
    if num_beams == 1:
        np.testing.assert_array_equal(
            seq[:, 0].numpy(), ttr.generate(tp, prompt, 8, tcfg).numpy())
