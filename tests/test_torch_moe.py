"""The port's mixture-of-experts layer against the JAX package's.

Identical weights through the bridge and identical numpy-seeded inputs
at the small size (2 layers, d_model 32, 4 heads, vocab 64, d_ff 64,
f32, both on the plain attention path): the f32 router's gates, expert
choices and aux loss for k = 1 and k = 2 with tied probabilities (ties
go to the lower expert, as ``jax.lax.top_k`` breaks them) within 1e-6;
dense and routed dispatch, with and without the shared expert, at a
capacity factor that drops assignments (the test counts the drops), to
1e-5; ``forward_with_aux``, ``lm_loss`` and every gradient against
``jax.grad`` (1e-5); ``prefill_cache`` then ``decode_block`` (dense
gating, logits and cache) within 1e-5; ``TransformerModel.compile``
pinning ``moe_dispatch='auto'`` as the JAX model does, and a three-epoch
``fit_tokens`` with the aux term within 1e-5 in loss; greedy tokens of
the contiguous ``DecodeEngine`` equal the JAX engine's, tie-aware (a
divergence only at a top-2 logit gap below 1e-3); and the paged engine
refusing MoE with the JAX package's message.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

torch = pytest.importorskip("torch")

from elephas_tpu.models import optimizers as jopt
from elephas_tpu.models import transformer as jtr
from elephas_tpu.models.transformer_model import TransformerModel as JModel
from elephas_tpu.serving_engine import DecodeEngine as JaxEngine
from elephas_tpu_torch.models import optimizers as topt
from elephas_tpu_torch.models import transformer as ttr
from elephas_tpu_torch.models.transformer_model import TransformerModel
from elephas_tpu_torch.serving_engine import DecodeEngine
# one_thread is an autouse fixture: importing it applies it here
from tests.torch_lm_parity import (configs, jax_decode_block,
                                   jax_forward, jax_forward_with_aux,
                                   jax_loss_and_grads, jax_prefill,
                                   one_thread, params)

_BASE = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
             max_seq_len=32, num_experts=4, expert_top_k=2)
_VARIANTS = {
    "dense": dict(moe_dispatch="dense"),
    "dense_shared": dict(moe_dispatch="dense", moe_shared_expert=True),
    # 1.25 x 2 x 24 / 4 = 15 slots for 48 assignments: the popular
    # experts overflow
    "routed_drops": dict(moe_dispatch="routed", moe_capacity_factor=0.4),
    "routed_shared": dict(moe_dispatch="routed", moe_capacity_factor=0.4,
                          moe_shared_expert=True),
    "routed_rope_k1": dict(moe_dispatch="routed", expert_top_k=1,
                           positional="rope", num_kv_heads=2,
                           norm="rmsnorm", tied_embedding=False,
                           loss_vocab_chunk=24),
}


def _configs(variant="dense", **extra):
    return configs(_BASE, _VARIANTS, variant, **extra)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 64,
                                                shape).astype(np.int32)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("k", [1, 2])
def test_gates_and_aux_match_jax_with_ties(k):
    jcfg, tcfg = _configs(expert_top_k=k, num_experts=6)
    rng = np.random.default_rng(1)
    h = rng.normal(size=(2, 5, 32)).astype(np.float32)
    gate = rng.normal(size=(32, 6)).astype(np.float32)
    # experts 1 and 4 share a column and 2 and 3 another: their
    # probabilities tie exactly on every token
    gate[:, 4] = gate[:, 1]
    gate[:, 3] = gate[:, 2]
    h[0, 0] = 0.0                # a token whose six probabilities all tie
    want = jtr._moe_gates(jnp.asarray(h), {"gate": jnp.asarray(gate)}, jcfg)
    got = ttr._moe_gates(torch.from_numpy(h),
                         {"gate": torch.from_numpy(gate)}, tcfg)
    for g, w in zip(got, want):
        _close(g, w, 1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2][0, 0].tolist() == list(range(k))


def _drops(tcfg, tp, tokens, layer=0):
    """Assignments past capacity at ``layer``'s router under routed
    dispatch over ``tokens`` (counted on the host from the router's
    choices, which the gate test holds equal to JAX's)."""
    x = ttr.embed_apply(tp["embed"], torch.from_numpy(tokens), tcfg)
    lyr = tp[f"layer_{layer}"]
    x = ttr._attn_apply(lyr, x, tcfg, ttr._attention_fn(
        tcfg, x.device, tokens.shape[1]))
    h = ttr._norm(x, lyr["ln2"], tcfg).reshape(-1, tcfg.d_model)
    experts = ttr._moe_gates(h, lyr["moe"], tcfg)[2].reshape(-1).tolist()
    cap = ttr._routed_capacity(tcfg, h.shape[0])
    seen = [0] * tcfg.num_experts
    dropped = 0
    for e in experts:
        dropped += seen[e] >= cap
        seen[e] += 1
    return dropped


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_moe_block_matches_jax(variant):
    jcfg, tcfg = _configs(variant)
    jp, tp = params(tcfg, seed=2)
    rng = np.random.default_rng(3)
    h = rng.normal(size=(2, 12, 32)).astype(np.float32)
    dispatch = jtr.select_moe_dispatch(jcfg)
    assert ttr.select_moe_dispatch(tcfg) == dispatch
    want = jtr._moe_block(jnp.asarray(h), jp["layer_0"]["moe"], jcfg,
                          dispatch=dispatch)
    got = ttr._moe_block(torch.from_numpy(h), tp["layer_0"]["moe"], tcfg,
                         dispatch=dispatch)
    _close(got[0], want[0], 1e-5)
    _close(got[1], want[1], 1e-6)
    if variant.startswith("routed") and tcfg.expert_top_k == 2:
        # the capacity race dropped assignments: routed is not dense
        dense = ttr._moe_block(torch.from_numpy(h), tp["layer_0"]["moe"],
                               tcfg, dispatch="dense")
        assert float((dense[0] - got[0]).abs().max()) > 1e-3
    if "shared" in variant:
        sh = jtr._shared_expert(jnp.asarray(h), jp["layer_0"]["moe"][
            "shared"], jcfg)
        _close(ttr._shared_expert(torch.from_numpy(h), tp["layer_0"]["moe"][
            "shared"], tcfg), sh, 1e-5)


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_forward_with_aux_matches_jax(variant):
    jcfg, tcfg = _configs(variant)
    jp, tp = params(tcfg, seed=4)
    tokens = _tokens(5, (2, 12))
    jl, ja = jax_forward_with_aux(jp, jnp.asarray(tokens), jcfg)
    tl, ta = ttr.forward_with_aux(tp, torch.from_numpy(tokens), tcfg)
    _close(tl, jl, 1e-5)
    assert abs(float(ta) - float(ja)) <= 1e-5
    if variant == "routed_drops":
        assert _drops(tcfg, tp, tokens) > 0


@pytest.mark.parametrize("variant", ["dense_shared", "routed_drops",
                                     "routed_rope_k1"])
def test_lm_loss_and_gradients_match_jax(variant):
    jcfg, tcfg = _configs(variant)
    jp, tp = params(tcfg, seed=6)
    tokens = _tokens(7, (2, 12))
    jloss, jgrads = jax_loss_and_grads(jp, jnp.asarray(tokens), jcfg)
    tloss, tgrads = ttr.lm_loss_and_grads(tp, torch.from_numpy(tokens), tcfg)
    assert abs(float(tloss) - float(jloss)) <= 1e-5
    for a, b in zip(jax.tree_util.tree_leaves(jgrads), tgrads):
        _close(b, a, 1e-5)


def test_routed_capacity_depends_on_the_call():
    """``forward`` over a batch and over its halves may differ under
    routed dispatch: the capacity is the call's, as in the JAX package."""
    jcfg, tcfg = _configs("routed_drops")
    jp, tp = params(tcfg, seed=8)
    tokens = _tokens(9, (4, 12))
    whole = ttr.forward(tp, torch.from_numpy(tokens), tcfg)
    halves = torch.cat([ttr.forward(tp, torch.from_numpy(tokens[i:i + 2]),
                                    tcfg) for i in (0, 2)])
    jwhole = jax_forward(jp, jnp.asarray(tokens), jcfg)
    jhalves = jnp.concatenate([jax_forward(jp, jnp.asarray(tokens[i:i + 2]),
                                           jcfg) for i in (0, 2)])
    _close(whole, jwhole, 1e-5)
    _close(halves, jhalves, 1e-5)
    assert float((whole - halves).abs().max()) > 1e-4


@pytest.mark.parametrize("variant", ["routed_drops", "dense_shared"])
def test_prefill_and_decode_block_match_jax(variant):
    jcfg, tcfg = _configs(variant)
    jp, tp = params(tcfg, seed=10)
    prompt = _tokens(11, (2, 7))
    block = _tokens(12, (2, 3))
    jl, jc = jax_prefill(jp, jnp.asarray(prompt), jcfg, 16)
    tl, tc = ttr.prefill_cache(tp, torch.from_numpy(prompt), tcfg, 16)
    _close(tl, jl, 1e-5)
    jl, jc = jax_decode_block(jp, jc, jnp.asarray(block), 7, jcfg)
    tl, tc = ttr.decode_block(tp, tc, torch.from_numpy(block), 7, tcfg)
    _close(tl, jl, 1e-5)
    for name in jc:
        for part in ("k", "v"):
            _close(tc[name][part], jc[name][part], 1e-5)
    # decode gates densely whatever the dispatch: the block's logits are
    # the dense forward's
    dense = ttr.forward(tp, torch.from_numpy(np.concatenate(
        [prompt, block], axis=1)), dataclasses.replace(
            tcfg, moe_dispatch="dense"))
    _close(tl, dense[:, 7:], 1e-5)


@pytest.mark.parametrize("experts,want", [(4, "dense"), (8, "routed")])
def test_compile_pins_the_dispatch_as_jax_does(experts, want):
    jcfg, tcfg = _configs("dense", num_experts=experts, moe_dispatch="auto")
    one = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jm = JModel(jcfg, mesh=one)
    # the port's initial weights: no JAX initializer to compile
    jm.params, jm.built = params(tcfg)[0], True
    jm.compile(jopt.Adam(1e-2))
    tm = TransformerModel(tcfg, device="cpu").compile(topt.Adam(1e-2),
                                                      seed=0)
    assert tm.config.moe_dispatch == jm.config.moe_dispatch == want


def test_fit_tokens_with_the_aux_term_matches_jax():
    jcfg, tcfg = _configs("routed_drops", moe_aux_weight=0.1)
    one = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    tm = TransformerModel(tcfg, device="cpu").compile(
        topt.SGD(0.3, momentum=0.9), seed=1)
    jm = JModel(jcfg, mesh=one)
    jm.params, jm.built = params(tcfg, seed=1)[0], True
    jm.compile(jopt.SGD(0.3, momentum=0.9))
    tokens = _tokens(13, (8, 13))
    kw = dict(epochs=3, batch_size=4, seed=2)
    ref, hist = jm.fit_tokens(tokens, **kw), tm.fit_tokens(tokens, **kw)
    np.testing.assert_allclose(hist["loss"], ref["loss"], atol=1e-5, rtol=0)
    for a, b in zip(jm.get_weights(), tm.get_weights()):
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)


def _run(eng, prompts, n):
    rids = [eng.submit(p, n) for p in prompts]
    while eng.pending:
        eng.step()
    return [eng.result(r) for r in rids]


def test_engine_greedy_tokens_match_jax_engine():
    jcfg, tcfg = _configs("routed_shared")
    jp, tp = params(tcfg, seed=14)
    rng = np.random.default_rng(15)
    prompts = [rng.integers(0, 64, n).tolist() for n in (5, 9, 3)]
    out = _run(DecodeEngine(tp, tcfg, max_slots=2, prefill_chunk=4,
                            device="cpu"), prompts, 8)
    ref = _run(JaxEngine(jp, jcfg, max_slots=2, prefill_chunk=4), prompts, 8)
    dense = dataclasses.replace(tcfg, moe_dispatch="dense")
    for p, r, o in zip(prompts, ref, out):
        if r == o:
            continue
        i = next((j for j, (a, b) in enumerate(zip(r, o)) if a != b),
                 min(len(r), len(o)))
        top2 = ttr.forward(tp, torch.as_tensor([p + r[:i]]),
                           dense)[0, -1].topk(2).values
        assert float(top2[0] - top2[1]) < 1e-3, (i, r, o)
    solo = [ttr.generate(tp, [p], 8, tcfg)[0].tolist() for p in prompts]
    assert sum(a == b for a, b in zip(solo, out)) >= 2


def test_paged_engine_refuses_moe_with_the_jax_message():
    jcfg, tcfg = _configs("dense")
    jp, tp = params(tcfg)
    with pytest.raises(ValueError) as jerr:
        JaxEngine(jp, jcfg, paged=(16, 4))
    with pytest.raises(ValueError) as terr:
        DecodeEngine(tp, tcfg, paged=(16, 4), device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert "MoE" in str(terr.value)
