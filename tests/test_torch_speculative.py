"""The port's speculative decoding and draft distillation against the
JAX package's.

Identical weights through the bridge at the small size (2-layer target,
1-layer draft, d_model 32, 4 heads, vocab 64, f32), identical
numpy-seeded inputs; each JAX function runs once per module in a
fixture. ``decode_block_paged`` logits and pool within 1e-5 (learned
positions, RoPE with GQA, ALiBi with a window); greedy
``speculative_generate`` equal to both packages' ``generate`` under the
tie-aware rule, with ``rounds`` and ``draft_acceptance`` equal to the
JAX package's for a draft equal to the target, a random draft and the
target's own first layer; ``speculative_round_paged`` equal to
``speculative_round`` on the same rows; ``distill_loss`` and its
gradient within 1e-5, and three ``make_distill_step`` steps (SGD with
momentum) leaving the draft within 1e-5. Sampling (temperature > 0):
a draft equal to the target accepts every proposal, and a torch-only
chi-square check at vocab 8 finds the emitted pairs distributed as the
target's (and not as the draft's); the two packages' random streams
differ, so no token parity is asked there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from elephas_tpu.models import distill as jdi
from elephas_tpu.models import optimizers as jopt
from elephas_tpu.models import paged_decode as jpd
from elephas_tpu.models import speculative as jsp
from elephas_tpu.models import transformer as jtr
from elephas_tpu_torch.models import distill as tdi
from elephas_tpu_torch.models import optimizers as topt
from elephas_tpu_torch.models import paged_decode as tpd
from elephas_tpu_torch.models import speculative as tsp
from elephas_tpu_torch.models import transformer as ttr
from elephas_tpu_torch.weights import (from_numpy_tree, to_numpy_tree,
                                       tree_leaves)
from tests.torch_one_thread import one_thread

_BASE = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
             max_seq_len=40)
_VARIANTS = {"learned": {},
             "rope_gqa": dict(positional="rope", num_kv_heads=2,
                              mlp_variant="swiglu", norm="rmsnorm"),
             "alibi_window": dict(positional="alibi", attention_window=5)}
_PROMPT_SHAPE = (3, 6)
_NEW, _GAMMA = 12, 3


def _configs(variant="learned", **extra):
    kw = dict(_BASE, **_VARIANTS[variant], **extra)
    return (jtr.TransformerConfig(dtype=jnp.float32, **kw),
            ttr.TransformerConfig(dtype=torch.float32, **kw))


def _tree(jp):
    return from_numpy_tree(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")


def _tokens(seed, shape, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab,
                                                shape).astype(np.int32)


def _first_layer(jp):
    """The target's embeddings, first layer and head: a 1-layer draft
    that agrees with the target part of the time."""
    return {k: v for k, v in jp.items() if k != "layer_1"}


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _configs()
    jdc, tdc = _configs(num_layers=1)
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    drafts = {"target": (jp, jcfg), "random": (
        jtr.init_params(jdc, jax.random.PRNGKey(7)), jdc),
        "first_layer": (_first_layer(jp), jdc)}
    return dict(jp=jp, jcfg=jcfg, tp=_tree(jp), tcfg=tcfg,
                drafts={name: (jd, jc, _tree(jd), tcfg if jc is jcfg
                               else tdc)
                        for name, (jd, jc) in drafts.items()})


@pytest.fixture(scope="module")
def jax_spec(models):
    """The JAX package's greedy speculative decode and generate, once."""
    prompt = _tokens(0, _PROMPT_SHAPE)
    jp, jcfg = models["jp"], models["jcfg"]
    out = {"prompt": prompt,
           "generate": np.asarray(jtr.generate(jp, prompt, _NEW, jcfg))}
    for name, (jd, jc, _, _) in models["drafts"].items():
        toks, stats = jsp.speculative_generate(jp, jd, prompt, _NEW, jcfg,
                                               jc, gamma=_GAMMA,
                                               return_stats=True)
        out[name] = (np.asarray(toks), stats)
    return out


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


# ------------------------------------------------------ paged verify
_jblock_paged = jax.jit(jpd.decode_block_paged, static_argnums=(5,))


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_decode_block_paged_matches_jax(variant):
    """The S > 1 verify over per-row block tables: the logits and every
    pool block (the scatter into the rows' own blocks, the scratch
    block's writes from an inactive row included) within 1e-5."""
    jcfg, tcfg = _configs(variant)
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(3))
    tp = _tree(jp)
    nb, bs = 12, 4
    rng = np.random.default_rng(1)
    jpool = {name: {part: jnp.asarray(rng.normal(size=a.shape).astype(
        np.float32)) for part, a in lc.items()}
        for name, lc in jpd.init_paged_pool(jcfg, nb, bs).items()}
    tpool = {name: {part: torch.from_numpy(np.array(a))
                    for part, a in lc.items()}
             for name, lc in jpool.items()}
    # three rows on disjoint tables of 3 blocks, the last row inactive
    # (a table of zeros at position 0: the scratch sink)
    tables = np.asarray([[3, 7, 1], [5, 2, 9], [0, 0, 0]], np.int32)
    pos0 = np.asarray([5, 2, 0], np.int32)
    block = _tokens(2, (3, 4))
    jl, jpool = _jblock_paged(jp, jpool, jnp.asarray(tables),
                              jnp.asarray(block), jnp.asarray(pos0), jcfg)
    tl, tpool = tpd.decode_block_paged(tp, tpool, torch.from_numpy(tables),
                                       torch.from_numpy(block),
                                       torch.from_numpy(pos0), tcfg)
    np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2],
                               atol=1e-5, rtol=0)
    for name, lc in jpool.items():
        for part in ("k", "v"):
            np.testing.assert_allclose(tpool[name][part].numpy(),
                                       np.asarray(lc[part]), atol=1e-5,
                                       rtol=0)


def test_decode_block_paged_equals_the_contiguous_block(models):
    """Rows laid over scattered blocks give the contiguous
    ``decode_block``'s logits at the same per-row positions."""
    tp, tcfg = models["tp"], models["tcfg"]
    prompt = _tokens(4, (2, 7))
    _, cache = ttr.prefill_cache(tp, torch.from_numpy(prompt), tcfg, 16)
    tables = np.asarray([[6, 2, 9, 4], [1, 8, 3, 5]], np.int32)
    pool = tpd.init_paged_pool(tcfg, 10, 4, device="cpu")
    for b in range(2):
        tpd.install_row_paged(pool, {n: {p: t[b:b + 1]
                                         for p, t in lc.items()}
                                     for n, lc in cache.items()},
                              tables[b], 4)
    pos0 = torch.as_tensor([7, 5])
    block = torch.from_numpy(_tokens(5, (2, 3)))
    want, _ = ttr.decode_block(tp, cache, block, pos0, tcfg)
    got, _ = tpd.decode_block_paged(tp, pool, torch.from_numpy(tables),
                                    block, pos0, tcfg)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


# ------------------------------------------------------ greedy decode
@pytest.mark.parametrize("draft", ["target", "random", "first_layer"])
def test_speculative_generate_matches_jax(models, jax_spec, draft):
    """Greedy tokens equal both packages' ``generate`` (tie-aware), and
    the round count and acceptance equal the JAX package's."""
    _, _, td, tdc = models["drafts"][draft]
    prompt = jax_spec["prompt"]
    toks, stats = tsp.speculative_generate(
        models["tp"], td, prompt, _NEW, models["tcfg"], tdc, gamma=_GAMMA,
        return_stats=True)
    want_toks, want = jax_spec[draft]
    jp, jcfg = models["jp"], models["jcfg"]
    tgen = ttr.generate(models["tp"], prompt, _NEW, models["tcfg"])
    _assert_tie_aware(jp, jcfg, prompt, jax_spec["generate"], toks.numpy())
    _assert_tie_aware(jp, jcfg, prompt, tgen.numpy(), toks.numpy())
    _assert_tie_aware(jp, jcfg, prompt, want_toks, toks.numpy())
    assert stats["rounds"] == want["rounds"]
    assert stats["draft_acceptance"] == pytest.approx(
        want["draft_acceptance"], abs=1e-12)
    if draft == "target":
        assert stats["draft_acceptance"] == 1.0
        assert stats["rounds"] == -(-(_NEW - 1) // (_GAMMA + 1))


def test_speculative_round_paged_equals_the_contiguous_round(models):
    """One greedy round over per-row block tables gives the contiguous
    round's emitted tokens, acceptance and next tokens, and writes the
    same k/v into the rows' blocks."""
    tp, tcfg = models["tp"], models["tcfg"]
    _, _, td, tdc = models["drafts"]["first_layer"]
    prompt = torch.from_numpy(_tokens(6, (2, 9)))
    length, bs = 20, 4
    t_logits, t_cache = ttr.prefill_cache(tp, prompt, tcfg, length)
    _, d_cache = ttr.prefill_cache(td, prompt, tdc, length)
    tables = np.asarray([[4, 9, 1, 7, 12], [2, 11, 6, 3, 10]], np.int32)
    pool = tpd.init_paged_pool(tcfg, 13, bs, device="cpu")
    for b in range(2):
        tpd.install_row_paged(pool, {n: {p: t[b:b + 1]
                                         for p, t in lc.items()}
                                     for n, lc in t_cache.items()},
                              tables[b], 3)
    d_cache2 = {n: {p: t.clone() for p, t in lc.items()}
                for n, lc in d_cache.items()}
    last = torch.argmax(t_logits, dim=-1)
    pos = torch.as_tensor([9, 9])
    args = (4, tcfg, tdc, 1.0, None, True)
    emit, a, nxt, t_cache, _, _ = tsp.speculative_round(
        tp, td, t_cache, d_cache, last, pos, *args)
    emit_p, a_p, nxt_p, pool, _, _ = tsp.speculative_round_paged(
        tp, td, pool, torch.from_numpy(tables), d_cache2, last, pos, *args)
    assert torch.equal(emit_p, emit) and torch.equal(a_p, a)
    assert torch.equal(nxt_p, nxt)
    for name, lc in pool.items():
        for b in range(2):
            got = lc["k"][torch.from_numpy(tables[b]).long()].transpose(
                0, 1).reshape(tcfg.kv_heads, -1, tcfg.head_dim)[:, :14]
            torch.testing.assert_close(got, t_cache[name]["k"][b, :, :14],
                                       atol=1e-6, rtol=0)


def test_speculative_generate_validation(models):
    tp, tcfg = models["tp"], models["tcfg"]
    prompt = _tokens(0, _PROMPT_SHAPE)
    small = ttr.TransformerConfig(**{**_BASE, "vocab_size": 32},
                                  dtype=torch.float32)
    with pytest.raises(ValueError, match="vocab"):
        tsp.speculative_generate(tp, tp, prompt, 4, tcfg, small)
    with pytest.raises(ValueError, match="gamma"):
        tsp.speculative_generate(tp, tp, prompt, 4, tcfg, tcfg, gamma=0)
    with pytest.raises(ValueError, match="max_seq_len"):
        tsp.speculative_generate(tp, tp, prompt, 32, tcfg, tcfg, gamma=3)
    with pytest.raises(ValueError, match="Generator"):
        tsp.speculative_generate(tp, tp, prompt, 4, tcfg, tcfg,
                                 temperature=1.0)


# ------------------------------------------------------------ sampling
def test_sampling_with_the_target_as_draft_accepts_everything(models):
    tp, tcfg = models["tp"], models["tcfg"]
    key = torch.Generator().manual_seed(0)
    toks, stats = tsp.speculative_generate(
        tp, tp, _tokens(0, _PROMPT_SHAPE), _NEW, tcfg, tcfg, gamma=4,
        temperature=0.8, key=key, return_stats=True)
    assert stats["draft_acceptance"] == 1.0
    assert toks.shape == (3, _NEW)
    assert int(toks.min()) >= 0 and int(toks.max()) < 64


def _chi2(counts, probs):
    expected = probs * counts.sum()
    return float(((counts - expected) ** 2 / expected).sum())


def test_speculative_sampling_follows_the_target_distribution():
    """At vocab 8, 40,000 rows of one prompt sample two tokens through
    the rejection rule (gamma 2, a different draft): the joint counts of
    (first, second) token meet the target's own p(t0) p(t1 | t0) by
    chi-square over 64 cells (99.99th percentile of chi2(63) = 117) and
    miss the draft's by far."""
    kw = dict(vocab_size=8, num_layers=1, num_heads=2, d_model=16,
              d_ff=32, max_seq_len=16, dtype=torch.float32)
    cfg = ttr.TransformerConfig(**kw)
    tp = ttr.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    dp = ttr.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    for params, scale in ((tp, 6.0), (dp, 4.0)):
        # peakier distributions than the near-uniform initial ones
        params["embed"]["tokens"].mul_(scale)
    prompt = np.asarray([[3, 1, 4, 1]])
    n = 40000
    key = torch.Generator().manual_seed(0)
    toks = tsp.speculative_generate(tp, dp, np.repeat(prompt, n, axis=0),
                                    2, cfg, cfg, gamma=2, temperature=1.0,
                                    key=key).numpy()
    counts = np.bincount(toks[:, 0] * 8 + toks[:, 1],
                         minlength=64).astype(np.float64)

    def joint(params):
        p0 = torch.softmax(ttr.forward(params, torch.as_tensor(prompt),
                                       cfg)[0, -1], -1)
        ctx = torch.cat([torch.as_tensor(prompt).repeat(8, 1),
                         torch.arange(8)[:, None]], dim=1)
        p1 = torch.softmax(ttr.forward(params, ctx, cfg)[:, -1], -1)
        return (p0[:, None] * p1).reshape(-1).double().numpy()

    assert _chi2(counts, joint(tp)) < 117.0
    assert _chi2(counts, joint(dp)) > 1000.0


# ------------------------------------------------------- distillation
@pytest.fixture(scope="module")
def distill_case(models):
    """The JAX package's distill loss, gradient and three SGD steps."""
    jp, jcfg = models["jp"], models["jcfg"]
    jd, jdc, _, _ = models["drafts"]["random"]
    tokens = _tokens(8, (4, 13))
    kw = dict(temperature=2.0, hard_weight=0.1)
    loss, grads = jax.jit(jax.value_and_grad(jdi.distill_loss),
                          static_argnums=(3, 4, 5, 6))(
        jd, jp, jnp.asarray(tokens), jdc, jcfg, kw["temperature"],
        kw["hard_weight"])
    jo = jopt.SGD(0.5, momentum=0.9)
    tx = jo.to_optax()
    step = jdi.make_distill_step(jdc, jcfg, tx, **kw)
    params, opt, losses = jd, tx.init(jd), []
    for i in range(3):
        params, opt, l = step(params, jp, opt,
                              jnp.asarray(_tokens(20 + i, (4, 13))))
        losses.append(float(l))
    return dict(tokens=tokens, kw=kw, loss=float(loss), grads=grads,
                opt=jo, params=params, losses=losses)


def test_distill_loss_and_gradient_match_jax(models, distill_case):
    _, _, td, tdc = models["drafts"]["random"]
    loss, grads = ttr.value_and_grads(
        lambda d: tdi.distill_loss(d, models["tp"],
                                   torch.from_numpy(distill_case["tokens"]),
                                   tdc, models["tcfg"], **distill_case["kw"]),
        td)
    assert abs(float(loss) - distill_case["loss"]) <= 1e-5
    value = tdi.distill_loss(td, models["tp"],
                             torch.from_numpy(distill_case["tokens"]), tdc,
                             models["tcfg"], **distill_case["kw"])
    assert abs(float(value) - float(loss)) <= 1e-6
    want = jax.tree_util.tree_leaves(distill_case["grads"])
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


def test_make_distill_step_matches_jax(models, distill_case):
    """Three steps of SGD with momentum: the losses and the draft's
    weights within 1e-5; the target is left as it was."""
    jd, _, _, tdc = models["drafts"]["random"]
    draft = _tree(jd)
    target_before = [t.clone() for t in tree_leaves(models["tp"])]
    ttx = topt.deserialize(jopt.serialize(distill_case["opt"])).to_transform()
    step = tdi.make_distill_step(tdc, models["tcfg"], ttx,
                                 **distill_case["kw"])
    opt = ttx.init(draft)
    for i in range(3):
        out, opt, loss = step(draft, models["tp"], opt,
                              torch.from_numpy(_tokens(20 + i, (4, 13))))
        assert out is draft                  # updated in place
        assert abs(float(loss) - distill_case["losses"][i]) <= 1e-5
    for a, b in zip(jax.tree_util.tree_leaves(distill_case["params"]),
                    tree_leaves(draft)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5,
                                   rtol=0)
    for a, b in zip(target_before, tree_leaves(models["tp"])):
        assert torch.equal(a, b)


def test_a_draft_crosses_the_weight_bridge_both_ways(models):
    """A 1-layer draft's tree goes JAX -> port -> JAX unchanged."""
    jd, _, td, _ = models["drafts"]["random"]
    back = to_numpy_tree(td)
    for a, b in zip(jax.tree_util.tree_leaves(jd),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(b, np.asarray(a))
