"""The port's ``DecodeEngine`` under the JAX package's defaults.

The contiguous cache (``paged=None``) and the options layered on it:
``steps_per_sync``, ``prefill_chunk``, ``register_prefix`` and the
automatic prefix cache (host blocks on a contiguous engine, pool blocks
in paged mode). Identical weights through the bridge at the small size
(2 layers, d_model 32, vocab 64, max_seq_len 32, f32), identical
numpy-seeded schedules (two slots, staggered admission, prompts sharing
a 6-token system head): each configuration's greedy tokens equal the
JAX ``DecodeEngine``'s under the same configuration and each request's
solo ``generate``, tie-aware (a divergence only at a top-2 logit gap
below 1e-3). Also: ``cancel``, the bounded queue's ``QueueFullError``,
``warmup`` on an idle and a busy engine, and every argument of a later
step raising ``NotImplementedError`` with its step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from elephas_tpu.models.transformer import \
    TransformerConfig as JaxConfig
from elephas_tpu.models.transformer import init_params as jax_init
from elephas_tpu.serving_engine import DecodeEngine as JaxEngine
from elephas_tpu_torch.models.transformer import (TransformerConfig,
                                                  forward, generate)
from elephas_tpu_torch.serving_engine import DecodeEngine, QueueFullError
from elephas_tpu_torch.weights import from_numpy_tree
from tests.torch_one_thread import one_thread

_CFG = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
            max_seq_len=32)
_RNG = np.random.default_rng(11)
_SYSTEM = _RNG.integers(0, 64, 6).tolist()
_PROMPTS = ([_SYSTEM + _RNG.integers(0, 64, n).tolist() for n in (3, 9)]
            + [_RNG.integers(0, 64, 5).tolist(),
               _SYSTEM + _RNG.integers(0, 64, 2).tolist(), list(_SYSTEM)])
_MAX_NEW = (8, 6, 9, 5, 7)

#: configuration -> (engine kwargs, register the system prefix)
_CONFIGS = {
    "default": ({}, False),
    "steps_per_sync_3": (dict(steps_per_sync=3), False),
    "prefill_chunk": (dict(prefill_chunk=4), False),
    "register_prefix": ({}, True),
    # enable_prefix_cache() on a contiguous engine (host blocks of 4)
    "prefix_cache_contiguous": ({}, True),
    "prefix_cache_paged": (dict(paged=(24, 4)), True),
    "all_paged": (dict(paged=(24, 4), steps_per_sync=3, prefill_chunk=4),
                  True),
}


@pytest.fixture(scope="module")
def model():
    jcfg = JaxConfig(dtype=jnp.float32, **_CFG)
    tcfg = TransformerConfig(dtype=torch.float32, **_CFG)
    jp = jax_init(jcfg, jax.random.PRNGKey(4))
    tp = from_numpy_tree(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    return jp, jcfg, tp, tcfg


@pytest.fixture(scope="module")
def solo(model):
    """Each request's solo greedy ``generate`` in the port."""
    _, _, tp, tcfg = model
    return [generate(tp, [p], n, tcfg)[0].tolist()
            for p, n in zip(_PROMPTS, _MAX_NEW)]


def _drive(eng, register=False, enable_cache=False):
    """Two requests, two steps, then the rest; tokens streamed by
    ``step`` are collected per request."""
    if enable_cache:
        eng.enable_prefix_cache(block_size=4)
    if register:
        eng.register_prefix(_SYSTEM)
    streamed = {}

    def step():
        for rid, toks in eng.step().items():
            streamed.setdefault(rid, []).extend(toks)

    rids = [eng.submit(p, n) for p, n in zip(_PROMPTS[:2], _MAX_NEW[:2])]
    step()
    step()
    rids += [eng.submit(p, n) for p, n in zip(_PROMPTS[2:], _MAX_NEW[2:])]
    while eng.pending:
        step()
    outs = [eng.result(r) for r in rids]
    assert [streamed.get(r, []) for r in rids] == outs
    return outs


def _assert_tie_aware(tp, tcfg, ref, out):
    for p, r, o in zip(_PROMPTS, ref, out):
        if r == o:
            continue
        i = next((j for j, (a, b) in enumerate(zip(r, o)) if a != b),
                 min(len(r), len(o)))
        top2 = forward(tp, torch.as_tensor([p + r[:i]]), tcfg)[0, -1].topk(2)
        gap = float(top2.values[0] - top2.values[1])
        assert gap < 1e-3, (i, r, o, gap)


@pytest.mark.parametrize("name", list(_CONFIGS))
def test_greedy_tokens_match_jax_engine_and_solo_generate(model, solo,
                                                          name):
    jp, jcfg, tp, tcfg = model
    kwargs, register = _CONFIGS[name]
    enable = name == "prefix_cache_contiguous"
    eng = DecodeEngine(tp, tcfg, max_slots=2, device="cpu", **kwargs)
    outs = _drive(eng, register, enable)
    ref = _drive(JaxEngine(jp, jcfg, max_slots=2, **kwargs), register,
                 enable)
    _assert_tie_aware(tp, tcfg, ref, outs)
    _assert_tie_aware(tp, tcfg, solo, outs)
    stats = eng.stats
    assert stats["requests_finished"] == len(_PROMPTS)
    assert stats["tokens_emitted"] == sum(map(len, outs))
    assert stats["tokens_per_step"] == stats["tokens_emitted"] / stats["steps"]
    # K decode steps per step(): the 35 tokens take 17 steps at K = 1
    assert stats["steps"] <= 17 // kwargs.get("steps_per_sync", 1) + 3
    if register:
        # three prompts share the system head's full blocks or its row
        assert stats["prefix_tokens_reused"] >= 3 * 4
    if enable:
        assert stats["kv_cache"]["block_size"] == 4
    if "paged" in kwargs:
        # only the pinned prefix block stays out of the allocatable count
        assert stats["blocks_free"] == kwargs["paged"][0] - 2
        assert stats["kv_cache"]["pinned_blocks"] == 1


def test_contiguous_is_the_default(model):
    _, _, tp, tcfg = model
    eng = DecodeEngine(tp, tcfg, max_slots=2, device="cpu")
    assert eng.paged is None and eng.pool is None
    assert eng.cache["layer_0"]["k"].shape == (2, 4, 32, 8)
    assert "prefix_hits" not in eng.stats
    with pytest.raises(ValueError, match="paged"):
        DecodeEngine(tp, tcfg, kernel="fused", device="cpu")


def test_steps_per_sync_trims_eos_and_budget(model, solo):
    """Slots that finish mid-chunk drop their surplus; an eos the run
    emits cuts its request short in both sync widths alike."""
    _, _, tp, tcfg = model
    eos = solo[1][2]

    def run(k):
        eng = DecodeEngine(tp, tcfg, max_slots=2, steps_per_sync=k,
                           eos_id=eos, device="cpu")
        return _drive(eng), eng.stats

    one, _ = run(1)
    four, stats = run(4)
    assert four == one
    assert any(len(o) < n for o, n in zip(one, _MAX_NEW))
    assert stats["tokens_emitted"] == sum(map(len, four))


def test_cancel_queued_and_active(model, solo):
    _, _, tp, tcfg = model
    for paged in (None, (24, 4)):
        eng = DecodeEngine(tp, tcfg, max_slots=2, paged=paged, device="cpu")
        rids = [eng.submit(p, n) for p, n in zip(_PROMPTS[:3], _MAX_NEW)]
        eng.step()
        assert eng.cancel(rids[2])          # still queued
        assert eng.cancel(rids[0])          # decoding
        assert not eng.cancel(rids[0]) and not eng.cancel(99)
        while eng.pending:
            eng.step()
        assert eng.result(rids[0]) is None and eng.result(rids[2]) is None
        assert eng.result(rids[1]) == solo[1]
        assert eng.stats["queued_tokens"] == 0
        if paged:
            assert eng.stats["blocks_free"] == paged[0] - 1


def test_queue_bounds_raise_queue_full(model):
    _, _, tp, tcfg = model
    eng = DecodeEngine(tp, tcfg, max_slots=1, max_queue=1, device="cpu")
    eng.submit(_PROMPTS[0], 4, admit=False)
    with pytest.raises(QueueFullError) as err:
        eng.submit(_PROMPTS[1], 4, admit=False)
    assert 50 <= err.value.retry_after_ms <= 10000
    assert eng.stats["requests_shed"] == 1
    eng = DecodeEngine(tp, tcfg, max_slots=1, max_queued_tokens=12,
                       device="cpu")
    eng.submit(_PROMPTS[0], 4, admit=False)         # 9 tokens queued
    with pytest.raises(QueueFullError, match="max_queued_tokens"):
        eng.submit(_PROMPTS[2], 4, admit=False)     # 5 more
    with pytest.raises(ValueError, match="never"):
        eng.submit(_PROMPTS[1], 4)                  # 15 > 12, ever
    while eng.pending:
        eng.step()
    assert eng.stats["queue_depth"] == 0


@pytest.mark.parametrize("kwargs", [{}, dict(paged=(24, 4), prefill_chunk=4,
                                             steps_per_sync=2)],
                         ids=["contiguous", "paged"])
def test_warmup_idle_then_busy(model, solo, kwargs):
    _, _, tp, tcfg = model
    eng = DecodeEngine(tp, tcfg, max_slots=2, device="cpu", **kwargs)
    eng.warmup(prompt_lengths=(5, 11))
    with pytest.raises(ValueError, match="out of range"):
        eng.warmup(prompt_lengths=(32,))
    assert _drive(eng) == solo
    eng.submit(_PROMPTS[0], 3)
    with pytest.raises(RuntimeError, match="idle"):
        eng.warmup()


@pytest.mark.parametrize("kwargs,step", [
    (dict(qos={}), 7), (dict(clock=lambda: 0.0), 7),
    (dict(kv_spill=True), 8), (dict(session_store=True), 8),
    (dict(tier="decode"), 8), (dict(registry=object()), 9),
    (dict(profiler=True), 9)],
    ids=["qos", "clock", "kv_spill", "session_store", "tier", "registry",
         "profiler"])
def test_later_arguments_raise_with_their_step(model, kwargs, step):
    _, _, tp, tcfg = model
    with pytest.raises(NotImplementedError, match=f"item 1, step {step}"):
        DecodeEngine(tp, tcfg, device="cpu", **kwargs)


@pytest.mark.parametrize("field,step", [("deadline_ms", 7), ("tenant", 7),
                                        ("priority", 7), ("seed", 7),
                                        ("resume_from", 8), ("session", 8)])
def test_later_submit_fields_raise_with_their_step(model, field, step):
    _, _, tp, tcfg = model
    eng = DecodeEngine(tp, tcfg, device="cpu")
    with pytest.raises(NotImplementedError, match=f"step {step}"):
        eng.submit(_PROMPTS[0], 2, **{field: 1})
    with pytest.raises(TypeError):
        eng.submit(_PROMPTS[0], 2, bogus=1)
    assert not eng.pending
