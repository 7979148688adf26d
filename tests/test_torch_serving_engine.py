"""The port's paged ``DecodeEngine`` against the JAX package's.

Identical weights through the bridge, identical request schedules
(ragged prompts, staggered admission, an eos id, pools small enough
that admission queues): the port's engine with the fused kernel's path
(its plain version on the CPU) emits exactly the JAX engine's greedy
tokens, where the JAX engine runs its Pallas paged kernel in interpret
mode. f32 compute, so greedy argmax is deterministic on both sides.
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
from elephas_tpu.serving_engine import \
    _filter_logits_rows as jax_filter
from elephas_tpu_torch.models.transformer import TransformerConfig
from elephas_tpu_torch.serving_engine import (DecodeEngine,
                                              _filter_logits_rows)
from elephas_tpu_torch.weights import from_numpy_tree

_CFG = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
            max_seq_len=48, num_kv_heads=2)
_PROMPTS = [np.random.default_rng(50 + i).integers(0, 64, n).tolist()
            for i, n in enumerate((3, 9, 14, 6, 11))]
_MAX_NEW = (8, 6, 8, 5, 7)


@pytest.fixture(scope="module")
def model():
    jcfg = JaxConfig(dtype=jnp.float32, **_CFG)
    tcfg = TransformerConfig(dtype=torch.float32, **_CFG)
    jp = jax_init(jcfg, jax.random.PRNGKey(2))
    tp = from_numpy_tree(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    return jp, jcfg, tp, tcfg


def _drive(eng):
    """Staggered admission: two requests, two steps, then the rest; the
    streamed tokens are collected per request."""
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
    return [eng.result(r) for r in rids], [streamed.get(r, []) for r in rids]


def _port(model, paged, eos_id=None, kernel="fused"):
    _, _, tp, tcfg = model
    eng = DecodeEngine(tp, tcfg, max_slots=2, paged=paged, kernel=kernel,
                       eos_id=eos_id, device="cpu")
    outs, streamed = _drive(eng)
    return eng, outs, streamed


@pytest.mark.parametrize("paged", [(24, 8), (6, 8)])
def test_greedy_tokens_match_jax_engine(model, paged):
    jp, jcfg, _, _ = model
    # an eos id the run really emits mid-request
    _, free_run, _ = _port(model, paged)
    eos = free_run[1][2]
    eng, outs, streamed = _port(model, paged, eos_id=eos)
    jeng = JaxEngine(jp, jcfg, max_slots=2, paged=paged, eos_id=eos,
                     prefix_cache=False, kernel="pallas",
                     kernel_interpret=True)
    ref, ref_streamed = _drive(jeng)
    assert outs == ref
    assert streamed == ref_streamed == outs
    assert any(len(o) < n for o, n in zip(outs, _MAX_NEW))   # eos hit
    # every block is back on the free list; tables point at the sink
    assert sorted(eng._free_block_ids) == list(range(1, paged[0]))
    assert not eng._tables.any()
    assert eng.stats["blocks_free"] == paged[0] - 1
    assert eng.stats["requests_finished"] == len(_PROMPTS)


def test_small_pool_queues_admission(model):
    """With 5 allocatable blocks a second request must wait for the
    first one's blocks, though a slot is free."""
    _, _, tp, tcfg = model
    eng = DecodeEngine(tp, tcfg, max_slots=2, paged=(6, 8), kernel="fused",
                       device="cpu")
    eng.submit(_PROMPTS[2], 8)          # 22 positions: 3 blocks
    eng.submit(_PROMPTS[4], 7)          # 18 positions: 3 blocks
    assert eng.stats["queue_depth"] == 1
    assert eng.stats["blocks_free"] == 2
    while eng.pending:
        eng.step()
    assert eng.stats["blocks_free"] == 5


def test_gather_and_fused_agree(model):
    _, gather, _ = _port(model, (24, 8), kernel="gather")
    eng, fused, _ = _port(model, (24, 8), kernel="fused")
    assert fused == gather
    stats = eng.stats
    assert stats["kernel"] == "fused"
    assert stats["kernel_launches"] == 0        # CPU: the plain version
    assert stats["tokens_emitted"] == sum(len(o) for o in fused)


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (3, 1.0), (0, 0.7),
                                         (5, 0.5), (1, 0.9)])
def test_filter_logits_rows_matches_jax(top_k, top_p):
    logits = np.random.default_rng(8).standard_normal((3, 64)).astype(
        np.float32)
    k = np.asarray([top_k, 0, 2], np.int32)
    p = np.asarray([top_p, 0.3, 1.0], np.float32)
    ref = np.asarray(jax_filter(jnp.asarray(logits), jnp.asarray(k),
                                jnp.asarray(p)))
    out = _filter_logits_rows(torch.from_numpy(logits), torch.from_numpy(k),
                              torch.from_numpy(p))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_sampling_is_seeded_and_top_k_1_is_greedy(model):
    _, _, tp, tcfg = model

    def run(seed, **kw):
        eng = DecodeEngine(tp, tcfg, max_slots=2, paged=(24, 8),
                           temperature=1.0, seed=seed, device="cpu")
        rids = [eng.submit(p, 6, **kw) for p in _PROMPTS[:3]]
        while eng.pending:
            eng.step()
        return [eng.result(r) for r in rids]

    assert run(3) == run(3)
    _, greedy, _ = _port(model, (24, 8))
    top1 = run(4, top_k=1)
    assert top1 == [g[:6] for g in greedy[:3]]


def test_rejects_what_could_never_run(model):
    _, _, tp, tcfg = model
    with pytest.raises(NotImplementedError):
        DecodeEngine(tp, tcfg, device="cpu")
    with pytest.raises(ValueError, match="kernel"):
        DecodeEngine(tp, tcfg, paged=(8, 8), kernel="pallas", device="cpu")
    eng = DecodeEngine(tp, tcfg, paged=(4, 8), device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.submit([1] * 40, 10)
    with pytest.raises(ValueError, match="blocks"):
        eng.submit([1] * 20, 10)
    with pytest.raises(ValueError, match="top_p"):
        eng.submit([1], 2, top_p=0.0)
