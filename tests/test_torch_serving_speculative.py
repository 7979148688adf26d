"""The port's contiguous ``DecodeEngine`` with a draft against the JAX
package's.

Identical weights through the bridge and the same numpy-seeded requests
(``tests/torch_speculative_parity.py``); each JAX engine runs once per
module in a fixture (its loop profiler off, so its interleaving budget
is the port's one chunk a step). Contiguous engines with a draft,
adaptive gamma off and on, 6 requests through 2 slots: every output
equals solo ``generate``, and the engine's accepted/proposed counts,
slot-rounds, per-request counts and the gamma after every step equal
the JAX engine's. A paged speculative engine over the block cache and a
registered prefix equals solo ``generate``, and the engine's refusals
name their ROADMAP step. The paged engines with a draft are in
``test_torch_serving_speculative_paged.py``, the interleaved engines in
``test_torch_serving_interleave.py``, the model-level surface in
``test_torch_serving_decode_surface.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from elephas_tpu_torch.models import transformer as ttr
from elephas_tpu_torch.serving_engine import DecodeEngine
from tests.torch_speculative_parity import (check_speculative_engine,
                                            jax_engine_runs, models,
                                            one_thread)

@pytest.fixture(scope="module")
def jax_engines(models):
    """The JAX engines' outputs and counters, once per module."""
    return jax_engine_runs(models, "contiguous")


@pytest.mark.parametrize("adaptive", [False, True],
                         ids=["fixed_gamma", "adaptive_gamma"])
@pytest.mark.parametrize("layout", ["contiguous"])
def test_speculative_engine_matches_jax(models, jax_engines, layout,
                                        adaptive):
    check_speculative_engine(models, jax_engines, layout, adaptive)


def test_speculative_engine_with_prefix_cache_and_prefix(models):
    """A paged speculative engine whose admissions hit the block cache
    and a registered prefix (the draft prefills its whole prompt on every
    admission) still equals solo ``generate``, warmed up first; the
    verify slack is part of every capacity rule."""
    m = models
    rng = np.random.default_rng(3)
    system = rng.integers(0, 64, 8).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(0, 64, n)]).astype(
        np.int32) for n in (3, 6, 3, 9)]
    eng = DecodeEngine(m["tp"], m["tcfg"], max_slots=2, max_len=32,
                       draft_params=m["td"], draft_config=m["tdc"], gamma=3,
                       paged=(40, 4), prefill_chunk=4, device="cpu")
    eng.warmup(prompt_lengths=[11])
    eng.register_prefix(system)
    outs = eng.run(prompts, 8)
    for p, o in zip(prompts, outs):
        assert o == ttr.generate(m["tp"], p[None], 8, m["tcfg"])[0].tolist()
    assert eng.stats["prefix_tokens_reused"] > 0
    with pytest.raises(ValueError, match="gamma"):
        eng.submit(np.zeros(20, np.int32), 10)     # 20 + 10 + 3 > 32
    with pytest.raises(ValueError, match="blocks"):
        DecodeEngine(m["tp"], m["tcfg"], max_slots=1, max_len=32,
                     draft_params=m["td"], draft_config=m["tdc"], gamma=4,
                     paged=(8, 4), device="cpu").submit(
            np.zeros(20, np.int32), 8)             # 8 blocks > 7


def test_engine_refusals(models):
    m = models
    spec = dict(draft_params=m["td"], draft_config=m["tdc"], device="cpu")
    with pytest.raises(ValueError, match="go together"):
        DecodeEngine(m["tp"], m["tcfg"], draft_params=m["td"], device="cpu")
    with pytest.raises(ValueError, match="steps_per_sync"):
        DecodeEngine(m["tp"], m["tcfg"], steps_per_sync=2, **spec)
    with pytest.raises(ValueError, match="gamma_min"):
        DecodeEngine(m["tp"], m["tcfg"], gamma=2, gamma_min=3, **spec)
    with pytest.raises(ValueError, match="adaptive_gamma requires"):
        DecodeEngine(m["tp"], m["tcfg"], adaptive_gamma=True, device="cpu")
    with pytest.raises(ValueError, match="requires prefill_chunk"):
        DecodeEngine(m["tp"], m["tcfg"], interleave_prefill=True,
                     device="cpu")
    eng = DecodeEngine(m["tp"], m["tcfg"], max_slots=1, **spec)
    with pytest.raises(NotImplementedError, match="step 6"):
        eng.stage_draft_params(m["td"], 1)
    with pytest.raises(NotImplementedError, match="step 9"):
        DecodeEngine(m["tp"], m["tcfg"], registry=object(), **spec)
    assert eng.stats["draft_acceptance"] is None
