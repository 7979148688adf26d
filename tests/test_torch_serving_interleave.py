"""The port's ``interleave_prefill`` engines against the JAX package's.

Identical weights through the bridge (``tests/torch_speculative_parity.py``);
the JAX engines run once per module in a fixture (their loop profiler
off, so their interleaving budget is the port's one chunk a step).
Contiguous, and paged with its prefix cache, 6 requests of up to 30
prompt tokens through 2 slots: the outputs, chunk counts and steps
equal the JAX engine's, and the outputs equal solo ``generate``. A
speculative paged engine interleaving its prefills equals solo
``generate``, and cancelling a request mid-prefill frees its slot and
blocks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from elephas_tpu.serving_engine import DecodeEngine as JEngine
from elephas_tpu_torch.models import transformer as ttr
from elephas_tpu_torch.serving_engine import DecodeEngine
from tests.torch_speculative_parity import models, one_thread

_INTERLEAVE = {"contiguous": None, "paged_prefix_cache": (64, 4)}
_LONG = (5, 30, 22, 8, 30, 13)


@pytest.fixture(scope="module")
def interleave_case(models):
    m = models
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 64, n).astype(np.int32) for n in _LONG]
    jax_out = {}
    for name, paged in _INTERLEAVE.items():
        eng = JEngine(m["jp"], m["jcfg"], max_slots=2, prefill_chunk=8,
                      interleave_prefill=True, paged=paged, profiler=False)
        outs = eng.run(prompts, 8)
        jax_out[name] = (outs, eng.stats)
    solo = [ttr.generate(m["tp"], p[None], 8, m["tcfg"])[0].tolist()
            for p in prompts]
    return prompts, jax_out, solo


@pytest.mark.parametrize("layout", sorted(_INTERLEAVE))
def test_interleave_prefill_matches_jax(models, interleave_case, layout):
    m = models
    prompts, jax_out, solo = interleave_case
    eng = DecodeEngine(m["tp"], m["tcfg"], max_slots=2, prefill_chunk=8,
                       interleave_prefill=True, paged=_INTERLEAVE[layout],
                       device="cpu")
    outs = eng.run(prompts, 8)
    want, jstats = jax_out[layout]
    assert outs == solo
    assert outs == want
    stats = eng.stats
    assert stats["prefill_chunks_interleaved"] > 0
    for key in ("prefill_chunks_interleaved", "pending_prefills", "steps",
                "tokens_emitted"):
        assert stats[key] == jstats[key], key


def test_interleaved_prefill_with_a_draft_and_cancel(models):
    """A speculative paged engine interleaving its prefills equals solo
    ``generate``; cancelling a request mid-prefill frees its slot and
    blocks."""
    m = models
    prompts = [np.random.default_rng(5).integers(0, 64, n).astype(np.int32)
               for n in (5, 20, 17)]
    eng = DecodeEngine(m["tp"], m["tcfg"], max_slots=2, max_len=40,
                       draft_params=m["td"], draft_config=m["tdc"], gamma=3,
                       paged=(40, 4), prefill_chunk=4,
                       interleave_prefill=True, prefix_cache=False,
                       device="cpu")
    assert eng.run(prompts, 6) == [
        ttr.generate(m["tp"], p[None], 6, m["tcfg"])[0].tolist()
        for p in prompts]
    free = eng.stats["blocks_free"]
    first = eng.submit(prompts[0], 6)
    eng.step()
    victim = eng.submit(prompts[1], 6)
    eng.step()
    assert eng.stats["pending_prefills"] == 1
    assert eng.cancel(victim)
    assert eng.stats["pending_prefills"] == 0
    while eng.pending:
        eng.step()
    assert eng.result(first) is not None and eng.result(victim) is None
    assert eng.stats["blocks_free"] == free
