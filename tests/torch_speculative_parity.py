"""Shared pieces of the port's speculative and interleaved serving
parity tests (``test_torch_serving_speculative.py`` and
``test_torch_serving_speculative_paged.py``, one engine layout each,
``test_torch_serving_interleave.py`` and
``test_torch_serving_decode_surface.py``).

Identical weights through the bridge: a 2-layer target, d_model 32, 4
heads, vocab 64, f32, drawn by the JAX initializer; the draft is the
target's own first layer, so it agrees with the target part of the
time. The requests are drawn with numpy from a seed, and solo
``generate`` on the port gives every test its oracle.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elephas_tpu.models import transformer as jtr
from elephas_tpu.serving_engine import DecodeEngine as JEngine
from elephas_tpu_torch.models import transformer as ttr
from elephas_tpu_torch.serving_engine import DecodeEngine
from elephas_tpu_torch.weights import from_numpy_tree
from tests.torch_one_thread import one_thread  # the test modules' fixture

BASE = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
            max_seq_len=48)
NEW = 10
# two prompt lengths (the JAX engine compiles one prefill per length)
LENGTHS = (5, 9, 5, 9, 9, 5)
# the engines' cache layouts: contiguous, and paged (blocks, block size)
SPEC = {"contiguous": None, "paged": (48, 4)}


def tree(jp):
    """A JAX parameter tree as the port's, on the CPU."""
    return from_numpy_tree(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")


@pytest.fixture(scope="module")
def models():
    """The target and draft in both packages, the requests, and solo
    ``generate``'s outputs for them."""
    jcfg = jtr.TransformerConfig(dtype=jnp.float32, **BASE)
    tcfg = ttr.TransformerConfig(dtype=torch.float32, **BASE)
    jdc = jtr.TransformerConfig(dtype=jnp.float32,
                                **{**BASE, "num_layers": 1})
    tdc = ttr.TransformerConfig(dtype=torch.float32,
                                **{**BASE, "num_layers": 1})
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    jd = {k: v for k, v in jp.items() if k != "layer_1"}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 64, n).astype(np.int32) for n in LENGTHS]
    tp = tree(jp)
    solo = [ttr.generate(tp, p[None], NEW, tcfg)[0].tolist()
            for p in prompts]
    return dict(jp=jp, jcfg=jcfg, jd=jd, jdc=jdc, tp=tp, tcfg=tcfg,
                td=tree(jd), tdc=tdc, prompts=prompts, solo=solo)


def drive(eng, prompts, n):
    """Submit every prompt, step until drained; (request ids, gamma after
    each step)."""
    rids = [eng.submit(p, n) for p in prompts]
    gammas = []
    while eng.pending:
        eng.step()
        gammas.append(eng.stats.get("gamma"))
    return rids, gammas


def jax_engine_runs(m, layout):
    """The JAX engines with a draft at ``layout``, adaptive gamma off and
    on: their outputs, gamma after every step, stats and per-request
    accepted/proposed counts (their loop profiler off, so their
    interleaving budget is the port's one chunk a step)."""
    out = {}
    for adaptive in (False, True):
        eng = JEngine(m["jp"], m["jcfg"], max_slots=2, max_len=32,
                      draft_params=m["jd"], draft_config=m["jdc"],
                      gamma=4, adaptive_gamma=adaptive, paged=SPEC[layout],
                      profiler=False)
        rids, gammas = drive(eng, m["prompts"], NEW)
        per_request = []
        for r in rids:
            done = eng.request_trace(r)["events"][-1]
            per_request.append((done["draft_accepted"],
                                done["draft_proposed"]))
        out[layout, adaptive] = dict(
            outputs=[eng.result(r) for r in rids], gammas=gammas,
            stats=eng.stats, per_request=per_request)
    return out


def check_speculative_engine(m, jax_engines, layout, adaptive):
    """The port's engine with a draft at ``layout``: every output equals
    solo ``generate`` and the JAX engine's, and so do the gamma after
    every step, the per-request counts and the stats."""
    eng = DecodeEngine(m["tp"], m["tcfg"], max_slots=2, max_len=32,
                       draft_params=m["td"], draft_config=m["tdc"], gamma=4,
                       adaptive_gamma=adaptive, paged=SPEC[layout],
                       device="cpu")
    rids, gammas = drive(eng, m["prompts"], NEW)
    infos = [eng.result_info(r) for r in rids]
    want = jax_engines[layout, adaptive]
    assert [i["tokens"] for i in infos] == m["solo"]
    assert [i["tokens"] for i in infos] == want["outputs"]
    assert gammas == want["gammas"]
    if adaptive:
        assert min(gammas) < 4      # the controller moved
    assert [(i["draft_accepted"], i["draft_proposed"])
            for i in infos] == want["per_request"]
    stats = eng.stats
    for key in ("draft_acceptance", "speculative_rounds", "gamma",
                "gamma_ceiling", "steps", "tokens_emitted"):
        assert stats[key] == pytest.approx(want["stats"][key], abs=1e-12), key
    assert 0.0 < stats["draft_acceptance"] < 1.0
