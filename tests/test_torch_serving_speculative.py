"""The port's ``DecodeEngine`` with a draft, interleaved prefill, and the
``TransformerModel``/``TextGenerator`` decode surface, against the JAX
package's.

Identical weights through the bridge (2-layer target, d_model 32, 4
heads, vocab 64, f32; the draft is the target's own first layer, so it
agrees with the target part of the time), the same numpy-seeded
requests; each JAX engine runs once per module in a fixture (its loop
profiler off, so its interleaving budget is the port's one chunk a
step). Engines with a draft, contiguous and paged, adaptive gamma off
and on, 6 requests through 2 slots: every output equals solo
``generate``, and the engine's accepted/proposed counts, slot-rounds,
per-request counts and the gamma after every step equal the JAX
engine's. ``interleave_prefill`` engines (contiguous, and paged with its
prefix cache) give the JAX engine's outputs, chunk counts and steps, and
equal solo ``generate``. ``TransformerModel.generate``, ``beam_search``,
``speculative_generate``, ``engine(draft=...)`` and ``serve`` (one
request over HTTP) and ``TextGenerator`` with a draft meet the JAX
package's. The refusals that remain name their ROADMAP step.
"""
import json
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from elephas_tpu.models import transformer as jtr
from elephas_tpu.models.transformer_model import TransformerModel as JModel
from elephas_tpu.serving import TextGenerator as JTextGenerator
from elephas_tpu.serving_engine import DecodeEngine as JEngine
from elephas_tpu_torch.models import transformer as ttr
from elephas_tpu_torch.models.transformer_model import TransformerModel
from elephas_tpu_torch.serving import TextGenerator
from elephas_tpu_torch.serving_engine import DecodeEngine
from elephas_tpu_torch.utils.text import ByteTokenizer
from elephas_tpu_torch.weights import from_numpy_tree, to_numpy_tree

_BASE = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
             max_seq_len=48)
_NEW = 10
# two prompt lengths (the JAX engine compiles one prefill per length)
_LENGTHS = (5, 9, 5, 9, 9, 5)
_SPEC = {"contiguous": None, "paged": (48, 4)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these ops are tiny, and under the parallel
    test run a pool of threads per worker oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree(jp):
    return from_numpy_tree(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")


@pytest.fixture(scope="module")
def models():
    jcfg = jtr.TransformerConfig(dtype=jnp.float32, **_BASE)
    tcfg = ttr.TransformerConfig(dtype=torch.float32, **_BASE)
    jdc = jtr.TransformerConfig(dtype=jnp.float32,
                                **{**_BASE, "num_layers": 1})
    tdc = ttr.TransformerConfig(dtype=torch.float32,
                                **{**_BASE, "num_layers": 1})
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    jd = {k: v for k, v in jp.items() if k != "layer_1"}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 64, n).astype(np.int32) for n in _LENGTHS]
    tp = _tree(jp)
    solo = [ttr.generate(tp, p[None], _NEW, tcfg)[0].tolist()
            for p in prompts]
    return dict(jp=jp, jcfg=jcfg, jd=jd, jdc=jdc, tp=tp, tcfg=tcfg,
                td=_tree(jd), tdc=tdc, prompts=prompts, solo=solo)


def _drive(eng, prompts, n):
    """Submit every prompt, step until drained; (outputs, gamma after
    each step, result infos)."""
    rids = [eng.submit(p, n) for p in prompts]
    gammas = []
    while eng.pending:
        eng.step()
        gammas.append(eng.stats.get("gamma"))
    return rids, gammas


@pytest.fixture(scope="module")
def jax_engines(models):
    """The JAX engines' outputs and counters, once per module."""
    out = {}
    m = models
    for name, paged in _SPEC.items():
        for adaptive in (False, True):
            eng = JEngine(m["jp"], m["jcfg"], max_slots=2, max_len=32,
                          draft_params=m["jd"], draft_config=m["jdc"],
                          gamma=4, adaptive_gamma=adaptive, paged=paged,
                          profiler=False)
            rids, gammas = _drive(eng, m["prompts"], _NEW)
            per_request = []
            for r in rids:
                done = eng.request_trace(r)["events"][-1]
                per_request.append((done["draft_accepted"],
                                    done["draft_proposed"]))
            out[name, adaptive] = dict(
                outputs=[eng.result(r) for r in rids], gammas=gammas,
                stats=eng.stats, per_request=per_request)
    return out


@pytest.mark.parametrize("adaptive", [False, True],
                         ids=["fixed_gamma", "adaptive_gamma"])
@pytest.mark.parametrize("layout", sorted(_SPEC))
def test_speculative_engine_matches_jax(models, jax_engines, layout,
                                        adaptive):
    m = models
    eng = DecodeEngine(m["tp"], m["tcfg"], max_slots=2, max_len=32,
                       draft_params=m["td"], draft_config=m["tdc"], gamma=4,
                       adaptive_gamma=adaptive, paged=_SPEC[layout],
                       device="cpu")
    rids, gammas = _drive(eng, m["prompts"], _NEW)
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


# --------------------------------------------------- interleaved prefill
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


# ------------------------------------------------ model-level surface
def _models(m):
    """A JAX and a port TransformerModel on the same weights, each with
    its draft."""
    jm, jdm = JModel(m["jcfg"]), JModel(m["jdc"])
    jm.params, jm.built = m["jp"], True
    jdm.params, jdm.built = m["jd"], True
    tm = TransformerModel(m["tcfg"], device="cpu").build()
    tdm = TransformerModel(m["tdc"], device="cpu").build()
    tm.set_weights([np.asarray(w) for w in jm.get_weights()])
    tdm.set_weights([np.asarray(w) for w in jdm.get_weights()])
    return jm, jdm, tm, tdm


def _open(req):
    """urlopen with a short retry on a refused connect to a freshly
    listening loopback socket."""
    for attempt in range(20):
        try:
            return urllib.request.urlopen(req, timeout=120)
        except urllib.error.URLError as err:
            if (isinstance(err, urllib.error.HTTPError)
                    or not isinstance(err.reason, ConnectionRefusedError)
                    or attempt == 19):
                raise
            time.sleep(0.05)


def test_transformer_model_decode_methods_match_jax(models):
    m = models
    jm, jdm, tm, tdm = _models(m)
    prompt = np.stack([p for p in m["prompts"] if p.size == 9])
    want = jm.generate(prompt, _NEW)
    np.testing.assert_array_equal(tm.generate(prompt, _NEW), want)
    spec, stats = tm.speculative_generate(tdm, prompt, _NEW, gamma=3,
                                          return_stats=True)
    jspec, jstats = jm.speculative_generate(jdm, prompt, _NEW, gamma=3,
                                            return_stats=True)
    np.testing.assert_array_equal(spec, want)
    np.testing.assert_array_equal(spec, jspec)
    assert stats == pytest.approx(jstats, abs=1e-12)
    seqs, scores = tm.beam_search(prompt[:1], 4, num_beams=3)
    jseqs, jscores = jm.beam_search(prompt[:1], 4, num_beams=3)
    np.testing.assert_array_equal(seqs, jseqs)
    np.testing.assert_allclose(scores, jscores, atol=1e-5, rtol=0)
    eng = tm.engine(draft=tdm, max_slots=2, max_len=32)
    assert eng.draft_config is m["tdc"]
    assert eng.run(m["prompts"], _NEW) == m["solo"]


def test_transformer_model_serve_with_a_draft(models):
    m = models
    _, _, tm, tdm = _models(m)
    srv = tm.serve(draft=tdm, max_slots=2, max_len=32, warmup_lengths=(5,))
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/v1/generate",
            data=json.dumps({"prompt": m["prompts"][0].tolist(),
                             "max_new_tokens": _NEW}).encode(),
            headers={"Content-Type": "application/json"})
        with _open(req) as resp:
            out = json.loads(resp.read())
    finally:
        srv.stop()
    assert out["tokens"] == m["solo"][0]


def test_text_generator_with_a_draft_matches_jax():
    """Uniform prompts decode speculatively, ragged ones through
    ``generate``: both equal the JAX ``TextGenerator``'s text."""
    tok = ByteTokenizer()
    kw = dict(_BASE, vocab_size=tok.vocab_size)
    jcfg = jtr.TransformerConfig(dtype=jnp.float32, **kw)
    jdc = jtr.TransformerConfig(dtype=jnp.float32, **{**kw,
                                                      "num_layers": 1})
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(2))
    jd = {k: v for k, v in jp.items() if k != "layer_1"}
    tgen = TextGenerator(
        _tree(jp), ttr.TransformerConfig(dtype=torch.float32, **kw),
        draft_params=_tree(jd), draft_config=ttr.TransformerConfig(
            dtype=torch.float32, **{**kw, "num_layers": 1}),
        gamma=3, device="cpu")
    jgen = JTextGenerator(jp, jcfg, draft_params=jd, draft_config=jdc,
                          gamma=3)
    for prompts in (["abcd", "efgh"], ["ab", "cdefg"]):
        assert tgen(prompts, max_new_tokens=8) == jgen(prompts,
                                                       max_new_tokens=8)
    assert to_numpy_tree(tgen.draft_params).keys() == jd.keys()
