"""The port's ``TransformerModel`` and ``TextGenerator`` decode surface
with a draft, against the JAX package's.

Identical weights through the bridge (``tests/torch_speculative_parity.py``).
``TransformerModel.generate``, ``beam_search``,
``speculative_generate``, ``engine(draft=...)`` and ``serve`` (one
request over HTTP) and ``TextGenerator`` with a draft meet the JAX
package's.
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
from elephas_tpu_torch.models import transformer as ttr
from elephas_tpu_torch.models.transformer_model import TransformerModel
from elephas_tpu_torch.serving import TextGenerator
from elephas_tpu_torch.utils.text import ByteTokenizer
from elephas_tpu_torch.weights import to_numpy_tree
from tests.torch_speculative_parity import BASE, NEW, models, one_thread, tree


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
    want = jm.generate(prompt, NEW)
    np.testing.assert_array_equal(tm.generate(prompt, NEW), want)
    spec, stats = tm.speculative_generate(tdm, prompt, NEW, gamma=3,
                                          return_stats=True)
    jspec, jstats = jm.speculative_generate(jdm, prompt, NEW, gamma=3,
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
    assert eng.run(m["prompts"], NEW) == m["solo"]


def test_transformer_model_serve_with_a_draft(models):
    m = models
    _, _, tm, tdm = _models(m)
    srv = tm.serve(draft=tdm, max_slots=2, max_len=32, warmup_lengths=(5,))
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/v1/generate",
            data=json.dumps({"prompt": m["prompts"][0].tolist(),
                             "max_new_tokens": NEW}).encode(),
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
    kw = dict(BASE, vocab_size=tok.vocab_size)
    jcfg = jtr.TransformerConfig(dtype=jnp.float32, **kw)
    jdc = jtr.TransformerConfig(dtype=jnp.float32, **{**kw,
                                                      "num_layers": 1})
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(2))
    jd = {k: v for k, v in jp.items() if k != "layer_1"}
    tgen = TextGenerator(
        tree(jp), ttr.TransformerConfig(dtype=torch.float32, **kw),
        draft_params=tree(jd), draft_config=ttr.TransformerConfig(
            dtype=torch.float32, **{**kw, "num_layers": 1}),
        gamma=3, device="cpu")
    jgen = JTextGenerator(jp, jcfg, draft_params=jd, draft_config=jdc,
                          gamma=3)
    for prompts in (["abcd", "efgh"], ["ab", "cdefg"]):
        assert tgen(prompts, max_new_tokens=8) == jgen(prompts,
                                                       max_new_tokens=8)
    assert to_numpy_tree(tgen.draft_params).keys() == jd.keys()
