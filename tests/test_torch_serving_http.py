"""``ServingServer`` over the port's engine: the ``examples/http_serving.py``
flow at the small size.

The example's engine shape (4 slots, ``steps_per_sync=2``, a paged pool
of 24 blocks of 8, the "SYSTEM: " prefix registered, the byte
tokenizer) over a 2-layer, d_model 32 LM whose weights the JAX package
draws and the bridge carries (f32): five concurrent ``/v1/generate``
text clients get exactly the JAX ``generate``'s tokens, under the
gather path and the fused kernel's path (its plain version on the CPU);
then ``/v1/submit`` with ``/v1/result``, ``/stats``, a streamed
request and an explicit ``deadline_ms`` (refused with 400: the port's
engine has no deadlines). ``TextGenerator`` on the port's ``generate``
meets the JAX package's, with the target as its own draft too.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from elephas_tpu.models.transformer import \
    TransformerConfig as JaxConfig
from elephas_tpu.models.transformer import generate as jax_generate
from elephas_tpu.models.transformer import init_params as jax_init
from elephas_tpu.serving import TextGenerator as JaxTextGenerator
from elephas_tpu_torch.models.transformer import TransformerConfig
from elephas_tpu_torch.serving import TextGenerator
from elephas_tpu_torch.serving_engine import DecodeEngine
from elephas_tpu_torch.serving_http import ServingServer
from elephas_tpu_torch.utils.text import ByteTokenizer
from elephas_tpu_torch.weights import from_numpy_tree

_TOK = ByteTokenizer()
_CFG = dict(vocab_size=_TOK.vocab_size, num_layers=2, num_heads=4,
            d_model=32, d_ff=64, max_seq_len=48)
_PROMPTS = ["SYSTEM: hello", "SYSTEM: goodbye", "SYSTEM: what",
            "plain prompt", "SYSTEM: again"]


@pytest.fixture(scope="module")
def model():
    jcfg = JaxConfig(dtype=jnp.float32, **_CFG)
    tcfg = TransformerConfig(dtype=torch.float32, **_CFG)
    jp = jax_init(jcfg, jax.random.PRNGKey(0))
    tp = from_numpy_tree(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    return jp, jcfg, tp, tcfg


def _ref(jp, jcfg, text, n):
    return [int(t) for t in np.asarray(jax_generate(
        jp, jnp.asarray(_TOK.encode(text))[None], n, jcfg))[0]]


def _open(req):
    """urlopen with a short retry on a refused connect (a freshly
    listening loopback socket can refuse a burst of connects)."""
    for attempt in range(20):
        try:
            return urllib.request.urlopen(req, timeout=120)
        except urllib.error.URLError as err:
            if (isinstance(err, urllib.error.HTTPError)
                    or not isinstance(err.reason, ConnectionRefusedError)
                    or attempt == 19):
                raise
            time.sleep(0.05)


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with _open(req) as resp:
        return json.loads(resp.read())


def _get(port, path):
    with _open(f"http://127.0.0.1:{port}{path}") as resp:
        return json.loads(resp.read())


def _engine(tp, tcfg, kernel):
    engine = DecodeEngine(tp, tcfg, max_slots=4, steps_per_sync=2,
                          paged=(24, 8), kernel=kernel, device="cpu")
    engine.register_prefix(_TOK.encode("SYSTEM: "))
    return engine


@pytest.mark.parametrize("kernel", ["gather", "fused"])
def test_concurrent_clients_get_the_jax_generate_tokens(model, kernel):
    jp, jcfg, tp, tcfg = model
    with ServingServer(_engine(tp, tcfg, kernel), tokenizer=_TOK) as srv:
        results = {}

        def client(i):
            results[i] = _post(srv.port, "/v1/generate",
                               {"text": _PROMPTS[i], "max_new_tokens": 16})

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(_PROMPTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i, text in enumerate(_PROMPTS):
            ref = _ref(jp, jcfg, text, 16)
            assert results[i]["tokens"] == ref, f"client {i} diverged"
            assert results[i]["text"] == _TOK.decode(ref)
        rid = _post(srv.port, "/v1/submit",
                    {"text": "one more", "max_new_tokens": 4})["id"]
        for _ in range(400):
            polled = _get(srv.port, f"/v1/result?id={rid}")
            if polled["status"] != "pending":
                break
            time.sleep(0.01)
        assert polled["tokens"] == _ref(jp, jcfg, "one more", 4)
        stats = _get(srv.port, "/stats")
    # four prompts start with the registered 8-token prefix: its one
    # full block is pinned in the pool's block cache
    assert stats["prefix_tokens_reused"] >= 4 * 8
    assert stats["kv_cache"]["pinned_blocks"] == 1
    assert stats["tokens_per_step"] > 1.0
    assert stats["requests_finished"] == len(_PROMPTS) + 1
    assert stats["kernel"] == kernel and stats["kernel_launches"] == 0
    assert stats["blocks_free"] == 24 - 2


def test_streaming_and_refused_fields(model):
    jp, jcfg, tp, tcfg = model
    with ServingServer(_engine(tp, tcfg, "gather"), tokenizer=_TOK) as srv:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/v1/generate",
            data=json.dumps({"text": "SYSTEM: stream", "max_new_tokens": 10,
                             "stream": True}).encode(),
            headers={"Content-Type": "application/json"})
        with _open(req) as resp:
            assert resp.headers["Content-Type"] == "application/x-ndjson"
            lines = [json.loads(raw) for raw in resp]
        assert lines[-1] == {"status": "done"}
        chunks = [ln["tokens"] for ln in lines[:-1]]
        assert len(chunks) >= 2                   # incremental, not one blob
        assert sum(chunks, []) == _ref(jp, jcfg, "SYSTEM: stream", 10)
        for field, value in (("deadline_ms", 500), ("tenant", "a"),
                             ("seed", 3), ("session", "s")):
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(srv.port, "/v1/generate",
                      {"text": "x", "max_new_tokens": 2, field: value})
            assert err.value.code == 400
            assert "does not support" in json.loads(err.value.read())["error"]
        assert _get(srv.port, "/health") == {"status": "ok"}
        assert _get(srv.port, "/stats")["requests_finished"] == 1


def test_text_generator_matches_jax(model):
    jp, jcfg, tp, tcfg = model
    prompts = ["SYSTEM: hi", "a longer prompt"]
    ref = JaxTextGenerator(jp, jcfg)(prompts, max_new_tokens=6)
    assert TextGenerator(tp, tcfg, device="cpu")(prompts,
                                                 max_new_tokens=6) == ref
    # with the target as its own draft: uniform prompts decode
    # speculatively, ragged ones through generate; the same text
    spec = TextGenerator(tp, tcfg, draft_params=tp, draft_config=tcfg,
                         device="cpu")
    assert spec(prompts, max_new_tokens=6) == ref
    uniform = ["SYSTEM: hi", "0123456789"]
    assert spec(uniform, max_new_tokens=6) == JaxTextGenerator(jp, jcfg)(
        uniform, max_new_tokens=6)
