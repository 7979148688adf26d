"""``TransformerModel`` in the port against the JAX package: training
under a learning-rate schedule, and ``predict`` on zero rows.

``fit_tokens`` on the ``gqa`` config of ``test_torch_train.py`` (2
layers, d_model 32, 2 kv heads, f32, plain attention) for 3 epochs of
batch 4 over 12 rows, from the JAX model's initial weights, under
WarmupCosine and ExponentialDecay (peak 2e-2) with AdamW (epsilon
1e-5: Adam divides by sqrt(nu) + eps, which amplifies last-bit
differences of near-zero gradients) and with SGD (momentum 0.9): each
epoch's loss within 7.2e-7 of the JAX model's and every weight within
1.9e-5, the agreement an earlier CPU probe of these four runs measured
(this set-up: 4.0e-7 and 8.1e-6 at most). Zero
rows through ``predict`` (and through ``TPUModel.predict`` over the LM)
give ``(0, seq, vocab)`` f32 zeros, as the JAX package's shape-only
evaluation does, with no forward call; with ``out`` given, ``out``
comes back.
"""
import jax
import numpy as np
import pytest
from jax.sharding import Mesh

torch = pytest.importorskip("torch")

from elephas_tpu.models import optimizers as jopt
from elephas_tpu.models.transformer_model import TransformerModel as JModel
from elephas_tpu_torch import TPUModel
from elephas_tpu_torch.models import optimizers as topt
from elephas_tpu_torch.models.transformer_model import TransformerModel
from tests.test_torch_train import _configs, _tokens
# one_thread is an autouse fixture: importing it applies it here
from tests.torch_lm_parity import one_thread


def _pair(jo, to):
    """The two packages' models on the JAX model's initial weights."""
    jcfg, tcfg = _configs("gqa")
    one = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jm = JModel(jcfg, mesh=one).compile(jo, seed=0)
    tm = TransformerModel(tcfg, device="cpu").compile(to, seed=1)
    tm.set_weights(jm.get_weights())
    return jm, tm


_SCHEDULES = {
    "warmup_cosine": lambda m: m.schedules.WarmupCosine(
        2e-2, warmup_steps=3, decay_steps=9),
    "exponential": lambda m: m.schedules.ExponentialDecay(
        2e-2, decay_steps=3, decay_rate=0.5),
}
_OPTIMIZERS = {
    "adamw": lambda m, lr: m.AdamW(lr, epsilon=1e-5),
    "sgd_momentum": lambda m, lr: m.SGD(lr, momentum=0.9),
}


@pytest.mark.parametrize("opt", sorted(_OPTIMIZERS))
@pytest.mark.parametrize("schedule", sorted(_SCHEDULES))
def test_fit_tokens_under_a_schedule_matches_jax(opt, schedule):
    make_opt, make_sched = _OPTIMIZERS[opt], _SCHEDULES[schedule]
    jm, tm = _pair(make_opt(jopt, make_sched(jopt)),
                   make_opt(topt, make_sched(topt)))
    tokens = _tokens(6, (12, 17))
    kw = dict(epochs=3, batch_size=4, seed=3)
    ref, hist = jm.fit_tokens(tokens, **kw), tm.fit_tokens(tokens, **kw)
    np.testing.assert_allclose(hist["loss"], ref["loss"], atol=7.2e-7,
                               rtol=0)
    assert hist["loss"][-1] < hist["loss"][0]
    for a, b in zip(jm.get_weights(), tm.get_weights()):
        np.testing.assert_allclose(b, a, atol=1.9e-5, rtol=0)


@pytest.mark.parametrize("route", ["model", "tpu_model", "out"])
def test_predict_on_zero_rows_matches_jax(route, monkeypatch):
    jm, tm = _pair(jopt.SGD(0.1), topt.SGD(0.1))
    rows = np.zeros((0, 9), np.int32)
    want = jm.predict(rows)
    assert want.shape == (0, 9, 64) and want.dtype == np.float32

    def no_forward(*args, **kwargs):
        raise AssertionError("zero rows make no forward call")

    from elephas_tpu_torch.models import transformer_model
    monkeypatch.setattr(transformer_model, "forward", no_forward)
    if route == "model":
        got = tm.predict(rows)
    elif route == "tpu_model":
        got = TPUModel(tm, mode="synchronous", num_workers=1).predict(rows)
    else:
        out = np.ones((0, 9, 64), np.float32)
        got = tm.predict(rows, out=out)
        assert got is out
    assert got.shape == want.shape and got.dtype == want.dtype
