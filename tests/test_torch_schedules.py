"""The port's learning-rate schedules against the JAX package's (optax).

Each schedule's value at steps around its boundaries equals the JAX
schedule's (float32, rtol 1e-6), its serialized form is the JAX
package's and loads there and back, and the JAX package's own claims
(``tests/models/test_schedules.py``: Keras's boundary rule and zero
values for ``PiecewiseConstantDecay``, the floored exponent, the cosine
endpoints, the warmup's shape) hold. Optimizers driven by a schedule
take 5 updates as optax's do (atol 1e-6) and carry the schedule's
count as the state's last leaf, where optax carries it; and ``fit``
with a scheduled Adam follows the JAX model for 2 epochs (atol 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

from elephas_tpu.models import core as jcore
from elephas_tpu.models import layers as jlayers
from elephas_tpu.models import optimizers as jopt
from elephas_tpu.models import schedules as jsched
from elephas_tpu_torch.models import core as tcore
from elephas_tpu_torch.models import layers as tlayers
from elephas_tpu_torch.models import optimizers as topt
from elephas_tpu_torch.models import schedules as tsched

_SCHEDULES = {
    "exponential": lambda m: m.ExponentialDecay(0.1, decay_steps=10,
                                                decay_rate=0.5),
    "exponential_staircase": lambda m: m.ExponentialDecay(
        0.1, decay_steps=10, decay_rate=0.5, staircase=True),
    "exponential_growth": lambda m: m.ExponentialDecay(1e-3, 4, 1.5),
    "exponential_constant": lambda m: m.ExponentialDecay(0.1, 0, 0.5),
    "cosine": lambda m: m.CosineDecay(0.1, decay_steps=100, alpha=0.1),
    "cosine_short": lambda m: m.CosineDecay(3e-3, decay_steps=7),
    "piecewise": lambda m: m.PiecewiseConstantDecay([100], [0.1, 0.01]),
    "piecewise_zero": lambda m: m.PiecewiseConstantDecay(
        [10, 20], [0.1, 0.0, 0.01]),
    "warmup_cosine": lambda m: m.WarmupCosine(
        1e-2, warmup_steps=10, decay_steps=100, end_learning_rate=1e-4),
    "warmup_cosine_no_warmup": lambda m: m.WarmupCosine(5e-3, 0, 20),
}

_STEPS = [0, 1, 2, 3, 4, 5, 7, 9, 10, 11, 15, 19, 20, 21, 50, 99, 100,
          101, 150]


@pytest.mark.parametrize("case", sorted(_SCHEDULES))
def test_values_match_jax(case):
    js, ts = _SCHEDULES[case](jsched), _SCHEDULES[case](tsched)
    want = np.array([js(s) for s in _STEPS], np.float64)
    got = np.array([ts(s) for s in _STEPS], np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # optax's own callable at int32 counts, as the optimizer calls it
    fn = js.to_optax()
    np.testing.assert_allclose(
        got, [float(fn(jnp.asarray(s, jnp.int32))) for s in _STEPS],
        rtol=1e-6, atol=0)


@pytest.mark.parametrize("case", sorted(_SCHEDULES))
def test_serialization_crosses_packages(case):
    js, ts = _SCHEDULES[case](jsched), _SCHEDULES[case](tsched)
    assert tsched.serialize(ts) == jsched.serialize(js)
    back = jsched.deserialize(tsched.serialize(ts))
    assert type(back) is type(js) and back.get_config() == js.get_config()
    there = tsched.deserialize(jsched.serialize(js))
    assert type(there) is type(ts) and there.get_config() == ts.get_config()
    assert tsched.get(tsched.serialize(ts)).get_config() == ts.get_config()
    assert tsched.get(ts) is ts


def test_the_jax_packages_claims_hold():
    s = tsched.ExponentialDecay(0.1, decay_steps=10, decay_rate=0.5,
                                staircase=True)
    assert np.isclose(s(9), 0.1) and np.isclose(s(10), 0.05)
    c = tsched.CosineDecay(0.1, decay_steps=100, alpha=0.1)
    assert np.isclose(c(0), 0.1) and np.isclose(c(100), 0.01, rtol=1e-5)
    p = tsched.PiecewiseConstantDecay([100], [0.1, 0.01])
    assert np.isclose(p(100), 0.1) and np.isclose(p(101), 0.01)
    z = tsched.PiecewiseConstantDecay([10, 20], [0.1, 0.0, 0.01])
    assert z(15) == 0.0 and np.isclose(z(25), 0.01)
    with pytest.raises(ValueError, match="len"):
        tsched.PiecewiseConstantDecay([10], [0.1])
    w = tsched.WarmupCosine(1e-2, warmup_steps=10, decay_steps=100,
                            end_learning_rate=1e-4)
    assert w(0) < w(5) < w(10) and np.isclose(w(10), 1e-2)
    assert np.isclose(w(100), 1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="positive decay_steps"):
        tsched.WarmupCosine(1e-2, warmup_steps=10, decay_steps=10)(0)
    with pytest.raises(ValueError, match="Unknown schedule"):
        tsched.deserialize({"class_name": "StepDecay"})


_SCHEDULED = {
    "sgd_momentum_piecewise": lambda m: m.SGD(m.schedules.PiecewiseConstantDecay(
        [1, 3], [0.1, 0.05, 0.0]), momentum=0.9),
    "adam_cosine": lambda m: m.Adam(m.schedules.CosineDecay(1e-2, 4)),
    "adamw_warmup_cosine": lambda m: m.AdamW(m.schedules.WarmupCosine(
        1e-2, warmup_steps=2, decay_steps=8), weight_decay=0.1),
    "rmsprop_exponential": lambda m: m.RMSprop(m.schedules.ExponentialDecay(
        1e-2, 2, 0.5), clipnorm=1.0),
    "nadam_exponential": lambda m: m.Nadam(m.schedules.ExponentialDecay(
        1e-2, 1, 0.7, staircase=True)),
    "adafactor_cosine": lambda m: m.Adafactor(m.schedules.CosineDecay(
        1e-1, 5), min_dim_size_to_factor=2),
    "lion_warmup_cosine": lambda m: m.Lion(m.schedules.WarmupCosine(
        1e-3, 1, 5)),
    "lamb_piecewise": lambda m: m.LAMB(m.schedules.PiecewiseConstantDecay(
        [2], [1e-2, 1e-3])),
}


@pytest.mark.parametrize("case", sorted(_SCHEDULED))
def test_scheduled_optimizer_matches_optax(case):
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(3).astype(np.float32)}
    jo = _SCHEDULED[case](jopt)
    to = topt.deserialize(jopt.serialize(jo))
    assert topt.serialize(to) == jopt.serialize(jo)
    tx, ttx = jo.to_optax(), to.to_transform()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = tx.init(jp), ttx.init(tp)
    for _ in range(5):
        g = {k: (2 * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in params.items()}
        updates, js = tx.update(jax.tree_util.tree_map(jnp.asarray, g), js,
                                jp)
        jp = optax.apply_updates(jp, updates)
        tu, ts = ttx.update({k: torch.from_numpy(v) for k, v in g.items()},
                            ts, tp)
        tp = {k: tp[k] + tu[k] for k in tp}
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-6, rtol=0)
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(js)]
    got = [t.numpy() for t in topt.opt_state_leaves(ts)]
    assert len(got) == len(want)
    assert got[-1].dtype == np.int32 and int(got[-1]) == int(want[-1]) == 5
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def test_fit_with_a_schedule_matches_jax():
    def layers(m):
        return [m.Dense(8, activation="relu", input_dim=5), m.Dense(1)]

    def opt(m):
        return m.Adam(m.schedules.WarmupCosine(5e-2, warmup_steps=3,
                                               decay_steps=8))

    jlayers.reset_layer_uids()
    jm = jcore.Sequential(layers(jlayers))
    jm.compile(opt(jopt), "mse", seed=0)
    tlayers.reset_layer_uids()
    tm = tcore.Sequential(layers(tlayers), device="cpu")
    tm.compile(opt(topt), "mse", seed=1)
    tm.set_weights(jm.get_weights())
    rng = np.random.default_rng(1)
    x = rng.normal(size=(32, 5)).astype(np.float32)
    y = x @ rng.normal(size=(5, 1)).astype(np.float32)
    kw = dict(epochs=2, batch_size=8, shuffle=False)
    jh, th = jm.fit(x, y, **kw).history, tm.fit(x, y, **kw).history
    np.testing.assert_allclose(th["loss"], jh["loss"], atol=1e-5, rtol=0)
    for a, b in zip(jm.get_weights(), tm.get_weights()):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-5, rtol=0)
