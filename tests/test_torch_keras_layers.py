"""The port's Keras-style building blocks against the JAX package.

Seeded numpy inputs go through each activation, loss and metric of both
packages (every registered name, f32; atol 1e-6, and rtol 1e-6 for the
losses whose values reach the hundreds); the initializers are held to
their distributions (bounds, fans, mean and std within five standard
errors), since a ``torch.Generator`` cannot draw ``jax.random``'s bits;
layers, ``Sequential`` and functional ``Model`` predict on the JAX
model's weights carried over with ``set_weights(get_weights())`` (atol
1e-5); and model JSON loads in either package from the other.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from elephas_tpu.models import activations as jact
from elephas_tpu.models import core as jcore
from elephas_tpu.models import initializers as jinit
from elephas_tpu.models import layers as jlayers
from elephas_tpu.models import losses as jlosses
from elephas_tpu.models import metrics as jmetrics
from elephas_tpu_torch.models import activations as tact
from elephas_tpu_torch.models import core as tcore
from elephas_tpu_torch.models import initializers as tinit
from elephas_tpu_torch.models import layers as tlayers
from elephas_tpu_torch.models import losses as tlosses
from elephas_tpu_torch.models import metrics as tmetrics


def _inputs(seed=0, shape=(6, 5)):
    rng = np.random.default_rng(seed)
    y_true = rng.random(shape).astype(np.float32)
    logits = rng.normal(size=shape).astype(np.float32)
    y_pred = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    labels = rng.integers(0, shape[-1], shape[0]).astype(np.int32)
    return y_true, y_pred.astype(np.float32), labels


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_registries_have_the_same_names():
    assert set(tact._ACTIVATIONS) == set(jact._ACTIVATIONS)
    assert set(tinit._INITIALIZERS) == set(jinit._INITIALIZERS)
    assert set(tlosses._LOSSES) == set(jlosses._LOSSES)
    assert set(tmetrics._METRICS) == set(jmetrics._METRICS)


@pytest.mark.parametrize("name", sorted(jact._ACTIVATIONS))
def test_activation_matches_jax(name):
    x = np.clip(np.random.default_rng(1).normal(size=(7, 9)), -2, 2)
    x = x.astype(np.float32)
    want = np.asarray(jact.get(name)(jnp.asarray(x)))
    got = tact.get(name)(_t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert tact.serialize(tact.get(name)) == jact.serialize(jact.get(name))


def test_activation_lookup_rules():
    assert tact.get(None) is tact.linear
    assert tact.get("mine", {"mine": abs}) is abs
    with pytest.raises(ValueError):
        tact.get("nope")


@pytest.mark.parametrize("name", sorted(jlosses._LOSSES))
def test_loss_matches_jax(name):
    y_true, y_pred, labels = _inputs(2)
    if name == "sparse_categorical_crossentropy":
        y_true = labels
    want = np.asarray(jlosses.get(name)(jnp.asarray(y_true),
                                        jnp.asarray(y_pred)))
    got = tlosses.get(name)(_t(y_true), _t(y_pred)).numpy()
    assert got.shape == want.shape == (6,)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    assert tlosses.serialize(tlosses.get(name)) == \
        jlosses.serialize(jlosses.get(name))


def test_cross_entropies_clip_and_renormalise_as_jax():
    """Predictions outside [EPS, 1] and rows that do not sum to 1: the
    clip-and-renormalise of ``losses.py`` must match exactly."""
    y_true, _, labels = _inputs(3)
    y_pred = np.array([[0.0, 1.0, 0.5, 1e-9, 2.0]] * 6, dtype=np.float32)
    for name, target in (("categorical_crossentropy", y_true),
                         ("sparse_categorical_crossentropy", labels),
                         ("binary_crossentropy", y_true)):
        want = np.asarray(jlosses.get(name)(jnp.asarray(target),
                                            jnp.asarray(y_pred)))
        got = tlosses.get(name)(_t(target), _t(y_pred)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    assert tlosses.EPS == jlosses.EPS


@pytest.mark.parametrize("name", sorted(jmetrics._METRICS))
def test_metric_matches_jax(name):
    y_true, y_pred, labels = _inputs(4)
    if name == "sparse_categorical_accuracy":
        y_true = labels
    if name == "categorical_accuracy":
        y_true = np.eye(5, dtype=np.float32)[labels]
    want = np.asarray(jmetrics.get(name)(jnp.asarray(y_true),
                                         jnp.asarray(y_pred)))
    got = tmetrics.get(name)(_t(y_true), _t(y_pred)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("loss", ["sparse_categorical_crossentropy",
                                  "binary_crossentropy",
                                  "categorical_crossentropy", "mse", None])
def test_acc_resolves_by_the_loss(loss):
    names, fns = tmetrics.resolve_metrics(["acc", "mae"], loss=loss)
    jnames, jfns = jmetrics.resolve_metrics(["acc", "mae"], loss=loss)
    assert names == jnames == ["acc", "mae"]
    assert [f.__name__ for f in fns] == [f.__name__ for f in jfns]


_INIT_SHAPE = (64, 48)        # fan_in 64, fan_out 48


def _expected_stats(name):
    """(mean, std, bound) of each initializer at ``_INIT_SHAPE``."""
    fi, fo = _INIT_SHAPE
    uniform = {"glorot_uniform": np.sqrt(6 / (fi + fo)),
               "he_uniform": np.sqrt(6 / fi), "random_uniform": 0.05}
    normal = {"glorot_normal": np.sqrt(2 / (fi + fo)),
              "he_normal": np.sqrt(2 / fi), "lecun_normal": np.sqrt(1 / fi),
              "random_normal": 0.05}
    if name in uniform:
        return 0.0, uniform[name] / np.sqrt(3), uniform[name]
    if name in normal:
        return 0.0, normal[name], None
    # a standard normal truncated to [-2, 2]: variance 1 - 4 phi(2) / mass
    mass = 0.9544997361036416
    phi2 = np.exp(-2.0) / np.sqrt(2 * np.pi)
    return 0.0, 0.05 * np.sqrt(1 - 4 * phi2 / mass), 0.1


@pytest.mark.parametrize("name", sorted(jinit._INITIALIZERS))
def test_initializer_distribution(name):
    assert tinit._fans(_INIT_SHAPE) == jinit._fans(_INIT_SHAPE)
    assert tinit._fans((3, 3, 8, 16)) == jinit._fans((3, 3, 8, 16))
    gen = torch.Generator().manual_seed(0)
    w = tinit.get(name)(gen, _INIT_SHAPE)
    assert w.shape == _INIT_SHAPE and w.dtype == torch.float32
    w = w.double().numpy()
    if name in ("zeros", "ones"):
        assert np.all(w == (name == "ones"))
        return
    if name == "orthogonal":
        np.testing.assert_allclose(w.T @ w, np.eye(_INIT_SHAPE[1]),
                                   atol=1e-5)
        return
    mean, std, bound = _expected_stats(name)
    n = w.size
    assert abs(w.mean() - mean) <= 5 * std / np.sqrt(n)
    # the sample std's standard error is about std / sqrt(2 n)
    assert abs(w.std() - std) <= 5 * std / np.sqrt(2 * n)
    if bound is not None:
        assert np.abs(w).max() <= bound
    # the JAX draw meets the same expectations
    jw = np.asarray(jinit.get(name)(jax.random.PRNGKey(0), _INIT_SHAPE),
                    dtype=np.float64)
    assert abs(jw.std() - std) <= 5 * std / np.sqrt(2 * n)


def test_initializer_draws_follow_the_generator():
    a = tinit.glorot_uniform(torch.Generator().manual_seed(3), (5, 4))
    b = tinit.glorot_uniform(torch.Generator().manual_seed(3), (5, 4))
    c = tinit.glorot_uniform(torch.Generator().manual_seed(4), (5, 4))
    assert torch.equal(a, b) and not torch.equal(a, c)


def _layers(m):
    """One Sequential stack per case, built by either package's module."""
    return {
        "dense_relu": [m.Dense(16, activation="relu", input_shape=(24,))],
        "dense_nobias_tanh": [m.Dense(8, activation="tanh", use_bias=False,
                                      input_dim=24)],
        "activation_softmax": [m.Dense(6, input_dim=24),
                               m.Activation("softmax")],
        "dropout_inference": [m.Dense(12, input_dim=24), m.Dropout(0.5),
                              m.Activation("gelu")],
        "reshape_flatten": [m.Reshape((4, 6), input_shape=(24,)),
                            m.Dense(5, activation="elu"), m.Flatten(),
                            m.Dense(3)],
        "mlp": [m.Dense(32, activation="relu", input_dim=24),
                m.Dropout(0.2), m.Dense(16, activation="swish"),
                m.Dense(10, activation="softmax")],
    }


def _pair(case):
    jlayers.reset_layer_uids()
    jm = jcore.Sequential(_layers(jlayers)[case])
    jm.build(seed=0)
    tlayers.reset_layer_uids()
    tm = tcore.Sequential(_layers(tlayers)[case], device="cpu")
    tm.build(seed=0)
    tm.set_weights(jm.get_weights())
    return jm, tm


@pytest.mark.parametrize("case", sorted(_layers(jlayers)))
def test_sequential_predict_matches_jax(case):
    jm, tm = _pair(case)
    assert [l.name for l in tm.layers] == [l.name for l in jm.layers]
    assert tm.output_shape == jm.output_shape
    for a, b in zip(jm.get_weights(), tm.get_weights()):
        assert a.shape == b.shape and a.dtype == b.dtype
    x = np.random.default_rng(5).normal(size=(13, 24)).astype(np.float32)
    # batch 5: the last batch of 3 rows is padded
    np.testing.assert_allclose(tm.predict(x, batch_size=5),
                               np.asarray(jm.predict(x, batch_size=5)),
                               atol=1e-5, rtol=0)


def _functional(m):
    inp = m.Input(shape=(24,))
    h = m.Dense(16, activation="relu")(inp)
    h = m.Dropout(0.3)(h)
    h = m.Dense(16, activation="tanh")(h)
    out = m.Dense(4, activation="softmax")(h)
    return inp, out


def test_functional_model_predict_matches_jax():
    jlayers.reset_layer_uids()
    jm = jcore.Model(*_functional(jlayers))
    tlayers.reset_layer_uids()
    tm = tcore.Model(*_functional(tlayers), device="cpu")
    tm.set_weights(jm.get_weights())
    x = np.random.default_rng(6).normal(size=(9, 24)).astype(np.float32)
    np.testing.assert_allclose(tm.predict(x), np.asarray(jm.predict(x)),
                               atol=1e-5, rtol=0)


def test_dropout_keeps_its_rate_and_scale_in_training():
    layer = tlayers.Dropout(0.3)
    x = torch.ones(200_000)
    y = layer.call({}, x, True, torch.Generator().manual_seed(0))
    kept = (y != 0).double().mean().item()
    # 5 standard errors of a Bernoulli(0.7) share over 200k draws
    assert abs(kept - 0.7) <= 5 * np.sqrt(0.7 * 0.3 / x.numel())
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0],
                                                          1 / 0.7))
    assert torch.equal(layer.call({}, x, False, None), x)
    again = layer.call({}, x, True, torch.Generator().manual_seed(0))
    assert torch.equal(y, again)


@pytest.mark.parametrize("kind", ["sequential", "functional"])
def test_to_json_loads_in_the_other_package(kind):
    def build(layers_mod, core_mod, **kw):
        layers_mod.reset_layer_uids()
        if kind == "sequential":
            m = core_mod.Sequential(_layers(layers_mod)["reshape_flatten"],
                                    **kw)
            m.build(seed=0)
            return m
        return core_mod.Model(*_functional(layers_mod), **kw)

    jm = build(jlayers, jcore)
    tm = build(tlayers, tcore, device="cpu")
    assert json.loads(tm.to_json())["config"]["layers"] == \
        json.loads(jm.to_json())["config"]["layers"]
    # JAX -> port: same architecture, and the weights carry over
    from_jax = tcore.model_from_json(jm.to_json(), device="cpu")
    from_jax.set_weights(jm.get_weights())
    x = np.random.default_rng(7).normal(size=(4, 24)).astype(np.float32)
    np.testing.assert_allclose(from_jax.predict(x), np.asarray(jm.predict(x)),
                               atol=1e-5, rtol=0)
    assert json.loads(from_jax.to_json()) == json.loads(jm.to_json())
    # port -> JAX
    to_jax = jcore.model_from_json(tm.to_json())
    to_jax.set_weights(tm.get_weights())
    np.testing.assert_allclose(np.asarray(to_jax.predict(x)), tm.predict(x),
                               atol=1e-5, rtol=0)
    assert json.loads(to_jax.to_json()) == json.loads(tm.to_json())


def test_unported_layers_raise():
    jlayers.reset_layer_uids()
    jm = jcore.Sequential([jlayers.Conv2D(4, 3, input_shape=(8, 8, 1)),
                           jlayers.Flatten(), jlayers.Dense(2)])
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        tcore.model_from_json(jm.to_json(), device="cpu")
    with pytest.raises(ValueError):
        tlayers.deserialize_layer({"class_name": "NoSuchLayer"})


def test_layer_auto_names_follow_the_jax_scheme():
    tlayers.reset_layer_uids()
    names = [tlayers.Dense(2).name, tlayers.Dense(2).name,
             tlayers.Dropout(0.1).name, tlayers.InputLayer((3,)).name]
    assert names == ["dense", "dense_1", "dropout", "input"]
