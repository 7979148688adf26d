"""The port's optimizers against the JAX package's optax transforms.

The same numpy parameters and three rounds of numpy gradients go
through ``Optimizer.to_optax()`` of the JAX package and
``Optimizer.to_transform()`` of the port (each built from the other's
config), and the parameters after each update must agree within atol
1e-6 (f32; ``1 - b**count`` is computed in another precision). The tree
mixes matrices and vectors (so the AdamW decay mask matters) and
``layer_10``/``layer_2`` keys (so JAX's string-sorted leaf order does).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

from elephas_tpu.models import optimizers as jopt
from elephas_tpu_torch.models import optimizers as topt

_CASES = {
    "sgd": lambda m: m.SGD(0.1),
    "sgd_momentum": lambda m: m.SGD(0.1, momentum=0.9),
    "sgd_nesterov": lambda m: m.SGD(0.05, momentum=0.8, nesterov=True),
    "adam": lambda m: m.Adam(1e-2),
    "adam_mu_bf16": lambda m: m.Adam(1e-2, mu_dtype="bfloat16"),
    "adamw_masked": lambda m: m.AdamW(1e-2, weight_decay=0.1),
    "adamw_unmasked": lambda m: m.AdamW(1e-2, weight_decay=0.1,
                                        decay_1d=True),
    "adamw_bench": lambda m: m.AdamW(3e-4, epsilon=1e-8, weight_decay=1e-4,
                                     decay_1d=True),
    "sgd_clipnorm": lambda m: m.SGD(0.1, clipnorm=1.0),
    "sgd_clipvalue": lambda m: m.SGD(0.1, clipvalue=0.5),
    "adam_both_clips": lambda m: m.Adam(1e-2, clipvalue=2.0, clipnorm=3.0),
    "rmsprop": lambda m: m.RMSprop(1e-2),
    "rmsprop_momentum": lambda m: m.RMSprop(1e-2, rho=0.8, momentum=0.9,
                                            epsilon=1e-6),
    "rmsprop_clipnorm": lambda m: m.RMSprop(1e-2, clipnorm=1.0),
}


def _tree(rng):
    return {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal(3).astype(np.float32),
            "layer_10": {"k": rng.standard_normal((2, 2, 2))
                         .astype(np.float32)},
            "layer_2": {"gamma": rng.standard_normal(5).astype(np.float32)}}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_updates_match_optax(case):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [jax.tree_util.tree_map(
        lambda p: (3 * rng.standard_normal(p.shape)).astype(np.float32),
        params) for _ in range(3)]
    jo = _CASES[case](jopt)
    to = topt.deserialize(jopt.serialize(jo))
    tx = jo.to_optax()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = tx.init(jp)
    ttx = to.to_transform()
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()), params)
    ts = ttx.init(tp)
    for g in grads:
        updates, js = tx.update(jax.tree_util.tree_map(jnp.asarray, g), js,
                                jp)
        jp = optax.apply_updates(jp, updates)
        tu, ts = ttx.update(jax.tree_util.tree_map(torch.from_numpy, g), ts,
                            tp)
        assert set(tu) == set(g)          # updates come back as a tree
        tp = jax.tree_util.tree_map(lambda a, b: a + b, tp, tu)
        for a, b in zip(jax.tree_util.tree_leaves(jp),
                        jax.tree_util.tree_leaves(tp)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6,
                                       rtol=0)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_serialize_round_trips_through_the_jax_package(case):
    """The port's ``serialize`` is the JAX package's form: it
    deserializes there into the same optimizer config, and back."""
    jo = _CASES[case](jopt)
    to = _CASES[case](topt)
    there = jopt.deserialize(topt.serialize(to))
    assert type(there) is type(jo)
    assert there.get_config() == jo.get_config()
    assert topt.serialize(topt.deserialize(jopt.serialize(jo))) == \
        topt.serialize(to)


def test_bench_optimizer_is_optax_adamw_defaults():
    """``optax.adamw(3e-4)`` (bench.py) is AdamW(3e-4, epsilon=1e-8,
    weight_decay=1e-4, decay_1d=True) in the port."""
    rng = np.random.default_rng(1)
    params = _tree(rng)
    g = jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
    tx = optax.adamw(3e-4)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    updates, _ = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                           tx.init(jp), jp)
    ttx = topt.AdamW(3e-4, epsilon=1e-8, weight_decay=1e-4,
                     decay_1d=True).to_transform()
    tp = jax.tree_util.tree_map(torch.from_numpy, params)
    tu, _ = ttx.update(jax.tree_util.tree_map(torch.from_numpy, g),
                       ttx.init(tp), tp)
    for a, b in zip(jax.tree_util.tree_leaves(updates),
                    jax.tree_util.tree_leaves(tu)):
        # updates of ~3e-4: 1e-8 is a few f32 ulps of the update
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-8,
                                   rtol=0)


@pytest.mark.parametrize("ident", ["sgd", "Adam", "adamw",
                                   {"class_name": "SGD",
                                    "config": {"lr": 0.5, "momentum": 0.9}}])
def test_get_by_name_and_config(ident):
    opt = topt.get(ident)
    assert isinstance(opt, topt.Optimizer)
    assert topt.get(opt) is opt
    if isinstance(ident, dict):
        assert opt.learning_rate == 0.5 and opt.momentum == 0.9


@pytest.mark.parametrize("name", ["adagrad", "Lion", "LAMB", "adafactor"])
def test_unported_optimizers_raise(name):
    with pytest.raises(NotImplementedError):
        topt.get(name)


def test_unknown_optimizer_and_schedules_raise():
    with pytest.raises(ValueError):
        topt.get("nope")
    with pytest.raises(NotImplementedError):
        topt.Adam(learning_rate={"class_name": "ExponentialDecay"})
