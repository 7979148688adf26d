"""The port's Conv2D and pooling layers against the JAX package.

Each layer's forward and gradient (of ``sum(out * r)`` for a seeded
``r``, with respect to every parameter and the input) run on the same
seeded numpy parameters and inputs in both packages, f32, within 1e-5
of the larger of 1 and the compared array's largest magnitude (a
gradient summed over a batch of positions reaches tens, where the two
summation orders part in the 7th digit) (:func:`layer_parity`, which
the recurrent and normalization files share). The cases include SAME padding at stride 2 over odd and even
sizes (XLA pads the odd cell at the end) and both pools under SAME
(MaxPooling2D pads with -inf, AveragePooling2D divides by the cells
inside the image). A small model of Keras's ``mnist_cnn.py`` layers
(12x12x1) predicts and trains one epoch as the JAX model does (without
dropout in training, whose random streams differ), and its JSON loads in
either package. Last, ``tests/parallel/test_sync_average_conv.py``'s
claim on the port: its conv model under ``SyncAverageTrainer`` at 20
batches per partition (the JAX package's per-batch path) gives the JAX
weights within atol 1e-5 and losses within 1e-5 (no shuffle), and a
partition no larger than a batch stays untrained.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from elephas_tpu.models import core as jcore
from elephas_tpu.models import layers as jlayers
from elephas_tpu.models import optimizers as jopt
from elephas_tpu.parallel import sync_trainer as jst
from elephas_tpu_torch.models import core as tcore
from elephas_tpu_torch.models import layers as tlayers
from elephas_tpu_torch.models import optimizers as topt
from elephas_tpu_torch.parallel import sync_trainer as tst
from tests.torch_one_thread import one_thread


def layer_parity(make, shape, x, training=False, scale=0.3, seed=0,
                 tol=1e-5, positive=()):
    """Build the layer ``make(module)`` in both packages for the
    batch-less input ``shape``, give both the same seeded parameters
    (``positive`` ones drawn in [0.5, 1.5)), and compare the output and
    the gradients of ``sum(out * r)`` within ``tol`` times the larger of
    1 and each array's largest magnitude. Returns the two layers."""
    jlayers.reset_layer_uids()
    tlayers.reset_layer_uids()
    jl, tl = make(jlayers), make(tlayers)
    assert tl.get_config() == jl.get_config()
    assert tl.compute_output_shape(shape) == jl.compute_output_shape(shape)
    built = jl.build(jax.random.PRNGKey(0), shape)
    tbuilt = tl.build(torch.Generator().manual_seed(0), shape)
    assert sorted(built) == sorted(tbuilt)
    rng = np.random.default_rng(seed)
    params = {k: (rng.uniform(0.5, 1.5, v.shape) if k in positive
                  else scale * rng.normal(size=v.shape)).astype(np.float32)
              for k, v in built.items()}
    integer = np.issubdtype(x.dtype, np.integer)

    def jfwd(p, xx):
        return jl.call(p, xx, training, None)

    jout = jfwd({k: jnp.asarray(v) for k, v in params.items()},
                jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=not integer)
    tout = tl.call(tp, tx, training, None)
    assert tuple(tout.shape) == (x.shape[0],) + tuple(
        jl.compute_output_shape(shape))
    assert_close_scaled(tout.detach().numpy(), jout, tol, "output")
    r = rng.normal(size=jout.shape).astype(np.float32)
    names = sorted(params)
    argnums = (0,) if integer else (0, 1)
    jgrads = jax.grad(lambda p, xx: jnp.sum(jfwd(p, xx) * r),
                      argnums=argnums)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    wrt = [tp[k] for k in names] + ([] if integer else [tx])
    # a parameter the forward does not read (BatchNormalization's moving
    # statistics in training) has no gradient here and zeros in JAX
    tgrads = torch.autograd.grad((tout * torch.from_numpy(r)).sum(), wrt,
                                 allow_unused=True)
    want = [jgrads[0][k] for k in names] + ([] if integer else [jgrads[1]])
    for name, a, b, t in zip(names + ["input"], want, tgrads, wrt):
        got = torch.zeros_like(t) if b is None else b
        assert_close_scaled(got.numpy(), a, tol, name)
    return jl, tl


def assert_close_scaled(got, want, tol, what=""):
    """``|got - want| <= tol * max(1, max |want|)`` elementwise."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0,
                               err_msg=what)


def _images(shape, seed=1, n=3):
    return np.random.default_rng(seed).normal(
        size=(n,) + shape).astype(np.float32)


_CONV = {
    "valid": (lambda m: m.Conv2D(4, 3), (8, 8, 2)),
    "same": (lambda m: m.Conv2D(4, 3, padding="same"), (8, 8, 2)),
    # stride 2 over 9 and 7: XLA pads (1, 1) and (0, 1)
    "same_stride2_odd": (lambda m: m.Conv2D(3, (3, 2), strides=2,
                                            padding="same"), (9, 7, 2)),
    # stride 2 over 8: (0, 1), the extra cell at the end
    "same_stride2_even": (lambda m: m.Conv2D(3, 3, strides=2,
                                             padding="SAME"), (8, 8, 1)),
    "valid_stride21_relu_nobias": (
        lambda m: m.Conv2D(5, (2, 3), strides=(2, 1), activation="relu",
                           use_bias=False), (9, 8, 3)),
}


@pytest.mark.parametrize("case", sorted(_CONV))
def test_conv2d_matches_jax(case):
    make, shape = _CONV[case]
    layer_parity(make, shape, _images(shape))


_POOLS = {
    "max_valid": (lambda m: m.MaxPooling2D(2), (8, 6, 3)),
    "max_same_odd": (lambda m: m.MaxPooling2D(3, strides=2,
                                              padding="same"), (9, 7, 2)),
    "max_same_stride1": (lambda m: m.MaxPooling2D(2, strides=1,
                                                  padding="same"), (5, 5, 1)),
    "avg_valid": (lambda m: m.AveragePooling2D((2, 3)), (8, 9, 2)),
    "avg_same_odd": (lambda m: m.AveragePooling2D(3, strides=2,
                                                  padding="same"), (9, 7, 2)),
    "avg_same_stride1": (lambda m: m.AveragePooling2D(2, strides=1,
                                                      padding="same"),
                         (5, 5, 1)),
    "global_avg": (lambda m: m.GlobalAveragePooling2D(), (5, 7, 3)),
}


@pytest.mark.parametrize("case", sorted(_POOLS))
def test_pool_matches_jax(case):
    make, shape = _POOLS[case]
    layer_parity(make, shape, _images(shape))


def test_same_average_pool_divides_by_the_cells_inside():
    """A corner window of a 3x3 SAME pool over ones-and-a-spike counts 4
    cells, not 9 (``count_include_pad=False`` semantics)."""
    x = torch.ones((1, 4, 4, 1))
    out = tlayers.AveragePooling2D(3, strides=1, padding="same").call(
        {}, x, False, None)
    torch.testing.assert_close(out, torch.ones_like(out))
    x[0, 0, 0, 0] = 5.0
    out = tlayers.AveragePooling2D(3, strides=1, padding="same").call(
        {}, x, False, None)
    assert float(out[0, 0, 0, 0]) == pytest.approx((5.0 + 3.0) / 4.0)


def _mnist_cnn(m, drop=(0.25, 0.5)):
    """The layers of Keras's ``examples/mnist_cnn.py``, narrowed to a
    12x12x1 input."""
    return [m.Conv2D(4, (3, 3), activation="relu", input_shape=(12, 12, 1)),
            m.Conv2D(8, (3, 3), activation="relu"),
            m.MaxPooling2D(pool_size=(2, 2)), m.Dropout(drop[0]),
            m.Flatten(), m.Dense(16, activation="relu"),
            m.Dropout(drop[1]), m.Dense(10, activation="softmax")]


def _cnn_pair(drop):
    jlayers.reset_layer_uids()
    jm = jcore.Sequential(_mnist_cnn(jlayers, drop))
    jm.compile(jopt.Adam(1e-2), "categorical_crossentropy", ["acc"], seed=0)
    tlayers.reset_layer_uids()
    tm = tcore.Sequential(_mnist_cnn(tlayers, drop), device="cpu")
    tm.compile(topt.Adam(1e-2), "categorical_crossentropy", ["acc"], seed=1)
    tm.set_weights(jm.get_weights())
    return jm, tm


def _cnn_data(n=48, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 12, 12, 1), dtype=np.float32)
    return x, np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]


def test_mnist_cnn_predicts_and_loads_as_jax():
    jm, tm = _cnn_pair((0.25, 0.5))
    x, _ = _cnn_data()
    np.testing.assert_allclose(tm.predict(x, batch_size=16),
                               np.asarray(jm.predict(x, batch_size=16)),
                               atol=1e-5, rtol=0)
    to_port = tcore.model_from_json(jm.to_json(), device="cpu")
    to_port.set_weights(jm.get_weights())
    to_jax = jcore.model_from_json(tm.to_json())
    to_jax.set_weights(tm.get_weights())
    assert json.loads(to_port.to_json()) == json.loads(jm.to_json())
    np.testing.assert_allclose(to_port.predict(x),
                               np.asarray(to_jax.predict(x)), atol=1e-5,
                               rtol=0)


def test_mnist_cnn_fit_matches_jax():
    jm, tm = _cnn_pair((0.0, 0.0))
    x, y = _cnn_data()
    kw = dict(epochs=1, batch_size=16, shuffle=False)
    jh, th = jm.fit(x, y, **kw).history, tm.fit(x, y, **kw).history
    for key in jh:
        np.testing.assert_allclose(th[key], jh[key], atol=1e-5, rtol=0)
    for a, b in zip(jm.get_weights(), tm.get_weights()):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-5, rtol=0)


# ---------------- tests/parallel/test_sync_average_conv.py on the port
def _conv_model(m):
    return [m.Conv2D(8, 3, input_shape=(12, 12, 3), padding="same"),
            m.Activation("relu"), m.Flatten(), m.Dense(10),
            m.Activation("softmax")]


def _conv_shards(sizes=(80, 80), seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        x = rng.normal(0, 1, (n, 12, 12, 3)).astype(np.float32)
        out.append((x, np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]))
    return out


@pytest.mark.parametrize("sizes", [(80, 80), (80, 3)])
def test_sync_average_conv_matches_the_jax_per_batch_path(sizes):
    """Batch 4 over 80 rows is 20 batches, past the JAX trainer's unroll
    budget of 16: its per-batch path, which its own test holds to the
    vmapped program. The port's one loop gives the same weights and
    histories; a 3-row partition trains in neither."""
    jlayers.reset_layer_uids()
    jm = jcore.Sequential(_conv_model(jlayers))
    jm.compile(jopt.SGD(0.05), "categorical_crossentropy", seed=0)
    tlayers.reset_layer_uids()
    tm = tcore.Sequential(_conv_model(tlayers), device="cpu")
    tm.build()
    loss = "categorical_crossentropy"
    jt = jst.SyncAverageTrainer(jm, jopt.SGD(0.05), loss)
    tt = tst.SyncAverageTrainer(tm, topt.SGD(0.05), loss)
    shards = _conv_shards(sizes)
    kw = dict(epochs=2, batch_size=4, validation_split=0.0, shuffle=False,
              seed=3)
    w0 = jm.get_weights()
    jw, jh = jt.run(w0, shards, **kw)
    assert jt._step_fns, "the JAX per-batch path was not taken"
    tw, th = tt.run(w0, shards, **kw)
    for a, b in zip(jw, tw):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-5, rtol=0)
    assert [h is None for h in th] == [h is None for h in jh]
    assert th[-1] is None if sizes[-1] <= 4 else th[-1] is not None
    for a, b in zip(jh, th):
        if a is not None:
            np.testing.assert_allclose(b["loss"], a["loss"], atol=1e-5,
                                       rtol=0)
