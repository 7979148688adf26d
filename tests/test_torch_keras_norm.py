"""The port's BatchNormalization and its moving statistics against the
JAX package, and the new layers and optimizers through checkpoints and
model files.

- The layer's forward and gradient in training (batch statistics) and
  inference (moving statistics) on the same seeded parameters, f32,
  within 1e-5 of the larger of 1 and each array's largest magnitude
  (``layer_parity`` of ``test_torch_keras_conv.py``).
- The moving statistics after 3 steps (24 rows, batch 8, no shuffle) of
  ``fit``, ``train_on_batch``, the sync step trainer and the sync
  average over 2 workers (whose copies' statistics average like the
  weights) on a Conv2D -> BatchNormalization model: every weight, the
  statistics included, within atol 1e-5 of the JAX package's, and the
  statistics moved. One asynchronous worker (batch and epoch frequency)
  moves them as the JAX ``TPUModel``'s worker does, within 1e-5.
- A checkpoint of that model under Adafactor (factored at
  ``min_dim_size_to_factor=2``, so its state holds row and column
  moments and ``(1,)`` placeholders) written by either package restores
  bit-equal in the other (weights, moving statistics, every optimizer
  leaf), and both then train one more epoch within atol 1e-5; the JAX
  package's HDF5 model file with BatchNormalization and Adafactor loads
  in the port with its statistics, optimizer config and predictions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from elephas_tpu.models import callbacks as jcallbacks
from elephas_tpu.models import core as jcore
from elephas_tpu.models import layers as jlayers
from elephas_tpu.models import optimizers as jopt
from elephas_tpu.models import saving as jsaving
from elephas_tpu.parallel import sync_trainer as jst
from elephas_tpu.tpu_model import TPUModel as JTPUModel
from elephas_tpu.utils import checkpoint as jckpt
from elephas_tpu.utils.dataset_utils import to_dataset as jto_dataset
from elephas_tpu_torch import TPUModel, to_dataset
from elephas_tpu_torch.models import core as tcore
from elephas_tpu_torch.models import layers as tlayers
from elephas_tpu_torch.models import optimizers as topt
from elephas_tpu_torch.models.callbacks import ModelCheckpoint
from elephas_tpu_torch.models.saving import load_model
from elephas_tpu_torch.parallel import sync_trainer as tst
from elephas_tpu_torch.utils.sockets import free_port
from tests.test_torch_keras_conv import layer_parity
from tests.torch_one_thread import one_thread


@pytest.mark.parametrize("training", [True, False])
def test_batch_normalization_matches_jax(training):
    x = np.random.default_rng(1).normal(1.0, 2.0, (6, 4, 4, 3)).astype(
        np.float32)
    layer_parity(lambda m: m.BatchNormalization(momentum=0.9, epsilon=1e-3),
                 (4, 4, 3), x, training=training,
                 positive=("gamma", "moving_variance"))


def test_moving_updates_use_the_biased_variance():
    layer = tlayers.BatchNormalization(momentum=0.8)
    x = torch.tensor([[1.0, 2.0], [3.0, 6.0]])
    params = {"moving_mean": torch.zeros(2), "moving_variance": torch.ones(2)}
    new = layer.moving_updates(params, x)
    torch.testing.assert_close(new["moving_mean"], 0.2 * torch.tensor([2.0, 4.0]))
    # biased: var([1, 3]) = 1, var([2, 6]) = 4
    torch.testing.assert_close(new["moving_variance"],
                               0.8 + 0.2 * torch.tensor([1.0, 4.0]))


# no bias before the normalization, which removes it: its gradient would
# be rounding noise, which Adam and Adafactor scale up to full steps
def _bn_model(m):
    return [m.Conv2D(4, 3, use_bias=False, input_shape=(6, 6, 2)),
            m.BatchNormalization(momentum=0.9), m.Activation("relu"),
            m.Flatten(), m.Dense(3, activation="softmax")]


def _pair(opt=lambda m: m.Adam(1e-2), layers=_bn_model):
    jlayers.reset_layer_uids()
    jm = jcore.Sequential(layers(jlayers))
    jm.compile(opt(jopt), "categorical_crossentropy", seed=0)
    tlayers.reset_layer_uids()
    tm = tcore.Sequential(layers(tlayers), device="cpu")
    tm.compile(opt(topt), "categorical_crossentropy", seed=1)
    tm.set_weights(jm.get_weights())
    return jm, tm


def _data(n=24, seed=2, shape=(6, 6, 2)):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.5, 1.0, (n,) + shape).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]


def _moving(model):
    name = next(l.name for l in model.layers
                if type(l).__name__ == "BatchNormalization")
    return [np.asarray(model.params[name][k])
            for k in ("moving_mean", "moving_variance")]


@pytest.mark.parametrize("route", ["fit", "train_on_batch", "sync_step",
                                   "sync_average"])
def test_moving_statistics_match_jax(route):
    jm, tm = _pair()
    x, y = _data()
    start = _moving(tm)
    loss = "categorical_crossentropy"
    kw = dict(epochs=1, batch_size=8, shuffle=False)
    if route == "fit":
        jm.fit(x, y, **kw)
        tm.fit(x, y, **kw)
        jw, tw = jm.get_weights(), tm.get_weights()
    elif route == "train_on_batch":
        for s in range(0, 24, 8):
            jm.train_on_batch(x[s:s + 8], y[s:s + 8])
            tm.train_on_batch(x[s:s + 8], y[s:s + 8])
        jw, tw = jm.get_weights(), tm.get_weights()
    elif route == "sync_step":
        jw, _ = jst.SyncStepTrainer(jm, jopt.Adam(1e-2), loss).fit(
            jm.get_weights(), x, y, validation_split=0.0, **kw)
        tw, _ = tst.SyncStepTrainer(tm, topt.Adam(1e-2), loss).fit(
            tm.get_weights(), x, y, validation_split=0.0, **kw)
    else:
        x2, y2 = _data(seed=3)
        shards = [(x, y), (x2, y2)]
        jw, _ = jst.SyncAverageTrainer(jm, jopt.Adam(1e-2), loss).run(
            jm.get_weights(), shards, validation_split=0.0, seed=0, **kw)
        tw, _ = tst.SyncAverageTrainer(tm, topt.Adam(1e-2), loss).run(
            tm.get_weights(), shards, validation_split=0.0, seed=0, **kw)
    for a, b in zip(jw, tw):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-5, rtol=0)
    tm.set_weights(tw)
    for before, after in zip(start, _moving(tm)):
        assert np.abs(after - before).max() > 1e-3   # the statistics moved


def _dense_bn(m):
    return [m.Dense(8, use_bias=False, input_dim=20), m.BatchNormalization(),
            m.Activation("tanh"), m.Dense(3, activation="softmax")]


@pytest.mark.parametrize("frequency,transport,batch", [
    ("batch", "socket", 16), ("epoch", "http", 32)])
def test_async_worker_moves_the_statistics_as_jax(frequency, transport,
                                                  batch):
    jm, tm = _pair(layers=_dense_bn)
    x, y = _data(40, shape=(20,))
    for tpu_cls, net, ds in ((JTPUModel, jm, jto_dataset),
                             (TPUModel, tm, to_dataset)):
        tpu_cls(net, mode="asynchronous", frequency=frequency,
                parameter_server_mode=transport, num_workers=1,
                port=free_port()).fit(ds(x, y), epochs=2, batch_size=batch,
                                      validation_split=0.2)
    for a, b in zip(jm.get_weights(), tm.get_weights()):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-5, rtol=0)
    assert np.abs(_moving(tm)[0]).max() > 1e-3


# ------------------------------------------ checkpoints and model files
def _adafactor(m):
    return m.Adafactor(1e-2, min_dim_size_to_factor=2)


def _opt_leaves(model, jax_side):
    if jax_side:
        return [np.asarray(v) for v in
                jax.tree_util.tree_leaves(model._opt_state)]
    return [t.numpy() for t in topt.opt_state_leaves(model._opt_state)]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_adafactor_bn_checkpoint_crosses_packages(tmp_path, monkeypatch,
                                                  writer):
    monkeypatch.setattr(jckpt, "_HAS_ORBAX", False)
    jm, tm = _pair(_adafactor)
    x, y = _data()
    kw = dict(batch_size=8, shuffle=False)
    ckpt = str(tmp_path / "ckpt")
    if writer == "port":
        tm.fit(x, y, epochs=1, callbacks=[ModelCheckpoint(ckpt)], **kw)
        assert jm.restore_training_state(ckpt) == 0
    else:
        jm.fit(x, y, epochs=1, callbacks=[jcallbacks.ModelCheckpoint(ckpt)],
               **kw)
        assert tm.restore_training_state(ckpt) == 0
    for a, b in zip(jm.get_weights(), tm.get_weights()):
        np.testing.assert_array_equal(b, np.asarray(a))
    got, want = _opt_leaves(tm, False), _opt_leaves(jm, True)
    # the count, then a row, a column and a full moment for each of the
    # 5 trainable parameters
    assert len(got) == len(want) == 16
    assert {w.shape for w in want} >= {(1,), ()}
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    jh = jm.fit(x, y, epochs=1, **kw).history
    th = tm.fit(x, y, epochs=1, **kw).history
    np.testing.assert_allclose(th["loss"], jh["loss"], atol=1e-5, rtol=0)
    for a, b in zip(jm.get_weights(), tm.get_weights()):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-5, rtol=0)


def test_jax_model_file_with_bn_and_adafactor_loads_in_the_port(tmp_path):
    jm, _ = _pair(_adafactor)
    x, y = _data()
    jm.fit(x, y, epochs=1, batch_size=8, shuffle=False)
    path = str(tmp_path / "bn.h5")
    jsaving.save_model(jm, path)
    tm = load_model(path, device="cpu")
    assert isinstance(tm.optimizer, topt.Adafactor)
    assert topt.serialize(tm.optimizer) == jopt.serialize(jm.optimizer)
    for a, b in zip(_moving(jm), _moving(tm)):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_allclose(tm.predict(x), np.asarray(jm.predict(x)),
                               atol=1e-5, rtol=0)
    # and back through the port's own file
    tm.save(str(tmp_path / "port.h5"))
    again = load_model(str(tmp_path / "port.h5"), device="cpu")
    for a, b in zip(tm.get_weights(), again.get_weights()):
        np.testing.assert_array_equal(a, b)
