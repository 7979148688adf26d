"""``BaseModel.fit`` of the port against the JAX package's.

The JAX model's initial weights go into the port's model
(``set_weights(get_weights())``); both then train 2 epochs on 256 rows of
the conftest's MNIST-like (categorical cross-entropy, ``acc``) and
housing (mse, ``mae``, rank-1 labels) data, without shuffling and
without dropout (the packages' random streams differ), with a
validation split. After ``fit`` the weights agree within atol 1e-5, and
so do ``predict`` and the ``History`` values (loss, metrics,
``val_*``) and ``evaluate``; those two also take rtol 1e-6, because the
housing losses are in the hundreds, where one f32 ulp is 3e-5.
Optimizers: SGD with momentum and with Nesterov, Adam, AdamW and
RMSprop. ``compute_dtype="bfloat16"`` is held to running and to a
falling loss.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from elephas_tpu.models import core as jcore
from elephas_tpu.models import layers as jlayers
from elephas_tpu.models import optimizers as jopt
from elephas_tpu_torch.models import core as tcore
from elephas_tpu_torch.models import layers as tlayers
from elephas_tpu_torch.models import optimizers as topt
from elephas_tpu_torch.models.callbacks import EarlyStopping, LambdaCallback
from tests.torch_one_thread import one_thread

_OPTIMIZERS = {
    # name: (factory(module, lr scale), lr scale per dataset)
    "sgd_momentum": lambda m, s: m.SGD(0.05 * s, momentum=0.9),
    "sgd_nesterov": lambda m, s: m.SGD(0.05 * s, momentum=0.9,
                                       nesterov=True),
    "adam": lambda m, s: m.Adam(1e-3),
    "adamw": lambda m, s: m.AdamW(1e-3, weight_decay=0.05),
    "rmsprop": lambda m, s: m.RMSprop(1e-3),
}
_LR_SCALE = {"mnist": 1.0, "housing": 0.02}


def _stack(m, data):
    if data == "mnist":
        return [m.Dense(32, activation="relu", input_dim=784),
                m.Dense(10, activation="softmax")]
    return [m.Dense(16, activation="relu", input_shape=(13,)), m.Dense(1)]


def _compile_args(data):
    if data == "mnist":
        return "categorical_crossentropy", ["acc"]
    return "mse", ["mae"]


def _data(data, mnist_data, housing_data, n=256):
    x, y = (mnist_data if data == "mnist" else housing_data)[:2]
    return x[:n], y[:n]


def _models(data, opt, **compile_kw):
    loss, metrics = _compile_args(data)
    jlayers.reset_layer_uids()
    jm = jcore.Sequential(_stack(jlayers, data))
    jm.compile(_OPTIMIZERS[opt](jopt, _LR_SCALE[data]), loss, metrics,
               seed=0, **compile_kw)
    tlayers.reset_layer_uids()
    tm = tcore.Sequential(_stack(tlayers, data), device="cpu")
    tm.compile(_OPTIMIZERS[opt](topt, _LR_SCALE[data]), loss, metrics,
               seed=0, **compile_kw)
    tm.set_weights(jm.get_weights())
    return jm, tm


@pytest.mark.parametrize("data", ["mnist", "housing"])
@pytest.mark.parametrize("opt", sorted(_OPTIMIZERS))
def test_fit_matches_jax(opt, data, mnist_data, housing_data):
    x, y = _data(data, mnist_data, housing_data)
    jm, tm = _models(data, opt)
    kw = dict(epochs=2, batch_size=32, shuffle=False, validation_split=0.125)
    jh = jm.fit(x, y, **kw).history
    th = tm.fit(x, y, **kw).history
    assert list(th) == list(jh)
    for key in jh:
        np.testing.assert_allclose(th[key], jh[key], atol=1e-5, rtol=1e-6)
    for a, b in zip(jm.get_weights(), tm.get_weights()):
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tm.evaluate(x, y, batch_size=48),
                               jm.evaluate(x, y, batch_size=48), atol=1e-5,
                               rtol=1e-6)
    np.testing.assert_allclose(tm.predict(x[:50], batch_size=16),
                               np.asarray(jm.predict(x[:50], batch_size=16)),
                               atol=1e-5, rtol=0)


def test_fit_continues_with_the_optimizer_state(mnist_data, housing_data):
    """A second fit() call picks the Adam moments up where the first left
    them, as in the JAX package; train_on_batch steps the same way."""
    x, y = _data("mnist", mnist_data, housing_data, n=128)
    jm, tm = _models("mnist", "adam")
    for model in (jm, tm):
        model.fit(x, y, epochs=1, batch_size=32, shuffle=False)
        model.fit(x, y, epochs=1, batch_size=32, shuffle=False)
    jr = jm.train_on_batch(x[:32], y[:32])
    tr = tm.train_on_batch(x[:32], y[:32])
    np.testing.assert_allclose(tr, jr, atol=1e-5, rtol=0)
    for a, b in zip(jm.get_weights(), tm.get_weights()):
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)


def test_sparse_labels_match_jax(mnist_data):
    x, y = mnist_data[0][:128], np.argmax(mnist_data[1][:128], axis=1)
    models = []
    for layers_mod, core_mod, opt_mod, kw in (
            (jlayers, jcore, jopt, {}), (tlayers, tcore, topt,
                                         {"device": "cpu"})):
        layers_mod.reset_layer_uids()
        m = core_mod.Sequential(_stack(layers_mod, "mnist"), **kw)
        m.compile(opt_mod.SGD(0.1), "sparse_categorical_crossentropy",
                  ["acc"], seed=0)
        models.append(m)
    jm, tm = models
    tm.set_weights(jm.get_weights())
    jh = jm.fit(x, y, epochs=2, batch_size=32, shuffle=False).history
    th = tm.fit(x, y, epochs=2, batch_size=32, shuffle=False).history
    for key in jh:
        np.testing.assert_allclose(th[key], jh[key], atol=1e-5, rtol=0)


def test_bf16_compute_runs_and_learns(mnist_data, housing_data):
    x, y = _data("mnist", mnist_data, housing_data, n=512)
    _, tm = _models("mnist", "sgd_momentum", compute_dtype="bfloat16")
    assert tm._compute_dtype == torch.bfloat16
    h = tm.fit(x, y, epochs=3, batch_size=32, shuffle=True).history
    assert all(np.isfinite(h["loss"])) and h["loss"][-1] < h["loss"][0]
    for w in tm.params.values():
        assert all(t.dtype == torch.float32 for t in w.values())
    assert tm.predict(x[:4]).dtype == np.float32
    with pytest.raises(ValueError):
        tm.compile("sgd", "mse", compute_dtype="float16")


def test_callbacks_see_each_epoch_and_can_stop(mnist_data, housing_data):
    x, y = _data("mnist", mnist_data, housing_data, n=128)
    _, tm = _models("mnist", "sgd_momentum")
    events = []

    def on_epoch_end(epoch, logs):
        events.append(("epoch", epoch, sorted(logs)))
        tm.stop_training = epoch == 1

    cb = LambdaCallback(on_epoch_end=on_epoch_end,
                        on_batch_end=lambda b, logs: events.append(
                            ("batch", b, logs["size"])))
    h = tm.fit(x, y, epochs=5, batch_size=48, callbacks=[cb])
    assert len(h.history["loss"]) == 2
    assert [e for e in events if e[0] == "epoch"] == [
        ("epoch", 0, ["acc", "loss"]), ("epoch", 1, ["acc", "loss"])]
    assert [e[2] for e in events if e[0] == "batch"] == [48, 48, 32] * 2
    # EarlyStopping that never sees an improvement restores nothing and
    # stops after `patience` epochs
    stop = EarlyStopping(monitor="loss", patience=1, mode="max")
    h = tm.fit(x, y, epochs=6, batch_size=32, callbacks=[stop])
    assert len(h.history["loss"]) == 2 and stop.stopped_epoch == 1


def test_unported_optimizers_and_save_raise(tmp_path):
    # every optimizer of the JAX package is ported: nadam resolves
    assert isinstance(topt.get("nadam"), topt.Nadam)
    with pytest.raises(ValueError, match="Unknown optimizer"):
        topt.get("adamax")
    tlayers.reset_layer_uids()
    m = tcore.Sequential([tlayers.Dense(2, input_dim=3)], device="cpu")
    m.compile("rmsprop", "mse")
    assert isinstance(m.optimizer, topt.RMSprop)
    # saving is ported: the file is written, and only a refused
    # overwrite raises
    path = str(tmp_path / "model.h5")
    m.save(path)
    with pytest.raises(FileExistsError):
        m.save(path, overwrite=False)
