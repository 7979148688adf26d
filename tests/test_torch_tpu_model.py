"""``TPUModel`` of the port in synchronous mode.

The reference's oracle (``tests/integration/test_end_to_end.py``) for
both sync modes x ``num_workers`` None/2 on the conftest's
classification model with Dropout 0.2: distributed predict's argmax
equals the master network's, distributed evaluate is within 0.01 of the
master's, and the training loss falls. The regression cases follow it
(scalar labels included). A ``TransformerModel`` (2 layers, d_model 32)
goes to the port's own ``TransformerModel.fit``, and its ``predict`` /
``evaluate`` through ``TPUModel`` equal the JAX ``TPUModel``'s on the
same weights (logits atol 1e-4, loss 1e-5, as the LM training tests
hold them). ``num_workers=None`` takes the dataset's partition count,
the CUDA device count here (1 without a card; 8 in the JAX package on
the conftest's CPU mesh), so comparisons with JAX pass it explicitly.
The async modes construct their parameter server here (their training
is in ``test_torch_tpu_model_async.py``); a sharded plane and hot
standbys raise.
On the full 60,000-row MNIST-like set of ``chip_smoke.py``, sync-step
SGD at 0.01 trains the bench's MLP in both packages and SGD at 0.1 (the
bench's rate) does not: its loss rises in the second epoch
(``pytest tests/test_torch_tpu_model.py -k sgd_rate -s`` prints the
epoch losses and accuracies of both).
"""
from math import isclose

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from elephas_tpu.data import Dataset as JDataset
from elephas_tpu.models import optimizers as jopt
from elephas_tpu.models.transformer_model import TransformerModel as JModel
from elephas_tpu.tpu_model import TPUModel as JTPUModel
from elephas_tpu_torch import (SGD, Activation, Dataset, Dense, Dropout,
                               Sequential, TPUModel, to_dataset)
from elephas_tpu_torch.models import optimizers as topt
from elephas_tpu_torch.models.callbacks import LambdaCallback
from elephas_tpu_torch.models.transformer_model import TransformerModel
from elephas_tpu_torch.utils import dict_to_model, encode_label, model_to_dict
from elephas_tpu_torch.weights import to_numpy_tree
from elephas_tpu.models import transformer as jtr
from elephas_tpu_torch.models import transformer as ttr
from elephas_tpu_torch.utils.sockets import free_port
from tests.test_torch_train import _configs, _tokens


def _classification_model():
    model = Sequential(device="cpu")
    model.add(Dense(128, input_dim=784))
    model.add(Activation("relu"))
    model.add(Dropout(0.2))
    model.add(Dense(128))
    model.add(Activation("relu"))
    model.add(Dropout(0.2))
    model.add(Dense(10))
    model.add(Activation("softmax"))
    return model


def _regression_model():
    model = Sequential(device="cpu")
    model.add(Dense(64, activation="relu", input_shape=(13,)))
    model.add(Dense(64, activation="relu"))
    model.add(Dense(1, activation="linear"))
    return model


@pytest.mark.parametrize("sync_mode", ["average", "step"])
@pytest.mark.parametrize("num_workers", [None, 2])
def test_training_classification(sync_mode, num_workers, mnist_data):
    x_train, y_train, x_test, y_test = mnist_data
    model = _classification_model()
    model.compile(SGD(learning_rate=0.1), "categorical_crossentropy", ["acc"],
                  seed=0)
    tpu_model = TPUModel(model, mode="synchronous", sync_mode=sync_mode,
                         num_workers=num_workers)
    tpu_model.fit(to_dataset(x_train[:1000], y_train[:1000]), epochs=3,
                  batch_size=64, verbose=0, validation_split=0.1)

    histories = tpu_model.training_histories
    assert len(histories) == (1 if sync_mode == "step" else num_workers or 1)
    for h in histories:
        assert h["loss"][-1] < h["loss"][0]

    predictions = tpu_model.predict(x_test)
    ds_predictions = tpu_model.predict(Dataset((x_test,)))
    master_preds = tpu_model.master_network.predict(x_test)
    assert predictions.shape == (len(x_test), 10)
    np.testing.assert_array_equal(predictions.argmax(1),
                                  ds_predictions.argmax(1))
    np.testing.assert_array_equal(predictions.argmax(1),
                                  master_preds.argmax(1))

    evals = tpu_model.evaluate(x_test, y_test)
    master_evals = tpu_model.master_network.evaluate(x_test, y_test)
    assert isclose(evals[0], master_evals[0], abs_tol=0.01)
    assert isclose(evals[1], master_evals[1], abs_tol=0.01)


@pytest.mark.parametrize("sync_mode", ["average", "step"])
@pytest.mark.parametrize("num_workers", [None, 2])
def test_training_regression(sync_mode, num_workers, housing_data):
    x_train, y_train, x_test, y_test = housing_data
    model = _regression_model()
    model.compile(SGD(learning_rate=1e-7), "mse",
                  ["mae", "mean_absolute_percentage_error"], seed=0)
    tpu_model = TPUModel(model, mode="synchronous", sync_mode=sync_mode,
                         num_workers=num_workers)
    tpu_model.fit(to_dataset(x_train, y_train), epochs=3, batch_size=64,
                  verbose=0, validation_split=0.1)
    predictions = tpu_model.predict(x_test)
    master_preds = tpu_model.master_network.predict(x_test)
    assert all(np.isclose(p, m, 0.01) for p, m in zip(predictions,
                                                      master_preds))
    evals = tpu_model.evaluate(x_test, y_test)
    master_evals = tpu_model.master_network.evaluate(x_test, y_test)
    assert len(evals) == 3
    for got, want in zip(evals, master_evals):
        assert isclose(got, want, abs_tol=0.01)


def test_sync_average_scalar_labels_learn(housing_data):
    """Rank-1 labels are rank-aligned before the masked loss."""
    x_train, y_train, _, _ = housing_data
    model = _regression_model()
    model.compile(SGD(learning_rate=0.01), "mse", seed=0)
    before = model.evaluate(x_train, y_train)
    tpu_model = TPUModel(model, mode="synchronous", num_workers=2)
    tpu_model.fit(to_dataset(x_train, y_train), epochs=10, batch_size=32,
                  validation_split=0.0)
    after = model.evaluate(x_train, y_train)
    assert np.isscalar(after) and after < before * 0.9
    assert np.isscalar(tpu_model.evaluate(x_train, y_train))


def test_callbacks_per_epoch_in_step_mode_once_in_average(mnist_data):
    x, y = mnist_data[0][:256], mnist_data[1][:256]
    for sync_mode, expected in (("step", [0, 1, 2]), ("average", [0])):
        model = _classification_model()
        model.compile(SGD(0.1), "categorical_crossentropy", ["acc"], seed=0)
        seen = []
        cb = LambdaCallback(on_epoch_end=lambda e, logs: seen.append(
            (e, sorted(logs))))
        tpu_model = TPUModel(model, mode="synchronous", sync_mode=sync_mode,
                             num_workers=2)
        tpu_model.fit(to_dataset(x, y), epochs=3, batch_size=32,
                      callbacks=[cb])
        assert [e for e, _ in seen] == expected
        assert "loss" in seen[0][1] and "categorical_accuracy" in seen[0][1]


def test_predict_streams_into_a_npy_file(mnist_data, tmp_path):
    model = _classification_model()
    model.compile(SGD(0.1), "categorical_crossentropy", seed=0)
    tpu_model = TPUModel(model, mode="synchronous", batch_size=16)
    path = str(tmp_path / "preds.npy")
    out = tpu_model.predict(mnist_data[0][:300], out=path)
    np.testing.assert_allclose(np.load(path), model.predict(
        mnist_data[0][:300]), atol=1e-6, rtol=0)
    assert out.shape == (300, 10)


def test_config_matches_the_jax_tpu_model():
    model = _classification_model()
    model.compile(SGD(0.1), "categorical_crossentropy", seed=0)
    tpu_model = TPUModel(model, mode="synchronous", sync_mode="step",
                         num_workers=2, batch_size=16)
    from elephas_tpu.models import SGD as JSGD
    from elephas_tpu.models import core as jcore
    from elephas_tpu.models import layers as jlayers

    jm = jcore.Sequential([jlayers.Dense(4, input_dim=3)])
    jm.compile(JSGD(0.1), "mse", seed=0)
    jtpu = JTPUModel(jm, mode="synchronous", sync_mode="step",
                     num_workers=2, batch_size=16)
    assert tpu_model.get_config() == jtpu.get_config()
    assert tpu_model.master_optimizer == jopt.serialize(JSGD(0.1))
    # the async keys: servers are built (not started) at construction
    async_kw = dict(mode="hogwild", frequency="batch",
                    parameter_server_mode="socket", async_overlap=True,
                    async_accum=4, on_worker_failure="continue",
                    max_worker_restarts=1, min_workers=0.75,
                    ps_auto_restart=True, ps_probe_interval=1.0,
                    max_ps_restarts=3, ps_pipeline=True,
                    delta_compression="int8", num_workers=2)
    tpu_model = TPUModel(model, port=free_port(), **async_kw)
    jtpu = JTPUModel(jm, port=free_port(), **async_kw)
    assert tpu_model.get_config() == jtpu.get_config()
    assert tpu_model.get_config()["async_accum"] == 4


@pytest.mark.parametrize("mode", ["asynchronous", "hogwild"])
def test_unported_modes_raise(mode):
    """The async modes run on one parameter server; a sharded plane and
    hot standbys (ROADMAP Queue 1 item 4's remainder) raise."""
    model = _classification_model()
    model.compile(SGD(0.1), "categorical_crossentropy", seed=0)
    tpu_model = TPUModel(model, mode=mode, port=free_port())
    assert tpu_model.parameter_server is not None
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        TPUModel(model, mode=mode, ps_shards=2)
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        TPUModel(model, mode=mode, ps_shards=2, ps_standby=True)


def test_unported_and_invalid_surfaces_raise():
    model = _classification_model()
    with pytest.raises(Exception, match="Compile"):
        TPUModel(model, mode="synchronous")
    model.compile(SGD(0.1), "categorical_crossentropy", seed=0)
    with pytest.raises(ValueError):
        TPUModel(model, mode="synchronous", sync_mode="bulk")
    tpu_model = TPUModel(model, mode="synchronous")
    with pytest.raises(NotImplementedError):
        tpu_model.save("model.h5")
    with pytest.raises(AttributeError):   # no server in synchronous mode
        tpu_model.start_server()
    with pytest.raises(ValueError):
        TPUModel(model, mode="bulk").fit(to_dataset(np.zeros((4, 784)),
                                                    np.zeros((4, 10))))


def test_dataset_partitions_match_jax():
    rng = np.random.default_rng(0)
    x, y = rng.random((23, 3)), rng.random(23)
    for parts in (1, 2, 5):
        tds, jds = Dataset((x, y), parts), JDataset((x, y), parts)
        assert tds.partition_sizes() == jds.partition_sizes()
        assert tds.partition_bounds() == jds.partition_bounds()
        for (tx, ty), (jx, jy) in zip(tds.partitions(), jds.partitions()):
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)
    ds = Dataset.from_pairs(list(zip(x, y))).repartition(3)
    assert ds.num_partitions == 3 and ds.count() == len(ds) == 23
    np.testing.assert_array_equal(ds.to_arrays()[0], x)
    assert len(ds.rows()) == 23 and np.allclose(ds.first()[0], x[0])
    assert to_dataset(x, y).num_partitions == max(1,
                                                  torch.cuda.device_count())
    np.testing.assert_array_equal(encode_label(2, 4), [0, 0, 1, 0])


def test_model_dict_round_trip(mnist_data):
    model = _classification_model()
    model.compile(SGD(0.1), "categorical_crossentropy", seed=0)
    copy = dict_to_model(model_to_dict(model), device="cpu")
    x = mnist_data[2][:8]
    np.testing.assert_array_equal(copy.predict(x), model.predict(x))


def _lm_pair():
    jcfg, tcfg = _configs()
    jm = JModel(jcfg).compile(jopt.SGD(0.5), seed=0)
    tm = TransformerModel(tcfg, device="cpu").compile(topt.SGD(0.5), seed=3)
    tm.set_weights(jm.get_weights())
    return jm, tm


def test_tpu_model_routes_a_transformer(tmp_path):
    jm, tm = _lm_pair()
    twin = TransformerModel(_configs()[1], device="cpu").compile(
        topt.SGD(0.5), seed=3)
    twin.set_weights(tm.get_weights())
    tokens = _tokens(9, (10, 17))
    tpu_model = TPUModel(tm, mode="synchronous", batch_size=4)
    tpu_model.fit(tokens, epochs=2, validation_split=0.2, seed=1)
    # delegated to TransformerModel.fit: the same history and weights as
    # calling it directly
    want = twin.fit(tokens, epochs=2, batch_size=4, validation_split=0.2,
                    seed=1)
    got = tpu_model.training_histories[-1]
    assert set(got) == {"loss", "val_loss", "epoch_time"}
    assert got["loss"] == want["loss"] and got["val_loss"] == want["val_loss"]
    for a, b in zip(twin.get_weights(), tm.get_weights()):
        np.testing.assert_array_equal(a, b)
    # predict / evaluate against the JAX TPUModel on the trained weights
    jm.set_weights(tm.get_weights())
    jtpu = JTPUModel(jm, mode="synchronous", batch_size=4)
    probe = _tokens(10, (5, 17))
    path = str(tmp_path / "logits.npy")
    logits = tpu_model.predict((probe, None), out=path)
    assert logits.shape == (5, 17, 64)
    np.testing.assert_allclose(np.load(path), np.asarray(jtpu.predict(probe)),
                               atol=1e-4, rtol=0)
    assert abs(tpu_model.evaluate(probe, None)
               - jtpu.evaluate(probe, None)) <= 1e-5


def test_tpu_model_lm_at_head_dim_32_matches_jax():
    """``TPUModel`` over ``TransformerModel`` at head dim 32 (2 layers,
    d_model 64, 2 heads, vocab 64; the head dim of
    examples/transformer_tpumodel.py) against the JAX ``TPUModel`` from
    the same weights (the port's init, handed to the JAX model, whose
    own init would compile for seconds), f32: the fit history (2
    epochs, batch 8, the same shuffle seed, validation split 0.2 of 40
    rows: 8 held out, a multiple of the JAX package's 8-device data
    axis, to which it trims the held-out rows) within 1e-5."""
    kw = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=64,
              d_ff=128, max_seq_len=24)
    tcfg = ttr.TransformerConfig(dtype=torch.float32, **kw)
    assert tcfg.head_dim == 32
    tm = TransformerModel(tcfg, device="cpu").compile(topt.SGD(0.5), seed=3)
    jm = JModel(jtr.TransformerConfig(dtype=jnp.float32,
                                      attention_impl="xla", **kw))
    jm.params, jm.built = to_numpy_tree(tm.params), True
    jm.compile(jopt.SGD(0.5))
    tokens = np.random.default_rng(12).integers(0, 64, (40, 17))
    hists = []
    for tpu_model in (JTPUModel(jm, mode="synchronous", batch_size=8),
                      TPUModel(tm, mode="synchronous", batch_size=8)):
        tpu_model.fit(tokens, epochs=2, validation_split=0.2, seed=1)
        hists.append(tpu_model.training_histories[-1])
    want, got = hists
    assert len(got["val_loss"]) == len(want["val_loss"]) == 2
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-5, rtol=0)


def _bench_mlp(mod, **kw):
    """bench.py's MLP, 784-128-128-10, in either package."""
    return mod.Sequential([mod.Dense(128, activation="relu", input_dim=784),
                           mod.Dense(128, activation="relu"),
                           mod.Dense(10, activation="softmax")], **kw)


@pytest.fixture(scope="module")
def full_mnist_like():
    from tests.conftest import _make_classification

    return _make_classification(60000, 784, 10, seed=0)


@pytest.mark.parametrize("lr", [0.1, 0.01])
def test_sgd_rate_on_the_full_mnist_like_set(lr, full_mnist_like):
    """chip_smoke's ``keras_sync_step`` set-up on the CPU: two shuffled
    epochs at batch 64 through ``TPUModel(sync_mode="step")``, one
    worker, in both packages."""
    import elephas_tpu.models as jmodels
    import elephas_tpu_torch as tpkg

    x, y = full_mnist_like
    runs = {}
    for name, mod, opt, tpu_cls, ds, kw in (
            ("jax", jmodels, jopt, JTPUModel, JDataset.from_arrays, {}),
            ("torch", tpkg, topt, TPUModel, to_dataset, {"device": "cpu"})):
        model = _bench_mlp(mod, **kw)
        model.compile(opt.SGD(learning_rate=lr), "categorical_crossentropy",
                      ["acc"], seed=0)
        tm = tpu_cls(model, mode="synchronous", sync_mode="step",
                     batch_size=64, num_workers=1)
        tm.fit(ds(x, y), epochs=2, batch_size=64, validation_split=0.0)
        hist = tm.training_histories[-1]
        runs[name] = (hist["loss"], hist["categorical_accuracy"])
    print(f"SGD {lr}: epoch (loss, accuracy) {runs}")
    for losses, accs in runs.values():
        assert np.isfinite(losses).all()
        if lr == 0.1:   # the bench's rate fails on this set
            assert losses[1] > losses[0] and accs[1] < 0.5
        else:           # chip_smoke's rate trains
            assert losses[1] < losses[0] and accs[1] > 0.9
