"""The port's model files, ``TPUModel.save``/``load_tpu_model``,
``TPUMatrixModel`` and the ``mllib`` types.

Mirrors ``tests/test_model_serialization.py`` (Sequential, extra
kwargs, functional, the matrix model, and the three hadoop failures,
here through a monkeypatched ``subprocess.run``),
``tests/test_matrix_model.py``, ``tests/mllib/test_adapter.py`` and the
LabeledPoint cases of ``tests/utils/test_dataset_utils.py`` (each
against the JAX function on the same input), and the object-store
cases of ``tests/utils/test_storage.py`` through a registered
``LocalMirrorStore``. The container: a zip at exactly the caller's path
(no ``.npz`` appended), read with ``allow_pickle=False``; ``.keras``
names work and other suffixes raise; ``overwrite=False`` raises on an
existing file or object; an unknown container raises ``ValueError``,
and an HDF5 file with h5py missing an ``ImportError`` naming h5py. A
``TPUModel`` file the JAX package wrote (HDF5, the MLP and a 2-layer LM
of d_model 32) loads in the port with bit-equal weights, equal configs
and ``predict`` within 1e-5. Round trips within the port are bit-exact.
"""
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from elephas_tpu import tpu_model as jtpu
from elephas_tpu.mllib import adapter as jadapter
from elephas_tpu.models import optimizers as jopt
from elephas_tpu.models import transformer as jtr
from elephas_tpu.models.transformer_model import TransformerModel as JModel
from elephas_tpu.utils import dataset_utils as jdu
from elephas_tpu_torch import tpu_model as ttpu
from elephas_tpu_torch.mllib import (DenseMatrix, DenseVector, Matrices,
                                     Vectors, from_matrix, from_vector,
                                     to_matrix, to_vector)
from elephas_tpu_torch.models import (SGD, Activation, Adam, Dense, Dropout,
                                      Input, Model, Sequential, load_model,
                                      save_model)
from elephas_tpu_torch.models import transformer as ttr
from elephas_tpu_torch.models.transformer_model import TransformerModel
from elephas_tpu_torch.tpu_model import (TPUMatrixModel, TPUModel,
                                         load_tpu_model)
from elephas_tpu_torch.utils import dataset_utils as tdu
from elephas_tpu_torch.utils.checkpoint import CheckpointManager
from elephas_tpu_torch.utils.storage import (LocalMirrorStore, get_store,
                                             is_remote, register_store,
                                             split_scheme)
from elephas_tpu_torch.weights import to_numpy_tree


def _classification_model(dropout=0.2):
    drop = [Dropout(dropout)] if dropout else []
    return Sequential([Dense(128, input_dim=784), Activation("relu"), *drop,
                       Dense(128), Activation("relu"), *drop, Dense(10),
                       Activation("softmax")], device="cpu")


def _functional_model():
    inputs = Input(shape=(784,))
    hidden = Dense(128, activation="relu")(inputs)
    hidden = Dropout(0.2)(hidden)
    hidden = Dense(128, activation="relu")(hidden)
    outputs = Dense(10, activation="softmax")(Dropout(0.2)(hidden))
    return Model(inputs=inputs, outputs=outputs, device="cpu")


def _x(n=4):
    return np.random.default_rng(0).random((n, 784), dtype=np.float32)


def _compiled(model, opt=None):
    model.compile(opt or SGD(), "categorical_crossentropy", ["acc"], seed=0)
    return model


# ----------------------------------------------- test_model_serialization
def test_tpu_model_save_load_sequential(tmp_path):
    model = _compiled(_classification_model())
    tpu_model = TPUModel(model, frequency="epoch", mode="synchronous")
    path = str(tmp_path / "elephas_sequential.h5")
    tpu_model.save(path)
    loaded = load_tpu_model(path, device="cpu")
    assert isinstance(loaded, TPUModel) and type(loaded) is TPUModel
    assert loaded.mode == "synchronous" and loaded.frequency == "epoch"
    assert loaded.get_config() == tpu_model.get_config()
    assert loaded.master_network.to_json() == model.to_json()
    assert loaded.master_optimizer == tpu_model.master_optimizer
    np.testing.assert_array_equal(loaded.master_network.predict(_x()),
                                  model.predict(_x()))


def test_tpu_model_save_load_extra_kwargs(tmp_path):
    model = _compiled(_classification_model())
    tpu_model = TPUModel(model, mode="synchronous",
                         custom_metadata="experiment-7")
    path = str(tmp_path / "with_kwargs.h5")
    tpu_model.save(path)
    loaded = load_tpu_model(path, device="cpu")
    assert loaded.kwargs.get("custom_metadata") == "experiment-7"


def test_tpu_model_save_load_functional(tmp_path):
    model = _compiled(_functional_model())
    path = str(tmp_path / "functional.keras")
    TPUModel(model, mode="synchronous").save(path)
    loaded = load_tpu_model(path, device="cpu")
    assert isinstance(loaded.master_network, Model)
    np.testing.assert_array_equal(loaded.master_network.predict(_x()),
                                  model.predict(_x()))


def test_matrix_model_save_load(tmp_path):
    model = _compiled(_classification_model())
    matrix_model = TPUMatrixModel(model, mode="synchronous", num_workers=2)
    path = str(tmp_path / "matrix.h5")
    matrix_model.save(path)
    loaded = load_tpu_model(path, device="cpu")
    assert isinstance(loaded, TPUMatrixModel)
    assert loaded.num_workers == 2


def _fake_run(returncode=None, missing=False, calls=None):
    def run(cli, **kwargs):
        if calls is not None:
            calls.append(list(cli))
        if missing:
            raise FileNotFoundError(cli[0])
        return subprocess.CompletedProcess(cli, returncode, "",
                                           "put: no filesystem")
    return run


def test_save_to_hadoop_failure_raises(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(ttpu.subprocess, "run", _fake_run(1, calls=calls))
    monkeypatch.chdir(tmp_path)
    tpu_model = TPUModel(_compiled(_classification_model()),
                         mode="synchronous")
    with pytest.raises(RuntimeError, match="moveFromLocal failed") as err:
        tpu_model.save(str(tmp_path / "model.h5"), to_hadoop=True,
                       overwrite=True)
    assert calls[0][:4] == ["hadoop", "fs", "-moveFromLocal", "-f"]
    assert calls[0][-1] == str(tmp_path / "model.h5")
    import re
    kept = re.search(r"local copy kept at (\S+)\)", str(err.value)).group(1)
    # the staged copy survives the failed put and is a loadable file
    assert isinstance(load_tpu_model(str(tmp_path / kept), device="cpu"),
                      TPUModel)


def test_save_to_hadoop_missing_cli_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(ttpu.subprocess, "run", _fake_run(missing=True))
    monkeypatch.chdir(tmp_path)
    tpu_model = TPUModel(_compiled(_classification_model()),
                         mode="synchronous")
    with pytest.raises(RuntimeError, match="hadoop CLI not found"):
        tpu_model.save(str(tmp_path / "model.h5"), to_hadoop=True)


def test_load_from_hadoop_failure_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(ttpu.subprocess, "run", _fake_run(1))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="copyToLocal failed"):
        load_tpu_model("hdfs/model.h5", from_hadoop=True, device="cpu")


# ------------------------------------------------------------ the container
def test_path_is_kept_exactly_and_entries_are_plain_arrays(tmp_path):
    model = _compiled(_classification_model(), Adam(1e-3))
    path = tmp_path / "model.h5"
    TPUModel(model, mode="synchronous").save(str(path))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["model.h5"]
    assert path.read_bytes()[:4] == b"PK\x03\x04"
    with np.load(path, allow_pickle=False) as data:
        names = sorted(data.files)
        assert names == sorted(["model_config", "training_config",
                                "distributed_config"]
                               + [f"model_weights/weight_{i}"
                                  for i in range(6)])
        config = json.loads(bytes(data["distributed_config"]))
        assert config == {"class_name": "TPUModel",
                          "config": TPUModel(model, mode="synchronous")
                          .get_config()}
        training = json.loads(bytes(data["training_config"]))
        assert training["optimizer"]["class_name"] == "Adam"
        assert data["model_weights/weight_0"].dtype == np.float32


def test_save_model_round_trip_and_overwrite(tmp_path):
    model = _compiled(_classification_model(0.0), Adam(1e-3))
    model.compile(Adam(1e-3), "categorical_crossentropy", ["acc"],
                  compute_dtype="bfloat16")
    path = str(tmp_path / "m.keras")
    model.save(path)
    with pytest.raises(FileExistsError):
        save_model(model, path, overwrite=False)
    loaded = load_model(path, device="cpu")
    assert loaded._compute_dtype == torch.bfloat16
    assert loaded.optimizer.get_config() == model.optimizer.get_config()
    for a, b in zip(loaded.get_weights(), model.get_weights()):
        np.testing.assert_array_equal(a, b)
    bare = str(tmp_path / "bare.h5")
    save_model(model, bare, include_optimizer=False)
    assert not load_model(bare, device="cpu").compiled


def test_suffix_is_checked(tmp_path):
    tpu_model = TPUModel(_compiled(_classification_model()),
                         mode="synchronous")
    with pytest.raises(ValueError, match=".h5' or '.keras'"):
        tpu_model.save(str(tmp_path / "model.npz"))
    with pytest.raises(ValueError, match=".h5' or '.keras'"):
        load_tpu_model(str(tmp_path / "model.bin"), device="cpu")


def test_pickled_entries_are_refused(tmp_path):
    path = tmp_path / "evil.h5"
    with open(path, "wb") as f:
        np.savez(f, model_config=np.array([{"x": 1}], dtype=object))
    with pytest.raises(ValueError, match="allow_pickle"):
        load_tpu_model(str(path), device="cpu")


def test_unknown_container_raises(tmp_path):
    path = tmp_path / "junk.h5"
    path.write_bytes(b"not a model file at all")
    with pytest.raises(ValueError, match="neither a zip"):
        load_model(str(path), device="cpu")


def test_hdf5_without_h5py_names_it(tmp_path, monkeypatch):
    import h5py

    path = str(tmp_path / "jax.h5")
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = b"{}"
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        load_model(path, device="cpu")


# ----------------------------------------------------------- object stores
@pytest.fixture
def mirror(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)        # staged temp files land here
    store = LocalMirrorStore(str(tmp_path / "remote"))
    register_store("gs", store)
    yield store
    register_store("gs", None)


def test_save_load_through_an_object_store(mirror, tmp_path):
    model = _compiled(_classification_model())
    tpu_model = TPUModel(model, mode="synchronous")
    url = "gs://bucket/models/m.h5"
    tpu_model.save(url)
    assert mirror.exists(url)
    with pytest.raises(FileExistsError):
        tpu_model.save(url)
    tpu_model.save(url, overwrite=True)
    loaded = load_tpu_model(url, device="cpu")
    np.testing.assert_array_equal(loaded.master_network.predict(_x()),
                                  model.predict(_x()))
    # no staged copy is left behind
    assert sorted(p.name for p in tmp_path.iterdir()) == ["remote"]
    with pytest.raises(ValueError, match="mutually exclusive"):
        tpu_model.save(url, to_hadoop=True)


def test_checkpoint_manager_mirrors_to_an_object_store(mirror):
    manager = CheckpointManager("gs://bucket/ckpt", max_to_keep=2)
    for step in (1, 2, 3):
        manager.save(step, {"w": torch.full((3,), float(step))},
                     block=step != 3)
    assert manager.steps() == [2, 3]
    assert not mirror.exists("gs://bucket/ckpt/step_1")
    fresh = CheckpointManager("gs://bucket/ckpt")      # a new process
    assert fresh.latest_step() == 3
    np.testing.assert_array_equal(fresh.restore(2)["w"], np.full(3, 2.0,
                                                                 np.float32))


@pytest.mark.parametrize("url", ["gs://b/k", "s3://b/k/x", "file:///tmp/a",
                                 "/tmp/a", "GS://b"])
def test_split_scheme_matches_jax(url):
    from elephas_tpu.utils import storage as jstorage

    assert split_scheme(url) == jstorage.split_scheme(url)
    assert is_remote(url) == jstorage.is_remote(url)


def test_get_store_refuses_a_local_path():
    with pytest.raises(ValueError, match="local path"):
        get_store("/tmp/model.h5")


# ----------------------------------------------------- JAX-written files
def test_jax_written_mlp_loads_in_the_port(tmp_path, classification_model):
    classification_model.compile(jopt.Adam(1e-3), "categorical_crossentropy",
                                 ["acc"], seed=0)
    jtm = jtpu.TPUModel(classification_model, mode="synchronous",
                        num_workers=2, custom_metadata="x")
    path = str(tmp_path / "jax.h5")
    jtm.save(path)
    assert open(path, "rb").read(8) == b"\x89HDF\r\n\x1a\n"
    loaded = load_tpu_model(path, device="cpu")
    assert type(loaded) is TPUModel
    assert loaded.get_config() == jtm.get_config()
    assert loaded.master_optimizer == jtm.master_optimizer
    for a, b in zip(loaded.master_network.get_weights(),
                    classification_model.get_weights()):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_allclose(
        loaded.master_network.predict(_x(8)),
        np.asarray(classification_model.predict(_x(8))), atol=1e-5, rtol=0)


def test_jax_written_lm_loads_in_the_port(tmp_path):
    kw = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
              max_seq_len=16)
    tm = TransformerModel(ttr.TransformerConfig(dtype=torch.float32, **kw),
                          device="cpu").compile(Adam(1e-2), seed=0)
    jm = JModel(jtr.TransformerConfig(dtype=jnp.float32,
                                      attention_impl="xla", **kw))
    jm.params = jax.tree_util.tree_map(jnp.asarray, to_numpy_tree(tm.params))
    jm.built = True
    jm.compile(jopt.Adam(1e-2))
    jtm = jtpu.TPUModel(jm, mode="synchronous")
    path = str(tmp_path / "lm.h5")
    jtm.save(path)
    loaded = load_tpu_model(path, device="cpu")
    model = loaded.master_network
    assert isinstance(model, TransformerModel)
    assert model.get_config() == json.loads(jm.to_json())["config"]
    assert model.config.attention_impl == "xla"
    assert loaded.get_config() == jtm.get_config()
    for a, b in zip(model.get_weights(), jm.get_weights()):
        np.testing.assert_array_equal(a, np.asarray(b))
    tokens = np.random.default_rng(1).integers(0, 64, (4, 16))
    np.testing.assert_allclose(loaded.predict(tokens),
                               np.asarray(jm.predict(tokens)), atol=1e-5,
                               rtol=0)


def test_lm_round_trip_is_bit_exact(tmp_path):
    cfg = ttr.TransformerConfig(vocab_size=64, num_layers=2, num_heads=4,
                                d_model=32, d_ff=64, max_seq_len=16,
                                dtype=torch.float32,
                                param_dtype=torch.bfloat16)
    model = TransformerModel(cfg, device="cpu").compile(Adam(1e-2), seed=0)
    tpu_model = TPUModel(model, mode="synchronous", batch_size=4)
    path = str(tmp_path / "lm.keras")
    tpu_model.save(path)
    loaded = load_tpu_model(path, device="cpu")
    assert loaded.master_network.get_config() == model.get_config()
    assert loaded.batch_size == 4
    for a, b in zip(loaded.master_network.get_weights(), model.get_weights()):
        assert a.dtype == np.dtype("V2")          # bf16 bits
        np.testing.assert_array_equal(a, b)
    tokens = np.random.default_rng(1).integers(0, 64, (4, 16))
    np.testing.assert_array_equal(loaded.predict(tokens),
                                  tpu_model.predict(tokens))


# ------------------------------------------------------------ matrix model
def test_matrix_model_training_and_predict(mnist_data):
    x_train, y_train, x_test, _ = mnist_data
    x_train, y_train = x_train[:400], y_train[:400]
    model = _compiled(_classification_model(), SGD(learning_rate=0.1))
    lp_ds = tdu.to_labeled_points(x_train, y_train, categorical=True)
    matrix_model = TPUMatrixModel(model, mode="synchronous", num_workers=2)
    matrix_model.fit(lp_ds, epochs=2, batch_size=32, verbose=0,
                     validation_split=0.1, categorical=True, nb_classes=10)
    matrix_preds = matrix_model.predict(to_matrix(x_test[:16]))
    assert isinstance(matrix_preds, DenseMatrix)
    assert matrix_preds.toArray().shape == (16, 10)
    np.testing.assert_array_equal(
        matrix_preds.toArray(),
        model.predict(x_test[:16].astype(np.float64)).astype(np.float64))
    vector_preds = matrix_model.predict(to_vector(x_test[0]))
    assert isinstance(vector_preds, DenseVector) and len(vector_preds) == 10
    np.testing.assert_allclose(vector_preds.toArray(),
                               matrix_preds.toArray()[0], atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="Matrix or Vector"):
        matrix_model.predict(x_test[:2])


def test_matrix_model_predicts_as_jax_does(mnist_data, classification_model):
    x = mnist_data[2][:8]
    classification_model.compile(jopt.SGD(), "categorical_crossentropy",
                                 seed=0)
    jmm = jtpu.TPUMatrixModel(classification_model, mode="synchronous")
    model = _compiled(_classification_model())
    model.set_weights(classification_model.get_weights())
    tmm = TPUMatrixModel(model, mode="synchronous")
    assert tmm.num_workers == jmm.num_workers == 4
    np.testing.assert_allclose(
        tmm.predict(to_matrix(x)).toArray(),
        jmm.predict(jadapter.to_matrix(x)).toArray(), atol=1e-5, rtol=0)


# ---------------------------------------------------- mllib and LabeledPoints
def test_to_matrix():
    mat = to_matrix(np.ones((4, 2)))
    assert mat.numRows == 4 and mat.numCols == 2
    with pytest.raises(Exception, match="two-dimensional"):
        to_matrix(np.ones(3))


def test_from_matrix():
    assert from_matrix(Matrices.dense(1, 2, [13, 37])).shape == (1, 2)


def test_matrix_round_trip_matches_jax():
    x = np.arange(12, dtype=float).reshape(3, 4)
    assert np.array_equal(from_matrix(to_matrix(x)), x)
    np.testing.assert_array_equal(to_matrix(x)._values,
                                  jadapter.to_matrix(x)._values)


def test_to_vector():
    assert len(to_vector(np.ones((3,)))) == 3
    with pytest.raises(Exception, match="one-dimensional"):
        to_vector(np.ones((2, 2)))


def test_from_vector():
    assert from_vector(Vectors.dense([4, 2])).shape == (2,)


@pytest.mark.parametrize("categorical", [True, False])
def test_labeled_points_match_jax(categorical):
    rng = np.random.default_rng(0)
    x = rng.random((6, 5))
    y = (np.eye(3)[rng.integers(0, 3, 6)] if categorical
         else rng.random(6))
    tlp = tdu.to_labeled_points(x, y, categorical, num_partitions=2)
    jlp = jdu.to_labeled_points(x, y, categorical, num_partitions=2)
    assert [(p.label, p.features.toArray().tolist()) for p in tlp.rows()] \
        == [(p.label, p.features.toArray().tolist()) for p in jlp.rows()]
    for got, want in ((tdu.from_labeled_points(tlp, categorical),
                       jdu.from_labeled_points(jlp, categorical)),
                      (tdu.lp_to_dataset(tlp, categorical).to_arrays(),
                       jdu.lp_to_dataset(jlp, categorical).to_arrays())):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert tdu.lp_to_dataset(tlp, categorical)._num_partitions == 2


def test_config_dicts_match_jax():
    from elephas_tpu.models import saving as jsaving
    from elephas_tpu_torch.models import saving as tsaving

    kw = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
              max_seq_len=16)
    tcfg = ttr.TransformerConfig(param_dtype=torch.bfloat16, **kw)
    jcfg = jtr.TransformerConfig(param_dtype=jnp.bfloat16, **kw)
    d = tsaving.config_to_dict(tcfg)
    assert d == jsaving.config_to_dict(jcfg)
    assert d["param_dtype"] == "bfloat16" and d["dtype"] == "bfloat16"
    assert tsaving.config_from_dict(json.loads(json.dumps(d))) == tcfg
    with pytest.raises(NotImplementedError, match="item 6"):
        tsaving.config_from_dict({**d, "__class__": "ViTConfig"})
