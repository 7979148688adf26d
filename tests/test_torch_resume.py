"""``ModelCheckpoint`` and bit-exact resume in the port, and checkpoints
crossing between the packages.

The port's own cases mirror ``tests/models/test_callbacks.py``
(``test_model_checkpoint_and_resume``, ``save_best_only``) and
``tests/models/test_transformer_model.py``
(``test_checkpoint_and_bitexact_resume``): a fresh model with other
auto-generated layer names and another init restores params, optimizer
moments and count bit-equal, ``block=False`` writes what a blocking save
writes, ``max_to_keep`` collects old steps, and a reused instance (or a
new one on the same directory) numbers its epochs after the last step.
A ``param_dtype=bfloat16`` LM restores bit-exact.

Across the packages, both ways (the JAX package writing npz: its
``_HAS_ORBAX`` is monkeypatched to False inside the test): after one
epoch of the writer, the other package's ``restore_training_state``
gives params and moments bit-equal (f32), and both then train one more
epoch from that state without shuffling (the LM walks the same seeded
permutation in both) with losses and weights within atol 1e-5, the
tolerance of ``test_torch_keras_fit.py``. The MLP is the 784-wide one
of that file on 128 rows; the LM has 2 layers, d_model 32, vocab 64,
seq 16.
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
from elephas_tpu.models import transformer as jtr
from elephas_tpu.models.transformer_model import TransformerModel as JModel
from elephas_tpu.utils import checkpoint as jckpt
from elephas_tpu_torch import TPUModel
from elephas_tpu_torch.models import core as tcore
from elephas_tpu_torch.models import layers as tlayers
from elephas_tpu_torch.models import optimizers as topt
from elephas_tpu_torch.models import transformer as ttr
from elephas_tpu_torch.models.callbacks import ModelCheckpoint
from elephas_tpu_torch.models.transformer_model import TransformerModel
from elephas_tpu_torch.utils.checkpoint import CheckpointManager
from elephas_tpu_torch.weights import to_numpy_tree, tree_leaves
from tests.torch_one_thread import one_thread


def _data(n=256):
    rng = np.random.default_rng(0)
    x = rng.random((n, 4), dtype=np.float32)
    return x, (x @ np.array([1.0, -2.0, 0.5, 3.0], np.float32))


def _mlp(lr=0.01, seed=0):
    model = tcore.Sequential([tlayers.Dense(8, input_dim=4,
                                            activation="relu"),
                              tlayers.Dense(1)], device="cpu")
    model.compile(topt.Adam(learning_rate=lr), "mse", seed=seed)
    return model


def _opt_leaves(model):
    return [t.numpy() for t in topt.opt_state_leaves(model._opt_state)]


def _assert_same_state(a, b):
    """Weights and optimizer leaves bit-equal (both port models)."""
    for x, y in zip(a.get_weights(), b.get_weights()):
        np.testing.assert_array_equal(x, y)
    got, want = _opt_leaves(a), _opt_leaves(b)
    assert len(got) == len(want) > 0
    for x, y in zip(got, want):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("block", [True, False])
def test_model_checkpoint_and_resume(tmp_path, block):
    x, y = _data()
    ckpt_dir = str(tmp_path / "ckpts")
    model = _mlp()
    model.fit(x, y, epochs=3, batch_size=32,
              callbacks=[ModelCheckpoint(ckpt_dir, block=block)])
    assert CheckpointManager(ckpt_dir).latest_step() == 2
    resumed = _mlp(seed=1)          # other layer names, other init
    assert [l.name for l in resumed.layers] != [l.name for l in model.layers]
    assert resumed.restore_training_state(ckpt_dir) == 2
    assert [l.name for l in resumed.layers] == [l.name for l in model.layers]
    _assert_same_state(resumed, model)
    np.testing.assert_array_equal(resumed.predict(x[:8]), model.predict(x[:8]))
    # training continues; a new instance numbers after the last step
    hist = resumed.fit(x, y, epochs=1, batch_size=32,
                       callbacks=[ModelCheckpoint(ckpt_dir, block=block)])
    assert np.isfinite(hist.history["loss"]).all()
    assert CheckpointManager(ckpt_dir).latest_step() == 3


def _check_async_checkpoint_equals_blocking(tmp_path):
    x, y = _data()
    states = []
    for block in (True, False):
        # both models get the same layer names, whatever the layer-uid
        # counter stood at: the restored states are dicts keyed by layer
        # name, which flatten in string order (dense_10 before dense_9)
        tlayers.reset_layer_uids()
        model = _mlp()
        model.fit(x, y, epochs=2, batch_size=32, shuffle=False,
                  callbacks=[ModelCheckpoint(str(tmp_path / str(block)),
                                             block=block)])
        states.append(CheckpointManager(str(tmp_path / str(block))).restore())
    flat = [jax.tree_util.tree_leaves(s) for s in states]
    assert len(flat[0]) == len(flat[1]) == 4 + 9
    for a, b in zip(*flat):
        np.testing.assert_array_equal(a, b)


def test_async_checkpoint_equals_blocking(tmp_path):
    _check_async_checkpoint_equals_blocking(tmp_path)


@pytest.mark.parametrize("made_before", [7, 97])
def test_async_checkpoint_equals_blocking_after_other_layers(tmp_path,
                                                             made_before):
    """After 7 or 97 Dense layers, where two models built in a row get
    names on both sides of a decimal boundary (``dense_9``/``dense_10``)
    when the counter started at zero."""
    for _ in range(made_before):
        tlayers.Dense(1)
    _check_async_checkpoint_equals_blocking(tmp_path)


def test_model_checkpoint_save_best_only(tmp_path):
    x, y = _data()
    ckpt_dir = str(tmp_path / "best")
    model = _mlp(lr=0.0)      # the loss never improves after epoch 0
    model.fit(x, y, epochs=4, batch_size=64, shuffle=False,
              callbacks=[ModelCheckpoint(ckpt_dir, monitor="loss",
                                         save_best_only=True)])
    assert CheckpointManager(ckpt_dir).steps() == [0]


def test_save_best_only_warns_on_a_missing_monitor(tmp_path):
    x, y = _data()
    ckpt_dir = str(tmp_path / "none")
    with pytest.warns(UserWarning, match="no checkpoints will be written"):
        _mlp().fit(x, y, epochs=2, batch_size=64,
                   callbacks=[ModelCheckpoint(ckpt_dir, monitor="val_loss",
                                              save_best_only=True)])
    assert CheckpointManager(ckpt_dir).steps() == []


def test_max_to_keep_and_a_reused_instance(tmp_path):
    x, y = _data()
    ckpt_dir = str(tmp_path / "keep")
    callback = ModelCheckpoint(ckpt_dir, max_to_keep=3)
    model = _mlp()
    model.fit(x, y, epochs=2, batch_size=64, callbacks=[callback])
    assert callback.manager.steps() == [0, 1]
    model.fit(x, y, epochs=3, batch_size=64, callbacks=[callback])
    assert callback.manager.steps() == [2, 3, 4]
    assert sorted(p.name for p in (tmp_path / "keep").iterdir()) == [
        "manifest.json", "step_2", "step_3", "step_4"]


def test_checkpoint_on_preemption_is_uninstalled_after_fit(tmp_path):
    import signal

    before = signal.getsignal(signal.SIGTERM)
    x, y = _data()
    _mlp().fit(x, y, epochs=1, batch_size=64,
               callbacks=[ModelCheckpoint(str(tmp_path / "p"),
                                          checkpoint_on_preemption=True)])
    assert signal.getsignal(signal.SIGTERM) == before


# ---------------------------------------------------------------- the LM
def _lm_config(**kw):
    return ttr.TransformerConfig(vocab_size=64, num_layers=2, num_heads=4,
                                 d_model=32, d_ff=64, max_seq_len=16,
                                 dtype=torch.float32, **kw)


def _lm_tokens(rows=32, seed=1):
    return np.random.default_rng(seed).integers(0, 64, (rows, 16))


def _assert_lm_state_equal(a, b):
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    got = topt.opt_state_leaves(a._opt_state)
    want = topt.opt_state_leaves(b._opt_state)
    assert len(got) == len(want) == 1 + 2 * 28
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_lm_checkpoint_and_bitexact_resume(tmp_path, param_dtype):
    cfg = _lm_config(param_dtype=getattr(torch, param_dtype))
    ckpt_dir = str(tmp_path / "lm")
    tokens = _lm_tokens()
    model = TransformerModel(cfg, device="cpu").compile(topt.Adam(1e-2),
                                                        seed=0)
    TPUModel(model, mode="synchronous").fit(
        tokens, epochs=3, batch_size=8, validation_split=0.0,
        callbacks=[ModelCheckpoint(ckpt_dir)])
    assert CheckpointManager(ckpt_dir).latest_step() == 2
    resumed = TransformerModel(cfg, device="cpu").compile(topt.Adam(1e-2),
                                                          seed=7)
    assert resumed.restore_training_state(ckpt_dir) == 2
    _assert_lm_state_equal(resumed, model)
    TPUModel(resumed, mode="synchronous").fit(
        tokens, epochs=1, batch_size=8, validation_split=0.0,
        callbacks=[ModelCheckpoint(ckpt_dir)])
    assert CheckpointManager(ckpt_dir).latest_step() == 3


def test_lm_restore_needs_compile(tmp_path):
    model = TransformerModel(_lm_config(), device="cpu").compile(
        topt.Adam(1e-2), seed=0)
    model.fit(_lm_tokens(), epochs=1, batch_size=8,
              callbacks=[ModelCheckpoint(str(tmp_path / "c"))])
    bare = TransformerModel(_lm_config(), device="cpu").build(seed=1)
    with pytest.raises(RuntimeError, match="compile"):
        bare.restore_training_state(str(tmp_path / "c"))


# ------------------------------------------------------- across packages
def _mnist_models():
    jlayers.reset_layer_uids()
    jm = jcore.Sequential([jlayers.Dense(32, activation="relu",
                                         input_dim=784),
                           jlayers.Dense(10, activation="softmax")])
    jm.compile(jopt.Adam(1e-3), "categorical_crossentropy", ["acc"], seed=0)
    tm = tcore.Sequential([tlayers.Dense(32, activation="relu",
                                         input_dim=784),
                           tlayers.Dense(10, activation="softmax")],
                          device="cpu")
    tm.compile(topt.Adam(1e-3), "categorical_crossentropy", ["acc"], seed=1)
    return jm, tm


def _jax_opt_leaves(model):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(model._opt_state)]


def _assert_cross_bit_equal(jm, tm):
    for a, b in zip(jm.get_weights(), tm.get_weights()):
        np.testing.assert_array_equal(np.asarray(a), b)
    got, want = _opt_leaves(tm), _jax_opt_leaves(jm)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_mlp_checkpoint_crosses_packages(tmp_path, monkeypatch, mnist_data,
                                         writer):
    monkeypatch.setattr(jckpt, "_HAS_ORBAX", False)
    x, y = mnist_data[0][:128], mnist_data[1][:128]
    jm, tm = _mnist_models()
    kw = dict(batch_size=32, shuffle=False)
    ckpt_dir = str(tmp_path / "ckpt")
    if writer == "port":
        tm.set_weights(jm.get_weights())
        tm.fit(x, y, epochs=1, callbacks=[ModelCheckpoint(ckpt_dir)], **kw)
        assert jm.restore_training_state(ckpt_dir) == 0
    else:
        jm.fit(x, y, epochs=1,
               callbacks=[jcallbacks.ModelCheckpoint(ckpt_dir)], **kw)
        assert tm.restore_training_state(ckpt_dir) == 0
    assert [l.name for l in tm.layers] == [l.name for l in jm.layers]
    _assert_cross_bit_equal(jm, tm)
    jh = jm.fit(x, y, epochs=1, **kw).history
    th = tm.fit(x, y, epochs=1, **kw).history
    for key in jh:
        np.testing.assert_allclose(th[key], jh[key], atol=1e-5, rtol=0)
    for a, b in zip(jm.get_weights(), tm.get_weights()):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-5, rtol=0)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_lm_checkpoint_crosses_packages(tmp_path, monkeypatch, writer):
    monkeypatch.setattr(jckpt, "_HAS_ORBAX", False)
    tm = TransformerModel(_lm_config(), device="cpu").compile(
        topt.Adam(1e-2), seed=0)
    jm = JModel(jtr.TransformerConfig(
        vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
        max_seq_len=16, dtype=jnp.float32, attention_impl="xla"))
    # the port's initial weights (skips the JAX init's per-op compiles)
    jm.params = jax.tree_util.tree_map(jnp.asarray, to_numpy_tree(tm.params))
    jm.built = True
    jm.compile(jopt.Adam(1e-2))
    tokens = _lm_tokens()
    kw = dict(batch_size=8, validation_split=0.0, seed=3)
    ckpt_dir = str(tmp_path / "ckpt")
    if writer == "port":
        tm.fit(tokens, epochs=1, callbacks=[ModelCheckpoint(ckpt_dir)], **kw)
        reader = jm
    else:
        jm.fit(tokens, epochs=1,
               callbacks=[jcallbacks.ModelCheckpoint(ckpt_dir)], **kw)
        reader = tm
    assert reader.restore_training_state(ckpt_dir) == 0
    for a, b in zip(jax.tree_util.tree_leaves(jm.params),
                    tree_leaves(tm.params)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    got = [t.numpy() for t in topt.opt_state_leaves(tm._opt_state)]
    want = _jax_opt_leaves(jm)
    assert len(got) == len(want) == 1 + 2 * 28
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    jh, th = jm.fit(tokens, epochs=1, **kw), tm.fit(tokens, epochs=1, **kw)
    np.testing.assert_allclose(th["loss"], jh["loss"], atol=1e-5, rtol=0)
    for a, b in zip(jax.tree_util.tree_leaves(jm.params),
                    tree_leaves(tm.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5,
                                   rtol=0)
