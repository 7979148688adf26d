"""The port's train step and TransformerModel against the JAX package.

Identical weights (the JAX ``init_params`` tree through the weight
bridge, or ``set_weights(jax_model.get_weights())``) and identical numpy
tokens go through both packages, each on its plain attention path (the
flash kernels are held against JAX in ``test_torch_flash_backward.py``
and ``test_torch_train.py``): ``make_train_step`` over three steps with
SGD (momentum) and AdamW, gradient accumulation, and
``TransformerModel.fit_tokens`` histories. f32 throughout. Tolerances:
step losses atol 1e-5; SGD parameters after three steps atol 1e-6;
AdamW parameters atol 2e-5 with epsilon 1e-5 (Adam divides by
sqrt(nu), so a near-zero gradient that differs in its last bits moves
its leaf by up to lr * |dg| / eps); accumulated steps atol 1e-6 (SGD);
``fit_tokens`` losses atol 1e-5 and weights after three epochs of
AdamW atol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

torch = pytest.importorskip("torch")

from elephas_tpu.models import optimizers as jopt
from elephas_tpu.models import transformer as jtr
from elephas_tpu.models.transformer_model import TransformerModel as JModel
from elephas_tpu_torch.models import optimizers as topt
from elephas_tpu_torch.models.callbacks import LambdaCallback
from elephas_tpu_torch.models import transformer as ttr
from elephas_tpu_torch.models.transformer_model import TransformerModel
from elephas_tpu_torch.weights import (from_numpy_tree, to_numpy_tree,
                                       tree_leaves)
from tests.test_torch_train import _configs, _params, _tokens
from tests.torch_one_thread import one_thread


def _run_steps(jo, variant="dense", accum=1, steps=3, seed=5):
    jcfg, tcfg = _configs(variant)
    jp, tp = _params(jcfg, seed=seed)
    to = topt.deserialize(jopt.serialize(jo))
    tx, ttx = jo.to_optax(), to.to_transform()
    jstep = jtr.make_train_step(jcfg, tx, accum_steps=accum)
    tstep = ttr.make_train_step(tcfg, ttx, accum_steps=accum)
    js, ts = tx.init(jp), ttx.init(tp)
    for i in range(steps):
        tokens = _tokens(10 + i, (4, 17))
        jp, js, jl = jstep(jp, js, jnp.asarray(tokens))
        out, ts, tl = tstep(tp, ts, torch.from_numpy(tokens))
        assert out is tp                     # updated in place
        assert abs(float(tl) - float(jl)) <= 1e-5
    return jp, tp


@pytest.mark.parametrize("opt,atol", [("sgd", 1e-6), ("adamw", 2e-5)])
def test_train_step_matches_jax(opt, atol):
    jo = (jopt.SGD(0.5, momentum=0.9) if opt == "sgd"
          else jopt.AdamW(1e-2, weight_decay=0.1, epsilon=1e-5))
    jp, tp = _run_steps(jo)
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=atol,
                                   rtol=0)


def test_accumulated_step_matches_jax():
    jp, tp = _run_steps(jopt.SGD(0.5), variant="gqa", accum=2, steps=2)
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6,
                                   rtol=0)


def test_fit_tokens_history_matches_jax():
    jcfg, tcfg = _configs("gqa")
    # one device: the test process holds a virtual 8-device CPU mesh
    one = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jm = JModel(jcfg, mesh=one).compile(jopt.AdamW(1e-2), seed=0)
    tm = TransformerModel(tcfg, device="cpu").compile(topt.AdamW(1e-2),
                                                      seed=1)
    tm.set_weights(jm.get_weights())
    tokens = _tokens(6, (12, 17))
    kw = dict(epochs=3, batch_size=4, validation_split=0.25, seed=3)
    ref, hist = jm.fit_tokens(tokens, **kw), tm.fit_tokens(tokens, **kw)
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose(hist[key], ref[key], atol=1e-5, rtol=0)
    assert len(hist["epoch_time"]) == 3 and len(tm.timer.durations) == 3
    assert hist["loss"][-1] < hist["loss"][0]
    for a, b in zip(jm.get_weights(), tm.get_weights()):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=0)
    assert abs(tm.evaluate(tokens) - jm.evaluate(tokens)) <= 1e-5
    np.testing.assert_allclose(tm.predict(tokens[:3]),
                               jm.predict(tokens[:3]), atol=1e-4, rtol=0)


def test_fit_with_accumulation_and_ema():
    """``grad_accum`` splits each batch, EMA tracks the parameters, and
    ``fit`` is ``fit_tokens`` with callbacks: each epoch's logs reach
    ``epoch_end``, and ``stop_training`` ends the fit."""
    _, tcfg = _configs()
    tokens = _tokens(7, (8, 17))
    one = TransformerModel(tcfg, device="cpu").compile(topt.SGD(0.5),
                                                       seed=2)
    two = TransformerModel(tcfg, device="cpu", grad_accum=2,
                           ema_decay=0.5).compile(topt.SGD(0.5), seed=2)
    h1 = one.fit(tokens, epochs=2, batch_size=4, seed=1)
    h2 = two.fit(tokens, epochs=2, batch_size=4, seed=1)
    np.testing.assert_allclose(h2["loss"], h1["loss"], atol=1e-5, rtol=0)
    raw = two.apply_ema()
    moved = [float(np.abs(a - b.numpy()).max())
             for a, b in zip(two.get_weights(), tree_leaves(raw))]
    assert max(moved) > 0                     # the average lags the params
    seen = []

    def stop_after_first(epoch, logs):
        seen.append((epoch, logs["loss"]))
        one.stop_training = True

    h3 = one.fit(tokens, epochs=3, batch_size=4, seed=1,
                 callbacks=[LambdaCallback(on_epoch_end=stop_after_first)])
    assert [e for e, _ in seen] == [0] and h3["loss"] == [seen[0][1]]


def test_train_step_with_dropout_takes_a_generator():
    _, tcfg = _configs(dropout_rate=0.1)
    params = ttr.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tx = topt.SGD(0.1).to_transform()
    step = ttr.make_train_step(tcfg, tx)
    tokens = torch.from_numpy(_tokens(11, (4, 17)))
    states = []
    for seed in (3, 3):
        p = from_numpy_tree(to_numpy_tree(params), device="cpu")
        _, _, loss = step(p, tx.init(p), tokens,
                          torch.Generator().manual_seed(seed))
        states.append((float(loss), tree_leaves(p)))
    assert states[0][0] == states[1][0]
    for a, b in zip(states[0][1], states[1][1]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("kw", [{"fsdp": True}, {"zero_optimizer": True},
                                {"seq_axis": "seq"}, {"mesh": object()}])
def test_unported_train_step_variants_raise(kw):
    _, tcfg = _configs()
    with pytest.raises(NotImplementedError):
        ttr.make_train_step(tcfg, topt.SGD(0.1).to_transform(), **kw)


@pytest.mark.parametrize("kw", [{"tensor_parallel": 2}, {"fsdp": True},
                                {"sequence_parallel": 2}])
def test_unported_model_arguments_raise(kw):
    _, tcfg = _configs()
    with pytest.raises(NotImplementedError):
        TransformerModel(tcfg, device="cpu", **kw)


def test_model_device_none_without_cuda_raises(monkeypatch):
    """The training entry point runs on the card unless the caller asks
    for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _configs()
    with pytest.raises(RuntimeError, match="CUDA"):
        TransformerModel(tcfg)
