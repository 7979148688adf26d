"""The port's Embedding, LSTM, GRU, LayerNormalization and merge layers
against the JAX package.

Forward and gradient on the same seeded parameters and inputs, f32,
within 1e-5 of the larger of 1 and each array's largest magnitude
(``layer_parity`` of ``test_torch_keras_conv.py``): Embedding with
indices that wrap ([-n, 0)) and fall outside (a row of NaN, as
``jnp.take`` gives); LSTM with the default pair, with
``return_sequences`` and with a relu/hard_sigmoid pair (which never
takes cuDNN's route); GRU in the JAX package's reset-before form
(``(r * h) @ W_n``); LayerNormalization; Add, Multiply and Concatenate
in a functional model. The LSTM's build keeps the unit forget bias and
the orthogonal recurrent kernel. Then the JAX package's
``tests/models/test_recurrent.py::
test_lstm_distributed_training_through_tpu_model`` on the port (the
same task, model and claims: the loss falls over 4 epochs of the sync
step ``TPUModel`` with 4 workers, distributed predict within 1e-4 of
the model's), and one epoch of that model's ``fit`` and of the sync
step trainer against the JAX package's (no shuffle; losses and weights
within atol 1e-5).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from elephas_tpu.models import core as jcore
from elephas_tpu.models import layers as jlayers
from elephas_tpu.models import optimizers as jopt
from elephas_tpu.parallel import sync_trainer as jst
from elephas_tpu_torch import TPUModel, to_dataset
from elephas_tpu_torch.models import core as tcore
from elephas_tpu_torch.models import layers as tlayers
from elephas_tpu_torch.models import optimizers as topt
from elephas_tpu_torch.parallel import sync_trainer as tst
from tests.test_torch_keras_conv import layer_parity
from tests.torch_one_thread import one_thread


def _seq(shape=(8, 3), n=4, seed=1):
    return np.random.default_rng(seed).normal(
        size=(n,) + shape).astype(np.float32)


def test_embedding_matches_jax():
    ids = np.array([[0, 5, 9, -1], [3, -10, 2, 7]], np.int32)
    layer_parity(lambda m: m.Embedding(10, 6), (4,), ids)


def test_embedding_takes_as_jnp_take_does():
    """int32 cast of float ids (toward zero), [-n, 0) wraps, outside
    [-n, n) gives NaN rows."""
    import jax.numpy as jnp

    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    ids = np.array([[1.7, -1.0, 4.0, -5.0]], np.float32)
    want = np.asarray(jlayers.Embedding(4, 3).call(
        {"embeddings": jnp.asarray(table)}, jnp.asarray(ids), False, None))
    got = tlayers.Embedding(4, 3).call(
        {"embeddings": torch.from_numpy(table)}, torch.from_numpy(ids),
        False, None).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[0, 2:]).all() and not np.isnan(got[0, :2]).any()


_RECURRENT = {
    "lstm": (lambda m: m.LSTM(6), (8, 3)),
    "lstm_sequences": (lambda m: m.LSTM(5, return_sequences=True), (7, 4)),
    # another pair: the loop, never cuDNN's route
    "lstm_relu_hard_sigmoid": (lambda m: m.LSTM(
        4, activation="relu", recurrent_activation="hard_sigmoid"), (6, 3)),
    "lstm_nobias": (lambda m: m.LSTM(4, use_bias=False), (5, 2)),
    "gru": (lambda m: m.GRU(6), (8, 3)),
    "gru_sequences": (lambda m: m.GRU(5, return_sequences=True), (7, 4)),
    "gru_elu": (lambda m: m.GRU(4, activation="elu"), (6, 3)),
}


@pytest.mark.parametrize("case", sorted(_RECURRENT))
def test_recurrent_matches_jax(case):
    make, shape = _RECURRENT[case]
    # recurrent kernels near the scale of the orthogonal init
    _, tl = layer_parity(make, shape, _seq(shape), scale=0.5)
    if isinstance(tl, tlayers.LSTM):   # a CPU tensor always loops
        assert not tl.cudnn_route(torch.zeros(2, *shape))


@pytest.mark.parametrize("sequences,use_bias", [(False, True), (True, True),
                                                (False, False)])
def test_lstm_library_route_computes_the_loop(sequences, use_bias):
    """The route the card takes for the tanh/sigmoid pair,
    ``torch._VF.lstm`` over the JAX layout's weights (transposed, the
    one bias as ``b_ih``, zeros as ``b_hh``), runs on the CPU too: its
    output and gradients equal the loop's within 1e-5 of scale."""
    from tests.test_torch_keras_conv import assert_close_scaled

    layer = tlayers.LSTM(6, return_sequences=sequences, use_bias=use_bias)
    rng = np.random.default_rng(2)
    built = layer.build(torch.Generator().manual_seed(0), (7, 3))
    params = {k: 0.5 * rng.normal(size=v.shape).astype(np.float32)
              for k, v in built.items()}
    x = _seq((7, 3), n=5)
    results = []
    for route in (layer.call, lambda p, xx, *a: layer._call_cudnn(p, xx)):
        p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
        xt = torch.tensor(x, requires_grad=True)
        out = route(p, xt, True, None)
        grads = torch.autograd.grad(out.square().sum(),
                                    [p[k] for k in sorted(p)] + [xt])
        results.append([out.detach().numpy()] + [g.numpy() for g in grads])
    for a, b in zip(*results):
        assert_close_scaled(b, a, 1e-5)


def test_gru_resets_before_the_recurrent_product():
    """With z near 0 (a bias of -50), a zero input kernel and identity
    recurrent blocks, the state after two steps is
    ``tanh(b_n + (r * h1) @ W_n)`` with ``r = sigmoid(b_r + h1)``: the
    reset gate scales the state before the product."""
    layer = tlayers.GRU(2)
    u = 2
    params = {"kernel": torch.zeros(1, 3 * u),
              "recurrent_kernel": torch.eye(u).repeat(1, 3),
              "bias": torch.tensor([-50.0, -50.0, 5.0, 5.0, 0.5, -0.5])}
    x = torch.ones(1, 2, 1)
    out = layer.call(params, x, False, None)
    h1 = torch.tanh(params["bias"][4:])            # r * h0 = 0
    r = torch.sigmoid(h1 + 5.0)
    h2 = torch.tanh(params["bias"][4:] + r * h1)  # W_n = I
    torch.testing.assert_close(out[0], h2, atol=1e-6, rtol=0)


def test_lstm_build_has_unit_forget_bias_and_orthogonal_rows():
    layer = tlayers.LSTM(8)
    params = layer.build(torch.Generator().manual_seed(0), (5, 3))
    bias = params["bias"].numpy()
    np.testing.assert_array_equal(bias[8:16], 1.0)
    np.testing.assert_array_equal(np.concatenate([bias[:8], bias[16:]]), 0.0)
    rec = params["recurrent_kernel"].numpy()          # (8, 32)
    np.testing.assert_allclose(rec @ rec.T, np.eye(8), atol=1e-5)


def test_layer_normalization_matches_jax():
    layer_parity(lambda m: m.LayerNormalization(epsilon=1e-3), (5, 6),
                 _seq((5, 6)), positive=("gamma",))


def _merged(m):
    a = m.Input(shape=(6,))
    b = m.Input(shape=(6,))
    ha = m.Dense(4, activation="tanh")(a)
    hb = m.Dense(4)(b)
    added = m.Add()([ha, hb])
    mult = m.Multiply()([ha, hb, added])
    cat = m.Concatenate()([added, mult, hb])
    cat1 = m.Concatenate(axis=1)([cat, ha])
    return [a, b], m.Dense(3, activation="softmax")(
        m.LayerNormalization()(cat1))


def test_merges_in_a_functional_model_match_jax():
    """Two inputs through Add, Multiply, Concatenate (last axis and
    axis 1) and LayerNormalization: ``apply`` and its gradient with
    respect to every parameter."""
    import jax
    import jax.numpy as jnp

    from tests.test_torch_keras_conv import assert_close_scaled

    jlayers.reset_layer_uids()
    jm = jcore.Model(*_merged(jlayers))
    jm.build(seed=0)
    tlayers.reset_layer_uids()
    tm = tcore.Model(*_merged(tlayers), device="cpu")
    tm.set_weights(jm.get_weights())
    assert tm.output_shape == jm.output_shape == (3,)
    rng = np.random.default_rng(3)
    xs = [rng.normal(size=(16, 6)).astype(np.float32) for _ in range(2)]
    r = rng.normal(size=(16, 3)).astype(np.float32)

    def jloss(p):
        return jnp.sum(jm.apply(p, [jnp.asarray(x) for x in xs]) * r)

    jgrads = jax.grad(jloss)(jm.params)
    tparams = {ln: {pn: t.clone().requires_grad_() for pn, t in lp.items()}
               for ln, lp in tm.params.items()}
    out = tm.apply(tparams, [torch.from_numpy(x) for x in xs])
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(jm.apply(jm.params, [jnp.asarray(x) for x in xs])),
        atol=1e-5, rtol=0)
    (out * torch.from_numpy(r)).sum().backward()
    for ln, lp in tparams.items():
        for pn, t in lp.items():
            assert_close_scaled(t.grad.numpy(), jgrads[ln][pn], 1e-5,
                                f"{ln}/{pn}")
    back = jcore.model_from_json(tm.to_json())
    assert json.loads(back.to_json()) == json.loads(tm.to_json())


# ---------------- tests/models/test_recurrent.py's TPUModel case
def _seq_data(n=256, t=12, vocab=16, seed=0):
    """Parity task: label = whether the count of token '1' is even."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, vocab, size=(n, t))
    y = ((x == 1).sum(axis=1) % 2 == 0).astype("float32")
    return x.astype("int32"), np.stack([1 - y, y], axis=1)


def _lstm_model(m, units=16, width=8):
    return [m.Embedding(16, width, input_shape=(12,)), m.LSTM(units),
            m.Dense(2, activation="softmax")]


def test_lstm_distributed_training_through_tpu_model():
    x, y = _seq_data(n=512)
    model = tcore.Sequential(_lstm_model(tlayers), device="cpu")
    model.compile(topt.Adam(learning_rate=5e-3), "categorical_crossentropy",
                  seed=0)
    tpu_model = TPUModel(model, mode="synchronous", sync_mode="step",
                         num_workers=4)
    tpu_model.fit(to_dataset(x, y), epochs=4, batch_size=64, verbose=0,
                  validation_split=0.0)
    history = tpu_model.training_histories[-1]
    assert history["loss"][-1] < history["loss"][0]
    local = model.predict(x[:64])
    dist = tpu_model.predict(x[:64])
    np.testing.assert_allclose(np.asarray(dist), np.asarray(local),
                               atol=1e-4)


@pytest.mark.parametrize("route", ["fit", "sync_step"])
def test_lstm_training_matches_jax(route):
    x, y = _seq_data(n=64)
    jlayers.reset_layer_uids()
    jm = jcore.Sequential(_lstm_model(jlayers, units=8))
    jm.compile(jopt.Adam(5e-3), "categorical_crossentropy", ["acc"], seed=0)
    tlayers.reset_layer_uids()
    tm = tcore.Sequential(_lstm_model(tlayers, units=8), device="cpu")
    tm.compile(topt.Adam(5e-3), "categorical_crossentropy", ["acc"], seed=1)
    tm.set_weights(jm.get_weights())
    if route == "fit":
        kw = dict(epochs=1, batch_size=16, shuffle=False)
        jh, th = jm.fit(x, y, **kw).history, tm.fit(x, y, **kw).history
        jw, tw = jm.get_weights(), tm.get_weights()
    else:
        loss = "categorical_crossentropy"
        kw = dict(epochs=1, batch_size=16, shuffle=False,
                  validation_split=0.0)
        jw, jh = jst.SyncStepTrainer(jm, jopt.Adam(5e-3), loss).fit(
            jm.get_weights(), x, y, **kw)
        tw, th = tst.SyncStepTrainer(tm, topt.Adam(5e-3), loss).fit(
            tm.get_weights(), x, y, **kw)
    np.testing.assert_allclose(th["loss"], jh["loss"], atol=1e-5, rtol=0)
    for a, b in zip(jw, tw):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-5, rtol=0)
