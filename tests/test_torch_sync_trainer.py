"""The port's synchronous trainers against the JAX package's.

The JAX model's initial weights go to both sides. ``SyncStepTrainer``
and ``SyncAverageTrainer`` then train without shuffling and without
dropout (the random streams differ), with ``validation_split=0.1``. The
average runs 1-3 workers over uneven partitions, one of them no larger
than a batch, so it stays untrained. Weights agree within atol 1e-5,
and the histories' keys and values too (``epoch_time``/``fit_time`` are
wall times and are only checked to exist). The JAX trainers shard over
the conftest's 8 CPU devices, so batch sizes are multiples of 8 there.
Adam runs at its default learning rate (1e-3): it divides each gradient
by its own running size, so a weight whose gradient sums to near zero
carries the two summation orders' rounding into an update of up to the
learning rate (at 2e-3, 1 weight of 25,088 differed by 1.15e-5).
``build_sharded_predict`` keeps the order, pads the last chunk and
fills ``out=``; ``build_sharded_evaluate`` is the sample-weighted mean;
both match the JAX ones and the model's own ``predict``/``evaluate``.
The average's new weights are the start minus the mean over all workers
of the deltas of the copies ``train_workers`` trains, recomputed here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from elephas_tpu.models import core as jcore
from elephas_tpu.models import layers as jlayers
from elephas_tpu.models import metrics as jmetrics
from elephas_tpu.models import optimizers as jopt
from elephas_tpu.parallel import sync_trainer as jst
from elephas_tpu_torch.models import core as tcore
from elephas_tpu_torch.models import layers as tlayers
from elephas_tpu_torch.models import metrics as tmetrics
from elephas_tpu_torch.models import optimizers as topt
from elephas_tpu_torch.parallel import sync_trainer as tst
from tests.torch_one_thread import one_thread

_OPT = {"sgd_momentum": lambda m: m.SGD(0.05, momentum=0.9),
        "adam": lambda m: m.Adam()}


def _stack(m):
    return [m.Dense(32, activation="relu", input_dim=784),
            m.Dropout(0.0), m.Dense(10, activation="softmax")]


def _models():
    jlayers.reset_layer_uids()
    jm = jcore.Sequential(_stack(jlayers))
    jm.build(seed=0)
    tlayers.reset_layer_uids()
    tm = tcore.Sequential(_stack(tlayers), device="cpu")
    tm.build(seed=0)
    return jm, tm


def _trainers(cls_name, opt):
    jm, tm = _models()
    loss = "categorical_crossentropy"
    jt = getattr(jst, cls_name)(jm, _OPT[opt](jopt), loss,
                                [jmetrics.get("acc", loss=loss)])
    tt = getattr(tst, cls_name)(tm, _OPT[opt](topt), loss,
                                [tmetrics.get("acc", loss=loss)])
    return jm, jt, tt


def _assert_histories(th, jh, time_key):
    assert list(th) == list(jh)
    for key in jh:
        if key == time_key:
            assert len(th[key]) == len(jh[key])
            continue
        np.testing.assert_allclose(th[key], jh[key], atol=1e-5, rtol=0)


@pytest.mark.parametrize("opt", sorted(_OPT))
def test_sync_step_trainer_matches_jax(opt, mnist_data):
    x, y = mnist_data[0][:250], mnist_data[1][:250]
    jm, jt, tt = _trainers("SyncStepTrainer", opt)
    w0 = jm.get_weights()
    kw = dict(epochs=2, batch_size=32, validation_split=0.1, shuffle=False)
    jw, jh = jt.fit(w0, x, y, **kw)
    tw, th = tt.fit(w0, x, y, **kw)
    for a, b in zip(jw, tw):
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)
    _assert_histories(th, jh, "epoch_time")


@pytest.mark.parametrize("opt", sorted(_OPT))
@pytest.mark.parametrize("sizes", [(150,), (90, 61), (100, 70, 20)])
def test_sync_average_trainer_matches_jax(sizes, opt, mnist_data):
    x, y = mnist_data[0], mnist_data[1]
    bounds = np.cumsum((0,) + sizes)
    shards = [(x[lo:hi], y[lo:hi]) for lo, hi in zip(bounds[:-1], bounds[1:])]
    jm, jt, tt = _trainers("SyncAverageTrainer", opt)
    w0 = jm.get_weights()
    kw = dict(epochs=2, batch_size=32, validation_split=0.1, shuffle=False)
    jw, jhs = jt.run(w0, shards, **kw)
    tw, ths = tt.run(w0, shards, **kw)
    for a, b in zip(jw, tw):
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)
    assert [h is None for h in ths] == [h is None for h in jhs] == \
        [n <= 32 for n in sizes]
    for th, jh in zip(ths, jhs):
        if jh is not None:
            _assert_histories(th, jh, "fit_time")


def test_inactive_workers_dilute_the_average(mnist_data):
    """The delta mean runs over ALL workers: with one of two partitions
    untrained, the step from the start is half the active worker's."""
    x, y = mnist_data[0], mnist_data[1]
    _, _, tt = _trainers("SyncAverageTrainer", "sgd_momentum")
    w0 = tt.model.get_weights()
    kw = dict(epochs=1, batch_size=32, shuffle=False)
    solo, _ = tt.run(w0, [(x[:96], y[:96])], **kw)
    pair, hs = tt.run(w0, [(x[:96], y[:96]), (x[96:110], y[96:110])], **kw)
    assert hs[1] is None
    for a, s, p in zip(w0, solo, pair):
        np.testing.assert_allclose(p - a, (s - a) / 2, atol=1e-6, rtol=0)


@pytest.mark.parametrize("shuffle", [False, True])
def test_average_is_the_start_minus_the_mean_worker_delta(shuffle,
                                                          mnist_data):
    """``run``'s weights, recomputed from each worker's trained copy:
    params0 - sum(params0 - trained) / num_workers, over all three
    workers (the third, no larger than a batch, trains no copy)."""
    x, y = mnist_data[0], mnist_data[1]
    _, _, tt = _trainers("SyncAverageTrainer", "sgd_momentum")
    w0 = tt.model.get_weights()
    shards = [(x[:120], y[:120]), (x[120:200], y[120:200]),
              (x[200:230], y[200:230])]
    kw = dict(epochs=2, batch_size=32, validation_split=0.1,
              shuffle=shuffle, seed=3)
    new, hs = tt.run(w0, shards, **kw)
    tt.model.set_weights(w0)
    params0 = tt.model.params
    trained = list(tt.train_workers(params0, shards, **kw))
    assert [w for w, _, _ in trained] == [0, 1] and hs[2] is None
    for (w, final, stats), h in zip(trained, hs):
        assert stats.shape == (2, 2)
        np.testing.assert_allclose(stats[:, 0].numpy(), h["loss"], rtol=0,
                                   atol=0)
    for idx, (ln, pn) in enumerate(tt.model._weight_entries()):
        delta = sum(params0[ln][pn] - final[ln][pn].detach()
                    for _, final, _ in trained)
        want = (params0[ln][pn] - delta / len(shards)).numpy()
        np.testing.assert_allclose(new[idx], want, atol=1e-6, rtol=0)
        assert not np.allclose(new[idx], w0[idx])


def test_stack_shards_pads_to_a_batch_multiple():
    shards = [(np.ones((5, 2)), np.ones(5)), (np.ones((3, 2)), np.ones(3))]
    for mod in (jst, tst):
        X, Y, SW, sizes = mod.stack_shards(shards, pad_multiple=4)
        assert X.shape == (2, 8, 2) and Y.shape == (2, 8)
        assert SW.sum(1).tolist() == [5, 3] and sizes.tolist() == [5, 3]


def _trained_pair(mnist_data):
    jm, tm = _models()
    loss = "categorical_crossentropy"
    jm.compile(jopt.SGD(0.1), loss, ["acc"], seed=0)
    tm.compile(topt.SGD(0.1), loss, ["acc"], seed=0)
    tm.set_weights(jm.get_weights())
    x, y = mnist_data[0][:128], mnist_data[1][:128]
    jm.fit(x, y, epochs=1, batch_size=32, shuffle=False)
    tm.fit(x, y, epochs=1, batch_size=32, shuffle=False)
    return jm, tm


def test_sharded_predict_keeps_order_and_fills_out(mnist_data, tmp_path):
    jm, tm = _trained_pair(mnist_data)
    x = mnist_data[2][:37]
    predict = tst.build_sharded_predict(tm)
    got = predict(x, batch_size=16)             # chunks 16, 16, 5 (+11 pad)
    np.testing.assert_allclose(got, tm.predict(x), atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        got, np.asarray(jst.build_sharded_predict(jm)(x, batch_size=16)),
        atol=1e-5, rtol=0)
    out = np.lib.format.open_memmap(str(tmp_path / "p.npy"), mode="w+",
                                    shape=(37, 10), dtype=np.float32)
    assert predict(x, batch_size=16, out=out) is out
    np.testing.assert_array_equal(np.load(tmp_path / "p.npy"), got)
    empty = predict(x[:0])
    assert empty.shape == (0, 10)


def test_sharded_evaluate_is_the_sample_weighted_mean(mnist_data):
    jm, tm = _trained_pair(mnist_data)
    x, y = mnist_data[2][:50], mnist_data[3][:50]
    loss = "categorical_crossentropy"
    evaluate = tst.build_sharded_evaluate(
        tm, loss, [tmetrics.get("acc", loss=loss)])
    got = evaluate(x, y, batch_size=16)          # a padded last chunk
    np.testing.assert_allclose(got, tm.evaluate(x, y), atol=1e-6, rtol=0)
    want = jst.build_sharded_evaluate(
        jm, loss, [jmetrics.get("acc", loss=loss)])(x, y, batch_size=16)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
