"""chip_smoke's ``keras_sync_step`` set-up on the CPU, in both packages:
bench.py's MLP (784-128-128-10) through ``TPUModel(sync_mode="step")``,
one worker, batch 64, two shuffled epochs over the full 60,000-row
MNIST-like set of ``tests/conftest.py``. SGD at 0.01 trains it in both
packages and SGD at 0.1 (the bench's rate) does not: its loss rises in
the second epoch. ``tests/test_torch_sgd_rate_0_1.py`` and
``tests/test_torch_sgd_rate_0_01.py`` run one rate each, so a parallel
test run puts them on two workers (``pytest -k sgd_rate -s`` prints the
epoch losses and accuracies of both packages).

The port's half runs with one intra-op thread: its ops are batch-64
matmuls, and under ``pytest -n 6`` a pool of eight threads per worker
oversubscribes the cores and slows that half about thirtyfold.
"""
import numpy as np
import pytest
import torch

from elephas_tpu.data import Dataset as JDataset
from elephas_tpu.models import optimizers as jopt
from elephas_tpu.tpu_model import TPUModel as JTPUModel
from elephas_tpu_torch import TPUModel, to_dataset
from elephas_tpu_torch.models import optimizers as topt


@pytest.fixture(scope="module")
def full_mnist_like():
    from tests.conftest import _make_classification

    return _make_classification(60000, 784, 10, seed=0)


@pytest.fixture(scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bench_mlp(mod, **kw):
    """bench.py's MLP, 784-128-128-10, in either package."""
    return mod.Sequential([mod.Dense(128, activation="relu", input_dim=784),
                           mod.Dense(128, activation="relu"),
                           mod.Dense(10, activation="softmax")], **kw)


def check_sgd_rate(lr, data):
    """Train both packages at ``lr`` and assert what each rate does."""
    import elephas_tpu.models as jmodels
    import elephas_tpu_torch as tpkg

    x, y = data
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
