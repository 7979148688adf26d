"""The overlapped async loop at 2 and 4 workers, in both packages.

Runs ``TPUModel(mode="asynchronous", parameter_server_mode="http",
frequency="batch", async_overlap=True, async_accum=8)`` of the JAX
package and of the port (on the CPU), unmodified, on the set and model
of ``chip_smoke.py``'s ``keras_async`` phase: 60,000 MNIST-like rows
(``chip_smoke.mnist_like``, seed 0; held out 10,000, seed 1), the
784-128-128-10 MLP with Dropout 0.2, SGD 0.01, batch 64, 2 epochs,
validation split 0.1. Prints one JSON line per package and worker
count: the fit's seconds, the server's updates and the master's
held-out loss and accuracy. A script, not a test (it takes about 40 s
on a CPU):

    JAX_PLATFORMS=cpu python tests/torch_overlap_workers.py [--workers 2 4]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import mnist_like  # noqa: E402
from elephas_tpu_torch.utils.sockets import free_port  # noqa: E402


def run(package, workers, data):
    (x, y), (x_test, y_test) = data
    if package == "jax":
        from elephas_tpu.models import (SGD, Activation, Dense, Dropout,
                                        Sequential)
        from elephas_tpu.tpu_model import TPUModel
        from elephas_tpu.utils.dataset_utils import to_dataset
        kw = {}
    else:
        from elephas_tpu_torch import SGD, TPUModel, to_dataset
        from elephas_tpu_torch.models import (Activation, Dense, Dropout,
                                              Sequential)
        kw = {"device": "cpu"}
    model = Sequential([Dense(128, input_dim=784), Activation("relu"),
                        Dropout(0.2), Dense(128), Activation("relu"),
                        Dropout(0.2), Dense(10), Activation("softmax")],
                       **kw)
    model.compile(SGD(learning_rate=0.01), "categorical_crossentropy",
                  ["acc"], seed=0)
    tpu_model = TPUModel(model, batch_size=64, port=free_port(),
                         mode="asynchronous", parameter_server_mode="http",
                         frequency="batch", async_overlap=True,
                         async_accum=8, num_workers=workers)
    t0 = time.perf_counter()
    tpu_model.fit(to_dataset(x, y).repartition(workers), epochs=2,
                  batch_size=64, validation_split=0.1)
    fit_s = time.perf_counter() - t0
    loss, acc = tpu_model.master_network.evaluate(x_test, y_test)
    return {"package": package, "workers": workers, "fit_s": fit_s,
            "server_updates": tpu_model.parameter_server.num_updates,
            "held_out_loss": float(loss), "held_out_acc": float(acc)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workers", type=int, nargs="+", default=[2, 4])
    args = ap.parse_args()
    data = (mnist_like(60000, seed=0), mnist_like(10000, seed=1))
    for workers in args.workers:
        for package in ("jax", "torch"):
            print(json.dumps(run(package, workers, data)), flush=True)


if __name__ == "__main__":
    main()
