"""The asynchronous epoch-frequency fit of ``chip_smoke.py``'s
``keras_async`` (a), repeated, with the order of the workers' pushes.

``TPUModel(mode="asynchronous", parameter_server_mode="http",
frequency="epoch")`` on the set and model of that phase: 60,000
MNIST-like rows (``chip_smoke.mnist_like``, seed 0; held out 10,000,
seed 1), the 784-128-128-10 MLP with Dropout 0.2, SGD 0.01, batch 64,
2 epochs, validation split 0.1. Each worker pulls the weights, trains
one local epoch and pushes its delta, which the server subtracts as it
comes (the reference's rule). Workers that pull the same weights push
their deltas from one base, a step as many times a worker's as there
are workers; whether they do depends on how the threads interleave.

Prints one JSON line per run: the master's held-out loss and accuracy,
and the seconds between the first and the last of the epoch-0 pushes.
``--lockstep`` holds every epoch's pushes until all workers have
trained from their pulls, and the next pulls until all pushes have
landed (``chip_smoke.epoch_pushes_in_lockstep``), the interleaving in
which each epoch's deltas share one base; ``--package jax`` runs the
JAX package (on the CPU) under the same hold. A script, not a test:

    python tests/torch_async_epoch_lockstep.py [--runs 8] [--workers 2] \\
        [--device cpu] [--lockstep]
    JAX_PLATFORMS=cpu python tests/torch_async_epoch_lockstep.py \\
        --package jax --lockstep --runs 2
"""
import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import (epoch_pushes_in_lockstep,  # noqa: E402
                        mnist_like)
from elephas_tpu_torch.utils.sockets import free_port  # noqa: E402


@contextlib.contextmanager
def recorded_pushes(worker_cls, times):
    """Append the time of each push to ``times``."""
    push = worker_cls._push

    def recorded(self, delta):
        times.append(time.perf_counter())
        return push(self, delta)

    worker_cls._push = recorded
    try:
        yield
    finally:
        worker_cls._push = push


def run(package, device, lockstep, workers, data):
    (x, y), (x_test, y_test) = data
    if package == "jax":
        from elephas_tpu.models import (SGD, Activation, Dense, Dropout,
                                        Sequential)
        from elephas_tpu.tpu_model import TPUModel
        from elephas_tpu.utils.dataset_utils import to_dataset
        from elephas_tpu.worker import AsyncWorker
        kw = {}
    else:
        from elephas_tpu_torch import SGD, TPUModel, to_dataset
        from elephas_tpu_torch.models import (Activation, Dense, Dropout,
                                              Sequential)
        from elephas_tpu_torch.worker import AsyncWorker
        kw = {"device": device}
    pushes = []
    model = Sequential([Dense(128, input_dim=784), Activation("relu"),
                        Dropout(0.2), Dense(128), Activation("relu"),
                        Dropout(0.2), Dense(10), Activation("softmax")],
                       **kw)
    model.compile(SGD(learning_rate=0.01), "categorical_crossentropy",
                  ["acc"], seed=0)
    tpu_model = TPUModel(model, batch_size=64, port=free_port(),
                         mode="asynchronous", parameter_server_mode="http",
                         frequency="epoch", num_workers=workers)
    with recorded_pushes(AsyncWorker, pushes), (
            epoch_pushes_in_lockstep(workers, AsyncWorker) if lockstep
            else contextlib.nullcontext()):
        tpu_model.fit(to_dataset(x, y).repartition(workers), epochs=2,
                      batch_size=64, validation_split=0.1)
    loss, acc = tpu_model.master_network.evaluate(x_test, y_test)
    return {"package": package, "device": device if package == "port"
            else "cpu", "workers": workers, "lockstep": lockstep,
            "server_updates": tpu_model.parameter_server.num_updates,
            "epoch0_push_spread_s": pushes[workers - 1] - pushes[0],
            "held_out_loss": float(loss), "held_out_acc": float(acc)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=8)
    ap.add_argument("--package", choices=("port", "jax"), default="port")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--lockstep", action="store_true")
    args = ap.parse_args()
    data = (mnist_like(60000, seed=0), mnist_like(10000, seed=1))
    if args.package == "port" and args.device == "cuda":
        from chip_smoke import nvidia_smi
        print(nvidia_smi(), flush=True)
    for i in range(args.runs):
        print(json.dumps({"run": i, **run(args.package, args.device,
                                          args.lockstep, args.workers,
                                          data)}),
              flush=True)


if __name__ == "__main__":
    main()
