"""Where a Keras-style training step's time goes, under torch.profiler:
the sync trainers' step (``models.core.train_step``), or one step of an
asynchronous worker's reference batch loop.

    python -m elephas_tpu_torch.profile_keras [--steps 200] [--batch 64]
    python -m elephas_tpu_torch.profile_keras --mode async_batch
    python -m elephas_tpu_torch.profile_keras --model lstm --batch 128

Runs on the CUDA device only. Builds the bench's MLP (784-128-128-10,
f32, weights from a seed) compiled as ``chip_smoke.py``'s
``keras_sync_step`` phase compiles it (SGD, categorical cross-entropy,
acc), or with ``--model lstm`` the model of
``examples/lstm_sequence_classification.py`` (Embedding 16 over 32
tokens -> LSTM 32 -> Dense 2, Adam 5e-3, rows of 16 tokens; cuDNN's
LSTM), makes ``--steps`` x ``--batch`` seeded rows, warms 20 steps,
times ``--steps`` steps and profiles as many more. Prints one JSON
line: the host time per step (untraced window), the device time per
step (sum of kernel and copy durations, traced window), the device's
busy share (their ratio), launches per step, and the device time per
step of the heaviest kernels by name.

``--mode sync_step`` (the default) puts the rows on the device and runs
``train_step`` on the next slice of rows each step with all-ones sample
weights, as ``SyncStepTrainer`` feeds it. ``--mode async_batch`` runs
one :class:`~elephas_tpu_torch.worker.AsyncWorker` at
``frequency="batch"`` against a socket parameter server in this
process, over host rows: each step pulls the weights (an RPC and a
host-to-device ``set_weights``), trains one batch (``train_on_batch``:
a host-to-device copy of the batch and a read of its loss), reads the
weights back (``get_weights``, a device-to-host copy that waits for the
device) and pushes the delta (an RPC). Each timed window is one
``AsyncWorker.train`` call, so it includes that worker's model build,
once per window.
"""
import argparse
import json
import time

import numpy as np
import torch


def _mlp(rng, rows):
    from .models import SGD, Activation, Dense, Sequential

    model = Sequential([Dense(128, input_dim=784), Activation("relu"),
                        Dense(128), Activation("relu"), Dense(10),
                        Activation("softmax")], device="cuda")
    model.compile(SGD(0.01), "categorical_crossentropy", ["acc"], seed=0)
    x = rng.random((rows, 784), dtype=np.float32)
    return model, x, np.eye(10, dtype=np.float32)[rng.integers(0, 10, rows)]


def _lstm(rng, rows):
    from .models import LSTM, Adam, Dense, Embedding, Sequential

    model = Sequential([Embedding(32, 16, input_shape=(16,)), LSTM(32),
                        Dense(2, activation="softmax")], device="cuda")
    model.compile(Adam(5e-3), "categorical_crossentropy", ["acc"], seed=0)
    x = rng.integers(0, 32, (rows, 16)).astype(np.int32)
    return model, x, np.eye(2, dtype=np.float32)[rng.integers(0, 2, rows)]


_MODELS = {"mlp": _mlp, "lstm": _lstm}


def _sync_step_runner(model, x, y, b):
    """``run(steps)``: the sync trainers' step over device rows."""
    from .models.core import _trainable_copy, train_step
    from .weights import tree_leaves

    x = torch.as_tensor(x, device="cuda")
    y = torch.as_tensor(y, device="cuda")
    sw = torch.ones(x.shape[0], device="cuda")
    trainable, state = model._split_params(model.params)
    trainable = _trainable_copy(trainable)
    opt_state = model._tx.init(tree_leaves(trainable))

    def run(steps):
        nonlocal opt_state
        totals = None
        for i in range(steps):
            sl = slice(i * b, (i + 1) * b)
            opt_state, stats = train_step(
                model, model._tx, model._loss_fn, model._metric_fns,
                trainable, state, opt_state, x[sl], y[sl], sw[sl])
            totals = stats if totals is None else totals + stats
        return float(totals[0] / totals[1])

    return run, lambda: None


def _async_batch_runner(model, x, y, b):
    """``run(steps)``: one async worker's reference batch loop over
    ``steps`` batches of host rows, against a local socket server."""
    from .models import serialize_optimizer
    from .parameter import SocketClient, SocketServer
    from .utils.serialization import model_to_dict
    from .utils.sockets import free_port
    from .worker import AsyncWorker

    port = free_port()
    server = SocketServer(model_to_dict(model), port, "asynchronous")
    server.start()
    client = SocketClient(port)

    def run(steps):
        losses = []
        worker = AsyncWorker(
            model.to_json(), model.get_weights(), client,
            {"epochs": 1, "batch_size": b}, "batch",
            serialize_optimizer(model.optimizer), model.loss,
            list(model.metrics), epoch_event=lambda e, loss:
            losses.append(loss), device=model.device)
        worker.train(x[:steps * b], y[:steps * b])
        worker.client.close()
        return losses[-1]

    def close():
        client.close()
        server.stop()

    return run, close


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--mode", choices=("sync_step", "async_batch"),
                    default="sync_step")
    ap.add_argument("--model", choices=sorted(_MODELS), default="mlp")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_keras needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from .profile_serving import device_breakdown

    n, b = args.steps, args.batch
    model, x, y = _MODELS[args.model](np.random.default_rng(0), n * b)
    if args.mode == "sync_step":
        run, close = _sync_step_runner(model, x, y, b)
    else:
        run, close = _async_batch_runner(model, x, y, b)
    try:
        run(20)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = run(n)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / n * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(n)
            torch.cuda.synchronize()
    finally:
        close()
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "mode": args.mode,
        "model": args.model,
        "steps": n, "batch": b, "loss": loss,
        "samples_per_s": b / host_ms * 1e3,
        **device_breakdown(prof, n, host_ms, args.top)}))


if __name__ == "__main__":
    main()
