"""Where a Keras-style training step's time goes: the sync trainers' step
(``models.core.train_step``) under torch.profiler.

    python -m elephas_tpu_torch.profile_keras [--steps 200] [--batch 64]

Runs on the CUDA device only. Builds the bench's MLP (784-128-128-10,
f32, weights from a seed) compiled as ``chip_smoke.py``'s
``keras_sync_step`` phase compiles it (SGD, categorical cross-entropy,
acc), puts ``--steps`` x ``--batch`` seeded rows on the device, warms 20
steps, times ``--steps`` steps and profiles as many more, each step on
the next slice of rows with all-ones sample weights, as
``SyncStepTrainer`` feeds it. Prints one JSON line: the host time per
step (untraced window), the device time per step (sum of kernel and
copy durations, traced window), the device's busy share (their ratio),
launches per step, and the device time per step of the heaviest
kernels by name.
"""
import argparse
import json
import time

import numpy as np
import torch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_keras needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from .models import SGD, Activation, Dense, Sequential
    from .models.core import _trainable_copy, train_step
    from .profile_serving import device_breakdown
    from .weights import tree_leaves

    model = Sequential([Dense(128, input_dim=784), Activation("relu"),
                        Dense(128), Activation("relu"), Dense(10),
                        Activation("softmax")], device="cuda")
    model.compile(SGD(0.01), "categorical_crossentropy", ["acc"], seed=0)
    rng = np.random.default_rng(0)
    n, b = args.steps, args.batch
    x = torch.as_tensor(rng.random((n * b, 784), dtype=np.float32),
                        device="cuda")
    y = torch.as_tensor(np.eye(10, dtype=np.float32)[
        rng.integers(0, 10, n * b)], device="cuda")
    sw = torch.ones(n * b, device="cuda")
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
        return totals

    run(20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    totals = run(n)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(n)
        torch.cuda.synchronize()
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "steps": n, "batch": b,
        "loss": float(totals[0] / totals[1]),
        "samples_per_s": b / host_ms * 1e3,
        **device_breakdown(prof, n, host_ms, args.top)}))


if __name__ == "__main__":
    main()
