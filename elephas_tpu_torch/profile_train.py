"""Where a training step's time goes: ``make_train_step`` under
torch.profiler.

    python -m elephas_tpu_torch.profile_train [--steps 5] [--batch 8]

Runs on the CUDA device only. Builds the flagship LM config (vocab
32000, 8 layers, 16 heads, d_model 1024, d_ff 4096, bf16 compute over
f32 weights from a seed) and the bench's optimizer (AdamW 3e-4,
``optax.adamw``'s defaults), warms two steps at ``--batch`` x 1024
tokens, times ``--steps`` steps, and profiles as many more. Prints one
JSON line: the host time per step (untraced window), the device time
per step (sum of kernel and copy durations, traced window), the
device's busy share (their ratio), launches per step, and the device
time per step of the heaviest kernels by name.
"""
import argparse
import json
import time

import numpy as np
import torch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--top", type=int, default=14)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from .models.optimizers import AdamW
    from .models.transformer import (FLAGSHIP, TransformerConfig,
                                     init_params, make_train_step)
    from .profile_serving import device_breakdown

    cfg = TransformerConfig(**FLAGSHIP)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    tx = AdamW(3e-4, epsilon=1e-8, weight_decay=1e-4,
               decay_1d=True).to_transform()
    step = make_train_step(cfg, tx)
    opt_state = tx.init(params)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, 1024)), device="cuda")
    for _ in range(2):
        params, opt_state, loss = step(params, opt_state, tokens)
    n = args.steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        params, opt_state, loss = step(params, opt_state, tokens)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            params, opt_state, loss = step(params, opt_state, tokens)
        torch.cuda.synchronize()
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "steps": n,
        "batch": args.batch, "seq": 1024, "loss": float(loss),
        "tokens_per_s": args.batch * 1024 / host_ms * 1e3,
        **device_breakdown(prof, n, host_ms, args.top)}))


if __name__ == "__main__":
    main()
