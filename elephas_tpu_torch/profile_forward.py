"""Where a ``forward`` call's time goes: the flagship LM under
torch.profiler.

    python -m elephas_tpu_torch.profile_forward [--reps 20] [--batch 2]
        [--config flagship|phi3_mini|olmoe_1b_7b|gemma_2b]

Runs on the CUDA device only. Builds the LM config (``flagship``: vocab
32000, 8 layers, 16 heads, d_model 1024, d_ff 4096; ``phi3_mini``:
Phi-3-mini-4k-instruct's widths, 32 layers, head dim 96, ``PHI3_MINI``;
``olmoe_1b_7b``: OLMoE-1B-7B's widths, 16 layers, 64 experts top-8 on
routed dispatch, ``OLMOE_1B_7B``; ``gemma_2b``: Gemma-2B's widths, 18
layers, head dim 256 over one kv head, ``GEMMA_2B``; bf16 compute over
f32 weights from a
seed) and calls ``forward`` with the flash kernel on ``--batch`` x a
sequence of 1024 (2048 for ``phi3_mini``) seeded token ids: three
warm-up calls, then
``--reps`` calls each clocked on the host with a device sync after it,
then ``--reps`` more under the profiler. Prints one JSON line: the
median and minimum host time per call (untraced window), the device
time per call (sum of kernel and copy durations, traced window), the
device's busy share, launches per call, and the device time per call of
the heaviest kernels by name.
"""
import argparse
import dataclasses
import json
import time

import numpy as np
import torch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--config", default="flagship",
                    choices=("flagship", "phi3_mini", "olmoe_1b_7b",
                             "gemma_2b"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from .models.transformer import (FLAGSHIP, GEMMA_2B, OLMOE_1B_7B,
                                     PHI3_MINI, TransformerConfig, forward,
                                     init_params)
    from .profile_serving import device_breakdown

    widths = {"flagship": FLAGSHIP, "phi3_mini": PHI3_MINI,
              "olmoe_1b_7b": OLMOE_1B_7B, "gemma_2b": GEMMA_2B}[args.config]
    cfg = dataclasses.replace(TransformerConfig(**widths),
                              attention_impl="flash")
    seq = min(cfg.max_seq_len, 2048 if args.config == "phi3_mini" else 1024)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (args.batch, seq)), device="cuda")
    for _ in range(3):
        forward(params, tokens, cfg)
    torch.cuda.synchronize()
    times = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        forward(params, tokens, cfg)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    host_ms = float(np.median(times))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.reps):
            forward(params, tokens, cfg)
        torch.cuda.synchronize()
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "config": args.config,
        "reps": args.reps, "batch": args.batch, "seq": seq,
        "host_ms_min": min(times),
        "tokens_per_s": args.batch * seq / host_ms * 1e3,
        **device_breakdown(prof, args.reps, host_ms, args.top)}))


if __name__ == "__main__":
    main()
