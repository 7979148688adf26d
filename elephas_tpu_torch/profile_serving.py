"""Where a decode step's time goes: the paged engine under torch.profiler.

    python -m elephas_tpu_torch.profile_serving [--kernel fused] [--steps 16]
        [--config flagship|olmoe_1b_7b|gemma_2b] [--int8]

Runs on the CUDA device only. Builds the flagship LM config (vocab
32000, 8 layers, 16 heads, d_model 1024, d_ff 4096; or ``olmoe_1b_7b``,
``OLMOE_1B_7B``: 16 layers, 64 experts top-8, gating densely in decode;
or ``gemma_2b``, ``GEMMA_2B``: 18 layers, head dim 256, 8 heads over 1
kv head, the paged kernel's split body at groups of 8; bf16 compute
over f32 weights
from a seed), fills all 8 slots of an
engine with 256-token prompts, steps until every slot decodes, then
times ``--steps`` steady decode steps, and profiles as many more. The
flagship and Gemma-2B run the paged engine (block 16, 513 blocks,
``--kernel``);
the MoE LM the contiguous engine (paged mode refuses MoE). ``--int8``
serves ``quantize_lm_params`` weights, and on the contiguous engine
the int8 KV cache too.
Prints one JSON line: the host time per step (untraced window), the
device time per step (sum of kernel and copy durations, traced window),
the device's busy share (their ratio), launches per step, and the device
time per step of the heaviest kernels by name.
"""
import argparse
import json
import time

import numpy as np
import torch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", default="fused", choices=("gather", "fused"))
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--config", default="flagship",
                    choices=("flagship", "olmoe_1b_7b", "gemma_2b"))
    ap.add_argument("--int8", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from .models.quantization import quantize_lm_params
    from .models.transformer import (FLAGSHIP, GEMMA_2B, OLMOE_1B_7B,
                                     TransformerConfig, init_params)
    from .serving_engine import DecodeEngine

    moe = args.config == "olmoe_1b_7b"
    widths = {"flagship": FLAGSHIP, "olmoe_1b_7b": OLMOE_1B_7B,
              "gemma_2b": GEMMA_2B}[args.config]
    cfg = TransformerConfig(**widths,
                            kv_cache_quant=moe and args.int8)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    if args.int8:
        params = quantize_lm_params(params)
        torch.cuda.empty_cache()
    if moe:
        eng = DecodeEngine(params, cfg, max_slots=8,
                           max_len=256 + 2 * args.steps + 16, device="cuda")
    else:
        eng = DecodeEngine(params, cfg, max_slots=8, paged=(513, 16),
                           kernel=args.kernel, device="cuda")
    rng = np.random.default_rng(0)
    for _ in range(8):
        eng.submit(rng.integers(0, cfg.vocab_size, 256).tolist(),
                   2 * args.steps + 8)
    for _ in range(4):                                  # warm, all active
        eng.step()
    n = args.steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        eng.step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / n * 1e3
    # a second window under the profiler: device durations are not
    # slowed by tracing, host time is, so the share uses host_ms above
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "config": args.config,
        "int8": args.int8, "kernel": None if moe else args.kernel,
        "steps": n, "batch": 8, "prompt_tokens": 256,
        **device_breakdown(prof, n, host_ms, args.top)}))


def device_breakdown(prof, steps: int, host_ms: float, top: int) -> dict:
    """Per-step device time of a profiled window of ``steps`` steps (sum
    of kernel and copy durations), its share of ``host_ms`` per step,
    launches per step, and the ``top`` heaviest device entries by name."""
    from torch.autograd import DeviceType

    per_name: dict = {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        ms, calls = per_name.get(evt.name, (0.0, 0))
        per_name[evt.name] = (ms + evt.device_time_total / 1e3, calls + 1)
    device_ms = sum(ms for ms, _ in per_name.values()) / steps
    heavy = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "host_ms_per_step": host_ms,
        "device_ms_per_step": device_ms,
        "device_busy_share": device_ms / host_ms,
        "device_launches_per_step": sum(c for _, c in per_name.values())
        / steps,
        "top": [{"name": name[:80], "ms_per_step": ms / steps,
                 "calls_per_step": calls / steps}
                for name, (ms, calls) in heavy]}


if __name__ == "__main__":
    main()
