"""Where a training step's time goes: ``make_train_step`` under
torch.profiler.

    python -m elephas_tpu_torch.profile_train [--steps 5] [--batch 8]
        [--config flagship|transformer_tpumodel|gemma_2b|phi3_mini]

Runs on the CUDA device only. Builds the LM config (``flagship``: vocab
32000, 8 layers, 16 heads, d_model 1024, d_ff 4096, with the bench's
optimizer, AdamW 3e-4 at ``optax.adamw``'s defaults;
``transformer_tpumodel``: examples/transformer_tpumodel.py, vocab 512,
4 layers, 8 heads, d_model 256 (head dim 32), d_ff 512, with its
Adam 3e-4; ``gemma_2b``: Gemma-2B's widths, ``GEMMA_2B``, at 8 of its 18
layers, head dim 256, with the flagship's AdamW: pass ``--batch 2``, the
fit of chip_smoke's ``lm_d256``; ``phi3_mini``: Phi-3-mini's widths,
``PHI3_MINI``, at 8 of its 32 layers, head dim 96, with the same AdamW:
pass ``--batch 2``, the fit of chip_smoke's ``lm_d96``), bf16 compute
over f32 weights from a seed, warms two steps at ``--batch`` x a
sequence of 1024 (128 for ``transformer_tpumodel``, 2048 for
``phi3_mini``) in tokens,
times ``--steps`` steps, and profiles as many more. Prints one JSON
line: the host time per step (untraced window), the device time
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
    ap.add_argument("--config", default="flagship",
                    choices=("flagship", "transformer_tpumodel",
                             "gemma_2b", "phi3_mini"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from .models.optimizers import Adam, AdamW
    from .models.transformer import (FLAGSHIP, GEMMA_2B, PHI3_MINI,
                                     TRANSFORMER_TPUMODEL,
                                     TransformerConfig, init_params,
                                     make_train_step)
    from .profile_serving import device_breakdown

    if args.config == "transformer_tpumodel":
        cfg = TransformerConfig(**TRANSFORMER_TPUMODEL)
        opt = Adam(3e-4)
    else:
        # Gemma-2B and Phi-3-mini at 8 layers: AdamW over all of Gemma-2B's
        # 18 (2.51 B f32 parameters) takes 40 GB before the activations
        wide = {"gemma_2b": GEMMA_2B, "phi3_mini": PHI3_MINI}
        cfg = TransformerConfig(**(FLAGSHIP if args.config == "flagship"
                                   else dict(wide[args.config],
                                             num_layers=8)))
        opt = AdamW(3e-4, epsilon=1e-8, weight_decay=1e-4, decay_1d=True)
    seq = min(cfg.max_seq_len, 2048 if args.config == "phi3_mini" else 1024)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    tx = opt.to_transform()
    step = make_train_step(cfg, tx)
    opt_state = tx.init(params)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, seq)), device="cuda")
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
        "device": torch.cuda.get_device_name(0), "config": args.config,
        "head_dim": cfg.head_dim, "steps": n, "batch": args.batch,
        "seq": seq, "loss": float(loss),
        "tokens_per_s": args.batch * seq / host_ms * 1e3,
        **device_breakdown(prof, n, host_ms, args.top)}))


if __name__ == "__main__":
    main()
