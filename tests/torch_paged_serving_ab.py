"""``lm_d128``'s paged serving step in one tree: the A/B side of a tree.

Serves ``chip_smoke.py``'s ``lm_d128`` traffic (the LM at
Mistral-7B-v0.1's widths over all 32 layers, random weights from seed
0; 16 requests of 64-512 prompt tokens, 64 new each; the paged engine
with the fused kernel, 8 slots, 513 blocks of 16, bf16) twice with
``chip_smoke.serve``, then steps a fresh engine on the same traffic: 4
steps to admit and start decoding, 8 untraced steps for the host's ms
per step, and 8 under torch.profiler for the device's ms per step: the
paged kernels' part, and all of it with its heaviest entries as
``profile_serving.device_breakdown`` gives them. Prints one JSON line
with the card's name and power limit. A script, not a test: it needs
the card.

    python tests/torch_paged_serving_ab.py [TREE]

``chip_smoke`` and ``elephas_tpu_torch`` are imported from TREE (by
default this checkout), so running it once on each of two trees
unpacked side by side (``git archive`` into a git-ignored directory),
in turns on one card (parent, change, change, parent), compares their
serving steps.
"""
import gc
import json
import os
import sys
import time

TREE = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else os.path.join(
    os.path.dirname(os.path.abspath(__file__)), os.pardir))
sys.path.insert(0, TREE)

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
import elephas_tpu_torch  # noqa: E402
from elephas_tpu_torch.models.transformer import init_params  # noqa: E402
from elephas_tpu_torch.profile_serving import device_breakdown  # noqa: E402
from elephas_tpu_torch.serving_engine import DecodeEngine  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_paged_serving_ab needs a CUDA device")
    pkg_tree = os.path.dirname(os.path.dirname(elephas_tpu_torch.__file__))
    if pkg_tree != TREE:
        raise SystemExit(f"imported {elephas_tpu_torch.__file__}, not "
                         f"the package of {TREE}")
    cfg = chip_smoke.lm_d128_config()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in rng.integers(64, 513, 16)]
    chip_smoke.serve(params, cfg, prompts[:2], "fused", max_new=4)
    runs = []
    for _ in range(2):
        _, info = chip_smoke.serve(params, cfg, prompts, "fused",
                                   timed=True)
        runs.append({k: info[k] for k in ("step_ms_p50",
                                          "output_tokens_per_s", "wall_s")})
        gc.collect()

    eng = DecodeEngine(params, cfg, max_slots=8, paged=(513, 16),
                       kernel="fused", device="cuda")
    for p in prompts:
        eng.submit(p, 64)
    for _ in range(4):
        eng.step()
    steps = 8
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    paged = sum(e.device_time_total for e in prof.events()
                if e.device_type == DeviceType.CUDA
                and "paged_" in e.name) / 1e3
    print(json.dumps({
        "tree": TREE, "nvidia_smi": chip_smoke.nvidia_smi(),
        "serving_runs": runs, "paged_device_ms_per_step": paged / steps,
        **device_breakdown(prof, steps, host_ms, top=4)}))


if __name__ == "__main__":
    main()
