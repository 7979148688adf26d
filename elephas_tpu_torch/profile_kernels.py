"""Host cost of the flash-attention kernels' calls, beside PyTorch's own.

    python -m elephas_tpu_torch.profile_kernels [--calls 200]

Runs on the CUDA device only. ``chip_smoke.py`` times the kernels on
the device; this measures what it does not: the host's side of a call.

- ``host_us_per_call``: microseconds per call over ``--calls`` calls
  issued back to back at a tiny shape (B 1, H 1, S 64, D 64, causal,
  bf16), where the device work is negligible, so the host sets the
  pace: ``flash_forward`` beside SDPA, and ``flash_dkv``; and
  ``paged_decode_attention`` at one request (B 1, H = KVH 16, 64 blocks
  of 16, pos 10, bf16), whose table still spans 16 splits, so the call
  includes the split kernel, its workspace and the merge kernel.
- ``entry_us_per_call``: the C entry points alone, called through ctypes
  with the pointers ready: the kernels' host set-up, tensor maps
  included, and the launch.
- ``stream_ms_per_call``: milliseconds per call over ``--calls`` calls
  issued back to back at the ``forward`` path's shape (B 2, H 16,
  S 1024), ``flash_forward`` beside SDPA: host and device overlap as in
  a layer stack, so each reads the larger of its host and device time
  (warm L2).

Prints one JSON line with the card's name and power limit. Run as a
file, ``PYTHONPATH=<checkout> python
elephas_tpu_torch/profile_kernels.py``, it imports ``elephas_tpu_torch``
from that checkout: an A/B of two trees on one card.
"""
import argparse
import json
import subprocess
import time

import torch


def per_call(fn, calls: int) -> float:
    """Host seconds per call of ``calls`` calls issued back to back,
    up to the device finishing the last of them."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls


def operands(b, h, s, gen):
    return tuple(torch.randn((b, h, s, 64), generator=gen, device="cuda")
                 .bfloat16() for _ in range(4))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels needs a CUDA device")
    from elephas_tpu_torch.ops import _kernels
    from elephas_tpu_torch.ops.flash_attention import (flash_dkv,
                                                       flash_forward,
                                                       flash_forward_plain)
    from elephas_tpu_torch.ops.paged_attention import paged_decode_attention

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "package": __import__("elephas_tpu_torch").__file__}

    q, k, v, g = operands(1, 1, 64, gen)
    o, lse = flash_forward_plain(q, k, v, causal=True)
    delta = (g.float() * o.float()).sum(-1)
    pq = torch.randn((1, 16, 64), generator=gen, device="cuda").bfloat16()
    pool = torch.randn((65, 16, 16, 64), generator=gen,
                       device="cuda").bfloat16()
    tables = torch.arange(1, 65, dtype=torch.int32, device="cuda")[None]
    ppos = torch.tensor([10], dtype=torch.int32, device="cuda")
    us = {"flash_forward": lambda: flash_forward(q, k, v, causal=True),
          "sdpa": lambda: sdpa(q, k, v, is_causal=True),
          "flash_dkv": lambda: flash_dkv(q, k, v, g, lse, delta),
          "paged_decode": lambda: paged_decode_attention(pq, pool, pool,
                                                         tables, ppos)}
    out["host_us_per_call"] = {name: per_call(fn, args.calls) * 1e6
                               for name, fn in us.items()}

    lib = _kernels.library()
    stream = torch.cuda.current_stream().cuda_stream
    o = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    # B H KVH Sq Sk D q_offset k_offset causal window | scale | bf16 stream
    dims = (1, 1, 1, 64, 64, 64, 0, 0, 1, 0, 0.125, 1, stream)
    fwd_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), *dims)
    dkv_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), *dims)
    out["entry_us_per_call"] = {
        "etpu_flash_fwd": per_call(lambda: lib.etpu_flash_fwd(*fwd_args),
                                   args.calls) * 1e6,
        "etpu_flash_bwd_dkv": per_call(
            lambda: lib.etpu_flash_bwd_dkv(*dkv_args), args.calls) * 1e6}

    q, k, v, _ = operands(2, 16, 1024, gen)
    out["stream_shape"] = {"B": 2, "H": 16, "S": 1024, "D": 64,
                           "causal": True, "dtype": "bfloat16"}
    out["stream_ms_per_call"] = {
        "flash_forward": per_call(lambda: flash_forward(q, k, v,
                                                        causal=True),
                                  args.calls) * 1e3,
        "sdpa": per_call(lambda: sdpa(q, k, v, is_causal=True),
                         args.calls) * 1e3}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
