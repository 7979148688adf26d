"""The paged decode kernel's bodies at the LMs' decode shapes, and the
split body at several split lengths, timed on one card.

At each shape (B 8 unless named, block 16, positions 64-575 drawn as
``chip_smoke.py`` draws them, shuffled tables; bf16) the script holds the call against the f32 plain
version, then times its device time alone (``chip_smoke.device_ms``:
cold L2, median of 20) on the split body at the wrapper's own split
length (``split_blocks``) and at each length of ``--lengths``, on the
general body, and gather + SDPA beside the byte bound; and under
torch.profiler each kernel's device us a call, warm L2, for each of
those runs (the split kernel and the merge apart). A split length
or a body is forced by replacing the wrapper's ``split_blocks`` or
``paged_body`` for the call. Prints one JSON line per shape, then the
card's name and power limit. A script, not a test: it needs the card.

    python tests/torch_paged_split_ab.py [TREE] [--lengths 1 2 4 8]

``chip_smoke`` and ``elephas_tpu_torch`` are imported from TREE (by
default this checkout), so running it on two trees unpacked side by
side (``git archive`` into a git-ignored directory), in turns on one
card (parent, change, change, parent), compares their kernels; a tree
whose ``split_blocks`` takes no group size is timed at its own rule.
"""
import argparse
import json
import os
import re
import sys

TREE = os.path.abspath(
    sys.argv[1] if len(sys.argv) > 1 and not sys.argv[1].startswith("-")
    else os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir))
sys.path.insert(0, TREE)

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
from elephas_tpu_torch.ops import paged_attention as pa  # noqa: E402

# name: (B, H, KVH, D, table entries a row); 128 entries of 16 are the
# engine's tables at max_seq_len 2048 (lm_d256, lm_d96), 64 chip_smoke's
# paged phase
SHAPES = {
    "gemma2b_d256_g8_mb128": (8, 8, 1, 256, 128),
    "gemma2b_d256_g8_mb64": (8, 8, 1, 256, 64),
    "gemma2b_d256_g8_b16_mb128": (16, 8, 1, 256, 128),
    "phi3mini_d96_mb128": (8, 32, 32, 96, 128),
    "phi3mini_d96_mb64": (8, 32, 32, 96, 64),
    "llama70b_d128_g8_mb64": (8, 64, 8, 128, 64),
    "llama70b_d128_g8_b1_mb64": (1, 64, 8, 128, 64),
    "mistral7b_d128_g4_mb64": (8, 32, 8, 128, 64),
    "flagship_d64_mb64": (8, 16, 16, 64, 64),
}


def inputs(b, h, kvh, d, mb, bs=16):
    rng = np.random.default_rng(0)
    nb = b * mb + 1
    tables = rng.permutation(np.arange(1, nb))[:b * mb].reshape(b, mb)
    pos = rng.integers(64, 576, b)
    gen = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn((b, h, d), generator=gen, device="cuda").bfloat16()
    kp, vp = (torch.randn((nb, kvh, bs, d), generator=gen,
                          device="cuda").bfloat16() for _ in range(2))
    return (q, kp, vp, torch.as_tensor(tables, dtype=torch.int32,
                                       device="cuda"),
            torch.as_tensor(pos, dtype=torch.int32, device="cuda")), pos


def forced(per=None, body=None):
    """The wrapper as a callable, its split length or body forced."""
    def call(*args):
        saved = pa.split_blocks, pa.paged_body
        if per is not None:
            pa.split_blocks = lambda *a: per
        if body is not None:
            pa.paged_body = lambda *a: body
        try:
            return pa.paged_decode_attention(*args)
        finally:
            pa.split_blocks, pa.paged_body = saved
    return call


def kernel_us(fn, calls=20):
    """Device us a call of each kernel ``fn`` launches, by name."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            found = re.search(r"(\w+_kernel)", e.name)
            name = found[1] if found else e.name[:40]
            out[name] = out.get(name, 0.0) + e.device_time_total / calls
    return out


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("tree", nargs="?")
    parser.add_argument("--lengths", type=int, nargs="*",
                        default=[1, 2, 4, 8])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_paged_split_ab needs a CUDA device")
    pkg_tree = os.path.dirname(os.path.dirname(pa.__file__))
    if os.path.dirname(pkg_tree) != TREE:
        raise SystemExit(f"imported {pa.__file__}, not the package of "
                         f"{TREE}")
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for name, (b, h, kvh, d, mb) in SHAPES.items():
        call_args, pos = inputs(b, h, kvh, d, mb)
        q, kp, vp, tables, pos_t = call_args
        ref = pa.paged_decode_attention_plain(q.float(), kp.float(),
                                              vp.float(), tables, pos_t)
        try:
            own = pa.split_blocks(b, kvh, mb, 16, h // kvh)
        except TypeError:       # a rule of the shape without the groups
            own = pa.split_blocks(b, kvh, mb, 16)
        body = pa.paged_body(q.dtype, d, h // kvh)
        runs = {"own": forced(), "general": forced(body="general"),
                **{f"per{n}": forced(per=n) for n in args.lengths}}
        errs, dev = {}, {}
        for key, fn in runs.items():
            errs[key] = chip_smoke.max_err(fn(*call_args), ref)
            chip_smoke.require(errs[key] <= 2e-2,
                               f"{name} {key} err {errs[key]} <= 2e-2")
            dev[key] = chip_smoke.device_ms(lambda: fn(*call_args), flush)
        library = chip_smoke.gather_sdpa(*call_args)
        nbytes, _, bound_ms, bound_by = chip_smoke.paged_bound(pos, h, d, 16,
                                                              kvh)
        live = sum(-(-(int(p) // 16 + 1) // own) for p in pos)
        print(json.dumps({
            "tree": TREE, "shape": name, "B": len(pos), "H": h, "KVH": kvh, "D": d,
            "max_blocks": mb, "positions": [int(p) for p in pos],
            "body": body, "own_split_blocks": own,
            "live_ctas_at_own": live * kvh, "device_ms": dev,
            "max_abs_err": errs,
            "kernel_us_warm": {key: kernel_us(lambda: fn(*call_args))
                               for key, fn in runs.items()},
            "library_device_ms": chip_smoke.device_ms(library, flush),
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes}),
            flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()
