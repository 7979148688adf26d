"""The flash kernels and ``lm_d128`` in one tree: the A/B side of a tree.

Times the bf16 flash forward, dK/dV and dQ beside SDPA with
``chip_smoke``'s timer (``device_ms``: cold L2, median of 20 calls,
device time alone) at the training shape (B 8, H 16, S 1024, causal) at
head dims 128, 64, 32, 16, 96, 80 and 256, at ``lm_d128``'s fit shape
(B 4, H 32 over KVH 8, S 1024, window 4096) at 128, at ``lm_d96``'s (B
2, H 32, S 2048, window 2047) at 96, at ``lm_d256``'s (B 2, H 8 over
KVH 1, S 1024) at 256 and at ``tpu_model_lm_d32``'s (B 16, H 8, S 128)
at 32, and in f32 (the f32 bodies; SDPA in f32) at head dims 16 and
32 on the two shapes the main path runs the f32 strip bodies at,
``speculative_example``'s (B 8, H 4, S 32) and ``forward_d16``'s (B 4,
H 4, S 96), and at the four shapes of the f32 checks that run the wider
f32 bodies (``chip_smoke.F32_WIDE_TIMED``: ``train_parity`` d 64, the
``lm_d128``, ``lm_d96`` and ``lm_d256`` gradients), where the f32
entries also time autograd's backward through f32 SDPA (``sdpa_bwd``:
dQ, dK and dV in one call), with digests (sha256) of each kernel's outputs, O and LSE,
dQ, and dK and dV, on the same seeded inputs, so two trees' bits can be
compared; a tree whose kernels refuse a head dim says so
there. It prints them as one JSON line, then runs ``chip_smoke``'s
``lm_d128`` phase (``forward`` over 32 layers, the paged engine, the
2-layer gradient and tokens, the 4-layer fit), which prints its own
lines (``bf16_ms`` of ``forward``, ``ms_per_step`` of the fit), unless
``--kernels-only`` is given. A script, not a test: it needs the card.

    python tests/torch_flash_ab.py [--kernels-only] [TREE]

As in tests/torch_paged_serving_ab.py, ``chip_smoke`` and
``elephas_tpu_torch`` are imported from TREE (by default this
checkout). Copy this checkout's chip_smoke.py into the other tree, so
that both sides use one timer, and run parent, change, change, parent
on one card.
"""
import hashlib
import json
import os
import sys

KERNELS_ONLY = "--kernels-only" in sys.argv[1:]
_TREES = [a for a in sys.argv[1:] if a != "--kernels-only"]
TREE = os.path.abspath(_TREES[0] if _TREES else os.path.join(
    os.path.dirname(os.path.abspath(__file__)), os.pardir))
sys.path.insert(0, TREE)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
import elephas_tpu_torch  # noqa: E402
from elephas_tpu_torch.ops import _kernels  # noqa: E402
from elephas_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_dkv, flash_dq, flash_forward, flash_forward_plain)

# name: (B, H, KVH, S, window), causal, the head dims timed there and
# the dtype (the f32 shapes last, so the bf16 ones draw the same inputs
# as before they were added)
SHAPES = {
    "b8": ((8, 16, 16, 1024, None), (128, 64, 32, 16, 96, 80, 256),
           torch.bfloat16),
    "path": ((4, 32, 8, 1024, 4096), (128,), torch.bfloat16),
    "path_d96": ((2, 32, 32, 2048, 2047), (96,), torch.bfloat16),
    "path_d256": ((2, 8, 1, 1024, None), (256,), torch.bfloat16),
    "path_d32": ((16, 8, 8, 128, None), (32,), torch.bfloat16),
    "f32_speculative_example": ((8, 4, 4, 32, None), (16, 32),
                                torch.float32),
    "f32_forward_d16": ((4, 4, 4, 96, None), (16, 32), torch.float32),
    "f32_train_parity": ((2, 16, 16, 1024, None), (64,), torch.float32),
    "f32_lm_d128_grad": ((1, 32, 8, 512, 4096), (128,), torch.float32),
    "f32_lm_d96_grad": ((1, 32, 32, 512, 2047), (96,), torch.float32),
    "f32_lm_d256_grad": ((1, 8, 1, 512, None), (256,), torch.float32)}


def digest(*tensors):
    """sha256 of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def kernel_times(flush):
    """{shape_d: {fwd, sdpa, dkv, dq, digest}} in device ms; ``refused``
    where this tree's kernels do not take the head dim."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for name, ((b, h, kvh, s, window), dims, dtype) in SHAPES.items():
        for d in dims:
            q, g = (torch.randn((b, h, s, d), generator=gen, device="cuda")
                    .to(dtype) for _ in range(2))
            k, v = (torch.randn((b, kvh, s, d), generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
            gqa = {"enable_gqa": True} if kvh != h else {}
            o, lse = flash_forward_plain(q, k, v, causal=True, window=window)
            delta = (g.float() * o.float()).sum(-1)
            args = (q, k, v, g, lse, delta, 0, 0, True, window)
            try:
                outs = (*flash_forward(q, k, v, causal=True, window=window),
                        flash_dq(*args), *flash_dkv(*args))
            except ValueError as e:
                out[f"{name}_d{d}"] = {"refused": str(e)}
                continue
            out[f"{name}_d{d}"] = {
                "digest": {"fwd": digest(*outs[:2]), "dq": digest(outs[2]),
                           "dkv": digest(*outs[3:])},
                "fwd": chip_smoke.device_ms(lambda: flash_forward(
                    q, k, v, causal=True, window=window), flush),
                "sdpa": chip_smoke.device_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        q, k, v, is_causal=True, **gqa), flush),
                "dkv": chip_smoke.device_ms(lambda: flash_dkv(*args), flush),
                "dq": chip_smoke.device_ms(lambda: flash_dq(*args), flush)}
            if dtype == torch.float32:
                ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))
                o_lib = torch.nn.functional.scaled_dot_product_attention(
                    ql, kl, vl, is_causal=True, **gqa)
                out[f"{name}_d{d}"]["sdpa_bwd"] = chip_smoke.device_ms(
                    lambda: torch.autograd.grad(o_lib, (ql, kl, vl), g,
                                                retain_graph=True), flush)
                del ql, kl, vl, o_lib
            del q, k, v, g, o, lse, delta, args, outs
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_flash_ab needs a CUDA device")
    pkg_tree = os.path.dirname(os.path.dirname(elephas_tpu_torch.__file__))
    if pkg_tree != TREE:
        raise SystemExit(f"imported {elephas_tpu_torch.__file__}, not "
                         f"the package of {TREE}")
    _kernels.library()
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    print(json.dumps({"tree": TREE, "card": chip_smoke.nvidia_smi(),
                      **kernel_times(flush)}), flush=True)
    del flush
    if KERNELS_ONLY:
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.run_lm_d128()


if __name__ == "__main__":
    main()
