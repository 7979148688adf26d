"""End-to-end smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA device and the
CUDA toolkit. It builds the port's hand-written kernels from
``elephas_tpu_torch/csrc`` (and fails if any spills registers), holds
each kernel against its plain PyTorch version at the shapes the main
paths give it (the flash kernels at head dims 16, 32 and 64, f32 and
bf16, and at the head-dim-32 path's own shapes; the paged kernel at 64
and, on its general body, at 16 and 32),
checks that two launches of the paged, dQ and dK/dV kernels give the
same bits, times one request's paged decode (B 1, pos 1000) on a line
of its own, then drives the port's
entry points at the full width of the flagship LM config (vocab 32000,
8 layers, 16 heads, d_model 1024, d_ff 4096; random weights from a
seed): ``forward`` with the flash-attention kernel; the paged
``DecodeEngine`` with the fused paged-attention kernel serving 16
requests; one f32 ``lm_loss`` gradient with the flash kernels against
the plain path; and training through ``TransformerModel.fit_tokens``
(bf16, AdamW, batch 8 x 1024, two epochs) with the flash forward and
backward kernels, after which the trained model serves two requests.
Then the Keras-style models through ``TPUModel(mode="synchronous")`` at
the bench's MLP width (784-128-128-10) on 60,000 seeded rows of the
tests' MNIST-like recipe: ``sync_mode="step"`` (samples/s beside a plain
PyTorch loop of the same MLP) and the default model averaging over 4
workers with Dropout 0.2, each held to the reference's predict/evaluate
oracle and a held-out accuracy above 0.9; ``keras_async``, the
parameter-server modes on the same rows and the MLP of
``examples/mnist_mlp_asynchronous.py`` (Dropout 0.2): asynchronous over
HTTP at epoch frequency and hogwild over the socket at batch frequency
(4 workers each), and the overlapped batch loop (``async_accum=8``, 2
workers), each with the oracle, the accuracy check, the server's update
count against the pushes issued, samples/s and RPC times, then one
worker's fit on the card against the CPU (no kernel runs there: the
phase fails if one launches); and ``TPUModel`` over the
flagship ``TransformerModel`` (one epoch of 2 steps, ``predict``,
``evaluate``), whose flash kernel launches are counted. Last,
``TPUModel`` over the ``examples/transformer_tpumodel.py`` LM (head dim
32: vocab 512, 4 layers, 8 heads, d_model 256) fits 256 seeded rows for
up to 5 epochs with ``EarlyStopping`` and serves ``predict`` and
``evaluate`` through the head-dim-32 flash kernels, and one f32
gradient at that config through the kernels meets the plain path's;
and ``forward`` of the ``examples/http_serving.py`` LM (head dim 16,
f32) runs the head-dim-16 flash kernel and meets the plain path. Every
phase prints one JSON line; any failure raises and the script
exits non-zero without the final result line. The last three lines are
the card's name and power limit as ``nvidia-smi`` reports them, the
``kernels`` summary, and ``{"ok": true, "device": ...}``.

No CPU path: without a CUDA device it exits non-zero at once.
"""
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

# The card's published peaks (NVIDIA H100 SXM data sheet, dense): the
# roofline bounds below are computed against them.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, flush: torch.Tensor = None,
            hold_cycles: int = 0) -> float:
    """Median time of one call, in ms, with CUDA events around each
    call. ``flush`` (a buffer larger than the 50 MB L2) is overwritten
    before every call so each one starts with a cold L2, as a call
    inside a decode step or a layer stack does.

    With ``hold_cycles`` 0 (every ``ms``, ``plain_ms`` and
    ``library_ms`` below) the events bracket the call as the host issues
    it: where the host takes longer to issue a call than the device
    takes to run it, the host's time is what shows. With ``hold_cycles``
    > 0 (the ``device_ms`` keys) the device first spins that many cycles
    (``torch.cuda._sleep``), so the whole call is queued before the start
    event fires and only its device time falls between the events."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        if hold_cycles:
            torch.cuda._sleep(hold_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, flush: torch.Tensor) -> float:
    """``time_ms`` with the host's issue time hidden: about 0.5 ms of
    device spin before each start event."""
    return time_ms(fn, flush=flush, hold_cycles=1_000_000)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


# --------------------------------------------------------------- kernels
# the paged phase's cases, name: (KVH, window, ALiBi), run at every head
# dim
PAGED_CASES = {"main": (16, None, False), "gqa": (4, None, False),
               "window": (16, 100, False), "alibi": (16, None, True)}


def check_paged(flush):
    """The paged decode kernel against its plain version at the serving
    path's shapes: B 8, H 16, block 16, 64 blocks per row, a pool of 513
    blocks; shuffled tables and ragged positions; at head dim 64 (the
    flagship's: the split body in bf16) and 32 and 16 (the general
    body), each timed; then one request alone at d 64."""
    b, mb, nb = 8, 64, 513
    rng = np.random.default_rng(0)
    tables = rng.permutation(np.arange(1, nb))[:b * mb].reshape(b, mb)
    # the serving run's positions: prompts of 64-512 tokens + 64 new
    pos = rng.integers(64, 576, b)
    tables_t = torch.as_tensor(tables, dtype=torch.int32, device="cuda")
    pos_t = torch.as_tensor(pos, dtype=torch.int32, device="cuda")
    by_d = {str(d): paged_at_head_dim(flush, d, tables_t, pos_t, pos, nb)
            for d in (64, 32, 16)}
    single = check_paged_single_user(flush, nb)
    errs = {f"d{d}": t.pop("errors") for d, t in by_d.items()}
    results = {**by_d["64"],
               "max_abs_err": max(single["max_abs_err"],
                                  *(t["max_abs_err"] for t in by_d.values())),
               "max_abs_err_f32": max(t["max_abs_err_f32"]
                                      for t in by_d.values()),
               "by_head_dim": by_d}
    emit({"phase": "paged_kernel", "errors": errs, **results,
          "bit_reproducible": True,
          "tolerance": {"f32": 1e-4, "bf16_vs_f32_plain": 2e-2}})
    return results


def paged_at_head_dim(flush, d, tables_t, pos_t, pos, nb):
    """The paged cases at head dim ``d`` on the serving shape's tables
    and positions, f32 and bf16 against the plain version; two bf16
    launches on the main case bit-equal; then the main case timed in
    bf16 beside gather + SDPA and the bound."""
    from elephas_tpu_torch.models.transformer import _alibi_slope_list
    from elephas_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_plain)

    b, h, bs = tables_t.shape[0], 16, 16
    gen = torch.Generator(device="cuda").manual_seed(1)
    errs = {}
    for name, (kvh, window, alibi) in PAGED_CASES.items():
        q = torch.randn((b, h, d), generator=gen, device="cuda")
        kp = torch.randn((nb, kvh, bs, d), generator=gen, device="cuda")
        vp = torch.randn((nb, kvh, bs, d), generator=gen, device="cuda")
        slopes = _alibi_slope_list(h) if alibi else None
        ref = paged_decode_attention_plain(q, kp, vp, tables_t, pos_t,
                                           window, slopes)
        out32 = paged_decode_attention(q, kp, vp, tables_t, pos_t, window,
                                       slopes)
        q16, k16, v16 = q.bfloat16(), kp.bfloat16(), vp.bfloat16()
        ref16 = paged_decode_attention_plain(q16.float(), k16.float(),
                                             v16.float(), tables_t, pos_t,
                                             window, slopes)
        out16 = paged_decode_attention(q16, k16, v16, tables_t, pos_t,
                                       window, slopes)
        torch.cuda.synchronize()
        e32, e16 = max_err(out32, ref), max_err(out16, ref16)
        what = f"paged {name} d {d}"
        require(bool(torch.isfinite(out16.float()).all()),
                f"{what} bf16 output finite")
        require(e32 <= 1e-4, f"{what} f32 err {e32} <= 1e-4")
        require(e16 <= 2e-2, f"{what} bf16 err {e16} <= 2e-2")
        errs[name] = {"f32": e32, "bf16": e16}
        if name == "main":
            args16 = (q16, k16, v16, tables_t, pos_t)
    # no atomics, splits merged in index order: a second bf16 launch on
    # the same inputs gives the same bits
    first, second = (paged_decode_attention(*args16) for _ in range(2))
    require(torch.equal(first.view(torch.int16), second.view(torch.int16)),
            f"two paged_decode launches at d {d} give bit-equal outputs")
    del first, second
    library = gather_sdpa(*args16)
    nbytes, flops, bound_ms, bound_by = paged_bound(pos, h, d, bs)
    return {"max_abs_err": max(max(e.values()) for e in errs.values()),
            "max_abs_err_f32": max(e["f32"] for e in errs.values()),
            "errors": errs,
            "ms": time_ms(lambda: paged_decode_attention(*args16),
                          flush=flush),
            "plain_ms": time_ms(
                lambda: paged_decode_attention_plain(*args16), flush=flush),
            "library_ms": time_ms(library, flush=flush),
            "device_ms": device_ms(lambda: paged_decode_attention(*args16),
                                   flush),
            "library_device_ms": device_ms(library, flush),
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "flops": flops,
            "shape": {"B": b, "H": h, "KVH": h, "D": d, "block": bs,
                      "max_blocks": tables_t.shape[1], "pool_blocks": nb,
                      "dtype": "bfloat16"}}


def gather_sdpa(q, k_pool, v_pool, tables, pos):
    """The paged call's library yardstick with KVH = H, as a callable:
    each row's blocks gathered into a contiguous cache, then SDPA under
    the position mask (the port never calls it)."""
    b, h, d = q.shape
    length = tables.shape[1] * k_pool.shape[2]
    mask = (torch.arange(length, device=q.device)[None, :]
            <= pos[:, None].long())[:, None, None, :]
    idx = tables.long()

    def library():
        ck = k_pool[idx].transpose(1, 2).reshape(b, h, length, d)
        cv = v_pool[idx].transpose(1, 2).reshape(b, h, length, d)
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], ck, cv, attn_mask=mask)

    return library


def paged_bound(pos, h, d, bs):
    """(bytes, flops, bound ms, bound by) of one bf16 paged call with
    KVH = H: the K/V rows at positions <= pos once, q in, o out, the
    live table entries and the positions."""
    live_blocks = int(np.sum(pos // bs + 1))
    esize = 2
    nbytes = (int(np.sum(pos + 1)) * h * d * 2 * esize
              + 2 * len(pos) * h * d * esize + live_blocks * 4
              + len(pos) * 4)
    flops = 4 * h * d * int(np.sum(pos + 1))
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_BF16_FLOPS * 1e3
    return (nbytes, flops, max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations")


def check_paged_single_user(flush, nb):
    """One request alone: B 1, H = KVH 16, D 64, 64 blocks of 16, pos
    1000, bf16 -- a single user's decode latency per layer. Held against
    the f32 plain version and timed beside gather + SDPA; printed on its
    own line."""
    from elephas_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_plain)

    h, d, bs, mb = 16, 64, 16, 64
    rng = np.random.default_rng(8)
    tables = torch.as_tensor(rng.permutation(np.arange(1, nb))[:mb][None],
                             dtype=torch.int32, device="cuda")
    pos_np = np.array([1000])
    pos = torch.as_tensor(pos_np, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(9)
    q = torch.randn((1, h, d), generator=gen, device="cuda").bfloat16()
    kp, vp = (torch.randn((nb, h, bs, d), generator=gen,
                          device="cuda").bfloat16() for _ in range(2))
    args = (q, kp, vp, tables, pos)
    out = paged_decode_attention(*args)
    ref = paged_decode_attention_plain(q.float(), kp.float(), vp.float(),
                                       tables, pos)
    err = max_err(out, ref)
    require(bool(torch.isfinite(out.float()).all()) and err <= 2e-2,
            f"paged single user bf16 err {err} <= 2e-2")
    library = gather_sdpa(*args)
    nbytes, flops, bound_ms, bound_by = paged_bound(pos_np, h, d, bs)
    res = {"max_abs_err": err,
           "ms": time_ms(lambda: paged_decode_attention(*args),
                         flush=flush),
           "device_ms": device_ms(lambda: paged_decode_attention(*args),
                                  flush),
           "library_ms": time_ms(library, flush=flush),
           "library_device_ms": device_ms(library, flush),
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes}
    emit({"phase": "paged_single_user", **res,
          "shape": {"B": 1, "H": h, "KVH": h, "D": d, "block": bs,
                    "max_blocks": mb, "pos": 1000, "dtype": "bfloat16"},
          "tolerance": {"bf16_vs_f32_plain": 2e-2}})
    return res


# head dims of the flash kernels' bodies: the repo's configurations use
# all three (64 the flagship, 32 examples/transformer_tpumodel.py, 16
# examples/http_serving.py)
HEAD_DIMS = (16, 32, 64)
# the training path's shape, B 8 x H 16 x S 1024 (causal, bf16): every
# head dim is timed there
TIMED = (8, 16, 1024)
# name: (B, H, KVH, Sq, Sk, causal, window, q_offset, k_offset), run at
# every head dim
FLASH_CASES = {"main": (2, 16, 16, 1024, 1024, True, None, 0, 0),
               "b4": (4, 16, 16, 1024, 1024, True, None, 0, 0),
               "gqa": (4, 16, 4, 1024, 1024, True, None, 0, 0),
               "window": (4, 16, 16, 1024, 1024, True, 256, 0, 0),
               "ragged": (4, 16, 16, 1000, 1000, True, None, 0, 0),
               "noncausal_ragged": (2, 16, 16, 1000, 777, False, None, 0,
                                    0),
               "hop_past": (2, 16, 16, 512, 512, True, None, 1024, 512),
               "hop_future": (2, 16, 16, 512, 512, True, None, 0, 512)}
# cases at d 32 only: examples/long_context_windowed_lm.py (GQA 8/2,
# window 48, S 256), and the tpu_model_lm_d32 phase's own shapes (the
# examples/transformer_tpumodel.py LM: H 8, S 128; fit batches of 16,
# predict and evaluate batches of 32)
D32_CASES = {"long_context_windowed_lm": (4, 8, 2, 256, 256, True, 48, 0, 0),
             "tpumodel_fit": (16, 8, 8, 128, 128, True, None, 0, 0),
             "tpumodel_predict": (32, 8, 8, 128, 128, True, None, 0, 0)}
# the case each head dim is timed at beside the training shape: d 32 at
# its main path's (tpu_model_lm_d32's fit); d 64's main path is the
# training shape; d 16 runs on no training path
PATH_TIMED = {32: "tpumodel_fit"}


def flash_cases(extra=None):
    """(head dim, name, case) over every head dim, then the d 32 cases;
    ``extra`` cases join at every head dim."""
    cases = dict(FLASH_CASES, **(extra or {}))
    return [*((d, n, c) for d in HEAD_DIMS for n, c in cases.items()),
            *((32, n, c) for n, c in D32_CASES.items())]


def bound(flops, nbytes):
    """(bound ms, bound by): the larger of the operations at the bf16
    peak and the bytes at the memory rate."""
    ops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes")


def causal_bound(b, h, s, d):
    """(flops, bytes, bound ms, bound by) of one causal bf16 forward:
    4*d flops per unmasked (q, k) pair; q, k, v in and o out once, the
    lse out."""
    pairs = s * (s + 1) // 2
    flops = 4 * b * h * d * pairs
    nbytes = 4 * b * h * s * d * 2 + b * h * s * 4
    return (flops, nbytes, *bound(flops, nbytes))


def check_flash(flush):
    """The flash forward kernel against its plain version at head dims
    16, 32 and 64, f32 and bf16: the forward path's shape (B 2, H 16, S
    1024, causal), B 4, GQA, a window, ragged lengths, ring-hop offsets,
    the training path's B 8, and at d 32 the long-context
    configuration's case (GQA 8/2, window 48) and the tpu_model_lm_d32
    phase's shapes. Timed beside SDPA: at d 64 at both main-path shapes,
    at d 32 at its path's fit shape, and at every head dim at B 8."""
    from elephas_tpu_torch.ops.flash_attention import (flash_forward,
                                                       flash_forward_plain)

    gen = torch.Generator(device="cuda").manual_seed(2)
    errs, timed = {f"d{d}": {} for d in HEAD_DIMS}, {}
    train = {"train": (*TIMED[:2], TIMED[1], TIMED[2], TIMED[2], True,
                       None, 0, 0)}
    for d, name, case in flash_cases(train):
        b, h, kvh, sq, sk, causal, window, qo, ko = case
        q = torch.randn((b, h, sq, d), generator=gen, device="cuda")
        k = torch.randn((b, kvh, sk, d), generator=gen, device="cuda")
        v = torch.randn((b, kvh, sk, d), generator=gen, device="cuda")
        o_ref, l_ref = flash_forward_plain(q, k, v, qo, ko, causal, window)
        o32, l32 = flash_forward(q, k, v, qo, ko, causal, window)
        q16, k16, v16 = q.bfloat16(), k.bfloat16(), v.bfloat16()
        o_ref16, l_ref16 = flash_forward_plain(q16.float(), k16.float(),
                                               v16.float(), qo, ko, causal,
                                               window)
        o16, l16 = flash_forward(q16, k16, v16, qo, ko, causal, window)
        torch.cuda.synchronize()
        live = l_ref > -1e29
        e = {"o_f32": max_err(o32, o_ref),
             "lse_f32": max_err(l32[live], l_ref[live]) if live.any()
             else 0.0,
             "o_bf16": max_err(o16, o_ref16),
             "lse_bf16": max_err(l16[live], l_ref16[live]) if live.any()
             else 0.0}
        what = f"flash {name} d {d}"
        require(bool(torch.all(l32[~live] < -1e29))
                and bool(torch.all(o32[~live] == 0)),
                f"{what}: fully masked rows give O = 0, LSE ~ -1e30")
        require(bool(torch.isfinite(o16.float()).all()),
                f"{what} bf16 output finite")
        require(e["o_f32"] <= 2e-4 and e["lse_f32"] <= 1e-4,
                f"{what} f32 errors {e}")
        require(e["o_bf16"] <= 2e-2 and e["lse_bf16"] <= 1e-3,
                f"{what} bf16 errors {e}")
        errs[f"d{d}"][name] = e
        if name in ("main", "train", *PATH_TIMED.values()):
            timed[name, d] = (q16, k16, v16)
        del q, k, v, o_ref, o32, o_ref16, o16

    def sdpa(q, k, v):
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True)

    def port(q, k, v):
        return lambda: flash_forward(q, k, v, causal=True)

    def timing(q, k, v, plain=False):
        """The call and SDPA's under both timers: as issued (ms) and
        device time alone (device_ms); the plain version as issued."""
        flops, nbytes, bound_ms, bound_by = causal_bound(*q.shape)
        ms = time_ms(port(q, k, v), flush=flush)
        dev_ms = device_ms(port(q, k, v), flush)
        out = {"shape": dict(zip("BHS", q.shape[:3])),
               "ms": ms, "device_ms": dev_ms,
               "library_ms": time_ms(sdpa(q, k, v), flush=flush),
               "library_device_ms": device_ms(sdpa(q, k, v), flush),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "flops": flops, "bytes": nbytes,
               "achieved_tflops": flops / (ms * 1e-3) / 1e12,
               "device_tflops": flops / (dev_ms * 1e-3) / 1e12}
        if plain:
            out["plain_ms"] = time_ms(lambda: flash_forward_plain(
                q, k, v, causal=True), flush=flush)
        return out

    q16, k16, v16 = timed["main", 64]
    b_m, h_m, s_m = q16.shape[:3]
    main = timing(q16, k16, v16, plain=True)
    # each head dim at its main path's shape (d 64: the train run's B 8,
    # 64 of its launches; d 32: the tpu_model_lm_d32 fit's B 16 x H 8 x S
    # 128), and at the training shape (B 8) beside it
    by_d = {}
    for d in HEAD_DIMS:
        t = timing(*timed["train", d], plain=True)
        if d in PATH_TIMED:
            t = {**timing(*timed[PATH_TIMED[d], d], plain=True),
                 "at_training_shape": t}
        t["max_abs_err"] = max(max(e.values())
                               for e in errs[f"d{d}"].values())
        by_d[str(d)] = t
    t64 = by_d["64"]
    results = {"max_abs_err": max(t["max_abs_err"] for t in by_d.values()),
               "max_abs_err_f32": max(max(e["o_f32"], e["lse_f32"])
                                      for es in errs.values()
                                      for e in es.values()),
               **main,
               "train_shape": {"B": TIMED[0], "H": TIMED[1],
                               "S": TIMED[2]},
               **{f"train_{k}": t64[k] for k in (
                   "ms", "library_ms", "device_ms", "library_device_ms",
                   "bound_ms", "bound_by", "achieved_tflops",
                   "device_tflops")},
               "by_head_dim": by_d}
    emit({"phase": "flash_kernel", "errors": errs, **results,
          "shape": {"B": b_m, "H": h_m, "S": s_m, "D": 64, "causal": True,
                    "dtype": "bfloat16"},
          "tolerance": {"o_f32": 2e-4, "lse_f32": 1e-4,
                        "o_bf16_vs_f32_plain": 2e-2,
                        "lse_bf16_vs_f32_plain": 1e-3}})
    return results


def library_flash_backward(q, k, v, g):
    """One PyTorch call computing dQ, dK and dV together on these
    tensors, as the yardstick (the port never calls it): the causal
    flash-attention backward op behind SDPA, fed by its own forward."""
    fwd = torch.ops.aten._scaled_dot_product_flash_attention(
        q, k, v, 0.0, True)
    out, lse, cq, ck, mq, mk, seed, offset = fwd[:8]
    return lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        g, q, k, v, out, lse, cq, ck, mq, mk, 0.0, True, seed, offset)


def check_flash_bwd(flush):
    """The dQ and dK/dV kernels against their plain versions over the
    forward phase's cases at head dims 16, 32 and 64 (and the d 32
    cases), with the same lse/delta: f32, and bf16 against the f32 plain
    version on bf16-rounded inputs. Then, at the training shape (B 8, H
    16, S 1024, causal, bf16) at every head dim and at d 32 at its
    path's fit shape, each is held against its plain version on the
    operands it is timed on, and two dQ and two dK/dV launches there
    must give the same bits."""
    from elephas_tpu_torch.ops.flash_attention import (
        flash_backward, flash_backward_plain, flash_forward_plain)

    gen = torch.Generator(device="cuda").manual_seed(5)
    # errors relative to max|ref| of each gradient: f32 another summation
    # order; bf16 P and dS enter their products in bf16 (the TPU
    # kernels' casts) over up to 1024 terms
    tol = {"f32": 1e-4, "bf16": 2e-2}
    errs = {f"d{d}": {} for d in HEAD_DIMS}
    for d, name, case in flash_cases():
        b, h, kvh, sq, sk, causal, window, qo, ko = case
        shape_q, shape_k = (b, h, sq, d), (b, kvh, sk, d)
        q, g = (torch.randn(shape_q, generator=gen, device="cuda")
                for _ in range(2))
        k, v = (torch.randn(shape_k, generator=gen, device="cuda")
                for _ in range(2))
        e = {}
        for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            qt, kt, vt, gt = (t.to(dtype) for t in (q, k, v, g))
            o, lse = flash_forward_plain(qt.float(), kt.float(), vt.float(),
                                         qo, ko, causal, window)
            delta = (gt.float() * o).sum(-1)
            ref = flash_backward_plain(qt.float(), kt.float(), vt.float(),
                                       gt.float(), lse, delta, qo, ko,
                                       causal, window)
            out = flash_backward(qt, kt, vt, gt, lse, delta, qo, ko, causal,
                                 window)
            torch.cuda.synchronize()
            what = f"flash bwd {name} d {d} {dt}"
            for part, got, want in zip(("dq", "dk", "dv"), out, ref):
                require(got.dtype == dtype and bool(
                    torch.isfinite(got.float()).all()),
                    f"{what} {part} finite, in {dtype}")
                scale = float(want.abs().max())
                err = max_err(got, want)
                if name == "hop_future":
                    # a hop wholly in the future: every gradient is zero
                    require(scale == 0.0 and err == 0.0,
                            f"{what} {part} is zero")
                rel = err / scale if scale else 0.0
                require(rel <= tol[dt], f"{what} {part} err {err} > "
                        f"{tol[dt]} * {scale}")
                e[f"{part}_{dt}"] = err
                e[f"{part}_{dt}_rel"] = rel
        errs[f"d{d}"][name] = e
    by_d = {}
    for d in HEAD_DIMS:
        t = bwd_timed(gen, d, TIMED, "train", flush, tol, errs[f"d{d}"])
        if d in PATH_TIMED:
            name = PATH_TIMED[d]
            b, h, _, s, *_ = D32_CASES[name]
            path = bwd_timed(gen, d, (b, h, s), f"{name}_timed", flush, tol,
                             errs[f"d{d}"])
            t = {part: {**path[part], "at_training_shape": t[part]}
                 for part in t}
        by_d[str(d)] = t
    results = {part: {**by_d["64"][part],
                      "max_abs_err": max(t[part]["max_abs_err"]
                                         for t in by_d.values()),
                      "max_abs_err_f32": max(t[part]["max_abs_err_f32"]
                                             for t in by_d.values()),
                      "by_head_dim": {k: t[part] for k, t in by_d.items()}}
               for part in ("dq", "dkv")}
    emit({"phase": "flash_bwd_kernels", "errors": errs, **results,
          "library": "aten._scaled_dot_product_flash_attention_backward",
          "library_note": "one call computing dQ, dK and dV together: "
                          "compare with dq ms + dkv ms",
          "dq_bit_reproducible": True, "dkv_bit_reproducible": True,
          "tolerance_relative_to_max_ref": tol})
    return results


def bwd_timed(gen, d, shape, label, flush, tol, errs):
    """dQ and dK/dV at ``shape`` (B, H, S; causal) and head dim ``d``,
    bf16, cold L2: each against its plain version on the very operands
    timed here (added to ``errs`` as ``label``), two launches of each
    bit-equal, and the times of both beside the library backward and
    the bound."""
    from elephas_tpu_torch.ops.flash_attention import (
        flash_dkv, flash_dkv_plain, flash_dq, flash_dq_plain,
        flash_forward_plain)

    b, h, s = shape
    q, k, v, g = (torch.randn((b, h, s, d), generator=gen, device="cuda")
                  .bfloat16() for _ in range(4))
    o, lse = flash_forward_plain(q, k, v, causal=True)
    delta = (g.float() * o.float()).sum(-1)
    args = (q, k, v, g, lse, delta)
    e = {}
    for part, got, want in zip(
            ("dq", "dk", "dv"), (flash_dq(*args), *flash_dkv(*args)),
            (flash_dq_plain(*args), *flash_dkv_plain(*args))):
        scale = float(want.float().abs().max())
        err = max_err(got, want)
        require(bool(torch.isfinite(got.float()).all())
                and err <= tol["bf16"] * scale,
                f"flash bwd {label} d {d} {part} err {err} > "
                f"{tol['bf16']} * {scale}")
        e[f"{part}_bf16"] = err
        e[f"{part}_bf16_rel"] = err / scale
    errs[label] = e
    # no atomics: a second dQ and a second dK/dV launch on the same
    # operands give the same bits
    for part, fn in (("dq", flash_dq), ("dkv", flash_dkv)):
        first, second = fn(*args), fn(*args)
        pairs = zip(first, second) if part == "dkv" else [(first, second)]
        require(all(torch.equal(a.view(torch.int16), b_.view(torch.int16))
                    for a, b_ in pairs),
                f"two flash_{part} launches at d {d} give bit-equal outputs")
        del first, second, pairs
    ms = {"dq": time_ms(lambda: flash_dq(*args), flush=flush),
          "dkv": time_ms(lambda: flash_dkv(*args), flush=flush)}
    plain_ms = {"dq": time_ms(lambda: flash_dq_plain(*args), flush=flush),
                "dkv": time_ms(lambda: flash_dkv_plain(*args),
                               flush=flush)}
    lib_ms = time_ms(library_flash_backward(q, k, v, g), flush=flush)
    dev_ms = {"dq": device_ms(lambda: flash_dq(*args), flush),
              "dkv": device_ms(lambda: flash_dkv(*args), flush)}
    lib_dev_ms = device_ms(library_flash_backward(q, k, v, g), flush)
    pairs = b * h * s * (s + 1) // 2      # unmasked (q, k) pairs, causal
    esize = 2
    tensor = b * h * s * d * esize        # one of q, k, v, dO, dq, dk, dv
    rows = 2 * b * h * s * 4              # lse and delta, f32
    # dQ: 3 products (S, dP, dQ), dK/dV: 4 (S, dP, dV, dK), 2*d flops
    # per unmasked pair each
    work = {"dq": (3 * 2 * d * pairs, 5 * tensor + rows),
            "dkv": (4 * 2 * d * pairs, 6 * tensor + rows)}
    grads = {"dq": ("dq",), "dkv": ("dk", "dv")}
    results = {}
    for part, (flops, nbytes) in work.items():
        bound_ms, bound_by = bound(flops, nbytes)
        results[part] = {
            "shape": {"B": b, "H": h, "S": s},
            "max_abs_err": max(err for es in errs.values()
                               for key, err in es.items()
                               if key.split("_")[0] in grads[part]
                               and not key.endswith("_rel")),
            "max_abs_err_f32": max(es[f"{gr}_f32"] for es in errs.values()
                                   for gr in grads[part]
                                   if f"{gr}_f32" in es),
            "ms": ms[part], "plain_ms": plain_ms[part], "library_ms": lib_ms,
            "device_ms": dev_ms[part], "library_device_ms": lib_dev_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "flops": flops, "bytes": nbytes,
            "achieved_tflops": flops / (ms[part] * 1e-3) / 1e12,
            "device_tflops": flops / (dev_ms[part] * 1e-3) / 1e12}
    return results


# ------------------------------------------------------------ main path
def reset_counts():
    from elephas_tpu_torch.ops.flash_attention import (flash_backward,
                                                       flash_forward)
    from elephas_tpu_torch.ops.paged_attention import paged_decode_attention
    flash_forward.launches = 0
    flash_backward.dq_launches = 0
    flash_backward.dkv_launches = 0
    paged_decode_attention.launches = 0


def read_counts():
    from elephas_tpu_torch.ops.flash_attention import (flash_backward,
                                                       flash_forward)
    from elephas_tpu_torch.ops.paged_attention import paged_decode_attention
    return {"flash_fwd": flash_forward.launches,
            "flash_dq": flash_backward.dq_launches,
            "flash_dkv": flash_backward.dkv_launches,
            "paged_decode": paged_decode_attention.launches}


def run_forward(params, cfg):
    """``forward`` at full width: flash logits against the plain path in
    f32, then the bf16 flash forward as the main-path run."""
    from elephas_tpu_torch.models.transformer import forward

    b, t = 2, 1024
    tokens = torch.as_tensor(
        np.random.default_rng(3).integers(0, cfg.vocab_size, (b, t)),
        device="cuda")
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    flash = forward(params, tokens, dataclasses.replace(
        c32, attention_impl="flash"))
    plain = forward(params, tokens, dataclasses.replace(
        c32, attention_impl="xla"))
    err = max_err(flash, plain)
    require(flash.shape == (b, t, cfg.vocab_size), "forward logits shape")
    require(bool(torch.isfinite(flash).all()), "forward logits finite")
    require(err <= 1e-3, f"flash vs plain logits err {err} <= 1e-3")
    del flash, plain

    c16 = dataclasses.replace(cfg, attention_impl="flash")
    reset_counts()
    logits = forward(params, tokens, c16)
    torch.cuda.synchronize()
    counts = read_counts()
    require(bool(torch.isfinite(logits).all()), "bf16 logits finite")
    require(counts["flash_fwd"] == cfg.num_layers,
            f"forward launched the flash kernel once per layer: {counts}")
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        forward(params, tokens, c16)
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / reps
    emit({"phase": "forward", "batch": b, "seq": t,
          "max_abs_err_f32_flash_vs_plain": err, "tolerance": 1e-3,
          "bf16_ms": sec * 1e3, "bf16_tokens_per_s": b * t / sec,
          "launches": counts})
    return counts


def run_forward_d16():
    """``forward`` of the ``examples/http_serving.py`` LM (head dim 16,
    f32, the byte tokenizer's 259 ids; weights from seed 0) under the
    default ``attention_impl="auto"`` on 4 sequences of its 96 tokens:
    the d 16 flash forward must run once per layer, and the logits must
    equal the plain attention path's."""
    from elephas_tpu_torch.models.transformer import (TransformerConfig,
                                                      forward, init_params)

    cfg = TransformerConfig(vocab_size=259, num_layers=2, num_heads=4,
                            d_model=64, d_ff=128, max_seq_len=96,
                            dtype=torch.float32)
    require(cfg.head_dim == 16, f"head dim {cfg.head_dim}")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    tokens = torch.as_tensor(np.random.default_rng(13).integers(
        0, cfg.vocab_size, (4, cfg.max_seq_len)), device="cuda")
    reset_counts()
    logits = forward(params, tokens, cfg)
    torch.cuda.synchronize()
    counts = read_counts()
    plain = forward(params, tokens,
                    dataclasses.replace(cfg, attention_impl="xla"))
    err = max_err(logits, plain)
    require(logits.shape == (4, cfg.max_seq_len, cfg.vocab_size)
            and bool(torch.isfinite(logits).all()), "d 16 logits finite")
    require(err <= 1e-4, f"d 16 flash vs plain logits err {err} <= 1e-4")
    require(counts["flash_fwd"] == cfg.num_layers,
            f"forward launched the d 16 flash kernel once per layer: "
            f"{counts}")
    emit({"phase": "forward_d16", "head_dim": cfg.head_dim, "batch": 4,
          "seq": cfg.max_seq_len, "max_abs_err_flash_vs_plain": err,
          "tolerance": 1e-4, "launches": counts})
    return counts


def serve(params, cfg, prompts, kernel, max_new=64, timed=False):
    from elephas_tpu_torch.serving_engine import DecodeEngine

    eng = DecodeEngine(params, cfg, max_slots=8, paged=(513, 16),
                       kernel=kernel, device="cuda")
    t_start = time.perf_counter()
    rids = [eng.submit(p, max_new) for p in prompts]
    t_sub = {r: time.perf_counter() for r in rids}
    first, steps = {}, []
    while eng.pending:
        t0 = time.perf_counter()
        out = eng.step()
        now = time.perf_counter()
        steps.append(now - t0)
        for rid in out:
            first.setdefault(rid, now)
    wall = time.perf_counter() - t_start
    outs = [eng.result(r) for r in rids]
    info = {"stats": eng.stats, "wall_s": wall}
    if timed:
        ttft = sorted(first[r] - t_sub[r] for r in rids)
        n_tok = sum(len(o) for o in outs)
        info.update({"output_tokens": n_tok,
                     "output_tokens_per_s": n_tok / wall,
                     "ttft_p50_ms": float(np.median(ttft)) * 1e3,
                     "ttft_max_ms": ttft[-1] * 1e3,
                     "step_ms_p50": float(np.median(steps)) * 1e3})
    return outs, info


def tie_aware_equal(params, cfg, prompts, ref, out):
    """Greedy outputs must be equal, except that a row may diverge at a
    provable argmax near-tie: at its first divergence the reference's
    next-token logits (recomputed by the plain f32 forward) have a top-2
    gap below 1e-3."""
    from elephas_tpu_torch.models.transformer import forward

    c32 = dataclasses.replace(cfg, dtype=torch.float32, attention_impl="xla")
    ties = []
    for p, r, o in zip(prompts, ref, out):
        if r == o:
            continue
        i = next((j for j, (x, y) in enumerate(zip(r, o)) if x != y),
                 min(len(r), len(o)))
        ctx = torch.as_tensor([list(p) + list(r[:i])], device="cuda")
        top2 = forward(params, ctx, c32)[0, -1].topk(2).values
        gap = float(top2[0] - top2[1])
        require(gap < 1e-3, f"divergence at token {i} with top-2 gap {gap}")
        ties.append({"index": i, "gap": gap})
    return ties


def greedy_plain(params, cfg, prompt, n):
    """``n`` greedy tokens after ``prompt`` from the plain f32 forward
    over the whole sequence at every step (no KV cache, no kernel)."""
    from elephas_tpu_torch.models.transformer import forward

    c32 = dataclasses.replace(cfg, dtype=torch.float32, attention_impl="xla")
    seq = list(prompt)
    for _ in range(n):
        logits = forward(params, torch.as_tensor([seq], device="cuda"), c32)
        seq.append(int(logits[0, -1].argmax()))
    return seq[len(prompt):]


def run_serving(params, cfg):
    """The paged engine at full width: 16 requests of 64-512 prompt
    tokens, 64 new tokens each, 8 slots, a pool of 512 usable blocks of
    16. f32: the fused kernel's greedy tokens equal the gather path's
    (tie-aware). bf16: the main-path run, timed."""
    rng = np.random.default_rng(4)
    lengths = rng.integers(64, 513, 16)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    gather, _ = serve(params, c32, prompts, "gather")
    fused, info32 = serve(params, c32, prompts, "fused")
    require(all(len(o) == 64 for o in fused), "every request got 64 tokens")
    ties = tie_aware_equal(params, cfg, prompts, gather, fused)
    require(info32["stats"]["kernel_launches"] > 0,
            "f32 fused engine launched the paged kernel")

    serve(params, cfg, prompts[:2], "fused", max_new=4)      # warm-up
    reset_counts()
    out16, info16 = serve(params, cfg, prompts, "fused", timed=True)
    torch.cuda.synchronize()
    counts = read_counts()
    require(counts["paged_decode"] > 0,
            f"the serving run launched the paged kernel: {counts}")
    require(counts["paged_decode"] == info16["stats"]["kernel_launches"],
            "engine stats agree with the wrapper's count")
    require(all(len(o) == 64 for o in out16), "bf16: 64 tokens each")
    require(all(0 <= t < cfg.vocab_size for o in out16 for t in o),
            "bf16 tokens in the vocabulary")
    emit({"phase": "serving", "requests": len(prompts),
          "prompt_lengths": [int(n) for n in lengths], "max_new_tokens": 64,
          "f32_equal_rows": sum(a == b for a, b in zip(gather, fused)),
          "f32_near_tie_divergences": ties,
          "bf16": {k: v for k, v in info16.items() if k != "stats"},
          "bf16_stats": info16["stats"], "launches": counts})
    return counts


def run_train_parity(params, cfg, shape=(2, 1024), phase="train_parity"):
    """One f32 ``lm_loss`` value and gradient at full width, ``shape``
    tokens, through the flash kernels (f32 bodies) against the plain
    attention path; each leaf's error relative to that leaf's max
    |gradient|."""
    from elephas_tpu_torch.models.transformer import lm_loss_and_grads

    tokens = torch.as_tensor(
        np.random.default_rng(6).integers(0, cfg.vocab_size, shape),
        device="cuda")
    out = {}
    for impl in ("flash", "xla"):
        c = dataclasses.replace(cfg, dtype=torch.float32,
                                attention_impl=impl)
        loss, grads = lm_loss_and_grads(params, tokens, c)
        out[impl] = (float(loss), grads)
    (fl, fg), (pl, pg) = out["flash"], out["xla"]
    rel = [max_err(a, b) / max(float(b.abs().max()), 1e-30)
           for a, b in zip(fg, pg)]
    tol = 1e-3
    require(np.isfinite(fl) and abs(fl - pl) <= 1e-4,
            f"f32 loss flash {fl} vs plain {pl}")
    require(max(rel) <= tol, f"f32 gradient rel err {max(rel)} <= {tol}")
    emit({"phase": phase, "batch": shape[0], "seq": shape[1],
          "head_dim": cfg.head_dim, "loss_flash": fl, "loss_plain": pl, "loss_diff": abs(fl - pl),
          "max_grad_rel_err": max(rel), "leaves": len(rel),
          "tolerance": {"loss_abs": 1e-4, "grad_rel_to_leaf_max": tol}})


def zipf_tokens(rng, vocab, shape):
    """Token ids with Zipf-distributed frequencies (exponent 1.1), so an
    LM's loss has somewhere to go."""
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks ** -1.1
    return rng.choice(vocab, size=shape, p=probs / probs.sum())


def flops_per_token(cfg, seq: int) -> float:
    """bench.py's model FLOPs per trained token (PaLM accounting):
    3 x (2 x matmul params + attention scores and values)."""
    p_matmul = (cfg.num_layers * (4 * cfg.d_model * cfg.d_model
                                  + 2 * cfg.d_model * cfg.d_ff)
                + cfg.d_model * cfg.vocab_size)
    attn = 2 * 2 * (seq / 2) * cfg.d_model
    return 3 * (2 * p_matmul + cfg.num_layers * attn)


def run_train(cfg):
    """The slice's main path: ``TransformerModel(...).compile(AdamW)``
    and ``fit_tokens`` at batch 8 x 1024, bf16 over f32 weights, two
    epochs of four steps over one seeded token set (Zipf-distributed
    ids, so the loss has somewhere to go). Then the trained model serves
    two requests through the paged engine: in f32 its greedy tokens must
    equal the plain forward's argmax and its sampled tokens the gather
    engine's; in bf16 through ``model.engine``."""
    from elephas_tpu_torch.models.optimizers import AdamW
    from elephas_tpu_torch.models.transformer_model import TransformerModel
    from elephas_tpu_torch.serving_engine import DecodeEngine

    batch, seq, rows, epochs = 8, 1024, 32, 2
    rng = np.random.default_rng(7)
    tokens = zipf_tokens(rng, cfg.vocab_size, (rows, seq))
    model = TransformerModel(cfg, device="cuda").compile(
        AdamW(3e-4, epsilon=1e-8, weight_decay=1e-4, decay_1d=True), seed=0)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    hist = model.fit_tokens(tokens, epochs=epochs, batch_size=batch, seed=0)
    torch.cuda.synchronize()
    counts = read_counts()
    steps = epochs * (rows // batch)
    losses = hist["loss"]
    require(all(np.isfinite(losses)), f"finite losses {losses}")
    require(losses[1] < losses[0], f"epoch 2 loss below epoch 1: {losses}")
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        require(counts[name] == cfg.num_layers * steps,
                f"{name} launched {cfg.num_layers} times per step: {counts}")
    step_s = hist["epoch_time"][1] / (rows // batch)
    tok_s = batch * seq / step_s
    mfu = flops_per_token(cfg, seq) * tok_s / PEAK_BF16_FLOPS
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    # the trained weights through the paged engine, in f32: the fused
    # kernel's greedy tokens equal the plain forward's argmax
    # (tie-aware), and, sampled at temperature 1 from one seed (tokens
    # that vary, where a model this young answers greedy with its most
    # frequent id), the fused engine's tokens equal the gather engine's;
    # then the bf16 engine, as a user would build it, serves
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (20, 45)]
    c32 = dataclasses.replace(cfg, dtype=torch.float32)

    def engine32(kernel, temperature=0.0):
        return DecodeEngine(model.params, c32, max_slots=2, paged=(16, 16),
                            kernel=kernel, temperature=temperature, seed=1,
                            device="cuda")

    oracle = [greedy_plain(model.params, cfg, p, 8) for p in prompts]
    fused32 = engine32("fused").run(prompts, 8)
    ties = tie_aware_equal(model.params, cfg, prompts, oracle, fused32)
    sampled = {k: engine32(k, 1.0).run(prompts, 8)
               for k in ("gather", "fused")}
    require(sampled["fused"] == sampled["gather"],
            f"f32 sampled tokens, fused vs gather: {sampled}")
    require(len({t for o in sampled["fused"] for t in o}) > 1,
            f"the sampled check saw more than one token id: {sampled}")
    eng = model.engine(max_slots=2, paged=(16, 16), kernel="fused")
    outs = eng.run(prompts, 8)
    require(all(len(o) == 8 for o in outs) and all(
        0 <= t < cfg.vocab_size for o in outs for t in o),
        f"the trained model served 2 requests: {outs}")
    emit({"phase": "train", "batch": batch, "seq": seq, "steps": steps,
          "epoch_losses": losses, "epoch_time_s": hist["epoch_time"],
          "ms_per_step": step_s * 1e3, "tokens_per_s": tok_s,
          "flops_per_token": flops_per_token(cfg, seq), "mfu": mfu,
          "peak_memory_gib": peak_gb, "launches": counts,
          "launches_per_step": {k: counts[k] / steps
                                for k in ("flash_fwd", "flash_dq",
                                          "flash_dkv")},
          "served_f32": fused32, "plain_argmax_f32": oracle,
          "f32_near_tie_divergences": ties,
          "sampled_f32_fused": sampled["fused"], "served": outs})
    return counts


# ------------------------------------------------- Keras-style TPUModel
def mnist_like(n, seed, dim=784, classes=10, centers_seed=123):
    """The "MNIST-like" set of ``tests/conftest.py`` (``_make_classification``):
    class centers fixed across splits, unit-normal noise around them,
    min-max scaled, one-hot labels."""
    centers = np.random.default_rng(centers_seed).normal(0.0, 2.0,
                                                         size=(classes, dim))
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, size=n)
    x = centers[labels] + rng.normal(0.0, 1.0, size=(n, dim))
    x = (x - x.min()) / (x.max() - x.min())
    return x.astype("float32"), np.eye(classes)[labels].astype("float32")


def mnist_mlp(dropout: float, device="cuda"):
    """The bench's MLP, 784-128-128-10, with the conftest's Dropout
    layers when ``dropout`` > 0."""
    from elephas_tpu_torch.models import (Activation, Dense, Dropout,
                                          Sequential)
    drop = [Dropout(dropout)] if dropout else []
    return Sequential([Dense(128, input_dim=784), Activation("relu"), *drop,
                       Dense(128), Activation("relu"), *drop, Dense(10),
                       Activation("softmax")], device=device)


def tpu_model_oracle(tpu_model, x_test, y_test):
    """The reference's oracle: distributed predict's argmax equals the
    master network's; distributed evaluate within 0.01 of the master's.
    Returns (evaluate, master evaluate)."""
    preds = tpu_model.predict(x_test)
    master = tpu_model.master_network.predict(x_test)
    require(preds.shape == (len(x_test), 10) and np.isfinite(preds).all(),
            "distributed predictions finite, one row per input")
    require(np.array_equal(preds.argmax(1), master.argmax(1)),
            "distributed predict argmax equals the master's")
    evals = tpu_model.evaluate(x_test, y_test)
    master_evals = tpu_model.master_network.evaluate(x_test, y_test)
    require(all(abs(a - b) <= 0.01 for a, b in zip(evals, master_evals)),
            f"distributed evaluate {evals} within 0.01 of {master_evals}")
    return evals, master_evals


def plain_mlp_samples_per_s(x, y, batch_size=64, epochs=2):
    """bench.py's hand-written training loop (``bench_pure_jax``) on the
    card: the same MLP as plain tensors, glorot init, log-softmax
    cross-entropy, SGD 0.1, a shuffled epoch of full batches; data on
    the card. Returns the second epoch's samples/s."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def glorot(i, o):
        limit = float(np.sqrt(6.0 / (i + o)))
        return (torch.rand((i, o), generator=gen, device="cuda") * 2 - 1) * limit

    params = [glorot(784, 128), torch.zeros(128, device="cuda"),
              glorot(128, 128), torch.zeros(128, device="cuda"),
              glorot(128, 10), torch.zeros(10, device="cuda")]
    for p in params:
        p.requires_grad_()
    x, y = torch.as_tensor(x, device="cuda"), torch.as_tensor(y, device="cuda")
    n = x.shape[0]
    nb = n // batch_size
    times = []
    for _ in range(epochs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        order = torch.randperm(n, generator=gen, device="cuda")
        for i in range(nb):
            idx = order[i * batch_size:(i + 1) * batch_size]
            w1, b1, w2, b2, w3, b3 = params
            h = torch.relu(x[idx] @ w1 + b1)
            h = torch.relu(h @ w2 + b2)
            logp = torch.log_softmax(h @ w3 + b3, dim=-1)
            loss = -(y[idx] * logp).sum(-1).mean()
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                for p, g in zip(params, grads):
                    p.sub_(0.1 * g)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    require(bool(torch.isfinite(loss)), "plain loop loss finite")
    return nb * batch_size / times[-1]


def run_keras_sync_step(data):
    """``TPUModel(mode="synchronous", sync_mode="step")`` on the bench's
    MLP at full width: SGD, categorical cross-entropy, acc, batch 64, two
    epochs over 60,000 rows; then the oracle and the held-out accuracy
    on 10,000 rows, and the plain loop's samples/s beside.

    The learning rate is 0.01, not the bench's 0.1: on this set (every
    feature min-max scaled around 0.5) SGD 0.1 at batch 64 does not
    train; its loss rises in the second epoch, in the JAX package as in
    the port (``tests/test_torch_tpu_model.py::
    test_sgd_rate_on_the_full_mnist_like_set`` shows both)."""
    from elephas_tpu_torch import SGD, TPUModel, to_dataset

    (x, y), (x_test, y_test) = data
    model = mnist_mlp(0.0)
    model.compile(SGD(learning_rate=0.01), "categorical_crossentropy",
                  ["acc"], seed=0)
    tpu_model = TPUModel(model, mode="synchronous", sync_mode="step",
                         batch_size=64)
    t0 = time.perf_counter()
    tpu_model.fit(to_dataset(x, y), epochs=2, batch_size=64,
                  validation_split=0.0)
    fit_s = time.perf_counter() - t0
    hist = tpu_model.training_histories[-1]
    losses = hist["loss"]
    require(all(np.isfinite(losses)) and losses[1] < losses[0],
            f"sync step epoch losses fall: {losses}")
    evals, master_evals = tpu_model_oracle(tpu_model, x_test, y_test)
    require(evals[1] > 0.9, f"held-out accuracy {evals[1]} > 0.9")
    samples_s = len(x) / hist["epoch_time"][1]
    plain_s = plain_mlp_samples_per_s(x, y)
    emit({"phase": "keras_sync_step", "rows": len(x), "held_out": len(x_test),
          "batch": 64, "epochs": 2, "epoch_losses": losses,
          "epoch_acc": hist["categorical_accuracy"],
          "epoch_time_s": hist["epoch_time"], "fit_s": fit_s,
          "samples_per_s": samples_s, "plain_loop_samples_per_s": plain_s,
          "held_out_loss_acc": evals, "master_loss_acc": master_evals})
    return samples_s


def check_delta_mean(w0, shards, new_weights, hists):
    """Retrain the four workers of ``run_keras_sync_average`` (same start,
    shards, seeds and dropout draws) through ``train_workers`` and
    recompute the average in plain torch: ``new_weights`` must equal
    w0 - sum(w0 - trained) / 4, and each copy's losses its history's.
    Returns the largest weight error."""
    from elephas_tpu_torch import SGD
    from elephas_tpu_torch.models import metrics
    from elephas_tpu_torch.parallel import SyncAverageTrainer

    ref = mnist_mlp(0.2)
    ref.build()
    ref.set_weights(w0)
    loss = "categorical_crossentropy"
    trainer = SyncAverageTrainer(ref, SGD(learning_rate=0.01), loss,
                                 [metrics.get("acc", loss=loss)])
    start = [torch.as_tensor(w, device="cuda") for w in w0]
    delta = [torch.zeros_like(w) for w in start]
    trained = 0
    for w, final, stats in trainer.train_workers(
            ref.params, shards, epochs=2, batch_size=64,
            validation_split=0.1):
        require(np.allclose(stats[:, 0].tolist(), hists[w]["loss"],
                            rtol=0, atol=1e-6),
                f"worker {w}'s copy repeats its losses {hists[w]['loss']}")
        for i, (ln, pn) in enumerate(ref._weight_entries()):
            delta[i] += start[i] - final[ln][pn].detach()
        trained += 1
    require(trained == 4, f"all four workers trained: {trained}")
    err = max(float((torch.as_tensor(got, device="cuda")
                     - (s - d / 4)).abs().max())
              for got, s, d in zip(new_weights, start, delta))
    require(err <= 1e-6, f"new weights are the start minus the mean "
            f"delta of the four workers: max error {err}")
    return err


def run_keras_sync_average(data):
    """``TPUModel(mode="synchronous")`` (model averaging) on the
    conftest's Dropout-0.2 model at full width: 4 workers, batch 64, two
    epochs, validation split 0.1, SGD 0.01 as in the step phase; the
    four worker histories, the oracle and seconds per fit. The master's
    new weights must be the start minus the mean of the four workers'
    deltas, recomputed here from each worker's trained copy."""
    from elephas_tpu_torch import SGD, TPUModel, to_dataset

    (x, y), (x_test, y_test) = data
    model = mnist_mlp(0.2)
    model.compile(SGD(learning_rate=0.01), "categorical_crossentropy",
                  ["acc"], seed=0)
    w0 = model.get_weights()
    tpu_model = TPUModel(model, mode="synchronous", num_workers=4,
                         batch_size=64)
    dataset = to_dataset(x, y)
    t0 = time.perf_counter()
    tpu_model.fit(dataset, epochs=2, batch_size=64, validation_split=0.1)
    fit_s = time.perf_counter() - t0
    hists = tpu_model.training_histories
    require(len(hists) == 4, f"four worker histories: {len(hists)}")
    for h in hists:
        require(all(np.isfinite(h["loss"])) and h["loss"][1] < h["loss"][0],
                f"worker epoch losses fall: {h['loss']}")
    average_err = check_delta_mean(w0, dataset.repartition(4).partitions(),
                                   tpu_model.master_network.get_weights(),
                                   hists)
    evals, master_evals = tpu_model_oracle(tpu_model, x_test, y_test)
    require(evals[1] > 0.9, f"held-out accuracy {evals[1]} > 0.9")
    emit({"phase": "keras_sync_average", "rows": len(x), "workers": 4,
          "batch": 64, "epochs": 2, "validation_split": 0.1,
          "worker_histories": hists, "fit_s": fit_s,
          "delta_mean_max_abs_err": average_err,
          "trainer_fit_time_s": hists[0]["fit_time"][0],
          "held_out_loss_acc": evals, "master_loss_acc": master_evals})


def client_rpcs():
    """``{op: (count, seconds)}`` of the parameter clients' successful
    pulls and pushes so far in this process (their latency histograms)."""
    from elephas_tpu_torch.obs.metrics import default_registry
    family = default_registry().histogram(
        "ps_client_rpc_latency_seconds",
        "successful PS client RPC attempt latency", labels=("op",))
    return {op: (family.labels(op=op).count, family.labels(op=op).sum)
            for op in ("get_parameters", "update_parameters")}


def async_pushes(sizes, frequency, epochs, accum, batch=64):
    """The pushes the workers issue: one per local epoch at epoch
    frequency; at batch frequency one per step, or one per window of
    ``accum`` steps and one for a partial last window."""
    if frequency == "epoch":
        return len(sizes) * epochs
    steps = [epochs * -(-n // batch) for n in sizes if n > batch]
    return sum(-(-s // accum) for s in steps)


def async_card_matches_cpu(data, rows=4096):
    """One worker at batch frequency (the reference loop, socket, SGD
    0.01, one epoch of 64 steps) from the same weights, master on the
    card and on the CPU: the final weights within 1e-4 (TF32 is off).

    The CPU fit runs on one thread: the CPU's GEMMs split their sums by
    thread count, and on these rows a ReLU input near zero flips sign
    between thread counts, after which the fits part (2.1e-3 after 64
    steps with the CPU fit on 8 threads, the check's first run on an
    H100 host). One thread sums in index order, as the card's f32 GEMMs
    do with TF32 off."""
    from elephas_tpu_torch import SGD, TPUModel, to_dataset
    from elephas_tpu_torch.utils.sockets import free_port

    (x, y), _ = data
    finals, w0 = [], None
    threads = torch.get_num_threads()
    for device in ("cpu", "cuda"):
        torch.set_num_threads(1 if device == "cpu" else threads)
        model = mnist_mlp(0.0, device)
        model.compile(SGD(learning_rate=0.01), "categorical_crossentropy",
                      seed=0)
        w0 = w0 or model.get_weights()
        model.set_weights(w0)
        tpu_model = TPUModel(model, mode="asynchronous", frequency="batch",
                             parameter_server_mode="socket", num_workers=1,
                             port=free_port())
        tpu_model.fit(to_dataset(x[:rows], y[:rows]), epochs=1,
                      batch_size=64)
        finals.append(model.get_weights())
    err = max(float(np.abs(a - b).max()) for a, b in zip(*finals))
    emit({"phase": "keras_async_card_vs_cpu", "rows": rows, "steps":
          rows // 64, "max_abs_err": err})
    require(err <= 1e-4, f"one async worker on the card matches the CPU "
            f"within 1e-4: {err}")


# (c) runs 2 workers, as the JAX repo's own row for the overlapped loop
# (benchmarks/baseline_rows.py:106-146): at 4 workers and 8 steps a
# window neither package, unmodified, trains this set
# (tests/torch_overlap_workers.py runs both on the CPU at 2 and 4)
ASYNC_CONFIGS = {
    "a": dict(mode="asynchronous", parameter_server_mode="http",
              frequency="epoch", num_workers=4),
    "b": dict(mode="hogwild", parameter_server_mode="socket",
              frequency="batch", num_workers=4),
    "c": dict(mode="asynchronous", parameter_server_mode="http",
              frequency="batch", async_overlap=True, async_accum=8,
              num_workers=2),
}


def run_keras_async(data, sync_samples_s):
    """``TPUModel`` in its parameter-server modes (the default
    ``mode="asynchronous"`` and ``"hogwild"``) on the rows of the sync
    phases and the MLP of ``examples/mnist_mlp_asynchronous.py`` (with
    its Dropout 0.2), workers as threads on the card, SGD 0.01, batch 64,
    2 epochs, validation split 0.1: (a) asynchronous over HTTP at epoch
    frequency, 4 workers, (b) hogwild over the socket at batch frequency
    (the reference loop: a pull, ``set_weights``, a step,
    ``get_weights`` and a push per batch), 4 workers, (c) asynchronous
    over HTTP at batch frequency, overlapped, one push per 8 steps, 2
    workers. Each: the oracle, held-out
    accuracy above 0.9, the server's update count equal to the pushes
    the workers issued (by formula and by the clients' RPC counts),
    samples/s beside the sync step's, and ms per pull and per push.
    Then one worker on the card against the same fit on the CPU."""
    from elephas_tpu_torch import SGD, TPUModel, to_dataset
    from elephas_tpu_torch.utils import native
    from elephas_tpu_torch.utils.sockets import free_port

    (x, y), (x_test, y_test) = data
    native.build()
    codec = "native" if native.available() else "python"
    epochs, vsplit = 2, 0.1
    results = {}
    for name, cfg in ASYNC_CONFIGS.items():
        workers = cfg["num_workers"]
        model = mnist_mlp(0.2)
        model.compile(SGD(learning_rate=0.01), "categorical_crossentropy",
                      ["acc"], seed=0)
        tpu_model = TPUModel(model, batch_size=64, port=free_port(), **cfg)
        dataset = to_dataset(x, y).repartition(workers)
        sizes = dataset.partition_sizes()
        before = client_rpcs()
        t0 = time.perf_counter()
        tpu_model.fit(dataset, epochs=epochs, batch_size=64,
                      validation_split=vsplit)
        fit_s = time.perf_counter() - t0
        after = client_rpcs()
        rpc = {op: (after[op][0] - before[op][0],
                    after[op][1] - before[op][1]) for op in after}
        report = tpu_model.training_histories[-1]["supervisor"]
        require(report["completed_shards"] == list(range(workers))
                and not report["failures"],
                f"({name}) every worker completed: {report}")
        pushes = async_pushes(sizes, cfg["frequency"], epochs,
                              cfg.get("async_accum", 1))
        updates = tpu_model.parameter_server.num_updates
        require(updates == pushes == rpc["update_parameters"][0],
                f"({name}) server updates {updates} equal the pushes "
                f"issued: {pushes} by count, "
                f"{rpc['update_parameters'][0]} by the clients")
        evals, master_evals = tpu_model_oracle(tpu_model, x_test, y_test)
        require(evals[1] > 0.9, f"({name}) held-out accuracy {evals[1]} "
                "> 0.9")
        trained = sum(int(n * (1 - vsplit)) if cfg["frequency"] == "epoch"
                      else n for n in sizes) * epochs
        results[name] = {
            **cfg, "fit_s": fit_s,
            "samples_per_s": trained / fit_s,
            "vs_sync_step": trained / fit_s / sync_samples_s,
            "server_updates": updates,
            "pulls": rpc["get_parameters"][0],
            "pull_ms": 1e3 * rpc["get_parameters"][1]
            / max(rpc["get_parameters"][0], 1),
            "push_ms": 1e3 * rpc["update_parameters"][1]
            / max(rpc["update_parameters"][0], 1),
            "held_out_loss_acc": evals, "master_loss_acc": master_evals}
    emit({"phase": "keras_async", "rows": len(x), "held_out": len(x_test),
          "batch": 64, "epochs": epochs, "validation_split": vsplit,
          "codec": codec, "sync_step_samples_per_s": sync_samples_s,
          "frame_bytes": sum(w.nbytes for w in model.get_weights()),
          "configs": results})
    async_card_matches_cpu(data)


def run_tpu_model_lm(cfg):
    """``TPUModel(TransformerModel(flagship))`` in synchronous mode: one
    epoch of 2 steps at batch 8 x 1024 (18 seeded Zipf rows, 2 held out
    by the default validation split of 0.1), then ``predict`` on 2 rows
    and ``evaluate``. The flash kernels must carry the route; evaluate
    must equal the cross-entropy of predict's logits."""
    from elephas_tpu_torch import TPUModel
    from elephas_tpu_torch.models.optimizers import AdamW
    from elephas_tpu_torch.models.transformer_model import TransformerModel

    tokens = zipf_tokens(np.random.default_rng(11), cfg.vocab_size,
                         (18, 1024))
    model = TransformerModel(cfg, device="cuda").compile(
        AdamW(3e-4, epsilon=1e-8, weight_decay=1e-4, decay_1d=True), seed=0)
    tpu_model = TPUModel(model, mode="synchronous", batch_size=8)
    reset_counts()
    t0 = time.perf_counter()
    tpu_model.fit(tokens, epochs=1, batch_size=8, seed=0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    logits = tpu_model.predict(tokens[:2])
    loss = tpu_model.evaluate(tokens[:2], None)
    torch.cuda.synchronize()
    counts = read_counts()
    hist = tpu_model.training_histories[-1]
    require(all(np.isfinite(hist["loss"] + hist["val_loss"])),
            f"finite LM losses {hist}")
    require(logits.shape == (2, 1024, cfg.vocab_size)
            and np.isfinite(logits).all(), "predict logits finite")
    lg = torch.as_tensor(logits[:, :-1])
    ce = float(-(torch.log_softmax(lg, -1).gather(
        -1, torch.as_tensor(tokens[:2, 1:])[..., None])).mean())
    require(np.isfinite(loss) and abs(loss - ce) <= 1e-3,
            f"evaluate {loss} equals predict's cross-entropy {ce}")
    steps = 2
    for name in ("flash_dq", "flash_dkv"):
        require(counts[name] == cfg.num_layers * steps,
                f"{name} launched once per layer and step: {counts}")
    # forward passes: 2 train steps, the validation loss, predict, evaluate
    require(counts["flash_fwd"] == cfg.num_layers * (steps + 3),
            f"flash_fwd launched once per layer and forward: {counts}")
    emit({"phase": "tpu_model_lm", "batch": 8, "seq": 1024, "steps": steps,
          "history": hist, "fit_s": fit_s, "evaluate_loss": loss,
          "predict_cross_entropy": ce, "launches": counts})
    return counts


def run_tpu_model_lm_d32():
    """``TPUModel`` over ``TransformerModel`` at the
    ``examples/transformer_tpumodel.py`` config (vocab 512, 4 layers, 8
    heads, d_model 256, d_ff 512, seq 128: head dim 32), bf16 over f32
    weights, ``Adam(3e-4)``, seed 0, under the default
    ``attention_impl="auto"``: ``fit`` on 256 seeded Zipf rows x 128 for
    up to 5 epochs at batch 16 with a validation split of 0.1 and
    ``EarlyStopping(val_loss, patience 2)``, then ``predict`` and
    ``evaluate`` on 32 rows. The d 32 flash kernels must carry every
    forward and step; the loss must fall; evaluate must equal the
    cross-entropy of predict's logits. Then one f32 gradient at this
    config through the kernels against the plain path."""
    from elephas_tpu_torch import Adam, TPUModel
    from elephas_tpu_torch.models import EarlyStopping
    from elephas_tpu_torch.models.transformer import (TRANSFORMER_TPUMODEL,
                                                      TransformerConfig,
                                                      init_params)
    from elephas_tpu_torch.models.transformer_model import TransformerModel

    cfg = TransformerConfig(**TRANSFORMER_TPUMODEL)
    require(cfg.head_dim == 32, f"head dim {cfg.head_dim}")
    rows, seq, batch, epochs, val = 256, cfg.max_seq_len, 16, 5, 0.1
    tokens = zipf_tokens(np.random.default_rng(12), cfg.vocab_size,
                         (rows, seq))
    model = TransformerModel(cfg, device="cuda").compile(Adam(3e-4), seed=0)
    tpu_model = TPUModel(model, mode="synchronous")
    stop = EarlyStopping(monitor="val_loss", patience=2)
    reset_counts()
    t0 = time.perf_counter()
    tpu_model.fit(tokens, epochs=epochs, batch_size=batch,
                  validation_split=val, callbacks=[stop])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_counts = read_counts()
    probe = tokens[:32]
    reset_counts()
    logits = tpu_model.predict(probe)
    loss = tpu_model.evaluate(probe, None)
    torch.cuda.synchronize()
    infer_counts = read_counts()
    hist = tpu_model.training_histories[-1]
    losses = hist["loss"]
    require(all(np.isfinite(losses + hist["val_loss"])),
            f"finite LM losses {hist}")
    require(losses[-1] < losses[0], f"training loss falls: {losses}")
    require(logits.shape == (32, seq, cfg.vocab_size)
            and np.isfinite(logits).all(), "predict logits finite")
    lg = torch.as_tensor(logits[:, :-1])
    ce = float(-(torch.log_softmax(lg, -1).gather(
        -1, torch.as_tensor(probe[:, 1:])[..., None])).mean())
    require(np.isfinite(loss) and abs(loss - ce) <= 1e-3,
            f"evaluate {loss} equals predict's cross-entropy {ce}")
    ran = len(losses)
    steps = ran * ((rows - int(round(rows * val))) // batch)
    layers = cfg.num_layers
    for name in ("flash_dq", "flash_dkv"):
        require(fit_counts[name] == layers * steps,
                f"{name} launched once per layer and step: {fit_counts}")
    # forward passes: every train step and each epoch's validation loss
    require(fit_counts["flash_fwd"] == layers * (steps + ran),
            f"flash_fwd launched once per layer and forward: {fit_counts}")
    # one predict and one evaluate batch (TPUModel's batch size, 32)
    require(infer_counts["flash_fwd"] == 2 * layers,
            f"predict and evaluate launched flash_fwd: {infer_counts}")
    counts = {k: fit_counts[k] + infer_counts[k] for k in fit_counts}
    emit({"phase": "tpu_model_lm_d32", "config": TRANSFORMER_TPUMODEL,
          "head_dim": cfg.head_dim, "rows": rows, "batch": batch,
          "epochs_run": ran, "stopped_epoch": stop.stopped_epoch,
          "steps": steps, "history": hist, "fit_s": fit_s,
          "evaluate_loss": loss, "predict_cross_entropy": ce,
          "launches": counts, "launches_fit": fit_counts,
          "launches_predict_evaluate": infer_counts})
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    run_train_parity(params, cfg, shape=(batch, seq),
                     phase="train_parity_d32")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "GPU", file=sys.stderr)
        return 2
    from elephas_tpu_torch.models.transformer import (FLAGSHIP,
                                                      TransformerConfig,
                                                      init_params)
    from elephas_tpu_torch.ops import _kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    report = _kernels.build(force=True)
    _kernels.library()
    resources = [ln.split("ptxas info    : ")[-1].strip()
                 for ln in report.splitlines()
                 if "entry function" in ln or "registers" in ln
                 or "spill" in ln]
    spills = [ln for ln in resources if "spill" in ln
              and "0 bytes spill stores, 0 bytes spill loads" not in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": resources})
    require(not spills, f"no kernel spills registers: {spills}")

    # a buffer past the 50 MB L2, overwritten before each timed call
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    paged = check_paged(flush)
    flash = check_flash(flush)
    bwd = check_flash_bwd(flush)
    del flush

    cfg = TransformerConfig(**FLAGSHIP)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    fwd_counts = run_forward(params, cfg)
    srv_counts = run_serving(params, cfg)
    run_train_parity(params, cfg)
    del params
    train_counts = run_train(cfg)

    data = (mnist_like(60000, seed=0), mnist_like(10000, seed=1))
    sync_samples_s = run_keras_sync_step(data)
    run_keras_sync_average(data)
    reset_counts()
    run_keras_async(data, sync_samples_s)
    async_counts = read_counts()
    require(not any(async_counts.values()),
            f"no async path launches a kernel: {async_counts}")
    lm_counts = run_tpu_model_lm(cfg)
    d32_counts = run_tpu_model_lm_d32()
    d16_counts = run_forward_d16()

    # max_abs_err: the largest error of any comparison this run made for
    # the kernel, f32 and bf16, at the main paths' shapes included; the
    # times as issued (ms, plain_ms, library_ms) and device time alone
    # (device_ms, library_device_ms)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "device_ms", "library_device_ms")
    # launches on each path, each path's counts set to 0 just before it
    paths = {"forward": fwd_counts, "serving": srv_counts,
             "train": train_counts, "tpu_model_lm": lm_counts,
             "tpu_model_lm_d32": d32_counts, "forward_d16": d16_counts,
             "keras_async": async_counts}
    kernels = [
        {"name": "paged_decode", "route": "cuda",
         "source": "elephas_tpu_torch/csrc/paged_decode.cu",
         "replaces": "elephas_tpu/ops/paged_attention.py:59",
         "launches": srv_counts["paged_decode"],
         **{k: paged[k] for k in keys}},
        {"name": "flash_fwd", "route": "cuda",
         "source": "elephas_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "elephas_tpu/ops/pallas_attention.py:55",
         "launches": fwd_counts["flash_fwd"],
         **{k: flash[k] for k in keys}},
        *({"name": f"flash_{part}", "route": "cuda",
           "source": "elephas_tpu_torch/csrc/flash_bwd.cu",
           "replaces": f"elephas_tpu/ops/pallas_attention.py:{line}",
           "launches": train_counts[f"flash_{part}"],
           **{k: bwd[part][k] for k in keys}}
          for part, line in (("dq", 196), ("dkv", 243))),
    ]
    for entry, results in zip(kernels, (paged, flash, bwd["dq"],
                                        bwd["dkv"])):
        name = entry["name"]
        entry["launches_by_path"] = {p: c[name] for p, c in paths.items()}
        # each head dim's errors and times at the shape named beside them
        # (flash d 32 also at the training shape), and its instance's
        # launches on the path that runs it: d 64 the flagship's (as
        # above), d 32 tpu_model_lm_d32, d 16 forward_d16
        launches = {"16": d16_counts[name], "32": d32_counts[name],
                    "64": entry["launches"]}
        entry["by_head_dim"] = {
            d: {**{k: t[k] for k in (*keys, "shape") if k in t},
                "launches": launches[d],
                **({"at_training_shape": {
                    k: t["at_training_shape"][k]
                    for k in (*keys, "shape")
                    if k in t["at_training_shape"]}}
                   if "at_training_shape" in t else {})}
            for d, t in results["by_head_dim"].items()}
    print(nvidia_smi(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
