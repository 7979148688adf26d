"""End-to-end smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA device and the
CUDA toolkit. It builds the port's hand-written kernels from
``elephas_tpu_torch/csrc`` (and fails if any spills registers, or if
the head-dim-128 forward and dK/dV bodies and the head-dim-256 forward,
dQ and dK/dV bodies do not launch at 168 registers with their producer
warpgroup at 24 and consumers at 240, as ptxas and the SASS's
``setmaxnreg`` show), holds each kernel against
its plain PyTorch version at the shapes the main paths give it (the
flash kernels at head dims 16, 32, 64, 128 and 256, f32 and bf16, and at
the head-dim-32, -96, -128 and -256 paths' own shapes, at 128 and 256
also at the edges of their tiles; at head dims 8, 24, 40, 72,
80, 96, 120, 136, 192 and 248, which run a wider body on columns TMA
fills with zeros, over ragged lengths, GQA 4:1, a window edge and ring
offsets, 96 and 80 timed beside SDPA; the paged kernel at 16, 32, 64,
128 and 256 and at 80, 96 and 136 (chunks past the head dim idle on the
next body up), 128 at Mistral-7B's groups of 4, 96 at Phi-3-mini's 32
heads over 32 and 256 at Gemma-2B's 8 query heads over 1 kv head, each
bf16 call on its split-K body and each f32 call on its general body,
as the wrapper's ``split_launches`` count shows, with every split
instantiation's registers from the build), checks that two launches of
the paged, forward, dQ and dK/dV kernels give the same bits (dK/dV at
head dim 256 on its split path: the wrapper's plan cuts each k tile's
walk over its group's query heads into chunks, one CTA each, and a
reduction kernel sums a split tile's f32 partials; the chunk count and
the reduction's device time are printed apart, and the reduction is
held against its plain version and timed on its own), times one
request's paged decode (B 1, pos 1000) on a line of its own, then
drives the port's
entry points at the full width of the flagship LM config (vocab 32000,
8 layers, 16 heads, d_model 1024, d_ff 4096; random weights from a
seed): ``forward`` with the flash-attention kernel; the paged
``DecodeEngine`` with the fused paged-attention kernel serving 16
requests; one f32 ``lm_loss`` gradient with the flash kernels against
the plain path; and training through ``TransformerModel.fit_tokens``
(bf16, AdamW, batch 8 x 1024, two epochs) with the flash forward and
backward kernels, after which the trained model serves two requests.
``lm_d128`` does the same at Mistral-7B-v0.1's widths (head dim 128,
32 heads over 8 kv heads, SwiGLU, RMSNorm, RoPE, window 4096, untied
head; random weights): ``forward`` and the paged engine over all 32
layers (every bf16 paged launch on the split body; the paged kernels'
device ms per decode step from a profiled window beside ``step()``'s
p50), an f32 gradient and f32 greedy tokens against ``generate`` at
2 layers, and ``fit_tokens`` at 4 (the cuts are printed with it).
``lm_d96`` does the same at Phi-3-mini's widths (head dim 96 on the
flash kernels' 128-wide bodies, 32 heads over 32 kv heads, d_ff 8192
SwiGLU, RMSNorm, RoPE, window 2047, untied head, vocab 32064):
``forward`` at B 2 x 2048 and the paged engine (every bf16 launch on
the split body, 96 on the 128-wide body) over all 32 layers, with the
paged kernels' device ms per decode step, an f32 gradient and f32 greedy
tokens against the plain argmax at 2 layers, ``fit_tokens`` at 8.
``lm_d256`` does the same at Gemma-2B's widths (``GEMMA_2B``: head dim
256 on the flash kernels' 256-wide bodies, 8 heads over 1 kv head,
d_ff 16384 SwiGLU, RMSNorm, RoPE, tied, vocab 256000; its departures
from Gemma printed): ``forward`` at B 2 x 1024 (time as issued and on
the device) and the paged engine (every bf16 launch on the split body,
groups of 8) over all 18 layers, with the paged kernels' device ms per
decode step, f32 logits, gradient and greedy tokens at 2, ``fit_tokens`` at
8 with its peak memory.
Then the Keras-style models through ``TPUModel(mode="synchronous")`` at
the bench's MLP width (784-128-128-10) on 60,000 seeded rows of the
tests' MNIST-like recipe: ``sync_mode="step"`` (samples/s beside a plain
PyTorch loop of the same MLP) and the default model averaging over 4
workers with Dropout 0.2, each held to the reference's predict/evaluate
oracle and a held-out accuracy above 0.9; ``keras_async``, the
parameter-server modes on the same rows and the MLP of
``examples/mnist_mlp_asynchronous.py`` (Dropout 0.2): asynchronous over
HTTP at epoch frequency (2 workers, once as they come and once with
every epoch's pushes in lockstep), hogwild over the socket at batch
frequency (4 workers), and the overlapped batch loop
(``async_accum=8``, 2 workers), each with the oracle, the accuracy
check, the server's update count against the pushes issued, samples/s
and RPC times, then one worker's fit on the card against the CPU (no
kernel runs there: the phase fails if one launches); ``keras_persist``
(no kernel either): the sync-step model through
``TPUModel.save``/``load_tpu_model`` (predict and evaluate bit-equal),
a ``ModelCheckpoint(block=False)`` fit restored bit-equal into a fresh
``Sequential`` that trains on, and ``TPUMatrixModel`` on 8,192
LabeledPoints (async, 2 workers) with its ``mllib`` predict and save;
``keras_layers`` (no kernel either):
(a) ``examples/lstm_sequence_classification.py``'s program on the port
(Embedding -> cuDNN's LSTM -> Dense over 4096 rows, sync step
``TPUModel`` with 4 workers, 6 epochs, predict) with held-out accuracy,
samples/s beside a plain ``nn.LSTM`` loop, and one epoch on the card
against the CPU, (b) the layers and widths of Keras's ``mnist_cnn.py``
(two Conv2D, MaxPooling2D, Dropout, Dense; Adadelta 1.0) on the 60,000
rows as 28x28x1 images through ``TPUModel(sync_mode="average")`` for
2 epochs with the oracle and held-out accuracy, and (c) every layer,
optimizer and schedule ported with them, and BatchNormalization's
moving statistics over 3 fit steps, card against CPU at stated
tolerances; and ``TPUModel`` over the
flagship ``TransformerModel`` (one epoch of 2 steps, ``predict``,
``evaluate``), whose flash kernel launches are counted. Last,
``examples/transformer_tpumodel.py`` whole: ``TPUModel`` over its LM
(head dim 32: vocab 512, 4 layers, 8 heads, d_model 256) fits 256
seeded rows for up to 5 epochs with ``ModelCheckpoint`` and
``EarlyStopping`` and serves ``predict`` and ``evaluate`` through the
head-dim-32 flash kernels; a fresh model restores the checkpoint
bit-equal, trains one more epoch, and goes through ``TPUModel.save``
and ``load_tpu_model`` to a bit-equal ``predict``; and one f32
gradient at that config through the kernels meets the plain path's;
and ``forward`` of the ``examples/http_serving.py`` LM (head dim 16,
f32) runs the head-dim-16 flash kernel and meets the plain path (every
launch on the f32 forward's strip body, as the wrapper's
``f32_narrow_launches`` count shows).
Serving over HTTP: ``http_serving_flagship`` puts ``ServingServer`` at
the flagship width in front of three engines (the default contiguous
cache; the contiguous cache with a registered system prompt,
``steps_per_sync=4`` and ``prefill_chunk=64``; the paged pool with the
fused kernel, the block cache, the registered prompt and
``steps_per_sync=4``), 16 concurrent streaming clients of a shared
256-token system prompt plus a 16-128-token suffix and 64 new tokens
each: f32 tokens equal the port's ``generate``, and in bf16 it prints
output tokens/s, client TTFT and latency p50/p99, host ms per step,
prefix reuse and paged-kernel launches, then times ``generate`` and
``beam_search`` (4 beams) at B 8; ``http_serving_example`` runs
``examples/http_serving.py``'s program (its LM, engine, registered
prefix and 5 concurrent text clients, then ``/v1/submit`` and
``/stats``) with ``kernel="gather"`` and ``kernel="fused"``, each
client's tokens equal to ``generate``'s. Speculative decoding:
``speculative_flagship`` distils a 1-layer draft of the flagship's
widths with ``make_distill_step`` at B 8 x 1024 (the three flash
kernels), runs ``speculative_generate`` at B 8 (gamma 4; the target as
its own draft, the truncated and the distilled draft) beside
``generate``, then a paged ``DecodeEngine`` with the draft and a plain
paged engine with ``interleave_prefill`` (the paged split body) on the
serving phase's 16 requests, with tokens/s, target rounds per token,
acceptance and ``step()`` times; at 2 layers in f32 greedy speculative
tokens and both engines' outputs equal ``generate`` (tie-aware) and the
target as its own draft accepts every proposal.
``speculative_example`` runs ``examples/speculative_serving.py``'s
program (head dim 16, f32: its training and distillation on the d 16
flash kernels, every forward, dQ and dK/dV launch on the f32 strip
bodies; ``flash_f32_bodies`` holds the f32 bodies at d 16 against their
plain versions at both paths' shapes, and the f32 dQ and dK/dV
tensor-core bodies at 64-256 at the shapes of the f32 checks that run
them, names the body each ran, times them beside two bounds (the CUDA
cores' f32 rate and the tensor cores' TF32 rate counted three times) and
autograd's backward through f32 SDPA with the kernels it ran; the build
line's ``f32_narrow_bodies`` and ``f32_wide_bodies`` give their
registers, no spill allowed; every driven path's f32 dQ and dK/dV
launches must all be on these bodies, and the kernels line counts them
by body). The LM's remaining single-device surface:
``int8_paged_flagship`` serves the flagship's ``quantize_lm_params``
weights through the paged engine (f32 tokens of the fused kernel equal
the gather path's, tie-aware; bf16 timed, every launch on the split
body); ``packed_flagship`` runs ``make_train_step(packed=True)`` at the
flagship's widths on B 8 rows of 1024 that the byte tokenizer packed
from seeded documents (the plain attention path with the segment
mask), and at 2 layers in f32 holds a packed step on one-document rows
against the unpacked step on the flash kernels; ``lm_moe`` drives an
MoE LM at OLMoE-1B-7B's widths (``OLMOE_1B_7B``: vocab 50304, 16
layers, 16 heads of 128, d_model 2048, 64 experts of width 1024, top-8,
RMSNorm, RoPE, untied; 4.77 B parameters, random, and four departures
from OLMoE, printed): ``forward`` at B 2 x 1024 over all 16 layers on
routed dispatch (16 flash launches, its time as issued and on the
device), the contiguous engine over all 16 layers with the int8 KV
cache and int8 weights (f32 tokens against ``generate`` on the same
weights, tie-aware on the cached path's logits; bf16 output tokens/s
and the cache's bytes against a bf16 cache's), f32 logits and
gradients through the f32 kernels against the plain path at 2 layers,
and ``fit_tokens`` (AdamW) at 4; ``packed_example`` runs
``examples/packed_lm_pretraining.py``'s 40 steps on the port. Every
phase prints one JSON line; any failure raises and the script
exits non-zero without the final result line. The last three lines are
the card's name and power limit as ``nvidia-smi`` reports them, the
``kernels`` summary, and ``{"ok": true, "device": ...}``.

No CPU path: without a CUDA device it exits non-zero at once.
"""
import contextlib
import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

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
    blocks; shuffled tables and ragged positions; at head dims 64 (the
    flagship's), 32, 16, 128, 96, 256, 80 and 136, each timed (d 128 at
    Mistral-7B's H 32 over KVH 8, the lm_d128 serving run's shape; d 96
    at Phi-3-mini's H = KVH 32, lm_d96's, and d 80 at Phi-2's; d 256 at
    Gemma-2B's H 8 over KVH 1, lm_d256's, there also in f32), every bf16
    call on the split body (80, 96 on its 128-wide body, 136 on the 256)
    and every f32 call on the general one (``body`` per head dim); then
    one request alone at d 64."""
    b, mb, nb = 8, 64, 513
    rng = np.random.default_rng(0)
    tables = rng.permutation(np.arange(1, nb))[:b * mb].reshape(b, mb)
    # the serving run's positions: prompts of 64-512 tokens + 64 new
    pos = rng.integers(64, 576, b)
    tables_t = torch.as_tensor(tables, dtype=torch.int32, device="cuda")
    pos_t = torch.as_tensor(pos, dtype=torch.int32, device="cuda")
    by_d = {str(d): paged_at_head_dim(flush, d, tables_t, pos_t, pos, nb,
                                      *PAGED_TIMED_HEADS.get(d, (16, 16)))
            for d in PAGED_HEAD_DIMS}
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


# the paged phase's head dims: the split body's widths and, on the next
# width up, 96 (Phi-3-mini), 80 (Phi-2) and 136
PAGED_HEAD_DIMS = (64, 32, 16, 128, 96, 256, 80, 136)
# the (H, KVH) each head dim's paged call is timed at: H = KVH 16 (the
# flagship's), at d 128 Mistral-7B's 32 over 8 (groups of 4), at d 96
# Phi-3-mini's 32 over 32 and at d 80 Phi-2's, at d 256 Gemma-2B's 8
# over 1
PAGED_TIMED_HEADS = {128: (32, 8), 96: (32, 32), 80: (32, 32),
                     256: (8, 1)}


def paged_call_body(fn):
    """``fn()`` (one paged_decode_attention call) and the body it took:
    "split" when the wrapper's ``split_launches`` rose, else "general"."""
    from elephas_tpu_torch.ops.paged_attention import paged_decode_attention
    before = paged_decode_attention.split_launches
    out = fn()
    return out, ("split" if paged_decode_attention.split_launches > before
                 else "general")


def paged_at_head_dim(flush, d, tables_t, pos_t, pos, nb, h_t, kvh_t):
    """The paged cases at head dim ``d`` on the serving shape's tables
    and positions, f32 and bf16 against the plain version; then, at
    ``h_t`` query over ``kvh_t`` kv heads (the main case where both are
    16), two bf16 launches bit-equal, held against the f32 plain version
    and timed beside gather + SDPA and the bound. Each call takes the body
    the wrapper's rule (``paged_body``: dtype, head dim, groups) gives."""
    from elephas_tpu_torch.models.transformer import _alibi_slope_list
    from elephas_tpu_torch.ops.paged_attention import (
        paged_body, paged_decode_attention, paged_decode_attention_plain)

    b, h, bs = tables_t.shape[0], 16, 16
    gen = torch.Generator(device="cuda").manual_seed(1)
    errs, bodies = {}, set()
    for name, (kvh, window, alibi) in PAGED_CASES.items():
        q = torch.randn((b, h, d), generator=gen, device="cuda")
        kp = torch.randn((nb, kvh, bs, d), generator=gen, device="cuda")
        vp = torch.randn((nb, kvh, bs, d), generator=gen, device="cuda")
        slopes = _alibi_slope_list(h) if alibi else None
        ref = paged_decode_attention_plain(q, kp, vp, tables_t, pos_t,
                                           window, slopes)
        out32, body32 = paged_call_body(lambda: paged_decode_attention(
            q, kp, vp, tables_t, pos_t, window, slopes))
        q16, k16, v16 = q.bfloat16(), kp.bfloat16(), vp.bfloat16()
        ref16 = paged_decode_attention_plain(q16.float(), k16.float(),
                                             v16.float(), tables_t, pos_t,
                                             window, slopes)
        out16, body16 = paged_call_body(lambda: paged_decode_attention(
            q16, k16, v16, tables_t, pos_t, window, slopes))
        torch.cuda.synchronize()
        e32, e16 = max_err(out32, ref), max_err(out16, ref16)
        what = f"paged {name} d {d}"
        bf16_body = paged_body(torch.bfloat16, d, h // kvh)
        require(body16 == bf16_body and body32 == "general",
                f"{what}: bf16 on the {bf16_body} body ({body16}), f32 on "
                f"the general one ({body32})")
        bodies.update({("f32", body32), ("bf16", body16)})
        require(bool(torch.isfinite(out16.float()).all()),
                f"{what} bf16 output finite")
        require(e32 <= 1e-4, f"{what} f32 err {e32} <= 1e-4")
        require(e16 <= 2e-2, f"{what} bf16 err {e16} <= 2e-2")
        errs[name] = {"f32": e32, "bf16": e16}
        if name == "main" and (h_t, kvh_t) == (h, h):
            args16 = (q16, k16, v16, tables_t, pos_t)
    if (h_t, kvh_t) != (h, h):
        # the timed shape of its own, held against the plain version
        q16 = torch.randn((b, h_t, d), generator=gen,
                          device="cuda").bfloat16()
        k16, v16 = (torch.randn((nb, kvh_t, bs, d), generator=gen,
                                device="cuda").bfloat16() for _ in range(2))
        args16 = (q16, k16, v16, tables_t, pos_t)
        out16, body16 = paged_call_body(
            lambda: paged_decode_attention(*args16))
        e16 = max_err(out16, paged_decode_attention_plain(
            q16.float(), k16.float(), v16.float(), tables_t, pos_t))
        require(e16 <= 2e-2, f"paged timed H {h_t} KVH {kvh_t} d {d} bf16 "
                             f"err {e16} <= 2e-2")
        bf16_body = paged_body(torch.bfloat16, d, h_t // kvh_t)
        require(body16 == bf16_body,
                f"paged timed H {h_t} KVH {kvh_t} d {d} bf16 on the "
                f"{bf16_body} body: {body16}")
        errs["timed"] = {"bf16": e16}
        if d == 256:
            # Gemma-2B's groups of 8 in f32 too (the f32 engine's calls)
            q32, k32, v32 = (t.float() for t in args16[:3])
            out32, body32 = paged_call_body(lambda: paged_decode_attention(
                q32, k32, v32, tables_t, pos_t))
            e32 = max_err(out32, paged_decode_attention_plain(
                q32, k32, v32, tables_t, pos_t))
            require(e32 <= 1e-4 and body32 == "general",
                    f"paged timed H {h_t} KVH {kvh_t} d {d} f32 err {e32} "
                    f"<= 1e-4, on the general body ({body32})")
            errs["timed"]["f32"] = e32
            del q32, k32, v32, out32
    # no atomics, splits merged in index order: a second bf16 launch on
    # the same inputs gives the same bits
    first, second = (paged_decode_attention(*args16) for _ in range(2))
    require(torch.equal(first.view(torch.int16), second.view(torch.int16)),
            f"two paged_decode launches at d {d} give bit-equal outputs")
    del first, second
    library = gather_sdpa(*args16)
    nbytes, flops, bound_ms, bound_by = paged_bound(pos, h_t, d, bs, kvh_t)
    return {"max_abs_err": max(max(e.values()) for e in errs.values()),
            "max_abs_err_f32": max(e["f32"] for e in errs.values()
                                   if "f32" in e),
            "errors": errs,
            "body": dict(sorted(bodies)),
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
            "shape": {"B": b, "H": h_t, "KVH": kvh_t, "D": d, "block": bs,
                      "max_blocks": tables_t.shape[1], "pool_blocks": nb,
                      "dtype": "bfloat16"}}


def gather_sdpa(q, k_pool, v_pool, tables, pos):
    """The paged call's library yardstick, as a callable: each row's
    blocks gathered into a contiguous cache, then SDPA under the
    position mask (GQA: the narrow cache through ``enable_gqa``; the
    port never calls it)."""
    b, h, d = q.shape
    kvh = k_pool.shape[1]
    length = tables.shape[1] * k_pool.shape[2]
    mask = (torch.arange(length, device=q.device)[None, :]
            <= pos[:, None].long())[:, None, None, :]
    idx = tables.long()
    gqa = {"enable_gqa": True} if kvh != h else {}

    def library():
        ck = k_pool[idx].transpose(1, 2).reshape(b, kvh, length, d)
        cv = v_pool[idx].transpose(1, 2).reshape(b, kvh, length, d)
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], ck, cv, attn_mask=mask, **gqa)

    return library


def check_paged_f32_example(flush):
    """The paged kernel's general body in f32 at http_serving_example's
    decode shape (its LM: H = KVH 4, head dim 16; its engine: 4 slots,
    blocks of 8, 12 table entries a row of a 24-block pool; positions of
    its prompts plus 16 new tokens), held against the plain version
    (1e-4) and timed as the bf16 calls are, beside its f32 bound (the
    bytes at the memory rate, the operations at the CUDA cores' f32 peak)
    and gather + SDPA in f32."""
    from elephas_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_plain)

    b, h, d, bs, mb, nb = 4, 4, 16, 8, 12, 24
    rng = np.random.default_rng(12)
    pos = rng.integers(8, 32, b)
    blocks = rng.permutation(np.arange(1, nb))
    tables = np.zeros((b, mb), np.int64)
    for i, p in enumerate(pos):
        tables[i, :p // bs + 1] = blocks[:p // bs + 1]
        blocks = blocks[p // bs + 1:]
    tables_t = torch.as_tensor(tables, dtype=torch.int32, device="cuda")
    pos_t = torch.as_tensor(pos, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(13)
    q = torch.randn((b, h, d), generator=gen, device="cuda")
    kp, vp = (torch.randn((nb, h, bs, d), generator=gen, device="cuda")
              for _ in range(2))
    args = (q, kp, vp, tables_t, pos_t)
    out, body = paged_call_body(lambda: paged_decode_attention(*args))
    err = max_err(out, paged_decode_attention_plain(*args))
    require(err <= 1e-4 and body == "general",
            f"paged f32 at http_serving_example's shape: err {err} <= "
            f"1e-4, on the general body ({body})")
    nbytes, flops, _, _ = paged_bound(pos, h, d, bs, esize=4)
    ops_ms = flops / PEAK_F32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    library = gather_sdpa(*args)
    result = {"shape": {"B": b, "H": h, "KVH": h, "D": d, "block": bs,
                        "max_blocks": mb, "pool_blocks": nb,
                        "positions": pos.tolist(), "dtype": "float32"},
              "body": body, "max_abs_err": err,
              "ms": time_ms(lambda: paged_decode_attention(*args),
                            flush=flush),
              "device_ms": device_ms(lambda: paged_decode_attention(*args),
                                     flush),
              "plain_ms": time_ms(
                  lambda: paged_decode_attention_plain(*args), flush=flush),
              "library_ms": time_ms(library, flush=flush),
              "library_device_ms": device_ms(library, flush),
              "bound_ms": max(ops_ms, bytes_ms),
              "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
              "bytes": nbytes, "flops": flops}
    emit({"phase": "paged_f32_example", **result})
    return result


def paged_bound(pos, h, d, bs, kvh=None, esize=2):
    """(bytes, flops, bound ms, bound by) of one bf16 paged call: the K/V
    rows of the ``kvh`` heads (default h) at positions <= pos once, q in,
    o out, the live table entries and the positions (``esize`` bytes an
    element: 4 counts an f32 call's bytes; the ms stay bf16's)."""
    kvh = h if kvh is None else kvh
    live_blocks = int(np.sum(pos // bs + 1))
    nbytes = (int(np.sum(pos + 1)) * kvh * d * 2 * esize
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
# three (64 the flagship, 32 examples/transformer_tpumodel.py, 16
# examples/http_serving.py), 128 is Mistral-7B's (the lm_d128 phase) and
# 256 Gemma-2B's (the lm_d256 phase)
HEAD_DIMS = (16, 32, 64, 128, 256)
# head dims that run a wider body, TMA filling the columns past the head
# dim with zeros: 96 is Phi-3-mini's (the lm_d96 phase) and 80 Phi-2's
# (both timed, on the 128-wide body); 8 (the repo's small LMs) on the
# 16-wide body, 24 on 32, 40 (Stable Diffusion 1.x) on 64, 72 (DiT-XL/2)
# and 120 on 128, 136, 192 and 248 on 256 are checked, not timed
FILLED_HEAD_DIMS = (8, 24, 40, 72, 80, 96, 120, 136, 192, 248)
FILLED_TIMED = (96, 80)
# the training path's shape, B 8 x H 16 x S 1024 (causal, bf16): every
# body's head dim and the filled ones timed are timed there
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
# the cases at d 128 only: the lm_d128 phase's training batch (Mistral-7B:
# H 32 over KVH 8, window 4096; B 4 x S 1024), and the edges of the d 128
# bodies' tiles (128 keys in the forward's K/V tiles and dK/dV's CTA, two
# warpgroups of 64 rows): a key length one past a tile, a q tile whose
# second warpgroup holds one row or none, a window edge inside a tile,
# ring hops whose diagonal crosses a tile or leaves the first rows with
# no key, GQA 8/1
D128_CASES = {"lm_d128_fit": (4, 32, 8, 1024, 1024, True, 4096, 0, 0),
              "sk_129": (2, 16, 16, 129, 129, True, None, 0, 0),
              "sq_65": (2, 16, 4, 65, 300, True, None, 235, 0),
              "sq_129": (2, 16, 16, 129, 129, True, None, 0, 0),
              "window_129": (2, 16, 8, 300, 300, True, 129, 0, 0),
              "hop_crossing": (2, 16, 16, 200, 200, True, None, 256, 128),
              "hop_first_rows_dead": (2, 16, 16, 150, 150, True, None,
                                      100, 164),
              "gqa8": (2, 32, 4, 191, 191, True, None, 0, 0)}
# the cases at the filled head dims: ragged lengths under GQA 4:1, a
# window edge inside a 128-key tile, a ring hop whose diagonal crosses a
# tile, a one-row query tile past 128, non-causal ragged Sq and Sk
FILLED_CASES = {"gqa4_ragged": (2, 16, 4, 1000, 1000, True, None, 0, 0),
                "window_129": (2, 16, 8, 300, 300, True, 129, 0, 0),
                "hop_crossing": (2, 16, 16, 200, 200, True, None, 256,
                                 128),
                "sq_129": (2, 16, 16, 129, 129, True, None, 0, 0),
                "noncausal_ragged": (2, 16, 16, 1000, 777, False, None, 0,
                                     0)}
# the case at d 96 only: the lm_d96 phase's training batch (Phi-3-mini:
# H = KVH 32, window 2047; B 2 x S 2048, so the window masks one pair,
# inside the last key tile, of each head)
D96_CASES = {"lm_d96_fit": (2, 32, 32, 2048, 2048, True, 2047, 0, 0)}
# the cases at d 256 only: the lm_d256 phase's shape (Gemma-2B: H 8 over
# KVH 1; B 2 x S 1024, its forward and fit), and the edges of the d 256
# bodies' tiles (64 keys in the forward's K/V tiles, the dK/dV CTA and
# dQ's split body at one wave, 32 in dQ's ping-pong body past one wave):
# a key length one past a tile, a q tile whose second
# warpgroup holds one row, a window edge inside a tile, a ring hop whose
# diagonal crosses a tile, Gemma-2B's groups of 8 on ragged lengths; and
# the dK/dV plan's groups of 2, 4, 8 and 16 over ragged lengths, a
# window and a ring hop, whose plans split some k tiles and not others,
# with chunks that start inside a query head's run of q tiles
D256_CASES = {"lm_d256_fit": (2, 8, 1, 1024, 1024, True, None, 0, 0),
              "sk_65": (2, 16, 16, 65, 65, True, None, 0, 0),
              "sq_65": (2, 16, 4, 65, 300, True, None, 235, 0),
              "window_65": (2, 16, 8, 300, 300, True, 65, 0, 0),
              "hop_crossing": (2, 16, 16, 200, 200, True, None, 256, 128),
              "mqa8_ragged": (2, 8, 1, 191, 191, True, None, 0, 0),
              "gqa2_ragged": (2, 8, 4, 333, 333, True, None, 0, 0),
              "gqa4_window": (2, 16, 4, 517, 517, True, 200, 0, 0),
              "mqa8_hop": (2, 8, 1, 300, 300, True, None, 400, 100),
              "mqa16_ragged": (1, 16, 1, 700, 700, True, None, 0, 0)}
# the d 128 bodies of the three flash kernels: the kernel (a fragment of
# its mangled name), the object it is built into, and the body as
# chip_smoke names it
WIDE_BODIES = {
    "flash_fwd": ("flash_fwd_pingpong_kernel", "flash_fwd.o",
                  "persistent ping-pong: a producer warpgroup and two "
                  "consumer warpgroups (384 threads, setmaxnreg) taking "
                  "turns, 128-key K/V tiles in a 2-stage ring, one CTA "
                  "per SM over pairs of q tiles"),
    "flash_dq": ("flash_dq_pingpong_kernelILi128", "flash_bwd.o",
                 "ping-pong: a producer warpgroup and two consumer "
                 "warpgroups (384 threads, setmaxnreg) of 64 query rows "
                 "taking turns, each issuing a 64-key tile's S and dP "
                 "with the tile before's dQ product in flight; 128 query "
                 "rows a CTA, 64-key K/V tiles in a 5-stage ring"),
    "flash_dkv": ("flash_dkv_wgmma_kernelILi128", "flash_bwd.o",
                  "384 threads (setmaxnreg), 128 key rows a CTA, 64 a "
                  "consumer warpgroup at the whole head dim")}
# the d 256 bodies of the three flash kernels, as WIDE_BODIES names them
WIDE_256_BODIES = {
    "flash_fwd": ("flash_fwd_w256_kernel", "flash_fwd.o",
                  "the d 128 ping-pong body at width 256: a producer "
                  "warpgroup and two consumer warpgroups (384 threads, "
                  "setmaxnreg) of 64 query rows taking turns, S(j) with "
                  "P V(j-1) in flight, 64-key K/V tiles in 2-stage rings, "
                  "a 64-row Q tile and a 16 KB O staging tile a "
                  "warpgroup; one CTA a q tile at one wave, else "
                  "persistent over pairs of q tiles"),
    "flash_dq": ("flash_dq_pingpong_kernelILi256", "flash_bwd.o",
                 "the d 128 ping-pong body at width 256 on 32-key K/V "
                 "tiles (3 in the ring beside 64 KB Q and dO tiles), 128 "
                 "query rows a CTA; where 128-row q tiles fill at most one "
                 "wave of the SMs (lm_d256's fit) the split body "
                 "(one_wave_body) runs instead"),
    "flash_dq_one_wave": ("flash_dq_w256_kernel", "flash_bwd.o",
                          "384 threads (setmaxnreg), 64 query rows a CTA, "
                          "each consumer warpgroup dQ at half the head "
                          "dim, Q and dO as register fragments (RS "
                          "products); warpgroup 0 computes S, warpgroup 1 "
                          "dP (handed over in f32 through shared memory, "
                          "the next tile's dP issued before the dS it "
                          "waits for), both read dS from shared memory; "
                          "64-key K and V tiles in 3-slot rings of their "
                          "own, heaviest first in groups of heads whose K "
                          "and V fit in L2"),
    "flash_dkv": ("flash_dkv_w256_kernel", "flash_bwd.o",
                  "384 threads (setmaxnreg), one CTA a chunk of a 64-row "
                  "k tile's walk over its group's query heads and live q "
                  "tiles (the wrapper's plan: chunks of about equal work "
                  "sized to fill the SMs), each consumer warpgroup dK "
                  "and dV at half the head dim; warpgroup 0 computes "
                  "S^T, warpgroup 1 dP^T, and both read P^T and dS^T "
                  "from shared memory; a split tile's chunks write f32 "
                  "partials that flash_dkv_reduce_kernel sums in chunk "
                  "order")}
# the cases at d 16 and 32: the edges of the narrow forward body's tiles
# (192-row q tiles of three warpgroups of 64 rows, 128-key K/V tiles,
# persistent pairs of q tiles past one wave of the SMs): a second q tile
# of one row (its second and third warpgroups empty), a q tile whose third
# warpgroup holds one row, one whose second holds one row and third none,
# a key length one past a tile, a window edge inside a tile, a ring hop
# whose diagonal crosses a tile, one whose first rows see no key, GQA 8/1
# and 4/1 on ragged lengths (the 4/1 case paired, with an odd middle q
# tile and a 9-row last one). B 8 x S 1024's 64-row last q tile is the
# training shape's (`train`).
NARROW_CASES = {"sq_193": (2, 16, 16, 193, 193, True, None, 0, 0),
                "sq_129": (2, 16, 16, 129, 129, True, None, 0, 0),
                "sq_65": (2, 16, 4, 65, 300, True, None, 235, 0),
                "sk_129": (2, 16, 16, 200, 129, False, None, 0, 0),
                "window_129": (2, 16, 8, 300, 300, True, 129, 0, 0),
                "hop_crossing": (2, 16, 16, 200, 200, True, None, 256,
                                 128),
                "hop_first_rows_dead": (2, 16, 16, 150, 150, True, None,
                                        100, 164),
                "gqa8_ragged": (2, 32, 4, 391, 391, True, None, 0, 0),
                "gqa4_ragged": (4, 16, 4, 777, 777, True, None, 0, 0)}
# the narrow forward body at widths 16 and 32, as WIDE_BODIES names them
NARROW_BODIES = {
    d: (f"flash_fwd_narrow_kernelILi{d}", "flash_fwd.o",
        "a producer warpgroup and three consumer warpgroups of 64 query "
        "rows (512 threads, setmaxnreg), 192-row q tiles, 128-key K/V "
        "tiles in 4-stage rings, each warpgroup walking its own run of "
        "the live tiles, S(j) with P V(j-1) in flight, no turns; one CTA "
        "a q tile at one wave, else persistent over pairs of q tiles")
    for d in ("16", "32")}
# the narrow backward bodies at widths 16 and 32, as WIDE_BODIES names
# them (`dq_16`, ..., `dkv_32`)
NARROW_BWD_BODIES = {
    f"{part}_{d}": (f"flash_{part}_narrow_kernelILi{d}", "flash_bwd.o",
                    body)
    for part, body in (
        ("dq", "a producer warpgroup and three consumer warpgroups of 64 "
               "query rows (512 threads, setmaxnreg 32/160), 192-row q "
               "tiles, 64-key K/V tiles through an 8-stage ring, each "
               "warpgroup walking its own run of the live tiles, S(j) and "
               "dP(j) issued with dQ(j-1) in flight, no turns; one CTA a q "
               "tile at one wave, else persistent over pairs of q tiles"),
        ("dkv", "a producer warpgroup and three consumer warpgroups of 64 "
                "key rows (512 threads, setmaxnreg 32/160), 192-row k "
                "tiles (K and V in two slots), 64-row Q/dO tiles through "
                "an 8-stage ring (lse and delta beside them by cp.async), "
                "each warpgroup walking its own run of the live q tiles, "
                "S^T(j) and dP^T(j) issued with dV/dK(j-1) in flight, no "
                "turns; one CTA a k tile at one wave, else persistent over "
                "pairs of k tiles"))
    for d in ("16", "32")}
# the narrow backward bodies' tile edges beside NARROW_CASES (which the
# backward phase runs too): their 192-row tiles are q tiles for dQ (64-key
# K/V tiles) and k tiles for dK/dV (64-row Q/dO tiles): a third k tile of
# one key row, a k tile whose second warpgroup holds one key row and third
# none, a ring hop whose last key rows (and a whole k tile) see no query,
# and past one wave of k tiles: pairs with a ragged last tile, causal (S
# 1000) and not (S 450)
NARROW_BWD_CASES = {
    "sk_385": (2, 16, 16, 385, 385, True, None, 0, 0),
    "sk_65": (2, 16, 8, 300, 65, False, None, 0, 0),
    "hop_keys_dead": (2, 16, 16, 200, 300, True, None, 0, 150),
    "paired_ragged_1000": (2, 16, 16, 1000, 1000, True, None, 0, 0),
    "paired_noncausal": (2, 32, 32, 450, 450, False, None, 0, 0)}
# the f32 strip bodies of the forward, dQ and dK/dV at widths 16 and 32
# (head dims 8-32; csrc/f32_narrow.cuh), as the build names them: their
# mangled-name fragments and what each is
F32_STRIP = ("a warp a strip of 16 {rows} rows (a CTA a warp, heaviest "
             "strips first) walking only its live {other} in steps of 8, "
             "the operands by 16-byte cp.async into the warp's ring of two "
             "64-row stages in one round trip, 3xTF32 products on the "
             "tensor cores (mma.sync m16n8k8), {elementwise} on the C "
             "fragments")
F32_NARROW_BODIES = {
    **{f"fwd_{d}": (f"flash_fwd_f32_narrow_kernelILi{d}E", F32_STRIP.format(
        rows="query", other="keys",
        elementwise="the online softmax")) for d in (16, 32)},
    **{f"dq_{d}": (f"flash_dq_f32_narrow_kernelILi{d}E", F32_STRIP.format(
        rows="query", other="keys", elementwise="P and dS")) for d in (16, 32)},
    **{f"dkv_{d}": (f"flash_dkv_f32_narrow_kernelILi{d}E", F32_STRIP.format(
        rows="key", other="query rows of each head of the group",
        elementwise="P and dS")) for d in (16, 32)}}
# the f32 tensor-core bodies of dQ and dK/dV at widths 64, 128 and 256
# (head dims 40-256; csrc/flash_bwd_f32.cu), as the build names them
F32_WIDE = ("CTAs of 16-row strips ({strips} {rows}, 4 or 2 at width 256) "
            "sharing a ring of two cp.async stages of 64-row tiles of the "
            "other operand (32 at 256), a warp 64 columns of a strip, the "
            "strip's partial S and dP summed through shared memory, "
            "3xTF32 mma.sync m16n8k8{more}")
F32_WIDE_BODIES = {
    **{f"dq_{w}": (f"flash_dq_f32_wide_kernelILi{w}E", F32_WIDE.format(
        strips="query", rows="rows of one head", more="; the last q tiles "
        "first")) for w in (64, 128, 256)},
    **{f"dkv_{w}": (f"flash_dkv_f32_wide_kernelILi{w}E", F32_WIDE.format(
        strips="key", rows="rows of one kv head", more="; one CTA a chunk "
        "of its dkv_plan (the group's query heads x the live q tiles), the "
        "split k tiles' f32 partials summed in chunk order by "
        "flash_dkv_reduce_kernel")) for w in (64, 128, 256)}}
# the f32 forward's CUDA-core body at widths 64-256
F32_CUDA_CORE_BODY = ("256 threads on the CUDA cores over 64 x 64 tiles, a "
                      "4x4 block of each tile a thread")
# the special-function units' exp2 rate on an H100 SXM5 (Shah et al.,
# 2024, FlashAttention-3: 3.9 TFLOPS of special functions): one exp2 a
# causal (q, k) pair bounds the narrow forward bodies, and the backward
# ones recompute it (exp_bound_ms)
PEAK_EXP2_PER_S = 3.9e12
# the f32 bodies' driven shapes, head dim 16, causal: forward_d16's
# forward (B 4 x H 4 x S 96), and speculative_example's training and
# distillation steps (B 8 x H 4 x S 32: rows of 33 tokens)
F32_TIMED = {"forward_d16": (4, 4, 96), "speculative_example": (8, 4, 32)}
# the f32 bodies at widths 64-256 on the f32 checks that launch them,
# path:
# (head dim, B, H, KVH, S, window), causal: the flagship's train_parity
# (B 2 x S 1024), and lm_d128's, lm_d96's and lm_d256's f32 gradients at
# 2 layers (B 1 x S 512 at their heads and windows; lm_moe's f32 checks
# run the d 128 body at B 1 x S 256)
F32_WIDE_TIMED = {"train_parity": (64, 2, 16, 16, 1024, None),
                  "lm_d128_grad": (128, 1, 32, 8, 512, 4096),
                  "lm_d96_grad": (96, 1, 32, 32, 512, 2047),
                  "lm_d256_grad": (256, 1, 8, 1, 512, None)}
# the card's f32 peak on the CUDA cores and its dense TF32 peak on the
# tensor cores (NVIDIA H100 SXM data sheet): the f32 bodies' operations
# bounds, on the CUDA cores and as 3xTF32 (three TF32 products a term)
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
# the case each head dim is timed at beside the training shape: d 32 at
# its main path's (tpu_model_lm_d32's fit), d 128 at lm_d128's fit, d 96
# at lm_d96's, d 256 at lm_d256's; d 64's main path is the training
# shape; d 16 and 80 run on no training path
PATH_TIMED = {32: "tpumodel_fit", 128: "lm_d128_fit", 96: "lm_d96_fit",
              256: "lm_d256_fit"}
PATH_CASES = {32: D32_CASES, 128: D128_CASES, 96: D96_CASES,
              256: D256_CASES}
# every head dim a kernel phase checks, and those it times
CHECKED_HEAD_DIMS = (*HEAD_DIMS, *FILLED_HEAD_DIMS)
TIMED_HEAD_DIMS = (*HEAD_DIMS, *FILLED_TIMED)


def flash_cases(extra=None):
    """(head dim, name, case) over every body's head dim, the filled
    head dims' cases, the d 32, d 96 and d 128 path cases, then the
    narrow bodies' cases at d 16 and 32; ``extra`` cases join at every
    timed head dim."""
    cases = dict(FLASH_CASES, **(extra or {}))
    filled = dict(FILLED_CASES, **(extra or {}))
    return [*((d, n, c) for d in HEAD_DIMS for n, c in cases.items()),
            *((d, n, c) for d in FILLED_HEAD_DIMS for n, c in
              (filled if d in FILLED_TIMED else FILLED_CASES).items()),
            *((d, n, c) for d, more in PATH_CASES.items()
              for n, c in more.items()),
            *((d, n, c) for d in (16, 32) for n, c in NARROW_CASES.items())]


def bound(flops, nbytes):
    """(bound ms, bound by): the larger of the operations at the bf16
    peak and the bytes at the memory rate."""
    ops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes")


def causal_pairs(s, window=None):
    """Unmasked (q, k) pairs of one causal head of length ``s`` under a
    sliding ``window`` (None: none)."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def causal_bound(b, h, s, d, kvh=None, window=None):
    """(flops, bytes, bound ms, bound by) of one causal bf16 forward:
    4*d flops per unmasked (q, k) pair of each query head; q in and o
    out once, k and v in once at their ``kvh`` heads (GQA; default h),
    the lse out."""
    kvh = h if kvh is None else kvh
    flops = 4 * b * h * d * causal_pairs(s, window)
    nbytes = (2 * b * h + 2 * b * kvh) * s * d * 2 + b * h * s * 4
    return (flops, nbytes, *bound(flops, nbytes))


def wide_body_registers(report, bodies):
    """Each body's registers (``WIDE_BODIES``, d 128, or
    ``WIDE_256_BODIES``), from the build: ptxas's count at launch
    (``-Xptxas -v``) and the ``setmaxnreg`` values of its producer and
    consumer warpgroups in its SASS (``cuobjdump -sass``)."""
    from elephas_tpu_torch.ops import _kernels

    launch, cur = {}, None
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            cur = ln.split("'")[1]
        elif cur and "Used" in ln and "registers" in ln:
            for name, (frag, _, _) in bodies.items():
                if frag in cur:
                    launch[name] = int(ln.split("Used ")[1].split()[0])
    out = {}
    for name, (frag, obj, _) in bodies.items():
        sass = subprocess.run(
            [_kernels.cuda_tool("cuobjdump"), "-sass",
             str(_kernels.BUILD_DIR / obj)], capture_output=True,
            text=True, check=True, timeout=300).stdout
        fn, regs = None, {"launch": launch.get(name)}
        for ln in sass.splitlines():
            if "Function :" in ln:
                fn = ln.split(":", 1)[1].strip()
            elif fn and frag in fn and "USETMAXREG" in ln:
                count = int(re.findall(r"0x[0-9a-f]+",
                                       ln.split(";")[0])[-1], 16)
                regs["producer" if "DEALLOC" in ln else "consumers"] = count
        out[name] = regs
    return out


def f32_body_registers(report, bodies):
    """ptxas's registers and spill line for each f32 body of ``bodies``
    (``F32_NARROW_BODIES`` or ``F32_WIDE_BODIES``), from the build
    report."""
    out, cur = {}, None
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            cur = next((name for name, (frag, _) in bodies.items()
                        if frag in ln), None)
        elif cur and "spill stores" in ln:
            out.setdefault(cur, {})["spill"] = ln.strip()
        elif cur and "Used" in ln and "registers" in ln:
            out.setdefault(cur, {})["registers"] = int(
                ln.split("Used ")[1].split()[0])
            cur = None
    return out


def paged_split_registers(report):
    """Each instantiation of the paged split body (``W<width>_G<group>``:
    widths 16-256, groups 1, 2, 4, 8) and ptxas's register count for it
    at launch (``-Xptxas -v``): up to 128 a thread at groups of up to 4
    (4 CTAs of 128 threads an SM), up to 255 at groups of 8 (one CTA of
    256 threads)."""
    regs, cur = {}, None
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            found = re.search(r"paged_split_kernelILi(\d+)ELi(\d+)E", ln)
            cur = f"W{found[1]}_G{found[2]}" if found else None
        elif cur and "Used" in ln and "registers" in ln:
            regs[cur] = int(ln.split("Used ")[1].split()[0])
            cur = None
    return dict(sorted(regs.items(), key=lambda kv: tuple(
        int(x[1:]) for x in kv[0].split("_"))))


def check_flash(flush):
    """The flash forward kernel against its plain version at head dims
    16, 32, 64, 128 and 256, f32 and bf16: the forward path's shape (B 2,
    H 16, S 1024, causal), B 4, GQA, a window, ragged lengths, ring-hop
    offsets, the training path's B 8, at d 32 the long-context
    configuration's case (GQA 8/2, window 48) and the tpu_model_lm_d32
    phase's shapes, at d 128 the lm_d128 phase's training batch (H
    32 over KVH 8, window 4096), at d 256 the lm_d256 phase's (H 8 over
    KVH 1) and the edges of the 256 bodies' tiles; at the filled head
    dims 8, 24, 40, 72, 80, 96, 120, 136, 192 and 248 over
    ``FILLED_CASES`` (d 96 and 80 also at B 8, d 96 at the lm_d96
    phase's training batch, H 32, S 2048, window 2047). Timed beside
    SDPA: at d 64 at both main-path shapes, at d 32, 96, 128 and 256 at
    their paths' fit shapes, and at d 16-256 and 96 and 80 at B 8; at d
    256 the SDPA kernel's name is recorded (``library_kernel``)."""
    from elephas_tpu_torch.ops.flash_attention import (flash_forward,
                                                       flash_forward_plain)

    gen = torch.Generator(device="cuda").manual_seed(2)
    errs, timed = {f"d{d}": {} for d in CHECKED_HEAD_DIMS}, {}
    narrow = {}
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
            timed[name, d] = (q16, k16, v16, window)
        if name in NARROW_CASES:
            narrow[name, d] = (q16, k16, v16, qo, ko, causal, window)
        del q, k, v, o_ref, o32, o_ref16, o16

    def sdpa(q, k, v):
        # GQA: SDPA reads the narrow k/v itself (enable_gqa); a window
        # at least the length is the causal mask SDPA applies
        gqa = {"enable_gqa": True} if k.shape[1] != q.shape[1] else {}
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, **gqa)

    def port(q, k, v, window):
        return lambda: flash_forward(q, k, v, causal=True, window=window)

    def timing(q, k, v, window, plain=False):
        """The call and SDPA's under both timers: as issued (ms) and
        device time alone (device_ms); the plain version as issued."""
        b, h, s, d = q.shape
        require(window is None or window >= s - 1,
                "a timed window spans the sequence (SDPA's causal mask), "
                "or all of it but the one pair (S - 1, 0) of each head")
        flops, nbytes, bound_ms, bound_by = causal_bound(
            b, h, s, d, kvh=k.shape[1], window=window)
        ms = time_ms(port(q, k, v, window), flush=flush)
        dev_ms = device_ms(port(q, k, v, window), flush)
        out = {"shape": {"B": b, "H": h, "KVH": k.shape[1], "S": s,
                         "window": window},
               "ms": ms, "device_ms": dev_ms,
               "library_ms": time_ms(sdpa(q, k, v), flush=flush),
               "library_device_ms": device_ms(sdpa(q, k, v), flush),
               "bound_ms": bound_ms, "bound_by": bound_by,
               # one exp2 a unmasked pair at the special-function rate:
               # what bounds the narrow bodies (bound() leaves it out)
               "exp_bound_ms": b * h * causal_pairs(s, window)
               / PEAK_EXP2_PER_S * 1e3,
               "flops": flops, "bytes": nbytes,
               "achieved_tflops": flops / (ms * 1e-3) / 1e12,
               "device_tflops": flops / (dev_ms * 1e-3) / 1e12}
        if plain:
            out["plain_ms"] = time_ms(lambda: flash_forward_plain(
                q, k, v, causal=True, window=window), flush=flush)
        if d == 256:
            out["library_kernel"] = device_kernels(sdpa(q, k, v))
        return out

    # no atomics and no data-dependent order: two launches on the same
    # bf16 operands give the same bits (at d 128 the ping-pong turns order
    # the warpgroups' issue, not their arithmetic; at d 16 and 32 the
    # narrow body's tile edges too)
    repro = {**{key: (q, k, v, 0, 0, True, window)
                for key, (q, k, v, window) in timed.items()}, **narrow}
    for (name, d), args in repro.items():
        (o1, l1), (o2, l2) = (flash_forward(*args) for _ in range(2))
        require(torch.equal(o1.view(torch.int16), o2.view(torch.int16))
                and torch.equal(l1, l2),
                f"two flash_forward launches at d {d} ({name}) give "
                f"bit-equal outputs")
        del o1, l1, o2, l2
    del narrow, repro

    q16, k16, v16, _ = timed["main", 64]
    b_m, h_m, s_m = q16.shape[:3]
    main = timing(q16, k16, v16, None, plain=True)
    # each head dim at its main path's shape (d 64: the train run's B 8,
    # 64 of its launches; d 32: the tpu_model_lm_d32 fit's B 16 x H 8 x S
    # 128; d 128: the lm_d128 fit's B 4 x H 32 x KVH 8 x S 1024; d 96: the
    # lm_d96 fit's B 2 x H 32 x S 2048), and at the training shape (B 8)
    # beside it
    by_d = {}
    for d in TIMED_HEAD_DIMS:
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
    results["max_abs_err_by_head_dim"] = {
        k: max(max(e.values()) for e in es.values())
        for k, es in errs.items()}
    emit({"phase": "flash_kernel", "errors": errs, **results,
          "bit_reproducible": True,
          "shape": {"B": b_m, "H": h_m, "S": s_m, "D": 64, "causal": True,
                    "dtype": "bfloat16"},
          "tolerance": {"o_f32": 2e-4, "lse_f32": 1e-4,
                        "o_bf16_vs_f32_plain": 2e-2,
                        "lse_bf16_vs_f32_plain": 1e-3}})
    return results


def check_flash_f32(flush):
    """The f32 bodies at head dim 16 on their driven paths' shapes
    (``F32_TIMED``): the forward at both, dQ and dK/dV at
    speculative_example's (the strip bodies, ``F32_NARROW_BODIES``);
    then the bodies at widths 64-256 on the shapes of the f32 checks that
    launch them (``F32_WIDE_TIMED``, in ``wide_bodies``): dQ and dK/dV on
    the tensor cores (``F32_WIDE_BODIES``), the forward on the CUDA cores
    (``F32_CUDA_CORE_BODY``). Each entry's ``body`` names the body that
    ran, as its per-body launch counter shows. Each against its plain
    version on the operands timed (O within 2e-4, LSE within 1e-4, the
    gradients within 1e-4 of max|ref|), timed as the bf16 bodies are,
    beside two bounds (``bounds``): the bytes at the memory rate against
    the operations at the CUDA cores' f32 peak (``cuda_cores``) and
    against three times the operations at the tensor cores' TF32 peak
    (``tf32x3``); ``bound_ms`` is that of the body's route. And beside
    one f32 PyTorch call: SDPA's forward, and autograd's backward through
    SDPA (the graph kept, the forward outside the timing) for dQ, dK and
    dV together, with the device kernels it ran (``library_kernel``)."""
    from elephas_tpu_torch.ops import flash_attention as fa
    from elephas_tpu_torch.ops.flash_attention import (
        flash_dkv, flash_dkv_plain, flash_dq, flash_dq_plain, flash_forward,
        flash_forward_plain)

    gen = torch.Generator(device="cuda").manual_seed(11)
    d, out = 16, {}

    def bounds(flops, nbytes, tensor_cores):
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        both = {}
        for route, ops_ms in (
                ("cuda_cores", flops / PEAK_F32_FLOPS * 1e3),
                ("tf32x3", 3 * flops / PEAK_TF32_FLOPS * 1e3)):
            both[route] = {"ms": max(ops_ms, bytes_ms),
                           "by": "operations" if ops_ms >= bytes_ms
                           else "bytes"}
        own = both["tf32x3" if tensor_cores else "cuda_cores"]
        return {"bound_ms": own["ms"], "bound_by": own["by"],
                "bounds": both}

    def ran(fn, counter):
        """fn's result, after checking that it launched the body counted
        in flash_backward.<counter> (flash_forward.<counter> for fwd_*)."""
        owner = (fa.flash_forward if counter.startswith("f32")
                 else fa.flash_backward)
        before = getattr(owner, counter)
        result = fn()
        require(getattr(owner, counter) == before + 1,
                f"the call ran the body counted in {counter}")
        return result

    def times(fn, plain):
        return {"ms": time_ms(fn, flush=flush),
                "device_ms": device_ms(fn, flush),
                "plain_ms": time_ms(plain, flush=flush)}

    def lib_times(lib):
        return {"library_ms": time_ms(lib, flush=flush),
                "library_device_ms": device_ms(lib, flush)}

    shapes = {**{p: (d, b, h, h, s, None)
                 for p, (b, h, s) in F32_TIMED.items()},
              **F32_WIDE_TIMED}
    wide = {}
    for path, (dim, b, h, kvh, s, window) in shapes.items():
        q, g = (torch.randn((b, h, s, dim), generator=gen, device="cuda")
                for _ in range(2))
        k, v = (torch.randn((b, kvh, s, dim), generator=gen, device="cuda")
                for _ in range(2))
        narrow = dim <= 32
        o, lse = ran(lambda: flash_forward(q, k, v, causal=True,
                                           window=window),
                     "f32_narrow_launches" if narrow else "f32_launches")
        o_ref, l_ref = flash_forward_plain(q, k, v, causal=True,
                                           window=window)
        err = {"o_f32": max_err(o, o_ref), "lse_f32": max_err(lse, l_ref)}
        require(err["o_f32"] <= 2e-4 and err["lse_f32"] <= 1e-4,
                f"flash f32 forward at {path}'s shape: errors {err}")
        # 4*d flops a unmasked pair (a window at least S - 1 masks none);
        # q, k, v in and o out, the lse out
        pairs = b * h * causal_pairs(s)
        size = b * h * s * dim * 4
        kv_size = b * kvh * s * dim * 4
        rows = b * h * s * 4
        gqa = {"enable_gqa": True} if kvh != h else {}
        width = fa.body_width(dim)
        entry = {"fwd": {
            "body": (F32_NARROW_BODIES[f"fwd_{dim}"][1] if narrow
                     else F32_CUDA_CORE_BODY),
            "shape": {"B": b, "H": h, "KVH": kvh, "S": s, "D": dim,
                      "window": window, "dtype": "float32"},
            "max_abs_err": max(err.values()),
            **bounds(4 * dim * pairs, 2 * size + 2 * kv_size + rows,
                     narrow),
            **times(lambda: flash_forward(q, k, v, causal=True,
                                          window=window),
                    lambda: flash_forward_plain(q, k, v, causal=True,
                                                window=window)),
            **lib_times(lambda: torch.nn.functional.
                        scaled_dot_product_attention(q, k, v, is_causal=True,
                                                     **gqa))}}
        if path in F32_WIDE_TIMED or path == "speculative_example":
            delta = (g * o_ref).sum(-1)
            args = (q, k, v, g, l_ref, delta, 0, 0, True, window)
            ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))
            o_lib = torch.nn.functional.scaled_dot_product_attention(
                ql, kl, vl, is_causal=True, **gqa)

            # one call for dQ, dK and dV together, timed once
            lib_call = (lambda: torch.autograd.grad(
                o_lib, (ql, kl, vl), g, retain_graph=True))
            lib = {**lib_times(lib_call),
                   "library_kernel": device_kernels(lib_call)}

            # dQ: 3 products (S, dP, dQ), dK/dV: 4, 2*d flops a pair each;
            # q, dO, dq or k, v, dk, dv once each, the lse and delta in
            for part, fn, plain, flops, nbytes in (
                    ("dq", flash_dq, flash_dq_plain, 3 * 2 * dim * pairs,
                     3 * size + 2 * kv_size + 2 * rows),
                    ("dkv", flash_dkv, flash_dkv_plain, 4 * 2 * dim * pairs,
                     2 * size + 4 * kv_size + 2 * rows)):
                got = ran(lambda: fn(*args), f"{part}_f32_"
                          f"{'narrow' if narrow else 'wide'}_launches")
                want = plain(*args)
                got = got if part == "dkv" else (got,)
                want = want if part == "dkv" else (want,)
                rel = max(max_err(a, w) / float(w.abs().max())
                          for a, w in zip(got, want))
                require(rel <= 1e-4, f"flash f32 {part} at {path}'s shape: "
                        f"error {rel} of max|ref|")
                entry[part] = {
                    "body": (F32_NARROW_BODIES if narrow else
                             F32_WIDE_BODIES)[f"{part}_{width}"][1],
                    "shape": entry["fwd"]["shape"],
                    "max_abs_err": max(max_err(a, w)
                                       for a, w in zip(got, want)),
                    **bounds(flops, nbytes, True),
                    **times(lambda: fn(*args), lambda: plain(*args)), **lib,
                    "library_note": "autograd's backward through f32 SDPA: "
                                    "dQ, dK and dV together"}
            del ql, kl, vl, o_lib
        (wide if path in F32_WIDE_TIMED else out)[path] = entry
        del q, k, v, g, o, lse, o_ref, l_ref
    out["wide_bodies"] = wide
    emit({"phase": "flash_f32_bodies", "head_dim": d, **out,
          "tolerance": {"o_f32": 2e-4, "lse_f32": 1e-4,
                        "grad_f32_relative_to_max_ref": 1e-4},
          "peak_f32_flops": PEAK_F32_FLOPS,
          "peak_tf32_flops": PEAK_TF32_FLOPS})
    return out


def device_kernels(fn):
    """The names of the device kernels one call of ``fn`` runs (under
    torch.profiler): which of SDPA's backends a yardstick call took."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and "memcpy" not in e.name.lower()
                   and "memset" not in e.name.lower()})


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
    forward phase's cases at head dims 16, 32, 64 and 128, at the filled
    head dims 8, 24, 40, 72, 80, 96 and 120 (and the d 32, d 96 and d
    128 cases), with the same lse/delta: f32, and bf16 against the f32
    plain version on bf16-rounded inputs; at d 16 and 32 also over the
    narrow backward bodies' tile edges (``NARROW_BWD_CASES``), two bf16
    launches bit-equal at every narrow case. Then, at the training shape
    (B 8, H 16, S 1024, causal, bf16) at every timed head dim and at d
    32, 96 and 128 at their paths' fit shapes, each is held against its
    plain version on the operands it is timed on, and two dQ and two
    dK/dV launches there must give the same bits."""
    from elephas_tpu_torch.ops.flash_attention import (
        flash_backward, flash_backward_plain, flash_forward_plain)

    gen = torch.Generator(device="cuda").manual_seed(5)
    # errors relative to max|ref| of each gradient: f32 another summation
    # order; bf16 P and dS enter their products in bf16 (the TPU
    # kernels' casts) over up to 1024 terms
    tol = {"f32": 1e-4, "bf16": 2e-2}
    errs = {f"d{d}": {} for d in CHECKED_HEAD_DIMS}
    narrow = {**NARROW_CASES, **NARROW_BWD_CASES}
    for d, name, case in [*flash_cases(), *(
            (d, n, c) for d in (16, 32) for n, c in NARROW_BWD_CASES.items())]:
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
            if dt == "bf16" and d in (16, 32) and name in narrow:
                # the narrow bodies' tile edges: two launches, same bits
                again = flash_backward(qt, kt, vt, gt, lse, delta, qo, ko,
                                       causal, window)
                require(all(torch.equal(a.view(torch.int16),
                                        b_.view(torch.int16))
                            for a, b_ in zip(out, again)),
                        f"{what}: two launches give bit-equal outputs")
                del again
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
    train = (TIMED[0], TIMED[1], TIMED[1], TIMED[2], None)
    for d in TIMED_HEAD_DIMS:
        t = bwd_timed(gen, d, train, "train", flush, tol, errs[f"d{d}"])
        if d in PATH_TIMED:
            name = PATH_TIMED[d]
            b, h, kvh, s, _, _, window, _, _ = PATH_CASES[d][name]
            path = bwd_timed(gen, d, (b, h, kvh, s, window),
                             f"{name}_timed", flush, tol, errs[f"d{d}"])
            t = {part: {**path[part], "at_training_shape": t[part]}
                 for part in t}
        by_d[str(d)] = t
    grads = {"dq": ("dq",), "dkv": ("dk", "dv")}
    results = {part: {**by_d["64"][part],
                      "max_abs_err": max(t[part]["max_abs_err"]
                                         for t in by_d.values()),
                      "max_abs_err_f32": max(t[part]["max_abs_err_f32"]
                                             for t in by_d.values()),
                      "max_abs_err_by_head_dim": {
                          dk: max(err for e in es.values()
                                  for key, err in e.items()
                                  if key.split("_")[0] in grads[part]
                                  and not key.endswith("_rel"))
                          for dk, es in errs.items()},
                      "by_head_dim": {k: t[part] for k, t in by_d.items()}}
               for part in ("dq", "dkv")}
    emit({"phase": "flash_bwd_kernels", "errors": errs, **results,
          "library": "aten._scaled_dot_product_flash_attention_backward",
          "library_note": "one call computing dQ, dK and dV together: "
                          "compare with dq ms + dkv ms; under GQA on k/v "
                          "expanded to the query heads (dK, dV per query "
                          "head, not summed)",
          "dq_bit_reproducible": True, "dkv_bit_reproducible": True,
          "tolerance_relative_to_max_ref": tol})
    emit({"phase": "flash_dq_bound_ratio",
          "by_head_dim": {d: dq_ratios(t) for d, t in by_d.items()}})
    return results


def dq_ratios(t):
    """dQ's device ms over its bound at a head dim's timed shapes (its
    path's fit shape and the training shape, or the training shape
    alone), beside dQ + dK/dV against the library backward there."""
    def one(dq, dkv):
        return {"shape": dq["shape"], "device_ms": dq["device_ms"],
                "bound_ms": dq["bound_ms"],
                "ratio": dq["device_ms"] / dq["bound_ms"],
                "dq_plus_dkv_device_ms": dq["device_ms"] + dkv["device_ms"],
                "library_device_ms": dq["library_device_ms"]}

    out = {"timed": one(t["dq"], t["dkv"])}
    if "at_training_shape" in t["dq"]:
        out["at_training_shape"] = one(t["dq"]["at_training_shape"],
                                       t["dkv"]["at_training_shape"])
    return out


def bwd_timed(gen, d, case, label, flush, tol, errs):
    """dQ and dK/dV at ``case`` (B, H, KVH, S, window; causal) and head
    dim ``d``, bf16, cold L2: each against its plain version on the very
    operands timed here (added to ``errs`` as ``label``), two launches of
    each bit-equal, and the times of both beside the library backward and
    the bound."""
    from elephas_tpu_torch.ops.flash_attention import (
        flash_dkv, flash_dkv_plain, flash_dq, flash_dq_plain,
        flash_forward_plain)

    b, h, kvh, s, window = case
    q, g = (torch.randn((b, h, s, d), generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    k, v = (torch.randn((b, kvh, s, d), generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    o, lse = flash_forward_plain(q, k, v, causal=True, window=window)
    delta = (g.float() * o.float()).sum(-1)
    args = (q, k, v, g, lse, delta, 0, 0, True, window)
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
                f"two flash_{part} launches at d {d} ({label}) give "
                f"bit-equal outputs")
        del first, second, pairs
    # the library backward takes no GQA: k/v expanded outside the timing;
    # a window at least the length is its causal mask (S - 1 leaves it
    # one pair of each head's)
    require(window is None or window >= s - 1, "a timed window spans S")
    k_lib, v_lib = (t.repeat_interleave(h // kvh, dim=1).contiguous()
                    for t in (k, v))
    ms = {"dq": time_ms(lambda: flash_dq(*args), flush=flush),
          "dkv": time_ms(lambda: flash_dkv(*args), flush=flush)}
    plain_ms = {"dq": time_ms(lambda: flash_dq_plain(*args), flush=flush),
                "dkv": time_ms(lambda: flash_dkv_plain(*args),
                               flush=flush)}
    lib_ms = time_ms(library_flash_backward(q, k_lib, v_lib, g),
                     flush=flush)
    dev_ms = {"dq": device_ms(lambda: flash_dq(*args), flush),
              "dkv": device_ms(lambda: flash_dkv(*args), flush)}
    lib_dev_ms = device_ms(library_flash_backward(q, k_lib, v_lib, g),
                           flush)
    lib_kernel = (device_kernels(library_flash_backward(q, k_lib, v_lib, g))
                  if d == 256 else None)
    del k_lib, v_lib
    split = dkv_split(args, flush) if d == 256 else None
    # unmasked (q, k) pairs of every query head, causal (and windowed)
    pairs = b * h * causal_pairs(s, window)
    esize = 2
    qsize = b * h * s * d * esize         # one of q, dO, dq
    kvsize = b * kvh * s * d * esize      # one of k, v, dk, dv
    rows = 2 * b * h * s * 4              # lse and delta, f32
    # dQ: 3 products (S, dP, dQ), dK/dV: 4 (S, dP, dV, dK), 2*d flops
    # per unmasked pair each
    work = {"dq": (3 * 2 * d * pairs, 3 * qsize + 2 * kvsize + rows),
            "dkv": (4 * 2 * d * pairs, 2 * qsize + 4 * kvsize + rows)}
    grads = {"dq": ("dq",), "dkv": ("dk", "dv")}
    results = {}
    for part, (flops, nbytes) in work.items():
        bound_ms, bound_by = bound(flops, nbytes)
        results[part] = {
            "shape": {"B": b, "H": h, "KVH": kvh, "S": s, "window": window},
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
            # both recompute one exp2 a unmasked pair at the special-
            # function rate: what bounds the narrow bodies (bound() leaves
            # it out)
            "exp_bound_ms": pairs / PEAK_EXP2_PER_S * 1e3,
            "flops": flops, "bytes": nbytes,
            "achieved_tflops": flops / (ms[part] * 1e-3) / 1e12,
            "device_tflops": flops / (dev_ms[part] * 1e-3) / 1e12}
        if lib_kernel is not None:
            results[part]["library_kernel"] = lib_kernel
    if split is not None:
        results["dkv"]["split"] = split
    return results


def kernel_device_ms(fn, flush, names, reps=10):
    """Device ms a call of ``fn`` spends in the kernels whose names hold
    each of ``names``, under torch.profiler over ``reps`` calls, each
    after a cold L2."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    totals = {n: 0.0 for n in names}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for n in names:
                if n in e.name:
                    totals[n] += e.device_time_total
    return {n: t / reps / 1e3 for n, t in totals.items()}


def dkv_split(args, flush):
    """The d 256 dK/dV call's plan (chunks, split k tiles, partial slots)
    and, where it splits k tiles, its device ms by kernel, the chunk kernel's and the reduction's
    apart (profiled), beside the reduction held against its plain version
    on this call's own partials and timed alone (as issued and on the
    device) with its bound: the partials read once, the split tiles' rows
    written once (bytes; its adds are 1 flop a partial float)."""
    from elephas_tpu_torch.ops.flash_attention import (
        flash_dkv, flash_dkv_partials, flash_dkv_reduce,
        flash_dkv_reduce_plain)

    q, k = args[0], args[1]
    dk, dv, partials, plan = flash_dkv_partials(*args)
    info = {"chunks": len(plan.chunks), "split_k_tiles": len(plan.reduce),
            "unsplit_k_tiles": sum(1 for c in plan.chunks if c[4] < 0),
            "partial_slots": plan.slots,
            "max_steps_a_chunk": max(c[3] for c in plan.chunks),
            "sms": torch.cuda.get_device_properties(0).multi_processor_count}
    if partials is None:
        return info
    want = flash_dkv_reduce_plain(partials, plan, dk.clone(), dv.clone())
    got = flash_dkv_reduce(partials, plan, dk, dv)
    torch.cuda.synchronize()
    err = max(max_err(a, b) for a, b in zip(got, want))
    scale = max(float(t.float().abs().max()) for t in want)
    # the same f32 sums in the same order, cast once: bit-equal but for
    # the last bf16 bit where the card's and the CPU's adds differ (none)
    require(err <= 1e-2 * scale, f"dK/dV reduction err {err} <= 1e-2 * "
                                 f"{scale}")
    by_kernel = kernel_device_ms(lambda: flash_dkv(*args), flush,
                                 ("flash_dkv_w256_kernel",
                                  "flash_dkv_reduce_kernel"))
    kvh, sk, d = k.shape[1], k.shape[2], k.shape[3]
    split_rows = sum(min(64, sk - kt * 64) for kt, *_ in plan.reduce)
    nbytes = partials.numel() * 4 + 2 * split_rows * d * 2
    flops = 2 * (plan.slots - len(plan.reduce)) * 64 * d
    bound_ms, bound_by = bound(flops, nbytes)

    def reduce():
        return flash_dkv_reduce(partials, plan, dk, dv)

    return {**info, "partial_mb": partials.numel() * 4 / 2 ** 20,
            "chunk_kernel_device_ms": by_kernel["flash_dkv_w256_kernel"],
            "reduce_device_ms": by_kernel["flash_dkv_reduce_kernel"],
            "reduce": {"max_abs_err": err, "scale": scale,
                       "ms": time_ms(reduce, flush=flush),
                       "device_ms": device_ms(reduce, flush),
                       "plain_ms": time_ms(lambda: flash_dkv_reduce_plain(
                           partials, plan, dk.clone(), dv.clone()),
                           flush=flush),
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "flops": flops, "bytes": nbytes,
                       "library_ms": None}}


# ------------------------------------------------------------ main path
def reset_counts():
    from elephas_tpu_torch.ops.flash_attention import (flash_backward,
                                                       flash_forward)
    from elephas_tpu_torch.ops.paged_attention import paged_decode_attention
    flash_forward.launches = 0
    flash_backward.dq_launches = 0
    flash_backward.dkv_launches = 0
    flash_backward.dkv_reduce_launches = 0
    flash_forward.f32_launches = 0
    flash_forward.f32_narrow_launches = 0
    for part in ("dq", "dkv"):
        for body in ("", "_narrow", "_wide"):
            setattr(flash_backward, f"{part}_f32{body}_launches", 0)
    paged_decode_attention.launches = 0
    paged_decode_attention.split_launches = 0


def read_counts():
    from elephas_tpu_torch.ops.flash_attention import (flash_backward,
                                                       flash_forward)
    from elephas_tpu_torch.ops.paged_attention import paged_decode_attention
    return {"flash_fwd": flash_forward.launches,
            "flash_dq": flash_backward.dq_launches,
            "flash_dkv": flash_backward.dkv_launches,
            "flash_dkv_reduce": flash_backward.dkv_reduce_launches,
            # the f32 launches among them, and those that ran the f32
            # strip bodies (widths 16 and 32) and the tensor-core bodies
            # of widths 64-256
            "flash_fwd_f32": flash_forward.f32_launches,
            "flash_fwd_f32_narrow": flash_forward.f32_narrow_launches,
            **{f"flash_{part}_f32{body}": getattr(
                flash_backward, f"{part}_f32{body}_launches")
               for part in ("dq", "dkv") for body in ("", "_narrow",
                                                      "_wide")},
            "paged_decode": paged_decode_attention.launches,
            "paged_split": paged_decode_attention.split_launches}


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
    require(counts["flash_fwd_f32_narrow"] == counts["flash_fwd"],
            f"every f32 d 16 forward launch took the strip body: {counts}")
    emit({"phase": "forward_d16", "head_dim": cfg.head_dim, "batch": 4,
          "seq": cfg.max_seq_len, "max_abs_err_flash_vs_plain": err,
          "tolerance": 1e-4, "launches": counts})
    return counts


def serve(params, cfg, prompts, kernel="gather", max_new=64, timed=False,
          **engine_kw):
    """The paged engine (8 slots, 512 usable blocks of 16) on
    ``prompts``: (outputs, info); ``timed`` adds tokens/s, TTFT and each
    ``step()``'s host ms."""
    from elephas_tpu_torch.serving_engine import DecodeEngine

    eng = DecodeEngine(params, cfg, max_slots=8, paged=(513, 16),
                       kernel=kernel, device="cuda", **engine_kw)
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
                     "steps": len(steps),
                     "step_ms_p50": float(np.median(steps)) * 1e3,
                     "step_ms_p99": float(np.percentile(steps, 99)) * 1e3,
                     "host_ms_per_step_mean": float(np.mean(steps)) * 1e3})
    return outs, info


def paged_device_per_decode_step(params, cfg, prompts, steps=8):
    """The paged engine of ``serve`` on ``prompts`` (64 new tokens each)
    under torch.profiler for ``steps`` steady ``step()`` calls, after
    the first 8 requests are admitted and decoding: the paged kernels'
    device ms per decode step (split, merge and general kernels; decode
    steps = paged launches / layers), beside every kernel's and copy's
    device ms per step and the heaviest entries by name (``top``), host
    ms per step of 8 untraced steps just before the traced window (the
    profiler slows the host, not the device), and the bodies'
    launches: every one on the body the wrapper's rule (``paged_body``:
    the config's dtype, head dim and groups) gives."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from elephas_tpu_torch.ops.paged_attention import paged_body
    from elephas_tpu_torch.profile_serving import device_breakdown
    from elephas_tpu_torch.serving_engine import DecodeEngine

    eng = DecodeEngine(params, cfg, max_slots=8, paged=(513, 16),
                       kernel="fused", device="cuda")
    for p in prompts:
        eng.submit(p, 64)
    for _ in range(4):                      # admission and first decodes
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / steps * 1e3
    reset_counts()
    t0 = time.perf_counter()
    # device activity only: nothing here reads the host's op events
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    counts = read_counts()
    decode_steps = counts["paged_decode"] / cfg.num_layers
    body = paged_body(cfg.dtype, cfg.head_dim,
                      cfg.num_heads // cfg.kv_heads)
    split = counts["paged_decode"] if body == "split" else 0
    require(decode_steps > 0 and counts["paged_split"] == split,
            f"the profiled window ran the {body} body for d "
            f"{cfg.head_dim}: {counts}")
    breakdown = device_breakdown(prof, steps, host_ms, top=8)
    paged_ms = sum(e.device_time_total for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and "paged_" in e.name) / 1e3
    require(paged_ms > 0, "the profiler saw the paged kernels' device time")
    del eng
    return {"profile_s": time.perf_counter() - t0,
            "paged_device_ms_per_decode_step": paged_ms / decode_steps,
            "paged_device_ms_per_launch":
                paged_ms / counts["paged_decode"],
            "decode_steps": decode_steps, "step_calls": steps,
            "launches": counts, **breakdown}


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
    require(counts["paged_split"] == counts["paged_decode"],
            f"every bf16 paged launch took the split body: {counts}")
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


# ----------------------------------------------------- HTTP serving
class StepTimer:
    """Wraps an engine's ``step`` (the ``ServingServer`` loop calls it
    through the instance) and records each call's host seconds."""

    def __init__(self, engine):
        self.engine, self.inner, self.seconds = engine, engine.step, []
        engine.step = self

    def __call__(self):
        t0 = time.perf_counter()
        out = self.inner()
        self.seconds.append(time.perf_counter() - t0)
        return out

    def restore(self):
        del self.engine.step


def http_open(req, timeout=300):
    """urlopen with a short retry on a refused connect to a freshly
    listening loopback socket."""
    import urllib.error
    import urllib.request

    for attempt in range(40):
        try:
            return urllib.request.urlopen(req, timeout=timeout)
        except urllib.error.URLError as err:
            if (isinstance(err, urllib.error.HTTPError)
                    or not isinstance(err.reason, ConnectionRefusedError)
                    or attempt == 39):
                raise
            time.sleep(0.05)


def http_json(port, path, payload=None):
    import urllib.request

    url = f"http://127.0.0.1:{port}{path}"
    req = url if payload is None else urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with http_open(req) as resp:
        return json.loads(resp.read())


def http_clients(port, payloads, stream):
    """One client thread per payload, all released together through
    ``/v1/generate``. Returns per client (tokens, client TTFT s or None,
    latency s, final status) and the wall seconds from release to the
    last reply. Streamed clients time their first token line."""
    import urllib.request

    out = [None] * len(payloads)
    gate = threading.Barrier(len(payloads) + 1)

    def client(i):
        body = dict(payloads[i], stream=stream)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/generate",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        gate.wait()
        t0 = time.perf_counter()
        with http_open(req) as resp:
            if not stream:
                reply = json.loads(resp.read())
                out[i] = (reply["tokens"], None, time.perf_counter() - t0,
                          reply.get("status"))
                return
            toks, first, status = [], None, None
            for raw in resp:
                line = json.loads(raw)
                if "tokens" in line:
                    if first is None:
                        first = time.perf_counter() - t0
                    toks += line["tokens"]
                else:
                    status = line.get("status")
        out[i] = (toks, first, time.perf_counter() - t0, status)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    gate.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    require(all(o is not None for o in out), "every HTTP client answered")
    return out, wall


def run_http_serving_example():
    """``examples/http_serving.py``'s program on the port: its LM (byte
    tokenizer, 2 layers, 4 heads, d_model 64, head dim 16, f32, weights
    from seed 0), its engine (4 slots, ``steps_per_sync=2``, a pool of 24
    blocks of 8, "SYSTEM: " registered) behind ``ServingServer``, 5
    concurrent text clients of 16 new tokens, then ``/v1/submit`` and
    ``/stats``; once with the example's ``kernel="gather"`` and once
    with ``kernel="fused"`` (the paged kernel's general body at d 16).
    Every client's tokens equal the port's ``generate`` on its prompt
    (tie-aware)."""
    from elephas_tpu_torch.models.transformer import (TransformerConfig,
                                                      generate, init_params)
    from elephas_tpu_torch.serving_engine import DecodeEngine
    from elephas_tpu_torch.serving_http import ServingServer
    from elephas_tpu_torch.utils.text import ByteTokenizer

    t_phase = time.perf_counter()
    tok = ByteTokenizer()
    cfg = TransformerConfig(vocab_size=tok.vocab_size, num_layers=2,
                            num_heads=4, d_model=64, d_ff=128,
                            max_seq_len=96, dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    prompts = ["SYSTEM: hello", "SYSTEM: goodbye", "SYSTEM: what",
               "plain prompt", "SYSTEM: again"]
    ids = [tok.encode(p) for p in prompts]
    ref = [generate(params, [p], 16, cfg)[0].tolist() for p in ids]
    runs = {}
    reset_counts()
    for kernel in ("gather", "fused"):
        engine = DecodeEngine(params, cfg, max_slots=4, steps_per_sync=2,
                              paged=(24, 8), kernel=kernel)
        engine.register_prefix(tok.encode("SYSTEM: "))
        with ServingServer(engine, tokenizer=tok) as srv:
            replies, wall = http_clients(
                srv.port, [{"text": p, "max_new_tokens": 16}
                           for p in prompts], stream=False)
            rid = http_json(srv.port, "/v1/submit",
                            {"text": "one more", "max_new_tokens": 4})["id"]
            for _ in range(2000):
                polled = http_json(srv.port, f"/v1/result?id={rid}")
                if polled["status"] != "pending":
                    break
                time.sleep(0.005)
            stats = http_json(srv.port, "/stats")
        outs = [r[0] for r in replies]
        ties = tie_aware_equal(params, cfg, ids, ref, outs)
        require(polled["status"] == "done" and len(polled["tokens"]) == 4,
                f"{kernel}: /v1/submit answered: {polled}")
        require(stats["requests_finished"] == len(prompts) + 1,
                f"{kernel}: every request finished")
        runs[kernel] = {"outs": outs, "ties": ties, "wall_s": wall,
                        "prefix_hits": stats["prefix_hits"],
                        "prefix_tokens_reused":
                            stats["prefix_tokens_reused"],
                        "tokens_per_step": stats["tokens_per_step"],
                        "kernel_launches": stats["kernel_launches"]}
    torch.cuda.synchronize()
    counts = read_counts()
    ties = tie_aware_equal(params, cfg, ids, runs["gather"]["outs"],
                           runs["fused"]["outs"])
    require(runs["gather"]["kernel_launches"] == 0,
            "the gather engine launched no paged kernel")
    require(runs["fused"]["kernel_launches"] > 0
            and counts["paged_decode"] == runs["fused"]["kernel_launches"],
            f"the fused engine launched the paged kernel: {counts}")
    emit({"phase": "http_serving_example", "clients": len(prompts),
          "max_new_tokens": 16,
          "fused_vs_gather_near_tie_divergences": ties,
          **{k: {key: v for key, v in r.items() if key != "outs"}
             for k, r in runs.items()},
          "launches": counts, "seconds": time.perf_counter() - t_phase})
    return counts


# ------------------------------------------------ speculative decoding
def timed_call(fn):
    """``fn()`` and its wall seconds, the device synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def first_layers(params, n):
    """The embeddings, head and first ``n`` layers of an LM's params."""
    return {k: v for k, v in params.items()
            if not k.startswith("layer_") or int(k.split("_")[1]) < n}


def run_speculative_flagship(params, cfg):
    """Speculative decoding at the flagship width (bf16 over f32
    masters) with a 1-layer draft of the same widths (the shape of
    ``examples/speculative_serving.py``'s draft: same widths, fewer
    layers), initialised as the target truncated to its embeddings and
    first layer: (a) ``make_distill_step`` (Adam 1e-3, temperature 2,
    hard weight 0.1) distils the draft for 9 steps at B 8 x 1024 (the
    flash forward, dQ and dK/dV at d 64, bf16); (b)
    ``speculative_generate`` at B 8 x 128, 64 new tokens, gamma 4,
    greedy, with the target as its own draft, the truncated draft and
    the distilled draft, beside ``generate``; (c) a paged ``DecodeEngine`` with the
    distilled draft (8 slots, gamma 4) and (d) a plain paged engine with
    the fused kernel, ``prefill_chunk=64`` and ``interleave_prefill`` on
    the serving phase's 16 requests (64-512 prompt tokens, 64 new each;
    the paged kernel's split body), each with tokens/s, ``step()`` p50
    and host ms per step. The exactness checks run 2 of the 8 layers in
    f32: greedy speculative tokens equal ``generate``'s (tie-aware), the
    target as its own draft accepts every proposal, and the speculative
    and interleaved paged engines' outputs equal solo ``generate``
    (tie-aware)."""
    from elephas_tpu_torch.models.distill import make_distill_step
    from elephas_tpu_torch.models.optimizers import Adam
    from elephas_tpu_torch.models.speculative import speculative_generate
    from elephas_tpu_torch.models.transformer import generate
    from elephas_tpu_torch.serving_engine import DecodeEngine
    from elephas_tpu_torch.weights import tree_map

    t_phase = time.perf_counter()
    dcfg = dataclasses.replace(cfg, num_layers=1)
    truncated = first_layers(params, 1)
    draft = tree_map(torch.clone, truncated)
    parts = {}

    # (a) distillation on the flash kernels
    rng = np.random.default_rng(11)
    tokens = torch.as_tensor(zipf_tokens(rng, cfg.vocab_size, (8, 1024)),
                             device="cuda")
    tx = Adam(1e-3, epsilon=1e-8).to_transform()
    step = make_distill_step(dcfg, cfg, tx, temperature=2.0,
                             hard_weight=0.1)
    opt = tx.init(draft)
    reset_counts()
    losses = []
    _, opt, loss = step(draft, params, opt, tokens)          # warm-up
    losses.append(float(loss))
    steps = 8
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        _, opt, loss = step(draft, params, opt, tokens)
        losses.append(float(loss))
    torch.cuda.synchronize()
    distill_ms = (time.perf_counter() - t0) / steps * 1e3
    parts["distill"] = counts = read_counts()
    require(all(np.isfinite(losses)), f"finite distill losses {losses}")
    for name, per_step in (("flash_fwd", cfg.num_layers + 1),
                           ("flash_dq", 1), ("flash_dkv", 1)):
        require(counts[name] == per_step * (steps + 1),
                f"the distill step launched {name} {per_step} times a "
                f"step: {counts}")
    distill = {"batch": 8, "seq": 1024, "steps": steps + 1,
               "losses": losses, "ms_per_step": distill_ms,
               "launches": counts,
               "launches_per_step": {k: counts[k] / (steps + 1)
                                     for k in ("flash_fwd", "flash_dq",
                                               "flash_dkv")}}
    del opt, tokens

    # (b) speculative_generate at B 8 beside generate
    prompt = rng.integers(0, cfg.vocab_size, (8, 128))
    new, gamma = 64, 4
    speculative_generate(params, draft, prompt[:, :16], 4, cfg, dcfg,
                         gamma=gamma)                        # warm-up
    generate(params, prompt[:, :16], 4, cfg)
    reset_counts()
    ref, plain_s = timed_call(lambda: generate(params, prompt, new, cfg))
    gen = {"generate": {"output_tokens_per_s": 8 * new / plain_s,
                        "seconds": plain_s}}
    for name, (dp, dc) in (("target_as_draft", (params, cfg)),
                           ("truncated_draft", (truncated, dcfg)),
                           ("distilled_draft", (draft, dcfg))):
        (toks, stats), sec = timed_call(lambda: speculative_generate(
            params, dp, prompt, new, cfg, dc, gamma=gamma,
            return_stats=True))
        require(toks.shape == (8, new) and bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()),
            f"{name}: tokens in the vocabulary")
        gen[name] = {"output_tokens_per_s": 8 * new / sec, "seconds": sec,
                     "rounds": stats["rounds"],
                     "target_rounds_per_generated_token":
                         stats["rounds"] / new,
                     "draft_acceptance": stats["draft_acceptance"],
                     "bf16_rows_equal_to_generate": int(
                         (toks == ref).all(dim=1).sum())}
    parts["speculative_generate"] = read_counts()

    # (c, d) the engines on the serving phase's requests
    srng = np.random.default_rng(4)
    lengths = srng.integers(64, 513, 16)
    prompts = [srng.integers(0, cfg.vocab_size, n).tolist()
               for n in lengths]
    spec_kw = dict(draft_params=draft, draft_config=dcfg, gamma=gamma)
    inter_kw = dict(kernel="fused", prefill_chunk=64,
                    interleave_prefill=True)
    engines = {}
    for name, kw in (("speculative_paged", spec_kw),
                     ("interleaved_paged_fused", inter_kw)):
        serve(params, cfg, prompts[:2], max_new=4, **kw)        # warm-up
        reset_counts()
        outs, info = serve(params, cfg, prompts, max_new=new, timed=True,
                           **kw)
        torch.cuda.synchronize()
        parts[name] = read_counts()
        require(all(len(o) == new for o in outs)
                and all(0 <= t < cfg.vocab_size for o in outs for t in o),
                f"{name}: {new} tokens each in the vocabulary")
        engines[name] = info
    stats = engines["speculative_paged"]["stats"]
    require(stats["speculative_rounds"] > 0
            and stats["draft_acceptance"] is not None,
            f"the speculative engine ran rounds: {stats}")
    inter = engines["interleaved_paged_fused"]["stats"]
    require(inter["prefill_chunks_interleaved"] > 0,
            f"the engine interleaved its prefills: {inter}")
    counts = parts["interleaved_paged_fused"]
    require(counts["paged_decode"] > 0
            and counts["paged_split"] == counts["paged_decode"]
            and counts["paged_decode"] == inter["kernel_launches"],
            f"the interleaved engine ran the paged split body: {counts}")

    # exactness at 2 layers, f32
    c2 = dataclasses.replace(cfg, num_layers=2, dtype=torch.float32)
    d2 = dataclasses.replace(dcfg, dtype=torch.float32)
    p2 = first_layers(params, 2)
    small = rng.integers(0, cfg.vocab_size, (4, 64))
    ref2 = generate(p2, small, 32, c2).tolist()
    spec2, st2 = speculative_generate(p2, draft, small, 32, c2, d2,
                                      gamma=gamma, return_stats=True)
    ties = tie_aware_equal(p2, c2, small.tolist(), ref2, spec2.tolist())
    same, st_same = speculative_generate(p2, p2, small, 32, c2, c2,
                                         gamma=gamma, return_stats=True)
    require(st_same["draft_acceptance"] == 1.0,
            f"f32: the target as its own draft accepts every proposal: "
            f"{st_same}")
    ties += tie_aware_equal(p2, c2, small.tolist(), ref2, same.tolist())
    few = prompts[:6]
    solo = [generate(p2, [p], 16, c2)[0].tolist() for p in few]
    f32_engines = {}
    for name, kw in (("speculative_paged", spec_kw),
                     ("interleaved_paged_fused", inter_kw)):
        kw = {**kw, "draft_config": d2} if "draft_config" in kw else kw
        eng = DecodeEngine(p2, c2, max_slots=2, paged=(257, 16),
                           device="cuda", **kw)
        outs = eng.run(few, 16)
        ties += tie_aware_equal(p2, c2, few, solo, outs)
        f32_engines[name] = {
            "rows_equal_to_generate": sum(a == b for a, b in
                                          zip(outs, solo)),
            **{k: eng.stats[k] for k in ("draft_acceptance",
                                          "prefill_chunks_interleaved",
                                          "kernel_launches")
               if k in eng.stats}}
    require(f32_engines["interleaved_paged_fused"][
        "prefill_chunks_interleaved"] > 0,
        "f32: the check's engine interleaved its prefills")
    emit({"phase": "speculative_flagship", "gamma": gamma,
          "draft_layers": dcfg.num_layers, "distill": distill,
          "speculative_generate": {"batch": 8, "prompt": 128,
                                   "max_new_tokens": new, **gen},
          "engines": {"requests": len(prompts),
                      "prompt_lengths": [int(n) for n in lengths],
                      "max_new_tokens": new, **engines},
          "f32_2_layers": {"speculative_generate_draft_acceptance":
                               st2["draft_acceptance"],
                           "target_as_draft_acceptance":
                               st_same["draft_acceptance"],
                           "engines": f32_engines,
                           "near_tie_divergences": ties},
          "launches": parts, "seconds": time.perf_counter() - t_phase})
    del draft, truncated
    gc.collect()
    return parts


def run_speculative_example():
    """``examples/speculative_serving.py``'s program on the port, at its
    own widths (vocab 256, 4 layers, 4 heads, d_model 64: head dim 16,
    f32; a 1-layer draft): greedy ``speculative_generate`` with the
    target as its draft and with a random draft; the target trained 40
    steps (Adam 1e-2) on a 4-letter corpus and a draft distilled against
    it for 120 steps (Adam 3e-3, temperature 2, hard weight 0.1), both
    on the d 16 f32 flash kernels; the distilled draft's speculative
    decode; continuous batching (6 requests through 2 slots); the
    speculative engine with the distilled draft; prefix caching. Every
    output equals ``generate`` (tie-aware), as the example asserts."""
    from elephas_tpu_torch.models.distill import make_distill_step
    from elephas_tpu_torch.models.optimizers import Adam
    from elephas_tpu_torch.models.speculative import speculative_generate
    from elephas_tpu_torch.models.transformer import (TransformerConfig,
                                                      generate, init_params,
                                                      make_train_step)
    from elephas_tpu_torch.serving_engine import DecodeEngine
    from elephas_tpu_torch.weights import tree_map

    t_phase = time.perf_counter()
    target_cfg = TransformerConfig(vocab_size=256, num_layers=4,
                                   num_heads=4, d_model=64, d_ff=128,
                                   max_seq_len=96, dtype=torch.float32)
    draft_cfg = dataclasses.replace(target_cfg, num_layers=1)
    require(target_cfg.head_dim == 16, f"head dim {target_cfg.head_dim}")
    params = init_params(target_cfg,
                         torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    draft = init_params(draft_cfg,
                        torch.Generator(device="cuda").manual_seed(7),
                        device="cuda")
    rng = np.random.default_rng(0)
    reset_counts()
    out, ties = {}, []

    def check(params, prompt, n, got):
        ref = generate(params, prompt, n, target_cfg).tolist()
        ties.extend(tie_aware_equal(params, target_cfg,
                                    np.asarray(prompt).tolist(), ref,
                                    np.asarray(got).tolist()))

    prompt = rng.integers(0, 256, (4, 8))
    for name, (dp, dc) in (("perfect_draft", (params, target_cfg)),
                           ("random_draft", (draft, draft_cfg))):
        spec, stats = speculative_generate(params, dp, prompt, 24,
                                           target_cfg, dc, gamma=4,
                                           return_stats=True)
        check(params, prompt, 24, spec.tolist())
        out[name] = stats
    require(out["perfect_draft"]["draft_acceptance"] == 1.0,
            f"the perfect draft accepts every proposal: {out}")

    rows = torch.as_tensor(rng.integers(0, 4, (8, 33)) + 97, device="cuda")
    undistilled = tree_map(torch.clone, draft)
    tx = Adam(1e-2, epsilon=1e-8).to_transform()
    opt = tx.init(params)
    train = make_train_step(target_cfg, tx)
    for _ in range(40):
        params, opt, loss = train(params, opt, rows)
    out["target_loss"] = float(loss)
    dtx = Adam(3e-3, epsilon=1e-8).to_transform()
    dopt = dtx.init(draft)
    distill = make_distill_step(draft_cfg, target_cfg, dtx,
                                temperature=2.0, hard_weight=0.1)
    for _ in range(120):
        draft, dopt, dloss = distill(draft, params, dopt, rows)
    out["distill_loss"] = float(dloss)
    prompt2 = rows[:4, :8].cpu().numpy()
    spec, stats = speculative_generate(params, draft, prompt2, 24,
                                       target_cfg, draft_cfg, gamma=4,
                                       return_stats=True)
    check(params, prompt2, 24, spec.tolist())
    out["distilled_draft"] = stats
    _, before = speculative_generate(params, undistilled, prompt2, 24,
                                     target_cfg, draft_cfg, gamma=4,
                                     return_stats=True)
    out["undistilled_draft_on_the_trained_target"] = before
    require(stats["draft_acceptance"] > before["draft_acceptance"],
            f"distillation raised the acceptance on the same prompts: "
            f"{out}")

    prompts = [rng.integers(0, 256, int(n)).tolist()
               for n in rng.integers(4, 12, 6)]
    solo = [generate(params, [p], 12, target_cfg)[0].tolist()
            for p in prompts]
    outs = DecodeEngine(params, target_cfg, max_slots=2).run(prompts, 12)
    ties.extend(tie_aware_equal(params, target_cfg, prompts, solo, outs))
    spec_eng = DecodeEngine(params, target_cfg, max_slots=2,
                            draft_params=draft, draft_config=draft_cfg,
                            gamma=4)
    rids = [spec_eng.submit(p, 12) for p in prompts]
    steps = 0
    while spec_eng.pending:
        spec_eng.step()
        steps += 1
    outs = [spec_eng.result(r) for r in rids]
    ties.extend(tie_aware_equal(params, target_cfg, prompts, solo, outs))
    out["speculative_engine"] = {
        "host_steps": steps,
        "draft_acceptance": spec_eng.stats["draft_acceptance"]}

    system = rng.integers(0, 256, 10).tolist()
    chats = [system + rng.integers(0, 256, int(n)).tolist()
             for n in (3, 5, 3, 7)]
    pc_eng = DecodeEngine(params, target_cfg, max_slots=2)
    pc_eng.register_prefix(system)
    outs = pc_eng.run(chats, 12)
    ties.extend(tie_aware_equal(
        params, target_cfg, chats,
        [generate(params, [p], 12, target_cfg)[0].tolist() for p in chats],
        outs))
    require(pc_eng.stats["prefix_hits"] == len(chats),
            f"every chat reused the system prompt: {pc_eng.stats}")
    torch.cuda.synchronize()
    counts = read_counts()
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        require(counts[name] > 0, f"the example's training and distillation "
                f"launched {name} at d 16: {counts}")
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        require(counts[f"{name}_f32_narrow"] == counts[name],
                f"every f32 d 16 {name} launch took the strip body: "
                f"{counts}")
    emit({"phase": "speculative_example", "head_dim": target_cfg.head_dim,
          **out, "near_tie_divergences": ties, "launches": counts,
          "seconds": time.perf_counter() - t_phase})
    return counts


def flagship_http_traffic(cfg, n=16, system_len=256, new=64, seed=9):
    """Chat traffic with a common system prompt: a shared ``system_len``
    token prefix plus a 16-128-token suffix per client."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, cfg.vocab_size, system_len).tolist()
    prompts = [system + rng.integers(0, cfg.vocab_size, int(k)).tolist()
               for k in rng.integers(16, 129, n)]
    return system, prompts, new


FLAGSHIP_ENGINES = {
    "contiguous": ({}, False),
    "contiguous_prefix_sync4_chunk64": (dict(steps_per_sync=4,
                                             prefill_chunk=64), True),
    "paged_fused_prefix_cache_sync4": (dict(paged=(513, 16), kernel="fused",
                                            steps_per_sync=4), True),
}


def flagship_engine(params, cfg, name, system):
    from elephas_tpu_torch.serving_engine import DecodeEngine

    kwargs, register = FLAGSHIP_ENGINES[name]
    engine = DecodeEngine(params, cfg, **kwargs)
    if "paged" in kwargs:
        engine.enable_prefix_cache()        # on by default: a no-op
    if register:
        engine.register_prefix(system)
    return engine


def run_http_serving_flagship(params, cfg):
    """``ServingServer`` at the flagship width (8 slots, 1024 positions)
    under 16 concurrent streaming clients, each a 256-token shared system
    prompt plus a 16-128-token suffix, 64 new tokens; three engines: the
    default contiguous one, the contiguous one with the prefix
    registered, ``steps_per_sync=4`` and ``prefill_chunk=64``, and the
    paged one (513 blocks of 16, the fused kernel, the block cache, the
    prefix registered, ``steps_per_sync=4``). f32: every engine's greedy
    tokens equal the port's ``generate`` (tie-aware). bf16, after
    ``warmup``: output tokens/s, client TTFT and request latency p50/p99,
    host ms per ``step()``, prefix reuse and paged-kernel launches. Then
    ``generate`` and ``beam_search`` (4 beams) timed at B 8."""
    from elephas_tpu_torch.models.transformer import beam_search, generate
    from elephas_tpu_torch.serving_http import ServingServer

    t_phase = time.perf_counter()
    system, prompts, new = flagship_http_traffic(cfg)
    payloads = [{"prompt": p, "max_new_tokens": new} for p in prompts]
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    lens = [len(p) for p in prompts]
    batch = np.zeros((len(prompts), max(lens)), np.int64)
    for i, p in enumerate(prompts):
        batch[i, :len(p)] = p
    ref = generate(params, batch, new, c32, prompt_lengths=lens).tolist()
    f32 = {}
    for name in FLAGSHIP_ENGINES:
        engine = flagship_engine(params, c32, name, system)
        with ServingServer(engine) as srv:
            replies, _ = http_clients(srv.port, payloads, stream=True)
        outs = [r[0] for r in replies]
        require(all(r[3] == "done" and len(r[0]) == new for r in replies),
                f"f32 {name}: every stream finished with {new} tokens")
        f32[name] = tie_aware_equal(params, cfg, prompts, ref, outs)
        del engine
    torch.cuda.empty_cache()

    def pct(xs, q):
        return float(np.percentile(xs, q)) * 1e3

    bf16 = {}
    reset_counts()
    for name in FLAGSHIP_ENGINES:
        engine = flagship_engine(params, cfg, name, system)
        before = read_counts()["paged_decode"]
        engine.warmup()
        timer = StepTimer(engine)
        with ServingServer(engine) as srv:
            replies, wall = http_clients(srv.port, payloads, stream=True)
            stats = http_json(srv.port, "/stats")
        timer.restore()
        require(all(r[3] == "done" and len(r[0]) == new for r in replies),
                f"bf16 {name}: every stream finished with {new} tokens")
        require(all(0 <= t < cfg.vocab_size for r in replies for t in r[0]),
                f"bf16 {name}: tokens in the vocabulary")
        n_tok = sum(len(r[0]) for r in replies)
        ttft = [r[1] for r in replies]
        lat = [r[2] for r in replies]
        steps = timer.seconds
        bf16[name] = {
            "output_tokens": n_tok, "wall_s": wall,
            "output_tokens_per_s": n_tok / wall,
            "ttft_p50_ms": pct(ttft, 50), "ttft_p99_ms": pct(ttft, 99),
            "latency_p50_ms": pct(lat, 50), "latency_p99_ms": pct(lat, 99),
            "step_calls": len(steps),
            "host_ms_per_step_p50": pct(steps, 50),
            "host_ms_per_step_p99": pct(steps, 99),
            "engine_steps": stats["steps"],
            "tokens_per_step": stats["tokens_per_step"],
            "prefix_hits": stats.get("prefix_hits", 0),
            "prefix_tokens_reused": stats.get("prefix_tokens_reused", 0),
            "paged_launches": read_counts()["paged_decode"] - before}
        del engine
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    counts = read_counts()
    require(counts["paged_decode"] > 0
            and bf16["paged_fused_prefix_cache_sync4"]["paged_launches"]
            == counts["paged_decode"],
            f"the paged engine launched the paged kernel: {counts}")
    require(counts["paged_split"] == counts["paged_decode"],
            f"every bf16 paged launch took the split body: {counts}")
    require(bf16["contiguous_prefix_sync4_chunk64"]["prefix_tokens_reused"]
            >= len(prompts) * len(system)
            and bf16["paged_fused_prefix_cache_sync4"]
            ["prefix_tokens_reused"] >= len(prompts) * len(system),
            "every request reused the system prompt")

    rng = np.random.default_rng(10)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (8, 128)),
                             device="cuda")
    timed = {}
    for name, fn in (("generate", lambda: generate(params, tokens, 64, cfg)),
                     ("beam_search_4", lambda: beam_search(
                         params, tokens, 64, cfg, num_beams=4))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        seqs = out if name == "generate" else out[0]
        require(bool(((seqs >= 0) & (seqs < cfg.vocab_size)).all()),
                f"{name} tokens in the vocabulary")
        timed[name] = {"ms": sec * 1e3, "new_tokens_per_s": 8 * 64 / sec}
    emit({"phase": "http_serving_flagship", "clients": len(prompts),
          "system_tokens": len(system), "suffix_tokens": [
              n - len(system) for n in lens], "max_new_tokens": new,
          "f32_near_tie_divergences": f32, "bf16": bf16,
          "batch_8_prompt_128_new_64": timed, "launches": counts,
          "seconds": time.perf_counter() - t_phase})
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
    3 x (2 x matmul params + attention scores and values). The matmul
    params of a layer: the q and o projections (d_model^2 each), k and v
    at the kv heads' width (GQA), the MLP's two matrices (three under
    SwiGLU); then the head, d_model x vocab whether tied or not. A
    token's query meets seq / 2 keys under the causal mask, or fewer
    under a window narrower than seq. For the flagship (MHA, GELU, tied)
    this is bench.py's count."""
    d, w = cfg.d_model, cfg.attention_window
    mlp = 3 if cfg.mlp_variant == "swiglu" else 2
    p_matmul = (cfg.num_layers * (2 * d * d + 2 * d * cfg.kv_heads
                                  * cfg.head_dim + mlp * d * cfg.d_ff)
                + d * cfg.vocab_size)
    keys = seq / 2 if w is None or w >= seq else causal_pairs(seq, w) / seq
    attn = 2 * 2 * keys * d
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


# ----------------------------------------- an LM at Mistral-7B's widths
# mistralai/Mistral-7B-v0.1 config.json: hidden_size 4096,
# num_attention_heads 32, num_key_value_heads 8 (head dim 128, GQA groups
# of 4), intermediate_size 14336, num_hidden_layers 32, vocab_size 32000,
# rope_theta 10000, sliding_window 4096, tie_word_embeddings false,
# RMSNorm, SiLU-gated MLP; as a config of the repo's LM family (whose MLP
# carries zero-initialised biases Mistral lacks). max_seq_len is cut to
# the phase's longest sequence (Mistral's 32768 positions bound nothing
# here: RoPE has no table).
MISTRAL_7B = dict(vocab_size=32000, num_layers=32, num_heads=32,
                  num_kv_heads=8, d_model=4096, d_ff=14336, max_seq_len=1024,
                  positional="rope", rope_theta=10000.0,
                  attention_window=4096, mlp_variant="swiglu",
                  norm="rmsnorm", tied_embedding=False)
# the cuts of scale, printed with the phase
LM_D128_REDUCED = [
    "training (d) runs 4 of the 32 layers: AdamW over f32 parameters "
    "takes 16 bytes a parameter, 116 GB for 7.24 B, past the card's 80 GB "
    "(1.13 B at 4 layers, about 18 GB)",
    "the f32 gradient and greedy checks (c) run 2 of the 32 layers at B 1 "
    "x 512 (an f32 graph of all 32 is the training case's memory again)",
    "max_seq_len 1024 of 32768: no sequence here is longer, so the 4096 "
    "window masks nothing on the path (the kernel phases check it at "
    "window 256)",
    "weights random from a seed: nothing is downloaded"]


def lm_d128_config(num_layers=MISTRAL_7B["num_layers"]):
    from elephas_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(**dict(MISTRAL_7B, num_layers=num_layers))


def run_lm_d128():
    """The LM at Mistral-7B-v0.1's widths (head dim 128, GQA groups of
    4): (a) ``forward`` at B 2 x T 1024 over all 32 layers, bf16 over f32
    parameters, with one flash forward launch per layer, its f32 logits
    against the plain path's; (b) the paged ``DecodeEngine`` with the
    fused kernel (the split body at D 128, G 4) over all 32 layers,
    serving the flagship serving phase's 16 requests (64-512 prompt
    tokens, 64 new each), every paged launch on the split body, then a
    profiled window of 8 steps of the same traffic: the paged kernels'
    device ms per decode step beside the timed run's ``step()`` p50;
    (c) at 2 layers an f32 ``lm_loss`` gradient
    through the f32 kernels against the plain path (B 1 x 512), and the
    f32 paged engine's greedy tokens against the port's ``generate``
    (tie-aware); (d) ``TransformerModel.fit_tokens`` at 4 layers, bf16
    over f32, AdamW 3e-4, B 4 x 1024, 2 epochs on Zipf rows: the loss
    falls and all three flash kernels run once per layer and step. Each
    part prints its line as it ends. Returns the launch counts of (a),
    (b), (c) and (d)."""
    from elephas_tpu_torch.models.optimizers import AdamW
    from elephas_tpu_torch.models.transformer import (forward, generate,
                                                      init_params)
    from elephas_tpu_torch.models.transformer_model import TransformerModel
    from elephas_tpu_torch.serving_engine import DecodeEngine
    from elephas_tpu_torch.weights import tree_leaves

    t_phase = time.perf_counter()
    counts = {}
    free_memory()
    cfg = lm_d128_config()
    require(cfg.head_dim == 128 and cfg.num_heads // cfg.kv_heads == 4,
            f"head dim {cfg.head_dim}, groups of "
            f"{cfg.num_heads // cfg.kv_heads}")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    emit({"phase": "lm_d128",
          "config": {**MISTRAL_7B, "head_dim": cfg.head_dim,
                     "source": "mistralai/Mistral-7B-v0.1 config.json"},
          "params": sum(t.numel() for t in tree_leaves(params)),
          "init_s": init_s, "reduced": LM_D128_REDUCED})

    # (a) forward, all 32 layers: f32 flash against f32 plain, then the
    # bf16 main-path run
    b, t = 2, 1024
    tokens = torch.as_tensor(
        np.random.default_rng(3).integers(0, cfg.vocab_size, (b, t)),
        device="cuda")
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    flash32 = forward(params, tokens, dataclasses.replace(
        c32, attention_impl="flash"))
    plain32 = forward(params, tokens, dataclasses.replace(
        c32, attention_impl="xla"))
    scale = float(plain32.abs().max())
    err = max_err(flash32, plain32)
    del flash32, plain32
    require(err <= 1e-4 * max(scale, 1.0),
            f"f32 logits flash vs plain err {err} <= 1e-4 * {scale}")
    c16 = dataclasses.replace(cfg, attention_impl="flash")
    reset_counts()
    logits = forward(params, tokens, c16)
    torch.cuda.synchronize()
    counts["forward"] = read_counts()
    require(logits.shape == (b, t, cfg.vocab_size)
            and bool(torch.isfinite(logits).all()), "bf16 logits finite")
    require(counts["forward"]["flash_fwd"] == cfg.num_layers,
            f"forward launched the d 128 flash kernel once per layer: "
            f"{counts['forward']}")
    del logits
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        forward(params, tokens, c16)
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / reps
    emit({
        "phase": "lm_d128_forward", "batch": b, "seq": t,
        "layers": cfg.num_layers,
        "f32_flash_vs_plain_max_abs_err": err, "f32_logit_scale": scale,
        "tolerance": "1e-4 x max(|logit|, 1)", "bf16_ms": sec * 1e3,
        "bf16_tokens_per_s": b * t / sec, "launches": counts["forward"]})

    # (b) the paged engine, fused, all 32 layers, the flagship serving
    # phase's traffic
    rng = np.random.default_rng(4)
    lengths = rng.integers(64, 513, 16)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]
    t0 = time.perf_counter()
    serve(params, cfg, prompts[:2], "fused", max_new=4)      # warm-up
    warmup_s = time.perf_counter() - t0
    reset_counts()
    outs, info = serve(params, cfg, prompts, "fused", timed=True)
    torch.cuda.synchronize()
    counts["serving"] = read_counts()
    require(counts["serving"]["paged_decode"] > 0
            and counts["serving"]["paged_decode"]
            == info["stats"]["kernel_launches"],
            f"the serving run launched the paged kernel at D 128: "
            f"{counts['serving']}, {info['stats']['kernel_launches']}")
    require(counts["serving"]["paged_split"]
            == counts["serving"]["paged_decode"],
            f"every bf16 paged launch at D 128 took the split body: "
            f"{counts['serving']}")
    require(all(len(o) == 64 for o in outs) and all(
        0 <= x < cfg.vocab_size for o in outs for x in o),
        "bf16: 64 tokens each, in the vocabulary")
    gc.collect()
    t0 = time.perf_counter()
    window = paged_device_per_decode_step(params, cfg, prompts)
    window_s = time.perf_counter() - t0
    emit({
        "phase": "lm_d128_serving", "requests": len(prompts),
        "prompt_lengths": [int(n) for n in lengths], "max_new_tokens": 64,
        "layers": cfg.num_layers,
        "bf16": {k: v for k, v in info.items() if k != "stats"},
        "step_ms_p50": info["step_ms_p50"],
        "paged_device_ms_per_decode_step":
            window["paged_device_ms_per_decode_step"],
        "profiled_window": window, "launches": counts["serving"],
        "seconds": {"warm_up": warmup_s, "timed": info["wall_s"],
                    "profiled_window": window_s}})
    # the engines sit in reference cycles: collect them, and the 29 GB of
    # parameters they hold, before the next part allocates
    del params
    free_memory()

    # (c) 2 layers: the f32 gradient through the f32 kernels, and the f32
    # paged engine's greedy tokens against generate
    cfg2 = lm_d128_config(num_layers=2)
    params2 = init_params(cfg2, torch.Generator(device="cuda").manual_seed(1),
                          device="cuda")
    reset_counts()
    run_train_parity(params2, cfg2, shape=(1, 512), phase="lm_d128_grad")
    counts["grad"] = read_counts()
    require(all(counts["grad"][k] > 0
                for k in ("flash_fwd", "flash_dq", "flash_dkv")),
            f"the f32 gradient ran the three f32 kernels: {counts['grad']}")
    c32 = dataclasses.replace(cfg2, dtype=torch.float32)
    greedy_prompts = [rng.integers(0, cfg2.vocab_size, n).tolist()
                      for n in (37, 120, 300)]
    eng = DecodeEngine(params2, c32, max_slots=4, paged=(96, 16),
                       kernel="fused", device="cuda")
    engine_out = eng.run(greedy_prompts, 16)
    ref = [generate(params2, [p], 16, c32)[0].tolist()
           for p in greedy_prompts]
    ties = tie_aware_equal(params2, cfg2, greedy_prompts, ref, engine_out)
    require(eng.stats["kernel_launches"] > 0,
            "the f32 engine launched the paged kernel")
    emit({
        "phase": "lm_d128_f32_greedy", "layers": 2,
        "prompt_lengths": [len(p) for p in greedy_prompts],
        "new_tokens": 16,
        "equal_rows": sum(a == b_ for a, b_ in zip(ref, engine_out)),
        "near_tie_divergences": ties,
        "paged_launches": eng.stats["kernel_launches"]})
    del params2, eng
    free_memory()

    # (d) fit_tokens at 4 layers, bf16 over f32, AdamW 3e-4
    cfg4 = lm_d128_config(num_layers=4)
    batch, seq, rows, epochs = 4, 1024, 16, 2
    tokens = zipf_tokens(np.random.default_rng(7), cfg4.vocab_size,
                         (rows, seq))
    model = TransformerModel(cfg4, device="cuda").compile(
        AdamW(3e-4, epsilon=1e-8, weight_decay=1e-4, decay_1d=True), seed=0)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    hist = model.fit_tokens(tokens, epochs=epochs, batch_size=batch, seed=0)
    torch.cuda.synchronize()
    counts["train"] = read_counts()
    steps = epochs * (rows // batch)
    losses = hist["loss"]
    require(all(np.isfinite(losses)) and losses[1] < losses[0],
            f"the d 128 LM's loss falls: {losses}")
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        require(counts["train"][name] == cfg4.num_layers * steps,
                f"{name} launched {cfg4.num_layers} times per step: "
                f"{counts['train']}")
    step_s = hist["epoch_time"][1] / (rows // batch)
    tok_s = batch * seq / step_s
    fpt = flops_per_token(cfg4, seq)
    emit({
        "phase": "lm_d128_train", "layers": 4, "batch": batch, "seq": seq,
        "steps": steps,
        "params": sum(t.numel() for t in tree_leaves(model.params)),
        "epoch_losses": losses, "epoch_time_s": hist["epoch_time"],
        "ms_per_step": step_s * 1e3, "tokens_per_s": tok_s,
        "flops_per_token": fpt, "mfu": fpt * tok_s / PEAK_BF16_FLOPS,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": counts["train"],
        "launches_per_step": {k: counts["train"][k] / steps
                              for k in ("flash_fwd", "flash_dq",
                                        "flash_dkv")},
        "phase_seconds": time.perf_counter() - t_phase})
    del model
    free_memory()
    return counts


# lm_d96 runs PHI3_MINI (models/transformer.py); the cuts of scale,
# printed with the phase
LM_D96_REDUCED = [
    "training (d) runs 8 of the 32 layers: AdamW over f32 parameters "
    "takes 16 bytes a parameter, 61 GB for 3.82 B beside the activations "
    "of B 2 x 2048 (1.11 B at 8 layers, about 18 GB)",
    "the f32 gradient and greedy checks (c) run 2 of the 32 layers at B 1 "
    "x 512 (an f32 graph of all 32 is the training case's memory again)",
    "max_seq_len 2048 of 4096: no sequence here is longer; at T 2048 the "
    "2047 window masks one pair of each head, inside the last key tile",
    "weights random from a seed: nothing is downloaded"]


def lm_d96_config(num_layers=32):
    from elephas_tpu_torch.models.transformer import (PHI3_MINI,
                                                      TransformerConfig)

    return TransformerConfig(**dict(PHI3_MINI, num_layers=num_layers))


def run_lm_d96():
    """The LM at Phi-3-mini's widths (head dim 96: the flash kernels run
    it on their 128-wide bodies, columns 96-127 of each tile filled with
    zeros by TMA; the paged kernel on its 128-wide split body, chunks
    12-15 of each key row idle): (a) ``forward``
    at B 2 x T 2048 over all 32 layers, bf16 over f32 parameters, one
    flash forward launch per layer, its f32 logits against the plain
    path's; (b) the paged ``DecodeEngine`` with the fused kernel over all
    32 layers serving 16 requests (64-512 prompt tokens, 64 new each),
    every paged launch on the split body, then a profiled window of 8
    steps: the paged kernels' device ms per decode step beside
    ``step()``'s p50; (c) at 2 layers an f32 ``lm_loss`` gradient
    through the f32 kernels against the plain path (B 1 x 512), and the
    f32 paged engine's greedy tokens against the plain f32 forward's
    argmax (tie-aware); (d) ``TransformerModel.fit_tokens`` at 8 layers,
    bf16 over f32, AdamW 3e-4, B 2 x 2048, 2 epochs on Zipf rows: the
    loss falls and all three flash kernels run once per layer and step.
    Each part prints its line as it ends. Returns the launch counts of
    (a), (b), (c) and (d)."""
    from elephas_tpu_torch.models.optimizers import AdamW
    from elephas_tpu_torch.models.transformer import (PHI3_MINI, forward,
                                                      init_params)
    from elephas_tpu_torch.models.transformer_model import TransformerModel
    from elephas_tpu_torch.serving_engine import DecodeEngine
    from elephas_tpu_torch.weights import tree_leaves

    t_phase = time.perf_counter()
    counts = {}
    free_memory()
    cfg = lm_d96_config()
    require(cfg.head_dim == 96 and cfg.num_heads == cfg.kv_heads,
            f"head dim {cfg.head_dim}, {cfg.num_heads} heads over "
            f"{cfg.kv_heads}")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    emit({"phase": "lm_d96",
          "config": {**PHI3_MINI, "head_dim": cfg.head_dim,
                     "source": "microsoft/Phi-3-mini-4k-instruct "
                               "config.json"},
          "params": sum(t.numel() for t in tree_leaves(params)),
          "init_s": init_s, "reduced": LM_D96_REDUCED})

    # (a) forward, all 32 layers: f32 flash against f32 plain, then the
    # bf16 main-path run
    b, t = 2, 2048
    tokens = torch.as_tensor(
        np.random.default_rng(3).integers(0, cfg.vocab_size, (b, t)),
        device="cuda")
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    flash32 = forward(params, tokens, dataclasses.replace(
        c32, attention_impl="flash"))
    plain32 = forward(params, tokens, dataclasses.replace(
        c32, attention_impl="xla"))
    scale = float(plain32.abs().max())
    err = max_err(flash32, plain32)
    del flash32, plain32
    require(err <= 1e-4 * max(scale, 1.0),
            f"f32 logits flash vs plain err {err} <= 1e-4 * {scale}")
    c16 = dataclasses.replace(cfg, attention_impl="flash")
    reset_counts()
    logits = forward(params, tokens, c16)
    torch.cuda.synchronize()
    counts["forward"] = read_counts()
    require(logits.shape == (b, t, cfg.vocab_size)
            and bool(torch.isfinite(logits).all()), "bf16 logits finite")
    require(counts["forward"]["flash_fwd"] == cfg.num_layers,
            f"forward launched the d 96 flash kernel once per layer: "
            f"{counts['forward']}")
    del logits
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        forward(params, tokens, c16)
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / reps
    emit({
        "phase": "lm_d96_forward", "batch": b, "seq": t,
        "layers": cfg.num_layers,
        "f32_flash_vs_plain_max_abs_err": err, "f32_logit_scale": scale,
        "tolerance": "1e-4 x max(|logit|, 1)", "bf16_ms": sec * 1e3,
        "bf16_tokens_per_s": b * t / sec, "launches": counts["forward"],
        "launches_by_body": {"flash_fwd": {
            "bf16_width_128": counts["forward"]["flash_fwd"]}}})

    # (b) the paged engine, fused, all 32 layers, the flagship serving
    # phase's traffic, on the paged kernel's 128-wide split body (12 of a
    # key row's 16 lanes of 16 bytes hold the head dim)
    rng = np.random.default_rng(4)
    lengths = rng.integers(64, 513, 16)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]
    t0 = time.perf_counter()
    serve(params, cfg, prompts[:2], "fused", max_new=4)      # warm-up
    warmup_s = time.perf_counter() - t0
    reset_counts()
    outs, info = serve(params, cfg, prompts, "fused", timed=True)
    torch.cuda.synchronize()
    counts["serving"] = read_counts()
    require(counts["serving"]["paged_decode"] > 0
            and counts["serving"]["paged_decode"]
            == info["stats"]["kernel_launches"],
            f"the serving run launched the paged kernel at D 96: "
            f"{counts['serving']}, {info['stats']['kernel_launches']}")
    require(counts["serving"]["paged_split"]
            == counts["serving"]["paged_decode"],
            f"every bf16 paged launch at D 96 took the split body: "
            f"{counts['serving']}")
    require(all(len(o) == 64 for o in outs) and all(
        0 <= x < cfg.vocab_size for o in outs for x in o),
        "bf16: 64 tokens each, in the vocabulary")
    gc.collect()
    t0 = time.perf_counter()
    window = paged_device_per_decode_step(params, cfg, prompts)
    window_s = time.perf_counter() - t0
    emit({
        "phase": "lm_d96_serving", "requests": len(prompts),
        "prompt_lengths": [int(n) for n in lengths], "max_new_tokens": 64,
        "layers": cfg.num_layers,
        "bf16": {k: v for k, v in info.items() if k != "stats"},
        "step_ms_p50": info["step_ms_p50"],
        "paged_device_ms_per_decode_step":
            window["paged_device_ms_per_decode_step"],
        "profiled_window": window, "launches": counts["serving"],
        "seconds": {"warm_up": warmup_s, "timed": info["wall_s"],
                    "profiled_window": window_s},
        "launches_by_body": {"paged_decode": {
            "general": counts["serving"]["paged_decode"]
            - counts["serving"]["paged_split"],
            "split": counts["serving"]["paged_split"]}}})
    # the engines sit in reference cycles: collect them, and the 15 GB of
    # parameters they hold, before the next part allocates
    del params
    free_memory()

    # (c) 2 layers: the f32 gradient through the f32 kernels, and the f32
    # paged engine's greedy tokens against the plain forward's argmax
    cfg2 = lm_d96_config(num_layers=2)
    params2 = init_params(cfg2, torch.Generator(device="cuda").manual_seed(1),
                          device="cuda")
    reset_counts()
    run_train_parity(params2, cfg2, shape=(1, 512), phase="lm_d96_grad")
    counts["grad"] = read_counts()
    require(all(counts["grad"][k] > 0
                for k in ("flash_fwd", "flash_dq", "flash_dkv")),
            f"the f32 gradient ran the three f32 kernels: {counts['grad']}")
    c32 = dataclasses.replace(cfg2, dtype=torch.float32)
    greedy_prompts = [rng.integers(0, cfg2.vocab_size, n).tolist()
                      for n in (37, 120, 300)]
    eng = DecodeEngine(params2, c32, max_slots=4, paged=(96, 16),
                       kernel="fused", device="cuda")
    engine_out = eng.run(greedy_prompts, 16)
    ref = [greedy_plain(params2, cfg2, p, 16) for p in greedy_prompts]
    ties = tie_aware_equal(params2, cfg2, greedy_prompts, ref, engine_out)
    require(eng.stats["kernel_launches"] > 0,
            "the f32 engine launched the paged kernel")
    emit({
        "phase": "lm_d96_f32_greedy", "layers": 2,
        "prompt_lengths": [len(p) for p in greedy_prompts],
        "new_tokens": 16,
        "equal_rows": sum(a == b_ for a, b_ in zip(ref, engine_out)),
        "near_tie_divergences": ties,
        "paged_launches": eng.stats["kernel_launches"]})
    del params2, eng
    free_memory()

    # (d) fit_tokens at 8 layers, bf16 over f32, AdamW 3e-4
    cfg8 = lm_d96_config(num_layers=8)
    batch, seq, rows, epochs = 2, 2048, 8, 2
    tokens = zipf_tokens(np.random.default_rng(7), cfg8.vocab_size,
                         (rows, seq))
    model = TransformerModel(cfg8, device="cuda").compile(
        AdamW(3e-4, epsilon=1e-8, weight_decay=1e-4, decay_1d=True), seed=0)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    hist = model.fit_tokens(tokens, epochs=epochs, batch_size=batch, seed=0)
    torch.cuda.synchronize()
    counts["train"] = read_counts()
    steps = epochs * (rows // batch)
    losses = hist["loss"]
    require(all(np.isfinite(losses)) and losses[1] < losses[0],
            f"the d 96 LM's loss falls: {losses}")
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        require(counts["train"][name] == cfg8.num_layers * steps,
                f"{name} launched {cfg8.num_layers} times per step: "
                f"{counts['train']}")
    step_s = hist["epoch_time"][1] / (rows // batch)
    tok_s = batch * seq / step_s
    fpt = flops_per_token(cfg8, seq)
    emit({
        "phase": "lm_d96_train", "layers": 8, "batch": batch, "seq": seq,
        "steps": steps,
        "params": sum(t.numel() for t in tree_leaves(model.params)),
        "epoch_losses": losses, "epoch_time_s": hist["epoch_time"],
        "ms_per_step": step_s * 1e3, "tokens_per_s": tok_s,
        "flops_per_token": fpt, "mfu": fpt * tok_s / PEAK_BF16_FLOPS,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": counts["train"],
        "launches_by_body": {
            name: {"bf16_width_128": counts["train"][name],
                   "f32_in_the_gradient_check": counts["grad"][name]}
            for name in ("flash_fwd", "flash_dq", "flash_dkv")},
        "launches_per_step": {k: counts["train"][k] / steps
                              for k in ("flash_fwd", "flash_dq",
                                        "flash_dkv")},
        "phase_seconds": time.perf_counter() - t_phase})
    del model
    free_memory()
    return counts


# -------------------------------------- an LM at Gemma-2B's widths (d 256)
# lm_d256 runs GEMMA_2B (models/transformer.py); the cuts of scale and
# the departures from Gemma-2B, printed with the phase
LM_D256_REDUCED = [
    "training (d) runs 8 of the 18 layers: AdamW over f32 parameters "
    "takes 16 bytes a parameter, 40 GB for 2.51 B before the activations "
    "(1.41 B at 8 layers, 22.6 GB)",
    "the f32 logit, gradient and greedy checks (c) run 2 of the 18 "
    "layers at B 1 x 512",
    "max_seq_len 2048 of 8192: no sequence here is longer",
    "weights random from a seed: nothing is downloaded"]
LM_D256_DEPARTURES = [
    "SwiGLU in place of GeGLU: the same three matrices, SiLU in place of "
    "tanh-GELU, and the repo's two MLP bias vectors (zero at "
    "initialization)",
    "no sqrt(d_model) scaling of the embedding",
    "the repo's RMSNorm: eps 1e-5 where Gemma has 1e-6, and x * g where "
    "Gemma has x * (1 + g), the same function under another "
    "parametrization"]


def lm_d256_config(num_layers=18):
    from elephas_tpu_torch.models.transformer import (GEMMA_2B,
                                                      TransformerConfig)

    return TransformerConfig(**dict(GEMMA_2B, num_layers=num_layers))


def run_lm_d256():
    """The LM at Gemma-2B's widths (head dim 256 on the flash kernels'
    256-wide bodies; 8 query heads over 1 kv head, the paged kernel's
    split body at groups of 8): (a) ``forward`` at B 2 x T 1024 over all
    18 layers,
    bf16 over f32 parameters, one flash forward launch per layer, its
    time as issued and on the device, and its f32 logits against the
    plain path's; (b) the paged ``DecodeEngine`` with the fused kernel
    over all 18 layers, 8 slots, serving 16 requests (64-512 prompt
    tokens, 64 new each), every paged launch on the split body, then a
    profiled window of 8 steps: the paged kernels' device ms per decode
    step beside ``step()``'s p50; (c) at 2 layers f32 logits and an f32
    ``lm_loss`` gradient through the f32 kernels against the plain path
    (B 1 x 512), and the f32 paged engine's greedy tokens against the
    plain f32 forward's argmax (tie-aware); (d)
    ``TransformerModel.fit_tokens`` at 8 layers, bf16 over f32, AdamW
    3e-4, B 2 x 1024, 2 epochs on Zipf rows: the loss falls and all three
    flash kernels run once per layer and step. Each part prints its line
    as it ends. Returns the launch counts of (a), (b), (c) and (d)."""
    from elephas_tpu_torch.models.optimizers import AdamW
    from elephas_tpu_torch.models.transformer import (GEMMA_2B, forward,
                                                      init_params)
    from elephas_tpu_torch.models.transformer_model import TransformerModel
    from elephas_tpu_torch.serving_engine import DecodeEngine
    from elephas_tpu_torch.weights import tree_leaves

    t_phase = time.perf_counter()
    counts, seconds = {}, {}
    free_memory()
    cfg = lm_d256_config()
    require(cfg.head_dim == 256 and cfg.kv_heads == 1,
            f"head dim {cfg.head_dim}, {cfg.num_heads} heads over "
            f"{cfg.kv_heads}")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    torch.cuda.synchronize()
    emit({"phase": "lm_d256",
          "config": {**GEMMA_2B, "head_dim": cfg.head_dim,
                     "source": "google/gemma-2b config.json"},
          "params": sum(t.numel() for t in tree_leaves(params)),
          "init_s": time.perf_counter() - t0, "reduced": LM_D256_REDUCED,
          "departures": LM_D256_DEPARTURES})

    # (a) forward, all 18 layers: f32 flash against f32 plain, then the
    # bf16 main-path run, timed as issued and on the device
    t0 = time.perf_counter()
    b, t = 2, 1024
    tokens = torch.as_tensor(
        np.random.default_rng(3).integers(0, cfg.vocab_size, (b, t)),
        device="cuda")
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    flash32 = forward(params, tokens, dataclasses.replace(
        c32, attention_impl="flash"))
    plain32 = forward(params, tokens, dataclasses.replace(
        c32, attention_impl="xla"))
    scale = float(plain32.abs().max())
    err = max_err(flash32, plain32)
    del flash32, plain32
    require(err <= 1e-4 * max(scale, 1.0),
            f"f32 logits flash vs plain err {err} <= 1e-4 * {scale}")
    c16 = dataclasses.replace(cfg, attention_impl="flash")
    reset_counts()
    logits = forward(params, tokens, c16)
    torch.cuda.synchronize()
    counts["forward"] = read_counts()
    require(logits.shape == (b, t, cfg.vocab_size)
            and bool(torch.isfinite(logits).all()), "bf16 logits finite")
    require(counts["forward"]["flash_fwd"] == cfg.num_layers,
            f"forward launched the d 256 flash kernel once per layer: "
            f"{counts['forward']}")
    del logits
    reps = 3
    t1 = time.perf_counter()
    for _ in range(reps):
        forward(params, tokens, c16)
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t1) / reps
    # about 0.2 s of device spin before each start event: the whole call
    # is queued before the timed window opens
    dev = time_ms(lambda: forward(params, tokens, c16), reps=reps,
                  hold_cycles=400_000_000)
    seconds["forward"] = time.perf_counter() - t0
    emit({
        "phase": "lm_d256_forward", "batch": b, "seq": t,
        "layers": cfg.num_layers,
        "f32_flash_vs_plain_max_abs_err": err, "f32_logit_scale": scale,
        "tolerance": "1e-4 x max(|logit|, 1)", "bf16_ms": sec * 1e3,
        "bf16_device_ms": dev, "bf16_tokens_per_s": b * t / sec,
        "launches": counts["forward"],
        "launches_by_body": {"flash_fwd": {
            "bf16_width_256": counts["forward"]["flash_fwd"]}}})

    # (b) the paged engine, fused, all 18 layers, the flagship serving
    # phase's traffic, on the paged kernel's 256-wide split body (groups
    # of 8)
    t0 = time.perf_counter()
    rng = np.random.default_rng(4)
    lengths = rng.integers(64, 513, 16)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]
    serve(params, cfg, prompts[:2], "fused", max_new=4)      # warm-up
    reset_counts()
    outs, info = serve(params, cfg, prompts, "fused", timed=True)
    torch.cuda.synchronize()
    counts["serving"] = read_counts()
    require(counts["serving"]["paged_decode"] > 0
            and counts["serving"]["paged_decode"]
            == info["stats"]["kernel_launches"],
            f"the serving run launched the paged kernel at D 256: "
            f"{counts['serving']}, {info['stats']['kernel_launches']}")
    require(counts["serving"]["paged_split"]
            == counts["serving"]["paged_decode"],
            f"every bf16 paged launch at D 256 took the split body: "
            f"{counts['serving']}")
    require(all(len(o) == 64 for o in outs) and all(
        0 <= x < cfg.vocab_size for o in outs for x in o),
        "bf16: 64 tokens each, in the vocabulary")
    gc.collect()
    window = paged_device_per_decode_step(params, cfg, prompts)
    seconds["serving"] = time.perf_counter() - t0
    emit({
        "phase": "lm_d256_serving", "requests": len(prompts),
        "prompt_lengths": [int(n) for n in lengths], "max_new_tokens": 64,
        "layers": cfg.num_layers, "slots": 8,
        "bf16": {k: v for k, v in info.items() if k != "stats"},
        "step_ms_p50": info["step_ms_p50"],
        "paged_device_ms_per_decode_step":
            window["paged_device_ms_per_decode_step"],
        "profiled_window": window, "launches": counts["serving"],
        "launches_by_body": {"paged_decode": {
            "general": counts["serving"]["paged_decode"]
            - counts["serving"]["paged_split"],
            "split": counts["serving"]["paged_split"]}}})
    # the engines sit in reference cycles: collect them, and the 10 GB of
    # parameters they hold, before the next part allocates
    del params
    free_memory()

    # (c) 2 layers: f32 logits and the f32 gradient through the f32
    # kernels, and the f32 paged engine's greedy tokens against the plain
    # forward's argmax
    t0 = time.perf_counter()
    cfg2 = lm_d256_config(num_layers=2)
    params2 = init_params(cfg2, torch.Generator(device="cuda").manual_seed(1),
                          device="cuda")
    c32 = dataclasses.replace(cfg2, dtype=torch.float32)
    tokens2 = tokens[:1, :512]
    reset_counts()
    flash32 = forward(params2, tokens2, dataclasses.replace(
        c32, attention_impl="flash"))
    plain32 = forward(params2, tokens2, dataclasses.replace(
        c32, attention_impl="xla"))
    scale2 = float(plain32.abs().max())
    err2 = max_err(flash32, plain32)
    del flash32, plain32
    require(err2 <= 1e-4 * max(scale2, 1.0),
            f"2-layer f32 logits flash vs plain err {err2} <= 1e-4 * "
            f"{scale2}")
    run_train_parity(params2, cfg2, shape=(1, 512), phase="lm_d256_grad")
    counts["grad"] = read_counts()
    require(all(counts["grad"][k] > 0
                for k in ("flash_fwd", "flash_dq", "flash_dkv")),
            f"the f32 checks ran the three f32 kernels: {counts['grad']}")
    greedy_prompts = [rng.integers(0, cfg2.vocab_size, n).tolist()
                      for n in (37, 120, 300)]
    eng = DecodeEngine(params2, c32, max_slots=4, paged=(96, 16),
                       kernel="fused", device="cuda")
    engine_out = eng.run(greedy_prompts, 16)
    ref = [greedy_plain(params2, cfg2, p, 16) for p in greedy_prompts]
    ties = tie_aware_equal(params2, cfg2, greedy_prompts, ref, engine_out)
    require(eng.stats["kernel_launches"] > 0,
            "the f32 engine launched the paged kernel")
    seconds["f32_checks"] = time.perf_counter() - t0
    emit({
        "phase": "lm_d256_f32", "layers": 2,
        "logits_flash_vs_plain_max_abs_err": err2,
        "f32_logit_scale": scale2, "tolerance": "1e-4 x max(|logit|, 1)",
        "prompt_lengths": [len(p) for p in greedy_prompts],
        "new_tokens": 16,
        "equal_rows": sum(a == b_ for a, b_ in zip(ref, engine_out)),
        "near_tie_divergences": ties,
        "paged_launches": eng.stats["kernel_launches"]})
    del params2, eng
    free_memory()

    # (d) fit_tokens at 8 layers, bf16 over f32, AdamW 3e-4
    t0 = time.perf_counter()
    cfg8 = lm_d256_config(num_layers=8)
    batch, seq, rows, epochs = 2, 1024, 8, 2
    tokens = zipf_tokens(np.random.default_rng(7), cfg8.vocab_size,
                         (rows, seq))
    model = TransformerModel(cfg8, device="cuda").compile(
        AdamW(3e-4, epsilon=1e-8, weight_decay=1e-4, decay_1d=True), seed=0)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    hist = model.fit_tokens(tokens, epochs=epochs, batch_size=batch, seed=0)
    torch.cuda.synchronize()
    counts["train"] = read_counts()
    steps = epochs * (rows // batch)
    losses = hist["loss"]
    require(all(np.isfinite(losses)) and losses[1] < losses[0],
            f"the d 256 LM's loss falls: {losses}")
    # the dK/dV plan splits k tiles at this shape: each dK/dV launch is
    # followed by its reduction
    for name in ("flash_fwd", "flash_dq", "flash_dkv", "flash_dkv_reduce"):
        require(counts["train"][name] == cfg8.num_layers * steps,
                f"{name} launched {cfg8.num_layers} times per step: "
                f"{counts['train']}")
    step_s = hist["epoch_time"][1] / (rows // batch)
    tok_s = batch * seq / step_s
    fpt = flops_per_token(cfg8, seq)
    seconds["train"] = time.perf_counter() - t0
    emit({
        "phase": "lm_d256_train", "layers": 8, "batch": batch, "seq": seq,
        "steps": steps,
        "params": sum(t.numel() for t in tree_leaves(model.params)),
        "epoch_losses": losses, "epoch_time_s": hist["epoch_time"],
        "ms_per_step": step_s * 1e3, "tokens_per_s": tok_s,
        "flops_per_token": fpt, "mfu": fpt * tok_s / PEAK_BF16_FLOPS,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": counts["train"],
        "launches_by_body": {
            name: {"bf16_width_256": counts["train"][name],
                   "f32_in_the_checks": counts["grad"][name]}
            for name in ("flash_fwd", "flash_dq", "flash_dkv")},
        "launches_per_step": {k: counts["train"][k] / steps
                              for k in ("flash_fwd", "flash_dq",
                                        "flash_dkv", "flash_dkv_reduce")},
        "seconds": seconds,
        "phase_seconds": time.perf_counter() - t_phase})
    del model
    free_memory()
    return counts


# ------------------------------------- an MoE LM at OLMoE-1B-7B's widths
# lm_moe runs OLMOE_1B_7B (models/transformer.py); the cuts of scale and
# the departures from OLMoE, printed with the phase
LM_MOE_REDUCED = [
    "training (c) runs 4 of the 16 layers: AdamW over f32 parameters "
    "takes 16 bytes a parameter, 76 GB for 4.77 B beside the activations "
    "(1.35 B at 4 layers, about 22 GB)",
    "the f32 checks (b) run 2 of the 16 layers at B 1 x 256",
    "weights random from a seed: nothing is downloaded"]
LM_MOE_DEPARTURES = [
    "experts are GELU (tanh) with biases, two matrices (OLMoE: SwiGLU, "
    "three matrices, no biases)",
    "the top-8 gates are renormalized to sum to 1 (OLMoE: "
    "norm_topk_prob false)",
    "no QK-norm (OLMoE normalizes q and k)",
    "routing by capacity (factor 1.25) with drops in forward and "
    "training (OLMoE is dropless); the cached decode family gates densely"]


def tree_bytes(tree):
    from elephas_tpu_torch.weights import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def tie_aware_equal_cached(params, cfg, prompts, ref, out):
    """``tie_aware_equal`` for the cached decode family's own numerics
    (an int8 KV cache is read back dequantized, MoE layers gate
    densely): the reference's next-token logits at a first divergence
    come from ``prefill_cache`` over the context."""
    from elephas_tpu_torch.models.transformer import prefill_cache

    ties = []
    for p, r, o in zip(prompts, ref, out):
        if r == o:
            continue
        i = next((j for j, (x, y) in enumerate(zip(r, o)) if x != y),
                 min(len(r), len(o)))
        ctx = torch.as_tensor([list(p) + list(r[:i])], device="cuda")
        top2 = prefill_cache(params, ctx, cfg, ctx.shape[1])[0][0].topk(
            2).values
        gap = float(top2[0] - top2[1])
        require(gap < 1e-3, f"divergence at token {i} with top-2 gap {gap}")
        ties.append({"index": i, "gap": gap})
    return ties


def run_lm_moe():
    """The MoE LM at OLMoE-1B-7B's widths (64 experts, top-8, expert
    width 1024, head dim 128; four departures, printed): (a) ``forward``
    at B 2 x T 1024 over all 16 layers, bf16 over f32 parameters, on
    routed dispatch (the ``auto`` rule's choice at 64 experts), with one
    flash forward launch per layer, its time as issued and on the device;
    (d) the contiguous ``DecodeEngine`` over all 16 layers with the int8
    KV cache and ``quantize_lm_params`` weights (MoE gating densely in
    prefill and decode): in f32 8 greedy requests' tokens against the
    port's ``generate`` on the same int8 weights (tie-aware), then in
    bf16 8 requests of 64 new tokens, timed, with the cache's bytes
    beside a bf16 cache's; (b) at 2 layers f32 logits and an f32
    ``lm_loss`` gradient through the f32 kernels against the plain path
    (B 1 x 256); (c) ``TransformerModel.fit_tokens`` at 4 layers, bf16
    over f32, AdamW 3e-4, B 4 x 1024, 2 epochs on Zipf rows: the loss
    falls and the three flash kernels run once per layer and step.
    Returns the launch counts of (a), (b), (c) and (d)."""
    from elephas_tpu_torch.models.optimizers import AdamW
    from elephas_tpu_torch.models.quantization import quantize_lm_params
    from elephas_tpu_torch.models.transformer import (OLMOE_1B_7B,
                                                      TransformerConfig,
                                                      forward, generate,
                                                      init_params,
                                                      select_moe_dispatch)
    from elephas_tpu_torch.models.transformer_model import TransformerModel
    from elephas_tpu_torch.serving_engine import DecodeEngine
    from elephas_tpu_torch.weights import tree_leaves

    t_phase = time.perf_counter()
    counts, seconds = {}, {}
    free_memory()
    cfg = TransformerConfig(**OLMOE_1B_7B)
    require(cfg.head_dim == 128 and select_moe_dispatch(cfg) == "routed",
            f"head dim {cfg.head_dim}, dispatch {select_moe_dispatch(cfg)}")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    torch.cuda.synchronize()
    emit({"phase": "lm_moe",
          "config": {**OLMOE_1B_7B, "head_dim": cfg.head_dim,
                     "source": "allenai/OLMoE-1B-7B-0924 config.json"},
          "params": sum(t.numel() for t in tree_leaves(params)),
          "init_s": time.perf_counter() - t0, "reduced": LM_MOE_REDUCED,
          "departures": LM_MOE_DEPARTURES})

    # (a) forward, all 16 layers, routed, bf16 over f32
    t0 = time.perf_counter()
    b, t = 2, 1024
    tokens = torch.as_tensor(
        np.random.default_rng(3).integers(0, cfg.vocab_size, (b, t)),
        device="cuda")
    c16 = dataclasses.replace(cfg, attention_impl="flash")
    forward(params, tokens, c16)                              # warm-up
    reset_counts()
    logits = forward(params, tokens, c16)
    torch.cuda.synchronize()
    counts["forward"] = read_counts()
    require(logits.shape == (b, t, cfg.vocab_size)
            and bool(torch.isfinite(logits).all()), "bf16 logits finite")
    require(counts["forward"]["flash_fwd"] == cfg.num_layers,
            f"forward launched the d 128 flash kernel once per layer: "
            f"{counts['forward']}")
    del logits
    reps = 3
    t1 = time.perf_counter()
    for _ in range(reps):
        forward(params, tokens, c16)
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t1) / reps
    # about 0.2 s of device spin before each start event: the whole call
    # is queued before the timed window opens
    dev = time_ms(lambda: forward(params, tokens, c16), reps=reps,
                  hold_cycles=400_000_000)
    seconds["forward"] = time.perf_counter() - t0
    emit({"phase": "lm_moe_forward", "batch": b, "seq": t,
          "layers": cfg.num_layers, "dispatch": "routed",
          "capacity_per_expert": int(np.ceil(
              cfg.moe_capacity_factor * cfg.expert_top_k * b * t
              / cfg.num_experts)),
          "bf16_ms": sec * 1e3, "bf16_device_ms": dev,
          "bf16_tokens_per_s": b * t / sec, "launches": counts["forward"]})

    # (d) the contiguous engine, int8 KV cache and int8 weights, all 16
    # layers
    t0 = time.perf_counter()
    qparams = quantize_lm_params(params)
    del params
    free_memory()
    cq = dataclasses.replace(cfg, kv_cache_quant=True)
    cq32 = dataclasses.replace(cq, dtype=torch.float32)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in rng.integers(64, 257, 8)]
    eng = DecodeEngine(qparams, cq32, max_slots=8, max_len=512,
                       device="cuda")
    out32 = eng.run(prompts, 16)
    ref = [generate(qparams, [p], 16, cq32)[0].tolist() for p in prompts]
    ties = tie_aware_equal_cached(qparams, cq32, prompts, ref, out32)
    del eng
    free_memory()
    DecodeEngine(qparams, cq, max_slots=8, max_len=512,
                 device="cuda").run(prompts[:2], 4)           # warm-up
    reset_counts()
    eng = DecodeEngine(qparams, cq, max_slots=8, max_len=512, device="cuda")
    t1 = time.perf_counter()
    rids = [eng.submit(p, 64) for p in prompts]
    steps = []
    while eng.pending:
        t2 = time.perf_counter()
        eng.step()
        steps.append(time.perf_counter() - t2)
    wall = time.perf_counter() - t1
    outs = [eng.result(r) for r in rids]
    torch.cuda.synchronize()
    counts["serving"] = read_counts()
    require(all(len(o) == 64 for o in outs) and all(
        0 <= x < cfg.vocab_size for o in outs for x in o),
        "bf16: 64 tokens each, in the vocabulary")
    kv_bytes = tree_bytes(eng.cache)
    fp_bytes = (2 * cfg.num_layers * 8 * cfg.kv_heads * 512 * cfg.head_dim
                * torch.finfo(cfg.dtype).bits // 8)
    require(kv_bytes * 256 == fp_bytes * 132,
            f"int8 cache bytes {kv_bytes} vs bf16 {fp_bytes}")
    n_tok = sum(len(o) for o in outs)
    seconds["serving"] = time.perf_counter() - t0
    emit({"phase": "lm_moe_serving", "layers": cfg.num_layers,
          "kv_cache_quant": True, "weights": "int8 (quantize_lm_params)",
          "moe_gating": "dense", "requests": len(prompts),
          "prompt_lengths": [len(p) for p in prompts],
          "f32_new_tokens": 16,
          "f32_equal_rows": sum(a == b_ for a, b_ in zip(ref, out32)),
          "f32_near_tie_divergences": ties, "bf16_new_tokens": 64,
          "bf16_output_tokens_per_s": n_tok / wall, "bf16_wall_s": wall,
          "step_ms_p50": float(np.median(steps)) * 1e3,
          "steps": len(steps), "kv_cache_bytes": kv_bytes,
          "bf16_kv_cache_bytes": fp_bytes,
          "kv_cache_ratio": kv_bytes / fp_bytes,
          "weight_bytes": tree_bytes(qparams),
          "launches": counts["serving"]})
    del eng, qparams
    free_memory()

    # (b) 2 layers in f32: logits and the gradient through the f32
    # kernels against the plain path
    t0 = time.perf_counter()
    cfg2 = TransformerConfig(**dict(OLMOE_1B_7B, num_layers=2))
    params2 = init_params(cfg2, torch.Generator(device="cuda").manual_seed(1),
                          device="cuda")
    tokens2 = torch.as_tensor(
        np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 256)),
        device="cuda")
    c32 = dataclasses.replace(cfg2, dtype=torch.float32)
    reset_counts()
    flash32 = forward(params2, tokens2, dataclasses.replace(
        c32, attention_impl="flash"))
    plain32 = forward(params2, tokens2, dataclasses.replace(
        c32, attention_impl="xla"))
    scale = float(plain32.abs().max())
    err = max_err(flash32, plain32)
    require(err <= 1e-4 * max(scale, 1.0),
            f"f32 logits flash vs plain err {err} <= 1e-4 * {scale}")
    run_train_parity(params2, cfg2, shape=(1, 256), phase="lm_moe_grad")
    counts["grad"] = read_counts()
    require(all(counts["grad"][k] > 0
                for k in ("flash_fwd", "flash_dq", "flash_dkv")),
            f"the f32 checks ran the three f32 kernels: {counts['grad']}")
    emit({"phase": "lm_moe_f32_forward", "layers": 2, "batch": 1,
          "seq": 256, "f32_flash_vs_plain_max_abs_err": err,
          "f32_logit_scale": scale, "tolerance": "1e-4 x max(|logit|, 1)",
          "launches": counts["grad"]})
    del params2, flash32, plain32
    free_memory()
    seconds["f32_checks"] = time.perf_counter() - t0

    # (c) fit_tokens at 4 layers, bf16 over f32, AdamW 3e-4
    t0 = time.perf_counter()
    cfg4 = TransformerConfig(**dict(OLMOE_1B_7B, num_layers=4))
    batch, seq, rows, epochs = 4, 1024, 16, 2
    tokens = zipf_tokens(np.random.default_rng(7), cfg4.vocab_size,
                         (rows, seq))
    model = TransformerModel(cfg4, device="cuda").compile(
        AdamW(3e-4, epsilon=1e-8, weight_decay=1e-4, decay_1d=True), seed=0)
    require(model.config.moe_dispatch == "routed",
            f"compile pinned routed dispatch: {model.config.moe_dispatch}")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    hist = model.fit_tokens(tokens, epochs=epochs, batch_size=batch, seed=0)
    torch.cuda.synchronize()
    counts["train"] = read_counts()
    steps = epochs * (rows // batch)
    losses = hist["loss"]
    require(all(np.isfinite(losses)) and losses[1] < losses[0],
            f"the MoE LM's loss falls: {losses}")
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        require(counts["train"][name] == cfg4.num_layers * steps,
                f"{name} launched {cfg4.num_layers} times per step: "
                f"{counts['train']}")
    step_s = hist["epoch_time"][1] / (rows // batch)
    seconds["train"] = time.perf_counter() - t0
    emit({
        "phase": "lm_moe_train", "layers": 4, "batch": batch, "seq": seq,
        "steps": steps, "dispatch": model.config.moe_dispatch,
        "params": sum(t.numel() for t in tree_leaves(model.params)),
        "epoch_losses": losses, "epoch_time_s": hist["epoch_time"],
        "ms_per_step": step_s * 1e3, "tokens_per_s": batch * seq / step_s,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": counts["train"],
        "launches_per_step": {k: counts["train"][k] / steps
                              for k in ("flash_fwd", "flash_dq",
                                        "flash_dkv")},
        "part_seconds": seconds,
        "phase_seconds": time.perf_counter() - t_phase})
    del model
    free_memory()
    return counts


def run_int8_paged_flagship(params, cfg):
    """The flagship with ``quantize_lm_params`` weights (int8 attention
    and MLP matrices, the tied embedding fp) in the paged engine: in f32
    8 requests of 32 new tokens through the fused kernel and the gather
    path, tokens equal (tie-aware); in bf16 the serving phase's 16
    requests (64-512 prompt tokens, 64 new each) through the fused
    kernel, timed, every launch on the split body. Returns the bf16
    run's launch counts."""
    from elephas_tpu_torch.models.quantization import QTensor, \
        quantize_lm_params

    t0 = time.perf_counter()
    qparams = quantize_lm_params(params)
    require(isinstance(qparams["layer_0"]["mlp"]["w1"], QTensor),
            "the flagship's MLP weights are int8")
    rng = np.random.default_rng(4)
    lengths = rng.integers(64, 513, 16)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    gather, _ = serve(qparams, c32, prompts[:8], "gather", max_new=32)
    fused, info32 = serve(qparams, c32, prompts[:8], "fused", max_new=32)
    ties = tie_aware_equal(qparams, cfg, prompts[:8], gather, fused)
    require(info32["stats"]["kernel_launches"] > 0,
            "the f32 fused engine launched the paged kernel")
    serve(qparams, cfg, prompts[:2], "fused", max_new=4)     # warm-up
    reset_counts()
    outs, info = serve(qparams, cfg, prompts, "fused", timed=True)
    torch.cuda.synchronize()
    counts = read_counts()
    require(counts["paged_decode"] > 0
            and counts["paged_decode"] == info["stats"]["kernel_launches"],
            f"the int8 engine launched the paged kernel: {counts}")
    require(counts["paged_split"] == counts["paged_decode"],
            f"every bf16 paged launch took the split body: {counts}")
    require(all(len(o) == 64 for o in outs) and all(
        0 <= x < cfg.vocab_size for o in outs for x in o),
        "bf16: 64 tokens each, in the vocabulary")
    emit({"phase": "int8_paged_flagship", "requests": len(prompts),
          "weight_bytes": tree_bytes(qparams),
          "f32_weight_bytes": tree_bytes(params),
          "f32_requests": 8, "f32_new_tokens": 32,
          "f32_equal_rows": sum(a == b for a, b in zip(gather, fused)),
          "f32_near_tie_divergences": ties,
          "bf16": {k: v for k, v in info.items() if k != "stats"},
          "launches": counts, "seconds": time.perf_counter() - t0})
    del qparams
    free_memory()
    return counts


PACKED_DOCS = ["the quick brown fox jumps over the lazy dog. ",
               "pack my box with five dozen liquor jugs! ",
               "sphinx of black quartz, judge my vow. "]


def run_packed_example():
    """``examples/packed_lm_pretraining.py``'s program on the port:
    three sentences repeated 40 times packed into rows of 64 by the byte
    tokenizer, the example's LM (2 layers, 4 heads over 2, d_model 64,
    RoPE, SwiGLU, RMSNorm, chunked-vocab loss, residual dropout 0.1,
    f32), AdamW 3e-3 (optax.adamw's defaults), 40 steps of
    ``make_train_step(packed=True)`` with a fresh dropout key each: the
    loss falls, as the example prints. Packed batches take the plain
    attention path, so no kernel runs."""
    from elephas_tpu_torch.models.optimizers import AdamW
    from elephas_tpu_torch.models.transformer import (TransformerConfig,
                                                      init_params,
                                                      make_train_step)
    from elephas_tpu_torch.utils.text import ByteTokenizer

    t0 = time.perf_counter()
    tok = ByteTokenizer()
    rows, segs = tok.pack_documents(PACKED_DOCS * 40, seq_len=64)
    config = TransformerConfig(
        vocab_size=tok.vocab_size, num_layers=2, num_heads=4,
        num_kv_heads=2, d_model=64, d_ff=128, max_seq_len=64,
        positional="rope", mlp_variant="swiglu", norm="rmsnorm",
        loss_vocab_chunk=128, dropout_rate=0.1, dtype=torch.float32)
    params = init_params(config,
                         torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    tx = AdamW(3e-3, weight_decay=1e-4, epsilon=1e-8,
               decay_1d=True).to_transform()
    opt = tx.init(params)
    step = make_train_step(config, tx, packed=True)
    tokens = torch.as_tensor(rows, device="cuda")
    segments = torch.as_tensor(segs, device="cuda")
    reset_counts()
    printed = []
    for i in range(40):
        key = torch.Generator(device="cuda").manual_seed(i)
        params, opt, loss = step(params, opt, tokens, key, segments)
        if (i + 1) % 10 == 0:
            printed.append(float(loss))
    counts = read_counts()
    require(all(np.isfinite(printed)) and printed[-1] < printed[0],
            f"the packed example's loss falls: {printed}")
    require(not any(counts.values()),
            f"packed batches take the plain attention path: {counts}")
    emit({"phase": "packed_example", "rows": int(rows.shape[0]),
          "seq": 64, "non_pad_share": float((segs > 0).mean()),
          "loss_at_steps_10_20_30_40": printed, "launches": counts,
          "seconds": time.perf_counter() - t0})
    return counts


def packed_corpus(rng, n_docs):
    """Seeded documents of random lowercase words, 100-3000 bytes each."""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    docs = []
    for n in rng.integers(100, 3001, n_docs):
        words, size = [], 0
        while size < n:
            w = "".join(rng.choice(letters, rng.integers(1, 11)))
            words.append(w)
            size += len(w) + 1
        docs.append(" ".join(words)[:n] + ". ")
    return docs


def run_packed_flagship(cfg):
    """``make_train_step(packed=True)`` at the flagship's widths, bf16
    over f32, AdamW 3e-4: 3 steps over B 8 rows of 1024 that the byte
    tokenizer packed from seeded documents (the plain attention path
    with the segment mask). Then at 2 layers in f32 one SGD step on rows
    that each hold one document over all 1024 positions: the packed step
    (plain attention, segment mask) and the unpacked step (the f32 flash
    kernels) give the same loss and the same update. Returns the bf16
    steps' launch counts."""
    from elephas_tpu_torch.models.optimizers import SGD, AdamW
    from elephas_tpu_torch.models.transformer import (init_params,
                                                      make_train_step)
    from elephas_tpu_torch.utils.text import ByteTokenizer
    from elephas_tpu_torch.weights import tree_leaves, tree_map

    t0 = time.perf_counter()
    tok = ByteTokenizer()
    rng = np.random.default_rng(8)
    rows, segs = tok.pack_documents(packed_corpus(rng, 24), seq_len=1024)
    require(rows.shape[0] >= 8, f"{rows.shape[0]} packed rows")
    rows, segs = rows[:8], segs[:8]
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(2),
                         device="cuda")
    tx = AdamW(3e-4, epsilon=1e-8, weight_decay=1e-4,
               decay_1d=True).to_transform()
    opt = tx.init(params)
    step = make_train_step(cfg, tx, packed=True)
    tokens = torch.as_tensor(rows, device="cuda")
    segments = torch.as_tensor(segs, device="cuda")
    _, opt, _ = step(params, opt, tokens, segments)          # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t1 = time.perf_counter()
    losses = []
    for _ in range(3):
        _, opt, loss = step(params, opt, tokens, segments)
        losses.append(loss)
    losses = [float(x) for x in losses]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t1) / 3
    counts = read_counts()
    require(all(np.isfinite(losses)), f"finite packed losses {losses}")
    require(not any(counts.values()),
            f"packed batches take the plain attention path: {counts}")
    del params, opt
    free_memory()

    # 2 layers, f32: one document a row, packed step against unpacked
    cfg2 = dataclasses.replace(cfg, num_layers=2, dtype=torch.float32)
    docs = [d for d in packed_corpus(np.random.default_rng(9), 40)
            if len(d) > 1024][:2]
    require(len(docs) == 2, "two documents longer than a row")
    one_doc = torch.as_tensor([tok.encode(d)[:1024] for d in docs],
                              device="cuda")
    ones = torch.ones_like(one_doc)
    base = init_params(cfg2, torch.Generator(device="cuda").manual_seed(3),
                       device="cuda")
    sgd = SGD(0.1).to_transform()
    out = {}
    for packed in (True, False):
        p = tree_map(torch.clone, base)
        before = [t.clone() for t in tree_leaves(p)]
        st = make_train_step(cfg2, sgd, packed=packed)
        reset_counts()
        _, _, loss = (st(p, sgd.init(p), one_doc, ones) if packed
                      else st(p, sgd.init(p), one_doc))
        out[packed] = (float(loss), [a - b for a, b in zip(tree_leaves(p),
                                                           before)],
                       read_counts())
    (lp, dp, cp), (lu, du, cu) = out[True], out[False]
    rel = [max_err(a, b) / max(float(b.abs().max()), 1e-30)
           for a, b in zip(dp, du)]
    require(abs(lp - lu) <= 1e-4, f"f32 loss packed {lp} vs unpacked {lu}")
    require(max(rel) <= 1e-3, f"f32 update rel err {max(rel)} <= 1e-3")
    require(cu["flash_fwd"] == 2 and not any(cp.values()),
            f"unpacked on the flash kernels {cu}, packed on plain {cp}")
    emit({"phase": "packed_flagship", "batch": 8, "seq": 1024,
          "layers": cfg.num_layers,
          "docs_per_row": [int(r.max()) for r in segs],
          "non_pad_share": float((segs > 0).mean()),
          "bf16_losses": losses, "ms_per_step": step_s * 1e3,
          "tokens_per_s": 8 * 1024 / step_s,
          "f32_one_document_rows": {
              "layers": 2, "batch": 2, "loss_packed": lp,
              "loss_unpacked": lu, "max_update_rel_err": max(rel),
              "tolerance": {"loss_abs": 1e-4, "update_rel_to_leaf_max":
                            1e-3},
              "unpacked_launches": cu},
          "launches": counts, "seconds": time.perf_counter() - t0})
    return counts


def free_memory():
    """Collect unreachable objects (engines and models in reference
    cycles hold their parameters until then) and return the freed
    device memory to the card."""
    gc.collect()
    torch.cuda.empty_cache()


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
    the port (``tests/test_torch_sgd_rate_0_1.py`` shows both)."""
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
    return samples_s, tpu_model


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
# (tests/torch_overlap_workers.py runs both on the CPU at 2 and 4).
# (a) runs 2 workers too: the server subtracts each whole-epoch delta as
# it comes, so workers that pulled the same weights add their deltas to
# one base, a step as many times a worker's as there are workers; at 3
# and 4 such a step leaves the set untrained in both packages, at 2 it
# trains it (tests/torch_async_epoch_lockstep.py), and
# ``run_keras_async`` runs (a) once more with every epoch's pushes held
# to one base
ASYNC_CONFIGS = {
    "a": dict(mode="asynchronous", parameter_server_mode="http",
              frequency="epoch", num_workers=2),
    "b": dict(mode="hogwild", parameter_server_mode="socket",
              frequency="batch", num_workers=4),
    "c": dict(mode="asynchronous", parameter_server_mode="http",
              frequency="batch", async_overlap=True, async_accum=8,
              num_workers=2),
}


@contextlib.contextmanager
def epoch_pushes_in_lockstep(workers, worker_cls=None, timeout=300.0):
    """Hold epoch-frequency workers in lockstep while the block runs:
    each push waits until every worker has trained its epoch from its
    pull, and each next pull until every push has landed, so all of an
    epoch's deltas share one base (the interleaving in which the
    server's step is largest, ``workers`` times a worker's). Wraps
    ``worker_cls._push`` for the duration (the port's ``AsyncWorker``
    unless another is given)."""
    if worker_cls is None:
        from elephas_tpu_torch.worker import AsyncWorker as worker_cls

    trained, landed = (threading.Barrier(workers, timeout=timeout)
                       for _ in range(2))
    push = worker_cls._push

    def held(self, delta):
        trained.wait()
        out = push(self, delta)
        if self._pusher is not None:
            self._pusher.drain()
        landed.wait()
        return out

    worker_cls._push = held
    try:
        yield
    finally:
        worker_cls._push = push


def run_keras_async(data, sync_samples_s):
    """``TPUModel`` in its parameter-server modes (the default
    ``mode="asynchronous"`` and ``"hogwild"``) on the rows of the sync
    phases and the MLP of ``examples/mnist_mlp_asynchronous.py`` (with
    its Dropout 0.2), workers as threads on the card, SGD 0.01, batch 64,
    2 epochs, validation split 0.1: (a) asynchronous over HTTP at epoch
    frequency, 2 workers, then again with every epoch's pushes in
    lockstep (``a_lockstep``), (b) hogwild over the socket at batch
    frequency (the reference loop: a pull, ``set_weights``, a step,
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
    runs = [(name, cfg, False) for name, cfg in ASYNC_CONFIGS.items()]
    runs.insert(1, ("a_lockstep", ASYNC_CONFIGS["a"], True))
    for name, cfg, lockstep in runs:
        workers = cfg["num_workers"]
        model = mnist_mlp(0.2)
        model.compile(SGD(learning_rate=0.01), "categorical_crossentropy",
                      ["acc"], seed=0)
        tpu_model = TPUModel(model, batch_size=64, port=free_port(), **cfg)
        dataset = to_dataset(x, y).repartition(workers)
        sizes = dataset.partition_sizes()
        before = client_rpcs()
        t0 = time.perf_counter()
        with (epoch_pushes_in_lockstep(workers) if lockstep
              else contextlib.nullcontext()):
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
            **cfg, "pushes_in_lockstep": lockstep, "fit_s": fit_s,
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


def run_keras_persist(data, tpu_model):
    """Persistence on the sync-step phase's MLP and rows: (1)
    ``TPUModel.save`` then ``load_tpu_model`` (onto the card): ``predict``
    and ``evaluate`` bit-equal, the distributed and optimizer configs
    equal; (2) a Keras ``fit`` (Adam 1e-3, one epoch, batch 64) with
    ``ModelCheckpoint(block=False)``, then a fresh ``Sequential`` of the
    same layers (other auto names, another init) restores params and
    Adam state bit-equal, and one more epoch lowers the loss; (3)
    ``TPUMatrixModel`` on ``to_labeled_points`` of 8,192 rows
    (categorical), its default asynchronous mode with 2 workers, 1
    epoch: ``predict`` on a ``DenseMatrix`` equals the master network's,
    on a ``DenseVector`` the matrix's first row within 1e-6 (a batch of
    one takes another GEMM), and a save and ``load_tpu_model`` give a
    ``TPUMatrixModel`` back."""
    import tempfile

    from elephas_tpu_torch import (Adam, SGD, TPUMatrixModel, TPUModel,
                                   load_tpu_model, to_labeled_points)
    from elephas_tpu_torch.mllib import DenseMatrix, to_matrix, to_vector
    from elephas_tpu_torch.models import ModelCheckpoint
    from elephas_tpu_torch.models.optimizers import opt_state_leaves
    from elephas_tpu_torch.utils.sockets import free_port

    (x, y), (x_test, y_test) = data
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        path = f"{tmp}/mlp.h5"
        t0 = time.perf_counter()
        tpu_model.save(path)
        out["save_ms"] = 1e3 * (time.perf_counter() - t0)
        out["file_bytes"] = os.path.getsize(path)
        t0 = time.perf_counter()
        loaded = load_tpu_model(path)
        torch.cuda.synchronize()
        out["load_ms"] = 1e3 * (time.perf_counter() - t0)
        require(type(loaded) is TPUModel
                and loaded.master_network.device.type == "cuda"
                and loaded.get_config() == tpu_model.get_config()
                and loaded.master_optimizer == tpu_model.master_optimizer,
                "the loaded TPUModel has the saved configs, on the card")
        require(np.array_equal(loaded.predict(x_test),
                               tpu_model.predict(x_test)),
                "the loaded model's predict is bit-equal")
        evals = loaded.evaluate(x_test, y_test)
        require(evals == tpu_model.evaluate(x_test, y_test),
                "the loaded model's evaluate is bit-equal")

        ckpt_dir = f"{tmp}/ckpt"
        model = mnist_mlp(0.0)
        model.compile(Adam(1e-3), "categorical_crossentropy", ["acc"],
                      seed=0)
        first = model.fit(x, y, epochs=1, batch_size=64, callbacks=[
            ModelCheckpoint(ckpt_dir, block=False)]).history["loss"][0]
        fresh = mnist_mlp(0.0)
        fresh.compile(Adam(1e-3), "categorical_crossentropy", ["acc"],
                      seed=1)
        require([l.name for l in fresh.layers]
                != [l.name for l in model.layers], "other layer names")
        t0 = time.perf_counter()
        step = fresh.restore_training_state(ckpt_dir)
        torch.cuda.synchronize()
        out["restore_ms"] = 1e3 * (time.perf_counter() - t0)
        require(step == 0, f"restored step {step}")
        pairs = (list(zip(fresh.get_weights(), model.get_weights()))
                 + [(a.cpu().numpy(), b.cpu().numpy()) for a, b in zip(
                     opt_state_leaves(fresh._opt_state),
                     opt_state_leaves(model._opt_state))])
        require(len(pairs) == 6 + 13 and all(
            a.dtype == b.dtype and np.array_equal(a, b) for a, b in pairs),
            "params and Adam state restored bit-equal")
        second = fresh.fit(x, y, epochs=1, batch_size=64).history["loss"][0]
        require(np.isfinite(second) and second < first,
                f"the resumed epoch lowers the loss: {first} -> {second}")
        out.update(first_epoch_loss=first, resumed_epoch_loss=second)

        rows = 8192
        matrix_model = mnist_mlp(0.0)
        matrix_model.compile(SGD(learning_rate=0.01),
                             "categorical_crossentropy", ["acc"], seed=0)
        before = matrix_model.get_weights()
        mm = TPUMatrixModel(matrix_model, num_workers=2, batch_size=64,
                            port=free_port())
        t0 = time.perf_counter()
        mm.fit(to_labeled_points(x[:rows], y[:rows], categorical=True),
               epochs=1, batch_size=64, categorical=True, nb_classes=10)
        out["matrix_fit_s"] = time.perf_counter() - t0
        require(mm.parameter_server.num_updates == 2,
                "one push per worker and epoch")
        require(any(not np.array_equal(a, b) for a, b in
                    zip(before, matrix_model.get_weights())),
                "the matrix model's weights moved")
        probe = x_test[:16]
        preds = mm.predict(to_matrix(probe))
        require(isinstance(preds, DenseMatrix) and np.array_equal(
            preds.toArray(), matrix_model.predict(probe).astype(np.float64)),
            "matrix predict equals the master network's")
        row = mm.predict(to_vector(probe[0])).toArray()
        out["vector_vs_matrix_err"] = float(
            np.abs(row - preds.toArray()[0]).max())
        require(out["vector_vs_matrix_err"] <= 1e-6,
                "vector predict is the matrix's first row")
        mm.save(f"{tmp}/matrix.h5")
        back = load_tpu_model(f"{tmp}/matrix.h5")
        require(type(back) is TPUMatrixModel and back.num_workers == 2,
                "a saved TPUMatrixModel loads as one")
    emit({"phase": "keras_persist", "rows": len(x), "matrix_rows": rows,
          "held_out_loss_acc": evals, **out})


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
    cross-entropy of predict's logits. The rest of the example follows:
    ``ModelCheckpoint`` beside ``EarlyStopping`` writes every epoch (the
    manifest's latest step is the last epoch run, the last 3 kept); a
    fresh model (seed 7) restores params, Adam moments and count
    bit-equal; it trains one more epoch through ``TPUModel`` (launches
    by formula); ``TPUModel.save`` and ``load_tpu_model`` give a model
    of the same config whose ``predict`` is bit-equal on the kernels.
    Then one f32 gradient at this config through the kernels against
    the plain path."""
    import tempfile

    from elephas_tpu_torch import Adam, TPUModel, load_tpu_model
    from elephas_tpu_torch.models import EarlyStopping, ModelCheckpoint
    from elephas_tpu_torch.models.optimizers import opt_state_leaves
    from elephas_tpu_torch.models.transformer import (TRANSFORMER_TPUMODEL,
                                                      TransformerConfig,
                                                      init_params)
    from elephas_tpu_torch.models.transformer_model import TransformerModel
    from elephas_tpu_torch.weights import tree_leaves

    cfg = TransformerConfig(**TRANSFORMER_TPUMODEL)
    require(cfg.head_dim == 32, f"head dim {cfg.head_dim}")
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    ckpt = ModelCheckpoint(f"{tmp.name}/ckpt")
    save_ms = []
    blocking_save = ckpt.manager.save

    def timed_save(*args, **kwargs):
        t = time.perf_counter()
        blocking_save(*args, **kwargs)
        save_ms.append(1e3 * (time.perf_counter() - t))

    ckpt.manager.save = timed_save
    rows, seq, batch, epochs, val = 256, cfg.max_seq_len, 16, 5, 0.1
    tokens = zipf_tokens(np.random.default_rng(12), cfg.vocab_size,
                         (rows, seq))
    model = TransformerModel(cfg, device="cuda").compile(Adam(3e-4), seed=0)
    tpu_model = TPUModel(model, mode="synchronous")
    stop = EarlyStopping(monitor="val_loss", patience=2)
    reset_counts()
    t0 = time.perf_counter()
    tpu_model.fit(tokens, epochs=epochs, batch_size=batch,
                  validation_split=val, callbacks=[ckpt, stop])
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

    # the rest of examples/transformer_tpumodel.py: restore, resume, save
    manifest = ckpt.manager.manifest()
    require(manifest["latest_step"] == ran - 1
            and manifest["steps"] == list(range(max(0, ran - 3), ran)),
            f"one checkpoint per epoch, the last 3 kept: {manifest}")
    ckpt_bytes = sum(f.stat().st_size for f in
                     Path(tmp.name, "ckpt").rglob("*") if f.is_file())
    resumed = TransformerModel(cfg, device="cuda").compile(Adam(3e-4), seed=7)
    t0 = time.perf_counter()
    step = resumed.restore_training_state(f"{tmp.name}/ckpt")
    torch.cuda.synchronize()
    restore_ms = 1e3 * (time.perf_counter() - t0)
    pairs = list(zip(tree_leaves(resumed.params) + opt_state_leaves(
        resumed._opt_state), tree_leaves(model.params) + opt_state_leaves(
        model._opt_state)))
    require(step == ran - 1 and len(pairs) == 1 + 3 * len(
        tree_leaves(model.params)) and all(
        a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs),
        "restore_training_state: params, moments and count bit-equal")
    resumed_tpu = TPUModel(resumed, mode="synchronous")
    reset_counts()
    resumed_tpu.fit(tokens, epochs=1, batch_size=batch, validation_split=val)
    torch.cuda.synchronize()
    resumed_counts = read_counts()
    resumed_hist = resumed_tpu.training_histories[-1]
    require(np.isfinite(resumed_hist["loss"] + resumed_hist["val_loss"]).all(),
            f"finite resumed losses {resumed_hist}")
    resumed_steps = (rows - int(round(rows * val))) // batch
    for name in ("flash_dq", "flash_dkv"):
        require(resumed_counts[name] == layers * resumed_steps,
                f"resumed fit: {name} once per layer and step: "
                f"{resumed_counts}")
    require(resumed_counts["flash_fwd"] == layers * (resumed_steps + 1),
            f"resumed fit: flash_fwd per layer and forward: {resumed_counts}")
    path = f"{tmp.name}/lm.h5"
    t0 = time.perf_counter()
    resumed_tpu.save(path)
    tpu_save_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    loaded = load_tpu_model(path)
    torch.cuda.synchronize()
    tpu_load_ms = 1e3 * (time.perf_counter() - t0)
    require(type(loaded) is TPUModel
            and isinstance(loaded.master_network, TransformerModel)
            and loaded.master_network.get_config() == resumed.get_config(),
            "load_tpu_model gives a TPUModel over the same LM config")
    saved_logits = resumed_tpu.predict(probe)
    reset_counts()
    loaded_logits = loaded.predict(probe)
    torch.cuda.synchronize()
    loaded_counts = read_counts()
    require(np.array_equal(loaded_logits, saved_logits),
            "the loaded model's predict is bit-equal to the saved one's")
    require(loaded_counts["flash_fwd"] == layers,
            f"the loaded predict ran flash_fwd once per layer: "
            f"{loaded_counts}")
    file_bytes = os.path.getsize(path)
    tmp.cleanup()
    emit({"phase": "tpu_model_lm_d32", "config": TRANSFORMER_TPUMODEL,
          "head_dim": cfg.head_dim, "rows": rows, "batch": batch,
          "epochs_run": ran, "stopped_epoch": stop.stopped_epoch,
          "steps": steps, "history": hist, "fit_s": fit_s,
          "evaluate_loss": loss, "predict_cross_entropy": ce,
          "launches": counts, "launches_fit": fit_counts,
          "launches_predict_evaluate": infer_counts,
          "checkpoint": {"manifest_steps": manifest["steps"],
                         "bytes_on_disk": ckpt_bytes,
                         "blocking_save_ms_per_epoch": save_ms,
                         "restore_ms": restore_ms, "restored_step": step},
          "resumed": {"history": resumed_hist, "steps": resumed_steps,
                      "launches": resumed_counts},
          "tpu_model_file": {"save_ms": tpu_save_ms, "load_ms": tpu_load_ms,
                             "bytes": file_bytes,
                             "predict_launches": loaded_counts}})
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    run_train_parity(params, cfg, shape=(batch, seq),
                     phase="train_parity_d32")
    return counts, resumed_counts, loaded_counts


# ----------------------------------------------------- keras_layers
def lstm_example_data(n=4096, t=16, vocab=32):
    """``examples/lstm_sequence_classification.py``'s task: is the count
    of token 1 in the window even?"""
    rng = np.random.default_rng(0)
    x = rng.integers(0, vocab, size=(n, t)).astype("int32")
    y_bit = ((x == 1).sum(axis=1) % 2 == 0).astype("float32")
    return x, np.stack([1 - y_bit, y_bit], axis=1)


def lstm_example_model(device):
    from elephas_tpu_torch.models import (LSTM, Adam, Dense, Embedding,
                                          Sequential)
    model = Sequential([Embedding(32, 16, input_shape=(16,)), LSTM(32),
                        Dense(2, activation="softmax")], device=device)
    model.compile(Adam(learning_rate=5e-3), "categorical_crossentropy",
                  metrics=["acc"], seed=0)
    return model


def lstm_epoch(device, w0, x, y):
    """One epoch of the example's model from ``w0`` through
    ``SyncStepTrainer`` (the sync step ``TPUModel``'s trainer) without
    shuffling (the card's and the CPU's generators permute differently):
    ``(epoch losses, weights, seconds)``."""
    from elephas_tpu_torch.models import Adam, metrics
    from elephas_tpu_torch.parallel import SyncStepTrainer

    model = lstm_example_model(device)
    loss = "categorical_crossentropy"
    trainer = SyncStepTrainer(model, Adam(learning_rate=5e-3), loss,
                              [metrics.get("acc", loss=loss)])
    t0 = time.perf_counter()
    weights, hist = trainer.fit(w0, x, y, epochs=1, batch_size=128,
                                validation_split=0.1, shuffle=False)
    return hist["loss"], weights, time.perf_counter() - t0


def plain_lstm_samples_per_s(x, y, batch_size=128, epochs=2):
    """The example's model as a plain PyTorch loop on the card:
    ``nn.Embedding`` -> ``nn.LSTM`` -> ``nn.Linear``, log-softmax
    cross-entropy, ``torch.optim.Adam(5e-3)``, shuffled full batches,
    data on the card. Returns the last epoch's samples/s."""
    torch.manual_seed(0)
    emb = torch.nn.Embedding(32, 16).to("cuda")
    lstm = torch.nn.LSTM(16, 32, batch_first=True).to("cuda")
    head = torch.nn.Linear(32, 2).to("cuda")
    params = [*emb.parameters(), *lstm.parameters(), *head.parameters()]
    opt = torch.optim.Adam(params, lr=5e-3)
    x = torch.as_tensor(x, device="cuda").long()
    y = torch.as_tensor(y, device="cuda")
    n = x.shape[0]
    nb = n // batch_size
    gen = torch.Generator(device="cuda").manual_seed(0)
    for _ in range(epochs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        order = torch.randperm(n, generator=gen, device="cuda")
        for i in range(nb):
            idx = order[i * batch_size:(i + 1) * batch_size]
            _, (h, _) = lstm(emb(x[idx]))
            logp = torch.log_softmax(head(h[0]), dim=-1)
            loss = -(y[idx] * logp).sum(-1).mean()
            opt.zero_grad()
            loss.backward()
            opt.step()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    require(bool(torch.isfinite(loss)), "plain LSTM loop loss finite")
    return nb * batch_size / seconds


def run_lstm_example():
    """(a) ``examples/lstm_sequence_classification.py``'s program on the
    port as written: 4096 rows of 16 tokens (vocab 32), Embedding 16 ->
    LSTM 32 -> Dense 2 softmax, Adam 5e-3, ``TPUModel(mode="synchronous",
    sync_mode="step", num_workers=4)``, 6 epochs at batch 128 with
    validation split 0.1, then ``predict`` on 1024 rows. Held-out
    accuracy on the 410 split rows, samples/s and seconds per epoch, a
    plain PyTorch loop's samples/s beside; then one epoch from the same
    weights on the card and on the CPU within 1e-4 (loss) and 1e-3
    (weights: 29 Adam steps carry cuDNN's and the loop's summation
    orders)."""
    from elephas_tpu_torch import TPUModel, to_dataset

    x, y = lstm_example_data()
    model = lstm_example_model("cuda")
    w0 = model.get_weights()
    require(model.layers[1].cudnn_route(
        torch.zeros((1, 16, 16), device="cuda")),
        "the example's LSTM takes cuDNN's route on the card")
    tpu_model = TPUModel(model, mode="synchronous", sync_mode="step",
                         num_workers=4)
    t0 = time.perf_counter()
    tpu_model.fit(to_dataset(x, y), epochs=6, batch_size=128, verbose=1,
                  validation_split=0.1)
    fit_s = time.perf_counter() - t0
    preds = tpu_model.predict(x[:1024])
    acc = float((np.asarray(preds).argmax(1) == y[:1024].argmax(1)).mean())
    print("accuracy:", acc, flush=True)
    hist = tpu_model.training_histories[-1]
    losses = hist["loss"]
    require(preds.shape == (1024, 2) and np.isfinite(preds).all()
            and np.allclose(preds.sum(1), 1.0, atol=1e-5),
            "example predictions: finite probabilities, one row per input")
    require(np.array_equal(preds.argmax(1), tpu_model.master_network.predict(
        x[:1024]).argmax(1)), "distributed predict argmax equals the master's")
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"example epoch losses fall: {losses}")
    split = int(len(x) * 0.9)
    held_out = tpu_model.evaluate(x[split:], y[split:])
    train_rows = split
    samples_s = train_rows / hist["epoch_time"][-1]
    plain_s = plain_lstm_samples_per_s(x[:split], y[:split])
    (cpu_loss, cpu_w, cpu_s), (gpu_loss, gpu_w, gpu_s) = (
        lstm_epoch(d, w0, x, y) for d in ("cpu", "cuda"))
    loss_err = float(np.abs(np.asarray(gpu_loss) - cpu_loss).max())
    weight_err = max(float(np.abs(a - b).max()) for a, b in zip(gpu_w, cpu_w))
    require(loss_err <= 1e-4 and weight_err <= 1e-3,
            f"one epoch on the card meets the CPU's: loss {loss_err}, "
            f"weights {weight_err}")
    emit({"phase": "keras_layers_lstm_example", "rows": len(x),
          "train_rows": train_rows, "held_out_rows": len(x) - split,
          "batch": 128, "epochs": 6, "epoch_losses": losses,
          "epoch_acc": hist["categorical_accuracy"],
          "epoch_time_s": hist["epoch_time"], "fit_s": fit_s,
          "samples_per_s": samples_s, "plain_loop_samples_per_s": plain_s,
          "held_out_loss_acc": held_out, "example_accuracy_1024": acc,
          "card_vs_cpu_epoch": {"loss_max_abs_err": loss_err,
                                "weight_max_abs_err": weight_err,
                                "loss_tol": 1e-4, "weight_tol": 1e-3,
                                "cpu_epoch_s": cpu_s, "card_epoch_s": gpu_s}})
    return samples_s


def mnist_cnn(device):
    """The layers and widths of Keras's published ``examples/mnist_cnn.py``
    (and its optimizer, Adadelta at learning rate 1.0)."""
    from elephas_tpu_torch.models import (Adadelta, Conv2D, Dense, Dropout,
                                          Flatten, MaxPooling2D, Sequential)
    model = Sequential([
        Conv2D(32, kernel_size=(3, 3), activation="relu",
               input_shape=(28, 28, 1)),
        Conv2D(64, (3, 3), activation="relu"),
        MaxPooling2D(pool_size=(2, 2)), Dropout(0.25), Flatten(),
        Dense(128, activation="relu"), Dropout(0.5),
        Dense(10, activation="softmax")], device=device)
    model.compile(Adadelta(learning_rate=1.0, rho=0.95, epsilon=1e-7),
                  "categorical_crossentropy", ["acc"], seed=0)
    return model


def run_mnist_cnn(data):
    """(b) The ``mnist_cnn.py`` model on the 60,000 MNIST-like rows as
    28x28x1 images through ``TPUModel(sync_mode="average")`` (one worker
    on the one card) for 2 epochs at batch 128; the oracle and held-out
    accuracy on 10,000 rows; samples/s with TF32 off, then one more epoch
    with cuDNN's TF32 on (PyTorch's default for convolutions)."""
    from elephas_tpu_torch import TPUModel, to_dataset

    (x, y), (x_test, y_test) = data
    x = x.reshape(-1, 28, 28, 1)
    x_test = x_test.reshape(-1, 28, 28, 1)
    model = mnist_cnn("cuda")
    tpu_model = TPUModel(model, mode="synchronous", sync_mode="average")
    t0 = time.perf_counter()
    tpu_model.fit(to_dataset(x, y), epochs=2, batch_size=128,
                  validation_split=0.0)
    fit_s = time.perf_counter() - t0
    hist = tpu_model.training_histories[-1]
    require(all(np.isfinite(hist["loss"]))
            and hist["loss"][1] < hist["loss"][0],
            f"CNN epoch losses fall: {hist['loss']}")
    evals, master_evals = tpu_model_oracle(tpu_model, x_test, y_test)
    require(evals[1] > 0.9, f"CNN held-out accuracy {evals[1]} > 0.9")
    samples_s = 2 * len(x) / hist["fit_time"][0]
    torch.backends.cudnn.allow_tf32 = True
    try:
        tpu_model.fit(to_dataset(x, y), epochs=1, batch_size=128,
                      validation_split=0.0)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    tf32_s = len(x) / tpu_model.training_histories[-1]["fit_time"][0]
    emit({"phase": "keras_layers_mnist_cnn", "rows": len(x),
          "held_out": len(x_test), "batch": 128, "epochs": 2,
          "optimizer": "Adadelta(1.0)", "epoch_losses": hist["loss"],
          "epoch_acc": hist["categorical_accuracy"], "fit_s": fit_s,
          "trainer_fit_time_s": hist["fit_time"][0],
          "samples_per_s": samples_s,
          "samples_per_s_cudnn_tf32": tf32_s,
          "held_out_loss_acc": evals, "master_loss_acc": master_evals})
    return samples_s


# name: (layer, batch-less input shape, integer ids, training); the
# shapes of (a) and (b)'s paths where a layer is on one
CARD_LAYERS = {
    "Conv2D_28x28x1_32": (lambda m: m.Conv2D(32, 3, activation="relu"),
                          (28, 28, 1), False, True),
    "Conv2D_26x26x32_64": (lambda m: m.Conv2D(64, 3, activation="relu"),
                           (26, 26, 32), False, True),
    "Conv2D_same_stride2_odd": (lambda m: m.Conv2D(8, (3, 2), strides=2,
                                                   padding="same"),
                                (9, 7, 3), False, True),
    "MaxPooling2D_24x24x64": (lambda m: m.MaxPooling2D(2), (24, 24, 64),
                              False, True),
    "MaxPooling2D_same": (lambda m: m.MaxPooling2D(3, strides=2,
                                                   padding="same"),
                          (9, 7, 4), False, True),
    "AveragePooling2D_same": (lambda m: m.AveragePooling2D(
        3, strides=2, padding="same"), (9, 7, 4), False, True),
    "GlobalAveragePooling2D": (lambda m: m.GlobalAveragePooling2D(),
                               (7, 7, 16), False, True),
    "Embedding_32x16": (lambda m: m.Embedding(32, 16), (16,), True, True),
    "LSTM_32_cudnn": (lambda m: m.LSTM(32), (16, 16), False, True),
    "LSTM_relu_loop": (lambda m: m.LSTM(16, activation="relu",
                                        return_sequences=True),
                       (16, 16), False, True),
    "GRU_32": (lambda m: m.GRU(32), (16, 16), False, True),
    "LayerNormalization": (lambda m: m.LayerNormalization(), (16, 32),
                           False, True),
    "BatchNormalization_training": (lambda m: m.BatchNormalization(),
                                    (13, 13, 32), False, True),
    "BatchNormalization_inference": (lambda m: m.BatchNormalization(),
                                     (13, 13, 32), False, False),
}
LAYER_TOL = 1e-4


def scaled_err(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| over max(1, max |want|)."""
    return float(np.abs(got - want).max(initial=0.0)
                 / max(1.0, float(np.abs(want).max(initial=0.0))))


def layer_card_vs_cpu(make, shape, integer, training, batch=64):
    """A layer's forward and the gradient of ``sum(out * r)`` (every
    parameter and the input) on the card against the CPU from the same
    seeded parameters: the worst :func:`scaled_err`, and the card's
    route for an LSTM."""
    from elephas_tpu_torch.models import layers

    layer = make(layers)
    rng = np.random.default_rng(0)
    built = layer.build(torch.Generator().manual_seed(0), shape)
    params = {k: (rng.uniform(0.5, 1.5, v.shape)
                  if k in ("gamma", "moving_variance")
                  else 0.3 * rng.normal(size=v.shape)).astype(np.float32)
              for k, v in built.items()}
    x = (rng.integers(0, 32, (batch,) + shape).astype(np.int32) if integer
         else rng.normal(size=(batch,) + shape).astype(np.float32))
    r, results, route = None, [], None
    for device in ("cpu", "cuda"):
        p = {k: torch.tensor(v, device=device, requires_grad=True)
             for k, v in params.items()}
        xt = torch.tensor(x, device=device, requires_grad=not integer)
        if device == "cuda" and isinstance(layer, layers.LSTM):
            route = "cudnn" if layer.cudnn_route(xt) else "loop"
        out = layer.call(p, xt, training, None)
        if r is None:
            r = rng.normal(size=tuple(out.shape)).astype(np.float32)
        wrt = [p[k] for k in sorted(p)] + ([] if integer else [xt])
        grads = torch.autograd.grad(
            (out * torch.as_tensor(r, device=device)).sum(), wrt,
            allow_unused=True)
        results.append([out.detach().cpu().numpy()] + [
            np.zeros(w.shape, np.float32) if g is None else g.cpu().numpy()
            for g, w in zip(grads, wrt)])
    return max(scaled_err(b, a) for a, b in zip(*results)), route


def bn_fit_card_vs_cpu():
    """3 steps of ``fit`` (batch 32, no shuffle) on Conv2D -> BatchNorm
    -> Dense on the card and the CPU from the same weights: the largest
    weight error (moving statistics included) and how far the moving
    mean moved."""
    from elephas_tpu_torch.models import (Adam, BatchNormalization, Conv2D,
                                          Dense, Flatten, Sequential)
    rng = np.random.default_rng(0)
    x = rng.normal(0.5, 1.0, (96, 14, 14, 3)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 96)]
    finals, w0 = [], None
    for device in ("cpu", "cuda"):
        model = Sequential([Conv2D(16, 3, use_bias=False,
                                   input_shape=(14, 14, 3)),
                            BatchNormalization(momentum=0.9), Flatten(),
                            Dense(10, activation="softmax")], device=device)
        model.compile(Adam(1e-2), "categorical_crossentropy", seed=0)
        w0 = w0 or model.get_weights()
        model.set_weights(w0)
        model.fit(x, y, epochs=1, batch_size=32, shuffle=False)
        finals.append(model.get_weights())
    err = max(float(np.abs(a - b).max()) for a, b in zip(*finals))
    # weights: kernel, gamma, beta, moving_mean, moving_variance, ...
    return err, float(np.abs(finals[1][3]).max())


CARD_OPTIMIZERS = {
    "Adagrad": lambda m: m.Adagrad(1e-1),
    "Adadelta": lambda m: m.Adadelta(1.0),
    "Nadam": lambda m: m.Nadam(1e-2),
    "Adafactor_factored": lambda m: m.Adafactor(min_dim_size_to_factor=32,
                                                weight_decay_rate=0.01),
    "Lion": lambda m: m.Lion(1e-3, weight_decay=0.1),
    "LAMB": lambda m: m.LAMB(1e-2, weight_decay=0.1),
    "Adam_ExponentialDecay": lambda m: m.Adam(m.schedules.ExponentialDecay(
        1e-2, 2, 0.5)),
    "SGD_CosineDecay": lambda m: m.SGD(m.schedules.CosineDecay(0.1, 4),
                                       momentum=0.9),
    "RMSprop_PiecewiseConstantDecay": lambda m: m.RMSprop(
        m.schedules.PiecewiseConstantDecay([2], [1e-2, 1e-3])),
    "LAMB_WarmupCosine": lambda m: m.LAMB(m.schedules.WarmupCosine(
        1e-2, 2, 6)),
}
# of scale: the card's reductions (Adafactor's moments, LAMB's norms)
# sum in another order than the CPU's
OPT_TOL = 1e-5


def optimizer_card_vs_cpu(make):
    """5 updates of the example LSTM's kernels' shapes ((16, 128) and
    (32, 128)) and a (128,) bias on the card against the CPU: the largest
    :func:`scaled_err` over the parameters and the state's leaves."""
    from elephas_tpu_torch.models import optimizers
    rng = np.random.default_rng(0)
    params = [rng.normal(size=s).astype(np.float32)
              for s in ((16, 128), (32, 128), (128,))]
    grads = [[rng.normal(size=p.shape).astype(np.float32) for p in params]
             for _ in range(5)]
    finals = []
    for device in ("cpu", "cuda"):
        tx = make(optimizers).to_transform()
        p = [torch.tensor(a, device=device) for a in params]
        state = tx.init(p)
        for g in grads:
            updates, state = tx.update(
                [torch.tensor(a, device=device) for a in g], state, p)
            p = [w + u for w, u in zip(p, updates)]
        finals.append([t.cpu().numpy() for t in
                       p + optimizers.opt_state_leaves(state)])
    return max(scaled_err(b, a) for a, b in zip(*finals))


def run_keras_layers(data):
    """``keras_layers``: (a) the LSTM example, (b) the MNIST CNN, (c)
    every layer, optimizer and schedule ported with them, card against
    CPU (TF32 off, as for the whole run)."""
    lstm_s = run_lstm_example()
    cnn_s = run_mnist_cnn(data)
    layer_errs, routes = {}, {}
    for name, (make, shape, integer, training) in CARD_LAYERS.items():
        layer_errs[name], route = layer_card_vs_cpu(make, shape, integer,
                                                    training)
        if route is not None:
            routes[name] = route
    require(routes == {"LSTM_32_cudnn": "cudnn", "LSTM_relu_loop": "loop"},
            f"LSTM routes on the card: {routes}")
    bad = {k: v for k, v in layer_errs.items() if not v <= LAYER_TOL}
    require(not bad, f"layers on the card meet the CPU within {LAYER_TOL} "
            f"of scale: {bad}")
    bn_err, bn_moved = bn_fit_card_vs_cpu()
    require(bn_err <= 1e-5 and bn_moved > 1e-3,
            f"BatchNormalization fit on the card meets the CPU: {bn_err}, "
            f"moving mean moved {bn_moved}")
    opt_errs = {name: optimizer_card_vs_cpu(make)
                for name, make in CARD_OPTIMIZERS.items()}
    bad = {k: v for k, v in opt_errs.items() if not v <= OPT_TOL}
    require(not bad, f"optimizers on the card meet the CPU within "
            f"{OPT_TOL}: {bad}")
    emit({"phase": "keras_layers_card_vs_cpu",
          "layer_max_scaled_err": layer_errs, "layer_tol": LAYER_TOL,
          "lstm_routes": routes, "bn_fit_weight_max_abs_err": bn_err,
          "bn_fit_tol": 1e-5, "bn_moving_mean_max": bn_moved,
          "optimizer_max_scaled_err": opt_errs, "optimizer_tol": OPT_TOL})
    return lstm_s, cnn_s


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "GPU", file=sys.stderr)
        return 2
    from elephas_tpu_torch.models.transformer import (FLAGSHIP,
                                                      TransformerConfig,
                                                      init_params)
    from elephas_tpu_torch.ops import _kernels
    from elephas_tpu_torch.ops.flash_attention import body_width

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_run = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        # each phase's wall seconds, printed in one line at the end
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

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
    wide = wide_body_registers(report, WIDE_BODIES)
    wide256 = wide_body_registers(report, WIDE_256_BODIES)
    narrow = wide_body_registers(report, NARROW_BODIES)
    narrow_bwd = wide_body_registers(report, NARROW_BWD_BODIES)
    split_regs = paged_split_registers(report)
    f32_narrow = f32_body_registers(report, F32_NARROW_BODIES)
    f32_wide = f32_body_registers(report, F32_WIDE_BODIES)
    # a product in flight where two paths meet: ptxas serializes every
    # wgmma of the kernel (C7515), as a trap in a consumer does (C7512)
    serialized = [ln for ln in report.splitlines()
                  if "C7515" in ln or "C7512" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": resources, "d128_bodies": wide, "d256_bodies": wide256,
          "narrow_bodies": narrow, "narrow_bwd_bodies": narrow_bwd,
          "paged_split_bodies": split_regs,
          "f32_narrow_bodies": f32_narrow, "f32_wide_bodies": f32_wide,
          "serialized_wgmma": serialized})
    require(not spills, f"no kernel spills registers: {spills}")
    for built, want, what in (
            (f32_narrow, F32_NARROW_BODIES, "strip bodies at widths 16 and 32"),
            (f32_wide, F32_WIDE_BODIES,
             "tensor-core bodies at widths 64, 128 and 256")):
        require(sorted(built) == sorted(want)
                and all("0 bytes spill stores, 0 bytes spill loads"
                        in r.get("spill", "")
                        and r.get("registers", 256) <= 255
                        for r in built.values()),
                f"the f32 {what} are built without a spill: {built}")
    require(not any("narrow" in ln for ln in serialized),
            f"the narrow forward and backward bodies' wgmma is not "
            f"serialized: {serialized}")
    require(all(r == {"launch": 128, "producer": 24, "consumers": 160}
                for r in narrow.values()),
            f"the narrow bodies launch at 128 registers, the producer drops "
            f"to 24 and the consumers rise to 160: {narrow}")
    require(all(r == {"launch": 128, "producer": 32, "consumers": 160}
                for r in narrow_bwd.values()),
            f"the narrow backward bodies launch at 128 registers, the "
            f"producer drops to 32 and the consumers rise to 160: "
            f"{narrow_bwd}")
    require(sorted(split_regs) == sorted(
        f"W{w}_G{g}" for w in (16, 32, 64, 128, 256) for g in (1, 2, 4, 8))
            and all(r <= (255 if k.endswith("_G8") else 128)
                    for k, r in split_regs.items()),
            f"the paged split body is built at every width and group, "
            f"within its register budget: {split_regs}")
    require(all(r == {"launch": 168, "producer": 24, "consumers": 240}
                for r in (*wide.values(), *wide256.values())),
            f"the d 128 and d 256 bodies launch at 168 registers, the "
            f"producer drops to 24 and the consumers rise to 240: {wide}, "
            f"{wide256}")

    # a buffer past the 50 MB L2, overwritten before each timed call
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    paged = timed("paged_kernel", check_paged, flush)
    flash = timed("flash_kernel", check_flash, flush)
    bwd = timed("flash_bwd_kernels", check_flash_bwd, flush)
    f32 = timed("flash_f32_bodies", check_flash_f32, flush)
    paged_f32 = timed("paged_f32_example", check_paged_f32_example, flush)
    del flush

    cfg = TransformerConfig(**FLAGSHIP)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    fwd_counts = timed("forward", run_forward, params, cfg)
    srv_counts = timed("serving", run_serving, params, cfg)
    flag_counts = timed("http_serving_flagship", run_http_serving_flagship,
                        params, cfg)
    reset_counts()
    timed("train_parity", run_train_parity, params, cfg)
    parity_counts = read_counts()
    spec = timed("speculative_flagship", run_speculative_flagship, params,
                 cfg)
    int8_counts = timed("int8_paged_flagship", run_int8_paged_flagship,
                        params, cfg)
    del params
    packed_counts = timed("packed_flagship", run_packed_flagship, cfg)
    train_counts = timed("train", run_train, cfg)
    d128 = timed("lm_d128", run_lm_d128)
    d96 = timed("lm_d96", run_lm_d96)
    d256 = timed("lm_d256", run_lm_d256)
    moe = timed("lm_moe", run_lm_moe)
    packed_ex_counts = timed("packed_example", run_packed_example)

    data = (mnist_like(60000, seed=0), mnist_like(10000, seed=1))
    sync_samples_s, sync_tpu_model = timed(
        "keras_sync_step", run_keras_sync_step, data)
    timed("keras_sync_average", run_keras_sync_average, data)
    reset_counts()
    timed("keras_async", run_keras_async, data, sync_samples_s)
    async_counts = read_counts()
    require(not any(async_counts.values()),
            f"no async path launches a kernel: {async_counts}")
    reset_counts()
    timed("keras_persist", run_keras_persist, data, sync_tpu_model)
    persist_counts = read_counts()
    require(not any(persist_counts.values()),
            f"no Keras persistence path launches a kernel: {persist_counts}")
    reset_counts()
    timed("keras_layers", run_keras_layers, data)
    layers_counts = read_counts()
    require(not any(layers_counts.values()),
            f"no Keras layer path launches a kernel: {layers_counts}")
    lm_counts = timed("tpu_model_lm", run_tpu_model_lm, cfg)
    d32_counts, resumed_counts, loaded_counts = timed(
        "tpu_model_lm_d32", run_tpu_model_lm_d32)
    d16_counts = timed("forward_d16", run_forward_d16)
    ex_counts = timed("http_serving_example", run_http_serving_example)
    spex_counts = timed("speculative_example", run_speculative_example)
    emit({"phase": "seconds", "phases": seconds,
          "total": time.perf_counter() - t_run})

    # max_abs_err: the largest error of any comparison this run made for
    # the kernel, f32 and bf16, at the main paths' shapes included; the
    # times as issued (ms, plain_ms, library_ms) and device time alone
    # (device_ms, library_device_ms)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "device_ms", "library_device_ms")
    # launches on each path, each path's counts set to 0 just before it
    paths = {"forward": fwd_counts, "serving": srv_counts,
             "train": train_counts, "tpu_model_lm": lm_counts,
             "tpu_model_lm_d32": d32_counts,
             "tpu_model_lm_d32_resumed_fit": resumed_counts,
             "tpu_model_lm_d32_loaded_predict": loaded_counts,
             "forward_d16": d16_counts, "keras_async": async_counts,
             "keras_persist": persist_counts,
             "keras_layers": layers_counts,
             "http_serving_example": ex_counts,
             "http_serving_flagship": flag_counts,
             "train_parity": parity_counts,
             **{f"speculative_flagship_{part}": c
                for part, c in spec.items()},
             "speculative_example": spex_counts,
             **{f"lm_d128_{part}": c for part, c in d128.items()},
             **{f"lm_d96_{part}": c for part, c in d96.items()},
             **{f"lm_d256_{part}": c for part, c in d256.items()},
             **{f"lm_moe_{part}": c for part, c in moe.items()},
             "int8_paged_flagship": int8_counts,
             "packed_flagship": packed_counts,
             "packed_example": packed_ex_counts}
    # every f32 dQ and dK/dV launch of every path on the strip bodies
    # (widths 16 and 32) or the tensor-core ones (64-256): none left on
    # the CUDA-core bodies they replaced
    for p, c in paths.items():
        for part in ("dq", "dkv"):
            key = f"flash_{part}_f32"
            require(c[key] == c[f"{key}_narrow"] + c[f"{key}_wide"],
                    f"{p}: every f32 {part} launch on the new bodies: {c}")

    # the main paths' paged engines: the flagship serving phases, the
    # speculative phase's interleaved engine, the flagship over int8
    # weights, the http_serving.py example
    paged_paths = (srv_counts, flag_counts,
                   spec["interleaved_paged_fused"], int8_counts, ex_counts)
    kernels = [
        {"name": "paged_decode", "route": "cuda",
         "source": "elephas_tpu_torch/csrc/paged_decode.cu",
         "replaces": "elephas_tpu/ops/paged_attention.py:59",
         "launches": sum(c["paged_decode"] for c in paged_paths),
         # the launches above by body: bf16 on the split body, f32 (the
         # http_serving.py engine) on the general one
         "split_launches": sum(c["paged_split"] for c in paged_paths),
         **{k: paged[k] for k in keys}},
        {"name": "flash_fwd", "route": "cuda",
         "source": "elephas_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "elephas_tpu/ops/pallas_attention.py:55",
         "launches": sum(c["flash_fwd"] for c in (
             fwd_counts, spec["distill"], spex_counts)),
         **{k: flash[k] for k in keys}},
        *({"name": f"flash_{part}", "route": "cuda",
           "source": "elephas_tpu_torch/csrc/flash_bwd.cu",
           "replaces": f"elephas_tpu/ops/pallas_attention.py:{line}",
           "launches": sum(c[f"flash_{part}"] for c in (
               train_counts, spec["distill"], spex_counts)),
           **{k: bwd[part][k] for k in keys}}
          for part, line in (("dq", 196), ("dkv", 243))),
    ]
    kernels[0]["general_launches"] = (kernels[0]["launches"]
                                      - kernels[0]["split_launches"])
    # the f32 launches on all paths by body (the CUDA-core dQ and dK/dV
    # bodies are gone: none may remain on them)
    kernels[1]["f32_launches_by_body"] = {
        "strip": sum(c["flash_fwd_f32_narrow"] for c in paths.values()),
        "cuda_cores": sum(c["flash_fwd_f32"] - c["flash_fwd_f32_narrow"]
                          for c in paths.values())}
    for entry in kernels[2:4]:
        key = entry["name"] + "_f32"
        entry["f32_launches_by_body"] = {
            "strip": sum(c[f"{key}_narrow"] for c in paths.values()),
            "tensor_cores": sum(c[f"{key}_wide"] for c in paths.values()),
            "cuda_cores_removed": sum(
                c[key] - c[f"{key}_narrow"] - c[f"{key}_wide"]
                for c in paths.values())}
    kernels[0]["split_body_registers"] = split_regs
    for entry, results in zip(kernels, (paged, flash, bwd["dq"],
                                        bwd["dkv"])):
        name = entry["name"]
        entry["launches_by_path"] = {p: c[name] for p, c in paths.items()}
        # each head dim's errors and times at the shape named beside them
        # (flash d 32 also at the training shape), and its instance's
        # launches on the paths that run it: d 64 the flagship's (as
        # above; the paged kernel's serving, http_serving_flagship and
        # the speculative phase's interleaved engine), d 32
        # tpu_model_lm_d32's three (the first fit with its predict and
        # evaluate, the resumed fit, the loaded model's predict), d 16
        # forward_d16, http_serving_example and speculative_example,
        # d 128 lm_d128's four (forward, serving, the f32 gradient, the
        # fit) and lm_moe's four (forward, serving, the f32 checks, the
        # fit), d 96 lm_d96's four, d 256 lm_d256's four; no driven
        # path runs d 80: its launches are null
        launches = {"16": d16_counts[name] + ex_counts[name]
                    + spex_counts[name],
                    "32": d32_counts[name] + resumed_counts[name]
                    + loaded_counts[name],
                    "64": entry["launches"] - ex_counts[name]
                    - spex_counts[name],
                    "128": sum(c[name] for c in (*d128.values(),
                                                 *moe.values())),
                    "96": sum(c[name] for c in d96.values()),
                    "256": sum(c[name] for c in d256.values())}
        if name == "paged_decode":
            split = {"16": d16_counts["paged_split"]
                     + ex_counts["paged_split"]
                     + spex_counts["paged_split"],
                     "32": d32_counts["paged_split"]
                     + resumed_counts["paged_split"]
                     + loaded_counts["paged_split"],
                     "64": srv_counts["paged_split"]
                     + flag_counts["paged_split"]
                     + spec["interleaved_paged_fused"]["paged_split"]
                     + int8_counts["paged_split"],
                     "128": sum(c["paged_split"] for c in (*d128.values(),
                                                          *moe.values())),
                     "96": sum(c["paged_split"] for c in d96.values()),
                     "256": sum(c["paged_split"]
                                for c in d256.values())}
        entry["by_head_dim"] = {
            d: {**{k: t[k] for k in (*keys, "shape", "body",
                                      "library_kernel", "exp_bound_ms")
                   if k in t},
                **({"launches": launches[d]} if d in launches
                   else {"launches": None, "driven_path": None}),
                **({"split_launches": split[d],
                    "general_launches": launches[d] - split[d]}
                   if name == "paged_decode" and d in launches else {}),
                **({"at_training_shape": {
                    k: t["at_training_shape"][k]
                    for k in (*keys, "shape", "exp_bound_ms")
                    if k in t["at_training_shape"]}}
                   if "at_training_shape" in t else {})}
            for d, t in results["by_head_dim"].items()}
        if name in WIDE_BODIES:
            entry["by_head_dim"]["128"].update(
                body=WIDE_BODIES[name][2], registers=wide[name])
        if name == "flash_fwd":
            for d, (_, _, body) in NARROW_BODIES.items():
                entry["by_head_dim"][d].update(body=body,
                                               registers=narrow[d])
        if name in ("flash_dq", "flash_dkv"):
            for d in ("16", "32"):
                key = f"{name[6:]}_{d}"
                entry["by_head_dim"][d].update(
                    body=NARROW_BWD_BODIES[key][2],
                    registers=narrow_bwd[key])
        # the f32 bodies at d 16 on the shapes of the paths that run them
        f32_paths = {"forward_d16": d16_counts,
                     "speculative_example": spex_counts}
        if name != "paged_decode":
            part = {"flash_fwd": "fwd", "flash_dq": "dq",
                    "flash_dkv": "dkv"}[name]
            entry["by_head_dim"]["16"]["f32_body"] = {
                p: {**f32[p][part], "launches": f32_paths[p][name],
                    "strip_body_launches":
                        f32_paths[p][f"{name}_f32_narrow"],
                    "registers": f32_narrow[f"{part}_16"]}
                for p in F32_TIMED if part in f32[p]}
            # the f32 bodies at 64-256 on the f32 checks that launch them
            wide_paths = {"train_parity": parity_counts,
                          "lm_d128_grad": d128["grad"],
                          "lm_d96_grad": d96["grad"],
                          "lm_d256_grad": d256["grad"]}
            for p, (dim, *_) in F32_WIDE_TIMED.items():
                c = wide_paths[p]
                entry["by_head_dim"][str(dim)].setdefault("f32_body", {})[
                    p] = {**f32["wide_bodies"][p][part],
                          "launches": c[name],
                          **({"f32_launches": c[f"{name}_f32"],
                              "tensor_core_body_launches":
                                  c[f"{name}_f32_wide"],
                              "registers": f32_wide[
                                  f"{part}_{body_width(dim)}"]}
                             if part != "fwd" else {})}
        else:
            # the general body in f32 at the decode shape of the path
            # that runs it
            entry["by_head_dim"]["16"]["f32_body"] = {
                "http_serving_example": {
                    **paged_f32, "launches": ex_counts[name]}}
        if name in WIDE_256_BODIES:
            require(launches["256"] > 0,
                    f"{name} launched its d 256 body on lm_d256")
            entry["by_head_dim"]["256"].update(
                body=WIDE_256_BODIES[name][2], registers=wide256[name])
        if name == "flash_dq":
            # the split body lm_d256's fit runs (one wave of q tiles)
            entry["by_head_dim"]["256"].update(
                one_wave_body=WIDE_256_BODIES["flash_dq_one_wave"][2],
                one_wave_registers=wide256["flash_dq_one_wave"])
        if name == "flash_dkv":
            entry["by_head_dim"]["256"]["split"] = (
                results["by_head_dim"]["256"]["split"])
        if name != "paged_decode":
            # d 96 and 80 on the 128-wide bodies, columns past the head
            # dim filled with zeros; the other multiples of 8 checked
            for d in map(str, FILLED_TIMED):
                entry["by_head_dim"][d]["body"] = (
                    "the 128-wide body, columns past the head dim "
                    "zero-filled by TMA")
            entry["checked_not_timed"] = {
                str(d): {"max_abs_err":
                         results["max_abs_err_by_head_dim"][f"d{d}"]}
                for d in FILLED_HEAD_DIMS if d not in FILLED_TIMED}
    # the d 256 dK/dV body's reduction, launched after its kernel wherever
    # the plan splits a k tile: on the main paths only in lm_d256's fit
    red = bwd["dkv"]["by_head_dim"]["256"]["split"]
    reduce_launches = sum(c["flash_dkv_reduce"] for c in d256.values())
    require(reduce_launches > 0, "lm_d256's fit ran the dK/dV reduction")
    kernels.append({
        "name": "flash_dkv_reduce", "route": "cuda",
        "source": "elephas_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "elephas_tpu/ops/pallas_attention.py:243",
        "replaces_note": "the f32 sum over the group's query heads and q "
                         "tiles that _dkv_kernel carries in scratch and "
                         "casts once (pallas_attention.py:295-298), where "
                         "the d 256 plan cuts it into chunks",
        "launches": reduce_launches,
        "launches_by_path": {p: c["flash_dkv_reduce"]
                             for p, c in paths.items()},
        "shape": bwd["dkv"]["by_head_dim"]["256"]["shape"],
        "split": {k: v for k, v in red.items() if k != "reduce"},
        **red["reduce"]})
    print(nvidia_smi(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
