"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: they need a CUDA device and the CUDA toolkit, and skip
elsewhere. On a machine with the card:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

The kernels are built from ``elephas_tpu_torch/csrc`` at first use.
The flash kernels are held at head dim 64 over every case and at head
dims 16 and 32 (the repo's other configurations) and 128 (most published
LMs) over the GQA, window, ragged and offset cases, and at 128 over the
edges of its 128-key tiles and dQ's 64-key tiles and ping-pong turns
(and dQ at 96 on them); the forward at 16 and 32 over the edges of its
narrow body (192-row q tiles of three 64-row warpgroups, 128-key
tiles, pairs of q tiles past one wave of the SMs); in f32 at 8-32 the
forward's, dQ's and dK/dV's strip bodies (a warp a strip of 16 rows,
3xTF32 products) over lengths of 1 to 1024, windows, GQA 1/2/4, ragged
and ring-hop offsets, bit-equal reruns and unaligned operands (which the
wrappers clone); in f32 at 40-256 dQ's and dK/dV's tensor-core bodies
(CTAs of strips sharing a ring of tiles, dK/dV on a plan whose split k
tiles a reduction sums) over GQA 1/4/8, windows, ragged lengths, Sq !=
Sk both ways, one query row, ring hops and S 2048, with bit-equal reruns
of the split walk; at 256 (Gemma-2B's)
over the same cases and
the edges of its 64-key tiles and of dQ's two bodies (64-row q tiles
at one wave of the SMs, 32-key tiles past it); at head dims 8, 24,
40, 72, 80, 96, 120, 136, 192 and 248, which run a wider body on
zero-filled columns, over the same cases, with a sentinel check that no
byte past a row's head_dim values is written; the paged kernel at
head dims 16, 32, 64, 128 and 256 and at 80, 96 and 136 (a wider body's
chunks past the head dim idle) and block sizes 8 and 16 over every case
(bf16 on its split body with groups of 1, 2, 4 and 8, f32 on its
general body), at 128 with Llama-2-70B's 64 query heads over 8 kv heads
and at 256 with Gemma-2B's 8 query heads over 1 kv head; a 2-layer LM
at Gemma-2B's widths on the flash kernels against the plain path in f32. The Keras layers, optimizers and schedules
ported with Conv2D (no kernel of the repo's: cuDNN, cuBLAS and torch
loops) are held against the CPU, TF32 off: layers within 1e-4 of each
array's scale, optimizers within 1e-5 of scale, a BatchNormalization fit within
1e-5, and the LSTM example's first epoch (cuDNN's LSTM against the CPU
loop) within 1e-4 in loss and 1e-3 in weights. The speculative
slice on CUDA tensors: greedy ``speculative_generate`` (f32) against
``generate`` and the CPU, the distill step on the flash kernels at head
dims 16 and 64 against the CPU within 1e-4, the interleaved paged engine
on the paged kernel's split body (bf16, equal to the same engine
prefilling at admission) and, in f32, the interleaved and speculative
paged engines against the CPU. Tolerances: f32 kernels within 1e-4 of the f32 plain version (another
summation order); bf16 kernels within 2e-2 of the f32 plain version on
the same bf16-rounded inputs (the softmax weights enter the P.V product
in bf16, as in the TPU kernels).
"""
import dataclasses
import subprocess
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def no_tf32():
    """f32 matmuls and convolutions in full f32 for the test's length."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


_FWD_CASES = {
    # (B, H, KVH, Sq, Sk, causal, window, q_offset, k_offset)
    "causal": (2, 4, 4, 130, 130, True, None, 0, 0),
    "noncausal": (2, 4, 4, 130, 70, False, None, 0, 0),
    "gqa": (2, 4, 1, 128, 128, True, None, 0, 0),
    "window": (2, 4, 2, 200, 200, True, 33, 0, 0),
    "ragged": (1, 4, 4, 77, 77, True, None, 0, 0),
    "hop": (1, 4, 4, 64, 64, True, None, 128, 64),
    # the tile edges of the TMA-fed bodies: one partial K tile, a single
    # query row, lengths off every tile multiple, GQA 4 with a ragged
    # length, a window narrower than a tile, a ragged past hop
    "sk_partial": (2, 4, 4, 130, 40, False, None, 0, 0),
    "sq_one": (2, 4, 2, 1, 200, True, None, 199, 0),
    "ragged_191_257": (2, 4, 4, 191, 257, True, None, 66, 0),
    "gqa4_ragged": (2, 8, 2, 191, 191, True, None, 0, 0),
    "window_17": (2, 4, 4, 200, 200, True, 17, 0, 0),
    "hop_ragged": (1, 4, 4, 100, 150, True, None, 150, 50),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(_FWD_CASES))
def test_flash_kernel_matches_plain(cuda, case, dtype):
    from elephas_tpu_torch.ops.flash_attention import (flash_forward,
                                                       flash_forward_plain)
    b, h, kvh, sq, sk, causal, window, qo, ko = _FWD_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((b, h, sq, 64), generator=gen, device=cuda).to(dtype)
    k = torch.randn((b, kvh, sk, 64), generator=gen, device=cuda).to(dtype)
    v = torch.randn((b, kvh, sk, 64), generator=gen, device=cuda).to(dtype)
    before = flash_forward.launches
    o, lse = flash_forward(q, k, v, qo, ko, causal, window)
    assert flash_forward.launches == before + 1
    o_ref, lse_ref = flash_forward_plain(q.float(), k.float(), v.float(),
                                         qo, ko, causal, window)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert o.dtype == dtype
    torch.testing.assert_close(o.float(), o_ref, atol=tol, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)


_BWD_CASES = {
    # (B, H, KVH, Sq, Sk, causal, window, q_offset, k_offset)
    "causal": (2, 4, 4, 130, 130, True, None, 0, 0),
    "noncausal": (2, 4, 4, 130, 70, False, None, 0, 0),
    "gqa": (2, 4, 1, 128, 128, True, None, 0, 0),
    "window": (2, 4, 2, 200, 200, True, 33, 0, 0),
    "ragged": (1, 4, 4, 77, 77, True, None, 0, 0),
    "hop_past": (1, 4, 4, 64, 100, True, None, 128, 0),
    "hop_future": (1, 4, 2, 64, 64, True, None, 0, 64),
    "sk_partial": (2, 4, 4, 130, 40, False, None, 0, 0),
    "sq_one": (2, 4, 2, 1, 200, True, None, 199, 0),
    "ragged_191_257": (2, 4, 4, 191, 257, True, None, 66, 0),
    "gqa4_ragged": (2, 8, 2, 191, 191, True, None, 0, 0),
    "window_17": (2, 4, 4, 200, 200, True, 17, 0, 0),
    # the dQ body's 128-row q tiles: one row past a tile, one row short
    "sq_129": (2, 4, 2, 129, 129, True, None, 0, 0),
    "sq_255": (1, 4, 4, 255, 300, True, None, 45, 0),
    # the examples/transformer_tpumodel.py LM's fit batch (H 8, S 128)
    "tpumodel_fit": (16, 8, 8, 128, 128, True, None, 0, 0),
    # Mistral-7B's attention shape cut in length: H 32 over KVH 8 (groups
    # of 4), a window narrower than the sequence, lengths off every tile
    "gqa4_window": (1, 32, 8, 300, 300, True, 100, 0, 0),
}


def _check_backward(cuda, case, dtype, d, cases=_BWD_CASES):
    from elephas_tpu_torch.ops.flash_attention import (flash_backward,
                                                       flash_backward_plain,
                                                       flash_forward_plain)
    b, h, kvh, sq, sk, causal, window, qo, ko = cases[case]
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, g = (torch.randn((b, h, sq, d), generator=gen, device=cuda)
            .to(dtype) for _ in range(2))
    k, v = (torch.randn((b, kvh, sk, d), generator=gen, device=cuda)
            .to(dtype) for _ in range(2))
    o, lse = flash_forward_plain(q.float(), k.float(), v.float(), qo, ko,
                                 causal, window)
    delta = (g.float() * o).sum(-1)
    before = (flash_backward.dq_launches, flash_backward.dkv_launches)
    out = flash_backward(q, k, v, g, lse, delta, qo, ko, causal, window)
    torch.cuda.synchronize()
    assert (flash_backward.dq_launches, flash_backward.dkv_launches) == (
        before[0] + 1, before[1] + 1)
    ref = flash_backward_plain(q.float(), k.float(), v.float(), g.float(),
                               lse, delta, qo, ko, causal, window)
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    for name, got, want, like in zip(("dq", "dk", "dv"), out, ref,
                                     (q, k, v)):
        assert got.dtype == dtype and got.shape == like.shape, name
        scale = float(want.abs().max())
        if case == "hop_future":
            assert scale == 0.0 and bool((got == 0).all()), name
            continue
        err = float((got.float() - want).abs().max())
        assert err <= rel * scale, f"{name}: {err} > {rel} * {scale}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(_BWD_CASES))
def test_flash_backward_kernels_match_plain(cuda, case, dtype):
    """dQ and dK/dV against the f32 plain version on the same (rounded)
    inputs and the same lse/delta; errors relative to max|ref| (f32
    1e-4: another summation order; bf16 2e-2: P and dS enter their
    products in bf16, as in the TPU kernels)."""
    _check_backward(cuda, case, dtype, 64)


# the GQA, window, ragged and offset cases and the head-dim-32 LM's
# batch, run at head dims 16, 32 and 128
_SMALL_D_CASES = ["gqa", "window", "window_17", "ragged", "ragged_191_257",
                  "gqa4_ragged", "sq_one", "sq_129", "hop_past",
                  "hop_future", "noncausal", "tpumodel_fit", "gqa4_window"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", _SMALL_D_CASES)
@pytest.mark.parametrize("head_dim", [16, 32, 128])
def test_flash_kernels_at_small_head_dims_match_plain(cuda, no_tf32,
                                                      head_dim, case,
                                                      dtype):
    """The forward, dQ and dK/dV kernels at head dims 16, 32 and 128 (the
    head dims besides the flagship's 64) against their plain versions,
    with the head-dim-64 tests' tolerances."""
    _check_all_three(cuda, head_dim, case, dtype)


def _check_all_three(cuda, head_dim, case, dtype, cases=_BWD_CASES):
    from elephas_tpu_torch.ops.flash_attention import (flash_forward,
                                                       flash_forward_plain)
    b, h, kvh, sq, sk, causal, window, qo, ko = cases[case]
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((b, h, sq, head_dim), generator=gen,
                    device=cuda).to(dtype)
    k, v = (torch.randn((b, kvh, sk, head_dim), generator=gen,
                        device=cuda).to(dtype) for _ in range(2))
    before = flash_forward.launches
    o, lse = flash_forward(q, k, v, qo, ko, causal, window)
    assert flash_forward.launches == before + 1
    o_ref, lse_ref = flash_forward_plain(q.float(), k.float(), v.float(),
                                         qo, ko, causal, window)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert o.dtype == dtype and o.shape == q.shape
    torch.testing.assert_close(o.float(), o_ref, atol=tol, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)
    _check_backward(cuda, case, dtype, head_dim, cases)


# the edges of the head-dim-256 bodies' tiles (64 keys in the forward's
# K/V tiles, the dK/dV CTA and dQ's split body, 32 in dQ's ping-pong
# body; two warpgroups of 64 query rows in the forward and dQ's
# ping-pong body, one head-dim half each in dK/dV and dQ's split body):
# key lengths one past a tile and one short; a query tile whose second
# warpgroup holds one row; a window edge inside a tile; ring hops;
# Gemma-2B's 8 query heads over 1 kv head, ragged and windowed
_D256_EDGE_CASES = {
    # (B, H, KVH, Sq, Sk, causal, window, q_offset, k_offset)
    "sk_33": (2, 4, 4, 33, 33, True, None, 0, 0),
    "sk_65_noncausal": (1, 4, 2, 100, 65, False, None, 0, 0),
    "sk_127": (1, 4, 4, 127, 127, True, None, 0, 0),
    "sq_65": (2, 4, 4, 65, 300, True, None, 235, 0),
    "window_65": (1, 4, 2, 300, 300, True, 65, 0, 0),
    "hop_crossing": (1, 4, 4, 200, 200, True, None, 256, 128),
    "hop_first_rows_dead": (1, 4, 4, 150, 150, True, None, 100, 164),
    "mqa8_ragged": (1, 8, 1, 191, 191, True, None, 0, 0),
    "mqa8_window": (2, 8, 1, 300, 300, True, 100, 0, 0),
    # the dK/dV plan's groups of 2, 4, 8 and 16 on ragged lengths, a
    # window and a ring hop: split and unsplit k tiles, chunks that start
    # inside a query head's run of q tiles
    "gqa2_ragged": (2, 8, 4, 333, 333, True, None, 0, 0),
    "gqa4_window": (1, 16, 4, 517, 517, True, 200, 0, 0),
    "mqa8_hop": (1, 8, 1, 300, 300, True, None, 400, 100),
    "mqa16_ragged": (1, 16, 1, 700, 700, True, None, 0, 0),
    # dQ's split body (where 128-row q tiles fill at most one wave of the
    # SMs): its 64-row q tiles and 64-key K/V tiles: a key length one
    # short of a tile, a query length one short of two tiles, three live
    # tiles, a window edge inside a tile, a ring hop whose first 70 query
    # rows see no key, and Gemma-2B's fit shape (256 CTAs of 1 to 16
    # tiles, heaviest first: more than one wave)
    "sk_63": (2, 4, 4, 63, 63, True, None, 0, 0),
    "sq_127": (1, 4, 2, 127, 200, True, None, 73, 0),
    "odd_live_tiles": (1, 4, 4, 100, 190, False, None, 0, 0),
    "window_33": (1, 4, 2, 300, 300, True, 33, 0, 0),
    "hop_rows_dead_64": (1, 4, 4, 150, 200, True, None, 0, 70),
    "mqa8_fit": (2, 8, 1, 1024, 1024, True, None, 0, 0),
    # dQ's ping-pong body (more 128-row q tiles than an H100's 132 SMs:
    # 136 heads or more): its 32-key tiles and ping-pong turns: a key
    # length one past a tile, three live tiles, a query length that
    # leaves the second warpgroup one row or none (GQA 4/1), a window
    # edge inside a tile, a ring hop whose first rows see no key, and
    # MQA 8/1 over 17 batch rows
    "pp_sk_33": (1, 136, 136, 33, 33, True, None, 0, 0),
    "pp_odd_live_tiles": (1, 136, 136, 100, 95, False, None, 0, 0),
    "pp_sq_65": (1, 136, 34, 65, 300, True, None, 235, 0),
    "pp_sq_64": (1, 136, 136, 64, 300, True, None, 236, 0),
    "pp_window_33": (1, 136, 136, 150, 150, True, 33, 0, 0),
    "pp_hop_rows_dead": (1, 136, 136, 150, 200, True, None, 0, 70),
    "pp_mqa8": (17, 8, 1, 191, 191, True, None, 0, 0),
}
_D256_CASES = {**{c: _BWD_CASES[c] for c in _SMALL_D_CASES},
               **_D256_EDGE_CASES}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(_D256_CASES))
def test_flash_kernels_at_head_dim_256_match_plain(cuda, no_tf32, case,
                                                   dtype):
    """The forward, dQ and dK/dV kernels at head dim 256 (the 256-wide
    bodies) against their plain versions over the small head dims' cases
    and the edges of the 256 bodies' tiles, with the head-dim-64 tests'
    tolerances."""
    _check_all_three(cuda, 256, case, dtype, _D256_CASES)


@pytest.mark.parametrize("case", ["mqa8_ragged", "mqa8_window", "sq_65",
                                  "hop_first_rows_dead", "gqa2_ragged",
                                  "mqa16_ragged", "mqa8_fit",
                                  "odd_live_tiles", "window_33",
                                  "hop_rows_dead_64", "pp_mqa8",
                                  "pp_sq_65", "pp_window_33"])
def test_flash_kernels_are_bit_reproducible_at_head_dim_256(cuda, case):
    """Two launches each of the forward, dQ and dK/dV kernels at head
    dim 256 on the same bf16 inputs give the same bits (no atomics; in
    dK/dV each warpgroup owns its half of the head dim, and a split k
    tile's partials are summed in chunk order: the split path, as the
    reduction's launch count shows, wherever the plan splits)."""
    from elephas_tpu_torch.ops.flash_attention import (dkv_plan,
                                                       flash_backward,
                                                       flash_dkv, flash_dq,
                                                       flash_forward,
                                                       flash_forward_plain)
    b, h, kvh, sq, sk, causal, window, qo, ko = _D256_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(6)
    q, g = (torch.randn((b, h, sq, 256), generator=gen, device=cuda)
            .bfloat16() for _ in range(2))
    k, v = (torch.randn((b, kvh, sk, 256), generator=gen, device=cuda)
            .bfloat16() for _ in range(2))
    (o1, l1), (o2, l2) = (flash_forward(q, k, v, qo, ko, causal, window)
                          for _ in range(2))
    assert torch.equal(o1.view(torch.int16), o2.view(torch.int16))
    assert torch.equal(l1, l2)
    o, lse = flash_forward_plain(q.float(), k.float(), v.float(), qo, ko,
                                 causal, window)
    args = (q, k, v, g, lse, (g.float() * o).sum(-1), qo, ko, causal,
            window)
    first, second = flash_dq(*args), flash_dq(*args)
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))
    before = flash_backward.dkv_reduce_launches
    for a, b_ in zip(flash_dkv(*args), flash_dkv(*args)):
        assert torch.equal(a.view(torch.int16), b_.view(torch.int16))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = dkv_plan(b, h, kvh, sq, sk, qo, ko, causal, window, sms)
    split = 2 if plan.reduce else 0
    assert flash_backward.dkv_reduce_launches == before + split
    if case in ("mqa8_ragged", "gqa2_ragged", "mqa16_ragged"):
        assert split, f"{case} runs the split path"


# the edges of the head-dim-128 bodies' tiles (128 keys in the forward's
# K/V tiles and dK/dV's CTA, two warpgroups of 64 query or key rows):
# key lengths one past a tile, inside one and one short of two; query
# lengths where the second warpgroup holds one row or none; window edges
# inside a tile and one past it; ring hops whose diagonal crosses a tile
# and whose first query rows see no key; GQA 4/1 and 8/1. Then the dQ
# body's 64-key tiles and ping-pong turns: key lengths one short of a
# tile and one past it, three live tiles (the turns of an odd count), a
# query length that leaves the second warpgroup no row, a window edge
# inside a 64-key tile, a ring hop whose first 70 query rows see no key,
# and 4 query heads over 1 kv head
_D128_EDGE_CASES = {
    # (B, H, KVH, Sq, Sk, causal, window, q_offset, k_offset)
    "sk_129": (2, 4, 4, 129, 129, True, None, 0, 0),
    "sk_191": (1, 4, 4, 191, 191, True, None, 0, 0),
    "sk_255_noncausal": (1, 4, 2, 100, 255, False, None, 0, 0),
    "sq_65": (2, 4, 4, 65, 300, True, None, 235, 0),
    "sq_129": (1, 4, 4, 129, 129, True, None, 0, 0),
    "window_100": (1, 4, 4, 400, 400, True, 100, 0, 0),
    "window_129": (1, 4, 2, 300, 300, True, 129, 0, 0),
    "hop_crossing": (1, 4, 4, 200, 200, True, None, 256, 128),
    "hop_first_rows_dead": (1, 4, 4, 150, 150, True, None, 100, 164),
    "gqa4": (2, 8, 2, 255, 255, True, None, 0, 0),
    "gqa8": (1, 8, 1, 191, 191, True, None, 0, 0),
    "sk_63": (2, 4, 4, 63, 63, True, None, 0, 0),
    "sk_65": (2, 4, 2, 65, 65, True, None, 0, 0),
    "odd_live_tiles": (1, 4, 4, 100, 190, False, None, 0, 0),
    "sq_64": (2, 4, 4, 64, 300, True, None, 236, 0),
    "window_33": (1, 4, 4, 300, 300, True, 33, 0, 0),
    "hop_rows_dead_64": (1, 4, 4, 150, 200, True, None, 0, 70),
    "gqa4_1": (2, 4, 1, 200, 200, True, None, 0, 0),
}


def _d128_forward_inputs(case, dtype, device, seed=7):
    b, h, kvh, sq, sk, causal, window, qo, ko = _D128_EDGE_CASES[case]
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((b, h, sq, 128), generator=gen, device=device).to(dtype)
    k, v = (torch.randn((b, kvh, sk, 128), generator=gen, device=device)
            .to(dtype) for _ in range(2))
    return q, k, v, qo, ko, causal, window


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(_D128_EDGE_CASES))
def test_flash_fwd_at_head_dim_128_tile_edges_matches_plain(cuda, no_tf32,
                                                            case, dtype):
    """The forward kernel at head dim 128 against its plain version where
    its 128-key tiles and 64-row warpgroups meet the causal diagonal,
    the window's edge, ragged lengths and ring-hop offsets: O within
    1e-4 (f32) or 2e-2 (bf16) and the LSE within 1e-3 of the f32 plain
    version, O = 0 and LSE ~ -1e30 on rows that see no key."""
    from elephas_tpu_torch.ops.flash_attention import (flash_forward,
                                                       flash_forward_plain)
    q, k, v, qo, ko, causal, window = _d128_forward_inputs(case, dtype,
                                                            cuda)
    before = flash_forward.launches
    o, lse = flash_forward(q, k, v, qo, ko, causal, window)
    assert flash_forward.launches == before + 1
    o_ref, lse_ref = flash_forward_plain(q.float(), k.float(), v.float(),
                                         qo, ko, causal, window)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert o.dtype == dtype and o.shape == q.shape
    torch.testing.assert_close(o.float(), o_ref, atol=tol, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)
    dead = lse_ref < -1e29
    assert bool((lse[dead] < -1e29).all()) and bool((o[dead] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(_D128_EDGE_CASES))
def test_flash_dkv_at_head_dim_128_tile_edges_matches_plain(cuda, no_tf32,
                                                            case, dtype):
    """dK/dV (and dQ) at head dim 128 over the same edges, with the
    head-dim-64 tests' tolerances."""
    _check_backward(cuda, case, dtype, 128, _D128_EDGE_CASES)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["gqa4_1", "odd_live_tiles", "sq_64",
                                  "sq_65", "window_33", "hop_rows_dead_64",
                                  "sk_65"])
def test_flash_dq_at_head_dim_96_on_the_128_body_matches_plain(
        cuda, no_tf32, case, dtype):
    """dQ (and dK/dV) at head dim 96 (Phi-3-mini's, on the 128-wide
    bodies' zero-filled columns) over the dQ body's tile edges, 4 query
    heads over 1 kv head among them, with the head-dim-64 tests'
    tolerances."""
    _check_backward(cuda, case, dtype, 96, _D128_EDGE_CASES)


@pytest.mark.parametrize("case", ["gqa4", "sq_65", "window_100",
                                  "hop_first_rows_dead"])
def test_flash_fwd_kernel_is_bit_reproducible_at_head_dim_128(cuda, case):
    """Two forward launches at head dim 128 on the same bf16 inputs give
    the same bits (the ping-pong turns order issue, not arithmetic)."""
    from elephas_tpu_torch.ops.flash_attention import flash_forward
    args = _d128_forward_inputs(case, torch.bfloat16, cuda)
    (o1, l1), (o2, l2) = flash_forward(*args), flash_forward(*args)
    assert torch.equal(o1.view(torch.int16), o2.view(torch.int16))
    assert torch.equal(l1, l2)


# the edges of the narrow forward body's tiles (head dims 8-32: 192-row
# q tiles of three warpgroups of 64 rows, 128-key K/V tiles, each
# warpgroup walking its own run of the live tiles, persistent pairs of q
# tiles past one wave of the SMs): a second q tile of one row, a q tile
# whose third warpgroup holds one row, one whose second holds one row and
# third none, a key length one past a tile, a window edge inside a tile,
# ring hops whose diagonal crosses a tile and whose first rows see no
# key, GQA 8/1 and 4/1 on ragged lengths, non-causal ragged lengths; then
# past one wave (more than 132 q tiles): pairs of q tiles with a ragged
# last tile under GQA 4/1, an odd middle tile under a window. The narrow
# backward bodies take the same 192-row tiles as q tiles (dQ, 64-key K/V
# tiles) and as k tiles (dK/dV, 64-row Q/dO tiles), each warpgroup 64 of
# the rows: so also a third k tile of one key row, a k tile whose second
# warpgroup holds one key row and third none, a ring hop whose last key
# rows (and a whole k tile) see no query, and past one wave of k tiles
# too: pairs with a ragged last tile, causal and not
_NARROW_EDGE_CASES = {
    # (B, H, KVH, Sq, Sk, causal, window, q_offset, k_offset)
    "sq_193": (2, 4, 4, 193, 193, True, None, 0, 0),
    "sq_129": (1, 4, 4, 129, 129, True, None, 0, 0),
    "sq_65": (2, 4, 4, 65, 300, True, None, 235, 0),
    "sk_129": (1, 4, 2, 200, 129, False, None, 0, 0),
    "window_129": (1, 4, 2, 300, 300, True, 129, 0, 0),
    "hop_crossing": (1, 4, 4, 200, 200, True, None, 256, 128),
    "hop_first_rows_dead": (1, 4, 4, 150, 150, True, None, 100, 164),
    "gqa8_ragged": (1, 8, 1, 391, 391, True, None, 0, 0),
    "gqa4_ragged": (2, 4, 1, 200, 200, True, None, 0, 0),
    "noncausal_ragged": (1, 4, 4, 500, 333, False, None, 0, 0),
    "paired_gqa4_ragged": (4, 16, 4, 1000, 1000, True, None, 0, 0),
    "paired_window": (4, 16, 16, 500, 500, True, 129, 0, 0),
    "sk_385": (1, 4, 4, 385, 385, True, None, 0, 0),
    "sk_65": (1, 4, 2, 300, 65, False, None, 0, 0),
    "hop_keys_dead": (1, 4, 4, 200, 300, True, None, 0, 150),
    "paired_ragged_1000": (2, 16, 16, 1000, 1000, True, None, 0, 0),
    "paired_noncausal": (2, 32, 32, 450, 450, False, None, 0, 0),
}


def _narrow_forward_inputs(case, dtype, device, d, seed=8):
    b, h, kvh, sq, sk, causal, window, qo, ko = _NARROW_EDGE_CASES[case]
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((b, h, sq, d), generator=gen, device=device).to(dtype)
    k, v = (torch.randn((b, kvh, sk, d), generator=gen, device=device)
            .to(dtype) for _ in range(2))
    return q, k, v, qo, ko, causal, window


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(_NARROW_EDGE_CASES))
@pytest.mark.parametrize("head_dim", [16, 32])
def test_flash_fwd_at_narrow_head_dims_tile_edges_matches_plain(
        cuda, no_tf32, head_dim, case, dtype):
    """The forward kernel at head dims 16 and 32 (bf16: the narrow body;
    f32: the f32 body) against its plain version where the narrow body's
    192-row q tiles, 64-row warpgroups and 128-key tiles meet the causal
    diagonal, the window's edge, ragged lengths and ring-hop offsets: O
    within 1e-4 (f32) or 2e-2 (bf16) and the LSE within 1e-3 of the f32
    plain version, O = 0 and LSE ~ -1e30 on rows that see no key."""
    from elephas_tpu_torch.ops.flash_attention import (flash_forward,
                                                       flash_forward_plain)
    q, k, v, qo, ko, causal, window = _narrow_forward_inputs(
        case, dtype, cuda, head_dim)
    before = flash_forward.launches
    o, lse = flash_forward(q, k, v, qo, ko, causal, window)
    assert flash_forward.launches == before + 1
    o_ref, lse_ref = flash_forward_plain(q.float(), k.float(), v.float(),
                                         qo, ko, causal, window)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert o.dtype == dtype and o.shape == q.shape
    torch.testing.assert_close(o.float(), o_ref, atol=tol, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)
    dead = lse_ref < -1e29
    assert bool((lse[dead] < -1e29).all()) and bool((o[dead] == 0).all())


@pytest.mark.parametrize("case", ["sq_193", "sq_65", "window_129",
                                  "hop_first_rows_dead",
                                  "paired_gqa4_ragged", "paired_window"])
def test_flash_fwd_kernel_is_bit_reproducible_at_head_dim_32(cuda, case):
    """Two forward launches at head dim 32 on the same bf16 inputs give
    the same bits (the narrow body: no atomics, and its warpgroups' free
    running orders issue, not arithmetic)."""
    from elephas_tpu_torch.ops.flash_attention import flash_forward
    args = _narrow_forward_inputs(case, torch.bfloat16, cuda, 32)
    (o1, l1), (o2, l2) = flash_forward(*args), flash_forward(*args)
    assert torch.equal(o1.view(torch.int16), o2.view(torch.int16))
    assert torch.equal(l1, l2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(_NARROW_EDGE_CASES))
@pytest.mark.parametrize("head_dim", [16, 32])
def test_flash_bwd_at_narrow_head_dims_tile_edges_matches_plain(
        cuda, no_tf32, head_dim, case, dtype):
    """dQ and dK/dV at head dims 16 and 32 (bf16: the narrow bodies; f32:
    the f32 bodies) against their plain versions where the narrow bodies'
    192-row q and k tiles, 64-row warpgroups and 64-row streamed tiles
    meet the causal diagonal, the window's edge, ragged lengths and
    ring-hop offsets, one CTA a tile and in pairs past one wave, with the
    head-dim-64 tests' tolerances."""
    _check_backward(cuda, case, dtype, head_dim, _NARROW_EDGE_CASES)


@pytest.mark.parametrize("case", ["sq_193", "sk_385", "sk_65",
                                  "window_129", "hop_keys_dead",
                                  "gqa8_ragged", "paired_ragged_1000",
                                  "paired_noncausal", "paired_window"])
def test_flash_bwd_kernels_are_bit_reproducible_at_head_dim_32(cuda, case):
    """Two dQ and two dK/dV launches at head dim 32 on the same bf16
    inputs give the same bits (the narrow bodies: no atomics, each
    warpgroup owns its rows and writes them alone, and its free running
    orders issue, not arithmetic)."""
    from elephas_tpu_torch.ops.flash_attention import flash_dq
    args = _bwd_args(case, 6, cuda, 32, _NARROW_EDGE_CASES)
    first, second = flash_dq(*args), flash_dq(*args)
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))
    _assert_dkv_reproducible(args)


# the f32 strip bodies of the forward and dK/dV at head dims 8-32 (a warp
# a strip of 16 query or key rows, walked in steps of 8 keys or queries
# through a ring of two 64-row stages): lengths of 1, 7, 33, 96 and 1024
# (one step, a ragged step, a ragged strip, a walk of two stages, many
# stages), the main path's shapes (speculative_example's B 8 x H 4 x S
# 32, forward_d16's B 4 x H 4 x S 96), causal and full, Sq != Sk both
# ways, windows narrower than a step and than a stage, GQA groups of 1, 2
# and 4, ring hops whose first query rows (and last keys) meet nothing, a
# hop wholly in the past and one wholly in the future
_F32_STRIP_CASES = {
    # (B, H, KVH, Sq, Sk, causal, window, q_offset, k_offset)
    "s1": (2, 4, 4, 1, 1, True, None, 0, 0),
    "s7_gqa2": (2, 4, 2, 7, 7, True, None, 0, 0),
    "s33_gqa4": (2, 4, 1, 33, 33, True, None, 0, 0),
    "speculative_example": (8, 4, 4, 32, 32, True, None, 0, 0),
    "forward_d16": (4, 4, 4, 96, 96, True, None, 0, 0),
    "s1024_gqa2": (1, 4, 2, 1024, 1024, True, None, 0, 0),
    "full_33_96": (2, 4, 4, 33, 96, False, None, 0, 0),
    "full_96_7_gqa2": (1, 4, 2, 96, 7, False, None, 0, 0),
    "causal_50_130": (2, 4, 2, 50, 130, True, None, 80, 0),
    "window_5": (2, 4, 4, 96, 96, True, 5, 0, 0),
    "window_17": (2, 4, 4, 200, 200, True, 17, 0, 0),
    "window_full_9": (1, 4, 4, 100, 100, False, 9, 0, 0),
    "window_100_gqa4": (1, 8, 2, 1024, 1024, True, 100, 0, 0),
    "hop_rows_dead": (1, 4, 4, 40, 50, True, None, 0, 20),
    "hop_window": (2, 4, 1, 70, 90, True, 30, 50, 0),
    "hop_past": (1, 4, 2, 33, 70, True, None, 100, 0),
    "hop_future": (1, 4, 4, 33, 33, True, None, 0, 64),
}


# the cases where every query meets exactly one key
_ONE_KEY_CASES = {"s1"}


def _f32_strip_inputs(case, device, d, seed=12):
    b, h, kvh, sq, sk, causal, window, qo, ko = _F32_STRIP_CASES[case]
    gen = torch.Generator(device=device).manual_seed(seed)
    q, g = (torch.randn((b, h, sq, d), generator=gen, device=device)
            for _ in range(2))
    k, v = (torch.randn((b, kvh, sk, d), generator=gen, device=device)
            for _ in range(2))
    return q, k, v, g, (qo, ko, causal, window)


@pytest.mark.parametrize("case", sorted(_F32_STRIP_CASES))
@pytest.mark.parametrize("head_dim", [8, 16, 24, 32])
def test_flash_f32_strip_bodies_match_plain(cuda, no_tf32, head_dim, case):
    """The f32 forward, dQ and dK/dV at head dims 8-32 (the strip bodies,
    as the wrappers' per-body counters show) against their plain
    versions: O and the LSE within 1e-4, dQ, dK and dV within 1e-4 of
    max|ref| (3xTF32 products, another summation order); a row that
    meets no key keeps O = 0 and LSE ~ -1e30, and a k/v shard no query
    meets gets dQ = dK = dV = 0."""
    from elephas_tpu_torch.ops.flash_attention import (flash_backward,
                                                       flash_dkv,
                                                       flash_dkv_plain,
                                                       flash_dq,
                                                       flash_dq_plain,
                                                       flash_forward,
                                                       flash_forward_plain)
    q, k, v, g, offs = _f32_strip_inputs(case, cuda, head_dim)
    before = (flash_forward.launches, flash_forward.f32_narrow_launches,
              flash_backward.dq_launches,
              flash_backward.dq_f32_narrow_launches,
              flash_backward.dkv_launches,
              flash_backward.dkv_f32_narrow_launches)
    o, lse = flash_forward(q, k, v, *offs)
    o_ref, lse_ref = flash_forward_plain(q, k, v, *offs)
    torch.testing.assert_close(o, o_ref, atol=1e-4, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=0)
    dead = lse_ref < -1e29
    assert bool((lse[dead] < -1e29).all()) and bool((o[dead] == 0).all())
    delta = (g * o_ref).sum(-1)
    args = (q, k, v, g, lse_ref, delta, *offs)
    got = (flash_dq(*args), *flash_dkv(*args))
    torch.cuda.synchronize()
    assert (flash_forward.launches, flash_forward.f32_narrow_launches,
            flash_backward.dq_launches,
            flash_backward.dq_f32_narrow_launches,
            flash_backward.dkv_launches,
            flash_backward.dkv_f32_narrow_launches) == tuple(
                n + 1 for n in before)
    want = (flash_dq_plain(*args), *flash_dkv_plain(*args))
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and a.shape == w.shape, name
        scale = float(w.abs().max())
        if case == "hop_future":
            assert scale == 0.0 and bool((a == 0).all()), name
            continue
        if case in _ONE_KEY_CASES and name in ("dq", "dk"):
            # each query meets one key: its softmax has no gradient, dQ and
            # dK are 0, and both sides hold only the f32 rounding of dP -
            # delta (about 1e-7 of the terms): held against dV's scale
            scale = float(want[2].abs().max())
        err = float((a - w).abs().max())
        assert err <= 1e-4 * scale, f"{name}: {err} > 1e-4 * {scale}"


@pytest.mark.parametrize("case", ["s33_gqa4", "forward_d16", "s1024_gqa2",
                                  "window_17", "hop_rows_dead"])
@pytest.mark.parametrize("head_dim", [16, 32])
def test_flash_f32_strip_bodies_are_bit_reproducible(cuda, head_dim, case):
    """Two launches each of the f32 forward, dQ and dK/dV strip bodies on
    the same inputs give the same bits (no atomics; a warp owns its rows
    and walks them in one order)."""
    from elephas_tpu_torch.ops.flash_attention import (flash_dkv,
                                                       flash_dq,
                                                       flash_forward,
                                                       flash_forward_plain)
    q, k, v, g, offs = _f32_strip_inputs(case, cuda, head_dim, seed=13)
    (o1, l1), (o2, l2) = (flash_forward(q, k, v, *offs) for _ in range(2))
    assert torch.equal(o1, o2) and torch.equal(l1, l2)
    o_ref, lse_ref = flash_forward_plain(q, k, v, *offs)
    args = (q, k, v, g, lse_ref, (g * o_ref).sum(-1), *offs)
    assert torch.equal(flash_dq(*args), flash_dq(*args))
    first, second = flash_dkv(*args), flash_dkv(*args)
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("head_dim", [16, 32])
def test_flash_f32_strip_bodies_take_unaligned_operands(cuda, no_tf32,
                                                        head_dim):
    """f32 q/k/v/dO as views 4 bytes past a 16-byte boundary
    (``torch.empty(n + 1)[1:]``): the wrappers clone them before the
    strip bodies' 16-byte cp.async, so the outputs are the bits of the
    same call on fresh tensors, and match the plain versions."""
    from elephas_tpu_torch.ops.flash_attention import (flash_dkv,
                                                       flash_dkv_plain,
                                                       flash_forward,
                                                       flash_forward_plain)
    q, k, v, g, offs = _f32_strip_inputs("forward_d16", cuda, head_dim)

    def offset_view(t):
        buf = torch.empty(t.numel() + 1, device=cuda)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    views = [offset_view(t) for t in (q, k, v, g)]
    assert all(t.data_ptr() % 16 == 4 and t.is_contiguous() for t in views)
    o, lse = flash_forward(*views[:3], *offs)
    o_fresh, lse_fresh = flash_forward(q, k, v, *offs)
    assert torch.equal(o, o_fresh) and torch.equal(lse, lse_fresh)
    o_ref, lse_ref = flash_forward_plain(q, k, v, *offs)
    torch.testing.assert_close(o, o_ref, atol=1e-4, rtol=0)
    delta = (g * o_ref).sum(-1)
    got = flash_dkv(*views, lse_ref, delta, *offs)
    fresh = flash_dkv(q, k, v, g, lse_ref, delta, *offs)
    want = flash_dkv_plain(q, k, v, g, lse_ref, delta, *offs)
    for name, a, f, w in zip(("dk", "dv"), got, fresh, want):
        assert torch.equal(a, f), name
        scale = float(w.abs().max())
        assert float((a - w).abs().max()) <= 1e-4 * scale, name


# the f32 tensor-core bodies of dQ and dK/dV at head dims 40-256
# (csrc/flash_bwd_f32.cu: CTAs of 16-row strips, 64 or 32 resident rows,
# the other operand's tiles of as many rows through a ring of two stages,
# a warp 64 columns of a strip; dK/dV one CTA a chunk of its plan):
# causal and full, Sq != Sk both ways, one query row, GQA groups of 1, 4
# and 8 (whose plans split k tiles, so the reduction runs), windows
# narrower than a step and than a tile, ragged lengths, ring hops whose
# first query rows meet nothing, one wholly in the past and one wholly in
# the future, and S 2048
_F32_WIDE_CASES = {
    # (B, H, KVH, Sq, Sk, causal, window, q_offset, k_offset)
    "causal_130": (2, 4, 4, 130, 130, True, None, 0, 0),
    "gqa4_ragged_191": (2, 8, 2, 191, 191, True, None, 0, 0),
    "gqa8_300": (1, 8, 1, 300, 300, True, None, 0, 0),
    "window_7": (2, 4, 2, 150, 150, True, 7, 0, 0),
    "window_100_gqa4": (1, 8, 2, 300, 300, True, 100, 0, 0),
    "full_130_70": (2, 4, 4, 130, 70, False, None, 0, 0),
    "full_40_200_gqa4": (1, 8, 2, 40, 200, False, None, 0, 0),
    "sq_one": (2, 4, 2, 1, 200, True, None, 199, 0),
    "hop_past": (1, 4, 4, 64, 100, True, None, 128, 0),
    "hop_rows_dead": (1, 4, 4, 40, 50, True, None, 0, 20),
    "hop_future": (1, 4, 2, 64, 64, True, None, 0, 64),
    "s2048_gqa8": (1, 8, 1, 2048, 2048, True, None, 0, 0),
}
_F32_WIDE_HEAD_DIMS = [40, 64, 72, 96, 128, 136, 200, 256]


def _f32_wide_args(case, device, d, seed=14):
    from elephas_tpu_torch.ops.flash_attention import flash_forward_plain
    b, h, kvh, sq, sk, causal, window, qo, ko = _F32_WIDE_CASES[case]
    gen = torch.Generator(device=device).manual_seed(seed)
    q, g = (torch.randn((b, h, sq, d), generator=gen, device=device)
            for _ in range(2))
    k, v = (torch.randn((b, kvh, sk, d), generator=gen, device=device)
            for _ in range(2))
    o, lse = flash_forward_plain(q, k, v, qo, ko, causal, window)
    return (q, k, v, g, lse, (g * o).sum(-1), qo, ko, causal, window)


@pytest.mark.parametrize("case", sorted(_F32_WIDE_CASES))
@pytest.mark.parametrize("head_dim", _F32_WIDE_HEAD_DIMS)
def test_flash_f32_wide_bodies_match_plain(cuda, no_tf32, head_dim, case):
    """f32 dQ and dK/dV at head dims 40-256 on the tensor-core bodies (as
    the per-body counters show; the reduction launched where the plan
    splits a k tile, and not elsewhere) against their plain versions,
    within 1e-4 of max|ref| (3xTF32 products, another summation order);
    a shard no query meets gets zeros."""
    from elephas_tpu_torch.ops import flash_attention as fa
    args = _f32_wide_args(case, cuda, head_dim)
    q, k = args[:2]
    plan = fa._dkv_plan_for(q, k, *args[6:])
    fb = fa.flash_backward
    before = (fb.dq_launches, fb.dq_f32_wide_launches, fb.dkv_launches,
              fb.dkv_f32_wide_launches, fb.dkv_reduce_launches)
    got = (fa.flash_dq(*args), *fa.flash_dkv(*args))
    torch.cuda.synchronize()
    assert (fb.dq_launches, fb.dq_f32_wide_launches, fb.dkv_launches,
            fb.dkv_f32_wide_launches, fb.dkv_reduce_launches) == (
        *(n + 1 for n in before[:4]), before[4] + bool(plan.reduce))
    if case.startswith("gqa8"):
        assert plan.reduce, "a group of 8 splits the first k tiles"
    want = (fa.flash_dq_plain(*args), *fa.flash_dkv_plain(*args))
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and a.shape == w.shape, name
        scale = float(w.abs().max())
        if case == "hop_future":
            assert scale == 0.0 and bool((a == 0).all()), name
            continue
        err = float((a - w).abs().max())
        assert err <= 1e-4 * scale, f"{name}: {err} > 1e-4 * {scale}"


@pytest.mark.parametrize("case", ["gqa8_300", "window_100_gqa4",
                                  "gqa4_ragged_191", "s2048_gqa8"])
@pytest.mark.parametrize("head_dim", [64, 96, 256])
def test_flash_f32_wide_bodies_are_bit_reproducible(cuda, head_dim, case):
    """No atomics in f32 at 40-256 either: two launches of dQ and of
    dK/dV (its plan's split k tiles summed by the reduction in chunk
    order) on the same inputs give the same bits."""
    from elephas_tpu_torch.ops import flash_attention as fa
    args = _f32_wide_args(case, cuda, head_dim, seed=15)
    if case.startswith("gqa8"):
        assert fa._dkv_plan_for(*args[:2], *args[6:]).reduce
    assert torch.equal(fa.flash_dq(*args), fa.flash_dq(*args))
    first, second = fa.flash_dkv(*args), fa.flash_dkv(*args)
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


# head dims below their body's width (8 on the 16-wide body, 24 on 32,
# 40 on 64, 72-120 on 128, 136-248 on 256; 96 is Phi-3-mini's, 80
# Phi-2's): TMA fills the columns past the head dim with zeros and the
# stores drop them
_FILLED_HEAD_DIMS = [8, 24, 40, 72, 80, 96, 120, 136, 192, 248]
# GQA 4:1, ragged lengths, a window edge, ring offsets, one query row,
# one past a 128-row tile
_FILLED_CASES = ["gqa", "gqa4_ragged", "window_17", "ragged_191_257",
                 "sq_one", "sq_129", "hop_past", "hop_future", "noncausal",
                 "gqa4_window"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", _FILLED_CASES)
@pytest.mark.parametrize("head_dim", _FILLED_HEAD_DIMS)
def test_flash_kernels_at_filled_head_dims_match_plain(cuda, no_tf32,
                                                       head_dim, case,
                                                       dtype):
    """The forward, dQ and dK/dV kernels at head dims that run a wider
    body on zero-filled columns, against their plain versions with the
    head-dim-64 tests' tolerances."""
    _check_all_three(cuda, head_dim, case, dtype)


def _sentinel_views(shapes, dtype, device):
    """Tensors of ``shapes`` as contiguous views into one buffer filled
    with a sentinel bit pattern (a NaN), each followed by 256 bytes of
    sentinel: returns the views and a function that says whether every
    guard still holds the sentinel."""
    guard = 256 // torch.empty((), dtype=dtype).element_size()
    sizes = [int(np.prod(sh)) for sh in shapes]
    buf = torch.full((sum(sizes) + guard * len(shapes),), float("nan"),
                     dtype=dtype, device=device)
    views, guards, at = [], [], 0
    for shape, n in zip(shapes, sizes):
        views.append(buf[at:at + n].view(shape))
        guards.append(buf[at + n:at + n + guard])
        at += n + guard
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    pattern = buf[-1:].view(bits).clone()

    def intact():
        return all(bool((g.view(bits) == pattern).all()) for g in guards)
    return views, intact


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["sq_one", "ragged_191_257", "gqa4_ragged",
                                  "sq_129"])
@pytest.mark.parametrize("head_dim", _FILLED_HEAD_DIMS)
def test_flash_kernels_write_no_byte_past_the_head_dim(cuda, no_tf32,
                                                       head_dim, case,
                                                       dtype):
    """Outputs into sentinel-filled memory: every value of O, dQ, dK and
    dV is written (no sentinel left), matches the plain version, and the
    256 bytes after each tensor keep the sentinel. A store of the filled
    columns would land past a row's head_dim values: in the next row, or
    past the tensor's last row into the guard."""
    from elephas_tpu_torch.ops import flash_attention as fa
    b, h, kvh, sq, sk, causal, window, qo, ko = _BWD_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(11)
    q, g = (torch.randn((b, h, sq, head_dim), generator=gen, device=cuda)
            .to(dtype) for _ in range(2))
    k, v = (torch.randn((b, kvh, sk, head_dim), generator=gen, device=cuda)
            .to(dtype) for _ in range(2))
    o_ref, lse_ref = fa.flash_forward_plain(q.float(), k.float(), v.float(),
                                            qo, ko, causal, window)
    delta = (g.float() * o_ref).sum(-1)
    ref = fa.flash_backward_plain(q.float(), k.float(), v.float(), g.float(),
                                  lse_ref, delta, qo, ko, causal, window)
    (o, dq, dk, dv), intact = _sentinel_views(
        [q.shape, q.shape, k.shape, v.shape], dtype, cuda)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=cuda)
    offs = (qo, ko, causal, window)
    fa._fwd_launch(q, k, v, o, lse, *offs)
    fa._bwd_launch("etpu_flash_bwd_dq", q, k, v, g, lse_ref, delta, (dq,),
                   *offs)
    fa._bwd_launch("etpu_flash_bwd_dkv", q, k, v, g, lse_ref, delta,
                   (dk, dv), *offs)
    torch.cuda.synchronize()
    assert intact(), "a store past the last row's head_dim values"
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), o_ref, atol=rel, rtol=0)
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert not bool(torch.isnan(got).any()), f"{name} not all written"
        scale = float(want.abs().max())
        err = float((got.float() - want).abs().max())
        assert err <= rel * max(scale, 1e-30), f"{name}: {err} > {rel} * "\
            f"{scale}"


@pytest.mark.parametrize("case", ["gqa4_ragged", "gqa4_window", "sq_255"])
def test_flash_kernels_are_bit_reproducible_at_head_dim_96(cuda, case):
    """Two launches each of the forward, dQ and dK/dV kernels at head dim
    96 (Phi-3-mini's, on the 128-wide bodies) on the same bf16 inputs give
    the same bits."""
    from elephas_tpu_torch.ops.flash_attention import flash_dq, flash_forward
    args = _bwd_args(case, 6, cuda, 96)
    q, k, v = args[:3]
    fwd = (args[6], args[7], args[8], args[9])
    (o1, l1), (o2, l2) = (flash_forward(q, k, v, *fwd) for _ in range(2))
    assert torch.equal(o1.view(torch.int16), o2.view(torch.int16))
    assert torch.equal(l1, l2)
    first, second = flash_dq(*args), flash_dq(*args)
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))
    _assert_dkv_reproducible(args)


@pytest.mark.parametrize("head_dim", [100, 260, 264])
def test_flash_kernels_refuse_other_head_dims_on_card(cuda, head_dim):
    """At a head dim that is not a multiple of 8, or is above 256, the
    wrappers raise on CUDA tensors, naming the rule (no plain fallback,
    no launch), and the C entry returns cudaErrorInvalidValue (1)."""
    from elephas_tpu_torch.ops import _kernels
    from elephas_tpu_torch.ops.flash_attention import (flash_attention,
                                                       flash_forward)
    q = torch.zeros((1, 2, 16, head_dim), device=cuda,
                    dtype=torch.bfloat16)
    before = flash_forward.launches
    for call in (lambda: flash_forward(q, q, q),
                 lambda: flash_attention(q, q, q, causal=True)):
        with pytest.raises(ValueError, match=r"multiple of 8 from 8 to 256"):
            call()
    assert flash_forward.launches == before
    lse = torch.empty((1, 2, 16), device=cuda)
    err = _kernels.library().etpu_flash_fwd(
        q.data_ptr(), q.data_ptr(), q.data_ptr(), q.data_ptr(),
        lse.data_ptr(), 1, 2, 2, 16, 16, head_dim, 0, 0, 1, 0, 0.1, 1,
        torch.cuda.current_stream(cuda).cuda_stream)
    assert err == 1


def _offset_views(shapes, offset, gen, device):
    """bf16 tensors of ``shapes`` as contiguous views into one buffer,
    each starting ``offset`` elements past the previous one's end (a
    nonzero storage offset; 16-byte aligned only when ``offset`` is a
    multiple of 8)."""
    sizes = [int(np.prod(s)) for s in shapes]
    buf = torch.randn(sum(sizes) + offset * len(shapes), generator=gen,
                      device=device).bfloat16()
    views, at = [], 0
    for shape, n in zip(shapes, sizes):
        at += offset
        views.append(buf[at:at + n].view(shape))
        at += n
    return views


@pytest.mark.parametrize("offset", [8, 3])
def test_flash_kernels_take_offset_views(cuda, offset):
    """q/k/v (and dO) as views with a nonzero storage offset, 16-byte
    aligned (8) or not (3, which the wrappers copy): the forward and
    dK/dV kernels read the same values as from fresh tensors."""
    from elephas_tpu_torch.ops.flash_attention import (flash_dkv,
                                                       flash_dkv_plain,
                                                       flash_forward,
                                                       flash_forward_plain)
    b, h, kvh, sq, sk = 2, 4, 2, 150, 150
    gen = torch.Generator(device=cuda).manual_seed(4)
    q, k, v, g = _offset_views([(b, h, sq, 64), (b, kvh, sk, 64),
                                (b, kvh, sk, 64), (b, h, sq, 64)], offset,
                               gen, cuda)
    assert q.storage_offset() > 0 and q.is_contiguous()
    o, lse = flash_forward(q, k, v, causal=True)
    o_ref, lse_ref = flash_forward_plain(q.float(), k.float(), v.float(),
                                         causal=True)
    torch.testing.assert_close(o.float(), o_ref, atol=2e-2, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)
    delta = (g.float() * o_ref).sum(-1)
    args = (q, k, v, g, lse_ref, delta)
    ref = flash_dkv_plain(*(t.float() for t in args[:4]), lse_ref, delta)
    for name, got, want in zip(("dk", "dv"), flash_dkv(*args), ref):
        scale = float(want.abs().max())
        err = float((got.float() - want).abs().max())
        assert err <= 2e-2 * scale, f"{name}: {err} > 2e-2 * {scale}"


def _bwd_args(case, seed, device, d=64, cases=_BWD_CASES):
    b, h, kvh, sq, sk, causal, window, qo, ko = cases[case]
    from elephas_tpu_torch.ops.flash_attention import flash_forward_plain
    gen = torch.Generator(device=device).manual_seed(seed)
    q, g = (torch.randn((b, h, sq, d), generator=gen, device=device)
            .bfloat16() for _ in range(2))
    k, v = (torch.randn((b, kvh, sk, d), generator=gen, device=device)
            .bfloat16() for _ in range(2))
    o, lse = flash_forward_plain(q.float(), k.float(), v.float(), qo, ko,
                                 causal, window)
    delta = (g.float() * o).sum(-1)
    return (q, k, v, g, lse, delta, qo, ko, causal, window)


@pytest.mark.parametrize("case", ["causal", "gqa4_ragged", "sq_255"])
def test_flash_dq_kernel_is_bit_reproducible(cuda, case):
    """No atomics: two dQ launches on the same bf16 inputs give the same
    bits."""
    from elephas_tpu_torch.ops.flash_attention import flash_dq
    args = _bwd_args(case, 6, cuda)
    first, second = flash_dq(*args), flash_dq(*args)
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


def _assert_dkv_reproducible(args):
    from elephas_tpu_torch.ops.flash_attention import flash_dkv
    first, second = flash_dkv(*args), flash_dkv(*args)
    for a, b_ in zip(first, second):
        assert torch.equal(a.view(torch.int16), b_.view(torch.int16))


@pytest.mark.parametrize("case", ["causal", "gqa4_ragged"])
def test_flash_dkv_kernel_is_bit_reproducible(cuda, case):
    """No atomics: two dK/dV launches on the same bf16 inputs give the
    same bits."""
    _assert_dkv_reproducible(_bwd_args(case, 6, cuda))


@pytest.mark.parametrize("case", ["causal", "gqa4_ragged", "window_17"])
@pytest.mark.parametrize("head_dim", [16, 32, 128])
def test_flash_dkv_kernel_is_bit_reproducible_at_small_head_dims(
        cuda, head_dim, case):
    """No atomics at head dims 16, 32 and 128 either: two dK/dV launches
    on the same bf16 inputs give the same bits (each warpgroup owns its
    key rows and writes them alone)."""
    _assert_dkv_reproducible(_bwd_args(case, 6, cuda, head_dim))


@pytest.mark.parametrize("case", ["causal", "gqa4_window", "sq_255",
                                  "odd_live_tiles", "sq_64", "window_33",
                                  "hop_rows_dead_64", "gqa4_1"])
def test_flash_dq_kernel_is_bit_reproducible_at_head_dim_128(cuda, case):
    """No atomics at head dim 128: two dQ launches on the same bf16
    inputs give the same bits (the ping-pong turns order issue, not
    arithmetic), over the dQ body's tile edges too."""
    from elephas_tpu_torch.ops.flash_attention import flash_dq
    args = _bwd_args(case, 6, cuda, 128, {**_D128_EDGE_CASES, **_BWD_CASES})
    first, second = flash_dq(*args), flash_dq(*args)
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


_PAGED_CASES = {
    # name: (H, KVH, max_blocks, positions, window, alibi); max_blocks at
    # block 16 (twice as many at block 8); a row at pos 0 is an inactive
    # slot (a table of zeros). The bf16 split body takes these tables in
    # runs of 64 positions (4 entries of 16, 8 of 8).
    "base": (8, 8, 8, [0, 17, 127, 0], None, False),
    "gqa": (8, 2, 8, [0, 17, 127, 0], None, False),
    "window": (8, 8, 8, [0, 17, 127, 0], 21, False),
    "alibi": (8, 8, 8, [0, 17, 127, 0], None, True),
    # a window that leaves the first split of three rows empty
    "window_empty_split": (8, 8, 8, [127, 100, 90, 0], 21, False),
    # the last position of split 0, the first of split 1, a block past it
    "split_boundary": (8, 8, 8, [63, 64, 80, 0], None, False),
    # 10 table entries: splits of 4, 4 and 2
    "ragged_max_blocks": (8, 8, 10, [159, 130, 64, 0], None, False),
    # one long row (64 blocks, pos 1023) beside an inactive slot
    "long_row": (8, 8, 64, [1023, 0], None, False),
    "gqa2": (8, 4, 10, [159, 70, 3, 0], None, True),
    "gqa4": (16, 4, 10, [159, 70, 3, 0], 40, False),
    # 8-way groups (the split body's budget of 2 CTAs an SM in bf16)
    "gqa8": (16, 2, 10, [159, 70, 3, 0], None, False),
    # Llama-2-70B's 64 query heads over 8 kv heads
    "gqa8_h64": (64, 8, 10, [159, 70, 3, 0], 40, True),
    # Gemma-2B's 8 query heads over 1 kv head
    "mqa8": (8, 1, 10, [159, 70, 3, 0], None, False),
    "mqa8_long_row": (8, 1, 64, [1023, 0], None, False),
    "mqa8_window": (8, 1, 10, [159, 100, 3, 0], 21, False),
}
# the split body's widths, and 80, 96 and 136 on the next width up
PAGED_HEAD_DIMS = (16, 32, 64, 128, 256, 80, 96, 136)


def _paged_inputs(case, dtype, device, d=64, bs=16):
    h, kvh, mb, positions, window, alibi = _PAGED_CASES[case]
    from elephas_tpu_torch.models.transformer import _alibi_slope_list
    b, mb = len(positions), mb * 16 // bs
    nb = b * mb + 1
    rng = np.random.default_rng(1)
    tables = torch.as_tensor(
        rng.permutation(np.arange(1, nb))[:b * mb].reshape(b, mb),
        dtype=torch.int32, device=device)
    pos = torch.as_tensor(positions, dtype=torch.int32, device=device)
    tables[pos == 0] = 0                       # inactive slots
    gen = torch.Generator(device=device).manual_seed(1)
    q = torch.randn((b, h, d), generator=gen, device=device).to(dtype)
    kp = torch.randn((nb, kvh, bs, d), generator=gen,
                     device=device).to(dtype)
    vp = torch.randn((nb, kvh, bs, d), generator=gen,
                     device=device).to(dtype)
    slopes = _alibi_slope_list(h) if alibi else None
    return q, kp, vp, tables, pos, window, slopes


@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("d", PAGED_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(_PAGED_CASES))
def test_paged_kernel_matches_plain(cuda, case, dtype, d, bs):
    """Every case at every head dim and both block sizes: bf16 with
    groups of 1, 2, 4 or 8 on the split body (``split_launches`` rises
    by one), f32 on the general body (it does not)."""
    from elephas_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_plain)
    q, kp, vp, tables, pos, window, slopes = _paged_inputs(case, dtype,
                                                           cuda, d, bs)
    split = dtype == torch.bfloat16
    before = paged_decode_attention.launches
    split_before = paged_decode_attention.split_launches
    out = paged_decode_attention(q, kp, vp, tables, pos, window, slopes)
    assert paged_decode_attention.launches == before + 1
    assert paged_decode_attention.split_launches == split_before + split
    ref = paged_decode_attention_plain(q.float(), kp.float(), vp.float(),
                                       tables, pos, window, slopes)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert out.dtype == dtype and bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), ref, atol=tol, rtol=0)


def test_paged_split_body_refuses_unaligned_operands(cuda):
    """A bf16 call of the split body's shapes with q off the 16-byte grid
    raises, launching nothing: no quiet fall-back to the general body."""
    from elephas_tpu_torch.ops.paged_attention import paged_decode_attention
    q, kp, vp, tables, pos, window, slopes = _paged_inputs(
        "gqa4", torch.bfloat16, cuda, 128)
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)
    shifted = buf[1:].view(q.shape).copy_(q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    before = (paged_decode_attention.launches,
              paged_decode_attention.split_launches)
    with pytest.raises(ValueError, match="aligned"):
        paged_decode_attention(shifted, kp, vp, tables, pos, window, slopes)
    assert (paged_decode_attention.launches,
            paged_decode_attention.split_launches) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["gqa4", "long_row", "window", "gqa8_h64"])
def test_paged_kernel_at_head_dim_128_matches_plain(cuda, case, dtype):
    """The paged kernel at head dim 128 (bf16 on its split body, f32 on
    the general one; Mistral-7B's groups of 4 in ``gqa4``, Llama-2-70B's
    groups of 8 in ``gqa8_h64``) against its plain version, with the
    head-dim 64 tolerances."""
    from elephas_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_plain)
    q, kp, vp, tables, pos, window, slopes = _paged_inputs(case, dtype,
                                                           cuda, d=128)
    out = paged_decode_attention(q, kp, vp, tables, pos, window, slopes)
    ref = paged_decode_attention_plain(q.float(), kp.float(), vp.float(),
                                       tables, pos, window, slopes)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert out.dtype == dtype and out.shape == q.shape
    assert bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), ref, atol=tol, rtol=0)


@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["mqa8", "mqa8_long_row", "mqa8_window"])
def test_paged_kernel_at_head_dim_256_matches_plain(cuda, case, dtype, bs):
    """The paged kernel at head dim 256 with groups of 8 (Gemma-2B's
    decode step), bf16 on its split body and f32 on its general body
    (``split_launches`` rises by one for bf16 only), against its plain
    version with the head-dim-64 tolerances; two launches give the same
    bits."""
    from elephas_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_plain)
    args = _paged_inputs(case, dtype, cuda, 256, bs)
    before = (paged_decode_attention.launches,
              paged_decode_attention.split_launches)
    out = paged_decode_attention(*args)
    assert (paged_decode_attention.launches,
            paged_decode_attention.split_launches) == (
        before[0] + 1, before[1] + (dtype == torch.bfloat16))
    q, kp, vp, tables, pos, window, slopes = args
    ref = paged_decode_attention_plain(q.float(), kp.float(), vp.float(),
                                       tables, pos, window, slopes)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert out.dtype == dtype and bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), ref, atol=tol, rtol=0)
    again = paged_decode_attention(*args)
    assert torch.equal(out.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       again.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32))


@pytest.mark.parametrize("d", PAGED_HEAD_DIMS)
@pytest.mark.parametrize("case", ["long_row", "gqa4", "window_empty_split",
                                  "mqa8"])
def test_paged_kernel_is_bit_reproducible(cuda, case, d):
    """No atomics, splits merged in index order: two bf16 launches on the
    same inputs give the same bits, at every head dim."""
    from elephas_tpu_torch.ops.paged_attention import paged_decode_attention
    args = _paged_inputs(case, torch.bfloat16, cuda, d)
    first = paged_decode_attention(*args)
    second = paged_decode_attention(*args)
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


def test_engine_fused_matches_gather_on_card(cuda):
    from elephas_tpu_torch import DecodeEngine, TransformerConfig, init_params
    cfg = TransformerConfig(vocab_size=128, num_layers=2, num_heads=4,
                            d_model=256, d_ff=512, max_seq_len=96,
                            dtype=torch.float32, num_kv_heads=2)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    prompts = [np.random.default_rng(i).integers(0, 128, n).tolist()
               for i, n in enumerate((5, 40, 17, 63))]

    def run(kernel, c=cfg):
        eng = DecodeEngine(params, c, max_slots=2, paged=(24, 16),
                           kernel=kernel)
        return eng.run(prompts, 12), eng.stats

    gather, _ = run("gather")
    fused, stats = run("fused")
    assert fused == gather
    assert stats["kernel_launches"] > 0
    bf16, _ = run("fused", dataclasses.replace(cfg, dtype=torch.bfloat16))
    assert all(len(o) == 12 for o in bf16)


def test_forward_flash_matches_plain_on_card(cuda):
    from elephas_tpu_torch import TransformerConfig, forward, init_params
    cfg = TransformerConfig(vocab_size=128, num_layers=2, num_heads=4,
                            d_model=256, d_ff=512, max_seq_len=200,
                            dtype=torch.float32, attention_window=50)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    tokens = torch.randint(0, 128, (2, 150), device=cuda)
    flash = forward(params, tokens, dataclasses.replace(
        cfg, attention_impl="flash"))
    plain = forward(params, tokens, dataclasses.replace(
        cfg, attention_impl="xla"))
    torch.testing.assert_close(flash, plain, atol=1e-4, rtol=0)


def test_train_step_on_card_matches_cpu(cuda):
    """One SGD step (lr 1, so the update is minus the gradient) through
    the flash kernels on the card against the CPU plain step on the same
    weights and tokens, in f32; each kernel launches once per layer."""
    from elephas_tpu_torch import TransformerConfig, init_params
    from elephas_tpu_torch.models.optimizers import SGD
    from elephas_tpu_torch.models.transformer import make_train_step
    from elephas_tpu_torch.ops.flash_attention import (flash_backward,
                                                       flash_forward)
    from elephas_tpu_torch.weights import (from_numpy_tree, to_numpy_tree,
                                           tree_leaves)
    cfg = TransformerConfig(vocab_size=128, num_layers=2, num_heads=4,
                            d_model=256, d_ff=512, max_seq_len=160,
                            dtype=torch.float32, num_kv_heads=2,
                            attention_window=100)
    host = to_numpy_tree(init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu"))
    tokens = torch.randint(0, 128, (2, 150),
                           generator=torch.Generator().manual_seed(1))
    deltas = []
    for device in ("cpu", cuda):
        params = from_numpy_tree(host, device=device)
        start = [p.clone() for p in tree_leaves(params)]
        tx = SGD(1.0).to_transform()
        step = make_train_step(cfg, tx)
        before = (flash_forward.launches, flash_backward.dq_launches,
                  flash_backward.dkv_launches)
        _, _, loss = step(params, tx.init(params), tokens.to(device))
        after = (flash_forward.launches, flash_backward.dq_launches,
                 flash_backward.dkv_launches)
        if device == cuda:
            assert tuple(a - b for a, b in zip(after, before)) == (2, 2, 2)
        deltas.append((float(loss), [(p - s).cpu() for p, s in
                                     zip(tree_leaves(params), start)]))
    (cpu_loss, cpu_d), (gpu_loss, gpu_d) = deltas
    assert abs(cpu_loss - gpu_loss) <= 1e-4
    for a, b in zip(cpu_d, gpu_d):
        scale = float(a.abs().max())
        assert float((a - b).abs().max()) <= 1e-3 * scale + 1e-7


def test_transformer_tpumodel_config_on_card_matches_cpu(cuda, no_tf32):
    """The ``transformer_tpumodel`` LM (head dim 32) under the default
    ``attention_impl="auto"``: on the card it routes to the flash
    kernels (once per layer each); its ``forward`` logits and one SGD
    step (lr 1: the update is minus the gradient) equal the CPU plain
    path's on the same weights and tokens, in f32."""
    from elephas_tpu_torch import TransformerConfig, forward, init_params
    from elephas_tpu_torch.models.optimizers import SGD
    from elephas_tpu_torch.models.transformer import (TRANSFORMER_TPUMODEL,
                                                      make_train_step)
    from elephas_tpu_torch.ops.flash_attention import (flash_backward,
                                                       flash_forward)
    from elephas_tpu_torch.weights import (from_numpy_tree, to_numpy_tree,
                                           tree_leaves)
    cfg = TransformerConfig(**TRANSFORMER_TPUMODEL, dtype=torch.float32)
    assert cfg.head_dim == 32
    host = to_numpy_tree(init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu"))
    tokens = torch.randint(0, 512, (4, 128),
                           generator=torch.Generator().manual_seed(1))
    logits, deltas = [], []
    for device in ("cpu", cuda):
        params = from_numpy_tree(host, device=device)
        before = flash_forward.launches
        logits.append(forward(params, tokens.to(device), cfg).cpu())
        if device == cuda:
            assert flash_forward.launches - before == cfg.num_layers
        start = [p.clone() for p in tree_leaves(params)]
        tx = SGD(1.0).to_transform()
        before = (flash_forward.launches, flash_backward.dq_launches,
                  flash_backward.dkv_launches)
        _, _, loss = make_train_step(cfg, tx)(params, tx.init(params),
                                              tokens.to(device))
        after = (flash_forward.launches, flash_backward.dq_launches,
                 flash_backward.dkv_launches)
        if device == cuda:
            assert tuple(a - b for a, b in zip(after, before)) == (
                (cfg.num_layers,) * 3)
        deltas.append((float(loss), [(p - s).cpu() for p, s in
                                     zip(tree_leaves(params), start)]))
    torch.testing.assert_close(logits[1], logits[0], atol=1e-4, rtol=0)
    (cpu_loss, cpu_d), (gpu_loss, gpu_d) = deltas
    assert abs(cpu_loss - gpu_loss) <= 1e-4
    for a, b in zip(cpu_d, gpu_d):
        scale = float(a.abs().max())
        assert float((a - b).abs().max()) <= 1e-3 * scale + 1e-7


def test_http_serving_config_forward_on_card_matches_cpu(cuda, no_tf32):
    """The ``examples/http_serving.py`` LM (head dim 16, f32; the byte
    tokenizer's vocabulary) under ``attention_impl="auto"``: on the card
    ``forward`` runs the flash forward kernel once per layer and its
    logits equal the CPU plain path's on the same weights."""
    from elephas_tpu_torch import TransformerConfig, forward, init_params
    from elephas_tpu_torch.ops.flash_attention import flash_forward
    from elephas_tpu_torch.weights import from_numpy_tree, to_numpy_tree
    cfg = TransformerConfig(vocab_size=259, num_layers=2, num_heads=4,
                            d_model=64, d_ff=128, max_seq_len=96,
                            dtype=torch.float32)
    assert cfg.head_dim == 16
    host = to_numpy_tree(init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu"))
    tokens = torch.randint(0, 259, (3, 96),
                           generator=torch.Generator().manual_seed(2))
    out = []
    for device in ("cpu", cuda):
        before = flash_forward.launches
        out.append(forward(from_numpy_tree(host, device=device),
                           tokens.to(device), cfg).cpu())
        if device == cuda:
            assert flash_forward.launches - before == cfg.num_layers
    torch.testing.assert_close(out[1], out[0], atol=1e-4, rtol=0)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_with_dropout_on_card_keeps_gradients(cuda, policy):
    """Through the flash kernels on the card, ``remat`` (either policy)
    recomputes the same forward, dropout masks included: the gradients
    equal those without remat under the same CUDA generator."""
    from elephas_tpu_torch import TransformerConfig, init_params
    from elephas_tpu_torch.models.transformer import lm_loss_and_grads
    cfg = TransformerConfig(vocab_size=128, num_layers=2, num_heads=4,
                            d_model=256, d_ff=512, max_seq_len=160,
                            dtype=torch.float32, dropout_rate=0.2)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    tokens = torch.randint(0, 128, (2, 150), device=cuda)
    grads = [lm_loss_and_grads(params, tokens, c,
                               torch.Generator(device=cuda).manual_seed(4))[1]
             for c in (cfg, dataclasses.replace(cfg, remat=True,
                                                remat_policy=policy))]
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


_STUCK_WAIT = r"""
#include "hopper.cuh"
#include <cstdio>
__global__ void stuck() {
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) etpu::mbar_init(&bar, 1);
  __syncthreads();
  etpu::mbar_wait(&bar, 0);  // nobody arrives: phase 0 never completes
}
int main() {
  stuck<<<1, 32>>>();
  cudaError_t e = cudaDeviceSynchronize();
  printf("%s\n", cudaGetErrorString(e));
  return e == cudaSuccess ? 0 : 3;
}
"""


def test_mbarrier_wait_that_never_completes_traps(cuda, tmp_path):
    """``mbar_wait``'s watchdog: a phase nobody completes ends the kernel
    with a launch error after about 4 s instead of hanging the card. Run
    in a process of its own, whose CUDA context the trap spoils."""
    from elephas_tpu_torch.ops import _kernels
    src = tmp_path / "stuck.cu"
    src.write_text(_STUCK_WAIT)
    exe = tmp_path / "stuck"
    subprocess.run([_kernels._nvcc(), *_kernels.ARCH, "-std=c++17",
                    f"-I{_kernels.CSRC}", str(src), "-o", str(exe)],
                   check=True, capture_output=True, timeout=300)
    t0 = time.perf_counter()
    run = subprocess.run([str(exe)], capture_output=True,
                         text=True, timeout=60)
    seconds = time.perf_counter() - t0
    assert run.returncode == 3, run.stdout + run.stderr
    assert "launch failure" in run.stdout
    assert 3.5 <= seconds <= 30, seconds


def test_sync_trainers_on_card_match_cpu(cuda):
    """The f32 MLP (784-128-128-10) through ``SyncStepTrainer`` and
    ``SyncAverageTrainer`` (2 workers) on the card, from the same
    weights, without shuffling, 1 epoch of 512 rows, TF32 off: weights
    and losses within atol 1e-5 of the same run on the CPU."""
    from elephas_tpu_torch.models import (SGD, Dense, Sequential, metrics,
                                          reset_layer_uids)
    from elephas_tpu_torch.parallel.sync_trainer import (SyncAverageTrainer,
                                                         SyncStepTrainer)
    rng = np.random.default_rng(0)
    x = rng.random((512, 784), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 512)]
    loss = "categorical_crossentropy"
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs, w0 = [], None
    try:
        for device in ("cpu", cuda):
            reset_layer_uids()
            model = Sequential([Dense(128, activation="relu", input_dim=784),
                                Dense(128, activation="relu"),
                                Dense(10, activation="softmax")],
                               device=device)
            model.build(seed=0)
            w0 = w0 or model.get_weights()
            acc = [metrics.get("acc", loss=loss)]
            sw, sh = SyncStepTrainer(model, SGD(0.1), loss, acc).fit(
                w0, x, y, epochs=1, batch_size=64, shuffle=False)
            aw, ah = SyncAverageTrainer(model, SGD(0.1), loss, acc).run(
                w0, [(x[:256], y[:256]), (x[256:], y[256:])], epochs=1,
                batch_size=64, shuffle=False)
            runs.append((sw, sh["loss"], aw, [h["loss"] for h in ah]))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    (cw, cl, caw, cal), (gw, gl, gaw, gal) = runs
    for a, b in zip(cw + caw, gw + gaw):
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)
    np.testing.assert_allclose(gl, cl, atol=1e-5, rtol=0)
    np.testing.assert_allclose(gal, cal, atol=1e-5, rtol=0)


@pytest.mark.parametrize("overlap", [False, True])
def test_async_tpu_model_on_card_matches_cpu(cuda, no_tf32, overlap):
    """One asynchronous worker at batch frequency over the socket server
    (the reference loop, or the overlapped loop with 4 steps a window,
    whose batches reach the card through pinned staging), on the f32
    MLP (784-128-128-10), from the same weights, 1 epoch of 1024 rows at
    batch 64, TF32 off: the final weights within 1e-4 of the same fit
    with the master on the CPU, and the worker's model on the master's
    device. The CPU fit runs on one thread, so its sums have one order
    (a ReLU input near zero flips sign between thread counts)."""
    from elephas_tpu_torch import SGD, Dense, Sequential, TPUModel, to_dataset
    from elephas_tpu_torch.utils.sockets import free_port
    from elephas_tpu_torch.worker import AsyncWorker

    rng = np.random.default_rng(0)
    x = rng.random((1024, 784), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 1024)]
    devices = []
    train = AsyncWorker.train

    def spy(worker, *a):
        devices.append(worker.device)
        return train(worker, *a)

    finals, w0 = [], None
    threads = torch.get_num_threads()
    AsyncWorker.train = spy
    try:
        for device in ("cpu", cuda):
            torch.set_num_threads(1 if device == "cpu" else threads)
            model = Sequential([Dense(128, activation="relu", input_dim=784),
                                Dense(128, activation="relu"),
                                Dense(10, activation="softmax")],
                               device=device)
            model.compile(SGD(0.01), "categorical_crossentropy", seed=0)
            w0 = w0 or model.get_weights()
            model.set_weights(w0)
            TPUModel(model, frequency="batch", parameter_server_mode="socket",
                     num_workers=1, port=free_port(), async_overlap=overlap,
                     async_accum=4 if overlap else 1).fit(
                to_dataset(x, y), epochs=1, batch_size=64)
            finals.append(model.get_weights())
    finally:
        AsyncWorker.train = train
        torch.set_num_threads(threads)
    assert [d.type for d in devices] == ["cpu", "cuda"]
    for a, b in zip(*finals):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=0)


def test_prefetch_to_device_on_card(cuda):
    from elephas_tpu_torch.utils.prefetch import prefetch_to_device

    rng = np.random.default_rng(0)
    items = [(rng.random((64, 784), dtype=np.float32),
              rng.integers(0, 10, 64)) for _ in range(7)]
    got = list(prefetch_to_device(iter(items), size=2, device=cuda))
    assert len(got) == len(items)
    for (gx, gy), (x, y) in zip(got, items):
        assert gx.device.type == "cuda" and gy.dtype == torch.int64
        np.testing.assert_array_equal(gx.cpu().numpy(), x)
        np.testing.assert_array_equal(gy.cpu().numpy(), y)


def _tiny_lm(device, param_dtype=torch.float32):
    from elephas_tpu_torch import Adam, TransformerConfig, TransformerModel

    cfg = TransformerConfig(vocab_size=64, num_layers=2, num_heads=2,
                            d_model=64, d_ff=128, max_seq_len=32,
                            dtype=torch.float32, param_dtype=param_dtype)
    return TransformerModel(cfg, device=device).compile(Adam(1e-2), seed=0)


@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_crosses_card_and_cpu_bit_equal(cuda, tmp_path,
                                                   param_dtype):
    """A checkpoint written from the card (async: the snapshot copies the
    card's tensors) restores on the CPU bit-equal, and one written on
    the CPU restores onto the card, params, moments and count."""
    from elephas_tpu_torch.models import ModelCheckpoint
    from elephas_tpu_torch.models.optimizers import opt_state_leaves
    from elephas_tpu_torch.weights import tree_leaves

    tokens = np.random.default_rng(1).integers(0, 64, (16, 32))

    def assert_same(a, b):
        for x, y in zip(tree_leaves(a.params) + opt_state_leaves(
                a._opt_state), tree_leaves(b.params) + opt_state_leaves(
                b._opt_state)):
            assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())

    trained = _tiny_lm(cuda, param_dtype)
    trained.fit(tokens, epochs=2, batch_size=8,
                callbacks=[ModelCheckpoint(str(tmp_path / "card"),
                                           block=False)])
    on_cpu = _tiny_lm("cpu", param_dtype)
    assert on_cpu.restore_training_state(str(tmp_path / "card")) == 1
    assert_same(on_cpu, trained)
    on_cpu.fit(tokens, epochs=1, batch_size=8,
               callbacks=[ModelCheckpoint(str(tmp_path / "cpu"))])
    back = _tiny_lm(cuda, param_dtype)
    assert back.restore_training_state(str(tmp_path / "cpu")) == 0
    assert all(t.device.type == cuda.type for t in tree_leaves(back.params))
    assert_same(back, on_cpu)


def test_load_tpu_model_on_card_predicts_on_the_kernels(cuda, no_tf32,
                                                       tmp_path):
    """A model file saved from the CPU loads onto the card; its
    ``predict`` runs the flash forward (once per layer) and meets the
    CPU's within 1e-4 in f32."""
    from elephas_tpu_torch import TPUModel, load_tpu_model
    from elephas_tpu_torch.ops.flash_attention import flash_forward

    cpu_model = TPUModel(_tiny_lm("cpu"), mode="synchronous", batch_size=4)
    path = str(tmp_path / "lm.h5")
    cpu_model.save(path)
    loaded = load_tpu_model(path, device="cuda")
    assert loaded.master_network.device.type == "cuda"
    tokens = np.random.default_rng(2).integers(0, 64, (4, 32))
    before = flash_forward.launches
    got = loaded.predict(tokens)
    assert flash_forward.launches - before == 2
    np.testing.assert_allclose(got, cpu_model.predict(tokens), atol=1e-4,
                               rtol=0)


def _engine_prompts(vocab, system_len=16):
    rng = np.random.default_rng(21)
    system = rng.integers(0, vocab, system_len).tolist()
    return system, ([system + rng.integers(0, vocab, n).tolist()
                     for n in (5, 19, 2, 11)]
                    + [rng.integers(0, vocab, 9).tolist()])


def _assert_tie_aware_cpu(params, cfg, prompts, ref, out):
    """Greedy rows equal, except a divergence where the plain f32
    forward on the CPU has a top-2 logit gap below 1e-3."""
    from elephas_tpu_torch import forward
    from elephas_tpu_torch.weights import from_numpy_tree, to_numpy_tree
    host = from_numpy_tree(to_numpy_tree(params), device="cpu")
    for p, r, o in zip(prompts, ref, out):
        if r == o:
            continue
        i = next((j for j, (a, b) in enumerate(zip(r, o)) if a != b),
                 min(len(r), len(o)))
        top2 = forward(host, torch.as_tensor([p + r[:i]]), dataclasses.replace(
            cfg, attention_impl="xla"))[0, -1].topk(2).values
        assert float(top2[0] - top2[1]) < 1e-3, (i, r, o)


_CARD_ENGINES = {
    "contiguous": ({}, False),
    "contiguous_sync3_chunk_prefix": (dict(steps_per_sync=3,
                                           prefill_chunk=8), True),
    "contiguous_prefix_cache": (dict(prefix_cache=True,
                                     prefix_cache_block_size=8), True),
    "paged_fused_sync2_prefix": (dict(paged=(40, 8), kernel="fused",
                                      steps_per_sync=2), True),
}


@pytest.mark.parametrize("name", list(_CARD_ENGINES))
def test_serving_engines_on_card_match_cpu(cuda, no_tf32, name):
    """The contiguous and paged engines (the http_serving config, head
    dim 16, f32) give the same greedy tokens on the card as on the CPU,
    tie-aware; the fused paged engine launches its kernel on the card."""
    from elephas_tpu_torch import DecodeEngine, TransformerConfig, init_params
    from elephas_tpu_torch.weights import from_numpy_tree, to_numpy_tree
    cfg = TransformerConfig(vocab_size=259, num_layers=2, num_heads=4,
                            d_model=64, d_ff=128, max_seq_len=96,
                            dtype=torch.float32)
    host = to_numpy_tree(init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu"))
    system, prompts = _engine_prompts(259)
    kwargs, register = _CARD_ENGINES[name]
    outs = {}
    for device in ("cpu", "cuda"):
        eng = DecodeEngine(from_numpy_tree(host, device=device), cfg,
                           max_slots=2, device=device, **kwargs)
        if register:
            eng.register_prefix(system)
        outs[device] = eng.run(prompts, 20)
        stats = eng.stats
    _assert_tie_aware_cpu(from_numpy_tree(host, device="cpu"), cfg, prompts,
                          outs["cpu"], outs["cuda"])
    if register:
        assert stats["prefix_tokens_reused"] > 0
    if kwargs.get("kernel") == "fused":
        assert stats["kernel_launches"] > 0


def test_fused_paged_under_sync_and_prefix_hits_equals_gather(cuda, no_tf32):
    """At head dim 64 (the kernel's fast body) and GQA 2: the fused paged
    engine under ``steps_per_sync=3``, a registered prefix and the block
    cache's hits gives the gather engine's greedy tokens (f32,
    tie-aware), launching the kernel on every decode step."""
    from elephas_tpu_torch import DecodeEngine, TransformerConfig, init_params
    cfg = TransformerConfig(vocab_size=128, num_layers=2, num_heads=4,
                            d_model=256, d_ff=512, max_seq_len=96,
                            dtype=torch.float32, num_kv_heads=2)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    system, prompts = _engine_prompts(128, system_len=24)

    def run(kernel):
        eng = DecodeEngine(params, cfg, max_slots=2, paged=(40, 8),
                           kernel=kernel, steps_per_sync=3)
        eng.register_prefix(system)
        return eng.run(prompts, 16), eng.stats

    gather, _ = run("gather")
    fused, stats = run("fused")
    _assert_tie_aware_cpu(params, cfg, prompts, gather, fused)
    assert stats["kernel_launches"] == stats["steps"] * 3 * cfg.num_layers
    assert stats["prefix_tokens_reused"] >= 4 * 24
    assert stats["kv_cache"]["pinned_blocks"] == 3


# ------------------------------------------- the rest of the Keras layers
def _close_scaled(got, want, tol, what=""):
    """``|got - want| <= tol * max(1, max |want|)``."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0,
                               err_msg=what)


def _images(shape, n=4, seed=1):
    return np.random.default_rng(seed).normal(size=(n,) + shape).astype(
        np.float32)


_CARD_LAYERS = {
    # name: (layer, batch-less input shape, integer input)
    "conv_valid": (lambda m: m.Conv2D(32, 3, activation="relu"),
                   (28, 28, 1), False),
    "conv_same_stride2_odd": (lambda m: m.Conv2D(8, (3, 2), strides=2,
                                                 padding="same"),
                              (9, 7, 3), False),
    "max_pool_same": (lambda m: m.MaxPooling2D(3, strides=2,
                                               padding="same"),
                      (9, 7, 2), False),
    "avg_pool_same": (lambda m: m.AveragePooling2D(3, strides=2,
                                                   padding="same"),
                      (9, 7, 2), False),
    "global_avg_pool": (lambda m: m.GlobalAveragePooling2D(), (5, 6, 3),
                        False),
    "embedding": (lambda m: m.Embedding(32, 16), (16,), True),
    "lstm_cudnn": (lambda m: m.LSTM(32), (16, 16), False),
    "lstm_cudnn_sequences": (lambda m: m.LSTM(8, return_sequences=True),
                             (12, 5), False),
    "lstm_loop_relu": (lambda m: m.LSTM(8, activation="relu"), (12, 5),
                       False),
    "gru": (lambda m: m.GRU(16, return_sequences=True), (12, 5), False),
    "layer_norm": (lambda m: m.LayerNormalization(), (6, 10), False),
    "batch_norm_training": (lambda m: m.BatchNormalization(), (5, 5, 4),
                            False),
    "batch_norm_inference": (lambda m: m.BatchNormalization(), (5, 5, 4),
                             False),
}


@pytest.mark.parametrize("case", sorted(_CARD_LAYERS))
def test_new_layers_on_card_match_cpu(cuda, no_tf32, case):
    """Each layer ported with Conv2D and the rest: forward and the
    gradient of ``sum(out * r)`` (parameters and input) on the card
    against the CPU from the same seeded parameters, f32 with TF32 off,
    within 1e-4 of the larger of 1 and each array's largest magnitude
    (cuDNN's convolutions and LSTM sum in other orders than the CPU's
    loops). The default LSTM takes cuDNN's route on the card."""
    from elephas_tpu_torch.models import layers

    make, shape, integer = _CARD_LAYERS[case]
    training = case != "batch_norm_inference"
    layer = make(layers)
    rng = np.random.default_rng(0)
    built = layer.build(torch.Generator().manual_seed(0), shape)
    params = {k: (rng.uniform(0.5, 1.5, v.shape)
                  if k in ("gamma", "moving_variance")
                  else 0.3 * rng.normal(size=v.shape)).astype(np.float32)
              for k, v in built.items()}
    x = (rng.integers(-32, 32, (8,) + shape).astype(np.int32) if integer
         else _images(shape, n=8))
    r = None
    results = []
    for device in ("cpu", cuda):
        p = {k: torch.tensor(v, device=device, requires_grad=True)
             for k, v in params.items()}
        xt = torch.tensor(x, device=device, requires_grad=not integer)
        if isinstance(layer, layers.LSTM):
            assert layer.cudnn_route(xt) == (
                device != "cpu" and case.startswith("lstm_cudnn"))
        out = layer.call(p, xt, training, None)
        if r is None:
            r = torch.from_numpy(rng.normal(size=tuple(out.shape)).astype(
                np.float32))
        wrt = [p[k] for k in sorted(p)] + ([] if integer else [xt])
        grads = torch.autograd.grad((out * r.to(device)).sum(), wrt,
                                    allow_unused=True)
        results.append([out.detach().cpu().numpy()] + [
            np.zeros(w.shape, np.float32) if g is None else g.cpu().numpy()
            for g, w in zip(grads, wrt)])
    for i, (a, b) in enumerate(zip(*results)):
        # the embedding's out-of-range ids give NaN rows on both
        np.testing.assert_array_equal(np.isnan(b), np.isnan(a))
        _close_scaled(np.nan_to_num(b), np.nan_to_num(a), 1e-4,
                      f"{case} #{i}")


_CARD_OPTIMIZERS = {
    "adagrad": lambda m: m.Adagrad(1e-1),
    "adadelta": lambda m: m.Adadelta(1.0),
    "nadam": lambda m: m.Nadam(1e-2),
    "adafactor": lambda m: m.Adafactor(min_dim_size_to_factor=2,
                                       weight_decay_rate=0.01),
    "lion": lambda m: m.Lion(1e-3, weight_decay=0.1),
    "lamb": lambda m: m.LAMB(1e-2, weight_decay=0.1),
    "adam_exponential": lambda m: m.Adam(m.schedules.ExponentialDecay(
        1e-2, 2, 0.5)),
    "sgd_cosine": lambda m: m.SGD(m.schedules.CosineDecay(0.1, 4),
                                  momentum=0.9),
    "rmsprop_piecewise": lambda m: m.RMSprop(
        m.schedules.PiecewiseConstantDecay([2], [1e-2, 1e-3])),
    "lamb_warmup_cosine": lambda m: m.LAMB(m.schedules.WarmupCosine(
        1e-2, 2, 6)),
}


@pytest.mark.parametrize("name", sorted(_CARD_OPTIMIZERS))
def test_new_optimizers_on_card_match_cpu(cuda, name):
    """Each optimizer ported with the layers, and each schedule: 5
    updates of a (64, 32) matrix and a (32,) vector on the card against
    the CPU, the parameters and the state's leaves within 1e-5 of the
    larger of 1 and each array's largest magnitude (the card's
    reductions, Adafactor's moments and LAMB's norms, sum in another
    order)."""
    from elephas_tpu_torch.models import optimizers

    rng = np.random.default_rng(0)
    params = [rng.normal(size=(64, 32)).astype(np.float32),
              rng.normal(size=(32,)).astype(np.float32)]
    grads = [[rng.normal(size=p.shape).astype(np.float32) for p in params]
             for _ in range(5)]
    finals = []
    for device in ("cpu", cuda):
        tx = _CARD_OPTIMIZERS[name](optimizers).to_transform()
        p = [torch.tensor(a, device=device) for a in params]
        state = tx.init(p)
        for g in grads:
            updates, state = tx.update(
                [torch.tensor(a, device=device) for a in g], state, p)
            p = [w + u for w, u in zip(p, updates)]
        finals.append([t.cpu().numpy() for t in
                       p + optimizers.opt_state_leaves(state)])
    for a, b in zip(*finals):
        _close_scaled(b, a, 1e-5, name)


def _bn_conv_model(device):
    from elephas_tpu_torch.models import (Adam, BatchNormalization, Conv2D,
                                          Dense, Flatten, Sequential,
                                          reset_layer_uids)
    reset_layer_uids()
    model = Sequential([Conv2D(8, 3, use_bias=False,
                               input_shape=(10, 10, 3)),
                        BatchNormalization(momentum=0.9), Flatten(),
                        Dense(4, activation="softmax")], device=device)
    model.compile(Adam(1e-2), "categorical_crossentropy", seed=0)
    return model


def test_bn_moving_statistics_on_card_match_cpu(cuda, no_tf32):
    """3 steps of ``fit`` (batch 16, no shuffle) on a Conv2D ->
    BatchNormalization model: every weight, the moving statistics
    included, within 1e-5 of the CPU's, and the statistics moved."""
    rng = np.random.default_rng(0)
    x = rng.normal(0.5, 1.0, (48, 10, 10, 3)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 48)]
    finals, w0 = [], None
    for device in ("cpu", cuda):
        model = _bn_conv_model(device)
        w0 = w0 or model.get_weights()
        model.set_weights(w0)
        model.fit(x, y, epochs=1, batch_size=16, shuffle=False)
        finals.append(model.get_weights())
    for a, b in zip(*finals):
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)
    assert np.abs(finals[1][2]).max() > 1e-3   # the moving mean moved


def test_lstm_example_first_epoch_on_card_matches_cpu(cuda, no_tf32):
    """``examples/lstm_sequence_classification.py``'s model and data at
    full size (4096 rows of 16 tokens, vocab 32; Embedding 16 -> LSTM 32
    -> Dense 2; Adam 5e-3, batch 128, validation split 0.1) through
    ``SyncStepTrainer`` (the sync step ``TPUModel``'s trainer; without
    shuffling, whose permutations differ between the card's and the
    CPU's generators), one epoch from the same weights on the card
    (cuDNN's LSTM) and on the CPU (the loop): the epoch loss within
    1e-4, every weight within 1e-3 (29 Adam steps carry the two
    summation orders' rounding), predictions within 1e-3."""
    from elephas_tpu_torch import LSTM, Adam, Dense, Embedding, Sequential
    from elephas_tpu_torch.models import metrics, reset_layer_uids
    from elephas_tpu_torch.parallel.sync_trainer import SyncStepTrainer

    rng = np.random.default_rng(0)
    n, t, vocab = 4096, 16, 32
    x = rng.integers(0, vocab, size=(n, t)).astype("int32")
    y_bit = ((x == 1).sum(axis=1) % 2 == 0).astype("float32")
    y = np.stack([1 - y_bit, y_bit], axis=1)
    loss = "categorical_crossentropy"
    runs, w0 = [], None
    for device in ("cpu", cuda):
        reset_layer_uids()
        model = Sequential([Embedding(vocab, 16, input_shape=(t,)),
                            LSTM(32), Dense(2, activation="softmax")],
                           device=device)
        model.build(seed=0)
        w0 = w0 or model.get_weights()
        trainer = SyncStepTrainer(model, Adam(learning_rate=5e-3), loss,
                                  [metrics.get("acc", loss=loss)])
        weights, hist = trainer.fit(w0, x, y, epochs=1, batch_size=128,
                                    validation_split=0.1, shuffle=False)
        runs.append((hist["loss"], weights, model.predict(x[:256])))
    (cl, cw, cp), (gl, gw, gp) = runs
    np.testing.assert_allclose(gl, cl, atol=1e-4, rtol=0)
    for a, b in zip(cw, gw):
        np.testing.assert_allclose(b, a, atol=1e-3, rtol=0)
    np.testing.assert_allclose(gp, cp, atol=1e-3, rtol=0)


# ------------------------------------------- speculative decoding slice
def _spec_model(device, head_dim=16, layers=2):
    """A small f32 LM and its first layer as a draft, on ``device`` (the
    same weights on the CPU and the card)."""
    from elephas_tpu_torch import TransformerConfig, init_params
    from elephas_tpu_torch.weights import from_numpy_tree, to_numpy_tree
    cfg = TransformerConfig(vocab_size=128, num_layers=layers, num_heads=4,
                            d_model=4 * head_dim, d_ff=128,
                            max_seq_len=96, dtype=torch.float32)
    host = to_numpy_tree(init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu"))
    params = from_numpy_tree(host, device=device)
    draft = {k: v for k, v in params.items() if k != "layer_1"}
    return params, cfg, draft, dataclasses.replace(cfg, num_layers=1)


def test_speculative_generate_on_card_matches_generate(cuda, no_tf32):
    """Greedy ``speculative_generate`` on CUDA tensors (f32): tokens
    equal ``generate``'s on the card and the CPU run's (tie-aware), and
    the target as its own draft accepts every proposal."""
    from elephas_tpu_torch.models.speculative import speculative_generate
    from elephas_tpu_torch.models.transformer import generate
    prompt = np.random.default_rng(3).integers(0, 128, (4, 12))
    runs = {}
    for device in ("cpu", cuda):
        params, cfg, draft, dcfg = _spec_model(device)
        toks, stats = speculative_generate(params, draft, prompt, 24, cfg,
                                           dcfg, gamma=4, return_stats=True)
        assert toks.device.type == torch.device(device).type
        runs[str(device)] = (toks.cpu().tolist(), stats)
    ref = generate(params, prompt, 24, cfg).cpu().tolist()
    _assert_tie_aware_cpu(params, cfg, prompt.tolist(), ref,
                          runs["cuda"][0])
    _assert_tie_aware_cpu(params, cfg, prompt.tolist(), runs["cpu"][0],
                          runs["cuda"][0])
    assert 1 <= runs["cuda"][1]["rounds"] <= 24
    _, same = speculative_generate(params, params, prompt, 24, cfg, cfg,
                                   gamma=4, return_stats=True)
    assert same["draft_acceptance"] == 1.0


def test_distill_step_on_card_runs_the_flash_kernels(cuda, no_tf32):
    """``make_distill_step`` on the card launches the flash forward (the
    target's layers and the draft's), dQ and dK/dV once a layer a step
    at head dims 16 and 64 (f32), and three steps meet the CPU's draft
    within 1e-4 (the kernels' and the plain path's summation orders)."""
    from elephas_tpu_torch.models.distill import make_distill_step
    from elephas_tpu_torch.models.optimizers import SGD
    from elephas_tpu_torch.ops.flash_attention import (flash_backward,
                                                       flash_forward)
    from elephas_tpu_torch.weights import tree_leaves, tree_map
    tokens = np.random.default_rng(4).integers(0, 128, (2, 64))
    for head_dim in (16, 64):
        finals = {}
        for device in ("cpu", cuda):
            params, cfg, draft, dcfg = _spec_model(device, head_dim)
            # the draft shares the target's tensors: train a copy
            draft = tree_map(torch.clone, draft)
            tx = SGD(0.1, momentum=0.9).to_transform()
            step = make_distill_step(dcfg, cfg, tx, temperature=2.0,
                                     hard_weight=0.1)
            opt = tx.init(draft)
            flash_forward.launches = 0
            flash_backward.dq_launches = flash_backward.dkv_launches = 0
            for _ in range(3):
                draft, opt, _ = step(draft, params, opt,
                                     torch.as_tensor(tokens, device=device))
            if device == cuda:
                torch.cuda.synchronize()
                assert flash_forward.launches == 3 * (cfg.num_layers + 1)
                assert flash_backward.dq_launches == 3
                assert flash_backward.dkv_launches == 3
            finals[str(device)] = [t.cpu() for t in tree_leaves(draft)]
        for a, b in zip(finals["cpu"], finals["cuda"]):
            torch.testing.assert_close(b, a, atol=1e-4, rtol=0)


def _bf16_engine_case(cuda):
    from elephas_tpu_torch import TransformerConfig, init_params
    cfg = TransformerConfig(vocab_size=128, num_layers=2, num_heads=4,
                            d_model=256, d_ff=512, max_seq_len=128)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    _, prompts = _engine_prompts(128, system_len=24)
    return params, cfg, prompts


def test_interleaved_paged_engine_on_card_runs_the_split_body(cuda):
    """bf16 at head dim 64: the interleaved paged engine (fused kernel,
    ``prefill_chunk`` 16) launches the paged kernel's split body on
    every decode step and gives the tokens of the same engine that
    prefills at admission (the same chunks, so the same bits)."""
    from elephas_tpu_torch import DecodeEngine
    from elephas_tpu_torch.ops.paged_attention import paged_decode_attention
    params, cfg, prompts = _bf16_engine_case(cuda)
    kw = dict(max_slots=2, paged=(64, 8), kernel="fused", prefill_chunk=16)
    base = DecodeEngine(params, cfg, **kw).run(prompts, 12)
    paged_decode_attention.launches = 0
    paged_decode_attention.split_launches = 0
    eng = DecodeEngine(params, cfg, interleave_prefill=True, **kw)
    outs = eng.run(prompts, 12)
    torch.cuda.synchronize()
    assert outs == base
    assert eng.stats["prefill_chunks_interleaved"] > 0
    assert paged_decode_attention.launches == eng.stats["kernel_launches"] > 0
    assert (paged_decode_attention.split_launches
            == paged_decode_attention.launches)


def test_speculative_paged_engine_on_card_in_bf16(cuda):
    """bf16 at head dim 64: the speculative paged engine with the
    target's first layer as its draft runs its rounds (the verify is
    einsum attention over the pool: no paged kernel launches) and emits
    12 tokens a request in the vocabulary. Token equality is checked in
    f32 (``test_interleaved_engine_on_card_matches_cpu``): in bf16 the
    verify block and a decode step round differently at near-ties."""
    from elephas_tpu_torch import DecodeEngine
    from elephas_tpu_torch.ops.paged_attention import paged_decode_attention
    params, cfg, prompts = _bf16_engine_case(cuda)
    paged_decode_attention.launches = 0
    eng = DecodeEngine(params, cfg, max_slots=2, paged=(64, 8),
                       draft_params={k: v for k, v in params.items()
                                     if k != "layer_1"},
                       draft_config=dataclasses.replace(cfg, num_layers=1),
                       gamma=3)
    outs = eng.run(prompts, 12)
    torch.cuda.synchronize()
    assert all(len(o) == 12 and all(0 <= t < 128 for t in o) for o in outs)
    assert eng.stats["speculative_rounds"] > 0
    assert 0.0 <= eng.stats["draft_acceptance"] <= 1.0
    assert paged_decode_attention.launches == 0


def test_interleaved_engine_on_card_matches_cpu(cuda, no_tf32):
    """f32 at head dim 16: the interleaved paged engine with the fused
    kernel (the general body) gives the CPU engine's tokens
    (tie-aware), and the speculative paged engine's with a draft."""
    from elephas_tpu_torch import DecodeEngine
    _, prompts = _engine_prompts(128)
    outs = {}
    for device in ("cpu", cuda):
        params, cfg, draft, dcfg = _spec_model(device)
        for name, kw in (("interleaved", dict(kernel="fused",
                                               prefill_chunk=8,
                                               interleave_prefill=True)),
                         ("speculative", dict(draft_params=draft,
                                              draft_config=dcfg,
                                              gamma=3))):
            eng = DecodeEngine(params, cfg, max_slots=2, paged=(48, 8),
                               device=device, **kw)
            outs[str(device), name] = eng.run(prompts, 16)
    for name in ("interleaved", "speculative"):
        _assert_tie_aware_cpu(params, cfg, prompts, outs["cpu", name],
                              outs["cuda", name])


# ------------------------------------------ MoE, packed rows and int8
def test_routed_moe_at_head_dim_128_on_card_matches_plain(cuda, no_tf32):
    """An MoE LM at head dim 128 (8 experts, top-2, routed dispatch at
    capacity factor 1.25) on the flash kernels against the plain path,
    f32: logits within 1e-4 of their scale, the loss within 1e-5 and
    every gradient within 1e-3 of its leaf's largest; one forward launch
    per layer, and the backward's dQ and dK/dV."""
    from elephas_tpu_torch import TransformerConfig, forward, init_params
    from elephas_tpu_torch.models.transformer import lm_loss_and_grads
    from elephas_tpu_torch.ops.flash_attention import (flash_backward,
                                                       flash_forward)
    cfg = TransformerConfig(vocab_size=128, num_layers=2, num_heads=2,
                            d_model=256, d_ff=128, max_seq_len=64,
                            num_experts=8, expert_top_k=2,
                            moe_dispatch="routed", positional="rope",
                            norm="rmsnorm", tied_embedding=False,
                            dtype=torch.float32)
    assert cfg.head_dim == 128
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, 128, (2, 64)), device=cuda)
    flash = dataclasses.replace(cfg, attention_impl="flash")
    plain = dataclasses.replace(cfg, attention_impl="xla")
    before = flash_forward.launches
    got = forward(params, tokens, flash)
    assert flash_forward.launches == before + cfg.num_layers
    want = forward(params, tokens, plain)
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, atol=1e-4 * scale, rtol=0)
    before = (flash_backward.dq_launches, flash_backward.dkv_launches)
    fl, fg = lm_loss_and_grads(params, tokens, flash)
    assert (flash_backward.dq_launches, flash_backward.dkv_launches) == (
        before[0] + cfg.num_layers, before[1] + cfg.num_layers)
    pl, pg = lm_loss_and_grads(params, tokens, plain)
    assert abs(float(fl) - float(pl)) <= 1e-5
    for a, b in zip(fg, pg):
        assert float((a - b).abs().max()) <= 1e-3 * max(
            float(b.abs().max()), 1e-30)


def test_gemma_2b_shaped_lm_on_card_matches_plain(cuda, no_tf32):
    """Two layers at Gemma-2B's widths (``GEMMA_2B``: head dim 256, 8
    heads over 1 kv head, d_ff 16384, vocab 256000) on the flash kernels
    against the plain path, f32, B 1 x 256: logits within 1e-4 of their
    scale, the loss within 1e-5 and every gradient within 1e-3 of its
    leaf's largest; one forward launch per layer, and the backward's dQ
    and dK/dV."""
    from elephas_tpu_torch import TransformerConfig, forward, init_params
    from elephas_tpu_torch.models.transformer import (GEMMA_2B,
                                                      lm_loss_and_grads)
    from elephas_tpu_torch.ops.flash_attention import (flash_backward,
                                                       flash_forward)
    cfg = TransformerConfig(**dict(GEMMA_2B, num_layers=2),
                            dtype=torch.float32)
    assert cfg.head_dim == 256 and cfg.kv_heads == 1
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 256)), device=cuda)
    flash = dataclasses.replace(cfg, attention_impl="flash")
    plain = dataclasses.replace(cfg, attention_impl="xla")
    before = flash_forward.launches
    got = forward(params, tokens, flash)
    assert flash_forward.launches == before + cfg.num_layers
    want = forward(params, tokens, plain)
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, atol=1e-4 * scale, rtol=0)
    del got, want
    before = (flash_backward.dq_launches, flash_backward.dkv_launches)
    fl, fg = lm_loss_and_grads(params, tokens, flash)
    assert (flash_backward.dq_launches, flash_backward.dkv_launches) == (
        before[0] + cfg.num_layers, before[1] + cfg.num_layers)
    pl, pg = lm_loss_and_grads(params, tokens, plain)
    assert abs(float(fl) - float(pl)) <= 1e-5
    for a, b in zip(fg, pg):
        assert float((a - b).abs().max()) <= 1e-3 * max(
            float(b.abs().max()), 1e-30)


def test_int8_weight_paged_engine_on_card(cuda, no_tf32):
    """Weight-only int8 (``quantize_lm_params``) in the paged engine at
    head dim 64, f32: the fused kernel's greedy tokens equal the gather
    path's and the CPU engine's (tie-aware), launching the kernel on
    every decode step."""
    from elephas_tpu_torch import DecodeEngine, TransformerConfig, init_params
    from elephas_tpu_torch.models.quantization import (QTensor,
                                                       quantize_lm_params)
    from elephas_tpu_torch.weights import from_numpy_tree, to_numpy_tree
    cfg = TransformerConfig(vocab_size=128, num_layers=2, num_heads=4,
                            d_model=256, d_ff=512, max_seq_len=96,
                            dtype=torch.float32, tied_embedding=False)
    params = quantize_lm_params(init_params(
        cfg, torch.Generator(device=cuda).manual_seed(3), cuda))
    assert isinstance(params["head"], QTensor)
    _, prompts = _engine_prompts(128)
    outs = {}
    for kernel in ("gather", "fused"):
        eng = DecodeEngine(params, cfg, max_slots=2, paged=(40, 8),
                           kernel=kernel)
        outs[kernel] = eng.run(prompts, 16)
    assert eng.stats["kernel_launches"] == (eng.stats["steps"]
                                            * cfg.num_layers)
    host = from_numpy_tree(to_numpy_tree(params), device="cpu")
    cpu = DecodeEngine(host, cfg, max_slots=2, paged=(40, 8),
                       device="cpu").run(prompts, 16)
    _assert_tie_aware_cpu(params, cfg, prompts, outs["gather"],
                          outs["fused"])
    _assert_tie_aware_cpu(params, cfg, prompts, cpu, outs["fused"])


def test_moe_int8_cache_engine_on_card_matches_cpu(cuda, no_tf32):
    """The contiguous engine over an MoE LM (dense gating in decode) with
    the int8 KV cache and int8 weights, f32: the card's greedy tokens
    equal the CPU's, tie-aware on the cached path's own logits."""
    from elephas_tpu_torch import DecodeEngine, TransformerConfig, init_params
    from elephas_tpu_torch.models.quantization import quantize_lm_params
    from elephas_tpu_torch.models.transformer import prefill_cache
    from elephas_tpu_torch.weights import from_numpy_tree, to_numpy_tree
    cfg = TransformerConfig(vocab_size=128, num_layers=2, num_heads=2,
                            d_model=256, d_ff=128, max_seq_len=96,
                            num_experts=8, expert_top_k=2,
                            moe_shared_expert=True, kv_cache_quant=True,
                            dtype=torch.float32)
    params = quantize_lm_params(init_params(
        cfg, torch.Generator(device=cuda).manual_seed(4), cuda))
    host = from_numpy_tree(to_numpy_tree(params), device="cpu")
    _, prompts = _engine_prompts(128)
    card = DecodeEngine(params, cfg, max_slots=2, prefill_chunk=8).run(
        prompts, 16)
    cpu = DecodeEngine(host, cfg, max_slots=2, prefill_chunk=8,
                       device="cpu").run(prompts, 16)
    for p, r, o in zip(prompts, cpu, card):
        if r == o:
            continue
        i = next((j for j, (a, b) in enumerate(zip(r, o)) if a != b),
                 min(len(r), len(o)))
        ctx = torch.as_tensor([p + r[:i]])
        top2 = prefill_cache(host, ctx, cfg, ctx.shape[1])[0][0].topk(2)
        assert float(top2.values[0] - top2.values[1]) < 1e-3, (i, r, o)


def test_packed_step_on_card_matches_cpu(cuda, no_tf32):
    """``make_train_step(packed=True)`` on CUDA tensors (the plain
    attention path with the segment mask, which the flash kernels do
    not take): three SGD steps leave the weights within 1e-5 of the CPU
    run's, and no flash kernel launches."""
    from elephas_tpu_torch import TransformerConfig, init_params
    from elephas_tpu_torch.models.optimizers import SGD
    from elephas_tpu_torch.models.transformer import make_train_step
    from elephas_tpu_torch.ops.flash_attention import flash_forward
    from elephas_tpu_torch.weights import tree_leaves, tree_map
    cfg = TransformerConfig(vocab_size=128, num_layers=2, num_heads=4,
                            d_model=256, d_ff=512, max_seq_len=64,
                            num_kv_heads=2, positional="rope",
                            dtype=torch.float32)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 128, (4, 64))
    segs = np.repeat(np.arange(1, 9), 8)[None].repeat(4, 0)
    segs[:, -5:] = 0
    result = {}
    for device in ("cpu", cuda):
        params = tree_map(lambda t: t.to(device), init_params(
            cfg, torch.Generator().manual_seed(6), "cpu"))
        tx = SGD(0.5, momentum=0.9).to_transform()
        step = make_train_step(cfg, tx, packed=True)
        opt = tx.init(params)
        before = flash_forward.launches
        for _ in range(3):
            params, opt, _ = step(params, opt, torch.as_tensor(
                tokens, device=device), torch.as_tensor(segs, device=device))
        assert flash_forward.launches == before
        result[str(device)] = [t.cpu() for t in tree_leaves(params)]
    for a, b in zip(result["cpu"], result["cuda"]):
        torch.testing.assert_close(b, a, atol=1e-5, rtol=0)
