"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: they need a CUDA device and the CUDA toolkit, and skip
elsewhere. On a machine with the card:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

The kernels are built from ``elephas_tpu_torch/csrc`` at first use.
The flash kernels are held at head dim 64 over every case and at head
dims 16 and 32 (the repo's other configurations) over the GQA, window,
ragged and offset cases. Tolerances: f32 kernels within 1e-4 of the f32 plain version (another
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
}


def _check_backward(cuda, case, dtype, d):
    from elephas_tpu_torch.ops.flash_attention import (flash_backward,
                                                       flash_backward_plain,
                                                       flash_forward_plain)
    b, h, kvh, sq, sk, causal, window, qo, ko = _BWD_CASES[case]
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
# batch, run at head dims 16 and 32
_SMALL_D_CASES = ["gqa", "window", "window_17", "ragged", "ragged_191_257",
                  "gqa4_ragged", "sq_one", "sq_129", "hop_past",
                  "hop_future", "noncausal", "tpumodel_fit"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", _SMALL_D_CASES)
@pytest.mark.parametrize("head_dim", [16, 32])
def test_flash_kernels_at_small_head_dims_match_plain(cuda, no_tf32,
                                                      head_dim, case,
                                                      dtype):
    """The forward, dQ and dK/dV kernels at head dims 16 and 32 against
    their plain versions, with the head-dim-64 tests' tolerances."""
    from elephas_tpu_torch.ops.flash_attention import (flash_forward,
                                                       flash_forward_plain)
    b, h, kvh, sq, sk, causal, window, qo, ko = _BWD_CASES[case]
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
    _check_backward(cuda, case, dtype, head_dim)


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


def _bwd_args(case, seed, device, d=64):
    b, h, kvh, sq, sk, causal, window, qo, ko = _BWD_CASES[case]
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
@pytest.mark.parametrize("head_dim", [16, 32])
def test_flash_dkv_kernel_is_bit_reproducible_at_small_head_dims(
        cuda, head_dim, case):
    """No atomics at head dims 16 and 32 either: two dK/dV launches on
    the same bf16 inputs give the same bits."""
    _assert_dkv_reproducible(_bwd_args(case, 6, cuda, head_dim))


_PAGED_CASES = {
    # name: (H, KVH, max_blocks, positions, window, alibi); block 16,
    # head_dim 64; a row at pos 0 is an inactive slot (a table of
    # zeros). The bf16 body splits these tables into runs of 4 entries
    # (64 positions).
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
    # 8-way groups take the generic body
    "gqa8": (16, 2, 10, [159, 70, 3, 0], None, False),
}


def _paged_inputs(case, dtype, device):
    h, kvh, mb, positions, window, alibi = _PAGED_CASES[case]
    from elephas_tpu_torch.models.transformer import _alibi_slope_list
    b, d, bs = len(positions), 64, 16
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(_PAGED_CASES))
def test_paged_kernel_matches_plain(cuda, case, dtype):
    from elephas_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_plain)
    q, kp, vp, tables, pos, window, slopes = _paged_inputs(case, dtype,
                                                           cuda)
    before = paged_decode_attention.launches
    out = paged_decode_attention(q, kp, vp, tables, pos, window, slopes)
    assert paged_decode_attention.launches == before + 1
    ref = paged_decode_attention_plain(q.float(), kp.float(), vp.float(),
                                       tables, pos, window, slopes)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert out.dtype == dtype and bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), ref, atol=tol, rtol=0)


@pytest.mark.parametrize("case", ["long_row", "gqa4", "window_empty_split"])
def test_paged_kernel_is_bit_reproducible(cuda, case):
    """No atomics, splits merged in index order: two bf16 launches on the
    same inputs give the same bits."""
    from elephas_tpu_torch.ops.paged_attention import paged_decode_attention
    args = _paged_inputs(case, torch.bfloat16, cuda)
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
