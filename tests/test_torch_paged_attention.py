"""Paged decode attention of the PyTorch port against the JAX package.

The same numpy inputs (shuffled block tables, ragged positions) go
through the JAX ``paged_decode_attention`` (the Pallas kernel in
interpret mode) and the port's wrapper, which on CPU tensors runs the
kernel's plain version (at head dim 16, and at 256 with 8 query heads
over 1 kv head, Gemma-2B's decode step), and the bf16 kernel's
split-and-merge arithmetic in numpy at every body width and group size
(head dims 16, 32, 80, 96, 128, 256; groups of 1, 2, 4 and 8). f32
throughout; rtol = atol = 2e-5 covers the online-versus-full-row softmax
reassociation. One torch intra-op thread for the module.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from elephas_tpu.models.transformer import _alibi_slope_list
from elephas_tpu.ops.paged_attention import \
    paged_decode_attention as jax_paged
from elephas_tpu_torch.ops.paged_attention import (
    SPLIT_GROUPS, paged_body, paged_decode_attention,
    paged_decode_attention_plain, split_blocks)
from tests.torch_one_thread import one_thread


_CASES = {
    "base": dict(h=4, kvh=4, window=None, alibi=False),
    "gqa": dict(h=4, kvh=2, window=None, alibi=False),
    "mqa": dict(h=4, kvh=1, window=None, alibi=False),
    "window": dict(h=4, kvh=4, window=11, alibi=False),
    "alibi": dict(h=4, kvh=4, window=None, alibi=True),
    "gqa_window_alibi": dict(h=4, kvh=2, window=9, alibi=True),
    # Gemma-2B's decode step: head dim 256, 8 query heads over 1 kv head
    "d256_mqa8": dict(h=8, kvh=1, window=None, alibi=False, d=256),
    "d256_mqa8_window": dict(h=8, kvh=1, window=11, alibi=False, d=256),
}


def _inputs(seed, b, h, kvh, d=16, bs=8, mb=4, nb=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((nb, kvh, bs, d)).astype(np.float32)
    vp = rng.standard_normal((nb, kvh, bs, d)).astype(np.float32)
    # blocks deliberately NOT in pool order; block 0 stays the sink
    ids = rng.permutation(np.arange(1, nb))[:b * mb].reshape(b, mb)
    pos = rng.integers(0, mb * bs, b)
    return q, kp, vp, ids.astype(np.int32), pos.astype(np.int32)


def _both(q, kp, vp, ids, pos, window, slopes):
    ref = np.asarray(jax_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(ids),
        jnp.asarray(pos), window=window, alibi_slopes=slopes,
        interpret=True))
    out = paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(ids), torch.from_numpy(pos), window=window,
        alibi_slopes=slopes)
    return ref, out


@pytest.mark.parametrize("case", sorted(_CASES))
def test_plain_matches_jax_kernel(case):
    cfg = _CASES[case]
    q, kp, vp, ids, pos = _inputs(7, 3, cfg["h"], cfg["kvh"],
                                  d=cfg.get("d", 16))
    pos[0] = 2                       # one row inside its first block
    slopes = _alibi_slope_list(cfg["h"]) if cfg["alibi"] else None
    ref, out = _both(q, kp, vp, ids, pos, cfg["window"], slopes)
    assert out.dtype == torch.float32 and out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_inactive_row_reads_only_the_scratch_block():
    """An inactive slot (pos 0, table of zeros) attends to position 0 of
    block 0 alone, in both packages."""
    q, kp, vp, ids, pos = _inputs(11, 2, 4, 2)
    ids[1] = 0
    pos[1] = 0
    ref, out = _both(q, kp, vp, ids, pos, None, None)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)
    v0 = np.repeat(vp[0, :, 0], 2, axis=0)          # (H, D) via GQA
    np.testing.assert_allclose(out.numpy()[1], v0, rtol=1e-6, atol=1e-6)


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    q, kp, vp, ids, pos = (torch.from_numpy(a)
                           for a in _inputs(3, 2, 4, 4))
    before = paged_decode_attention.launches
    split_before = paged_decode_attention.split_launches
    out = paged_decode_attention(q, kp, vp, ids, pos, window=5)
    assert paged_decode_attention.launches == before
    assert paged_decode_attention.split_launches == split_before
    torch.testing.assert_close(
        out, paged_decode_attention_plain(q, kp, vp, ids, pos, window=5),
        rtol=0, atol=0)


def test_bf16_pool_keeps_q_dtype():
    q, kp, vp, ids, pos = (torch.from_numpy(a)
                           for a in _inputs(5, 2, 4, 2))
    out = paged_decode_attention(q.bfloat16(), kp.bfloat16(), vp.bfloat16(),
                                 ids, pos)
    ref = paged_decode_attention(q, kp, vp, ids, pos)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref, rtol=0, atol=5e-2)


@pytest.mark.parametrize("bad", ["heads", "slopes", "window"])
def test_rejects_bad_arguments(bad):
    q, kp, vp, ids, pos = (torch.from_numpy(a)
                           for a in _inputs(1, 2, 4, 2))
    kwargs = {}
    if bad == "heads":
        q = q[:, :3]
    elif bad == "slopes":
        kwargs["alibi_slopes"] = [0.5, 0.25]
    else:
        kwargs["window"] = 0
    with pytest.raises(ValueError):
        paged_decode_attention(q, kp, vp, ids, pos, **kwargs)


def _split_merge(q, kp, vp, ids, pos, per, window=None, slopes=None):
    """The bf16 kernel's split-K arithmetic in f32 numpy: row b's table
    entries in runs of ``per``; each run gives (m, l, acc) over its valid
    keys (m = -inf, l = 0, acc = 0 for a run with none, which the kernel
    never launches work for), and the merge takes the runs in index
    order: m* = max m_i, l = sum l_i e^(m_i - m*), o = sum acc_i
    e^(m_i - m*) / max(l, 1e-30), a run with m_i = -inf weighing 0."""
    b, h, d = q.shape
    _, kvh, bs, _ = kp.shape
    groups, mb = h // kvh, ids.shape[1]
    out = np.zeros_like(q)
    for r in range(b):
        for hh in range(h):
            n = hh // groups
            parts = []
            for s0 in range(0, mb, per):
                m, l, acc = -np.inf, 0.0, np.zeros(d, np.float32)
                blocks = range(s0, min(s0 + per, mb))
                kpos = np.concatenate([j * bs + np.arange(bs)
                                       for j in blocks])
                valid = kpos <= pos[r]
                if window is not None:
                    valid &= kpos > pos[r] - window
                if valid.any():
                    # a valid key's block is live: only those entries read
                    js = sorted({int(k) // bs for k in kpos[valid]})
                    keys = np.concatenate([kp[ids[r, j], n] for j in js])
                    vals = np.concatenate([vp[ids[r, j], n] for j in js])
                    kp_live = np.concatenate([j * bs + np.arange(bs)
                                              for j in js])
                    ok = np.isin(kp_live, kpos[valid])
                    sc = keys @ q[r, hh] / np.sqrt(d)
                    if slopes is not None:
                        sc = sc - slopes[hh] * (pos[r] - kp_live)
                    m = sc[ok].max()
                    p = np.where(ok, np.exp(sc - m), 0.0)
                    l, acc = p.sum(), p @ vals
                parts.append((m, l, acc))
            mj = max(m for m, _, _ in parts)
            w = [0.0 if m == -np.inf else np.exp(m - mj)
                 for m, _, _ in parts]
            lsum = sum(wi * l for wi, (_, l, _) in zip(w, parts))
            acc = sum(wi * a for wi, (_, _, a) in zip(w, parts))
            out[r, hh] = acc / max(lsum, 1e-30)
    return out


_SPLIT_CASES = {
    # name: (split length, h, kvh, window, alibi, positions)
    "per1": (1, 4, 2, None, False, [37, 5, 63]),
    "per3": (3, 4, 4, None, False, [63, 23, 24]),
    "per4": (4, 4, 1, None, False, [31, 32, 40]),
    # window 9 at pos 60: blocks 0-5 lie wholly before it, so the first
    # runs of 1 and of 3 blocks hold no valid key
    "before_window_per1": (1, 4, 2, 9, False, [60, 17, 8]),
    "before_window_per3": (3, 4, 4, 9, False, [60, 47, 2]),
    "inactive_per3": (3, 4, 2, None, False, [0, 44, 0]),
    "alibi_per4": (4, 4, 4, None, True, [61, 12, 33]),
    "alibi_window_per3": (3, 4, 2, 13, True, [58, 30, 0]),
}


@pytest.mark.parametrize("case", sorted(_SPLIT_CASES))
def test_split_merge_matches_jax_kernel_and_plain(case):
    """The split-and-merge arithmetic of the bf16 kernel equals the JAX
    kernel (interpret mode) and the port's plain version, in f32: rtol
    = atol = 2e-5 covers the split-versus-full-row reassociation."""
    per, h, kvh, window, alibi, positions = _SPLIT_CASES[case]
    q, kp, vp, ids, pos = _inputs(13, 3, h, kvh, mb=8, nb=30)
    pos[:] = positions
    if case.startswith("inactive"):
        ids[pos == 0] = 0          # inactive slots: the scratch block
    slopes = _alibi_slope_list(h) if alibi else None
    got = _split_merge(q, kp, vp, ids, pos, per, window, slopes)
    assert np.isfinite(got).all()
    ref, out = _both(q, kp, vp, ids, pos, window, slopes)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, out.numpy(), rtol=2e-5, atol=2e-5)


# name: (split length, window, ALiBi, positions); the table is 8 blocks of
# 8, so positions reach 63. 96 and 80 run on the 128-wide body, 256 is
# Gemma-2B's (with 8 query heads over 1 kv head at groups of 8)
_DIM_CASES = {
    16: (3, None, True, [63, 8, 0]),
    32: (2, 13, False, [58, 23, 0]),
    128: (3, 9, True, [60, 40, 0]),
    256: (2, None, False, [61, 30, 0]),
    96: (3, 11, False, [59, 17, 0]),
    80: (4, None, True, [62, 33, 0]),
}


@pytest.mark.parametrize("groups", SPLIT_GROUPS)
@pytest.mark.parametrize("d", sorted(_DIM_CASES))
def test_split_merge_at_head_dims_and_groups(d, groups):
    """The split body's arithmetic at its other head dims (16, 32, 128,
    256, and 80 and 96 on the 128-wide body) and every group size it
    takes (1, 2, 4, 8; 4 query heads, 8 at groups of 8), each with a
    window or ALiBi and an inactive slot, against the JAX kernel
    (interpret mode) and the plain version at rtol = atol = 2e-5."""
    per, window, alibi, positions = _DIM_CASES[d]
    h = max(4, groups)
    q, kp, vp, ids, pos = _inputs(17 + d, 3, h, h // groups, d=d, mb=8,
                                  nb=30)
    pos[:] = positions
    ids[pos == 0] = 0              # the inactive slot: the scratch block
    slopes = _alibi_slope_list(h) if alibi else None
    got = _split_merge(q, kp, vp, ids, pos, per, window, slopes)
    assert np.isfinite(got).all()
    ref, out = _both(q, kp, vp, ids, pos, window, slopes)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, out.numpy(), rtol=2e-5, atol=2e-5)


_BODY_CASES = {
    # name: ((dtype, head dim, groups, aligned), body or None for a
    # raise)
    "bf16_d128_g4": ((torch.bfloat16, 128, 4, True), "split"),
    "bf16_d64_g1": ((torch.bfloat16, 64, 1, True), "split"),
    "bf16_d32_g2": ((torch.bfloat16, 32, 2, True), "split"),
    "bf16_d16_g1": ((torch.bfloat16, 16, 1, True), "split"),
    "f32_d64": ((torch.float32, 64, 1, True), "general"),
    "f32_d128_unaligned": ((torch.float32, 128, 4, False), "general"),
    "bf16_g8": ((torch.bfloat16, 64, 8, True), "split"),
    "bf16_g3": ((torch.bfloat16, 64, 3, True), "general"),
    "bf16_d96": ((torch.bfloat16, 96, 1, True), "split"),
    "bf16_d256_g8": ((torch.bfloat16, 256, 8, True), "split"),
    "bf16_d80_g2": ((torch.bfloat16, 80, 2, True), "split"),
    "bf16_d136_g8": ((torch.bfloat16, 136, 8, True), "split"),
    "bf16_d100": ((torch.bfloat16, 100, 1, True), "general"),
    "bf16_d8": ((torch.bfloat16, 8, 1, True), "general"),
    "bf16_d264": ((torch.bfloat16, 264, 1, True), "general"),
    "bf16_g16": ((torch.bfloat16, 128, 16, True), "general"),
    "f32_d256_g8": ((torch.float32, 256, 8, True), "general"),
    "bf16_d8_unaligned": ((torch.bfloat16, 8, 1, False), "general"),
    "bf16_d96_unaligned": ((torch.bfloat16, 96, 1, False), None),
    "bf16_d256_g8_unaligned": ((torch.bfloat16, 256, 8, False), None),
    "bf16_unaligned": ((torch.bfloat16, 128, 4, False), None),
    "bf16_d16_unaligned": ((torch.bfloat16, 16, 2, False), None),
}


@pytest.mark.parametrize("case", sorted(_BODY_CASES))
def test_paged_body_choice(case):
    """bf16 at every multiple of 8 from 16 to 256 with groups of 1, 2, 4
    or 8 takes the split body; other dtypes and shapes (f32, D 8, D
    100, D 264, groups of 3 or 16) the general one; a split-body call
    the body cannot take (unaligned) raises instead of falling back."""
    args, body = _BODY_CASES[case]
    if body is None:
        with pytest.raises(ValueError):
            paged_body(*args)
    else:
        assert paged_body(*args) == body


def test_split_body_takes_every_multiple_of_8_to_256():
    """The split body's head dims are 16, 24, ..., 256, each with groups
    of 1, 2, 4 and 8, and nothing else in between runs it."""
    assert SPLIT_GROUPS == (1, 2, 4, 8)
    assert all(paged_body(torch.bfloat16, d, g) == "split"
               for d in range(16, 257, 8) for g in SPLIT_GROUPS)
    assert not any(paged_body(torch.bfloat16, d, 1) == "split"
                   for d in range(1, 300) if d % 8 or not 16 <= d <= 256)


def test_split_length_comes_from_the_shape():
    """The serving shape (B 8, 16 kv heads, 64 blocks of 16) runs 16
    splits of 4 blocks; one request alone the same 16 splits (256 CTAs);
    a large batch fewer, longer splits; never more splits than table
    entries, and at least 64 positions a split."""
    assert split_blocks(8, 16, 64, 16) == 4
    assert split_blocks(1, 16, 64, 16) == 4
    assert split_blocks(64, 16, 64, 16) == 32
    # Mistral-7B's 8 kv heads (D 128, groups of 4) at MB 64: the same 16
    # splits of 4 blocks (1,024 CTAs at B 8), one request 16 splits (128
    # CTAs), blocks of 8 splits of 8 entries (still 64 positions)
    assert split_blocks(8, 8, 64, 16) == 4
    assert split_blocks(1, 8, 64, 16) == 4
    assert split_blocks(8, 8, 64, 8) == 8
    assert split_blocks(32, 8, 64, 16) == 8
    for b, kvh, mb, bs in [(1, 1, 1, 16), (3, 2, 10, 16), (2, 4, 7, 8),
                           (512, 16, 64, 16), (1, 1, 300, 1),
                           (8, 8, 64, 16), (16, 8, 64, 8)]:
        per = split_blocks(b, kvh, mb, bs)
        assert 1 <= per <= mb
        assert per * bs >= min(64, mb * bs)
        assert -(-mb // per) * per - mb < per   # no split wholly empty


def test_split_length_at_groups_of_8():
    """Groups of 8 over at most 8 (row, kv head) pairs split at 32
    positions: Gemma-2B's decode step in the paged engine (B 8, 8 query
    heads over 1 kv head, its 128-entry tables of 16 at max_seq_len 2048)
    runs 64 splits of 2 blocks; Llama-2-70B's 64 heads over 8 at B 8
    keep 64 positions, as does every shape at smaller groups."""
    assert split_blocks(8, 1, 128, 16, groups=8) == 2
    assert split_blocks(8, 1, 64, 16, groups=8) == 2
    assert split_blocks(1, 8, 64, 16, groups=8) == 2
    assert split_blocks(8, 8, 64, 16, groups=8) == 4
    assert split_blocks(8, 1, 128, 16, groups=4) == 4
    assert split_blocks(8, 1, 128, 8, groups=8) == 4
    for b, kvh, mb, bs in [(1, 1, 1, 16), (8, 1, 3, 16), (1, 1, 300, 1),
                           (2, 4, 7, 8)]:
        per = split_blocks(b, kvh, mb, bs, groups=8)
        assert 1 <= per <= mb
        assert per * bs >= min(32, mb * bs)
        assert -(-mb // per) * per - mb < per
