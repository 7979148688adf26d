"""The work plan of the port's 256-wide dK/dV kernel, and its split path's
arithmetic against the JAX package.

At head dims 136-256 (bf16) the dK/dV kernel runs one CTA per chunk of
``dkv_plan``: a 64-row k tile's walk over (query head of the GQA group,
live 64-row q tile), head-major, cut into chunks of about equal work;
the chunks of a split k tile write f32 partials, summed in chunk order
by a second kernel (``flash_dkv_reduce``). The plan is pure Python, so
it is checked here:

- it covers the work exactly: against a brute-force list of live (head,
  q tile) steps per k tile (from the element mask, not from the
  kernels' tile test), under causal and non-causal masks, windows,
  ragged lengths and ring-hop offsets, every live step falls in exactly
  one chunk, in walk order, and every k tile has a chunk;
- it splits where it should: at ``lm_d256``'s fit shape (Gemma-2B: B 2,
  H 8 over KVH 1, S 1024) at least 132 chunks on 132 SMs, none above
  twice the mean; at the training shape (B 8, H = KVH 16) one chunk a k
  tile;
- the chunked sums match JAX: ``flash_dkv_chunked_plain`` (the plain dK
  and dV of each chunk as an f32 partial, the partials summed in the
  plan's order) against the JAX ``flash_hop_backward`` (the Pallas
  ``_dkv_kernel`` in interpret mode), f32, d 256, H 8 over KVH 1 and H 4
  over KVH 2, causal and windowed, on plans whose chunks cross head
  boundaries. Tolerance: ``tests/test_torch_flash_backward.py`` allows
  2e-6 at d 16 and 4e-6 at d 80-128 (about 8 ulps of the largest
  gradient, dq reaching |4|); at d 256 the S and dP dots run over twice
  d 128's terms and dk here reaches |8| (ulp 9.5e-7 there), so 8 ulps is
  8e-6.

Torch runs one intra-op thread for the module, as the speculative files
do: under the parallel test run a pool a worker oversubscribes the cores.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from elephas_tpu.ops.pallas_attention import flash_hop_backward
from elephas_tpu_torch.ops.flash_attention import (
    DKV_ROWS, dkv_live_q_tiles, dkv_plan, dkv_step, flash_backward,
    flash_dkv_chunked_plain, flash_dkv_plain, flash_dkv_reduce,
    flash_dkv_reduce_plain, flash_forward_plain)
from tests.torch_one_thread import one_thread

ATOL = 8e-6


# (B, H, KVH, Sq, Sk, causal, window, q_offset, k_offset, SMs)
_PLAN_CASES = {
    "fit": (2, 8, 1, 1024, 1024, True, None, 0, 0, 132),
    "train": (8, 16, 16, 1024, 1024, True, None, 0, 0, 132),
    "noncausal_ragged": (1, 8, 2, 100, 65, False, None, 0, 0, 132),
    "window": (2, 8, 1, 300, 300, True, 100, 0, 0, 132),
    "window_ragged": (1, 4, 1, 517, 517, True, 65, 0, 0, 24),
    "hop_past": (1, 16, 1, 200, 200, True, None, 256, 128, 132),
    "hop_future": (1, 4, 2, 128, 128, True, None, 0, 128, 132),
    "hop_window": (1, 4, 4, 330, 250, True, 90, 300, 120, 17),
    "gqa16": (1, 16, 1, 191, 191, True, None, 0, 0, 132),
    "gqa4_few_sms": (3, 8, 2, 640, 640, True, None, 0, 0, 8),
    "sq_one": (2, 8, 1, 1, 300, True, None, 299, 0, 132),
}


def _live_steps(case):
    """{(kv row, k tile): [(head of the group, q tile), ...]} in walk
    order, each (q tile, k tile) pair live where some element of it is
    valid under the mask on global positions."""
    b, h, kvh, sq, sk, causal, window, qo, ko, _ = case
    qg = qo + np.arange(sq)[:, None]
    kg = ko + np.arange(sk)[None, :]
    valid = np.ones((sq, sk), bool)
    if causal:
        valid &= kg <= qg
    if window:
        valid &= kg > qg - window
    nq, nk = -(-sq // DKV_ROWS), -(-sk // DKV_ROWS)
    grp = h // kvh
    out = {}
    for row in range(b * kvh):
        for kt in range(nk):
            ks = slice(kt * DKV_ROWS, (kt + 1) * DKV_ROWS)
            live = [qi for qi in range(nq)
                    if valid[qi * DKV_ROWS:(qi + 1) * DKV_ROWS, ks].any()]
            out[row, kt] = [(g, qi) for g in range(grp) for qi in live]
    return out


@pytest.mark.parametrize("name", sorted(_PLAN_CASES))
def test_plan_covers_the_live_steps_exactly(name):
    case = _PLAN_CASES[name]
    b, h, kvh, sq, sk, causal, window, qo, ko, sms = case
    plan = dkv_plan(b, h, kvh, sq, sk, qo, ko, causal, window, sms)
    want = _live_steps(case)
    by_tile = {}
    for kt, row, first, count, slot in plan.chunks:
        by_tile.setdefault((row, kt), []).append((first, count, slot))
    assert set(by_tile) == set(want), "every k tile has a chunk"
    split = {(row, kt): (slot0, n) for kt, row, slot0, n in plan.reduce}
    slots = []
    for key, chunks in by_tile.items():
        chunks.sort()
        live = dkv_live_q_tiles(key[1], sq, sk, qo, ko, causal, window)
        # the chunks partition the tile's walk, in order, and step t of the
        # walk is the kernel's dkv_step(t)
        walk = [dkv_step(t, live) for first, count, _ in chunks
                for t in range(first, first + count)]
        assert walk == want[key]
        assert chunks[0][0] == 0 and all(
            a[0] + a[1] == c[0] for a, c in zip(chunks, chunks[1:]))
        if len(chunks) == 1:
            assert chunks[0][2] == -1 and key not in split
        else:
            slot0, n = split[key]
            assert [c[2] for c in chunks] == list(range(slot0, slot0 + n))
            slots += [c[2] for c in chunks]
    assert sorted(slots) == list(range(plan.slots))
    # the heaviest chunks first
    counts = [c[3] for c in plan.chunks]
    assert counts == sorted(counts, reverse=True)


def test_plan_splits_where_it_should():
    fit = dkv_plan(2, 8, 1, 1024, 1024, 0, 0, True, None, 132)
    counts = [c[3] for c in fit.chunks]
    mean = sum(counts) / len(counts)
    assert len(fit.chunks) >= 132 and max(counts) <= 2 * mean
    assert sum(counts) == 2 * 8 * 136
    # 8, 8, 7, 7, ..., 1, 1 chunks for k tiles 0..15 of each batch row
    per_tile = [sum(1 for c in fit.chunks if c[0] == kt and c[1] == 0)
                for kt in range(16)]
    assert per_tile == [8, 8, 7, 7, 6, 6, 5, 5, 4, 4, 3, 3, 2, 2, 1, 1]
    train = dkv_plan(8, 16, 16, 1024, 1024, 0, 0, True, None, 132)
    assert len(train.chunks) == 8 * 16 * 16 and train.slots == 0
    assert not train.reduce


def test_reduction_sums_in_chunk_order():
    """The plain reduction adds each split tile's partials in slot order
    and casts once; the CPU wrapper runs it and launches nothing."""
    plan = dkv_plan(1, 8, 1, 191, 191, 0, 0, True, None, 132)
    assert plan.reduce
    rng = np.random.default_rng(3)
    partials = torch.from_numpy(rng.standard_normal(
        (plan.slots, 2, DKV_ROWS, 256)).astype(np.float32))
    dk = torch.full((1, 1, 191, 200), 7.0, dtype=torch.bfloat16)
    dv = dk.clone()
    before = flash_backward.dkv_reduce_launches
    flash_dkv_reduce(partials, plan, dk, dv)
    assert flash_backward.dkv_reduce_launches == before
    for kt, row, slot0, n in plan.reduce:
        rows = min(DKV_ROWS, 191 - kt * DKV_ROWS)
        acc = partials[slot0]
        for s in range(slot0 + 1, slot0 + n):
            acc = acc + partials[s]
        rk = dk[0, row, kt * DKV_ROWS:kt * DKV_ROWS + rows]
        assert torch.equal(rk, acc[0, :rows, :200].bfloat16())
    # the unsplit tile's rows are left alone
    split = {kt for kt, *_ in plan.reduce}
    for kt in set(range(3)) - split:
        assert bool((dk[0, 0, kt * DKV_ROWS:(kt + 1) * DKV_ROWS] == 7).all())
    # the plain version on its own gives the same bits
    dk2, dv2 = flash_dkv_reduce_plain(partials, plan, dk.clone(), dv.clone())
    assert torch.equal(dk2, dk) and torch.equal(dv2, dv)
    with pytest.raises(ValueError, match="partial slots"):
        flash_dkv_reduce(partials[:-1], plan, dk, dv)


# (H, KVH, S, window, q_offset, k_offset, SMs): plans whose chunks cross
# the group's head boundaries
_JAX_CASES = {
    "mqa8_causal": (8, 1, 150, None, 0, 0, 10),
    "mqa8_window": (8, 1, 150, 50, 0, 0, 6),
    "gqa2_causal": (4, 2, 260, None, 0, 0, 15),
    "gqa2_window_hop": (4, 2, 260, 150, 100, 30, 19),
}


@pytest.mark.parametrize("name", sorted(_JAX_CASES))
def test_chunked_sums_match_jax(name):
    h, kvh, s, window, qo, ko, sms = _JAX_CASES[name]
    d = 256
    rng = np.random.default_rng(17)
    q, g = (rng.standard_normal((1, h, s, d)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.standard_normal((1, kvh, s, d)).astype(np.float32)
            for _ in range(2))
    o, lse = flash_forward_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                 qo, ko, True, window)
    delta = (torch.from_numpy(g) * o).sum(-1)
    plan = dkv_plan(1, h, kvh, s, s, qo, ko, True, window, sms)
    # the plan splits, and some chunk starts inside a head's run of steps
    assert plan.slots > 0
    assert any(first % len(dkv_live_q_tiles(kt, s, s, qo, ko, True,
                                            window))
               for kt, _, first, count, _ in plan.chunks if count)
    arrays = (q, k, v, g, lse.numpy(), delta.numpy())
    _, jdk, jdv = flash_hop_backward(*(jnp.asarray(a) for a in arrays), qo,
                                     ko, causal=True, window=window,
                                     block_q=64, block_k=64, interpret=True)
    dk, dv = flash_dkv_chunked_plain(*(torch.from_numpy(a) for a in arrays),
                                     qo, ko, True, window, plan)
    for name_, got, want in (("dk", dk, jdk), ("dv", dv, jdv)):
        assert got.shape == k.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0, err_msg=name_)
    # and the unchunked plain version agrees with both
    pk, pv = flash_dkv_plain(*(torch.from_numpy(a) for a in arrays), qo, ko,
                             True, window)
    torch.testing.assert_close(dk, pk, atol=ATOL, rtol=0)
    torch.testing.assert_close(dv, pv, atol=ATOL, rtol=0)
