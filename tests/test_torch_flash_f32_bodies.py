"""The routing and the work plan of the port's f32 flash backward, and
its chunked sums against the JAX package.

In f32 the dQ and dK/dV kernels run on the tensor cores as 3xTF32
products at every head dim (``csrc/flash_bwd_f32.cu``): strip bodies at
head dims 8-32 (``f32_narrow_body``), and at 40-256 bodies of widths 64,
128 and 256 (``f32_wide_body``) whose dK/dV runs one CTA a chunk of a
``dkv_plan`` of its own geometry: k tiles of 64 key rows (32 at width
256), steps of (query head of the GQA group, live q tile of 64 rows, 32
at 256), the chunks of a split k tile writing f32 partials that a
reduction sums in chunk order. The kernels need the card; what decides
their work is pure Python, so it is checked here:

- the routing: which dtype and head dim go to which f32 body, and which
  calls get a plan of which geometry (bf16 keeps its 256-wide body's);
- the plan covers the work exactly at each f32 geometry: against a
  brute-force list of live (head, q tile) steps per k tile (from the
  element mask, not the kernels' tile test), under causal and
  non-causal masks, windows, ragged lengths and ring-hop offsets;
- it spreads Gemma-2B's single kv head: at ``lm_d256``'s f32 gradient
  (B 1, H 8 over KVH 1, S 512) the 16 k tiles of 32 rows become one
  wave of chunks on 132 SMs, where one CTA a k tile ran 16;
- the reduction adds a split tile's f32 partials in slot order without
  a cast;
- the chunked sums match JAX: ``flash_dkv_chunked_plain`` on an f32
  plan (each chunk's plain dK and dV as an f32 partial, summed in the
  plan's order) against the JAX ``flash_hop_backward`` (the Pallas
  ``_dkv_kernel`` in interpret mode) on the same numpy inputs, at head
  dims 64, 96 and 256, GQA groups of 4 and 8, causal, windowed and a
  ring hop. Tolerance: 8 ulps of the largest gradient, as in
  ``tests/test_torch_flash_dkv_plan.py``: 4e-6 at d 64-96, 8e-6 at 256.

Torch runs one intra-op thread for the module, as the speculative files
do: under the parallel test run a pool a worker oversubscribes the cores.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from elephas_tpu.ops.pallas_attention import flash_hop_backward
from elephas_tpu_torch.ops import flash_attention as fa
from elephas_tpu_torch.ops.flash_attention import (
    body_width, dkv_live_q_tiles, dkv_plan, dkv_step, f32_narrow_body,
    f32_wide_body, flash_backward, flash_dkv_chunked_plain, flash_dkv_plain,
    flash_dkv_reduce, flash_forward_plain)
from tests.torch_one_thread import one_thread  # noqa: F401

HEAD_DIMS = list(range(8, 257, 8))


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_each_head_dim_has_one_f32_body(d):
    """f32 runs the strip bodies at 8-32 and the tensor-core bodies of
    widths 64-256 at 40-256, one of the two at every head dim; bf16 runs
    neither; the body is the narrowest of 16-256 at least d wide."""
    assert f32_narrow_body(torch.float32, d) == (d <= 32)
    assert f32_wide_body(torch.float32, d) == (d > 32)
    assert not (f32_narrow_body(torch.bfloat16, d)
                or f32_wide_body(torch.bfloat16, d))
    w = body_width(d)
    assert w in (16, 32, 64, 128, 256) and w >= d and (w == 16 or w // 2 < d)


@pytest.mark.parametrize("dtype, d, want", [
    (torch.float32, 16, None), (torch.float32, 32, None),
    (torch.float32, 40, (64, 64)), (torch.float32, 64, (64, 64)),
    (torch.float32, 96, (64, 64)), (torch.float32, 128, (64, 64)),
    (torch.float32, 136, (32, 32)), (torch.float32, 256, (32, 32)),
    (torch.bfloat16, 64, None), (torch.bfloat16, 128, None),
    (torch.bfloat16, 136, (64, 64)), (torch.bfloat16, 256, (64, 64))])
def test_which_calls_run_a_plan(monkeypatch, dtype, d, want):
    """A dK/dV call gets a plan where its body runs one: the 256-wide
    bf16 body (64-row k and q tiles), the f32 tensor-core bodies (64, or
    32 at width 256); the f32 plan counts the body's CTAs an SM (2 at
    width 64) on the card's SMs."""
    monkeypatch.setattr(fa, "_multiprocessors", lambda device: 132)
    q = torch.zeros((1, 8, 100, d), dtype=dtype)
    k = torch.zeros((1, 2, 100, d), dtype=dtype)
    plan = fa._dkv_plan_for(q, k, 0, 0, True, None)
    if want is None:
        assert plan is None
        return
    assert (plan.rows, plan.q_rows) == want
    ctas = 2 if f32_wide_body(dtype, d) and body_width(d) == 64 else 1
    assert plan == dkv_plan(1, 8, 2, 100, 100, 0, 0, True, None,
                            132 * ctas, *want)


# (B, H, KVH, Sq, Sk, causal, window, q_offset, k_offset, SMs)
_PLAN_CASES = {
    "lm_d256_grad": (1, 8, 1, 512, 512, True, None, 0, 0, 132),
    "lm_d128_grad": (1, 32, 8, 512, 512, True, None, 0, 0, 132),
    "train_parity": (2, 16, 16, 1024, 1024, True, None, 0, 0, 264),
    "noncausal_ragged": (1, 8, 2, 100, 65, False, None, 0, 0, 132),
    "window_ragged": (1, 4, 1, 517, 517, True, 65, 0, 0, 24),
    "hop_past": (1, 16, 1, 200, 200, True, None, 256, 128, 132),
    "hop_future": (1, 4, 2, 128, 128, True, None, 0, 128, 132),
    "hop_window": (1, 4, 4, 330, 250, True, 90, 300, 120, 17),
    "sq_one": (2, 8, 1, 1, 300, True, None, 299, 0, 132),
}


def _live_steps(case, rows, q_rows):
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
    out = {}
    for row in range(b * kvh):
        for kt in range(-(-sk // rows)):
            ks = slice(kt * rows, (kt + 1) * rows)
            live = [qi for qi in range(-(-sq // q_rows))
                    if valid[qi * q_rows:(qi + 1) * q_rows, ks].any()]
            out[row, kt] = [(g, qi) for g in range(h // kvh) for qi in live]
    return out


@pytest.mark.parametrize("rows", [64, 32])
@pytest.mark.parametrize("name", sorted(_PLAN_CASES))
def test_f32_plan_covers_the_live_steps_exactly(name, rows):
    case = _PLAN_CASES[name]
    b, h, kvh, sq, sk, causal, window, qo, ko, sms = case
    plan = dkv_plan(b, h, kvh, sq, sk, qo, ko, causal, window, sms, rows,
                    rows)
    want = _live_steps(case, rows, rows)
    by_tile = {}
    for kt, row, first, count, slot in plan.chunks:
        by_tile.setdefault((row, kt), []).append((first, count, slot))
    assert set(by_tile) == set(want), "every k tile has a chunk"
    split = {(row, kt): (slot0, n) for kt, row, slot0, n in plan.reduce}
    slots = []
    for key, chunks in by_tile.items():
        chunks.sort()
        live = dkv_live_q_tiles(key[1], sq, sk, qo, ko, causal, window,
                                rows, rows)
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
    counts = [c[3] for c in plan.chunks]
    assert counts == sorted(counts, reverse=True)


def test_f32_plan_spreads_a_single_kv_head():
    """``lm_d256``'s f32 gradient (Gemma-2B: 8 query heads over 1 kv
    head, S 512): 16 k tiles of 32 rows, 1088 (head, q tile) steps,
    become 128 chunks of at most 9 steps, one wave on 132 SMs; d 64's
    ``train_parity`` (B 2, H = KVH 16, S 1024) splits nothing."""
    fit = dkv_plan(1, 8, 1, 512, 512, 0, 0, True, None, 132, 32, 32)
    counts = [c[3] for c in fit.chunks]
    assert sum(counts) == 8 * 136 and max(counts) == 9
    assert 16 < len(fit.chunks) <= 132 and len(fit.reduce) == 15
    parity = dkv_plan(2, 16, 16, 1024, 1024, 0, 0, True, None, 264, 64, 64)
    assert len(parity.chunks) == 2 * 16 * 16 and parity.slots == 0


def test_f32_reduction_sums_in_chunk_order():
    """The f32 reduction adds each split tile's partials (32-row k tiles
    of the 256-wide body) in slot order and writes the sum uncast; the
    CPU wrapper runs the plain version and launches nothing."""
    plan = dkv_plan(1, 8, 1, 100, 100, 0, 0, True, None, 132, 32, 32)
    assert plan.reduce and plan.rows == 32
    rng = np.random.default_rng(5)
    partials = torch.from_numpy(rng.standard_normal(
        (plan.slots, 2, 32, 256)).astype(np.float32))
    dk = torch.full((1, 1, 100, 200), 7.0)
    dv = dk.clone()
    before = flash_backward.dkv_reduce_launches
    flash_dkv_reduce(partials, plan, dk, dv)
    assert flash_backward.dkv_reduce_launches == before
    for kt, row, slot0, n in plan.reduce:
        rows = min(32, 100 - kt * 32)
        acc = partials[slot0]
        for s in range(slot0 + 1, slot0 + n):
            acc = acc + partials[s]
        assert torch.equal(dk[0, row, kt * 32:kt * 32 + rows],
                           acc[0, :rows, :200])
        assert torch.equal(dv[0, row, kt * 32:kt * 32 + rows],
                           acc[1, :rows, :200])
    split = {kt for kt, *_ in plan.reduce}
    for kt in set(range(4)) - split:
        assert bool((dk[0, 0, kt * 32:(kt + 1) * 32] == 7).all())


# (d, H, KVH, S, window, q_offset, k_offset, SMs): f32 plans whose chunks
# cross the group's head boundaries
_JAX_CASES = {
    "d64_gqa8_causal": (64, 8, 1, 130, None, 0, 0, 10),
    "d96_gqa4_window_hop": (96, 8, 2, 150, 60, 70, 20, 13),
    "d256_gqa8_causal": (256, 8, 1, 100, None, 0, 0, 12),
}


@pytest.mark.parametrize("name", sorted(_JAX_CASES))
def test_f32_chunked_sums_match_jax(name):
    d, h, kvh, s, window, qo, ko, sms = _JAX_CASES[name]
    rows = fa._F32_WIDE[body_width(d)][0]
    rng = np.random.default_rng(19)
    q, g = (rng.standard_normal((1, h, s, d)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.standard_normal((1, kvh, s, d)).astype(np.float32)
            for _ in range(2))
    o, lse = flash_forward_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                 qo, ko, True, window)
    delta = (torch.from_numpy(g) * o).sum(-1)
    plan = dkv_plan(1, h, kvh, s, s, qo, ko, True, window, sms, rows, rows)
    assert plan.slots > 0 and plan.rows == rows
    assert any(first % len(dkv_live_q_tiles(kt, s, s, qo, ko, True, window,
                                            rows, rows))
               for kt, _, first, count, _ in plan.chunks if count)
    arrays = (q, k, v, g, lse.numpy(), delta.numpy())
    _, jdk, jdv = flash_hop_backward(*(jnp.asarray(a) for a in arrays), qo,
                                     ko, causal=True, window=window,
                                     block_q=64, block_k=64, interpret=True)
    dk, dv = flash_dkv_chunked_plain(*(torch.from_numpy(a) for a in arrays),
                                     qo, ko, True, window, plan)
    atol = 8e-6 if d > 128 else 4e-6
    for name_, got, want in (("dk", dk, jdk), ("dv", dv, jdv)):
        assert got.shape == k.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                                   rtol=0, err_msg=name_)
    pk, pv = flash_dkv_plain(*(torch.from_numpy(a) for a in arrays), qo, ko,
                             True, window)
    torch.testing.assert_close(dk, pk, atol=atol, rtol=0)
    torch.testing.assert_close(dv, pv, atol=atol, rtol=0)
