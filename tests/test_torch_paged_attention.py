"""Paged decode attention of the PyTorch port against the JAX package.

The same numpy inputs (shuffled block tables, ragged positions) go
through the JAX ``paged_decode_attention`` (the Pallas kernel in
interpret mode) and the port's wrapper, which on CPU tensors runs the
kernel's plain version. f32 throughout; rtol = atol = 2e-5 covers the
online-versus-full-row softmax reassociation.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from elephas_tpu.models.transformer import _alibi_slope_list
from elephas_tpu.ops.paged_attention import \
    paged_decode_attention as jax_paged
from elephas_tpu_torch.ops.paged_attention import (
    paged_decode_attention, paged_decode_attention_plain)

_CASES = {
    "base": dict(h=4, kvh=4, window=None, alibi=False),
    "gqa": dict(h=4, kvh=2, window=None, alibi=False),
    "mqa": dict(h=4, kvh=1, window=None, alibi=False),
    "window": dict(h=4, kvh=4, window=11, alibi=False),
    "alibi": dict(h=4, kvh=4, window=None, alibi=True),
    "gqa_window_alibi": dict(h=4, kvh=2, window=9, alibi=True),
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
    q, kp, vp, ids, pos = _inputs(7, 3, cfg["h"], cfg["kvh"])
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
    out = paged_decode_attention(q, kp, vp, ids, pos, window=5)
    assert paged_decode_attention.launches == before
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
