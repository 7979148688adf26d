"""Flash-attention backward of the PyTorch port against the JAX package.

The same numpy q, k, v, dO and the same lse/delta go through the JAX
``flash_hop_backward`` (the Pallas ``_dq_kernel`` and ``_dkv_kernel`` in
interpret mode) and the port's ``flash_backward``, which on CPU tensors
runs the kernels' plain versions; f32, atol 2e-6 on dq/dk/dv (sums of
at most ~200 f32 products reassociated). One case of each parity test
runs at head dim 128 (H 4 over KVH 1, causal under a window, the shape
Mistral-7B gives the kernels), one each at 96 (Phi-3-mini's head dim),
80 (Phi-2's) and 8 (the repo's small LMs), the head dims the kernels run
on a wider body's zero-filled columns, the rest at 16 (autograd also at
256, H 4 over KVH 1 under a window, and 200); at 128, 96 and
80 the S and dP dot products run over 5-8 times the terms and dq
reaches |4|, so their atol is 4e-6 (about 8 ulps of the largest
gradient). Autograd through the port's
``flash_attention`` is held against ``jax.grad`` of the JAX
``flash_attention`` at the JAX package's own gradient tolerances
(``tests/ops/test_pallas_attention.py``: atol 5e-5, rtol 5e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from elephas_tpu.ops.pallas_attention import flash_attention as jax_flash
from elephas_tpu.ops.pallas_attention import flash_hop_backward
from elephas_tpu_torch.ops.flash_attention import (flash_attention,
                                                   flash_backward,
                                                   flash_backward_plain,
                                                   flash_dkv, flash_dq,
                                                   flash_forward_plain)
from tests.torch_one_thread import one_thread

# (causal, kvh, window, sq, sk, q_offset, k_offset), as the forward tests
_CASES = {
    "causal": (True, 4, None, 40, 40, 0, 0),
    "noncausal": (False, 4, None, 40, 40, 0, 0),
    "gqa": (True, 2, None, 40, 40, 0, 0),
    "window": (True, 4, 7, 40, 40, 0, 0),
    "ragged": (True, 4, None, 37, 37, 0, 0),
    "ragged_noncausal": (False, 1, None, 21, 45, 0, 0),
    "hop_past": (True, 4, None, 32, 32, 64, 32),
    "hop_future": (True, 2, None, 32, 32, 0, 32),
    "hop_window": (True, 4, 20, 32, 32, 64, 32),
    "d128_gqa4_window": (True, 1, 40, 64, 64, 0, 0),
    "d96_window": (True, 4, 9, 24, 24, 0, 0),
    "d80_ragged": (True, 2, None, 21, 21, 0, 0),
    "d8_hop_past": (True, 4, None, 16, 16, 32, 16),
}
# the cases at another head dim than 16
_HEAD_DIM = {"d128_gqa4_window": 128, "d96_window": 96, "d80_ragged": 80,
             "d8_hop_past": 8}


def _inputs(seed, case, b=2, h=4):
    causal, kvh, window, sq, sk, qo, ko = _CASES[case]
    d = _HEAD_DIM.get(case, 16)
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, kvh, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, kvh, sk, d)).astype(np.float32)
    g = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    # the row statistics of this shard pair's forward
    o, lse = flash_forward_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                 qo, ko, causal, window)
    delta = (torch.from_numpy(g) * o).sum(-1)
    return (q, k, v, g, lse.numpy(), delta.numpy()), (qo, ko, causal, window)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_backward_matches_jax_hop(case):
    arrays, (qo, ko, causal, window) = _inputs(7, case)
    ref = flash_hop_backward(*(jnp.asarray(a) for a in arrays), qo, ko,
                             causal=causal, window=window, block_q=16,
                             block_k=16, interpret=True)
    out = flash_backward(*(torch.from_numpy(a) for a in arrays), qo, ko,
                         causal, window)
    atol = 4e-6 if _HEAD_DIM.get(case, 16) >= 80 else 2e-6
    for name, got, want, like in zip(("dq", "dk", "dv"), out, ref,
                                     arrays[:3]):
        assert got.shape == like.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                                   rtol=0, err_msg=name)
    if case == "hop_future":
        # a hop wholly in the future contributes nothing
        assert all(bool((t == 0).all()) for t in out)


@pytest.mark.parametrize("case", ["causal", "gqa", "hop_window"])
def test_split_kernels_equal_the_pair(case):
    """``flash_dq`` and ``flash_dkv`` (one kernel each) give what
    ``flash_backward`` and the plain version give."""
    arrays, offs = _inputs(8, case)
    t = [torch.from_numpy(a) for a in arrays]
    dq, dk, dv = flash_backward_plain(*t, *offs)
    torch.testing.assert_close(flash_dq(*t, *offs), dq, atol=0, rtol=0)
    got_dk, got_dv = flash_dkv(*t, *offs)
    torch.testing.assert_close(got_dk, dk, atol=0, rtol=0)
    torch.testing.assert_close(got_dv, dv, atol=0, rtol=0)


@pytest.mark.parametrize("kvh,causal,window,seq,d", [
    *(pytest.param(kvh, causal, window, 27, 16,
                   id=f"{kvh}-{causal}-{window}")
      for kvh in (4, 2) for causal in (True, False) for window in (None, 9)),
    # head dim 128, H 4 over KVH 1 (groups of 4), causal under a window
    pytest.param(1, True, 40, 64, 128, id="d128-1-True-40"),
    # the head dims of a wider body's filled columns: 96 (Phi-3-mini) MHA
    # under a window, 80 (Phi-2) with GQA 2, 8 non-causal
    pytest.param(4, True, 9, 16, 96, id="d96-4-True-9"),
    pytest.param(2, True, None, 16, 80, id="d80-2-True-None"),
    pytest.param(4, False, None, 16, 8, id="d8-4-False-None"),
    # head dim 256, H 4 over KVH 1 (multi-query, Gemma-2B's) under a
    # window; 200, a filled head dim of the 256-wide bodies, GQA 2
    pytest.param(1, True, 11, 24, 256, id="d256-1-True-11"),
    pytest.param(2, True, None, 20, 200, id="d200-2-True-None")])
def test_autograd_matches_jax_grad(causal, kvh, window, seq, d):
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 4, seq, d)).astype(np.float32)
    k = rng.standard_normal((2, kvh, seq, d)).astype(np.float32)
    v = rng.standard_normal((2, kvh, seq, d)).astype(np.float32)

    def jloss(q, k, v):
        o = jax_flash(q, k, v, causal=causal, block_q=16, block_k=16,
                      interpret=True, window=window)
        return jnp.sum(jnp.sin(o))

    ref = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    torch.sin(flash_attention(tq, tk, tv, causal=causal,
                              window=window)).sum().backward()
    for name, got, want in zip("qkv", (tq, tk, tv), ref):
        assert got.grad.shape == got.shape
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   atol=5e-5, rtol=5e-4, err_msg=f"d{name}")


def test_autograd_takes_a_non_contiguous_gradient():
    """The Function makes the incoming gradient contiguous: a transposed
    view upstream gives the same gradients as a contiguous one."""
    rng = np.random.default_rng(10)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 12, 8))
                                .astype(np.float32)).requires_grad_()
               for _ in range(3))
    w = torch.from_numpy(rng.standard_normal((8, 12)).astype(np.float32))
    o = flash_attention(q, k, v, causal=True)
    (o.transpose(2, 3) * w).sum().backward()
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    (flash_attention(q, k, v, causal=True) * w.T).sum().backward()
    for a, t in zip(got, (q, k, v)):
        torch.testing.assert_close(a, t.grad, atol=1e-6, rtol=0)


def test_cpu_wrappers_launch_nothing():
    arrays, offs = _inputs(11, "causal")
    before = (flash_backward.dq_launches, flash_backward.dkv_launches)
    flash_backward(*(torch.from_numpy(a) for a in arrays), *offs)
    assert (flash_backward.dq_launches,
            flash_backward.dkv_launches) == before


@pytest.mark.parametrize("bad", ["g_shape", "lse_dtype", "delta_shape",
                                 "window"])
def test_backward_rejects_bad_arguments(bad):
    arrays, (qo, ko, causal, window) = _inputs(12, "causal")
    q, k, v, g, lse, delta = (torch.from_numpy(a) for a in arrays)
    if bad == "g_shape":
        g = g[:, :, :-1]
    elif bad == "lse_dtype":
        lse = lse.double()
    elif bad == "delta_shape":
        delta = delta[0]
    else:
        window = 0
    with pytest.raises(ValueError):
        flash_backward(q, k, v, g, lse, delta, qo, ko, causal, window)
