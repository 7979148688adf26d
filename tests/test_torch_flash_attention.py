"""Flash-attention forward of the PyTorch port against the JAX package.

The same numpy inputs go through the JAX ``flash_hop_forward`` (the
Pallas ``_fwd_kernel`` in interpret mode) and the port's
``flash_forward``, which on CPU tensors runs the kernel's plain
version: O and the per-row LSE, at zero and nonzero global offsets, at
head dim 16 and, in one case each, at 128 (GQA groups of 4 under a
window, the shape Mistral-7B gives the kernels), 96 (Phi-3-mini's head
dim, under a window), 80 (Phi-2's, ragged) and 8 (the repo's small LMs,
a ring hop): the head dims the kernels run on a wider body's
zero-filled columns. ``flash_attention`` also at 256 (Gemma-2B's, H 4
over KVH 1 under a window) and 200 (a filled head dim of the 256-wide
bodies). f32; atol 2e-5 on O and 1e-4 on LSE (a logsumexp
of up to ~100 terms reassociated).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from elephas_tpu.ops.pallas_attention import flash_attention as jax_flash
from elephas_tpu.ops.pallas_attention import flash_hop_forward
from elephas_tpu_torch.ops.attention import attention
from elephas_tpu_torch.ops.flash_attention import (_kernel_operands,
                                                   flash_attention,
                                                   flash_forward,
                                                   flash_forward_plain,
                                                   kernel_takes_head_dim)

# (causal, kvh, window, sq, sk, q_offset, k_offset)
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


def _qkv(seed, h, kvh, sq, sk, b=2, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, kvh, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, kvh, sk, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("case", sorted(_CASES))
def test_forward_and_lse_match_jax_hop(case):
    causal, kvh, window, sq, sk, qo, ko = _CASES[case]
    q, k, v = _qkv(3, 4, kvh, sq, sk, d=_HEAD_DIM.get(case, 16))
    o_ref, lse_ref = flash_hop_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), qo, ko,
        causal=causal, window=window, block_q=16, block_k=16,
        interpret=True)
    o, lse = flash_forward(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), qo, ko, causal=causal,
                           window=window)
    assert o.shape == q.shape and lse.shape == q.shape[:3]
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=2e-5,
                               rtol=0)
    lse_ref = np.asarray(lse_ref)
    live = lse_ref > -1e29
    np.testing.assert_allclose(lse.numpy()[live], lse_ref[live], atol=1e-4,
                               rtol=0)
    # fully masked rows (a hop wholly in the future): O = 0, LSE ~ -1e30
    np.testing.assert_array_equal(lse.numpy()[~live] < -1e29, True)
    np.testing.assert_array_equal(o.numpy()[~live], 0.0)


def test_hop_in_the_future_is_fully_masked():
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 4, 4, 16, 16))
    o, lse = flash_forward(q, k, v, q_offset=0, k_offset=16, causal=True)
    assert torch.all(o == 0)
    assert torch.all(lse < -1e29)


@pytest.mark.parametrize("causal,kvh,window,seq,d", [
    *(pytest.param(causal, kvh, None, 33, 16, id=f"{kvh}-{causal}")
      for kvh in (4, 2) for causal in (True, False)),
    # head dim 128, H 4 over KVH 1 (groups of 4), causal under a window
    pytest.param(True, 1, 40, 64, 128, id="d128-1-True-40"),
    # the head dims of a wider body's filled columns: 96 (Phi-3-mini) MHA
    # under a window, 80 (Phi-2) with GQA 2, 8 non-causal
    pytest.param(True, 4, 9, 24, 96, id="d96-4-True-9"),
    pytest.param(True, 2, None, 21, 80, id="d80-2-True"),
    pytest.param(False, 4, None, 16, 8, id="d8-4-False"),
    # head dim 256, H 4 over KVH 1 (multi-query, Gemma-2B's) under a
    # window; 200, a filled head dim of the 256-wide bodies, GQA 2
    pytest.param(True, 1, 11, 24, 256, id="d256-1-True-11"),
    pytest.param(True, 2, None, 20, 200, id="d200-2-True")])
def test_flash_attention_matches_jax_flash(causal, kvh, window, seq, d):
    q, k, v = _qkv(9, 4, kvh, seq, seq, d=d)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, block_q=16,
                               block_k=16, interpret=True, window=window))
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal, window=window)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=0)


def test_plain_flash_equals_plain_attention():
    """Same function, two plain formulations: the flash plain version
    with expanded GQA heads equals the reference softmax attention."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, 4, 2, 24, 24))
    o, _ = flash_forward_plain(q, k, v, causal=True)
    ref = attention(q, k.repeat_interleave(2, 1), v.repeat_interleave(2, 1),
                    causal=True)
    torch.testing.assert_close(o, ref, atol=2e-6, rtol=0)


def test_cpu_wrapper_launches_nothing():
    q, k, v = (torch.from_numpy(a) for a in _qkv(6, 4, 4, 8, 8))
    before = flash_forward.launches
    flash_forward(q, k, v)
    assert flash_forward.launches == before


def test_flash_attention_tiles_are_fixed():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 4, 4, 8, 8))
    flash_attention(q, k, v, block_q=64, block_k=64)
    with pytest.raises(NotImplementedError):
        flash_attention(q, k, v, block_q=256)


@pytest.mark.parametrize("bad", ["gqa", "window", "rank"])
def test_rejects_bad_arguments(bad):
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 4, 8, 8))
    kwargs = {}
    if bad == "gqa":
        k, v = k[:, :3], v[:, :3]
    elif bad == "window":
        kwargs["window"] = 0
    else:
        q = q[0]
    with pytest.raises(ValueError):
        flash_forward(q, k, v, **kwargs)


def test_kernels_take_the_repo_head_dims():
    """The CUDA kernels take every multiple of 8 from 8 to 256 (bodies
    16, 32, 64, 128 and 256 wide, a head dim below a body's width on its
    zero-filled columns: 64 the flagship, 32 and 16 the examples, 128
    most published LMs, 256 Gemma-2B, 96 Phi-3-mini, 80 Phi-2, 8 the
    repo's small LMs); csrc/hopper.cuh ``takes_head_dim`` is the same
    rule. Not 4, 12, 100, 127 (not multiples of 8), 260 or 264 (past the
    widest body)."""
    assert all(kernel_takes_head_dim(d) for d in range(8, 257, 8))
    assert not any(kernel_takes_head_dim(d)
                   for d in (0, 4, 12, 100, 127, 260, 264))


@pytest.mark.parametrize("head_dim", [100, 260, 264])
def test_kernel_operand_check_rejects_other_head_dims(head_dim):
    """A flash kernel call at a head dim the kernels do not take raises,
    naming the head dim and the rule (checked before the device, so a
    CPU tensor shows it)."""
    q, k, v = (torch.from_numpy(a)
               for a in _qkv(7, 4, 2, 8, 8, d=head_dim))
    with pytest.raises(ValueError, match=rf"head_dim {head_dim}: .*"
                       r"multiple of 8 from 8 to 256"):
        _kernel_operands(q, k=k, v=v)
