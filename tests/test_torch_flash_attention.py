"""Flash-attention forward of the PyTorch port against the JAX package.

The same numpy inputs go through the JAX ``flash_hop_forward`` (the
Pallas ``_fwd_kernel`` in interpret mode) and the port's
``flash_forward``, which on CPU tensors runs the kernel's plain
version: O and the per-row LSE, at zero and nonzero global offsets.
f32; atol 2e-5 on O and 1e-4 on LSE (a logsumexp of up to ~100 terms
reassociated).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from elephas_tpu.ops.pallas_attention import flash_attention as jax_flash
from elephas_tpu.ops.pallas_attention import flash_hop_forward
from elephas_tpu_torch.ops.attention import attention
from elephas_tpu_torch.ops.flash_attention import (SUPPORTED_HEAD_DIMS,
                                                   _kernel_operands,
                                                   flash_attention,
                                                   flash_forward,
                                                   flash_forward_plain)

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
}


def _qkv(seed, h, kvh, sq, sk, b=2, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, kvh, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, kvh, sk, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("case", sorted(_CASES))
def test_forward_and_lse_match_jax_hop(case):
    causal, kvh, window, sq, sk, qo, ko = _CASES[case]
    q, k, v = _qkv(3, 4, kvh, sq, sk)
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


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kvh", [4, 2])
def test_flash_attention_matches_jax_flash(causal, kvh):
    q, k, v = _qkv(9, 4, kvh, 33, 33)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, block_q=16,
                               block_k=16, interpret=True))
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal)
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
    """The CUDA bodies' head dims: 64 (the flagship), 32
    (examples/transformer_tpumodel.py) and 16 (examples/http_serving.py);
    csrc/flash_*.cu dispatch the same set."""
    assert SUPPORTED_HEAD_DIMS == (16, 32, 64)


@pytest.mark.parametrize("head_dim", [48, 8])
def test_kernel_operand_check_rejects_other_head_dims(head_dim):
    """A flash kernel call at a head dim with no body raises, naming the
    head dim and the supported set (checked before the device, so a CPU
    tensor shows it)."""
    q, k, v = (torch.from_numpy(a)
               for a in _qkv(7, 4, 2, 8, 8, d=head_dim))
    with pytest.raises(ValueError, match=rf"head_dim {head_dim}: .*"
                       r"\(16, 32, 64\)"):
        _kernel_operands(q, k=k, v=v)
