"""Training path of the PyTorch port against the JAX package.

Identical weights (the JAX ``init_params`` tree through the weight
bridge) and identical numpy tokens go through both packages: ``lm_loss``
values and gradients (dense and chunked-vocab loss, label smoothing,
z-loss, GQA, RoPE + RMSNorm + SwiGLU, a window, an untied head) and
rematerialization; the train step and ``TransformerModel`` are held
against JAX in ``test_torch_train_step.py``. The port runs both
its attention paths (the flash kernels' plain versions and the plain
path); the JAX side runs its plain attention, which its own tests hold
equal to its Pallas kernels (``tests/ops/test_pallas_attention.py``);
the kernels themselves are held against the Pallas ones in
``test_torch_flash_backward.py``. f32 throughout. Tolerances: loss atol
1e-5 and gradients atol 1e-5 (two layers of f32 matmuls summed in
another order).

Dropout masks cannot equal JAX's bits (another generator), so dropout
is checked on its own terms: rate 0 equals no dropout; a rate > 0 is
deterministic for a given generator and zeroes a share near the rate;
and with ``remat=True`` the gradient equals the one without remat under
the same generator.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from elephas_tpu.models import transformer as jtr
from elephas_tpu_torch.models import transformer as ttr
from elephas_tpu_torch.weights import from_numpy_tree

_BASE = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
             max_seq_len=48)
_VARIANTS = {
    "dense": {},
    "chunked_smooth_z": {"loss_vocab_chunk": 24, "label_smoothing": 0.1,
                         "z_loss_weight": 1e-3},
    "dense_smooth_z": {"label_smoothing": 0.1, "z_loss_weight": 1e-3},
    "gqa": {"num_kv_heads": 2},
    "rope_rmsnorm_swiglu": {"positional": "rope", "norm": "rmsnorm",
                            "mlp_variant": "swiglu", "num_kv_heads": 1},
    "window_untied_chunked": {"attention_window": 5,
                              "tied_embedding": False,
                              "loss_vocab_chunk": 16},
}


def _configs(variant="dense", attention_impl="xla", **extra):
    """(JAX config on its plain attention, port config on ``impl``)."""
    kw = dict(_BASE, **_VARIANTS[variant], **extra)
    return (jtr.TransformerConfig(dtype=jnp.float32, attention_impl="xla",
                                  **kw),
            ttr.TransformerConfig(dtype=torch.float32,
                                  attention_impl=attention_impl, **kw))


def _params(jcfg, seed=0):
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, from_numpy_tree(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")


def _tokens(seed, shape=(2, 19)):
    return np.random.default_rng(seed).integers(0, _BASE["vocab_size"],
                                                shape)


_jax_grad = jax.jit(jax.value_and_grad(jtr.lm_loss), static_argnums=2)


def _jax_value_and_grad(jp, tokens, jcfg):
    return _jax_grad(jp, jnp.asarray(tokens), jcfg)


def _value_and_grad(tp, tokens, tcfg, dropout_key=None):
    loss, grads = ttr.lm_loss_and_grads(tp, torch.from_numpy(tokens), tcfg,
                                        dropout_key=dropout_key)
    return float(loss), grads


@pytest.mark.parametrize("impl", ["flash", "xla"])
@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_lm_loss_value_and_grad_match_jax(variant, impl):
    jcfg, tcfg = _configs(variant, attention_impl=impl)
    jp, tp = _params(jcfg)
    tokens = _tokens(1)
    ref_loss, ref_grads = _jax_value_and_grad(jp, tokens, jcfg)
    loss, grads = _value_and_grad(tp, tokens, tcfg)
    assert abs(loss - float(ref_loss)) <= 1e-5
    for a, b in zip(jax.tree_util.tree_leaves(ref_grads), grads):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_remat_gives_the_same_values_and_gradients(impl, policy):
    jcfg, tcfg = _configs("gqa", attention_impl=impl)
    jp, tp = _params(jcfg, seed=3)
    tokens = _tokens(4)
    ref_loss, ref_grads = _jax_value_and_grad(jp, tokens, jcfg)
    loss, grads = _value_and_grad(tp, tokens, dataclasses.replace(
        tcfg, remat=True, remat_policy=policy))
    plain_loss, plain_grads = _value_and_grad(tp, tokens, tcfg)
    assert abs(loss - float(ref_loss)) <= 1e-5
    assert loss == plain_loss
    for a, b, c in zip(jax.tree_util.tree_leaves(ref_grads), grads,
                       plain_grads):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5,
                                   rtol=0)
        torch.testing.assert_close(b, c, atol=1e-7, rtol=0)


def test_dropout_rate_zero_equals_no_dropout():
    _, tcfg = _configs()
    params = ttr.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(_tokens(8))
    ref = ttr.forward(params, tokens, tcfg)
    out = ttr.forward(params, tokens, tcfg,
                      dropout_key=torch.Generator().manual_seed(1))
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


def test_dropout_is_deterministic_and_drops_near_the_rate():
    x = torch.ones((64, 64, 32))
    gen = torch.Generator().manual_seed(2)
    a = ttr._dropout(x, 0.3, gen)
    b = ttr._dropout(x, 0.3, torch.Generator().manual_seed(2))
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    share = float((a == 0).float().mean())
    assert abs(share - 0.3) < 0.01
    # kept entries are scaled by 1 / keep (inverted dropout)
    torch.testing.assert_close(a[a != 0], torch.full_like(a[a != 0],
                                                          1 / 0.7))
    _, tcfg = _configs(dropout_rate=0.2)
    params = ttr.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(_tokens(9))
    runs = [ttr.forward(params, tokens, tcfg,
                        dropout_key=torch.Generator().manual_seed(s))
            for s in (5, 5, 6)]
    torch.testing.assert_close(runs[0], runs[1], atol=0, rtol=0)
    assert not torch.equal(runs[0], runs[2])


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_dropout_under_remat_keeps_its_masks(impl):
    """The recomputed forward draws the same masks: remat's gradient
    equals the gradient without remat under the same generator."""
    _, tcfg = _configs(dropout_rate=0.3, attention_impl=impl)
    params = ttr.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tokens = _tokens(10)
    loss, grads = _value_and_grad(params, tokens, tcfg,
                                  torch.Generator().manual_seed(7))
    rloss, rgrads = _value_and_grad(
        params, tokens, dataclasses.replace(tcfg, remat=True),
        torch.Generator().manual_seed(7))
    assert loss == rloss
    for a, b in zip(grads, rgrads):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=0)
