"""A small LM shaped like Gemma-2B through the port and the JAX package.

Head dim 256 (d_model 1024 over 4 heads) over one kv head (multi-query),
SwiGLU, RMSNorm, RoPE and a tied embedding: the shape google/gemma-2b
gives the flash kernels (their 256-wide bodies) and the paged kernel
(its general body in f32, groups of 4 here; in bf16 at Gemma-2B's
widths its 256-wide split body, groups of 8), at 2
layers, d_ff 256 and vocab 64. Identical weights (the port's initial
weights as a numpy tree, which the JAX package takes as they are, or
``set_weights(jax_model.get_weights())``; the tree's ``wk``/``wv`` are
``(d_model, 1, 256)``) and identical numpy tokens go through both
packages. The port runs its flash path (the kernels' plain versions on
the CPU; the kernels themselves are held against the Pallas ones at
head dim 256 in ``test_torch_flash_attention.py`` and
``test_torch_flash_backward.py``) and the JAX package its plain
attention. f32 throughout. Tolerances: logits atol 1e-4 and the loss
1e-5; gradients atol 1e-5; one ``fit_tokens`` epoch's history atol 1e-5
and weights atol 1e-4 under AdamW with epsilon 1e-5 (as in
``test_torch_head_dim_96.py``); paged greedy tokens equal to the JAX
``generate``'s, tie-aware (a row may diverge only where the reference's
top-2 logit gap is below 1e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

torch = pytest.importorskip("torch")

from elephas_tpu.models import optimizers as jopt
from elephas_tpu.models import transformer as jtr
from elephas_tpu.models.transformer_model import TransformerModel as JModel
from elephas_tpu_torch.models import optimizers as topt
from elephas_tpu_torch.models import transformer as ttr
from elephas_tpu_torch.models.transformer_model import TransformerModel
from elephas_tpu_torch.serving_engine import DecodeEngine
from elephas_tpu_torch.weights import to_numpy_tree
from tests.torch_one_thread import one_thread

# Gemma-2B's shape (google/gemma-2b config.json: head dim 256, one kv
# head, a gated MLP, RMSNorm, RoPE theta 10000, tied embeddings) at the
# size of a CPU test
_CFG = dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=1,
            d_model=1024, d_ff=256, max_seq_len=48, positional="rope",
            rope_theta=10000.0, norm="rmsnorm", mlp_variant="swiglu",
            tied_embedding=True)


@pytest.fixture(scope="module")
def model():
    jcfg = jtr.TransformerConfig(dtype=jnp.float32, attention_impl="xla",
                                 **_CFG)
    tcfg = ttr.TransformerConfig(dtype=torch.float32, attention_impl="flash",
                                 **_CFG)
    assert tcfg.head_dim == 256 and tcfg.kv_heads == 1
    tp = ttr.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tree = to_numpy_tree(tp)
    assert tree["layer_0"]["attn"]["wk"].shape == (1024, 1, 256)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    return jp, jcfg, tp, tcfg


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, _CFG["vocab_size"],
                                                shape)


def test_logits_match_jax(model):
    jp, jcfg, tp, tcfg = model
    tokens = _tokens(1, (2, 40))
    ref = np.asarray(jax.jit(jtr.forward, static_argnums=2)(
        jp, jnp.asarray(tokens), jcfg))
    out = ttr.forward(tp, torch.from_numpy(tokens), tcfg)
    assert out.shape == (2, 40, _CFG["vocab_size"])
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


def test_lm_loss_gradient_matches_jax(model):
    jp, jcfg, tp, tcfg = model
    tokens = _tokens(2, (2, 40))
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jtr.lm_loss),
                                  static_argnums=2)(jp, jnp.asarray(tokens),
                                                    jcfg)
    loss, grads = ttr.lm_loss_and_grads(tp, torch.from_numpy(tokens), tcfg)
    assert abs(float(loss) - float(ref_loss)) <= 1e-5
    ref_leaves = jax.tree_util.tree_leaves(ref_grads)
    assert len(ref_leaves) == len(grads)
    for a, b in zip(ref_leaves, grads):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5,
                                   rtol=0)


def test_fit_tokens_epoch_matches_jax(model):
    _, jcfg, tp, tcfg = model
    # one device: the test process holds a virtual 8-device CPU mesh
    one = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jm = JModel(jcfg, mesh=one)
    jm.params, jm.built = to_numpy_tree(tp), True
    jm.compile(jopt.AdamW(1e-3, epsilon=1e-5), seed=0)
    tm = TransformerModel(tcfg, device="cpu").compile(
        topt.AdamW(1e-3, epsilon=1e-5), seed=1)
    tm.set_weights(jm.get_weights())
    tokens = _tokens(3, (4, 33))
    kw = dict(epochs=1, batch_size=4, seed=3)
    ref, hist = jm.fit_tokens(tokens, **kw), tm.fit_tokens(tokens, **kw)
    np.testing.assert_allclose(hist["loss"], ref["loss"], atol=1e-5, rtol=0)
    for a, b in zip(jm.get_weights(), tm.get_weights()):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=0)


def test_paged_greedy_tokens_match_jax_generate(model):
    """The port's paged engine on the fused kernel's path (its plain
    version here; the general body at head dim 256 on the card) against
    the JAX ``generate``."""
    jp, jcfg, tp, tcfg = model
    prompts = [_tokens(10 + i, n).tolist() for i, n in enumerate((20, 7))]
    eng = DecodeEngine(tp, tcfg, max_slots=2, paged=(12, 8), kernel="fused",
                       device="cpu")
    outs = eng.run(prompts, 10)
    assert eng.stats["kernel"] == "fused"
    for p, o in zip(prompts, outs):
        ref = [int(t) for t in np.asarray(
            jtr.generate(jp, jnp.asarray([p]), 10, jcfg))[0]]
        if o == ref:
            continue
        i = next(j for j, (a, b) in enumerate(zip(ref, o)) if a != b)
        ctx = jnp.asarray([p + ref[:i]])
        top2 = jax.lax.top_k(jtr.forward(jp, ctx, jcfg)[0, -1], 2)[0]
        assert float(top2[0] - top2[1]) < 1e-3, (i, ref, o)
