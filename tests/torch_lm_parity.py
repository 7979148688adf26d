"""Shared pieces of the LM parity tests of packed rows, MoE and int8
(``test_torch_packed.py``, ``test_torch_moe.py``,
``test_torch_quantization.py``).

Both packages get the same weights: the port draws them from a seeded
``torch.Generator`` and the JAX side takes the same numbers through
numpy, which spares every test the JAX initializer's per-op compiles.
The JAX functions run jitted (one compile per config and shape instead
of one per primitive), with the config static.
"""
import jax
import jax.numpy as jnp
import torch

from elephas_tpu.models import transformer as jtr
from elephas_tpu_torch.models import transformer as ttr
from elephas_tpu_torch.weights import to_numpy_tree
from tests.torch_one_thread import one_thread

jax_forward = jax.jit(jtr.forward, static_argnums=2)
jax_forward_with_aux = jax.jit(jtr.forward_with_aux, static_argnums=2)
jax_lm_loss = jax.jit(jtr.lm_loss, static_argnums=2)
jax_loss_and_grads = jax.jit(jax.value_and_grad(jtr.lm_loss),
                             static_argnums=2)
jax_prefill = jax.jit(jtr.prefill_cache, static_argnums=(2, 3))
jax_decode_block = jax.jit(jtr.decode_block, static_argnums=4)


def configs(base, variants, variant, **extra):
    """(JAX config on its plain attention path, port config), f32."""
    kw = {**base, **variants[variant], **extra}
    return (jtr.TransformerConfig(**{**kw, "dtype": jnp.float32,
                                     "attention_impl": "xla"}),
            ttr.TransformerConfig(dtype=torch.float32, **kw))


def params(tcfg, seed=0):
    """(the JAX tree, the port tree): one seeded draw, both packages."""
    tp = ttr.init_params(tcfg, torch.Generator().manual_seed(seed), "cpu")
    return jax.tree_util.tree_map(jnp.asarray, to_numpy_tree(tp)), tp
