"""Draft-model distillation for speculative decoding.

The counterpart of ``elephas_tpu/models/distill.py``:
:func:`make_distill_step` trains a small transformer (the draft) to
imitate a frozen large one (the target) by minimizing the KL divergence
between their next-token distributions, optionally mixed with the plain
next-token cross-entropy. Speculative decoding emits ``1 + gamma *
acceptance`` tokens per target weight read, and acceptance is how often
the draft's proposals match the target: the quantity KL training
raises directly.

Both models run :func:`~elephas_tpu_torch.models.transformer.forward`,
so on a CUDA device the target's forward launches the flash forward
kernel and the draft's forward and backward the flash forward, dQ and
dK/dV kernels. The target runs under ``torch.no_grad()`` (the JAX
package's ``stop_gradient``): it gets no gradient and keeps no graph.
"""
from typing import Dict

import torch

from .transformer import (TransformerConfig, apply_updates, forward,
                          value_and_grads)

__all__ = ["distill_loss", "make_distill_step"]


def distill_loss(draft_params: Dict, target_params: Dict,
                 tokens: torch.Tensor, draft_config: TransformerConfig,
                 target_config: TransformerConfig,
                 temperature: float = 1.0,
                 hard_weight: float = 0.0) -> torch.Tensor:
    """Mean KL(target || draft) over next-token positions at the given
    softening ``temperature``, scaled by ``temperature**2`` (keeping the
    gradient's magnitude comparable across temperatures);
    ``hard_weight`` mixes in the ground-truth cross-entropy. Gradients
    flow into ``draft_params`` only."""
    device = draft_params["embed"]["tokens"].device
    tokens = torch.as_tensor(tokens, device=device).long()
    with torch.no_grad():
        t_logits = forward(target_params, tokens, target_config)
    d_logits = forward(draft_params, tokens, draft_config)
    t_logp = torch.log_softmax(
        t_logits[:, :-1].float() / temperature, dim=-1)
    d_logp = torch.log_softmax(
        d_logits[:, :-1].float() / temperature, dim=-1)
    kl = torch.sum(torch.exp(t_logp) * (t_logp - d_logp), dim=-1)
    loss = (temperature ** 2) * kl.mean()
    if hard_weight > 0.0:
        targets = tokens[:, 1:]
        ce = -torch.gather(
            torch.log_softmax(d_logits[:, :-1].float(), dim=-1), 2,
            targets[..., None])[..., 0]
        loss = loss + hard_weight * ce.mean()
    return loss


def make_distill_step(draft_config: TransformerConfig,
                      target_config: TransformerConfig, tx,
                      temperature: float = 1.0, hard_weight: float = 0.0):
    """Build a ``(draft_params, target_params, opt_state, tokens) ->
    (draft_params, opt_state, loss)`` step. ``tx`` is a transform of
    :mod:`~elephas_tpu_torch.models.optimizers` (``init(params)``,
    ``update(grads, state, params)``), as :func:`~elephas_tpu_torch.
    models.transformer.make_train_step` takes. The target is frozen;
    the draft's parameters are updated IN PLACE (where JAX returns new
    buffers) and the same dict is returned."""

    def step(draft_params, target_params, opt_state, tokens):
        loss, grads = value_and_grads(
            lambda d: distill_loss(d, target_params, tokens, draft_config,
                                   target_config, temperature, hard_weight),
            draft_params)
        opt_state = apply_updates(tx, grads, opt_state, draft_params)
        return draft_params, opt_state, loss

    return step
