"""Plain softmax attention, the reference path of the port.

The counterpart of ``elephas_tpu/ops/attention.py`` ``attention``. All
shapes are ``(batch, heads, seq, head_dim)``.
"""
import math
from typing import Optional

import torch

NEG_INF = -1e30

__all__ = ["attention", "einsum", "NEG_INF"]


def einsum(spec: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with JAX's dtype promotion: mixed bf16/f32
    operands compute in f32 (torch refuses mixed operand types)."""
    dt = operands[0].dtype
    for op in operands[1:]:
        dt = torch.promote_types(dt, op.dtype)
    return torch.einsum(spec, *(op.to(dt) for op in operands))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False,
              mask: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain softmax attention. ``bias`` (broadcastable to ``(B, H, Tq,
    Tk)``, e.g. ALiBi) adds to the scaled scores before masking."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = einsum("bhqd,bhkd->bhqk", q, k) * scale
    if bias is not None:
        scores = scores + bias
    if causal:
        q_pos = torch.arange(q.shape[2], device=q.device)[:, None]
        k_pos = torch.arange(k.shape[2], device=q.device)[None, :]
        scores = torch.where(k_pos <= q_pos, scores, NEG_INF)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    return einsum("bhqk,bhkd->bhqd", weights, v)
