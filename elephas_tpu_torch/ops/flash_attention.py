"""Flash-attention forward: a hand-written CUDA kernel and its plain version.

The counterpart of ``elephas_tpu/ops/pallas_attention.py``: the CUDA
kernel in ``csrc/flash_fwd.cu`` replaces the TPU kernel ``_fwd_kernel``
(see the note at the top of that file for its design and what bounds it
on the H100). :func:`flash_forward` mirrors ``flash_hop_forward`` and
returns ``(o, lse)``; :func:`flash_attention` mirrors the single-device
``flash_attention`` forward. The backward kernels are not ported yet.

On CPU tensors the wrapper computes the plain version
:func:`flash_forward_plain`; on CUDA tensors it launches the kernel or
raises. Shapes follow the JAX package: q ``(B, H, Sq, D)``, k/v ``(B,
KVH, Sk, D)`` with ``KVH`` dividing ``H`` (GQA), bf16 or f32.
"""
import math
from typing import Optional, Tuple

import torch

from . import _kernels
from .attention import NEG_INF

__all__ = ["flash_attention", "flash_forward", "flash_forward_plain",
           "SUPPORTED_HEAD_DIMS", "BLOCK"]

#: head dims the CUDA kernel is instantiated for (the CPU plain version
#: takes any)
SUPPORTED_HEAD_DIMS = (64,)
#: the kernel's q and k/v tile rows (``BQ``/``BK`` in csrc/flash_fwd.cu)
BLOCK = 64


def _valid_mask(sq: int, sk: int, q_offset: int, k_offset: int,
                causal: bool, window: Optional[int],
                device) -> torch.Tensor:
    """(Sq, Sk) validity on GLOBAL positions, as the TPU kernel masks."""
    qg = q_offset + torch.arange(sq, device=device)[:, None]
    kg = k_offset + torch.arange(sk, device=device)[None, :]
    valid = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        valid = valid & (kg <= qg)
    if window is not None:
        valid = valid & (kg > qg - window)
    return valid


def flash_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_offset: int = 0, k_offset: int = 0,
                        causal: bool = True, window: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, in f32: one full-row
    masked softmax instead of the online recurrence. Fully masked rows
    give O = 0 and LSE = -1e30 + log(1e-30), as the kernel does."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    groups = h // kvh
    qf = q.float()
    kf = k.float().repeat_interleave(groups, dim=1)
    vf = v.float().repeat_interleave(groups, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * (1.0 / math.sqrt(d))
    valid = _valid_mask(sq, sk, int(q_offset), int(k_offset), causal,
                        window, q.device)
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vf) / l
    lse = (m + torch.log(l))[..., 0]
    return o.to(q.dtype), lse


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B, H, Sq, D) and k/v (B, KVH, Sk, "
                         f"D), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError("q and k/v disagree on batch or head_dim")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"kv heads {k.shape[1]} must divide query heads "
                         f"{q.shape[1]} (GQA)")


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_offset: int = 0, k_offset: int = 0, causal: bool = True,
                  window: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block attention of q against one k/v shard, masked on global
    positions (``q_offset``/``k_offset`` place the shards); returns
    ``(o, lse)`` with ``o`` in q's dtype and ``lse`` ``(B, H, Sq)`` f32.
    Counts each kernel launch in ``flash_forward.launches``."""
    _check(q, k, v)
    if window is not None and window < 1:
        raise ValueError("window must be >= 1")
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, q_offset, k_offset, causal,
                                   window)
    if q.device.type != "cuda":
        raise ValueError(f"no flash kernel for device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash kernel takes bf16 or f32, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} must share q's device and dtype")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in "
                         f"{SUPPORTED_HEAD_DIMS}, got {d}")
    if q.dtype == torch.bfloat16:
        # the bf16 kernel stages rows with 16-byte vector loads
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _kernels.library()
    err = lib.etpu_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, h, kvh, sq, sk, d, int(q_offset), int(k_offset),
        int(bool(causal)), 0 if window is None else int(window),
        1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _kernels.check(err, "flash forward")
    flash_forward.launches += 1
    return o, lse


flash_forward.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Flash attention forward over ``(batch, heads, seq, head_dim)``
    tensors (k/v may carry fewer heads: GQA). The kernel's tiles are
    fixed at :data:`BLOCK` x :data:`BLOCK` rows (``block_q``/``block_k``
    may only name them); sequence lengths need not be multiples of them.
    Not differentiable: the backward kernels are not ported yet."""
    if q.ndim != 4:
        raise ValueError(f"expected (batch, heads, seq, head_dim), got "
                         f"{tuple(q.shape)}")
    for name, blk in (("block_q", block_q), ("block_k", block_k)):
        if blk is not None and blk != BLOCK:
            raise NotImplementedError(
                f"{name}={blk}: the CUDA kernel's tiles are fixed at "
                f"{BLOCK} rows")
    o, _ = flash_forward(q.contiguous(), k.contiguous(), v.contiguous(),
                         causal=causal, window=window)
    return o
