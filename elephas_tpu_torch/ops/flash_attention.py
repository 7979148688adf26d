"""Flash attention: hand-written CUDA kernels and their plain versions.

The counterpart of ``elephas_tpu/ops/pallas_attention.py``. The CUDA
kernel in ``csrc/flash_fwd.cu`` replaces the TPU kernel ``_fwd_kernel``;
the two in ``csrc/flash_bwd.cu`` replace ``_dq_kernel`` and
``_dkv_kernel`` (see the notes at the top of those files for their
designs and what bounds them on the H100). :func:`flash_forward` mirrors
``flash_hop_forward`` and returns ``(o, lse)``; :func:`flash_backward`
mirrors ``flash_hop_backward``: given the global ``lse`` and ``delta =
rowsum(dO * O)`` it returns ``(dq, dk, dv)``, launching the dQ kernel
(:func:`flash_dq`) and the dK/dV kernel (:func:`flash_dkv`).
:func:`flash_attention` mirrors the single-device, differentiable
``flash_attention``: a ``torch.autograd.Function`` over the forward and
the two backward kernels, as the ``_flash`` custom VJP is.

On CPU tensors each wrapper computes its plain version; on CUDA tensors
it launches its kernel or raises. Shapes follow the JAX package: q and
dO ``(B, H, Sq, D)``, k/v ``(B, KVH, Sk, D)`` with ``KVH`` dividing
``H`` (GQA), lse and delta ``(B, H, Sq)`` f32, bf16 or f32 otherwise.
"""
import math
from typing import Optional, Tuple

import torch

from . import _kernels
from .attention import NEG_INF

__all__ = ["flash_attention", "flash_forward", "flash_forward_plain",
           "flash_backward", "flash_backward_plain", "flash_dq",
           "flash_dq_plain", "flash_dkv", "flash_dkv_plain",
           "SUPPORTED_HEAD_DIMS", "BLOCK"]

#: head dims the CUDA kernels are instantiated for, bf16 and f32 (the
#: head dims of the repo's configurations; the CPU plain versions take
#: any)
SUPPORTED_HEAD_DIMS = (16, 32, 64)
#: the one block size :func:`flash_attention` takes by name; the kernels
#: pick their own tiles (64 or 128 rows, csrc/flash_*.cu)
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


def _kernel_operands(q: torch.Tensor, **tensors: torch.Tensor):
    """Check the operands of a CUDA flash kernel (head dim instantiated;
    ``q`` and the named tensors of q's dtype, on q's device, contiguous)
    and return them in order, with bf16 operands cloned where they are
    not 16-byte aligned."""
    if q.shape[3] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"no flash kernel for head_dim {q.shape[3]}: the "
                         f"kernels take head_dim in {SUPPORTED_HEAD_DIMS}")
    if q.device.type != "cuda":
        raise ValueError(f"no flash kernel for device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash kernel takes bf16 or f32, got {q.dtype}")
    for name, t in (("q", q), *tensors.items()):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} must share q's device and dtype")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    ops = (q, *tensors.values())
    if q.dtype == torch.bfloat16:
        # TMA and the bf16 kernels' vector loads need 16-byte alignment
        ops = tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in ops)
    return ops


def _check_window(window: Optional[int]) -> None:
    if window is not None and window < 1:
        raise ValueError("window must be >= 1")


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_offset: int = 0, k_offset: int = 0, causal: bool = True,
                  window: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block attention of q against one k/v shard, masked on global
    positions (``q_offset``/``k_offset`` place the shards); returns
    ``(o, lse)`` with ``o`` in q's dtype and ``lse`` ``(B, H, Sq)`` f32.
    Counts each kernel launch in ``flash_forward.launches``."""
    _check(q, k, v)
    _check_window(window)
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, q_offset, k_offset, causal,
                                   window)
    q, k, v = _kernel_operands(q, k=k, v=v)
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
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


# ----------------------------------------------------------------- backward
def _bwd_probs(q, k, v, g, lse, delta, q_offset, k_offset, causal, window):
    """What both backward kernels recompute, in f32 with k/v expanded to
    the query heads: ``(p, ds, qf, gf, kf)`` with ``p = exp(s - lse)``
    and ``ds = p * (dp - delta) * scale`` (B, H, Sq, Sk), zero wherever
    the (q, k) pair is masked on global positions."""
    d = q.shape[3]
    groups = q.shape[1] // k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qf, gf = q.float(), g.float()
    kf = k.float().repeat_interleave(groups, dim=1)
    vf = v.float().repeat_interleave(groups, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    valid = _valid_mask(q.shape[2], k.shape[2], int(q_offset),
                        int(k_offset), causal, window, q.device)
    # a fully masked row's lse is ~-1e30: exp overflows there, and the
    # mask drops it
    p = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf)
    ds = p * (dp - delta[..., None]) * scale
    return p, ds, qf, gf, kf


def flash_dq_plain(q, k, v, g, lse, delta, q_offset: int = 0,
                   k_offset: int = 0, causal: bool = True,
                   window: Optional[int] = None) -> torch.Tensor:
    """The dQ kernel's function in plain PyTorch, in f32: ``dq = ds k``
    over full rows; returned in q's dtype."""
    _, ds, _, _, kf = _bwd_probs(q, k, v, g, lse, delta, q_offset,
                                 k_offset, causal, window)
    return torch.einsum("bhqk,bhkd->bhqd", ds, kf).to(q.dtype)


def flash_dkv_plain(q, k, v, g, lse, delta, q_offset: int = 0,
                    k_offset: int = 0, causal: bool = True,
                    window: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel's function in plain PyTorch, in f32: ``dk = ds^T
    q`` and ``dv = p^T dO``, each query head of a GQA group adding into
    its kv head; returned in k's and v's dtypes."""
    p, ds, qf, gf, _ = _bwd_probs(q, k, v, g, lse, delta, q_offset,
                                  k_offset, causal, window)
    b, kvh, sk, d = k.shape
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gf)
    dk = dk.reshape(b, kvh, -1, sk, d).sum(2)
    dv = dv.reshape(b, kvh, -1, sk, d).sum(2)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_backward_plain(q, k, v, g, lse, delta, q_offset: int = 0,
                         k_offset: int = 0, causal: bool = True,
                         window: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Both backward kernels' function in plain PyTorch, in f32:
    ``(dq, dk, dv)`` in the inputs' dtypes."""
    args = (q, k, v, g, lse, delta, q_offset, k_offset, causal, window)
    return (flash_dq_plain(*args), *flash_dkv_plain(*args))


def _check_bwd(q, k, v, g, lse, delta, window) -> None:
    _check(q, k, v)
    _check_window(window)
    if g.shape != q.shape:
        raise ValueError(f"the output gradient {tuple(g.shape)} must have "
                         f"q's shape {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:3] or t.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 {tuple(q.shape[:3])}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on q's device")


def _bwd_launch(entry: str, q, k, v, g, lse, delta, outs, q_offset,
                k_offset, causal, window) -> None:
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    lib = _kernels.library()
    err = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
        b, h, kvh, sq, sk, d, int(q_offset), int(k_offset),
        int(bool(causal)), 0 if window is None else int(window),
        1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _kernels.check(err, entry)


def flash_dq(q, k, v, g, lse, delta, q_offset: int = 0, k_offset: int = 0,
             causal: bool = True, window: Optional[int] = None
             ) -> torch.Tensor:
    """dQ of one (q, k/v shard) pair given the global ``lse`` and
    ``delta``: the dQ kernel on CUDA tensors (counted in
    ``flash_backward.dq_launches``), :func:`flash_dq_plain` on CPU
    tensors."""
    _check_bwd(q, k, v, g, lse, delta, window)
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, g, lse, delta, q_offset, k_offset,
                              causal, window)
    q, k, v, g = _kernel_operands(q, k=k, v=v, g=g)
    dq = torch.empty_like(q)
    _bwd_launch("etpu_flash_bwd_dq", q, k, v, g, lse, delta, (dq,),
                q_offset, k_offset, causal, window)
    flash_backward.dq_launches += 1
    return dq


def flash_dkv(q, k, v, g, lse, delta, q_offset: int = 0, k_offset: int = 0,
              causal: bool = True, window: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) of one (q, k/v shard) pair given the global ``lse`` and
    ``delta``, at the narrow kv width: the dK/dV kernel on CUDA tensors
    (counted in ``flash_backward.dkv_launches``),
    :func:`flash_dkv_plain` on CPU tensors."""
    _check_bwd(q, k, v, g, lse, delta, window)
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, g, lse, delta, q_offset, k_offset,
                               causal, window)
    q, k, v, g = _kernel_operands(q, k=k, v=v, g=g)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch("etpu_flash_bwd_dkv", q, k, v, g, lse, delta, (dk, dv),
                q_offset, k_offset, causal, window)
    flash_backward.dkv_launches += 1
    return dk, dv


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   g: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                   q_offset: int = 0, k_offset: int = 0, causal: bool = True,
                   window: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-hop backward with GLOBAL row statistics, as the JAX
    ``flash_hop_backward``: the softmax over the whole ring factorizes
    as ``exp(s - lse_global)``, so dq/dk/dv of this shard pair are exact
    given the global ``lse`` and ``delta = rowsum(dO * O_global)``.
    Returns ``(dq, dk, dv)`` in the inputs' dtypes, dk/dv at the narrow
    kv width. On CUDA tensors it launches the dQ and the dK/dV kernels
    (``g`` must be contiguous: it raises otherwise) and counts them in
    ``flash_backward.dq_launches`` / ``.dkv_launches``."""
    args = (q, k, v, g, lse, delta, q_offset, k_offset, causal, window)
    return (flash_dq(*args), *flash_dkv(*args))


flash_backward.dq_launches = 0
flash_backward.dkv_launches = 0


class _FlashAttention(torch.autograd.Function):
    """The ``_flash`` custom VJP: the forward kernel, saving the JAX
    residuals ``(q, k, v, o, lse)``; the backward computes ``delta``
    outside the kernels (as ``_bwd`` does) and launches both."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = flash_forward(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        delta = torch.sum(g.float() * o.float(), dim=-1)
        dq, dk, dv = flash_backward(q, k, v, g.contiguous(), lse, delta,
                                    causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Flash attention over ``(batch, heads, seq, head_dim)`` tensors
    (k/v may carry fewer heads: GQA). Differentiable: the backward runs
    the dQ and dK/dV kernels (their plain versions on the CPU). The
    kernels pick their own tiles: ``block_q``/``block_k`` may only be
    :data:`BLOCK`, and sequence lengths need not be multiples of any
    tile."""
    if q.ndim != 4:
        raise ValueError(f"expected (batch, heads, seq, head_dim), got "
                         f"{tuple(q.shape)}")
    for name, blk in (("block_q", block_q), ("block_k", block_k)):
        if blk is not None and blk != BLOCK:
            raise NotImplementedError(
                f"{name}={blk}: the CUDA kernels pick their own tiles; "
                f"only {BLOCK} is accepted")
    _check_window(window)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    window = None if window is None else int(window)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window)
    # no graph to record (inference): the forward kernel alone, without
    # the autograd Function's host cost
    o, _ = flash_forward(q, k, v, causal=causal, window=window)
    return o
