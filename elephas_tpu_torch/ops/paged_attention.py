"""Paged decode attention: a hand-written CUDA kernel and its plain version.

The counterpart of ``elephas_tpu/ops/paged_attention.py``: the CUDA
kernel in ``csrc/paged_decode.cu`` replaces the TPU kernel
``_paged_kernel`` (see the note at the top of that file for its design
and what bounds it on the H100). It reads the KV cache straight from the
block pool through per-row block tables, with no gathered copy.

On CPU tensors the wrapper computes the plain version
:func:`paged_decode_attention_plain`; on CUDA tensors it launches the
kernel or raises.
"""
import math
from typing import Optional, Sequence, Union

import torch

from . import _kernels
from .attention import NEG_INF, einsum

__all__ = ["paged_decode_attention", "paged_decode_attention_plain",
           "paged_attention_gathered", "split_blocks"]

Slopes = Union[None, Sequence[float], torch.Tensor]


def _slopes_tensor(alibi_slopes: Slopes, h: int,
                   device: torch.device) -> Optional[torch.Tensor]:
    if alibi_slopes is None:
        return None
    sl = torch.as_tensor(alibi_slopes, dtype=torch.float32).reshape(-1)
    if sl.shape[0] != h:
        raise ValueError(f"{sl.shape[0]} ALiBi slopes for {h} heads")
    return sl.to(device)


def split_blocks(b: int, kvh: int, max_blocks: int, block_size: int) -> int:
    """Table entries per split of the bf16 kernel's split-K grid (B, KVH,
    splits): at least 64 positions a split, and at most as many splits
    as put about 2048 CTAs on the card when every row is full, so the
    serving shape (B 8, 16 kv heads, 64 blocks of 16) gets 16 splits of
    4 blocks and one request alone still spreads over 256 CTAs. From the
    shape alone: reading ``pos`` back to the host would cost more than
    the kernel."""
    min_blocks = min(max(1, 64 // block_size), max_blocks)
    splits = min(-(-max_blocks // min_blocks),
                 max(1, -(-2048 // (b * kvh))))
    return max(-(-max_blocks // splits), min_blocks)


def paged_attention_gathered(q: torch.Tensor, k_pool: torch.Tensor,
                             v_pool: torch.Tensor, tables: torch.Tensor,
                             pos: torch.Tensor,
                             window: Optional[int] = None,
                             alibi_slopes: Slopes = None,
                             dtype: torch.dtype = torch.float32
                             ) -> torch.Tensor:
    """Paged decode attention the plain way, computing in ``dtype``:
    gather every row's blocks into attention order (positions beyond
    the row's allocation land on stale or scratch data and are masked)
    and run one masked softmax over the full row. In the compute dtype
    this is the JAX gather path's arithmetic (``decode_step_paged(...,
    kernel="gather")``); in f32 it is the kernel's plain version. ALiBi
    biases promote the scores to f32, as in JAX. Returns ``(B, H, D)``
    in the dtype the arithmetic ends in."""
    b, h, d = q.shape
    _, kvh, bs, _ = k_pool.shape
    groups = h // kvh
    length = tables.shape[1] * bs
    tables = tables.long()
    pos = pos.long()
    ck = k_pool[tables].to(dtype).transpose(1, 2).reshape(b, kvh, length, d)
    cv = v_pool[tables].to(dtype).transpose(1, 2).reshape(b, kvh, length, d)
    qg = q.to(dtype).reshape(b, kvh, groups, d)
    s = einsum("bngd,bntd->bngt", qg, ck) * (1.0 / math.sqrt(d))
    kpos = torch.arange(length, device=q.device)
    if alibi_slopes is not None:
        sl = _slopes_tensor(alibi_slopes, h, q.device).reshape(
            1, kvh, groups, 1)
        dist = (pos[:, None] - kpos[None, :]).float()[:, None, None, :]
        s = s + (-sl * dist)
    valid = kpos[None, :] <= pos[:, None]
    if window is not None:
        valid = valid & (kpos[None, :] > pos[:, None] - window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return einsum("bngt,bntd->bngd", p, cv).reshape(b, h, d)


def paged_decode_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor, tables: torch.Tensor,
                                 pos: torch.Tensor,
                                 window: Optional[int] = None,
                                 alibi_slopes: Slopes = None
                                 ) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the gathered full-row
    softmax of :func:`paged_attention_gathered` in f32, in q's dtype."""
    return paged_attention_gathered(q, k_pool, v_pool, tables, pos, window,
                                    alibi_slopes).to(q.dtype)


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, tables: torch.Tensor,
                           pos: torch.Tensor,
                           window: Optional[int] = None,
                           alibi_slopes: Slopes = None) -> torch.Tensor:
    """Single-position paged attention straight off the block pool.

    :param q: ``(B, num_heads, head_dim)`` queries, positional encoding
        already applied.
    :param k_pool: ``(num_blocks, kv_heads, block_size, head_dim)`` pool
        AFTER this step's k scatter.
    :param v_pool: same shape, values.
    :param tables: ``(B, max_blocks)`` int block ids per row.
    :param pos: ``(B,)`` int current position per row; keys at
        ``kpos <= pos`` (and ``kpos > pos - window`` if set) are read.
    :param alibi_slopes: optional ``(H,)`` slopes adding the
        ``-slope * (pos - kpos)`` ALiBi bias.
    :returns: ``(B, num_heads, head_dim)`` in ``q.dtype``.

    Counts each kernel launch in ``paged_decode_attention.launches``."""
    if q.ndim != 3 or k_pool.ndim != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"expected q (B, H, D) and pools (NB, KVH, bs, "
                         f"D), got {tuple(q.shape)}, {tuple(k_pool.shape)},"
                         f" {tuple(v_pool.shape)}")
    b, h, d = q.shape
    _, kvh, bs, _ = k_pool.shape
    if h % kvh:
        raise ValueError(f"kv heads {kvh} must divide query heads {h}")
    if k_pool.shape[3] != d or tables.ndim != 2 or tables.shape[0] != b:
        raise ValueError("q, pools and tables disagree on head_dim or "
                         "batch")
    if window is not None and window < 1:
        raise ValueError("window must be >= 1")
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, tables, pos,
                                            window, alibi_slopes)
    if q.device.type != "cuda":
        raise ValueError(f"no paged decode kernel for device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"paged kernel takes bf16 or f32, got {q.dtype}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} must share q's device and dtype")
    tables = tables.to(device=q.device, dtype=torch.int32).contiguous()
    pos = pos.to(device=q.device, dtype=torch.int32).contiguous()
    q, k_pool, v_pool = (q.contiguous(), k_pool.contiguous(),
                         v_pool.contiguous())
    slopes = _slopes_tensor(alibi_slopes, h, q.device)
    out = torch.empty_like(q)
    mb = tables.shape[1]
    is_bf16 = q.dtype == torch.bfloat16
    # the bf16 body's split length and its per-split (m, l, acc) records
    per = split_blocks(b, kvh, mb, bs) if is_bf16 else 0
    splits = -(-mb // per) if per else 1
    ws = (torch.empty(b * h * splits * (d + 2), dtype=torch.float32,
                      device=q.device) if splits > 1 else None)
    lib = _kernels.library()
    err = lib.etpu_paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), pos.data_ptr(),
        None if slopes is None else slopes.data_ptr(), out.data_ptr(),
        b, h, kvh, bs, d, mb, 0 if window is None else int(window),
        1.0 / math.sqrt(d), int(is_bf16),
        None if ws is None else ws.data_ptr(), per,
        torch.cuda.current_stream(q.device).cuda_stream)
    _kernels.check(err, "paged decode")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
