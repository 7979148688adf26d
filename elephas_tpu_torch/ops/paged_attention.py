"""Paged decode attention: a hand-written CUDA kernel and its plain version.

The counterpart of ``elephas_tpu/ops/paged_attention.py``: the CUDA
kernel in ``csrc/paged_decode.cu`` replaces the TPU kernel
``_paged_kernel`` (see the note at the top of that file for its design
and what bounds it on the H100). It reads the KV cache straight from the
block pool through per-row block tables, with no gathered copy.

On CPU tensors the wrapper computes the plain version
:func:`paged_decode_attention_plain`; on CUDA tensors it launches the
kernel or raises. The kernel has two bodies, and the wrapper chooses
(:func:`paged_body`): the split-K body for bf16 at every head dim that
is a multiple of 8 from 16 to 256 (on a body of the next width up of
16, 32, 64, 128 and 256) with GQA groups of 1, 2, 4 or 8, the general
body for the rest (f32 at any shape; bf16 at head dim 8, at head dims
that are not multiples of 8, and at other group sizes). A bf16 call of
the split body's shapes that it cannot take raises: nothing drops
quietly to the general body.
"""
import math
from typing import Optional, Sequence, Union

import torch

from . import _kernels
from .attention import NEG_INF, einsum

__all__ = ["paged_decode_attention", "paged_decode_attention_plain",
           "paged_attention_gathered", "split_blocks", "paged_body",
           "SPLIT_HEAD_DIMS", "SPLIT_GROUPS"]

Slopes = Union[None, Sequence[float], torch.Tensor]

# the shapes the bf16 split body takes (csrc/paged_decode.cu
# `split::takes`): every multiple of 8 from 16 to 256, each on the body
# of the smallest width of 16, 32, 64, 128 and 256 that holds it
SPLIT_HEAD_DIMS = tuple(range(16, 257, 8))
SPLIT_GROUPS = (1, 2, 4, 8)
# the `body` argument of the C entry point
_BODY_IDS = {"general": 0, "split": 1}


def _slopes_tensor(alibi_slopes: Slopes, h: int,
                   device: torch.device) -> Optional[torch.Tensor]:
    if alibi_slopes is None:
        return None
    sl = torch.as_tensor(alibi_slopes, dtype=torch.float32).reshape(-1)
    if sl.shape[0] != h:
        raise ValueError(f"{sl.shape[0]} ALiBi slopes for {h} heads")
    return sl.to(device)


def split_blocks(b: int, kvh: int, max_blocks: int, block_size: int,
                 groups: int = 1) -> int:
    """Table entries per split of the bf16 kernel's split-K grid (B, KVH,
    splits): at least 64 positions a split, and at most as many splits
    as put about 2048 CTAs on the card when every row is full, so the
    serving shape (B 8, 16 kv heads, 64 blocks of 16) gets 16 splits of
    4 blocks and one request alone still spreads over 256 CTAs. At
    Mistral-7B's 8 kv heads the same 16 splits of 4 make 1,024 CTAs; at
    D 128 each reads 32 KB of K/V, all of it in flight at once. With
    ``groups`` of 8 (query heads per kv head) and at most 8 (row, kv
    head) pairs, 32 positions: there a CTA takes a whole SM and does 8
    heads' work a key, and Gemma-2B's decode step (B 8 over one kv head,
    D 256) ran 9% faster on splits of 32 than of 64, while at 64 pairs
    (Llama-2-70B's 8 kv heads at B 8) 32 ran 28% slower (an H100 80GB
    HBM3 at 700 W, ``tests/torch_paged_split_ab.py``). From the shape
    alone (not the head dim): reading ``pos`` back to the host would
    cost more than the kernel."""
    positions = 32 if groups >= 8 and b * kvh <= 8 else 64
    min_blocks = min(max(1, positions // block_size), max_blocks)
    splits = min(-(-max_blocks // min_blocks),
                 max(1, -(-2048 // (b * kvh))))
    return max(-(-max_blocks // splits), min_blocks)


def paged_body(dtype: torch.dtype, head_dim: int, groups: int,
               aligned: bool = True) -> str:
    """Which body of the CUDA kernel runs a call: ``"split"`` for bf16 at
    a head dim of :data:`SPLIT_HEAD_DIMS` (a multiple of 8 from 16 to
    256) with ``groups`` (query heads per kv head) in
    :data:`SPLIT_GROUPS`, ``"general"`` for any other dtype or shape.
    Raises ``ValueError`` for a call of the split body's shapes that it
    cannot take: an operand not 16-byte aligned (``aligned`` False). The Python mirror of ``split::takes`` in
    ``csrc/paged_decode.cu``, which refuses such a call too."""
    if (dtype != torch.bfloat16 or head_dim not in SPLIT_HEAD_DIMS
            or groups not in SPLIT_GROUPS):
        return "general"
    if not aligned:
        raise ValueError("the bf16 paged split body needs q, k_pool and "
                         "v_pool 16-byte aligned")
    return "split"


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

    Counts each kernel launch in ``paged_decode_attention.launches``,
    and those that took the split body (:func:`paged_body`) also in
    ``paged_decode_attention.split_launches``."""
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
    per = split_blocks(b, kvh, mb, bs, h // kvh)
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k_pool, v_pool))
    body = paged_body(q.dtype, d, h // kvh, aligned)
    # the split body's per-split (m, l, acc[d]) records: d + 2 floats
    # each, as `split::ws_record`
    splits = -(-mb // per) if body == "split" else 1
    ws = (torch.empty(b * h * splits * (d + 2), dtype=torch.float32,
                      device=q.device) if splits > 1 else None)
    lib = _kernels.library()
    err = lib.etpu_paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), pos.data_ptr(),
        None if slopes is None else slopes.data_ptr(), out.data_ptr(),
        b, h, kvh, bs, d, mb, 0 if window is None else int(window),
        1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16),
        _BODY_IDS[body], None if ws is None else ws.data_ptr(), per,
        torch.cuda.current_stream(q.device).cuda_stream)
    _kernels.check(err, f"paged decode ({body} body)")
    paged_decode_attention.launches += 1
    if body == "split":
        paged_decode_attention.split_launches += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention.split_launches = 0
