"""Paged KV cache: block-pool decode for the serving engine.

The counterpart of ``elephas_tpu/models/paged_decode.py`` (the subset
the engine's paged decode and speculative verify paths run). Cache lives in fixed
``block_size``-position blocks of one shared pool; each slot holds a
small block table. Block id 0 is a reserved scratch sink that is never
allocated: an inactive slot (table of zeros, position 0) writes and
reads only there, so it can never touch a block owned by a live
request.

Unlike the JAX package, whose arrays are immutable, the pool tensors
here are updated IN PLACE (``index_put_`` / slice assignment): one
pool, no per-step copy. The functions still return the pool so the
call sites read as in the JAX package.
"""
import math
from typing import Dict, Tuple

import torch

from .._device import DeviceLike, resolve_device
from ..ops.attention import NEG_INF, einsum
from ..ops.paged_attention import (paged_attention_gathered,
                                   paged_decode_attention)
from .transformer import (TransformerConfig, _alibi_slopes,
                          _apply_rope, _mlp_apply, _norm,
                          _qkv, _sinusoidal_table, head_logits)

__all__ = ["validate_paged_config", "init_paged_pool", "install_row_paged",
           "gather_blocks_to_row", "decode_step_paged", "decode_block_paged",
           "KERNELS"]

#: the paged decode-attention inner loops: ``gather`` materializes each
#: row's blocks and runs a full-row softmax; ``fused`` runs the CUDA
#: kernel (the counterpart of the JAX package's ``"pallas"``)
KERNELS = ("gather", "fused")


def validate_paged_config(config: TransformerConfig):
    """Refuse what paged mode does not carry, with the JAX package's
    messages: the int8 KV cache (the contiguous engine composes with
    it) and MoE layers."""
    if config.kv_cache_quant:
        raise ValueError("paged KV mode does not compose with "
                         "kv_cache_quant; use the contiguous engine for "
                         "the int8 cache")
    if config.num_experts > 1:
        raise ValueError("paged KV mode does not support MoE layers")


def init_paged_pool(config: TransformerConfig, num_blocks: int,
                    block_size: int, device: DeviceLike = None) -> Dict:
    """Shared block pool: per layer ``k``/``v`` of shape ``(num_blocks,
    kv_heads, block_size, head_dim)`` in the compute dtype. Block 0 is
    the reserved scratch sink (allocators hand out ids >= 1)."""
    validate_paged_config(config)
    c = config
    device = resolve_device(device)
    shape = (num_blocks, c.kv_heads, block_size, c.head_dim)
    return {f"layer_{i}": {"k": torch.zeros(shape, dtype=c.dtype,
                                            device=device),
                           "v": torch.zeros(shape, dtype=c.dtype,
                                            device=device)}
            for i in range(c.num_layers)}


def install_row_paged(pool: Dict, row_cache: Dict, block_ids,
                      nblocks: int, start: int = 0) -> Dict:
    """Scatter a contiguous batch-1 prefill row into pool blocks:
    positions ``[start*block_size, nblocks*block_size)`` of
    ``row_cache`` land in ``block_ids[start:nblocks]`` (in place). A
    final block past the row's length holds zero padding that no
    position ever reads. ``start > 0`` is the prefix-cache-hit install:
    the first ``start`` table entries point at shared cached blocks that
    already hold those positions and are left alone."""
    for name, lc in pool.items():
        bs = lc["k"].shape[2]
        ids = torch.as_tensor(block_ids[start:nblocks], dtype=torch.long,
                              device=lc["k"].device)
        n_write = nblocks - start
        for part in ("k", "v"):
            row = row_cache[name][part][0]               # (H, L, D)
            h, length, d = row.shape
            take = min(nblocks * bs, length)
            chunk = row[:, start * bs:take]
            if take < nblocks * bs:
                chunk = torch.nn.functional.pad(
                    chunk, (0, 0, 0, nblocks * bs - take))
            lc[part][ids] = chunk.reshape(h, n_write, bs, d).transpose(
                0, 1).to(lc[part].dtype)
    return pool


def gather_blocks_to_row(pool: Dict, block_ids, max_len: int) -> Dict:
    """The inverse of :func:`install_row_paged`: read ``block_ids``'
    pool blocks back into a fresh contiguous batch-1 row cache (``(1,
    kv_heads, max_len, head_dim)`` per layer k/v, zero past
    ``len(block_ids) * block_size``). A prefix-cache hit feeds the
    remainder prefill this way: the cached blocks become the row's head
    and :func:`~elephas_tpu_torch.models.transformer.decode_block`
    extends past them."""
    out = {}
    for name, lc in pool.items():
        ids = torch.as_tensor(list(block_ids), dtype=torch.long,
                              device=lc["k"].device)
        parts = {}
        for part in ("k", "v"):
            sel = lc[part].index_select(0, ids)           # (n, H, bs, D)
            n, h, bs, d = sel.shape
            row = torch.zeros((1, h, max_len, d), dtype=sel.dtype,
                              device=sel.device)
            row[0, :, :n * bs] = sel.transpose(0, 1).reshape(h, n * bs, d)
            parts[part] = row
        out[name] = parts
    return out


def decode_step_paged(params: Dict, pool: Dict, tables: torch.Tensor,
                      tokens: torch.Tensor, pos: torch.Tensor,
                      config: TransformerConfig,
                      kernel: str = "gather") -> Tuple[torch.Tensor, Dict]:
    """One autoregressive step over the block pool: token ids ``(B,)``
    at per-row positions ``pos`` ``(B,)``; ``tables`` is ``(B,
    max_blocks)`` of block ids. Returns (f32 logits ``(B, vocab)``, the
    pool). This position's k/v are scattered into each row's owning
    block IN PLACE (``index_put_``), where the JAX package returns an
    updated copy.

    ``kernel="gather"`` materializes each row's blocks into attention
    order and runs a full-row masked softmax (the JAX gather path);
    ``kernel="fused"`` runs :func:`~elephas_tpu_torch.ops.
    paged_attention.paged_decode_attention`, whose CUDA kernel reads the
    blocks straight from the pool (on CPU tensors it takes the kernel's
    plain version)."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown paged decode kernel {kernel!r}; "
                         f"expected one of {KERNELS}")
    validate_paged_config(config)
    c = config
    device = params["embed"]["tokens"].device
    tokens = torch.as_tensor(tokens, device=device).long()
    pos = torch.as_tensor(pos, device=device).long()
    tables = torch.as_tensor(tables, device=device)
    first = next(iter(pool.values()))["k"]
    bs = first.shape[2]
    tables_l = tables.long()
    blk = torch.gather(tables_l, 1, (pos // bs)[:, None])[:, 0]
    off = pos % bs

    x = params["embed"]["tokens"][tokens]          # (B, D)
    if c.positional == "learned":
        x = x + params["embed"]["pos"][pos]
    elif c.positional == "sinusoidal":
        x = x + _sinusoidal_table(pos, c.d_model)
    x = x.to(c.dtype)[:, None]                     # (B, 1, D)

    rp = pos[:, None, None]                        # (B, 1, 1) rope angles
    hidx = torch.arange(c.kv_heads, device=device)
    widx = (blk[:, None], hidx[None, :], off[:, None])
    slopes = (_alibi_slopes(c.num_heads, device)
              if c.positional == "alibi" else None)
    if kernel == "fused":
        tables_i = tables.to(torch.int32).contiguous()
        pos_i = pos.to(torch.int32).contiguous()
    for i in range(c.num_layers):
        layer = params[f"layer_{i}"]
        h = _norm(x, layer["ln1"], c).to(c.dtype)
        q, k_new, v_new = _qkv(layer, h, c)        # (B, heads, 1, hd)
        if c.positional == "rope":
            q = _apply_rope(q, rp, c)
            k_new = _apply_rope(k_new, rp, c)

        lc = pool[f"layer_{i}"]
        pk, pv = lc["k"], lc["v"]
        pk.index_put_(widx, k_new[:, :, 0].to(pk.dtype))
        pv.index_put_(widx, v_new[:, :, 0].to(pv.dtype))

        if kernel == "fused":
            o = paged_decode_attention(
                q[:, :, 0], pk, pv, tables_i, pos_i,
                window=c.attention_window,
                alibi_slopes=slopes)[:, :, None, :]
        else:
            o = paged_attention_gathered(
                q[:, :, 0], pk, pv, tables_l, pos,
                window=c.attention_window, alibi_slopes=slopes,
                dtype=c.dtype)[:, :, None, :]
        x = x + einsum("bhsk,hkd->bsd", o, layer["attn"]["wo"].to(c.dtype))
        x = _mlp_apply(layer, x, c)
    logits = head_logits(params["embed"], params["final_ln"], x[:, 0],
                         head=params.get("head"), norm=c.norm)
    return logits, pool


def decode_block_paged(params: Dict, pool: Dict, tables: torch.Tensor,
                       tokens: torch.Tensor, pos0,
                       config: TransformerConfig) -> Tuple[torch.Tensor,
                                                           Dict]:
    """Multi-token cached decode over the block pool: ``(B, S)`` tokens
    at per-row positions ``pos0 .. pos0+S-1`` (``pos0`` is ``(B,)``);
    each position's k/v is scattered into the owning block of that
    row's table IN PLACE, and (f32 logits ``(B, S, vocab)``, the pool)
    is returned.

    The counterpart of ``decode_block_paged`` in
    ``elephas_tpu/models/paged_decode.py:415``: the paged mirror of
    :func:`~elephas_tpu_torch.models.transformer.decode_block` and the
    verify pass of paged speculative decoding. All S positions' k/v are
    written before attention; each block slot ``j`` attends causally to
    cache positions ``<= pos0 + j`` of its row's gathered blocks, with
    einsum attention as in the JAX package (no kernel on this path).
    Writes stay inside the row's own table: a row's rejected tail
    positions are masked until later rounds overwrite them, and inactive
    rows (tables of zeros) write only into the scratch block 0."""
    validate_paged_config(config)
    c = config
    device = params["embed"]["tokens"].device
    tokens = torch.as_tensor(tokens, device=device).long()
    b, s = tokens.shape
    first = next(iter(pool.values()))["k"]
    bs = first.shape[2]
    tables = torch.as_tensor(tables, device=device).long()
    mb = tables.shape[1]
    length = mb * bs                               # gathered view length
    pos0 = torch.as_tensor(pos0, device=device).long().reshape(-1)
    blockpos = pos0[:, None] + torch.arange(s, device=device)[None, :]
    blk = torch.gather(tables, 1, blockpos // bs)  # (B, S)
    off = blockpos % bs

    x = params["embed"]["tokens"][tokens]          # (B, S, D)
    if c.positional == "learned":
        x = x + params["embed"]["pos"][blockpos]
    elif c.positional == "sinusoidal":
        x = x + _sinusoidal_table(blockpos, c.d_model)
    x = x.to(c.dtype)

    kpos = torch.arange(length, device=device)
    mask = kpos[None, None, :] <= blockpos[:, :, None]       # (B, S, L)
    if c.attention_window is not None:
        mask = mask & (kpos[None, None, :]
                       > blockpos[:, :, None] - c.attention_window)
    scale = 1.0 / math.sqrt(c.head_dim)
    rp = blockpos[:, None, :]                      # (B, 1, S) rope angles
    groups = c.num_heads // c.kv_heads
    hidx = torch.arange(c.kv_heads, device=device)
    # scatter target per (b, s, head): rows own disjoint tables and a
    # row's S positions are distinct (block, offset) pairs; only
    # inactive rows collide, on the scratch sink
    widx = (blk[:, :, None], hidx[None, None, :], off[:, :, None])
    slopes = (_alibi_slopes(c.num_heads, device)
              if c.positional == "alibi" else None)
    for i in range(c.num_layers):
        layer = params[f"layer_{i}"]
        h = _norm(x, layer["ln1"], c).to(c.dtype)
        q, k_new, v_new = _qkv(layer, h, c)        # (B, heads, S, hd)
        if c.positional == "rope":
            q = _apply_rope(q, rp, c)
            k_new = _apply_rope(k_new, rp, c)

        lc = pool[f"layer_{i}"]
        pk, pv = lc["k"], lc["v"]
        # (B, H, S, D) -> (B, S, H, D) to line up with the scatter index
        pk.index_put_(widx, k_new.transpose(1, 2).to(pk.dtype))
        pv.index_put_(widx, v_new.transpose(1, 2).to(pv.dtype))

        # each row's blocks in attention order: (B, MB, H, bs, D) ->
        # (B, H, MB*bs, D); positions past the row's allocation read
        # stale or scratch data and are masked
        ck = pk[tables].transpose(1, 2).reshape(b, c.kv_heads, length,
                                                c.head_dim)
        cv = pv[tables].transpose(1, 2).reshape(b, c.kv_heads, length,
                                                c.head_dim)
        qg = q.reshape(b, c.kv_heads, groups, s, c.head_dim)
        scores = einsum("bngsk,bntk->bngst", qg, ck) * scale
        if slopes is not None:
            dist = (blockpos[:, :, None] - kpos[None, None, :]).to(
                torch.float32)                     # (B, S, L)
            ab = (-slopes[None, :, None, None] * dist[:, None]).reshape(
                b, c.kv_heads, groups, s, length)
            scores = scores + ab
        scores = torch.where(mask[:, None, None], scores, NEG_INF)
        weights = torch.softmax(scores, dim=-1)
        o = einsum("bngst,bntk->bngsk", weights, cv)
        o = o.reshape(b, c.num_heads, s, c.head_dim)
        x = x + einsum("bhsk,hkd->bsd", o, layer["attn"]["wo"].to(c.dtype))
        x = _mlp_apply(layer, x, c)
    logits = head_logits(params["embed"], params["final_ln"], x,
                         head=params.get("head"), norm=c.norm)
    return logits, pool
