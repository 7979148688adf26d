"""Paged KV cache: block-pool decode for the serving engine.

The counterpart of ``elephas_tpu/models/paged_decode.py`` (the subset
the engine's paged decode path runs). Cache lives in fixed
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
from typing import Dict, Tuple

import torch

from .._device import DeviceLike, resolve_device
from ..ops.attention import einsum
from ..ops.paged_attention import (paged_attention_gathered,
                                   paged_decode_attention)
from .transformer import (TransformerConfig, _alibi_slopes,
                          _apply_rope, _mlp_apply, _norm,
                          _qkv, _sinusoidal_table, check_ported,
                          head_logits)

__all__ = ["validate_paged_config", "init_paged_pool", "install_row_paged",
           "decode_step_paged", "KERNELS"]

#: the paged decode-attention inner loops: ``gather`` materializes each
#: row's blocks and runs a full-row softmax; ``fused`` runs the CUDA
#: kernel (the counterpart of the JAX package's ``"pallas"``)
KERNELS = ("gather", "fused")


def validate_paged_config(config: TransformerConfig):
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
    position ever reads."""
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
    check_ported(config)
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
