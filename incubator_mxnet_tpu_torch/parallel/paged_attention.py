"""Block-pool (paged) KV-cache primitives as torch index ops — the port
of ``incubator_mxnet_tpu/parallel/paged_attention.py``.

The engine owns one device-resident block pool per tensor (K and V):
``[num_blocks, layers, heads, block_size, head_dim]``.  A slot's cache
rows live scattered across pool blocks; a per-slot page-table row
(int ``[max_blocks_per_slot]``) maps its logical block index to a
physical block.  Physical block 0 is the reserved null block: page-table
entries of inactive slots and padding rows point there, so their
garbage writes never reach a live block.

JAX arrays are immutable, so the JAX helpers return a new pool that the
engine's programs donate.  Here the writers (``scatter_prompt_blocks``,
``write_token_rows``, ``copy_blocks``) update the pool IN PLACE — the
stand-in for buffer donation — and return it for symmetry.

Indices are never checked on the device: CUDA indexing out of range
raises a device-side assert that poisons the process's CUDA context.
Callers keep them in range as the engine's invariants do (block ids
< num_blocks, positions clamped to ``max_len - 1``).

``write_token_rows`` has the JAX helper's two extensions for the
speculative-decoding window: ``limit`` routes rows at positions
``>= limit`` to the null block (a verify window may overshoot the cache
depth near retirement), and ``layers`` writes only the first ``layers``
layer rows (the truncated-layer self-draft owns no deeper rows).
"""
from __future__ import annotations

import torch

__all__ = ["gather_layer_blocks", "scatter_prompt_blocks",
           "write_token_rows", "copy_blocks"]


def gather_layer_blocks(pool, page_table, layer):
    """pool [NB, layers, H, bs, hd], page_table [S, MB] -> [S, H, MB*bs,
    hd]: layer ``layer``'s cache rows of every slot, contiguous in
    logical row order (value-identical to a dense cache slice)."""
    g = pool[:, layer][page_table.long()]     # [S, MB, H, bs, hd]
    s, mb, h, bs, hd = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(s, h, mb * bs, hd)


def scatter_prompt_blocks(pool, kv, block_ids, block_size):
    """Write prefill output kv [layers, H, bucket, hd] into pool at
    ``block_ids`` [bucket // bs], in place.  Duplicate ids (several
    entries routed to the null block) write garbage the engine never
    reads."""
    layers, h, bucket, hd = kv.shape
    nb = bucket // block_size
    blocks = kv.reshape(layers, h, nb, block_size, hd) \
               .permute(2, 0, 1, 3, 4)        # [nb, layers, H, bs, hd]
    pool[block_ids.long()] = blocks.to(pool.dtype)
    return pool


def write_token_rows(pool, page_table, positions, rows, block_size,
                     limit=None, layers=None):
    """Append one K/V row per slot, in place: rows [S, layers, H, hd]
    land at physical block ``page_table[s, pos // bs]``, offset
    ``pos % bs``.  Inactive slots (page-table row all null) write into
    block 0.  ``limit``: positions >= limit write into block 0 too.
    ``layers``: rows hold only the first ``layers`` pool layers; deeper
    layers keep their bytes."""
    pos = positions.long()
    if limit is not None:
        # index with the clamped position (keeps the page-table gather
        # in range) but route the overshoot to the null block
        pos = pos.clamp(max=limit - 1)
    blk = page_table.long().gather(1, (pos // block_size)[:, None])[:, 0]
    if limit is not None:
        blk = torch.where(positions.long() < limit, blk, 0)
    off = pos % block_size
    pool[blk, :layers, :, off] = rows.to(pool.dtype)
    return pool


def copy_blocks(pool, dst, src):
    """Per-slot block copy ``pool[dst] = pool[src]`` (the copy-on-write
    move of prefix sharing), in place.  A slot with no pending copy
    passes ``src == dst``."""
    pool[dst.long()] = pool[src.long()]
    return pool
