"""Causal transformer decoder with KV-cache hooks — the port of
``incubator_mxnet_tpu/gluon/decoder.py`` (the model half of the
generation engine).

One parameter set, seven call modes (the JAX module's docstring has the
full contract):

* ``forward(tokens)`` — full causal LM forward ``[B, T] -> [B, T, V]``;
  attention runs through the flash-attention kernel on the card.
* ``prefill(tokens, length)`` — one right-padded prompt ``[1, S]``
  through the same causal forward, returning the last valid position's
  logits and every layer's K/V for the slot cache.
* ``decode_step(tokens, positions, k_cache, v_cache)`` — one current
  token per slot attends over its dense cache rows (``< position``)
  plus itself, returning the new K/V rows to write at ``position``.
* ``decode_step_paged(tokens, positions, k_pool, v_pool, page_table)``
  — the same over the paged block pool; each slot's blocks are gathered
  into the contiguous view first, so paged equals dense bit for bit.

* ``decode_step_paged_partial(..., layers)`` — the self-draft of
  speculative decoding: ``decode_step_paged`` through the first
  ``layers`` layers only, the shared ``ln_f``/``head`` reading the
  truncated hidden state.
* ``decode_step_paged_window(tokens, positions, k_pool, v_pool,
  page_table)`` — the batched verify pass: a ``[slots, W]`` window of
  consecutive tokens at full depth, each layer gathering the pool once
  and substituting the window's own K/V rows at their absolute columns,
  so row ``t`` sees what the ``t``-th sequential ``decode_step_paged``
  would see.
* ``prefill_chunk(tokens, start, length, k_pool, v_pool, page_table)``
  — one bounded chunk of a prompt: ``C`` tokens attend the slot's
  filled cache rows (``< start``) plus causally within the chunk.  Its
  attention is einsums in ``forward_step``'s order, not the flash
  kernel, so a chunked engine is its own numerics configuration.

These three attentions are einsums outside any kernel, as in the JAX
package: fp32 scores, ``-inf`` masks, one softmax over the context and
window columns together.  Parameters are created on ``device``
(``None`` -> ``cuda:0``, raising without a GPU) and drawn from ``seed``
on the CPU, so a seed gives the same weights on every device.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..base import MXNetError
from ..context import resolve_device
from ..parallel.flash_attention import flash_attention
from ..parallel.paged_attention import gather_layer_blocks
from .nn._modules import Dense, Embedding, LayerNorm

__all__ = ["DecoderLayer", "TransformerDecoder"]


class DecoderLayer(nn.Module):
    """Pre-LN decoder layer: causal self-attention + 2-layer ReLU MLP,
    each residual.  ``forward_full`` also returns the K/V it computed
    (prefill hook); ``forward_step`` consumes cached K/V (decode
    hook)."""

    def __init__(self, dim, heads, mlp_ratio=4, flash_block=32,
                 device=None, dtype=torch.float32):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} must divide heads {heads}")
        self._dim = dim
        self._heads = heads
        self._flash_block = flash_block
        kw = dict(device=device, dtype=dtype)
        self.ln1 = LayerNorm(dim, **kw)
        self.qkv = Dense(3 * dim, dim, use_bias=False, **kw)
        self.proj = Dense(dim, dim, **kw)
        self.ln2 = LayerNorm(dim, **kw)
        self.fc1 = Dense(mlp_ratio * dim, dim, activation="relu", **kw)
        self.fc2 = Dense(dim, mlp_ratio * dim, **kw)

    def _mlp(self, x):
        return self.fc2(self.fc1(x))

    def forward_full(self, x):
        """x [B, T, D] -> (out [B, T, D], k [B, H, T, hd], v [B, H, T,
        hd]): full causal self-attention through ``flash_attention``
        (T must divide the flash block; bucket lengths are powers of
        two, so it always does)."""
        b, t, _ = x.shape
        h, d = self._heads, self._dim // self._heads
        blk = min(self._flash_block, t)
        q, k, v = self.qkv(self.ln1(x)).split(self._dim, dim=-1)

        def split(a):   # the kernel takes contiguous (B, H, T, hd)
            return a.reshape(b, t, h, d).transpose(1, 2).contiguous()

        q, k, v = split(q), split(k), split(v)
        o = flash_attention(q, k, v, causal=True, block_q=blk, block_k=blk)
        o = o.transpose(1, 2).reshape(b, t, h * d)
        x = x + self.proj(o)
        x = x + self._mlp(self.ln2(x))
        return x, k, v

    def forward(self, x):
        return self.forward_full(x)[0]

    def forward_step(self, x, k_ctx, v_ctx, positions):
        """One decode iteration: x [S, D] (one current token per slot),
        k_ctx/v_ctx [S, H, M, hd] (this layer's cache rows), positions
        [S] (valid rows per slot = the current token's index).  Returns
        (out [S, D], k_new [S, H, hd], v_new [S, H, hd]); the caller
        writes k_new/v_new at ``positions`` after this call, which equals
        write-then-attend since the current token enters the softmax
        explicitly."""
        return self._step(x, self.qkv(self.ln1(x)), k_ctx, v_ctx, positions)

    def _step(self, x, qkv, k_ctx, v_ctx, positions):
        """``forward_step`` from its QKV projection on."""
        o, k_new, v_new = self._attend(qkv, k_ctx, v_ctx, positions)
        x = x + self.proj(o)
        x = x + self._mlp(self.ln2(x))
        return x, k_new, v_new

    def _attend(self, qkv, k_ctx, v_ctx, positions):
        """The decode step's attention: qkv [S, 3D] -> (o [S, D], k_new
        [S, H, hd], v_new [S, H, hd])."""
        h, d = self._heads, self._dim // self._heads
        s, m = k_ctx.shape[0], k_ctx.shape[2]
        q, k_new, v_new = qkv.split(self._dim, dim=-1)
        q = q.reshape(s, h, d).float()
        k_new = k_new.reshape(s, h, d)
        v_new = v_new.reshape(s, h, d)
        scale = 1.0 / math.sqrt(d)
        # the score product's summation order follows the memory layout;
        # contiguous context rows make a dense cache slice (strided) and
        # a gathered paged view give bit-identical results
        k_ctx, v_ctx = k_ctx.contiguous(), v_ctx.contiguous()
        scores = torch.einsum("shd,shmd->shm", q, k_ctx.float()) * scale
        idx = torch.arange(m, device=qkv.device)
        valid = idx[None, None, :] < positions.long()[:, None, None]
        scores = scores.masked_fill(~valid, float("-inf"))
        self_s = (q * k_new.float()).sum(-1, keepdim=True) * scale
        w = torch.softmax(torch.cat([scores, self_s], dim=-1), dim=-1)
        o = torch.einsum("shm,shmd->shd", w[..., :m], v_ctx.float()) \
            + w[..., m:] * v_new.float()
        return o.reshape(s, h * d).to(qkv.dtype), k_new, v_new

    def forward_window(self, x, k_ctx, v_ctx, start):
        """One prefill chunk: x [1, C, D] (prompt tokens at absolute
        positions ``start..start+C-1``), k_ctx/v_ctx [1, H, M, hd] (the
        slot's gathered rows; rows < ``start`` are valid), ``start`` an
        int.  Queries attend the context rows plus causally within the
        chunk; the chunk's own K/V are returned for the caller to
        scatter.  Returns (out [1, C, D], k_new [1, H, C, hd], v_new
        [1, H, C, hd]); rows past the prompt are padding garbage."""
        b, c, _ = x.shape
        h, d = self._heads, self._dim // self._heads
        m = k_ctx.shape[2]
        qkv = self.qkv(self.ln1(x))
        q, k_new, v_new = qkv.split(self._dim, dim=-1)

        def split(a):
            return a.reshape(b, c, h, d).transpose(1, 2)

        q, k_new, v_new = split(q).float(), split(k_new), split(v_new)
        scale = 1.0 / math.sqrt(d)
        s_ctx = torch.einsum("bhcd,bhmd->bhcm", q, k_ctx.float()) * scale
        ctx_ok = torch.arange(m, device=x.device) < int(start)
        s_ctx = s_ctx.masked_fill(~ctx_ok, float("-inf"))
        s_win = torch.einsum("bhcd,bhjd->bhcj", q, k_new.float()) * scale
        causal = torch.ones((c, c), dtype=torch.bool,
                            device=x.device).tril()
        s_win = s_win.masked_fill(~causal, float("-inf"))
        w = torch.softmax(torch.cat([s_ctx, s_win], dim=-1), dim=-1)
        o = torch.einsum("bhcm,bhmd->bhcd", w[..., :m], v_ctx.float()) \
            + torch.einsum("bhcj,bhjd->bhcd", w[..., m:], v_new.float())
        o = o.transpose(1, 2).reshape(b, c, h * d).to(qkv.dtype)
        x = x + self.proj(o)
        x = x + self._mlp(self.ln2(x))
        return x, k_new, v_new

    def forward_step_window(self, x, k_ctx, v_ctx, positions):
        """Batched speculative-verify window: x [S, W, D] (row t at
        absolute position ``positions + t``), k_ctx/v_ctx [S, H, M, hd]
        (gathered rows; rows < ``positions`` are valid), positions [S].
        The window's own K/V rows are substituted into the context at
        their absolute columns, so row t sees the rows the t-th
        sequential ``forward_step`` would see; columns from
        ``positions + t`` on carry weight 0.  Each row then runs
        ``forward_step``'s own code on ``[S, D]`` operands: a GEMM over
        ``S * W`` rows may sum in another order than one over ``S``
        rows, and the row-count-invariant form keeps row t equal to the
        t-th sequential step bit for bit.  Returns (out [S, W, D], k_new
        [S, W, H, hd], v_new [S, W, H, hd])."""
        s, w, _ = x.shape
        h, d = self._heads, self._dim // self._heads
        m = k_ctx.shape[2]
        rows = [x[:, t].contiguous() for t in range(w)]
        qkvs = [self.qkv(self.ln1(r)) for r in rows]
        k_new = torch.stack([q.split(self._dim, dim=-1)[1].reshape(s, h, d)
                             for q in qkvs], 1)
        v_new = torch.stack([q.split(self._dim, dim=-1)[2].reshape(s, h, d)
                             for q in qkvs], 1)
        posw = positions.long()[:, None] + \
            torch.arange(w, device=x.device)[None, :]
        # JAX drops the rows past the gathered depth; clamped here, they
        # land in the last column, which only rows past the cache depth
        # read (rows whose tokens the engine never keeps)
        cols = posw.clamp(max=m - 1)
        sidx = torch.arange(s, device=x.device)[:, None].expand(s, w)
        k_sub, v_sub = k_ctx.contiguous().clone(), v_ctx.contiguous().clone()
        k_sub[sidx, :, cols] = k_new.to(k_sub.dtype)
        v_sub[sidx, :, cols] = v_new.to(v_sub.dtype)
        out = [self._step(rows[t], qkvs[t], k_sub, v_sub, posw[:, t])[0]
               for t in range(w)]
        return torch.stack(out, 1), k_new, v_new


class TransformerDecoder(nn.Module):
    """Decoder-only causal LM with the generation engine's cache
    contract.  ``max_len`` bounds both the learned position table and
    the engine's cache depth per sequence."""

    def __init__(self, vocab, dim=64, heads=4, depth=2, max_len=256,
                 mlp_ratio=4, flash_block=32, device=None,
                 dtype=torch.float32, seed=0):
        super().__init__()
        device = resolve_device(device)
        self._vocab = vocab
        self._dim = dim
        self._heads = heads
        self._depth = depth
        self._max_len = max_len
        kw = dict(device=device, dtype=dtype)
        self.embed = Embedding(vocab, dim, **kw)
        self.pos = nn.Parameter(torch.empty((1, max_len, dim), **kw))
        self.layers = nn.ModuleList(
            DecoderLayer(dim, heads, mlp_ratio, flash_block, **kw)
            for _ in range(depth))
        self.ln_f = LayerNorm(dim, **kw)
        self.head = Dense(vocab, dim, **kw)
        self.initialize(seed)

    @torch.no_grad()
    def initialize(self, seed=0):
        """Fill every parameter from ``seed``: weights, embeddings and
        the position table ~ N(0, 0.02), biases and LayerNorm beta 0,
        gamma 1.  Drawn on the CPU in name order, then copied to the
        parameter's device."""
        gen = torch.Generator().manual_seed(int(seed))
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "gamma":
                p.fill_(1.0)
            elif leaf in ("bias", "beta"):
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
        return self

    # ------------------------------------------------------- cache contract
    @property
    def max_len(self):
        return self._max_len

    @property
    def vocab(self):
        return self._vocab

    @property
    def device(self):
        return self.pos.device

    def cache_spec(self):
        """(layers, heads, head_dim): the engine allocates its cache as
        ``[..., layers, heads, rows, head_dim]``."""
        return self._depth, self._heads, self._dim // self._heads

    # --------------------------------------------------------------- modes
    def _pos_rows(self, positions):
        # jnp.take would not fault on an out-of-range position; a CUDA
        # gather would assert, so clamp (the engine never passes one)
        return self.pos[0][positions.long().clamp(0, self._max_len - 1)]

    def _embed_seq(self, tokens):
        t = tokens.shape[1]
        if t > self._max_len:
            raise MXNetError(f"sequence of {t} exceeds max_len "
                             f"{self._max_len}")
        return self.embed(tokens) + self.pos[:, :t]

    def forward(self, tokens):
        """Full causal LM: tokens [B, T] -> logits [B, T, V]."""
        x = self._embed_seq(tokens)
        for layer in self.layers:
            x = layer(x)
        return self.head(self.ln_f(x))

    def prefill(self, tokens, length):
        """Prompt pass for ONE slot: tokens [1, S] (right-padded bucket),
        length int (valid prefix).  Returns (logits [1, V] at the last
        valid position, k [layers, H, S, hd], v [layers, H, S, hd]);
        rows >= length carry padding garbage the decode mask never
        reads."""
        x = self._embed_seq(tokens)
        ks, vs = [], []
        for layer in self.layers:
            x, k, v = layer.forward_full(x)
            ks.append(k[0])
            vs.append(v[0])
        hidden = self.ln_f(x)
        last = max(int(length) - 1, 0)
        logits = self.head(hidden[0, last][None])
        return logits, torch.stack(ks, 0), torch.stack(vs, 0)

    def decode_step(self, tokens, positions, k_cache, v_cache):
        """Decode over every slot of a dense cache: tokens [S], positions
        [S], k_cache/v_cache [S, layers, H, M, hd].  Returns (logits
        [S, V], k_new [S, layers, H, hd], v_new [S, layers, H, hd])."""
        x = self.embed(tokens) + self._pos_rows(positions)
        ks, vs = [], []
        for li, layer in enumerate(self.layers):
            x, kn, vn = layer.forward_step(x, k_cache[:, li], v_cache[:, li],
                                           positions)
            ks.append(kn)
            vs.append(vn)
        logits = self.head(self.ln_f(x))
        return logits, torch.stack(ks, 1), torch.stack(vs, 1)

    def decode_step_paged_partial(self, tokens, positions, k_pool,
                                  v_pool, page_table, layers):
        """``decode_step_paged`` through the first ``layers`` (an int,
        ``1 <= layers <= depth``) decoder layers only — the self-draft
        of speculative decoding; ``ln_f``/``head`` read the truncated
        hidden state.  Returns (logits [S, V], k_new [S, layers, H, hd],
        v_new [S, layers, H, hd]) for the layer-sliced
        ``write_token_rows``."""
        x = self.embed(tokens) + self._pos_rows(positions)
        ks, vs = [], []
        for li, layer in enumerate(self.layers[:layers]):
            kc = gather_layer_blocks(k_pool, page_table, li)
            vc = gather_layer_blocks(v_pool, page_table, li)
            x, kn, vn = layer.forward_step(x, kc, vc, positions)
            ks.append(kn)
            vs.append(vn)
        logits = self.head(self.ln_f(x))
        return logits, torch.stack(ks, 1), torch.stack(vs, 1)

    def decode_step_paged_window(self, tokens, positions, k_pool, v_pool,
                                 page_table):
        """Batched verify pass of speculative decoding: tokens [S, W]
        (row t at absolute position ``positions + t``), positions [S]
        (pool rows below it are valid), pools / page_table as in
        ``decode_step_paged``.  Returns (logits [S, W, V], k_new [S, W,
        layers, H, hd], v_new [S, W, layers, H, hd]); the caller writes
        row j with ``write_token_rows`` at ``positions + j``."""
        w = tokens.shape[1]
        pos = positions.long()[:, None] + \
            torch.arange(w, device=tokens.device)[None, :]
        x = self.embed(tokens) + self._pos_rows(pos)
        ks, vs = [], []
        for li, layer in enumerate(self.layers):
            kc = gather_layer_blocks(k_pool, page_table, li)
            vc = gather_layer_blocks(v_pool, page_table, li)
            x, kn, vn = layer.forward_step_window(x, kc, vc, positions)
            ks.append(kn)
            vs.append(vn)
        # row by row, in the decode step's [S, D] shape (see
        # forward_step_window)
        logits = torch.stack([self.head(self.ln_f(x[:, t].contiguous()))
                              for t in range(w)], 1)
        return logits, torch.stack(ks, 2), torch.stack(vs, 2)

    def prefill_chunk(self, tokens, start, length, k_pool, v_pool,
                      page_table):
        """One bounded prompt chunk of ONE slot: tokens [1, C] (prompt
        rows ``start..start+C-1``, zero past ``length``), start / length
        ints, pools as in ``decode_step_paged``, page_table [1,
        max_blocks] (rows < ``start`` are filled).  Returns (logits
        [1, V] at prompt position ``length - 1``, meaningful only on the
        chunk that holds it, k [layers, H, C, hd], v [layers, H, C, hd])
        for whole-block scatter."""
        c = tokens.shape[1]
        start = int(start)
        x = self.embed(tokens) + self._pos_rows(
            start + torch.arange(c, device=tokens.device))[None]
        ks, vs = [], []
        for li, layer in enumerate(self.layers):
            kc = gather_layer_blocks(k_pool, page_table, li)
            vc = gather_layer_blocks(v_pool, page_table, li)
            x, k, v = layer.forward_window(x, kc, vc, start)
            ks.append(k[0])
            vs.append(v[0])
        hidden = self.ln_f(x)
        last = min(max(int(length) - 1 - start, 0), c - 1)
        logits = self.head(hidden[0, last][None])
        return logits, torch.stack(ks, 0), torch.stack(vs, 0)

    def decode_step_paged(self, tokens, positions, k_pool, v_pool,
                          page_table):
        """Decode over the paged block pool: tokens [S], positions [S],
        k_pool/v_pool [num_blocks, layers, H, block_size, hd],
        page_table [S, max_blocks] (null-block-0 rows are masked out by
        ``positions``).  Returns (logits [S, V], k_new [S, layers, H,
        hd], v_new [S, layers, H, hd]) for the caller to write at
        ``positions``."""
        x = self.embed(tokens) + self._pos_rows(positions)
        ks, vs = [], []
        for li, layer in enumerate(self.layers):
            kc = gather_layer_blocks(k_pool, page_table, li)
            vc = gather_layer_blocks(v_pool, page_table, li)
            x, kn, vn = layer.forward_step(x, kc, vc, positions)
            ks.append(kn)
            vs.append(vn)
        logits = self.head(self.ln_f(x))
        return logits, torch.stack(ks, 1), torch.stack(vs, 1)
