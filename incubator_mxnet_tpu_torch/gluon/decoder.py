"""Causal transformer decoder with KV-cache hooks — the port of
``incubator_mxnet_tpu/gluon/decoder.py`` (the model half of the
generation engine).

One parameter set, four call modes (the JAX module's docstring has the
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

The speculative-decoding and chunked-prefill modes
(``decode_step_paged_partial``/``_window``, ``prefill_chunk``) come
with those stages.  Parameters are created on ``device`` (``None`` ->
``cuda:0``, raising without a GPU) and drawn from ``seed`` on the CPU,
so a seed gives the same weights on every device.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..base import MXNetError
from ..context import resolve_device
from ..parallel.flash_attention import flash_attention
from ..parallel.paged_attention import gather_layer_blocks
from .nn import Dense, Embedding, LayerNorm

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
        h, d = self._heads, self._dim // self._heads
        qkv = self.qkv(self.ln1(x))
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
        idx = torch.arange(m, device=x.device)
        valid = idx[None, None, :] < positions.long()[:, None, None]
        scores = scores.masked_fill(~valid, float("-inf"))
        self_s = (q * k_new.float()).sum(-1, keepdim=True) * scale
        w = torch.softmax(torch.cat([scores, self_s], dim=-1), dim=-1)
        o = torch.einsum("shm,shmd->shd", w[..., :m], v_ctx.float()) \
            + w[..., m:] * v_new.float()
        o = o.reshape(s, h * d).to(qkv.dtype)
        x = x + self.proj(o)
        x = x + self._mlp(self.ln2(x))
        return x, k_new, v_new


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
