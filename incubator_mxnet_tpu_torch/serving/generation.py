"""Autoregressive generation engine — the port of
``incubator_mxnet_tpu/serving/generation.py``: a device-resident KV
cache (paged block pool by default, dense per-slot cache as the oracle
layout) and an iteration-level continuous-batching scheduler.

* **Paged KV cache** (``kv_layout="paged"``) — two device block pools
  ``[num_blocks, layers, heads, block_size, head_dim]`` (K and V) and a
  host-owned page table ``[slots, max_blocks_per_slot]``.  Block 0 is the
  reserved null block: inactive slots and padding rows write there.
  Admission reserves a request's worst-case block need, so the pool can
  never run dry mid-decode; a request that does not fit stays queued.
  ``kv_layout="dense"`` keeps the per-slot ``[slots, layers, heads,
  max_len, head_dim]`` cache, and greedy output is identical on both.
* **Prefix cache** (``MXNET_GEN_PREFIX_CACHE``, on by default; paged
  only) — full prompt blocks are chain-hashed and refcounted.  A
  repeated prompt runs no prefill: its first token is drawn from the
  cached last-position logits.  A prompt that shares warm full blocks
  maps them instead of writing them again, and the first decode write
  into a shared block copies it first (copy-on-write).  Under memory
  pressure admission evicts cold entries, least recently used first.
* **Speculative decoding** (``MXNET_GEN_SPEC_K=K``, off by default;
  paged only) — the first ``spec_draft_layers`` layers propose K tokens
  per slot, one full-depth window verifies all K+1 rows, and the host
  keeps the accepted prefix; rejected rows stay behind ``cache_len``
  and the next window writes over them.  Greedy acceptance compares
  tokens; sampled acceptance is the rejection rule ``u q(d) <= p(d)``
  with a residual resample.
* **Chunked prefill** (``MXNET_GEN_PREFILL_CHUNK=C``, off by default;
  paged only) — prompts prefill in block-aligned C-token chunks, one
  chunk of one slot per scheduler pass between decode iterations, so a
  long prompt cannot hold the loop.  A partial prefix hit adopts the
  warm lead blocks and fills only the tail.
* **Scheduler** — one background thread runs the loop: admit queued
  requests into free slots, one prefill chunk when chunking, then one
  decode step (or spec window) over the full slot capacity, then retire
  (EOS / max tokens / max_len / deadline) and reuse the slot at once.
  Futures stream tokens as they are produced.

What differs from the JAX engine:

* PyTorch runs eagerly, so there are no compiled program families; the
  pools are updated in place (the stand-in for buffer donation) on the
  scheduler thread's current CUDA stream, and each iteration reads back
  only its O(slots) sampled token ids (O(slots * (K+1)) with spec).
* Sampling.  The JAX engine draws with ``fold_in(PRNGKey(seed), pos)``,
  whose bits torch cannot reproduce.  Greedy decoding (temperature 0)
  is token-identical to the JAX engine; a sampled draw here is
  Gumbel-max with noise from a CPU ``torch.Generator`` seeded by a
  splitmix64 mix of (seed as uint32, absolute position), so within the
  port it stays a pure function of (seed, position) whatever the slot,
  batch composition or device.  Speculative decoding's extra draws XOR
  the JAX engine's role salts into the seed.
* The spec window runs each of its rows in the decode step's own shapes
  (``gluon.decoder.DecoderLayer.forward_step_window``), so speculative
  greedy output equals the plain engine's bit for bit on any device.
* Admission reserves the spec window's overshoot too (``worst_blocks``
  counts it; the JAX admission leaves it out).
* ``stats()`` is the ``gen.*`` slice of ``telemetry.report(as_dict=
  True)``, as in the JAX engine: ``gen.kv.*`` exists only once a paged
  engine is built, ``gen.prefix.*`` with the prefix cache live,
  ``gen.spec.*`` with speculative decoding and
  ``gen.prefill.chunk.count`` with chunked prefill; none with
  ``MXNET_TELEMETRY=0``.  The registry is process-wide, so every engine
  of the process adds to it.  The tracing and request-journal hooks are
  not ported yet.
* Prompt token ids are validated at submit against the decoder's
  vocabulary: an out-of-range id would be a device-side assert on CUDA.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import hashlib
import logging
import queue as _queuemod
import threading
import time

import numpy as np
import torch

from .. import telemetry
from ..base import MXNetError, get_env
from ..context import resolve_device
from ..parallel import paged_attention as _pa
from .batcher import (DeadlineExceededError, QueueFullError,
                      ServerClosedError, WorkerCrashedError)

__all__ = ["GenerationConfig", "GenerationEngine", "GenerationFuture"]

_logger = logging.getLogger(__name__)


def gen_slots():
    """MXNET_GEN_SLOTS: decode-batch capacity (concurrent sequences)."""
    return max(0, get_env("MXNET_GEN_SLOTS", 8, int))


def gen_block_size():
    """MXNET_GEN_BLOCK_SIZE: KV-cache rows per pool block (pow-2)."""
    return max(1, get_env("MXNET_GEN_BLOCK_SIZE", 16, int))


def gen_blocks():
    """MXNET_GEN_BLOCKS: physical pool blocks (incl. the null block);
    0 = auto."""
    return max(0, get_env("MXNET_GEN_BLOCKS", 0, int))


def gen_spec_k():
    """MXNET_GEN_SPEC_K: draft tokens proposed per decode iteration
    (paged layout only); 0 turns speculative decoding off."""
    return max(0, get_env("MXNET_GEN_SPEC_K", 0, int))


def gen_prefill_chunk():
    """MXNET_GEN_PREFILL_CHUNK: prefill chunk length in tokens (paged
    layout only, rounded down to whole blocks, at least one); 0 turns
    chunked prefill off."""
    return max(0, get_env("MXNET_GEN_PREFILL_CHUNK", 0, int))


def prefix_cache_enabled():
    """MXNET_GEN_PREFIX_CACHE=0 turns the prefix cache off, whatever an
    engine asks for."""
    return get_env("MXNET_GEN_PREFIX_CACHE", 1, int) != 0


def _default_buckets(max_len):
    """Pow-2 chain 16, 32, ... capped at max_len (always >= one
    bucket)."""
    out, b = [], 16
    while b < max_len:
        out.append(b)
        b <<= 1
    if not out or out[-1] != max_len:
        out.append(max_len)
    return out


def _ceil_div(a, b):
    return -(-a // b)


class GenerationConfig:
    """Validated knobs of the generation engine: ``slots``,
    ``max_len``, ``prefill_buckets``, ``kv_layout`` (``"paged"`` or
    ``"dense"``), ``block_size``, ``num_blocks``, ``prefix_cache``
    (``None``: on for the paged layout), ``spec_k`` /
    ``spec_draft_layers``, ``prefill_chunk``, ``eos_id``,
    ``max_new_tokens``, ``queue_depth``, ``timeout_ms`` — the JAX
    package's ``GenerationConfig`` documents each.  The dense layout
    turns the three paged stages off."""

    def __init__(self, slots=None, max_len=None, prefill_buckets=None,
                 eos_id=None, max_new_tokens=64, queue_depth=256,
                 timeout_ms=None, kv_layout="paged", block_size=None,
                 num_blocks=None, prefix_cache=None, spec_k=None,
                 spec_draft_layers=1, prefill_chunk=None):
        self.slots = int(slots if slots is not None else gen_slots())
        if self.slots < 1:
            raise MXNetError(
                "generation disabled: slots < 1 (MXNET_GEN_SLOTS=0) — "
                "pass slots= to enable")
        self.max_len = int(max_len if max_len is not None
                           else get_env("MXNET_GEN_MAX_LEN", 256, int))
        if self.max_len < 2:
            raise MXNetError(f"max_len must be >= 2, got {self.max_len}")
        if prefill_buckets is None:
            env = get_env("MXNET_GEN_PREFILL_BUCKETS", "", str).strip()
            prefill_buckets = [int(x) for x in env.split(",") if x] \
                if env else _default_buckets(self.max_len)
        buckets = sorted({int(b) for b in prefill_buckets})
        if not buckets or buckets[0] < 1:
            raise MXNetError(
                f"prefill_buckets must be positive, got {buckets}")
        if buckets[-1] > self.max_len:
            raise MXNetError(
                f"largest prefill bucket ({buckets[-1]}) exceeds max_len "
                f"({self.max_len}) — it could not fit the cache")
        for b in buckets:
            if b & (b - 1):
                raise MXNetError(
                    f"prefill bucket {b} is not a power of two (the "
                    "flash-attention block divisibility contract)")
        self.prefill_buckets = buckets
        if kv_layout not in ("paged", "dense"):
            raise MXNetError(
                f"kv_layout must be 'paged' or 'dense', got {kv_layout!r}")
        self.kv_layout = kv_layout
        self.spec_draft_layers = max(1, int(spec_draft_layers))
        if kv_layout == "paged":
            # the default block size clamps to the smallest bucket so
            # prefill always scatters whole blocks (both are pow-2)
            self.block_size = int(block_size) if block_size is not None \
                else min(gen_block_size(), buckets[0])
            bs = self.block_size
            if bs < 1 or bs & (bs - 1):
                raise MXNetError(f"block_size {bs} is not a power of two")
            if bs > buckets[0]:
                raise MXNetError(
                    f"block_size {bs} exceeds the smallest prefill "
                    f"bucket ({buckets[0]}) — prefill could not scatter "
                    "whole blocks")
            self.max_blocks = _ceil_div(self.max_len, bs)
            # auto: dense-equivalent capacity + one block of
            # copy-on-write headroom + the null block
            auto = self.slots * self.max_blocks + 2
            self.num_blocks = int(num_blocks) if num_blocks else \
                (gen_blocks() or auto)
            if self.num_blocks < 2:
                raise MXNetError(
                    f"num_blocks ({self.num_blocks}) must be >= 2 "
                    "(the null block + at least one allocatable block)")
            # the env switch wins over the knob
            self.prefix_cache = bool(
                True if prefix_cache is None else prefix_cache) \
                and prefix_cache_enabled()
            self.spec_k = max(0, int(spec_k) if spec_k is not None
                              else gen_spec_k())
            chunk = max(0, int(prefill_chunk) if prefill_chunk is not None
                        else gen_prefill_chunk())
            if chunk:
                # block-aligned, so every chunk scatters whole blocks
                chunk = max(bs, chunk - chunk % bs)
                chunk = min(chunk, self.max_blocks * bs)
            self.prefill_chunk = chunk
        else:
            self.block_size = int(block_size or 0)
            self.max_blocks = 0
            self.num_blocks = 0
            # the three stages are paged constructions; the dense oracle
            # layout stays the plain engine
            self.prefix_cache = False
            self.spec_k = 0
            self.prefill_chunk = 0
        self.eos_id = eos_id
        self.max_new_tokens = int(max_new_tokens)
        self.queue_depth = int(queue_depth)
        self.timeout_ms = timeout_ms

    def bucket_for(self, n):
        for b in self.prefill_buckets:
            if b >= n:
                return b
        raise MXNetError(
            f"prompt of {n} tokens exceeds the largest prefill bucket "
            f"({self.prefill_buckets[-1]}); raise "
            "MXNET_GEN_PREFILL_BUCKETS / MXNET_GEN_MAX_LEN")

    def total_blocks(self, prompt_len, max_new):
        """Blocks a request's rows can ever span: rows max out at
        min(L + max_new - 1, max_len) (the last sampled token needs no
        row), and a spec window overshoots the retirement row by up to
        ``spec_k`` rows (written, then rolled back)."""
        rows = max(prompt_len, min(prompt_len + max_new - 1 + self.spec_k,
                                   self.max_len))
        return _ceil_div(rows, self.block_size)

    def worst_blocks(self, prompt_len, max_new):
        """Worst-case private blocks a request can ever hold:
        ``total_blocks`` plus one copy-on-write block when the prefix
        cache will share its partial tail."""
        need = self.total_blocks(prompt_len, max_new)
        if self.prefix_cache and prompt_len % self.block_size:
            need += 1
        return need

    def __repr__(self):
        return (f"GenerationConfig(slots={self.slots}, "
                f"max_len={self.max_len}, "
                f"kv_layout={self.kv_layout!r}, "
                f"block_size={self.block_size}, "
                f"num_blocks={self.num_blocks}, "
                f"prefix_cache={self.prefix_cache}, "
                f"prefill_buckets={self.prefill_buckets}, "
                f"spec_k={self.spec_k}, "
                f"prefill_chunk={self.prefill_chunk}, "
                f"eos_id={self.eos_id}, "
                f"max_new_tokens={self.max_new_tokens})")


class GenerationFuture(concurrent.futures.Future):
    """Future of one generation request.  ``result()`` is the
    ``np.int32`` array of generated token ids (EOS included when hit);
    ``stream()`` yields ids as the scheduler produces them.  Failures:
    QueueFullError / DeadlineExceededError (``.tokens`` holds the
    partial output) / ServerClosedError / WorkerCrashedError.
    ``submitted_at`` and ``first_token_at`` are ``time.perf_counter()``
    readings (the latter None until a token exists): their difference
    is the request's time to first token."""

    def __init__(self):
        super().__init__()
        self._token_q = _queuemod.Queue()
        self.submitted_at = time.perf_counter()
        self.first_token_at = None

    def _emit_token(self, tok):
        if self.first_token_at is None:
            self.first_token_at = time.perf_counter()
        self._token_q.put(int(tok))

    def _end_stream(self):
        self._token_q.put(None)

    def stream(self, timeout=None):
        """Yield generated token ids as they arrive; returns when the
        sequence retires (raises the failure instead, after yielding
        whatever was produced)."""
        while True:
            tok = self._token_q.get(timeout=timeout)
            if tok is None:
                exc = self.exception(timeout=timeout)
                if exc is not None:
                    raise exc
                return
            yield tok


class _Request:
    __slots__ = ("prompt", "max_new", "temperature", "seed", "eos_id",
                 "deadline", "future")

    def __init__(self, prompt, max_new, temperature, seed, eos_id,
                 deadline, future):
        self.prompt = prompt
        self.max_new = max_new
        self.temperature = temperature
        self.seed = seed
        self.eos_id = eos_id
        self.deadline = deadline
        self.future = future

    def expired(self, now=None):
        return self.deadline is not None and \
            (now if now is not None else time.perf_counter()) > self.deadline


class _Slot:
    __slots__ = ("req", "cache_len", "last_token", "generated", "blocks",
                 "reserve_left", "chunk_pos", "chunk_hashes")

    def __init__(self, req, cache_len, last_token, blocks=None,
                 reserve_left=0):
        self.req = req
        self.cache_len = cache_len        # valid K/V rows of this sequence
        self.last_token = last_token      # token the next iteration feeds
        self.generated = [last_token]
        self.blocks = blocks or []        # physical pool blocks, in
                                          # logical order (paged only)
        self.reserve_left = reserve_left  # worst-case blocks still owed
        self.chunk_pos = -1               # next prompt row a chunked
                                          # prefill fills; -1: decoding
        self.chunk_hashes = None          # prefix chain hashes, kept for
                                          # registration at chunk finish


class _BlockPool:
    """Host-side physical-block allocator + refcounts (scheduler-thread
    state; the engine's condition guards cross-thread reads).  Block 0
    is the reserved null block — never allocated, never refcounted."""

    def __init__(self, num_blocks):
        self.num_blocks = num_blocks
        self._free = list(range(1, num_blocks))[::-1]
        self.ref = np.zeros(num_blocks, np.int32)
        self.reserved = 0       # worst-case blocks promised to slots

    def alloc(self):
        if not self._free:
            raise MXNetError(
                "KV block pool exhausted mid-decode — the admission "
                "reservation invariant was violated (engine bug)")
        b = self._free.pop()
        self.ref[b] = 1
        return b

    def retain(self, b):
        self.ref[b] += 1

    def release(self, b):
        self.ref[b] -= 1
        if self.ref[b] <= 0:
            self.ref[b] = 0
            self._free.append(b)

    def free_count(self):
        return len(self._free)

    def live_count(self):
        return self.num_blocks - 1 - len(self._free)


class _PrefixCache:
    """Block-hash prompt cache (scheduler-thread state), as the JAX
    engine's.  Full prompt blocks are chain-hashed over their int32
    token bytes (hash i folds hash i-1, so equal hashes mean equal
    positions and equal preceding tokens: the condition for K/V reuse).
    ``blocks`` maps a chain hash to a physical block (one cache ref
    each); ``terminals`` maps a whole prompt to its chain hashes, its
    partial tail block (one cache ref) and its last-position logits (on
    the host) — a terminal hit runs no prefill.  Eviction is LRU under
    admission pressure: terminals first, then blocks; a block returns
    to the free list once no slot holds it either."""

    def __init__(self, pool, block_size):
        self._pool = pool
        self._bs = block_size
        self.blocks = collections.OrderedDict()     # hash -> block id
        self.terminals = collections.OrderedDict()  # bytes -> entry

    @staticmethod
    def _key(prompt):
        return np.ascontiguousarray(prompt, np.int32).tobytes()

    def chain_hashes(self, prompt):
        prompt = np.ascontiguousarray(prompt, np.int32)
        out, h = [], b"gen-prefix-v1"
        for i in range(prompt.size // self._bs):
            h = hashlib.sha1(
                h + prompt[i * self._bs:(i + 1) * self._bs].tobytes()
            ).digest()
            out.append(h)
        return out

    def lead(self, hashes):
        """Blocks of the longest warm leading full-block run
        (LRU-touched)."""
        out = []
        for h in hashes:
            b = self.blocks.get(h)
            if b is None:
                break
            self.blocks.move_to_end(h)
            out.append(b)
        return out

    def terminal(self, prompt):
        """(entry, full block ids) of an exact-prompt hit, or None.  A
        terminal whose chain blocks were evicted is stale and dropped."""
        key = self._key(prompt)
        ent = self.terminals.get(key)
        if ent is None:
            return None
        ids = []
        for h in ent["chains"]:
            b = self.blocks.get(h)
            if b is None:
                self._drop_terminal(key)
                return None
            self.blocks.move_to_end(h)
            ids.append(b)
        self.terminals.move_to_end(key)
        return ent, ids

    def register(self, prompt, hashes, slot, logits):
        """After a cold prefill: take cache refs on the slot's full
        blocks (moving the slot onto an already-cached block with the
        same hash, and freeing its duplicate) and record the terminal
        entry (tail block + last-position logits)."""
        for i, h in enumerate(hashes):
            cached = self.blocks.get(h)
            if cached is None:
                self.blocks[h] = slot.blocks[i]
                self._pool.retain(slot.blocks[i])
            elif cached != slot.blocks[i]:
                self._pool.retain(cached)
                self._pool.release(slot.blocks[i])
                slot.blocks[i] = cached
        key = self._key(prompt)
        if key not in self.terminals:
            tail_len = prompt.size % self._bs
            tail = slot.blocks[len(hashes)] if tail_len else None
            if tail is not None:
                self._pool.retain(tail)
            self.terminals[key] = {
                "chains": hashes, "tail": tail, "tail_len": tail_len,
                "logits": logits, "length": int(prompt.size)}

    def _drop_terminal(self, key):
        ent = self.terminals.pop(key, None)
        if ent is not None and ent["tail"] is not None:
            self._pool.release(ent["tail"])
        return ent

    def evict(self, want_blocks):
        """LRU-evict until ``want_blocks`` blocks returned to the free
        list (or nothing evictable remains); returns the number
        freed."""
        before = self._pool.free_count()
        for key in list(self.terminals):
            if self._pool.free_count() - before >= want_blocks:
                break
            self._drop_terminal(key)
        for h in list(self.blocks):
            if self._pool.free_count() - before >= want_blocks:
                break
            self._pool.release(self.blocks.pop(h))
        return self._pool.free_count() - before

    def size(self):
        return {"blocks": len(self.blocks),
                "terminals": len(self.terminals)}


_MASK64 = (1 << 64) - 1
# role salts of the speculative window's extra draws (the JAX engine's):
# each is XORed into the request seed, so every draw stays a pure
# function of (seed, absolute position, role)
_SPEC_DRAFT_SALT = 0x9E3779B1   # draft proposals
_SPEC_ACCEPT_SALT = 0x85EBCA6B  # rejection-rule uniforms
_SPEC_RESID_SALT = 0xC2B2AE35   # residual resamples


def _draw_seed(seed, pos):
    """Generator seed of the draw at absolute position ``pos`` of a
    request seeded ``seed``: splitmix64 of (seed as uint32) << 32 | pos,
    in 64-bit integer arithmetic, cut to 63 bits."""
    z = ((int(seed) & 0xFFFFFFFF) << 32) | (int(pos) & 0xFFFFFFFF)
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def _salted(seeds, salt):
    """Request seeds (numpy) with a role salt XORed into their uint32."""
    return (np.asarray(seeds, np.int64) & 0xFFFFFFFF) ^ salt


def _uniforms(seed, pos, n):
    """``n`` U[0, 1) draws (float64), a pure function of (seed, pos)."""
    gen = torch.Generator().manual_seed(_draw_seed(seed, pos))
    return torch.rand(n, generator=gen, dtype=torch.float64)


def _gumbel(seed, pos, vocab):
    """Gumbel(0, 1) noise [vocab], a pure function of (seed, pos)."""
    u = _uniforms(seed, pos, vocab)
    return (-torch.log(-torch.log(u.clamp_min(1e-300)))).float()


def _draw(logits, temps, seeds, positions):
    """Next token per row, on the logits' device: greedy argmax at
    temperature 0, else Gumbel-max over ``logits / temperature`` with
    noise keyed by (seed, absolute position).  logits [S, V];
    temps/seeds/positions numpy [S].  Returns a long tensor [S]."""
    logits = logits.float()
    out = logits.argmax(dim=-1)
    hot = np.flatnonzero(temps > 0)
    if hot.size:
        vocab = logits.shape[-1]
        noise = torch.stack([_gumbel(seeds[i], positions[i], vocab)
                             for i in hot]).to(logits.device)
        idx = torch.from_numpy(hot).to(logits.device)
        temp = torch.from_numpy(np.maximum(temps[hot], 1e-6)
                                .astype(np.float32)).to(logits.device)
        out[idx] = (logits[idx] / temp[:, None] + noise).argmax(dim=-1)
    return out


def _sample(logits, temps, seeds, positions):
    """``_draw`` read back as np.int32 [S] (the one device-to-host read
    of an iteration)."""
    return _draw(logits, temps, seeds, positions).cpu().numpy() \
        .astype(np.int32)


def _sample_one(logits, temp, seed, pos):
    """One next token from logits [V] (see ``_draw``)."""
    return int(_sample(logits[None], np.array([temp], np.float32),
                       np.array([seed], np.int64),
                       np.array([pos], np.int64))[0])


def _accept(drafts, dlog, outs, tlog, temps, seeds, positions):
    """The acceptance half of a spec window (the JAX engine's math).
    drafts / outs: K / K+1 long tensors [S] (the draft's proposals and
    the target's own draws); dlog / tlog: their logits.  Greedy rows
    accept a proposal equal to the target's draw; sampled rows take the
    rejection rule ``u q(d) <= p(d)`` and, on rejection, a draw from
    ``max(p - q, 0)``.  Returns (tokens np.int32 [S, K+1], accepted
    np.int32 [S]); a slot keeps ``tokens[:accepted + 1]``."""
    k = len(drafts)
    hot = np.flatnonzero(temps > 0)
    accs, emit = [], []
    for j in range(k):
        d, t = drafts[j], outs[j]
        acc, tok = d == t, t.clone()
        if hot.size:
            dev = t.device
            idx = torch.from_numpy(hot).to(dev)
            temp = torch.from_numpy(np.maximum(temps[hot], 1e-6)
                                    .astype(np.float32)).to(dev)[:, None]
            p = torch.softmax(tlog[j][idx].float() / temp, dim=-1)
            q = torch.softmax(dlog[j][idx].float() / temp, dim=-1)
            dh = d[idx][:, None]
            p_d, q_d = p.gather(1, dh)[:, 0], q.gather(1, dh)[:, 0]
            pos = positions + j + 1
            acc_seeds = _salted(seeds, _SPEC_ACCEPT_SALT)
            u = torch.stack([_uniforms(acc_seeds[i], pos[i], 1)[0]
                             for i in hot]).float().to(dev)
            resid_seeds = _salted(seeds, _SPEC_RESID_SALT)
            noise = torch.stack([_gumbel(resid_seeds[i], pos[i], p.shape[-1])
                                 for i in hot]).to(dev)
            resid = (torch.log((p - q).clamp_min(0.0) + 1e-30) + noise) \
                .argmax(dim=-1)
            ok = u * q_d <= p_d
            acc[idx] = ok
            tok[idx] = torch.where(ok, d[idx], resid)
        accs.append(acc)
        emit.append(tok)
    emit.append(outs[k])       # the bonus token on full acceptance
    acc_m = torch.stack(accs, 1).int()
    n_acc = acc_m.cumprod(dim=1).sum(dim=1)
    return (torch.stack(emit, 1).cpu().numpy().astype(np.int32),
            n_acc.cpu().numpy().astype(np.int32))


#: the engine's own counts and the ``gen.*`` counter each feeds, by the
#: slice of the JAX schema it belongs to: "core" always, "kv" on the
#: paged layout, "prefix" with the prefix cache, "spec" with
#: speculative decoding, "chunk" with chunked prefill
_COUNTERS = {
    "requests": ("core", "gen.request.count"),
    "rejects": ("core", "gen.reject.count"),
    "tokens": ("core", "gen.token.count"),
    "prefills": ("core", "gen.prefill.count"),
    "decodes": ("core", "gen.decode.count"),
    "h2d_bytes": ("core", "gen.h2d.bytes"),
    "retire_eos": ("core", "gen.retire.eos"),
    "retire_max_tokens": ("core", "gen.retire.max_tokens"),
    "retire_max_len": ("core", "gen.retire.max_len"),
    "retire_deadline": ("core", "gen.retire.deadline"),
    "retire_error": ("core", "gen.retire.error"),
    "kv_cow": ("kv", "gen.kv.cow.count"),
    "queued_on_memory": ("kv", "gen.kv.queued_on_memory"),
    "prefix_hit": ("prefix", "gen.prefix.hit"),
    "prefix_miss": ("prefix", "gen.prefix.miss"),
    "prefix_saved_tokens": ("prefix", "gen.prefix.saved_tokens"),
    "prefix_evict": ("prefix", "gen.prefix.evict.count"),
    "spec_proposed": ("spec", "gen.spec.proposed.count"),
    "spec_accepted": ("spec", "gen.spec.accepted.count"),
    "spec_rollback": ("spec", "gen.spec.rollback.count"),
    "prefill_chunks": ("chunk", "gen.prefill.chunk.count"),
}
#: the gauges and histograms of each slice
_LEVELS = {
    "core": (("gauge", "gen.slot.occupancy"), ("gauge", "gen.queue.depth"),
             ("gauge", "gen.tokens_per_s"),
             ("gauge", "gen.time.prefill_pct"),
             ("gauge", "gen.time.decode_pct"),
             ("histogram", "gen.prefill.us"),
             ("histogram", "gen.decode.us"), ("histogram", "gen.ttft.us"),
             ("histogram", "gen.e2e.us")),
    "kv": (("gauge", "gen.kv.blocks.live"), ("gauge", "gen.kv.blocks.free"),
           ("gauge", "gen.kv.tokens_resident")),
    "spec": (("gauge", "gen.spec.accept_rate"),),
}


class GenerationEngine:
    """Continuous-batching autoregressive server over one
    ``gluon.decoder.TransformerDecoder``-contract module
    (``cache_spec`` / ``prefill`` / ``decode_step`` /
    ``decode_step_paged``, plus ``decode_step_paged_partial`` /
    ``decode_step_paged_window`` with spec and ``prefill_chunk`` with
    chunking).  ``device`` (``None`` -> ``cuda:0``) is where the cache
    lives and must be where the decoder's parameters are.

    Usage::

        eng = GenerationEngine(decoder, slots=8, max_len=256)
        eng.warmup()                       # build kernels, first touch
        fut = eng.submit([3, 1, 4], max_new_tokens=32)
        for tok in fut.stream(): ...       # per-token streaming
        out = fut.result()                 # the whole sequence
        eng.close()
    """

    def __init__(self, decoder, config=None, device=None, **knobs):
        if config is None:
            config = GenerationConfig(**knobs)
        elif knobs:
            raise MXNetError(
                f"pass either config= or knob kwargs, not both "
                f"(got {sorted(knobs)})")
        self._device = resolve_device(device)
        self._paged = config.kv_layout == "paged"
        hooks = ["cache_spec", "prefill",
                 "decode_step_paged" if self._paged else "decode_step"]
        if config.spec_k:
            hooks += ["decode_step_paged_partial", "decode_step_paged_window"]
        if config.prefill_chunk:
            hooks.append("prefill_chunk")
        for hook in hooks:
            if not callable(getattr(decoder, hook, None)):
                raise MXNetError(
                    f"decoder lacks the KV-cache hook {hook}() — see "
                    "gluon.decoder.TransformerDecoder")
        where = next(decoder.parameters()).device
        if where != self._device:
            raise MXNetError(
                f"decoder parameters live on {where} but the engine runs "
                f"on {self._device}; build the decoder with "
                f"device={str(self._device)!r}")
        block_max = getattr(decoder, "max_len", None)
        if block_max is not None and block_max < config.max_len:
            raise MXNetError(
                f"decoder position table ({block_max}) is shorter than "
                f"max_len ({config.max_len})")
        layers, heads, hd = decoder.cache_spec()
        if config.spec_k and config.spec_draft_layers >= layers:
            raise MXNetError(
                f"spec_draft_layers ({config.spec_draft_layers}) must be < "
                f"the decoder depth ({layers}) — a self-draft the size of "
                "the target proposes nothing cheaper")
        self._cfg = config
        self._block = decoder
        self._vocab = getattr(decoder, "vocab", None)
        if self._paged:
            shape = (config.num_blocks, layers, heads, config.block_size,
                     hd)
            self._pool = _BlockPool(config.num_blocks)
            self._prefix = _PrefixCache(self._pool, config.block_size) \
                if config.prefix_cache else None
        else:
            shape = (config.slots, layers, heads, config.max_len, hd)
            self._pool = None
            self._prefix = None
        # the device-resident cache, updated in place; its contents never
        # cross to the host
        self._kv_k = torch.zeros(shape, dtype=torch.float32,
                                 device=self._device)
        self._kv_v = torch.zeros(shape, dtype=torch.float32,
                                 device=self._device)
        self._queue = collections.deque()
        self._cond = threading.Condition()
        self._slots = [None] * config.slots
        self._free = list(range(config.slots))[::-1]
        self._admitting = None   # the request between queue and slot
        self._chunk_rr = 0       # round-robin cursor over mid-prefill slots
        self._closed = False
        self._drain = True
        self._crash = None
        # every key exists from the start: a reader iterating the dict
        # never races a first insertion by the scheduler thread
        self._counts = dict.fromkeys(_COUNTERS, 0)
        self._busy_prefill_s = 0.0
        self._busy_decode_s = 0.0
        self._tok_window = collections.deque(maxlen=64)
        self._slices = {"core"}
        if self._paged:
            self._slices.add("kv")
        if self._prefix is not None:
            self._slices.add("prefix")
        if config.spec_k:
            self._slices.add("spec")
        if config.prefill_chunk:
            self._slices.add("chunk")
        if telemetry.enabled:
            # the engine's slices of the gen.* schema exist from its
            # construction on, zeros included, as in the JAX engine
            for key, (part, name) in _COUNTERS.items():
                if part in self._slices:
                    telemetry.counter(name)
            for part in self._slices:
                for kind, name in _LEVELS.get(part, ()):
                    getattr(telemetry, kind)(name)
        self._scheduler = threading.Thread(
            target=self._loop, name="mxnet-gen-scheduler", daemon=True)
        self._scheduler.start()

    # ------------------------------------------------------------- plumbing
    @property
    def config(self):
        return self._cfg

    def free_slots(self):
        with self._cond:
            return len(self._free)

    def queue_depth(self):
        with self._cond:
            return len(self._queue)

    def free_blocks(self):
        """Unallocated physical pool blocks (paged layout; else None)."""
        with self._cond:
            return self._pool.free_count() if self._pool else None

    def live_blocks(self):
        """Allocated pool blocks — slots' and the prefix cache's (paged
        layout; else None)."""
        with self._cond:
            return self._pool.live_count() if self._pool else None

    def kv_info(self):
        """Paged-pool occupancy: block geometry, live/free counts,
        outstanding worst-case reservations and the prefix cache's
        sizes."""
        if not self._paged:
            return {"layout": "dense"}
        with self._cond:
            out = {"layout": "paged",
                   "block_size": self._cfg.block_size,
                   "num_blocks": self._cfg.num_blocks,
                   "max_blocks_per_slot": self._cfg.max_blocks,
                   "live": self._pool.live_count(),
                   "free": self._pool.free_count(),
                   "reserved": self._pool.reserved}
            if self._prefix is not None:
                out["prefix"] = self._prefix.size()
            return out

    def cache_info(self):
        """Where the KV cache lives: {"bytes", "shape", "devices",
        "layout"}."""
        return {"bytes": int(self._kv_k.nbytes + self._kv_v.nbytes),
                "shape": tuple(self._kv_k.shape),
                "devices": [str(self._kv_k.device)],
                "layout": self._cfg.kv_layout}

    def stats(self):
        """The ``gen.*`` slice of ``telemetry.report(as_dict=True)`` (JAX
        ``GenerationServer.stats``)."""
        snap = telemetry.report(as_dict=True)
        return {k: v for k, v in snap.items() if k.startswith("gen.")}

    def _counters(self):
        """This engine's own counts (the keys of ``_COUNTERS``) and the
        busy seconds of prefill and decode (``prefill_s``,
        ``decode_s``)."""
        out = dict(self._counts)
        out["prefill_s"] = self._busy_prefill_s
        out["decode_s"] = self._busy_decode_s
        return out

    def _count(self, key, n=1):
        self._counts[key] += n
        if telemetry.enabled:
            telemetry.counter(_COUNTERS[key][1]).inc(n)

    def _note_queue(self):
        if telemetry.enabled:
            telemetry.gauge("gen.queue.depth").set(len(self._queue))

    def _note_occupancy(self):
        if telemetry.enabled:
            telemetry.gauge("gen.slot.occupancy").set(len(self._active()))
            if self._paged:
                live = self._pool.live_count()
                telemetry.gauge("gen.kv.blocks.live").set(live)
                telemetry.gauge("gen.kv.blocks.free").set(
                    self._pool.free_count())
                telemetry.gauge("gen.kv.tokens_resident").set(
                    live * self._cfg.block_size)

    def _observe(self, name, seconds):
        if telemetry.enabled:
            telemetry.histogram(name).observe(seconds * 1e6)

    def _note_rate(self, now, produced):
        """Tokens a second over the last 64 decode iterations, and the
        busy time's prefill and decode shares (JAX ``_note_rate``)."""
        self._tok_window.append((now, produced))
        if not telemetry.enabled or len(self._tok_window) < 2:
            return
        t_first = self._tok_window[0][0]
        total = sum(p for _, p in self._tok_window) - self._tok_window[0][1]
        if now > t_first:
            telemetry.gauge("gen.tokens_per_s").set(
                round(total / (now - t_first), 2))
        busy = self._busy_prefill_s + self._busy_decode_s
        if busy > 0:
            telemetry.gauge("gen.time.prefill_pct").set(
                round(self._busy_prefill_s / busy * 100, 1))
            telemetry.gauge("gen.time.decode_pct").set(
                round(self._busy_decode_s / busy * 100, 1))

    def _device_scope(self):
        if self._device.type == "cuda":
            return torch.cuda.device(self._device)
        return contextlib.nullcontext()

    def warmup(self):
        """Build the kernels and touch every code path once — the
        prefill (one chunk when chunking, else the smallest bucket) and
        the decode step (the draft and the verify window with spec),
        none of which writes the cache — so the first request pays
        neither the kernel build nor CUDA start-up."""
        cfg, dev, blk = self._cfg, self._device, self._block
        n = cfg.slots
        with torch.inference_mode(), self._device_scope():
            zeros = torch.zeros((n,), dtype=torch.long, device=dev)
            if not self._paged:
                blk.prefill(torch.zeros((1, cfg.prefill_buckets[0]),
                                        dtype=torch.long, device=dev), 1)
                blk.decode_step(zeros, zeros, self._kv_k, self._kv_v)
            else:
                pt = torch.zeros((n, cfg.max_blocks), dtype=torch.long,
                                 device=dev)
                if cfg.prefill_chunk:
                    c = cfg.prefill_chunk
                    blk.prefill_chunk(
                        torch.zeros((1, c), dtype=torch.long, device=dev),
                        0, 1, self._kv_k, self._kv_v, pt[:1])
                else:
                    blk.prefill(torch.zeros((1, cfg.prefill_buckets[0]),
                                            dtype=torch.long, device=dev), 1)
                if cfg.spec_k:
                    blk.decode_step_paged_partial(zeros, zeros, self._kv_k,
                                                  self._kv_v, pt,
                                                  cfg.spec_draft_layers)
                    blk.decode_step_paged_window(
                        torch.zeros((n, cfg.spec_k + 1), dtype=torch.long,
                                    device=dev), zeros, self._kv_k,
                        self._kv_v, pt)
                else:
                    blk.decode_step_paged(zeros, zeros, self._kv_k,
                                          self._kv_v, pt)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    # -------------------------------------------------------------- submit
    def submit(self, prompt, max_new_tokens=None, temperature=0.0,
               seed=0, eos_id=None, timeout_ms=None):
        """Queue one prompt (iterable of int token ids).  Returns a
        GenerationFuture; the request prefills into a free slot and
        joins the running decode batch at the next iteration."""
        if self._crash is not None:
            raise WorkerCrashedError(
                f"generation scheduler crashed ({self._crash!r}); the "
                "engine is dead — recreate it")
        if self._closed:
            raise ServerClosedError("generation engine is closed")
        prompt = np.asarray(list(prompt), np.int64).ravel()
        if prompt.size < 1:
            raise MXNetError("submit: empty prompt")
        if prompt.size > self._cfg.max_len - 1:
            raise MXNetError(
                f"prompt of {prompt.size} tokens leaves no room to "
                f"generate under max_len {self._cfg.max_len}")
        if self._vocab is not None and \
                (prompt.min() < 0 or prompt.max() >= self._vocab):
            raise MXNetError(
                f"prompt token ids must lie in [0, {self._vocab})")
        if not self._cfg.prefill_chunk:
            # chunked prefill has no bucket family to validate against
            self._cfg.bucket_for(prompt.size)
        max_new = int(max_new_tokens if max_new_tokens is not None
                      else self._cfg.max_new_tokens)
        if self._paged:
            worst = self._cfg.worst_blocks(int(prompt.size), max_new)
            if worst > self._cfg.num_blocks - 1:
                raise MXNetError(
                    f"request needs up to {worst} KV blocks but the "
                    f"pool only has {self._cfg.num_blocks - 1} — raise "
                    "MXNET_GEN_BLOCKS or lower max_new_tokens")
        if timeout_ms is None:
            timeout_ms = self._cfg.timeout_ms
        deadline = time.perf_counter() + timeout_ms / 1e3 \
            if timeout_ms is not None else None
        fut = GenerationFuture()
        req = _Request(prompt, max_new, float(temperature), int(seed),
                       self._cfg.eos_id if eos_id is None else eos_id,
                       deadline, fut)
        with self._cond:
            if len(self._queue) >= self._cfg.queue_depth:
                self._count("rejects")
                raise QueueFullError(
                    f"generation queue full ({self._cfg.queue_depth})")
            self._queue.append(req)
            self._count("requests")
            self._note_queue()
            self._cond.notify_all()
        return fut

    def generate(self, prompt, **kw):
        """Blocking convenience: submit() + result()."""
        return self.submit(prompt, **kw).result()

    # ----------------------------------------------------------- scheduler
    def _active(self):
        return [i for i, s in enumerate(self._slots) if s is not None]

    def _chunking(self):
        """Slots mid-chunked-prefill."""
        return [i for i, s in enumerate(self._slots)
                if s is not None and s.chunk_pos >= 0]

    def _decode_ready(self):
        """Slots that feed the decode batch (prefill complete)."""
        return [i for i, s in enumerate(self._slots)
                if s is not None and s.chunk_pos < 0]

    def _loop(self):
        try:
            # grad mode and the current CUDA device are per thread
            with torch.inference_mode(), self._device_scope():
                while True:
                    with self._cond:
                        while not self._queue and not self._active() \
                                and not self._closed:
                            self._cond.wait()
                        closed, drain = self._closed, self._drain
                    if closed and not drain:
                        # the scheduler owns all slot state: cancellation
                        # happens here, never from the closing thread
                        self._cancel_all()
                        return
                    if closed and not self._queue and not self._active():
                        return
                    self._admit()
                    if self._cfg.prefill_chunk and self._chunking():
                        # ONE bounded chunk per pass, between decode
                        # iterations
                        self._prefill_chunk_step()
                    if self._decode_ready():
                        self._decode_iteration()
        except Exception as e:   # containment: fail every future
            self._on_crash(e)

    def _on_crash(self, e):
        self._crash = e
        _logger.error("generation scheduler died (%r): failing all "
                      "pending requests", e, exc_info=e)
        exc = WorkerCrashedError(
            f"generation scheduler crashed ({e!r}); the engine is dead "
            "— recreate it")
        with self._cond:
            victims = list(self._queue)
            self._queue.clear()
        if self._admitting is not None:
            victims.append(self._admitting)
            self._admitting = None
        for i in self._active():
            victims.append(self._slots[i].req)
            self._release_slot_blocks(self._slots[i])
            self._slots[i] = None
        for req in victims:
            self._count("retire_error")
            self._fail(req, exc)

    def _fail(self, req, exc):
        req.future._end_stream()
        if not req.future.done():
            req.future.set_exception(exc)

    # ----------------------------------------------------------- admission
    def _admit(self):
        """Admit queued requests into free slots.  Paged admission also
        reserves the request's worst-case block need, evicting cold
        prefix entries when it does not fit; when it still does not, the
        request stays at the front of the queue until retirements free
        blocks."""
        while True:
            with self._cond:
                if not self._queue or not self._free:
                    return
                req = self._queue.popleft()
                self._note_queue()
                if req.expired():
                    self._count("retire_deadline")
                    exc = DeadlineExceededError(
                        "deadline expired before prefill")
                    exc.tokens = np.zeros((0,), np.int32)
                    self._fail(req, exc)
                    continue
                slot = self._free.pop()
            self._admitting = req
            if self._paged:
                admitted = self._admit_paged(req, slot)
            else:
                self._prefill(req, slot)
                admitted = True
            self._admitting = None
            if not admitted:
                with self._cond:
                    self._queue.appendleft(req)
                    self._free.append(slot)
                    self._note_queue()
                return

    def _admit_paged(self, req, slot):
        """Reserve and start one request: a terminal prefix hit, a
        chunked or bucketed prefill (adopting a warm lead run).  False
        when its blocks do not fit even after eviction."""
        cfg = self._cfg
        L = int(req.prompt.size)
        bs = cfg.block_size
        nfull, tail_len = L // bs, L % bs
        total = cfg.total_blocks(L, req.max_new)
        warm = hashes = lead = None
        if self._prefix is not None:
            hashes = self._prefix.chain_hashes(req.prompt)
            warm = self._prefix.terminal(req.prompt)
            if warm is None:
                lead = self._prefix.lead(hashes)
        if cfg.prefill_chunk and lead:
            # the final chunk must compute row L-1's hidden state: the
            # first token's logits come from it
            lead = lead[:min(len(lead), (L - 1) // bs)]
        if warm is not None:
            need = total - nfull
            ent, ids = warm
            pins = ids + ([ent["tail"]] if ent["tail"] is not None else [])
        elif lead:
            need = total - len(lead) + (1 if tail_len else 0)
            pins = lead
        else:
            need = total + (1 if self._prefix is not None and tail_len
                            else 0)
            pins = []
        # pin the blocks this request maps before evicting: the eviction
        # may drop their own cache entries, and a pinned block stays off
        # the free list (the JAX engine retains them only after it)
        for b in pins:
            self._pool.retain(b)
        avail = self._pool.free_count() - self._pool.reserved
        if need > avail and self._prefix is not None:
            self._count("prefix_evict", self._prefix.evict(need - avail))
            avail = self._pool.free_count() - self._pool.reserved
        if need > avail:
            for b in pins:
                self._pool.release(b)
            self._count("queued_on_memory")
            return False
        self._pool.reserved += need
        if warm is not None:
            self._prefix_hit(req, slot, warm, need)
        elif cfg.prefill_chunk:
            self._start_chunked(req, slot, hashes, lead or [], need)
        else:
            self._prefill(req, slot, hashes=hashes, lead=lead or [],
                          reserve=need)
        return True

    def _alloc_block(self, s):
        """One private block for slot ``s``, drawing down its
        reservation."""
        b = self._pool.alloc()
        if s.reserve_left > 0:
            s.reserve_left -= 1
            self._pool.reserved -= 1
        return b

    def _release_slot_blocks(self, s):
        if not self._paged:
            return
        self._pool.reserved -= s.reserve_left
        s.reserve_left = 0
        for b in s.blocks:
            self._pool.release(b)
        s.blocks = []

    def _prefix_hit(self, req, slot, warm, reserve):
        """Terminal prefix hit: map the cached blocks and draw the first
        token from the cached last-position logits — no prefill runs."""
        ent, full_ids = warm
        blocks = list(full_ids)      # pinned by ``_admit_paged``
        if ent["tail"] is not None:
            blocks.append(ent["tail"])
        L = ent["length"]
        tok = _sample_one(ent["logits"], req.temperature, req.seed, L)
        self._count("prefix_hit")
        self._count("prefix_saved_tokens", L)
        self._observe("gen.ttft.us",
                      time.perf_counter() - req.future.submitted_at)
        s = _Slot(req, cache_len=L, last_token=tok, blocks=blocks,
                  reserve_left=reserve)
        self._slots[slot] = s
        self._emit(s, slot, tok)
        self._note_occupancy()

    def _register(self, req, s, hashes, logits):
        """Prefix registration after a cold prompt's prefill; keeps its
        last-position logits on the host."""
        self._count("prefix_miss")
        self._prefix.register(req.prompt, hashes or [], s,
                              logits.float().cpu())

    # ----------------------------------------------------- chunked prefill
    def _start_chunked(self, req, slot, hashes, lead, reserve):
        """Park a slot mid-prefill, adopting the warm lead blocks (pinned
        by ``_admit_paged``); ``_prefill_chunk_step`` fills the rest
        between decode iterations."""
        bs = self._cfg.block_size
        s = _Slot(req, cache_len=0, last_token=0, blocks=list(lead),
                  reserve_left=reserve)
        s.generated = []          # no token exists until the last chunk
        s.chunk_pos = s.cache_len = len(lead) * bs
        s.chunk_hashes = hashes or []
        self._count("prefix_saved_tokens", len(lead) * bs)
        self._slots[slot] = s

    def _prefill_chunk_step(self):
        """ONE chunk of ONE mid-prefill slot, round-robin."""
        cfg, dev = self._cfg, self._device
        chunking = self._chunking()
        self._chunk_rr += 1
        i = chunking[self._chunk_rr % len(chunking)]
        s = self._slots[i]
        req = s.req
        if req.expired():
            # frees the partly filled blocks without running the tail
            return self._retire(i, "deadline")
        C, bs = cfg.prefill_chunk, cfg.block_size
        L = int(req.prompt.size)
        start = s.chunk_pos
        end = min(start + C, L)
        toks = np.zeros((1, C), np.int64)
        toks[0, :end - start] = req.prompt[start:end]
        prompt_blocks = _ceil_div(L, bs)
        ids = np.zeros((C // bs,), np.int64)   # padding -> null block
        for j in range(C // bs):
            b = start // bs + j
            if b >= prompt_blocks:
                break
            if b >= len(s.blocks):
                s.blocks.append(self._alloc_block(s))
            ids[j] = s.blocks[b]
        pt = np.zeros((1, cfg.max_blocks), np.int64)
        pt[0, :len(s.blocks)] = s.blocks
        self._count("h2d_bytes", toks.nbytes + ids.nbytes + pt.nbytes)
        t0 = time.perf_counter()
        logits, k, v = self._block.prefill_chunk(
            torch.from_numpy(toks).to(dev), start, L, self._kv_k,
            self._kv_v, torch.from_numpy(pt).to(dev))
        ids = torch.from_numpy(ids).to(dev)
        _pa.scatter_prompt_blocks(self._kv_k, k, ids, bs)
        _pa.scatter_prompt_blocks(self._kv_v, v, ids, bs)
        done = end >= L
        if done:
            # the first generated token sits at absolute position L
            tok = _sample_one(logits[0], req.temperature, req.seed, L)
        t1 = time.perf_counter()
        self._busy_prefill_s += t1 - t0
        self._count("prefill_chunks")
        self._observe("gen.prefill.us", t1 - t0)
        s.chunk_pos = s.cache_len = end
        if not done:
            return
        if self._prefix is not None:
            self._register(req, s, s.chunk_hashes, logits[0])
        s.chunk_pos = -1
        s.chunk_hashes = None
        s.last_token = tok
        s.generated = [tok]
        self._count("prefills")
        self._observe("gen.ttft.us", t1 - req.future.submitted_at)
        self._emit(s, i, tok)
        self._note_occupancy()

    # ------------------------------------------------------------- prefill
    def _prefill(self, req, slot, hashes=None, lead=(), reserve=0):
        cfg, dev = self._cfg, self._device
        L = int(req.prompt.size)
        bucket = cfg.bucket_for(L)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :L] = req.prompt
        self._count("h2d_bytes", toks.nbytes)
        t0 = time.perf_counter()
        logits, k, v = self._block.prefill(torch.from_numpy(toks).to(dev),
                                           L)
        if self._paged:
            bs = cfg.block_size
            s = _Slot(req, cache_len=L, last_token=0, blocks=list(lead),
                      reserve_left=reserve)
            for _ in range(_ceil_div(L, bs) - len(lead)):
                s.blocks.append(self._alloc_block(s))
            # the warm lead and the padding blocks past the prompt
            # scatter into the null block
            ids = np.zeros((bucket // bs,), np.int64)
            ids[len(lead):len(s.blocks)] = s.blocks[len(lead):]
            self._count("h2d_bytes", ids.nbytes)
            ids = torch.from_numpy(ids).to(dev)
            _pa.scatter_prompt_blocks(self._kv_k, k, ids, bs)
            _pa.scatter_prompt_blocks(self._kv_v, v, ids, bs)
        else:
            # rows >= L are padding garbage the decode mask never reads
            self._kv_k[slot, :, :, :bucket] = k
            self._kv_v[slot, :, :, :bucket] = v
            s = _Slot(req, cache_len=L, last_token=0)
        # the first generated token sits at absolute position L
        tok = _sample_one(logits[0], req.temperature, req.seed, L)
        if self._prefix is not None:
            self._register(req, s, hashes, logits[0])
        s.last_token = tok
        s.generated = [tok]
        t1 = time.perf_counter()
        self._busy_prefill_s += t1 - t0
        self._count("prefills")
        self._observe("gen.prefill.us", t1 - t0)
        self._observe("gen.ttft.us", t1 - req.future.submitted_at)
        self._slots[slot] = s
        self._emit(s, slot, tok)
        self._note_occupancy()

    # -------------------------------------------------------------- decode
    def _decode_iteration(self):
        """ONE decode step over the full slot capacity (with spec, one
        draft + verify window: up to K+1 tokens per slot); retire and
        free slots right after.  Free slots feed token 0 at position 0
        with an all-null page-table row, so every index stays in range
        and their writes land in the null block."""
        cfg, dev = self._cfg, self._device
        n, spec = cfg.slots, cfg.spec_k
        tokens = np.zeros((n,), np.int64)
        positions = np.zeros((n,), np.int64)
        temps = np.zeros((n,), np.float32)
        seeds = np.zeros((n,), np.int64)
        active = self._decode_ready()
        if self._paged:
            pt = np.zeros((n, cfg.max_blocks), np.int64)
            cow_dst, cow_src = [], []
        for i in active:
            s = self._slots[i]
            tokens[i] = s.last_token
            positions[i] = s.cache_len
            temps[i] = s.req.temperature
            seeds[i] = s.req.seed
            if self._paged:
                # extend at a block boundary; copy-on-write when the
                # write block is shared with the prefix cache or a
                # sibling slot
                b = s.cache_len // cfg.block_size
                if b >= len(s.blocks):
                    s.blocks.append(self._alloc_block(s))
                elif self._pool.ref[s.blocks[b]] > 1:
                    old = s.blocks[b]
                    s.blocks[b] = self._alloc_block(s)
                    self._pool.release(old)
                    cow_dst.append(s.blocks[b])
                    cow_src.append(old)
                    self._count("kv_cow")
                if spec:
                    # the window's later blocks lie past the sequence
                    # end, always fresh; rows past max_len go to the
                    # null block
                    last_b = min(s.cache_len + spec, cfg.max_len - 1) \
                        // cfg.block_size
                    while len(s.blocks) <= last_b:
                        s.blocks.append(self._alloc_block(s))
                pt[i, :len(s.blocks)] = s.blocks
        self._count("h2d_bytes", tokens.nbytes + positions.nbytes
                    + temps.nbytes + seeds.nbytes
                    + (pt.nbytes if self._paged else 0))
        t0 = time.perf_counter()
        if self._paged and cow_dst:
            dst = torch.tensor(cow_dst, device=dev)
            src = torch.tensor(cow_src, device=dev)
            _pa.copy_blocks(self._kv_k, dst, src)
            _pa.copy_blocks(self._kv_v, dst, src)
        tok_t = torch.from_numpy(tokens).to(dev)
        pos_t = torch.from_numpy(positions).to(dev)
        if spec:
            out, acc = self._spec_window(tok_t, pos_t,
                                         torch.from_numpy(pt).to(dev),
                                         temps, seeds, positions)
        elif self._paged:
            pos_c = pos_t.clamp(0, cfg.max_len - 1)
            pt_t = torch.from_numpy(pt).to(dev)
            logits, k_new, v_new = self._block.decode_step_paged(
                tok_t, pos_t, self._kv_k, self._kv_v, pt_t)
            _pa.write_token_rows(self._kv_k, pt_t, pos_c, k_new,
                                 cfg.block_size)
            _pa.write_token_rows(self._kv_v, pt_t, pos_c, v_new,
                                 cfg.block_size)
        else:
            pos_c = pos_t.clamp(0, cfg.max_len - 1)
            logits, k_new, v_new = self._block.decode_step(
                tok_t, pos_t, self._kv_k, self._kv_v)
            rows = torch.arange(n, device=dev)
            self._kv_k[rows, :, :, pos_c] = k_new
            self._kv_v[rows, :, :, pos_c] = v_new
        if not spec:
            # the sampled token lands at absolute position `positions + 1`
            out = _sample(logits, temps, seeds, positions + 1)[:, None]
            acc = np.zeros((n,), np.int32)
        t1 = time.perf_counter()
        self._busy_decode_s += t1 - t0
        self._count("decodes")
        self._observe("gen.decode.us", t1 - t0)
        produced = 0
        for i in active:
            s = self._slots[i]
            a = int(acc[i])
            if spec:
                self._count("spec_proposed", spec)
                self._count("spec_accepted", a)
                # the rejected tail is the rollback: its rows stay past
                # cache_len, and the next window writes over them
                self._count("spec_rollback", spec - a)
            for j in range(a + 1):
                s.cache_len += 1       # the fed token's row was written
                tok = int(out[i, j])
                s.last_token = tok
                s.generated.append(tok)
                produced += 1
                self._emit(s, i, tok)
                if self._slots[i] is not s:
                    # retired inside the window: the later accepted
                    # tokens are dropped, as a sequential engine would
                    # never have produced them
                    break
        if spec and telemetry.enabled and self._counts["spec_proposed"]:
            telemetry.gauge("gen.spec.accept_rate").set(round(
                self._counts["spec_accepted"]
                / self._counts["spec_proposed"], 4))
        self._note_occupancy()
        self._note_rate(t1, produced)

    def _spec_window(self, tok_t, pos_t, pt_t, temps, seeds, positions):
        """Draft K tokens with the first ``spec_draft_layers`` layers,
        verify the K+1-row window at full depth, and accept (``_accept``).
        Every row is written into the pool; rows past the accepted ones
        are rolled back by the host not advancing ``cache_len``."""
        cfg, blk = self._cfg, self._block
        K, dl, bs, lim = (cfg.spec_k, cfg.spec_draft_layers,
                          cfg.block_size, cfg.max_len)
        kk, vv = self._kv_k, self._kv_v
        cur, drafts, dlog = tok_t, [], []
        draft_seeds = _salted(seeds, _SPEC_DRAFT_SALT)
        for j in range(K):
            lg, kn, vn = blk.decode_step_paged_partial(cur, pos_t + j, kk,
                                                       vv, pt_t, dl)
            _pa.write_token_rows(kk, pt_t, pos_t + j, kn, bs, limit=lim,
                                 layers=dl)
            _pa.write_token_rows(vv, pt_t, pos_t + j, vn, bs, limit=lim,
                                 layers=dl)
            cur = _draw(lg, temps, draft_seeds, positions + j + 1)
            drafts.append(cur)
            dlog.append(lg)
        feed = torch.stack([tok_t] + drafts, 1)
        lgw, knw, vnw = blk.decode_step_paged_window(feed, pos_t, kk, vv,
                                                     pt_t)
        outs = []
        for j in range(K + 1):
            _pa.write_token_rows(kk, pt_t, pos_t + j, knw[:, j], bs,
                                 limit=lim)
            _pa.write_token_rows(vv, pt_t, pos_t + j, vnw[:, j], bs,
                                 limit=lim)
            outs.append(_draw(lgw[:, j], temps, seeds, positions + j + 1))
        return _accept(drafts, dlog, outs, [lgw[:, j] for j in range(K)],
                       temps, seeds, positions)

    def _emit(self, s, slot, tok):
        """Stream one token and apply the retirement rules."""
        req = s.req
        self._count("tokens")
        req.future._emit_token(tok)
        if req.eos_id is not None and tok == req.eos_id:
            return self._retire(slot, "eos")
        if len(s.generated) >= req.max_new:
            return self._retire(slot, "max_tokens")
        if s.cache_len >= self._cfg.max_len:
            # the next iteration would write past the cache depth
            return self._retire(slot, "max_len")
        if req.expired():
            return self._retire(slot, "deadline")

    def _retire(self, slot, reason):
        s = self._slots[slot]
        self._slots[slot] = None
        with self._cond:
            self._release_slot_blocks(s)
            self._free.append(slot)
            self._cond.notify_all()
        self._count("retire_" + reason)
        req = s.req
        self._observe("gen.e2e.us",
                      time.perf_counter() - req.future.submitted_at)
        self._note_occupancy()
        toks = np.asarray(s.generated, np.int32)
        req.future._end_stream()
        if reason == "deadline":
            exc = DeadlineExceededError(
                f"deadline expired after {len(s.generated)} generated "
                f"token(s); partial output on .tokens")
            exc.tokens = toks
            if not req.future.done():
                req.future.set_exception(exc)
            return
        if not req.future.done():
            req.future.set_result(toks)

    # ------------------------------------------------------------- control
    def _cancel_all(self):
        """Fail every queued and running request (scheduler thread
        only — it owns the slot state)."""
        with self._cond:
            victims = list(self._queue)
            self._queue.clear()
        for req in victims:
            self._fail(req, ServerClosedError(
                "engine closed before the request ran"))
        for i in self._active():
            s = self._slots[i]
            self._slots[i] = None
            self._release_slot_blocks(s)
            exc = ServerClosedError(
                f"engine closed mid-generation "
                f"({len(s.generated)} token(s) produced)")
            exc.tokens = np.asarray(s.generated, np.int32)
            self._fail(s.req, exc)

    def close(self, drain=True):
        """Stop admitting; ``drain=True`` (default) finishes queued +
        running sequences first, ``drain=False`` fails them with
        ServerClosedError (partial output on ``.tokens``)."""
        if self._closed:
            return
        with self._cond:
            self._closed = True
            self._drain = drain
            self._cond.notify_all()
        self._scheduler.join(timeout=60)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close(drain=exc_type is None)
        return False
