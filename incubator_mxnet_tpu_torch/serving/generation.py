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
* **Scheduler** — one background thread runs the loop: admit queued
  requests into free slots (one prefill each, bucketed to a power of
  two), then one decode step over the full slot capacity, then retire
  (EOS / max tokens / max_len / deadline) and reuse the slot at once.
  Futures stream tokens as they are produced.

What differs from the JAX engine:

* PyTorch runs eagerly, so there are no compiled program families; the
  pools are updated in place (the stand-in for buffer donation) on the
  scheduler thread's current CUDA stream, and each iteration reads back
  only its O(slots) sampled token ids.
* Sampling.  The JAX engine draws with ``fold_in(PRNGKey(seed), pos)``,
  whose bits torch cannot reproduce.  Greedy decoding (temperature 0)
  is token-identical to the JAX engine; a sampled draw here is
  Gumbel-max with noise from a CPU ``torch.Generator`` seeded by a
  splitmix64 mix of (seed as uint32, absolute position), so within the
  port it stays a pure function of (seed, position) whatever the slot,
  batch composition or device.
* Not ported yet: the prefix cache (default off here; ``prefix_cache=
  True`` raises), speculative decoding, chunked prefill, and the
  telemetry / tracing / request-journal hooks.  ``stats()`` returns the
  engine's own counters instead.
* Prompt token ids are validated at submit against the decoder's
  vocabulary: an out-of-range id would be a device-side assert on CUDA.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import logging
import queue as _queuemod
import threading
import time

import numpy as np
import torch

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
    (must stay off until the prefix cache is ported), ``eos_id``,
    ``max_new_tokens``, ``queue_depth``, ``timeout_ms`` — the JAX
    package's ``GenerationConfig`` documents each."""

    def __init__(self, slots=None, max_len=None, prefill_buckets=None,
                 eos_id=None, max_new_tokens=64, queue_depth=256,
                 timeout_ms=None, kv_layout="paged", block_size=None,
                 num_blocks=None, prefix_cache=False):
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
        if prefix_cache:
            raise MXNetError(
                "prefix_cache=True: the prefix cache is not ported to "
                "incubator_mxnet_tpu_torch yet (the JAX engine has it)")
        self.prefix_cache = False
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
            # auto: dense-equivalent capacity + one spare + the null block
            auto = self.slots * self.max_blocks + 2
            self.num_blocks = int(num_blocks) if num_blocks else \
                (gen_blocks() or auto)
            if self.num_blocks < 2:
                raise MXNetError(
                    f"num_blocks ({self.num_blocks}) must be >= 2 "
                    "(the null block + at least one allocatable block)")
        else:
            self.block_size = int(block_size or 0)
            self.max_blocks = 0
            self.num_blocks = 0
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

    def worst_blocks(self, prompt_len, max_new):
        """Worst-case blocks a request can ever hold: cache rows max out
        at min(L + max_new - 1, max_len) (the last sampled token needs
        no row)."""
        rows = max(prompt_len,
                   min(prompt_len + max_new - 1, self.max_len))
        return _ceil_div(rows, self.block_size)

    def __repr__(self):
        return (f"GenerationConfig(slots={self.slots}, "
                f"max_len={self.max_len}, "
                f"kv_layout={self.kv_layout!r}, "
                f"block_size={self.block_size}, "
                f"num_blocks={self.num_blocks}, "
                f"prefill_buckets={self.prefill_buckets}, "
                f"eos_id={self.eos_id}, "
                f"max_new_tokens={self.max_new_tokens})")


class GenerationFuture(concurrent.futures.Future):
    """Future of one generation request.  ``result()`` is the
    ``np.int32`` array of generated token ids (EOS included when hit);
    ``stream()`` yields ids as the scheduler produces them.  Failures:
    QueueFullError / DeadlineExceededError (``.tokens`` holds the
    partial output) / ServerClosedError / WorkerCrashedError."""

    def __init__(self):
        super().__init__()
        self._token_q = _queuemod.Queue()

    def _emit_token(self, tok):
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
                 "reserve_left")

    def __init__(self, req, cache_len, last_token, reserve_left=0):
        self.req = req
        self.cache_len = cache_len        # valid K/V rows of this sequence
        self.last_token = last_token      # token the next iteration feeds
        self.generated = [last_token]
        self.blocks = []                  # physical pool blocks, in
                                          # logical order (paged only)
        self.reserve_left = reserve_left  # worst-case blocks still owed


class _BlockPool:
    """Host-side physical-block allocator + refcounts (scheduler-thread
    state).  Block 0 is the reserved null block — never allocated."""

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

    def release(self, b):
        self.ref[b] -= 1
        if self.ref[b] <= 0:
            self.ref[b] = 0
            self._free.append(b)

    def free_count(self):
        return len(self._free)

    def live_count(self):
        return self.num_blocks - 1 - len(self._free)


_MASK64 = (1 << 64) - 1


def _draw_seed(seed, pos):
    """Generator seed of the draw at absolute position ``pos`` of a
    request seeded ``seed``: splitmix64 of (seed as uint32) << 32 | pos,
    in 64-bit integer arithmetic, cut to 63 bits."""
    z = ((int(seed) & 0xFFFFFFFF) << 32) | (int(pos) & 0xFFFFFFFF)
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def _gumbel(seed, pos, vocab):
    """Gumbel(0, 1) noise [vocab], a pure function of (seed, pos)."""
    gen = torch.Generator().manual_seed(_draw_seed(seed, pos))
    u = torch.rand(vocab, generator=gen, dtype=torch.float64)
    return (-torch.log(-torch.log(u.clamp_min(1e-300)))).float()


def _sample(logits, temps, seeds, positions):
    """Next token per row: greedy argmax at temperature 0, else
    Gumbel-max over ``logits / temperature`` with noise keyed by
    (seed, absolute position).  logits [S, V] on the engine's device;
    temps/seeds/positions numpy [S].  Returns np.int32 [S] (the one
    device-to-host read of an iteration)."""
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
    return out.cpu().numpy().astype(np.int32)


def _sample_one(logits, temp, seed, pos):
    """One next token from logits [V] (see ``_sample``)."""
    return int(_sample(logits[None], np.array([temp], np.float32),
                       np.array([seed], np.int64),
                       np.array([pos], np.int64))[0])


_COUNTERS = ("requests", "rejects", "tokens", "prefills", "decodes",
             "queued_on_memory", "retire_eos", "retire_max_tokens",
             "retire_max_len", "retire_deadline", "retire_error")


class GenerationEngine:
    """Continuous-batching autoregressive server over one
    ``gluon.decoder.TransformerDecoder``-contract module
    (``cache_spec`` / ``prefill`` / ``decode_step`` /
    ``decode_step_paged``).  ``device`` (``None`` -> ``cuda:0``) is where
    the cache lives and must be where the decoder's parameters are.

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
        self._cfg = config
        self._block = decoder
        self._vocab = getattr(decoder, "vocab", None)
        layers, heads, hd = decoder.cache_spec()
        if self._paged:
            shape = (config.num_blocks, layers, heads, config.block_size,
                     hd)
            self._pool = _BlockPool(config.num_blocks)
        else:
            shape = (config.slots, layers, heads, config.max_len, hd)
            self._pool = None
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
        self._closed = False
        self._drain = True
        self._crash = None
        # every key exists from the start: a reader iterating the dict
        # never races a first insertion by the scheduler thread
        self._counts = dict.fromkeys(_COUNTERS, 0)
        self._busy_prefill_s = 0.0
        self._busy_decode_s = 0.0
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

    def kv_info(self):
        """Paged-pool occupancy: block geometry, live/free counts and
        outstanding worst-case reservations."""
        if not self._paged:
            return {"layout": "dense"}
        with self._cond:
            return {"layout": "paged",
                    "block_size": self._cfg.block_size,
                    "num_blocks": self._cfg.num_blocks,
                    "max_blocks_per_slot": self._cfg.max_blocks,
                    "live": self._pool.live_count(),
                    "free": self._pool.free_count(),
                    "reserved": self._pool.reserved}

    def stats(self):
        """The engine's counters: requests, rejects, tokens, prefills,
        decodes, queued_on_memory, retire_{eos,max_tokens,max_len,
        deadline,error}, and the busy seconds of prefill and decode."""
        out = dict(self._counts)
        out["prefill_s"] = self._busy_prefill_s
        out["decode_s"] = self._busy_decode_s
        return out

    def _device_scope(self):
        if self._device.type == "cuda":
            return torch.cuda.device(self._device)
        return contextlib.nullcontext()

    def warmup(self):
        """Build the kernels and touch every code path once — one
        prefill at the smallest bucket and one decode step, neither of
        which writes the cache — so the first request pays neither the
        kernel build nor CUDA start-up."""
        cfg, dev = self._cfg, self._device
        n = cfg.slots
        with torch.inference_mode(), self._device_scope():
            b0 = cfg.prefill_buckets[0]
            self._block.prefill(
                torch.zeros((1, b0), dtype=torch.long, device=dev), 1)
            zeros = torch.zeros((n,), dtype=torch.long, device=dev)
            if self._paged:
                pt = torch.zeros((n, cfg.max_blocks), dtype=torch.long,
                                 device=dev)
                self._block.decode_step_paged(zeros, zeros, self._kv_k,
                                              self._kv_v, pt)
            else:
                self._block.decode_step(zeros, zeros, self._kv_k,
                                        self._kv_v)
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
                self._counts["rejects"] += 1
                raise QueueFullError(
                    f"generation queue full ({self._cfg.queue_depth})")
            self._queue.append(req)
            self._counts["requests"] += 1
            self._cond.notify_all()
        return fut

    def generate(self, prompt, **kw):
        """Blocking convenience: submit() + result()."""
        return self.submit(prompt, **kw).result()

    # ----------------------------------------------------------- scheduler
    def _active(self):
        return [i for i, s in enumerate(self._slots) if s is not None]

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
                    if self._active():
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
            self._counts["retire_error"] += 1
            self._fail(req, exc)

    def _fail(self, req, exc):
        req.future._end_stream()
        if not req.future.done():
            req.future.set_exception(exc)

    # ----------------------------------------------------------- admission
    def _admit(self):
        """Prefill queued requests into free slots.  Paged admission
        also reserves the request's worst-case block need; when that
        does not fit the unreserved pool, the request stays at the front
        of the queue until retirements free blocks."""
        while True:
            with self._cond:
                if not self._queue or not self._free:
                    return
                req = self._queue.popleft()
                if req.expired():
                    self._counts["retire_deadline"] += 1
                    exc = DeadlineExceededError(
                        "deadline expired before prefill")
                    exc.tokens = np.zeros((0,), np.int32)
                    self._fail(req, exc)
                    continue
                slot = self._free.pop()
            reserve = self._reserve(req) if self._paged else 0
            if reserve is None:
                with self._cond:
                    self._queue.appendleft(req)
                    self._free.append(slot)
                return
            self._admitting = req
            self._prefill(req, slot, reserve)
            self._admitting = None

    def _reserve(self, req):
        """Reserve the request's worst-case blocks; None when they do
        not fit the unreserved pool."""
        need = self._cfg.worst_blocks(int(req.prompt.size), req.max_new)
        if need > self._pool.free_count() - self._pool.reserved:
            self._counts["queued_on_memory"] += 1
            return None
        self._pool.reserved += need
        return need

    def _alloc_block(self, s):
        """One block for slot ``s``, drawing down its reservation."""
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

    def _prefill(self, req, slot, reserve):
        cfg, dev = self._cfg, self._device
        L = int(req.prompt.size)
        bucket = cfg.bucket_for(L)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :L] = req.prompt
        t0 = time.perf_counter()
        logits, k, v = self._block.prefill(torch.from_numpy(toks).to(dev),
                                           L)
        if self._paged:
            bs = cfg.block_size
            s = _Slot(req, cache_len=L, last_token=0,
                      reserve_left=reserve)
            for _ in range(_ceil_div(L, bs)):
                s.blocks.append(self._alloc_block(s))
            # padding blocks past the prompt route to the null block
            ids = np.zeros((bucket // bs,), np.int64)
            ids[:len(s.blocks)] = s.blocks
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
        s.last_token = tok
        s.generated = [tok]
        self._busy_prefill_s += time.perf_counter() - t0
        self._counts["prefills"] += 1
        self._slots[slot] = s
        self._emit(s, slot, tok)

    # -------------------------------------------------------------- decode
    def _decode_iteration(self):
        """ONE decode step over the full slot capacity; retire and free
        slots right after.  Free slots feed token 0 at position 0 with an
        all-null page-table row, so every index stays in range and their
        writes land in the null block."""
        cfg, dev = self._cfg, self._device
        n = cfg.slots
        tokens = np.zeros((n,), np.int64)
        positions = np.zeros((n,), np.int64)
        temps = np.zeros((n,), np.float32)
        seeds = np.zeros((n,), np.int64)
        active = self._active()
        if self._paged:
            pt = np.zeros((n, cfg.max_blocks), np.int64)
        for i in active:
            s = self._slots[i]
            tokens[i] = s.last_token
            positions[i] = s.cache_len
            temps[i] = s.req.temperature
            seeds[i] = s.req.seed
            if self._paged:
                # extend at a block boundary
                if s.cache_len // cfg.block_size >= len(s.blocks):
                    s.blocks.append(self._alloc_block(s))
                pt[i, :len(s.blocks)] = s.blocks
        t0 = time.perf_counter()
        tok_t = torch.from_numpy(tokens).to(dev)
        pos_t = torch.from_numpy(positions).to(dev)
        pos_c = pos_t.clamp(0, cfg.max_len - 1)
        if self._paged:
            pt_t = torch.from_numpy(pt).to(dev)
            logits, k_new, v_new = self._block.decode_step_paged(
                tok_t, pos_t, self._kv_k, self._kv_v, pt_t)
            _pa.write_token_rows(self._kv_k, pt_t, pos_c, k_new,
                                 cfg.block_size)
            _pa.write_token_rows(self._kv_v, pt_t, pos_c, v_new,
                                 cfg.block_size)
        else:
            logits, k_new, v_new = self._block.decode_step(
                tok_t, pos_t, self._kv_k, self._kv_v)
            rows = torch.arange(n, device=dev)
            self._kv_k[rows, :, :, pos_c] = k_new
            self._kv_v[rows, :, :, pos_c] = v_new
        # the sampled token lands at absolute position `positions + 1`
        out = _sample(logits, temps, seeds, positions + 1)
        self._busy_decode_s += time.perf_counter() - t0
        self._counts["decodes"] += 1
        for i in active:
            s = self._slots[i]
            s.cache_len += 1           # the fed token's row was written
            tok = int(out[i])
            s.last_token = tok
            s.generated.append(tok)
            self._emit(s, i, tok)

    def _emit(self, s, slot, tok):
        """Stream one token and apply the retirement rules."""
        req = s.req
        self._counts["tokens"] += 1
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
        self._counts["retire_" + reason] += 1
        req = s.req
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
