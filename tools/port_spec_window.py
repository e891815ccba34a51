"""The speculative-verify window of the port's decoder against K+1
sequential decode steps, at GPT-2-small width on one GPU.

    python3 tools/port_spec_window.py [--slots 8] [--k 4] [--draft 2]

On random weights (``--seed``) and a paged pool of random rows, one
window of ``K+1`` tokens per slot at positions 300..1010 goes through

* ``sequential``: ``decode_step_paged`` K+1 times, each step's rows
  written into the pool before the next (the plain engine's order);
* ``window``: ``decode_step_paged_window``, the port's hook;
* ``forms``: the window written out with its two halves chosen apart,
  to find which half keeps row t equal to the t-th sequential step:
  the dense products (LayerNorm, qkv, proj, MLP, head) run ``rows``
  (one ``[S, D]`` call per window row, the decode step's shape),
  ``flat`` (one call over all ``S*(K+1)`` rows) or ``bmm`` (one
  strided-batched GEMM over ``K+1`` blocks of ``S`` rows); the
  attention runs ``rows`` (the decode step's own ``_attend`` per row)
  or ``batched`` (one einsum over the whole window, the JAX package's
  form);
* ``draft``: K steps of ``decode_step_paged_partial`` over ``--draft``
  layers (the self-draft that proposes the window).

It prints one JSON line: each form's largest difference from
``sequential`` in logits (0 and ``bit_identical`` when equal), the rows
and argmaxes that differ, and its time (CUDA events, median of 10
after 3 warm-up calls); for ``sequential`` and ``window`` also their
device time, launches and top kernels under torch.profiler; and the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from incubator_mxnet_tpu_torch.gluon.decoder import \
    TransformerDecoder  # noqa: E402
from incubator_mxnet_tpu_torch.parallel import \
    paged_attention as pa  # noqa: E402

GPT2_SMALL = dict(vocab=50257, dim=768, heads=12, depth=12, max_len=1024)
BLOCK = 16
FORMS = [("rows", "batched"), ("flat", "rows"), ("bmm", "rows"),
         ("flat", "batched"), ("bmm", "batched")]


def per_row(fn, x):
    """``fn`` on each window row [S, D] of x [S, W, D], restacked."""
    return torch.stack([fn(x[:, t].contiguous())
                        for t in range(x.shape[1])], 1)


def dense(layer, x, products):
    """A ``Dense`` layer on x [S, W, Din] in the chosen product form."""
    if products == "rows":
        return per_row(layer, x)
    if products == "flat":
        return layer(x)
    s, w, _ = x.shape
    wt = layer.weight.t().expand(w, *layer.weight.t().shape)
    xt = x.transpose(0, 1)
    out = torch.bmm(xt, wt) if layer.bias is None else \
        torch.baddbmm(layer.bias.expand(w, s, layer.bias.shape[0]), xt, wt)
    out = out.transpose(0, 1)
    return torch.relu(out) if layer._relu else out


def norm(ln, x, products):
    return per_row(ln, x) if products == "rows" else ln(x)


def batched_attention(layer, qkv, kc, vc, pos):
    """The window's attention as one einsum: qkv [S, W, 3D], kc/vc the
    context with the window rows substituted, pos [S, W]."""
    s, w, _ = qkv.shape
    h, d = layer._heads, layer._dim // layer._heads
    m = kc.shape[2]
    q, kn, vn = qkv.split(layer._dim, dim=-1)
    q, kn, vn = (a.reshape(s, w, h, d) for a in (q, kn, vn))
    scale = 1.0 / math.sqrt(d)
    sc = torch.einsum("swhd,shmd->swhm", q, kc) * scale
    valid = torch.arange(m, device=qkv.device) < pos[:, :, None, None]
    sc = sc.masked_fill(~valid, float("-inf"))
    self_s = (q * kn).sum(-1, keepdim=True) * scale
    wt = torch.softmax(torch.cat([sc, self_s], -1), -1)
    o = torch.einsum("swhm,shmd->swhd", wt[..., :m], vc) \
        + wt[..., m:] * vn
    return o.reshape(s, w, h * d)


def window_form(net, tokens, positions, k_pool, v_pool, pt, products,
                attention):
    """The verify window's logits [S, W, V] with its products and its
    attention each in the chosen form."""
    s, w = tokens.shape
    pos = positions[:, None] + torch.arange(w, device=tokens.device)
    x = net.embed(tokens) + net._pos_rows(pos)
    sidx = torch.arange(s, device=x.device)[:, None].expand(s, w)
    for li, layer in enumerate(net.layers):
        kc = pa.gather_layer_blocks(k_pool, pt, li).contiguous().clone()
        vc = pa.gather_layer_blocks(v_pool, pt, li).contiguous().clone()
        h, d = layer._heads, layer._dim // layer._heads
        qkv = dense(layer.qkv, norm(layer.ln1, x, products), products)
        _, kn, vn = qkv.split(layer._dim, dim=-1)
        cols = pos.clamp(max=kc.shape[2] - 1)
        kc[sidx, :, cols] = kn.reshape(s, w, h, d)
        vc[sidx, :, cols] = vn.reshape(s, w, h, d)
        if attention == "rows":
            o = torch.stack([layer._attend(qkv[:, t].contiguous(), kc, vc,
                                           pos[:, t])[0]
                             for t in range(w)], 1)
        else:
            o = batched_attention(layer, qkv, kc, vc, pos)
        x = x + dense(layer.proj, o, products)
        x = x + dense(layer.fc2, dense(layer.fc1, norm(layer.ln2, x,
                                                       products),
                                       products), products)
    return dense(net.head, norm(net.ln_f, x, products), products)


def time_ms(fn, iters=10, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def device_breakdown(fn, iters=3, top=6):
    """Device time of one call of fn under torch.profiler: total ms,
    kernel launches, and the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ks = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    ks.sort(key=lambda e: -e.self_device_time_total)
    return {"device_ms": sum(e.self_device_time_total for e in ks)
            / iters / 1e3,
            "launches": sum(e.count for e in ks) // iters,
            "top": [[e.key[:70], e.count // iters,
                     e.self_device_time_total / iters / 1e3]
                    for e in ks[:top]]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--draft", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    net = TransformerDecoder(device=dev, seed=args.seed, **GPT2_SMALL)
    s, w = args.slots, args.k + 1
    mb = GPT2_SMALL["max_len"] // BLOCK
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    shape = (s * mb + 1, GPT2_SMALL["depth"], GPT2_SMALL["heads"], BLOCK,
             GPT2_SMALL["dim"] // GPT2_SMALL["heads"])
    k_pool = torch.randn(shape, device=dev, generator=gen) * 0.5
    v_pool = torch.randn(shape, device=dev, generator=gen) * 0.5
    pt = (1 + torch.arange(s * mb, device=dev)).reshape(s, mb)
    positions = torch.linspace(300, 1010, s, device=dev).long()
    tokens = torch.randint(0, GPT2_SMALL["vocab"], (s, w), device=dev,
                           generator=gen)

    def sequential(kk, vv):
        out = []
        for t in range(w):
            lg, kn, vn = net.decode_step_paged(tokens[:, t], positions + t,
                                               kk, vv, pt)
            pa.write_token_rows(kk, pt, positions + t, kn, BLOCK,
                                limit=GPT2_SMALL["max_len"])
            pa.write_token_rows(vv, pt, positions + t, vn, BLOCK,
                                limit=GPT2_SMALL["max_len"])
            out.append((lg, kn, vn))
        return out

    def draft(kk, vv):
        cur = tokens[:, 0]
        for j in range(args.k):
            lg, kn, vn = net.decode_step_paged_partial(
                cur, positions + j, kk, vv, pt, args.draft)
            pa.write_token_rows(kk, pt, positions + j, kn, BLOCK,
                                limit=GPT2_SMALL["max_len"],
                                layers=args.draft)
            cur = lg.argmax(-1)

    def compare(lg):
        return {"logits_max_abs": (lg - seq_l).abs().max().item(),
                "bit_identical": bool(torch.equal(lg, seq_l)),
                "rows_differing": int((lg != seq_l).any(-1).sum().item()),
                "argmax_differing": int((lg.argmax(-1) != seq_l.argmax(-1))
                                        .sum().item())}

    with torch.inference_mode():
        seq = sequential(k_pool.clone(), v_pool.clone())
        seq_l = torch.stack([r[0] for r in seq], 1)
        seq_k = torch.stack([r[1] for r in seq], 1)
        seq_v = torch.stack([r[2] for r in seq], 1)
        lw, kw, vw = net.decode_step_paged_window(tokens, positions, k_pool,
                                                  v_pool, pt)
        row = {"shape": {"slots": s, "window": w, "draft_layers": args.draft},
               "window": dict(compare(lw), kv_bit_identical=bool(
                   torch.equal(kw, seq_k) and torch.equal(vw, seq_v))),
               "logits_abs_max": seq_l.abs().max().item()}
        for products, attention in [("rows", "rows")] + FORMS:
            lf = window_form(net, tokens, positions, k_pool, v_pool, pt,
                             products, attention)
            row[f"{products}_products+{attention}_attention"] = compare(lf)
        kk, vv = k_pool.clone(), v_pool.clone()
        ms = {"sequential": time_ms(lambda: sequential(kk, vv)),
              "window": time_ms(lambda: net.decode_step_paged_window(
                  tokens, positions, k_pool, v_pool, pt))}
        for products, attention in FORMS:
            ms[f"{products}_products+{attention}_attention"] = time_ms(
                lambda: window_form(net, tokens, positions, k_pool, v_pool,
                                    pt, products, attention))
        ms["draft"] = time_ms(lambda: draft(kk, vv))
        ms["one_decode_step"] = time_ms(lambda: net.decode_step_paged(
            tokens[:, 0], positions, k_pool, v_pool, pt))
        row["ms"] = ms
        row["device"] = {
            "sequential": device_breakdown(lambda: sequential(kk, vv)),
            "window": device_breakdown(lambda: net.decode_step_paged_window(
                tokens, positions, k_pool, v_pool, pt))}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    row["card"] = smi
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
