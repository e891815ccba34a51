"""How far two fp32 computations of one ``Module`` step of the symbolic
ResNet-50 v2 (examples/train_imagenet.py's, ``chip_smoke.sym_get_resnet``)
agree at b=2, on one GPU and its host:

    python3 tools/port_symbolic_spread.py [--seed 0]

From Xavier weights (gaussian, in, 2) and one seeded batch of two
224x224 images, one ``forward_backward`` + ``update`` (SGD lr 0.05,
momentum 0.9, wd 1e-4) in six formulations: the NCHW graph on the card
twice and on the CPU, the graph after the FuseBatchNormRelu pass on the
CPU, and the same network in NHWC (``sym_resnet_fused(fuse=False)``) on
the CPU and on the card.  For each pair it prints, over the updated
parameters, how many lie beyond ``chip_smoke.py``'s step bound (STEP_RTOL
of the tensor's largest magnitude plus STEP_ATOL) and the six worst, in
units of that bound, with the absolute difference and the magnitude.
A step through ~50 BatchNorms at b=2 amplifies rounding: the pairs show
which formulations measure that (the ones that sum in other orders)
and which do not.
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import incubator_mxnet_tpu_torch as mx
    cs.phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mx.random.seed(args.seed)
    net = cs.sym_get_resnet(mx, cs.SYM_LAYERS, cs.SYM_CLASSES, cs.SYM_IMAGE)
    batch = (cs.SYM_REF_BATCH,) + cs.SYM_IMAGE
    with mx.cpu():
        mod = mx.mod.Module(net, context=mx.cpu())
        mod.bind(data_shapes=[("data", batch)],
                 label_shapes=[("softmax_label", batch[:1])])
        mod.init_params(initializer=mx.init.Xavier(
            rnd_type="gaussian", factor_type="in", magnitude=2))
        arg_params, aux_params = mod.get_params()
    init_args = {k: v.asnumpy() for k, v in arg_params.items()}
    init_aux = {k: v.asnumpy() for k, v in aux_params.items()}
    rs = np.random.RandomState(args.seed + 40)
    x = (rs.rand(*batch) * 100).astype(np.float32)
    y = rs.randint(0, cs.SYM_CLASSES, batch[0]).astype(np.float32)
    xh = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    fused = mx.sym.passes.apply_pass(net, "FuseBatchNormRelu").symbol
    nhwc = mx.sym.SoftmaxOutput(cs.sym_resnet_fused(
        mx, cs.SYM_UNITS, cs.SYM_FILTERS, cs.SYM_CLASSES, cs.SYM_IMAGE,
        fuse=False)[0], name="softmax")
    runs = {}
    for key, sym, ctx, data in (("card", net, mx.gpu(0), x),
                                ("card2", net, mx.gpu(0), x),
                                ("cpu", net, mx.cpu(), x),
                                ("cpu_fused", fused, mx.cpu(), x),
                                ("cpu_nhwc", nhwc, mx.cpu(), xh),
                                ("card_nhwc", nhwc, mx.gpu(0), xh)):
        with ctx:
            runs[key] = cs._sym_module_step(
                mx, sym, ctx, {k: mx.nd.array(v) for k, v in
                               init_args.items()},
                {k: mx.nd.array(v) for k, v in init_aux.items()}, data, y)
        print(json.dumps({"run": key, "loss": runs[key][1]}), flush=True)
    for a, b in (("card", "cpu"), ("card2", "card"), ("cpu_fused", "cpu"),
                 ("cpu_nhwc", "cpu"), ("card_nhwc", "cpu"),
                 ("card_nhwc", "card")):
        got, ref = runs[a][2], runs[b][2]
        rows = []
        for k in ref:
            if k.endswith(("moving_mean", "moving_var")):
                continue
            err = (got[k] - ref[k]).abs().max().item()
            scale = ref[k].abs().max().item()
            rows.append((err / (cs.STEP_RTOL * scale + cs.STEP_ATOL), k, err,
                         scale))
        rows.sort(reverse=True)
        print(json.dumps({"pair": f"{a} vs {b}", "params": len(rows),
                          "over_bound": sum(r[0] > 1 for r in rows),
                          "worst": [list(r) for r in rows[:6]]}), flush=True)


if __name__ == "__main__":
    main()
