"""One rank of the port's four-rank CPU world, for
tests/test_torch_model_parallel.py.

Run under the launcher, which sets the ``DMLC_*`` rank variables:

    python tools/launch.py -n 4 -- python tests/torch_mp_worker.py DIR

It reads ``DIR/inputs.pt`` (the test's seeded initial weights, batches
and MoE arrays), trains the small transformer LMs of
``tests/torch_mp_models.py`` through ``TrainStep(mesh=)`` on each mesh
of ``MESHES``, runs ``moe_ffn_alltoall`` on ``ep=4`` forward and
backward, and asks for the refusals; it writes what this rank holds to
``DIR/rank<r>.pt``.  It imports the port only (gloo, on the CPU).
"""
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))
sys.path.insert(0, HERE)

import incubator_mxnet_tpu_torch as mx  # noqa: E402
from incubator_mxnet_tpu_torch.convert import (  # noqa: E402
    gluon_params_from_numpy, gluon_params_to_numpy)
from incubator_mxnet_tpu_torch.ndarray.ndarray import NDArray  # noqa: E402
from incubator_mxnet_tpu_torch.parallel import (  # noqa: E402
    TrainStep, dist, flash_attention, make_mesh, moe_ffn_alltoall,
    ring_attention_sharded, ulysses_attention_sharded)
from incubator_mxnet_tpu_torch.predict import BlockPredictor  # noqa: E402
from torch_mp_models import lm_classes  # noqa: E402

SIZES = dict(vocab=64, dim=32, heads=4, depth=2, seq_len=16)
BATCH, STEPS = 4, 2
#: PR 19's optimizer: SGD's update is linear in the gradient, so the
#: gate holds the arithmetic (Adam's divides by sqrt(v): near-zero
#: gradients make the JAX package's own mesh step differ from its
#: one-device step by about 1e-5 of a tensor's max)
SGD_KW = dict(learning_rate=0.1, momentum=0.9)
#: name -> (mesh axes, attention, model kind)
MESHES = {"dp2_tp2": (dict(dp=2, tp=2), "flash", "mlp"),
          "dp2_sp2_ulysses": (dict(dp=2, sp=2), "ulysses", "mlp"),
          "dp2_sp2_ring": (dict(dp=2, sp=2), "ring", "mlp"),
          "dp2_ep2": (dict(dp=2, ep=2), "flash", "moe"),
          "tp2_pp2": (dict(tp=2, pp=2), "flash", "pp")}
EXPERTS, MICROBATCHES = 4, 2
A2A = dict(tokens=16, dim=8, hidden=16, experts=4)
#: sizes tp=4 does not divide: blocks of ceil(5 / 4) = 2 rows leave
#: rank 3 no row of the embedding and no output feature of the column
UNEVEN = dict(vocab=5, dim=6, tokens=7)


def port_apply(fn, x):
    return NDArray(fn(x._data), x.context)


def port_attend(kind, mesh):
    def contig(*a):
        return [t.contiguous() for t in a]
    if kind == "flash":
        return lambda q, k, v: flash_attention(*contig(q, k, v), causal=True)
    if kind == "ulysses":
        return lambda q, k, v: ulysses_attention_sharded(
            *contig(q, k, v), mesh, causal=True, attn_fn=flash_attention)
    return lambda q, k, v: ring_attention_sharded(*contig(q, k, v), mesh,
                                                  causal=True)


def build_lm(pkg, apply, attend, kind):
    """The LM of model ``kind`` ("mlp", "moe" or "pp") over ``pkg``."""
    c = lm_classes(pkg, apply)
    if kind == "pp":
        return c["TransformerLM"](
            **SIZES, attend=attend, vocab_axis="pp",
            stage=c["ffn_stage"](SIZES["dim"]), stages=2,
            microbatches=MICROBATCHES, prefix="lm_")
    return c["TransformerLM"](**SIZES, attend=attend,
                              experts=EXPERTS if kind == "moe" else 0,
                              prefix="lm_")


def build_uneven(pkg):
    """ShardedEmbedding(5) -> ColumnParallelDense(5) ->
    RowParallelDense(in_units=5), to be cut over tp=4."""
    u = UNEVEN
    net = pkg.gluon.nn.HybridSequential(prefix="uneven_")
    with net.name_scope():
        net.add(pkg.parallel.ShardedEmbedding(u["vocab"], u["dim"]),
                pkg.parallel.ColumnParallelDense(
                    5, in_units=u["dim"], flatten=False, activation="relu"),
                pkg.parallel.RowParallelDense(3, in_units=5, flatten=False))
    return net


def uneven_job(inputs):
    """Two SGD steps of ``build_uneven`` on tp=4: the global parameters
    after them."""
    u = inputs["uneven"]
    with mx.cpu():
        net = build_uneven(mx)
        gluon_params_from_numpy(net, u["init"], ctx=mx.cpu())
    step = TrainStep(net, mx.gluon.loss.L2Loss(),
                     mx.optimizer.SGD(**SGD_KW),
                     mesh=make_mesh(tp=4, device="cpu"))
    for _ in range(STEPS):
        step(u["ids"], u["y"])
    return gluon_params_to_numpy(net)


def _np(t):
    return t.detach().cpu().numpy().copy()


def train_job(name, inputs, rank, outdir):
    axes, attn, kind = MESHES[name]
    mesh = make_mesh(**axes, device="cpu")
    with mx.cpu():
        net = build_lm(mx, port_apply, port_attend(attn, mesh), kind)
        gluon_params_from_numpy(net, inputs["init"][kind], ctx=mx.cpu())
    c = lm_classes(mx, port_apply)
    step = TrainStep(net, c["FlatLoss"](SIZES["vocab"]),
                     mx.optimizer.SGD(**SGD_KW), mesh=mesh)
    losses = [float(step(inputs["x"], inputs["y"]).asscalar())
              for _ in range(STEPS)]
    params = net.collect_params()
    by_tensor = {id(p._data._data): p for p in params.values()}
    states = {}
    for t, s in zip(step._params, step._states):
        p = by_tensor[id(t)]
        states[p.name] = _np(s if p._cut is None else
                             p._cut.gather(s, p.shape))
    out = {}
    if name == "dp2_tp2":
        # save_parameters writes the global arrays (a collective: every
        # rank calls it); set_data of a global array keeps this rank's
        # block of it
        net.save_parameters(os.path.join(outdir, f"saved{rank}.params"))
        head = net.head.weight
        doubled = head.data()._data * 2
        head.set_data(NDArray(doubled))
        out["set_data"] = (_np(head.local_data()._data), _np(doubled))
        head.set_data(NDArray(doubled / 2))
        # every rank: the global batch's logits (dp gathered, tp whole)
        out["predicted"] = _np(BlockPredictor(net, mesh=mesh)(inputs["x"]))
    return dict(out, losses=losses,
                params=gluon_params_to_numpy(net),
            states=states,
            local={n: _np(p.local_data()._data)
                   for n, p in params.items()},
            cut={n: p._cut is not None for n, p in params.items()},
            sharding={n: p.sharding for n, p in params.items()})


def alltoall_job(inputs):
    mesh = make_mesh(ep=4, device="cpu")
    arrays = [torch.tensor(inputs["a2a"][k], requires_grad=True)
              for k in ("x", "gate_w", "w1", "b1", "w2", "b2")]
    y, aux = moe_ffn_alltoall(*arrays, mesh, top_k=2)
    loss = (y * torch.tensor(inputs["a2a"]["cot"])).sum() + aux
    loss.backward()
    return {"y": _np(y), "aux": float(aux.detach()),
            "grads": [_np(a.grad) for a in arrays]}


def refusal_jobs():
    out = {}
    with mx.cpu():
        dense = mx.gluon.nn.Dense(8, in_units=4, prefix="plain_")
        dense.initialize(ctx=mx.cpu())
    dense.weight.sharding = ("tp", None)
    try:
        TrainStep(dense, mx.gluon.loss.L2Loss(), mx.optimizer.SGD(),
                  mesh=make_mesh(dp=2, tp=2, device="cpu"))
        out["hand_set"] = None
    except mx.MXNetError as e:
        out["hand_set"] = str(e)
    mesh = make_mesh(dp=2, sp=2, device="cpu")
    out["ulysses"] = []
    for shape in ((1, 3, 4, 8), (1, 4, 3, 8)):
        q = torch.zeros(shape)
        try:
            ulysses_attention_sharded(q, q, q, mesh)
            out["ulysses"].append(None)
        except ValueError as e:
            out["ulysses"].append(str(e))
    try:
        make_mesh(tp=2, device="cpu")
        out["tp_not_world"] = None
    except mx.MXNetError as e:
        out["tp_not_world"] = str(e)
    return out


def main():
    outdir = sys.argv[1]
    torch.set_num_threads(1)
    dist.init_process_group(backend="gloo")
    rank = int(os.environ["DMLC_WORKER_ID"])
    inputs = torch.load(os.path.join(outdir, "inputs.pt"),
                        weights_only=False)
    out = {name: train_job(name, inputs, rank, outdir) for name in MESHES}
    out["alltoall"] = alltoall_job(inputs)
    out["uneven"] = uneven_job(inputs)
    out["refusals"] = refusal_jobs()
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
