"""The training and inference steps of the port (counterpart of
``incubator_mxnet_tpu/parallel/step.py`` ``TrainStep`` and
``EvalStep``): forward, loss, backward and optimizer update of a module,
one call per step; or a forward in eval mode.

The JAX step compiles the whole step (and a ``run_steps`` window as one
``lax.scan``) into one XLA program; the port runs it eagerly, each
step's forward, backward and update as PyTorch calls on the device.
What one step does is the JAX step body's:

* the module runs in train mode, so every BatchNorm takes its batch's
  statistics and moves its running ones towards them during the
  forward (the JAX step's aux outputs);
* the loss is the batch mean of the per-sample loss;
* every trainable parameter (``requires_grad``) is updated by the
  optimizer, with its ``lr_mult`` / ``wd_mult``: weight decay reaches
  BatchNorm gamma/beta and biases too, as in the JAX step.
* ``bf16_compute=True``: the parameters and buffers stay fp32 masters.
  Each forward runs over bf16 copies of every fp32 parameter and buffer
  (``torch.func.functional_call``) on the float inputs cast to bf16,
  explicitly, op by op as the JAX step casts its arrays (not
  ``torch.autocast``, which keeps some ops in fp32).  The loss is the
  bf16 mean cast to fp32; the gradients reach the fp32 masters through
  the casts, and the update is fp32.  The moving statistics take the
  forward's bf16 update, cast back to fp32 (JAX folds them in bf16 over
  the bf16-cast buffers too).  On a CUDA device a net's fused layers
  launch the bf16 forms of the hand-written kernels B1-B4 on those
  copies (``ops.fused_conv``, ``ops.fused_chain``), as the JAX step runs
  its Pallas kernels in bf16; on the CPU their plain versions run the
  same arithmetic.
* ``grad_accum=k``: the batch is split into k microbatches along axis 0
  (it must divide evenly); each microbatch's forward sees the moving
  statistics the previous one left (they compound), the loss is the
  mean of the microbatch losses, the gradient the mean of theirs, and
  there is one update.
* ``loss_scaler`` (``numerics.LossScaler``; with ``bf16_compute``,
  ``MXNET_LOSS_SCALE`` opts the env-configured one in): the backward
  runs on ``loss * scale`` and the gradients are divided by the scale.
  A step whose gradients are not finite applies no update: parameters,
  optimizer states and moving statistics keep their values (by
  ``torch.where`` on the device, no host sync), and the scale backs off.
  The scale state is a device float32 ``[scale, streak]``;
  ``loss_scale()`` reads it.  The optimizer's update counters count
  only applied updates, as JAX's do: the skipped steps are counted on
  the device, where Adam's, Adamax's and FTML's bias corrections read
  them, and the host's ``num_update`` and per-index counts are rewound
  (``Optimizer.rewind_updates``) once a step's overflow flag has come
  back through pinned memory, at most a few steps later on the card.

A batch is ``(x..., y)``: any number of data inputs, then the label.
``block`` is a torch module over tensors (the zoo's ResNet, with a
tensor loss such as ``gluon.nn._modules.SoftmaxCrossEntropyLoss``) or a
Gluon ``Block`` written over ``mx.nd`` (the JAX examples' nets, with a
``gluon.loss`` block or any function of NDArrays): a Gluon block gets
its data inputs as NDArrays and runs under ``autograd.record()``, its
loss takes NDArrays, and the step returns NDArray losses, as the JAX
step does.  Its parameters take the dense update whatever their
``grad_stype``, as the JAX step's do.

Inputs are numpy arrays, tensors or NDArrays.  A batch that
``pipeline_io.DevicePrefetchIter`` staged (every input stamped) is taken
as it is, with no copy and no placement check; ``resident_fastpath``
counts those calls.  ``input_prep`` (``uint8_input_prep`` for the
uint8 NHWC batches of ``io.ImageRecordIter(dtype="uint8")``) runs on
each data input on the device before the forward, as the JAX step runs
it inside its program.  ``run_steps(drain=d)`` pushes the window's
losses through a ``pipeline_io.MetricDrain`` and returns what matured.

``mesh`` (a ``parallel.DeviceMesh``; default the current one, ``with
mesh:``) makes the step data parallel over the mesh's ``dp`` axis,
one process per rank.  Under GSPMD the JAX step on a ``dp`` mesh
computes the single-device step on the global batch, and so does this
one: each rank takes its ``1/dp`` of the batch (a batch that
``DevicePrefetchIter(sharding=mesh.sharding("dp"))`` staged is that
slice already); the parameters and buffers start as rank 0's (a
broadcast when the step is built); every BatchNorm's statistics, and
their backward, are the global batch's (``ops.collective.dp_sync``
around the forward and backward when the group has more than one
rank); the gradients and the loss are averaged by one coalesced
``all_reduce`` after ``autograd.grad`` and before the optimizer, so the
loss is the global batch's mean and every rank takes the same update.
With ``grad_accum`` k, microbatch j is the global batch's j-th k-th
(rows ``[j*B/k, (j+1)*B/k)``, as the JAX step's ``split_microbatches``
takes it) split over the ranks: the step's ``sharding`` cuts a rank's
slice so (``Sharding.microbatched``), and a prefetch for it takes
``sharding=step.sharding``.  The loss scaler's overflow test reads the
averaged gradients, so every rank agrees on it.

The mesh may have ``tp``, ``pp``, ``sp`` and ``ep`` axes too (its size
the world's).  Under GSPMD the JAX step on such a mesh still computes
the single-device step on the global batch, and so does this one: the
batch is cut over ``dp`` only and replicated over the other axes; the
parameters start as rank 0's global values (one broadcast over the
world), then each sharded parameter (``Parameter.sharding``, set by
the model-parallel layers) keeps this rank's block, and so do its
optimizer states; the layers write out the collectives GSPMD inserts
(``ops.collective``), so every replicated parameter gets its whole
gradient on every rank, and the gradients are averaged over ``dp``
only.  The ranks of the other axes then agree on every replicated
parameter, bit for bit.  A parameter whose ``sharding`` splits it on
the mesh but whose layer writes no collectives (a plain ``Dense`` with
a hand-set sharding) raises ``MXNetError`` naming it.

Not ported yet, and raising ``MXNetError`` when asked for: ``mirror``,
``autotune=True`` and ``run_steps(stacked=True)``; the persistent
compile cache and the numerics sentinels have no counterpart.
"""
from __future__ import annotations

import collections
import time

import numpy as np
import torch
from torch.func import functional_call

from .. import pipeline_io as _pipeline_io
from .. import telemetry
from ..base import MXNetError
from ..context import resolve_device
from ..ndarray.ndarray import NDArray
from ..numerics import LossScaler, program_overflow
from ..ops.collective import dp_sync, gather_rows
from .dist import coalesced
from .mesh import DeviceMesh, current_mesh

__all__ = ["EvalStep", "TrainStep", "uint8_input_prep"]


def _refuse(owner, asked):
    for what, on in asked:
        if on:
            raise MXNetError(f"{owner}({what}) is not ported yet")


def _tensor(x):
    """The tensor of a batch element (NDArray, numpy array or tensor)."""
    if isinstance(x, NDArray):
        return x._data
    return torch.from_numpy(np.ascontiguousarray(x)) \
        if isinstance(x, np.ndarray) else torch.as_tensor(x)


def _inputs(step, batch):
    """The batch's tensors on ``step.device``: a stamped batch (every
    input staged by ``DevicePrefetchIter`` with the step's sharding) as
    it is, counted in ``step.resident_fastpath``; anything else cut to
    this rank's slice (on a mesh) and copied there.  A batch staged as
    some rank's slice of another sharding raises: it is not the global
    batch."""
    if _pipeline_io.enabled:
        stamp = _pipeline_io.match_stamp(batch)[0]
        if stamp is not None and stamp.sharding == step._sharding:
            step.resident_fastpath += 1
            if telemetry.enabled:
                telemetry.counter("step.resident_fastpath.count").inc()
            return [b._data for b in batch]
        if stamp is not None and stamp.sharding is not None:
            raise MXNetError(
                f"a batch staged as the slice of {stamp.sharding} fed to a "
                f"step that takes {step._sharding}: prefetch with "
                "DevicePrefetchIter(sharding=step.sharding)")
    sharding = step._sharding
    return [(sharding.local(_tensor(b)) if sharding else _tensor(b)).to(
        step.device) for b in batch]


def _data_parallel(owner, mesh):
    """``(mesh, its dp sharding)`` of a step: ``mesh`` or the current
    one, which must be a ``DeviceMesh``; ``(None, None)`` without one.
    The batch is cut over ``dp`` only, and replicated over the other
    axes (JAX ``_resolve_shardings``)."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return None, None
    if not isinstance(mesh, DeviceMesh):
        raise MXNetError(f"{owner}(mesh=...) takes a parallel.DeviceMesh, "
                         f"got {type(mesh).__name__}")
    return mesh, mesh.sharding("dp")


def _gluon_blocks(block):
    """Every Gluon block under ``block``, a ``PipelineStack``'s stage
    block included."""
    yield block
    stage = getattr(block, "_stage_block", None)
    if stage is not None:
        yield from _gluon_blocks(stage)
    for child in block._children.values():
        yield from _gluon_blocks(child)


def _model_parallel(owner, block, mesh):
    """Cut the block's sharded parameters on ``mesh`` (each rank keeps
    its block of them).  A parameter whose ``sharding`` splits it on
    this mesh but whose layer writes no collectives raises: computing
    with its block alone would train another model."""
    for blk in _gluon_blocks(block):
        for p in blk._reg_params.values():
            if p.sharding is None or not \
                    mesh.sharding(*p.sharding).is_split:
                continue
            if not getattr(blk, "_writes_collectives", False):
                raise MXNetError(
                    f"{owner}: parameter {p.name} has sharding "
                    f"{p.sharding}, but its layer {type(blk).__name__} "
                    "writes no collectives for it; use the parallel "
                    "layers (ColumnParallelDense, RowParallelDense, "
                    "ShardedEmbedding, MoELayer, PipelineStack) or clear "
                    "the sharding")
    for p in block.collect_params().values():
        p.cut(mesh)


def uint8_input_prep(mean=0.0, scale=1.0, layout="NCHW"):
    """Input prep for the uint8 NHWC batches of
    ``io.ImageRecordIter(dtype="uint8", layout="NHWC")``: on the device,
    cast to fp32, ``(x - mean) * scale`` per channel, and for an NCHW
    model the relayout (JAX ``step.py:uint8_input_prep``).  A non-uint8
    input passes through untouched, so one step serves both feeds."""
    mean_a = torch.as_tensor(np.asarray(mean, np.float32))
    scale_a = torch.as_tensor(np.asarray(scale, np.float32))

    def prep(a):
        if a.dtype != torch.uint8:
            return a
        x = (a.float() - mean_a.to(a.device)) * scale_a.to(a.device)
        return x.permute(0, 3, 1, 2) if layout == "NCHW" and x.dim() == 4 \
            else x

    return prep


def _uncut(block):
    """The block's parameters and buffers but the data of its cut Gluon
    parameters (a rank's own blocks, never broadcast)."""
    from ..gluon.block import Block
    cut = set()
    if isinstance(block, Block):
        cut = {id(p._data._data) for p in block.collect_params().values()
               if p._cut is not None}
    return [t for t in list(block.parameters()) + list(block.buffers())
            if id(t) not in cut]


def _check_placement(owner, block, device):
    where = {p.device for p in block.parameters()}
    if where and where != {device}:
        raise MXNetError(f"{owner} on {device}, but the block's parameters "
                         f"are on {sorted(map(str, where))}")


def _half(t):
    return t.to(torch.bfloat16) if t.dtype == torch.float32 else t


def _bf16_forward(block, inputs, keep_buffers):
    """``block(*inputs)`` over bf16 copies of its fp32 parameters and
    buffers, with its fp32 inputs cast to bf16.  With ``keep_buffers``
    the copies' final values (the moving statistics the forward moved,
    in bf16) are cast back into the fp32 buffers."""
    params = {n: _half(p) for n, p in block.named_parameters()}
    buffers = {n: _half(b) for n, b in block.named_buffers()}
    out = functional_call(block, (params, buffers),
                          tuple(_half(x) for x in inputs))
    if keep_buffers:
        with torch.no_grad():
            for name, buf in block.named_buffers():
                if buffers[name] is not buf:
                    buf.copy_(buffers[name])
    return out


class TrainStep:
    """One optimizer step of ``block`` under ``loss_fn`` per call, on
    ``device`` (``None``: ``cuda:0``, raising without a GPU), which must
    be where the block's parameters are.

    Usage::

        step = TrainStep(net, SoftmaxCrossEntropyLoss(),
                         SGD(learning_rate=0.1, momentum=0.9, wd=1e-4),
                         bf16_compute=True)
        loss = step(x, y)                        # one step, a 0-d tensor
        losses = step.run_steps(x, y, num_steps=100)   # (100,) tensor

    ``loss_fn`` takes tensors (``gluon.nn._modules.
    SoftmaxCrossEntropyLoss``; the ``gluon.loss`` blocks take NDArrays).
    Inputs are numpy arrays, tensors or NDArrays and are moved to the
    device (a prefetched batch is already there); losses stay on the
    device (read them when the window is done, or through a
    ``MetricDrain``).  The parameters are the block's own and are
    updated in place: there is nothing to sync back (``sync_params`` is
    kept for the API)."""

    def __init__(self, block, loss_fn, optimizer, mesh=None, batch_axis=0,
                 grad_accum=1, donate=True, bf16_compute=False, mirror=None,
                 input_prep=None, autotune=None, loss_scaler=None,
                 device=None):
        _refuse("TrainStep", (("mirror", bool(mirror)),
                              ("autotune", bool(autotune))))
        if batch_axis != 0:
            raise MXNetError("TrainStep takes the batch on axis 0")
        if int(grad_accum) != grad_accum or grad_accum < 1:
            raise MXNetError(f"grad_accum must be a positive integer, got "
                             f"{grad_accum!r}")
        self._mesh, self._sharding = _data_parallel("TrainStep", mesh)
        if self._sharding is not None and grad_accum > 1:
            # microbatch j is the global batch's, split over the ranks
            self._sharding = self._sharding.microbatched(grad_accum)
        self.device = resolve_device(
            self._mesh.device if device is None and self._mesh else device)
        self._bf16 = bool(bf16_compute)
        from ..gluon.block import Block
        self._gluon = isinstance(block, Block)
        if self._gluon and self._bf16:
            raise MXNetError("TrainStep(bf16_compute=True) of a Gluon block "
                             "over mx.nd is not ported yet")
        if self._mesh is not None and self._mesh.size > 1:
            # every rank starts from rank 0's global values, then keeps
            # its block of the sharded parameters
            coalesced("broadcast", _uncut(block), None)
            if self._gluon:
                _model_parallel("TrainStep", block, self._mesh)
        _check_placement("TrainStep", block, self.device)
        self._block = block
        self._loss_fn = loss_fn
        self._optimizer = optimizer
        self._input_prep = input_prep
        #: calls that took a prefetched batch as it was (no copy)
        self.resident_fastpath = 0
        self._grad_accum = int(grad_accum)
        self._params = [p for p in block.parameters() if p.requires_grad]
        # the optimizer reads each parameter's lr_mult / wd_mult by its
        # index, as gluon.Trainer hands it its Parameters
        optimizer.param_dict = dict(enumerate(self._params))
        self._states = [optimizer.create_state_multi_precision(i, p)
                        for i, p in enumerate(self._params)]
        if loss_scaler is None and self._bf16:
            loss_scaler = LossScaler.from_env()
        self._scaler = loss_scaler
        self._scaler_state = None if loss_scaler is None else \
            loss_scaler.state_init(self.device)
        if loss_scaler is not None:
            # the overflowed steps the host has not rewound yet, counted
            # on the device: the bias corrections read it there (the JAX
            # step restores its in-program counters), and the host
            # rewinds its own counters once each step's flag has landed
            optimizer._unrewound = torch.zeros((), dtype=torch.float32,
                                               device=self.device)
            self._flags = collections.deque()
        #: the dp group (None: one process) and its size; the BN
        #: statistics are summed over it when it has more than one rank
        self._group = None if self._mesh is None else self._mesh.group("dp")
        self._dp = 1 if self._mesh is None else self._mesh.axis_size("dp")
        self._bn_group = self._group if self._dp > 1 else None

    def _forward_loss(self, xs, y):
        if self._gluon:
            from .. import autograd
            with autograd.record(train_mode=True):
                out = self._block(*[NDArray(x) for x in xs])
                loss = self._loss_fn(out, NDArray(y))
            lv = loss._data if isinstance(loss, NDArray) else loss
            return lv.mean().float()
        if not self._bf16:
            return self._loss_fn(self._block(*xs), y).mean()
        out = _bf16_forward(self._block, tuple(xs), keep_buffers=True)
        return self._loss_fn(out, y).mean().float()

    def _carry(self):
        """Every tensor an overflowed step must leave as it was: the
        trainable parameters, the optimizer states' tensors and the
        block's float buffers (the moving statistics)."""
        states = []
        for s in self._states:
            states += [t for t in (s if isinstance(s, tuple) else (s,))
                       if t is not None]
        buffers = [b for b in self._block.buffers() if b.is_floating_point()]
        return self._params + states + buffers

    def _step(self, xs, y):
        self._block.train()
        scaler = self._scaler
        if scaler is not None:
            carry = self._carry()
            kept = [t.detach().clone() for t in carry]
            scale = self._scaler_state[0]
        accum = self._grad_accum
        loss = grads = None
        parts = zip(*[x.chunk(accum) for x in xs]) if accum > 1 else [xs]
        for xi, yi in zip(parts, y.chunk(accum)):
            with torch.enable_grad(), dp_sync(self._bn_group):
                lv = self._forward_loss(list(xi), yi)
                # a block with nothing to train (every BatchNorm gamma
                # and beta fixed) still steps its moving statistics
                g = torch.autograd.grad(lv if scaler is None else lv * scale,
                                        self._params) if self._params else []
            if scaler is not None:
                g = [gi / scale for gi in g]
            lv = lv.detach()
            loss = lv if loss is None else loss + lv
            grads = list(g) if grads is None else \
                [a + b for a, b in zip(grads, g)]
        if accum > 1:
            loss = loss / accum
            grads = [g / accum for g in grads]
        if self._group is not None:
            # the global batch's mean gradient and loss on every rank
            loss = loss.reshape(1)
            coalesced("all_reduce", grads + [loss], self._group,
                      divide=self._dp)
            loss = loss[0]
        opt = self._optimizer
        for i, (p, g, s) in enumerate(zip(self._params, grads,
                                          self._states)):
            opt.update_multi_precision(i, p, g, s)
        if scaler is not None:
            overflow = program_overflow(grads)
            with torch.no_grad():
                for t, old in zip(carry, kept):
                    t.copy_(torch.where(overflow, old, t))
            self._scaler_state = scaler.next_state(self._scaler_state,
                                                   overflow)
            self._optimizer._unrewound.add_(overflow)
            self._post_flag(overflow)
            self._rewind_skipped(wait=False)
        return loss

    def _post_flag(self, overflow):
        """Send the step's overflow flag to the host without waiting: a
        copy into pinned memory behind an event on the card, the tensor
        itself on the CPU."""
        if overflow.device.type != "cuda":
            self._flags.append((None, overflow))
            return
        flag = torch.empty((), dtype=torch.bool, pin_memory=True)
        flag.copy_(overflow, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self._flags.append((event, flag))

    def _rewind_skipped(self, wait):
        """Rewind the optimizer's host counters by each overflowed step
        whose flag has reached the host (JAX rewinds its host counter
        when its drain reads the step's record): after every step those
        already landed (on the CPU, all), and every one when ``wait``
        (``loss_scale()`` reads the device state anyway)."""
        opt = self._optimizer
        while self._flags:
            event, flag = self._flags[0]
            if event is not None:
                if not (wait or event.query()):
                    return
                event.synchronize()
            self._flags.popleft()
            if bool(flag):
                opt.rewind_updates(1)
                opt._unrewound.sub_(1.0)

    def loss_scale(self):
        """The current loss scale (a host read of the device state), or
        None without a scaler."""
        if self._scaler is None:
            return None
        self._rewind_skipped(wait=True)
        return float(self._scaler_state[0])

    def sync_params(self):
        """Nothing to do: the step updates the block's own parameters in
        place (the JAX step keeps them in its own carry).  A cut
        parameter's ``data()`` gathers the global array from the ranks'
        blocks."""

    @property
    def mesh(self):
        return self._mesh

    @property
    def sharding(self):
        """How the step cuts a global batch into this rank's slice (None
        without a mesh): ``DevicePrefetchIter(sharding=step.sharding)``
        stages batches the step takes as they are."""
        return self._sharding

    def __call__(self, *batch):
        """One step on the batch ``(x..., y)``; returns its loss (fp32,
        a 0-d tensor on the device; an NDArray for a Gluon block)."""
        if not telemetry.enabled:
            return self.run_steps(*batch, num_steps=1)[0]
        t0 = time.perf_counter()
        loss = self.run_steps(*batch, num_steps=1)[0]
        # the host time to enqueue the step (the card runs behind it)
        telemetry.histogram("step.dispatch.us").observe(
            (time.perf_counter() - t0) * 1e6)
        return loss

    def run_steps(self, *batch, num_steps=None, stacked=False, drain=None):
        """``num_steps`` steps on the one batch ``(x..., y)`` (the
        benchmark's resident batch); returns the ``(num_steps,)`` fp32
        losses on the device (an NDArray for a Gluon block).  With
        ``drain`` (a ``pipeline_io.MetricDrain``) the losses are pushed
        through it and the list of matured host losses of earlier
        windows is returned instead (empty until the drain fills)."""
        _refuse("run_steps", (("stacked=True", stacked),))
        if num_steps is None or num_steps < 1:
            raise MXNetError(f"run_steps needs num_steps >= 1, got "
                             f"{num_steps}")
        if telemetry.enabled:
            telemetry.counter("step.count").inc(int(num_steps))
            # the bytes fed from host arrays (numpy, as JAX counts
            # them) or from tensors on another device; a tensor already
            # on the step's device is resident
            telemetry.counter("transfer.h2d.bytes").inc(sum(
                _tensor(b).nbytes for b in batch
                if isinstance(b, np.ndarray)
                or _tensor(b).device != self.device))
        *xs, y = _inputs(self, batch)
        if self._input_prep is not None:
            xs = [self._input_prep(x) for x in xs]
        if self._grad_accum > 1 and any(
                a.shape[0] % self._grad_accum or a.shape[0] != y.shape[0]
                for a in xs):
            raise MXNetError(
                f"grad_accum={self._grad_accum} splits the batch along axis "
                f"0 into equal microbatches: got {xs[0].shape[0]} samples "
                f"and {y.shape[0]} labels")
        losses = torch.stack([self._step(xs, y) for _ in range(num_steps)])
        if self._gluon:
            losses = NDArray(losses)
        return losses if drain is None else drain.push(losses)


class EvalStep:
    """The block's forward in eval mode under ``no_grad`` per call, on
    ``device`` (``None``: ``cuda:0``), the inference complement of
    ``TrainStep`` (reference ``step.py:EvalStep``).  ``bf16_compute``
    casts as ``TrainStep`` does: bf16 copies of the fp32 parameters and
    buffers, the fp32 inputs cast, and the output left in bf16.  The
    block's train/eval mode is restored after the call.

    Usage::

        logits = EvalStep(net)(x)

    Inputs are taken as ``TrainStep`` takes them (a prefetched batch as
    it is, counted in ``resident_fastpath``), and ``input_prep`` runs on
    each of them.  On a ``dp`` mesh each rank runs its slice of the
    batch, and the outputs are gathered over the ``dp`` group
    (``ops.collective.gather_rows``), so every rank returns the global
    batch's output, as the JAX step does.  On a mesh with model axes the
    sharded parameters are cut as ``TrainStep`` cuts them, and the output
    is every rank's (replicated over those axes).  Not ported yet, and
    raising ``MXNetError``: ``autotune=True``."""

    def __init__(self, block, mesh=None, bf16_compute=False,
                 input_prep=None, autotune=None, device=None):
        _refuse("EvalStep", (("autotune", bool(autotune)),))
        self._mesh, self._sharding = _data_parallel("EvalStep", mesh)
        self.device = resolve_device(
            self._mesh.device if device is None and self._mesh else device)
        self._bf16 = bool(bf16_compute)
        from ..gluon.block import Block
        self._gluon = isinstance(block, Block)
        if self._gluon and self._bf16:
            raise MXNetError("TrainStep(bf16_compute=True) of a Gluon block "
                             "over mx.nd is not ported yet")
        if self._gluon and self._mesh is not None:
            _model_parallel("EvalStep", block, self._mesh)
        _check_placement("EvalStep", block, self.device)
        self._block = block
        self._input_prep = input_prep
        #: calls that took a prefetched batch as it was (no copy)
        self.resident_fastpath = 0

    def __call__(self, *batch):
        """What the block returns for ``batch`` (numpy arrays, tensors
        or NDArrays, moved to the device)."""
        block = self._block
        was_training = block.training
        inputs = _inputs(self, batch)
        if self._input_prep is not None:
            inputs = [self._input_prep(b) for b in inputs]
        block.eval()
        try:
            with torch.no_grad():
                if self._bf16:
                    out = _bf16_forward(block, inputs, keep_buffers=False)
                elif self._gluon:
                    out = block(*[NDArray(x) for x in inputs])
                else:
                    out = block(*inputs)
        finally:
            block.train(was_training)
        group = None if self._mesh is None else self._mesh.group("dp")
        if group is None or self._mesh.axis_size("dp") == 1:
            return out
        return _gathered(out, group, self._mesh.axis_size("dp"),
                         self._mesh.axis_rank("dp"))

    @property
    def sharding(self):
        """How the step cuts a global batch (None without a mesh)."""
        return self._sharding


def _gathered(out, group, size, rank):
    """The ranks' outputs (a tensor, an NDArray or a tuple or list of
    them), each concatenated along the batch axis in rank order."""
    if isinstance(out, (tuple, list)):
        return type(out)(_gathered(o, group, size, rank) for o in out)
    t = out._data if isinstance(out, NDArray) else out
    rows = gather_rows(t, group, size, rank)
    t = rows.reshape((size * t.shape[0],) + tuple(t.shape[1:]))
    return NDArray(t, out._ctx) if isinstance(out, NDArray) else t
