"""Inference front end of the port (``incubator_mxnet_tpu/predict.py``):
``Predictor`` over a symbol checkpoint and ``BlockPredictor`` over a
module.

``Predictor`` (the reference's MXPredCreate/SetInput/Forward/GetOutput,
``predict.py:30-148``) binds a forward-only executor from the two
checkpoint artifacts; its default context is the card (``gpu(0)``, the
port's convention; the JAX default is ``cpu()``).  ``BlockPredictor``:
the JAX predictor compiles one ``EvalStep`` program per input shape;
PyTorch runs eagerly, so here a forward is the module's own call under
``torch.inference_mode()``, or with ``bf16_compute`` the port's
``EvalStep(bf16_compute=True)`` (bf16 copies of the fp32 parameters and
inputs; on the card the bf16 forms of the fused kernels).  The exported
``CompiledPredictor`` (a serialized program) waits for a later slice of
ROADMAP A7, the ``mesh=`` sharding for A6.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from .base import MXNetError
from .context import cpu, gpu, resolve_device
from .ndarray import NDArray
from .parallel.mesh import DeviceMesh
from .parallel.step import EvalStep

__all__ = ["Predictor", "load_checkpoint_predictor", "BlockPredictor"]


class Predictor:
    """MXPredCreate equivalent.

    Parameters
    ----------
    symbol : Symbol | str
        A Symbol, a path to '-symbol.json', or a JSON string.
    params : dict | str
        {'arg:name'/'aux:name' -> NDArray} dict or a '.params' path.
    input_shapes : dict name -> shape
    ctx : Context (default ``gpu(0)``; ``mx.cpu()`` for the CPU).

    Thread safety (the serving.ModelServer contract): ``forward`` takes
    an internal lock around the set-inputs + run sequence (the bound
    executor's arg arrays are shared mutable state), and the outputs it
    returns are also stashed per thread, so ``get_output()`` never
    observes another thread's results.
    """

    def __init__(self, symbol, params, input_shapes, ctx=None):
        from . import symbol as sym_mod
        from .ndarray.utils import load as nd_load
        ctx = ctx or gpu()
        if isinstance(symbol, str):
            if symbol.lstrip().startswith("{"):
                symbol = sym_mod.load_json(symbol)
            else:
                symbol = sym_mod.load(symbol)
        self._symbol = symbol
        if isinstance(params, str):
            with cpu():       # staged on the host, copied to ctx below
                params = nd_load(params)
        arg_params, aux_params = {}, {}
        for k, v in params.items():
            if k.startswith("arg:"):
                arg_params[k[4:]] = v
            elif k.startswith("aux:"):
                aux_params[k[4:]] = v
            else:
                arg_params[k] = v
        self._input_names = list(input_shapes)
        self._executor = symbol.simple_bind(
            ctx, grad_req="null", **{k: tuple(v)
                                     for k, v in input_shapes.items()})
        self._executor.copy_params_from(
            {k: v for k, v in arg_params.items()
             if k in self._executor.arg_dict},
            {k: v for k, v in aux_params.items()
             if k in self._executor.aux_dict})
        self._lock = threading.RLock()
        self._tls = threading.local()     # per-thread get_output stash

    @property
    def device(self):
        return self._executor._device

    def set_input(self, name, value):
        """MXPredSetInput."""
        if name not in self._executor.arg_dict:
            raise MXNetError(f"unknown input {name!r}")
        self._executor.copy_params_from({name: value})

    def forward(self, **inputs):
        """MXPredForward; optional inputs by keyword.  Returns the
        outputs directly (and stashes them per thread for
        ``get_output``); safe to call from concurrent threads."""
        with self._lock:
            for k, v in inputs.items():
                self.set_input(k, v)
            outputs = self._executor.forward(is_train=False)
        self._tls.outputs = outputs
        return outputs

    def get_output(self, index=0):
        """MXPredGetOutput (this thread's most recent forward)."""
        outputs = getattr(self._tls, "outputs", None)
        if outputs is None:
            raise MXNetError("forward() has not been run in this thread")
        return outputs[index]

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    def reshape(self, input_shapes):
        """MXPredReshape: a predictor for new input geometry over the
        same parameters."""
        params = {f"arg:{k}": v for k, v in self._executor.arg_dict.items()
                  if k not in self._input_names}
        params.update({f"aux:{k}": v
                       for k, v in self._executor.aux_dict.items()})
        return Predictor(self._symbol, params, input_shapes,
                         ctx=self._executor._ctx)


def load_checkpoint_predictor(prefix, epoch, input_shapes, ctx=None):
    """A Predictor from a model.save_checkpoint pair
    (prefix-symbol.json + prefix-####.params)."""
    return Predictor(f"{prefix}-symbol.json",
                     f"{prefix}-{epoch:04d}.params", input_shapes, ctx=ctx)


class BlockPredictor:
    """Batch inference on a module, on ``device`` (``None``: ``cuda:0``,
    raising without a GPU), which must be where the module's parameters
    are.  The module is put in ``eval()``.

    Usage::

        pred = BlockPredictor(net)           # net built on cuda:0
        logits = pred(images)                # numpy or tensor -> tensor
        probs = pred.predict(big, batch_size=32)

    Calls are serialised by a lock and may come from any thread: each
    runs under ``torch.inference_mode()`` with the predictor's CUDA
    device current, since both are per-thread state.  Inputs are copied
    to the device (numpy arrays through pageable host memory).

    ``bf16_compute``: ``None`` (the default) means bf16 on a CUDA device
    and fp32 on the CPU, as the JAX predictor's default is bf16 on its
    accelerator; a bf16 forward returns bf16 outputs.

    ``mesh`` (a ``parallel.DeviceMesh``, one process per rank) runs the
    forward through ``EvalStep(mesh=)``, as the JAX predictor does: the
    batch split over ``dp``, the sharded parameters cut by their
    ``sharding`` (the model-parallel layers' collectives), and every rank
    returns the global batch's output."""

    def __init__(self, block, device=None, mesh=None, bf16_compute=None):
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise MXNetError(f"BlockPredictor(mesh=...) takes a parallel."
                             f"DeviceMesh, got {type(mesh).__name__}")
        if mesh is not None and device is None:
            device = mesh.device
        self.device = resolve_device(device)
        where = {p.device for p in block.parameters()}
        if where and where != {self.device}:
            raise MXNetError(f"BlockPredictor on {self.device}, but the "
                             f"block's parameters are on {sorted(map(str, where))}")
        if bf16_compute is None:
            bf16_compute = self.device.type == "cuda"
        self.bf16_compute = bool(bf16_compute)
        self._block = block.eval()
        self._forward = EvalStep(block, mesh=mesh,
                                 bf16_compute=self.bf16_compute,
                                 device=self.device) \
            if self.bf16_compute or mesh is not None else block
        self._lock = threading.Lock()

    def _scope(self):
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _to_device(self, x):
        t = torch.from_numpy(np.ascontiguousarray(x)) \
            if isinstance(x, np.ndarray) else torch.as_tensor(x)
        return t.to(self.device)

    def __call__(self, *batch):
        """Forward one batch (each input with its batch dim); returns
        the module's output, on the device (a Gluon block's ``NDArray``
        output as its tensor)."""
        with self._lock, torch.inference_mode(), self._scope():
            out = self._forward(*(self._to_device(x) for x in batch))
        return out._data if isinstance(out, NDArray) else out

    def predict(self, data, batch_size=None):
        """Minibatched forward over a large array.  Every minibatch,
        including a single whole-array call and the tail, is padded with
        zeros to a fixed size — ``batch_size``, or with ``batch_size=None``
        the next power of two — and the padding is sliced off the
        output.  Single-output modules only."""
        data = data if isinstance(data, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(data))
        n = data.shape[0]
        if batch_size is None or batch_size >= n:
            target = batch_size if batch_size is not None else \
                (1 if n <= 1 else 1 << (n - 1).bit_length())
            return self._forward_fixed(data, target)
        return torch.cat([self._forward_fixed(data[i:i + batch_size],
                                              batch_size)
                          for i in range(0, n, batch_size)])

    def _forward_fixed(self, chunk, target):
        valid = chunk.shape[0]
        if valid < target:
            pad = torch.zeros((target - valid,) + tuple(chunk.shape[1:]),
                              dtype=chunk.dtype, device=chunk.device)
            chunk = torch.cat([chunk, pad])
        out = self(chunk)
        if not isinstance(out, torch.Tensor):
            raise MXNetError("BlockPredictor.predict supports single-output "
                             "blocks only; call the predictor directly")
        return out[:valid]
