"""The training step of the port (counterpart of
``incubator_mxnet_tpu/parallel/step.py`` ``TrainStep``): forward, loss,
backward and optimizer update of a module, one call per step.

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

Not ported yet, and raising ``MXNetError`` when asked for: ``mesh``,
``grad_accum > 1``, ``bf16_compute``, ``loss_scaler``, ``mirror``,
``input_prep``, ``autotune=True`` and ``run_steps(stacked=True)``; the
persistent compile cache and the numerics sentinels have no counterpart.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from ..context import resolve_device

__all__ = ["TrainStep"]


class TrainStep:
    """One optimizer step of ``block`` under ``loss_fn`` per call, on
    ``device`` (``None``: ``cuda:0``, raising without a GPU), which must
    be where the block's parameters are.

    Usage::

        step = TrainStep(net, SoftmaxCrossEntropyLoss(),
                         SGD(learning_rate=0.1, momentum=0.9, wd=1e-4))
        loss = step(x, y)                        # one step, a 0-d tensor
        losses = step.run_steps(x, y, num_steps=100)   # (100,) tensor

    Inputs are numpy arrays or tensors and are moved to the device;
    losses stay on the device (read them when the window is done).  The
    parameters are the block's own and are updated in place: there is
    nothing to sync back."""

    def __init__(self, block, loss_fn, optimizer, mesh=None, batch_axis=0,
                 grad_accum=1, donate=True, bf16_compute=False, mirror=None,
                 input_prep=None, autotune=None, loss_scaler=None,
                 device=None):
        for what, asked in (("mesh", mesh is not None),
                            ("grad_accum > 1", grad_accum != 1),
                            ("bf16_compute", bool(bf16_compute)),
                            ("mirror", bool(mirror)),
                            ("input_prep", input_prep is not None),
                            ("autotune", bool(autotune)),
                            ("loss_scaler", loss_scaler is not None)):
            if asked:
                raise MXNetError(f"TrainStep({what}) is not ported yet")
        if batch_axis != 0:
            raise MXNetError("TrainStep takes the batch on axis 0")
        self.device = resolve_device(device)
        where = {p.device for p in block.parameters()}
        if where and where != {self.device}:
            raise MXNetError(f"TrainStep on {self.device}, but the block's "
                             f"parameters are on "
                             f"{sorted(map(str, where))}")
        self._block = block
        self._loss_fn = loss_fn
        self._optimizer = optimizer
        self._params = [p for p in block.parameters() if p.requires_grad]
        self._states = [optimizer.create_state(p) for p in self._params]

    def _to_device(self, x):
        t = torch.from_numpy(np.ascontiguousarray(x)) \
            if isinstance(x, np.ndarray) else torch.as_tensor(x)
        return t.to(self.device)

    def _step(self, x, y):
        block = self._block.train()
        with torch.enable_grad():
            loss = self._loss_fn(block(x), y).mean()
            grads = torch.autograd.grad(loss, self._params)
        opt = self._optimizer
        for p, g, s in zip(self._params, grads, self._states):
            opt.update(p, g, s)
        return loss.detach()

    def __call__(self, x, y):
        """One step on the batch ``(x, y)``; returns its loss (fp32, a
        0-d tensor on the device)."""
        return self.run_steps(x, y, num_steps=1)[0]

    def run_steps(self, x, y, num_steps=None, stacked=False):
        """``num_steps`` steps on the one batch ``(x, y)`` (the
        benchmark's resident batch); returns the ``(num_steps,)`` fp32
        losses on the device."""
        if stacked:
            raise MXNetError("run_steps(stacked=True) is not ported yet")
        if num_steps is None or num_steps < 1:
            raise MXNetError(f"run_steps needs num_steps >= 1, got "
                             f"{num_steps}")
        x, y = self._to_device(x), self._to_device(y)
        return torch.stack([self._step(x, y) for _ in range(num_steps)])
