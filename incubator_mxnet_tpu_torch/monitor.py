"""Monitor — per-layer output statistics during training (counterpart of
``incubator_mxnet_tpu/monitor.py``; reference python/mxnet/monitor.py:33
over executor monitor callbacks).

Gluon blocks are monitored with forward hooks; a symbolic ``Executor``
through its output monitor callback (``install_exec``, which the port's
``Module.install_monitor`` calls; the JAX one calls ``install``, which
cannot walk an Executor).  Stats are computed on the host from synced
values, as in the reference; the JAX monitor can also take the default
stat from its numerics sentinels, which wait for ROADMAP A9."""
from __future__ import annotations

import re

import numpy as np

from .base import MXNetError

__all__ = ["Monitor"]


def _default_stat(x):
    return float(np.abs(x.asnumpy()).mean())


class Monitor:
    """Collect statistics of layer outputs (and parameters).

    Parameters mirror the reference: interval (batches between
    collections), stat_func (NDArray -> scalar/ndarray, default
    mean(|x|)), pattern (regex over names), sort (sort output by name).
    """

    def __init__(self, interval=1, stat_func=None, pattern=".*", sort=False):
        self.interval = interval
        self.stat_func = stat_func or _default_stat
        self.re_pattern = re.compile(pattern)
        self.sort = sort
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self._handles = []
        self._monitored_block = None

    # --------------------------------------------------------------- gluon
    def install(self, block, monitor_params=True):
        """Hook every sub-block's forward output (gluon path)."""
        mon = self

        def make_hook(name):
            def hook(blk, inputs, output):
                if not mon.activated:
                    return
                outs = output if isinstance(output, (list, tuple)) \
                    else [output]
                for i, o in enumerate(outs):
                    nm = f"{name}_output{i}" if len(outs) > 1 \
                        else f"{name}_output"
                    if mon.re_pattern.match(nm):
                        mon.queue.append((mon.step, nm, mon._stat(nm, o)))
            return hook

        def walk(blk, prefix):
            self._handles.append(
                blk.register_forward_hook(make_hook(blk.name or prefix)))
            for name, child in blk._children.items():
                walk(child, f"{prefix}.{name}" if prefix else name)

        walk(block, block.name or "block")
        self._monitored_block = block if monitor_params else None
        return self

    def uninstall(self):
        for h in self._handles:
            h.detach()
        self._handles = []

    # ------------------------------------------------------------ symbolic
    def install_exec(self, executor):
        """Attach to an Executor's output monitor callback."""
        mon = self

        def callback(name, arr):
            if mon.activated and mon.re_pattern.match(name):
                mon.queue.append((mon.step, name, mon._stat(name, arr)))

        executor.set_monitor_callback(callback)
        self.exes.append(executor)
        return self

    # ------------------------------------------------------------- control
    def _stat(self, name, value):
        """Apply stat_func, converting the AttributeError a non-NDArray
        input produces into the documented MXNetError."""
        try:
            return self.stat_func(value)
        except (AttributeError, TypeError) as e:
            raise MXNetError(
                f"Monitor stat_func failed on {name!r} "
                f"({type(value).__name__}): {e}") from e

    def tic(self):
        """Start collecting for this batch if the interval elapsed
        (reference monitor.py:tic)."""
        if self.step % self.interval == 0:
            self.activated = True
            self.queue = []
        return self.activated

    def toc(self):
        """Stop collecting; returns [(step, name, stat)]
        (reference monitor.py:toc)."""
        if not self.activated:
            self.step += 1
            return []
        self.activated = False
        blk = self._monitored_block
        if blk is not None:
            for name, p in blk.collect_params().items():
                if not self.re_pattern.match(name):
                    continue
                try:
                    value = p.data()
                except (RuntimeError, MXNetError):
                    continue
                self.queue.append((self.step, name,
                                   self._stat(name, value)))
        res = sorted(self.queue, key=lambda t: t[1]) if self.sort \
            else list(self.queue)
        self.queue = []
        self.step += 1
        return res

    def toc_print(self):
        for step, name, stat in self.toc():
            print(f"Batch {step:>6} {name:<40} {stat}")
