"""Interval sampling of the port (counterpart of ``incubator_mxnet_tpu/
gluon/contrib/data/sampler.py``; reference gluon/contrib/data/sampler.py:
IntervalSampler): stride through [0, length) with optional rollover, the
truncated-BPTT batching pattern."""
from __future__ import annotations

from ...data.sampler import Sampler

__all__ = ["IntervalSampler"]


class IntervalSampler(Sampler):
    """Yield 0, k, 2k, ... then (with rollover) 1, k+1, ... until all of
    [0, length) is covered."""

    def __init__(self, length, interval, rollover=True):
        if interval >= length:
            raise ValueError(
                f"interval {interval} must be smaller than length {length}")
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        starts = range(self._interval) if self._rollover else range(1)
        for i in starts:
            yield from range(i, self._length, self._interval)

    def __len__(self):
        return self._length if self._rollover \
            else len(range(0, self._length, self._interval))
