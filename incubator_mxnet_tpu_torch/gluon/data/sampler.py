"""Samplers of the port (counterpart of ``incubator_mxnet_tpu/gluon/data/
sampler.py``; reference python/mxnet/gluon/data/sampler.py).
``RandomSampler`` draws its permutation from ``np.random``, as the JAX
package does, so a numpy seed gives the same order in both."""
from __future__ import annotations

import numpy as np

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler"]


class Sampler:
    """Abstract sampler: iterates sample indices."""

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    """[0, length) in order."""

    def __init__(self, length):
        self._length = length

    def __iter__(self):
        return iter(range(self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    """[0, length) shuffled each epoch."""

    def __init__(self, length):
        self._length = length

    def __iter__(self):
        return iter(np.random.permutation(self._length))

    def __len__(self):
        return self._length


class BatchSampler(Sampler):
    """Group a sampler's output into batches, with last-batch handling
    'keep'/'discard'/'rollover' (reference sampler.py:BatchSampler)."""

    def __init__(self, sampler, batch_size, last_batch="keep"):
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []
        if last_batch not in ("keep", "discard", "rollover"):
            raise ValueError(
                f"last_batch must be one of keep/discard/rollover, got"
                f" {last_batch}")

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "rollover":
                self._prev = batch

    def __len__(self):
        if self._last_batch == "keep":
            return (len(self._sampler) + self._batch_size - 1) \
                // self._batch_size
        if self._last_batch == "discard":
            return len(self._sampler) // self._batch_size
        return (len(self._sampler) + len(self._prev)) // self._batch_size
