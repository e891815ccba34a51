"""Dynamic loss scaling of the port's training step (counterpart of
``incubator_mxnet_tpu/numerics.py`` ``LossScaler`` and
``program_overflow``).  The JAX module's in-program health sentinels,
drain and reports are not ported yet (ROADMAP A9)."""
from __future__ import annotations

import os

import torch

from .base import MXNetError, get_env

__all__ = ["LossScaler", "program_overflow"]


class LossScaler:
    """Dynamic loss-scaling policy for the bf16 training path.

    The *state* (current scale, clean-step streak) lives on the device
    inside the ``TrainStep`` as a float32[2] tensor; this object holds
    only the policy constants:

    * ``init_scale``      — starting scale (``MXNET_LOSS_SCALE``, 2^15)
    * ``growth_factor``   — multiplier after ``growth_interval`` clean
      steps (``MXNET_LOSS_SCALE_GROWTH``, 2.0)
    * ``backoff_factor``  — multiplier on overflow
      (``MXNET_LOSS_SCALE_BACKOFF``, 0.5)
    * ``growth_interval`` — clean steps between growths
      (``MXNET_LOSS_SCALE_WINDOW``, 200)

    An overflowed step applies *no* update: parameters, optimizer states
    and BatchNorm statistics keep their previous values, the scale backs
    off (to at least 1)."""

    def __init__(self, init_scale=None, growth_factor=None,
                 backoff_factor=None, growth_interval=None):
        self.init_scale = float(
            get_env("MXNET_LOSS_SCALE", 2.0 ** 15, float)
            if init_scale is None else init_scale)
        self.growth_factor = float(
            get_env("MXNET_LOSS_SCALE_GROWTH", 2.0, float)
            if growth_factor is None else growth_factor)
        self.backoff_factor = float(
            get_env("MXNET_LOSS_SCALE_BACKOFF", 0.5, float)
            if backoff_factor is None else backoff_factor)
        self.growth_interval = int(
            get_env("MXNET_LOSS_SCALE_WINDOW", 200, int)
            if growth_interval is None else growth_interval)
        if self.init_scale <= 0:
            raise MXNetError(
                f"LossScaler init_scale must be > 0, got {self.init_scale}")
        if not 0.0 < self.backoff_factor < 1.0:
            raise MXNetError(
                "LossScaler backoff_factor must be in (0, 1), got "
                f"{self.backoff_factor}")
        if self.growth_factor <= 1.0:
            raise MXNetError(
                "LossScaler growth_factor must be > 1, got "
                f"{self.growth_factor}")
        if self.growth_interval < 1:
            raise MXNetError(
                "LossScaler growth_interval must be >= 1, got "
                f"{self.growth_interval}")

    @classmethod
    def from_env(cls):
        """A scaler configured from ``MXNET_LOSS_SCALE*``, or None when
        ``MXNET_LOSS_SCALE`` is unset, empty or 0 (loss scaling is
        opt-in)."""
        raw = os.environ.get("MXNET_LOSS_SCALE", "").strip()
        if not raw:
            return None
        try:
            if float(raw) <= 0:
                return None
        except ValueError:
            raise MXNetError(
                f"MXNET_LOSS_SCALE={raw!r}: expected a positive number")
        return cls()

    def describe(self):
        return (f"LossScaler(init={self.init_scale!r},"
                f"growth={self.growth_factor!r},"
                f"backoff={self.backoff_factor!r},"
                f"interval={self.growth_interval})")

    def state_init(self, device):
        """Fresh state on ``device``: float32 ``[scale, clean-step
        streak]``."""
        return torch.tensor([self.init_scale, 0.0], dtype=torch.float32,
                            device=device)

    def next_state(self, state, overflow):
        """The state after a step, on the device (no host sync): on
        ``overflow`` the scale backs off to ``max(scale * backoff, 1)``
        and the streak restarts; a clean step that completes
        ``growth_interval`` clean steps multiplies the scale by
        ``growth_factor`` and restarts the streak."""
        scale, good = state[0], state[1]
        grew = (good + 1.0) >= self.growth_interval
        new_scale = torch.where(
            overflow, torch.clamp(scale * self.backoff_factor, min=1.0),
            torch.where(grew, scale * self.growth_factor, scale))
        new_good = torch.where(overflow | grew, torch.zeros_like(good),
                               good + 1.0)
        return torch.stack([new_scale, new_good])

    def __repr__(self):
        return self.describe()


def program_overflow(grads):
    """The loss scaler's overflow sentinel, a 0-d bool tensor on the
    device: True when any gradient holds a non-finite value, read from
    the sum of the fp32 sums of squares (a non-finite element, or one
    whose square overflows fp32, makes it non-finite)."""
    if not grads:
        return torch.zeros((), dtype=torch.bool)
    sq = torch.stack([g.float().square().sum() for g in grads])
    return ~torch.isfinite(sq.sum())
