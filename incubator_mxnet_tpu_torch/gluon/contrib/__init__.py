"""Gluon contrib of the port: the data helpers (``IntervalSampler``,
``text.WikiText2`` / ``WikiText103``).  The contrib layers and cells of
the JAX package are not ported (ROADMAP A8)."""
from . import data

__all__ = ["data"]
