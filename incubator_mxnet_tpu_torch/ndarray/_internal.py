"""Internal op namespace ``mx.nd._internal`` (the reference generates the
``_``-prefixed ops here); the same registry as ``op.py``."""
import sys as _sys

from .op import __getattr__  # noqa: F401 — lazy lookup of any op
from .op import _populate

_populate(_sys.modules[__name__])
