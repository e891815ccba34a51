"""Vision datasets and transforms of the port."""
from .datasets import *  # noqa: F401,F403
from . import transforms  # noqa: F401
from . import datasets  # noqa: F401
