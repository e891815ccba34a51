"""Model zoo of the port (``gluon.model_zoo`` counterpart)."""
from . import vision

__all__ = ["vision"]
