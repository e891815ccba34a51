"""Text utilities of the port: ``Vocabulary``.  The token embeddings of
the JAX package's ``contrib/text/embedding.py`` are not ported (ROADMAP
A10)."""
from .vocab import Vocabulary

__all__ = ["Vocabulary"]
