"""Contrib of the port: ``contrib.text.Vocabulary`` so far (the
vocabulary of ``gluon.contrib.data.text``)."""
from . import text

__all__ = ["text"]
