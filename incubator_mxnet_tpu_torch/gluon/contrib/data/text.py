"""Language-model datasets of the port (counterpart of
``incubator_mxnet_tpu/gluon/contrib/data/text.py``; reference
gluon/contrib/data/text.py: WikiText2 / WikiText103).

Nothing is downloaded: the datasets read the extracted token files from
``root`` (``wiki.<segment>.tokens``).  Tokenisation, the vocabulary
(``contrib.text.Vocabulary``), the EOS handling and the (N, seq_len)
batching are the JAX package's; samples are host int32 NDArrays.
"""
from __future__ import annotations

import io
import os

import numpy as np

from ....base import MXNetError
from ....context import cpu
from ....ndarray import array as nd_array
from ...data.dataset import Dataset

__all__ = ["WikiText2", "WikiText103"]

EOS_TOKEN = "<eos>"


class _WikiText(Dataset):
    _name = None

    def __init__(self, root, segment="train", vocab=None, seq_len=35):
        self._root = os.path.expanduser(root)
        self._segment = segment
        self._seq_len = seq_len
        self.vocabulary = vocab
        self._load()

    def _token_path(self):
        return os.path.join(self._root, f"wiki.{self._segment}.tokens")

    def _load(self):
        path = self._token_path()
        if not os.path.exists(path):
            raise MXNetError(
                f"{type(self).__name__}: token file {path} not found. "
                "This environment has no network egress; place the "
                f"extracted {self._name} archive (wiki.<segment>.tokens) "
                "under root=")
        with io.open(path, "r", encoding="utf8") as fin:
            content = fin.read()
        tokens = []
        for line in content.splitlines():
            words = line.strip().split()
            if words:
                tokens.extend(words)
                tokens.append(EOS_TOKEN)
        if self.vocabulary is None:
            from ....contrib.text.vocab import Vocabulary
            import collections
            self.vocabulary = Vocabulary(
                collections.Counter(tokens), reserved_tokens=[EOS_TOKEN])
        idx = self.vocabulary.to_indices(tokens)
        data, label = np.asarray(idx[:-1], np.int32), \
            np.asarray(idx[1:], np.int32)
        n = len(data) // self._seq_len
        self._data = nd_array(
            data[:n * self._seq_len].reshape(-1, self._seq_len), ctx=cpu())
        self._label = nd_array(
            label[:n * self._seq_len].reshape(-1, self._seq_len), ctx=cpu())

    def __getitem__(self, idx):
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._data)


class WikiText2(_WikiText):
    """WikiText-2 LM dataset (~2M tokens; reference text.py:WikiText2)."""
    _name = "wikitext-2"

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "wikitext-2"),
                 segment="train", vocab=None, seq_len=35):
        super().__init__(root, segment, vocab, seq_len)


class WikiText103(_WikiText):
    """WikiText-103 LM dataset (~103M tokens; reference
    text.py:WikiText103)."""
    _name = "wikitext-103"

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "wikitext-103"),
                 segment="train", vocab=None, seq_len=35):
        super().__init__(root, segment, vocab, seq_len)
