"""Vocabulary of the port (its own copy of ``incubator_mxnet_tpu/contrib/
text/vocab.py``; reference python/mxnet/contrib/text/vocab.py)."""
from __future__ import annotations

import collections

from ...base import MXNetError

__all__ = ["Vocabulary"]


class Vocabulary:
    """Indexes tokens by frequency (reference vocab.py:Vocabulary).

    counter: collections.Counter of tokens; most_freq_count caps vocab
    size (excluding unknown/reserved); min_freq filters rare tokens;
    index 0 is the unknown token; reserved_tokens follow it.
    """

    def __init__(self, counter=None, most_freq_count=None, min_freq=1,
                 unknown_token="<unk>", reserved_tokens=None):
        if min_freq < 1:
            raise MXNetError("min_freq must be >= 1")
        reserved_tokens = list(reserved_tokens or [])
        if unknown_token in reserved_tokens:
            raise MXNetError("unknown_token must not be in reserved_tokens")
        if len(set(reserved_tokens)) != len(reserved_tokens):
            raise MXNetError("reserved_tokens must be unique")
        self._unknown_token = unknown_token
        self._reserved_tokens = reserved_tokens or None
        self._idx_to_token = [unknown_token] + reserved_tokens
        self._token_to_idx = {t: i for i, t in enumerate(self._idx_to_token)}
        if counter is not None:
            self._index_counter(counter, most_freq_count, min_freq)

    def _index_counter(self, counter, most_freq_count, min_freq):
        if not isinstance(counter, collections.Counter):
            counter = collections.Counter(counter)
        # stable order: by frequency desc, then alphabetically (reference
        # sorts the same way for determinism)
        pairs = sorted(counter.items(), key=lambda kv: (-kv[1], kv[0]))
        kept = 0
        for token, freq in pairs:
            if freq < min_freq:
                break
            if most_freq_count is not None and kept >= most_freq_count:
                break
            if token in self._token_to_idx:
                continue
            self._token_to_idx[token] = len(self._idx_to_token)
            self._idx_to_token.append(token)
            kept += 1

    def __len__(self):
        return len(self._idx_to_token)

    @property
    def token_to_idx(self):
        return self._token_to_idx

    @property
    def idx_to_token(self):
        return self._idx_to_token

    @property
    def unknown_token(self):
        return self._unknown_token

    @property
    def reserved_tokens(self):
        return self._reserved_tokens

    def to_indices(self, tokens):
        """Token(s) -> index/indices; unknown maps to index 0."""
        single = isinstance(tokens, str)
        toks = [tokens] if single else tokens
        idx = [self._token_to_idx.get(t, 0) for t in toks]
        return idx[0] if single else idx

    def to_tokens(self, indices):
        single = isinstance(indices, int)
        idxs = [indices] if single else indices
        for i in idxs:
            if not 0 <= i < len(self):
                raise MXNetError(f"index {i} out of vocabulary range")
        toks = [self._idx_to_token[i] for i in idxs]
        return toks[0] if single else toks
