"""Bucketed sequence iterator of the port (counterpart of
``incubator_mxnet_tpu/rnn/io.py``; reference python/mxnet/rnn/io.py:
``encode_sentences``, ``BucketSentenceIter``): variable-length sentences
grouped into fixed-length buckets, so a ``BucketingModule`` binds one
executor per bucket.  Batches are host NDArrays, as every iterator of
the port emits them."""
from __future__ import annotations

import random as pyrandom

import numpy as np

from ..context import cpu
from ..io import DataIter, DataBatch, DataDesc
from ..ndarray import array as nd_array

__all__ = ["BucketSentenceIter", "encode_sentences"]


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0, unknown_token=None):
    """Encode token lists into integer ids, building/extending the vocab
    (reference python/mxnet/rnn/io.py:encode_sentences)."""
    idx = start_label
    if vocab is None:
        vocab = {invalid_key: invalid_label}
        new_vocab = True
    else:
        new_vocab = False
    res = []
    for sent in sentences:
        coded = []
        for word in sent:
            if word not in vocab:
                assert new_vocab or unknown_token is not None, \
                    "Unknown token %s" % word
                if unknown_token:
                    word = unknown_token
                else:
                    if idx == invalid_label:
                        idx += 1
                    vocab[word] = idx
                    idx += 1
            coded.append(vocab[word])
        res.append(coded)
    return res, vocab


class BucketSentenceIter(DataIter):
    """Iterator over integer-encoded sentences with bucketing.

    sentences: list of lists of int ids. Each sentence lands in the
    smallest bucket >= its length, padded with `invalid_label`. Labels are
    the input shifted left by one (language-modeling convention).  The
    batches' order is shuffled by ``random.Random(0)`` at every
    ``reset``, as in the JAX package.
    """

    def __init__(self, sentences, batch_size, buckets=None,
                 invalid_label=-1, data_name="data", label_name="softmax_label",
                 dtype="float32", layout="NT"):
        super().__init__(batch_size)
        if not buckets:
            lens = np.bincount([len(s) for s in sentences])
            buckets = [i for i, n in enumerate(lens)
                       if n >= batch_size]
            if not buckets:
                buckets = [max(len(s) for s in sentences)]
        buckets = sorted(set(buckets))
        ndiscard = 0
        self.data = [[] for _ in buckets]
        for sent in sentences:
            buck = next((i for i, b in enumerate(buckets)
                         if b >= len(sent)), None)
            if buck is None:
                ndiscard += 1
                continue
            buf = np.full((buckets[buck],), invalid_label, dtype)
            buf[:len(sent)] = sent
            self.data[buck].append(buf)
        self.data = [np.asarray(x, dtype) for x in self.data]
        self.buckets = buckets
        self.batch_size = batch_size
        self.invalid_label = invalid_label
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.layout = layout
        self.ndiscard = ndiscard
        self.major_axis = layout.find("N")
        self.default_bucket_key = max(buckets)

        shape = (batch_size, self.default_bucket_key) \
            if self.major_axis == 0 else (self.default_bucket_key, batch_size)
        self.provide_data = [DataDesc(data_name, shape)]
        self.provide_label = [DataDesc(label_name, shape)]

        self.idx = []
        for i, buck in enumerate(self.data):
            self.idx.extend((i, j) for j in
                            range(0, len(buck) - batch_size + 1, batch_size))
        self.curr_idx = 0
        self.reset()

    def reset(self):
        self.curr_idx = 0
        pyrandom.Random(0).shuffle(self.idx)
        self.nddata = []
        self.ndlabel = []
        for buck in self.data:
            if len(buck) == 0:
                self.nddata.append(None)
                self.ndlabel.append(None)
                continue
            label = np.full(buck.shape, self.invalid_label, self.dtype)
            label[:, :-1] = buck[:, 1:]
            self.nddata.append(buck)
            self.ndlabel.append(label)

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        data = self.nddata[i][j:j + self.batch_size]
        label = self.ndlabel[i][j:j + self.batch_size]
        if self.major_axis == 1:
            data, label = data.T, label.T
        return DataBatch([nd_array(data, ctx=cpu())],
                         [nd_array(label, ctx=cpu())],
                         pad=0, bucket_key=self.buckets[i],
                         provide_data=[DataDesc(self.data_name, data.shape)],
                         provide_label=[DataDesc(self.label_name,
                                                 label.shape)])
