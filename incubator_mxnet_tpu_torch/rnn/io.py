"""Bucketing sentence iterator (ref: python/mxnet/rnn/io.py).

Counterpart of ``incubator_mxnet_tpu/rnn/io.py``. Sentences are padded
into length buckets and each batch carries its ``bucket_key``, so a
trainer can keep one compiled step (a CUDA graph on the card) a bucket
with shared parameters. ``reset()`` draws the batch order from Python's
``random`` and each bucket's row order from numpy's global generator, in
the reference's order, so a seeded run yields the reference's batches.
Arrays are made on the current context.
"""
from __future__ import annotations

import bisect
import random

import numpy as np

from .. import ndarray
from ..io import DataIter, DataBatch, DataDesc


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0, unknown_token=None):
    """Token-string sentences -> integer ids, building a vocab on the fly
    (ref: rnn/io.py:31 encode_sentences)."""
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
                assert new_vocab or unknown_token, f"Unknown token {word}"
                if idx == invalid_label:
                    idx += 1
                if unknown_token:
                    word = unknown_token
                vocab[word] = idx
                idx += 1
            coded.append(vocab[word])
        res.append(coded)
    return res, vocab


class BucketSentenceIter(DataIter):
    """(ref: rnn/io.py:84 BucketSentenceIter). Label at each step is the
    next token; sentences longer than the largest bucket are discarded."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label",
                 dtype="float32", layout="NT"):
        super().__init__()
        if not buckets:
            buckets = [i for i, j in
                       enumerate(np.bincount([len(s) for s in sentences]))
                       if j >= batch_size]
        buckets = sorted(buckets)

        ndiscard = 0
        self.data = [[] for _ in buckets]
        for sent in sentences:
            buck = bisect.bisect_left(buckets, len(sent))
            if buck == len(buckets):
                ndiscard += 1
                continue
            buff = np.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[:len(sent)] = sent
            self.data[buck].append(buff)
        keep = [i for i, d in enumerate(self.data) if d]
        buckets = [buckets[i] for i in keep]
        self.data = [np.asarray(self.data[i], dtype=dtype) for i in keep]
        if ndiscard:
            print("WARNING: discarded %d sentences longer than the largest "
                  "bucket." % ndiscard)

        self.batch_size = batch_size
        self.buckets = buckets
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.nddata = []
        self.ndlabel = []
        self.major_axis = layout.find("N")
        self.layout = layout
        self.default_bucket_key = max(buckets)

        shape = ((batch_size, self.default_bucket_key)
                 if self.major_axis == 0
                 else (self.default_bucket_key, batch_size))
        if self.major_axis not in (0, 1):
            raise ValueError(
                f"Invalid layout {layout}: must be NT (batch major) or TN "
                "(time major)")
        self.provide_data = [DataDesc(name=data_name, shape=shape)]
        self.provide_label = [DataDesc(name=label_name, shape=shape)]

        self.idx = []
        for i, buck in enumerate(self.data):
            self.idx.extend(
                [(i, j) for j in
                 range(0, len(buck) - batch_size + 1, batch_size)])
        self.curr_idx = 0
        self.reset()

    def reset(self):
        self.curr_idx = 0
        random.shuffle(self.idx)
        for buck in self.data:
            np.random.shuffle(buck)
        self.nddata = []
        self.ndlabel = []
        for buck in self.data:
            label = np.empty_like(buck)
            label[:, :-1] = buck[:, 1:]
            label[:, -1] = self.invalid_label
            self.nddata.append(ndarray.array(buck.astype(self.dtype)))
            self.ndlabel.append(ndarray.array(label.astype(self.dtype)))

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        if self.major_axis == 1:
            data = self.nddata[i][j:j + self.batch_size].T
            label = self.ndlabel[i][j:j + self.batch_size].T
        else:
            data = self.nddata[i][j:j + self.batch_size]
            label = self.ndlabel[i][j:j + self.batch_size]
        return DataBatch(
            [data], [label], pad=0, bucket_key=self.buckets[i],
            provide_data=[DataDesc(name=self.data_name, shape=data.shape)],
            provide_label=[DataDesc(name=self.label_name,
                                    shape=label.shape)])
