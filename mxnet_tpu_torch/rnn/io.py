"""Bucketed sequence IO of the port (counterpart of
``mxnet_tpu/rnn/io.py``; reference: python/mxnet/rnn/io.py
BucketSentenceIter :61, encode_sentences :21).

The JAX package's iterator, unchanged in behaviour: sentences are placed
in the smallest bucket that holds them (one ``searchsorted`` pass; longer
ones are dropped with a warning), each bucket is one matrix padded with
``invalid_label``, the labels are its next-token shift, and every reset
shuffles the order of the batches and the rows within each bucket with
the global numpy RNG, so two runs see the same batches when numpy is
seeded alike. Batches are host (CPU) NDArrays with ``bucket_key`` set.
"""
from __future__ import annotations

import logging

import numpy as np

from .. import ndarray
from ..context import cpu
from ..io import DataBatch, DataDesc, DataIter

__all__ = ["BucketSentenceIter", "encode_sentences"]


def encode_sentences(sentences, vocab=None, invalid_label=-1, invalid_key="\n",
                     start_label=0):
    """Map token sequences to integer-id sequences.

    When ``vocab`` is None a fresh vocabulary is grown in first-seen order
    starting at ``start_label`` (skipping ``invalid_label``); when a vocab is
    given, unknown tokens are an error. Returns (encoded, vocab)."""
    grow = vocab is None
    if grow:
        vocab = {invalid_key: invalid_label}
    next_id = start_label
    encoded = []
    for sent in sentences:
        ids = []
        for token in sent:
            if token not in vocab:
                if not grow:
                    raise ValueError("unknown token %r with a fixed vocab" % (token,))
                if next_id == invalid_label:
                    next_id += 1
                vocab[token] = next_id
                next_id += 1
            ids.append(vocab[token])
        encoded.append(ids)
    return encoded, vocab


class BucketSentenceIter(DataIter):
    """Variable-length sequences batched by bucket.

    Each sentence lands in the smallest bucket that fits it (longer ones are
    dropped with a warning); every batch comes from a single bucket, padded to
    the bucket length with ``invalid_label``. Labels are the next-token shift
    of the data. ``layout`` "NTC" (batch-major) or "TNC" (time-major).
    Reference behavior contract: rnn/io.py:61-124."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label", dtype="float32",
                 layout="NTC"):
        super().__init__(batch_size)
        lengths = np.fromiter(
            (len(s) for s in sentences), dtype=np.int64, count=len(sentences)
        )
        if buckets:
            buckets = sorted(int(b) for b in buckets)
        else:
            # auto-buckets: every sentence length with enough members to fill
            # at least one batch
            counts = np.bincount(lengths)
            buckets = [int(b) for b in np.nonzero(counts >= batch_size)[0]]
        if not buckets:
            raise ValueError("no usable buckets for batch_size=%d" % batch_size)

        placement = np.searchsorted(buckets, lengths)  # smallest bucket >= len
        dropped = int((placement >= len(buckets)).sum())
        if dropped:
            logging.warning(
                "BucketSentenceIter: dropped %d sentences longer than the "
                "largest bucket (%d)", dropped, buckets[-1],
            )

        # one padded matrix per bucket, then the label matrix as a left-shift
        per_bucket = [[] for _ in buckets]
        for sent, where in zip(sentences, placement):
            if where < len(buckets):
                per_bucket[where].append(sent)
        self.data = []
        self._labels = []
        for width, group in zip(buckets, per_bucket):
            mat = np.full((len(group), width), invalid_label, dtype=dtype)
            for row, sent in enumerate(group):
                mat[row, : len(sent)] = sent
            lab = np.full_like(mat, invalid_label)
            lab[:, :-1] = mat[:, 1:]
            self.data.append(mat)
            self._labels.append(lab)

        self.batch_size = batch_size
        self.buckets = buckets
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.layout = layout
        self.major_axis = layout.find("N")
        if self.major_axis not in (0, 1):
            raise ValueError(
                "layout %r: need batch-major ('NT...') or time-major ('TN...')"
                % layout
            )
        self.default_bucket_key = max(buckets)
        shape = (
            (batch_size, self.default_bucket_key)
            if self.major_axis == 0
            else (self.default_bucket_key, batch_size)
        )
        self.provide_data = [DataDesc(data_name, shape, layout=layout)]
        self.provide_label = [DataDesc(label_name, shape, layout=layout)]

        # (bucket, row-offset) pairs for every full batch; shuffled per epoch
        self._row_perm = [np.arange(len(m)) for m in self.data]
        self.idx = [
            (b, start)
            for b, mat in enumerate(self.data)
            for start in range(0, len(mat) - batch_size + 1, batch_size)
        ]
        self.curr_idx = 0
        self.reset()

    def reset(self):
        self.curr_idx = 0
        rng = np.random
        rng.shuffle(self.idx)
        for perm in self._row_perm:
            rng.shuffle(perm)

    def next(self):
        if self.curr_idx >= len(self.idx):
            raise StopIteration
        bucket, start = self.idx[self.curr_idx]
        self.curr_idx += 1
        rows = self._row_perm[bucket][start : start + self.batch_size]
        data = self.data[bucket][rows]
        label = self._labels[bucket][rows]
        if self.major_axis == 1:  # time-major
            data, label = data.T, label.T
        data = ndarray.array(data, ctx=cpu(), dtype=self.dtype)
        label = ndarray.array(label, ctx=cpu(), dtype=self.dtype)
        return DataBatch(
            [data], [label], pad=0, bucket_key=self.buckets[bucket],
            provide_data=[DataDesc(self.data_name, data.shape, layout=self.layout)],
            provide_label=[DataDesc(self.label_name, label.shape, layout=self.layout)],
        )
