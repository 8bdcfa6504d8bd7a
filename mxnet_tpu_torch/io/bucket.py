"""Bucketed sequence iterator (counterpart of `mxnet_tpu/io/bucket.py`).

Sentences are grouped into a few length buckets, padded to the bucket
length, and each batch carries its ``bucket_key``: a few shapes, so a
few captured steps (`gluon.FusedTrainStep` captures one CUDA graph a
signature).  Batches are int tensors on the CPU; the bucket order and
the rows within a bucket are shuffled with numpy's global generator, as
the reference's are.
"""
from __future__ import annotations

import numpy as onp
import torch

from .io import DataBatch, DataDesc, DataIter

__all__ = ["BucketSentenceIter"]


class BucketSentenceIter(DataIter):
    """Iterate tokenized sentences in padded length buckets.

    sentences: list of int-lists (token ids).  Each batch yields
    data (N, bucket_len) and label (N, bucket_len) = data shifted left by
    one (next-token prediction), padded with `invalid_label`.
    """

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label", dtype="int32",
                 layout="NT"):
        super().__init__(batch_size)
        if buckets is None:
            lens = onp.bincount([len(s) for s in sentences])
            # auto buckets: lengths that occur often enough to fill a batch
            buckets = [i for i, n in enumerate(lens) if n >= batch_size]
            if not buckets:
                buckets = [max(len(s) for s in sentences)]
        buckets = sorted(buckets)
        self.buckets = buckets
        self.data_name = data_name
        self.label_name = label_name
        self.invalid_label = invalid_label
        self.dtype = dtype
        self.layout = layout

        self.data = [[] for _ in buckets]
        ndiscard = 0
        for s in sentences:
            buck = onp.searchsorted(buckets, len(s))
            if buck == len(buckets):  # longer than the largest bucket
                ndiscard += 1
                continue
            arr = onp.full((buckets[buck],), invalid_label, dtype=dtype)
            arr[:len(s)] = s
            self.data[buck].append(arr)
        self.data = [onp.asarray(x, dtype=dtype) for x in self.data]
        self.ndiscard = ndiscard
        self.default_bucket_key = max(buckets)
        self.reset()

    def _desc_shape(self):
        if self.layout == "TN":
            return (self.default_bucket_key, self.batch_size)
        return (self.batch_size, self.default_bucket_key)

    @property
    def provide_data(self):
        return [DataDesc(self.data_name, self._desc_shape(), self.dtype,
                         layout=self.layout)]

    @property
    def provide_label(self):
        return [DataDesc(self.label_name, self._desc_shape(), self.dtype,
                         layout=self.layout)]

    def reset(self):
        self.curr_idx = 0
        self.idx = []
        for i, buck in enumerate(self.data):
            perm = onp.random.permutation(len(buck))
            # full batches only, like the reference bucket iterator
            for j in range(0, len(buck) - self.batch_size + 1,
                           self.batch_size):
                self.idx.append((i, perm[j:j + self.batch_size]))
        onp.random.shuffle(self.idx)

    def iter_next(self):
        return self.curr_idx < len(self.idx)

    def next(self):
        if not self.iter_next():
            raise StopIteration
        i, rows = self.idx[self.curr_idx]
        self.curr_idx += 1
        data = self.data[i][rows]
        # next-token labels: shift left, pad tail with invalid_label
        label = onp.full_like(data, self.invalid_label)
        label[:, :-1] = data[:, 1:]
        if self.layout == "TN":
            data, label = data.T, label.T
        bucket_len = self.buckets[i]
        return DataBatch(
            [torch.from_numpy(onp.ascontiguousarray(data))],
            [torch.from_numpy(onp.ascontiguousarray(label))], pad=0,
            bucket_key=bucket_len,
            provide_data=[DataDesc(self.data_name, data.shape, self.dtype,
                                   layout=self.layout)],
            provide_label=[DataDesc(self.label_name, label.shape, self.dtype,
                                    layout=self.layout)])
