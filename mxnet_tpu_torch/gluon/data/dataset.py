"""Datasets (counterpart of `mxnet_tpu/gluon/data/dataset.py`).

Datasets yield host items (numpy arrays, CPU tensors, bytes); the
`DataLoader` moves whole batches to the card, one copy a batch.
"""
from __future__ import annotations

import os

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    def __getitem__(self, idx):  # pragma: no cover - abstract
        raise NotImplementedError

    def __len__(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def filter(self, fn):
        return SimpleDataset([i for i in self if fn(i)])

    def shard(self, num_shards, index):
        assert 0 <= index < num_shards
        length = len(self)
        shard_len = length // num_shards
        rest = length % num_shards
        start = shard_len * index + min(index, rest)
        end = start + shard_len + (index < rest)
        return SimpleDataset([self[i] for i in range(start, end)])

    def take(self, count):
        return SimpleDataset([self[i] for i in range(min(count, len(self)))])

    def sample(self, sampler):
        return _SampledDataset(self, sampler)

    def transform(self, fn, lazy=True):
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        def base_fn(x, *args):
            if args:
                return (fn(x),) + args
            return fn(x)

        return self.transform(base_fn, lazy)


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class _SampledDataset(Dataset):
    def __init__(self, dataset, sampler):
        self._dataset = dataset
        self._indices = list(sampler)

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, idx):
        return self._dataset[self._indices[idx]]


class ArrayDataset(Dataset):
    """Zip of arrays/datasets (reference dataset.py ArrayDataset)."""

    def __init__(self, *args):
        assert len(args) > 0
        self._length = len(args[0])
        self._data = []
        for i, data in enumerate(args):
            assert len(data) == self._length, \
                f"All arrays must have the same length; {len(data)} != {self._length}"
            if isinstance(data, (list, tuple)) or hasattr(data, "__getitem__"):
                self._data.append(data)
            else:
                raise TypeError(f"unsupported data type {type(data)}")

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)


class RecordFileDataset(Dataset):
    """The records of a RecordIO file, by position: the ``.rec`` / ``.idx``
    pair that im2rec writes (`recordio.MXIndexedRecordIO`)."""

    def __init__(self, filename):
        from ...recordio import MXIndexedRecordIO
        idx_file = os.path.splitext(filename)[0] + ".idx"
        self._record = MXIndexedRecordIO(idx_file, filename, "r")

    def __len__(self):
        return len(self._record.keys)

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])
