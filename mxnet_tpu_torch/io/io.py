"""Legacy data iterators (counterpart of `mxnet_tpu/io/io.py`):
`DataDesc`, `DataBatch` and the `DataIter` protocol, `NDArrayIter`
(pad / discard / roll_over last batches, shuffle), `CSVIter`,
`LibSVMIter`, `ResizeIter` and `PrefetchingIter`.

Iterators yield host batches: a `DataBatch`'s arrays are torch tensors
on the CPU (`LibSVMIter`'s data a sparse CSR tensor), and
`io.DevicePrefetcher` or `gluon.data.DataLoader` moves them to the
card.  ``NDArrayIter``'s shuffle draws from numpy's global generator,
as the reference's does.  CSV and LibSVM files are parsed by the port's
host library (`_native`).  `PrefetchingIter` runs one thread a
sub-iterator.
"""
from __future__ import annotations

import collections
import threading

import numpy as onp
import torch

from .._native import parse_csv, parse_libsvm

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "CSVIter",
           "LibSVMIter", "ResizeIter", "PrefetchingIter"]


class DataDesc(collections.namedtuple("DataDesc", ["name", "shape"])):
    """Data description incl. dtype/layout (reference `io.py` DataDesc)."""

    def __new__(cls, name, shape, dtype=onp.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self.name, self.shape, self.dtype,
                                          self.layout)

    @staticmethod
    def get_batch_axis(layout):
        """Index of the batch ('N') axis; 0 when layout is unspecified."""
        if layout is None:
            return 0
        return layout.find("N")

    @staticmethod
    def get_list(shapes, types):
        if types is not None:
            type_dict = dict(types)
            return [DataDesc(x[0], x[1], type_dict[x[0]]) for x in shapes]
        return [DataDesc(x[0], x[1]) for x in shapes]


class DataBatch:
    """One mini-batch (reference `io.py` DataBatch)."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None:
            assert isinstance(data, (list, tuple)), "data must be a list"
        if label is not None:
            assert isinstance(label, (list, tuple)), "label must be a list"
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        data_shapes = [d.shape for d in self.data]
        if self.label:
            label_shapes = [l.shape for l in self.label]
        else:
            label_shapes = None
        return "{}: data shapes: {} label shapes: {}".format(
            self.__class__.__name__, data_shapes, label_shapes)


class DataIter:
    """Iterator protocol (reference `io.py` DataIter)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _init_data(data, allow_empty, default_name):
    """Normalize array/list/dict input to an ordered list of (name, numpy array)
    (reference `io/utils.py` `_init_data`)."""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (onp.ndarray, torch.Tensor)):
        data = [data]
    if isinstance(data, (list, tuple)):
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {"_%d_%s" % (i, default_name): d
                    for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be a tensor, numpy.ndarray, a list of "
                        "them or dict with them as values")
    out = []
    # sorted by name, as the reference does (`io/utils.py` _init_data) —
    # classic scripts rely on this ordering of batch.data
    for k, v in sorted(data.items()):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        out.append((k, onp.ascontiguousarray(v)))
    return out


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (reference `io.py` NDArrayIter):
    supports shuffle and `last_batch_handle` in {'pad','discard',
    'roll_over'}."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.idx = onp.arange(self.data[0][1].shape[0])
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.num_data = self.idx.shape[0]
        assert self.num_data >= batch_size, \
            "batch_size needs to be smaller than data size"
        self.cursor = -batch_size
        self._cache_data = None
        self._cache_label = None
        self._tail = 0
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def hard_reset(self):
        if self.shuffle:
            self._shuffle_data()
        self.cursor = -self.batch_size
        self._cache_data = None
        self._cache_label = None
        self._tail = 0

    def reset(self):
        if self.shuffle:
            self._shuffle_data()
        if self.last_batch_handle == "roll_over" and \
                self._cache_data is not None:
            # the cached tail (``self._tail`` rows) opens the new epoch: the
            # first batch sits at cursor = -tail after iter_next, taking the
            # cache plus batch_size - tail fresh head rows
            self.cursor = -self.batch_size - self._tail
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if not self.iter_next():
            raise StopIteration
        data = self.getdata()
        label = self.getlabel()
        if data[0].shape[0] != self.batch_size:
            if self.last_batch_handle == "discard":
                raise StopIteration
            if self.last_batch_handle == "roll_over":
                # keep the incomplete tail for the next epoch
                self._cache_data = data
                self._cache_label = label
                self._tail = data[0].shape[0]
                raise StopIteration
        return DataBatch(data=data, label=label, pad=self.getpad(),
                         index=None)

    def _getdata(self, data_source, start=None, end=None):
        assert start is not None or end is not None
        start = start if start is not None else 0
        end = end if end is not None else data_source[0][1].shape[0]
        s = slice(start, end)
        return [torch.from_numpy(x[1][self.idx[s]]) for x in data_source]

    def _concat(self, first, second):
        assert len(first) == len(second)
        return [torch.cat((f, s)) for f, s in zip(first, second)]

    def _is_rolled_batch(self, cache):
        # first batch of an epoch opened by a rolled-over tail: after
        # iter_next the cursor sits at -tail, in (-batch_size, 0)
        return (self.last_batch_handle == "roll_over"
                and cache is not None
                and -self.batch_size < self.cursor < 0)

    def _batchify(self, data_source, cache):
        assert self.cursor < self.num_data, "DataIter needs reset."
        if self._is_rolled_batch(cache):
            # cached tail + the first batch_size - tail fresh head rows
            return self._concat(cache, self._getdata(
                data_source, start=0, end=self.cursor + self.batch_size))
        if self.cursor + self.batch_size <= self.num_data:
            return self._getdata(data_source, start=self.cursor,
                                 end=self.cursor + self.batch_size)
        # incomplete tail of the epoch
        first = self._getdata(data_source, start=self.cursor)
        if self.last_batch_handle == "pad":
            # wrap around to the head of the data
            pad = self.batch_size - self.num_data + self.cursor
            second = self._getdata(data_source, end=pad)
            return self._concat(first, second)
        return first

    def getdata(self):
        rolled = self._is_rolled_batch(self._cache_data)
        batch = self._batchify(self.data, self._cache_data)
        if rolled:
            self._cache_data = None
        return batch

    def getlabel(self):
        if not self.label:
            return []
        rolled = self._is_rolled_batch(self._cache_label)
        batch = self._batchify(self.label, self._cache_label)
        if rolled:
            self._cache_label = None
        return batch

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0

    def _shuffle_data(self):
        onp.random.shuffle(self.idx)


class CSVIter(DataIter):
    """Iterate rows of a CSV file (parsed by the host library,
    `csrc/host/csv.cc`): fixed `data_shape` per row, optional label CSV,
    round-robin padding of the last batch."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, dtype="float32",
                 data_name="data", label_name="softmax_label"):
        super().__init__(batch_size)
        data = parse_csv(data_csv).astype(dtype, copy=False)
        n = data.shape[0]
        data = data.reshape((n,) + tuple(data_shape))
        if label_csv is not None:
            label = parse_csv(label_csv).astype(dtype, copy=False)
            label = label.reshape((n,) + tuple(label_shape))
        else:
            label = onp.zeros((n,) + tuple(label_shape), dtype=dtype)
        # both round_batch modes emit the final partial batch at full size
        # with `pad` set (reference `iter_batchloader.h` emits a padded last
        # batch either way; only the fill source differs)
        self._iter = NDArrayIter(
            {data_name: data}, {label_name: label}, batch_size=batch_size,
            last_batch_handle="pad",
            data_name=data_name, label_name=label_name)

    @property
    def provide_data(self):
        return self._iter.provide_data

    @property
    def provide_label(self):
        return self._iter.provide_label

    def reset(self):
        self._iter.reset()

    def iter_next(self):
        return self._iter.iter_next()

    def next(self):
        return self._iter.next()

    def getdata(self):
        return self._iter.getdata()

    def getlabel(self):
        return self._iter.getlabel()

    def getpad(self):
        return self._iter.getpad()


class ResizeIter(DataIter):
    """Resize an iterator to `size` batches per epoch (reference `io.py`
    ResizeIter), re-looping the underlying iterator as needed."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        if hasattr(data_iter, "default_bucket_key"):
            self.default_bucket_key = data_iter.default_bucket_key

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Overlap batch assembly with compute using one background thread per
    sub-iterator (reference `io.py` PrefetchingIter)."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        super().__init__()
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        self.n_iter = len(iters)
        assert self.n_iter > 0
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0].shape[0] * self.n_iter
        self.data_ready = [threading.Event() for _ in range(self.n_iter)]
        self.data_taken = [threading.Event() for _ in range(self.n_iter)]
        for e in self.data_taken:
            e.set()
        self._stop = threading.Event()
        self.current_batch = None
        # per-iterator slot: [batch_or_None, exception_or_None]; threads
        # close over these objects, NOT over self, so dropping the iterator
        # releases it (the threads are then shut down by close()/__del__)
        self._slots = [[None, None] for _ in range(self.n_iter)]

        def prefetch_func(it, taken, ready, slot, stop):
            while True:
                taken.wait()
                if stop.is_set():
                    break
                try:
                    slot[0] = it.next()
                except StopIteration:
                    slot[0] = None
                except Exception as exc:  # surfaced in iter_next
                    slot[0] = None
                    slot[1] = exc
                taken.clear()
                ready.set()

        self.prefetch_threads = [
            threading.Thread(
                target=prefetch_func,
                args=(self.iters[i], self.data_taken[i], self.data_ready[i],
                      self._slots[i], self._stop),
                daemon=True)
            for i in range(self.n_iter)]
        for t in self.prefetch_threads:
            t.start()

    def close(self):
        """Stop the prefetch threads (also called on garbage collection)."""
        self._stop.set()
        for e in self.data_taken:
            e.set()
        for t in self.prefetch_threads:
            t.join(timeout=1.0)

    def __del__(self):
        self.close()

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([[
            DataDesc(r[x.name], x.shape, x.dtype)
            if isinstance(x, DataDesc) else DataDesc(*x)
            for x in i.provide_data
        ] for r, i in zip(self.rename_data, self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([[
            DataDesc(r[x.name], x.shape, x.dtype)
            if isinstance(x, DataDesc) else DataDesc(*x)
            for x in i.provide_label
        ] for r, i in zip(self.rename_label, self.iters)], [])

    def reset(self):
        for e in self.data_ready:
            e.wait()
        for i in self.iters:
            i.reset()
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()

    def iter_next(self):
        for e in self.data_ready:
            e.wait()
        for slot in self._slots:
            if slot[1] is not None:  # a prefetch thread hit an error
                exc, slot[1] = slot[1], None
                raise exc
        batches = [slot[0] for slot in self._slots]
        if batches[0] is None:
            # all sub-iterators end together
            for b in batches:
                assert b is None, "Number of entry mismatches between iters"
            return False
        for b in batches:
            assert b.pad == batches[0].pad, \
                "Different pad size in sub-iterators"
        self.current_batch = DataBatch(
            sum([b.data for b in batches], []),
            sum([b.label for b in batches], []),
            batches[0].pad,
            batches[0].index,
            provide_data=self.provide_data,
            provide_label=self.provide_label)
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class LibSVMIter(DataIter):
    """Iterate a LibSVM-format file as CSR batches: each batch yields a
    sparse CSR tensor (``torch.sparse_csr_tensor``, f32 values) of
    (batch_size, num_cols) and a dense label vector.  Parsed by the host
    library (`csrc/host/libsvm.cc`)."""

    def __init__(self, data_libsvm, data_shape=None, label_libsvm=None,
                 batch_size=1, round_batch=True, data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        labels, indptr, indices, values, ncols = parse_libsvm(data_libsvm)
        if data_shape is not None:
            ncols = data_shape[0] if isinstance(data_shape, (tuple, list)) \
                else int(data_shape)
            if len(indices) and int(indices.max()) >= ncols:
                raise ValueError(
                    f"data_shape={ncols} is smaller than the largest "
                    f"feature index {int(indices.max())} in {data_libsvm}")
        self._csr = (values, indices, indptr)
        if label_libsvm is not None:
            ext_labels = parse_libsvm(label_libsvm)[0]
            if len(ext_labels) != len(labels):
                raise ValueError(
                    f"label file has {len(ext_labels)} rows but data file "
                    f"has {len(labels)}")
            labels = ext_labels
        self._labels = labels
        self._ncols = ncols
        self.num_data = len(labels)
        assert self.num_data >= batch_size
        self._round = round_batch
        self.data_name = data_name
        self.label_name = label_name
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(self.data_name, (self.batch_size, self._ncols))]

    @property
    def provide_label(self):
        return [DataDesc(self.label_name, (self.batch_size,))]

    def reset(self):
        self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def _rows(self, idxs):
        values, col, indptr = self._csr
        data, indices, new_indptr = [], [], [0]
        for r in idxs:
            lo, hi = indptr[r], indptr[r + 1]
            data.append(values[lo:hi])
            indices.append(col[lo:hi])
            new_indptr.append(new_indptr[-1] + (hi - lo))
        return torch.sparse_csr_tensor(
            torch.tensor(new_indptr, dtype=torch.int64),
            torch.from_numpy(onp.concatenate(indices).astype(onp.int64)),
            torch.from_numpy(onp.concatenate(data)),
            (len(idxs), self._ncols))

    def next(self):
        if not self.iter_next():
            raise StopIteration
        end = self.cursor + self.batch_size
        idxs = list(range(self.cursor, min(end, self.num_data)))
        pad = end - self.num_data if end > self.num_data else 0
        if pad:
            if not self._round:
                raise StopIteration
            idxs += list(range(pad))  # wrap to the head, reference-style
        batch = DataBatch([self._rows(idxs)],
                          [torch.from_numpy(self._labels[idxs])], pad=pad)
        return batch

    def getpad(self):
        end = self.cursor + self.batch_size
        return end - self.num_data if end > self.num_data else 0
