"""``ImageRecordIter``: the image input pipeline over a RecordIO file
(counterpart of `mxnet_tpu/io/image_record.py`).

It drives the native pipeline of the port's host library
(`csrc/host/image_pipeline.cc`, built by g++ with libjpeg at first use,
`_native.img_lib`): worker threads decode JPEG and crop/flip outside the
GIL into a ring of batch slots, and Python pops completed batches in
order.  ``num_parts``/``part_index`` give each part a strided slice of
the epoch's global permutation, a function of (seed, epoch, part) only,
and the parts together cover the file exactly.

Batches are NHWC uint8 with f32 labels, on the host: normalisation and
the cast belong on the card, inside the training step
(`gluon.data.DeviceAugment`, or the step's own prologue), and
`io.DevicePrefetcher` moves the batches there.  Records that fail to
decode are zero-filled and counted (``decode_errors``).  As in the
reference, the counts are published to the telemetry registry
(``mxtpu_io_decode_errors_total``, ``mxtpu_io_batches_total``, the
``mxtpu_io_ring_ready`` gauge and the ``mxtpu_io_next_wait_seconds``
histogram); `stats()` returns this iterator's own.
"""
from __future__ import annotations

import ctypes
import logging
import time

import numpy as onp
import torch

from .._native import img_lib
from ..env import decode_threads, io_error_tolerance


def _io_metrics():
    from .. import telemetry as _tm

    return (
        _tm.counter("mxtpu_io_decode_errors_total",
                    "Records the native image pipeline failed to decode "
                    "(zero-filled and counted, never dropped)"),
        _tm.counter("mxtpu_io_batches_total",
                    "Batches popped from the native decode ring"),
        _tm.gauge("mxtpu_io_ring_ready",
                  "Completed batches waiting in the decode ring at the "
                  "last pop (0 while compute waits = decode-bound)"),
        _tm.histogram("mxtpu_io_next_wait_seconds",
                      "Consumer wait for the next completed batch"),
    )
from .io import DataBatch, DataDesc, DataIter

__all__ = ["ImageRecordIter"]


class ImageRecordIter(DataIter):
    """The reference's constructor arguments.  ``data_shape`` is (C, H, W)
    with C = 3; batches are NHWC unless ``layout='NCHW'``.
    ``preprocess_threads`` defaults to `env.decode_threads`."""

    def __init__(self, path_imgrec, batch_size, data_shape=(3, 224, 224),
                 resize=0, rand_crop=False, rand_mirror=False,
                 shuffle=False, preprocess_threads=None, prefetch_buffer=3,
                 seed=0, num_parts=1, part_index=0, layout="NHWC",
                 round_batch=True, **_compat):
        super().__init__(batch_size=batch_size)
        c, h, w = data_shape
        if c != 3:
            raise ValueError("the pipeline decodes RGB: data_shape[0] must "
                             "be 3")
        if layout not in ("NHWC", "NCHW"):
            raise ValueError("layout must be NHWC or NCHW")
        if preprocess_threads is None:
            preprocess_threads = decode_threads()
        self._err_tolerance = io_error_tolerance()
        self._lib = img_lib()
        self._h, self._w = h, w
        self._layout = layout
        self.num_parts = int(num_parts)
        self.part_index = int(part_index)
        self._handle = self._lib.imgpipe_create(
            str(path_imgrec).encode(), batch_size, h, w, int(resize),
            int(preprocess_threads), int(prefetch_buffer),
            int(bool(rand_crop)), int(bool(rand_mirror)),
            int(bool(shuffle)), int(seed), self.num_parts, self.part_index)
        if not self._handle:
            raise IOError(self._lib.imgpipe_last_error().decode())
        self._num_records = self._lib.imgpipe_num_records(self._handle)
        self._part_records = self._lib.imgpipe_part_records(self._handle)
        # every part delivers the same number of batches an epoch, from the
        # smallest part's size; the native stream wraps, so a larger part's
        # surplus rolls into its next epoch
        self._batches_per_epoch = max(
            1, (self._num_records // self.num_parts) // batch_size)
        self._cursor = 0
        # decode-error watermarks of the warning's window
        self._err_window_base = 0
        self._err_window_records = 0
        self._err_seen = 0
        self._err_ctr, self._batch_ctr, self._ring_gauge, self._wait_hist = \
            _io_metrics()
        self.batches = 0
        self.wait_seconds = 0.0
        shape = (batch_size, c, h, w) if layout == "NCHW" else \
            (batch_size, h, w, c)
        self.provide_data = [DataDesc("data", shape, onp.uint8)]
        self.provide_label = [DataDesc("softmax_label", (batch_size,),
                                       onp.float32)]

    @property
    def num_records(self):
        return self._num_records

    @property
    def part_records(self):
        """Records owned by this (num_parts, part_index) part."""
        return self._part_records

    @property
    def decode_errors(self):
        return self._lib.imgpipe_decode_errors(self._handle)

    @property
    def ready_batches(self):
        """Completed batches waiting in the decode ring."""
        return self._lib.imgpipe_ready_batches(self._handle)

    def stats(self):
        """The pipeline's counts: batches popped, records that failed to
        decode, completed batches waiting now, and the seconds the
        consumer waited for batches in all."""
        return {"batches": self.batches, "decode_errors": self.decode_errors,
                "ready_batches": self.ready_batches,
                "wait_seconds": self.wait_seconds}

    def _account_errors(self):
        """Warn when the share of records that failed to decode in the
        current window (one part's worth of records) exceeds
        `env.io_error_tolerance`."""
        errs = self.decode_errors
        delta = errs - self._err_seen
        if delta > 0:
            self._err_ctr.inc(delta)
            self._err_seen = errs
        self._err_window_records += self.batch_size
        if self._err_window_records >= max(self._part_records,
                                           self.batch_size):
            frac = (errs - self._err_window_base) / \
                max(1, self._err_window_records)
            if frac > self._err_tolerance:
                logging.getLogger("mxnet_tpu_torch.io").warning(
                    "ImageRecordIter: %.2f%% of the last %d records failed "
                    "to decode (tolerance %.2f%%); corrupt records are "
                    "zero-filled, check the .rec file",
                    100.0 * frac, self._err_window_records,
                    100.0 * self._err_tolerance)
            self._err_window_base = errs
            self._err_window_records = 0

    def next_arrays(self):
        """One batch as host numpy arrays: NHWC uint8 data, f32 labels."""
        n = self.batch_size
        data = onp.empty((n, self._h, self._w, 3), onp.uint8)
        labels = onp.empty((n,), onp.float32)
        t0 = time.perf_counter()
        self._lib.imgpipe_next(
            self._handle,
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        waited = time.perf_counter() - t0
        self.wait_seconds += waited
        self._wait_hist.observe(waited)
        self.batches += 1
        self._batch_ctr.inc()
        self._ring_gauge.set(self.ready_batches)
        self._account_errors()
        return data, labels

    def next(self):
        if self._cursor >= self._batches_per_epoch:
            raise StopIteration
        self._cursor += 1
        data, labels = self.next_arrays()
        d = torch.from_numpy(data)
        if self._layout == "NCHW":
            d = d.permute(0, 3, 1, 2).contiguous()
        return DataBatch(data=[d], label=[torch.from_numpy(labels)], pad=0)

    def reset(self):
        # the native stream runs on across epochs (reshuffling at each
        # wrap); reset only rearms the epoch's batch count
        self._cursor = 0

    def reshard(self, num_parts, part_index):
        raise NotImplementedError(
            "ImageRecordIter.reshard (an elastic change of the world) is "
            "ROADMAP queue A item A7d (distribution) in the port")

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.imgpipe_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
