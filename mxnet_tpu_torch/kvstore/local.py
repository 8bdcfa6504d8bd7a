"""Single-process kvstore with the classic init/push/pull API
(counterpart of `mxnet_tpu/kvstore/local.py`).

A push sums the per-context copies of a value in index order on the
first copy's device; a pull copies the stored value into every output.
With an optimizer set (``set_optimizer``, as ``update_on_kvstore=True``
does), a push runs the update at the store through an
`optimizer.Updater` instead of storing the sum.  ``pushpull_list``
reduces the values of two or more copies through a
`bucketing.GradBucketer`, uncompressed, as the reference does.  Values
are dense tensors; row-sparse ones are ROADMAP queue A item A10.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .base import KVStoreBase, _as_list, _copy_into

__all__ = ["LocalKVStore"]


class LocalKVStore(KVStoreBase):
    def __init__(self):
        self._store = {}
        self._updater = None
        self._bucketer = None

    # -- classic API --------------------------------------------------------
    def init(self, key, value):
        for k, v in zip(*_normalize(key, value)):
            self._store[k] = _as_list(v)[0].detach().clone()

    def push(self, key, value, priority=0):
        for k, v in zip(*_normalize(key, value)):
            reduced = _reduce(v)
            if self._updater is not None:
                if k not in self._store:
                    raise MXNetError(f"key {k} not initialized")
                self._updater(_int_key(k), reduced, self._store[k])
            else:
                self._store[k] = reduced

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        for k, o in zip(*_normalize(key, out)):
            if k not in self._store:
                raise MXNetError(f"key {k} not initialized")
            for dst in _as_list(o):
                _copy_into(self._store[k], dst)

    def set_optimizer(self, optimizer):
        from ..optimizer import Updater
        self._updater = Updater(optimizer)

    def set_updater(self, updater):
        self._updater = updater

    # -- KVStoreBase API ----------------------------------------------------
    def broadcast(self, key, value, out, priority=0):
        self.init(key, value)
        self.pull(key, out=out, priority=priority)

    def pushpull(self, key, value, out=None, priority=0):
        keys, values = _normalize(key, value)
        outs = values if out is None else _normalize(key, out)[1]
        for v, o in zip(values, outs):
            reduced = _reduce(v)
            for dst in _as_list(o):
                _copy_into(reduced, dst)

    def pushpull_list(self, pairs):
        """Reduce many keys in place in the caller's order, the values of
        two or more dense copies through the store's `GradBucketer` (one
        reduce a size-capped bucket); a single value keeps the per-key
        path.  ``MXNET_KVSTORE_BUCKETING=0`` reduces key by key."""
        from . import bucketing as _bucketing

        if not _bucketing.bucketing_enabled():
            for key, value in pairs:
                self.pushpull(key, value)
            return
        bucketable, per_key = _bucketing.split_bucketable(pairs)
        for key, value in per_key:
            self.pushpull(key, value)
        if bucketable:
            if self._bucketer is None:
                self._bucketer = _bucketing.GradBucketer()
            self._bucketer.pushpull(bucketable)

    @staticmethod
    def is_capable(capability):
        if capability.lower() == KVStoreBase.OPTIMIZER:
            return True
        raise MXNetError(f"unknown capability: {capability}")

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    @property
    def type(self):
        return "local"

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("optimizer is not set")
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        """Load the updater's states from ``fname``, each onto the device
        of its key's stored value."""
        if self._updater is None:
            raise MXNetError("optimizer is not set")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())
        self._updater.states = {
            i: tuple(torch.from_numpy(s).to(self._device_of(i))
                     for s in st)
            for i, st in self._updater.states.items()}

    def _device_of(self, key):
        # the updater keys an int-like name as its int
        stored = self._store.get(key, self._store.get(str(key)))
        return "cpu" if stored is None else stored.device


def _int_key(k):
    try:
        return int(k)
    except (TypeError, ValueError):
        return k


def _reduce(v):
    """The sum of the copies in ``v``, in index order on the first one's
    device (the first copy itself when there is one)."""
    vals = _as_list(v)
    if any(x.layout != torch.strided for x in vals):
        raise NotImplementedError(
            "row-sparse kvstore values wait for the port's row-sparse "
            "arrays (ROADMAP queue A item A10)")
    acc = vals[0]
    for x in vals[1:]:
        acc = acc + x.to(acc.device)
    return acc


def _normalize(key, value):
    if isinstance(key, (list, tuple)):
        if not isinstance(value, (list, tuple)) or len(key) != len(value):
            raise ValueError("a list of keys needs a list of values of the "
                             "same length")
        return list(key), list(value)
    return [key], [value]
