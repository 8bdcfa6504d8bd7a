"""KVStore plugin API (counterpart of `mxnet_tpu/kvstore/base.py`).

``KVStoreBase`` is the capability interface (``broadcast`` /
``pushpull`` / ``is_capable``) that `gluon.Trainer` drives, with a
registry of store classes by lower-cased class name.  Names accepted by
:func:`create`, as in the reference:

=================  ====================================================
name               store
=================  ====================================================
``local``          `LocalKVStore`: reduce of per-context copies, with
                   the classic ``init`` / ``push`` / ``pull`` API and an
                   optional updater (``update_on_kvstore``)
``device``         alias of ``local`` (also ``local_allreduce_cpu`` and
                   ``local_allreduce_device``)
``tpu_ici``        `TPUICIStore`: the copies summed by one NCCL
                   all-reduce where they lie on distinct cards; the name
                   is the reference's
``nccl``,          aliases of ``tpu_ici``
``horovod``,
``dist_sync``,
``dist_device_
sync``
=================  ====================================================

``dist_async`` and the ``p3`` stores raise, as in the reference.
"""
from __future__ import annotations

import torch

from ..base import MXNetError

__all__ = ["KVStoreBase", "create", "TestStore"]


class KVStoreBase:
    OPTIMIZER = "optimizer"

    kv_registry = {}

    @staticmethod
    def register(klass):
        KVStoreBase.kv_registry[klass.__name__.lower()] = klass
        return klass

    # -- interface --------------------------------------------------------
    def broadcast(self, key, value, out, priority=0):
        raise NotImplementedError

    def pushpull(self, key, value, out=None, priority=0):
        """Reduce ``value`` (a tensor or a list of per-context copies);
        ``out=None`` writes the sum into the pushed tensors in place (the
        Trainer's path).  ``priority`` is accepted and orders nothing:
        the reductions run in the order of the calls."""
        raise NotImplementedError

    def pushpull_list(self, pairs):
        """Reduce many ``(key, value)`` pairs in place, in the order
        given (the Trainer gives them in reverse registration order, the
        order a backward produces them)."""
        for key, value in pairs:
            self.pushpull(key, value)

    @staticmethod
    def is_capable(capability):
        raise NotImplementedError

    @property
    def rank(self):
        raise NotImplementedError

    @property
    def num_workers(self):
        raise NotImplementedError


_ALIASES = {
    "local": "local",
    "device": "local",
    "local_allreduce_cpu": "local",
    "local_allreduce_device": "local",
    "tpu_ici": "tpuicistore",
    "nccl": "tpuicistore",
    "horovod": "tpuicistore",
    "dist_sync": "tpuicistore",
    "dist_device_sync": "tpuicistore",
    "dist_sync_device": "tpuicistore",
    "teststore": "teststore",
}


def create(name="local"):
    """A new store of type ``name`` (see the module's table)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    key = name.lower()
    if key in ("dist_async", "p3", "dist_sync_device_p3",
               "dist_device_sync_p3"):
        raise MXNetError(
            f"kvstore type '{name}' (asynchronous/priority parameter-server) "
            "has no faithful analogue on synchronous collectives; use "
            "'tpu_ici' (synchronous allreduce). See SURVEY.md §7 hard-part 5.")
    target = _ALIASES.get(key)
    if target is None:
        raise MXNetError(f"unknown kvstore type '{name}'")
    if target == "local":
        from .local import LocalKVStore
        return LocalKVStore()
    klass = KVStoreBase.kv_registry.get(target)
    if klass is None:
        raise MXNetError(f"kvstore backend '{target}' not registered")
    return klass()


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _copy_into(src, dst):
    """``dst[...] = src`` across devices, outside autograd (``dst`` may
    be a parameter's leaf)."""
    if dst is not src:
        with torch.no_grad():
            dst.copy_(src)


@KVStoreBase.register
class TestStore(KVStoreBase):
    """Pure-python single-worker store for tests (the reference's
    ``TestStore``)."""

    def broadcast(self, key, value, out, priority=0):
        src = _as_list(value)[0]
        for o in _as_list(out):
            _copy_into(src, o)

    def pushpull(self, key, value, out=None, priority=0):
        values = _as_list(value)
        reduced = values[0]
        for v in values[1:]:
            reduced = reduced + v.to(reduced.device)
        if out is None:
            if len(values) == 1:
                return
            for v in values:
                _copy_into(reduced, v)
        else:
            for o in _as_list(out):
                _copy_into(reduced, o)

    @staticmethod
    def is_capable(capability):
        if capability.lower() == KVStoreBase.OPTIMIZER:
            return False
        raise MXNetError(f"unknown capability: {capability}")

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1
