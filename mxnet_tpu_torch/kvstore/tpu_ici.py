"""``kvstore='tpu_ici'``: the copies' reduction in one process
(counterpart of `mxnet_tpu/kvstore/tpu_ici.py`'s dense copies path).

The name is the reference's, and ``nccl``, ``dist_sync``,
``dist_device_sync`` and ``horovod`` are its aliases (`kvstore.create`).
Values arrive as a list of per-context copies of one gradient, as
``Trainer`` pushes them; `_reduce_copies` sums them:

- copies on two or more distinct cards: one ``torch.cuda.nccl``
  all-reduce over the copies, each card's sum left on that card (the
  reference's one compiled psum over the copies' devices);
- host-backed copies, or several copies on one device: a plain sum in
  index order on the first copy's device, written back to each copy (the
  reference's fallback branch).

Each ``pushpull`` runs inside the transient-fault retry policy, with the
``kvstore.pushpull`` fault site and a ``collective_span("allreduce",
bytes)`` around the reduction, as in the reference.  ``pushpull_list``
reduces key by key in the caller's order.

This store runs one process (``rank`` 0 of 1).  A process group of more
than one rank and liveness across ranks (``get_dead_nodes``, the
heartbeat) are ROADMAP queue A item A7b; gradient compression and
bucketing are A7c; row-sparse values are A10.
"""
from __future__ import annotations

import torch

from .. import observe as _observe
from ..base import MXNetError
from ..telemetry import collective_span as _collective_span
from .base import KVStoreBase, _as_list, _copy_into

__all__ = ["TPUICIStore"]


def _payload_bytes(vals):
    """The collective's payload: the bytes of every copy."""
    return sum(v.numel() * v.element_size() for v in vals)


@KVStoreBase.register
class TPUICIStore(KVStoreBase):
    def __init__(self):
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized() and \
                dist.get_world_size() > 1:
            raise NotImplementedError(
                f"a process group of {dist.get_world_size()} ranks: the "
                "store across ranks is ROADMAP queue A item A7b in the "
                "port, which reduces copies in one process")
        self._rank = 0
        self._size = 1
        _observe.set_rank(self._rank)

    def get_dead_nodes(self, timeout=60):
        """Ranks whose heartbeat is older than ``timeout``: none in one
        process (liveness across ranks is ROADMAP queue A item A7b)."""
        return []

    # -- interface ---------------------------------------------------------
    def broadcast(self, key, value, out, priority=0):
        """Copy ``value`` (or its first copy) into every output copy;
        outputs on more than one device count as a collective."""
        src = _as_list(value)[0]
        outs = _as_list(out)
        devices = {o.device for o in outs}
        if len(devices) <= 1:
            for o in outs:
                _copy_into(src, o)
            return
        with _collective_span("broadcast",
                              _payload_bytes([src]) * len(devices)):
            for o in outs:
                _copy_into(src, o)

    def set_gradient_compression(self, compression_params):
        raise NotImplementedError(
            "gradient compression (2-bit, block-scaled int8/fp8) is "
            "ROADMAP queue A item A7c in the port")

    def pushpull(self, key, value, out=None, priority=0):
        """One key's reduce inside the transient-fault retry policy: a
        timeout injected at ``kvstore.pushpull`` costs a backoff and a
        retry, counted inside the retried call."""
        from ..resilience.policies import retry_transient

        return retry_transient(
            lambda: self._pushpull_once(key, value, out),
            site="kvstore.pushpull")

    def _pushpull_once(self, key, value, out=None):
        from ..resilience import faultline as _faultline

        _faultline.check("kvstore.pushpull")
        vals = _as_list(value)
        if any(v.layout != torch.strided for v in vals):
            raise NotImplementedError(
                "row-sparse kvstore values wait for the port's row-sparse "
                "arrays (ROADMAP queue A item A10)")
        if len(vals) == 1:
            reduced = vals[0]          # one copy: its own sum
        else:
            with _collective_span("allreduce", _payload_bytes(vals)):
                reduced = self._reduce_copies(vals)
        targets = vals if out is None else _as_list(out)
        if isinstance(reduced, list):
            # each card's sum, written on its own card
            for o, r in zip(targets, reduced):
                _copy_into(r, o)
            return
        for o in targets:
            _copy_into(reduced, o)

    def pushpull_list(self, pairs):
        """Reduce many keys in place, key by key in the caller's order
        (gradient bucketing is ROADMAP queue A item A7c)."""
        for key, value in pairs:
            self.pushpull(key, value)

    @staticmethod
    def _reduce_copies(vals):
        """The sum of the copies: one list of per-card sums from a NCCL
        all-reduce where every copy lies on a card of its own, else one
        tensor summed in index order on the first copy's device."""
        devices = [v.device for v in vals]
        if any(d.type != "cuda" for d in devices) or \
                len(set(devices)) < len(vals):
            total = vals[0]
            for v in vals[1:]:
                total = total + v.to(devices[0])
            return total
        sums = [v.clone(memory_format=torch.contiguous_format)
                for v in vals]
        torch.cuda.nccl.all_reduce(sums)
        return sums

    @staticmethod
    def is_capable(capability):
        if capability.lower() == KVStoreBase.OPTIMIZER:
            return False       # an allreduce store: the Trainer updates
        raise MXNetError(f"unknown capability: {capability}")

    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        return self._size

    @property
    def type(self):
        return "tpu_ici"
