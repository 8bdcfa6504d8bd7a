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

Across ranks (a ``torch.distributed`` group, `mxnet_tpu_torch._distributed`)
``rank`` and ``num_workers`` are the group's.  A single value's
``pushpull`` is its own sum there too, as in the reference, where XLA has
already reduced it inside the step: `gluon.FusedTrainStep(mesh=)` sums
the gradients across the ranks; the eager loop's are not summed (ROADMAP
queue C12, inherited).

Liveness (the reference's heartbeat over the coordination service): with
more than one rank, a thread stamps ``mxtpu/heartbeat/<rank>`` with the
wall clock into the bootstrap's ``TCPStore`` every
``MXNET_HEARTBEAT_INTERVAL`` seconds (default 5), through a connection
of its own; `get_dead_nodes` reads every rank's stamp and declares a
rank dead on its second stale observation in a row, after a start-up
grace of ``timeout`` for a rank that never stamped.  `record_steptime`
and `read_steptimes` stamp and read ``mxtpu/steptime/<rank>`` for the
straggler policy.  Reads go through the ``kvstore.kv`` fault site under
`retry_transient`; a ``bitflip`` there corrupts a stamp, and a
``dead_node`` fault marks its rank stale for good.  `close` stops and
joins the thread.  A group that `_distributed` did not start has no
store to stamp into: there, as in the reference without a coordination
client, no rank is reported dead.

Gradient compression and bucketing are ROADMAP queue A item A7c;
row-sparse values are A10.
"""
from __future__ import annotations

import os
import threading
import time

import torch

from .. import _distributed
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
        self._rank, self._size = _distributed.world()
        _observe.set_rank(self._rank)
        self._hb_stop = None
        self._hb_thread = None
        # rank -> consecutive stale heartbeat observations (death needs 2)
        self._stale_counts = {}
        # a rank that never stamped is dead only after `timeout` seconds
        # from here
        self._started_at = time.time()
        if self._size > 1:
            self._start_heartbeat()

    # -- liveness -------------------------------------------------------------
    @staticmethod
    def _kv_client():
        from .. import _distributed

        return _distributed.store()

    @staticmethod
    def _kv_try_get(client, key):
        """The stamp under ``key`` or None, through the ``kvstore.kv``
        fault site under the transient-fault retry policy; after the retry
        budget, unreachable and absent both read as no stamp.  A planned
        ``bitflip`` corrupts the stamp in flight."""
        from ..resilience import faultline as _faultline
        from ..resilience.policies import retry_transient

        def attempt():
            _faultline.check("kvstore.kv")
            if not client.check([key]):
                return None
            return client.get(key).decode()

        try:
            out = retry_transient(attempt, site="kvstore.kv")
        # an unreachable store after the retries reads as "no stamp"
        except (RuntimeError, TimeoutError, ConnectionError):
            return None
        if isinstance(out, str):
            out = _faultline.corrupt("kvstore.kv", out)
        return out

    def _start_heartbeat(self):
        from .. import _distributed

        client = _distributed.store_client()
        if client is None:
            return
        interval = float(os.environ.get("MXNET_HEARTBEAT_INTERVAL", "5"))
        self._hb_stop = threading.Event()
        key = f"mxtpu/heartbeat/{self._rank}"

        def beat():
            while True:
                try:
                    stamp = time.time()
                    client.set(key, repr(stamp))
                    _observe.record("heartbeat", "beat",
                                    rank=self._rank, stamp=stamp)
                # the store going down mid-beat: peers see a stale stamp,
                # which is what this thread reports by stopping to beat
                except RuntimeError:
                    pass
                if self._hb_stop.wait(interval):
                    return

        t = threading.Thread(target=beat, daemon=True,
                             name="mxtpu-heartbeat")
        t.start()
        self._hb_thread = t

    def get_dead_nodes(self, timeout=60):
        """Ranks whose heartbeat is older than ``timeout`` seconds (empty
        with one rank).  A single stale observation only marks a rank
        suspect; death is declared on the second in a row, so one missed
        stamp never kills a live job.  A fresh stamp clears the
        suspicion."""
        from ..resilience import faultline as _faultline

        client = self._kv_client()
        if client is None or self._size <= 1:
            return []
        now = time.time()
        # ranks an injected `dead_node` fault killed read stale for good
        killed = _faultline.dead_ranks()
        dead = []
        for r in range(self._size):
            stamp = self._kv_try_get(client, f"mxtpu/heartbeat/{r}")
            if r in killed:
                stale = True
            elif stamp is None:
                # never stamped: "still launching" within the grace window
                stale = now - self._started_at > timeout
            else:
                try:
                    stale = now - float(stamp) > timeout
                except ValueError:
                    stale = True  # forged/corrupt stamp: not a live beat
            if not stale:
                self._stale_counts.pop(r, None)
                if r != self._rank and stamp is not None:
                    _observe.record("heartbeat", "observe", rank=r,
                                    stamp=float(stamp), stale=False)
                continue
            n = self._stale_counts.get(r, 0) + 1
            self._stale_counts[r] = n
            _observe.record("heartbeat", "observe", rank=r, stamp=None,
                            stale=True, consecutive=n)
            if n >= 2:
                dead.append(r)
        return dead

    def record_steptime(self, seconds):
        """Stamp this rank's last step wall time (``mxtpu/steptime/<rank>``)
        for the straggler policy.  Best-effort: a rank that cannot stamp
        looks like a rank with no stamp, which the policy skips."""
        client = self._kv_client()
        if client is None:
            return
        try:
            client.set(f"mxtpu/steptime/{self._rank}", repr(float(seconds)))
            _observe.record("heartbeat", "steptime", rank=self._rank,
                            seconds=float(seconds))
        # a store hiccup must not fail the step that just completed
        except RuntimeError:
            pass

    def read_steptimes(self):
        """Every rank's last stamped step time, ``{rank: seconds}``; ranks
        with no (or an unparseable) stamp are absent."""
        client = self._kv_client()
        if client is None or self._size <= 1:
            return {}
        out = {}
        for r in range(self._size):
            stamp = self._kv_try_get(client, f"mxtpu/steptime/{r}")
            if stamp is None:
                continue
            try:
                out[r] = float(stamp)
            except ValueError:
                continue  # corrupt stamp: treated as absent, never 0.0
        return out

    def close(self):
        """Stop and join the heartbeat thread."""
        if self._hb_stop is not None:
            self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=10)
            self._hb_thread = None

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
