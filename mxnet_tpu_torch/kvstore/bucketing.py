"""Bucketed gradient collectives (counterpart of
`mxnet_tpu/kvstore/bucketing.py`).

A step of the eager loop over copies would otherwise pay one collective
a gradient (ResNet-50 v1: 161, most of them BatchNorm's 64-2048-element
vectors).  :class:`GradBucketer` plans them as the reference does:

* gradients of one ``(dtype, contexts)`` group fill size-capped buckets
  (default 4 MB, ``MXNET_KVSTORE_BUCKET_BYTES``) in the caller's order
  (the Trainer gives reverse registration order, the order a backward
  produces them); a gradient that would overflow the open bucket closes
  it, so an oversize tensor lands alone;
* each bucket is packed into one flat buffer a copy, zero-padded to a
  capacity rounded up to the 64 KB quantum, reduced with ONE collective
  (the store's ring or fallback, `tpu_ici`), and unpacked back into the
  gradients; a one-key bucket reduces on the tensor's own shape, with no
  pack;
* compression composes per bucket: 2bit quantizes the packed buffer,
  block-scaled int8/fp8 run `tpu_ici._blockwise_body` on it (scale
  blocks of ``MXNET_KVSTORE_QBLOCK`` elements ride the quantum, so the
  padding never splits one), each with one residual a (bucket, copy).

Each bucket is one ``collective_span`` (``allreduce_bucket`` or
``allreduce_<type>_bucket``, its wire bytes) issued under
``retry_transient(site="collective.dispatch")`` with the fault site
checked inside, before any gradient is written; the fill fraction of
each bucket slot goes to ``mxtpu_kvstore_bucket_fill_fraction``.

Integrity mode (``MXNET_KVSTORE_INTEGRITY=1``) runs
`tpu_ici._integrity_sideband` on the dense and block-scaled ring
reduces, where a payload crosses between copies; a ``bitflip`` planned
at ``collective.dispatch`` (`faultline.poll_payload`) adds a seeded
magnitude to one copy's result, drawn as the reference draws it, so one
plan flips the same copy in both packages.  The flags are read on the
host once a step (`consume_integrity`, the trainer's step guard).

Residuals are keyed by the plan's signature, which holds contexts; a
checkpoint holds them under a digest of the context-free part (keys,
shapes, numpy dtype names, copy count), the reference's string, so a
checkpoint crosses packages with its error feedback
(`export_residuals` / `import_residuals`; `export_layouts` and
`import_key_residuals` are what a reshard onto another world, ROADMAP
queue A7d, feeds).
"""
from __future__ import annotations

import os

import numpy as onp
import torch

from .. import telemetry as _telemetry
from ..resilience.policies import retry_transient as _retry_transient
from ..telemetry import collective_span as _collective_span
from .base import _copy_into

__all__ = ["GradBucketer", "bucketing_enabled", "bucket_bytes",
           "split_bucketable", "DEFAULT_BUCKET_BYTES",
           "DEFAULT_QUANTUM_BYTES"]

DEFAULT_BUCKET_BYTES = 4 << 20    # ~4 MB: a few buckets per ResNet-50
DEFAULT_QUANTUM_BYTES = 64 << 10  # capacity padding quantum


def bucketing_enabled():
    """``MXNET_KVSTORE_BUCKETING=0`` opts out (default: on)."""
    return os.environ.get("MXNET_KVSTORE_BUCKETING", "1") != "0"


def bucket_bytes():
    """Bucket payload cap (``MXNET_KVSTORE_BUCKET_BYTES``, default 4 MB)."""
    return int(os.environ.get("MXNET_KVSTORE_BUCKET_BYTES",
                              DEFAULT_BUCKET_BYTES))


def split_bucketable(pairs):
    """Partition ``(key, value)`` pairs into ``(bucketable, per_key)``:
    two or more dense copies are bucketable; a single value and sparse
    copies keep the per-key path."""
    bucketable, per_key = [], []
    for key, value in pairs:
        vals = list(value) if isinstance(value, (list, tuple)) else [value]
        if len(vals) >= 2 and vals[0].layout == torch.strided:
            bucketable.append((key, vals))
        else:
            per_key.append((key, value))
    return bucketable, per_key


def _fill_gauge():
    return _telemetry.gauge(
        "mxtpu_kvstore_bucket_fill_fraction",
        "Payload fraction of each gradient bucket's quantum-padded "
        "capacity, per bucket slot of the last bucketed pushpull",
        labelnames=("bucket",))


def _ctype(compression):
    """The compression type of ``compression`` (None: dense)."""
    return None if compression is None else compression.get("type", "2bit")


def _dtype_name(dtype):
    """A torch dtype's numpy name (``float32``, ``bfloat16``): what the
    reference's signature holds."""
    return str(dtype).replace("torch.", "")


class _Bucket:
    """One issue unit: contiguous segments of same-(dtype, contexts)
    gradients, padded to a quantum capacity."""

    __slots__ = ("positions", "keys", "shapes", "sizes", "offsets",
                 "dtype", "contexts", "used", "capacity")

    def __init__(self, dtype, contexts):
        self.positions = []      # indices into the pushpull items list
        self.keys = []
        self.shapes = []
        self.sizes = []
        self.offsets = []
        self.dtype = dtype       # torch dtype
        self.contexts = contexts  # tuple, one a copy (None: unmarked)
        self.used = 0            # elements
        self.capacity = 0        # elements, quantum-padded

    def add(self, pos, key, shape, size):
        self.positions.append(pos)
        self.keys.append(key)
        self.shapes.append(tuple(int(d) for d in shape))
        self.sizes.append(size)
        self.offsets.append(self.used)
        self.used += size

    def finalize(self, quantum_bytes):
        q = max(1, quantum_bytes // self.itemsize)
        self.capacity = -(-self.used // q) * q

    @property
    def itemsize(self):
        return self.dtype.itemsize

    def pack(self, tensors):
        """One copy's gradients as one flat buffer, zero-padded to the
        capacity."""
        flat = [t.reshape(-1) for t in tensors]
        pad = self.capacity - self.used
        if pad:
            flat.append(flat[0].new_zeros(pad))
        return torch.cat(flat)

    def unpack(self, flat):
        """Every key's segment of ``flat``, in its shape."""
        return [flat[off:off + size].view(shape) for off, size, shape in
                zip(self.offsets, self.sizes, self.shapes)]

    @property
    def used_bytes(self):
        return self.used * self.itemsize

    @property
    def fill_fraction(self):
        return self.used / self.capacity if self.capacity else 0.0


class GradBucketer:
    """Pack -> one collective -> unpack, per size-capped bucket.

    In place (the Trainer's path): every input copy receives the reduced
    value on its own device.  The plan is cached per item signature
    (keys, shapes, dtypes, contexts), so a `reset_ctx` builds a fresh
    plan, and fresh residuals with it.  ``MXNET_KVSTORE_BUCKET_BYTES``
    and ``MXNET_KVSTORE_INTEGRITY`` are read at construction; the
    arguments override them."""

    def __init__(self, bucket_bytes=None, quantum_bytes=None,
                 integrity=None):
        from .. import env as _env

        self.bucket_bytes = int(bucket_bytes) if bucket_bytes is not None \
            else globals()["bucket_bytes"]()
        self.quantum_bytes = int(quantum_bytes) if quantum_bytes is not None \
            else DEFAULT_QUANTUM_BYTES
        self.integrity = _env.kvstore_integrity() if integrity is None \
            else bool(integrity)
        self._violations = []  # per launch: the copies' int32 flags
        self._plans = {}       # signature -> list[_Bucket]
        self._residuals = {}   # (signature, bucket, copy) -> tensor
        self._pending_residuals = {}  # checkpoint-restored, pre-adoption
        # per-key residual totals parked for re-bucketing (a reshard)
        self._pending_key_residuals = {}
        # introspection for tests and benchmarks
        self.last_issue_keys = []
        self.last_num_buckets = 0

    # -- planning ----------------------------------------------------------
    @staticmethod
    def _signature(items):
        from .tpu_ici import _value_contexts

        return tuple(
            (key, tuple(int(d) for d in vals[0].shape),
             _dtype_name(vals[0].dtype), tuple(_value_contexts(vals)), "")
            for key, vals in items)

    def _build_plan(self, items):
        from .tpu_ici import _value_contexts

        buckets, open_by_group = [], {}
        for pos, (key, vals) in enumerate(items):
            v0 = vals[0]
            ctxs = tuple(_value_contexts(vals))
            gkey = (_dtype_name(v0.dtype), ctxs, "")
            size = int(v0.numel())
            nbytes = size * v0.element_size()
            b = open_by_group.get(gkey)
            # close the open bucket when this item would overflow it; an
            # oversize tensor then lands alone in a bucket of its own
            if b is None or (b.used_bytes + nbytes > self.bucket_bytes
                             and b.keys):
                b = _Bucket(v0.dtype, ctxs)
                open_by_group[gkey] = b
                buckets.append(b)
            b.add(pos, key, v0.shape, size)
        for b in buckets:
            b.finalize(self.quantum_bytes)
        return buckets

    # -- the reduce --------------------------------------------------------
    def pushpull(self, items, compression=None):
        """Reduce every ``(key, [copies])`` of ``items`` in place, bucket
        by bucket in the plan's (the caller's) order."""
        if not items:
            return
        sig = self._signature(items)
        plan = self._plans.get(sig)
        if plan is None:
            plan = self._plans[sig] = self._build_plan(items)
        self.last_issue_keys = [k for b in plan for k in b.keys]
        self.last_num_buckets = len(plan)
        ctype = _ctype(compression)
        fill = _fill_gauge()
        for bidx, b in enumerate(plan):
            payload = b.used_bytes * len(items[b.positions[0]][1])
            op = "allreduce_bucket" if ctype is None \
                else f"allreduce_{ctype}_bucket"
            if ctype == "2bit":
                payload //= 4  # int8 levels on the wire, not f32 words
            elif ctype is not None:
                # 2-byte partials: half of f32; a bf16 bucket keeps its
                # width
                payload = payload * 2 // b.itemsize
            with _collective_span(op, payload):
                # a transient dispatch fault retries with backoff; the
                # fault site is checked inside, before any write
                _retry_transient(
                    lambda: self._issue_bucket(sig, bidx, b, items,
                                               compression),
                    site="collective.dispatch")
            fill.labels(bucket=str(bidx)).set(b.fill_fraction)

    def _issue_bucket(self, sig, bidx, b, items, compression):
        from ..resilience import faultline as _faultline
        from .tpu_ici import _on_ring

        _faultline.check("collective.dispatch")
        n = len(items[b.positions[0]][1])
        if len(b.positions) == 1:
            # a one-key bucket (an oversize tensor, or a lone straggler):
            # packing would only copy and pad, so it reduces on its own
            # shape
            return self._issue_single(sig, bidx, b, items, compression)
        packed = [b.pack([items[pos][1][j] for pos in b.positions])
                  for j in range(n)]
        if _on_ring(b.contexts):
            flats = self._reduce_flat_ring(sig, bidx, b, packed,
                                           compression)
        else:
            flats = [self._reduce_flat_fallback(sig, bidx, b, packed,
                                                compression)] * n
        for j in range(n):
            for pos, seg in zip(b.positions, b.unpack(flats[j])):
                _copy_into(seg, items[pos][1][j])

    def _issue_single(self, sig, bidx, b, items, compression):
        """Reduce a one-key bucket without pack or unpack: the same
        collectives on the tensor's own shape (block-scaled ones on its
        flat elements)."""
        from .tpu_ici import _on_ring, _sum_levels

        vals = items[b.positions[0]][1]
        n, shape = len(vals), b.shapes[0]
        ctype = _ctype(compression)
        if not _on_ring(b.contexts):
            reduced = self._reduce_flat_fallback(
                sig, bidx, b, [v.reshape(-1) for v in vals], compression)
            for v in vals:
                _copy_into(reduced.view(shape), v)
            return
        if ctype in ("int8", "fp8"):
            outs = self._reduce_flat_blockwise_ring(
                sig, bidx, b, [v.reshape(-1) for v in vals], compression)
        elif ctype == "2bit":
            thr = compression["threshold"]
            levels = [self._quantize(sig, bidx, j, vals[j], thr)
                      for j in range(n)]
            outs = _sum_levels(levels, b.contexts, b.dtype, thr)
        else:
            outs = self._dense_ring(b.contexts, list(vals))
        for v, o in zip(vals, outs):
            _copy_into(o.view(shape), v)

    def _dense_ring(self, ctxs, tensors):
        """The ring's sum, with the integrity sideband in integrity
        mode."""
        from .tpu_ici import _collective_for, _integrity_sideband

        collective = _collective_for(ctxs)
        totals = collective.all_reduce(tensors, "sum")
        if self.integrity:
            totals, viol = _integrity_sideband(
                totals, self._flip_input(len(ctxs)), collective)
            self._violations.append(viol)
        return totals

    def _flip_input(self, n):
        """Each copy's flip for an integrity-mode reduce: zeros, unless a
        ``bitflip`` plan has an arrival due at ``collective.dispatch``;
        then ONE copy carries a seeded magnitude, drawn as the reference
        draws it (a string seed: sha512, never salted by the process)."""
        import random as _random

        from ..resilience import faultline as _faultline

        info = _faultline.poll_payload("collective.dispatch")
        if info is None:
            return [0.0] * n
        rng = _random.Random(f"bitflip:{int(info['seed'])}")
        mag = rng.uniform(1.0, 2.0) * (2.0 ** rng.randrange(0, 16))
        rank = info.get("rank")
        idx = (int(rank) if rank is not None else rng.randrange(n)) % n
        return [mag if j == idx else 0.0 for j in range(n)]

    def consume_integrity(self):
        """Read every integrity flag since the last call on the host and
        return how many launches disagreed (0 with integrity off or a
        clean step).  A nonzero count ticks
        ``mxtpu_integrity_violations_total{site="collective.dispatch"}``;
        the trainer's step guard then skips the update."""
        if not self._violations:
            return 0
        pending, self._violations = self._violations, []
        count = sum(1 for flags in pending
                    if any(bool(f.any()) for f in flags))
        if count:
            from ..resilience import sentinel as _sentinel

            _sentinel.integrity_violations_counter().labels(
                site="collective.dispatch").inc(count)
        return count

    def _reduce_flat_ring(self, sig, bidx, b, packed, compression):
        """The ring's reduce of the packed buffers, one result a copy on
        its device: the sum, 2bit's levels, or the block-scaled body."""
        from .tpu_ici import _sum_levels

        ctype = _ctype(compression)
        if ctype in ("int8", "fp8"):
            return self._reduce_flat_blockwise_ring(sig, bidx, b, packed,
                                                    compression)
        if ctype is None:
            return self._dense_ring(b.contexts, packed)
        thr = compression["threshold"]
        levels = [self._quantize(sig, bidx, j, flat, thr)
                  for j, flat in enumerate(packed)]
        return _sum_levels(levels, b.contexts, b.dtype, thr)

    def _reduce_flat_blockwise_ring(self, sig, bidx, b, flats,
                                    compression):
        """The block-scaled body over the copies' flat buffers, with the
        integrity sideband in integrity mode; the new residuals stored
        per (bucket, copy) on each copy's device."""
        from .tpu_ici import (_blockwise_body, _collective_for,
                              _integrity_sideband)

        collective = _collective_for(b.contexts)
        res = [self._residual_flat(sig, bidx, j, f)
               for j, f in enumerate(flats)]
        outs, new_res = _blockwise_body(flats, res, compression["type"],
                                        compression["block"], collective)
        if self.integrity:
            outs, viol = _integrity_sideband(
                outs, self._flip_input(len(flats)), collective)
            self._violations.append(viol)
        for j, r in enumerate(new_res):
            self._residuals[(sig, bidx, j)] = r
        return outs

    def _reduce_flat_fallback(self, sig, bidx, b, packed, compression):
        """Copies sharing a context (or an unmarked host tensor): no ring
        to ride, the reduce runs on the first copy's device (the store's
        fallback); block-scaled types take the body's collective-free
        twin."""
        from .tpu_ici import _blockwise_local, _sum_levels

        dev = packed[0].device
        ctype = _ctype(compression)
        if ctype in ("int8", "fp8"):
            res = [self._residual_flat(sig, bidx, j, f)
                   for j, f in enumerate(packed)]
            out, new_res = _blockwise_local(packed, res, ctype,
                                            compression["block"])
            for j, r in enumerate(new_res):
                self._residuals[(sig, bidx, j)] = r
            return out
        if ctype == "2bit":
            thr = compression["threshold"]
            levels = [self._quantize(sig, bidx, j, flat, thr)
                      for j, flat in enumerate(packed)]
            return _sum_levels(levels, b.contexts, b.dtype, thr)
        total = packed[0]
        for flat in packed[1:]:
            total = total + flat.to(dev)
        return total

    def _residual_flat(self, sig, bidx, j, flat):
        """The live residual of (bucket, copy) on ``flat``'s device and in
        its shape: stored, else adopted from a checkpoint, else zeros."""
        res = self._residuals.get((sig, bidx, j))
        if res is None:
            res = self._adopt_pending(sig, bidx, j, flat)
        if res is None:
            res = self._adopt_key_pending(sig, bidx, j, flat)
        if res is None:
            return torch.zeros_like(flat)
        return res.to(flat.device).view(flat.shape)

    def _quantize(self, sig, bidx, j, flat, thr):
        """2bit levels with one residual a (bucket, copy); the padding
        tail quantizes to level 0 and residual 0."""
        from .tpu_ici import _quantize_2bit

        lvl, res = _quantize_2bit(flat, self._residual_flat(sig, bidx, j,
                                                            flat), thr)
        self._residuals[(sig, bidx, j)] = res
        return lvl

    # -- checkpoint I/O ----------------------------------------------------
    # A signature holds contexts, which mean nothing after a restart; the
    # checkpoint keys residuals by a digest of the rest (keys, shapes,
    # dtype names, copy count), the reference's string exactly, and a
    # restore parks them until the next pushpull builds the plan they
    # belong to.
    @staticmethod
    def _sig_digest(sig):
        import hashlib

        context_free = tuple(
            (key, shape, dtype, len(ctxs), spec)
            for key, shape, dtype, ctxs, spec in sig)
        return hashlib.sha1(repr(context_free).encode()).hexdigest()

    def export_residuals(self):
        """``{(digest, bucket, copy): flat tensor}`` for every live
        residual, on its device (the checkpoint's gather copies them to
        the host with one synchronization)."""
        return {(self._sig_digest(sig), bidx, j): res.reshape(-1)
                for (sig, bidx, j), res in self._residuals.items()}

    def import_residuals(self, entries):
        """Park restored residuals (keyed as `export_residuals` keys
        them) for adoption at the next pushpull."""
        self._pending_residuals = dict(entries)

    def _adopt_pending(self, sig, bidx, j, flat):
        """A parked residual of (bucket, copy), if one of ``flat``'s
        element count and dtype is there.  The reference compares shapes,
        so a one-key 2bit bucket of a tensor of two or more dimensions
        (whose residual keeps the tensor's shape and is saved flat) drops
        its restored residual there (ROADMAP queue C15); here it is
        adopted."""
        if not self._pending_residuals:
            return None
        pending = self._pending_residuals.pop(
            (self._sig_digest(sig), bidx, j), None)
        if pending is None:
            return None
        pending = _as_tensor(pending)
        if pending.numel() != flat.numel() or pending.dtype != flat.dtype:
            return None  # the plan changed since the checkpoint: drop
        return pending.reshape(flat.shape)

    # -- the reshard's inputs (ROADMAP queue A7d) ------------------------------
    def export_layouts(self):
        """The context-free layout of every planned bucket, keyed by the
        digest `export_residuals` uses: per bucket, its keys and their
        (offset, size) segments.  JSON-safe (it rides the checkpoint's
        meta)."""
        return {self._sig_digest(sig): {"buckets": [
            {"keys": list(b.keys),
             "offsets": [int(o) for o in b.offsets],
             "sizes": [int(s) for s in b.sizes]}
            for b in plan]} for sig, plan in self._plans.items()}

    def import_key_residuals(self, per_key):
        """Park per-key residual totals (``{key: flat array}``, already
        summed over an old world's copies) for re-bucketing into this
        bucketer's plan: the next pushpull packs each key's segment into
        copy 0 of the bucket its plan gives the key."""
        self._pending_key_residuals = {
            k: _as_tensor(v).reshape(-1) for k, v in per_key.items()}

    def _adopt_key_pending(self, sig, bidx, j, flat):
        """Copy ``j``'s residual for bucket ``bidx`` from parked per-key
        totals.  Only copy 0 adopts (the totals are sums over the old
        copies); the padding and keys not parked (or resized) stay
        zero."""
        if j != 0 or not self._pending_key_residuals:
            return None
        plan = self._plans.get(sig)
        if plan is None or bidx >= len(plan):
            return None
        b = plan[bidx]
        out = torch.zeros(flat.numel(), dtype=flat.dtype)
        hit = False
        for key, off, size in zip(b.keys, b.offsets, b.sizes):
            pend = self._pending_key_residuals.get(key)
            if pend is None or pend.numel() != size:
                continue
            out[off:off + size] = pend.to(out.dtype)
            del self._pending_key_residuals[key]
            hit = True
        return out.view(flat.shape) if hit else None


def _as_tensor(a):
    """A checkpoint array (numpy, or a CPU tensor where numpy lacks the
    dtype) as a CPU tensor."""
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        onp.ascontiguousarray(a))
