"""``kvstore='tpu_ici'``: the copies' reduction in one process
(counterpart of `mxnet_tpu/kvstore/tpu_ici.py`'s copies path).

The name is the reference's, and ``nccl``, ``dist_sync``,
``dist_device_sync`` and ``horovod`` are its aliases (`kvstore.create`).
Values arrive as a list of per-context copies of one gradient, as
``Trainer`` pushes them.  Whether a reduction rides a ring is decided by
the copies' **contexts** (`context.tensor_context`: a card tensor's
device, the mark `split_and_load` and `Parameter.grad` put on a host
tensor), not by ``tensor.device``, since every host copy says ``cpu``:

- copies on distinct known contexts ride the ring: each copy's result
  is computed and left on its own device, with the collective the
  contexts allow (`_collective_for`): one ``torch.cuda.nccl``
  all-reduce where every copy lies on a card of its own, else an
  in-process reduction of the list in copy-index order on the first
  copy's device (host copies ``cpu(0..3)``, or a card copy beside a
  host copy), as the reference's four host devices take its psum;
- copies on one context, or an unmarked host tensor among them: the
  fallback, a plain sum in index order on the first copy's device,
  written back to each copy (the reference's fallback branch).

Gradient compression with error feedback (`set_gradient_compression`,
the reference's types and error text): ``2bit`` quantizes each copy to
levels {-1, 0, +1} against a threshold and sums the levels; ``int8`` and
``fp8`` are block-scaled, with one scale per ``MXNET_KVSTORE_QBLOCK``
elements agreed across the copies by a MAX of their block maxima, so
the quantized payloads sum exactly (`_blockwise_body`).  Each keeps the
quantization error as a residual per (key, copy), added back at the next
reduce, reset where its shape, dtype or context changed
(`_residual_matches`).  The math is plain torch ops, as the reference's
is ``jnp`` code that XLA fuses.

Each ``pushpull`` runs inside the transient-fault retry policy, with the
``kvstore.pushpull`` fault site and a ``collective_span`` around the
reduction (``allreduce``; ``allreduce_2bit`` at a quarter of the bytes,
``allreduce_int8`` / ``allreduce_fp8`` at half), as in the reference.
``pushpull_list`` reduces the bucketable values through a
`bucketing.GradBucketer` (one collective a size-capped bucket; the
integrity sideband rides there), ``MXNET_KVSTORE_BUCKETING=0`` key by
key.

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

Row-sparse values are ROADMAP queue A item A10.
"""
from __future__ import annotations

import os
import threading
import time

import torch

from .. import _distributed
from .. import observe as _observe
from ..base import MXNetError
from ..context import mark_context, tensor_context
from ..telemetry import collective_span as _collective_span
from .base import KVStoreBase, _as_list, _copy_into

__all__ = ["TPUICIStore", "SUPPORTED_COMPRESSION", "DEFAULT_QBLOCK",
           "qblock_size"]


def _payload_bytes(vals):
    """The collective's payload: the bytes of every copy."""
    return sum(v.numel() * v.element_size() for v in vals)


# -- where a reduction runs ----------------------------------------------------

def _value_contexts(vals):
    """The context each copy belongs to (None: an unmarked host tensor)."""
    return [tensor_context(v) for v in vals]


def _on_ring(ctxs):
    """Whether copies on ``ctxs`` ride the ring: every context known and
    each copy on one of its own."""
    return None not in ctxs and len(set(ctxs)) == len(ctxs)


# ncclRedOp_t values (torch.cuda.nccl names only SUM)
_NCCL_OPS = {"sum": 0, "max": 2}


class _NcclCollective:
    """All-reduce over copies each on a card of its own: one
    ``torch.cuda.nccl.all_reduce`` a call, each card's result on that
    card.  The cards' streams run NCCL calls in issue order, so the
    reference's launch-chain token and host fence (workarounds for XLA's
    emulated collectives) have no counterpart here."""

    @staticmethod
    def all_reduce(tensors, op):
        outs = [t.clone(memory_format=torch.contiguous_format)
                for t in tensors]
        torch.cuda.nccl.all_reduce(outs, op=_NCCL_OPS[op])
        return outs


class _ListCollective:
    """All-reduce over copies on distinct contexts that NCCL cannot
    join (host copies, a card copy beside a host copy): the list reduced
    in copy-index order on the first copy's device, and the result copied
    to every copy's device (each copy its own tensor).  A sum of 16-bit
    floats accumulates in f32 and rounds once, as XLA's all-reduce over
    the reference's host devices does (fp8's bf16 partials then agree
    with the reference bitwise)."""

    @staticmethod
    def all_reduce(tensors, op):
        first = tensors[0]
        wide = op == "sum" and first.dtype in (torch.bfloat16,
                                                torch.float16)
        total = first.float() if wide else first
        for t in tensors[1:]:
            t = t.to(first.device)
            if wide:
                total = total + t.float()
            elif op == "sum":
                total = total + t
            else:
                total = torch.maximum(total, t)
        total = total.to(first.dtype)
        return [total.to(t.device, copy=True) for t in tensors]


def _collective_for(ctxs):
    """NCCL where every copy lies on a card of its own, else the
    in-process list reduction."""
    if all(c.type == "cuda" for c in ctxs):
        return _NcclCollective
    return _ListCollective


def _residual_matches(res, data):
    """An error-feedback residual holds only for the tensor it was
    recorded against: the same shape and dtype and, where both say it,
    the same context (a copy moved by `reset_ctx` resets it).  A residual
    restored from a checkpoint carries no context and gates on shape and
    dtype only."""
    if tuple(res.shape) != tuple(data.shape) or res.dtype != data.dtype:
        return False
    a, b = tensor_context(res), tensor_context(data)
    return a is None or b is None or a == b


def _like(value, tensor):
    """``value`` (a python float) as a 0-dim tensor of ``tensor``'s dtype
    on its device, as the reference's weak-typed scalars take the
    array's dtype (filled on the device: no copy from the host)."""
    return torch.full((), value, dtype=tensor.dtype, device=tensor.device)


def _quantize_2bit(x, residual, threshold):
    """The reference's 2-bit compression: ``x + residual`` to levels
    {-1, 0, +1} against ``threshold`` (scaled by it after the sum), the
    error kept as the new residual.  Returns (int8 levels, residual)."""
    acc = x + residual
    thr = _like(threshold, acc)
    lvl = torch.where(acc >= thr, 1,
                      torch.where(acc <= -thr, -1, 0)).to(torch.int8)
    return lvl, acc - lvl.to(acc.dtype) * thr


def _sum_levels(levels, ctxs, dtype, threshold):
    """The dequantized sum of the copies' 2bit levels (``dtype`` times
    the threshold in ``dtype``): on the ring one result a copy, the
    levels summed as int8 while n x 1 fits, int32 past 127 copies (NCCL
    has no int16, the reference's type there); else one tensor, summed
    as int32 on the first copy's device."""
    if _on_ring(ctxs):
        acc = torch.int8 if len(levels) <= 127 else torch.int32
        totals = _collective_for(ctxs).all_reduce(
            [lvl.to(acc) for lvl in levels], "sum")
        outs = [t.to(dtype) for t in totals]
        return [o * _like(threshold, o) for o in outs]
    total = levels[0].to(torch.int32)
    for lvl in levels[1:]:
        total = total + lvl.to(levels[0].device).to(torch.int32)
    out = total.to(dtype)
    return out * _like(threshold, out)


# -- block-scaled int8/fp8 ----------------------------------------------------

#: Gradient compression types ``set_gradient_compression`` accepts.
SUPPORTED_COMPRESSION = ("2bit", "int8", "fp8")

#: Largest quantized magnitude per block-scaled type (int8: symmetric 127;
#: fp8 e4m3: 448, the format's finite max).
_QMAX = {"int8": 127.0, "fp8": 448.0}

DEFAULT_QBLOCK = 256


def qblock_size():
    """Scale-block size in elements for block-scaled int8/fp8
    compression (``MXNET_KVSTORE_QBLOCK``, default 256): 256 f32 elements
    are 1 KB, so the 64 KB bucket-capacity quantum holds whole blocks."""
    return max(1, int(os.environ.get("MXNET_KVSTORE_QBLOCK",
                                     DEFAULT_QBLOCK)))


def _blockwise_qparams(qtype, n_copies):
    """``(qmax, wire dtype, sum dtype)`` for a variant.

    The reference sums int8 payloads as int16 partials; NCCL has no
    int16, so they sum as f16 while ``n x 127 <= 2048``, up to 16 copies:
    every partial sum is then an integer f16 holds exactly, so the result
    is bitwise the int16 sum.  Past 16 copies they sum as int32 (exact,
    twice the bytes).  fp8 payloads widen to bf16 partials, as in the
    reference."""
    if qtype == "int8":
        acc = torch.float16 if n_copies <= 16 else torch.int32
        return _QMAX["int8"], torch.int8, acc
    if qtype == "fp8":
        return _QMAX["fp8"], torch.float8_e4m3fn, torch.bfloat16
    raise MXNetError(f"no block-scaled compression type {qtype!r}")


def _blockwise_layout(numel, block):
    """``(n_blocks, pad)`` covering ``numel`` elements with whole
    ``block``-element scale blocks (the tail block zero-padded)."""
    nblk = -(-numel // block)
    return nblk, nblk * block - numel


def _blockwise_body(gs, rs, qtype, block, collective):
    """The block-scaled reduce over copies: ``gs`` and ``rs`` are each
    copy's flat gradient and residual (one dtype, each on its copy's
    device), ``collective`` the all-reduce the copies ride (a SUM and a
    MAX over a list, each result left on its copy's device).  Returns
    ``(outs, new residuals)``, one of each a copy, in the gradient's
    dtype on its device.

    Copies scaled independently cannot share a sum, so the scale is
    agreed first: a MAX of each copy's per-block amax (a sideband of
    1/block of the payload) gives every copy the same scale, and the
    quantized payloads then sum exactly in the widened type.  A zero-amax
    block keeps scale 1, so 0/0 never happens and a zero-padded tail
    stays zero through quantize, sum and residual.  Rounding follows what
    XLA makes of the reference's code: the scale is the block maximum
    times the f32 reciprocal of qmax, round half to even, clip to +-qmax before the cast (the
    fp8 cast does not saturate), and the residual ``blocks - q x scale``
    rounded once, as the fused multiply-subtract XLA emits: the product
    and the difference are exact in f64 (q has at most 8 significant
    bits, the scale 24, and q x scale lies within a factor of two of the
    block's value), so one rounding to f32 remains."""
    n, numel = len(gs), gs[0].numel()
    out_dtype = gs[0].dtype
    qmax, wire, acc_dt = _blockwise_qparams(qtype, n)
    nblk, pad = _blockwise_layout(numel, block)
    blocks = []
    for g, r in zip(gs, rs):
        # one program in the reference: XLA keeps the 16-bit sum in f32
        # (excess precision), so the sum is taken in f32 here
        accf = (g.to(torch.float32) + r.to(torch.float32)).reshape(-1)
        if pad:
            accf = torch.nn.functional.pad(accf, (0, pad))
        blocks.append(accf.reshape(nblk, block))
    gmaxes = collective.all_reduce(
        [b.abs().amax(dim=1) for b in blocks], "max")
    qs, scales = [], []
    for b, gmax in zip(blocks, gmaxes):
        # XLA turns the reference's division by the constant qmax into
        # a multiplication by its f32 reciprocal; so does this
        scale = torch.where(gmax > 0, gmax * _like(1.0 / qmax, gmax),
                            _like(1.0, gmax))
        q = b / scale[:, None]
        if qtype == "int8":
            q = torch.round(q)
        qs.append(q.clamp(-qmax, qmax).to(wire))
        scales.append(scale)
    totals = collective.all_reduce([q.to(acc_dt) for q in qs], "sum")
    outs, new_res = [], []
    for b, q, scale, total in zip(blocks, qs, scales, totals):
        outs.append((total.to(torch.float32) * scale[:, None])
                    .reshape(-1)[:numel].to(out_dtype))
        res = b.double() - q.double() * scale.double()[:, None]
        new_res.append(res.to(torch.float32).reshape(-1)[:numel]
                       .to(out_dtype))
    return outs, new_res


def _blockwise_local(gs, rs, qtype, block):
    """The collective-free twin of `_blockwise_body` for copies that
    share a context (or an unmarked host tensor): every copy moved to the
    first one's device and reduced there by the same math, so the twin
    and the ring agree bitwise.  Returns ``(reduced, new residuals)``."""
    dev = gs[0].device
    outs, new_res = _blockwise_body([g.to(dev) for g in gs],
                                    [r.to(dev) for r in rs], qtype, block,
                                    _ListCollective)
    return outs[0], new_res


# -- the integrity sideband ---------------------------------------------------

_I32 = 1 << 32


def _wrap_i32(x):
    """int64 tensor ``x`` mod 2^32 as a signed int32 value (in int64)."""
    return torch.remainder(x + (1 << 31), _I32) - (1 << 31)


def _digest(total):
    """The wrapping int32 sum of ``total``'s f32 bit patterns (a 0-dim
    int64 tensor holding an int32 value): the reference's
    ``jnp.sum(bitcast(total.astype(f32), int32), dtype=int32)``."""
    bits = total.reshape(-1).to(torch.float32).view(torch.int32)
    return _wrap_i32(bits.sum(dtype=torch.int64))


def _integrity_sideband(totals, flips, collective):
    """The integrity check (``MXNET_KVSTORE_INTEGRITY=1``) on the copies'
    results of one reduce: ``flips[j]`` (0.0 = clean; a chaos plan puts a
    seeded magnitude on one copy, a payload bit flipped in flight) is
    added to element 0 of copy j's result, then each copy's digest is
    agreement-checked with ONE MAX over ``[d, -d]`` (max and -min), the
    negation wrapping at INT32_MIN as jax's does.  Returns ``(totals,
    violation)``, the violation an int32 flag a copy on its device."""
    digests = []
    for t, f in zip(totals, flips):
        if f != 0.0:
            flat = t.view(-1)
            flat[0] = flat[0] + torch.tensor(
                f, dtype=torch.float32).to(t.dtype)
        d = _digest(t)
        digests.append(torch.stack([d, _wrap_i32(-d)]).to(torch.int32))
    viol = [(m[0].to(torch.int64) != _wrap_i32(-m[1].to(torch.int64)))
            .to(torch.int32) for m in collective.all_reduce(digests, "max")]
    return totals, viol


@KVStoreBase.register
class TPUICIStore(KVStoreBase):
    def __init__(self):
        self._rank, self._size = _distributed.world()
        _observe.set_rank(self._rank)
        self._compression = None
        self._residuals = {}      # (key, copy) -> error-feedback residual
        self._bucketer = None
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

    def consume_integrity_violations(self):
        """The bucketer's integrity flags since the last call, read on
        the host (`GradBucketer.consume_integrity`): 0 when nothing was
        bucketed or integrity mode is off.  The trainer's step guard
        calls it once a step."""
        if self._bucketer is None:
            return 0
        return self._bucketer.consume_integrity()

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
        """Turn on gradient compression with error feedback (the
        reference's `set_gradient_compression`):

        * ``{'type': '2bit', 'threshold': t}`` (default 0.5): levels
          {-1, 0, +1} ride as int8, a quarter of the f32 bytes;
        * ``{'type': 'int8'}`` / ``{'type': 'fp8'}``: block-scaled, one
          scale per ``MXNET_KVSTORE_QBLOCK`` elements (``'block'``
          overrides it) agreed by a MAX across the copies, the payload
          summed as 2-byte partials, half the f32 bytes.

        Either applies to the reduce over copies; a single value (a
        rank's own, already summed in its step) is left as it is.  The
        residuals start from zero."""
        ctype = compression_params.get("type", "2bit")
        if ctype not in SUPPORTED_COMPRESSION:
            raise MXNetError(
                f"unsupported gradient compression type {ctype!r}: "
                f"supported types are "
                f"{', '.join(repr(t) for t in SUPPORTED_COMPRESSION)} "
                f"(docs/DESIGN.md \"Block-scaled quantized allreduce\")")
        if ctype == "2bit":
            self._compression = {
                "type": "2bit",
                "threshold": float(compression_params.get("threshold", 0.5)),
            }
        else:
            self._compression = {
                "type": ctype,
                "block": int(compression_params.get("block",
                                                    qblock_size())),
            }
        self._residuals = {}

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
        _check_dense(vals)
        if len(vals) == 1:
            reduced = vals[0]          # one copy: its own sum
        elif self._compression is not None:
            ctype = self._compression["type"]
            # 2bit levels ride as int8 (a quarter of the f32 bytes);
            # block-scaled int8/fp8 as 2-byte partials (half)
            shrink = 4 if ctype == "2bit" else 2
            with _collective_span(f"allreduce_{ctype}",
                                  _payload_bytes(vals) // shrink):
                reduced = self._reduce_compressed(key, vals)
        else:
            with _collective_span("allreduce", _payload_bytes(vals)):
                reduced = self._reduce_copies(vals)
        targets = vals if out is None else _as_list(out)
        if isinstance(reduced, list):
            # each copy's result, written on its own device
            for o, r in zip(targets, reduced):
                _copy_into(r, o)
            return
        for o in targets:
            _copy_into(reduced, o)

    def pushpull_list(self, pairs):
        """Reduce many keys in place in the caller's order, the values of
        two or more dense copies through the store's `GradBucketer` (one
        collective a size-capped bucket, compressed as the store is); a
        single value keeps the per-key path.  ``MXNET_KVSTORE_BUCKETING=0``
        reduces key by key."""
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
            self._bucketer.pushpull(bucketable,
                                    compression=self._compression)

    def _stored_residual(self, key, i, v):
        """Copy ``i``'s residual for ``key`` on ``v``'s device, zeros
        where none is stored or it no longer matches ``v``."""
        res = self._residuals.get((key, i))
        if res is None or not _residual_matches(res, v):
            return torch.zeros_like(v)
        return res.to(v.device)

    def _reduce_compressed(self, key, vals):
        """Quantize each copy on its own device against its residual
        (stored back per (key, copy), marked with the copy's context) and
        sum the levels: on the ring one list of per-copy results, else
        one tensor on the first copy's device."""
        if self._compression["type"] != "2bit":
            return self._reduce_blockwise(key, vals)
        thr = self._compression["threshold"]
        ctxs = _value_contexts(vals)
        levels = []
        for i, v in enumerate(vals):
            lvl, res = _quantize_2bit(v, self._stored_residual(key, i, v),
                                      thr)
            self._residuals[(key, i)] = _mark(res, ctxs[i])
            levels.append(lvl)
        return _sum_levels(levels, ctxs, vals[0].dtype, thr)

    def _reduce_blockwise(self, key, vals):
        """The per-key block-scaled int8/fp8 reduce: every copy's flat
        gradient and residual through `_blockwise_body` on the ring (its
        twin off it), the new residual stored per (key, copy) in the
        value's shape and dtype."""
        ctype, block = self._compression["type"], self._compression["block"]
        shape = tuple(vals[0].shape)
        ctxs = _value_contexts(vals)
        flats = [v.reshape(-1) for v in vals]
        res_flats = [self._stored_residual(key, i, v).reshape(-1)
                     for i, v in enumerate(vals)]
        if not _on_ring(ctxs):
            out, new_res = _blockwise_local(flats, res_flats, ctype, block)
            for i in range(len(vals)):
                self._residuals[(key, i)] = new_res[i].reshape(shape)
            return out.reshape(shape)
        outs, new_res = _blockwise_body(flats, res_flats, ctype, block,
                                        _collective_for(ctxs))
        for i in range(len(vals)):
            self._residuals[(key, i)] = _mark(new_res[i].reshape(shape),
                                              ctxs[i])
        return [o.reshape(shape) for o in outs]

    @staticmethod
    def _reduce_copies(vals):
        """The sum of the copies: on the ring one list of per-copy sums,
        else one tensor summed in index order on the first copy's
        device."""
        ctxs = _value_contexts(vals)
        if _on_ring(ctxs):
            return _collective_for(ctxs).all_reduce(vals, "sum")
        total = vals[0]
        for v in vals[1:]:
            total = total + v.to(vals[0].device)
        return total

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


def _check_dense(vals):
    if any(v.layout != torch.strided for v in vals):
        raise NotImplementedError(
            "row-sparse kvstore values wait for the port's row-sparse "
            "arrays (ROADMAP queue A item A10)")


def _mark(tensor, ctx):
    """``tensor`` marked with context ``ctx`` (a host tensor carries its
    copy's context as a mark)."""
    return tensor if ctx is None else mark_context(tensor, ctx)
