"""Recovery policies: bounded retry, abort-to-checkpoint (counterpart of
`mxnet_tpu/resilience/policies.py`).

Three failure classes, three policies (docs/RESILIENCE.md):

* **Transient** (KV timeouts, collective deadline misses, injected
  ``timeout`` faults): :func:`retry_transient` — capped exponential
  backoff, ``MXNET_KVSTORE_RETRIES`` attempts, every survived fault
  ticks ``mxtpu_faults_recovered_total``.
* **Poisoned step** (inf/nan gradients after a loss blow-up): the
  finite-grad step-guard inside ``FusedTrainStep``/``Trainer.step`` —
  not here; it lives in the step (in a captured step, on the card) to
  avoid a host sync.
* **Fatal** (a peer's heartbeat went stale): :func:`check_peers` /
  :func:`abort_to_checkpoint` — flush the checkpoint manager and raise
  :class:`DeadNodeError` so the launcher can restart the job against
  the surviving hosts; resumption costs one checkpoint interval, not
  the run.  Without a ``store``, or with one rank, :func:`check_peers`
  finds no peer dead, as the reference does with a single rank; across
  ranks it asks ``TPUICIStore.get_dead_nodes``.
"""
from __future__ import annotations

import time

from .. import _distributed
from .. import observe as _observe
from ..base import MXNetError
from . import faultline

__all__ = ["TRANSIENT_EXCEPTIONS", "retry_transient", "DeadNodeError",
           "check_peers", "abort_to_checkpoint", "kv_retries",
           "step_skip_counter", "backoff_delay", "fault_kind"]

# the transient class: deadline misses and connection hiccups.  Real
# execution errors (CUDA, a kernel's) are NOT here — retrying a poisoned
# step re-poisons it; those surface immediately.
TRANSIENT_EXCEPTIONS = (TimeoutError, ConnectionError)


def kv_retries():
    """Retry budget for transient KV/collective faults
    (``MXNET_KVSTORE_RETRIES``, default 3 = up to 4 attempts total)."""
    import os

    return int(os.environ.get("MXNET_KVSTORE_RETRIES", "3"))


def _retries_counter():
    from .. import telemetry as _telemetry

    return _telemetry.counter(
        "mxtpu_kvstore_retries_total",
        "Transient-fault retries taken by the bounded-backoff policy, "
        "by site — a steadily rising value means the coordination KV or "
        "the interconnect is flapping",
        labelnames=("site",))


def step_skip_counter():
    """Counter for steps the finite-grad step-guard held back: the
    optimizer update was suppressed (params/states/aux bitwise intact)
    because a gradient came back inf/nan — loss blow-up or an injected
    ``nan_grad`` fault."""
    from .. import telemetry as _telemetry

    return _telemetry.counter(
        "mxtpu_train_steps_skipped_total",
        "Training steps whose optimizer update was skipped by the "
        "finite-grad step-guard (non-finite gradients: loss overflow or "
        "injected nan_grad); parameters and optimizer state were left "
        "bitwise untouched and the loss scaler backed off")


def backoff_delay(attempt, base_delay=0.05, max_delay=2.0, rank=None):
    """The capped exponential delay for retry ``attempt`` (0-based) with
    deterministic per-rank jitter: the base ``min(max, base*2^k)``
    schedule scaled by a factor in [0.5, 1.0] derived ONLY from
    (rank, attempt).  Without it every host in the pod sleeps the
    identical schedule and a flapping coordinator eats a synchronized
    retry storm; with it the schedules decorrelate while each host
    stays bit-reproducible run to run."""
    import random as _random

    if rank is None:
        rank = _distributed.world()[0]
    # string seed -> deterministic sha512 path, never process-salted
    rng = _random.Random(f"backoff:{int(rank)}:{int(attempt)}")
    jitter = 0.5 + 0.5 * rng.random()
    return min(max_delay, base_delay * (2 ** attempt)) * jitter


def fault_kind(e):
    """Map an exception to the recovery-counter kind: an explicit
    ``.kind`` (faultline's injected classes) wins; otherwise a
    ``ConnectionError`` is a flaky link, anything else transient is a
    deadline miss — so the counters tell the two gray classes apart."""
    kind = getattr(e, "kind", None)
    if kind is not None:
        return kind
    return "flaky" if isinstance(e, ConnectionError) else "timeout"


def retry_transient(fn, site, retries=None, base_delay=0.05, max_delay=2.0,
                    retry_on=TRANSIENT_EXCEPTIONS, sleep=time.sleep,
                    rank=None):
    """Call ``fn()``; on a transient exception retry up to ``retries``
    times with capped, per-rank-jittered exponential backoff
    (:func:`backoff_delay`).  A retry that then succeeds ticks
    ``mxtpu_faults_recovered_total{site,kind}`` with the kind from
    :func:`fault_kind`; exhausting the budget re-raises the last
    exception."""
    if retries is None:
        retries = kv_retries()
    attempt = 0
    while True:
        try:
            out = fn()
        except retry_on as e:
            if attempt >= retries:
                raise
            delay = backoff_delay(attempt, base_delay, max_delay, rank)
            attempt += 1
            _retries_counter().labels(site=site).inc()
            last_kind = fault_kind(e)
            sleep(delay)
            continue
        if attempt:
            faultline.recovered(site, last_kind)
        return out


class DeadNodeError(MXNetError):
    """A peer's heartbeat went stale past tolerance; the job must fall
    back to its last checkpoint (``.ranks`` names the dead peers,
    ``.checkpoint_step`` the committed step to resume from)."""

    def __init__(self, ranks, checkpoint_step=None):
        ranks = sorted(ranks)
        super().__init__(
            f"dead nodes detected (ranks {ranks}); "
            + (f"resume from checkpoint step {checkpoint_step}"
               if checkpoint_step is not None
               else "no checkpoint committed yet"))
        self.ranks = ranks
        self.checkpoint_step = checkpoint_step


def _survivor_ranks(store, dead):
    """The ranks that will restore together after ``dead`` are dropped —
    the rank set ``restore_latest(ranks=...)`` validates against.  From
    the pod's explicit rank tuple (``EmulatedPod.ranks``) or the store's
    world size; None when the store exposes neither."""
    ranks = getattr(store, "ranks", None)
    if ranks is None:
        size = getattr(store, "num_workers", None)
        if size is None:
            return None
        ranks = range(int(size))
    return [int(r) for r in ranks if int(r) not in set(dead)]


def check_peers(store=None, manager=None, timeout=60):
    """Poll ``store.get_dead_nodes`` and, when it fires, abort to the
    last checkpoint: flush ``manager``'s queued writes and raise
    :class:`DeadNodeError`.  Returns ``[]`` when all peers are live —
    cheap enough to call every N steps from a training loop.  Without a
    ``store`` (one rank) there is no peer, and it returns ``[]``."""
    if store is None:
        return []
    dead = store.get_dead_nodes(timeout=timeout)
    if not dead:
        return []
    abort_to_checkpoint(dead, manager, ranks=_survivor_ranks(store, dead))


def abort_to_checkpoint(dead_ranks, manager=None, ranks=None,
                        error_cls=DeadNodeError):
    """Flush the checkpoint manager (the last snapshot must actually be
    on disk before the process gives up) and raise ``error_cls`` (a
    :class:`DeadNodeError` — the sentinel passes its
    ``DegradedNodeError`` subclass) for the launcher to act on.

    ``checkpoint_step`` is the newest step COMPLETE across ``ranks``
    (``complete_steps``) — a host that died mid-save leaves its newest
    step torn, and ``latest_step`` would name a checkpoint
    ``restore_latest`` then refuses to load.  Without a rank set the
    torn-save-blind ``latest_step`` is still reported (single-host
    callers, where torn == corrupt and restore falls back anyway)."""
    from .checkpoint import complete_steps, latest_step

    step = None
    if manager is not None:
        try:
            manager.wait()
        finally:
            if ranks:
                steps = complete_steps(manager.root, ranks)
                step = steps[-1] if steps else None
            else:
                step = latest_step(manager.root)
    # the black box's primary trigger: record the terminal transition and
    # flush the flight record to disk BEFORE the error unwinds the stack
    _observe.record("terminal", error_cls.__name__,
                    dead_ranks=sorted(dead_ranks),
                    checkpoint_step=step)
    _observe.dump(reason=error_cls.__name__,
                  root=manager.root if manager is not None else None)
    raise error_cls(dead_ranks, checkpoint_step=step)
