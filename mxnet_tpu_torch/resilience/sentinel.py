"""sentinel: gray-failure detection and response (counterpart of
`mxnet_tpu/resilience/sentinel.py`: the same detectors, trip rules and
counters).

* **Straggler** — :class:`StragglerPolicy` watches per-rank step wall
  times: a rank whose EMA exceeds ``MXNET_SENTINEL_SLOW_FACTOR`` x the
  pod median for ``windows`` consecutive observations is DEGRADED, and
  the caller raises :class:`DegradedNodeError` (a
  :class:`~mxnet_tpu_torch.resilience.policies.DeadNodeError`
  subclass).  The reference's supervisor that reshards past it is
  ROADMAP queue A7 in the port.
* **Silent corruption** — the integrity sideband is the kvstore's
  (A7); this module owns the counter it ticks.
* **Divergence** — :class:`DivergenceSentinel` watches the loss the
  training loop already reads: a spike past
  ``MXNET_SENTINEL_LOSS_FACTOR`` x the warmed-up EMA (or a non-finite
  loss) trips a rollback to the newest complete checkpoint, bounded by
  ``MXNET_SENTINEL_ROLLBACKS`` before :class:`DivergenceError`
  surfaces.

Both detectors are host-side and deterministic: they consume numbers
the training loop already has (wall times, the loss it read) and add
no device round trip.
"""
from __future__ import annotations

from .. import env as _env
from .. import observe as _observe
from .. import telemetry as _telemetry
from ..base import MXNetError
from .policies import DeadNodeError

__all__ = [
    "DegradedNodeError", "DivergenceError",
    "StragglerPolicy", "DivergenceSentinel",
    "integrity_violations_counter", "rollbacks_counter",
    "degraded_counter", "steptime_ratio_gauge",
]


def integrity_violations_counter():
    """Counter for allreduce integrity-sideband trips: some device's
    digest of a bucket's psum result disagreed with the others — a
    payload bit flipped in flight (or was injected).  The step-guard
    suppressed that step's update, so a nonzero value means corruption
    was CAUGHT, not suffered."""
    return _telemetry.counter(
        "mxtpu_integrity_violations_total",
        "Bucketed-allreduce integrity sideband trips (per-device digest "
        "disagreement after the psum), by site — each one is a silently "
        "corrupted payload that was caught in-program and kept away "
        "from the optimizer",
        labelnames=("site",))


def rollbacks_counter():
    """Counter for divergence auto-rollbacks taken by the supervisor."""
    return _telemetry.counter(
        "mxtpu_sentinel_rollbacks_total",
        "Automatic rollbacks to the newest complete checkpoint after "
        "the DivergenceSentinel tripped (loss spike past the EMA "
        "factor, or non-finite loss); bounded by "
        "MXNET_SENTINEL_ROLLBACKS before DivergenceError surfaces")


def degraded_counter():
    """Counter for straggler demotions, by rank."""
    return _telemetry.counter(
        "mxtpu_node_degraded_total",
        "Ranks demoted by the StragglerPolicy (step-time EMA past "
        "MXNET_SENTINEL_SLOW_FACTOR x the pod median for consecutive "
        "observations) and resharded away like dead nodes",
        labelnames=("rank",))


def steptime_ratio_gauge():
    """Gauge: each rank's step-time EMA over the pod median — the
    number the demotion threshold is applied to.  ~1.0 is healthy; a
    rank pinned above the slow factor is about to be demoted."""
    return _telemetry.gauge(
        "mxtpu_steptime_ratio",
        "Per-rank step-time EMA over the pod-median EMA, from the "
        "StragglerPolicy's last observation window; sustained values "
        "above MXNET_SENTINEL_SLOW_FACTOR trigger demotion",
        labelnames=("rank",))


class DegradedNodeError(DeadNodeError):
    """A rank is alive per heartbeat but persistently too slow — the
    whole synchronous pod runs at its pace, so the supervisor demotes
    it to dead and reshards onto the survivors (the
    :class:`DeadNodeError` recovery path, verbatim)."""


class DivergenceError(MXNetError):
    """Training diverged and the rollback budget
    (``MXNET_SENTINEL_ROLLBACKS``) is exhausted: rolling back and
    re-running keeps reproducing the spike, so a human (or the
    launcher's own policy) has to look."""

    def __init__(self, loss, ema, rollbacks):
        super().__init__(
            f"divergence persists after {rollbacks} rollback(s): "
            f"loss {loss:g} vs EMA {ema:g}")
        self.loss = loss
        self.ema = ema
        self.rollbacks = rollbacks


class StragglerPolicy:
    """Declares a rank DEGRADED when its per-step wall time stays above
    ``factor`` x the pod median.

    Per-rank EMA (``alpha``) over the stamped step times, compared to
    the median of all live ranks' EMAs each observation window; a rank
    above ``factor`` x median increments its suspicion counter, a rank
    back under it resets it, and ``windows`` consecutive suspicious
    observations demote — the same two-observation shape as heartbeat
    death, so one GC pause or checkpoint flush never costs a reshard.
    """

    def __init__(self, factor=None, windows=2, alpha=0.5):
        self.factor = (_env.sentinel_slow_factor()
                       if factor is None else float(factor))
        self.windows = max(1, int(windows))
        self.alpha = float(alpha)
        self._ema = {}       # rank -> step-time EMA
        self._suspect = {}   # rank -> consecutive suspicious windows
        self._gauge = steptime_ratio_gauge()

    def reset(self):
        """Forget every EMA and suspicion count — called after a
        reshard (the survivor pod starts a fresh baseline; the dead
        rank's history must not leak into it)."""
        self._ema.clear()
        self._suspect.clear()

    def observe(self, times):
        """Fold one window of per-rank step times (``{rank: seconds}``)
        and return the ranks that just crossed the demotion threshold
        (usually ``[]``).  Ranks absent from ``times`` (no stamp yet)
        are skipped, not suspected — missing stamps are the liveness
        poller's problem."""
        import statistics

        for rank, t in times.items():
            t = float(t)
            prev = self._ema.get(rank)
            self._ema[rank] = t if prev is None else \
                self.alpha * t + (1.0 - self.alpha) * prev
        live = {r: self._ema[r] for r in times if r in self._ema}
        if len(live) < 2:
            return []
        median = statistics.median(live.values())
        degraded = []
        for rank, ema in live.items():
            ratio = ema / median if median > 0 else 1.0
            self._gauge.labels(rank=str(rank)).set(ratio)
            if median > 0 and ema > self.factor * median:
                n = self._suspect.get(rank, 0) + 1
                self._suspect[rank] = n
                if n == self.windows:
                    degraded.append(rank)
                    degraded_counter().labels(rank=str(rank)).inc()
                    _observe.record("sentinel", "straggler_demoted",
                                    rank=rank, ratio=ratio,
                                    windows=n, ema=ema, median=median)
            else:
                self._suspect[rank] = 0
        return sorted(degraded)


class DivergenceSentinel:
    """Trips when the loss the trainer already syncs spikes past
    ``factor`` x its warmed-up EMA, or goes non-finite.

    The EMA (``alpha``) warms up over the first ``warmup``
    observations without tripping (except on non-finite loss, which
    always trips); a tripping value is NOT folded into the EMA, so one
    spike cannot drag the baseline up and mask the next one."""

    def __init__(self, factor=None, warmup=3, alpha=0.3):
        self.factor = (_env.sentinel_loss_factor()
                       if factor is None else float(factor))
        self.warmup = max(1, int(warmup))
        self.alpha = float(alpha)
        self.ema = None
        self._seen = 0

    def reset(self):
        """Forget the EMA — called after a rollback (the restored
        trajectory re-warms its own baseline)."""
        self.ema = None
        self._seen = 0

    def observe(self, loss):
        """Fold one synced loss; return True when training just
        diverged (roll back now, before checkpointing this step)."""
        import math

        loss = float(loss)
        if not math.isfinite(loss):
            _observe.record("sentinel", "divergence_trip", loss=loss,
                            ema=self.ema, finite=False)
            return True
        if self.ema is not None and self._seen >= self.warmup \
                and loss > self.factor * self.ema:
            _observe.record("sentinel", "divergence_trip", loss=loss,
                            ema=self.ema, finite=True)
            return True
        self.ema = loss if self.ema is None else \
            self.alpha * loss + (1.0 - self.alpha) * self.ema
        self._seen += 1
        return False
