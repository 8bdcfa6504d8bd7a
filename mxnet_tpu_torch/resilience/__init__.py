"""Resilience: deterministic fault injection, checkpoints, recovery
(counterpart of `mxnet_tpu/resilience/__init__.py`).

* :mod:`~mxnet_tpu_torch.resilience.faultline` — a deterministic, seeded
  fault-injection layer: a plan (``faultline.plan([...])`` or
  ``MXNET_FAULTLINE``) names a *site*, a *kind* and the arrival index at
  that site; the hooks at each site consult it, so chaos runs are
  reproducible bit for bit.
* :mod:`~mxnet_tpu_torch.resilience.checkpoint` — atomic (tmp + fsync +
  rename + manifest-with-checksum) per-host save/restore of the training
  state: params, optimizer states and update counts, the ``LossScaler``,
  the ``mx.random`` stream and the CPU ``torch.Generator`` that
  train-mode draws take their seeds from.  Async background writer,
  keep-last-K pruning, fallback to the previous checkpoint on
  corruption.  The files are the reference's: either package restores
  the other's.
* :mod:`~mxnet_tpu_torch.resilience.policies` — bounded exponential-
  backoff retry for transient faults, and abort-to-checkpoint when a
  peer is declared dead.
* :mod:`~mxnet_tpu_torch.resilience.sentinel` — straggler demotion and
  divergence rollback.

The reference's ``elastic`` module (``ElasticSupervisor``,
``ElasticWorld``, ``EmulatedPod``, ``scaled_lr``) rebuilds the kvstore,
the bucketer and the fused step for a survivor world; it waits for the
port's distribution layer (ROADMAP queue A7), and naming it raises.
"""
from __future__ import annotations

from . import faultline, sentinel
from .checkpoint import (CheckpointCorrupt, CheckpointManager,
                         CheckpointTopologyError, complete_steps,
                         gather_training_state, load_checkpoint,
                         restore_training_state, save_checkpoint)
from .faultline import (InjectedError, InjectedFault, InjectedFlaky,
                        InjectedPreemption, InjectedTimeout)
from .policies import (DeadNodeError, TRANSIENT_EXCEPTIONS,
                       abort_to_checkpoint, backoff_delay, check_peers,
                       fault_kind, retry_transient)
from .sentinel import (DegradedNodeError, DivergenceError,
                       DivergenceSentinel, StragglerPolicy)

__all__ = [
    "faultline", "sentinel",
    "InjectedFault", "InjectedTimeout", "InjectedError", "InjectedPreemption",
    "InjectedFlaky",
    "CheckpointManager", "CheckpointCorrupt", "CheckpointTopologyError",
    "save_checkpoint", "load_checkpoint", "complete_steps",
    "gather_training_state", "restore_training_state",
    "retry_transient", "abort_to_checkpoint", "check_peers",
    "backoff_delay", "fault_kind",
    "DeadNodeError", "TRANSIENT_EXCEPTIONS",
    "DegradedNodeError", "DivergenceError",
    "StragglerPolicy", "DivergenceSentinel",
]

_ELASTIC = ("elastic", "ElasticSupervisor", "ElasticWorld", "EmulatedPod",
            "scaled_lr")


def __getattr__(name):
    if name in _ELASTIC:
        raise NotImplementedError(
            f"resilience.{name} is the reference's elastic layer, which "
            "reshards onto a survivor world through the kvstore and the "
            "bucketer: ROADMAP queue A7 (distribution) in the port")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
