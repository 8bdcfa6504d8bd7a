"""``mxnet_tpu_torch.observe`` — flight recorder + postmortem dumps
(counterpart of `mxnet_tpu/observe/__init__.py`).

A bounded per-host ring of structured events (see ``flightrec``) and
atomic per-host dumps on terminal errors, signals or demand, in the
reference's format.
"""
from ..lockwitness import LockOrderViolation  # noqa: F401  (observability surface)
from .flightrec import (FlightRecorder, SCHEMA_VERSION, configure,
                        default_recorder, dump, enabled, events,
                        install_signal_handlers, record, reset,
                        set_generation, set_rank, set_step, snapshot,
                        uninstall_signal_handlers)

__all__ = ["FlightRecorder", "LockOrderViolation", "SCHEMA_VERSION",
           "configure", "default_recorder", "dump", "enabled", "events",
           "install_signal_handlers", "record", "reset",
           "set_generation", "set_rank", "set_step", "snapshot",
           "uninstall_signal_handlers"]
