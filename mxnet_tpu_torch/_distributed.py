"""Process bootstrap shared by package import and
`parallel.init_distributed` (counterpart of `mxnet_tpu/_distributed.py`).

`tools/launch.py` starts every worker of a job with the same three
variables as for the reference, so ``python tools/launch.py -n N
--launcher local -- python script.py`` starts port workers unchanged:

  JAX_COORDINATOR_ADDRESS   host:port of rank 0
  JAX_NUM_PROCESSES         N
  JAX_PROCESS_ID            0..N-1

`init_from_env` (run by the package's import) opens a
``torch.distributed.TCPStore`` at the coordinator's address, rank 0
serving it, and ``torch.distributed.init_process_group`` over it.  The
store stays in reach (`store`, `store_client`) for the heartbeat of
`kvstore.TPUICIStore`.

Each rank's device and the backend are decided before the group starts
(`choose`), from the world size and the visible cards, and logged once:

- ``MXNET_DIST_CONTEXT=cpu``, or no card visible: ``gloo`` on the CPU;
- at least N cards: rank ``r`` takes ``cuda:r % cards`` and ``nccl``;
- fewer cards than ranks: the ranks share the cards (``cuda:r % cards``)
  over ``gloo``, whose all-reduce and broadcast carry CUDA tensors
  through the host (NCCL refuses two ranks of one communicator on one
  card).

An NCCL error raises: ``gloo`` is never taken after ``nccl`` failed.
"""
from __future__ import annotations

import logging
import os
import warnings
from datetime import timedelta

_ENV_VARS = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
             "JAX_PROCESS_ID")
_STORE_TIMEOUT = timedelta(seconds=300)
_log = logging.getLogger(__name__)
# what init_from_env / init_group set up: the bootstrap's store, the
# coordinator's (host, port), the backend and this rank's device
_state = {"store": None, "address": None, "backend": None, "device": None}


def read_env():
    """Returns (coordinator_address, num_processes, process_id) from the
    launcher environment, or None if the env is absent or malformed (a
    malformed set warns rather than making the package unimportable)."""
    present = [v for v in _ENV_VARS if v in os.environ]
    if not present:
        return None
    if len(present) < len(_ENV_VARS):
        warnings.warn(
            f"incomplete multi-host environment: have {present}, need all "
            f"of {_ENV_VARS}; skipping torch.distributed bootstrap")
        return None
    try:
        return (os.environ["JAX_COORDINATOR_ADDRESS"],
                int(os.environ["JAX_NUM_PROCESSES"]),
                int(os.environ["JAX_PROCESS_ID"]))
    except ValueError:
        warnings.warn(
            "non-integer JAX_NUM_PROCESSES/JAX_PROCESS_ID; skipping "
            "torch.distributed bootstrap")
        return None


def choose(world, rank, cards, want_cpu=False):
    """``(backend, device)`` of ``rank`` in a world of ``world`` ranks on
    a machine with ``cards`` visible cards (see the module's rules)."""
    import torch

    if want_cpu or cards == 0:
        return "gloo", torch.device("cpu")
    device = torch.device("cuda", rank % cards)
    return ("nccl" if cards >= world else "gloo"), device


def init_from_env():
    """Start the process group from the launcher env if present.  Safe
    to call more than once; returns True if initialization ran."""
    spec = read_env()
    if spec is None:
        return False
    import torch.distributed as dist

    if dist.is_initialized():
        return False
    init_group(*spec)
    _maybe_profile_rank(spec[2])
    return True


def _split(address):
    host, _, port = address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator address {address!r} is not host:port")
    return host, int(port)


def init_group(coordinator_address, num_processes, process_id):
    """Open the store at ``coordinator_address`` (rank 0 serves it) and
    the process group over it, with the backend and device `choose`
    decides; a CUDA rank makes its card the current one."""
    import torch
    import torch.distributed as dist

    host, port = _split(coordinator_address)
    want_cpu = os.environ.get("MXNET_DIST_CONTEXT", "").lower() == "cpu"
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    backend, device = choose(num_processes, process_id, cards, want_cpu)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    store = dist.TCPStore(host, port, num_processes, process_id == 0,
                          timeout=_STORE_TIMEOUT)
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes)
    _state.update(store=store, address=(host, port), backend=backend,
                  device=device)
    _log.info("rank %d of %d: backend %s on %s (%d card(s) visible%s)",
              process_id, num_processes, backend, device, cards,
              ", MXNET_DIST_CONTEXT=cpu" if want_cpu else "")


def _up():
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def world():
    """(rank, world size) of the process group, else (0, 1)."""
    import torch.distributed as dist

    if _up():
        return int(dist.get_rank()), int(dist.get_world_size())
    return 0, 1


def backend():
    """The process group's backend (``"nccl"`` or ``"gloo"``), or None
    while no group is up."""
    import torch.distributed as dist

    if not _up():
        return None
    return _state["backend"] or dist.get_backend()


def device():
    """This rank's device as the bootstrap chose it, or None."""
    return _state["device"]


def store():
    """The bootstrap's ``TCPStore``, or None (no group, or a group that
    this module did not start)."""
    return _state["store"]


def store_client():
    """A new client connection to the bootstrap's store (for a thread of
    its own), or None."""
    if _state["address"] is None:
        return None
    import torch.distributed as dist

    host, port = _state["address"]
    return dist.TCPStore(host, port, is_master=False,
                         timeout=timedelta(seconds=30))


def _maybe_profile_rank(rank):
    """Remote-rank profiling: `tools/launch.py --profile-rank N
    [--profile-dir D]` sets MXNET_PROFILE_RANK / MXNET_PROFILE_DIR for
    every worker, and the matching rank starts the profiler here and
    dumps `D/profile_rank{N}.json` (chrome://tracing) at exit.
    MXNET_PROFILE_RANK=-1 profiles every rank."""
    want = os.environ.get("MXNET_PROFILE_RANK")
    if want is None:
        return
    try:
        want = int(want)
    except ValueError:
        # same warn-don't-crash contract as read_env(): a malformed env
        # var must not make the package unimportable
        warnings.warn(f"MXNET_PROFILE_RANK={want!r} is not an integer; "
                      "profiling request ignored")
        return
    if want != -1 and want != rank:
        return
    import atexit

    from . import profiler
    out_dir = os.environ.get("MXNET_PROFILE_DIR", ".")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"profile_rank{rank}.json")
    profiler.set_config(filename=path, profile_all=True)
    profiler.set_state("run")

    def _dump():
        try:
            profiler.set_state("stop")
            # write to the captured path directly: the training script may
            # have re-pointed the profiler's global filename at its own
            # trace, and the launcher-requested one must not clobber it
            with open(path, "w") as f:
                f.write(profiler.dumps(format="json"))
        except Exception as e:   # teardown must not fail the worker,
            warnings.warn(       # but silence would hide a lost trace
                f"profiler dump to {path} failed: {e}")
    atexit.register(_dump)
