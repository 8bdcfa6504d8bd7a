"""Meshes over ranks (counterpart of `mxnet_tpu/parallel/mesh.py`).

The reference's mesh is a grid of devices that one XLA program spans;
the port's is a grid of ranks, one device a rank, each rank a process of
a ``torch.distributed`` group (`tools/launch.py` starts them).  A mesh
over several devices of one process has no meaning here and raises.

Data parallelism is what the port runs over a mesh: `global_put` hands
each rank its rows of a global batch, `shard_parameters` replicates
parameters by a broadcast from rank 0, and `gluon.FusedTrainStep(mesh=)`
sums the gradients across the group inside its step.  A spec that
shards a parameter along any axis (tensor, sequence or pipeline
parallelism) is ROADMAP queue A item A8 and raises.

Inside `mesh_scope` of a mesh of more than one rank, with a process
group up, BatchNorm's statistics are global across the ranks
(`sync_size`): `FusedTrainStep` enters that scope around its step, as
the reference's one program sees the global batch.
"""
from __future__ import annotations

import logging
import re
import threading

import numpy as onp

from .. import _distributed

__all__ = [
    "Mesh", "NamedSharding", "PartitionSpec", "RuleCoverage", "make_mesh",
    "current_mesh", "mesh_scope", "data_sharding", "replicated_sharding",
    "match_partition_rules", "shard_parameters", "global_put", "constrain",
    "init_distributed", "sync_size",
]

_state = threading.local()
_log = logging.getLogger(__name__)


class PartitionSpec(tuple):
    """One entry a dimension: an axis name, a tuple of names, or None
    (not sharded); ``PartitionSpec()`` replicates."""

    def __new__(cls, *partitions):
        return super().__new__(cls, partitions)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


class Mesh:
    """Ranks laid out on named axes: ``devices`` a numpy array of rank
    numbers of shape ``tuple(shape.values())``."""

    def __init__(self, devices, axis_names):
        self.devices = onp.asarray(devices)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d devices for axes "
                             f"{self.axis_names}")

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    def coords(self, rank):
        """``{axis: index}`` of ``rank`` in the mesh."""
        where = onp.argwhere(self.devices == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in mesh {self.shape}")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def __repr__(self):
        return f"Mesh({self.shape})"


class NamedSharding:
    """A mesh and a `PartitionSpec`."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def _ranks(devices):
    """Rank numbers from ``devices``: None is the world's ranks; several
    devices of this process (anything but rank numbers) raise."""
    rank, world = _distributed.world()
    if devices is None:
        return list(range(world))
    devices = list(devices)
    if all(isinstance(d, (int, onp.integer)) for d in devices):
        return [int(d) for d in devices]
    if len(devices) == 1:
        return [rank]            # this process's one device
    raise ValueError(
        f"a mesh over {len(devices)} devices of one process: the port runs "
        "one device a rank; start one process a device with "
        "tools/launch.py -n N --launcher local -- python script.py")


def make_mesh(axes=None, devices=None):
    """Create a Mesh.  ``axes`` maps axis name -> size; sizes may use -1 once
    to absorb the remaining ranks.  Default: 1-d data-parallel mesh over
    every rank: ``make_mesh({'dp': -1})``.  ``devices``: rank numbers
    (default: the world's)."""
    ranks = _ranks(devices)
    if axes is None:
        axes = {"dp": -1}
    names = list(axes)
    sizes = list(axes.values())
    n = len(ranks)
    if sizes.count(-1) > 1:
        raise ValueError(
            f"mesh {dict(zip(names, sizes))}: at most one axis may be -1")
    if -1 in sizes:
        known = 1
        for sz in sizes:
            if sz != -1:
                known *= sz
        if known > n or n % known:
            raise ValueError(
                f"mesh {dict(zip(names, sizes))}: the explicit axes "
                f"({known}) must divide the device count ({n}) for -1 to "
                "absorb the remainder")
        sizes[sizes.index(-1)] = n // known
    total = 1
    for s in sizes:
        total *= s
    if total > n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} "
                         f"devices, have {n}")
    # a typo'd recipe (`dp2` on 8 ranks) otherwise trains at quarter speed
    # with no visible symptom
    if total < n:
        _log.warning(
            "mesh %s uses %d of %d devices — %d device(s) idle; "
            "if unintended, size an axis -1 to absorb the remainder",
            dict(zip(names, sizes)), total, n, n - total)
    return Mesh(onp.asarray(ranks[:total]).reshape(sizes), names)


def current_mesh():
    return getattr(_state, "mesh", None)


class mesh_scope:
    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        self._prev = getattr(_state, "mesh", None)
        _state.mesh = self.mesh
        return self.mesh

    def __exit__(self, *_exc):
        _state.mesh = self._prev


def sync_size():
    """The number of ranks BatchNorm's statistics span here: the current
    mesh's size inside `mesh_scope` of a mesh of more than one rank with
    a process group up, else 1 (local statistics)."""
    mesh = getattr(_state, "mesh", None)
    if mesh is None or mesh.size == 1:
        return 1
    return mesh.size if _distributed.world()[1] > 1 else 1


def data_sharding(mesh, axis_name="dp"):
    """Shard the leading (batch) axis over the given mesh axis."""
    return NamedSharding(mesh, PartitionSpec(axis_name))


def replicated_sharding(mesh):
    return NamedSharding(mesh, PartitionSpec())


class RuleCoverage(dict):
    """The ``name -> PartitionSpec`` mapping from
    :func:`match_partition_rules`, with the audit trail attached:

    * ``matched``: name -> the regex pattern that decided its spec
      (first match wins);
    * ``replicated``: names of non-scalar params that fell through every
      rule and defaulted to replicated;
    * ``scalars``: names short-circuited to replicated because sharding
      a scalar/size-1 array is meaningless.
    """

    def __init__(self):
        super().__init__()
        self.matched = {}
        self.replicated = []
        self.scalars = []

    def summary(self):
        return (f"{len(self.matched)} rule-matched, "
                f"{len(self.replicated)} fell through to replicated, "
                f"{len(self.scalars)} scalar")


def match_partition_rules(rules, names_to_shapes, strict=False):
    """Map parameter names to PartitionSpecs by regex rules.

    ``rules``: list of (pattern, PartitionSpec); first match wins; scalars
    and unmatched params are replicated.  Returns a :class:`RuleCoverage`
    (a dict subclass) recording which rule matched each param and which
    fell through.  ``strict=True`` raises ``ValueError`` naming every
    non-scalar param no rule matched.
    """
    out = RuleCoverage()
    for name, shape in names_to_shapes.items():
        if len(shape) == 0 or int(onp.prod(shape)) == 1:
            out[name] = PartitionSpec()
            out.scalars.append(name)
            continue
        spec = None
        for pattern, ps in rules:
            if re.search(pattern, name):
                spec = ps
                out.matched[name] = pattern
                break
        if spec is None:
            spec = PartitionSpec()
            out.replicated.append(name)
        out[name] = spec
    if strict and out.replicated:
        raise ValueError(
            "partition rule not found for param(s): "
            + ", ".join(sorted(out.replicated))
            + " — every non-scalar parameter must match a rule under a "
            "strict (tp/pp) recipe; add a block partition_rules() or a "
            "user override, or pass strict=False to replicate them")
    return out


def _sharded(spec):
    """Whether ``spec`` names a mesh axis for any dimension."""
    return any(p is not None for p in spec)


def _transfer_metrics():
    from .. import telemetry as _tm

    return (
        _tm.counter("mxtpu_mesh_transfer_total",
                    "Host->mesh placements via parallel.global_put",
                    labelnames=("kind",)),
        _tm.counter("mxtpu_mesh_transfer_bytes_total",
                    "Bytes placed onto the mesh via parallel.global_put",
                    labelnames=("kind",)),
    )


def row_block(mesh, spec):
    """(index, count) of this rank's block of rows along the axes that
    ``spec``'s leading entry names."""
    lead = spec[0]
    axes = (lead,) if isinstance(lead, str) else tuple(lead)
    coords = mesh.coords(_distributed.world()[0])
    index, count = 0, 1
    for a in axes:
        index = index * mesh.shape[a] + coords[a]
        count *= mesh.shape[a]
    return index, count


def global_put(value, sharding):
    """This rank's part of ``value`` (the same global value on every
    rank) under ``sharding``: its block of rows along the leading axis
    when the spec's first entry names mesh axes, else the whole value.
    A numpy array comes back as a CPU tensor; a tensor stays where it
    is.  Publishes count/bytes into the telemetry registry."""
    import torch

    t = value if isinstance(value, torch.Tensor) else \
        torch.as_tensor(onp.asarray(value))
    spec = sharding.spec
    if _sharded(spec[1:]):
        raise NotImplementedError(
            f"spec {spec!r} shards past the leading axis: ROADMAP queue A "
            "item A8")
    total, bytes_ = _transfer_metrics()
    if not spec or spec[0] is None or t.ndim == 0:
        total.labels(kind="replicated").inc()
        return t
    index, count = row_block(sharding.mesh, spec)
    if t.shape[0] % count:
        raise ValueError(f"{t.shape[0]} rows do not divide over {count} "
                         f"ranks of {spec[0]!r}")
    rows = t.shape[0] // count
    part = t[index * rows:(index + 1) * rows]
    total.labels(kind="rows").inc()
    bytes_.labels(kind="rows").inc(part.numel() * part.element_size())
    return part


def shard_parameters(params, mesh, rules=None, strict=False):
    """Replicate Gluon Parameters over the mesh: every parameter's value
    is broadcast from rank 0 (the reference's `kvstore.broadcast` of
    initial params), in name order.  A rule that shards a parameter
    raises (ROADMAP queue A item A8).

    Returns the :class:`RuleCoverage`; the coverage summary is logged
    and the fell-through-to-replicated count published as the
    ``mxtpu_recipe_params_replicated_total`` gauge.
    """
    import torch
    import torch.distributed as dist

    from .. import telemetry as _tm

    specs = match_partition_rules(
        rules or [], {k: p.shape for k, p in params.items()}, strict=strict)
    sharded = sorted(k for k, s in specs.items() if _sharded(s))
    if sharded:
        raise NotImplementedError(
            f"partition rules shard {sharded[0]} ({specs[sharded[0]]!r}): "
            "tensor, sequence and pipeline parallelism are ROADMAP queue A "
            "item A8; the port replicates parameters over the mesh")
    if _distributed.world()[1] > 1:
        with torch.no_grad():
            for name in sorted(params):
                for t in params[name].list_data():
                    dist.broadcast(t, src=int(mesh.devices.flat[0]))
    _log.info("shard_parameters: placed %d param(s) on mesh %s — %s",
              len(specs), mesh.shape, specs.summary())
    _tm.gauge(
        "mxtpu_recipe_params_replicated_total",
        "Non-scalar params the last shard_parameters call replicated "
        "because no partition rule matched them",
    ).set(len(specs.replicated))
    return specs


def constrain(x, mesh, spec):
    """The reference steers XLA's sharding propagation; a rank holds its
    rows already, so a replicated or leading-axis spec returns ``x``
    and any other raises (ROADMAP queue A item A8)."""
    spec = spec.spec if isinstance(spec, NamedSharding) else spec
    if _sharded(tuple(spec)[1:]):
        raise NotImplementedError(
            f"constrain to {spec!r}: sharding past the leading axis is "
            "ROADMAP queue A item A8")
    return x


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None):
    """Start the process group from explicit args or the environment set
    by `tools/launch.py` (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID); see `mxnet_tpu_torch._distributed`."""
    from .. import _distributed

    if coordinator_address is None and num_processes is None and \
            process_id is None:
        _distributed.init_from_env()
        return
    _distributed.init_group(coordinator_address, num_processes, process_id)
