"""Environment-variable configuration surface (counterpart of
`mxnet_tpu/env.py`).

Reference: the 102 documented ``MXNET_*`` variables
(`docs/static_site/src/pages/api/faq/env_var.md`).  The tables below keep
the JAX package's names, so ``describe()`` lists the same variables; the
behaviour column says what each does in the port.  Variables whose
subsystem is not ported yet (kvstore, elastic, serving fleet, sharding
recipes, autotune) are read by nothing in the port until that subsystem
lands; their readers are kept so that it finds them.

Handled at import (see the ``apply()`` call in
``mxnet_tpu_torch/__init__``):

=========================== =================================================
variable                     behavior
=========================== =================================================
MXNET_SEED                   seeds the global RNG streams at import
                             (``random.seed``: the key stream, the host
                             streams and the default torch.Generator)
MXNET_ENGINE_TYPE            read at import (``is_naive_engine``); it does
                             nothing until the ``engine`` module is
                             ported (ROADMAP queue A10)
MXNET_EXEC_BULK_EXEC_TRAIN   read at import; does nothing until
                             ``engine`` (A10) takes its bulk size
MXNET_CPU_WORKER_NTHREADS    default worker count for the native image
                             pipeline and thread DataLoaders
MXNET_PROFILER_AUTOSTART     start the profiler at import (chrome trace)
MXNET_ENFORCE_DETERMINISM    forbid nondeterministic op paths:
                             ``torch.use_deterministic_algorithms(True)``
MXNET_HOME                   cache root (model_store, datasets)
MXNET_HEARTBEAT_INTERVAL     kvstore liveness stamp period (seconds)
MXNET_KVSTORE_BUCKETING      ``0`` disables bucketed gradient allreduce —
                             Trainer/kvstore fall back to one collective
                             per parameter (default: bucketing on)
MXNET_KVSTORE_BUCKET_BYTES   gradient-bucket payload cap in bytes for the
                             fused allreduce (default 4194304 = 4 MB;
                             read when a store's bucketer is created)
MXNET_GPU_MEM_POOL_RESERVE   accepted, no-op (torch's caching allocator
                             owns device memory)
MXNET_STORAGE_FALLBACK_LOG_VERBOSE  accepted, no-op (no storage fallback:
                             sparse compute is explicit here)
=========================== =================================================

Read by their owning subsystem (import-time reads are baked in for the
process — set them before ``import mxnet_tpu_torch``; the runtime reads
say so explicitly):

=========================== =================================================
variable                     behavior
=========================== =================================================
MXNET_ENGINE_DEBUG           the reference's stale-read diagnostics; torch's
                             autograd checks in-place mutation itself, and
                             the port reads nothing
MXNET_DROPOUT_RNG            the reference's dropout bitstream choice;
                             the port's dropout always hashes
                             threefry2x32 (``csrc/dropout.cu``) and
                             reads nothing
MXNET_TELEMETRY_STEADY_STEPS retrace-watchdog steady-state call count:
                             a graph capture after this many calls of a
                             watched step or cache logs a WARNING
                             (default 2; read when a watchdog is
                             constructed)
MXNET_PROFILE_RANK           set by ``tools/launch.py --profile-rank``:
                             the matching rank (or every rank, ``-1``)
                             starts the profiler at import and dumps a
                             chrome trace at exit (the port has one rank
                             until ROADMAP queue A7b)
MXNET_PROFILE_DIR            output directory for the launcher-requested
                             profile dumps (default ``.``)
MXNET_KVSTORE_SPARSE_HOST_BOUND  row-sparse pushpull crossover: below
                             this many touched rows the host union beats
                             the device sort (default 256; re-read per
                             pushpull so it can be tuned mid-run)
MXNET_TPU_MODEL_REPO         colon-separated directories searched for
                             pretrained weight files (no network egress;
                             read at each ``get_model_file`` call)
MXNET_FAULTLINE              chaos fault plan for ``resilience.faultline``:
                             inline JSON (list of ``{site, kind, at,
                             times}`` specs) or ``@/path/to/plan.json``;
                             read once at the first instrumented-site
                             arrival, so set it before training starts.
                             Leave unset outside chaos runs
MXNET_CHECKPOINT_KEEP        checkpoints retained by
                             ``resilience.CheckpointManager.prune()``
                             (default 3; read when a manager is created)
MXNET_KVSTORE_RETRIES        transient-fault retry budget for KV reads,
                             per-key pushpull, bucketed collectives, and
                             the serve model call (default 3 retries =
                             4 attempts; re-read per retry loop so it can
                             be tuned mid-run)
MXNET_KVSTORE_QBLOCK         scale-block size (elements) for the
                             block-scaled int8/fp8 quantized allreduce
                             (default 256; read when
                             ``set_gradient_compression`` is called, and
                             ``compression_params['block']`` overrides it
                             per store); see docs/DESIGN.md
                             "Block-scaled quantized allreduce"
MXNET_DECODE_THREADS         decode-pool width for the native image
                             pipeline (``ImageRecordIter``); default
                             falls back to MXNET_CPU_WORKER_NTHREADS
                             (read when an iterator is constructed)
MXNET_PREFETCH_DEPTH         ``DevicePrefetcher`` ring depth — batches
                             resident on device ahead of compute
                             (default 2; read when a prefetcher is
                             constructed, including the DataLoader
                             ``prefetch_to_device`` path)
MXNET_IO_ERROR_TOLERANCE     decode-error fraction per window of records
                             above which ``ImageRecordIter`` logs a
                             WARNING and keeps ticking
                             ``mxtpu_io_decode_errors_total`` (default
                             0.01; read at iterator construction)
MXNET_SERVE_REPLICAS         default replica count for ``serve.Fleet``
                             (default 2; read when a fleet is created
                             without an explicit ``replicas=``)
MXNET_SERVE_DEADLINE_MS      base request deadline for the fleet's SLA
                             classes: interactive = 1x, standard = 4x,
                             batch = 20x (default 1000 ms; read when a
                             router's class table is built)
MXNET_SERVE_EJECT_AFTER      consecutive replica failures before the
                             fleet ejects it from routing (default 2 —
                             the tpu_ici two-observation suspicion rule;
                             read when a fleet is created)
MXNET_ELASTIC                ``1`` lets ``resilience.ElasticSupervisor``
                             re-shard onto the survivor mesh after a
                             permanent host loss instead of re-raising
                             ``DeadNodeError`` (default 0: abort to
                             checkpoint, the pre-elastic behavior; read
                             when a supervisor is created without an
                             explicit ``elastic=``)
MXNET_ELASTIC_MIN_WORLD      smallest world the supervisor will shrink
                             to; a fault leaving fewer survivors aborts
                             to checkpoint instead of resharding
                             (default 1; read at supervisor creation)
MXNET_ELASTIC_SCALING        batch/lr scaling rule across a world-size
                             change: ``linear`` (default — per-host
                             batch constant, so global batch AND lr
                             scale by world/base_world; loss scale
                             untouched) or ``none`` (keep the lr; the
                             global batch still shrinks with the world
                             and the supervisor logs that the effective
                             step size changed).  Read at supervisor
                             creation; the applied rule is always
                             logged, never silent
MXNET_SENTINEL_SLOW_FACTOR   straggler-demotion threshold for
                             ``resilience.sentinel.StragglerPolicy``: a
                             rank whose step-time EMA exceeds factor x
                             the pod median for M consecutive
                             observations is declared DEGRADED and
                             resharded away exactly like a dead node
                             (default 3.0; read when a policy is
                             created)
MXNET_SENTINEL_LOSS_FACTOR   divergence-rollback threshold for
                             ``resilience.sentinel.DivergenceSentinel``:
                             a synced loss above factor x the warmed-up
                             EMA (or non-finite) trips an automatic
                             rollback to the newest complete checkpoint
                             (default 10.0; read when a sentinel is
                             created)
MXNET_SENTINEL_ROLLBACKS     divergence rollbacks the supervisor takes
                             before surfacing ``DivergenceError``
                             (default 2; read at supervisor creation)
MXNET_PARALLEL_RECIPE        default sharding recipe string
                             (``"dp2.tp2"`` etc., grammar in
                             docs/SHARDING.md) used by
                             ``FusedTrainStep``/dryrun when the caller
                             passes neither ``mesh`` nor ``recipe``
                             (default unset: plain dp over all devices;
                             read when a fused step is constructed)
MXNET_RECIPE_STRICT          overrides the recipe's auto strict-coverage
                             policy: ``1`` forces the placement audit to
                             raise on any non-scalar param no partition
                             rule matched, ``0`` always allows the
                             replicated fallback (default unset = auto:
                             strict whenever the recipe has a non-dp
                             axis of size > 1; read when a recipe's
                             strictness is resolved)
MXNET_KVSTORE_INTEGRITY      ``1`` turns on the allreduce integrity
                             sideband: a per-device digest of each
                             bucket's psum result is agreement-checked
                             in-program (pmax-vs-pmin, same launch);
                             disagreement ticks
                             ``mxtpu_integrity_violations_total`` and
                             the step-guard skips the update so a
                             flipped bit never reaches the optimizer
                             (default 0; read when a store's bucketer
                             is created)
MXNET_BLACKBOX               ``0`` disables the ``observe`` flight
                             recorder entirely — no events recorded, no
                             postmortem dumps (default on; read when
                             the recorder is created or ``reset()``)
MXNET_BLACKBOX_EVENTS        flight-recorder ring capacity in events;
                             older events are overwritten and counted
                             in the dump's ``dropped`` field (default
                             4096; read at recorder creation/reset)
MXNET_BLACKBOX_DIR           fixed directory for postmortem dumps;
                             default unset: dumps land next to the
                             checkpoint step dirs (``<root>/blackbox``)
                             or ``./blackbox`` with no checkpoint root
                             (read at each dump)
MXNET_AUTOTUNE               ``0`` disables the autotune winner cache:
                             every tuned kernel (flash attention, the
                             scan-LSTM cell, the s2d stem, the
                             BN-backward epilogue) silently uses its
                             documented static default and ``tune.best``
                             stops warning about misses (default on;
                             read once at the first cache consult and
                             memoized for the process —
                             ``tune.invalidate()`` re-reads)
MXNET_AUTOTUNE_CACHE         path of the autotune winner cache to read
                             instead of the committed
                             ``tools/autotune_cache.json`` (e.g. a
                             freshly swept cache under review; read
                             once at the first cache consult, see
                             docs/AUTOTUNE.md)
MXNET_LOCKSCAN_WITNESS       ``1`` installs the lock-acquisition
                             witness (``mxnet_tpu_torch.lockwitness``) as
                             the very first package import: every
                             package-created Lock/RLock/Condition is
                             wrapped, held->acquired order edges are
                             recorded per thread, an acquisition that
                             closes a cycle raises
                             ``LockOrderViolation``, and a process with
                             recorded violations exits 70.  Read at
                             import only — set before ``import
                             mxnet_tpu_torch``
MXNET_LOCKSCAN_REPORT        path where the witness dumps its observed
                             order graph (JSON) at process exit, for
                             ``python -m tools.lockscan --crosscheck``
                             against the static model (read at exit;
                             only meaningful with the witness on)
=========================== =================================================
"""
from __future__ import annotations

import os

__all__ = ["apply", "describe", "is_naive_engine", "cpu_worker_nthreads",
           "decode_threads", "prefetch_depth", "io_error_tolerance",
           "serve_replicas", "serve_deadline_ms", "serve_eject_after",
           "elastic_enabled", "elastic_min_world", "elastic_scaling",
           "sentinel_slow_factor", "sentinel_loss_factor",
           "sentinel_rollbacks", "kvstore_integrity",
           "parallel_recipe", "recipe_strict", "blackbox_enabled",
           "blackbox_events", "blackbox_dir", "autotune_enabled",
           "autotune_cache_path", "lockscan_witness",
           "lockscan_report_path"]

_naive_engine = False


def is_naive_engine():
    return _naive_engine


def cpu_worker_nthreads(default=None):
    v = os.environ.get("MXNET_CPU_WORKER_NTHREADS")
    if v is None:
        return default if default is not None else (os.cpu_count() or 1)
    return max(1, int(v))


def decode_threads(default=None):
    """Decode-pool width for the native image pipeline; falls back to
    the general worker knob when MXNET_DECODE_THREADS is unset."""
    v = os.environ.get("MXNET_DECODE_THREADS")
    if v is None:
        return cpu_worker_nthreads(default)
    return max(1, int(v))


def prefetch_depth(default=2):
    v = os.environ.get("MXNET_PREFETCH_DEPTH")
    if v is None:
        return default
    return max(1, int(v))


def io_error_tolerance(default=0.01):
    v = os.environ.get("MXNET_IO_ERROR_TOLERANCE")
    if v is None:
        return default
    return max(0.0, float(v))


def serve_replicas(default=2):
    v = os.environ.get("MXNET_SERVE_REPLICAS")
    if v is None:
        return default
    return max(1, int(v))


def serve_deadline_ms(default=1000.0):
    """Base deadline for the fleet SLA classes (interactive = 1x)."""
    v = os.environ.get("MXNET_SERVE_DEADLINE_MS")
    if v is None:
        return default
    return max(1.0, float(v))


def serve_eject_after(default=2):
    """Consecutive failures before a fleet replica is ejected."""
    v = os.environ.get("MXNET_SERVE_EJECT_AFTER")
    if v is None:
        return default
    return max(1, int(v))


def elastic_enabled(default=False):
    """Whether the elastic supervisor may re-shard onto survivors after
    a permanent host loss (default: abort to checkpoint instead)."""
    v = os.environ.get("MXNET_ELASTIC")
    if v is None:
        return default
    return v not in ("0", "")


def elastic_min_world(default=1):
    """Smallest world the supervisor will shrink to; fewer survivors
    abort to checkpoint."""
    v = os.environ.get("MXNET_ELASTIC_MIN_WORLD")
    if v is None:
        return default
    return max(1, int(v))


def elastic_scaling(default="linear"):
    """Batch/lr scaling rule across a world-size change: ``linear`` or
    ``none`` (see the docstring table; the choice is always logged)."""
    v = os.environ.get("MXNET_ELASTIC_SCALING")
    if v is None:
        return default
    if v not in ("linear", "none"):
        raise ValueError(
            f"MXNET_ELASTIC_SCALING={v!r}: expected 'linear' or 'none'")
    return v


def sentinel_slow_factor(default=3.0):
    """Straggler-demotion threshold: step-time EMA over pod-median
    ratio above which a rank is suspected (see StragglerPolicy)."""
    v = os.environ.get("MXNET_SENTINEL_SLOW_FACTOR")
    if v is None:
        return default
    return max(1.0, float(v))


def sentinel_loss_factor(default=10.0):
    """Divergence threshold: loss over warmed-up EMA ratio above which
    the DivergenceSentinel trips an auto-rollback."""
    v = os.environ.get("MXNET_SENTINEL_LOSS_FACTOR")
    if v is None:
        return default
    return max(1.0, float(v))


def sentinel_rollbacks(default=2):
    """Divergence rollbacks the supervisor takes before surfacing
    ``DivergenceError``."""
    v = os.environ.get("MXNET_SENTINEL_ROLLBACKS")
    if v is None:
        return default
    return max(0, int(v))


def kvstore_integrity(default=False):
    """Whether the bucketed allreduce runs the in-program integrity
    sideband (digest agreement check inside the same launch)."""
    v = os.environ.get("MXNET_KVSTORE_INTEGRITY")
    if v is None:
        return default
    return v not in ("0", "")


def parallel_recipe(default=None):
    """Default sharding recipe string for FusedTrainStep/dryrun when the
    caller passes neither mesh nor recipe (None = plain dp)."""
    v = os.environ.get("MXNET_PARALLEL_RECIPE")
    if v is None or not v.strip():
        return default
    return v.strip()


def recipe_strict(default=None):
    """Tri-state strict-coverage override for sharding recipes: None
    (unset — the recipe's auto policy applies), True (``1``: the audit
    raises on uncovered non-scalar params), or False (``0``: always
    allow the replicated fallback)."""
    v = os.environ.get("MXNET_RECIPE_STRICT")
    if v is None or v == "":
        return default
    return v != "0"


def blackbox_enabled(default=True):
    """Whether the ``observe`` flight recorder records at all."""
    v = os.environ.get("MXNET_BLACKBOX")
    if v is None:
        return default
    return v not in ("0", "")


def blackbox_events(default=4096):
    """Flight-recorder ring capacity (events); older events are
    overwritten."""
    v = os.environ.get("MXNET_BLACKBOX_EVENTS")
    if v is None:
        return default
    return max(16, int(v))


def blackbox_dir(default=None):
    """Fixed postmortem-dump directory; None = next to the checkpoint
    dir (``<root>/blackbox``) or ``./blackbox``."""
    v = os.environ.get("MXNET_BLACKBOX_DIR")
    if v is None or not v.strip():
        return default
    return v.strip()


def autotune_enabled(default=True):
    """Whether tuned dispatch consults the autotune winner cache at all
    (``0`` = static defaults everywhere, no miss warnings)."""
    v = os.environ.get("MXNET_AUTOTUNE")
    if v is None:
        return default
    return v not in ("0", "")


def autotune_cache_path(default=None):
    """Cache-file override; None = the committed
    ``tools/autotune_cache.json``."""
    v = os.environ.get("MXNET_AUTOTUNE_CACHE")
    if v is None or not v.strip():
        return default
    return v.strip()


def lockscan_witness(default=False):
    """Whether the lock-acquisition witness is requested.  NOTE: the
    install itself happens at the top of ``mxnet_tpu_torch/__init__``
    from a
    direct environ read (the witness must patch the lock factories
    before any package import creates one) — this helper only reports
    the setting."""
    v = os.environ.get("MXNET_LOCKSCAN_WITNESS")
    if v is None:
        return default
    return v not in ("0", "")


def lockscan_report_path(default=None):
    """Where the witness dumps its observed order graph at exit; None =
    no dump.  (Read at exit by ``mxnet_tpu_torch.lockwitness``.)"""
    v = os.environ.get("MXNET_LOCKSCAN_REPORT")
    if v is None or not v.strip():
        return default
    return v.strip()


def apply():
    """Read the environment once at package import."""
    global _naive_engine

    if os.environ.get("MXNET_ENFORCE_DETERMINISM", "0") not in ("0", ""):
        import torch
        torch.use_deterministic_algorithms(True)

    # read, and kept for the engine (ROADMAP queue A10), which acts on
    # neither yet
    _naive_engine = os.environ.get("MXNET_ENGINE_TYPE") == "NaiveEngine"
    bulk = os.environ.get("MXNET_EXEC_BULK_EXEC_TRAIN")
    if bulk is not None:
        try:
            int(bulk)
        except ValueError:
            pass

    seed = os.environ.get("MXNET_SEED")
    if seed is not None:
        from . import random as _rng
        try:
            _rng.seed(int(seed))
        except ValueError:
            pass

    if os.environ.get("MXNET_PROFILER_AUTOSTART", "0") not in ("0", ""):
        from . import profiler
        profiler.set_state("run")


def describe():
    """The live table: (name, current value, honored?)."""
    names = ["MXNET_SEED", "MXNET_ENGINE_TYPE", "MXNET_EXEC_BULK_EXEC_TRAIN",
             "MXNET_CPU_WORKER_NTHREADS", "MXNET_PROFILER_AUTOSTART",
             "MXNET_ENFORCE_DETERMINISM", "MXNET_HOME",
             "MXNET_HEARTBEAT_INTERVAL", "MXNET_KVSTORE_BUCKETING",
             "MXNET_KVSTORE_BUCKET_BYTES", "MXNET_GPU_MEM_POOL_RESERVE",
             "MXNET_STORAGE_FALLBACK_LOG_VERBOSE",
             # subsystem-owned knobs (second docstring table)
             "MXNET_ENGINE_DEBUG", "MXNET_DROPOUT_RNG",
             "MXNET_TELEMETRY_STEADY_STEPS", "MXNET_PROFILE_RANK",
             "MXNET_PROFILE_DIR", "MXNET_KVSTORE_SPARSE_HOST_BOUND",
             "MXNET_TPU_MODEL_REPO", "MXNET_FAULTLINE",
             "MXNET_CHECKPOINT_KEEP", "MXNET_KVSTORE_RETRIES",
             "MXNET_KVSTORE_QBLOCK", "MXNET_DECODE_THREADS",
             "MXNET_PREFETCH_DEPTH", "MXNET_IO_ERROR_TOLERANCE",
             "MXNET_SERVE_REPLICAS", "MXNET_SERVE_DEADLINE_MS",
             "MXNET_SERVE_EJECT_AFTER", "MXNET_ELASTIC",
             "MXNET_ELASTIC_MIN_WORLD", "MXNET_ELASTIC_SCALING",
             "MXNET_SENTINEL_SLOW_FACTOR", "MXNET_SENTINEL_LOSS_FACTOR",
             "MXNET_SENTINEL_ROLLBACKS", "MXNET_KVSTORE_INTEGRITY",
             "MXNET_PARALLEL_RECIPE", "MXNET_RECIPE_STRICT",
             "MXNET_BLACKBOX", "MXNET_BLACKBOX_EVENTS",
             "MXNET_BLACKBOX_DIR", "MXNET_AUTOTUNE",
             "MXNET_AUTOTUNE_CACHE", "MXNET_LOCKSCAN_WITNESS",
             "MXNET_LOCKSCAN_REPORT"]
    return [(n, os.environ.get(n), n in __doc__) for n in names]
