"""Checkpointing: atomic, per-host sharded, async, self-verifying
(counterpart of `mxnet_tpu/resilience/checkpoint.py`; the same layout,
manifest and array names, so a checkpoint either package writes restores
in the other).

Layout (``<root>`` is the checkpoint directory)::

    <root>/step-0000000042/host-00000/MANIFEST.json
    <root>/step-0000000042/host-00000/arrays.npz

Each host commits its own shard directory **atomically**: arrays and
manifest are written into a hidden tmp directory, every file is
fsync'd, the directory entry is fsync'd, and a single ``os.rename``
publishes it.  The manifest carries a sha256 per file, so a torn write
(power loss mid-rename never exposes one, but a corrupted disk block
can) is *detected* at restore and the previous checkpoint is used
instead — corruption degrades to "lose one checkpoint interval", never
to "resume from garbage".

What a training-state checkpoint holds (``gather_training_state``):
params, optimizer ``_states`` + update counts + ``num_update``,
``LossScaler`` scale and window position, the ``mx.random`` stream
(root key words + counter, the reference's ``rng/root`` and
``rng_counter``) and, under a key of the port's own
(``rng/torch_generator``), the state of the CPU ``torch.Generator`` that
train-mode draws take their seed words from: without it a resumed run
would draw other dropout bits.  The reference ignores that key, and a
reference checkpoint without it leaves the generator as it is.  The
kvstore's error-feedback residuals, the reference's ``kvres/`` and
``bucketres/`` arrays, wait for the kvstore's compression and
bucketing (ROADMAP queue A7c):
a checkpoint that holds them raises.

Arrays are host copies: numpy arrays, except where numpy has no dtype
(bfloat16, the float8 types), which stay CPU ``torch`` tensors.  On
disk those ride as same-width unsigned views with the dtype's name in
the manifest, as the reference writes them, and decode through
``torch.from_numpy(a).view(torch.bfloat16)`` (no ``ml_dtypes``).
`gather_training_state` takes the copies of the card's tensors with
non-blocking copies and one synchronization, so a checkpoint taken
between two replays of a captured step holds step *k*'s values, not
views that replay *k+1* overwrites.

:class:`CheckpointManager` adds the operational layer: an async
background writer (the host snapshot is taken synchronously, the disk
I/O happens off-thread; the worker is joined in ``close()``),
keep-last-K pruning (``MXNET_CHECKPOINT_KEEP``), ``restore_latest``
with automatic fallback, and ``mxtpu_checkpoint_*`` telemetry.

Each rank writes and reads its own ``host-<rank>`` shard, its rank and
world ``torch.distributed``'s when a process group is up, else 0 and 1:
a checkpoint restores in a world of the size that saved it, a world of
another size raises :class:`CheckpointTopologyError`, and
``reshard=True`` (onto a survivor world) raises ``NotImplementedError``
(ROADMAP queue A7d).
"""
from __future__ import annotations

import hashlib
import json
import os
import queue
import threading
import time

import numpy as onp
import torch

from .. import _distributed
from .. import observe as _observe
from .. import telemetry as _telemetry
from . import faultline

__all__ = ["CheckpointManager", "CheckpointCorrupt",
           "CheckpointTopologyError",
           "save_checkpoint", "load_checkpoint", "latest_step",
           "list_steps", "complete_steps",
           "gather_training_state", "restore_training_state"]

SCHEMA = "mxtpu-ckpt-v1"
_ARRAYS = "arrays.npz"
_MANIFEST = "MANIFEST.json"

# numpy-native dtype names; anything else (bfloat16, fp8) is stored as a
# same-width unsigned view and restored through the dtype map below
_NATIVE = frozenset(
    ["bool", "int8", "int16", "int32", "int64", "uint8", "uint16",
     "uint32", "uint64", "float16", "float32", "float64",
     "complex64", "complex128"])


class CheckpointCorrupt(RuntimeError):
    """A shard failed manifest/checksum validation."""


class CheckpointTopologyError(RuntimeError):
    """The checkpoint was saved by a different world than the one
    restoring it (device-copy count or a parameter shape differs).
    Raised by :func:`restore_training_state` instead of letting the
    mismatch surface as an obscure shape or device error;
    ``.saved_world`` / ``.live_world`` name both sides.  A shape
    mismatch means the wrong model."""

    def __init__(self, message, saved_world=None, live_world=None):
        super().__init__(message)
        self.saved_world = saved_world
        self.live_world = live_world


def _counter(name, help, labelnames=()):
    return _telemetry.counter(name, help, labelnames=labelnames)


def _saves_counter():
    return _counter(
        "mxtpu_checkpoint_saves_total",
        "Checkpoint shard writes, by outcome (written / failed)",
        labelnames=("outcome",))


def _restores_counter():
    return _counter(
        "mxtpu_checkpoint_restores_total",
        "Checkpoint restore attempts, by outcome (ok / corrupt_fallback "
        "/ none)",
        labelnames=("outcome",))


def _bytes_counter():
    return _counter(
        "mxtpu_checkpoint_bytes_total",
        "Bytes committed to checkpoint shards (post-encoding, pre-"
        "compression: the npz payload)")


def _last_step_gauge():
    return _telemetry.gauge(
        "mxtpu_checkpoint_last_step",
        "Step number of the most recently committed checkpoint shard")


def _param_bytes_counter():
    return _counter(
        "mxtpu_ckpt_param_bytes_total",
        "Host bytes copied per parameter at checkpoint gather, by mode: "
        "'replicated' copies the full array, 'shard' copies only each "
        "unique device shard of a recipe-sharded param (never the "
        "gathered full array)",
        labelnames=("mode",))


# --------------------------------------------------------------------------
# dtype encoding: non-native dtypes ride as unsigned views
# --------------------------------------------------------------------------
_UNSIGNED = {1: onp.uint8, 2: onp.uint16, 4: onp.uint32, 8: onp.uint64}
_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _torch_dtype(name):
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise CheckpointCorrupt(f"unknown array dtype {name!r}")
    return dt


def _numpy_of(t):
    """A CPU tensor as numpy, where numpy has its dtype; else the tensor
    (bfloat16, float8)."""
    try:
        return t.numpy()
    except TypeError:
        return t


def _encode_arrays(arrays):
    enc, nonnative = {}, {}
    for name, a in arrays.items():
        if isinstance(a, torch.Tensor):
            t = a.detach().cpu()
            a = _numpy_of(t)
            if isinstance(a, torch.Tensor):
                nonnative[name] = str(t.dtype).replace("torch.", "")
                a = t.contiguous().view(_SIGNED[t.element_size()]).numpy()
                a = a.view(_UNSIGNED[a.dtype.itemsize])
        a = onp.asarray(a)
        if a.dtype.name not in _NATIVE:
            nonnative[name] = a.dtype.name
            a = a.view(_UNSIGNED[a.dtype.itemsize])
        enc[name] = a
    return enc, nonnative


def _decode_arrays(npz, nonnative):
    out = {}
    for name in npz.files:
        a = npz[name]
        dt = nonnative.get(name)
        if dt:
            signed = a.view(a.dtype.str.replace("u", "i"))
            a = torch.from_numpy(signed).view(_torch_dtype(dt))
        out[name] = a
    return out


def _sha256(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _fsync_dir(path):
    # directory-entry durability: rename is only durable once the parent
    # directory's entry is flushed (POSIX leaves it to the fs otherwise)
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # platforms without O_RDONLY dirs
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


# --------------------------------------------------------------------------
# shard-level save / load
# --------------------------------------------------------------------------
def _step_dir(root, step):
    return os.path.join(root, f"step-{int(step):010d}")


def _host_dir(root, step, rank):
    return os.path.join(_step_dir(root, step), f"host-{int(rank):05d}")


def save_checkpoint(root, step, arrays, meta=None, rank=None):
    """Atomically commit one host's shard for ``step``.  Returns the
    committed shard directory path."""
    if rank is None:
        rank = _distributed.world()[0]
    faultline.check("checkpoint.write")
    t0 = time.monotonic()
    final = _host_dir(root, step, rank)
    step_parent = os.path.dirname(final)
    os.makedirs(step_parent, exist_ok=True)
    tmp = os.path.join(
        root, f".tmp-step-{int(step):010d}-host-{rank:05d}-{os.getpid()}")
    try:
        os.makedirs(tmp, exist_ok=True)
        enc, nonnative = _encode_arrays(arrays)
        arr_path = os.path.join(tmp, _ARRAYS)
        with open(arr_path, "wb") as f:
            onp.savez(f, **enc)
            f.flush()
            os.fsync(f.fileno())
        manifest = {
            "schema": SCHEMA,
            "step": int(step),
            "rank": int(rank),
            "world": _distributed.world()[1],
            "saved_unix": time.time(),
            "nonnative_dtypes": nonnative,
            "files": {_ARRAYS: {"sha256": _sha256(arr_path),
                                "bytes": os.path.getsize(arr_path)}},
            "meta": meta or {},
        }
        man_path = os.path.join(tmp, _MANIFEST)
        with open(man_path, "w", encoding="utf-8") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        if os.path.isdir(final):  # re-save of the same step: replace
            import shutil
            shutil.rmtree(final)
        os.rename(tmp, final)
        _fsync_dir(step_parent)
    except BaseException:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _bytes_counter().inc(manifest["files"][_ARRAYS]["bytes"])
    _last_step_gauge().set(int(step))
    _telemetry.histogram(
        "mxtpu_checkpoint_save_seconds",
        "Wall time of one shard commit (encode + write + fsync + rename)"
    ).observe(time.monotonic() - t0)
    return final


def _validate_shard(host_dir):
    man_path = os.path.join(host_dir, _MANIFEST)
    if not os.path.isfile(man_path):
        raise CheckpointCorrupt(f"{host_dir}: no manifest")
    try:
        with open(man_path, "r", encoding="utf-8") as f:
            manifest = json.load(f)
    except (ValueError, OSError) as e:
        raise CheckpointCorrupt(f"{host_dir}: unreadable manifest: {e}")
    if manifest.get("schema") != SCHEMA:
        raise CheckpointCorrupt(
            f"{host_dir}: schema {manifest.get('schema')!r} != {SCHEMA!r}")
    for fname, info in manifest.get("files", {}).items():
        fpath = os.path.join(host_dir, fname)
        if not os.path.isfile(fpath):
            raise CheckpointCorrupt(f"{host_dir}: missing {fname}")
        digest = _sha256(fpath)
        if digest != info.get("sha256"):
            raise CheckpointCorrupt(
                f"{host_dir}: {fname} checksum mismatch "
                f"({digest[:12]} != {info.get('sha256', '')[:12]})")
    return manifest


def load_checkpoint(root, step=None, rank=None):
    """Load one host's shard (validating checksums).  ``step=None`` loads
    the newest step present.  Returns ``(step, arrays, meta)``; arrays
    whose dtype numpy lacks (bfloat16) come back as CPU tensors.  Raises
    :class:`CheckpointCorrupt` on validation failure, ``FileNotFoundError``
    when nothing exists."""
    if rank is None:
        rank = _distributed.world()[0]
    if step is None:
        steps = list_steps(root)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {root}")
        step = steps[-1]
    host_dir = _host_dir(root, step, rank)
    manifest = _validate_shard(host_dir)
    with onp.load(os.path.join(host_dir, _ARRAYS),
                  allow_pickle=False) as npz:
        arrays = _decode_arrays(npz, manifest.get("nonnative_dtypes", {}))
    return int(manifest["step"]), arrays, manifest.get("meta", {})


def list_steps(root):
    """Committed step numbers, ascending (a step counts once any host
    shard directory exists for it)."""
    if not os.path.isdir(root):
        return []
    steps = []
    for name in os.listdir(root):
        if name.startswith("step-"):
            try:
                steps.append(int(name[len("step-"):]))
            except ValueError:
                continue
    return sorted(steps)


def latest_step(root):
    steps = list_steps(root)
    return steps[-1] if steps else None


def complete_steps(root, ranks):
    """Steps whose shard exists AND validates for EVERY rank in
    ``ranks``, ascending.  Under a mid-save host death the hosts can
    disagree on their newest local step; the newest *complete* step is
    the only one every survivor can restore together, so the elastic
    path restores from ``complete_steps(root, survivors)[-1]``."""
    out = []
    for step in list_steps(root):
        try:
            for r in ranks:
                _validate_shard(_host_dir(root, step, r))
        except CheckpointCorrupt:
            continue
        out.append(step)
    return out


# --------------------------------------------------------------------------
# training-state gather / restore
# --------------------------------------------------------------------------
def _as_tuple(x):
    if x is None:
        return ()
    if isinstance(x, (tuple, list)):
        return tuple(x)
    return (x,)


def _host_copies(tensors):
    """Host copies of ``tensors``: the card's through non-blocking copies
    (into pinned memory) on the current stream and one synchronization
    of that stream for all of them, the CPU's cloned; as numpy where
    numpy has the dtype."""
    out, streams = [], {}
    for t in tensors:
        t = t.detach()
        if t.is_cuda:
            out.append(t.to("cpu", non_blocking=True))
            streams.setdefault(t.device,
                               torch.cuda.current_stream(t.device))
        else:
            out.append(t.clone())
    for stream in streams.values():
        stream.synchronize()
    return [_numpy_of(t) for t in out]


def _default_generator(generator):
    from .. import random as _rng

    return generator if generator is not None else _rng.default_generator()


def gather_training_state(trainer, step, scaler=None, include_rng=True,
                          generator=None):
    """Snapshot the training state to host arrays: ``(arrays, meta)``
    ready for :func:`save_checkpoint`.  Call it between steps.

    ``scaler`` defaults to the loss scaler `amp.init_trainer` attached
    to the trainer.  With ``include_rng``, the ``mx.random`` stream and
    the state of ``generator`` (default: ``mx.random``'s default
    generator, which train-mode draws take when no scope names one) are
    saved too.  Every device tensor is copied to the host with one
    synchronization."""
    from .. import random as _rng

    _one_copy(trainer)
    trainer._init_states()
    arrays, meta = {}, {"step": int(step)}
    names = [p.name for p in trainer._params]
    opt_items = sorted((trainer._states or {}).items())
    flat = [p.data() for p in trainer._params]
    for _i, entry in opt_items:
        flat.extend(_as_tuple(entry))
    host = iter(_host_copies(flat))
    rep_bytes = 0
    for i in range(len(trainer._params)):
        a = next(host)
        arrays[f"param/{i}"] = a
        rep_bytes += a.nbytes
    meta["param_names"] = names
    if rep_bytes:
        _param_bytes_counter().labels(mode="replicated").inc(rep_bytes)
    meta["world"] = {"copies": 1, "processes": _distributed.world()[1]}
    # -- optimizer: per-param state tuples, update counts, num_update
    opt = trainer._optimizer
    opt_multi = {}
    for i, entry in opt_items:
        opt_multi[str(i)] = 0  # single-device: no copy axis
        for j, _s in enumerate(_as_tuple(entry)):
            arrays[f"opt/{i}/{j}"] = next(host)
    meta["opt_multi"] = opt_multi
    meta["opt_update_counts"] = {
        "0": {str(i): int(t) for i, t in opt._index_update_count.items()}}
    meta["opt_num_update"] = int(opt.num_update)
    # -- loss scaler
    if scaler is None:
        scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is not None:
        meta["scaler"] = {"loss_scale": float(scaler.loss_scale),
                          "unskipped": int(scaler._unskipped)}
    # -- mx.random stream (the reference's keys) and the generator
    if include_rng:
        arrays["rng/root"] = _rng._state.root.numpy().astype(onp.uint32)
        meta["rng_counter"] = int(_rng._state.counter)
        gen = _default_generator(generator)
        if gen is not None:
            arrays["rng/torch_generator"] = gen.get_state().numpy().copy()
    return arrays, meta


def _one_copy(trainer):
    """Raise for a trainer over parameters with copies on several
    contexts, whose checkpoints are ROADMAP queue A7d."""
    several = [p.name for p in trainer._params if len(p.list_ctx()) > 1]
    if several:
        raise NotImplementedError(
            f"parameters with copies on several contexts ({several[0]}, "
            "...): their training-state checkpoints are ROADMAP queue A "
            "item A7d; Block.save_parameters and Trainer.save_states save "
            "them")


def _to_tensor(a):
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        onp.ascontiguousarray(a))


def restore_training_state(arrays, meta, trainer, scaler=None,
                           reshard=False, generator=None):
    """Inverse of :func:`gather_training_state`: copy params, optimizer
    states and counts, scaler, the ``mx.random`` stream and the
    generator's state back, bitwise.  Returns the checkpointed step.

    Params and states are copied into the trainer's tensors in place, so
    they keep their device, their ``generation`` and a captured step's
    CUDA graph.  ``scaler`` and ``generator`` default as in
    :func:`gather_training_state`; a checkpoint with a generator state
    and no default generator makes one.  A checkpoint saved by a larger
    world raises :class:`CheckpointTopologyError`; ``reshard=True``,
    recipe-sharded params and kvstore residuals raise
    ``NotImplementedError`` (ROADMAP queue A7c, A7d)."""
    from .. import random as _rng
    from ..ops import invoke as _invoke
    from ..ops import threefry as _threefry

    if reshard:
        raise NotImplementedError(
            "restore_training_state(reshard=True) restores onto a survivor "
            "world, which is ROADMAP queue A7d (distribution)")
    if meta.get("sharded_params") or meta.get("bucket_residuals") or any(
            k.startswith(("kvres/", "bucketres/", "paramshard/"))
            for k in arrays):
        raise NotImplementedError(
            "this checkpoint holds recipe-sharded params or kvstore "
            "residuals, which wait for the port's kvstore (ROADMAP queue "
            "A7c, distribution)")
    _one_copy(trainer)
    trainer._init_states()
    saved = meta.get("world")
    live = {"copies": 1, "processes": _distributed.world()[1]}
    if saved and (int(saved.get("copies", 1)) != 1 or
                  int(saved.get("processes", 1)) != live["processes"]):
        raise CheckpointTopologyError(
            f"checkpoint topology mismatch: saved world has "
            f"{saved.get('copies')} device copies ({saved.get('processes')} "
            f"process(es)), live world has 1 device copy "
            f"({live['processes']} process(es)); resharding onto another "
            "world is ROADMAP queue A7d", saved_world=dict(saved),
            live_world=live)
    with torch.no_grad():
        for i, p in enumerate(trainer._params):
            a = arrays.get(f"param/{i}")
            if a is None:
                continue
            if tuple(a.shape) != tuple(p.shape):
                raise CheckpointTopologyError(
                    f"checkpoint shape mismatch for param {i} "
                    f"({meta.get('param_names', [None] * (i + 1))[i]}): "
                    f"saved {tuple(a.shape)}, live {tuple(p.shape)} — "
                    "different model", saved_world=saved, live_world=live)
            p.data().copy_(_to_tensor(a))
        opt_multi = meta.get("opt_multi", {})
        for i, entry in (trainer._states or {}).items():
            ncopies = opt_multi.get(str(i))
            if ncopies is None:
                continue
            for j, s in enumerate(_as_tuple(entry)):
                key = f"opt/{i}/0/{j}" if ncopies else f"opt/{i}/{j}"
                if key in arrays:
                    s.copy_(_to_tensor(arrays[key]))
    opt = trainer._optimizer
    counts = meta.get("opt_update_counts")
    if counts is not None:
        dev = "0" if "0" in counts else next(iter(counts), None)
        opt._index_update_count = {
            int(i): int(t) for i, t in counts.get(dev, {}).items()}
        opt.num_update = int(meta.get("opt_num_update", opt.num_update))
    if scaler is None:
        scaler = getattr(trainer, "_amp_loss_scaler", None)
    sc = meta.get("scaler")
    if scaler is not None and sc is not None:
        scaler.loss_scale = sc["loss_scale"]
        scaler._unskipped = sc["unskipped"]
    if "rng/root" in arrays:
        _rng._state.root = _threefry.key_of(
            [int(w) for w in onp.asarray(arrays["rng/root"]).reshape(-1)])
        _rng._state.counter = int(meta.get("rng_counter", 0))
    if "rng/torch_generator" in arrays:
        gen = _default_generator(generator)
        if gen is None:
            gen = torch.Generator()
            _invoke.set_default_generator(gen)
        gen.set_state(_to_tensor(arrays["rng/torch_generator"]).clone())
    return int(meta.get("step", 0))


# --------------------------------------------------------------------------
# the manager: async writer, pruning, fallback restore
# --------------------------------------------------------------------------
class CheckpointManager:
    """Operational wrapper around the shard writer.

    >>> mgr = CheckpointManager("/ckpt", keep=3)
    >>> mgr.save(step, *resilience.gather_training_state(trainer, step))
    >>> ...
    >>> restored = mgr.restore_latest()   # (step, arrays, meta) or None
    >>> mgr.close()

    ``async_write=True`` (default) moves the disk I/O to a background
    worker; the host-side state snapshot happens in the CALLER
    (``gather_training_state``), so by enqueue time nothing references
    live device buffers and the training loop may immediately dispatch
    the next step.  The worker is a daemon thread with an explicit join
    path (``close()``/``wait()``); a write failure is re-raised at the
    next ``save()``/``wait()``/``close()`` call, never swallowed.
    """

    def __init__(self, root, keep=None, async_write=True, rank=None):
        self.root = str(root)
        if keep is None:
            keep = int(os.environ.get("MXNET_CHECKPOINT_KEEP", "3"))
        self.keep = max(1, int(keep))
        self._rank = _distributed.world()[0] if rank is None else int(rank)
        self._async = bool(async_write)
        self._q = None
        self._worker = None
        self._stop = threading.Event()
        self._error = None
        self._lock = threading.Lock()

    # -- async plumbing ---------------------------------------------------
    def _ensure_worker(self):
        """The live writer queue, spawning the worker if needed.  The
        whole check-and-replace is one critical section: two racing
        ``save()`` calls used to BOTH see a dead worker and BOTH replace
        ``self._q``, stranding whichever queue lost the race (writes
        silently never hit disk).  The worker drains the queue it was
        born with, so a later generation can never steal its items."""
        with self._lock:
            if self._worker is not None and self._worker.is_alive():
                return self._q
            q = queue.Queue()
            t = threading.Thread(target=self._drain, args=(q,),
                                 daemon=True, name="mxtpu-ckpt-writer")
            self._q = q
            self._worker = t
            t.start()
        return q

    def _drain(self, q):
        while True:
            item = q.get()
            if item is None:
                return
            step, arrays, meta = item
            try:
                self._commit(step, arrays, meta)
            except BaseException as e:  # re-raised at the next call
                with self._lock:
                    self._error = e
            finally:
                q.task_done()

    def _raise_pending(self):
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    # -- API --------------------------------------------------------------
    def save(self, step, arrays, meta=None):
        """Commit one shard (async by default).  ``arrays`` must already
        be host numpy (gather_training_state guarantees that)."""
        self._raise_pending()
        if not self._async:
            self._commit(step, arrays, meta)
            return
        self._ensure_worker().put((int(step), arrays, meta))

    def _commit(self, step, arrays, meta):
        try:
            save_checkpoint(self.root, step, arrays, meta, rank=self._rank)
        except BaseException:
            _saves_counter().labels(outcome="failed").inc()
            _observe.record("checkpoint", "save", step=int(step),
                            rank=self._rank, outcome="failed")
            raise
        _saves_counter().labels(outcome="written").inc()
        _observe.record("checkpoint", "save", step=int(step),
                        rank=self._rank, outcome="written")
        self.prune()

    def wait(self):
        """Block until every queued write is on disk; re-raise the first
        writer error if one occurred."""
        with self._lock:
            q = self._q
        if q is not None:
            q.join()
        self._raise_pending()

    def close(self):
        """Flush pending writes and reap the worker thread.  Ownership
        of the (queue, worker) pair is taken under the lock; the joins
        happen OUTSIDE it so a slow flush never blocks a concurrent
        wait()/save() on the lock itself."""
        with self._lock:
            q, worker = self._q, self._worker
            self._worker = None
        if worker is not None:
            q.join()
            q.put(None)  # wake + exit
            worker.join(timeout=30)
        self._raise_pending()

    def __enter__(self):
        return self

    def __exit__(self, *_exc):
        self.close()

    def prune(self):
        """Keep the newest ``keep`` steps, delete the rest (and this
        rank's leftover tmp dirs from crashed writers: another rank's may
        be a shard it is writing into the same root, which the
        reference's prune deletes, ROADMAP queue C13)."""
        import shutil

        steps = list_steps(self.root)
        for s in steps[:-self.keep] if len(steps) > self.keep else []:
            shutil.rmtree(_step_dir(self.root, s), ignore_errors=True)
        mine = f"-host-{self._rank:05d}-"
        if os.path.isdir(self.root):
            for name in os.listdir(self.root):
                if name.startswith(".tmp-") and mine in name:
                    shutil.rmtree(os.path.join(self.root, name),
                                  ignore_errors=True)

    def restore_latest(self, ranks=None):
        """Newest valid shard for this rank: ``(step, arrays, meta)``.
        A corrupt shard is logged, counted, and skipped — restore falls
        back to the previous checkpoint; ``None`` when nothing valid
        exists.

        ``ranks`` (the reference's elastic path) restricts the search to
        steps whose
        shard validates for EVERY given rank: a host that died mid-save
        leaves its newest step torn — some shards committed, its own
        missing — and restoring it would resume the survivors from
        different steps.  A torn step ticks the restore counter with
        outcome ``torn_fallback`` and the previous complete step is
        used."""
        import logging

        for step in reversed(list_steps(self.root)):
            if ranks is not None:
                try:
                    for r in ranks:
                        _validate_shard(_host_dir(self.root, step, r))
                except CheckpointCorrupt as e:
                    _restores_counter().labels(
                        outcome="torn_fallback").inc()
                    _observe.record("checkpoint", "restore", step=step,
                                    outcome="torn_fallback")
                    logging.getLogger(__name__).warning(
                        "checkpoint step %d incomplete across ranks %s "
                        "(%s); falling back", step, list(ranks), e)
                    continue
            try:
                out = load_checkpoint(self.root, step, rank=self._rank)
            except CheckpointCorrupt as e:
                _restores_counter().labels(outcome="corrupt_fallback").inc()
                _observe.record("checkpoint", "restore", step=step,
                                outcome="corrupt_fallback")
                logging.getLogger(__name__).warning(
                    "checkpoint step %d corrupt (%s); falling back", step, e)
                continue
            except FileNotFoundError:
                continue
            _restores_counter().labels(outcome="ok").inc()
            _observe.record("checkpoint", "restore", step=step,
                            outcome="ok")
            return out
        _restores_counter().labels(outcome="none").inc()
        _observe.record("checkpoint", "restore", step=None,
                        outcome="none")
        return None
