"""faultline: deterministic, seeded fault injection (counterpart of
`mxnet_tpu/resilience/faultline.py`: the same sites, kinds, plans and
arrival counting).

A *fault plan* is a list of specs; each spec names a **site** (an
instrumented code location), a **kind**, and the 1-based **arrival
index** at that site on which it fires (``at``; the older alias
``step`` is accepted — for per-step sites like ``train.grads`` the
arrival index IS the step number).  Sites re-count from 1 after
``clear()``/``plan()``, so a chaos test is reproducible bit for bit.

Sites (each has a hook in the named module of the reference; in the
port, ``collective.dispatch`` waits for the bucketer, ROADMAP queue
A7c):

=================== ======================================================
site                 hook location
=================== ======================================================
kvstore.kv           ``TPUICIStore._kv_try_get`` (coordination KV reads)
kvstore.pushpull     ``TPUICIStore.pushpull`` (per-key collectives)
collective.dispatch  ``GradBucketer._issue_bucket`` (bucketed collectives)
serve.model_call     ``serve.Endpoint._execute`` (batched model call)
serve.replica        ``serve.Fleet`` dispatch (replica-level kill/timeout)
data.iterator        ``io.DevicePrefetcher._pull`` (feeder thread)
checkpoint.write     ``resilience.checkpoint`` shard writer
train.grads          ``FusedTrainStep.step`` (gradient poisoning)
=================== ======================================================

Kinds: ``timeout`` (raises :class:`InjectedTimeout`, a ``TimeoutError`` —
the transient class every retry policy handles), ``error``
(:class:`InjectedError` — non-transient), ``preempt``
(:class:`InjectedPreemption` — the "host died" class; chaos tests catch
it where a real preemption would kill the process), ``nan_grad``
(only meaningful at ``train.grads``: the hook poisons the gradient
rescale factor instead of raising, exercising the finite-grad
step-guard end to end; in the port, the rescale slot of the packed f32
scalars a captured step reads, so a CUDA graph's replay is poisoned
too), and ``dead_node`` (only meaningful at
``kvstore.kv``: the spec's required ``rank`` is registered as
permanently dead — its heartbeat stamp reads stale forever after — so
elastic recovery is drivable from a seeded plan; the liveness pollers
consult :func:`dead_ranks`.  Never raises: a dead peer is something the
*other* hosts observe, not an exception at the reader).

Gray kinds (failures where the process stays alive):

* ``slow`` — the hook sleeps ``delay`` seconds (outside the faultline
  lock) and then proceeds normally: a straggling host, not a dead one.
  Only the straggler-demotion policy can see it.
* ``flaky`` — a seeded intermittent-error pattern over the spec's
  ``times``-arrival window: each arrival in the window independently
  raises :class:`InjectedFlaky` (a ``ConnectionError`` — transient, so
  ``retry_transient`` absorbs it) or passes, per a bit pattern derived
  ONLY from (``seed``, ``times``) — bit-reproducible across fresh plan
  constructions.  At least one arrival in the window always fires.
* ``bitflip`` — corrupts ONE element of a payload the site hands over.
  Bitflip specs live on a separate *payload* arrival channel (counted
  as ``<site>#payload``) so they never perturb the regular arrival
  indices other specs are planned against.  Two hook styles: sites
  holding the payload on host call :func:`corrupt(site, payload)
  <corrupt>`; sites that keep the payload on device (the bucketed
  allreduce) call :func:`poll_payload` and apply the seeded flip
  in-program.  The element/bit are picked from ``seed`` unless the
  spec pins ``index``/``bit`` explicitly.

Registration::

    faultline.plan([{"site": "kvstore.pushpull", "kind": "timeout",
                     "at": 3}])
    # or, for whole-process chaos runs:
    MXNET_FAULTLINE='[{"site": "kvstore.kv", "kind": "timeout"}]'
    MXNET_FAULTLINE=@/path/to/plan.json

``seeded_plan(seed, sites, n_faults, horizon)`` derives a deterministic
random plan from a seed — same seed, same faults, every run.

Every injection ticks ``mxtpu_faults_injected_total{site,kind}``;
recovery code calls :func:`recovered` to tick
``mxtpu_faults_recovered_total{site,kind}`` after surviving one.
"""
from __future__ import annotations

import json
import threading

from .. import observe as _observe
from .. import telemetry as _telemetry

__all__ = [
    "SITES", "KINDS",
    "InjectedFault", "InjectedTimeout", "InjectedError",
    "InjectedPreemption", "InjectedFlaky",
    "plan", "clear", "active_plan", "seeded_plan",
    "check", "poll", "recovered", "arrivals", "raise_fault",
    "dead_ranks", "poll_payload", "corrupt",
]

SITES = ("kvstore.kv", "kvstore.pushpull", "collective.dispatch",
         "serve.model_call", "serve.replica", "data.iterator",
         "checkpoint.write", "train.grads")
KINDS = ("timeout", "error", "preempt", "nan_grad", "dead_node",
         "slow", "flaky", "bitflip")


class InjectedFault(RuntimeError):
    """Base class for every faultline-raised exception."""

    def __init__(self, site, kind, arrival):
        super().__init__(
            f"faultline: injected {kind} at {site} (arrival #{arrival})")
        self.site = site
        self.kind = kind
        self.arrival = arrival


class InjectedTimeout(InjectedFault, TimeoutError):
    """Transient: retry policies treat it like a real deadline miss."""


class InjectedError(InjectedFault):
    """Non-transient: must surface to the caller, not be retried away."""


class InjectedPreemption(InjectedFault):
    """The host-died class: a real one never returns; chaos tests catch
    it at the training-loop boundary and resume from checkpoint."""


class InjectedFlaky(InjectedFault, ConnectionError):
    """A flapping link: transient like a timeout (``ConnectionError`` is
    in ``TRANSIENT_EXCEPTIONS`` so the retry policy absorbs it) but
    distinguishable in the recovery counters — ``.kind == "flaky"``."""


_EXC_BY_KIND = {
    "timeout": InjectedTimeout,
    "error": InjectedError,
    "preempt": InjectedPreemption,
    "flaky": InjectedFlaky,
}


def _flaky_pattern(seed, times):
    """The intermittent fire/pass bit pattern for a flaky spec: one bit
    per arrival in the window, derived ONLY from (seed, times) via the
    stdlib Mersenne generator (stable across Python versions and fresh
    constructions).  Forced nonempty: a flaky spec that never fires is a
    misconfigured test, not a fault."""
    import random as _random

    # string seeds go through the deterministic sha512 path (int tuples
    # would go through process-salted hash())
    rng = _random.Random(f"flaky:{int(seed)}:{int(times)}")
    bits = tuple(rng.getrandbits(1) for _ in range(int(times)))
    if not any(bits):
        bits = (1,) + bits[1:]
    return bits


class _Spec:
    __slots__ = ("site", "kind", "at", "times", "fired", "rank",
                 "delay", "seed", "index", "bit", "pattern")

    def __init__(self, site, kind, at=None, times=1, rank=None,
                 delay=None, seed=0, index=None, bit=None):
        if site not in SITES:
            raise ValueError(f"unknown faultline site {site!r}; "
                             f"one of {SITES}")
        if kind not in KINDS:
            raise ValueError(f"unknown faultline kind {kind!r}; "
                             f"one of {KINDS}")
        if kind == "dead_node" and rank is None:
            raise ValueError(
                "faultline kind 'dead_node' needs an explicit 'rank' "
                "(which peer's heartbeat goes permanently stale)")
        self.site = site
        self.kind = kind
        # `at` is the 1-based arrival index at the site; None = next
        # arrival.  `times` = how many consecutive arrivals fire
        # (times=2 on a timeout exhausts a retry budget of 1, etc.)
        self.at = None if at is None else int(at)
        self.times = max(1, int(times))
        self.fired = 0
        self.rank = None if rank is None else int(rank)
        # gray-kind knobs: `delay` (slow, seconds), `seed` (flaky
        # pattern / bitflip element+bit choice), `index`/`bit` (bitflip
        # pins: flat element index and bit-within-element, little-endian)
        self.delay = 0.05 if delay is None else float(delay)
        self.seed = int(seed)
        self.index = None if index is None else int(index)
        self.bit = None if bit is None else int(bit)
        self.pattern = (_flaky_pattern(self.seed, self.times)
                        if kind == "flaky" else None)

    def matches(self, arrival):
        start = self.at if self.at is not None else 1
        in_window = self.fired < self.times and \
            start <= arrival < start + self.times
        if in_window and self.pattern is not None:
            return bool(self.pattern[arrival - start])
        return in_window

    def to_dict(self):
        d = {"site": self.site, "kind": self.kind,
             "at": self.at, "times": self.times, "fired": self.fired}
        if self.rank is not None:
            d["rank"] = self.rank
        if self.kind == "slow":
            d["delay"] = self.delay
        if self.kind in ("flaky", "bitflip"):
            d["seed"] = self.seed
        if self.index is not None:
            d["index"] = self.index
        if self.bit is not None:
            d["bit"] = self.bit
        return d


class _State:
    def __init__(self):
        self.lock = threading.Lock()
        self.specs = None       # None = env not consulted yet
        self.counts = {}        # site -> arrivals seen
        self.dead_ranks = set()  # ranks killed by fired dead_node specs


_state = _State()


def _injected_counter():
    return _telemetry.counter(
        "mxtpu_faults_injected_total",
        "Faults deliberately injected by the faultline chaos layer, by "
        "site and kind — nonzero outside a chaos run means a fault plan "
        "leaked into production config",
        labelnames=("site", "kind"))


def _recovered_counter():
    return _telemetry.counter(
        "mxtpu_faults_recovered_total",
        "Faults (injected or real) a recovery policy survived — retry "
        "succeeded, step-guard skipped a poisoned update, serve request "
        "re-executed — by site and kind",
        labelnames=("site", "kind"))


def _parse_plan(entries):
    specs = []
    for e in entries:
        if isinstance(e, _Spec):
            specs.append(_Spec(e.site, e.kind, e.at, e.times, e.rank,
                               e.delay, e.seed, e.index, e.bit))
            continue
        at = e.get("at", e.get("step"))
        specs.append(_Spec(e["site"], e["kind"], at, e.get("times", 1),
                           e.get("rank"), e.get("delay"),
                           e.get("seed", 0), e.get("index"),
                           e.get("bit")))
    return specs


def _load_env_plan():
    import os

    raw = os.environ.get("MXNET_FAULTLINE")
    if not raw:
        return []
    if raw.startswith("@"):
        with open(raw[1:], "r", encoding="utf-8") as f:
            raw = f.read()
    return _parse_plan(json.loads(raw))


def plan(entries):
    """Install a fault plan (replacing any active one) and reset every
    site's arrival counter.  ``entries``: dicts with ``site``, ``kind``,
    optional ``at``/``step`` (1-based arrival index) and ``times``."""
    with _state.lock:
        _state.specs = _parse_plan(entries)
        _state.counts = {}
        _state.dead_ranks = set()


def clear():
    """Drop the active plan and arrival counters (also forgets the env
    plan — it is re-read on the next hook arrival only if `plan()` is
    never called)."""
    with _state.lock:
        _state.specs = []
        _state.counts = {}
        _state.dead_ranks = set()


def active_plan():
    """The live specs as dicts (with their fired counts), for tests and
    the dryrun verdict."""
    with _state.lock:
        specs = _state.specs or []
        return [s.to_dict() for s in specs]


def arrivals(site=None):
    """Arrival counters, for assertions on hook coverage."""
    with _state.lock:
        if site is not None:
            return _state.counts.get(site, 0)
        return dict(_state.counts)


def seeded_plan(seed, sites=("kvstore.pushpull", "kvstore.kv"),
                n_faults=2, horizon=10, kinds=("timeout",)):
    """Derive a deterministic plan from ``seed``: ``n_faults`` faults
    spread over the first ``horizon`` arrivals of the given sites.  Same
    seed -> identical plan, every process, every run."""
    import numpy as onp

    rng = onp.random.default_rng(int(seed))
    entries = []
    for _ in range(int(n_faults)):
        entries.append({
            "site": sites[int(rng.integers(len(sites)))],
            "kind": kinds[int(rng.integers(len(kinds)))],
            "at": int(rng.integers(1, max(2, int(horizon)))),
        })
    return entries


def _arrive(site, payload=False):
    """Advance the site's arrival counter; return the matched spec or
    None.  Lazily consults MXNET_FAULTLINE on the first arrival ever.

    ``payload=True`` is the separate payload-arrival channel (counted
    under ``<site>#payload``): only ``bitflip`` specs match it, and
    bitflip specs match ONLY it — so adding a payload hook to a site
    never shifts the regular arrival indices existing plans target."""
    key = f"{site}#payload" if payload else site
    with _state.lock:
        if _state.specs is None:
            # read once, under the lock, so that no arrival slips past
            # an empty plan
            _state.specs = _load_env_plan()
        n = _state.counts.get(key, 0) + 1
        _state.counts[key] = n
        if not _state.specs:
            return None
        for s in _state.specs:
            if s.site == site and (s.kind == "bitflip") == payload \
                    and s.matches(n):
                s.fired += 1
                if s.kind == "dead_node":
                    # permanent: the rank stays dead until the plan is
                    # replaced/cleared — every later liveness poll sees it
                    _state.dead_ranks.add(s.rank)
                return s
        return None


def dead_ranks():
    """Ranks killed by fired ``dead_node`` specs (permanently stale
    heartbeats).  Consulted by the liveness pollers —
    ``TPUICIStore.get_dead_nodes`` and ``elastic.EmulatedPod`` — so a
    planned host death is observed exactly like a real one."""
    with _state.lock:
        return frozenset(_state.dead_ranks)


def poll(site):
    """Non-raising hook: returns the matched kind (string) or None.
    Used by sites that act on the fault themselves (``train.grads``
    poisons the rescale factor instead of raising)."""
    spec = _arrive(site)
    if spec is None:
        return None
    _injected_counter().labels(site=site, kind=spec.kind).inc()
    _observe.record("fault", f"{site}/{spec.kind}", site=site,
                    kind=spec.kind, rank=spec.rank,
                    arrival=_state.counts[site])
    if spec.kind == "slow":
        _sleep_slow(spec)
    return spec.kind


def check(site):
    """Raising hook: no-op when no fault matches this arrival, else
    raises the kind's exception class (``nan_grad`` never raises — it is
    returned by :func:`poll` at the one site that understands it;
    ``slow`` sleeps the spec's delay and returns normally)."""
    spec = _arrive(site)
    if spec is None:
        return
    _injected_counter().labels(site=site, kind=spec.kind).inc()
    _observe.record("fault", f"{site}/{spec.kind}", site=site,
                    kind=spec.kind, rank=spec.rank,
                    arrival=_state.counts[site])
    if spec.kind == "slow":
        _sleep_slow(spec)
        return
    exc = _EXC_BY_KIND.get(spec.kind)
    if exc is not None:
        raise exc(site, spec.kind, _state.counts[site])


def _sleep_slow(spec):
    """The straggler delay — always OUTSIDE the faultline lock (a slow
    site must not serialize every other site's hooks behind it)."""
    import time

    time.sleep(spec.delay)


def poll_payload(site):
    """Payload-channel hook for sites that keep the payload on device:
    advances the ``<site>#payload`` arrival counter and, when a
    ``bitflip`` spec fires, returns its targeting knobs
    ``{"seed", "index", "bit", "rank"}`` (else None).  The caller
    applies the seeded corruption itself — the bucketed allreduce turns
    this into an in-program perturbation input so injection never
    forces a host round-trip."""
    spec = _arrive(site, payload=True)
    if spec is None:
        return None
    _injected_counter().labels(site=site, kind="bitflip").inc()
    _observe.record("fault", f"{site}/bitflip", site=site, kind="bitflip",
                    rank=spec.rank, channel="payload")
    return {"seed": spec.seed, "index": spec.index, "bit": spec.bit,
            "rank": spec.rank}


def corrupt(site, payload):
    """Payload-channel hook for sites holding the payload on host:
    advances the ``<site>#payload`` arrival counter and, when a
    ``bitflip`` spec fires, returns a copy of ``payload`` with ONE bit
    of ONE element flipped (seeded choice unless the spec pins
    ``index``/``bit``).  Otherwise returns ``payload`` unchanged.
    Handles numpy arrays, tuples/lists of them (first array corrupted),
    bytes, and str."""
    spec = _arrive(site, payload=True)
    if spec is None:
        return payload
    _injected_counter().labels(site=site, kind="bitflip").inc()
    _observe.record("fault", f"{site}/bitflip", site=site, kind="bitflip",
                    rank=spec.rank, channel="payload")
    return _flip(payload, spec)


def _flip(payload, spec):
    import random as _random

    import numpy as onp

    rng = _random.Random(f"bitflip:{spec.seed}")
    if isinstance(payload, (tuple, list)):
        out = list(payload)
        for i, item in enumerate(out):
            if isinstance(item, onp.ndarray):
                out[i] = _flip(item, spec)
                break
        return type(payload)(out) if isinstance(payload, tuple) else out
    if isinstance(payload, onp.ndarray):
        flat = onp.array(payload, copy=True).reshape(-1)
        idx = spec.index if spec.index is not None \
            else rng.randrange(flat.size)
        nbits = flat.itemsize * 8
        bit = spec.bit if spec.bit is not None else rng.randrange(nbits)
        raw = flat.view(onp.uint8)
        # little-endian bit order within the element: bit 30 of a
        # float32 is the exponent MSB — the classic silent-corruption
        # magnitude explosion
        raw[idx * flat.itemsize + bit // 8] ^= onp.uint8(1 << (bit % 8))
        return flat.reshape(payload.shape)
    if isinstance(payload, (bytes, bytearray)):
        buf = bytearray(payload)
        idx = spec.index if spec.index is not None \
            else rng.randrange(len(buf))
        bit = spec.bit if spec.bit is not None else rng.randrange(8)
        buf[idx] ^= 1 << (bit % 8)
        return bytes(buf)
    if isinstance(payload, str):
        enc = _flip(payload.encode("utf-8", "surrogatepass"), spec)
        return enc.decode("utf-8", "replace")
    return payload


def raise_fault(site, kind, arrival=None):
    """Raise the exception class for ``kind`` — for poll-style sites
    that self-handle one kind (``train.grads`` + ``nan_grad``) but must
    still surface the raising kinds like any other hook."""
    exc = _EXC_BY_KIND.get(kind)
    if exc is not None:
        raise exc(site, kind,
                  arrival if arrival is not None else arrivals(site))


def recovered(site, kind):
    """Tick ``mxtpu_faults_recovered_total`` — call after a recovery
    policy survived a fault (injected or real) at ``site``."""
    _recovered_counter().labels(site=site, kind=kind).inc()
    _observe.record("recovery", f"{site}/{kind}", site=site, kind=kind)
