"""Random state (counterpart of `mxnet_tpu/random.py`).

The reference keeps a stateful key stream over ``jax.random``: a root
key, advanced by one `fold_in` a draw.  The port keeps the same stream
over its own threefry (`ops.threefry`), so ``seed``, `new_key`,
`advance` and `root_and_counter` hand out the reference's key words bit
for bit: a key is an int64 (2,) tensor holding two uint32 words, as
`ops.threefry` takes it, where the reference holds a typed jax key.
`host_rng` is numpy's ``default_rng`` over the same ``SeedSequence``
spawn as the reference's, so its draws are the reference's too.

Train-mode randomness in the port (dropout masks, the flash kernels'
attention dropout) draws its seed words from a CPU ``torch.Generator``
(`ops.seeds`).  A scope names one (``autograd.record(generator=...)``);
where it names none, the draws take this module's default generator,
which `seed` seeds.  Before the first `seed` there is none, and a draw
without a scope's generator raises, as before.  The default generator
is one for the process, not one a thread.

The samplers `uniform`, `normal` and `randint` are the reference's shims
over ``mx.np.random``, which the port does not have yet (ROADMAP queue
A10): they raise.
"""
from __future__ import annotations

import threading

import numpy as onp
import torch

from .ops import invoke as _invoke
from .ops import threefry as _threefry

__all__ = ["seed", "new_key", "advance", "key_stream_scope", "uniform",
           "normal", "randint", "host_rng", "root_and_counter",
           "default_generator"]

_M32 = 0xFFFFFFFF


def _key(seed_state):
    """``jax.random.key(seed_state)``'s two words: the high word of the
    seed taken as a 32-bit integer (always 0) and its low 32 bits."""
    return _threefry.key_of((0, int(seed_state) & _M32))


class _KeyState(threading.local):
    def __init__(self):
        self.root = _key(0)
        self.counter = 0
        self.stack = []  # key stream scopes
        self.host = None  # lazy host-side Generator (image aug scalars)
        self.host_seeded_with = None


_state = _KeyState()

# process-wide host seed, so that threads made after seed() derive
# deterministic streams (one numpy Generator a thread, spawned in the
# order the threads first ask for one)
_host_seed = [(0, None)]
_host_spawn = [0]
_host_lock = threading.Lock()


def host_rng():
    """This thread's host numpy Generator for dispatch-time draws (image
    augmentation factors, crop offsets): deterministic once `seed` has
    set the process-wide seed, each thread an independent stream
    spawned from it in the order threads ask."""
    if _state.host is None or _state.host_seeded_with != _host_seed[0]:
        gen, seed_val = _host_seed[0]
        with _host_lock:
            idx = _host_spawn[0]
            _host_spawn[0] += 1
        if seed_val is None:
            _state.host = onp.random.default_rng()
        else:
            _state.host = onp.random.default_rng(
                onp.random.SeedSequence(seed_val).spawn(idx + 1)[idx])
        _state.host_seeded_with = _host_seed[0]
    return _state.host


class KeyStream:
    """Deterministic stream of subkeys folded from a base key."""

    def __init__(self, base_key):
        self.base = base_key
        self.n = 0

    def next(self):
        self.n += 1
        return _threefry.fold_in(self.base, self.n)


def default_generator():
    """The CPU ``torch.Generator`` that train-mode draws take where the
    scope names none (None before the first `seed`)."""
    return _invoke.default_generator()


def seed(seed_state, ctx="all"):
    """Reset the key stream to ``seed_state``'s root key, the host
    streams to the seed, and seed the default generator
    (`default_generator`) with it.  ``ctx`` is kept for the reference's
    signature: the stream does not depend on the device."""
    s = int(seed_state)
    _state.root = _key(s)
    _state.counter = 0
    _host_seed[0] = (_host_seed[0][0] + 1, s)
    _host_spawn[0] = 0
    _state.host = onp.random.default_rng(s)
    _state.host_seeded_with = _host_seed[0]
    gen = _invoke.default_generator()
    if gen is None:
        gen = torch.Generator()
        _invoke.set_default_generator(gen)
    gen.manual_seed(s & ((1 << 64) - 1))


def new_key():
    """The next key: from the innermost `key_stream_scope` if one is
    active, else by advancing the global stream (``fold_in(root,
    counter)``)."""
    if _state.stack:
        return _state.stack[-1].next()
    _state.counter += 1
    return _threefry.fold_in(_state.root, _state.counter)


def advance(n):
    """Skip the global stream forward by ``n`` draws: the next
    `new_key()` returns what the (n+1)-th call would have."""
    _state.counter += int(n)


def root_and_counter():
    """Advance the global stream as `new_key()` does, but return
    ``(root_key, counter)``: ``fold_in(root, counter)`` is the key
    `new_key()` would have returned."""
    _state.counter += 1
    return _state.root, _state.counter


class key_stream_scope:
    """Push a base key for the duration of a scope: `new_key()` folds
    from it instead of advancing the global stream."""

    def __init__(self, base_key):
        self.stream = KeyStream(base_key)

    def __enter__(self):
        _state.stack.append(self.stream)
        return self.stream

    def __exit__(self, *_exc):
        _state.stack.pop()


def _sampler(name):
    raise NotImplementedError(
        f"mx.random.{name} draws through mx.np.random, which the port does "
        "not have yet (ROADMAP queue A10, surface breadth)")


def uniform(low=0, high=1, shape=(), dtype=None, ctx=None, out=None,
            device=None):
    _sampler("uniform")


def normal(loc=0, scale=1, shape=(), dtype=None, ctx=None, out=None,
           device=None):
    _sampler("normal")


def randint(low, high=None, shape=(), dtype=None, ctx=None, out=None,
            device=None):
    _sampler("randint")
