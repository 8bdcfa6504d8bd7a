"""The port's `mx.random` against the JAX package's, in one process.

- ``seed``, ``new_key``, ``advance``, ``root_and_counter`` and
  ``key_stream_scope`` hand out the reference's key words bit for bit
  (the port's keys are int64 tensors of two uint32 words, the
  reference's typed jax keys, compared through ``jax.random.key_data``);
- ``host_rng`` draws the reference's numbers bit for bit, in the calling
  thread and in threads made after ``seed``;
- ``seed`` seeds the default generator that train-mode draws take when
  no scope names one;
- the samplers raise and name ROADMAP queue A10.

Both packages' global random state is put back after each test, so no
later test in the same process sees a seed of this file.
"""
import threading

import jax
import numpy as onp
import pytest
import torch

import mxnet_tpu.random as ref
import mxnet_tpu_torch.random as port
from mxnet_tpu_torch import autograd, npx
from mxnet_tpu_torch.ops import invoke
from mxnet_tpu_torch.ops import threefry

torch.set_num_threads(1)

SEEDS = [0, 1, 42, 2 ** 31 - 1, 2 ** 31 + 7, 2 ** 32 + 5]


def _save(mod):
    st = mod._state
    return (st.root, st.counter, list(st.stack), st.host,
            st.host_seeded_with, list(mod._host_seed), list(mod._host_spawn))


def _load(mod, saved):
    st = mod._state
    (st.root, st.counter, stack, st.host, st.host_seeded_with,
     mod._host_seed[:], mod._host_spawn[:]) = saved
    st.stack[:] = stack


@pytest.fixture(autouse=True)
def _isolated():
    saved = (_save(ref), _save(port))
    gen = invoke.set_default_generator(None)
    yield
    _load(ref, saved[0])
    _load(port, saved[1])
    invoke.set_default_generator(gen)


def _words(key):
    """Two uint32 words of a jax key or of a port key."""
    if isinstance(key, torch.Tensor):
        return [int(w) for w in key.tolist()]
    return [int(w) for w in onp.asarray(jax.random.key_data(key))]


@pytest.mark.parametrize("seed", SEEDS)
def test_key_stream_is_the_reference_s(seed):
    ref.seed(seed)
    port.seed(seed)
    assert _words(port._state.root) == _words(ref._state.root)
    for _ in range(3):
        assert _words(port.new_key()) == _words(ref.new_key())
    ref.advance(5)
    port.advance(5)
    assert _words(port.new_key()) == _words(ref.new_key())
    (r_root, r_n), (p_root, p_n) = ref.root_and_counter(), \
        port.root_and_counter()
    assert p_n == r_n == 10
    assert _words(p_root) == _words(r_root)
    assert _words(threefry.fold_in(p_root, p_n)) == \
        _words(jax.random.fold_in(r_root, r_n))
    base_r, base_p = ref.new_key(), port.new_key()
    with ref.key_stream_scope(base_r) as sr, \
            port.key_stream_scope(base_p) as sp:
        for _ in range(2):
            assert _words(port.new_key()) == _words(ref.new_key())
        assert sr.n == sp.n == 2
    assert ref._state.counter == port._state.counter == 11


@pytest.mark.parametrize("seed", [3, 2024])
def test_host_rng_draws_are_the_reference_s(seed):
    ref.seed(seed)
    port.seed(seed)
    assert onp.array_equal(port.host_rng().random(5), ref.host_rng().random(5))
    assert onp.array_equal(port.host_rng().integers(0, 100, 7),
                           ref.host_rng().integers(0, 100, 7))
    got = {}

    def draw(mod, tag):
        got[tag] = mod.host_rng().standard_normal(4)

    for mod, tag in ((ref, "ref"), (port, "port")):
        t = threading.Thread(target=draw, args=(mod, tag))
        t.start()
        t.join()
    assert onp.array_equal(got["ref"], got["port"])


def test_seed_seeds_the_default_generator():
    """Without a scope's generator a train-mode draw raises until
    ``seed``; then it takes the default generator, which ``seed`` puts
    back at the same words."""
    x = torch.ones(64)
    with autograd.train_mode():
        with pytest.raises(ValueError, match="Generator"):
            npx.dropout(x, p=0.5)
        port.seed(7)
        a = npx.dropout(x, p=0.5)
        port.seed(7)
        b = npx.dropout(x, p=0.5)
    assert torch.equal(a, b)
    assert port.default_generator() is invoke.default_generator()
    with autograd.train_mode(generator=torch.Generator().manual_seed(1)):
        c = npx.dropout(x, p=0.5)          # the scope's generator wins
    port.seed(7)
    with autograd.train_mode():
        d = npx.dropout(x, p=0.5)
    assert torch.equal(d, a) and not torch.equal(c, a)


@pytest.mark.parametrize("name,args", [("uniform", ()), ("normal", ()),
                                       ("randint", (0, 5))])
def test_samplers_name_their_queue(name, args):
    with pytest.raises(NotImplementedError, match="A10"):
        getattr(port, name)(*args)
