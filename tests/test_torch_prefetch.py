"""The port's ``DevicePrefetcher`` (mirroring `test_device_prefetch.py`).

On the CPU (``ctx=cpu()``) the prefetcher is a plain ordered queue fed
by its thread; its card path (pinned slots, a side stream, events) runs
in ``chip_smoke.py``'s recordio phase.  Held here: batches keep their
order and equal the reference prefetcher's for the same source; the
host casts of ``dtypes=``; a callable and a ``DataIter`` as sources;
``reset`` replays the stream; ``close`` and the context manager join
the feeder, also when the consuming loop raises; an exception of the
source (first, mid-stream, or in the cast) reaches the consumer; the
depth's default from ``MXNET_PREFETCH_DEPTH``; ``sharding=`` raises and
names the roadmap item; without ``ctx`` it targets the card, which
raises without CUDA.
"""
import threading

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu_torch import MXNetError, cpu
from mxnet_tpu_torch.io import DevicePrefetcher, NDArrayIter

torch.set_num_threads(1)


def _batches(n=5):
    return [(onp.full((4, 3), i, onp.float32),
             onp.arange(4, dtype=onp.float32) + i) for i in range(n)]


def test_order_and_values_equal_the_reference_prefetcher():
    batches = _batches()
    mine = list(DevicePrefetcher(iter(batches), ctx=cpu(), depth=2))
    theirs = list(mx.io.DevicePrefetcher(iter(batches), depth=2))
    assert len(mine) == len(theirs) == 5
    for (x, y), (rx, ry), (hx, hy) in zip(mine, theirs, batches):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        onp.testing.assert_array_equal(x.numpy(), rx.asnumpy())
        onp.testing.assert_array_equal(y.numpy(), ry.asnumpy())
        onp.testing.assert_array_equal(x.numpy(), hx)


def test_stop_iteration_ends_the_stream():
    pf = DevicePrefetcher(iter(_batches(2)), ctx=cpu(), depth=1)
    assert len(list(pf)) == 2
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()


def test_dtype_cast_on_the_host_and_a_callable_source():
    calls = []

    def src():
        calls.append(1)
        if len(calls) > 3:
            raise StopIteration
        return (onp.zeros((2, 2), onp.uint8),
                onp.array([1.0, 2.0], onp.float32))

    pf = DevicePrefetcher(src, ctx=cpu(), depth=1, dtypes=(None, onp.int32))
    x, y = next(pf)
    assert x.dtype == torch.uint8 and y.dtype == torch.int32
    assert y.tolist() == [1, 2]
    assert len(list(pf)) == 2
    pf.close()


def test_dataiter_source_and_reset():
    data = onp.random.default_rng(0).uniform(size=(10, 4)).astype(onp.float32)
    labels = onp.arange(10, dtype=onp.float32)
    pf = DevicePrefetcher(NDArrayIter(data, labels, batch_size=5), ctx=cpu(),
                          depth=2)
    first = list(pf)
    assert len(first) == 2
    pf.reset()
    second = list(pf)
    assert len(second) == 2
    for a, b in zip(first, second):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    onp.testing.assert_array_equal(first[0][0].numpy(), data[:5])
    assert pf.stats()["batches"] == 4
    batch = DevicePrefetcher(NDArrayIter(data, labels, batch_size=5),
                             ctx=cpu()).next_batch()
    onp.testing.assert_array_equal(batch.label[0].numpy(), labels[:5])
    pf.close()


def _feeders():
    return [t for t in threading.enumerate()
            if t.name == "mxnet-device-prefetch" and t.is_alive()]


def test_close_and_the_context_manager_join_the_feeder():
    before = set(_feeders())
    with pytest.raises(RuntimeError, match="user code blew up"):
        with DevicePrefetcher(iter([(onp.zeros((2, 2), onp.float32),)] * 8),
                              ctx=cpu(), depth=2) as pf:
            next(pf)
            raise RuntimeError("user code blew up")
    pf2 = DevicePrefetcher(iter(_batches(50)), ctx=cpu(), depth=1)
    next(pf2)
    pf2.close()
    assert not set(_feeders()) - before


def test_an_error_of_the_source_reaches_the_consumer():
    def bad():
        raise ValueError("decode exploded")

    pf = DevicePrefetcher(bad, ctx=cpu(), depth=1)
    with pytest.raises(ValueError, match="decode exploded"):
        next(pf)
    pf.close()

    def gen():
        yield (onp.zeros((2, 2), onp.float32),)
        yield (onp.ones((2, 2), onp.float32),)
        raise RuntimeError("source died mid-stream")

    pf = DevicePrefetcher(gen(), ctx=cpu(), depth=1)
    assert next(pf)[0].max().item() == 0.0
    assert next(pf)[0].max().item() == 1.0
    with pytest.raises(RuntimeError, match="mid-stream"):
        next(pf)
    pf.close()

    pf = DevicePrefetcher(iter([(onp.array(["a", "b"], dtype=object),)]),
                          ctx=cpu(), depth=1, dtypes=(onp.float32,))
    with pytest.raises((TypeError, ValueError)):
        next(pf)
    pf.close()


def test_depth_default_from_the_environment(monkeypatch):
    monkeypatch.setenv("MXNET_PREFETCH_DEPTH", "5")
    pf = DevicePrefetcher(iter([]), ctx=cpu())
    assert pf._depth == 5
    pf.close()


def test_sharding_and_the_default_card():
    with pytest.raises(NotImplementedError, match="A7d"):
        DevicePrefetcher(iter([]), ctx=cpu(), sharding=object())
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(MXNetError, match="CUDA is not available"):
        DevicePrefetcher(iter([]))
