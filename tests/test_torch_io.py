"""The port's legacy data iterators against the JAX package's.

The same inputs go through both packages' iterators on the CPU, and
every batch must be equal, bitwise (data, labels, ``pad``): `NDArrayIter`
with each last-batch policy over two epochs, with shuffling (numpy's
global generator, seeded the same before each package's run) and with
dict inputs (sorted by name); `CSVIter` and `LibSVMIter` over files
written here (CSR batches compared densely); `ResizeIter`,
`PrefetchingIter` (also its worker's exception reaching the consumer)
and `BucketSentenceIter`; `DataDesc`.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu_torch import io as pio

torch.set_num_threads(1)


def _np(a):
    if isinstance(a, torch.Tensor):
        return (a.to_dense() if a.layout == torch.sparse_csr else a).numpy()
    if hasattr(a, "todense"):
        return onp.asarray(a.todense().asnumpy() if hasattr(
            a.todense(), "asnumpy") else a.todense())
    return a.asnumpy()


def _drain(it, epochs=1):
    out = []
    for e in range(epochs):
        if e:
            it.reset()
        for b in it:
            out.append(([_np(d) for d in b.data],
                        [_np(lb) for lb in (b.label or [])], b.pad))
    return out


def _assert_same(mine, theirs):
    assert len(mine) == len(theirs)
    for (d1, l1, p1), (d2, l2, p2) in zip(mine, theirs):
        assert p1 == p2
        assert len(d1) == len(d2) and len(l1) == len(l2)
        for a, b in zip(d1 + l1, d2 + l2):
            assert a.shape == b.shape
            onp.testing.assert_array_equal(a, b)


def _data(n=10):
    rng = onp.random.default_rng(0)
    return (rng.uniform(size=(n, 3)).astype(onp.float32),
            onp.arange(n, dtype=onp.float32))


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarrayiter_equals_the_reference(handle, shuffle):
    x, y = _data()
    runs = []
    for pkg in (pio, mx.io):
        onp.random.seed(4)
        it = pkg.NDArrayIter(x, y, batch_size=4, shuffle=shuffle,
                             last_batch_handle=handle)
        runs.append(_drain(it, epochs=2))
    _assert_same(*runs)


def test_ndarrayiter_dict_inputs_and_descriptions():
    x, y = _data(8)
    data = {"b": x, "a": x[:, :2] * 2}
    mine = pio.NDArrayIter(data, {"lab": y}, batch_size=4)
    theirs = mx.io.NDArrayIter(data, {"lab": y}, batch_size=4)
    assert [d.name for d in mine.provide_data] == ["a", "b"]
    assert [tuple(d.shape) for d in mine.provide_data] == \
        [tuple(d.shape) for d in theirs.provide_data]
    _assert_same(_drain(mine), _drain(theirs))
    desc = pio.DataDesc("data", (2, 3), layout="NTC")
    assert desc.layout == "NTC" and pio.DataDesc.get_batch_axis("TNC") == 1


def test_csviter_equals_the_reference(tmp_path):
    x, y = _data(7)
    onp.savetxt(tmp_path / "d.csv", x.reshape(7, 3), delimiter=",")
    onp.savetxt(tmp_path / "l.csv", y, delimiter=",")
    args = dict(data_csv=str(tmp_path / "d.csv"), data_shape=(3,),
                label_csv=str(tmp_path / "l.csv"), batch_size=3)
    _assert_same(_drain(pio.CSVIter(**args), 2),
                 _drain(mx.io.CSVIter(**args), 2))


def test_libsvmiter_equals_the_reference(tmp_path):
    lines = ["1 0:1.5 3:2.0", "0 2:-1", "1", "0 1:0.25 4:3 5:1e-3",
             "1 5:7 # comment"]
    (tmp_path / "d.svm").write_text("\n".join(lines) + "\n")
    for kw in (dict(batch_size=2), dict(batch_size=2, round_batch=False),
               dict(batch_size=3, data_shape=(8,))):
        mine = pio.LibSVMIter(str(tmp_path / "d.svm"), **kw)
        theirs = mx.io.LibSVMIter(str(tmp_path / "d.svm"), **kw)
        got, want = _drain(mine), _drain(theirs)
        _assert_same(got, want)
        assert mine.provide_data[0].shape == theirs.provide_data[0].shape
    batch = pio.LibSVMIter(str(tmp_path / "d.svm"), batch_size=2).next()
    assert batch.data[0].layout == torch.sparse_csr


def test_resizeiter_equals_the_reference():
    x, y = _data()
    mine = pio.ResizeIter(pio.NDArrayIter(x, y, batch_size=4), 7)
    theirs = mx.io.ResizeIter(mx.io.NDArrayIter(x, y, batch_size=4), 7)
    _assert_same(_drain(mine, 2), _drain(theirs, 2))


def test_prefetchingiter_equals_the_reference():
    x, y = _data(12)
    mine = pio.PrefetchingIter([pio.NDArrayIter(x, y, batch_size=4),
                                pio.NDArrayIter(x * 2, y, batch_size=4)])
    theirs = mx.io.PrefetchingIter([mx.io.NDArrayIter(x, y, batch_size=4),
                                    mx.io.NDArrayIter(x * 2, y,
                                                      batch_size=4)])
    try:
        assert mine.batch_size == 8
        _assert_same(_drain(mine, 2), _drain(theirs, 2))
    finally:
        mine.close()
        theirs.close()


def test_prefetchingiter_passes_on_its_workers_error():
    class Bad(pio.NDArrayIter):
        def next(self):
            raise ValueError("worker failed")

    x, y = _data(8)
    it = pio.PrefetchingIter(Bad(x, y, batch_size=4))
    try:
        with pytest.raises(ValueError, match="worker failed"):
            it.next()
    finally:
        it.close()


def test_bucketsentenceiter_equals_the_reference():
    rng = onp.random.default_rng(1)
    sentences = [list(rng.integers(1, 50, int(n)))
                 for n in rng.integers(2, 12, 60)]
    runs = []
    for pkg in (pio, mx.io):
        onp.random.seed(2)
        it = pkg.BucketSentenceIter(sentences, batch_size=4,
                                    buckets=[4, 8, 12])
        keys = []
        out = []
        for _ in range(2):
            it.reset()
            for b in it:
                keys.append(b.bucket_key)
                out.append(([_np(b.data[0])], [_np(b.label[0])], b.pad))
        runs.append((keys, out))
    assert runs[0][0] == runs[1][0]
    _assert_same(runs[0][1], runs[1][1])
