"""The port's RecordIO files and host library against the JAX package's.

Held here, on the CPU, bitwise:

- a file written by either package is byte for byte the other's, and
  each package reads the other's records back (sequential and indexed,
  with label arrays in the `IRHeader`, odd record lengths for the
  padding);
- ``pack`` / ``unpack`` give the same bytes and headers;
- ``pack_img`` / ``unpack_img`` (Pillow on both sides) give the same
  bytes and the same decoded pixels;
- `RecordFileDataset` reads the same records as the reference's.

And the port's own contract: the host library is built by g++ into
``build/host/`` keyed by a hash of its sources; a source that does not
compile raises with the compiler's message (there is no pure-Python
fallback); the JPEG probe finds libjpeg on this machine.
"""
import numpy as onp
import pytest
import torch

from mxnet_tpu import recordio as ref_rio
from mxnet_tpu.gluon.data import RecordFileDataset as RefRecordFileDataset
from mxnet_tpu_torch import _native
from mxnet_tpu_torch import recordio
from mxnet_tpu_torch.gluon.data import RecordFileDataset

torch.set_num_threads(1)


def _records(n=17, seed=3):
    rs = onp.random.RandomState(seed)
    out = []
    for i in range(n):
        payload = rs.bytes(int(rs.randint(0, 70)))
        label = float(i) if i % 3 else rs.rand(i % 5 + 2).astype(onp.float32)
        out.append(((0, label, i, 7 * i), payload))
    return out


def _write(pkg, path, records, indexed=False):
    if indexed:
        w = pkg.MXIndexedRecordIO(str(path) + ".idx", str(path), "w")
    else:
        w = pkg.MXRecordIO(str(path), "w")
    for i, (hdr, payload) in enumerate(records):
        buf = pkg.pack(pkg.IRHeader(*hdr), payload)
        if indexed:
            w.write_idx(i, buf)
        else:
            w.write(buf)
    w.close()


@pytest.mark.parametrize("indexed", [False, True])
def test_files_are_bitwise_the_references_both_ways(tmp_path, indexed):
    records = _records()
    mine, theirs = tmp_path / "mine.rec", tmp_path / "theirs.rec"
    _write(recordio, mine, records, indexed)
    _write(ref_rio, theirs, records, indexed)
    assert mine.read_bytes() == theirs.read_bytes()
    if indexed:
        assert (tmp_path / "mine.rec.idx").read_text() == \
            (tmp_path / "theirs.rec.idx").read_text()
    for reader_pkg, path in ((recordio, theirs), (ref_rio, mine)):
        if indexed:
            r = reader_pkg.MXIndexedRecordIO(str(path) + ".idx", str(path),
                                             "r")
            got = [r.read_idx(k) for k in reversed(r.keys)][::-1]
        else:
            r = reader_pkg.MXRecordIO(str(path), "r")
            got = []
            while (buf := r.read()) is not None:
                got.append(buf)
        r.close()
        assert len(got) == len(records)
        for buf, (hdr, payload) in zip(got, records):
            h, s = reader_pkg.unpack(buf)
            assert s == payload
            assert (h.id, h.id2) == (hdr[2], hdr[3])
            onp.testing.assert_array_equal(onp.asarray(h.label),
                                           onp.asarray(hdr[1], onp.float32))


def test_pack_and_unpack_equal_the_references():
    for hdr, payload in _records():
        mine = recordio.pack(recordio.IRHeader(*hdr), payload)
        theirs = ref_rio.pack(ref_rio.IRHeader(*hdr), payload)
        assert mine == theirs
        (hm, sm), (ht, st) = recordio.unpack(mine), ref_rio.unpack(theirs)
        assert sm == st and (hm.flag, hm.id, hm.id2) == \
            (ht.flag, ht.id, ht.id2)
        onp.testing.assert_array_equal(onp.asarray(hm.label),
                                       onp.asarray(ht.label))


@pytest.mark.parametrize("fmt", [".jpg", ".png"])
def test_pack_img_and_unpack_img_equal_the_references(fmt):
    img = onp.random.RandomState(0).randint(0, 255, (24, 40, 3), onp.uint8)
    hdr = (0, 5.0, 2, 0)
    mine = recordio.pack_img(recordio.IRHeader(*hdr), img, quality=90,
                             img_fmt=fmt)
    theirs = ref_rio.pack_img(ref_rio.IRHeader(*hdr), img, quality=90,
                              img_fmt=fmt)
    assert mine == theirs
    h, decoded = recordio.unpack_img(mine)
    _, ref_decoded = ref_rio.unpack_img(theirs)
    assert h.label == 5.0 and decoded.dtype == torch.uint8
    onp.testing.assert_array_equal(decoded.numpy(), onp.asarray(ref_decoded))
    if fmt == ".png":
        onp.testing.assert_array_equal(decoded.numpy(), img)


def test_record_file_dataset_reads_the_references_records(tmp_path):
    path = tmp_path / "d.rec"
    _write(ref_rio, path, _records(9), indexed=True)
    # the dataset looks for the .idx beside the .rec, without the suffix
    (tmp_path / "d.idx").write_text((tmp_path / "d.rec.idx").read_text())
    mine, theirs = RecordFileDataset(str(path)), \
        RefRecordFileDataset(str(path))
    assert len(mine) == len(theirs) == 9
    assert [mine[i] for i in range(9)] == [theirs[i] for i in range(9)]


def test_host_library_is_built_by_gxx_into_build_host():
    path = _native.build("host")
    assert path.parent == _native.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "host")
    assert path.name.startswith("host-") and path.exists()
    assert _native.SRC.parts[-3:] == ("mxnet_tpu_torch", "csrc", "host")
    assert _native.jpeg_unavailable() is None
    assert _native.build("img").name.startswith("img-")


def test_a_source_that_does_not_compile_raises_with_the_message(
        tmp_path, monkeypatch):
    (tmp_path / "broken.cc").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(_native, "SRC", tmp_path)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setitem(_native._LIBS, "broken", (("broken.cc",), ()))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*broken"):
        _native.build("broken")


def test_reader_and_writer_errors_raise():
    with pytest.raises(IOError):
        recordio.MXRecordIO("/nonexistent-dir/x.rec", "r")
    with pytest.raises(ValueError, match="Invalid flag"):
        recordio.MXRecordIO("x.rec", "a")
