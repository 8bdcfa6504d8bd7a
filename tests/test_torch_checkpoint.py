"""Checkpoints across the two packages: parameter files
(``save_parameters`` / ``load_parameters``, the JAX package's ``.npz``
format and upstream's binary 0x112 format) and trainer-state files
(``Trainer.save_states`` / ``load_states``), in both directions, and a
save, load and step that equals the uninterrupted step.

Values cross bitwise: the formats carry the arrays' bytes, so every
comparison here is exact.
"""
import pickle

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as ref_ag
from mxnet_tpu.gluon import Trainer as RefTrainer
from mxnet_tpu.gluon.model_zoo import vision as ref_vision
from mxnet_tpu.utils import legacy_format as ref_legacy
from mxnet_tpu.utils.serialization import load_ndarrays as ref_load
from mxnet_tpu.utils.serialization import save_ndarrays as ref_save
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import autograd, cpu
from mxnet_tpu_torch.gluon import Trainer
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.utils import legacy_format
from mxnet_tpu_torch.utils.convert import load_reference_params
from mxnet_tpu_torch.utils.serialization import load_ndarrays, save_ndarrays

torch.set_num_threads(1)

SPEC = ([1, 1, 1, 1], [8, 16, 32, 64, 128])
B, HW, CLASSES = 2, 32, 10


def _batch(seed=0):
    rng = onp.random.default_rng(seed)
    return (rng.uniform(-1, 1, (B, 3, HW, HW)).astype(onp.float32),
            rng.integers(0, CLASSES, B).astype(onp.int32))


def _ref_net():
    mx.random.seed(3)
    net = ref_vision.ResNetV1(ref_vision.BottleneckV1, *SPEC, classes=CLASSES)
    net.initialize(init=mx.init.Xavier())
    net(mx.np.zeros((1, 3, HW, HW)))
    return net


def _port_net(seed=5, settle=True):
    net = vision.ResNetV1(vision.BottleneckV1, *SPEC, classes=CLASSES)
    net.initialize(init=mxt.init.Xavier(), ctx=cpu(),
                   generator=torch.Generator().manual_seed(seed))
    if settle:
        net._ensure_shapes(torch.zeros(1, 3, HW, HW))
    return net


def _values(params, port):
    get = (lambda p: p.data().detach().numpy()) if port else \
        (lambda p: p.data().asnumpy())
    return {k: get(p) for k, p in params.items()}


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        onp.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_reference_parameters_load_in_the_port(tmp_path):
    """Into a fresh port net whose shapes are still deferred: they come
    from the file."""
    ref = _ref_net()
    ref.save_parameters(str(tmp_path / "ref.params"))
    net = _port_net(settle=False)
    net.load_parameters(str(tmp_path / "ref.params"))
    _equal(_values(net.collect_params(), True),
           _values(ref.collect_params(), False))
    x, _ = _batch()
    with torch.no_grad(), autograd.predict_mode():
        out = net(torch.tensor(x))
    onp.testing.assert_allclose(out.numpy(), ref(mx.np.array(x)).asnumpy(),
                                rtol=1e-4, atol=1e-4)


def test_port_parameters_load_in_the_reference(tmp_path):
    net = _port_net()
    net.save_parameters(str(tmp_path / "port.params"))
    ref = _ref_net()
    ref.load_parameters(str(tmp_path / "port.params"))
    _equal(_values(ref.collect_params(), False),
           _values(net.collect_params(), True))


def test_load_parameters_checks_names(tmp_path):
    net = _port_net()
    full = {k: p.data() for k, p in net.collect_params().items()}
    missing = dict(full)
    missing.pop("output.bias")
    save_ndarrays(str(tmp_path / "missing.params"), missing)
    with pytest.raises(AssertionError, match="output.bias"):
        _port_net().load_parameters(str(tmp_path / "missing.params"))
    _port_net().load_parameters(str(tmp_path / "missing.params"),
                                allow_missing=True)
    extra = dict(full, stray=torch.zeros(2))
    save_ndarrays(str(tmp_path / "extra.params"), extra)
    with pytest.raises(AssertionError, match="stray"):
        _port_net().load_parameters(str(tmp_path / "extra.params"))
    _port_net().load_parameters(str(tmp_path / "extra.params"),
                                ignore_extra=True)


def test_reference_arrays_follow_the_same_name_rules():
    """`load_reference_params` matches names by the rules of
    `load_parameters` (both go through `Block.load_dict`), with neither
    a missing nor an extra name allowed."""
    full = _values(_port_net().collect_params(), True)
    missing = dict(full)
    missing.pop("output.bias")
    with pytest.raises(AssertionError, match="output.bias"):
        load_reference_params(_port_net(), missing)
    with pytest.raises(AssertionError, match="stray"):
        load_reference_params(_port_net(), dict(full, stray=onp.zeros(2)))
    net = load_reference_params(_port_net(seed=9), full)
    _equal(_values(net.collect_params(), True), full)


def test_legacy_0x112_file_loads_in_the_port(tmp_path):
    """A module-era checkpoint in upstream's binary format, names with
    ``arg:``/``aux:`` prefixes, written by the JAX package's codec."""
    ref = _ref_net()
    names, arrays = [], []
    for k, p in ref.collect_params().items():
        names.append(("aux:" if "running" in k else "arg:") + k)
        arrays.append(p.data().asnumpy())
    path = tmp_path / "legacy.params"
    path.write_bytes(ref_legacy.save_legacy(arrays, names))
    net = _port_net(settle=False)
    net.load_parameters(str(path))
    _equal(_values(net.collect_params(), True),
           _values(ref.collect_params(), False))


DTYPES = [onp.float32, onp.float64, onp.float16, onp.int32, onp.int64,
          onp.uint8, onp.int8, onp.bool_]


def _arrays(rng):
    return [(rng.standard_normal((3, 4)) * 10).astype(dt) for dt in DTYPES] \
        + [onp.asarray([2.5], onp.float32)]


def test_legacy_codec_both_ways():
    """Every mshadow type and a list without names; the port's bytes
    equal the JAX package's, and bfloat16 (type flag 12) crosses as its
    bits.  A 0-dim array has no record in the format (ndim 0 is
    upstream's "none" array, with no data after it): the port refuses
    to write one."""
    rng = onp.random.default_rng(1)
    arrays = _arrays(rng)
    want_names = [f"a{i}" for i in range(len(arrays))]
    blob = ref_legacy.save_legacy(arrays, want_names)
    got, names = legacy_format.load_legacy(blob)
    assert names == want_names
    for a, b in zip(got, arrays):
        assert a.dtype == b.dtype and a.shape == b.shape
        onp.testing.assert_array_equal(a, b)
    assert legacy_format.save_legacy(arrays, names) == blob
    bf = torch.tensor(rng.standard_normal((5, 2)), dtype=torch.bfloat16)
    blob = legacy_format.save_legacy([bf])
    (ref_bf,), ref_names = ref_legacy.load_legacy(blob)
    assert ref_names == [] and str(ref_bf.dtype) == "bfloat16"
    onp.testing.assert_array_equal(ref_bf.astype(onp.float32),
                                   bf.float().numpy())
    (back,), _ = legacy_format.load_legacy(
        ref_legacy.save_legacy([ref_bf]))
    assert back.dtype == torch.bfloat16 and torch.equal(back, bf)
    with pytest.raises(ValueError, match="0-dim"):
        legacy_format.save_legacy([onp.asarray(2.5, onp.float32)])


def test_npz_bfloat16_crosses_as_the_reference_writes_it(tmp_path):
    """The JAX package writes bfloat16 to ``.npz`` as 2-byte void records
    (``|V2``): the port reads them back as bfloat16 and writes the same
    entries."""
    rng = onp.random.default_rng(2)
    w = rng.standard_normal((4, 3)).astype(onp.float32)
    ref_arr = mx.np.array(w).astype("bfloat16")
    ref_save(str(tmp_path / "ref.npz"), {"w": ref_arr, "n": mx.np.array(w)})
    got = load_ndarrays(str(tmp_path / "ref.npz"), ctx=cpu())
    assert list(got) == ["w", "n"]
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].float(),
                       torch.tensor(ref_arr.astype("float32").asnumpy()))
    assert torch.equal(got["n"], torch.tensor(w))
    save_ndarrays(str(tmp_path / "port.npz"), got)
    with onp.load(tmp_path / "ref.npz", allow_pickle=True) as a, \
            onp.load(tmp_path / "port.npz", allow_pickle=True) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes()


@pytest.mark.parametrize("data", ["solo", "list"])
def test_npz_layouts_cross(tmp_path, data):
    rng = onp.random.default_rng(4)
    arrays = [rng.standard_normal((2, 3)).astype(onp.float32),
              rng.integers(0, 9, (4,)).astype(onp.int32)]
    if data == "solo":
        ref_save(str(tmp_path / "f.npz"), mx.np.array(arrays[0]))
        got = load_ndarrays(str(tmp_path / "f.npz"), ctx=cpu())
        onp.testing.assert_array_equal(got.numpy(), arrays[0])
        save_ndarrays(str(tmp_path / "g.npz"), got)
        onp.testing.assert_array_equal(
            ref_load(str(tmp_path / "g.npz")).asnumpy(), arrays[0])
    else:
        ref_save(str(tmp_path / "f.npz"), [mx.np.array(a) for a in arrays])
        got = load_ndarrays(str(tmp_path / "f.npz"), ctx=cpu())
        for t, a in zip(got, arrays):
            assert t.dtype == torch.from_numpy(a).dtype
            onp.testing.assert_array_equal(t.numpy(), a)
        save_ndarrays(str(tmp_path / "g.npz"), got)
        for r, a in zip(ref_load(str(tmp_path / "g.npz")), arrays):
            onp.testing.assert_array_equal(r.asnumpy(), a)


def _ref_train(net, opt, kw, steps=2):
    """``steps`` eager steps of the reference net with cross entropy."""
    from mxnet_tpu.gluon.loss import SoftmaxCrossEntropyLoss as RefSCE
    trainer = RefTrainer(net.collect_params(), opt, kw)
    x, y = _batch(1)
    for _ in range(steps):
        with ref_ag.record():
            loss = RefSCE()(net(mx.np.array(x)), mx.np.array(y))
        loss.backward()
        trainer.step(B)
    return trainer


OPTS = [("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
        ("adam", {"learning_rate": 0.01})]


@pytest.mark.parametrize("opt, kw", OPTS, ids=["sgd", "adam"])
def test_reference_trainer_states_load_in_the_port(tmp_path, opt, kw):
    """SGD's momentum and Adam's moments land in the port's f32 state
    tensors, in the reference's parameter order; and back."""
    ref = _ref_net()
    ref_tr = _ref_train(ref, opt, kw)
    ref_tr.save_states(str(tmp_path / "ref.states"))
    net = _port_net()
    tr = Trainer(net.collect_params(), opt, kw)
    tr.load_states(str(tmp_path / "ref.states"))
    assert sorted(tr._states) == sorted(ref_tr._states)
    for i, st in ref_tr._states.items():
        assert len(tr._states[i]) == len(st) > 0
        for mine, theirs in zip(tr._states[i], st):
            assert mine.dtype == torch.float32
            onp.testing.assert_array_equal(mine.numpy(),
                                           theirs.asnumpy().astype("f4"))
    tr.save_states(str(tmp_path / "port.states"))
    back = RefTrainer(ref.collect_params(), opt, kw)
    back.load_states(str(tmp_path / "port.states"))
    for i, st in ref_tr._states.items():
        for a, b in zip(back._states[i], st):
            onp.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


def test_state_file_with_objects_is_refused(tmp_path):
    """A blob that pickles more than numpy arrays (here a reference
    optimizer, as ``dump_optimizer=True`` writes it) is not unpickled."""
    ref = _ref_net()
    ref_tr = _ref_train(ref, *OPTS[0], steps=1)
    updater = mx.optimizer.Updater(ref_tr.optimizer)
    updater.states = {0: ()}
    (tmp_path / "obj.states").write_bytes(updater.get_states(True))
    tr = Trainer(_port_net().collect_params(), *OPTS[0])
    with pytest.raises(pickle.UnpicklingError, match="numpy arrays only"):
        tr.load_states(str(tmp_path / "obj.states"))


class _RunsCode:
    """Pickles as a call of ``os.system``."""

    def __init__(self, marker):
        self.marker = marker

    def __reduce__(self):
        import os
        return os.system, (f"touch {self.marker}",)


def test_parameter_file_keys_that_run_code_are_refused(tmp_path):
    """A ``.params`` file whose pickled ``__keys__`` names ``os.system``
    is refused before the call is made; its arrays are never read with
    pickle either."""
    marker = tmp_path / "ran"
    keys = onp.empty(1, dtype=object)
    keys[0] = _RunsCode(marker)
    fname = tmp_path / "evil.params"
    with open(fname, "wb") as f:
        onp.savez(f, __mxnet_tpu_magic__=onp.asarray(0x112, onp.int64),
                  __keys__=keys, w=onp.zeros(2, onp.float32))
    with pytest.raises(pickle.UnpicklingError,
                       match="numpy arrays only; refusing .*system"):
        load_ndarrays(fname, ctx=cpu())
    net = _port_net()
    with pytest.raises(pickle.UnpicklingError, match="numpy arrays only"):
        net.load_parameters(str(fname))
    assert not marker.exists()
    objects = onp.empty(1, dtype=object)
    objects[0] = _RunsCode(marker)
    with open(fname, "wb") as f:
        onp.savez(f, __mxnet_tpu_magic__=onp.asarray(0x112, onp.int64),
                  w=objects)
    with pytest.raises(ValueError, match="allow_pickle"):
        load_ndarrays(fname, ctx=cpu())
    assert not marker.exists()


def _step(net, trainer, x, y):
    with autograd.record():
        loss = SoftmaxCrossEntropyLoss()(net(x), y)
    autograd.backward(loss)
    trainer.step(B)


def test_resume_equals_the_uninterrupted_step(tmp_path):
    """Two SGD-momentum steps, a checkpoint, one more step; a fresh net
    and trainer loaded from the checkpoint take the same step to the
    same weights, running statistics included, bitwise."""
    kw = {"learning_rate": 0.1, "momentum": 0.9}
    x, y = (torch.tensor(a) for a in _batch(2))
    net = _port_net(seed=5)
    tr = Trainer(net.collect_params(), "sgd", kw)
    for _ in range(2):
        _step(net, tr, x, y)
    net.save_parameters(str(tmp_path / "ck.params"))
    tr.save_states(str(tmp_path / "ck.states"))
    _step(net, tr, x, y)

    fresh = _port_net(seed=9, settle=False)
    fresh.load_parameters(str(tmp_path / "ck.params"))
    fresh_tr = Trainer(fresh.collect_params(), "sgd", kw)
    fresh_tr.load_states(str(tmp_path / "ck.states"))
    _step(fresh, fresh_tr, x, y)
    _equal(_values(fresh.collect_params(), True),
           _values(net.collect_params(), True))


def test_updater_against_the_reference():
    """``Updater(opt)(index, grad, weight)`` creates the state at first
    use and updates in place, as the reference's."""
    rng = onp.random.default_rng(6)
    w0 = rng.standard_normal((3, 2)).astype(onp.float32)
    grads = [rng.standard_normal((3, 2)).astype(onp.float32)
             for _ in range(2)]
    ref_w, w = mx.np.array(w0), torch.tensor(w0)
    ref_up = mx.optimizer.Updater(mx.optimizer.create(
        "sgd", learning_rate=0.1, momentum=0.9))
    up = mxt.optimizer.Updater(mxt.optimizer.create(
        "sgd", learning_rate=0.1, momentum=0.9))
    for g in grads:
        ref_up(0, mx.np.array(g), ref_w)
        up(0, torch.tensor(g), w)
    onp.testing.assert_allclose(w.numpy(), ref_w.asnumpy(), rtol=1e-6,
                                atol=1e-6)
    up.set_states(up.get_states())
    assert set(up.states) == {0}
