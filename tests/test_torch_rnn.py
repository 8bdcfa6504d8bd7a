"""The port's recurrent layers and cells against the JAX package's.

The same seeded numpy inputs and weights (the reference's
``collect_params()`` carried across with `load_reference_params`) go
through `mxnet_tpu.gluon.rnn` and `mxnet_tpu_torch.gluon.rnn` on the CPU
at V 50, E = H = 16, T 7, N 3.  Compared: outputs, ``h_n``/``c_n`` and
every parameter's gradient of a fixed random projection of them, for
every mode, 1-2 layers, both directions, TNC and NTC, with and without
explicit states; ``gate_layout="split"`` against ``"fused"``; the
train-mode mask between layers, bitwise for a given key; every cell and
``unroll``; the ``cast`` fix; ``sequence_length`` ignored; the mx.np and
npx functions the layers and cells call.

Tolerances, f32 throughout (true-f32 products on both sides, which
differ in summation order only): outputs and states rtol 1e-5, atol
1e-6.  Gradients rtol 1e-5 and atol 1e-5 x the largest magnitude of that
parameter's reference gradient: a weight's gradient sums T*N = 21
products per layer and direction, back through up to two layers and
seven steps, and an element whose terms cancel keeps an absolute error
of that order of the largest element while its own value is near zero;
a wrong gate order, a missing path or a wrong mask moves gradients by
their own size.
"""
import builtins

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as ref_autograd
from mxnet_tpu.gluon import rnn as ref_rnn
from mxnet_tpu.gluon.rnn import rnn_layer as ref_layer_mod
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import autograd, cpu, npx
from mxnet_tpu_torch.gluon import Block, rnn
from mxnet_tpu_torch.gluon.rnn import rnn_layer
from mxnet_tpu_torch.ops.seeds import DRAWS
from mxnet_tpu_torch.utils.convert import load_reference_params

torch.set_num_threads(1)

T, N, C, H = 7, 3, 16, 16
RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-5


def _layer_cls(mode):
    return {"lstm": ("LSTM", {}), "gru": ("GRU", {}),
            "rnn_relu": ("RNN", {"activation": "relu"}),
            "rnn_tanh": ("RNN", {"activation": "tanh"})}[mode]


def _pair(mode, layers, bidir, layout, dropout=0.0):
    name, kw = _layer_cls(mode)
    kw = dict(kw, num_layers=layers, layout=layout, bidirectional=bidir,
              dropout=dropout)
    ref = getattr(ref_rnn, name)(H, input_size=C, **kw)
    ref.initialize()
    port = getattr(rnn, name)(H, input_size=C, **kw)
    port.initialize(ctx=cpu())
    load_reference_params(port, {k: p.data().asnumpy()
                                 for k, p in ref.collect_params().items()})
    return ref, port


def _inputs(rng, layout, layers, bidir, mode):
    shape = (T, N, C) if layout == "TNC" else (N, T, C)
    x = rng.uniform(-1, 1, shape).astype("float32")
    nst = layers * (2 if bidir else 1)
    states = [rng.uniform(-0.5, 0.5, (nst, N, H)).astype("float32")
              for _ in range(2 if mode == "lstm" else 1)]
    return x, states


def _as_list(st):
    return list(st) if isinstance(st, (list, tuple)) else [st]


def _head(outs, rng):
    """Fixed random weights for every output, so each element of each
    output reaches the loss with its own coefficient."""
    return [rng.standard_normal(o.shape).astype("float32") for o in outs]


CASES = [(mode, layers, bidir, layout, explicit)
         for mode in ("lstm", "gru", "rnn_relu", "rnn_tanh")
         for layers, bidir, layout, explicit in (
             (1, False, "TNC", True), (2, True, "NTC", True),
             (2, False, "TNC", False), (1, True, "TNC", False))]


@pytest.mark.parametrize("mode,layers,bidir,layout,explicit", CASES)
def test_layer_matches_reference(mode, layers, bidir, layout, explicit):
    rng = onp.random.default_rng(0)
    ref, port = _pair(mode, layers, bidir, layout)
    x, states = _inputs(rng, layout, layers, bidir, mode)

    def run_ref():
        args = (mx.np.array(x),)
        if explicit:
            st = [mx.np.array(s) for s in states]
            args += (st if mode == "lstm" else st[0],)
        out = ref(*args)
        return [out[0]] + _as_list(out[1]) if explicit else [out]

    def run_port():
        args = (torch.from_numpy(x),)
        if explicit:
            st = [torch.from_numpy(s) for s in states]
            args += (st if mode == "lstm" else st[0],)
        out = port(*args)
        return [out[0]] + _as_list(out[1]) if explicit else [out]

    with ref_autograd.record(train_mode=False):
        outs_r = run_ref()
        head = _head([o.asnumpy() for o in outs_r], rng)
        loss_r = sum((o * mx.np.array(w)).sum() for o, w in zip(outs_r, head))
    loss_r.backward()
    with autograd.record(train_mode=False):
        outs_p = run_port()
        loss_p = sum((o * torch.from_numpy(w)).sum()
                     for o, w in zip(outs_p, head))
    autograd.backward(loss_p)
    assert len(outs_p) == len(outs_r)
    for o_p, o_r in zip(outs_p, outs_r):
        assert tuple(o_p.shape) == o_r.shape
        onp.testing.assert_allclose(o_p.detach().numpy(), o_r.asnumpy(),
                                    rtol=RTOL, atol=ATOL)
    ref_params = ref.collect_params()
    for name, p in port.collect_params().items():
        expect = ref_params[name].grad().asnumpy()
        onp.testing.assert_allclose(
            p.grad().numpy(), expect, rtol=GRAD_RTOL,
            atol=GRAD_ATOL * float(onp.abs(expect).max()), err_msg=name)


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_parameter_names_shapes_and_deferred_input_size(mode):
    name, kw = _layer_cls(mode)
    ref = getattr(ref_rnn, name)(H, num_layers=2, bidirectional=True, **kw)
    ref.initialize()
    ref(mx.np.array(onp.zeros((T, N, C), "float32")))
    port = getattr(rnn, name)(H, num_layers=2, bidirectional=True, **kw)
    port.initialize(ctx=cpu())
    assert port.l0_i2h_weight.shape == (port._hidden_size * (4 if mode ==
                                        "lstm" else 3), 0)
    port(torch.zeros(T, N, C))
    shapes_r = {k: p.shape for k, p in ref.collect_params().items()}
    shapes_p = {k: tuple(p.shape) for k, p in port.collect_params().items()}
    assert shapes_p == shapes_r
    assert list(shapes_p) == list(shapes_r)


@pytest.mark.parametrize("mode", ["lstm", "rnn_tanh"])
def test_split_gate_layout_matches_fused(mode):
    """``gate_layout="split"`` (one (H, H) product per gate) against the
    fused (H, 4H) product, and against the reference's split layout."""
    rng = onp.random.default_rng(1)
    ng = 4 if mode == "lstm" else 1
    arrs = [rng.uniform(-0.5, 0.5, s).astype("float32") for s in
            ((T, N, C), (N, H), (N, H), (ng * H, C), (ng * H,),
             (ng * H, H), (ng * H,))]
    x, h0, c0, wi, bi, wh, bh = arrs
    tens = [torch.from_numpy(a) for a in arrs]
    fused = rnn_layer.run_single_direction(
        mode, tens[0], tens[1], tens[2], *tens[3:], gate_layout="fused")
    split = rnn_layer.run_single_direction(
        mode, tens[0], tens[1], tens[2], *tens[3:], gate_layout="split",
        unroll=3)
    expect = ref_layer_mod._run_single_direction(
        mode, *(mx.np.array(a)._data for a in arrs), unroll=1,
        gate_layout="split")
    for f, s, e in zip(fused, split, expect):
        onp.testing.assert_allclose(s.numpy(), f.numpy(), rtol=RTOL,
                                    atol=ATOL)
        onp.testing.assert_allclose(s.numpy(), onp.asarray(e), rtol=RTOL,
                                    atol=ATOL)


def _known_key(seed):
    """The two key words a draw of kind "rnn" takes from a generator
    seeded ``seed``."""
    return DRAWS["rnn"](torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("layer", [0, 1, 4])
def test_inter_layer_mask_is_jax_bitwise(layer):
    import jax
    import jax.numpy as jnp
    words = _known_key(5)
    key = jax.random.wrap_key_data(jnp.asarray(words, dtype=jnp.uint32))
    shape = (T, N, 2 * H)
    expect = onp.asarray(jax.random.bernoulli(jax.random.fold_in(key, layer),
                                              0.7, shape))
    got = rnn_layer.inter_layer_mask(
        torch.tensor(onp.asarray(words, onp.uint32).view(onp.int32)),
        layer, 0.7, shape)
    assert got.dtype == torch.bool
    assert onp.array_equal(got.numpy(), expect)


@pytest.mark.parametrize("bidir", [False, True])
def test_train_mode_dropout_matches_reference_for_the_same_key(
        bidir, monkeypatch):
    """Three layers with dropout 0.4 in train mode: with the reference's
    key set to the words the port's generator draws, outputs, states and
    gradients agree (the masks are the same bits)."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu import random as ref_random
    rng = onp.random.default_rng(2)
    ref, port = _pair("lstm", 3, bidir, "TNC", dropout=0.4)
    x, states = _inputs(rng, "TNC", 3, bidir, "lstm")
    words = _known_key(11)
    key = jax.random.wrap_key_data(jnp.asarray(words, dtype=jnp.uint32))
    monkeypatch.setattr(ref_random, "new_key", lambda: key)
    with ref_autograd.record():
        out_r, st_r = ref(mx.np.array(x), [mx.np.array(s) for s in states])
        head = _head([out_r.asnumpy()], rng)[0]
        loss_r = (out_r * mx.np.array(head)).sum()
    loss_r.backward()
    with autograd.record(generator=torch.Generator().manual_seed(11)):
        out_p, st_p = port(torch.from_numpy(x),
                           [torch.from_numpy(s) for s in states])
        loss_p = (out_p * torch.from_numpy(head)).sum()
    autograd.backward(loss_p)
    onp.testing.assert_allclose(out_p.detach().numpy(), out_r.asnumpy(),
                                rtol=RTOL, atol=ATOL)
    for a, b in zip(st_p, st_r):
        onp.testing.assert_allclose(a.detach().numpy(), b.asnumpy(),
                                    rtol=RTOL, atol=ATOL)
    ref_params = ref.collect_params()
    for name, p in port.collect_params().items():
        expect = ref_params[name].grad().asnumpy()
        onp.testing.assert_allclose(
            p.grad().numpy(), expect, rtol=GRAD_RTOL,
            atol=GRAD_ATOL * float(onp.abs(expect).max()), err_msg=name)


def test_dropout_needs_a_generator_and_draws_one_key_per_forward():
    layer = rnn.LSTM(H, num_layers=2, dropout=0.5, input_size=C)
    layer.initialize(ctx=cpu())
    x = torch.ones(T, N, C)
    with autograd.train_mode():
        with pytest.raises(ValueError, match="RNN dropout"):
            layer(x)
    gen = torch.Generator().manual_seed(3)
    with autograd.record(generator=gen):
        a = layer(x)
        b = layer(x)
    assert not torch.equal(a, b)            # a fresh key each forward
    with autograd.predict_mode():
        assert torch.equal(layer(x), layer(x))


class _UnfixedLSTM(rnn.LSTM):
    """The layer without the ``cast`` fix: its parameters are cast, its
    initial states' dtype is not."""

    def cast(self, dtype):
        return Block.cast(self, dtype)


def test_cast_retargets_the_states_dtype():
    """After ``cast("bfloat16")`` the initial states, every layer's
    h_n/c_n and the output stay bf16; without the fix (the parameters
    cast, the states' dtype not) the f32 states promote the gates and
    every layer after the first computes in f32."""
    x = torch.ones(T, N, C, dtype=torch.bfloat16)
    for cls, expect in ((rnn.LSTM, torch.bfloat16),
                        (_UnfixedLSTM, torch.float32)):
        layer = cls(H, num_layers=2, input_size=C)
        layer.initialize(ctx=cpu())
        layer.cast("bfloat16")
        states = layer.begin_state(N, ctx=cpu())
        assert all(s.dtype == expect for s in states)
        out, (hn, cn) = layer(x, states)
        assert out.dtype == hn.dtype == cn.dtype == expect


def test_parent_cast_reaches_the_layer():
    from mxnet_tpu_torch.models import RNNModel
    m = RNNModel(50, num_embed=C, num_hidden=H, num_layers=2)
    m.initialize(ctx=cpu())
    m.cast("bfloat16")
    st = m.begin_state(N, ctx=cpu())
    assert all(s.dtype == torch.bfloat16 for s in st)
    logits, (hn, cn) = m(torch.zeros(T, N, dtype=torch.int32), st)
    assert logits.dtype == hn.dtype == cn.dtype == torch.bfloat16


def test_sequence_length_is_ignored():
    """As in the reference, ``sequence_length`` changes nothing (and
    ``use_sequence_length`` is only stored)."""
    rng = onp.random.default_rng(3)
    ref, port = _pair("lstm", 1, False, "TNC")
    port._use_sequence_length = True
    x = rng.uniform(-1, 1, (T, N, C)).astype("float32")
    lengths = onp.array([2, 7, 4], "int32")
    a = port(torch.from_numpy(x))
    b = port(torch.from_numpy(x), None, torch.from_numpy(lengths))
    r = ref(mx.np.array(x), None, mx.np.array(lengths))
    assert torch.equal(a, b)
    onp.testing.assert_allclose(b.detach().numpy(), r.asnumpy(), rtol=RTOL,
                                atol=ATOL)


def test_never_reads_the_tune_cache(monkeypatch):
    """The port's layer takes the static default and opens no file (the
    reference's may read the TPU autotune cache)."""
    opened = []
    real_open = builtins.open

    def spy(path, *a, **kw):
        opened.append(str(path))
        return real_open(path, *a, **kw)

    monkeypatch.setattr(builtins, "open", spy)
    layer = rnn.LSTM(H, num_layers=2, input_size=C)
    layer.initialize(ctx=cpu())
    layer(torch.ones(T, N, C))
    assert opened == []
    assert "tune" not in rnn_layer.__dict__


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------
def _carry(ref, port):
    load_reference_params(port, {k: p.data().asnumpy()
                                 for k, p in ref.collect_params().items()})


CELLS = {
    "rnn_tanh": lambda m: m.RNNCell(H, input_size=C),
    "rnn_relu": lambda m: m.RNNCell(H, activation="relu", input_size=C),
    "lstm": lambda m: m.LSTMCell(H, input_size=C),
    "gru": lambda m: m.GRUCell(H, input_size=C),
    "lstmp": lambda m: m.LSTMPCell(H, 8, input_size=C),
    "residual": lambda m: m.ResidualCell(m.GRUCell(C, input_size=C)),
    "sequential": lambda m: _seq(m),
}


def _seq(m):
    cell = m.SequentialRNNCell()
    cell.add(m.LSTMCell(H, input_size=C))
    cell.add(m.GRUCell(H, input_size=H))
    return cell


@pytest.mark.parametrize("kind", sorted(CELLS))
@pytest.mark.parametrize("layout,merge,lengths", [
    ("NTC", True, False), ("TNC", None, True), ("NTC", False, True)])
def test_cell_unroll_matches_reference(kind, layout, merge, lengths):
    rng = onp.random.default_rng(4)
    ref, port = CELLS[kind](ref_rnn), CELLS[kind](rnn)
    ref.initialize()
    port.initialize(ctx=cpu())
    shape = (N, T, C) if layout == "NTC" else (T, N, C)
    x = rng.uniform(-1, 1, shape).astype("float32")
    ref.unroll(T, mx.np.array(x), layout=layout)      # settle shapes
    port.unroll(T, torch.from_numpy(x), layout=layout)
    _carry(ref, port)
    vl = onp.array([7, 3, 5], "float32") if lengths else None
    out_r, st_r = ref.unroll(T, mx.np.array(x), layout=layout,
                             merge_outputs=merge,
                             valid_length=None if vl is None
                             else mx.np.array(vl))
    out_p, st_p = port.unroll(T, torch.from_numpy(x), layout=layout,
                              merge_outputs=merge,
                              valid_length=None if vl is None
                              else torch.from_numpy(vl))
    merged = merge is not False
    assert isinstance(out_p, torch.Tensor) == merged
    outs_r = [out_r] if merged else list(out_r)
    outs_p = [out_p] if merged else list(out_p)
    assert len(outs_p) == len(outs_r)
    for a, b in zip(outs_p + list(st_p), outs_r + list(st_r)):
        onp.testing.assert_allclose(a.detach().numpy(), b.asnumpy(),
                                    rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("inputs_as_list", [False, True])
def test_bidirectional_cell_matches_reference(inputs_as_list):
    rng = onp.random.default_rng(5)

    def make(m):
        return m.BidirectionalCell(m.LSTMCell(H, input_size=C),
                                   m.GRUCell(H, input_size=C))

    ref, port = make(ref_rnn), make(rnn)
    ref.initialize()
    port.initialize(ctx=cpu())
    x = rng.uniform(-1, 1, (N, T, C)).astype("float32")
    ref.unroll(T, mx.np.array(x))
    port.unroll(T, torch.from_numpy(x))
    _carry(ref, port)
    vl = onp.array([7, 2, 5], "float32")
    if inputs_as_list:
        xr = [mx.np.array(x[:, t]) for t in range(T)]
        xp = [torch.from_numpy(x[:, t].copy()) for t in range(T)]
    else:
        xr, xp = mx.np.array(x), torch.from_numpy(x)
    out_r, st_r = ref.unroll(T, xr, valid_length=mx.np.array(vl))
    out_p, st_p = port.unroll(T, xp, valid_length=torch.from_numpy(vl))
    outs_r = list(out_r) if inputs_as_list else [out_r]
    outs_p = list(out_p) if inputs_as_list else [out_p]
    assert len(outs_p) == len(outs_r)
    for a, b in zip(outs_p + list(st_p), outs_r + list(st_r)):
        onp.testing.assert_allclose(a.detach().numpy(), b.asnumpy(),
                                    rtol=RTOL, atol=ATOL)
    with pytest.raises(NotImplementedError):
        port(torch.from_numpy(x[:, 0]), port.begin_state(N, ctx=cpu()))


def test_cell_gradients_match_reference():
    rng = onp.random.default_rng(6)
    ref, port = _seq(ref_rnn), _seq(rnn)
    ref.initialize()
    port.initialize(ctx=cpu())
    x = rng.uniform(-1, 1, (N, T, C)).astype("float32")
    ref.unroll(T, mx.np.array(x))
    port.unroll(T, torch.from_numpy(x))
    _carry(ref, port)
    head = rng.standard_normal((N, T, H)).astype("float32")
    with ref_autograd.record(train_mode=False):
        out_r, _ = ref.unroll(T, mx.np.array(x))
        loss_r = (out_r * mx.np.array(head)).sum()
    loss_r.backward()
    with autograd.record(train_mode=False):
        out_p, _ = port.unroll(T, torch.from_numpy(x))
        loss_p = (out_p * torch.from_numpy(head)).sum()
    autograd.backward(loss_p)
    ref_params = ref.collect_params()
    for name, p in port.collect_params().items():
        expect = ref_params[name].grad().asnumpy()
        onp.testing.assert_allclose(
            p.grad().numpy(), expect, rtol=GRAD_RTOL,
            atol=GRAD_ATOL * float(onp.abs(expect).max()), err_msg=name)


def _train_scope(seed=0):
    return autograd.record(generator=torch.Generator().manual_seed(seed))


def test_dropout_cell():
    cell = rnn.DropoutCell(0.5)
    x = torch.ones(N, H)
    with autograd.predict_mode():
        assert torch.equal(cell(x, [])[0], x)
    with _train_scope():
        out, st = cell(x, [])
    assert st == []
    vals = set(out.unique().tolist())
    assert vals <= {0.0, 2.0} and len(vals) == 2
    # axes: one mask value per element of the kept axes, broadcast
    cell = rnn.DropoutCell(0.5, axes=(1,))
    with _train_scope(1):
        out, _ = cell(torch.ones(8, H), [])
    assert (out == out[0]).all()


def test_zoneout_cell_keeps_the_previous_output_at_its_rate():
    base = rnn.RNNCell(H, input_size=C)
    cell = rnn.ZoneoutCell(base, zoneout_outputs=0.5, zoneout_states=0.0)
    cell.initialize(ctx=cpu())
    x = torch.randn(64, C, generator=torch.Generator().manual_seed(0))
    st = cell.begin_state(64, ctx=cpu())
    with autograd.predict_mode():
        expect, _ = base(x, st)
        assert torch.equal(cell(x, st)[0], expect)
    with _train_scope():
        out, new_st = cell(x, st)
    # the previous output is zeros at the first step: zoned-out elements
    # read 0, the others the base cell's output
    zoned = out == 0
    assert torch.equal(out[~zoned], expect[~zoned])
    assert 0.35 < zoned.float().mean().item() < 0.65
    assert torch.equal(new_st[0], base(x, st)[1][0])
    cell.reset()
    assert cell._prev_output is None


def test_variational_dropout_cell_locks_its_masks_until_reset():
    base = rnn.LSTMCell(H, input_size=C)
    cell = rnn.VariationalDropoutCell(base, drop_inputs=0.5,
                                      drop_states=0.5, drop_outputs=0.5)
    cell.initialize(ctx=cpu())
    x = torch.ones(N, T, C)
    with _train_scope(2):
        cell.unroll(T, x)
        masks = (cell._mask_in, cell._mask_st, cell._mask_out)
        assert all(m is not None for m in masks)
        # stepping on keeps the same masks
        st = cell.begin_state(N, ctx=cpu())
        cell(x[:, 0], st)
        assert all(a is b for a, b in zip(masks, (cell._mask_in,
                                                  cell._mask_st,
                                                  cell._mask_out)))
        # the output mask is the same at every step of a sequence
        out, _ = cell.unroll(T, x)
        zero = out == 0
        assert (zero == zero[:, :1]).all()
        new = (cell._mask_in, cell._mask_st, cell._mask_out)
    assert any(not torch.equal(a, b) for a, b in zip(masks, new))
    cell.reset()
    assert cell._mask_in is cell._mask_st is cell._mask_out is None
    with pytest.raises(ValueError):
        rnn.VariationalDropoutCell(rnn.BidirectionalCell(
            rnn.LSTMCell(H), rnn.LSTMCell(H)), drop_states=0.5)


@pytest.mark.parametrize("kind,ndim", [("ConvRNNCell", 2),
                                       ("ConvLSTMCell", 2),
                                       ("ConvGRUCell", 2),
                                       ("Conv1DLSTMCell", 1),
                                       ("Conv3DGRUCell", 3)])
def test_conv_cells_match_reference(kind, ndim):
    rng = onp.random.default_rng(7)
    spatial = (5, 6, 4)[:ndim]
    kw = {"i2h_pad": (1,) * ndim}
    ref = getattr(ref_rnn, kind)((3,) + spatial, 4, **kw)
    port = getattr(rnn, kind)((3,) + spatial, 4, **kw)
    ref.initialize()
    port.initialize(ctx=cpu())
    _carry(ref, port)
    x = rng.uniform(-1, 1, (2, 4, 3) + spatial).astype("float32")
    out_r, st_r = ref.unroll(4, mx.np.array(x), layout="NTC")
    out_p, st_p = port.unroll(4, torch.from_numpy(x), layout="NTC")
    for a, b in zip([out_p] + list(st_p), [out_r] + list(st_r)):
        assert tuple(a.shape) == b.shape
        onp.testing.assert_allclose(a.detach().numpy(), b.asnumpy(),
                                    rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the mx.np / npx functions the layers and cells call
# ---------------------------------------------------------------------------
def test_numpy_functions_match_reference():
    rng = onp.random.default_rng(8)
    a = rng.standard_normal((3, 4, 5)).astype("float32")
    b = rng.standard_normal((3, 4, 5)).astype("float32")
    ra, rb = mx.np.array(a), mx.np.array(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    pairs = [
        (mx.np.zeros((2, 3), ctx=mx.cpu()), mxt.np.zeros((2, 3), ctx=cpu())),
        (mx.np.zeros((2, 3), dtype="int32"),
         mxt.np.zeros((2, 3), ctx=cpu(), dtype="int32")),
        (mx.np.ones_like(ra), mxt.np.ones_like(ta)),
        (mx.np.zeros_like(ra), mxt.np.zeros_like(ta)),
        (mx.np.stack([ra, rb], axis=1), mxt.np.stack([ta, tb], axis=1)),
        (mx.np.concatenate([ra, rb], axis=-1),
         mxt.np.concatenate([ta, tb], axis=-1)),
        (ra.swapaxes(0, 2), mxt.np.swapaxes(ta, 0, 2)),
    ]
    for r, p in pairs:
        assert tuple(p.shape) == r.shape
        assert str(p.dtype).split(".")[-1] == str(r.dtype)
        onp.testing.assert_allclose(p.numpy(), r.asnumpy(), rtol=RTOL,
                                    atol=ATOL)


@pytest.mark.parametrize("axis", [0, 1])
def test_sequence_ops_match_reference(axis):
    rng = onp.random.default_rng(9)
    x = rng.standard_normal((T, N, 4) if axis == 0 else (N, T, 4)) \
        .astype("float32")
    ln = onp.array([3, 7, 1], "float32")
    for fn, kw in (("sequence_mask", {"value": -2.0}),
                   ("sequence_reverse", {})):
        r = getattr(mx.npx, fn)(mx.np.array(x), mx.np.array(ln),
                                use_sequence_length=True, axis=axis, **kw)
        p = getattr(npx, fn)(torch.from_numpy(x), torch.from_numpy(ln),
                             use_sequence_length=True, axis=axis, **kw)
        assert torch.equal(p, torch.from_numpy(r.asnumpy()))
        r = getattr(mx.npx, fn)(mx.np.array(x), axis=axis)
        p = getattr(npx, fn)(torch.from_numpy(x), axis=axis)
        assert torch.equal(p, torch.from_numpy(r.asnumpy()))


def test_npx_dropout_mode_and_axes():
    x = torch.ones(6, 5, 4)
    with autograd.predict_mode():
        assert npx.dropout(x, p=0.5) is x
        with pytest.raises(ValueError):         # "always" draws: needs a
            npx.dropout(x, p=0.5, mode="always")    # generator
    with _train_scope(4):
        assert npx.dropout(x, p=0.5, mode="training") is x   # as the
        # reference: only mode=None (train mode) and "always" drop
        out = npx.dropout(x, p=0.5, axes=(0, 2))
    assert set(out.unique().tolist()) == {0.0, 2.0}
    assert (out == out[:, :1, :]).all()
    with autograd.record(train_mode=False,
                         generator=torch.Generator().manual_seed(6)):
        out = npx.dropout(x, p=0.5, mode="always")    # in predict mode
    assert set(out.unique().tolist()) == {0.0, 2.0}
