"""The port's BERT against the JAX package's, with the same weights.

A small BertModel (vocab 100, units 64, FFN 128, 2 layers, 4 heads,
max_length 128, dropout 0) is built in both packages; the JAX model's
``collect_params()`` arrays are carried into the port's model with
`load_reference_params`, and both run the same tokens, segments and
valid_mask on the CPU (the JAX flash kernel in interpret mode, the
port's through its plain version).

Tolerance: f32 on both sides, true-f32 products; the outputs differ
only by summation order through 2 layers of products over widths of 64
and 128 and two layer norms, which moves values of order 1 by ~1e-6 —
atol = rtol = 1e-4 leaves margin without hiding a wrong mask or a
wrong weight (either moves results by order 0.1).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.models import BertModel as RefBert
from mxnet_tpu_torch import cpu
from mxnet_tpu_torch.gluon import Parameter
from mxnet_tpu_torch.models import BertModel, bert_base
from mxnet_tpu_torch.utils.convert import load_reference_params

torch.set_num_threads(1)

ATOL = RTOL = 1e-4
CFG = dict(vocab_size=100, units=64, hidden_size=128, num_layers=2,
           num_heads=4, max_length=128, dropout=0.0)
T = 128


def _reference(use_flash):
    net = RefBert(use_flash=use_flash, **CFG)
    net.initialize()
    net(mx.np.zeros((1, T), dtype="int32"))    # finish deferred init
    return net


def _port_like(ref, use_flash):
    net = BertModel(use_flash=use_flash, **CFG).initialize(ctx=cpu())
    return load_reference_params(
        net, {k: p.data().asnumpy() for k, p in ref.collect_params().items()})


def _inputs(seed):
    rng = onp.random.default_rng(seed)
    tokens = rng.integers(0, CFG["vocab_size"], (3, T)).astype(onp.int32)
    segments = (onp.arange(T)[None, :] >= 50).astype(onp.int32).repeat(3, 0)
    lens = onp.array([T, 77, 1])
    valid = (onp.arange(T)[None, :] < lens[:, None]).astype(onp.int32)
    return tokens, segments, valid


@pytest.mark.parametrize("with_mask", [True, False])
@pytest.mark.parametrize("use_flash", [True, False])
def test_bert_matches_reference(use_flash, with_mask):
    ref = _reference(use_flash)
    net = _port_like(ref, use_flash)
    tokens, segments, valid = _inputs(int(use_flash) * 2 + int(with_mask))
    args = [tokens, segments] + ([valid] if with_mask else [])
    seq_r, pooled_r = ref(*(mx.np.array(a, dtype="int32") for a in args))
    with torch.inference_mode():
        seq_p, pooled_p = net(*(torch.from_numpy(a) for a in args))
    assert seq_p.shape == (3, T, CFG["units"])
    assert pooled_p.shape == (3, CFG["units"])
    onp.testing.assert_allclose(seq_p.numpy(), seq_r.asnumpy(),
                                atol=ATOL, rtol=RTOL)
    onp.testing.assert_allclose(pooled_p.numpy(), pooled_r.asnumpy(),
                                atol=ATOL, rtol=RTOL)


def test_parameter_names_match_reference():
    ref = _reference(True)
    net = BertModel(use_flash=True, **CFG).initialize(ctx=cpu())
    mine = {k: p.shape for k, p in net.collect_params().items()}
    theirs = {k: tuple(p.shape) for k, p in ref.collect_params().items()}
    assert mine == theirs
    assert "encoder.layer0.attention.query.weight" in mine
    assert "position_embed" in mine


def test_flash_and_dense_agree_on_valid_rows():
    """Flash and dense attention differ only on batch rows with no valid
    key (flash gives 0, dense uniform weights); elsewhere they agree."""
    flash = BertModel(use_flash=True, **CFG).initialize(ctx=cpu())
    dense = BertModel(use_flash=False, **CFG).initialize(ctx=cpu())
    tokens, segments, valid = (torch.from_numpy(a) for a in _inputs(9))
    with torch.inference_mode():
        a = flash(tokens, segments, valid)
        b = dense(tokens, segments, valid)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, atol=ATOL, rtol=RTOL)


def test_initialize_is_seeded_and_casts():
    a = bert_base(num_layers=1, vocab_size=50).initialize(
        ctx=cpu(), generator=torch.Generator().manual_seed(3))
    b = bert_base(num_layers=1, vocab_size=50).initialize(
        ctx=cpu(), generator=torch.Generator().manual_seed(3))
    pa, pb = a.collect_params(), b.collect_params()
    for name in pa:
        assert torch.equal(pa[name].data(), pb[name].data()), name
    w = pa["encoder.layer0.attention.query.weight"].data()
    assert w.shape == (768, 768) and 0.015 < float(w.std()) < 0.025
    assert (pa["encoder.layer0.attention.query.bias"].data() == 0).all()
    assert (pa["embed_ln.gamma"].data() == 1).all()
    a.cast("bfloat16")
    assert pa["word_embed.weight"].data().dtype == torch.bfloat16


def test_dense_needs_its_input_width():
    """Without ``in_units`` the width is taken at the first forward (as
    the reference's Dense does); with it, at ``initialize``."""
    from mxnet_tpu_torch.gluon import nn
    deferred = nn.Dense(5, flatten=False).initialize(ctx=cpu())
    assert deferred.weight.shape == (5, 0) and deferred.weight._data is None
    assert deferred(torch.ones(2, 3, 7)).shape == (2, 3, 5)
    assert deferred.weight.shape == (5, 7)
    layer = nn.Dense(5, in_units=7).initialize(ctx=cpu())
    assert isinstance(layer.weight, Parameter)
    assert layer.weight.shape == (5, 7)
    assert layer(torch.ones(2, 7)).shape == (2, 5)
    with pytest.raises(ValueError, match="shape"):
        layer.weight.set_data(onp.zeros((7, 5)))


@pytest.mark.parametrize("axis", [-1, 1])
def test_layer_norm_matches_reference(axis):
    import jax.numpy as jnp
    from mxnet_tpu.ops import nn as ref_nn
    from mxnet_tpu_torch.ops import nn as port_nn

    rng = onp.random.default_rng(5)
    x = (rng.standard_normal((3, 64, 64)) * 3 + 1).astype(onp.float32)
    g, b = (rng.standard_normal(64).astype(onp.float32) for _ in range(2))
    expect = ref_nn.layer_norm(jnp.asarray(x), jnp.asarray(g),
                               jnp.asarray(b), axis=axis, eps=1e-12)
    got = port_nn.layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                             torch.from_numpy(b), axis=axis, eps=1e-12)
    onp.testing.assert_allclose(got.numpy(), onp.asarray(expect),
                                atol=ATOL, rtol=RTOL)


def test_embedding_backward_sums_in_a_fixed_order(monkeypatch):
    """The embedding's weight gradient is accumulated by
    ``index_put_(accumulate=True)`` (on the card: indices sorted stably,
    each index's rows added one after another), not by torch's embedding
    backward, which adds repeated indices with atomics on the card in a
    varying order.  On the CPU its sum is the sequential f32 sum in
    position order, bitwise, and two backwards agree bitwise."""
    from mxnet_tpu_torch import numpy_extension as npx

    rng = onp.random.default_rng(3)
    idx = torch.from_numpy(rng.integers(0, 3, (4, 64)).astype(onp.int32))
    weight = torch.from_numpy(rng.standard_normal((5, 8)).astype(
        onp.float32)).requires_grad_()
    dout = torch.from_numpy(rng.standard_normal((4, 64, 8)).astype(
        onp.float32) * 1e3)
    calls = []
    real = torch.Tensor.index_put_

    def spy(self, indices, values, accumulate=False):
        calls.append(accumulate)
        return real(self, indices, values, accumulate)

    monkeypatch.setattr(torch.Tensor, "index_put_", spy)
    grads = []
    for _ in range(2):
        out = npx.embedding(idx, weight)
        (g,) = torch.autograd.grad(out, weight, dout)
        grads.append(g)
    assert calls == [True, True]
    assert torch.equal(grads[0], grads[1])
    want = onp.zeros((5, 8), onp.float32)
    for i, row in zip(idx.reshape(-1).tolist(), dout.reshape(-1, 8).numpy()):
        want[i] += row
    onp.testing.assert_array_equal(grads[0].numpy(), want)
