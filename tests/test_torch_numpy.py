"""The ``mx.np`` functions of the input pipeline, and ``argsort``'s index
type, against the JAX package's.

- ``argsort`` returns int32 indices, as the reference's (JAX without
  x64), equal to them bitwise, flat and along an axis; indexing a tensor
  with them works as with int64;
- ``array`` (Python lists, numpy floats and int64, an explicit dtype such
  as ``"bfloat16"``, a tensor), ``asarray``, ``transpose`` (with and
  without axes; the result is contiguous) give the reference's dtypes
  and values bitwise; ``array`` without a context
  targets the card, which raises without CUDA.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import MXNetError, cpu

torch.set_num_threads(1)


def _ref_np(a):
    return onp.asarray(a.astype("float32").asnumpy() if str(a.dtype) ==
                       "bfloat16" else a.asnumpy())


@pytest.mark.parametrize("axis", [None, 0, -1])
def test_argsort_gives_the_references_int32_indices(axis):
    x = onp.random.default_rng(0).integers(0, 5, (4, 6)).astype(onp.float32)
    got = mxt.np.argsort(torch.from_numpy(x), axis=axis)
    want = mx.np.argsort(mx.np.array(x), axis=axis).asnumpy()
    assert got.dtype == torch.int32 and want.dtype == onp.int32
    onp.testing.assert_array_equal(got.numpy(), want)
    flat = torch.from_numpy(x).reshape(-1)
    if axis is None:
        assert torch.equal(flat[got], flat[got.long()])


@pytest.mark.parametrize("obj,dtype", [
    ([1.5, 2.0, -3.25], None), ([1, 2, 3], None),
    (onp.arange(6, dtype=onp.int64).reshape(2, 3), None),
    (onp.linspace(-1, 1, 7), None), (onp.linspace(-1, 1, 7), "bfloat16"),
    (onp.arange(4, dtype=onp.uint8), None), ([[1, 0]], "int32")])
def test_array_and_asarray_equal_the_references(obj, dtype):
    got = mxt.np.array(obj, dtype=dtype, ctx=cpu())
    want = mx.np.array(obj, dtype=dtype)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    onp.testing.assert_array_equal(got.float().numpy() if dtype ==
                                   "bfloat16" else got.numpy(), _ref_np(want))
    assert mxt.np.asarray(got) is got
    assert mxt.np.asarray(got, dtype="float32").dtype == torch.float32


def test_array_targets_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(MXNetError, match="CUDA is not available"):
        mxt.np.array([1.0])


@pytest.mark.parametrize("axes", [None, (0, 3, 1, 2), (2, 0, 1, 3)])
def test_transpose_equals_the_references(axes):
    x = onp.random.default_rng(1).uniform(size=(2, 3, 4, 5)).astype(
        onp.float32)
    got = mxt.np.transpose(torch.from_numpy(x), axes)
    want = mx.np.transpose(mx.np.array(x), axes).asnumpy()
    assert got.is_contiguous()
    onp.testing.assert_array_equal(got.numpy(), want)

