"""The port's model-level dropout on the CPU (`ops.nn.dropout`: two
hand-written CUDA kernels, `csrc/dropout.cu`, and their plain versions).

The mask is the port's own (the reference draws XLA's random bits): one
threefry2x32 hash of the draw's two seed words for each pair of
elements, its first word keeping element 2j and its second element
2j + 1.  Here the plain forward is held bitwise to a numpy threefry2x32
(itself held to the hash's published test vectors), its keep rate to
1 - p within 5 sigma, the plain backward to the gradient times the
forward's mask, the packed keep bits to their layout, and the wrappers,
with the kernel library replaced by a fake, to the pointers, sizes and
alignment they hand it.  The kernels themselves run only on the card:
`chip_smoke.py` (phase 2d) holds them bitwise against these plain
versions there.
"""
import ctypes

import numpy as onp
import pytest
import torch

from mxnet_tpu_torch.ops import _build
from mxnet_tpu_torch.ops import nn

torch.set_num_threads(1)

SEED = (0x2468ACE, 0xFFFFECA9)
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _np_threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32, 20 rounds, both words, on numpy uint32 arrays."""
    k0, k1, c0, c1 = (onp.asarray(a, onp.uint32) for a in (k0, k1, c0, c1))
    ks2 = onp.uint32(0x1BD11BDA) ^ k0 ^ k1
    x0, x1 = c0 + k0, c1 + k1
    inj = ((k1, ks2), (ks2, k0), (k0, k1), (k1, ks2), (ks2, k0))
    for i, (a, b) in enumerate(inj):
        for r in _ROT[i % 2]:
            x0 = x0 + x1
            x1 = ((x1 << onp.uint32(r)) | (x1 >> onp.uint32(32 - r))) ^ x0
        x0 = x0 + a
        x1 = x1 + b + onp.uint32(i + 1)
    return x0, x1


@pytest.mark.parametrize("key, ctr, want", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0))])
def test_numpy_threefry_matches_the_published_vectors(key, ctr, want):
    got = _np_threefry2x32(*[onp.array([w]) for w in key + ctr])
    assert (int(got[0][0]), int(got[1][0])) == want


def _np_keep(n, seed, p):
    j = onp.arange((n + 1) // 2, dtype=onp.uint64)
    w0, w1 = _np_threefry2x32(seed[0], seed[1], j & 0xFFFFFFFF, j >> 32)
    thr = nn._keep_threshold(1.0 - p)
    return onp.stack([w0 < thr, w1 < thr], axis=1).reshape(-1)[:n]


@pytest.mark.parametrize("n", [1, 2, 7, 32, 33, 1000, 4097])
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_plain_forward_hashes_pairs(n, p):
    """Element 2j takes pair j's first word, 2j + 1 its second (an odd
    n's last element the first); the output is the input scaled by
    1/(1 - p) in f32 where kept, else 0."""
    seed = torch.tensor(SEED, dtype=torch.int64).to(torch.int32)
    keep = _np_keep(n, SEED, p)
    assert onp.array_equal(nn.dropout_keep(n, seed, p).numpy(), keep)
    x = onp.random.default_rng(n).standard_normal(n).astype(onp.float32)
    out, bits = nn.dropout_forward_reference(torch.from_numpy(x), seed, p)
    want = onp.where(keep, x * onp.float32(1.0 / (1.0 - p)), 0)
    assert onp.array_equal(out.numpy(), want.astype(onp.float32))
    assert onp.array_equal(nn.unpack_keep_bits(bits, n).numpy(), keep)


def test_odd_count_takes_the_first_word_last():
    """n = 5: element 4 is pair 2's first word; pair 2's second word is
    drawn and left unused."""
    full = nn.dropout_keep(6, SEED, 0.5)
    assert torch.equal(nn.dropout_keep(5, SEED, 0.5), full[:5])
    w0, _ = _np_threefry2x32(SEED[0], SEED[1], onp.array([2]),
                             onp.array([0]))
    assert bool(full[4]) == bool(w0[0] < nn._keep_threshold(0.5))


def test_high_counter_word():
    """Pairs past 2^32 count in the counter's second word: keep of the
    pair j = 2^32 + 3 is the hash of (3, 1)."""
    j = torch.tensor([2 ** 32 + 3])
    w0, w1 = nn.threefry2x32(*SEED, j & nn._M32, j >> 32)
    n0, n1 = _np_threefry2x32(SEED[0], SEED[1], onp.array([3]),
                              onp.array([1]))
    assert (int(w0), int(w1)) == (int(n0[0]), int(n1[0]))


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_keep_rate_within_five_sigma(p):
    n = 400_001
    kept = nn.dropout_keep(n, (12345, 678), p).double().mean().item()
    sigma = (p * (1 - p) / n) ** 0.5
    assert abs(kept - (1 - p)) < 5 * sigma


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_plain_backward_is_grad_times_the_forward_mask(dtype):
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(3, 101, 7, generator=gen).to(dtype)
    grad = torch.randn(3, 101, 7, generator=gen).to(dtype)
    p = 0.3
    out, bits = nn.dropout_forward_reference(x, SEED, p)
    mask = nn.dropout_reference(torch.ones(x.shape), SEED, p)
    dx = nn.dropout_backward_reference(grad, bits, p)
    assert dx.dtype == dtype
    assert torch.equal(dx, (grad.float() * mask).to(dtype))
    assert torch.equal(out != 0, mask != 0)


def test_pack_layout_and_round_trip():
    """Bit b of word w is element 32 w + b; the bits past n are 0; the
    words are int32 holding uint32 bits."""
    keep = torch.zeros(70, dtype=torch.bool)
    keep[[0, 31, 32, 69]] = True
    words = nn.pack_keep_bits(keep)
    assert words.dtype == torch.int32 and words.shape == (3,)
    assert words.tolist() == [1 | -(1 << 31), 1, 1 << 5]
    assert torch.equal(nn.unpack_keep_bits(words, 70), keep)
    rand = nn.dropout_keep(1000, SEED, 0.5)
    assert torch.equal(nn.unpack_keep_bits(nn.pack_keep_bits(rand), 1000),
                       rand)
    assert torch.equal(nn.pack_keep_bits(torch.ones(33, dtype=torch.bool)),
                       torch.tensor([-1, 1], dtype=torch.int32))


def test_autograd_backward_reads_the_saved_bits():
    """The backward needs the keep bits only: seed words rewritten after
    the forward (as a captured step's buffer is at its next replay)
    leave the gradient as the forward's mask, and the CPU takes the
    plain versions, so no launch is counted."""
    seed = torch.tensor([5, 6], dtype=torch.int32)
    x = torch.randn(4, 33, requires_grad=True)
    before = (nn.DROPOUT.launches, nn.DROPOUT_BWD.launches)
    y = nn.dropout(x, seed, 0.25)
    seed.copy_(torch.tensor([7, 8], dtype=torch.int32))
    y.backward(torch.ones_like(y))
    mask = nn.dropout_reference(torch.ones(4, 33), [5, 6], 0.25)
    assert torch.equal(x.grad, mask)
    assert torch.equal(y, nn.dropout_reference(x.detach(), [5, 6], 0.25))
    assert (nn.DROPOUT.launches, nn.DROPOUT_BWD.launches) == before
    assert nn.dropout(x, seed, 0.0) is x


# ---------------------------------------------------------------------------
# the wrappers against a fake kernel library
# ---------------------------------------------------------------------------
class _FakeLib:
    """Stands in for the dropout library: records each call's arguments
    and returns ``result``."""

    def __init__(self, result=0):
        self.calls = []
        self.result = result

    def __getattr__(self, name):
        lib = self

        class Entry:
            argtypes = None
            restype = None

            def __call__(self, *args):
                assert len(args) == len(self.argtypes)
                lib.calls.append((name, args))
                return lib.result

        entry = Entry()
        setattr(self, name, entry)
        return entry


@pytest.fixture
def fake(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(_build, "load", lambda name, declare: (
        declare(lib), lib)[1])
    monkeypatch.setattr(nn, "stream_of", lambda x: 0x77)
    return lib


@pytest.mark.parametrize("dtype, code", [(torch.float32, 0),
                                         (torch.bfloat16, 1),
                                         (torch.float16, 2)])
def test_forward_wrapper_hands_the_kernel_its_buffers(fake, dtype, code):
    x = torch.zeros(1001, dtype=dtype)[1:]          # 1000, off 16 bytes
    seed = torch.tensor([3, -4], dtype=torch.int32)
    fwd, bwd = nn.DROPOUT.launches, nn.DROPOUT_BWD.launches
    out, bits = nn._launch_forward(x, seed, 0.1)
    (name, a), = fake.calls
    assert name == "dropout_forward"
    assert a[:4] == (x.data_ptr(), out.data_ptr(), bits.data_ptr(),
                     seed.data_ptr())
    assert a[4:] == (1000, code, nn._keep_threshold(0.9), 1.0 / 0.9, 0x77)
    assert bits.dtype == torch.int32 and bits.shape == (32,)
    assert out.shape == x.shape and out.dtype == dtype
    # the output starts as far from a 16-byte boundary as the input
    assert out.data_ptr() % 16 == x.data_ptr() % 16 != 0
    assert (nn.DROPOUT.launches, nn.DROPOUT_BWD.launches) == (fwd + 1, bwd)


def test_backward_wrapper_takes_bits_and_no_seed(fake):
    grad = torch.zeros(2, 3, 7, dtype=torch.bfloat16)
    bits = torch.zeros(2, dtype=torch.int32)
    fwd, bwd = nn.DROPOUT.launches, nn.DROPOUT_BWD.launches
    dx = nn._launch_backward(grad, bits, 0.5)
    (name, a), = fake.calls
    assert name == "dropout_backward"
    assert a == (grad.data_ptr(), bits.data_ptr(), dx.data_ptr(), 42, 1,
                 2.0, 0x77)
    assert dx.shape == grad.shape and dx.data_ptr() % 16 == 0
    assert (nn.DROPOUT.launches, nn.DROPOUT_BWD.launches) == (fwd + 1,
                                                              bwd + 1)
    with pytest.raises(ValueError, match="2 int32 words"):
        nn._launch_backward(grad, torch.zeros(3, dtype=torch.int32), 0.5)


def test_a_failed_launch_raises_and_counts_nothing(fake):
    fake.result = 700                     # cudaErrorIllegalAddress
    x = torch.zeros(64)
    counts = (nn.DROPOUT.launches, nn.DROPOUT_BWD.launches)
    with pytest.raises(RuntimeError, match="forward launch failed.*700"):
        nn._launch_forward(x, torch.zeros(2, dtype=torch.int32), 0.1)
    with pytest.raises(RuntimeError, match="backward launch failed.*700"):
        nn._launch_backward(x, torch.zeros(2, dtype=torch.int32), 0.1)
    assert (nn.DROPOUT.launches, nn.DROPOUT_BWD.launches) == counts


def test_wrappers_refuse_what_the_kernels_do_not_take(fake):
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        nn._launch_forward(torch.zeros(4, dtype=torch.float64),
                           torch.zeros(2, dtype=torch.int32), 0.1)
    with pytest.raises(ValueError, match="two int32 words"):
        nn._launch_forward(torch.zeros(4), torch.zeros(3, dtype=torch.int32),
                           0.1)
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        nn._dropout_forward(torch.zeros(4, device="meta"),
                            torch.zeros(2, dtype=torch.int32), 0.1)
    assert fake.calls == []


def test_declared_argument_types():
    """Pointers as void *, the count as long long: ctypes would cut a
    pointer passed as an int."""
    lib = _FakeLib()
    nn._declare_dropout(lib)
    p = ctypes.c_void_p
    assert lib.dropout_forward.argtypes == [
        p, p, p, p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint,
        ctypes.c_float, p]
    assert lib.dropout_backward.argtypes == [
        p, p, p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float, p]
