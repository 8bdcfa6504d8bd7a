"""The port's serving Endpoint over a small BERT, on an explicit CPU device.

The model is the small BertModel of ``test_torch_bert.py`` with
``use_flash=True`` (the flash kernel's plain version on the CPU).
Requests carry (tokens, segments, valid_mask) of their own lengths and
are padded by the endpoint onto the (16, 32, 128) sequence grid and the
(1, 2, 4, 8) batch grid.  (As in the reference, the endpoint trims every
output whose sequence axis has the bucket's length, so no bucket equals
the model width of 64, or the pooled output would be trimmed too.)

Tolerance: a request served inside a padded batch sees the same valid
keys as the request alone — padded keys are masked to exact zero weight
— so the two differ only by the summation order of products over a
longer padded row, a few ulps of f32: atol = rtol = 1e-5.  Against the
JAX package's Endpoint (same weights, JAX flash kernel in interpret
mode) the stated BERT tolerance applies: atol = rtol = 1e-4.
"""
import threading
import time

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.models import BertModel as RefBert
from mxnet_tpu.serve import Endpoint as RefEndpoint
from mxnet_tpu_torch import cpu
from mxnet_tpu_torch.models import BertModel
from mxnet_tpu_torch.serve import (Endpoint, QueueFullError, RequestTimeout)
from mxnet_tpu_torch.utils.convert import load_reference_params

torch.set_num_threads(1)

CFG = dict(vocab_size=100, units=64, hidden_size=128, num_layers=2,
           num_heads=4, max_length=128, dropout=0.0)
SEQ_BUCKETS = (16, 32, 128)
LENGTHS = (1, 5, 31, 32, 33, 64, 90, 128, 17, 70, 3, 100)


@pytest.fixture(scope="module")
def net():
    return BertModel(use_flash=True, **CFG).initialize(
        ctx=cpu(), generator=torch.Generator().manual_seed(11))


def _request(length, seed, rows=1):
    rng = onp.random.default_rng(seed)
    tokens = rng.integers(1, CFG["vocab_size"], (rows, length)).astype(
        onp.int32)
    segments = (onp.arange(length) >= length // 2).astype(onp.int32)[None]
    valid = onp.ones((rows, length), onp.int32)
    return tokens, segments.repeat(rows, 0), valid


def _direct(net, req):
    with torch.inference_mode():
        return net(*(torch.from_numpy(a) for a in req))


def test_threaded_requests_match_direct_forward(net):
    reqs = [_request(n, i) for i, n in enumerate(LENGTHS)]
    results = [None] * len(reqs)
    with Endpoint(net, device="cpu", max_batch_size=8, max_latency_ms=20,
                  seq_buckets=SEQ_BUCKETS) as ep:
        ep.warmup(*reqs[0])

        def client(idx):
            for i in idx:
                results[i] = ep.submit(*reqs[i]).result(timeout=120)

        threads = [threading.Thread(target=client, args=(range(c, len(reqs),
                                                                4),))
                   for c in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
        stats = ep.stats()
    for req, (seq, pooled) in zip(reqs, results):
        length = req[0].shape[1]
        assert seq.shape == (1, length, CFG["units"])
        assert pooled.shape == (1, CFG["units"])
        seq_d, pooled_d = _direct(net, req)
        torch.testing.assert_close(seq, seq_d, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(pooled, pooled_d, atol=1e-5, rtol=1e-5)
    # warmup ran the whole 4 x 3 grid, so traffic never missed
    assert stats["executables"] == 4 * len(SEQ_BUCKETS)
    assert stats["cache_misses"] == 0
    assert stats["cache_hits"] == stats["batches"] >= 1
    assert stats["completed"] == stats["submitted"] == len(reqs)
    assert stats["latency_ms_p99"] is not None


def test_padded_batch_rows_are_finite(net):
    """The endpoint pads a 3-row batch to 4 with all-zero rows (a
    valid_mask row of zeros: no valid key).  The whole padded batch the
    model computes stays finite."""
    seen = []

    def model(*tensors):
        out = net(*tensors)
        seen.append([bool(torch.isfinite(o).all()) for o in out])
        seen.append(tensors[2].sum(dim=1).tolist())
        return out

    with Endpoint(model, device="cpu", max_batch_size=4, max_latency_ms=200,
                  seq_buckets=SEQ_BUCKETS) as ep:
        futs = [ep.submit(*_request(n, n)) for n in (5, 9, 12)]
        for f in futs:
            f.result(timeout=120)
    assert seen[0] == [True, True]
    assert seen[1] == [5, 9, 12, 0]


def test_cache_counts_misses_without_warmup(net):
    with Endpoint(net, device="cpu", max_batch_size=2, max_latency_ms=1,
                  seq_buckets=SEQ_BUCKETS) as ep:
        for n in (10, 12, 40):
            ep.predict(*_request(n, n))
        stats = ep.stats()
    # seq 10 and 12 share the 16 bucket; 40 takes the 128 bucket
    assert stats["cache_misses"] == 2 and stats["cache_hits"] == 1
    assert stats["executables"] == 2


def test_shutdown_drains_queued_requests(net):
    ep = Endpoint(net, device="cpu", max_batch_size=4,
                  seq_buckets=SEQ_BUCKETS, start=False)
    futs = [ep.submit(*_request(n, n)) for n in (3, 8, 40, 7, 128, 2)]
    ep.shutdown(drain=True, timeout=120)
    for f in futs:
        seq, _ = f.result(timeout=0)
        assert torch.isfinite(seq).all()
    assert ep.stats()["completed"] == 6


def test_deadline_and_queue_full(net):
    ep = Endpoint(net, device="cpu", max_batch_size=4, max_queue=2,
                  seq_buckets=SEQ_BUCKETS, start=False)
    late = ep.submit(*_request(4, 1), timeout_ms=1)
    ok = ep.submit(*_request(4, 2))
    with pytest.raises(QueueFullError):
        ep.submit(*_request(4, 3))
    time.sleep(0.05)
    ep.start()
    with pytest.raises(RequestTimeout):
        late.result(timeout=60)
    assert ok.result(timeout=120)[0].shape == (1, 4, CFG["units"])
    ep.shutdown()
    stats = ep.stats()
    assert stats["timeouts"] == 1 and stats["rejected_full"] == 1


def test_endpoint_requires_card_unless_cpu_is_named(net):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from mxnet_tpu_torch.base import MXNetError
    with pytest.raises(MXNetError, match="CUDA is not available"):
        Endpoint(net, start=False)


def test_matches_jax_endpoint():
    ref = RefBert(use_flash=True, **CFG)
    ref.initialize()
    ref(mx.np.zeros((1, 32), dtype="int32"))
    net = load_reference_params(
        BertModel(use_flash=True, **CFG).initialize(ctx=cpu()),
        {k: p.data().asnumpy() for k, p in ref.collect_params().items()})
    reqs = [_request(n, 100 + n) for n in (7, 30, 19)]
    kw = dict(max_batch_size=4, max_latency_ms=200, seq_buckets=(32,))
    with RefEndpoint(ref, **kw) as ref_ep:
        ref_out = [f.result(timeout=300)
                   for f in [ref_ep.submit(*r) for r in reqs]]
    with Endpoint(net, device="cpu", **kw) as ep:
        out = [f.result(timeout=120) for f in [ep.submit(*r) for r in reqs]]
    for (seq_r, pooled_r), (seq, pooled) in zip(ref_out, out):
        onp.testing.assert_allclose(seq.numpy(), seq_r.asnumpy(),
                                    atol=1e-4, rtol=1e-4)
        onp.testing.assert_allclose(pooled.numpy(), pooled_r.asnumpy(),
                                    atol=1e-4, rtol=1e-4)


def test_swap_model_serves_new_version_after_flip(net):
    other = BertModel(use_flash=True, **CFG).initialize(
        ctx=cpu(), generator=torch.Generator().manual_seed(12))
    req = _request(20, 5)
    with Endpoint(net, device="cpu", max_batch_size=4, max_latency_ms=1,
                  seq_buckets=SEQ_BUCKETS) as ep:
        ep.warmup(*req)
        before = ep.predict(*req)
        version = ep.swap_model(other)
        after = ep.predict(*req)
        stats = ep.stats()
    assert version == 1 and stats["model_version"] == 1
    torch.testing.assert_close(before[0], _direct(net, req)[0])
    torch.testing.assert_close(after[0], _direct(other, req)[0])
    # the new version was staged over the live grid: no miss after the flip
    assert stats["cache_misses"] == 0


def test_poisoned_request_fails_alone(net):
    def model(tokens, segments, valid):
        # token 0 inside a request's valid positions marks the poison
        # (padding rows are all zeros, but not valid)
        if bool(((tokens == 0) & (valid != 0)).any()):
            raise ValueError("poisoned request")
        return net(tokens, segments, valid)

    good = [_request(n, n) for n in (4, 6, 9)]
    bad = _request(5, 1)
    bad[0][0, 2] = 0
    ep = Endpoint(model, device="cpu", max_batch_size=8,
                  seq_buckets=SEQ_BUCKETS, start=False)
    futs = [ep.submit(*r) for r in (good[0], bad, good[1], good[2])]
    ep.shutdown(drain=True, timeout=120)
    with pytest.raises(ValueError, match="poisoned"):
        futs[1].result(timeout=0)
    for f, r in zip([futs[0], futs[2], futs[3]], good):
        torch.testing.assert_close(f.result(timeout=0)[0], _direct(net, r)[0])
    stats = ep.stats()
    assert stats["failed"] == 1 and stats["completed"] == 3


@pytest.mark.parametrize("window_ms, batches", [(60_000, 1), (1, 4)])
def test_latency_window_bounds_the_batch(net, window_ms, batches):
    """The reference's batching policy: requests join the oldest one's
    batch only while its ``max_latency_ms`` window is open, so requests
    queued past the window are dispatched one by one."""
    ep = Endpoint(net, device="cpu", max_batch_size=4,
                  max_latency_ms=window_ms, seq_buckets=SEQ_BUCKETS,
                  start=False)
    futs = [ep.submit(*_request(n, n)) for n in (3, 8, 12, 15)]
    time.sleep(0.02)
    ep.start()
    for f in futs:
        f.result(timeout=120)
    ep.shutdown()
    assert ep.stats()["batches"] == batches
