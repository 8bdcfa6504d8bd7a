"""The port's serving Endpoint over a small BERT, on an explicit CPU device.

The model is the small BertModel of ``test_torch_bert.py`` with
``use_flash=True`` (the flash kernel's plain version on the CPU).
Requests carry (tokens, segments, valid_mask) of their own lengths and
are padded by the endpoint onto the (16, 32, 128) sequence grid and the
(1, 2, 4, 8) batch grid.  (As in the reference, the endpoint trims every
output whose sequence axis has the bucket's length, so no bucket equals
the model width of 64, or the pooled output would be trimmed too.)

The endpoint's hooks, as the reference runs them around each batch: the
batch hooks and `Monitor.install_endpoint`, the ``stats()`` surface, the
registry's ``mxtpu_serve_*`` series against ``stats()``, a
``serve.model_call`` timeout retried once (and, under a stand-in for the
CUDA graph, a retry copying the batch into the graph's static inputs
anew), ``swap_model(stage=)`` and ``donate=``.

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
from mxnet_tpu_torch import cpu, telemetry
from mxnet_tpu_torch.models import BertModel
from mxnet_tpu_torch.monitor import Monitor
from mxnet_tpu_torch.ops import capture
from mxnet_tpu_torch.resilience import faultline
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


# -- the hooks around each batch ----------------------------------------------

def _sample(name, labels):
    v = telemetry.default_registry().get_sample_value(name, labels)
    return 0.0 if v is None else v


@pytest.fixture
def no_plan():
    faultline.clear()
    yield
    faultline.clear()


def test_batch_hooks_fire_and_detach(net):
    calls = []
    with Endpoint(net, device="cpu", max_batch_size=4, max_latency_ms=200,
                  seq_buckets=SEQ_BUCKETS, start=False) as ep:
        handle = ep.register_batch_hook(
            lambda e, rows, bucket, lat: calls.append((e, rows, bucket, lat)))
        futs = [ep.submit(*_request(n, n)) for n in (5, 9, 12)]
        for f in futs:
            f.result(timeout=120)
        handle.detach()
        handle.detach()                  # a second detach is a no-op
        ep.predict(*_request(4, 4))
    assert len(calls) == 1
    e, rows, bucket, lat = calls[0]
    assert e is ep and rows == 3 and bucket == 4 and lat > 0


def test_monitor_install_endpoint(net):
    mon = Monitor(interval=1)
    with Endpoint(net, device="cpu", max_batch_size=4, max_latency_ms=5,
                  seq_buckets=SEQ_BUCKETS) as ep:
        mon.install_endpoint(ep)
        mon.tic()
        ep.predict(*_request(6, 1))
        rows = mon.toc()
        mon.uninstall()
        mon.tic()
        ep.predict(*_request(6, 2))
        after = mon.toc()
    keys = {k for _s, k, _v in rows}
    assert keys == {f"{ep.name}_batch_occupancy",
                    f"{ep.name}_batch_latency_ms"}
    occ = next(v for _s, k, v in rows if k.endswith("_occupancy"))
    assert occ == 1.0                    # one row in the 1-row bucket
    assert after == []


def test_stats_surface(net):
    req = _request(9, 3)
    with Endpoint(net, device="cpu", max_batch_size=8, max_latency_ms=1,
                  seq_buckets=SEQ_BUCKETS) as ep:
        ep.warmup(*req)
        for _ in range(5):
            ep.predict(*req)
        s = ep.stats()
    for key in ("qps", "latency_ms_p50", "latency_ms_p95", "latency_ms_p99",
                "mean_batch_occupancy", "queue_depth", "cache_hit_rate",
                "submitted", "completed", "batches", "failed", "timeouts",
                "rejected_full", "cache_hits", "cache_misses",
                "queue_wait_ms_p50", "queue_wait_ms_p99", "execute_ms_p50",
                "execute_ms_p99", "executables", "model_version"):
        assert key in s, key
    assert s["qps"] > 0 and s["latency_ms_p50"] > 0
    assert s["submitted"] == s["completed"] == 5
    assert s["cache_hit_rate"] == 1.0


def test_registry_counts_equal_stats(net):
    name = "t_serve_registry"
    ep = Endpoint(net, name=name, device="cpu", max_batch_size=4,
                  max_queue=3, seq_buckets=SEQ_BUCKETS, start=False)
    late = ep.submit(*_request(4, 1), timeout_ms=1)
    futs = [ep.submit(*_request(n, n)) for n in (7, 20)]
    with pytest.raises(QueueFullError):
        ep.submit(*_request(4, 3))
    time.sleep(0.05)
    ep.start()
    with pytest.raises(RequestTimeout):
        late.result(timeout=60)
    for f in futs:
        f.result(timeout=120)
    ep.predict(*_request(40, 5))
    ep.shutdown()
    s = ep.stats()
    lab = {"endpoint": name}
    for event in ("submitted", "completed", "failed", "timeouts",
                  "rejected_full"):
        assert _sample("mxtpu_serve_requests_total",
                       dict(lab, event=event)) == s[event], event
    assert _sample("mxtpu_serve_cache_total", dict(lab, kind="hit")) == \
        s["cache_hits"]
    assert _sample("mxtpu_serve_cache_total", dict(lab, kind="miss")) == \
        s["cache_misses"]
    assert _sample("mxtpu_serve_batches_total", lab) == s["batches"]
    real = _sample("mxtpu_serve_batch_rows_total", dict(lab, kind="real"))
    slots = _sample("mxtpu_serve_batch_rows_total", dict(lab, kind="slots"))
    assert real / slots == pytest.approx(s["mean_batch_occupancy"])
    assert _sample("mxtpu_serve_latency_seconds_count", lab) == \
        s["completed"]
    assert _sample("mxtpu_serve_execute_seconds_count", lab) == s["batches"]
    assert _sample("mxtpu_serve_queue_wait_seconds_count", lab) == \
        s["completed"]
    assert s["timeouts"] == s["rejected_full"] == 1 and s["completed"] == 3


def test_model_call_timeout_is_retried_once(net, no_plan):
    name = "t_serve_retry"
    labels = {"site": "serve.model_call", "kind": "timeout"}
    before = _sample("mxtpu_faults_recovered_total", labels)
    req = _request(11, 4)
    faultline.plan([{"site": "serve.model_call", "kind": "timeout",
                     "at": 1}])
    with Endpoint(net, name=name, device="cpu", max_batch_size=4,
                  max_latency_ms=1, seq_buckets=SEQ_BUCKETS) as ep:
        seq, pooled = ep.predict(*req)
        s = ep.stats()
    seq_d, pooled_d = _direct(net, req)
    torch.testing.assert_close(seq, seq_d, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(pooled, pooled_d, atol=1e-5, rtol=1e-5)
    assert _sample("mxtpu_faults_recovered_total", labels) == before + 1
    assert faultline.arrivals("serve.model_call") == 2
    assert s["completed"] == 1 and s["failed"] == 0 and s["batches"] == 1
    # the fault fired before the device call: one cache lookup
    assert s["cache_hits"] + s["cache_misses"] == 1


class _FlakyReplay(capture.Graph):
    """A stand-in graph (its capture runs the function once, its replay
    runs it again into the first outputs) whose first replay clobbers
    the static inputs and raises a transient error, as a transport
    timeout after the copy-in would."""

    flaky = True

    def _record(self, fn):
        self._fn = fn
        self._out = fn()
        self._inputs = None
        return self._out

    def _launch(self):
        if _FlakyReplay.flaky:
            _FlakyReplay.flaky = False
            for t in self._inputs:
                t.zero_()
            raise TimeoutError("replay timed out")
        new = self._fn()
        with torch.inference_mode():
            for old, fresh in zip(self._out, new):
                old.copy_(fresh)


def test_retry_copies_the_batch_into_the_graph_again(net, monkeypatch):
    """A transient failure after the batch was copied into the graph's
    static inputs: the retry copies it in anew, so the answer is the
    request's own."""
    from mxnet_tpu_torch.serve import cache as cache_mod

    _FlakyReplay.flaky = True
    made = []

    class Entry(cache_mod._Entry):
        def __init__(self, *args):
            super().__init__(*args)
            self.graph._inputs = self.inputs
            made.append(self)

    monkeypatch.setattr(capture, "Graph", _FlakyReplay)
    monkeypatch.setattr(capture, "capturable", lambda device: True)
    monkeypatch.setattr(capture, "new_pool", lambda: None)
    monkeypatch.setattr(cache_mod, "_Entry", Entry)
    req = _request(13, 6)
    with Endpoint(net, device="cpu", max_batch_size=1, max_latency_ms=1,
                  seq_buckets=(16,)) as ep:
        ep.warmup(*req)
        seq, pooled = ep.predict(*req)
        s = ep.stats()
    assert not _FlakyReplay.flaky and len(made) == 1
    seq_d, pooled_d = _direct(net, req)
    torch.testing.assert_close(seq, seq_d, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(pooled, pooled_d, atol=1e-5, rtol=1e-5)
    assert s["cache_hits"] == 2 and s["completed"] == 1


@pytest.mark.parametrize("stage", [True, False])
def test_swap_model_stage(net, stage):
    """``stage=True`` captures the new version's grid before the flip:
    no miss after it.  ``stage=False`` captures nothing: each warmed
    shape used after the flip misses once."""
    other = BertModel(use_flash=True, **CFG).initialize(
        ctx=cpu(), generator=torch.Generator().manual_seed(13))
    reqs = [_request(n, n) for n in (10, 25, 12)]   # two shapes: 16, 32
    with Endpoint(net, device="cpu", max_batch_size=1, max_latency_ms=1,
                  seq_buckets=(16, 32)) as ep:
        ep.warmup(*reqs[0])
        assert ep.swap_model(other, stage=stage) == 1
        outs = [ep.predict(*r) for r in reqs]
        s = ep.stats()
    assert s["cache_misses"] == (0 if stage else 2)
    assert s["cache_hits"] == 3 - s["cache_misses"]
    assert s["executables"] == 2
    for r, (seq, _) in zip(reqs, outs):
        torch.testing.assert_close(seq, _direct(other, r)[0],
                                   atol=1e-5, rtol=1e-5)


def test_donate_is_accepted_and_changes_nothing(net):
    req = _request(8, 2)
    with Endpoint(net, device="cpu", max_batch_size=2, max_latency_ms=1,
                  seq_buckets=(16,), donate=True) as ep:
        assert ep.donate is True
        assert ep.warmup(*req) == 2
        seq, _ = ep.predict(*req)
    torch.testing.assert_close(seq, _direct(net, req)[0],
                               atol=1e-5, rtol=1e-5)
