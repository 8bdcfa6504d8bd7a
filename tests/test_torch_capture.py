"""The bookkeeping around the CUDA graphs of `FusedTrainStep` and the
serving cache, on the CPU, with a stand-in for the graph.

On the card a training step and a serving bucket are captured into a
``torch.cuda.CUDAGraph`` (`ops.capture.Graph`) and replayed.  A CUDA
graph cannot be captured here, so these tests replace `Graph` by a
stand-in (its capture runs the function once, as a capture traces it;
its replay does nothing for the training step, and runs the function
again for a serving bucket) and make `capturable` say yes for the CPU.
What they hold is what surrounds the graph:

- a step is run eagerly at the first call of a signature, captured at
  the second and replayed from then on; a new input shape, a new
  ``batch_size``, a parameter bound to a new tensor (``set_data``,
  ``cast``) each give a new capture;
- the seed words a replay writes into the static buffer are the words
  the eager step would draw at that step from the same generator, in the
  order it draws them, and the optimizer's packed scalars follow them;
- the capture differentiates to fresh leaves over the parameters'
  storage, so an eager loss whose graph is alive does not reach it;
- a capture counts no kernel launch, and each replay counts the
  launches the capture recorded;
- the staging ring hands its buffers out in turn;
- the serving endpoint returns copies, not views, of a bucket's static
  outputs, which the next batch overwrites.
"""
import numpy as onp
import pytest
import torch

from mxnet_tpu_torch import autograd, cpu
from mxnet_tpu_torch.gluon import FusedTrainStep, HybridBlock, Trainer, nn
from mxnet_tpu_torch.ops import _build, capture
from mxnet_tpu_torch.ops.invoke import set_seed_table
from mxnet_tpu_torch.ops.seeds import SeedTable
from mxnet_tpu_torch.serve import Endpoint

torch.set_num_threads(1)

PROBE = _build.Kernel("capture_test_probe")


class _StandIn(capture.Graph):
    """A graph whose capture runs the function once and whose replay runs
    nothing (``rerun``: runs it again, writing into the first outputs)."""

    rerun = False
    made = []

    def _record(self, fn):
        _StandIn.made.append(self)
        self._fn = fn
        self._out = fn()
        return self._out

    def _launch(self):
        if self.rerun:
            new = self._fn()
            with torch.inference_mode():      # outputs of a served forward
                for old, fresh in zip(_leaves(self._out), _leaves(new)):
                    old.copy_(fresh)


def _leaves(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [x for o in out for x in _leaves(o)]


@pytest.fixture
def standin(monkeypatch):
    _StandIn.made = []
    monkeypatch.setattr(capture, "Graph", _StandIn)
    monkeypatch.setattr(capture, "capturable", lambda device: True)
    monkeypatch.setattr(capture, "new_pool", lambda: None)
    return _StandIn


class _Net(HybridBlock):
    """Dense, dropout, dense; the mean square as the loss; a launch of
    the probe kernel per forward."""

    def __init__(self):
        super().__init__()
        self.d1 = nn.Dense(8, in_units=4)
        self.drop = nn.Dropout(0.5)
        self.d2 = nn.Dense(1, in_units=8)

    def forward(self, x):
        PROBE.launches += 1
        return (self.d2(self.drop(self.d1(x))) ** 2).mean()


def _setup(seed=0):
    net = _Net()
    net.initialize(ctx=cpu(), generator=torch.Generator().manual_seed(seed))
    trainer = Trainer(net.collect_params(), "adam", {"learning_rate": 0.01})
    step = FusedTrainStep(net, trainer,
                          generator=torch.Generator().manual_seed(5))
    return net, trainer, step


def _x(rows=6, seed=1):
    return torch.from_numpy(onp.random.default_rng(seed).standard_normal(
        (rows, 4)).astype(onp.float32))


def test_first_call_runs_eagerly_second_captures_then_replays(standin):
    net, _, step = _setup()
    x = _x()
    w0 = net.d1.weight.data().clone()
    step(x, batch_size=6)
    assert step.captures == 0 and not standin.made
    assert not torch.equal(net.d1.weight.data(), w0)    # a real step
    step(x, batch_size=6)
    assert step.captures == 1
    graph, = standin.made
    assert graph.replays == 1
    out = step(x, batch_size=6)
    assert step.captures == 1 and graph.replays == 2
    entry, = step._graphs.values()
    # outputs and the verdict are copies of the graph's buffers
    assert out.data_ptr() != entry.outs.data_ptr()
    assert step.last_step_finite.data_ptr() != entry.finite.data_ptr()


def test_signature_keys_the_graphs(standin):
    _, _, step = _setup()
    for x, bs in ((_x(6), 6), (_x(6), 6), (_x(6), 6)):
        step(x, batch_size=bs)
    assert step.captures == 1
    step(_x(3), batch_size=3)            # a new shape: eager first
    assert step.captures == 1
    step(_x(3), batch_size=3)
    assert step.captures == 2
    step(_x(6), batch_size=6)            # the first signature replays
    assert step.captures == 2 and standin.made[0].replays == 3
    step(_x(6), batch_size=12)           # same shapes, new batch_size
    step(_x(6), batch_size=12)
    assert step.captures == 3 and len(step._graphs) == 3


@pytest.mark.parametrize("rebind", ["set_data", "cast", "load_parameters"])
def test_rebinding_a_parameter_captures_again(standin, rebind, tmp_path):
    net, trainer, step = _setup()
    x = _x()
    step(x, batch_size=6)
    step(x, batch_size=6)
    assert step.captures == 1
    old = net.d1.weight.data()
    if rebind == "set_data":
        net.d1.weight.set_data(torch.ones(8, 4))
    elif rebind == "cast":
        net.cast("float32")
    else:
        net.save_parameters(str(tmp_path / "w.params"))
        net.load_parameters(str(tmp_path / "w.params"))
    assert net.d1.weight.data() is not old
    step(x, batch_size=6)
    assert step.captures == 2
    entry, = step._graphs.values()
    assert entry.generations == step._generations()
    step(x, batch_size=6)
    assert step.captures == 2
    # an in-place copy keeps the graph
    with torch.no_grad():
        net.d1.weight.data().copy_(torch.zeros(8, 4))
    fname = str(tmp_path / "s.states")
    trainer.save_states(fname)
    trainer.load_states(fname)
    step(x, batch_size=6)
    assert step.captures == 2


def _eager_words(n_steps, x):
    """The words each of ``n_steps`` eager steps draws, in order."""
    _, _, step = _setup()
    real = capture.capturable
    capture.capturable = lambda device: False
    try:
        words = []
        for _ in range(n_steps):
            table = SeedTable()
            prev = set_seed_table(table)
            try:
                step(x, batch_size=6)
            finally:
                set_seed_table(prev)
            words.append(table.words)
        return words, table.kinds
    finally:
        capture.capturable = real


def test_the_capture_differentiates_fresh_leaves(standin):
    """The capture binds each trainable parameter to a new leaf over the
    same storage (an eager loss still alive holds the old leaves'
    gradient accumulators), and binds the old leaves back after it,
    with no new generation."""
    net, _, step = _setup()
    x = _x()
    seen = []
    real_forward = net.d1.forward

    def spy(*a):
        seen.append(net.d1.weight.data())
        return real_forward(*a)

    net.d1.forward = spy
    step(x, batch_size=6)                     # eager
    weight, gen = net.d1.weight.data(), net.d1.weight.generation
    with autograd.record(generator=torch.Generator().manual_seed(2)):
        loss = net(x)
    loss.backward()                           # its graph stays alive
    step(x, batch_size=6)                     # capture
    assert seen[0] is weight and seen[1] is weight
    leaf = seen[2]
    assert leaf is not weight and leaf.is_leaf and leaf.requires_grad
    assert leaf.data_ptr() == weight.data_ptr()
    assert net.d1.weight.data() is weight
    assert net.d1.weight.generation == gen and step.captures == 1
    step(x, batch_size=6)                     # the replay keeps the graph
    assert step.captures == 1 and loss.grad_fn is not None


def test_replays_write_the_eager_draws_in_order(standin):
    """Step k's replay stages the words step k of the eager path draws
    from the same generator, slot i holding draw i; the optimizer's
    packed scalars follow them."""
    x = _x()
    expect, kinds = _eager_words(5, x)
    assert kinds == ["dropout"]
    _, trainer, step = _setup()
    for k in range(5):
        step(x, batch_size=6)
        if k == 0:
            assert step._kinds[next(iter(step._kinds))] == tuple(kinds)
            continue
        entry, = step._graphs.values()
        n_seed = 2 * len(entry.kinds)
        staged = entry.buf[:n_seed].numpy().view(onp.uint32)
        assert [tuple(staged[2 * i: 2 * i + 2]) for i in
                range(len(kinds))] == [tuple(w) for w in expect[k]], k
        assert entry.buf[n_seed:].view(torch.float32)[0] == \
            onp.float32(1 / 6)                   # the rescale first


def test_a_step_without_a_generator_raises_on_replay(standin):
    net, trainer, _ = _setup()
    step = FusedTrainStep(net, trainer)
    x = _x()
    with autograd.train_mode(generator=torch.Generator().manual_seed(1)):
        step(x, batch_size=6)
        step(x, batch_size=6)
        step(x, batch_size=6)
    with pytest.raises(ValueError, match="Generator"):
        step(x, batch_size=6)


def test_launch_counts_are_the_capture_s_at_each_replay(standin):
    _, _, step = _setup()
    x = _x()
    before = PROBE.launches
    step(x, batch_size=6)                  # eager: the forward runs
    assert PROBE.launches == before + 1
    step(x, batch_size=6)                  # capture (uncounted) + replay
    assert PROBE.launches == before + 2
    graph, = standin.made
    assert graph.launches == {PROBE: 1}
    for _ in range(3):
        step(x, batch_size=6)
    assert PROBE.launches == before + 5


def test_host_ring_takes_its_buffers_in_turn():
    ring = capture.HostRing(4, "cpu", depth=3)
    dest = torch.zeros(4, dtype=torch.int32)
    seen = []
    for k in range(5):
        ring.upload(onp.arange(4, dtype=onp.int32) + 10 * k, dest)
        assert dest.tolist() == [10 * k, 10 * k + 1, 10 * k + 2, 10 * k + 3]
        seen.append(ring._bufs[k % 3].data_ptr())
    assert len(set(seen)) == 3 and seen[0] == seen[3] and seen[1] == seen[4]
    assert ring.waits == 0


def test_endpoint_returns_copies_of_the_static_outputs(standin):
    standin.rerun = True
    try:
        with Endpoint(lambda x: x * 2, device="cpu", max_batch_size=4,
                      max_latency_ms=1) as ep:
            ep.warmup(onp.zeros((1, 3), onp.float32))
            cache = ep._cache_for(ep._version)
            assert len(cache) == len(ep.spec.batch_buckets)
            first = ep.predict(onp.full((1, 3), 1.0, onp.float32))
            second = ep.predict(onp.full((1, 3), 5.0, onp.float32))
            entry = cache._entries[cache.key_for([((1, 3), "float32")])]
            static = entry.outputs
            for res in (first, second):
                assert res.untyped_storage().data_ptr() != \
                    static.untyped_storage().data_ptr()
            # the second batch rewrote the static output, not the first
            # result
            assert first.tolist() == [[2.0, 2.0, 2.0]]
            assert second.tolist() == [[10.0, 10.0, 10.0]]
            assert static.tolist() == [[10.0, 10.0, 10.0]]
            assert entry.graph.replays == 2
            stats = ep.stats()
            assert stats["cache_hits"] == 2 and stats["cache_misses"] == 0
            assert stats["executables"] == len(ep.spec.batch_buckets)
    finally:
        standin.rerun = False


def test_swap_model_captures_the_staged_grid(standin):
    standin.rerun = True
    try:
        with Endpoint(lambda x: x + 1, device="cpu", max_batch_size=2,
                      max_latency_ms=1) as ep:
            ep.warmup(onp.zeros((1, 2), onp.float32))
            n = len(standin.made)
            assert ep.predict(onp.ones((1, 2), onp.float32)).tolist() == \
                [[2.0, 2.0]]
            ep.swap_model(lambda x: x * 10)
            assert len(standin.made) == 2 * n    # the new grid, captured
            assert ep.predict(onp.ones((1, 2), onp.float32)).tolist() == \
                [[10.0, 10.0]]
    finally:
        standin.rerun = False
