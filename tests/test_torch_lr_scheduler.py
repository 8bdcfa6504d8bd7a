"""The port's learning-rate schedules against the JAX package's.

Each schedule (`lr_scheduler.py`: Factor, MultiFactor, Poly, Cosine,
with linear and constant warmups) is built in both packages with the
same arguments and called for ``num_update`` = 0 .. N in order, as an
optimizer calls it; every value must equal the reference's exactly
(both are the same double arithmetic on the host).  Beside it: the
schedule reaches the optimizer's packed scalars, so a step that
`FusedTrainStep` replays from a CUDA graph (here a stand-in that runs
nothing) trains at the scheduled lr, and an lr set on an optimizer with
a schedule is refused, as in the reference.
"""
import numpy as onp
import pytest
import torch

from mxnet_tpu import lr_scheduler as ref_sched
from mxnet_tpu_torch import cpu
from mxnet_tpu_torch import lr_scheduler as port_sched
from mxnet_tpu_torch.gluon import FusedTrainStep, HybridBlock, Trainer, nn
from mxnet_tpu_torch.ops import capture

torch.set_num_threads(1)

N_UPDATES = 60

SCHEDULES = [
    ("FactorScheduler", dict(step=7, factor=0.5, base_lr=0.1)),
    ("FactorScheduler", dict(step=5, factor=0.9, stop_factor_lr=0.05,
                             base_lr=0.1, warmup_steps=6,
                             warmup_begin_lr=0.01)),
    ("MultiFactorScheduler", dict(step=[5, 12, 30], factor=0.3,
                                  base_lr=0.2)),
    ("MultiFactorScheduler", dict(step=[10, 20], factor=0.5, base_lr=0.2,
                                  warmup_steps=8, warmup_mode="constant",
                                  warmup_begin_lr=0.02)),
    ("PolyScheduler", dict(max_update=40, base_lr=0.1, pwr=2)),
    ("PolyScheduler", dict(max_update=50, base_lr=1e-3, pwr=1, final_lr=1e-5,
                           warmup_steps=10)),
    ("CosineScheduler", dict(max_update=45, base_lr=0.3, final_lr=0.01)),
    ("CosineScheduler", dict(max_update=45, base_lr=0.3, warmup_steps=9,
                             warmup_begin_lr=0.05)),
]


@pytest.mark.parametrize("name,kw", SCHEDULES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(SCHEDULES)])
def test_schedule_values_equal_the_reference(name, kw):
    mine = getattr(port_sched, name)(**kw)
    theirs = getattr(ref_sched, name)(**kw)
    got = [mine(n) for n in range(N_UPDATES + 1)]
    expect = [theirs(n) for n in range(N_UPDATES + 1)]
    assert got == expect
    assert len(set(got)) > 1


@pytest.mark.parametrize("name,kw", [
    ("FactorScheduler", dict(step=0)),
    ("FactorScheduler", dict(step=2, factor=1.5)),
    ("MultiFactorScheduler", dict(step=[3, 3])),
    ("PolyScheduler", dict(max_update=0)),
    ("CosineScheduler", dict(max_update=0)),
    ("LRScheduler", dict(warmup_mode="cubic")),
])
def test_bad_arguments_raise_as_the_reference(name, kw):
    with pytest.raises(ValueError):
        getattr(ref_sched, name)(**kw)
    with pytest.raises(ValueError):
        getattr(port_sched, name)(**kw)


class _StandIn(capture.Graph):
    """A graph whose capture runs the function once and whose replay
    runs nothing: what a replay trains with is what the host wrote into
    the static buffer."""

    def _record(self, fn):
        return fn()

    def _launch(self):
        pass


class _Net(HybridBlock):
    def __init__(self):
        super().__init__()
        self.d = nn.Dense(1, in_units=3)

    def forward(self, x):
        return (self.d(x) ** 2).mean()


def test_replayed_steps_carry_the_scheduled_lr(monkeypatch):
    """Each call of a captured step writes the optimizer's scalars for
    its own update count into the static buffer: the packed lr follows
    the schedule, warmup included, step after step."""
    monkeypatch.setattr(capture, "Graph", _StandIn)
    monkeypatch.setattr(capture, "capturable", lambda device: True)
    net = _Net()
    net.initialize(ctx=cpu(), generator=torch.Generator().manual_seed(0))
    schedule = port_sched.PolyScheduler(max_update=20, base_lr=0.5, pwr=1,
                                        warmup_steps=4)
    twin = port_sched.PolyScheduler(max_update=20, base_lr=0.5, pwr=1,
                                    warmup_steps=4)
    trainer = Trainer(net.collect_params(), "sgd",
                      {"learning_rate": 0.5, "lr_scheduler": schedule})
    step = FusedTrainStep(net, trainer)
    uploads = []
    real = capture.HostRing.upload

    def spy(ring, words, dest):
        uploads.append(onp.asarray(words).copy())
        return real(ring, words, dest)

    monkeypatch.setattr(capture.HostRing, "upload", spy)
    x = torch.ones(2, 3)
    for _ in range(8):
        step(x, batch_size=2)
    assert step.captures == 1
    # one upload a replay (the capture's call replays too: calls 2..8);
    # the packed f32 array holds the rescale, then the (lr, wd) row of the
    # one group
    assert len(uploads) == 7
    for n, host in enumerate(uploads, start=2):
        lr = host.view(onp.float32)[1]
        assert lr == onp.float32(twin(n)), n
    assert trainer.optimizer.num_update == 8


def test_set_learning_rate_refused_with_a_schedule():
    trainer = Trainer([], "sgd", {"lr_scheduler":
                                  port_sched.FactorScheduler(step=2)})
    with pytest.raises(UserWarning):
        trainer.set_learning_rate(0.1)
