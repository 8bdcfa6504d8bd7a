"""`mxnet_tpu_torch.parallel.mesh` against `mxnet_tpu.parallel.mesh`, in
one process.

The reference's meshes are grids of devices (here its eight virtual CPU
devices), the port's grids of ranks; `make_mesh` takes the same axes
and the same ``-1`` and subset rules, and lays the ranks out as the
reference lays out its devices' ids.  `match_partition_rules` and
`RuleCoverage` are the reference's regex logic, compared on the same
rules and shapes.  The rest is what a rank does over the mesh: its rows
(`global_put`, with the rank and world stood in), the refusals that name
ROADMAP queue A item A8 and `tools/launch.py`, and a `FusedTrainStep`
over a mesh of one rank, bitwise the plain step's.
"""
import logging

import jax
import numpy as onp
import pytest
import torch

from mxnet_tpu.parallel import mesh as ref_mesh
from mxnet_tpu_torch import cpu, gluon, parallel
from mxnet_tpu_torch.parallel import mesh as port_mesh
from mxnet_tpu_torch.parallel.mesh import PartitionSpec as P
from mxnet_tpu_torch.resilience import checkpoint

torch.set_num_threads(1)

RP = ref_mesh.PartitionSpec


def _ids(mesh):
    return onp.vectorize(lambda d: d.id)(mesh.devices)


@pytest.mark.parametrize("axes", [
    None, {"dp": -1}, {"dp": 2, "tp": -1}, {"dp": -1, "tp": 2},
    {"dp": 2, "tp": 2, "pp": 2}, {"dp": 4}, {"dp": 2, "tp": 1},
])
def test_make_mesh_matches_reference(axes, caplog):
    devs = jax.devices()[:8]
    with caplog.at_level(logging.WARNING):
        ref = ref_mesh.make_mesh(axes, devices=devs)
        ref_warned = [r.getMessage() for r in caplog.records]
        caplog.clear()
        mine = port_mesh.make_mesh(axes, devices=list(range(8)))
        warned = [r.getMessage() for r in caplog.records]
    assert mine.shape == dict(ref.shape)
    assert mine.axis_names == tuple(ref.axis_names)
    onp.testing.assert_array_equal(mine.devices, _ids(ref))
    assert mine.size == ref.size
    assert warned == ref_warned


@pytest.mark.parametrize("axes", [
    {"dp": -1, "tp": -1}, {"dp": 3, "tp": -1}, {"dp": 16},
])
def test_make_mesh_refusals_match_reference(axes):
    with pytest.raises(ValueError) as ref_err:
        ref_mesh.make_mesh(axes, devices=jax.devices()[:8])
    with pytest.raises(ValueError) as err:
        port_mesh.make_mesh(axes, devices=list(range(8)))
    assert str(err.value) == str(ref_err.value)


def test_mesh_defaults_to_the_world_and_refuses_local_devices():
    assert port_mesh.make_mesh().shape == {"dp": 1}
    assert port_mesh.make_mesh(devices=[cpu()]).shape == {"dp": 1}
    with pytest.raises(ValueError, match="tools/launch.py"):
        port_mesh.make_mesh(devices=[cpu(0), cpu(1)])


RULES = [
    (r"dense\d*\.weight", ("tp", None)),
    (r"embed", (None, "tp")),
    (r"bias", ("tp",)),
]
SHAPES = {"dense0.weight": (8, 4), "dense0.bias": (8,),
          "embed.weight": (100, 16), "norm.gamma": (16,),
          "scale": (), "one": (1, 1), "head.weight": (4, 16)}


@pytest.mark.parametrize("strict", [False, True])
def test_match_partition_rules_matches_reference(strict):
    ref_rules = [(p, RP(*s)) for p, s in RULES]
    rules = [(p, P(*s)) for p, s in RULES]
    if strict:
        with pytest.raises(ValueError) as ref_err:
            ref_mesh.match_partition_rules(ref_rules, SHAPES, strict=True)
        with pytest.raises(ValueError) as err:
            port_mesh.match_partition_rules(rules, SHAPES, strict=True)
        assert str(err.value) == str(ref_err.value)
        return
    ref = ref_mesh.match_partition_rules(ref_rules, SHAPES)
    mine = port_mesh.match_partition_rules(rules, SHAPES)
    assert isinstance(mine, port_mesh.RuleCoverage) and isinstance(mine, dict)
    assert {k: tuple(v) for k, v in mine.items()} == \
        {k: tuple(v) for k, v in ref.items()}
    assert mine.matched == ref.matched
    assert mine.replicated == ref.replicated
    assert mine.scalars == ref.scalars
    assert mine.summary() == ref.summary()


def test_shardings_and_scope():
    mesh = port_mesh.make_mesh({"dp": -1})
    assert tuple(parallel.data_sharding(mesh).spec) == ("dp",)
    assert tuple(parallel.replicated_sharding(mesh).spec) == ()
    assert repr(P("dp", None)) == "PartitionSpec('dp', None)"
    assert parallel.current_mesh() is None
    with parallel.mesh_scope(mesh) as m:
        assert m is mesh and parallel.current_mesh() is mesh
        # one rank, no process group: BatchNorm stays local
        assert port_mesh.sync_size() == 1
    assert parallel.current_mesh() is None
    x = torch.arange(6.0)
    assert parallel.constrain(x, mesh, P("dp")) is x
    with pytest.raises(NotImplementedError, match="A8"):
        parallel.constrain(x, mesh, P(None, "tp"))


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_global_put_hands_each_rank_its_rows(rank, monkeypatch):
    monkeypatch.setattr(port_mesh._distributed, "world",
                        lambda: (rank, 4))
    mesh = port_mesh.make_mesh({"dp": 2, "tp": 2})
    x = torch.arange(24.0).reshape(8, 3)
    rows = parallel.global_put(x, parallel.NamedSharding(mesh, P("dp")))
    dp_index = mesh.coords(rank)["dp"]
    torch.testing.assert_close(rows, x[4 * dp_index:4 * dp_index + 4])
    both = parallel.global_put(onp.asarray(x),
                               parallel.NamedSharding(mesh, P(("dp", "tp"))))
    torch.testing.assert_close(both, x[2 * rank:2 * rank + 2])
    whole = parallel.global_put(x, parallel.replicated_sharding(mesh))
    assert whole is x
    with pytest.raises(ValueError, match="do not divide"):
        parallel.global_put(torch.ones(3, 2),
                            parallel.NamedSharding(mesh, P("dp")))
    with pytest.raises(NotImplementedError, match="A8"):
        parallel.global_put(x, parallel.NamedSharding(mesh, P("dp", "tp")))


def _tiny(seed=0):
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(6, in_units=5), gluon.nn.BatchNorm(in_channels=6),
            gluon.nn.Dense(3, in_units=6))
    net.initialize(ctx=cpu(), generator=torch.Generator().manual_seed(seed))
    return net


def test_shard_parameters_replicates_and_refuses_sharding():
    net = _tiny()
    mesh = port_mesh.make_mesh({"dp": -1})
    params = net.collect_params()
    specs = parallel.shard_parameters(params, mesh)
    assert len(specs.replicated) == len(params) - len(specs.scalars)
    with pytest.raises(NotImplementedError, match="A8"):
        parallel.shard_parameters(params, mesh, [(r"weight", P("tp"))])


def _loss_block(net):
    class WithLoss(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.net = net
            self.loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

        def forward(self, x, y):
            return self.loss_fn(self.net(x), y)

    return WithLoss()


def test_step_over_a_mesh_of_one_rank_is_the_plain_step():
    rs = onp.random.RandomState(3)
    x = torch.from_numpy(rs.normal(size=(8, 5)).astype(onp.float32))
    y = torch.from_numpy(rs.randint(0, 3, (8,)).astype(onp.float32))
    runs = []
    for mesh in (None, port_mesh.make_mesh({"dp": -1})):
        net = _tiny(seed=4)
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1, "momentum": 0.9})
        step = gluon.FusedTrainStep(_loss_block(net), trainer, mesh=mesh)
        losses = [step(x, y, batch_size=8) for _ in range(3)]
        runs.append((losses, [p.data().detach().clone() for p in
                              net.collect_params().values()]))
        assert step.eager_reason is None
    for a, b in zip(runs[0][0] + runs[0][1], runs[1][0] + runs[1][1]):
        assert torch.equal(a, b)


def test_step_mesh_must_span_the_world():
    net = _tiny()
    trainer = gluon.Trainer(net.collect_params(), "sgd")
    step = gluon.FusedTrainStep(_loss_block(net), trainer,
                                mesh=port_mesh.make_mesh({"dp": 2},
                                                         devices=[0, 1]))
    with pytest.raises(ValueError, match="tools/launch.py"):
        step(torch.ones(4, 5), torch.zeros(4), batch_size=4)


def test_prune_spares_other_ranks_temp_dirs(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path), async_write=False,
                                       rank=0)
    mine = tmp_path / ".tmp-step-0000000002-host-00000-11"
    theirs = tmp_path / ".tmp-step-0000000002-host-00001-12"
    mine.mkdir()
    theirs.mkdir()
    mgr.prune()
    assert not mine.exists() and theirs.exists()
    mgr.close()
