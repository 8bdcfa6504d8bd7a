"""A port worker of a world of ranks, started by `tools/launch.py`:

    python tools/launch.py -n 2 --launcher local -- \\
        python tests/torch_dist_scripts/ranks_worker.py MODE OUTDIR

Importing ``mxnet_tpu_torch`` starts the rank's process group from the
launcher's variables (gloo on the CPU: ``MXNET_DIST_CONTEXT=cpu``).
Each mode writes ``OUTDIR/<mode>-<rank>.json`` (``bn``: also an
``.npz``) for ``tests/test_torch_ranks.py`` to read, and asserts what a
rank can check alone:

- ``train``: the reference's `tests/dist_scripts/train_worker.py`
  case (Dense(4), mean-square loss, 3 SGD steps over a dp mesh) against
  its numpy oracle; the stores a ``Trainer`` makes in a world of 2; a
  training-state checkpoint saved and restored by both ranks;
- ``bn``: `bn_net` trained by `FusedTrainStep` over the dp mesh from
  ``OUTDIR/bn_in.npz`` (weights and the global batch), its outputs and
  parameters after every step saved;
- ``live``: `TPUICIStore` across the ranks: rank, heartbeat stamps,
  step-time stamps; rank 1 exits hard and rank 0 times its detection.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as onp  # noqa: E402
import torch  # noqa: E402

import mxnet_tpu_torch as mxt  # noqa: E402  (starts the process group)

BN_STEPS = 3
BN_OPT = {"learning_rate": 0.1, "momentum": 0.9}


def bn_net(nn):
    """Conv-BatchNorm-ReLU-Dense on (N, 3, 6, 6), built by either
    package's ``gluon.nn``."""
    net = nn.HybridSequential()
    net.add(nn.Conv2D(4, 3, padding=1, in_channels=3),
            nn.BatchNorm(in_channels=4), nn.Activation("relu"),
            nn.Dense(3, in_units=4 * 6 * 6))
    return net


def with_loss(gluon, block, loss):
    """``block`` then ``loss`` (one value a row), for a fused step, in
    the package of ``gluon``."""
    class NetWithLoss(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.net = block
            self.loss_fn = loss

        def forward(self, x, y):
            return self.loss_fn(self.net(x), y)

    return NetWithLoss()


def _dump(outdir, name, rank, obj):
    with open(os.path.join(outdir, f"{name}-{rank}.json"), "w") as f:
        json.dump(obj, f)


def run_train(rank, outdir):
    from mxnet_tpu_torch import cpu, gluon, kv, parallel
    from mxnet_tpu_torch.resilience import checkpoint

    dist = torch.distributed
    mesh = parallel.make_mesh({"dp": -1})
    assert mesh.shape == {"dp": 2} and mxt._distributed.backend() == "gloo"

    class WithLoss(gluon.HybridBlock):
        def __init__(self, n):
            super().__init__()
            self.n = n

        def forward(self, x, y):
            d = self.n(x) - y
            return (d * d).mean()

    # each rank draws other weights: the step's broadcast from rank 0
    # makes them one
    net = gluon.nn.Dense(4, use_bias=True, in_units=5)
    net.initialize(ctx=cpu(), generator=torch.Generator().manual_seed(
        7 + rank))
    mod = WithLoss(net)
    rs = onp.random.RandomState(13)
    xs = [rs.rand(16, 5).astype("f") for _ in range(3)]
    ys = [rs.rand(16, 4).astype("f") for _ in range(3)]
    params = net.collect_params()
    parallel.shard_parameters(params, mesh)
    w0 = net.weight.data().detach().numpy().copy()
    b0 = net.bias.data().detach().numpy().copy()
    trainer = gluon.Trainer(params, "sgd", {"learning_rate": 0.1})
    step = gluon.FusedTrainStep(mod, trainer, mesh=mesh,
                                data_spec=parallel.PartitionSpec("dp"))
    for x, y in zip(xs, ys):
        loss = step(torch.from_numpy(x), torch.from_numpy(y), batch_size=1)
    final_loss = float(loss)

    # the reference worker's numpy oracle of the same math
    w, b = w0.copy(), b0.copy()
    for x, y in zip(xs, ys):
        d = x @ w.T + b - y
        gpred = 2 * d / d.size
        w -= 0.1 * (gpred.T @ x)
        b -= 0.1 * gpred.sum(0)
        exp_loss = (d * d).mean()
    onp.testing.assert_allclose(net.weight.data().detach().numpy(), w,
                                rtol=1e-4, atol=1e-5)
    onp.testing.assert_allclose(net.bias.data().detach().numpy(), b,
                                rtol=1e-4, atol=1e-5)
    onp.testing.assert_allclose(final_loss, exp_loss, rtol=1e-4)

    # the stores a Trainer makes in a world of two
    device_store = gluon.Trainer(params, "sgd", kvstore="device").kvstore
    ici = gluon.Trainer(params, "sgd", kvstore="tpu_ici").kvstore
    stores = {"device": type(device_store).__name__,
              "tpu_ici": [type(ici).__name__, ici.rank, ici.num_workers],
              "none": gluon.Trainer(params, "sgd", kvstore=None).kvstore}
    ici.close()
    assert kv.create("local").num_workers == 1

    # a training-state checkpoint of the world of two, each rank its shard
    root = os.path.join(outdir, "ckpt")
    arrays, meta = checkpoint.gather_training_state(trainer, 3)
    mgr = checkpoint.CheckpointManager(root, async_write=False)
    mgr.save(3, arrays, meta)
    mgr.close()
    dist.barrier()
    saved = net.weight.data().detach().clone()
    with torch.no_grad():
        net.weight.data().add_(1.0)
    got_step, arrays, meta = checkpoint.CheckpointManager(
        root, async_write=False).restore_latest()
    restored_step = checkpoint.restore_training_state(arrays, meta, trainer)
    assert got_step == restored_step == 3, (got_step, restored_step)
    assert torch.equal(net.weight.data().detach(), saved)
    _dump(outdir, "train", rank, {
        "loss": final_loss, "oracle_loss": float(exp_loss),
        "weight": net.weight.data().detach().numpy().tolist(),
        "stores": stores, "ckpt_world": meta["world"],
        "backend": mxt._distributed.backend()})


def run_bn(rank, outdir):
    from mxnet_tpu_torch import cpu, gluon, parallel
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    data = dict(onp.load(os.path.join(outdir, "bn_in.npz")))
    net = bn_net(gluon.nn)
    net.initialize(ctx=cpu(), generator=torch.Generator().manual_seed(rank))
    params = net._collect_params_with_prefix()
    with torch.no_grad():
        for name, p in params.items():
            if rank == 0:    # rank 1 keeps its own draws: broadcast
                p.data().copy_(torch.from_numpy(data["param/" + name]))
    mod = with_loss(gluon, net, SoftmaxCrossEntropyLoss())
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(BN_OPT))
    step = gluon.FusedTrainStep(mod, trainer,
                                mesh=parallel.make_mesh({"dp": -1}))
    x, y = torch.from_numpy(data["x"]), torch.from_numpy(data["y"])
    out = {}
    for k in range(BN_STEPS):
        loss = step(x, y, batch_size=x.shape[0])
        out[f"loss/{k}"] = loss.detach().numpy()
        for name, p in params.items():
            out[f"{k}/{name}"] = p.data().detach().numpy().copy()
    onp.savez(os.path.join(outdir, f"bn-{rank}.npz"), **out)
    _dump(outdir, "bn", rank, {"eager_reason": step.eager_reason,
                               "captures": step.captures})


def run_live(rank, outdir):
    from mxnet_tpu_torch import kv

    dist = torch.distributed
    store = kv.create("tpu_ici")
    assert (store.rank, store.num_workers) == (rank, 2)
    client = mxt._distributed.store()
    deadline = time.time() + 20
    while not client.check(["mxtpu/heartbeat/0", "mxtpu/heartbeat/1"]):
        assert time.time() < deadline, "no heartbeat stamps"
        time.sleep(0.05)
    store.record_steptime(0.25 + rank)
    dist.barrier()
    steptimes = store.read_steptimes()
    assert steptimes == {0: 0.25, 1: 1.25}, steptimes
    live = [store.get_dead_nodes(timeout=2) for _ in range(3)]
    assert live == [[], [], []], live
    dist.barrier()
    if rank == 1:
        os._exit(0)       # no goodbye: the heartbeat just stops
    t0 = time.time()
    polls = []
    while time.time() - t0 < 20:
        dead = store.get_dead_nodes(timeout=1.0)
        polls.append([round(time.time() - t0, 3), dead,
                      store._stale_counts.get(1, 0)])
        if dead:
            break
        time.sleep(0.1)
    store.close()
    _dump(outdir, "live", rank, {
        "dead": dead, "seconds": time.time() - t0, "polls": polls,
        "steptimes": {str(k): v for k, v in steptimes.items()},
        "thread_joined": store._hb_thread is None})


if __name__ == "__main__":
    torch.set_num_threads(1)
    mode, outdir = sys.argv[1], sys.argv[2]
    rank = torch.distributed.get_rank()
    {"train": run_train, "bn": run_bn, "live": run_live}[mode](rank, outdir)
    torch.distributed.destroy_process_group()
