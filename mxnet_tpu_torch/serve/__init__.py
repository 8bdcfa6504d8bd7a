"""mxnet_tpu_torch.serve — batched inference serving on the card
(counterpart of `mxnet_tpu/serve/`).

Quickstart::

    import torch
    import mxnet_tpu_torch as mx

    net = mx.models.bert_base(use_flash=True)
    net.initialize(ctx=mx.gpu(0), generator=torch.Generator().manual_seed(0))
    net.cast("bfloat16")

    ep = mx.serve.Endpoint(net, max_batch_size=8,
                           seq_buckets=(128, 256, 512))
    ep.warmup(tokens, segments, valid_mask)        # run the grid once
    seq, pooled = ep.submit(tokens, segments, valid_mask).result()
    print(ep.stats())                              # qps, p99, occupancy...
    ep.shutdown(drain=True)

    # N replicas behind an SLA router (two on one card share it)
    with mx.serve.Fleet(net, replicas=2, max_batch_size=8,
                        seq_buckets=(128, 256, 512)) as fleet:
        fleet.warmup(tokens, segments, valid_mask)
        out = fleet.submit(tokens, segments, valid_mask,
                           cls="interactive").result()
        print(fleet.sla_report())                  # p50/p99 per class

    # autoregressive decode: sequences join a running slot batch
    cb = mx.serve.ContinuousBatcher(prefill_fn, decode_fn, slots=8)
    tokens_out = cb.generate(prompt, max_new_tokens=32)

:class:`Fleet` pools N endpoints behind an SLA-aware router
(priority/deadline service classes, deadline sheds with a distinct
error, health-tracked replicas with ejection and re-admission, failover
after a replica dies, hot model-version swap), and
:class:`ContinuousBatcher` runs the prefill/decode-split loop for
autoregressive workloads, its decode step one CUDA graph on the card.
"""
from .bucketing import BucketSpec, pick_bucket, pow2_buckets
from .cache import ExecutableCache
from .continuous import ContinuousBatcher
from .endpoint import Endpoint, EndpointClosed, QueueFullError, \
    RequestTimeout
from .fleet import Fleet, FleetMetrics, Replica
from .metrics import EndpointMetrics
from .router import (DeadlineExceeded, FleetClosed, NoHealthyReplica,
                     PriorityRouter, ReplicaUnavailable, SLAClass,
                     UnknownServiceClass, default_classes)

__all__ = [
    "Endpoint", "BucketSpec", "ExecutableCache", "EndpointMetrics",
    "QueueFullError", "RequestTimeout", "EndpointClosed",
    "pick_bucket", "pow2_buckets",
    "Fleet", "FleetMetrics", "Replica", "ContinuousBatcher",
    "PriorityRouter", "SLAClass", "default_classes",
    "UnknownServiceClass", "DeadlineExceeded", "NoHealthyReplica",
    "ReplicaUnavailable", "FleetClosed",
]
