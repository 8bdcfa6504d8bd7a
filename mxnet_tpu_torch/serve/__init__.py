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

Not ported yet: ``Fleet``, ``ContinuousBatcher`` and the router.
"""
from .bucketing import BucketSpec, pick_bucket, pow2_buckets
from .cache import ExecutableCache
from .endpoint import Endpoint, EndpointClosed, QueueFullError, \
    RequestTimeout
from .metrics import EndpointMetrics

__all__ = [
    "Endpoint", "BucketSpec", "ExecutableCache", "EndpointMetrics",
    "QueueFullError", "RequestTimeout", "EndpointClosed",
    "pick_bucket", "pow2_buckets",
]
