"""Training monitor for debugging intermediate values (counterpart of
`mxnet_tpu/monitor.py`).

Reference: `python/mxnet/monitor.py` — `Monitor` installs output hooks and
prints per-tensor statistics every N batches.  Here it hooks Gluon blocks
(torch's ``register_forward_hook``, over ``Block.children``); the default
statistic is the same |x|/size norm the reference uses, in numpy, over
the output read back to the host in f32.
"""
from __future__ import annotations

import logging
import re

import numpy as onp
import torch

__all__ = ["Monitor"]


class Monitor:
    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        if stat_func is None:
            def stat_func(x):  # reference default: mean |x|
                return onp.abs(x).sum() / x.size
        self.stat_func = stat_func
        self.interval = interval
        self.sort = sort
        self.pattern = re.compile(pattern)
        self.queue = []
        self.step = 0
        self.activated = False
        self._handles = []

    def install(self, block, root_name=""):
        """Hook every sub-block's outputs (reference `install_monitor` on
        executors).

        A forward that is being captured into a CUDA graph (the second
        call of a `FusedTrainStep`) cannot read values back, so its
        outputs are skipped, as the reference skips a jit trace's
        abstract values; each statistic otherwise reads its tensor back
        to the host, one sync a hooked output."""

        def hook(_blk, _inputs, output, _name):
            if not self.activated:
                return
            outs = output if isinstance(output, (list, tuple)) else [output]
            for i, o in enumerate(outs):
                key = f"{_name}_output{i}" if len(outs) > 1 \
                    else f"{_name}_output"
                if not self.pattern.match(key) or \
                        not isinstance(o, torch.Tensor):
                    continue
                if o.is_cuda and torch.cuda.is_current_stream_capturing():
                    continue
                host = o.detach()
                if host.is_floating_point():
                    host = host.float()
                self.queue.append(
                    (self.step, key, self.stat_func(host.cpu().numpy())))

        def walk(b, name):
            self._handles.append(b.register_forward_hook(
                lambda blk, ins, out, _n=name: hook(blk, ins, out, _n)))
            for cname, child in b.children.items():
                walk(child, f"{name}.{cname}" if name else cname)
        walk(block, root_name or type(block).__name__)
        return self

    def install_endpoint(self, endpoint, name=None):
        """Watch a serving endpoint (`mxnet_tpu_torch.serve.Endpoint`):
        every dispatched batch records occupancy (real rows / bucket
        slots) and device latency into the same tic/toc queue as tensor
        stats, so a training-style monitor loop can watch serving
        health."""
        _name = name or endpoint.name

        def hook(_ep, real_rows, bucket_rows, latency_s):
            if not self.activated:
                return
            occ_key = f"{_name}_batch_occupancy"
            lat_key = f"{_name}_batch_latency_ms"
            if self.pattern.match(occ_key):
                self.queue.append((self.step, occ_key,
                                   real_rows / max(bucket_rows, 1)))
            if self.pattern.match(lat_key):
                self.queue.append((self.step, lat_key, latency_s * 1e3))

        self._handles.append(endpoint.register_batch_hook(hook))
        return self

    def tic(self):
        """Start collecting for this batch if the interval hits."""
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """Stop collecting; returns [(step, name, stat)] (reference toc)."""
        if not self.activated:
            return []
        self.activated = False
        res = list(self.queue)
        self.queue = []
        if self.sort:
            res.sort(key=lambda x: x[1])
        return res

    def toc_print(self):
        """Log collected stats at fixed precision (6 decimal places), so
        runs diff cleanly; non-numeric stats fall back to ``str``."""
        for step, name, stat in self.toc():
            try:
                rendered = f"{float(stat):.6f}"
            except (TypeError, ValueError):
                rendered = str(stat)
            logging.info("Batch: %7d %30s %s", step, name, rendered)

    def uninstall(self):
        for h in self._handles:
            if hasattr(h, "detach"):      # an endpoint's batch hook
                h.detach()
            else:                         # a block's torch hook handle
                h.remove()
        self._handles = []
