"""Training-loop callbacks (counterpart of `mxnet_tpu/callback.py`):
`Speedometer` (throughput logging), `ProgressBar` and
`log_train_metric`, copied from the reference.  Each is called with a
record of ``epoch``, ``nbatch`` and ``eval_metric``.  `do_checkpoint`
needs the module-era `model` package, which is not ported: it raises.
"""
from __future__ import annotations

import logging
import time

__all__ = ["Speedometer", "ProgressBar", "do_checkpoint",
           "module_checkpoint", "log_train_metric"]


class Speedometer:
    """Log throughput + metrics every `frequent` batches (reference
    `callback.py` Speedometer)."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self.init = False
        self.tic = 0
        self.last_count = 0

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if self.init:
            if count % self.frequent == 0:
                try:
                    speed = self.frequent * self.batch_size / \
                        (time.time() - self.tic)
                except ZeroDivisionError:
                    speed = float("inf")
                if param.eval_metric is not None:
                    name_value = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset()
                    msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec" \
                        % (param.epoch, count, speed)
                    msg += "".join("\t%s=%f" % kv for kv in name_value)
                    logging.info(msg)
                else:
                    logging.info(
                        "Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                        param.epoch, count, speed)
                self.tic = time.time()
        else:
            self.init = True
            self.tic = time.time()


class ProgressBar:
    """Draw a text progress bar (reference `callback.py` ProgressBar)."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = int(round(100.0 * count / float(self.total)))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s\r", prog_bar, percents, "%")


def do_checkpoint(prefix, period=1):
    """Epoch-end checkpoint callback of the module API: it saves through
    the `model` package, which the port does not have yet."""
    raise NotImplementedError(
        "do_checkpoint saves through the module-era `model` package, which "
        "is not ported (ROADMAP queue A item A10, surface breadth); use "
        "Block.save_parameters and Trainer.save_states")


module_checkpoint = do_checkpoint


def log_train_metric(period, auto_reset=False):
    """Log metrics every `period` batches (reference log_train_metric)."""

    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            for name, value in name_value:
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()
    return _callback
