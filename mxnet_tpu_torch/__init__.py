"""mxnet_tpu_torch: the PyTorch/CUDA port of mxnet_tpu.

The JAX package `mxnet_tpu` is the reference; this package keeps its
module paths and names and runs on an NVIDIA H100.  Entry points run on
the card (``gpu()``) unless the caller passes ``cpu()``; without CUDA
they raise.  f32 matrix products and convolutions run at true f32 (TF32
off), as the reference computes them.  Importing it loads no CUDA
library: `rtc` loads NVRTC and libcuda at its first use.

With ``MXNET_LOCKSCAN_WITNESS=1`` the lock witness (`lockwitness`) is
installed before anything else of the package is imported, and the
environment's import-time settings (`env.apply`: ``MXNET_SEED``,
``MXNET_ENFORCE_DETERMINISM``, ``MXNET_PROFILER_AUTOSTART``, ...) are
read last.
"""
import os as _os

if _os.environ.get("MXNET_LOCKSCAN_WITNESS", "0") not in ("0", ""):
    from . import lockwitness as _lockwitness
    _lockwitness.install()

import torch  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from . import autograd, gluon, initializer, models, serve  # noqa: E402
from . import amp, callback, lr_scheduler, operator, optimizer, rtc  # noqa: E402
from . import image, io, recordio  # noqa: E402
from . import env, monitor, observe, profiler, random  # noqa: E402
from . import resilience, telemetry  # noqa: E402
from . import kvstore  # noqa: E402
from . import kvstore as kv  # noqa: E402
from . import ndarray as nd  # noqa: E402
from . import numpy as np  # noqa: E402
from . import numpy_extension as npx  # noqa: E402
from .base import MXNetError  # noqa: E402
from .context import cpu, current_context, gpu, num_gpus  # noqa: E402

init = initializer

env.apply()

__all__ = ["amp", "autograd", "callback", "gluon", "initializer", "init", "lr_scheduler",
           "models", "optimizer", "serve", "np", "npx", "nd", "operator", "rtc",
           "image", "io", "recordio", "env", "monitor", "observe",
           "profiler", "random", "resilience", "telemetry", "kvstore", "kv",
           "MXNetError", "cpu", "gpu", "num_gpus", "current_context"]
