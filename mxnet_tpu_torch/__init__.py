"""mxnet_tpu_torch: the PyTorch/CUDA port of mxnet_tpu.

The JAX package `mxnet_tpu` is the reference; this package keeps its
module paths and names and runs on an NVIDIA H100.  Entry points run on
the card (``gpu()``) unless the caller passes ``cpu()``; without CUDA
they raise.  f32 matrix products and convolutions run at true f32 (TF32
off), as the reference computes them.  Importing it loads no CUDA
library: `rtc` loads NVRTC and libcuda at its first use.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from . import autograd, gluon, initializer, models, serve  # noqa: E402
from . import amp, callback, lr_scheduler, operator, optimizer, rtc  # noqa: E402
from . import image, io, recordio  # noqa: E402
from . import ndarray as nd  # noqa: E402
from . import numpy as np  # noqa: E402
from . import numpy_extension as npx  # noqa: E402
from .base import MXNetError  # noqa: E402
from .context import cpu, current_context, gpu, num_gpus  # noqa: E402

init = initializer

__all__ = ["amp", "autograd", "callback", "gluon", "initializer", "init", "lr_scheduler",
           "models", "optimizer", "serve", "np", "npx", "nd", "operator", "rtc",
           "image", "io", "recordio",
           "MXNetError", "cpu", "gpu", "num_gpus", "current_context"]
