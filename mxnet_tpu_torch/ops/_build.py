"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` source is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, which ``ctypes`` loads.
Builds happen at first use, never at import, into ``build/kernels/``
at the root of the checkout, under a name keyed by a hash of the source,
the ``csrc/*.cuh`` headers and the flags, so an edited source is rebuilt
and an unchanged one is reused.  ``nvcc`` is taken from ``PATH``, else
from ``$CUDA_HOME/bin``, else from ``/usr/local/cuda/bin``.  Nothing is
downloaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "KERNELS", "Kernel",
           "find_nvcc", "build", "launch_counts", "load", "stream_of"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded = {}          # source name -> ctypes.CDLL
BUILD_LOG = {}        # source name -> {"seconds": float, "ptxas": str}


class Kernel:
    """A CUDA kernel's launch count (a plain integer, read and reset by
    whoever checks that a path went through the kernel).  Every kernel
    registers in `KERNELS`, so that a captured CUDA graph can record the
    launches it holds and add them at each replay, where no wrapper
    runs."""

    def __init__(self, name):
        self.name = name
        self.launches = 0
        KERNELS.append(self)


KERNELS = []


def launch_counts():
    """``{kernel: launches}`` of every registered kernel."""
    return {k: k.launches for k in KERNELS}


def stream_of(x):
    """The current CUDA stream of ``x``'s device, as ``ctypes`` takes it."""
    import torch
    return torch.cuda.current_stream(x.device).cuda_stream


def find_nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found on PATH, under $CUDA_HOME/bin or "
                       "/usr/local/cuda/bin; the CUDA kernels cannot be "
                       "built")


def build(name):
    """Path of the shared library built from ``csrc/<name>.cu``
    (compiling it if no library for this source, the headers beside it
    and these flags exists yet)."""
    src = CSRC / f"{name}.cu"
    text = src.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,
                       "ptxas": proc.stderr}
    return out


def load(name, declare):
    """The ``ctypes`` library for ``csrc/<name>.cu``, built and loaded
    once per process; ``declare(lib)`` sets its functions' argtypes and
    restype."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            declare(lib)
            _loaded[name] = lib
        return lib
