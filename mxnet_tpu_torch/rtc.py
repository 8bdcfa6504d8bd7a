"""User CUDA kernels compiled at run time (counterpart of
`mxnet_tpu/rtc.py`, TPU kernel B6: `PallasKernel.launch`).

The JAX package's ``PallasModule`` / ``PallasKernel`` are the TPU form
of upstream MXNet's ``mx.rtc.CudaModule`` / ``CudaKernel``
(`python/mxnet/rtc.py`, `include/mxnet/rtc.h:39`): "write your own
kernel".  On the H100 the user writes CUDA again, so the port keeps
upstream's API::

    import mxnet_tpu_torch as mx

    mod = mx.rtc.CudaModule(r'''
    extern "C" __global__ void axpy(const float *x, float *y, float a,
                                    int n) {
        int i = blockIdx.x * blockDim.x + threadIdx.x;
        if (i < n) y[i] += a * x[i];
    }''')
    k = mod.get_kernel("axpy", "const float *x, float *y, float a, int n")
    k.launch((x, y, 2.0, x.numel()), mx.gpu(0), (x.numel() // 256 + 1,),
             (256,))                       # y updated in place

Route: NVRTC compiles the source to a CUBIN for ``sm_90a`` when the
module is built; ``libcuda`` loads it into the device's primary
context (the one torch uses) at the first launch on that device, and
``cuLaunchKernel`` runs it on torch's current stream of that device,
so it is ordered with torch's own kernels without a sync.  Both
libraries are reached through ``ctypes`` and loaded at first use,
never at import.  Kernels defined ``extern "C"`` are found by name;
C++ and templated kernels are named in ``exports`` (``"scale<float>"``)
and found through NVRTC's lowered names, as upstream does.

What bounds a user kernel on the card is the user's to say; what this
module adds is the host's work per launch, which `chip_smoke.py`
measures beside torch's own launch.  That work is only what changes
between two launches of one kernel on one device: the argument checks
and the argument values, the stream, the grid.  The resolved device,
the ``CUfunction``, the shared memory opted into and a ``ctypes``
argument block with its ``void **kernelParams`` array (one block for
each thread and device, refilled in place) are kept from the first
launch; the primary context is made current once on each thread and
device (``cuCtxGetCurrent`` then, not at every launch).  A launch that
fails on a kept handle, such as one whose thread had another context
made current by other code, takes the full lookup and is tried again
once.

There is no CPU route for user CUDA source: a CPU tensor, a CPU
``ctx`` or a machine without CUDA raises :class:`MXNetError`.

Library search.  NVRTC: ``$CUDA_HOME/lib64``, ``$CUDA_PATH/lib64`` and
``/usr/local/cuda/lib64``, then the ``lib`` directories of the
``nvidia`` wheels beside torch, then the loader's own path; in the
directory it comes from, NVRTC's builtins library of the same version
is loaded first, since NVRTC opens it by name at compile time.  The
``libcuda``: ``libcuda.so.1``, then ``libcuda.so``.  The toolkit's include
directory (the first of those roots that has ``cuda_fp16.h``) is
passed to every compile, so ``cuda_fp16.h`` and ``cuda_bf16.h``
resolve.
"""
from __future__ import annotations

import ctypes
import glob
import math
import numbers
import os
import struct
import threading

import torch

from .base import MXNetError
from .context import resolve_device

__all__ = ["CudaModule", "CudaKernel", "ARCH"]

ARCH = "sm_90a"
# above this a block's dynamic shared memory must be opted into
_DEFAULT_SMEM_LIMIT = 48 * 1024
_CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES = 8

# C type of a kernel parameter -> (ctypes type of a scalar, torch dtype
# name of the tensor a pointer to it takes)
_TYPES = {
    "float": (ctypes.c_float, "float32"),
    "double": (ctypes.c_double, "float64"),
    "__half": (ctypes.c_uint16, "float16"),
    "__nv_bfloat16": (ctypes.c_uint16, "bfloat16"),
    "int": (ctypes.c_int32, "int32"),
    "int64_t": (ctypes.c_int64, "int64"),
    "unsigned": (ctypes.c_uint32, "uint32"),
    "unsigned int": (ctypes.c_uint32, "uint32"),
    "bool": (ctypes.c_bool, "bool"),
}
_QUALIFIERS = ("const", "__restrict__", "volatile")

# reentrant: an error raised while a library or context is being set up
# looks the library up again to name the error
_lock = threading.RLock()
_libs = {}          # "nvrtc" / "cuda" -> ctypes.CDLL
_primary = {}       # device index -> CUcontext (retained primary context)
# .device: the index of the device whose primary context `_make_current`
# last made current on this thread
_current = threading.local()
_F32, _F16 = struct.Struct("<f"), struct.Struct("<e")
_U32, _U16 = struct.Struct("<I"), struct.Struct("<H")


# ---------------------------------------------------------------------------
# signatures and arguments
# ---------------------------------------------------------------------------
class _Param:
    """One kernel parameter: its position, name, C type, whether it is
    a pointer, and the ctypes scalar type and torch dtype it takes."""

    def __init__(self, index, name, ctype, pointer):
        self.index = index
        self.name = name
        self.ctype = ctype
        self.pointer = pointer
        self.scalar_type = _TYPES[ctype][0]
        self.dtype = getattr(torch, _TYPES[ctype][1])
        self.integral = ctype not in ("float", "double", "__half",
                                      "__nv_bfloat16")
        # Python types a launch writes into the scalar's slot as they are
        # (the rest go through `_scalar`)
        self.direct = () if pointer or self.scalar_type is ctypes.c_uint16 \
            else (int,) if self.integral else (float, int)

    @property
    def where(self):
        return f"argument {self.index} ({self.name})"

    def __repr__(self):
        return (f"{self.ctype}{' *' if self.pointer else ' '}{self.name}")


def parse_signature(signature):
    """The parameters of a C signature such as ``"const float *x, float
    *y, int n"``: ``const`` (and ``__restrict__``) anywhere, the ``*`` on
    either side, names optional (upstream's examples leave them out)."""
    if not signature.strip():
        return []
    params = []
    for i, raw in enumerate(signature.split(",")):
        tokens = [t for t in raw.replace("*", " * ").split()
                  if t not in _QUALIFIERS]
        words = [t for t in tokens if t != "*"]
        n_ptr = len(tokens) - len(words)
        name = f"arg{i}"
        if " ".join(words) not in _TYPES and len(words) > 1:
            name = words.pop()
        ctype = " ".join(words)
        if ctype not in _TYPES or n_ptr > 1:
            raise MXNetError(
                f"argument {i} ({raw.strip()!r}) of signature {signature!r}: "
                f"takes a scalar or a single pointer of "
                f"{sorted(_TYPES)}")
        params.append(_Param(i, name, ctype, n_ptr == 1))
    return params


def _scalar(param, value):
    """``value`` as the ctypes scalar ``param`` takes (half and bfloat16
    as their bits, rounded to nearest even)."""
    kind = type(value)
    if kind is not int and kind is not float and kind is not bool and (
            isinstance(value, torch.Tensor) or
            not isinstance(value, numbers.Real)):
        raise MXNetError(f"{param.where}: expected a Python number for "
                         f"{param.ctype}, got {kind.__name__}")
    if param.integral and not (kind is int or kind is bool or
                               isinstance(value, numbers.Integral)):
        raise MXNetError(f"{param.where}: expected an integer for "
                         f"{param.ctype}, got {value!r}")
    if param.scalar_type is ctypes.c_uint16:
        return ctypes.c_uint16(_half_bits(float(value), param.ctype))
    return param.scalar_type(value)


def _half_bits(value, ctype):
    """The bits of ``value`` as ``__half`` or ``__nv_bfloat16``, rounded
    as torch rounds a Python float into those types: to float32 first,
    then from float32, each to nearest even (inf past float32's range,
    NaN as torch writes it)."""
    try:
        f32 = _F32.pack(value)
    except OverflowError:
        f32 = _F32.pack(math.copysign(math.inf, value))
    if ctype == "__half":
        try:
            return _U16.unpack(_F16.pack(_F32.unpack(f32)[0]))[0]
        except OverflowError:
            return 0xFC00 if value < 0 else 0x7C00
    if value != value:
        return 0x7FC0
    u = _U32.unpack(f32)[0]
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) & 0xFFFF


def _pointer(param, arg, device):
    """``arg`` as the pointer ``param`` takes: a contiguous tensor of its
    dtype on ``device``; raises naming the argument otherwise."""
    want = param.dtype
    if not isinstance(arg, torch.Tensor):
        raise MXNetError(f"{param.where}: expected a {want} tensor, got "
                         f"{type(arg).__name__}")
    if arg.dtype != want:
        raise MXNetError(f"{param.where}: expected a {want} tensor, got "
                         f"{arg.dtype}")
    if arg.device != device:
        raise MXNetError(f"{param.where}: the tensor is on {arg.device}, "
                         f"the kernel launches on {device}")
    if not arg.is_contiguous():
        raise MXNetError(f"{param.where}: the tensor is not contiguous")
    return ctypes.c_void_p(arg.data_ptr())


def _count_args(params, args):
    if len(args) != len(params):
        raise MXNetError(f"the kernel takes {len(params)} arguments "
                         f"{params}, got {len(args)}")


def marshal(params, args, device):
    """Check ``args`` against ``params`` and return their ctypes values:
    a pointer takes a contiguous tensor of its dtype on ``device``, a
    scalar a Python number.  Every mismatch raises with the argument's
    index and name."""
    _count_args(params, args)
    return [_pointer(param, arg, device) if param.pointer
            else _scalar(param, arg) for param, arg in zip(params, args)]


def pack(values):
    """The ``void **kernelParams`` array of ``cuLaunchKernel``: the
    address of each value.  The caller keeps ``values`` alive until the
    launch returns."""
    return (ctypes.c_void_p * len(values))(
        *[ctypes.addressof(v) for v in values])


class _ArgBlock:
    """One ``ctypes`` value for each parameter and the ``void
    **kernelParams`` array of their addresses, built once; `fill` writes
    a launch's arguments into the values in place, with `marshal`'s
    checks and errors."""

    def __init__(self, params):
        self.params = params
        self.values = [ctypes.c_void_p() if p.pointer else p.scalar_type()
                       for p in params]
        self.array = pack(self.values)

    def fill(self, args, device):
        _count_args(self.params, args)
        index = device.index
        for param, value, arg in zip(self.params, self.values, args):
            if param.pointer:
                if isinstance(arg, torch.Tensor) and \
                        arg.dtype is param.dtype and arg.is_cuda and \
                        arg.get_device() == index and arg.is_contiguous():
                    value.value = arg.data_ptr()
                else:
                    value.value = _pointer(param, arg, device).value
            elif type(arg) in param.direct:
                value.value = arg
            else:
                value.value = _scalar(param, arg).value


def _dims(dims, what):
    dims = tuple(map(int, dims))
    if not 1 <= len(dims) <= 3 or min(dims) < 1:
        raise MXNetError(f"{what} must be 1 to 3 positive integers, got "
                         f"{dims}")
    return dims + (1,) * (3 - len(dims))


def _raw_stream(device):
    """torch's current stream of the CUDA ``device`` as an integer,
    without building a ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(device.index)


# ---------------------------------------------------------------------------
# libraries
# ---------------------------------------------------------------------------
def _cuda_roots():
    roots = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
             "/usr/local/cuda"]
    return [r for i, r in enumerate(roots) if r and r not in roots[:i]]


def _wheel_lib_dirs():
    """``lib`` directories of the ``nvidia`` wheels torch depends on."""
    try:
        import nvidia
    except ImportError:
        return []
    return sorted({d for root in nvidia.__path__
                   for d in glob.glob(os.path.join(root, "*", "lib"))})


def _include_dir():
    for root in _cuda_roots():
        inc = os.path.join(root, "include")
        if os.path.isfile(os.path.join(inc, "cuda_fp16.h")):
            return inc
    return None


def _nvrtc_candidates():
    dirs = [os.path.join(r, "lib64") for r in _cuda_roots()] + \
        _wheel_lib_dirs()
    found = []
    for d in dirs:
        names = sorted(glob.glob(os.path.join(d, "libnvrtc.so.*")))
        names = [n for n in names if ".alt." not in n] or \
            glob.glob(os.path.join(d, "libnvrtc.so"))
        found += names[:1]
    return found + ["libnvrtc.so.12", "libnvrtc.so"]


def _declare_nvrtc(lib):
    p, c_int, c_char_p = ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p
    size_p = ctypes.POINTER(ctypes.c_size_t)
    for name, args in {
            "nvrtcVersion": [ctypes.POINTER(c_int), ctypes.POINTER(c_int)],
            "nvrtcCreateProgram": [ctypes.POINTER(p), c_char_p, c_char_p,
                                   c_int, ctypes.POINTER(c_char_p),
                                   ctypes.POINTER(c_char_p)],
            "nvrtcAddNameExpression": [p, c_char_p],
            "nvrtcCompileProgram": [p, c_int, ctypes.POINTER(c_char_p)],
            "nvrtcGetProgramLogSize": [p, size_p],
            "nvrtcGetProgramLog": [p, c_char_p],
            "nvrtcGetCUBINSize": [p, size_p],
            "nvrtcGetCUBIN": [p, c_char_p],
            "nvrtcGetLoweredName": [p, c_char_p, ctypes.POINTER(c_char_p)],
            "nvrtcDestroyProgram": [ctypes.POINTER(p)]}.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, c_int
    lib.nvrtcGetErrorString.argtypes = [c_int]
    lib.nvrtcGetErrorString.restype = c_char_p


def _load_nvrtc():
    tried = []
    for path in _nvrtc_candidates():
        try:
            lib = ctypes.CDLL(path)
        except OSError as exc:
            tried.append(f"{path}: {exc}")
            continue
        _declare_nvrtc(lib)
        major, minor = ctypes.c_int(), ctypes.c_int()
        if lib.nvrtcVersion(ctypes.byref(major), ctypes.byref(minor)):
            tried.append(f"{path}: nvrtcVersion failed")
            continue
        here = os.path.dirname(path)
        if here:
            builtins = os.path.join(
                here, f"libnvrtc-builtins.so.{major.value}.{minor.value}")
            if os.path.isfile(builtins):
                ctypes.CDLL(builtins, mode=ctypes.RTLD_GLOBAL)
        return lib
    raise MXNetError("NVRTC not found; tried:\n  " + "\n  ".join(tried))


def _declare_cuda(lib):
    p, c_int, c_uint = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    for name, args in {
            "cuInit": [c_uint],
            "cuDeviceGet": [ctypes.POINTER(c_int), c_int],
            "cuDevicePrimaryCtxRetain": [ctypes.POINTER(p), c_int],
            "cuCtxGetCurrent": [ctypes.POINTER(p)],
            "cuCtxSetCurrent": [p],
            "cuModuleLoadData": [ctypes.POINTER(p), p],
            "cuModuleGetFunction": [ctypes.POINTER(p), p, ctypes.c_char_p],
            "cuFuncSetAttribute": [p, c_int, c_int],
            "cuLaunchKernel": [p] + [c_uint] * 7 + [
                p, ctypes.POINTER(p), ctypes.POINTER(p)],
            "cuGetErrorName": [c_int, ctypes.POINTER(ctypes.c_char_p)],
            "cuGetErrorString": [c_int, ctypes.POINTER(ctypes.c_char_p)],
    }.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, c_int


def _load_cuda():
    tried = []
    for path in ("libcuda.so.1", "libcuda.so"):
        try:
            lib = ctypes.CDLL(path)
        except OSError as exc:
            tried.append(f"{path}: {exc}")
            continue
        _declare_cuda(lib)
        return lib
    raise MXNetError("libcuda was not found; tried:\n  " +
                     "\n  ".join(tried))


def _lib(name):
    with _lock:
        if name not in _libs:
            _libs[name] = _load_nvrtc() if name == "nvrtc" else _load_cuda()
        return _libs[name]


def _check_cuda(result, what):
    if result == 0:
        return
    lib = _lib("cuda")
    name, desc = ctypes.c_char_p(), ctypes.c_char_p()
    lib.cuGetErrorName(result, ctypes.byref(name))
    lib.cuGetErrorString(result, ctypes.byref(desc))
    raise MXNetError(f"{what} failed: CUresult {result} "
                     f"({(name.value or b'?').decode()}: "
                     f"{(desc.value or b'?').decode()})")


def _check_nvrtc(result, what, log=""):
    if result != 0:
        msg = _lib("nvrtc").nvrtcGetErrorString(result).decode()
        raise MXNetError(f"{what} failed: {msg}" + (f"\n{log}" if log
                                                   else ""))


def _need_cuda():
    if not torch.cuda.is_available():
        raise MXNetError("user CUDA kernels need a CUDA device, and CUDA is "
                         "not available; there is no CPU route for CUDA "
                         "source")


def _make_current(index):
    """Make device ``index``'s primary context (torch's) current on the
    calling thread, retaining it once per process."""
    lib = _lib("cuda")
    with _lock:
        ctx = _primary.get(index)
        if ctx is None:
            torch.cuda.init()
            _check_cuda(lib.cuInit(0), "cuInit")
            dev, handle = ctypes.c_int(), ctypes.c_void_p()
            _check_cuda(lib.cuDeviceGet(ctypes.byref(dev), index),
                        "cuDeviceGet")
            _check_cuda(lib.cuDevicePrimaryCtxRetain(ctypes.byref(handle),
                                                     dev),
                        "cuDevicePrimaryCtxRetain")
            ctx = _primary[index] = handle.value
    cur = ctypes.c_void_p()
    _check_cuda(lib.cuCtxGetCurrent(ctypes.byref(cur)), "cuCtxGetCurrent")
    if cur.value != ctx:
        _check_cuda(lib.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")
    _current.device = index


# ---------------------------------------------------------------------------
# modules and kernels
# ---------------------------------------------------------------------------
def _compile(source, options=(), exports=(), name="module.cu"):
    """NVRTC: ``source`` -> (CUBIN bytes for ``ARCH``, {export: lowered
    name}, compile log).  Raises :class:`MXNetError` with the log on a
    failed compile."""
    lib = _lib("nvrtc")
    prog = ctypes.c_void_p()
    _check_nvrtc(lib.nvrtcCreateProgram(ctypes.byref(prog), source.encode(),
                                        name.encode(), 0, None, None),
                 "nvrtcCreateProgram")
    try:
        for expr in exports:
            _check_nvrtc(lib.nvrtcAddNameExpression(prog, expr.encode()),
                         f"nvrtcAddNameExpression({expr!r})")
        inc = _include_dir()
        opts = [f"--gpu-architecture={ARCH}"] + \
            ([f"-I{inc}"] if inc else []) + list(options)
        c_opts = (ctypes.c_char_p * len(opts))(*[o.encode() for o in opts])
        result = lib.nvrtcCompileProgram(prog, len(opts), c_opts)
        size = ctypes.c_size_t()
        _check_nvrtc(lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size)),
                     "nvrtcGetProgramLogSize")
        buf = ctypes.create_string_buffer(size.value)
        _check_nvrtc(lib.nvrtcGetProgramLog(prog, buf), "nvrtcGetProgramLog")
        log = buf.value.decode(errors="replace")
        _check_nvrtc(result, f"compiling {name} with {opts}", log)
        lowered = {}
        for expr in exports:
            out = ctypes.c_char_p()
            _check_nvrtc(lib.nvrtcGetLoweredName(prog, expr.encode(),
                                                 ctypes.byref(out)),
                         f"nvrtcGetLoweredName({expr!r})")
            lowered[expr] = out.value.decode()
        _check_nvrtc(lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
        cubin = ctypes.create_string_buffer(size.value)
        _check_nvrtc(lib.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
        return cubin.raw, lowered, log
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


class CudaModule:
    """CUDA source compiled by NVRTC for ``sm_90a`` (upstream
    `mx.rtc.CudaModule`; the JAX package's `PallasModule`).

    ``options`` go to NVRTC after the architecture and the toolkit's
    include directory; ``exports`` name the C++ (mangled) kernels, such
    as template instances, that `get_kernel` will be asked for.
    Compiles at construction; the module is loaded into a device's
    context at its first launch there and stays loaded for the life of
    the process."""

    def __init__(self, source, options=(), exports=()):
        _need_cuda()
        if isinstance(options, str):
            options = (options,)
        if isinstance(exports, str):
            exports = (exports,)
        self.exports = list(exports)
        self._cubin, self._lowered, self.log = _compile(
            source, tuple(options), tuple(exports))
        self._image = ctypes.create_string_buffer(self._cubin,
                                                  len(self._cubin))
        self._lock = threading.Lock()
        self._modules = {}            # device index -> CUmodule
        self._functions = {}          # (device index, name) -> CUfunction

    def get_kernel(self, name, signature):
        """The kernel ``name`` (an ``extern "C"`` name, or one of
        ``exports``) with the C parameter list ``signature``."""
        return CudaKernel(self, name, self._lowered.get(name, name),
                          parse_signature(signature))

    def _function(self, index, lowered):
        """The CUfunction of ``lowered`` in device ``index``'s context
        (loading the module there first), with that context current."""
        _make_current(index)
        with self._lock:
            fn = self._functions.get((index, lowered))
            if fn is not None:
                return fn
            lib = _lib("cuda")
            mod = self._modules.get(index)
            if mod is None:
                handle = ctypes.c_void_p()
                _check_cuda(lib.cuModuleLoadData(
                    ctypes.byref(handle),
                    ctypes.cast(self._image, ctypes.c_void_p)),
                    f"cuModuleLoadData (device {index})")
                mod = self._modules[index] = handle.value
            handle = ctypes.c_void_p()
            _check_cuda(lib.cuModuleGetFunction(ctypes.byref(handle), mod,
                                                lowered.encode()),
                        f"cuModuleGetFunction({lowered!r})")
            self._functions[(index, lowered)] = handle.value
            return handle.value


class CudaKernel:
    """A kernel of a `CudaModule` (upstream `mx.rtc.CudaKernel`; the JAX
    package's `PallasKernel`).  ``launches`` counts its launches."""

    def __init__(self, module, name, lowered, params):
        self._module = module
        self.name = name
        self._lowered = lowered
        self.params = params
        self._smem_opt_in = {}        # device index -> bytes opted into
        self._devices = {}            # torch.device ctx -> resolved device
        self._fns = {}                # device index -> CUfunction
        self._blocks = threading.local()   # .by_device: index -> _ArgBlock
        self.launches = 0

    def _device(self, ctx):
        device = self._devices.get(ctx) if type(ctx) is torch.device \
            else None
        if device is None:
            device = resolve_device(ctx)
            if device.type != "cuda":
                raise MXNetError(f"kernel {self.name}: ctx {device} is not a "
                                 "CUDA device; there is no CPU route for "
                                 "CUDA source")
            if type(ctx) is torch.device and ctx.index is not None:
                self._devices[ctx] = device
        return device

    def _args(self, index):
        by_device = getattr(self._blocks, "by_device", None)
        if by_device is None:
            by_device = self._blocks.by_device = {}
        block = by_device.get(index)
        if block is None:
            block = by_device[index] = _ArgBlock(self.params)
        return block

    def _lookup(self, index):
        """The full lookup: the device's primary context made current on
        this thread, the module loaded there, the CUfunction found."""
        fn = self._fns[index] = self._module._function(index, self._lowered)
        return fn

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        """Run the kernel over ``args`` (tensors in place, and numbers) on
        ``ctx``'s current stream, with ``grid_dims`` blocks of
        ``block_dims`` threads and ``shared_mem`` bytes of dynamic shared
        memory.  Returns without a sync."""
        device = self._device(ctx)
        index = device.index
        grid = _dims(grid_dims, "grid_dims")
        block = _dims(block_dims, "block_dims")
        argblock = self._args(index)
        argblock.fill(args, device)
        fn = self._fns.get(index)
        kept = fn is not None and getattr(_current, "device", None) == index
        if not kept:
            fn = self._lookup(index)
        lib = _lib("cuda")
        if shared_mem > _DEFAULT_SMEM_LIMIT and \
                shared_mem > self._smem_opt_in.get(index, 0):
            _check_cuda(lib.cuFuncSetAttribute(
                fn, _CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES,
                int(shared_mem)),
                f"cuFuncSetAttribute({self.name}, {shared_mem} bytes)")
            self._smem_opt_in[index] = int(shared_mem)
        stream = _raw_stream(device)
        result = lib.cuLaunchKernel(fn, *grid, *block, int(shared_mem),
                                    stream, argblock.array, None)
        if result != 0 and kept:
            # a kept handle may have gone stale (another context made
            # current on this thread by other code): look up again, once
            fn = self._lookup(index)
            result = lib.cuLaunchKernel(fn, *grid, *block, int(shared_mem),
                                        stream, argblock.array, None)
        _check_cuda(result, f"cuLaunchKernel({self.name})")
        self.launches += 1
