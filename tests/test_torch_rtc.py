"""`mxnet_tpu_torch.rtc` (B6, user CUDA kernels) on the CPU: signature
parsing, argument checks, the ``void **`` array ``cuLaunchKernel``
takes, the launch counter and the errors where there is no CUDA route.

Compiling and launching needs the card: `chip_smoke.py` compiles the
user kernels with NVRTC there and holds them against their plain
versions (phase 9).
"""
import ctypes
import pathlib
import subprocess
import sys
import threading

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import rtc

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("signature, want", [
    ("const float *x, float *y, int n",
     [("float", True, "x"), ("float", True, "y"), ("int", False, "n")]),
    # upstream's examples leave the names out
    ("const float*, float*, const int, const int",
     [("float", True, "arg0"), ("float", True, "arg1"),
      ("int", False, "arg2"), ("int", False, "arg3")]),
    ("float const * __restrict__ a, double* b, __half *h, "
     "__nv_bfloat16 s, int64_t *i, unsigned u, unsigned int w, bool f",
     [("float", True, "a"), ("double", True, "b"), ("__half", True, "h"),
      ("__nv_bfloat16", False, "s"), ("int64_t", True, "i"),
      ("unsigned", False, "u"), ("unsigned int", False, "w"),
      ("bool", False, "f")]),
    ("", []),
])
def test_parse_signature(signature, want):
    got = [(p.ctype, p.pointer, p.name)
           for p in rtc.parse_signature(signature)]
    assert got == want


@pytest.mark.parametrize("signature", ["float **x", "char *s",
                                       "float *x, long n"])
def test_parse_signature_refuses(signature):
    with pytest.raises(mx.MXNetError, match="argument"):
        rtc.parse_signature(signature)


CPU = torch.device("cpu")
PARAMS = rtc.parse_signature("const float *x, int *lab, float a, int n, "
                             "__half h, __nv_bfloat16 b, bool f")


def _args():
    return [torch.zeros(4), torch.zeros(4, dtype=torch.int32), 2.5, 7,
            1.0, -2.0, True]


def test_marshal_converts_each_argument():
    args = _args()
    values = rtc.marshal(PARAMS, args, CPU)
    assert values[0].value == args[0].data_ptr()
    assert values[1].value == args[1].data_ptr()
    assert values[2].value == 2.5 and isinstance(values[2], ctypes.c_float)
    assert values[3].value == 7 and isinstance(values[3], ctypes.c_int32)
    assert values[4].value == 0x3C00          # 1.0 in IEEE half
    assert values[5].value == 0xC000          # -2.0 in bfloat16
    assert values[6].value is True


@pytest.mark.parametrize("index, bad, match", [
    (0, torch.zeros(4, dtype=torch.float64), "argument 0 \\(x\\).*float32"),
    (0, torch.zeros(4, 2).t(), "argument 0 \\(x\\).*contiguous"),
    (0, 3.0, "argument 0 \\(x\\).*tensor"),
    (1, torch.zeros(4), "argument 1 \\(lab\\).*int32"),
    (2, torch.zeros(()), "argument 2 \\(a\\).*Python number"),
    (3, 7.5, "argument 3 \\(n\\).*integer"),
    (6, "yes", "argument 6 \\(f\\).*Python number"),
])
def test_marshal_names_the_bad_argument(index, bad, match):
    args = _args()
    args[index] = bad
    with pytest.raises(mx.MXNetError, match=match):
        rtc.marshal(PARAMS, args, CPU)


def test_marshal_refuses_a_tensor_on_another_device():
    with pytest.raises(mx.MXNetError, match="argument 0 \\(x\\).*on cpu"):
        rtc.marshal(PARAMS, _args(), torch.device("cuda", 0))


def test_marshal_counts_arguments():
    with pytest.raises(mx.MXNetError, match="takes 7 arguments"):
        rtc.marshal(PARAMS, _args()[:3], CPU)


def test_pack_fake_pointers():
    """The kernelParams array holds the address of each value, whose
    contents are the pointer or the scalar."""
    values = [ctypes.c_void_p(0xDEAD0000), ctypes.c_float(2.5),
              ctypes.c_int32(-7), ctypes.c_uint16(0x3C00)]
    arr = rtc.pack(values)
    assert len(arr) == 4
    assert ctypes.cast(arr[0], ctypes.POINTER(ctypes.c_void_p))[0] == \
        0xDEAD0000
    assert ctypes.cast(arr[1], ctypes.POINTER(ctypes.c_float))[0] == 2.5
    assert ctypes.cast(arr[2], ctypes.POINTER(ctypes.c_int32))[0] == -7
    assert ctypes.cast(arr[3], ctypes.POINTER(ctypes.c_uint16))[0] == 0x3C00


def _kernel():
    """A kernel object whose module is never reached: each case below
    must raise before it would compile or launch."""
    return rtc.CudaKernel(None, "axpy", "axpy", rtc.parse_signature(
        "const float *x, float *y, float a, int n"))


def test_launch_refuses_a_cpu_ctx_and_counts_nothing():
    k = _kernel()
    x, y = torch.ones(4), torch.zeros(4)
    with pytest.raises(mx.MXNetError, match="not a CUDA device"):
        k.launch((x, y, 2.0, 4), mx.cpu(), (1,), (32,))
    assert k.launches == 0


def test_launch_on_a_cuda_ctx_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    k = _kernel()
    with pytest.raises(mx.MXNetError, match="CUDA is not available"):
        k.launch((torch.ones(4), torch.zeros(4), 2.0, 4), mx.gpu(0), (1,),
                 (32,))
    assert k.launches == 0


class _FakeLibcuda:
    """Stands in for libcuda: one device whose primary context is 0xC0,
    a context current on each thread (none at first), and a record of
    every call."""

    CTX, MODULE, FN = 0xC0, 0xD0, 0xF00

    def __init__(self):
        self.calls = []
        self.current = threading.local()
        self.fail_next_launch = False

    @staticmethod
    def _out(ref, value):
        ref._obj.value = value

    def cuInit(self, flags):  # noqa: N802
        self.calls.append(("init",))
        return 0

    def cuDeviceGet(self, out, index):  # noqa: N802
        self._out(out, index)
        return 0

    def cuDevicePrimaryCtxRetain(self, out, dev):  # noqa: N802
        self.calls.append(("retain", dev))
        self._out(out, self.CTX)
        return 0

    def cuCtxGetCurrent(self, out):  # noqa: N802
        self.calls.append(("get_current", threading.get_ident()))
        self._out(out, getattr(self.current, "ctx", None))
        return 0

    def cuCtxSetCurrent(self, ctx):  # noqa: N802
        self.calls.append(("set_current", threading.get_ident(), ctx))
        self.current.ctx = ctx
        return 0

    def cuModuleLoadData(self, out, image):  # noqa: N802
        self.calls.append(("load",))
        self._out(out, self.MODULE)
        return 0

    def cuModuleGetFunction(self, out, mod, name):  # noqa: N802
        self.calls.append(("get_function", mod, name))
        self._out(out, self.FN)
        return 0

    def cuFuncSetAttribute(self, fn, attr, value):  # noqa: N802
        self.calls.append(("attr", fn, attr, value))
        return 0

    def cuLaunchKernel(self, fn, *rest):  # noqa: N802
        dims, smem, stream, params, extra = rest[:6], *rest[6:]
        x = ctypes.cast(params[0], ctypes.POINTER(ctypes.c_void_p))[0]
        y = ctypes.cast(params[1], ctypes.POINTER(ctypes.c_void_p))[0]
        a = ctypes.cast(params[2], ctypes.POINTER(ctypes.c_float))[0]
        n = ctypes.cast(params[3], ctypes.POINTER(ctypes.c_int32))[0]
        self.calls.append(("launch", fn, dims, smem, stream, x, y, a, n,
                           extra))
        if self.fail_next_launch:
            self.fail_next_launch = False
            return 400                    # CUDA_ERROR_INVALID_HANDLE
        return 0 if getattr(self.current, "ctx", None) == self.CTX else 201

    def cuGetErrorName(self, result, out):  # noqa: N802
        self._out(out, b"CUDA_ERROR")
        return 0

    def cuGetErrorString(self, result, out):  # noqa: N802
        self._out(out, b"fake")
        return 0


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on cuda:0, for the launch path's
    checks; the fake libcuda reads only its data pointer."""

    is_cuda = True

    def get_device(self):
        return 0


def _on_card(n, dtype=torch.float32):
    return torch.zeros(n, dtype=dtype).as_subclass(_OnCard)


@pytest.fixture
def fake_cuda(monkeypatch):
    """A `CudaModule` built without NVRTC over `_FakeLibcuda`, torch's
    current stream 0x77, cuda:0 resolved by a counted stand-in."""
    fake = _FakeLibcuda()
    monkeypatch.setattr(rtc, "_lib", lambda name: fake)
    monkeypatch.setattr(rtc, "_primary", {})
    monkeypatch.setattr(rtc, "_current", threading.local())
    monkeypatch.setattr(rtc, "_need_cuda", lambda: None)
    monkeypatch.setattr(rtc, "_compile", lambda source, options, exports: (
        b"\x7fELF", {"axpy": "_Z4axpy"}, ""))
    monkeypatch.setattr(torch.cuda, "init", lambda: None)
    resolved = []

    def resolve(ctx):
        resolved.append(ctx)
        return torch.device("cuda", 0)
    monkeypatch.setattr(rtc, "resolve_device", resolve)
    monkeypatch.setattr(rtc, "_raw_stream", lambda device: 0x77)
    mod = rtc.CudaModule("// source", exports=["axpy"])
    kernel = mod.get_kernel("axpy", "const float *x, float *y, float a, "
                                    "int n")
    return fake, kernel, resolved


def _kinds(calls):
    return [c[0] for c in calls]


def test_launch_path_with_a_fake_libcuda(fake_cuda):
    """Dims padded to three, the dynamic shared memory opted into once
    above 48 KB, torch's current stream, the packed arguments, and one
    count per launch."""
    fake, k, _ = fake_cuda
    x, y = _on_card(4), _on_card(4)
    for _ in range(2):
        k.launch((x, y, 1.5, 9), mx.gpu(0), (4,), (256, 2),
                 shared_mem=64 * 1024)
    fn = _FakeLibcuda.FN
    launch = ("launch", fn, (4, 1, 1, 256, 2, 1), 65536, 0x77,
              x.data_ptr(), y.data_ptr(), 1.5, 9, None)
    assert [c for c in fake.calls if c[0] in ("attr", "launch")] == [
        ("attr", fn, 8, 65536), launch, launch]
    assert k.launches == 2


def test_second_launch_reuses_the_kept_handles(fake_cuda):
    """The first launch on a thread makes the context current, loads the
    module and finds the function; the second makes none of those calls
    (nor the shared-memory opt-in, nor a device lookup), and passes the
    new call's pointers and scalars from the same argument block."""
    fake, k, resolved = fake_cuda
    ctx = torch.device("cuda", 0)
    x, y = _on_card(4), _on_card(4)
    k.launch((x, y, 1.5, 9), ctx, (4,), (256,), shared_mem=64 * 1024)
    assert _kinds(fake.calls) == ["init", "retain", "get_current",
                                  "set_current", "load", "get_function",
                                  "attr", "launch"]
    fake.calls.clear()
    x2, y2 = _on_card(8), _on_card(8)
    k.launch((x2, y2, -2.0, 8), ctx, (4,), (256,), shared_mem=64 * 1024)
    assert fake.calls == [("launch", _FakeLibcuda.FN, (4, 1, 1, 256, 1, 1),
                           65536, 0x77, x2.data_ptr(), y2.data_ptr(), -2.0,
                           8, None)]
    assert resolved == [ctx] and k.launches == 2


def test_launch_from_a_second_thread_makes_the_context_current(fake_cuda):
    """Another thread has no context current: its first launch makes the
    primary context current there (without loading the module again),
    and its second launch is the kept path."""
    fake, k, _ = fake_cuda
    x, y = _on_card(4), _on_card(4)
    k.launch((x, y, 1.0, 4), mx.gpu(0), (1,), (32,))
    fake.calls.clear()
    errors = []

    def other():
        try:
            for _ in range(2):
                k.launch((x, y, 1.0, 4), mx.gpu(0), (1,), (32,))
        except Exception as exc:     # noqa: BLE001 - reported below
            errors.append(exc)
    worker = threading.Thread(target=other)
    worker.start()
    worker.join(timeout=30)
    assert not errors and not worker.is_alive()
    assert _kinds(fake.calls) == ["get_current", "set_current", "launch",
                                  "launch"]
    assert {c[1] for c in fake.calls[:2]} == {worker.ident}
    assert k.launches == 3


def test_threads_launch_from_their_own_argument_blocks(fake_cuda):
    """Each thread refills an argument block of its own: under 16
    threads (more than the cores) switching every microsecond, every
    launch passes the pointers and scalar its caller gave it."""
    fake, k, _ = fake_cuda
    n_threads, per_thread = 16, 40
    tensors = [(_on_card(4), _on_card(4)) for _ in range(n_threads)]
    errors = []

    def work(i):
        x, y = tensors[i]
        try:
            for _ in range(per_thread):
                k.launch((x, y, float(i), i), mx.gpu(0), (1,), (32,))
        except Exception as exc:     # noqa: BLE001 - reported below
            errors.append(exc)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(w.is_alive() for w in workers)
    launched = [c for c in fake.calls if c[0] == "launch"]
    assert len(launched) == n_threads * per_thread
    for c in launched:
        i = c[8]                              # n, the caller's index
        assert (c[5], c[6], c[7]) == (tensors[i][0].data_ptr(),
                                      tensors[i][1].data_ptr(), float(i))


def test_a_failed_launch_on_kept_handles_looks_up_again(fake_cuda):
    """A launch refused on the kept handles (another context made current
    by other code) takes the full lookup and is tried once more; a
    failure on a fresh lookup raises with the CUresult."""
    fake, k, _ = fake_cuda
    x, y = _on_card(4), _on_card(4)
    k.launch((x, y, 1.0, 4), mx.gpu(0), (1,), (32,))
    fake.calls.clear()
    fake.current.ctx = 0xBAD                  # other code switched context
    k.launch((x, y, 1.0, 4), mx.gpu(0), (1,), (32,))
    assert _kinds(fake.calls) == ["launch", "get_current", "set_current",
                                  "launch"]
    assert k.launches == 2
    fake.current.ctx = 0xBAD
    rtc._current.device = None                # not kept: no second try
    with pytest.raises(mx.MXNetError, match="cuLaunchKernel\\(axpy\\)"):
        fake.fail_next_launch = True
        k.launch((x, y, 1.0, 4), mx.gpu(0), (1,), (32,))
    assert k.launches == 2


def test_launch_checks_each_argument_as_marshal(fake_cuda):
    """The kept argument block refuses what `marshal` refuses, with its
    messages, and launches nothing."""
    fake, k, _ = fake_cuda
    x, y = _on_card(4), _on_card(4)
    for args, match in [
            ((x, y, 1.0), "takes 4 arguments"),
            ((x, _on_card(4, torch.float64), 1.0, 4),
             "argument 1 \\(y\\).*float32"),
            ((torch.zeros(4), y, 1.0, 4), "argument 0 \\(x\\).*on cpu"),
            ((x, y, torch.zeros(()), 4),
             "argument 2 \\(a\\).*Python number"),
            ((x, y, 1.0, 4.5), "argument 3 \\(n\\).*integer")]:
        with pytest.raises(mx.MXNetError, match=match):
            k.launch(args, mx.gpu(0), (1,), (32,))
    assert "launch" not in _kinds(fake.calls) and k.launches == 0


def _bits_via_torch(value, dtype):
    """How a 16-bit scalar was converted before: through a torch tensor."""
    return torch.tensor(float(value), dtype=dtype).view(
        torch.int16).item() & 0xFFFF


def test_half_scalars_round_as_torch():
    """``__nv_bfloat16`` and ``__half`` scalars are rounded without a
    tensor, bit for bit as torch rounds a Python float into them: to
    float32 first, then to nearest even; ties, subnormals, overflow to
    inf, NaN and values that round twice among them."""
    rng = onp.random.default_rng(3)
    values = [1 + 2 ** -8 + 2 ** -30, -(1 + 2 ** -8 + 2 ** -30),
              1 + 2 ** -11 + 2 ** -40, 1 + 2 ** -8, 1 + 3 * 2 ** -8,
              65504.0, 65519.9, 65520.0, 1e300, -1e300, 3.4028235e38,
              3.5e38, float("inf"), float("-inf"), float("nan"), 0.0, -0.0,
              2.0 ** -24, 3 * 2.0 ** -26, 2.0 ** -25, 2.0 ** -149,
              2.0 ** -150, 1e-46, 7, True]
    values += list(rng.uniform(-1, 1, 3000) * 10.0 ** rng.uniform(
        -45, 39, 3000))
    for ctype, dtype in (("__nv_bfloat16", torch.bfloat16),
                         ("__half", torch.float16)):
        param = rtc.parse_signature(f"{ctype} s")[0]
        for v in values:
            assert rtc._scalar(param, v).value == \
                _bits_via_torch(v, dtype), (ctype, v)


@pytest.mark.parametrize("dims", [(), (0,), (1, 2, 3, 4)])
def test_launch_dims(dims):
    with pytest.raises(mx.MXNetError, match="grid_dims"):
        rtc._dims(dims, "grid_dims")


def test_module_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(mx.MXNetError, match="CUDA is not available"):
        rtc.CudaModule('extern "C" __global__ void k() {}')


def test_import_loads_no_cuda_library():
    """Importing the package (and rtc) opens neither NVRTC nor
    libcuda: they load at the first compile or launch."""
    code = ("import mxnet_tpu_torch, mxnet_tpu_torch.rtc, "
            "mxnet_tpu_torch.operator; "
            "maps = open('/proc/self/maps').read(); "
            "bad = [n for n in ('libnvrtc', 'libcuda.so') if n in maps]; "
            "print(bad); raise SystemExit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


class _FailingLibcuda:
    def cuInit(self, flags):  # noqa: N802
        return 100                        # CUDA_ERROR_NO_DEVICE

    def cuGetErrorName(self, result, out):  # noqa: N802
        out._obj.value = b"CUDA_ERROR_NO_DEVICE"
        return 0

    def cuGetErrorString(self, result, out):  # noqa: N802
        out._obj.value = b"no CUDA-capable device is detected"
        return 0


def test_setup_error_raises_with_its_name(monkeypatch):
    """A failing call while the context is set up (under the module's
    lock) raises with the CUresult's name, from any thread, and does not
    wait on the lock it holds."""
    monkeypatch.setitem(rtc._libs, "cuda", _FailingLibcuda())
    monkeypatch.setattr(rtc, "_primary", {})
    monkeypatch.setattr(torch.cuda, "init", lambda: None)
    errors = []

    def setup():
        try:
            rtc._make_current(0)
        except mx.MXNetError as exc:
            errors.append(str(exc))

    worker = threading.Thread(target=setup, daemon=True)
    worker.start()
    worker.join(timeout=30)
    assert not worker.is_alive()
    assert errors and "cuInit failed" in errors[0] and \
        "CUDA_ERROR_NO_DEVICE" in errors[0]
