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
    """Stands in for libcuda: records each call."""

    def __init__(self):
        self.calls = []

    def cuFuncSetAttribute(self, fn, attr, value):  # noqa: N802
        self.calls.append(("attr", fn, attr, value))
        return 0

    def cuLaunchKernel(self, fn, *rest):  # noqa: N802
        dims, smem, stream, params, extra = rest[:6], *rest[6:]
        x = ctypes.cast(params[0], ctypes.POINTER(ctypes.c_void_p))[0]
        a = ctypes.cast(params[2], ctypes.POINTER(ctypes.c_float))[0]
        self.calls.append(("launch", fn, dims, smem, stream, x, a, extra))
        return 0


class _FakeModule:
    def _function(self, index, lowered):
        assert (index, lowered) == (0, "_Z4axpy")
        return 0xF00


def test_launch_path_with_a_fake_libcuda(monkeypatch):
    """Dims padded to three, the dynamic shared memory opted into once
    above 48 KB, torch's current stream, the packed arguments, and one
    count per launch."""
    fake = _FakeLibcuda()
    monkeypatch.setattr(rtc, "_lib", lambda name: fake)
    monkeypatch.setattr(rtc, "resolve_device",
                        lambda ctx: torch.device("cuda", 0))
    monkeypatch.setattr(rtc, "marshal", lambda params, args, device: [
        ctypes.c_void_p(0xBEE0), ctypes.c_void_p(0xBEF0),
        ctypes.c_float(args[2]), ctypes.c_int32(args[3])])
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: type("S", (), {"cuda_stream": 0x77}))
    k = rtc.CudaKernel(_FakeModule(), "axpy", "_Z4axpy", rtc.parse_signature(
        "const float *x, float *y, float a, int n"))
    for _ in range(2):
        k.launch((None, None, 1.5, 9), mx.gpu(0), (4,), (256, 2),
                 shared_mem=64 * 1024)
    assert fake.calls == [
        ("attr", 0xF00, 8, 65536),
        ("launch", 0xF00, (4, 1, 1, 256, 2, 1), 65536, 0x77, 0xBEE0, 1.5,
         None),
        ("launch", 0xF00, (4, 1, 1, 256, 2, 1), 65536, 0x77, 0xBEE0, 1.5,
         None)]
    assert k.launches == 2


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
