// Model-level dropout for Hopper (sm_90a), CUDA C++.
//
// Not the port of a Pallas kernel: the reference's dropout
// (mxnet_tpu/ops/nn.py:566 `dropout`) draws its mask from XLA's random bits.
// The port draws it here from the threefry2x32 hash the flash kernels use
// (flash_attention_common.cuh), keyed by the two seed words of the draw and
// counted by the element's flat index:
//
//   keep(i) = threefry2x32(seed0, seed1, i mod 2^32, i div 2^32) < thr
//   out[i]  = keep(i) ? x[i] * inv_keep : 0     (f32 product, one rounding)
//
// The seed words are read from device memory, so that a training step
// captured as a CUDA graph draws fresh bits at every replay from the words
// the host writes into its seed buffer.  The backward is the same kernel on
// the output gradient with the same words.
//
// What bounds it.  One read and one write of the tensor (4 bytes an element
// in bf16 at BERT-base's (32, 128, 768): 12.6 MB, 3.8 us at 3.35 TB/s) and
// about 70 integer operations of threefry an element (2 G a call there,
// a few us on the CUDA cores): bytes and integer work are of one order.
// A grid-stride loop, one element a thread a step; PERF.md keeps its time.

#include "flash_attention_common.cuh"

namespace {

constexpr int NTHREADS = 256;

template <typename S>
__global__ void __launch_bounds__(NTHREADS)
dropout_kernel(const S* __restrict__ x, S* __restrict__ out,
               const uint32_t* __restrict__ seed, long long n, uint32_t thr,
               float inv_keep) {
  const uint32_t s0 = __ldg(seed);
  const uint32_t s1 = __ldg(seed + 1);
  const long long stride = static_cast<long long>(gridDim.x) * NTHREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * NTHREADS +
                     threadIdx.x;
       i < n; i += stride) {
    const uint32_t bits = flash::threefry2x32(
        s0, s1, static_cast<uint32_t>(i),
        static_cast<uint32_t>(static_cast<unsigned long long>(i) >> 32));
    out[i] = bits < thr ? flash::from_f32<S>(flash::to_f32(x[i]) * inv_keep)
                        : flash::from_f32<S>(0.f);
  }
}

template <typename S>
cudaError_t launch(const void* x, void* out, const uint32_t* seed,
                   long long n, uint32_t thr, float inv_keep,
                   cudaStream_t stream) {
  const long long blocks = (n + NTHREADS - 1) / NTHREADS;
  const int grid = static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16);
  dropout_kernel<S><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const S*>(x), static_cast<S*>(out), seed, n, thr,
      inv_keep);
  return cudaGetLastError();
}

}  // namespace

// x and out: n contiguous elements of dtype 0 = float32, 1 = bfloat16,
// 2 = float16 (out a buffer of its own); seed: the two uint32 seed words;
// keep(i) is bits < thr.  Every pointer is a device pointer.  Launches on `stream`
// and does not synchronise; returns the CUDA error of the launch.
extern "C" int dropout_apply(const void* x, void* out,
                             const unsigned int* seed, long long n, int dtype,
                             unsigned int thr, float inv_keep, void* stream) {
  if (n < 1 || seed == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(x, out, seed, n, thr, inv_keep, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(x, out, seed, n, thr, inv_keep, st);
  else if (dtype == 2)
    err = launch<__half>(x, out, seed, n, thr, inv_keep, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
