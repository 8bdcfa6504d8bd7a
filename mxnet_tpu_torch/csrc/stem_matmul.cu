// Space-to-depth stem matrix product (B2) for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel `_matmul_kernel` of mxnet_tpu/ops/stem.py
// (launched by `_stem_matmul` / `stem_conv_pallas` through
// `pl.pallas_call`).  It computes the same function: out = patches @ w for
// row-major patches (M, K) and w (K, N), both f32 or both bf16, with every
// product and sum in f32 and K never split, the result rounded once to the
// inputs' type (round to nearest even, as PyTorch's cast).
//
// What bounds it.  ResNet-50's stem at batch 128: M = 1,605,632, K = 192,
// N = 64.  In bf16 it moves 617 MB of patches and 206 MB of output (0.245
// ms at 3.35 TB/s) against 39.5 GFLOP (0.040 ms on the bf16 tensor cores):
// bytes bound it.  This first kernel runs its products as scalar f32 FMAs on
// the CUDA cores (67 TF/s), where the same work takes at least 0.59 ms: the
// FMA pipe and the shared-memory loads that feed it bound it.
//
// What the design does about it.  Each 256-thread block owns a 128 x 64
// output tile and walks K in steps of 32: the 128 x 32 patch tile is staged
// in shared memory transposed (k-major, rows padded to 129 floats so that a
// warp's stores hit distinct banks) and the 32 x 64 weight tile as it is,
// both widened to f32.  Each thread keeps an 8 x 4 register tile of sums and
// reads its 8 patch values and a float4 of weights per k.  Ragged M, N and K
// edges are masked.  Tensor cores (mma.sync, then wgmma with TMA) and an
// implicit im2col that reads the packed input instead of the 16x larger
// patches are the steps toward the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;       // output rows per block
constexpr int BN = 64;        // output columns per block
constexpr int BK = 32;        // K per stage
constexpr int NTHREADS = 256;
constexpr int TM = 8;         // rows per thread
constexpr int TN = 4;         // columns per thread
constexpr int APAD = BM + 1;  // transposed patch tile row length

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
stem_matmul_kernel(const T* __restrict__ a, const T* __restrict__ w,
                   T* __restrict__ out, long long M, int K, int N) {
  __shared__ float As[BK * APAD];
  __shared__ __align__(16) float Ws[BK * BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);   // column group: 0..15
  const int ty = tid / (BN / TN);   // row group: 0..15
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // patch tile: BM x BK, read row by row (consecutive threads, consecutive
    // k), stored k-major
#pragma unroll
    for (int e = tid; e < BM * BK; e += NTHREADS) {
      const int row = e / BK, kk = e % BK;
      const long long gm = m0 + row;
      const int gk = k0 + kk;
      As[kk * APAD + row] =
          (gm < M && gk < K) ? to_f32(a[gm * K + gk]) : 0.f;
    }
    // weight tile: BK x BN
#pragma unroll
    for (int e = tid; e < BK * BN; e += NTHREADS) {
      const int kk = e / BN, col = e % BN;
      const int gk = k0 + kk, gn = n0 + col;
      Ws[kk * BN + col] =
          (gk < K && gn < N) ? to_f32(w[(long long)gk * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk * APAD + ty * TM + i];
      const float4 wv = *reinterpret_cast<const float4*>(&Ws[kk * BN + tx * TN]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        acc[i][0] = fmaf(av[i], wv.x, acc[i][0]);
        acc[i][1] = fmaf(av[i], wv.y, acc[i][1]);
        acc[i][2] = fmaf(av[i], wv.z, acc[i][2]);
        acc[i][3] = fmaf(av[i], wv.w, acc[i][3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < N) store(out + gm * N + gn, acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* w, void* out, long long M,
                   int K, int N, cudaStream_t st) {
  const long long gx = (M + BM - 1) / BM;
  const int gy = (N + BN - 1) / BN;
  if (gx > 2147483647LL || gy > 65535) return cudaErrorInvalidValue;
  stem_matmul_kernel<T><<<dim3((unsigned)gx, gy), NTHREADS, 0, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(w), static_cast<T*>(out),
      M, K, N);
  return cudaGetLastError();
}

}  // namespace

// a: (M, K) row-major, w: (K, N) row-major, out: (M, N) row-major, all of
// `dtype` (0 = float32, 1 = bfloat16) on the device.  Launches on `stream`
// and does not synchronise.
extern "C" int stem_matmul(const void* a, const void* w, void* out,
                           long long M, int K, int N, int dtype,
                           void* stream) {
  if (M < 0 || K <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(a, w, out, M, K, N, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(a, w, out, M, K, N, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
