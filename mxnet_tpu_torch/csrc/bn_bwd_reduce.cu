// BatchNorm-backward joint reduction (B1) for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel `_bn_reduce_kernel` of mxnet_tpu/ops/nn.py
// (launched by `_bn_reduce_call` / `bn_bwd_reduce_pallas` through
// `pl.pallas_call`).  It computes the same function: for f32 dy and x-hat,
// the per-channel sums sum(dy) and sum(dy * x-hat), in f32, reading each
// input once.  The reference hands its kernel a channel-minor (M, C) view;
// PyTorch's activations are NCHW, so this kernel reads the contiguous
// (N0, C, N1) view directly (channel c's elements are N0 runs of N1 floats,
// C * N1 apart), which spares a transposing copy of both inputs.
//
// What bounds it.  Two f32 reads per element and two flops: bytes.  At
// ResNet-50's stem BatchNorm at batch 128, (N0, C, N1) = (128, 64, 12544),
// it reads 822 MB: 0.245 ms at 3.35 TB/s.
//
// What the design does about it.  The TPU kernel carried its sums across a
// sequential grid in scratch memory; blocks on the card run in parallel in
// no order.  So each channel's M = N0 * N1 elements are cut into `splits`
// ranges of `chunk` (chosen by the wrapper so that the card holds about
// four blocks per SM), one 256-thread block per (range, channel).  Threads
// walk their range with a stride of 256 elements, keeping the (row, column)
// position by additions instead of a division per element, four loads of
// each input in flight before they are summed, and accumulate in f32
// registers.  A warp-shuffle tree and a second tree over the eight warps
// give the block's two partial sums, which go to a workspace; a second
// small kernel adds each channel's partials in index order.  Every order is
// fixed and no float atomics are used, so two launches on the same inputs
// agree bitwise.  Summation depth per output: ceil(chunk / 256) sequential
// adds in a thread, 8 tree levels, `splits` sequential adds at the end.
// Reading x-hat in f32 is what the reference does; rebuilding it from the
// bf16 activations inside this kernel would halve the bytes (later work).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;     // threads per block
constexpr int U = 4;        // loads of each input in flight per thread

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid (splits, C); block NT.  part_a / part_b: (C, splits).
__global__ void __launch_bounds__(NT)
bn_reduce_partial(const float* __restrict__ dy, const float* __restrict__ xh,
                  float* __restrict__ part_a, float* __restrict__ part_b,
                  int C, long long L, long long M, long long chunk) {
  const int s = blockIdx.x;
  const int c = blockIdx.y;
  const int splits = gridDim.x;
  const long long j0 = (long long)s * chunk;
  const long long j1 = (j0 + chunk < M) ? j0 + chunk : M;
  const long long row_stride = (long long)C * L;
  const float* pdy = dy + (long long)c * L;
  const float* pxh = xh + (long long)c * L;
  // the stride NT in (row, column) terms: NT = q * L + r
  const long long q = NT / L;
  const long long r = NT - q * L;

  float a = 0.f, b = 0.f;
  long long j = j0 + threadIdx.x;
  long long n = j / L;
  long long l = j - n * L;
  while (j < j1) {
    float d[U], x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool live = j + (long long)u * NT < j1;
      const long long off = n * row_stride + l;
      d[u] = live ? __ldg(pdy + off) : 0.f;
      x[u] = live ? __ldg(pxh + off) : 0.f;
      l += r;
      n += q;
      if (l >= L) {
        l -= L;
        ++n;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      a += d[u];
      b = fmaf(d[u], x[u], b);
    }
    j += (long long)U * NT;
  }

  __shared__ float sa[NT / 32], sb[NT / 32];
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < NT / 32 ? sa[lane] : 0.f;
    b = lane < NT / 32 ? sb[lane] : 0.f;
    a = warp_sum(a);
    b = warp_sum(b);
    if (lane == 0) {
      part_a[(long long)c * splits + s] = a;
      part_b[(long long)c * splits + s] = b;
    }
  }
}

// one thread per channel: the partials in index order.
__global__ void bn_reduce_final(const float* __restrict__ part_a,
                                const float* __restrict__ part_b,
                                float* __restrict__ sum_dy,
                                float* __restrict__ sum_dy_xhat, int C,
                                int splits) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float a = 0.f, b = 0.f;
  for (int s = 0; s < splits; ++s) {
    a += part_a[(long long)c * splits + s];
    b += part_b[(long long)c * splits + s];
  }
  sum_dy[c] = a;
  sum_dy_xhat[c] = b;
}

}  // namespace

// dy, xhat: contiguous (n0, C, n1) f32; part: 2 * C * splits f32 of
// workspace; sum_dy, sum_dy_xhat: (C,) f32.  Every pointer is a device
// pointer.  Launches on `stream` and does not synchronise.
extern "C" int bn_bwd_reduce(const float* dy, const float* xhat, float* part,
                             float* sum_dy, float* sum_dy_xhat, int n0, int C,
                             long long n1, int splits, long long chunk,
                             void* stream) {
  if (C <= 0 || C > 65535 || splits <= 0 || n1 <= 0 || n0 < 0 || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long M = (long long)n0 * n1;
  float* part_a = part;
  float* part_b = part + (long long)C * splits;
  bn_reduce_partial<<<dim3(splits, C), NT, 0, st>>>(dy, xhat, part_a, part_b,
                                                     C, n1, M, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_reduce_final<<<(C + 127) / 128, 128, 0, st>>>(part_a, part_b, sum_dy,
                                                   sum_dy_xhat, C, splits);
  return static_cast<int>(cudaGetLastError());
}
