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
//
// The channel-minor form (`bn_bwd_reduce_rows`).  When the elements after
// the channel axis are few (N1 = 1 for NHWC activations and for BatchNorm
// on 2-d input: exactly the (M, C) view the TPU kernel was written for),
// the kernel above reads floats C * N1 apart in neighbouring threads and
// uses a few bytes of every 32-byte sector it pulls.  This form reads the
// data as R = N0 rows of W = C * N1 contiguous floats instead.  A block
// owns a tile of TW * VEC consecutive columns and a range of `chunk` rows;
// its 256 threads are RP = 256 / TW rows of TW column threads, each thread
// loading VEC columns (float4 when W % 4 == 0 and both pointers are
// 16-byte aligned), so a warp reads whole rows' runs: 512 bytes of one row
// at TW = 32 or more.  Each thread sums its rows in order in f32 registers
// (four rows' loads in flight), the block sums its RP row lanes per column
// in shared memory in a fixed order, and the column partials go to the
// (W, splits) workspace; `bn_reduce_final` then adds, per channel, its N1
// columns' partials in index order.  No float atomics: two launches agree
// bitwise.  Summation depth per output: ceil(chunk / RP) adds in a thread,
// RP in the block, N1 * splits at the end.

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

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = __ldg(p + i);
  }
}

// grid (splits, tiles); block NT = RP x TW threads.  part_a / part_b:
// (W, splits).
template <int VEC>
__global__ void __launch_bounds__(NT)
bn_reduce_rows_partial(const float* __restrict__ dy,
                       const float* __restrict__ xh,
                       float* __restrict__ part_a, float* __restrict__ part_b,
                       long long R, int W, int tw_log2, long long chunk) {
  const int TW = 1 << tw_log2;
  const int RP = NT >> tw_log2;
  const int ncol = TW * VEC;
  const int s = blockIdx.x;
  const int splits = gridDim.x;
  const int tx = threadIdx.x & (TW - 1);
  const int ty = threadIdx.x >> tw_log2;
  const int col = blockIdx.y * ncol + tx * VEC;
  const long long r0 = (long long)s * chunk;
  const long long r1 = (r0 + chunk < R) ? r0 + chunk : R;

  float a[VEC], b[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) a[i] = b[i] = 0.f;
  if (col < W) {   // VEC = 4 only when W % 4 == 0: the whole vector is in
    long long r = r0 + ty;
    for (; r + (U - 1) * (long long)RP < r1; r += U * (long long)RP) {
      float d[U][VEC], x[U][VEC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long off = (r + (long long)u * RP) * W + col;
        load_vec<VEC>(dy + off, d[u]);
        load_vec<VEC>(xh + off, x[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          a[i] += d[u][i];
          b[i] = fmaf(d[u][i], x[u][i], b[i]);
        }
      }
    }
    for (; r < r1; r += RP) {
      float d[VEC], x[VEC];
      load_vec<VEC>(dy + r * W + col, d);
      load_vec<VEC>(xh + r * W + col, x);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        a[i] += d[i];
        b[i] = fmaf(d[i], x[i], b[i]);
      }
    }
  }

  __shared__ float sa[NT * VEC], sb[NT * VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    sa[ty * ncol + tx * VEC + i] = a[i];
    sb[ty * ncol + tx * VEC + i] = b[i];
  }
  __syncthreads();
  for (int o = threadIdx.x; o < 2 * ncol; o += NT) {
    const bool second = o >= ncol;
    const int cc = second ? o - ncol : o;
    const float* src = second ? sb : sa;
    float acc = 0.f;
    for (int y = 0; y < RP; ++y) acc += src[y * ncol + cc];
    const int gcol = blockIdx.y * ncol + cc;
    if (gcol < W) (second ? part_b : part_a)[(long long)gcol * splits + s] = acc;
  }
}

// one thread per channel: its `per` columns' partials in index order
// (column-major over the splits).
__global__ void bn_reduce_final(const float* __restrict__ part_a,
                                const float* __restrict__ part_b,
                                float* __restrict__ sum_dy,
                                float* __restrict__ sum_dy_xhat, int C,
                                int splits, int per) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float a = 0.f, b = 0.f;
  for (long long k = (long long)c * per * splits;
       k < (long long)(c + 1) * per * splits; ++k) {
    a += part_a[k];
    b += part_b[k];
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
                                                   sum_dy_xhat, C, splits, 1);
  return static_cast<int>(cudaGetLastError());
}

// The channel-minor form.  dy, xhat: contiguous (n0, C, n1) f32 read as
// n0 rows of W = C * n1 floats; part: 2 * W * splits f32 of workspace;
// vec: 4 (W % 4 == 0, 16-byte aligned pointers) or 1; tw: column threads
// per row, a power of two from 1 to 256.  Launches on `stream`.
extern "C" int bn_bwd_reduce_rows(const float* dy, const float* xhat,
                                  float* part, float* sum_dy,
                                  float* sum_dy_xhat, long long n0, int C,
                                  int n1, int vec, int tw, int splits,
                                  long long chunk, void* stream) {
  const long long W = (long long)C * n1;
  int tw_log2 = 0;
  while ((1 << tw_log2) < tw) ++tw_log2;
  if (C <= 0 || n1 <= 0 || n0 <= 0 || W > 0x7fffffffLL || splits <= 0 ||
      chunk <= 0 || (1 << tw_log2) != tw || tw > NT ||
      !(vec == 1 || (vec == 4 && W % 4 == 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (W + (long long)tw * vec - 1) / ((long long)tw * vec);
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part_a = part;
  float* part_b = part + W * splits;
  const dim3 grid(splits, (unsigned)tiles);
  if (vec == 4)
    bn_reduce_rows_partial<4><<<grid, NT, 0, st>>>(dy, xhat, part_a, part_b,
                                                   n0, (int)W, tw_log2, chunk);
  else
    bn_reduce_rows_partial<1><<<grid, NT, 0, st>>>(dy, xhat, part_a, part_b,
                                                   n0, (int)W, tw_log2, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_reduce_final<<<(C + 127) / 128, 128, 0, st>>>(part_a, part_b, sum_dy,
                                                   sum_dy_xhat, C, splits, n1);
  return static_cast<int>(cudaGetLastError());
}
