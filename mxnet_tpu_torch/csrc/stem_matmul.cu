// Space-to-depth stem for Hopper (sm_90a), CUDA C++: kernel B2.
//
// Replaces the TPU kernel `_matmul_kernel` of mxnet_tpu/ops/stem.py
// (launched by `_stem_matmul` / `stem_conv_pallas` through
// `pl.pallas_call`), which multiplies the im2col patches of the packed input
// by the folded weight.  Two entry points:
//
// - `stem_conv` (the path `ops/stem.py` takes): the whole packed stem conv,
//   out (B, C_out, H2, W2) = 4x4 stride-1 conv of xs (B, Cp, H2, W2) at
//   padding (2, 1), with the folded weight (C_out, Cp, 4, 4), NCHW in and
//   out, both f32 or both bf16.  Every product and sum in f32, K = 16 Cp
//   never split, one rounding to the input type: the function of
//   `patches @ w2d` reshaped to NCHW, without the patches.
// - `stem_matmul` (the first design, kept as the B2 matrix product for
//   callers that hold patches): out = patches @ w for row-major (M, K) and
//   (K, N), scalar f32 FMAs on 128 x 64 tiles.
//
// What bounds it.  ResNet-50's stem at batch 128 in bf16: xs (128, 12, 112,
// 112) is 38.5 MB, the weight 24.6 KB and the output (128, 64, 112, 112)
// 205.5 MB: 244 MB, 0.073 ms at 3.35 TB/s, against 39.5 GFLOP, 0.040 ms on
// the bf16 tensor cores: bytes bound it.  The first design read 617 MB of
// patches that the wrapper built (and wrote) first, and a permute copied its
// (M, C_out) result to NCHW.
//
// What the design does about it (bf16).  No patches: a block stages the
// rows its 4x4 windows need (RG output rows need RG + 3 input rows, all Cp
// channels, with the zero padding) in shared memory by 16-byte cp.async,
// and the whole 64-wide slice of the weight, (64, 16 Cp) row-major (24 KB at
// Cp = 12), once.  It walks its tasks (RG rows x up to 128 columns of one
// image) with the next task's input rows in flight in a second buffer while
// the current one is computed.  Pixels are the MMA's M, output channels its
// N, K is ordered (channel, kh, kw) as the folded weight, so one 16-deep
// k-step is one channel's 4x4 window: the A fragments are built straight
// from the staged rows (pairs of neighbouring columns), the B fragments by
// ldmatrix from the weight's rows, and mma.sync m16n8k16 (bf16 in, f32
// accumulate) runs the products; a warp takes two 16-pixel tiles by 64
// channels at a time.  The accumulators are rounded once to bf16, staged per
// warp transposed (channel-major) in shared memory and written to NCHW rows
// from there, so no permute copy follows.  f32 stays true f32 (no TF32): a
// scalar kernel over the same staged rows (one output row of up to 128
// pixels a task, 8 pixels x 4 channels a thread, sequential FMAs in K
// order), without the second buffer.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

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

// ---------------------------------------------------------------------------
// stem_conv: the packed stem conv without patches
// ---------------------------------------------------------------------------
constexpr int CV_WARPS = 8;       // tensor-core kernel: 8 warps
constexpr int CV_THREADS = 32 * CV_WARPS;
constexpr int CV_N = 64;          // output channels per block
constexpr int CV_MAX_WC = 128;    // columns per task at most
constexpr int WPAD = 8;           // weight rows: elements of padding
constexpr int OPAD = 8;           // output staging rows: elements of padding

struct ConvParams {
  const void* x;     // (B, Cp, H2, W2)
  const void* w;     // (C_out, 16 Cp)
  void* out;         // (B, C_out, H2, W2)
  int B, Cp, H2, W2, Cout;
  int RG;            // output rows a task
  int WC;            // columns a task
  int SW;            // staged row length: input columns j0 - 8 .. j0 - 8 + SW
  int tasks_h, tasks_w;   // tasks along H2 and W2
  int vec;           // 16-byte copies (W2 % 8 == 0, x 16-byte aligned)
};

// Staged input: slab element (c, rr, s) = x[b, c, i0 - 2 + rr, j0 - 8 + s],
// zero outside the image (the conv's padding), at ((c * (RG + 3) + rr) * SW
// + s), for rr < RG + 3 and s < SW.
template <typename S>
__device__ __forceinline__ void stage_rows(const ConvParams& p, S* slab,
                                           int task, int nthreads) {
  const int per_img = p.tasks_h * p.tasks_w;
  const int b = task / per_img;
  const int i0 = (task % per_img) / p.tasks_w * p.RG;
  const int j0 = (task % p.tasks_w) * p.WC;
  const int rows = p.RG + 3;
  const S* X = static_cast<const S*>(p.x) +
               static_cast<size_t>(b) * p.Cp * p.H2 * p.W2;
  if (p.vec) {
    // whole 16-byte chunks: each lies wholly inside or outside the image
    constexpr int V = 16 / sizeof(S);
    const int cpr = p.SW / V;
    const int n = p.Cp * rows * cpr;
    const uint32_t base = hopper::smem_u32(slab);
    for (int e = threadIdx.x; e < n; e += nthreads) {
      const int q = e % cpr;
      const int cr = e / cpr;
      const int ii = i0 - 2 + cr % rows;
      const int jj = j0 - 8 + V * q;
      const bool ok = ii >= 0 && ii < p.H2 && jj >= 0 && jj < p.W2;
      const size_t at =
          ok ? (static_cast<size_t>(cr / rows) * p.H2 + ii) * p.W2 + jj : 0;
      hopper::cp_async16(base + (cr * p.SW + V * q) * sizeof(S), X + at, ok);
    }
  } else {
    const int n = p.Cp * rows * p.SW;
    for (int e = threadIdx.x; e < n; e += nthreads) {
      const int s = e % p.SW;
      const int cr = e / p.SW;
      const int ii = i0 - 2 + cr % rows;
      const int jj = j0 - 8 + s;
      const bool ok = ii >= 0 && ii < p.H2 && jj >= 0 && jj < p.W2;
      slab[e] = ok ? X[(static_cast<size_t>(cr / rows) * p.H2 + ii) * p.W2 +
                       jj]
                   : S(0.f);
    }
  }
}

// Output pixel m (< RG * WC) of a task: its element offset in one (C_out)
// plane of the image, or -1 where it lies outside the image.
__device__ __forceinline__ long long pixel_at(const ConvParams& p, int task,
                                              int m) {
  const int per_img = p.tasks_h * p.tasks_w;
  const int i = (task % per_img) / p.tasks_w * p.RG + m / p.WC;
  const int j = (task % p.tasks_w) * p.WC + m % p.WC;
  if (m >= p.RG * p.WC || i >= p.H2 || j >= p.W2) return -1;
  return static_cast<long long>(i) * p.W2 + j;
}

template <typename TR>
size_t conv_tc_smem_bytes(const ConvParams& p) {
  return (2 * static_cast<size_t>(p.Cp) * (p.RG + 3) * p.SW +
          CV_N * (16 * p.Cp + WPAD) + CV_WARPS * CV_N * (32 + OPAD)) *
         2;
}

// Grid: (tasks, or fewer: a block walks tasks blockIdx.x + k gridDim.x;
// ceil(C_out / 64)).  Warp w takes the task's 16-pixel tiles 2w, 2w + 1,
// then 2w + 16, 2w + 17, ...; lane = 4g + t holds pixels g and g + 8 of
// each tile, channels 8n + 2t, 8n + 2t + 1 of each 8-channel block n.  Two
// blocks an SM (16 warps) keep the shared-memory loads and the MMAs in
// flight.
template <typename TR>
__global__ void __launch_bounds__(CV_THREADS, 2)
stem_conv_tc_kernel(const ConvParams p) {
  using S = typename TR::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int slab_elems = p.Cp * (p.RG + 3) * p.SW;
  const int KS = 16 * p.Cp + WPAD;   // weight row stride
  S* slab0 = reinterpret_cast<S*>(smem);
  S* wsm = slab0 + 2 * slab_elems;
  unsigned short* stage =
      reinterpret_cast<unsigned short*>(wsm + CV_N * KS);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  unsigned short* my_stage = stage + warp * CV_N * (32 + OPAD);
  const int n0 = blockIdx.y * CV_N;
  const int n_tasks = p.B * p.tasks_h * p.tasks_w;
  const int MP = p.RG * p.WC;              // pixels a task
  const int n_pairs = (MP + 31) / 32;      // pairs of 16-pixel tiles
  const int rows = p.RG + 3;

  // the weight's rows n0 .. n0 + 63 (zeros past C_out), 16 bytes at a time
  {
    const int cpr = 2 * p.Cp;   // 16-byte chunks of a 16 Cp row
    const uint32_t base = hopper::smem_u32(wsm);
    for (int e = threadIdx.x; e < CV_N * cpr; e += CV_THREADS) {
      const int n = e / cpr;
      const int q = e % cpr;
      const bool ok = n0 + n < p.Cout;
      hopper::cp_async16(
          base + (n * KS + 8 * q) * 2,
          static_cast<const S*>(p.w) +
              (ok ? static_cast<size_t>(n0 + n) * 16 * p.Cp + 8 * q : 0),
          ok);
    }
  }
  int task = blockIdx.x;
  if (task < n_tasks) stage_rows<S>(p, slab0, task, CV_THREADS);
  hopper::cp_async_commit();

  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) * 8;
  const uint32_t w_base = hopper::smem_u32(wsm);
  // this lane's (kh, kw) in a 16-deep k-step: columns 2t, 2t + 1 are kh =
  // t / 2, kw = 2t % 4 and kw + 1; columns 2t + 8, 2t + 9 are kh + 2
  const int kofs = (t4 >> 1) * p.SW + ((2 * t4) & 3);

  for (int it = 0; task < n_tasks; ++it, task += gridDim.x) {
    const int next = task + gridDim.x;
    S* cur = slab0 + (it & 1) * slab_elems;
    if (next < n_tasks) {       // the next task's rows into the other buffer
      stage_rows<S>(p, slab0 + ((it + 1) & 1) * slab_elems, next,
                    CV_THREADS);
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned short* xs = reinterpret_cast<const unsigned short*>(cur);
    const int b = task / (p.tasks_h * p.tasks_w);

    for (int pr = warp; pr < n_pairs; pr += CV_WARPS) {
      // slab offsets of this lane's pixels g, g + 8 of both tiles (pixels
      // past the task read in-range rows; they are not stored)
      int off[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        int m = 32 * pr + 8 * u + g;
        m = min(m, MP - 1);
        off[u] = (m / p.WC) * p.SW + m % p.WC + 6 + kofs;
      }
      float acc[2][8][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mt][n][c] = 0.f;

#pragma unroll 4
      for (int c = 0; c < p.Cp; ++c) {
        const unsigned short* xc = xs + c * rows * p.SW;
        uint32_t wb[4][4];
#pragma unroll
        for (int np = 0; np < 4; ++np)
          hopper::ldsm_x4(wb[np],
                          w_base + ((np * 16 + b_row) * KS + c * 16 + b_col) *
                                       2);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const unsigned short* ra = xc + off[2 * mt];
          const unsigned short* rb = xc + off[2 * mt + 1];
          uint32_t a[4];
          a[0] = ra[0] | (static_cast<uint32_t>(ra[1]) << 16);
          a[1] = rb[0] | (static_cast<uint32_t>(rb[1]) << 16);
          a[2] = ra[2 * p.SW] | (static_cast<uint32_t>(ra[2 * p.SW + 1]) << 16);
          a[3] = rb[2 * p.SW] | (static_cast<uint32_t>(rb[2 * p.SW + 1]) << 16);
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            TR::mma(acc[mt][2 * np], a, wb[np][0], wb[np][1]);
            TR::mma(acc[mt][2 * np + 1], a, wb[np][2], wb[np][3]);
          }
        }
      }

      // round once, stage channel-major, write NCHW rows of 32 pixels
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int o = n * 8 + 2 * t4 + (c & 1);
            const int px = 16 * mt + g + 8 * (c >> 1);
            my_stage[o * (32 + OPAD) + px] =
                static_cast<unsigned short>(TR::bits(acc[mt][n][c]));
          }
      __syncwarp();
      const int n_valid = min(CV_N, p.Cout - n0);
      const size_t plane = static_cast<size_t>(p.H2) * p.W2;
      unsigned short* O = static_cast<unsigned short*>(p.out) +
                          (static_cast<size_t>(b) * p.Cout + n0) * plane;
      if (p.WC % 2 == 0 && p.W2 % 2 == 0) {
        // two neighbouring pixels a lane (an even pixel pair never spans
        // two rows), 16 lanes a channel row: 4-byte stores
        const int pp = 2 * (lane & 15);
        const long long at = pixel_at(p, task, 32 * pr + pp);
        if (at >= 0)
          for (int o = lane >> 4; o < n_valid; o += 2)
            *reinterpret_cast<uint32_t*>(O + o * plane + at) =
                *reinterpret_cast<const uint32_t*>(
                    my_stage + o * (32 + OPAD) + pp);
      } else {
        const long long at = pixel_at(p, task, 32 * pr + lane);
        if (at >= 0)
          for (int o = 0; o < n_valid; ++o)
            O[o * plane + at] = my_stage[o * (32 + OPAD) + lane];
      }
      __syncwarp();
    }
    __syncthreads();   // every warp is done with this buffer
  }
  hopper::cp_async_wait<0>();
}

constexpr int CF_THREADS = 256;   // f32 kernel: 16 pixel lanes x 16 channel groups

size_t conv_f32_smem_bytes(const ConvParams& p) {
  return (static_cast<size_t>(p.Cp) * (p.RG + 3) * p.SW +
          16 * p.Cp * CV_N) *
         4;
}

// f32: one output row of up to 128 pixels a task (RG = 1).  Thread (tp, to)
// = (tid % 16, tid / 16) takes pixels tp + 16 i (i < 8) and channels
// 4 to .. 4 to + 3; K in order (channel, kh, kw), one FMA after another.
__global__ void __launch_bounds__(CF_THREADS)
stem_conv_f32_kernel(const ConvParams p) {
  extern __shared__ __align__(16) float smem_f[];
  float* slab = smem_f;
  float* wsm = slab + p.Cp * (p.RG + 3) * p.SW;   // [16 Cp][64]
  const int K = 16 * p.Cp;
  const int n0 = blockIdx.y * CV_N;
  const int tp = threadIdx.x & 15;
  const int to = threadIdx.x >> 4;
  const int n_tasks = p.B * p.tasks_h * p.tasks_w;
  const int rows = p.RG + 3;

  for (int e = threadIdx.x; e < K * CV_N; e += CF_THREADS) {
    const int k = e / CV_N;
    const int n = e % CV_N;
    wsm[e] = n0 + n < p.Cout
                 ? static_cast<const float*>(p.w)[
                       static_cast<size_t>(n0 + n) * K + k]
                 : 0.f;
  }
  for (int task = blockIdx.x; task < n_tasks; task += gridDim.x) {
    __syncthreads();   // every thread is done with the previous rows
    stage_rows<float>(p, slab, task, CF_THREADS);
    hopper::cp_async_commit();
    hopper::cp_async_wait<0>();
    __syncthreads();
    const int b = task / (p.tasks_h * p.tasks_w);
    int off[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) off[i] = min(tp + 16 * i, p.WC - 1) + 6;
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < K; ++k) {
      const int c = k >> 4;
      const float* xr = slab + (c * rows + ((k >> 2) & 3)) * p.SW + (k & 3);
      const float4 wv = *reinterpret_cast<const float4*>(wsm + k * CV_N +
                                                         4 * to);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xv = xr[off[i]];
        acc[i][0] = fmaf(xv, wv.x, acc[i][0]);
        acc[i][1] = fmaf(xv, wv.y, acc[i][1]);
        acc[i][2] = fmaf(xv, wv.z, acc[i][2]);
        acc[i][3] = fmaf(xv, wv.w, acc[i][3]);
      }
    }
    float* O = static_cast<float*>(p.out) +
               static_cast<size_t>(b) * p.Cout * p.H2 * p.W2;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long at = pixel_at(p, task, tp + 16 * i);
      if (at < 0) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = n0 + 4 * to + j;
        if (o < p.Cout) O[static_cast<size_t>(o) * p.H2 * p.W2 + at] =
            acc[i][j];
      }
    }
  }
}

template <typename K>
cudaError_t launch_conv(K kernel, size_t smem, int threads,
                        const ConvParams& p, cudaStream_t st) {
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return err;
  const long long tasks =
      static_cast<long long>(p.B) * p.tasks_h * p.tasks_w;
  const int gy = (p.Cout + CV_N - 1) / CV_N;
  // resident blocks walk the tasks: a few tasks a block, so that the next
  // task's rows arrive while the current one is computed
  const long long want = static_cast<long long>(sms) * max(per_sm, 1) * 2 / gy;
  const int gx = static_cast<int>(max(1LL, min(tasks, want)));
  if (gy > 65535) return cudaErrorInvalidValue;
  kernel<<<dim3(gx, gy), threads, smem, st>>>(p);
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

// xs: (B, Cp, H2, W2), w: (C_out, 16 Cp), out: (B, C_out, H2, W2), all
// contiguous, 16-byte aligned, of `dtype` (0 = float32, 1 = bfloat16) on the
// device.  Launches on `stream` and does not synchronise.
extern "C" int stem_conv(const void* xs, const void* w, void* out, int batch,
                         int cp, int h2, int w2, int cout, int dtype,
                         void* stream) {
  if (batch < 0 || cp <= 0 || h2 <= 0 || w2 <= 0 || cout <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  ConvParams p;
  p.x = xs;
  p.w = w;
  p.out = out;
  p.B = batch;
  p.Cp = cp;
  p.H2 = h2;
  p.W2 = w2;
  p.Cout = cout;
  p.WC = w2 < CV_MAX_WC ? w2 : CV_MAX_WC;
  // the 16-bit kernel takes about 512 pixels a task, the f32 kernel a row
  p.RG = dtype == 0 ? 1 : (512 / p.WC < h2 ? 512 / p.WC : h2);
  if (p.RG < 1) p.RG = 1;
  p.SW = (p.WC + 9 + 7) / 8 * 8;
  p.tasks_h = (h2 + p.RG - 1) / p.RG;
  p.tasks_w = (w2 + p.WC - 1) / p.WC;
  const size_t esize = dtype == 0 ? 4 : 2;
  p.vec = w2 % 8 == 0 && reinterpret_cast<uintptr_t>(xs) % 16 == 0 &&
          (static_cast<size_t>(h2) * w2 * esize) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_conv(stem_conv_f32_kernel, conv_f32_smem_bytes(p),
                      CF_THREADS, p, st);
  else if (dtype == 1)
    err = launch_conv(stem_conv_tc_kernel<hopper::Bf16>,
                      conv_tc_smem_bytes<hopper::Bf16>(p), CV_THREADS, p, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
