// Flash-attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel `_fwd_kernel` of mxnet_tpu/ops/pallas_kernels.py
// (launched by `_flash_forward` through `pl.pallas_call`).  It computes the
// same function: q, k, v (B, H, T, D) in f32 or bf16 -> out (B, H, T, D) in
// the input type and lse (B, H, T) in f32, with an online softmax whose
// running max, running sum and output accumulator are f32.  Options: causal
// (with the tile skip past the diagonal), a (B, T) key-padding mask (with the
// per-batch-row `kend` tile skip, and element masking inside the last tiles),
// an additive f32 bias broadcast over (B|1, H|1, T, T), and threefry2x32
// attention dropout in which `l` sums the undropped mass and only the PV
// product sees the dropped, rescaled p.  Rows with no valid key give exact
// zeros and an lse below the -1e29 sentinel.
//
// What bounds it.  At the serving path's largest bucket (B=8, H=12, T=512,
// D=64, bf16) the function moves 25.2 MB unmasked (q, k, v, out; 7.5 us at
// 3.35 TB/s) and does 6.4 GFLOP (6.5 us at 989 TF/s on the bf16 tensor
// cores): on the data sheet it is bound by bytes.  With a key-padding mask it
// needs only the valid keys' k and v rows and attends only to them, which
// at chip_smoke.py's mask (about half the keys valid) leaves a bound of
// 5.7 us.  This first kernel does not reach either line: it runs the
// products as scalar f32 FMAs on the CUDA cores (67 TF/s peak), so the FMA
// pipe and the shared-memory loads that feed it bound it; with that mask it
// takes about 0.24 ms on an H100 SXM at 700 W, some 42x the bound (PERF.md).
//
// What the design does about it.  Each block owns a 64-row query tile of one
// (batch, head) and keeps it in shared memory for the whole K loop, so q is
// read from device memory once and k/v once per query tile; the (T, T)
// scores never leave the chip.  64-key tiles of k and v are staged in shared
// memory (rows padded by one float so the lanes of a warp hit distinct
// banks), each thread holds a 4 x 8 register tile of scores and a 4 x D/8
// tile of the output, and row reductions are warp shuffles.  f32 inputs stay
// true f32 (no TF32); bf16 inputs are widened to f32, which is exact, so the
// products accumulate in f32 as the reference's do, and p is rounded to bf16
// before the PV product as the reference rounds it.  Tensor cores (wgmma),
// TMA and a pipelined K loop are the next steps toward the bound.  The
// threefry2x32 generator and the type conversions live in
// flash_attention_common.cuh, shared with the backward kernels (B4, B5), so
// that all three draw the same dropout bits.

#include "flash_attention_common.cuh"

namespace {

using flash::BH_FOLD;
using flash::MASKED_ROW;
using flash::NEG_INF;
using flash::from_f32;
using flash::row_max8;
using flash::row_sum8;
using flash::threefry2x32;
using flash::to_f32;

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per K/V tile
constexpr int NTHREADS = 128;   // 4 warps x 16 query rows
constexpr int R = 4;            // query rows per thread
constexpr int C = BK / 8;       // score columns per thread: cg + 8 * j

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  const int32_t* mask;   // (B, T) 0/1, or null
  const int32_t* kend;   // (B,) 1 + last valid key, or null (with mask)
  const float* bias;     // element (b, h, i, j) at b*bias_sb + h*bias_sh + i*T + j
  long long bias_sb;
  long long bias_sh;
  int B, H, T;
  float scale;
  int causal;
  int dropout;
  uint32_t seed0, seed1, thr;
  float inv_keep;
};

template <int D>
constexpr size_t smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1);
}

// Grid: (ceil(T / BQ), B * H).  Block: 128 threads.  Warp w owns query rows
// [16w, 16w + 16) of the tile; lane = 8 * rg + cg owns rows 16w + 4rg + i
// (i < 4), score columns cg + 8j (j < 8) and output columns cg + 8j
// (j < D/8), so the 8 lanes that share a row are one shuffle group.
template <typename S, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const Params p) {
  constexpr int QS = D + 1;
  constexpr int KS = D + 1;
  constexpr int VS = D;
  constexpr int PS = BK + 1;
  constexpr int DC = D / 8;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * QS;
  float* sV = sK + BK * KS;
  float* sP = sV + BK * VS;

  const int T = p.T;
  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rg = lane >> 3;
  const int cg = lane & 7;
  const int row0 = warp * 16 + rg * R;   // first of this thread's tile rows
  const int q0 = qt * BQ;

  const size_t base = static_cast<size_t>(bh) * T * D;
  const S* Q = static_cast<const S*>(p.q) + base;
  const S* K = static_cast<const S*>(p.k) + base;
  const S* V = static_cast<const S*>(p.v) + base;
  const bool masked = p.mask != nullptr;
  const int32_t* mrow = masked ? p.mask + static_cast<size_t>(b) * T : nullptr;
  const float* brow = p.bias ? p.bias + b * p.bias_sb + h * p.bias_sh
                             : nullptr;
  const uint32_t key0 = p.seed0 ^ (static_cast<uint32_t>(bh) * BH_FOLD);

  for (int idx = tid; idx < BQ * D; idx += NTHREADS) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int qrow = q0 + r;
    sQ[r * QS + c] =
        qrow < T ? to_f32(Q[static_cast<size_t>(qrow) * D + c]) : 0.f;
  }

  float m[R], l[R], acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  // Keys at or past kmax contribute nothing to any row of this tile: the
  // causal diagonal and the batch row's last valid key bound the K loop.
  int kmax = T;
  if (p.causal) kmax = min(kmax, q0 + BQ);
  if (p.kend != nullptr) kmax = min(kmax, p.kend[b]);
  const int n_tiles = (kmax + BK - 1) / BK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // every warp is done with the previous sK / sV
    for (int idx = tid; idx < BK * D; idx += NTHREADS) {
      const int r = idx / D;
      const int c = idx - r * D;
      const int krow = k0 + r;
      const bool ok = krow < T;
      sK[r * KS + c] = ok ? to_f32(K[static_cast<size_t>(krow) * D + c]) : 0.f;
      sV[r * VS + c] = ok ? to_f32(V[static_cast<size_t>(krow) * D + c]) : 0.f;
    }
    __syncthreads();

    float s[R][C];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[R], kv[C];
#pragma unroll
      for (int i = 0; i < R; ++i) qv[i] = sQ[(row0 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < C; ++j) kv[j] = sK[(cg + 8 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qpos = q0 + row0 + i;
      float mc = NEG_INF;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int kpos = k0 + cg + 8 * j;
        float x = s[i][j] * p.scale;
        if (kpos >= T) {
          x = NEG_INF;   // ragged last tile: the key does not exist
        } else {
          if (brow != nullptr && qpos < T)
            x += brow[static_cast<size_t>(qpos) * T + kpos];
          if (p.causal && qpos < kpos) x = NEG_INF;
          if (masked && mrow[kpos] == 0) x = NEG_INF;
        }
        s[i][j] = x;
        mc = fmaxf(mc, x);
      }
      mc = row_max8(mc);
      const float m_new = fmaxf(m[i], mc);
      // A row that has seen no valid key yet keeps m at -1e30; anchoring the
      // exponent at 0 keeps its p at exactly 0 instead of exp(0) = 1.
      const float m_exp = (masked && !(m_new > MASKED_ROW)) ? 0.f : m_new;
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int kpos = k0 + cg + 8 * j;
        const float pj = expf(s[i][j] - m_exp);
        rs += pj;
        float pa = pj;
        if (p.dropout) {
          const uint32_t bits =
              threefry2x32(key0, p.seed1, static_cast<uint32_t>(qpos),
                           static_cast<uint32_t>(kpos));
          pa = bits < p.thr ? pj * p.inv_keep : 0.f;
        }
        // p meets v in v's type (the reference casts p to v.dtype)
        sP[(row0 + i) * PS + cg + 8 * j] = to_f32(from_f32<S>(pa));
      }
      rs = row_sum8(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    // A warp reads back only the P rows its own lanes wrote.
    __syncwarp();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[R], vv[DC];
#pragma unroll
      for (int i = 0; i < R; ++i) pv[i] = sP[(row0 + i) * PS + kk];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = sV[kk * VS + cg + 8 * j];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  S* O = static_cast<S*>(p.out) + base;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qpos = q0 + row0 + i;
    if (qpos >= T) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DC; ++j)
      O[static_cast<size_t>(qpos) * D + cg + 8 * j] = from_f32<S>(acc[i][j] / lc);
    if (cg == 0)
      p.lse[static_cast<size_t>(bh) * T + qpos] = m[i] + logf(lc);
  }
}

template <typename S, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<S, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.T + BQ - 1) / BQ, p.B * p.H);
  flash_fwd_kernel<S, D><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename S>
cudaError_t launch_d(const Params& p, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<S, 16>(p, stream);
    case 32: return launch<S, 32>(p, stream);
    case 64: return launch<S, 64>(p, stream);
    case 128: return launch<S, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Every pointer is a device pointer; mask,
// kend and bias may be null.  Launches on `stream` and does not synchronise.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, float* lse,
    const int32_t* mask, const int32_t* kend, const float* bias,
    long long bias_sb, long long bias_sh, int batch, int heads, int seq,
    int head_dim, int dtype, float scale, int causal, int dropout,
    unsigned int seed0, unsigned int seed1, unsigned int thr, float inv_keep,
    void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = lse;
  p.mask = mask;
  p.kend = kend;
  p.bias = bias;
  p.bias_sb = bias_sb;
  p.bias_sh = bias_sh;
  p.B = batch;
  p.H = heads;
  p.T = seq;
  p.scale = scale;
  p.causal = causal;
  p.dropout = dropout;
  p.seed0 = seed0;
  p.seed1 = seed1;
  p.thr = thr;
  p.inv_keep = inv_keep;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_d<float>(p, head_dim, st);
  else if (dtype == 1)
    err = launch_d<__nv_bfloat16>(p, head_dim, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
