// Flash-attention backward for Hopper (sm_90a), CUDA C++: kernels B4 (dq) and
// B5 (dk, dv).
//
// Replace the TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel` of
// mxnet_tpu/ops/pallas_kernels.py (launched by `_flash_backward` through
// `pl.pallas_call`).  They compute the same function, not a block-for-block
// copy.  Inputs: q, k, v, dO (B, H, T, D) in f32 or bf16; the forward's lse
// (B, H, T) f32; delta = rowsum(dO * out) - dlse (B, H, T) f32, reduced in
// torch before the launch.  Both kernels recompute the probabilities from
// the saved lse instead of storing them:
//
//   s  = q k^T * scale (+ bias), then causal / key-padding fill -1e30
//   p  = exp(s - lse)          (lse anchored at 0 where lse <= -1e29, so a
//                               row with no valid key has p = 0, not NaN)
//   dp = (dO v^T) * keep       (keep: the dropout keep/rescale factor,
//                               regenerated from the forward's seed words)
//   ds = p * (dp - delta) * scale
//   dq = ds @ k                               (B4, q-major)
//   dv = (p * keep)^T @ dO,  dk = ds^T @ q    (B5, k-major)
//
// ds is rounded to the input type before it meets k or q, and p * keep to
// dO's type before it meets dO, as the reference rounds them; the products
// accumulate in f32 and dq, dk, dv are stored in the input type.  Dropout
// bits come from the threefry2x32 device function that the forward uses
// (flash_attention_common.cuh), keyed by (seed, batch*head) with global
// (q_pos, k_pos) counters, so all three kernels draw bit-identical masks.
//
// Work skipped, as in the reference: B4 stops its K loop at the causal
// diagonal and at the batch row's `kend` (1 + its last valid key); B5 starts
// its Q loop at the diagonal and runs no Q tile at all for a K tile at or
// past `kend`.  Every dk/dv row is still written: rows of a skipped K tile
// get exact zeros, as the reference's `_finish` writes its zero accumulator.
//
// What bounds it.  At the training path's shape (B=32, H=12, T=128, D=64,
// bf16, about 3/4 of the keys valid) B4 moves ~25 MB (q, k, v, dO, dq, lse,
// delta) and does 3 products of 2*D flops per live (query, key) pair, B5
// ~31 MB and 4 products: on the data sheet both are bound by bytes, at a few
// microseconds.  Like B3, these first kernels run the products as scalar f32
// FMAs on the CUDA cores (67 TF/s peak), fed from shared memory, so the FMA
// pipe bounds them; chip_smoke.py times them against their bound and
// PERF.md keeps the numbers.
//
// What the design does about it.  Each block owns one 64-row tile (queries
// for B4, keys for B5) of one (batch, head) and keeps it and its partner
// operand (dO for B4, v for B5) in shared memory for the whole loop, so the
// (T, T) scores, probabilities and their gradients never leave the chip.  A
// thread holds a 4 x 8 register tile of s and dp (both products share one
// pass over D) and 4 x D/8 tiles of its outputs; the tile of ds (and of
// p * keep for B5) goes through shared memory, rows padded by one float so
// the lanes of a warp hit distinct banks, and each warp reads back only the
// rows its own lanes wrote.  f32 inputs stay true f32 (no TF32); bf16 inputs
// widen to f32 exactly.  Tensor cores (wgmma), TMA and a pipelined loop are
// the next steps toward the bound.

#include "flash_attention_common.cuh"

namespace {

using flash::BH_FOLD;
using flash::MASKED_ROW;
using flash::NEG_INF;
using flash::from_f32;
using flash::keep_scale;
using flash::round_to;
using flash::to_f32;

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int NTHREADS = 128;   // 4 warps x 16 rows of the block's own tile
constexpr int R = 4;            // tile rows per thread
constexpr int C = 8;            // columns per thread of the other tile: cg + 8 * j

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;      // (B, H, T) from the forward
  const float* delta;    // (B, H, T) rowsum(dO * out) - dlse
  void* dq;
  void* dk;
  void* dv;
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

// Copy rows [r0, r0 + 64) of a (T, D) slab into shared memory as f32 with
// row stride D + 1; rows at or past T are zeros.
template <typename S, int D>
__device__ __forceinline__ void load_tile(float* dst, const S* src, int r0,
                                          int T) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += NTHREADS) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int row = r0 + r;
    dst[r * (D + 1) + c] =
        row < T ? to_f32(src[static_cast<size_t>(row) * D + c]) : 0.f;
  }
}

template <int D>
constexpr size_t dq_smem_floats() {
  return 4 * 64 * (D + 1) + BQ * (BK + 1);
}

template <int D>
constexpr size_t dkv_smem_floats() {
  return 4 * 64 * (D + 1) + 2 * BQ + 2 * BK * (BQ + 1);
}

// B4.  Grid: (ceil(T / BQ), B * H).  Warp w owns query rows [16w, 16w + 16)
// of the tile; lane = 8 * rg + cg owns rows 16w + 4rg + i (i < 4), score
// columns cg + 8j (j < 8) and dq columns cg + 8j (j < D/8).
template <typename S, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const Params p) {
  constexpr int RS = D + 1;
  constexpr int PS = BK + 1;
  constexpr int DC = D / 8;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + BQ * RS;
  float* sK = sDO + BQ * RS;
  float* sV = sK + BK * RS;
  float* sDS = sV + BK * RS;

  const int T = p.T;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int lane = threadIdx.x & 31;
  const int cg = lane & 7;
  const int row0 = (threadIdx.x >> 5) * 16 + (lane >> 3) * R;

  const size_t base = static_cast<size_t>(bh) * T * D;
  const S* K = static_cast<const S*>(p.k) + base;
  const S* V = static_cast<const S*>(p.v) + base;
  const bool masked = p.mask != nullptr;
  const int32_t* mrow = masked ? p.mask + static_cast<size_t>(b) * T : nullptr;
  const float* brow = p.bias ? p.bias + b * p.bias_sb + h * p.bias_sh
                             : nullptr;
  const uint32_t key0 = p.seed0 ^ (static_cast<uint32_t>(bh) * BH_FOLD);

  load_tile<S, D>(sQ, static_cast<const S*>(p.q) + base, q0, T);
  load_tile<S, D>(sDO, static_cast<const S*>(p.dout) + base, q0, T);

  float lse[R], delta[R], acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qpos = q0 + row0 + i;
    const size_t at = static_cast<size_t>(bh) * T + qpos;
    lse[i] = qpos < T ? p.lse[at] : 0.f;
    delta[i] = qpos < T ? p.delta[at] : 0.f;
    if (masked && !(lse[i] > MASKED_ROW)) lse[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  int kmax = T;
  if (p.causal) kmax = min(kmax, q0 + BQ);
  if (p.kend != nullptr) kmax = min(kmax, p.kend[b]);
  const int n_tiles = (kmax + BK - 1) / BK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // every warp is done with the previous sK / sV
    load_tile<S, D>(sK, K, k0, T);
    load_tile<S, D>(sV, V, k0, T);
    __syncthreads();

    float s[R][C], dp[R][C];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qv[R], ov[R], kv[C], vv[C];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        qv[i] = sQ[(row0 + i) * RS + d];
        ov[i] = sDO[(row0 + i) * RS + d];
      }
#pragma unroll
      for (int j = 0; j < C; ++j) {
        kv[j] = sK[(cg + 8 * j) * RS + d];
        vv[j] = sV[(cg + 8 * j) * RS + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qpos = q0 + row0 + i;
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
        const float pj = expf(x - lse[i]);
        float dpj = dp[i][j];
        if (p.dropout)
          dpj *= keep_scale(key0, p.seed1, qpos, kpos, p.thr, p.inv_keep);
        // ds meets k in k's type (the reference casts ds to k.dtype)
        sDS[(row0 + i) * PS + cg + 8 * j] =
            round_to<S>(pj * (dpj - delta[i]) * p.scale);
      }
    }
    // A warp reads back only the ds rows its own lanes wrote.
    __syncwarp();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[R], kv[DC];
#pragma unroll
      for (int i = 0; i < R; ++i) dsv[i] = sDS[(row0 + i) * PS + kk];
#pragma unroll
      for (int j = 0; j < DC; ++j) kv[j] = sK[kk * RS + cg + 8 * j];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

  S* DQ = static_cast<S*>(p.dq) + base;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qpos = q0 + row0 + i;
    if (qpos >= T) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      DQ[static_cast<size_t>(qpos) * D + cg + 8 * j] = from_f32<S>(acc[i][j]);
  }
}

// B5.  Grid: (ceil(T / BK), B * H).  The same thread layout in transposed
// (k-major) score space: warp w owns key rows [16w, 16w + 16) of the tile;
// lane = 8 * rg + cg owns key rows 16w + 4rg + i (i < 4), query columns
// cg + 8j (j < 8) and dk/dv columns cg + 8j (j < D/8).
template <typename S, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const Params p) {
  constexpr int RS = D + 1;
  constexpr int PS = BQ + 1;
  constexpr int DC = D / 8;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * RS;
  float* sQ = sV + BK * RS;
  float* sDO = sQ + BQ * RS;
  float* sLSE = sDO + BQ * RS;
  float* sDEL = sLSE + BQ;
  float* sP = sDEL + BQ;
  float* sDS = sP + BK * PS;

  const int T = p.T;
  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int lane = threadIdx.x & 31;
  const int cg = lane & 7;
  const int row0 = (threadIdx.x >> 5) * 16 + (lane >> 3) * R;

  const size_t base = static_cast<size_t>(bh) * T * D;
  const S* Q = static_cast<const S*>(p.q) + base;
  const S* DO = static_cast<const S*>(p.dout) + base;
  const float* LSE = p.lse + static_cast<size_t>(bh) * T;
  const float* DEL = p.delta + static_cast<size_t>(bh) * T;
  const bool masked = p.mask != nullptr;
  const float* brow = p.bias ? p.bias + b * p.bias_sb + h * p.bias_sh
                             : nullptr;
  const uint32_t key0 = p.seed0 ^ (static_cast<uint32_t>(bh) * BH_FOLD);

  // a key that does not exist (ragged last tile) or is padding
  bool dead[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kpos = k0 + row0 + i;
    dead[i] = kpos >= T ||
              (masked && p.mask[static_cast<size_t>(b) * T + kpos] == 0);
  }

  float dk[R][DC], dv[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dk[i][j] = dv[i][j] = 0.f;

  // A K tile at or past kend sees no query: it keeps its zero accumulators.
  const bool alive = p.kend == nullptr || k0 < p.kend[b];
  // Causal: Q tiles wholly before the diagonal see nothing of this K tile.
  const int first_qt = p.causal ? k0 / BQ : 0;
  const int n_qt = alive ? (T + BQ - 1) / BQ : 0;

  if (alive) {
    load_tile<S, D>(sK, static_cast<const S*>(p.k) + base, k0, T);
    load_tile<S, D>(sV, static_cast<const S*>(p.v) + base, k0, T);
  }

  for (int qt = first_qt; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();   // every warp is done with the previous sQ / sDO
    load_tile<S, D>(sQ, Q, q0, T);
    load_tile<S, D>(sDO, DO, q0, T);
    for (int r = threadIdx.x; r < BQ; r += NTHREADS) {
      const int qpos = q0 + r;
      float l = qpos < T ? LSE[qpos] : 0.f;
      if (masked && !(l > MASKED_ROW)) l = 0.f;
      sLSE[r] = l;
      sDEL[r] = qpos < T ? DEL[qpos] : 0.f;
    }
    __syncthreads();

    float st[R][C], dpt[R][C];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float kv[R], vv[R], qv[C], ov[C];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        kv[i] = sK[(row0 + i) * RS + d];
        vv[i] = sV[(row0 + i) * RS + d];
      }
#pragma unroll
      for (int j = 0; j < C; ++j) {
        qv[j] = sQ[(cg + 8 * j) * RS + d];
        ov[j] = sDO[(cg + 8 * j) * RS + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) {
          st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
          dpt[i][j] = fmaf(vv[i], ov[j], dpt[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int kpos = k0 + row0 + i;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int qc = cg + 8 * j;
        const int qpos = q0 + qc;
        float x = st[i][j] * p.scale;
        if (qpos >= T || kpos >= T) {
          x = NEG_INF;   // ragged last tiles: the query or key does not exist
        } else {
          if (brow != nullptr) x += brow[static_cast<size_t>(qpos) * T + kpos];
          if (p.causal && qpos < kpos) x = NEG_INF;
          if (dead[i]) x = NEG_INF;
        }
        const float pj = expf(x - sLSE[qc]);
        const float ks = p.dropout ? keep_scale(key0, p.seed1, qpos, kpos,
                                                p.thr, p.inv_keep)
                                   : 1.f;
        // p * keep meets dO in dO's type, ds meets q in q's type
        sP[(row0 + i) * PS + qc] = round_to<S>(pj * ks);
        sDS[(row0 + i) * PS + qc] =
            round_to<S>(pj * (dpt[i][j] * ks - sDEL[qc]) * p.scale);
      }
    }
    // A warp reads back only the rows its own lanes wrote.
    __syncwarp();

#pragma unroll 2
    for (int qq = 0; qq < BQ; ++qq) {
      float pv[R], dsv[R], ov[DC], qv[DC];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        pv[i] = sP[(row0 + i) * PS + qq];
        dsv[i] = sDS[(row0 + i) * PS + qq];
      }
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        ov[j] = sDO[qq * RS + cg + 8 * j];
        qv[j] = sQ[qq * RS + cg + 8 * j];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          dv[i][j] = fmaf(pv[i], ov[j], dv[i][j]);
          dk[i][j] = fmaf(dsv[i], qv[j], dk[i][j]);
        }
    }
  }

  S* DK = static_cast<S*>(p.dk) + base;
  S* DV = static_cast<S*>(p.dv) + base;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kpos = k0 + row0 + i;
    if (kpos >= T) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const size_t at = static_cast<size_t>(kpos) * D + cg + 8 * j;
      DK[at] = from_f32<S>(dk[i][j]);
      DV[at] = from_f32<S>(dv[i][j]);
    }
  }
}

template <typename S, int D, bool DQ>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kernel = DQ ? flash_bwd_dq_kernel<S, D> : flash_bwd_dkv_kernel<S, D>;
  const size_t smem =
      (DQ ? dq_smem_floats<D>() : dkv_smem_floats<D>()) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.T + 63) / 64, p.B * p.H);
  kernel<<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool DQ>
cudaError_t launch_any(const Params& p, int dtype, int d,
                       cudaStream_t stream) {
  if (dtype == 0) {
    switch (d) {
      case 16: return launch<float, 16, DQ>(p, stream);
      case 32: return launch<float, 32, DQ>(p, stream);
      case 64: return launch<float, 64, DQ>(p, stream);
      case 128: return launch<float, 128, DQ>(p, stream);
    }
  } else if (dtype == 1) {
    switch (d) {
      case 16: return launch<__nv_bfloat16, 16, DQ>(p, stream);
      case 32: return launch<__nv_bfloat16, 32, DQ>(p, stream);
      case 64: return launch<__nv_bfloat16, 64, DQ>(p, stream);
      case 128: return launch<__nv_bfloat16, 128, DQ>(p, stream);
    }
  }
  return cudaErrorInvalidValue;
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   const int32_t* mask, const int32_t* kend,
                   const float* bias, long long bias_sb, long long bias_sh,
                   int batch, int heads, int seq, float scale, int causal,
                   int dropout, unsigned int seed0, unsigned int seed1,
                   unsigned int thr, float inv_keep) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = p.dk = p.dv = nullptr;
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
  return p;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Every pointer is a device pointer; mask,
// kend and bias may be null.  Each launches on `stream` and does not
// synchronise; it returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, const int32_t* mask,
    const int32_t* kend, const float* bias, long long bias_sb,
    long long bias_sh, int batch, int heads, int seq, int head_dim,
    int dtype, float scale, int causal, int dropout, unsigned int seed0,
    unsigned int seed1, unsigned int thr, float inv_keep, void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, mask, kend, bias, bias_sb,
                         bias_sh, batch, heads, seq, scale, causal, dropout,
                         seed0, seed1, thr, inv_keep);
  p.dq = dq;
  return static_cast<int>(launch_any<true>(
      p, dtype, head_dim, static_cast<cudaStream_t>(stream)));
}

extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
    const int32_t* mask, const int32_t* kend, const float* bias,
    long long bias_sb, long long bias_sh, int batch, int heads, int seq,
    int head_dim, int dtype, float scale, int causal, int dropout,
    unsigned int seed0, unsigned int seed1, unsigned int thr, float inv_keep,
    void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, mask, kend, bias, bias_sb,
                         bias_sh, batch, heads, seq, scale, causal, dropout,
                         seed0, seed1, thr, inv_keep);
  p.dk = dk;
  p.dv = dv;
  return static_cast<int>(launch_any<false>(
      p, dtype, head_dim, static_cast<cudaStream_t>(stream)));
}
