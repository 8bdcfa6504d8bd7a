// Flash-attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel `_fwd_kernel` of mxnet_tpu/ops/pallas_kernels.py
// (launched by `_flash_forward` through `pl.pallas_call`).  It computes the
// same function: q, k, v (B, H, T, D) in f32, bf16 or f16 -> out (B, H, T, D)
// in the input type and lse (B, H, T) in f32, with an online softmax whose
// running max, running sum and output accumulator are f32.  Options: causal
// (with the tile skip past the diagonal), a (B, T) key-padding mask (with the
// per-batch-row `kend` tile skip, and element masking inside the last tiles),
// an additive f32 bias broadcast over (B|1, H|1, T, T), and threefry2x32
// attention dropout in which `l` sums the undropped mass and only the PV
// product sees the dropped, rescaled p, rounded to v's type.  Rows with no
// valid key give exact zeros and an lse below the -1e29 sentinel.  Any
// batch*head: it is folded over the grid's y and z dimensions.
//
// What bounds it.  At the serving path's largest bucket (B=8, H=12, T=512,
// D=64, bf16) the function moves 25.2 MB unmasked (q, k, v, out; 7.5 us at
// 3.35 TB/s) and does 6.4 GFLOP (6.5 us at 989 TF/s on the bf16 tensor
// cores): on the data sheet it is bound by bytes.  With a key-padding mask it
// needs only the valid keys' k and v rows and attends only to them, which
// at chip_smoke.py's mask (about half the keys valid) leaves a bound of
// 5.7 us.  What the card can reach with mma.sync is below the data sheet's
// rate, and the per-element work (scale, masks, exp, dropout bits) runs on
// the CUDA cores beside it; PERF.md keeps the measured times.
//
// What the design does about it (bf16 and f16).  A block owns a 64-row
// query tile of one (batch, head); four warps own 16 rows each and hold
// their rows of q as MMA A fragments in registers for the whole K loop, so q
// is read from device memory once and k/v once per query tile; the (T, T)
// scores never leave the chip.  K and V tiles of 64 keys (32 from D = 80 on,
// so that the score and output accumulators fit the registers) arrive by
// 16-byte cp.async into two buffers, the next tile in flight while the
// current one is computed.  S = q k^T and O += p v run on mma.sync m16n8k16
// (16-bit inputs, f32 accumulation), fed by ldmatrix for k and ldmatrix.trans
// for v from row-major (T, D) tiles whose rows are padded by 16 bytes so that
// an ldmatrix hits distinct banks.  Scale, bias, masks and dropout are
// applied to the score fragments in registers; row max and row sum take two
// shuffles across the four lanes that share a row; p (times keep) is rounded
// to the input type straight into the PV A fragments.  Any head_dim <= 128
// that is a multiple of 8 (the wrapper pads others): the kernel is
// instantiated at D rounded up to 16, and cp.async zero-fills the columns
// past the true D in shared memory.  The output is staged through shared
// memory and written 16 bytes a lane.
//
// Head dims past 128 take chunked kernels, in which no register array
// grows with D.  bf16 and f16 (flash_fwd_wide_tc_kernel): the tensor-core
// kernel above with the head dim cut into chunks of 64.  s = q k^T runs on
// mma.sync over the chunks into the same f32 accumulators, the tiles
// zero-filled past D, so that a D that is no multiple of 16 adds exact
// zeros; a block owns 128
// output columns in register accumulators and recomputes the scores, the
// softmax and the dropout bits ceil(D / 128) times.  q's rows and the K
// tiles' rows lie whole in shared memory up to D = 320 (two blocks an SM),
// and stream a chunk at a time past that.  f32 (flash_fwd_wide_kernel):
// scalar f32 FMAs, the scores summed over D in chunks of 32 staged through
// shared memory, each block owning 64 columns of the output.  PERF.md keeps
// their times beside their bounds.
//
// The dropout seed words are read from device memory (`seed`), so that a
// captured CUDA graph draws the words its replay was given.
//
// f32 stays true f32 (no TF32): a scalar kernel with FMAs on the CUDA cores
// (67 TF/s peak), q/k/v tiles in shared memory widened to f32 (rows padded
// by one float), a 4 x 8 register tile of scores per thread and warp-shuffle
// row reductions, at D of 16, 32, 64 or 128 (the wrapper zero-pads D).  The
// threefry2x32 generator and the type conversions live in
// flash_attention_common.cuh, shared with the backward kernels (B4, B5), so
// that all three draw the same dropout bits; the tensor-core helpers in
// hopper_mma.cuh.

#include "flash_attention_common.cuh"
#include "hopper_mma.cuh"

namespace {

using flash::MASKED_ROW;
using flash::MAX_HEAD_DIM;
using flash::NEG_INF;
using flash::fold_grid;
using flash::folded_bh;
using flash::row_max8;
using flash::row_sum8;
using flash::threefry2x32;

constexpr int BQ = 64;          // query rows per block
constexpr int NTHREADS = 128;   // 4 warps x 16 query rows
constexpr int PAD = 8;          // 16-bit kernels: elements of padding per row
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

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
  int D;                 // row length of q, k, v, out in device memory
  float scale;
  int causal;
  int dropout;
  const uint32_t* seed;  // the two threefry seed words (device memory)
  uint32_t thr;
  float inv_keep;
};

// ---------------------------------------------------------------------------
// bf16 / f16: tensor cores
// ---------------------------------------------------------------------------
// keys per K/V tile: narrower from D = 80 on, where the output accumulators
// take 40 or more registers
template <int DP>
__host__ __device__ constexpr int tc_bk() {
  return DP > 64 ? 32 : 64;
}

template <int DP>
constexpr size_t tc_smem_bytes() {
  // the Q tile (later the output staging), two K and two V tiles, two
  // tiles of the key-padding mask
  return (BQ + 4 * tc_bk<DP>()) * (DP + PAD) * 2 + 2 * tc_bk<DP>() * 4;
}

// Rows [r0, r0 + ROWS) of a (T, d) slab of 16-bit values into shared memory
// at dst (row stride DP + PAD elements) by 16-byte cp.async; rows at or past
// T and columns at or past d are zeros.  d is a multiple of 8.
template <int DP, int ROWS, typename S>
__device__ __forceinline__ void copy_rows(uint32_t dst, const S* src, int r0,
                                          int T, int d) {
  constexpr int CPR = DP / 8;   // 16-byte chunks a row
  for (int c = threadIdx.x; c < ROWS * CPR; c += NTHREADS) {
    const int r = c / CPR;
    const int col = (c % CPR) * 8;
    const int row = r0 + r;
    const bool ok = row < T && col < d;
    hopper::cp_async16(dst + (r * (DP + PAD) + col) * 2,
                  src + (ok ? static_cast<size_t>(row) * d + col : 0), ok);
  }
}

// Grid: (ceil(T / BQ), folded B * H).  Warp w owns query rows
// [16w, 16w + 16) of the tile; lane = 4g + t holds rows 16w + g and
// 16w + g + 8, score columns 8n + 2t, 8n + 2t + 1 of each 8-key block n,
// and output columns likewise of each 8-wide block of D.
template <typename TR, int DP>
__global__ void __launch_bounds__(NTHREADS, DP <= 64 ? 3 : 2)
flash_fwd_tc_kernel(const Params p) {
  using S = typename TR::T;
  constexpr int BKT = tc_bk<DP>();
  constexpr int RS = DP + PAD;
  constexpr uint32_t KV_TILE = BKT * RS * 2;
  extern __shared__ __align__(16) unsigned char smem[];
  S* tQ = reinterpret_cast<S*>(smem);
  const uint32_t sQ = hopper::smem_u32(tQ);
  const uint32_t sK = sQ + BQ * RS * 2;          // two buffers
  const uint32_t sV = sK + 2 * KV_TILE;          // two buffers
  // the key-padding mask of each K tile (two buffers; 0 past T)
  const int32_t* tMask = reinterpret_cast<const int32_t*>(
      smem + BQ * RS * 2 + 4 * KV_TILE);
  const uint32_t sMask = sV + 2 * KV_TILE;

  const int bh = folded_bh();
  if (bh >= p.B * p.H) return;
  const int T = p.T;
  const int d = p.D;
  const int q0 = blockIdx.x * BQ;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  const size_t base = static_cast<size_t>(bh) * T * d;
  const S* K = static_cast<const S*>(p.k) + base;
  const S* V = static_cast<const S*>(p.v) + base;
  const bool masked = p.mask != nullptr;
  const int32_t* mrow = masked ? p.mask + static_cast<size_t>(b) * T : nullptr;
  const float* brow = p.bias ? p.bias + b * p.bias_sb + h * p.bias_sh
                             : nullptr;
  const flash::SeedKey sk = flash::seed_key(p.seed, p.dropout, bh);
  // scores go to base 2: p = 2^(x log2(e) - m), m kept in that unit
  const float scale2 = p.scale * LOG2E;

  // Keys at or past kmax contribute nothing to any row of this tile: the
  // causal diagonal and the batch row's last valid key bound the K loop.
  int kmax = T;
  if (p.causal) kmax = min(kmax, q0 + BQ);
  if (p.kend != nullptr) kmax = min(kmax, p.kend[b]);
  const int n_tiles = (kmax + BKT - 1) / BKT;

  // K, V and (with a mask) the mask of K tile kt into buffer kt & 1
  auto stage = [&](int kt) {
    const uint32_t off = (kt & 1) * KV_TILE;
    copy_rows<DP, BKT>(sK + off, K, kt * BKT, T, d);
    copy_rows<DP, BKT>(sV + off, V, kt * BKT, T, d);
    if (masked && threadIdx.x < BKT) {
      const int kpos = kt * BKT + threadIdx.x;
      hopper::cp_async4(sMask + ((kt & 1) * BKT + threadIdx.x) * 4,
                        mrow + (kpos < T ? kpos : 0), kpos < T);
    }
  };

  copy_rows<DP, BQ>(sQ, static_cast<const S*>(p.q) + base, q0, T, d);
  if (n_tiles > 0) stage(0);
  hopper::cp_async_commit();

  int rows[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) rows[i] = 16 * warp + g + 8 * i;

  // ldmatrix lane addresses: A from (rows x k) storage; B from (n x k)
  // storage; B from (k x n) storage through .trans
  const int a_row = 16 * warp + (lane & 15);
  const int a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) * 8;
  const int t_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int t_col = (lane >> 4) * 8;

  uint32_t qa[DP / 16][4];
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BKT;
    const uint32_t buf = (kt & 1) * KV_TILE;
    if (kt + 1 < n_tiles) {       // prefetch the next K/V tile
      stage(kt + 1);
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks)
        hopper::ldsm_x4(qa[ks], sQ + (a_row * RS + ks * 16 + a_col) * 2);
    }

    float s[BKT / 8][4];
#pragma unroll
    for (int n = 0; n < BKT / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
#pragma unroll
      for (int np = 0; np < BKT / 16; ++np) {
        uint32_t kb[4];
        hopper::ldsm_x4(kb, sK + buf +
                                ((np * 16 + b_row) * RS + ks * 16 + b_col) * 2);
        TR::mma(s[2 * np], qa[ks], kb[0], kb[1]);
        TR::mma(s[2 * np + 1], qa[ks], kb[2], kb[3]);
      }
    }

    // the keys of this lane's columns that exist and are valid: bit
    // 2n + j for column 8n + 2t + j
    uint32_t keys = 0u;
#pragma unroll
    for (int n = 0; n < BKT / 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = n * 8 + 2 * t4 + j;
        const bool ok = k0 + col < T &&
                        (!masked || tMask[(kt & 1) * BKT + col] != 0);
        keys |= static_cast<uint32_t>(ok) << (2 * n + j);
      }
    // A tile whose keys all exist, are valid and lie at or before every
    // row of the warp (and no bias) needs no per-element work before the
    // max: it is taken on the raw scores, and the scale (base 2) is folded
    // into the exponent's FMA.  Elsewhere the scores are scaled, biased
    // and masked in place first.
    const bool raw = brow == nullptr && p.scale > 0.f &&
                     __all_sync(0xffffffffu,
                                keys == (1u << (BKT / 4)) - 1u) &&
                     !(p.causal && k0 + BKT - 1 > q0 + 16 * warp);
    const float sc_now = raw ? scale2 : 1.f;
    float mc[2] = {NEG_INF, NEG_INF};
    if (raw) {
#pragma unroll
      for (int n = 0; n < BKT / 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) mc[c >> 1] = fmaxf(mc[c >> 1], s[n][c]);
    } else {
#pragma unroll
    for (int n = 0; n < BKT / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c >> 1;
        const int qpos = q0 + rows[i];
        const int kpos = k0 + n * 8 + 2 * t4 + (c & 1);
        float x;
        if (brow != nullptr) {
          const float bv =
              qpos < T && kpos < T ? brow[static_cast<size_t>(qpos) * T + kpos]
                                   : 0.f;
          x = __fmul_rn(__fadd_rn(__fmul_rn(s[n][c], p.scale), bv), LOG2E);
        } else {
          x = __fmul_rn(s[n][c], scale2);
        }
        const bool ok = ((keys >> (2 * n + (c & 1))) & 1u) &&
                        !(p.causal && qpos < kpos);
        x = ok ? x : NEG_INF;
        s[n][c] = x;
        mc[i] = fmaxf(mc[i], x);
      }
    }
    float alpha[2], m_exp[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mc[i] = fmaxf(mc[i], __shfl_xor_sync(0xffffffffu, mc[i], 1));
      mc[i] = fmaxf(mc[i], __shfl_xor_sync(0xffffffffu, mc[i], 2));
      // the max of the scaled scores is the scaled max (scale > 0)
      const float m_new = fmaxf(m[i], mc[i] * sc_now);
      // A row that has seen no valid key yet keeps m at -1e30; anchoring the
      // exponent at 0 keeps its p at exactly 0 instead of exp(0) = 1.
      m_exp[i] = (masked && !(m_new > MASKED_ROW)) ? 0.f : m_new;
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
    // p into s: l sums the undropped p, the PV product sees p * keep
#pragma unroll
    for (int n = 0; n < BKT / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c >> 1;
        const float pj = exp2f(fmaf(s[n][c], sc_now, -m_exp[i]));
        rs[i] += pj;
        float pa = pj;
        if (p.dropout) {
          const uint32_t bits = threefry2x32(
              sk.key0, sk.key1, static_cast<uint32_t>(q0 + rows[i]),
              static_cast<uint32_t>(k0 + n * 8 + 2 * t4 + (c & 1)));
          pa = bits < p.thr ? pj * p.inv_keep : 0.f;
        }
        s[n][c] = pa;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = l[i] * alpha[i] + rs[i];
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += p v: p meets v in v's type (the reference casts p to v.dtype)
#pragma unroll
    for (int kk = 0; kk < BKT / 16; ++kk) {
      uint32_t pa[4];
      hopper::to_a_frag<TR>(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n2 = 0; n2 < DP / 16; ++n2) {
        uint32_t vb[4];
        hopper::ldsm_x4_t(vb, sV + buf +
                                  ((kk * 16 + t_row) * RS + n2 * 16 + t_col) * 2);
        TR::mma(acc[2 * n2], pa, vb[0], vb[1]);
        TR::mma(acc[2 * n2 + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();   // every warp is done with this buffer
  }
  hopper::cp_async_wait<0>();
  __syncthreads();     // the Q tile's copy has landed; reuse it for out

  // out = acc / l in the input type, staged in the warp's own rows of the Q
  // tile, then written 16 bytes a lane
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
      *reinterpret_cast<uint32_t*>(tQ + rows[i] * RS + n * 8 + 2 * t4) =
          TR::pack(acc[n][2 * i] / lc, acc[n][2 * i + 1] / lc);
    const int qpos = q0 + rows[i];
    if (t4 == 0 && qpos < T)
      p.lse[static_cast<size_t>(bh) * T + qpos] = m[i] * LN2 + logf(lc);
  }
  __syncwarp();
  S* O = static_cast<S*>(p.out) + base;
  const int cpr = d / 8;
  for (int c = lane; c < 16 * cpr; c += 32) {
    const int r = 16 * warp + c / cpr;
    const int col = (c % cpr) * 8;
    const int qpos = q0 + r;
    if (qpos < T)
      *reinterpret_cast<uint4*>(O + static_cast<size_t>(qpos) * d + col) =
          *reinterpret_cast<const uint4*>(tQ + r * RS + col);
  }
}

// ---------------------------------------------------------------------------
// f32: scalar FMAs (true f32)
// ---------------------------------------------------------------------------
constexpr int BK = 64;          // keys per K/V tile
constexpr int R = 4;            // query rows per thread
constexpr int C = BK / 8;       // score columns per thread: cg + 8 * j

template <int D>
constexpr size_t f32_smem_bytes() {
  return (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1)) * 4;
}

// Grid: (ceil(T / BQ), folded B * H).  Block: 128 threads.  Warp w owns
// query rows [16w, 16w + 16) of the tile; lane = 8 * rg + cg owns rows
// 16w + 4rg + i (i < 4), score columns cg + 8j (j < 8) and output columns
// cg + 8j (j < D/8), so the 8 lanes that share a row are one shuffle group.
template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_f32_kernel(const Params p) {
  constexpr int QS = D + 1;
  constexpr int KS = D + 1;
  constexpr int VS = D;
  constexpr int PS = BK + 1;
  constexpr int DC = D / 8;
  extern __shared__ float smem_f[];
  float* sQ = smem_f;
  float* sK = sQ + BQ * QS;
  float* sV = sK + BK * KS;
  float* sP = sV + BK * VS;

  const int bh = folded_bh();
  if (bh >= p.B * p.H) return;
  const int T = p.T;
  const int qt = blockIdx.x;
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
  const float* Q = static_cast<const float*>(p.q) + base;
  const float* K = static_cast<const float*>(p.k) + base;
  const float* V = static_cast<const float*>(p.v) + base;
  const bool masked = p.mask != nullptr;
  const int32_t* mrow = masked ? p.mask + static_cast<size_t>(b) * T : nullptr;
  const float* brow = p.bias ? p.bias + b * p.bias_sb + h * p.bias_sh
                             : nullptr;
  const flash::SeedKey sk = flash::seed_key(p.seed, p.dropout, bh);

  for (int idx = tid; idx < BQ * D; idx += NTHREADS) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int qrow = q0 + r;
    sQ[r * QS + c] = qrow < T ? Q[static_cast<size_t>(qrow) * D + c] : 0.f;
  }

  float m[R], l[R], acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
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
    for (int idx = tid; idx < BK * D; idx += NTHREADS) {
      const int r = idx / D;
      const int c = idx - r * D;
      const int krow = k0 + r;
      const bool ok = krow < T;
      sK[r * KS + c] = ok ? K[static_cast<size_t>(krow) * D + c] : 0.f;
      sV[r * VS + c] = ok ? V[static_cast<size_t>(krow) * D + c] : 0.f;
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
              threefry2x32(sk.key0, sk.key1, static_cast<uint32_t>(qpos),
                           static_cast<uint32_t>(kpos));
          pa = bits < p.thr ? pj * p.inv_keep : 0.f;
        }
        sP[(row0 + i) * PS + cg + 8 * j] = pa;
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

  float* O = static_cast<float*>(p.out) + base;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qpos = q0 + row0 + i;
    if (qpos >= T) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DC; ++j)
      O[static_cast<size_t>(qpos) * D + cg + 8 * j] = acc[i][j] / lc;
    if (cg == 0)
      p.lse[static_cast<size_t>(bh) * T + qpos] = m[i] + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// head_dim > 128, f32: scalar f32 FMAs, D in chunks
// ---------------------------------------------------------------------------
// The kernels above keep a row of q (B3 bf16/f16: as MMA fragments) or of
// the output accumulator in registers, which does not scale past D = 128.
// Here the scores s = q k^T are summed over D in chunks of WCH columns
// staged through shared memory (sequential FMAs in d order, as the plain
// version's f32 product sums), and each block owns WCOL columns of the
// output: the grid's x dimension walks (query tile, column chunk), and
// every column block of a query tile computes the same scores, softmax
// statistics and dropout bits again.  Only column block 0 writes the lse.
// Nothing in shared memory or registers grows with D, so any D is taken.
constexpr int WCH = 32;         // D columns a score chunk sums
constexpr int WCOL = 64;        // output columns a block owns

constexpr size_t wide_smem_bytes() {
  return (BQ * (WCH + 1) + BK * (WCH + 1) + BK * WCOL + BQ * (BK + 1)) * 4;
}

// Grid: (ceil(T / BQ) * ceil(D / WCOL), folded B * H).  Block: 128
// threads.  Warp w owns query rows [16w, 16w + 16) of the tile; lane =
// 8 * rg + cg owns rows 16w + 4rg + i (i < 4), score columns cg + 8j (j < 8)
// and output columns c0 + cg + 8j (j < WCOL / 8) of the block's chunk.
// Instantiated for f32 only (bf16 and f16 take flash_fwd_wide_tc_kernel).
template <typename S>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_wide_kernel(const Params p) {
  constexpr int CS = WCH + 1;
  constexpr int PS = BK + 1;
  constexpr int DC = WCOL / 8;
  extern __shared__ float smem_w[];
  float* sQ = smem_w;
  float* sK = sQ + BQ * CS;
  float* sV = sK + BK * CS;
  float* sP = sV + BK * WCOL;

  const int bh = folded_bh();
  if (bh >= p.B * p.H) return;
  const int T = p.T;
  const int D = p.D;
  const int n_col = (D + WCOL - 1) / WCOL;
  const int q0 = static_cast<int>(blockIdx.x) / n_col * BQ;
  const int c0 = static_cast<int>(blockIdx.x) % n_col * WCOL;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int cg = lane & 7;
  const int row0 = (tid >> 5) * 16 + (lane >> 3) * R;

  const size_t base = static_cast<size_t>(bh) * T * D;
  const S* Q = static_cast<const S*>(p.q) + base;
  const S* K = static_cast<const S*>(p.k) + base;
  const S* V = static_cast<const S*>(p.v) + base;
  const bool masked = p.mask != nullptr;
  const int32_t* mrow = masked ? p.mask + static_cast<size_t>(b) * T : nullptr;
  const float* brow = p.bias ? p.bias + b * p.bias_sb + h * p.bias_sh
                             : nullptr;
  const flash::SeedKey sk = flash::seed_key(p.seed, p.dropout, bh);

  float m[R], l[R], acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  int kmax = T;
  if (p.causal) kmax = min(kmax, q0 + BQ);
  if (p.kend != nullptr) kmax = min(kmax, p.kend[b]);
  const int n_tiles = (kmax + BK - 1) / BK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    float s[R][C];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) s[i][j] = 0.f;
    for (int dc = 0; dc < D; dc += WCH) {
      __syncthreads();   // every warp is done with the previous chunk
      for (int idx = tid; idx < BQ * WCH; idx += NTHREADS) {
        const int r = idx / WCH;
        const int c = idx - r * WCH;
        const int d = dc + c;
        const int qrow = q0 + r;
        const int krow = k0 + r;
        sQ[r * CS + c] = qrow < T && d < D
            ? flash::to_f32(Q[static_cast<size_t>(qrow) * D + d]) : 0.f;
        sK[r * CS + c] = krow < T && d < D
            ? flash::to_f32(K[static_cast<size_t>(krow) * D + d]) : 0.f;
      }
      __syncthreads();
      const int dn = min(WCH, D - dc);
#pragma unroll 4
      for (int c = 0; c < dn; ++c) {
        float qv[R], kv[C];
#pragma unroll
        for (int i = 0; i < R; ++i) qv[i] = sQ[(row0 + i) * CS + c];
#pragma unroll
        for (int j = 0; j < C; ++j) kv[j] = sK[(cg + 8 * j) * CS + c];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < C; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
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
              threefry2x32(sk.key0, sk.key1, static_cast<uint32_t>(qpos),
                           static_cast<uint32_t>(kpos));
          pa = bits < p.thr ? pj * p.inv_keep : 0.f;
        }
        // p (times keep) meets v in v's type
        sP[(row0 + i) * PS + cg + 8 * j] = flash::round_to<S>(pa);
      }
      rs = row_sum8(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }

    __syncthreads();   // every warp is done with the previous V chunk
    for (int idx = tid; idx < BK * WCOL; idx += NTHREADS) {
      const int r = idx / WCOL;
      const int c = idx - r * WCOL;
      const int krow = k0 + r;
      const int col = c0 + c;
      sV[r * WCOL + c] = krow < T && col < D
          ? flash::to_f32(V[static_cast<size_t>(krow) * D + col]) : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[R], vv[DC];
#pragma unroll
      for (int i = 0; i < R; ++i) pv[i] = sP[(row0 + i) * PS + kk];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = sV[kk * WCOL + cg + 8 * j];
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
    for (int j = 0; j < DC; ++j) {
      const int col = c0 + cg + 8 * j;
      if (col < D)
        O[static_cast<size_t>(qpos) * D + col] =
            flash::from_f32<S>(acc[i][j] / lc);
    }
    if (c0 == 0 && cg == 0)
      p.lse[static_cast<size_t>(bh) * T + qpos] = m[i] + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// head_dim > 128, bf16 / f16: tensor cores, D in chunks
// ---------------------------------------------------------------------------
// flash_fwd_tc_kernel with the head dim cut into chunks of WDC columns.  q
// no longer fits the registers as MMA fragments: its rows lie in shared
// memory and each chunk's A fragments come by ldmatrix.  s = q k^T runs on
// mma.sync chunk by chunk into the same f32 accumulators.  16-bit tiles
// arrive by 16-byte cp.async, zeros past T and past D (element by element
// where D is no multiple of 8, so rows are not 16-byte aligned), in one of
// two layouts:
// - whole (`wide_whole`: up to D = 320, where two blocks share an SM): q's
//   64 rows whole, loaded once, and each K tile's rows whole in two
//   buffers, the next tile arriving while this one is worked;
// - streamed (past that): two buffers of one chunk of q and of K, the next
//   chunk (or the next tile's first) arriving while this one is multiplied.
// In both, each K tile's block of WNC columns of v (the block's own output
// columns) and its mask arrive with its rows (streamed: with its first
// chunk), in two buffers.  The grid's x dimension walks (query tile,
// column block); each column block computes the same scores, softmax
// statistics and dropout bits, ceil(D / WNC) times in all, and only column
// block 0 writes the lse.  The softmax, masks and dropout are those of
// flash_fwd_tc_kernel, applied to the score fragments in registers.
constexpr int WDC = 64;                 // D columns a score chunk sums
constexpr int WNC = 128;                // output columns a block owns
constexpr int WBK = 32;                 // keys per K/V tile
constexpr int WRS = WDC + PAD;          // row stride of a chunk tile
constexpr int WCS = WNC + PAD;          // row stride of a column block
constexpr size_t WIDE_SMEM = 232448 / 2;   // two blocks an SM

// Row stride (elements) of whole rows: D up to whole chunks, zero-filled,
// plus PAD (so that, as WRS, ldmatrix rows hit distinct banks).
__host__ __device__ constexpr int own_stride(int d) {
  return (d + WDC - 1) / WDC * WDC + PAD;
}

// q (whole: 64 rows; streamed: two buffers of a chunk), two buffers of a
// K tile (whole rows or a chunk), two of its v column block, two of its
// mask.
__host__ __device__ constexpr size_t wide_tc_smem(int d, bool whole) {
  return ((whole ? (BQ + 2 * WBK) * own_stride(d) : 2 * (BQ + WBK) * WRS) +
          2 * WBK * WCS) * 2 + 2 * WBK * 4;
}

__host__ __device__ constexpr bool wide_whole(int d) {
  return wide_tc_smem(d, true) <= WIDE_SMEM;
}

// Rows [r0, r0 + ROWS), columns [c0, c0 + NCOLS) of a (T, D) 16-bit slab
// into shared memory at dst (row stride ds elements); zeros past T and D.
// By 16-byte cp.async where the rows are 16-byte aligned (D a multiple of
// 8), else element by element.
template <int ROWS, int NCOLS, typename S>
__device__ __forceinline__ void copy_block(S* dst, int ds, const S* src,
                                           int r0, int T, int c0, int D) {
  constexpr int CPR = NCOLS / 8;   // 16-byte chunks a row
  static_assert(ROWS * CPR % NTHREADS == 0, "block does not split evenly");
  const uint32_t sdst = hopper::smem_u32(dst);
#pragma unroll
  for (int i = 0; i < ROWS * CPR / NTHREADS; ++i) {
    const int c = threadIdx.x + i * NTHREADS;
    const int r = c / CPR;
    const int col = (c % CPR) * 8;
    const int row = r0 + r;
    const int d = c0 + col;
    const size_t at = static_cast<size_t>(row) * D + d;
    if ((D & 7) == 0) {
      const bool ok = row < T && d < D;
      hopper::cp_async16(sdst + (r * ds + col) * 2, src + (ok ? at : 0), ok);
    } else {
      S* to = dst + r * ds + col;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        to[e] = row < T && d + e < D ? src[at + e] : flash::from_f32<S>(0.f);
    }
  }
}

// Grid: (ceil(T / BQ) * ceil(D / WNC), folded B * H).  The fragment layout
// of flash_fwd_tc_kernel: warp w owns query rows [16w, 16w + 16) of the
// tile, which walks K tiles of WBK keys, each in chunks of WDC columns of
// D; output columns c0 + 8n + 2t (n < WNC / 8).
template <typename TR>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_fwd_wide_tc_kernel(const Params p) {
  constexpr int KB = WBK;
  using S = typename TR::T;
  const int D = p.D;
  const bool whole = wide_whole(D);
  const int rs = whole ? own_stride(D) : WRS;   // row stride of q and K
  extern __shared__ __align__(16) unsigned char smem[];
  S* tQ = reinterpret_cast<S*>(smem);       // whole, or two chunk buffers
  S* tK = tQ + (whole ? BQ * rs : 2 * BQ * WRS);   // two buffers
  S* tV = tK + 2 * KB * rs;                 // two buffers of the column block
  int32_t* tMask = reinterpret_cast<int32_t*>(tV + 2 * KB * WCS);

  const int bh = folded_bh();
  if (bh >= p.B * p.H) return;
  const int T = p.T;
  const int n_col = (D + WNC - 1) / WNC;
  const int q0 = static_cast<int>(blockIdx.x) / n_col * BQ;
  const int c0 = static_cast<int>(blockIdx.x) % n_col * WNC;
  const int ncol = min(WNC, D - c0);        // output columns of this block
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  const size_t base = static_cast<size_t>(bh) * T * D;
  const S* Q = static_cast<const S*>(p.q) + base;
  const S* K = static_cast<const S*>(p.k) + base;
  const S* V = static_cast<const S*>(p.v) + base;
  const bool masked = p.mask != nullptr;
  const int32_t* mrow = masked ? p.mask + static_cast<size_t>(b) * T : nullptr;
  const float* brow = p.bias ? p.bias + b * p.bias_sb + h * p.bias_sh
                             : nullptr;
  const flash::SeedKey sk = flash::seed_key(p.seed, p.dropout, bh);
  const float scale2 = p.scale * LOG2E;

  int kmax = T;
  if (p.causal) kmax = min(kmax, q0 + BQ);
  if (p.kend != nullptr) kmax = min(kmax, p.kend[b]);
  const int n_tiles = (kmax + KB - 1) / KB;
  const int n_ch = (D + WDC - 1) / WDC;

  // K tile kt's v column block and mask into buffer kt & 1
  auto stage_v = [&](int kt) {
    copy_block<KB, WNC>(tV + (kt & 1) * KB * WCS, WCS, V, kt * KB, T, c0, D);
    if (masked && threadIdx.x < KB) {
      const int kpos = kt * KB + threadIdx.x;
      hopper::cp_async4(hopper::smem_u32(tMask + (kt & 1) * KB + threadIdx.x),
                        mrow + (kpos < T ? kpos : 0), kpos < T);
    }
  };
  // whole: K tile kt's rows into buffer kt & 1
  auto stage_tile = [&](int kt) {
    for (int ch = 0; ch < n_ch; ++ch)
      copy_block<KB, WDC>(tK + (kt & 1) * KB * rs + ch * WDC, rs, K, kt * KB,
                          T, ch * WDC, D);
    stage_v(kt);
  };
  // streamed: the chunks of step (K tile, chunk) = (step / n_ch, step %
  // n_ch) of q and k into buffer step & 1
  auto stage_step = [&](int step) {
    const int kt = step / n_ch;
    const int dc = step % n_ch * WDC;
    copy_block<BQ, WDC>(tQ + (step & 1) * BQ * WRS, WRS, Q, q0, T, dc, D);
    copy_block<KB, WDC>(tK + (step & 1) * KB * WRS, WRS, K, kt * KB, T, dc,
                        D);
    if (dc == 0) stage_v(kt);
  };
  if (n_tiles > 0) {
    if (whole) {
      for (int ch = 0; ch < n_ch; ++ch)
        copy_block<BQ, WDC>(tQ + ch * WDC, rs, Q, q0, T, ch * WDC, D);
      stage_tile(0);
    } else {
      stage_step(0);
    }
    hopper::cp_async_commit();
  }

  int rows[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) rows[i] = 16 * warp + g + 8 * i;

  // ldmatrix lane addresses: A from (rows x k) storage; B from (n x k)
  // storage; B from (k x n) storage through .trans
  const int a_row = 16 * warp + (lane & 15);
  const int a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) * 8;
  const int t_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int t_col = (lane >> 4) * 8;

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[WNC / 8][4];
#pragma unroll
  for (int n = 0; n < WNC / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * KB;
    const int tb = kt & 1;
    if (whole) {
      if (kt + 1 < n_tiles) {       // prefetch the next K tile
        stage_tile(kt + 1);
        hopper::cp_async_commit();
        hopper::cp_async_wait<1>();
      } else {
        hopper::cp_async_wait<0>();
      }
      __syncthreads();
    }

    float s[KB / 8][4];
#pragma unroll
    for (int n = 0; n < KB / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
    for (int ch = 0; ch < n_ch; ++ch) {
      const int step = kt * n_ch + ch;
      if (!whole) {
        if (step + 1 < n_tiles * n_ch) {   // prefetch the next chunks
          stage_step(step + 1);
          hopper::cp_async_commit();
          hopper::cp_async_wait<1>();
        } else {
          hopper::cp_async_wait<0>();
        }
        __syncthreads();
      }
      const uint32_t sQ = hopper::smem_u32(
          whole ? tQ + ch * WDC : tQ + (step & 1) * BQ * WRS);
      const uint32_t sK = hopper::smem_u32(
          whole ? tK + tb * KB * rs + ch * WDC : tK + (step & 1) * KB * WRS);
#pragma unroll
      for (int ks = 0; ks < WDC / 16; ++ks) {
        uint32_t qa[4];
        hopper::ldsm_x4(qa, sQ + (a_row * rs + ks * 16 + a_col) * 2);
#pragma unroll
        for (int np = 0; np < KB / 16; ++np) {
          uint32_t kb[4];
          hopper::ldsm_x4(kb, sK + ((np * 16 + b_row) * rs + ks * 16 + b_col)
                                       * 2);
          TR::mma(s[2 * np], qa, kb[0], kb[1]);
          TR::mma(s[2 * np + 1], qa, kb[2], kb[3]);
        }
      }
      if (!whole) __syncthreads();   // every warp is done with this buffer
    }

    // the keys of this lane's columns that exist and are valid: bit
    // 2n + j for column 8n + 2t + j
    uint32_t keys = 0u;
#pragma unroll
    for (int n = 0; n < KB / 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = n * 8 + 2 * t4 + j;
        const bool ok = k0 + col < T && (!masked || tMask[tb * KB + col] != 0);
        keys |= static_cast<uint32_t>(ok) << (2 * n + j);
      }
    // as in flash_fwd_tc_kernel: a tile whose keys all exist, are valid and
    // lie at or before every row of the warp (and no bias) takes its max on
    // the raw scores, the scale folded into the exponent's FMA
    const bool raw = brow == nullptr && p.scale > 0.f &&
                     __all_sync(0xffffffffu, keys == (1u << (KB / 4)) - 1u) &&
                     !(p.causal && k0 + KB - 1 > q0 + 16 * warp);
    const float sc_now = raw ? scale2 : 1.f;
    float mc[2] = {NEG_INF, NEG_INF};
    if (raw) {
#pragma unroll
      for (int n = 0; n < KB / 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) mc[c >> 1] = fmaxf(mc[c >> 1], s[n][c]);
    } else {
#pragma unroll
      for (int n = 0; n < KB / 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = c >> 1;
          const int qpos = q0 + rows[i];
          const int kpos = k0 + n * 8 + 2 * t4 + (c & 1);
          float x;
          if (brow != nullptr) {
            const float bv =
                qpos < T && kpos < T
                    ? brow[static_cast<size_t>(qpos) * T + kpos] : 0.f;
            x = __fmul_rn(__fadd_rn(__fmul_rn(s[n][c], p.scale), bv), LOG2E);
          } else {
            x = __fmul_rn(s[n][c], scale2);
          }
          const bool ok = ((keys >> (2 * n + (c & 1))) & 1u) &&
                          !(p.causal && qpos < kpos);
          x = ok ? x : NEG_INF;
          s[n][c] = x;
          mc[i] = fmaxf(mc[i], x);
        }
    }
    float alpha[2], m_exp[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mc[i] = fmaxf(mc[i], __shfl_xor_sync(0xffffffffu, mc[i], 1));
      mc[i] = fmaxf(mc[i], __shfl_xor_sync(0xffffffffu, mc[i], 2));
      const float m_new = fmaxf(m[i], mc[i] * sc_now);
      m_exp[i] = (masked && !(m_new > MASKED_ROW)) ? 0.f : m_new;
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
    // p into s: l sums the undropped p, the PV product sees p * keep
#pragma unroll
    for (int n = 0; n < KB / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c >> 1;
        const float pj = exp2f(fmaf(s[n][c], sc_now, -m_exp[i]));
        rsum[i] += pj;
        float pa = pj;
        if (p.dropout) {
          const uint32_t bits = threefry2x32(
              sk.key0, sk.key1, static_cast<uint32_t>(q0 + rows[i]),
              static_cast<uint32_t>(k0 + n * 8 + 2 * t4 + (c & 1)));
          pa = bits < p.thr ? pj * p.inv_keep : 0.f;
        }
        s[n][c] = pa;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 1);
      rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 2);
      l[i] = l[i] * alpha[i] + rsum[i];
    }
#pragma unroll
    for (int n = 0; n < WNC / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += p v over the block's columns: p meets v in v's type
    const uint32_t sV = hopper::smem_u32(tV + tb * KB * WCS);
#pragma unroll
    for (int kk = 0; kk < KB / 16; ++kk) {
      uint32_t pa[4];
      hopper::to_a_frag<TR>(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n2 = 0; n2 < WNC / 16; ++n2) {
        if (16 * n2 >= ncol) break;
        uint32_t vb[4];
        hopper::ldsm_x4_t(vb, sV + ((kk * 16 + t_row) * WCS + n2 * 16 + t_col)
                                       * 2);
        TR::mma(acc[2 * n2], pa, vb[0], vb[1]);
        TR::mma(acc[2 * n2 + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();   // every warp is done with this tile's buffers
  }
  hopper::cp_async_wait<0>();
  __syncthreads();     // every copy has landed; reuse shared memory for out

  // out = acc / l in the input type, staged in the warp's own rows (row
  // stride WCS), then written 16 bytes a lane where rows are aligned
  S* tO = reinterpret_cast<S*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < WNC / 8; ++n)
      *reinterpret_cast<uint32_t*>(tO + rows[i] * WCS + n * 8 + 2 * t4) =
          TR::pack(acc[n][2 * i] / lc, acc[n][2 * i + 1] / lc);
    const int qpos = q0 + rows[i];
    if (c0 == 0 && t4 == 0 && qpos < T)
      p.lse[static_cast<size_t>(bh) * T + qpos] = m[i] * LN2 + logf(lc);
  }
  __syncwarp();
  S* O = static_cast<S*>(p.out) + base + c0;
  if ((D & 7) == 0) {
    const int cpr = ncol / 8;
    for (int c = lane; c < 16 * cpr; c += 32) {
      const int r = 16 * warp + c / cpr;
      const int col = (c % cpr) * 8;
      const int qpos = q0 + r;
      if (qpos < T)
        *reinterpret_cast<uint4*>(O + static_cast<size_t>(qpos) * D + col) =
            *reinterpret_cast<const uint4*>(tO + r * WCS + col);
    }
  } else {
    for (int c = lane; c < 16 * ncol; c += 32) {
      const int r = 16 * warp + c / ncol;
      const int col = c % ncol;
      const int qpos = q0 + r;
      if (qpos < T) O[static_cast<size_t>(qpos) * D + col] = tO[r * WCS + col];
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
cudaError_t launch_kernel(void (*kernel)(Params), size_t smem, const Params& p,
                          cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<fold_grid((p.T + BQ - 1) / BQ, p.B * p.H), NTHREADS, smem,
           stream>>>(p);
  return cudaGetLastError();
}

template <typename TR>
cudaError_t launch_tc(const Params& p, cudaStream_t stream) {
  if (p.D % 8 != 0) return cudaErrorInvalidValue;
  switch ((p.D + 15) / 16) {
    case 1: return launch_kernel(flash_fwd_tc_kernel<TR, 16>,
                                 tc_smem_bytes<16>(), p, stream);
    case 2: return launch_kernel(flash_fwd_tc_kernel<TR, 32>,
                                 tc_smem_bytes<32>(), p, stream);
    case 3: return launch_kernel(flash_fwd_tc_kernel<TR, 48>,
                                 tc_smem_bytes<48>(), p, stream);
    case 4: return launch_kernel(flash_fwd_tc_kernel<TR, 64>,
                                 tc_smem_bytes<64>(), p, stream);
    case 5: return launch_kernel(flash_fwd_tc_kernel<TR, 80>,
                                 tc_smem_bytes<80>(), p, stream);
    case 6: return launch_kernel(flash_fwd_tc_kernel<TR, 96>,
                                 tc_smem_bytes<96>(), p, stream);
    case 7: return launch_kernel(flash_fwd_tc_kernel<TR, 112>,
                                 tc_smem_bytes<112>(), p, stream);
    case 8: return launch_kernel(flash_fwd_tc_kernel<TR, 128>,
                                 tc_smem_bytes<128>(), p, stream);
  }
  return cudaErrorInvalidValue;
}

cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  switch (p.D) {
    case 16: return launch_kernel(flash_fwd_f32_kernel<16>,
                                  f32_smem_bytes<16>(), p, stream);
    case 32: return launch_kernel(flash_fwd_f32_kernel<32>,
                                  f32_smem_bytes<32>(), p, stream);
    case 64: return launch_kernel(flash_fwd_f32_kernel<64>,
                                  f32_smem_bytes<64>(), p, stream);
    case 128: return launch_kernel(flash_fwd_f32_kernel<128>,
                                   f32_smem_bytes<128>(), p, stream);
  }
  return cudaErrorInvalidValue;
}

// a chunked kernel, each block owning `cols` output columns of a query tile
cudaError_t launch_wide(void (*kernel)(Params), size_t smem, int cols,
                        const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int gx = (p.T + BQ - 1) / BQ * ((p.D + cols - 1) / cols);
  kernel<<<fold_grid(gx, p.B * p.H), NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename TR>
cudaError_t launch_wide_tc(const Params& p, cudaStream_t stream) {
  return launch_wide(flash_fwd_wide_tc_kernel<TR>,
                     wide_tc_smem(p.D, wide_whole(p.D)), WNC, p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  head_dim is the row length
// of q, k, v and out in device memory: 16, 32, 64 or 128 for float32, a
// multiple of 8 up to 128 for the 16-bit types, or any length from 129 to
// MAX_HEAD_DIM (the chunked kernels: bf16 and f16 on the tensor cores, f32
// scalar).  true_dim is the backward's (unused here: the scale comes in
// `scale`).  Every pointer is a device pointer, q, k, v and out 16-byte
// aligned in the 16-bit types; mask, kend and bias may be null,
// and seed (the two threefry words) too without dropout.  Launches on
// `stream` and does not synchronise.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, float* lse,
    const int32_t* mask, const int32_t* kend, const float* bias,
    long long bias_sb, long long bias_sh, int batch, int heads, int seq,
    int head_dim, int true_dim, int dtype, float scale, int causal,
    int dropout, const unsigned int* seed, unsigned int thr, float inv_keep,
    void* stream) {
  (void)true_dim;
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
  p.D = head_dim;
  p.scale = scale;
  p.causal = causal;
  p.dropout = dropout;
  p.seed = seed;
  p.thr = thr;
  p.inv_keep = inv_keep;
  if (head_dim < 1 || head_dim > MAX_HEAD_DIM || batch * heads < 1 ||
      seq < 1 || (dropout && seed == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (head_dim > 128)
    err = dtype == 0   ? launch_wide(flash_fwd_wide_kernel<float>,
                                     wide_smem_bytes(), WCOL, p, st)
          : dtype == 1 ? launch_wide_tc<hopper::Bf16>(p, st)
          : dtype == 2 ? launch_wide_tc<hopper::F16>(p, st)
                       : cudaErrorInvalidValue;
  else if (dtype == 0)
    err = launch_f32(p, st);
  else if (dtype == 1)
    err = launch_tc<hopper::Bf16>(p, st);
  else if (dtype == 2)
    err = launch_tc<hopper::F16>(p, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
