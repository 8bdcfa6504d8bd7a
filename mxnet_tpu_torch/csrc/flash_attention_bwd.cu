// Flash-attention backward for Hopper (sm_90a), CUDA C++: kernels B4 (dq)
// and B5 (dk, dv).
//
// Replace the TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel` of
// mxnet_tpu/ops/pallas_kernels.py (launched by `_flash_backward` through
// `pl.pallas_call`).  They compute the same function, not a block-for-block
// copy.  Inputs: q, k, v, dO, out (B, H, T, D) in f32, bf16 or f16 (D of
// 16, 32, 64 or 128: the wrapper zero-pads other head dims up to 128, which
// adds exact zeros to every product, sum and row norm; any D past 128 as
// it is, through the chunked kernels at the end of this file); the forward's
// lse (B, H, T) f32 and, for `flash_attention_with_lse`, its cotangent dlse.
// Both kernels recompute the probabilities from the saved lse instead of
// storing them:
//
//   delta = rowsum(dO * out) - dlse               (B4, written for B5)
//   s  = q k^T * scale (+ bias), then causal / key-padding fill -1e30
//   p  = exp(s - lse)          (lse anchored at 0 where lse <= -1e29, so a
//                               row with no valid key has p = 0, not NaN)
//   dp = (dO v^T) * keep       (keep: the dropout keep/rescale factor)
//   ds = p * (dp - delta) * scale
//   dq = ds @ k                               (B4, q-major)
//   dv = (p * keep)^T @ dO,  dk = ds^T @ q    (B5, k-major)
//
// ds is rounded to the input type before it meets k or q, and p * keep to
// dO's type before it meets dO, as the reference rounds them; the products
// accumulate in f32 and dq, dk, dv are stored in the input type.
//
// The dropout bits are drawn once per backward.  B4, launched first, draws
// them from the threefry2x32 device function the forward uses
// (flash_attention_common.cuh), keyed by (seed, batch*head) with global
// (q_pos, k_pos) counters, and writes them packed: uint32 words (B, H, T,
// ceil(T/32)), bit j of word w in row q = keep(q, 32w + j), the first plane
// of a (2, B, H, T, ceil(T/32)) buffer whose second plane marks the pairs
// whose rounding is derived again (below).  B5 reads both instead of running
// threefry.  Pairs where p is exactly 0 (a padding key, a
// causally hidden pair, a key past T) are not drawn: their bit is 0, and ds
// and p * keep are 0 there whatever it is.  Words of tiles B4 skips are not
// written; B5 skips the same pairs.
//
// Work skipped, as in the reference: B4 stops its K loop at the causal
// diagonal and at the batch row's `kend` (1 + its last valid key); B5 starts
// its Q loop at the diagonal and runs no Q tile at all for a K tile at or
// past `kend`.  Every dk/dv row is still written: rows of a skipped K tile
// get exact zeros, as the reference's `_finish` writes its zero accumulator.
//
// What bounds it.  At the BERT training path's shape (B=32, H=12, T=128,
// D=64, bf16, about 3/4 of the keys valid, dropout 0.1) B4 moves ~25 MB and
// B5 ~31 MB (7.5-9 us at 3.35 TB/s); their products, 3 and 4 of 2*D flops
// per live pair, are ~2-3 us on the bf16 tensor cores.  Neither sets the
// pace: the work per score element does.  Threefry2x32 is ~70 integer
// instructions a pair (B4 draws ~5 M), and every element is recomputed from
// the saved lse, masked, tested against its rounding tie (below) and
// rounded, in both kernels; a block runs two tile steps at T = 128.
// chip_smoke.py times both against their bound; PERF.md keeps the numbers.
//
// What the design does about it.
// - bf16 and f16 (one kernel each, templated on a traits struct of
//   hopper_mma.cuh: the MMA, packing and the type's rounding tie): the
//   products run on the tensor cores, mma.sync m16n8k16 (16-bit in, f32
//   accumulate), fed by ldmatrix from 16-bit tiles kept in shared memory
//   in their row-major (T, D) layout: s = q k^T and dp = dO v^T (B4), and
//   st = k q^T and dpt = v dO^T (B5), take k, v, q, dO as the "col" operand
//   straight from their rows; dq = ds k, dv = (p keep)^T dO and dk = ds^T q
//   take k, dO and q through ldmatrix.trans.  ds and p * keep are rounded to
//   the input type in registers, straight from the accumulator fragments,
//   and feed the next product as its A operand without a trip through
//   shared memory.
//   Rows are padded by 8 elements (16 bytes) so an ldmatrix hits distinct
//   banks.  Four warps own a 64-row tile, 16 rows each.  Tiles arrive by
//   16-byte cp.async, and the next K/V tile (B4) or Q/dO tile (B5) is
//   prefetched into a second buffer while the current one is computed.  The
//   MMA rate is not what bounds it, so wgmma and TMA are not used.  From
//   D = 64 on, B4 takes 32-key and B5 32-query tiles, so that the
//   accumulators and the score fragments leave room for three blocks an SM.
// - The rounding points decide single 16-bit values, so where s or dp comes
//   out of the tensor cores a few f32 ulps away from a sequential f32 sum,
//   ds or p * keep can round to the neighbouring value: one such term of
//   0.1-1 moves a gradient by a few 1e-3, past chip_smoke.py's allowance
//   against the plain version (BWD_TOL), which holds for an order of sums
//   that matches the plain version's at the rounding points.  Each element
//   whose f32 ds (or p * keep) lies within an error bound of a rounding tie
//   of the type (bf16: low 16 bits 0x8000; f16: half an ulp of the value's
//   own f16 ulp, fixed at 2^-24 below 2^-14) (bound: 6 * 2^-24 |q| |k| for s and |dO| |v| for dp, row
//   norms taken from the tiles; chip_smoke.py measures the tensor cores'
//   error against it) is derived again, with s and dp as sequential f32
//   FMAs over d, in the plain version's order, and that value is rounded
//   instead.  About 2 % of the elements are, through a per-warp queue in
//   shared memory that all 32 lanes work off together.  B4 decides for both
//   kernels, with twice the bound, and writes its decisions as packed words
//   beside the keep bits; B5 reads them.  For the same reason B4 sums delta
//   in the order of torch's CUDA sum over the last dim, which the plain
//   version's delta takes.
// - The dropout bits are drawn once (B4) and read as packed words (B5), and
//   delta is a row sum inside B4, not torch passes over f32 copies.
// - f32 stays true f32 (no TF32): its kernels keep scalar f32 FMAs on the
//   CUDA cores, with 4 x 8 register tiles, f32 tiles in shared memory (rows
//   padded by one float), and the same delta and keep-word contract.
// - No atomics: dq is q-major, dk and dv k-major, so results repeat bitwise.
// - batch*heads is folded over the grid's y and z dimensions, so it may
//   exceed the 65535 one dimension takes.
// - Head dims past 128 take chunked kernels, which take the rows as they
//   are (no padding).  bf16 and f16 (flash_bwd_dq_wide_tc_kernel,
//   flash_bwd_dkv_wide_tc_kernel): the tensor-core kernels above with s
//   and dp summed on mma.sync over D in chunks of 64, 16-key (B4) and
//   16-query (B5) tiles, and each block owning 128 columns of dq (or of dk
//   and dv) in register accumulators, so that it recomputes s, dp, p and
//   ds on the tensor cores, ceil(D / 128) times in all.  Up to D = 256
//   the tiles' rows lie whole in shared memory (the block's own 64 rows
//   once, the other side's tiles double-buffered), past that one chunk of
//   each at a time; the rounding points as above, with the row norms
//   summed over the chunks, the bound scaled for the chain over D, and the
//   marked pairs derived again from the whole rows (in shared memory, else
//   in device memory).  Neither bytes nor products set the pace (at (4, 8,
//   512, 256) B4's bound is ~10 us): the per-element work and the
//   sequential chains of the pairs derived again do (PERF.md).  f32
//   (flash_bwd_dq_wide_kernel, flash_bwd_dkv_wide_kernel): scalar f32
//   FMAs, s and dp summed in chunks of 32 through shared memory, 64 result
//   columns a block.  In both, B4's column block 0 alone writes delta
//   (summed in the order of torch's vectorized row sum, `torch_row_sum`)
//   and the words.
// - The dropout seed words are read from device memory (`seed`), so that a
//   captured CUDA graph draws the words its replay was given.

#include "flash_attention_common.cuh"
#include "hopper_mma.cuh"

namespace {

using flash::MASKED_ROW;
using flash::MAX_HEAD_DIM;
using flash::NEG_INF;
using flash::fold_grid;
using flash::folded_bh;
using flash::threefry2x32;
using flash::to_f32;

constexpr int BQ = 64;          // query rows per B4 tile
constexpr int BK = 64;          // keys per tile
constexpr int NTHREADS = 128;   // 4 warps x 16 rows of the block's own tile
constexpr int R = 4;            // f32 kernels: tile rows per thread
constexpr int C = 8;            // f32 kernels: columns per thread, cg + 8 * j
constexpr int PAD = 8;          // 16-bit kernels: elements of padding per row

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const void* out;       // B4: the forward's output, for delta
  const float* lse;      // (B, H, T) from the forward
  const float* dlse;     // B4: (B, H, T) lse cotangent, or null
  float* delta;          // (B, H, T) rowsum(dO * out) - dlse: B4 writes
  uint32_t* keep;        // (2, B, H, T, W) words: B4 writes, B5 reads
                         // [0] the dropout keep bits, [1] (bf16 / f16) the
                         // pairs whose rounding is derived again
  unsigned long long* stats;   // 16-bit: += elements derived again, or null
  void* dq;
  void* dk;
  void* dv;
  const int32_t* mask;   // (B, T) 0/1, or null
  const int32_t* kend;   // (B,) 1 + last valid key, or null (with mask)
  const float* bias;     // element (b, h, i, j) at b*bias_sb + h*bias_sh + i*T + j
  long long bias_sb;
  long long bias_sh;
  int B, H, T;
  int W;                 // keep words per query row, ceil(T / 32)
  int Dt;                // the head dim before zero-padding to D (delta's)
  float scale;
  int causal;
  int dropout;
  const uint32_t* seed;  // the two threefry seed words (device memory)
  uint32_t thr;
  float inv_keep;
  // head dims past 128 (the chunked kernels): the lanes of torch's CUDA row
  // sum that B4 follows for delta, bw along the row and by across warps
  int sum_bw, sum_by;
};

// delta = rowsum(dO * out) - dlse of the block's query rows [q0, q0 + 64),
// into sDel (zeros past T) and p.delta, two threads a row.  Summed in the
// order of torch's CUDA sum over a contiguous last dim of D values (ATen's
// Reduce.cuh): each of min(D, 32) lanes adds its elements in turn (D < 128:
// i, i + 32, ...; D = 128: its 4-vector 4i .. 4i + 3), then a shuffle-down
// tree over the lanes; each product is rounded on its own.  So delta equals
// the plain version's `(dout.float() * out.float()).sum(-1)` bit for bit,
// and ds meets its rounding point with the plain version's operands.
// Rows zero-padded from head dim Dt < D take `block_delta_padded`.
template <typename S, int D>
__device__ __forceinline__ void block_delta_padded(const Params& p, int bh,
                                                   int q0, float* sDel);

template <typename S, int D>
__device__ __forceinline__ void block_delta(const Params& p, int bh, int q0,
                                            float* sDel) {
  if (p.Dt != D) {
    block_delta_padded<S, D>(p, bh, q0, sDel);
    return;
  }
  constexpr int BW = D < 32 ? D : 32;   // lanes of torch's block row
  constexpr int PER = D / BW;           // elements a lane adds
  constexpr int HALF = BW / 2;          // lanes this thread stands for
  // the thread's elements lie in PER runs of HALF (D < 128) or in one run
  // of D / 2 (D = 128), each 16-byte aligned
  constexpr int RUN = D >= 128 ? D / 2 : HALF;
  constexpr int NRUN = D / 2 / RUN;
  constexpr int V = 16 / sizeof(S);
  const int r = threadIdx.x >> 1;
  const int h = threadIdx.x & 1;
  const int qpos = q0 + r;
  const size_t row = static_cast<size_t>(bh) * p.T + (qpos < p.T ? qpos : 0);
  const S* a = static_cast<const S*>(p.dout) + row * D;
  const S* b = static_cast<const S*>(p.out) + row * D;
  uint4 ra[D / 2 / V], rb[D / 2 / V];
#pragma unroll
  for (int k = 0; k < NRUN; ++k) {
    const int start = D >= 128 ? h * RUN : h * HALF + BW * k;
#pragma unroll
    for (int c = 0; c < RUN / V; ++c) {
      ra[k * RUN / V + c] = *reinterpret_cast<const uint4*>(a + start + c * V);
      rb[k * RUN / V + c] = *reinterpret_cast<const uint4*>(b + start + c * V);
    }
  }
  const S* xa = reinterpret_cast<const S*>(ra);
  const S* xb = reinterpret_cast<const S*>(rb);
  float v[HALF];
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      // element lane + BW j (D < 128) or PER lane + j (D = 128), lane =
      // h HALF + i, as held in xa / xb
      const int at = D >= 128 ? PER * i + j : RUN * j + i;
      const float x = __fmul_rn(to_f32(xa[at]), to_f32(xb[at]));
      v[i] = j == 0 ? x : __fadd_rn(v[i], x);
    }
  }
  // the tree's first level pairs lane i with lane i + HALF: the partner
  // thread's v[i]
#pragma unroll
  for (int i = 0; i < HALF; ++i)
    v[i] = __fadd_rn(v[i], __shfl_xor_sync(0xffffffffu, v[i], 1));
#pragma unroll
  for (int o = HALF / 2; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < o; ++i) v[i] = __fadd_rn(v[i], v[i + o]);
  if (h == 0) {
    float d = 0.f;
    if (qpos < p.T) {
      d = p.dlse != nullptr ? __fsub_rn(v[0], p.dlse[row]) : v[0];
      p.delta[row] = d;
    }
    sDel[r] = d;
  }
}

// delta where the rows are zero-padded from head dim Dt (< 128) to D: torch
// sums the unpadded rows, so its lanes follow Dt.  With fewer than 128
// elements it does not vectorize: min(last_pow2(Dt), 32) lanes, lane i
// adding elements i, i + lanes, ... < Dt in turn, then the same tree.  Two
// threads a row, each standing for half the lanes; element by element (this
// runs only for head dims the kernels do not take natively).
template <typename S, int D>
__device__ __forceinline__ void block_delta_padded(const Params& p, int bh,
                                                   int q0, float* sDel) {
  const int dt = p.Dt;
  int bw = 1;
  while (2 * bw <= dt && bw < 32) bw *= 2;
  const int half = bw >> 1;
  const int r = threadIdx.x >> 1;
  const int h = threadIdx.x & 1;
  const int qpos = q0 + r;
  const size_t row = static_cast<size_t>(bh) * p.T + (qpos < p.T ? qpos : 0);
  const S* a = static_cast<const S*>(p.dout) + row * D;
  const S* b = static_cast<const S*>(p.out) + row * D;
  // lanes [first, first + nl) are this thread's
  const int nl = bw >= 2 ? half : (h == 0 ? 1 : 0);
  const int first = h * half;
  float v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    v[i] = 0.f;
    if (i < nl) {
      const int lane = first + i;
      float acc = __fmul_rn(to_f32(a[lane]), to_f32(b[lane]));
      for (int j = lane + bw; j < dt; j += bw)
        acc = __fadd_rn(acc, __fmul_rn(to_f32(a[j]), to_f32(b[j])));
      v[i] = acc;
    }
  }
  if (bw >= 2) {
    // the tree's first level pairs lane i with lane i + half: the partner
    // thread's v[i]; then offsets half / 2, ..., 1 inside the thread
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float o = __shfl_xor_sync(0xffffffffu, v[i], 1);
      if (i < half) v[i] = __fadd_rn(v[i], o);
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      if (o < half)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (i < o) v[i] = __fadd_rn(v[i], v[i + o]);
  }
  if (h == 0) {
    float d = 0.f;
    if (qpos < p.T) {
      d = p.dlse != nullptr ? __fsub_rn(v[0], p.dlse[row]) : v[0];
      p.delta[row] = d;
    }
    sDel[r] = d;
  }
}

// The keep bit of pair (q_pos, k_pos), drawn as the forward draws it.
__device__ __forceinline__ bool draw_keep(const Params& p,
                                          const flash::SeedKey& sk,
                                          int q_pos, int k_pos) {
  return threefry2x32(sk.key0, sk.key1, static_cast<uint32_t>(q_pos),
                      static_cast<uint32_t>(k_pos)) < p.thr;
}

__device__ __forceinline__ size_t keep_at(const Params& p, int bh, int q_pos,
                                          int word) {
  return (static_cast<size_t>(bh) * p.T + q_pos) * p.W + word;
}

// The same word in the plane of pairs to derive again.
__device__ __forceinline__ size_t redo_at(const Params& p, int bh, int q_pos,
                                          int word) {
  return static_cast<size_t>(p.B) * p.H * p.T * p.W +
         keep_at(p, bh, q_pos, word);
}

// ---------------------------------------------------------------------------
// bf16 / f16: tensor cores (helpers and type traits in hopper_mma.cuh)
// ---------------------------------------------------------------------------
using hopper::cp_async4;
using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::ldsm_x4;
using hopper::ldsm_x4_t;
using hopper::smem_u32;
using hopper::to_a_frag;

// Rows [r0, r0 + ROWS) of a (T, D) 16-bit slab into shared memory at dst
// (row stride D + PAD elements) by 16-byte cp.async; rows at or past T are
// zeros.
template <int D, int ROWS, typename S>
__device__ __forceinline__ void copy_tile(uint32_t dst, const S* src, int r0,
                                          int T) {
  constexpr int CPR = D / 8;   // 16-byte chunks a row
  static_assert(ROWS * CPR % NTHREADS == 0, "tile does not split evenly");
#pragma unroll
  for (int i = 0; i < ROWS * CPR / NTHREADS; ++i) {
    const int c = threadIdx.x + i * NTHREADS;
    const int r = c / CPR;
    const int col = (c % CPR) * 8;
    const int row = r0 + r;
    const bool ok = row < T;
    cp_async16(dst + (r * (D + PAD) + col) * 2,
               src + static_cast<size_t>(ok ? row : 0) * D + col, ok);
  }
}

// Euclidean norms of the ROWS rows of two 16-bit tiles in shared memory, two
// threads a row (for the error bound of the products over them).
template <typename TR, int D, int ROWS>
__device__ __forceinline__ void tile_norms(const typename TR::T* a,
                                           const typename TR::T* b, float* na,
                                           float* nb) {
  static_assert(2 * ROWS <= NTHREADS, "two threads a row");
  const int r = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  float sa = 0.f, sb = 0.f;
  if (r < ROWS) {
#pragma unroll
    for (int d = half * D / 2; d < (half + 1) * D / 2; d += 2) {
      const float2 x = TR::unpack(
          *reinterpret_cast<const uint32_t*>(a + r * (D + PAD) + d));
      const float2 y = TR::unpack(
          *reinterpret_cast<const uint32_t*>(b + r * (D + PAD) + d));
      sa += x.x * x.x + x.y * x.y;
      sb += y.x * y.x + y.y * y.y;
    }
  }
  sa += __shfl_xor_sync(0xffffffffu, sa, 1);
  sb += __shfl_xor_sync(0xffffffffu, sb, 1);
  if (r < ROWS && half == 0) {
    na[r] = sqrtf(sa);
    nb[r] = sqrtf(sb);
  }
}

// sum_d a[d] * b[d] as sequential f32 FMAs in d order from 0, as the plain
// version's f32 matmul sums: the value the rounding points must see.
template <typename TR, int D>
__device__ __forceinline__ float seq_dot(const typename TR::T* a,
                                         const typename TR::T* b) {
  float acc = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 8) {
    const uint4 x = *reinterpret_cast<const uint4*>(a + d);
    const uint4 y = *reinterpret_cast<const uint4*>(b + d);
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
    const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float2 xv = TR::unpack(xs[w]);
      const float2 yv = TR::unpack(ys[w]);
      acc = __fmaf_rn(xv.x, yv.x, acc);
      acc = __fmaf_rn(xv.y, yv.y, acc);
    }
  }
  return acc;
}

// Bound on |s (tensor cores) - s (sequential FMAs)| per unit of |a| |b|:
// both sums of D exact bf16 products err by a few f32 ulps of the
// products' magnitude, and sum_d |a_d b_d| <= |a| |b|
// (chip_smoke.py phase 1b measures it on the card)
constexpr float SUM_ERR = 6 * 5.9604645e-8f;   // 6 * 2^-24

// Queue entry of an element to derive again: row within the warp's 16, column
// within the tile, its keep bit.
__device__ __forceinline__ uint32_t entry(int row, int col, bool kept) {
  return static_cast<uint32_t>(col) | (static_cast<uint32_t>(row) << 7) |
         (static_cast<uint32_t>(kept) << 11);
}

// Put the elements flagged in `risk` (bit e = slot e of this lane) into the
// warp's queue, in slot order; returns the count.  slot_entry(e) is the
// lane's entry for slot e.  Slots no lane flagged cost a test.
template <int NSLOT, typename F>
__device__ __forceinline__ int enqueue(uint32_t risk, uint32_t* queue,
                                       F slot_entry) {
  const uint32_t lane_lt = (1u << (threadIdx.x & 31)) - 1u;
  const uint32_t any = __reduce_or_sync(0xffffffffu, risk);
  int total = 0;
#pragma unroll
  for (int e = 0; e < NSLOT; ++e) {
    if (!((any >> e) & 1u)) continue;
    const bool rk = (risk >> e) & 1u;
    const uint32_t bal = __ballot_sync(0xffffffffu, rk);
    if (rk) queue[total + __popc(bal & lane_lt)] = slot_entry(e);
    total += __popc(bal);
  }
  return total;
}

// The queue's results back to the lanes that flagged them, in the same
// order: take(e, result) for each flagged slot e.
template <int NSLOT, typename F>
__device__ __forceinline__ void dequeue(uint32_t risk, const uint32_t* queue,
                                        F take) {
  const uint32_t lane_lt = (1u << (threadIdx.x & 31)) - 1u;
  const uint32_t any = __reduce_or_sync(0xffffffffu, risk);
  int total = 0;
#pragma unroll
  for (int e = 0; e < NSLOT; ++e) {
    if (!((any >> e) & 1u)) continue;
    const bool rk = (risk >> e) & 1u;
    const uint32_t bal = __ballot_sync(0xffffffffu, rk);
    if (rk) take(e, queue[total + __popc(bal & lane_lt)]);
    total += __popc(bal);
  }
}

// keys per B4 tile: narrower from D = 64 on, so that the score fragments
// and the dq accumulators leave room for three blocks an SM
template <int D>
__host__ __device__ constexpr int dq_bk() {
  return D >= 64 ? 32 : 64;
}

template <int D>
constexpr size_t dq_tc_smem_bytes() {
  // q, dO, two K and two V tiles; lse, delta, q and dO norms; two buffers of
  // K and V norms; the queue, 16 x KB entries a warp
  return (2 * 64 + 4 * dq_bk<D>()) * (D + PAD) * 2 + 4 * 64 * 4 +
         4 * dq_bk<D>() * 4 + 4 * 16 * dq_bk<D>() * 4;
}

// queries per B5 tile: narrower from D = 64 on, where the dk and dv
// accumulators take 64 or more registers and the scores must leave room
// for three blocks an SM
template <int D>
__host__ __device__ constexpr int dkv_bn() {
  return D >= 64 ? 32 : 64;
}

template <int D>
constexpr size_t dkv_tc_smem_bytes() {
  // K and V tiles; two buffers of q and dO tiles, lse, delta, keep words
  // and the words of pairs to derive again; the queue, 16 x BN entries a
  // warp
  return (2 * 64 + 4 * dkv_bn<D>()) * (D + PAD) * 2 +
         2 * dkv_bn<D>() * 24 + 4 * 16 * dkv_bn<D>() * 4;
}

// B4, bf16 / f16.  Grid: (ceil(T / BQ), folded B * H).  Warp w owns query rows
// [16w, 16w + 16) of the tile, which walks K tiles of KB keys; lane = 4g + t
// holds rows 16w + g and 16w + g + 8, score columns 8n + 2t, 8n + 2t + 1 of
// each 8-key block n and dq columns likewise of each 8-wide block of D.
template <typename TR, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_tc_kernel(const Params p) {
  constexpr int KB = dq_bk<D>();
  constexpr int NSLOT = KB / 2;     // score elements a lane holds
  constexpr int RS = D + PAD;
  constexpr uint32_t TILE_BYTES = KB * RS * 2;
  using S = typename TR::T;
  extern __shared__ __align__(16) unsigned char smem[];
  S* tQ = reinterpret_cast<S*>(smem);
  S* tDO = tQ + 64 * RS;
  S* tK = tDO + 64 * RS;                    // two buffers
  S* tV = tK + 2 * KB * RS;                 // two buffers
  float* sLse = reinterpret_cast<float*>(tV + 2 * KB * RS);
  float* sDel = sLse + 64;
  float* sQn = sDel + 64;
  float* sOn = sQn + 64;
  float* sKn = sOn + 64;                       // two buffers
  float* sVn = sKn + 2 * KB;                   // two buffers
  uint32_t* sQueue = reinterpret_cast<uint32_t*>(sVn + 2 * KB);
  const uint32_t sQ = smem_u32(tQ);
  const uint32_t sDO = smem_u32(tDO);
  const uint32_t sK = smem_u32(tK);
  const uint32_t sV = smem_u32(tV);

  const int T = p.T;
  const int q0 = blockIdx.x * BQ;
  const int bh = folded_bh();
  if (bh >= p.B * p.H) return;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  uint32_t* queue = sQueue + warp * 16 * KB;

  const size_t base = static_cast<size_t>(bh) * T * D;
  const S* K = static_cast<const S*>(p.k) + base;
  const S* V = static_cast<const S*>(p.v) + base;
  const bool masked = p.mask != nullptr;
  const int32_t* mrow = masked ? p.mask + static_cast<size_t>(b) * T : nullptr;
  const float* brow = p.bias ? p.bias + b * p.bias_sb + h * p.bias_sh
                             : nullptr;
  const flash::SeedKey sk = flash::seed_key(p.seed, p.dropout, bh);

  int kmax = T;
  if (p.causal) kmax = min(kmax, q0 + BQ);
  if (p.kend != nullptr) kmax = min(kmax, p.kend[b]);
  const int n_tiles = (kmax + KB - 1) / KB;

  copy_tile<D, 64>(sQ, static_cast<const S*>(p.q) + base, q0, T);
  copy_tile<D, 64>(sDO, static_cast<const S*>(p.dout) + base, q0, T);
  if (n_tiles > 0) {
    copy_tile<D, KB>(sK, K, 0, T);
    copy_tile<D, KB>(sV, V, 0, T);
  }
  cp_async_commit();
  if (threadIdx.x < 64) {
    const int qpos = q0 + threadIdx.x;
    const size_t at = static_cast<size_t>(bh) * T + qpos;
    float l = qpos < T ? p.lse[at] : 0.f;
    if (masked && !(l > MASKED_ROW)) l = 0.f;
    sLse[threadIdx.x] = l;
  }
  block_delta<S, D>(p, bh, q0, sDel);   // while the tiles arrive

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

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * KB;
    const int nb = kt & 1;
    const uint32_t buf = nb * TILE_BYTES;
    if (kt + 1 < n_tiles) {       // prefetch the next K/V tile
      copy_tile<D, KB>(sK + (TILE_BYTES - buf), K, k0 + KB, T);
      copy_tile<D, KB>(sV + (TILE_BYTES - buf), V, k0 + KB, T);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const S* cK = tK + nb * KB * RS;
    const S* cV = tV + nb * KB * RS;
    if (kt == 0) tile_norms<TR, D, 64>(tQ, tDO, sQn, sOn);
    tile_norms<TR, D, KB>(cK, cV, sKn + nb * KB, sVn + nb * KB);
    __syncthreads();

    float s[KB / 8][4], dp[KB / 8][4];
#pragma unroll
    for (int n = 0; n < KB / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t qa[4], oa[4];
      ldsm_x4(qa, sQ + (a_row * RS + ks * 16 + a_col) * 2);
      ldsm_x4(oa, sDO + (a_row * RS + ks * 16 + a_col) * 2);
#pragma unroll
      for (int np = 0; np < KB / 16; ++np) {
        const uint32_t off = ((np * 16 + b_row) * RS + ks * 16 + b_col) * 2;
        uint32_t kb[4], vb[4];
        ldsm_x4(kb, sK + buf + off);
        ldsm_x4(vb, sV + buf + off);
        TR::mma(s[2 * np], qa, kb[0], kb[1]);
        TR::mma(s[2 * np + 1], qa, kb[2], kb[3]);
        TR::mma(dp[2 * np], oa, vb[0], vb[1]);
        TR::mma(dp[2 * np + 1], oa, vb[2], vb[3]);
      }
    }

    // ds into s; the keep bits and the pairs to derive again of this tile
    // (words[i][w], redo[i][w] hold keys [32w, 32w + 32) of row i); the
    // same for this lane's slots (risk, kept_bits), bit 4n + c for (n, c).
    // A pair is derived again when its ds (B4, B5) or its p * keep (B5)
    // lies near a rounding tie, by twice the bound of one kernel: B5 then
    // reads the decision and rounds its own sums, equally near the plain
    // version's, as settled wherever B4 did.
    uint32_t words[2][KB / 32] = {}, redo[2][KB / 32] = {};
    uint32_t risk = 0u, kept_bits = 0u;
#pragma unroll
    for (int n = 0; n < KB / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c >> 1;
        const int qpos = q0 + rows[i];
        const int kcol = n * 8 + 2 * t4 + (c & 1);
        const int kpos = k0 + kcol;
        float x = __fmul_rn(s[n][c], p.scale);
        bool live = false;
        if (kpos >= T) {
          x = NEG_INF;   // ragged last tile: the key does not exist
        } else {
          if (brow != nullptr && qpos < T)
            x = __fadd_rn(x, brow[static_cast<size_t>(qpos) * T + kpos]);
          if ((p.causal && qpos < kpos) || (masked && mrow[kpos] == 0))
            x = NEG_INF;
          else
            live = qpos < T;
        }
        const float pj = expf(x - sLse[rows[i]]);
        float dpj = dp[n][c];
        float ksf = 1.f;
        if (p.dropout) {
          const bool kept = live && draw_keep(p, sk, qpos, kpos);
          ksf = kept ? p.inv_keep : 0.f;
          dpj = __fmul_rn(dpj, ksf);
          words[i][n >> 2] |= static_cast<uint32_t>(kept) << (kcol & 31);
          kept_bits |= static_cast<uint32_t>(kept) << (4 * n + c);
        }
        const float ds = pj * (dpj - sDel[rows[i]]) * p.scale;
        const float pk = p.dropout ? __fmul_rn(pj, ksf) : pj;
        if (live) {
          const float ex = 2 * SUM_ERR * sQn[rows[i]] *
                               sKn[nb * KB + kcol] * p.scale +
                           fabsf(x) * 2.4e-7f;
          const float edp = 2 * SUM_ERR * sOn[rows[i]] *
                                sVn[nb * KB + kcol] * ksf +
                            fabsf(dpj) * 2.4e-7f;
          if (TR::near_tie(ds, 1.01f * ex * fabsf(ds) + pj * p.scale * edp) ||
              TR::near_tie(pk, 1.01f * ex * fabsf(pk))) {
            risk |= 1u << (4 * n + c);
            redo[i][n >> 2] |= 1u << (kcol & 31);
          }
        }
        s[n][c] = ds;   // rounded below
      }

    // ds again, in the plain version's order, where its rounding is in doubt
    const int total = enqueue<NSLOT>(risk, queue, [&](int e) {
      const int n = e >> 2, c = e & 3;
      return entry(g + 8 * (c >> 1), n * 8 + 2 * t4 + (c & 1),
                   (kept_bits >> e) & 1u);
    });
    if (total > 0) {
      if (p.stats != nullptr && lane == 0)
        atomicAdd(p.stats, static_cast<unsigned long long>(total));
      __syncwarp();
      for (int j = lane; j < total; j += 32) {
        const uint32_t en = queue[j];
        const int row = 16 * warp + ((en >> 7) & 15);
        const int kcol = en & 127;
        const int qpos = q0 + row;
        const int kpos = k0 + kcol;
        const float sv = seq_dot<TR, D>(tQ + row * RS, cK + kcol * RS);
        float dpv = seq_dot<TR, D>(tDO + row * RS, cV + kcol * RS);
        float x = __fmul_rn(sv, p.scale);
        if (brow != nullptr)
          x = __fadd_rn(x, brow[static_cast<size_t>(qpos) * T + kpos]);
        const float pj = expf(__fsub_rn(x, sLse[row]));
        if (p.dropout)
          dpv = __fmul_rn(dpv, (en >> 11) & 1u ? p.inv_keep : 0.f);
        queue[j] = TR::bits(__fmul_rn(
            __fmul_rn(pj, __fsub_rn(dpv, sDel[row])), p.scale));
      }
      __syncwarp();
      dequeue<NSLOT>(risk, queue, [&](int e, uint32_t r) {
        s[e >> 2][e & 3] = TR::value(r);
      });
    }

    {
      // gather each word from the four lanes of its row; lane t writes
      // word t of the lane group's 2 * KB / 32 words, row-major
      constexpr int NW = KB / 32;
      uint32_t word = 0u, rword = 0u;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          if (p.dropout) {
            words[i][w] |= __shfl_xor_sync(0xffffffffu, words[i][w], 1);
            words[i][w] |= __shfl_xor_sync(0xffffffffu, words[i][w], 2);
          }
          redo[i][w] |= __shfl_xor_sync(0xffffffffu, redo[i][w], 1);
          redo[i][w] |= __shfl_xor_sync(0xffffffffu, redo[i][w], 2);
          if (t4 == i * NW + w) {
            word = words[i][w];
            rword = redo[i][w];
          }
        }
      const int i = t4 / NW;
      const int qpos = q0 + rows[i < 2 ? i : 1];
      const int widx = (k0 >> 5) + t4 % NW;
      if (i < 2 && qpos < T && widx < p.W) {
        if (p.dropout) p.keep[keep_at(p, bh, qpos, widx)] = word;
        p.keep[redo_at(p, bh, qpos, widx)] = rword;
      }
    }

    // dq += ds k: ds meets k in k's type (the reference casts ds to k.dtype)
#pragma unroll
    for (int kk = 0; kk < KB / 16; ++kk) {
      uint32_t da[4];
      to_a_frag<TR>(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t kb[4];
        ldsm_x4_t(kb, sK + buf + ((kk * 16 + t_row) * RS + n2 * 16 + t_col) * 2);
        TR::mma(acc[2 * n2], da, kb[0], kb[1]);
        TR::mma(acc[2 * n2 + 1], da, kb[2], kb[3]);
      }
    }
    __syncthreads();   // every warp is done with this buffer
  }
  cp_async_wait<0>();

  S* DQ = static_cast<S*>(p.dq) + base;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = q0 + rows[i];
    if (qpos >= T) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(DQ + static_cast<size_t>(qpos) * D + n * 8 +
                                   2 * t4) =
          TR::pack(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

// B5, bf16 / f16.  Grid: (ceil(T / BK), folded B * H).  The same fragment layout in
// transposed (k-major) score space: warp w owns key rows [16w, 16w + 16) of
// the tile, each Q tile is BN queries wide.
template <typename TR, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_tc_kernel(const Params p) {
  constexpr int BN = dkv_bn<D>();
  constexpr int NSLOT = BN / 2;     // score elements a lane holds
  constexpr int RS = D + PAD;
  constexpr uint32_t KTILE = 64 * RS * 2;
  constexpr uint32_t QTILE = BN * RS * 2;
  using S = typename TR::T;
  extern __shared__ __align__(16) unsigned char smem[];
  S* tK = reinterpret_cast<S*>(smem);
  S* tV = tK + 64 * RS;
  S* tQ = tV + 64 * RS;                     // two buffers
  S* tDO = tQ + 2 * BN * RS;                // two buffers
  float* sLse = reinterpret_cast<float*>(tDO + 2 * BN * RS);   // two buffers
  float* sDel = sLse + 2 * BN;                                 // each, from
  uint32_t* sKeep = reinterpret_cast<uint32_t*>(sDel + 2 * BN);   // here:
  uint32_t* sRedo = sKeep + 4 * BN;            // [2][BN][2] words each
  uint32_t* sQueue = sRedo + 4 * BN;
  const uint32_t sK = smem_u32(tK);
  const uint32_t sV = smem_u32(tV);
  const uint32_t sQ = smem_u32(tQ);
  const uint32_t sDO = smem_u32(tDO);

  const int T = p.T;
  const int k0 = blockIdx.x * BK;
  const int bh = folded_bh();
  if (bh >= p.B * p.H) return;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  uint32_t* queue = sQueue + warp * 16 * BN;

  const size_t base = static_cast<size_t>(bh) * T * D;
  const S* Q = static_cast<const S*>(p.q) + base;
  const S* DO = static_cast<const S*>(p.dout) + base;
  const bool masked = p.mask != nullptr;
  const float* brow = p.bias ? p.bias + b * p.bias_sb + h * p.bias_sh
                             : nullptr;

  // a key that does not exist (ragged last tile) or is padding
  int rows[2];
  bool dead[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rows[i] = 16 * warp + g + 8 * i;
    const int kpos = k0 + rows[i];
    dead[i] = kpos >= T ||
              (masked && p.mask[static_cast<size_t>(b) * T + kpos] == 0);
  }

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[n][c] = dv[n][c] = 0.f;

  // A K tile at or past kend sees no query: it keeps its zero accumulators.
  const bool alive = p.kend == nullptr || k0 < p.kend[b];
  // Causal: Q tiles wholly before the diagonal see nothing of this K tile.
  const int first_qt = p.causal ? k0 / BN : 0;
  const int n_qt = alive ? (T + BN - 1) / BN : 0;

  // Q tile qt (q, dO, lse, delta and this K tile's two keep words and two
  // words of pairs to derive again a query) into buffer `buf`
  auto stage = [&](int qt, int buf) {
    const int q0 = qt * BN;
    copy_tile<D, BN>(sQ + buf * QTILE, Q, q0, T);
    copy_tile<D, BN>(sDO + buf * QTILE, DO, q0, T);
    for (int i = threadIdx.x; i < BN; i += NTHREADS) {
      const int qpos = q0 + i;
      const bool ok = qpos < T;
      const size_t at = static_cast<size_t>(bh) * T + (ok ? qpos : 0);
      cp_async4(smem_u32(sLse + buf * BN + i), p.lse + at, ok);
      cp_async4(smem_u32(sDel + buf * BN + i), p.delta + at, ok);
    }
    for (int i = threadIdx.x; i < 2 * BN; i += NTHREADS) {
      const int qpos = q0 + (i >> 1);
      const int widx = (k0 >> 5) + (i & 1);
      const bool ok = qpos < T && widx < p.W;
      if (p.dropout)
        cp_async4(smem_u32(sKeep + buf * 2 * BN + i),
                  p.keep + (ok ? keep_at(p, bh, qpos, widx) : 0), ok);
      cp_async4(smem_u32(sRedo + buf * 2 * BN + i),
                p.keep + (ok ? redo_at(p, bh, qpos, widx) : 0), ok);
    }
  };

  if (first_qt < n_qt) {
    copy_tile<D, 64>(sK, static_cast<const S*>(p.k) + base, k0, T);
    copy_tile<D, 64>(sV, static_cast<const S*>(p.v) + base, k0, T);
    stage(first_qt, 0);
    cp_async_commit();
  }

  const int a_row = 16 * warp + (lane & 15);
  const int a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) * 8;
  const int t_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int t_col = (lane >> 4) * 8;

  for (int qt = first_qt; qt < n_qt; ++qt) {
    const int buf = (qt - first_qt) & 1;
    if (qt + 1 < n_qt) {           // prefetch the next Q tile
      stage(qt + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = qt * BN;
    const S* cQ = tQ + buf * BN * RS;
    const S* cDO = tDO + buf * BN * RS;
    const float* lse = sLse + buf * BN;
    const float* del = sDel + buf * BN;
    const uint32_t* keep = sKeep + buf * 2 * BN;
    const uint32_t* redo = sRedo + buf * 2 * BN;
    const uint32_t qb_base = sQ + buf * QTILE;
    const uint32_t ob_base = sDO + buf * QTILE;

    float st[BN / 8][4], dpt[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) st[n][c] = dpt[n][c] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, sK + (a_row * RS + ks * 16 + a_col) * 2);
      ldsm_x4(va, sV + (a_row * RS + ks * 16 + a_col) * 2);
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        const uint32_t off = ((np * 16 + b_row) * RS + ks * 16 + b_col) * 2;
        uint32_t qb[4], ob[4];
        ldsm_x4(qb, qb_base + off);
        ldsm_x4(ob, ob_base + off);
        TR::mma(st[2 * np], ka, qb[0], qb[1]);
        TR::mma(st[2 * np + 1], ka, qb[2], qb[3]);
        TR::mma(dpt[2 * np], va, ob[0], ob[1]);
        TR::mma(dpt[2 * np + 1], va, ob[2], ob[3]);
      }
    }

    // p * keep into st, ds into dpt (both rounded below); the elements B4
    // marked to derive again (risk) and their keep bits, bit 4n + c for
    // slot (n, c).  Words of tiles B4 skipped are not written, but their
    // pairs are not live.
    uint32_t risk = 0u, kept_bits = 0u;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c >> 1;
        const int kpos = k0 + rows[i];
        const int qc = n * 8 + 2 * t4 + (c & 1);
        const int qpos = q0 + qc;
        float x = __fmul_rn(st[n][c], p.scale);
        bool live = false;
        if (qpos >= T || kpos >= T) {
          x = NEG_INF;   // ragged last tiles: the query or key does not exist
        } else {
          if (brow != nullptr)
            x = __fadd_rn(x, brow[static_cast<size_t>(qpos) * T + kpos]);
          if ((p.causal && qpos < kpos) || dead[i])
            x = NEG_INF;
          else
            live = true;
        }
        float l = lse[qc];
        if (masked && !(l > MASKED_ROW)) l = 0.f;
        const float pj = expf(x - l);
        float ksf = 1.f;
        float dpj = dpt[n][c];
        if (p.dropout) {
          const bool kept =
              (keep[2 * qc + (rows[i] >> 5)] >> (rows[i] & 31)) & 1u;
          ksf = kept ? p.inv_keep : 0.f;
          dpj = __fmul_rn(dpj, ksf);
          kept_bits |= static_cast<uint32_t>(kept) << (4 * n + c);
        }
        if (live && ((redo[2 * qc + (rows[i] >> 5)] >> (rows[i] & 31)) & 1u))
          risk |= 1u << (4 * n + c);
        st[n][c] = p.dropout ? __fmul_rn(pj, ksf) : pj;
        const float ds = pj * (dpj - del[qc]) * p.scale;
        dpt[n][c] = ds;
      }

    // p * keep and ds again, in the plain version's order, where a
    // rounding is in doubt; the queue returns both rounded, (ds << 16) | pk
    const int total = enqueue<NSLOT>(risk, queue, [&](int e) {
      const int n = e >> 2, c = e & 3;
      return entry(g + 8 * (c >> 1), n * 8 + 2 * t4 + (c & 1),
                   (kept_bits >> e) & 1u);
    });
    if (total > 0) {
      if (p.stats != nullptr && lane == 0)
        atomicAdd(p.stats, static_cast<unsigned long long>(total));
      __syncwarp();
      for (int j = lane; j < total; j += 32) {
        const uint32_t en = queue[j];
        const int kr = 16 * warp + ((en >> 7) & 15);
        const int qc = en & 127;
        const int qpos = q0 + qc;
        const int kpos = k0 + kr;
        const float sv = seq_dot<TR, D>(cQ + qc * RS, tK + kr * RS);
        float dpv = seq_dot<TR, D>(cDO + qc * RS, tV + kr * RS);
        float x = __fmul_rn(sv, p.scale);
        if (brow != nullptr)
          x = __fadd_rn(x, brow[static_cast<size_t>(qpos) * T + kpos]);
        float l = lse[qc];
        if (masked && !(l > MASKED_ROW)) l = 0.f;
        const float pj = expf(__fsub_rn(x, l));
        float pk = pj;
        if (p.dropout) {
          const float ksf = (en >> 11) & 1u ? p.inv_keep : 0.f;
          pk = __fmul_rn(pj, ksf);
          dpv = __fmul_rn(dpv, ksf);
        }
        const float ds =
            __fmul_rn(__fmul_rn(pj, __fsub_rn(dpv, del[qc])), p.scale);
        queue[j] = TR::bits(pk) | (TR::bits(ds) << 16);
      }
      __syncwarp();
      dequeue<NSLOT>(risk, queue, [&](int e, uint32_t r) {
        st[e >> 2][e & 3] = TR::value(r & 0xFFFFu);
        dpt[e >> 2][e & 3] = TR::value(r >> 16);
      });
    }

    // dv += (p keep)^T dO in dO's type, dk += ds^T q in q's type
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[4], da[4];
      to_a_frag<TR>(pa, st[2 * kk], st[2 * kk + 1]);
      to_a_frag<TR>(da, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        const uint32_t off = ((kk * 16 + t_row) * RS + n2 * 16 + t_col) * 2;
        uint32_t ob[4], qb[4];
        ldsm_x4_t(ob, ob_base + off);
        TR::mma(dv[2 * n2], pa, ob[0], ob[1]);
        TR::mma(dv[2 * n2 + 1], pa, ob[2], ob[3]);
        ldsm_x4_t(qb, qb_base + off);
        TR::mma(dk[2 * n2], da, qb[0], qb[1]);
        TR::mma(dk[2 * n2 + 1], da, qb[2], qb[3]);
      }
    }
    __syncthreads();   // every warp is done with this buffer
  }
  cp_async_wait<0>();

  S* DK = static_cast<S*>(p.dk) + base;
  S* DV = static_cast<S*>(p.dv) + base;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kpos = k0 + rows[i];
    if (kpos >= T) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const size_t at = static_cast<size_t>(kpos) * D + n * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(DK + at) =
          TR::pack(dk[n][2 * i], dk[n][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(DV + at) =
          TR::pack(dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: scalar FMAs (true f32)
// ---------------------------------------------------------------------------

// Copy rows [r0, r0 + 64) of a (T, D) slab into shared memory with row
// stride D + 1; rows at or past T are zeros.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int r0,
                                          int T) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += NTHREADS) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int row = r0 + r;
    dst[r * (D + 1) + c] = row < T ? src[static_cast<size_t>(row) * D + c]
                                   : 0.f;
  }
}

template <int D>
constexpr size_t dq_f32_smem_bytes() {
  return (4 * 64 * (D + 1) + BQ * (BK + 1) + BQ) * 4;
}

template <int D>
constexpr size_t dkv_f32_smem_bytes() {
  return (4 * 64 * (D + 1) + 2 * BQ + 2 * BK * (BQ + 1) + 2 * BQ) * 4;
}

// B4, f32.  Grid: (ceil(T / BQ), B * H).  Warp w owns query rows
// [16w, 16w + 16) of the tile; lane = 8 * rg + cg owns rows 16w + 4rg + i
// (i < 4), score columns cg + 8j (j < 8) and dq columns cg + 8j (j < D/8).
template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_f32_kernel(const Params p) {
  constexpr int RS = D + 1;
  constexpr int PS = BK + 1;
  constexpr int DC = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sDO = sQ + BQ * RS;
  float* sK = sDO + BQ * RS;
  float* sV = sK + BK * RS;
  float* sDS = sV + BK * RS;
  float* sDel = sDS + BQ * PS;

  const int T = p.T;
  const int q0 = blockIdx.x * BQ;
  const int bh = folded_bh();
  if (bh >= p.B * p.H) return;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int lane = threadIdx.x & 31;
  const int cg = lane & 7;
  const int row0 = (threadIdx.x >> 5) * 16 + (lane >> 3) * R;

  const size_t base = static_cast<size_t>(bh) * T * D;
  const float* K = static_cast<const float*>(p.k) + base;
  const float* V = static_cast<const float*>(p.v) + base;
  const bool masked = p.mask != nullptr;
  const int32_t* mrow = masked ? p.mask + static_cast<size_t>(b) * T : nullptr;
  const float* brow = p.bias ? p.bias + b * p.bias_sb + h * p.bias_sh
                             : nullptr;
  const flash::SeedKey sk = flash::seed_key(p.seed, p.dropout, bh);

  load_tile<D>(sQ, static_cast<const float*>(p.q) + base, q0, T);
  load_tile<D>(sDO, static_cast<const float*>(p.dout) + base, q0, T);
  block_delta<float, D>(p, bh, q0, sDel);
  __syncthreads();

  float lse[R], delta[R], acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qpos = q0 + row0 + i;
    const size_t at = static_cast<size_t>(bh) * T + qpos;
    lse[i] = qpos < T ? p.lse[at] : 0.f;
    delta[i] = sDel[row0 + i];
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
    load_tile<D>(sK, K, k0, T);
    load_tile<D>(sV, V, k0, T);
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

    // words[i][w]: this lane's keep bits of row i, keys [32w, 32w + 32)
    uint32_t words[R][2];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      words[i][0] = words[i][1] = 0u;
      const int qpos = q0 + row0 + i;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int kpos = k0 + cg + 8 * j;
        float x = s[i][j] * p.scale;
        bool live = false;
        if (kpos >= T) {
          x = NEG_INF;   // ragged last tile: the key does not exist
        } else {
          if (brow != nullptr && qpos < T)
            x += brow[static_cast<size_t>(qpos) * T + kpos];
          if ((p.causal && qpos < kpos) || (masked && mrow[kpos] == 0))
            x = NEG_INF;
          else
            live = qpos < T;
        }
        const float pj = expf(x - lse[i]);
        float dpj = dp[i][j];
        if (p.dropout) {
          const bool kept = live && draw_keep(p, sk, qpos, kpos);
          dpj *= kept ? p.inv_keep : 0.f;
          words[i][j >> 2] |= static_cast<uint32_t>(kept)
                              << (cg + 8 * (j & 3));
        }
        sDS[(row0 + i) * PS + cg + 8 * j] = pj * (dpj - delta[i]) * p.scale;
      }
    }
    if (p.dropout) {
      // gather each word from the 8 lanes of its rows; lane cg writes
      // (row cg / 2, word cg % 2)
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int w = 0; w < 2; ++w)
#pragma unroll
          for (int x = 1; x < 8; x <<= 1)
            words[i][w] |= __shfl_xor_sync(0xffffffffu, words[i][w], x);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          const int qpos = q0 + row0 + i;
          const int widx = (k0 >> 5) + w;
          if (cg == 2 * i + w && qpos < T && widx < p.W)
            p.keep[keep_at(p, bh, qpos, widx)] = words[i][w];
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

  float* DQ = static_cast<float*>(p.dq) + base;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qpos = q0 + row0 + i;
    if (qpos >= T) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      DQ[static_cast<size_t>(qpos) * D + cg + 8 * j] = acc[i][j];
  }
}

// B5, f32.  Grid: (ceil(T / BK), B * H).  The same thread layout in
// transposed (k-major) score space: warp w owns key rows [16w, 16w + 16) of
// the tile; lane = 8 * rg + cg owns key rows 16w + 4rg + i (i < 4), query
// columns cg + 8j (j < 8) and dk/dv columns cg + 8j (j < D/8).
template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_f32_kernel(const Params p) {
  constexpr int RS = D + 1;
  constexpr int PS = BQ + 1;
  constexpr int DC = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + BK * RS;
  float* sQ = sV + BK * RS;
  float* sDO = sQ + BQ * RS;
  float* sLSE = sDO + BQ * RS;
  float* sDEL = sLSE + BQ;
  float* sP = sDEL + BQ;
  float* sDS = sP + BK * PS;
  uint32_t* sKeep = reinterpret_cast<uint32_t*>(sDS + BK * PS);   // [BQ][2]

  const int T = p.T;
  const int k0 = blockIdx.x * BK;
  const int bh = folded_bh();
  if (bh >= p.B * p.H) return;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int lane = threadIdx.x & 31;
  const int cg = lane & 7;
  const int row0 = (threadIdx.x >> 5) * 16 + (lane >> 3) * R;

  const size_t base = static_cast<size_t>(bh) * T * D;
  const float* Q = static_cast<const float*>(p.q) + base;
  const float* DO = static_cast<const float*>(p.dout) + base;
  const float* LSE = p.lse + static_cast<size_t>(bh) * T;
  const float* DEL = p.delta + static_cast<size_t>(bh) * T;
  const bool masked = p.mask != nullptr;
  const float* brow = p.bias ? p.bias + b * p.bias_sb + h * p.bias_sh
                             : nullptr;

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
    load_tile<D>(sK, static_cast<const float*>(p.k) + base, k0, T);
    load_tile<D>(sV, static_cast<const float*>(p.v) + base, k0, T);
  }

  for (int qt = first_qt; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();   // every warp is done with the previous sQ / sDO
    load_tile<D>(sQ, Q, q0, T);
    load_tile<D>(sDO, DO, q0, T);
    for (int r = threadIdx.x; r < BQ; r += NTHREADS) {
      const int qpos = q0 + r;
      float l = qpos < T ? LSE[qpos] : 0.f;
      if (masked && !(l > MASKED_ROW)) l = 0.f;
      sLSE[r] = l;
      sDEL[r] = qpos < T ? DEL[qpos] : 0.f;
    }
    if (p.dropout) {
      for (int i = threadIdx.x; i < 2 * BQ; i += NTHREADS) {
        const int qpos = q0 + (i >> 1);
        const int widx = (k0 >> 5) + (i & 1);
        sKeep[i] = qpos < T && widx < p.W ? p.keep[keep_at(p, bh, qpos, widx)]
                                          : 0u;
      }
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
      const int kr = row0 + i;
      const int kpos = k0 + kr;
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
        const float ks =
            p.dropout ? ((sKeep[2 * qc + (kr >> 5)] >> (kr & 31)) & 1u
                             ? p.inv_keep
                             : 0.f)
                      : 1.f;
        sP[kr * PS + qc] = pj * ks;
        sDS[kr * PS + qc] = pj * (dpt[i][j] * ks - sDEL[qc]) * p.scale;
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

  float* DK = static_cast<float*>(p.dk) + base;
  float* DV = static_cast<float*>(p.dv) + base;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kpos = k0 + row0 + i;
    if (kpos >= T) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const size_t at = static_cast<size_t>(kpos) * D + cg + 8 * j;
      DK[at] = dk[i][j];
      DV[at] = dv[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// head_dim > 128, f32: scalar f32 FMAs, D in chunks
// ---------------------------------------------------------------------------
// The kernels above keep rows of the dq or dk/dv accumulators in registers
// and whole (64, D) tiles in shared memory, which does not scale past D =
// 128.  Here (true f32, no TF32, so no tensor cores) s = q k^T and dp =
// dO v^T are summed over D in chunks of WCH columns staged through shared
// memory, as sequential FMAs in d order (the plain version's f32 products
// sum in that order, so no pair is derived again), and each block owns
// WCOL columns of dq (B4) or of dk and dv (B5): the grid's x dimension
// walks (tile, column chunk), and every column block of a tile recomputes
// the same s, dp, p and ds.  The dropout
// bits come from the same threefry2x32 of (seed, batch*head, q, k) in every
// column block; only column block 0 of B4 writes delta, the keep words and
// the (empty) plane of pairs to derive again, which B5 reads.
constexpr int WCH = 32;          // D columns a score chunk sums
constexpr int WCOL = 64;         // result columns a block owns
constexpr int SUM_LANES = 512;   // torch's row sum has at most 512 lanes

// delta of one row as torch's CUDA sum over the last dim takes it (ATen
// Reduce.cuh, input vectorized by 4 for rows of 128 or more f32 values):
// bw x by lanes (by > 1 when the row is split across warps); lane (x, y)
// sums the 4-vectors x + bw * y, x + bw * y + bw * by, ... of the row, each
// of the four positions in its own accumulator, then adds them in turn.  A
// row that starts `shift` elements past a 16-byte boundary gives its first
// 4 - shift elements to lanes x = shift .. 3 (y = 0) and its last
// (n - 4 + shift) % 4 to lanes x = 0, 1, 2 as a tail.  Then a tree over x
// (offsets bw / 2, ..., 1) and one over y.  Each product is rounded on its
// own, as `(dout.float() * out.float())` rounds it.  One warp works it out,
// its lanes' sums in `scratch` (bw * by floats).
template <typename S>
__device__ float torch_row_sum(const S* a, const S* b, int n, int shift,
                               int bw, int by, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int nl = bw * by;
  const int head = shift > 0 ? 4 - shift : 0;   // the vectors start here
  const int end = n - head;
  auto prod = [&](int e) {
    return __fmul_rn(to_f32(a[e]), to_f32(b[e]));
  };
  for (int v = lane; v < nl; v += 32) {
    const int x = v % bw;
    const int y = v / bw;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (shift > 0 && y == 0 && x >= shift && x < 4)
      acc[0] = __fadd_rn(acc[0], prod(x - shift));
    for (int idx = v; idx * 4 + 3 < end; idx += nl)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[i] = __fadd_rn(acc[i], prod(head + idx * 4 + i));
    const int t = end - end % 4 + x;
    if (y == 0 && t < end) acc[0] = __fadd_rn(acc[0], prod(head + t));
    scratch[v] = __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]),
                           acc[3]);
  }
  __syncwarp();
  for (int off = bw / 2; off > 0; off >>= 1) {
    for (int v = lane; v < nl; v += 32)
      if (v % bw < off) scratch[v] = __fadd_rn(scratch[v], scratch[v + off]);
    __syncwarp();
  }
  for (int off = by / 2; off > 0; off >>= 1) {
    for (int y = lane; y < off; y += 32)
      scratch[y * bw] = __fadd_rn(scratch[y * bw], scratch[(y + off) * bw]);
    __syncwarp();
  }
  const float r = scratch[0];
  __syncwarp();
  return r;
}

// torch_row_sum of four rows at once, where torch's sum takes one warp a
// row (bw = 32, by = 1) and the rows start on 4-vectors (n a multiple of
// 4, so shift = 0 and no tail): the same sums in the same order, the four
// rows' loads in flight together and the tree over the lanes by shuffles
// (lane x adds lane x + off's sum, as scratch[x] += scratch[x + off]).
// Rows a[r], b[r]; the sums land in lane 0.
template <typename S>
__device__ __forceinline__ void torch_row_sum4(const S* const (&a)[4],
                                               const S* const (&b)[4], int n,
                                               float (&out)[4]) {
  static_assert(sizeof(S) == 2, "16-bit rows, 8 bytes a 4-vector");
  const int lane = threadIdx.x & 31;
  float acc[4][4] = {};
  for (int idx = lane; idx < n / 4; idx += 32) {
    uint2 x[4], y[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x[r] = *reinterpret_cast<const uint2*>(a[r] + 4 * idx);
      y[r] = *reinterpret_cast<const uint2*>(b[r] + 4 * idx);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const S* xa = reinterpret_cast<const S*>(&x[r]);
      const S* yb = reinterpret_cast<const S*>(&y[r]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[r][i] = __fadd_rn(acc[r][i],
                              __fmul_rn(to_f32(xa[i]), to_f32(yb[i])));
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float v = __fadd_rn(__fadd_rn(__fadd_rn(acc[r][0], acc[r][1]), acc[r][2]),
                        acc[r][3]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
    out[r] = v;
  }
}

// Columns [dc, dc + WCH) of rows [r0, r0 + 64) of a (T, D) slab, widened to
// f32, into shared memory at dst (row stride WCH + 1); zeros past T and D.
__device__ __forceinline__ void load_chunk(float* dst, const float* src, int r0,
                                           int T, int D, int dc) {
  for (int idx = threadIdx.x; idx < 64 * WCH; idx += NTHREADS) {
    const int r = idx / WCH;
    const int c = idx - r * WCH;
    const int row = r0 + r;
    const int d = dc + c;
    dst[r * (WCH + 1) + c] =
        row < T && d < D ? src[static_cast<size_t>(row) * D + d] : 0.f;
  }
}

// Columns [c0, c0 + WCOL) of rows [r0, r0 + 64), widened to f32, at dst
// (row stride WCOL); zeros past T and D.
__device__ __forceinline__ void load_cols(float* dst, const float* src, int r0,
                                          int T, int D, int c0) {
  for (int idx = threadIdx.x; idx < 64 * WCOL; idx += NTHREADS) {
    const int r = idx / WCOL;
    const int c = idx - r * WCOL;
    const int row = r0 + r;
    const int col = c0 + c;
    dst[r * WCOL + c] = row < T && col < D
        ? src[static_cast<size_t>(row) * D + col] : 0.f;
  }
}

constexpr size_t dq_wide_smem_bytes() {
  // q, k, dO and v chunks (the k column chunk reuses the q and k ones);
  // ds; delta and lse; each warp's lanes of the delta row sum
  return (4 * 64 * (WCH + 1) + BQ * (BK + 1) + 2 * BQ + 4 * SUM_LANES) * 4;
}

constexpr size_t dkv_wide_smem_bytes() {
  // k, v, q and dO chunks (the q and dO column chunks reuse them); p * keep
  // and ds; lse and delta; the keep words of the Q tile
  return (4 * 64 * (WCH + 1) + 2 * BK * (BQ + 1) + 2 * BQ + 2 * BQ) * 4;
}

// B4, head_dim > 128.  Grid: (ceil(T / BQ) * ceil(D / WCOL), folded B * H).
// The thread layout of the f32 kernel: lane = 8 * rg + cg of warp w owns
// query rows 16w + 4rg + i (i < 4), key columns cg + 8j (j < 8) and dq
// columns c0 + cg + 8j (j < WCOL / 8) of the block's chunk.
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_wide_kernel(const Params p) {
  constexpr int CS = WCH + 1;
  constexpr int PS = BK + 1;
  constexpr int DC = WCOL / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = sQ + 64 * CS;
  float* sDO = sK + 64 * CS;
  float* sV = sDO + 64 * CS;
  float* sKc = sQ;                 // k's column chunk, after the scores
  float* sDS = sV + 64 * CS;
  float* sDel = sDS + BQ * PS;
  float* sLse = sDel + BQ;
  float* sSum = sLse + BQ;

  const int bh = folded_bh();
  if (bh >= p.B * p.H) return;
  const int T = p.T;
  const int D = p.Dt;
  const int n_col = (D + WCOL - 1) / WCOL;
  const int q0 = static_cast<int>(blockIdx.x) / n_col * BQ;
  const int c0 = static_cast<int>(blockIdx.x) % n_col * WCOL;
  const bool writer = c0 == 0;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int cg = lane & 7;
  const int row0 = warp * 16 + (lane >> 3) * R;

  const size_t base = static_cast<size_t>(bh) * T * D;
  const float* Q = static_cast<const float*>(p.q) + base;
  const float* K = static_cast<const float*>(p.k) + base;
  const float* V = static_cast<const float*>(p.v) + base;
  const float* DO = static_cast<const float*>(p.dout) + base;
  const float* OUT = static_cast<const float*>(p.out) + base;
  const bool masked = p.mask != nullptr;
  const int32_t* mrow = masked ? p.mask + static_cast<size_t>(b) * T : nullptr;
  const float* brow = p.bias ? p.bias + b * p.bias_sb + h * p.bias_sh
                             : nullptr;
  const flash::SeedKey sk = flash::seed_key(p.seed, p.dropout, bh);

  // delta of the tile's rows, one warp a row, in torch's order over D
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    const int qpos = q0 + r;
    float dl = 0.f;
    if (qpos < T) {
      const size_t row = static_cast<size_t>(bh) * T + qpos;
      dl = torch_row_sum<float>(DO + static_cast<size_t>(qpos) * D,
                            OUT + static_cast<size_t>(qpos) * D, D,
                            static_cast<int>((row * D) & 3u), p.sum_bw,
                            p.sum_by, sSum + warp * SUM_LANES);
      if (p.dlse != nullptr) dl = __fsub_rn(dl, p.dlse[row]);
      if (writer && lane == 0) p.delta[row] = dl;
    }
    if (lane == 0) sDel[r] = dl;
  }
  for (int r = threadIdx.x; r < BQ; r += NTHREADS) {
    const int qpos = q0 + r;
    float l = qpos < T ? p.lse[static_cast<size_t>(bh) * T + qpos] : 0.f;
    if (masked && !(l > MASKED_ROW)) l = 0.f;
    sLse[r] = l;
  }
  __syncthreads();

  float lse[R], delta[R], acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    lse[i] = sLse[row0 + i];
    delta[i] = sDel[row0 + i];
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  int kmax = T;
  if (p.causal) kmax = min(kmax, q0 + BQ);
  if (p.kend != nullptr) kmax = min(kmax, p.kend[b]);
  const int n_tiles = (kmax + BK - 1) / BK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    float s[R][C], dp[R][C];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int dc = 0; dc < D; dc += WCH) {
      __syncthreads();   // every warp is done with the previous chunks
      load_chunk(sQ, Q, q0, T, D, dc);
      load_chunk(sK, K, k0, T, D, dc);
      load_chunk(sDO, DO, q0, T, D, dc);
      load_chunk(sV, V, k0, T, D, dc);
      __syncthreads();
      const int dn = min(WCH, D - dc);
#pragma unroll 2
      for (int c = 0; c < dn; ++c) {
        float qv[R], ov[R], kv[C], vv[C];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          qv[i] = sQ[(row0 + i) * CS + c];
          ov[i] = sDO[(row0 + i) * CS + c];
        }
#pragma unroll
        for (int j = 0; j < C; ++j) {
          kv[j] = sK[(cg + 8 * j) * CS + c];
          vv[j] = sV[(cg + 8 * j) * CS + c];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < C; ++j) {
            s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
            dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
          }
      }
    }

    // words[i][w]: this lane's keep bits of row i, keys [32w, 32w + 32)
    uint32_t words[R][2];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      words[i][0] = words[i][1] = 0u;
      const int qpos = q0 + row0 + i;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int kpos = k0 + cg + 8 * j;
        float x = s[i][j] * p.scale;
        bool live = false;
        if (kpos >= T) {
          x = NEG_INF;   // ragged last tile: the key does not exist
        } else {
          if (brow != nullptr && qpos < T)
            x += brow[static_cast<size_t>(qpos) * T + kpos];
          if ((p.causal && qpos < kpos) || (masked && mrow[kpos] == 0))
            x = NEG_INF;
          else
            live = qpos < T;
        }
        const float pj = expf(x - lse[i]);
        float dpj = dp[i][j];
        if (p.dropout) {
          const bool kept = live && draw_keep(p, sk, qpos, kpos);
          dpj *= kept ? p.inv_keep : 0.f;
          words[i][j >> 2] |= static_cast<uint32_t>(kept)
                              << (cg + 8 * (j & 3));
        }
        sDS[(row0 + i) * PS + cg + 8 * j] = pj * (dpj - delta[i]) * p.scale;
      }
    }
    if (writer) {
      // gather each word from the 8 lanes of its rows; lane cg writes
      // (row cg / 2, word cg % 2) and, in the second plane, no pair to
      // derive again
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int w = 0; w < 2; ++w)
#pragma unroll
          for (int x = 1; x < 8; x <<= 1)
            words[i][w] |= __shfl_xor_sync(0xffffffffu, words[i][w], x);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          const int qpos = q0 + row0 + i;
          const int widx = (k0 >> 5) + w;
          if (cg == 2 * i + w && qpos < T && widx < p.W) {
            if (p.dropout) p.keep[keep_at(p, bh, qpos, widx)] = words[i][w];
            p.keep[redo_at(p, bh, qpos, widx)] = 0u;
          }
        }
    }
    __syncthreads();   // ds is complete; the chunk buffers are free
    load_cols(sKc, K, k0, T, D, c0);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[R], kv[DC];
#pragma unroll
      for (int i = 0; i < R; ++i) dsv[i] = sDS[(row0 + i) * PS + kk];
#pragma unroll
      for (int j = 0; j < DC; ++j) kv[j] = sKc[kk * WCOL + cg + 8 * j];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

  float* DQ = static_cast<float*>(p.dq) + base;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qpos = q0 + row0 + i;
    if (qpos >= T) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int col = c0 + cg + 8 * j;
      if (col < D)
        DQ[static_cast<size_t>(qpos) * D + col] = acc[i][j];
    }
  }
}

// B5, head_dim > 128.  Grid: (ceil(T / BK) * ceil(D / WCOL), folded B * H).
// The f32 kernel's layout in transposed (k-major) score space: lane = 8 *
// rg + cg of warp w owns key rows 16w + 4rg + i (i < 4), query columns
// cg + 8j (j < 8) and dk/dv columns c0 + cg + 8j (j < WCOL / 8).
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_wide_kernel(const Params p) {
  constexpr int CS = WCH + 1;
  constexpr int PS = BQ + 1;
  constexpr int DC = WCOL / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + 64 * CS;
  float* sQ = sV + 64 * CS;
  float* sDO = sQ + 64 * CS;
  float* sQc = sK;                 // the column chunks, after the scores
  float* sDOc = sK + 64 * WCOL;
  float* sP = sDO + 64 * CS;
  float* sDS = sP + BK * PS;
  float* sLSE = sDS + BK * PS;
  float* sDEL = sLSE + BQ;
  uint32_t* sKeep = reinterpret_cast<uint32_t*>(sDEL + BQ);   // [BQ][2]

  const int bh = folded_bh();
  if (bh >= p.B * p.H) return;
  const int T = p.T;
  const int D = p.Dt;
  const int n_col = (D + WCOL - 1) / WCOL;
  const int k0 = static_cast<int>(blockIdx.x) / n_col * BK;
  const int c0 = static_cast<int>(blockIdx.x) % n_col * WCOL;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int lane = threadIdx.x & 31;
  const int cg = lane & 7;
  const int row0 = (threadIdx.x >> 5) * 16 + (lane >> 3) * R;

  const size_t base = static_cast<size_t>(bh) * T * D;
  const float* Q = static_cast<const float*>(p.q) + base;
  const float* K = static_cast<const float*>(p.k) + base;
  const float* V = static_cast<const float*>(p.v) + base;
  const float* DO = static_cast<const float*>(p.dout) + base;
  const float* LSE = p.lse + static_cast<size_t>(bh) * T;
  const float* DEL = p.delta + static_cast<size_t>(bh) * T;
  const bool masked = p.mask != nullptr;
  const float* brow = p.bias ? p.bias + b * p.bias_sb + h * p.bias_sh
                             : nullptr;

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

  for (int qt = first_qt; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();   // every warp is done with the previous Q tile
    for (int r = threadIdx.x; r < BQ; r += NTHREADS) {
      const int qpos = q0 + r;
      float l = qpos < T ? LSE[qpos] : 0.f;
      if (masked && !(l > MASKED_ROW)) l = 0.f;
      sLSE[r] = l;
      sDEL[r] = qpos < T ? DEL[qpos] : 0.f;
    }
    if (p.dropout) {
      for (int i = threadIdx.x; i < 2 * BQ; i += NTHREADS) {
        const int qpos = q0 + (i >> 1);
        const int widx = (k0 >> 5) + (i & 1);
        sKeep[i] = qpos < T && widx < p.W ? p.keep[keep_at(p, bh, qpos, widx)]
                                          : 0u;
      }
    }

    float st[R][C], dpt[R][C];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) st[i][j] = dpt[i][j] = 0.f;
    for (int dc = 0; dc < D; dc += WCH) {
      __syncthreads();   // every warp is done with the previous chunks
      load_chunk(sK, K, k0, T, D, dc);
      load_chunk(sV, V, k0, T, D, dc);
      load_chunk(sQ, Q, q0, T, D, dc);
      load_chunk(sDO, DO, q0, T, D, dc);
      __syncthreads();
      const int dn = min(WCH, D - dc);
#pragma unroll 2
      for (int c = 0; c < dn; ++c) {
        float kv[R], vv[R], qv[C], ov[C];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          kv[i] = sK[(row0 + i) * CS + c];
          vv[i] = sV[(row0 + i) * CS + c];
        }
#pragma unroll
        for (int j = 0; j < C; ++j) {
          qv[j] = sQ[(cg + 8 * j) * CS + c];
          ov[j] = sDO[(cg + 8 * j) * CS + c];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < C; ++j) {
            st[i][j] = fmaf(qv[j], kv[i], st[i][j]);
            dpt[i][j] = fmaf(ov[j], vv[i], dpt[i][j]);
          }
      }
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int kr = row0 + i;
      const int kpos = k0 + kr;
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
        float dpj = dpt[i][j];
        float ks = 1.f;
        if (p.dropout) {
          ks = (sKeep[2 * qc + (kr >> 5)] >> (kr & 31)) & 1u ? p.inv_keep
                                                             : 0.f;
          dpj *= ks;
        }
        sP[kr * PS + qc] = pj * ks;
        sDS[kr * PS + qc] = pj * (dpj - sDEL[qc]) * p.scale;
      }
    }
    __syncthreads();   // p * keep and ds are complete; the chunks are free
    load_cols(sQc, Q, q0, T, D, c0);
    load_cols(sDOc, DO, q0, T, D, c0);
    __syncthreads();

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
        ov[j] = sDOc[qq * WCOL + cg + 8 * j];
        qv[j] = sQc[qq * WCOL + cg + 8 * j];
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

  float* DK = static_cast<float*>(p.dk) + base;
  float* DV = static_cast<float*>(p.dv) + base;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kpos = k0 + row0 + i;
    if (kpos >= T) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int col = c0 + cg + 8 * j;
      if (col >= D) continue;
      const size_t at = static_cast<size_t>(kpos) * D + col;
      DK[at] = dk[i][j];
      DV[at] = dv[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// head_dim > 128, bf16 / f16: tensor cores, D in chunks
// ---------------------------------------------------------------------------
// The D <= 128 tensor-core kernels above with the head dim cut into chunks.
// A block has its own 64-row tile (B4: q and dO; B5: k and v) and walks the
// other's tiles (B4: k and v, WKB keys; B5: q and dO, WBN queries).  s =
// q k^T and dp = dO v^T (B5: st, dpt) run on mma.sync over D in chunks of
// WDC columns, the accumulators running on across the chunks.  16-bit tiles
// arrive by 16-byte cp.async, zeros past T and past D (so a D that is no
// multiple of 16 adds exact zeros), in one of two layouts:
// - whole (`wide_whole`: up to D = 256, where both fit two blocks an SM):
//   the own tile's rows whole, loaded once, and the other's whole rows in
//   two buffers, the next tile arriving while this one is worked;
// - streamed (past that): two buffers of one chunk of each, the next chunk
//   (or the next tile's first) arriving while this one is multiplied.
// Each block owns WNC result columns of dq (or of dk and dv) in register
// accumulators, as the D = 128 kernels do; the other tile's column block of
// k (B5: of q and dO) is read from its whole rows, or rides with its first
// chunk.  The grid's x dimension walks (tile, column block), and every
// column block recomputes s, dp, p and ds on the tensor cores, ceil(D /
// WNC) times in all.  The rounding points follow the D <= 128 kernels: B4
// tests every ds and p * keep against the type's rounding tie with the row
// norms summed over the chunks and the bound scaled for a chain over the
// true D (`wide_sum_err`), derives the marked pairs again with sequential
// f32 FMAs over the whole rows (from shared memory where they are whole,
// else from device memory), and its column block 0 writes the keep words
// and the marked pairs (the second plane) with delta, which B5 reads.
constexpr int WDC = 64;             // D columns a score chunk sums
constexpr int WNC = 128;            // result columns a block owns
constexpr int WRS = WDC + PAD;      // row stride of a chunk tile (elements)
constexpr int WCS = WNC + PAD;      // row stride of a column block
constexpr int WKB = 16;             // keys per B4 tile (half a keep word)
constexpr int WBN = 16;             // queries per B5 tile (its dk and dv
                                    // accumulators take 128 registers)
// a block's shared memory where two blocks share an SM (the registers
// allow no more)
constexpr size_t WIDE_SMEM = 232448 / 2;
// entries of a warp's queue (B4's also holds the lanes of a delta row sum)
constexpr int DQ_QUEUE = 16 * WKB > SUM_LANES ? 16 * WKB : SUM_LANES;

// Row stride (elements) of whole rows: D up to whole chunks, zero-filled,
// plus PAD (so that, as WRS, ldmatrix rows hit distinct banks).
__host__ __device__ constexpr int own_stride(int d) {
  return (d + WDC - 1) / WDC * WDC + PAD;
}

// Shared memory of a wide block: its own tile (two tensors of 64 rows,
// whole or two chunk buffers); two buffers of the other tile (two tensors
// of OTHER rows, whole or one chunk); streamed, NCB column blocks of OTHER
// rows; `extra` bytes of f32 rows, words and queue.
__host__ __device__ constexpr size_t wide_smem(int d, bool whole, int other,
                                               int ncb, size_t extra) {
  return (2 * (whole ? 64 * own_stride(d) : 2 * 64 * WRS) +
          2 * 2 * other * (whole ? own_stride(d) : WRS) +
          (whole ? 0 : ncb * other * WCS)) * 2 + extra;
}

// B4's lse, delta, q and dO norms, k and v norms, and the queues; B5's two
// sets of lse, delta, keep words and words of pairs to derive again, and
// the queues.
constexpr size_t DQ_WIDE_EXTRA = (4 * 64 + 2 * WKB) * 4 + 4 * DQ_QUEUE * 4;
constexpr size_t DKV_WIDE_EXTRA = 2 * 6 * WBN * 4 + 4 * 16 * WBN * 4;

// Whether both kernels take the whole layout at head dim d.
__host__ __device__ constexpr bool wide_whole(int d) {
  return wide_smem(d, true, WKB, 1, DQ_WIDE_EXTRA) <= WIDE_SMEM &&
         wide_smem(d, true, WBN, 2, DKV_WIDE_EXTRA) <= WIDE_SMEM;
}

__host__ __device__ constexpr size_t dq_wide_tc_smem(int d) {
  return wide_smem(d, wide_whole(d), WKB, 1, DQ_WIDE_EXTRA);
}

__host__ __device__ constexpr size_t dkv_wide_tc_smem(int d) {
  return wide_smem(d, wide_whole(d), WBN, 2, DKV_WIDE_EXTRA);
}

// SUM_ERR for a chain of mma.sync over head dim d: each step of 16 adds
// an error of a few f32 ulps of the running sum, which grows as the root of
// the terms summed, so the error in units of |a| |b| grows as sqrt(d / 128)
// past the D = 128 the bound was measured at (chip_smoke.py phase 1b
// measures it at the wide head dims against this)
__device__ __forceinline__ float wide_sum_err(int d) {
  return SUM_ERR * sqrtf(fmaxf(1.f, d / 128.f));
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
  const uint32_t sdst = smem_u32(dst);
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
      cp_async16(sdst + (r * ds + col) * 2, src + (ok ? at : 0), ok);
    } else {
      S* to = dst + r * ds + col;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        to[e] = row < T && d + e < D ? src[at + e] : flash::from_f32<S>(0.f);
    }
  }
}

// Sum of squares of this thread's half of row r of a chunk (row stride rs;
// two threads a row), for the row norms of the error bound.
template <typename TR>
__device__ __forceinline__ float chunk_sq(const typename TR::T* tile, int rs,
                                          int r) {
  const int half = threadIdx.x & 1;
  float s = 0.f;
#pragma unroll
  for (int d = half * WDC / 2; d < (half + 1) * WDC / 2; d += 2) {
    const float2 x = TR::unpack(
        *reinterpret_cast<const uint32_t*>(tile + r * rs + d));
    s += x.x * x.x + x.y * x.y;
  }
  return s;
}

// s = seq_dot(a0, b0) and dp = seq_dot(a1, b1) over n elements of rows in
// shared or device memory, the two chains side by side: the same
// sequential f32 FMAs in d order from 0, by 16-byte loads where every row
// is 16-byte aligned (n a multiple of 8).
template <typename TR>
__device__ __forceinline__ float2 seq_dot2_rows(const typename TR::T* a0,
                                                const typename TR::T* b0,
                                                const typename TR::T* a1,
                                                const typename TR::T* b1,
                                                int n) {
  float s0 = 0.f, s1 = 0.f;
  if ((n & 7) == 0) {
#pragma unroll 1
    for (int d = 0; d < n; d += 8) {
      const uint4 x0 = *reinterpret_cast<const uint4*>(a0 + d);
      const uint4 y0 = *reinterpret_cast<const uint4*>(b0 + d);
      const uint4 x1 = *reinterpret_cast<const uint4*>(a1 + d);
      const uint4 y1 = *reinterpret_cast<const uint4*>(b1 + d);
      const uint32_t xs0[4] = {x0.x, x0.y, x0.z, x0.w};
      const uint32_t ys0[4] = {y0.x, y0.y, y0.z, y0.w};
      const uint32_t xs1[4] = {x1.x, x1.y, x1.z, x1.w};
      const uint32_t ys1[4] = {y1.x, y1.y, y1.z, y1.w};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float2 u0 = TR::unpack(xs0[w]), v0 = TR::unpack(ys0[w]);
        const float2 u1 = TR::unpack(xs1[w]), v1 = TR::unpack(ys1[w]);
        s0 = __fmaf_rn(u0.x, v0.x, s0);
        s1 = __fmaf_rn(u1.x, v1.x, s1);
        s0 = __fmaf_rn(u0.y, v0.y, s0);
        s1 = __fmaf_rn(u1.y, v1.y, s1);
      }
    }
  } else {
    for (int d = 0; d < n; ++d) {
      s0 = __fmaf_rn(to_f32(a0[d]), to_f32(b0[d]), s0);
      s1 = __fmaf_rn(to_f32(a1[d]), to_f32(b1[d]), s1);
    }
  }
  return make_float2(s0, s1);
}

// Columns col and col + 1 of a result row of D values, rounded to the
// type; one 4-byte store where the pair is aligned and inside the row.
template <typename TR>
__device__ __forceinline__ void store_pair(typename TR::T* row, int col,
                                           int D, float a, float b) {
  if (col + 1 < D && (D & 1) == 0) {
    *reinterpret_cast<uint32_t*>(row + col) = TR::pack(a, b);
  } else {
    if (col < D) row[col] = flash::from_f32<typename TR::T>(a);
    if (col + 1 < D) row[col + 1] = flash::from_f32<typename TR::T>(b);
  }
}

// B4, head_dim > 128, bf16 / f16.  Grid: (ceil(T / BQ) * ceil(D / WNC),
// folded B * H).  The fragment layout of flash_bwd_dq_tc_kernel: warp w owns
// query rows [16w, 16w + 16) of the tile, which walks K tiles of WKB keys,
// each in chunks of WDC columns of D; dq columns c0 + 8n + 2t (n < WNC / 8).
template <typename TR>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_wide_tc_kernel(const Params p) {
  constexpr int KB = WKB;
  constexpr int NSLOT = KB / 2;     // score elements a lane holds
  using S = typename TR::T;
  const int D = p.Dt;
  const bool whole = wide_whole(D);
  const int rs = whole ? own_stride(D) : WRS;   // row stride of the tiles
  extern __shared__ __align__(16) unsigned char smem[];
  S* tQ = reinterpret_cast<S*>(smem);       // whole, or two chunk buffers
  S* tDO = tQ + (whole ? 64 * rs : 2 * 64 * WRS);
  S* tK = tDO + (whole ? 64 * rs : 2 * 64 * WRS);   // two buffers each
  S* tV = tK + 2 * KB * rs;
  S* tKc = tV + 2 * KB * rs;                // streamed: k's column block
  float* sLse = reinterpret_cast<float*>(tKc + (whole ? 0 : KB * WCS));
  float* sDel = sLse + 64;
  float* sQn = sDel + 64;
  float* sOn = sQn + 64;
  float* sKn = sOn + 64;
  float* sVn = sKn + KB;
  uint32_t* sQueue = reinterpret_cast<uint32_t*>(sVn + KB);

  const int bh = folded_bh();
  if (bh >= p.B * p.H) return;
  const int T = p.T;
  const int n_col = (D + WNC - 1) / WNC;
  const int q0 = static_cast<int>(blockIdx.x) / n_col * BQ;
  const int c0 = static_cast<int>(blockIdx.x) % n_col * WNC;
  const bool writer = c0 == 0;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  uint32_t* queue = sQueue + warp * DQ_QUEUE;

  const size_t base = static_cast<size_t>(bh) * T * D;
  const S* Q = static_cast<const S*>(p.q) + base;
  const S* K = static_cast<const S*>(p.k) + base;
  const S* V = static_cast<const S*>(p.v) + base;
  const S* DO = static_cast<const S*>(p.dout) + base;
  const S* OUT = static_cast<const S*>(p.out) + base;
  const bool masked = p.mask != nullptr;
  const int32_t* mrow = masked ? p.mask + static_cast<size_t>(b) * T : nullptr;
  const float* brow = p.bias ? p.bias + b * p.bias_sb + h * p.bias_sh
                             : nullptr;
  const flash::SeedKey sk = flash::seed_key(p.seed, p.dropout, bh);
  const float sum_err = wide_sum_err(D);

  int kmax = T;
  if (p.causal) kmax = min(kmax, q0 + BQ);
  if (p.kend != nullptr) kmax = min(kmax, p.kend[b]);
  const int n_tiles = (kmax + KB - 1) / KB;
  const int n_ch = (D + WDC - 1) / WDC;

  // whole: K tile kt's rows into buffer kt & 1
  auto stage_tile = [&](int kt) {
    for (int ch = 0; ch < n_ch; ++ch) {
      const int at = (kt & 1) * KB * rs + ch * WDC;
      copy_block<KB, WDC>(tK + at, rs, K, kt * KB, T, ch * WDC, D);
      copy_block<KB, WDC>(tV + at, rs, V, kt * KB, T, ch * WDC, D);
    }
  };
  // streamed: the chunks of step (K tile, chunk) = (step / n_ch, step %
  // n_ch) of q, dO, k and v into buffer step & 1
  auto stage_step = [&](int step) {
    const int k0 = step / n_ch * KB;
    const int dc = step % n_ch * WDC;
    const int buf = step & 1;
    copy_block<64, WDC>(tQ + buf * 64 * WRS, WRS, Q, q0, T, dc, D);
    copy_block<64, WDC>(tDO + buf * 64 * WRS, WRS, DO, q0, T, dc, D);
    copy_block<KB, WDC>(tK + buf * KB * WRS, WRS, K, k0, T, dc, D);
    copy_block<KB, WDC>(tV + buf * KB * WRS, WRS, V, k0, T, dc, D);
  };
  if (n_tiles > 0) {
    if (whole) {
      for (int ch = 0; ch < n_ch; ++ch) {
        copy_block<64, WDC>(tQ + ch * WDC, rs, Q, q0, T, ch * WDC, D);
        copy_block<64, WDC>(tDO + ch * WDC, rs, DO, q0, T, ch * WDC, D);
      }
      stage_tile(0);
    } else {
      stage_step(0);
    }
    cp_async_commit();
  }
  if (threadIdx.x < 64) {
    const int qpos = q0 + threadIdx.x;
    float l = qpos < T ? p.lse[static_cast<size_t>(bh) * T + qpos] : 0.f;
    if (masked && !(l > MASKED_ROW)) l = 0.f;
    sLse[threadIdx.x] = l;
  }
  // delta of the tile's rows, one warp a row, in torch's order over D,
  // while the first tiles arrive (the queue holds the row sum's lanes)
  auto put_delta = [&](int r, float dl) {
    const int qpos = q0 + r;
    if (qpos < T) {
      const size_t row = static_cast<size_t>(bh) * T + qpos;
      if (p.dlse != nullptr) dl = __fsub_rn(dl, p.dlse[row]);
      if (writer && lane == 0) p.delta[row] = dl;
    } else {
      dl = 0.f;
    }
    if (lane == 0) sDel[r] = dl;
  };
  if (p.sum_bw == 32 && p.sum_by == 1 && (D & 3) == 0) {
    for (int r0 = warp * 16; r0 < warp * 16 + 16; r0 += 4) {
      const S* ra[4];
      const S* rb[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const size_t at = static_cast<size_t>(q0 + r0 + r < T ? q0 + r0 + r
                                                                : 0) * D;
        ra[r] = DO + at;
        rb[r] = OUT + at;
      }
      float dl[4];
      torch_row_sum4<S>(ra, rb, D, dl);
#pragma unroll
      for (int r = 0; r < 4; ++r) put_delta(r0 + r, dl[r]);
    }
  } else {
    for (int r = warp * 16; r < warp * 16 + 16; ++r) {
      const int qpos = q0 + r;
      const size_t row = static_cast<size_t>(bh) * T + (qpos < T ? qpos : 0);
      put_delta(r, qpos < T ? torch_row_sum<S>(
                                  DO + static_cast<size_t>(qpos) * D,
                                  OUT + static_cast<size_t>(qpos) * D, D,
                                  static_cast<int>((row * D) & 3u), p.sum_bw,
                                  p.sum_by, reinterpret_cast<float*>(queue))
                            : 0.f);
    }
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

  float acc[WNC / 8][4];
#pragma unroll
  for (int n = 0; n < WNC / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  // squared row norms over the chunks so far (two threads a row): q and dO
  // in the first K tile, k and v in each
  float nq = 0.f, no = 0.f, nk = 0.f, nv = 0.f;
  const int nr = threadIdx.x >> 1;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * KB;
    // lane j < KB: whether key k0 + j exists and is valid (read here, used
    // after the products)
    const bool key_ok = lane < KB && k0 + lane < T &&
                        (!masked || mrow[k0 + lane] != 0);
    // this K tile's rows: whole, or the streamed column block of k
    const S* cKt = tK + (kt & 1) * KB * rs;
    const S* cVt = tV + (kt & 1) * KB * rs;
    if (whole) {
      if (kt + 1 < n_tiles) {        // prefetch the next K tile
        stage_tile(kt + 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
    }
    float s[KB / 8][4], dp[KB / 8][4];
#pragma unroll
    for (int n = 0; n < KB / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;

    for (int ch = 0; ch < n_ch; ++ch) {
      const int step = kt * n_ch + ch;
      const int buf = step & 1;
      if (!whole) {
        // k's column block rides with the tile's first chunks; the last
        // tile's dq product is done with it (the barrier closing that tile)
        if (ch == 0) copy_block<KB, WNC>(tKc, WCS, K, k0, T, c0, D);
        if (step + 1 < n_tiles * n_ch) {   // prefetch the next chunks
          stage_step(step + 1);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_commit();
          cp_async_wait<0>();
        }
        __syncthreads();
      }
      const S* cQ = whole ? tQ + ch * WDC : tQ + buf * 64 * WRS;
      const S* cDO = whole ? tDO + ch * WDC : tDO + buf * 64 * WRS;
      const S* cK = whole ? cKt + ch * WDC : tK + buf * KB * WRS;
      const S* cV = whole ? cVt + ch * WDC : tV + buf * KB * WRS;
      if (kt == 0) {
        nq += chunk_sq<TR>(cQ, rs, nr);
        no += chunk_sq<TR>(cDO, rs, nr);
      }
      if (nr < KB) {
        nk += chunk_sq<TR>(cK, rs, nr);
        nv += chunk_sq<TR>(cV, rs, nr);
      }
      const uint32_t sQ = smem_u32(cQ);
      const uint32_t sDO = smem_u32(cDO);
      const uint32_t sK = smem_u32(cK);
      const uint32_t sV = smem_u32(cV);
#pragma unroll
      for (int ks = 0; ks < WDC / 16; ++ks) {
        uint32_t qa[4], oa[4];
        ldsm_x4(qa, sQ + (a_row * rs + ks * 16 + a_col) * 2);
        ldsm_x4(oa, sDO + (a_row * rs + ks * 16 + a_col) * 2);
#pragma unroll
        for (int np = 0; np < KB / 16; ++np) {
          const uint32_t off = ((np * 16 + b_row) * rs + ks * 16 + b_col) * 2;
          uint32_t kb[4], vb[4];
          ldsm_x4(kb, sK + off);
          ldsm_x4(vb, sV + off);
          TR::mma(s[2 * np], qa, kb[0], kb[1]);
          TR::mma(s[2 * np + 1], qa, kb[2], kb[3]);
          TR::mma(dp[2 * np], oa, vb[0], vb[1]);
          TR::mma(dp[2 * np + 1], oa, vb[2], vb[3]);
        }
      }
      if (!whole) __syncthreads();   // every warp is done with this buffer
    }

    // the row norms over the whole of D
    {
      const float k2 = nk + __shfl_xor_sync(0xffffffffu, nk, 1);
      const float v2 = nv + __shfl_xor_sync(0xffffffffu, nv, 1);
      if (nr < KB && (threadIdx.x & 1) == 0) {
        sKn[nr] = sqrtf(k2);
        sVn[nr] = sqrtf(v2);
      }
      nk = nv = 0.f;
      if (kt == 0) {
        const float q2 = nq + __shfl_xor_sync(0xffffffffu, nq, 1);
        const float o2 = no + __shfl_xor_sync(0xffffffffu, no, 1);
        if ((threadIdx.x & 1) == 0) {
          sQn[nr] = sqrtf(q2);
          sOn[nr] = sqrtf(o2);
        }
      }
      __syncthreads();
    }

    // ds into s; the keep bits and the pairs to derive again of this tile,
    // as in flash_bwd_dq_tc_kernel
    const uint32_t kvalid = __ballot_sync(0xffffffffu, key_ok);
    uint32_t words[2] = {0u, 0u}, redo[2] = {0u, 0u};
    uint32_t risk = 0u, kept_bits = 0u;
#pragma unroll
    for (int n = 0; n < KB / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c >> 1;
        const int qpos = q0 + rows[i];
        const int kcol = n * 8 + 2 * t4 + (c & 1);
        const int kpos = k0 + kcol;
        float x = __fmul_rn(s[n][c], p.scale);
        bool live = false;
        if (kpos >= T) {
          x = NEG_INF;   // ragged last tile: the key does not exist
        } else {
          if (brow != nullptr && qpos < T)
            x = __fadd_rn(x, brow[static_cast<size_t>(qpos) * T + kpos]);
          if ((p.causal && qpos < kpos) || !((kvalid >> kcol) & 1u))
            x = NEG_INF;
          else
            live = qpos < T;
        }
        const float pj = expf(x - sLse[rows[i]]);
        float dpj = dp[n][c];
        float ksf = 1.f;
        if (p.dropout) {
          const bool kept = live && draw_keep(p, sk, qpos, kpos);
          ksf = kept ? p.inv_keep : 0.f;
          dpj = __fmul_rn(dpj, ksf);
          words[i] |= static_cast<uint32_t>(kept) << kcol;
          kept_bits |= static_cast<uint32_t>(kept) << (4 * n + c);
        }
        const float ds = pj * (dpj - sDel[rows[i]]) * p.scale;
        const float pk = p.dropout ? __fmul_rn(pj, ksf) : pj;
        if (live) {
          const float ex = 2 * sum_err * sQn[rows[i]] * sKn[kcol] * p.scale +
                           fabsf(x) * 2.4e-7f;
          const float edp = 2 * sum_err * sOn[rows[i]] * sVn[kcol] * ksf +
                            fabsf(dpj) * 2.4e-7f;
          if (TR::near_tie(ds, 1.01f * ex * fabsf(ds) + pj * p.scale * edp) ||
              TR::near_tie(pk, 1.01f * ex * fabsf(pk))) {
            risk |= 1u << (4 * n + c);
            redo[i] |= 1u << kcol;
          }
        }
        s[n][c] = ds;   // rounded below
      }

    // ds again, in the plain version's order, where its rounding is in doubt
    const int total = enqueue<NSLOT>(risk, queue, [&](int e) {
      const int n = e >> 2, c = e & 3;
      return entry(g + 8 * (c >> 1), n * 8 + 2 * t4 + (c & 1),
                   (kept_bits >> e) & 1u);
    });
    if (total > 0) {
      if (writer && p.stats != nullptr && lane == 0)
        atomicAdd(p.stats, static_cast<unsigned long long>(total));
      __syncwarp();
      for (int j = lane; j < total; j += 32) {
        const uint32_t en = queue[j];
        const int row = 16 * warp + ((en >> 7) & 15);
        const int kcol = en & 127;
        const int qpos = q0 + row;
        const int kpos = k0 + kcol;
        const size_t qr = whole ? static_cast<size_t>(row) * rs
                                : static_cast<size_t>(qpos) * D;
        const size_t kr = whole ? static_cast<size_t>(kcol) * rs
                                : static_cast<size_t>(kpos) * D;
        const float2 sd = seq_dot2_rows<TR>(
            (whole ? tQ : Q) + qr, (whole ? cKt : K) + kr,
            (whole ? tDO : DO) + qr, (whole ? cVt : V) + kr, D);
        float x = __fmul_rn(sd.x, p.scale);
        if (brow != nullptr)
          x = __fadd_rn(x, brow[static_cast<size_t>(qpos) * T + kpos]);
        const float pj = expf(__fsub_rn(x, sLse[row]));
        float dpv = sd.y;
        if (p.dropout)
          dpv = __fmul_rn(dpv, (en >> 11) & 1u ? p.inv_keep : 0.f);
        queue[j] = TR::bits(__fmul_rn(
            __fmul_rn(pj, __fsub_rn(dpv, sDel[row])), p.scale));
      }
      __syncwarp();
      dequeue<NSLOT>(risk, queue, [&](int e, uint32_t r) {
        s[e >> 2][e & 3] = TR::value(r);
      });
    }

    if (writer) {
      // gather each half word (the tile's 16 keys) from the four lanes of
      // its row; lane t < 2 of the lane group writes row t's
      uint32_t word = 0u, rword = 0u;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (p.dropout) {
          words[i] |= __shfl_xor_sync(0xffffffffu, words[i], 1);
          words[i] |= __shfl_xor_sync(0xffffffffu, words[i], 2);
        }
        redo[i] |= __shfl_xor_sync(0xffffffffu, redo[i], 1);
        redo[i] |= __shfl_xor_sync(0xffffffffu, redo[i], 2);
        if (t4 == i) {
          word = words[i];
          rword = redo[i];
        }
      }
      const int qpos = q0 + rows[t4 < 2 ? t4 : 1];
      const int widx = k0 >> 5;
      const int half = (k0 >> 4) & 1;   // bits 16 half .. 16 half + 15
      if (t4 < 2 && qpos < T && widx < p.W) {
        if (p.dropout)
          reinterpret_cast<uint16_t*>(p.keep + keep_at(p, bh, qpos, widx))
              [half] = static_cast<uint16_t>(word);
        reinterpret_cast<uint16_t*>(p.keep + redo_at(p, bh, qpos, widx))
            [half] = static_cast<uint16_t>(rword);
      }
    }

    // dq += ds k over the block's columns: ds meets k in k's type
    const uint32_t sKc = whole ? smem_u32(cKt + c0) : smem_u32(tKc);
    const int kcs = whole ? rs : WCS;
#pragma unroll
    for (int kk = 0; kk < KB / 16; ++kk) {
      uint32_t da[4];
      to_a_frag<TR>(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n2 = 0; n2 < WNC / 16; ++n2) {
        if (c0 + 16 * n2 >= D) break;
        uint32_t kb[4];
        ldsm_x4_t(kb, sKc + ((kk * 16 + t_row) * kcs + n2 * 16 + t_col) * 2);
        TR::mma(acc[2 * n2], da, kb[0], kb[1]);
        TR::mma(acc[2 * n2 + 1], da, kb[2], kb[3]);
      }
    }
    __syncthreads();   // every warp is done with this tile's buffers
  }
  cp_async_wait<0>();

  S* DQ = static_cast<S*>(p.dq) + base;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = q0 + rows[i];
    if (qpos >= T) continue;
#pragma unroll
    for (int n = 0; n < WNC / 8; ++n)
      store_pair<TR>(DQ + static_cast<size_t>(qpos) * D, c0 + n * 8 + 2 * t4,
                     D, acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

// B5, head_dim > 128, bf16 / f16.  Grid: (ceil(T / BK) * ceil(D / WNC),
// folded B * H).  The fragment layout of flash_bwd_dkv_tc_kernel: warp w
// owns key rows [16w, 16w + 16) of the tile, which walks Q tiles of WBN
// queries, each in chunks of WDC columns of D; dk and dv columns c0 + 8n +
// 2t (n < WNC / 8).
template <typename TR>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_wide_tc_kernel(const Params p) {
  constexpr int BN = WBN;
  constexpr int NSLOT = BN / 2;     // score elements a lane holds
  using S = typename TR::T;
  const int D = p.Dt;
  const bool whole = wide_whole(D);
  const int rs = whole ? own_stride(D) : WRS;   // row stride of the tiles
  extern __shared__ __align__(16) unsigned char smem[];
  S* tK = reinterpret_cast<S*>(smem);       // whole, or two chunk buffers
  S* tV = tK + (whole ? 64 * rs : 2 * 64 * WRS);
  S* tQ = tV + (whole ? 64 * rs : 2 * 64 * WRS);   // two buffers each
  S* tDO = tQ + 2 * BN * rs;
  S* tQc = tDO + 2 * BN * rs;               // streamed: column blocks
  S* tDOc = tQc + BN * WCS;
  // two sets (Q tile qt in set qt & 1) of lse, delta, keep words [BN][2]
  // and words of pairs to derive again [BN][2]
  float* sLse = reinterpret_cast<float*>(tQc + (whole ? 0 : 2 * BN * WCS));
  float* sDel = sLse + 2 * BN;
  uint32_t* sKeep = reinterpret_cast<uint32_t*>(sDel + 2 * BN);
  uint32_t* sRedo = sKeep + 4 * BN;
  uint32_t* sQueue = sRedo + 4 * BN;

  const int bh = folded_bh();
  if (bh >= p.B * p.H) return;
  const int T = p.T;
  const int n_col = (D + WNC - 1) / WNC;
  const int k0 = static_cast<int>(blockIdx.x) / n_col * BK;
  const int c0 = static_cast<int>(blockIdx.x) % n_col * WNC;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  uint32_t* queue = sQueue + warp * 16 * BN;

  const size_t base = static_cast<size_t>(bh) * T * D;
  const S* Q = static_cast<const S*>(p.q) + base;
  const S* K = static_cast<const S*>(p.k) + base;
  const S* V = static_cast<const S*>(p.v) + base;
  const S* DO = static_cast<const S*>(p.dout) + base;
  const bool masked = p.mask != nullptr;
  const float* brow = p.bias ? p.bias + b * p.bias_sb + h * p.bias_sh
                             : nullptr;

  // a key that does not exist (ragged last tile) or is padding
  int rows[2];
  bool dead[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rows[i] = 16 * warp + g + 8 * i;
    const int kpos = k0 + rows[i];
    dead[i] = kpos >= T ||
              (masked && p.mask[static_cast<size_t>(b) * T + kpos] == 0);
  }

  float dk[WNC / 8][4], dv[WNC / 8][4];
#pragma unroll
  for (int n = 0; n < WNC / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[n][c] = dv[n][c] = 0.f;

  // A K tile at or past kend sees no query: it keeps its zero accumulators.
  const bool alive = p.kend == nullptr || k0 < p.kend[b];
  // Causal: Q tiles wholly before the diagonal see nothing of this K tile.
  const int first_qt = p.causal ? k0 / BN : 0;
  const int n_qt = alive ? (T + BN - 1) / BN : 0;
  const int n_ch = (D + WDC - 1) / WDC;
  const int n_steps = first_qt < n_qt ? (n_qt - first_qt) * n_ch : 0;

  // Q tile qt's lse and delta and this K tile's two keep words and two
  // words of pairs to derive again a query, into set qt & 1
  auto stage_rows = [&](int qt) {
    const int q0 = qt * BN;
    const int set = qt & 1;
    for (int i = threadIdx.x; i < BN; i += NTHREADS) {
      const int qpos = q0 + i;
      const bool ok = qpos < T;
      const size_t at = static_cast<size_t>(bh) * T + (ok ? qpos : 0);
      cp_async4(smem_u32(sLse + set * BN + i), p.lse + at, ok);
      cp_async4(smem_u32(sDel + set * BN + i), p.delta + at, ok);
    }
    for (int i = threadIdx.x; i < 2 * BN; i += NTHREADS) {
      const int qpos = q0 + (i >> 1);
      const int widx = (k0 >> 5) + (i & 1);
      const bool ok = qpos < T && widx < p.W;
      if (p.dropout)
        cp_async4(smem_u32(sKeep + set * 2 * BN + i),
                  p.keep + (ok ? keep_at(p, bh, qpos, widx) : 0), ok);
      cp_async4(smem_u32(sRedo + set * 2 * BN + i),
                p.keep + (ok ? redo_at(p, bh, qpos, widx) : 0), ok);
    }
  };
  // whole: Q tile qt's rows of q and dO into buffer qt & 1, and its rows
  auto stage_tile = [&](int qt) {
    for (int ch = 0; ch < n_ch; ++ch) {
      const int at = (qt & 1) * BN * rs + ch * WDC;
      copy_block<BN, WDC>(tQ + at, rs, Q, qt * BN, T, ch * WDC, D);
      copy_block<BN, WDC>(tDO + at, rs, DO, qt * BN, T, ch * WDC, D);
    }
    stage_rows(qt);
  };
  // streamed: the chunks of step (Q tile, chunk) = (first_qt + step / n_ch,
  // step % n_ch) of k, v, q and dO into buffer step & 1
  auto stage_step = [&](int step) {
    const int q0 = (first_qt + step / n_ch) * BN;
    const int dc = step % n_ch * WDC;
    const int buf = step & 1;
    copy_block<64, WDC>(tK + buf * 64 * WRS, WRS, K, k0, T, dc, D);
    copy_block<64, WDC>(tV + buf * 64 * WRS, WRS, V, k0, T, dc, D);
    copy_block<BN, WDC>(tQ + buf * BN * WRS, WRS, Q, q0, T, dc, D);
    copy_block<BN, WDC>(tDO + buf * BN * WRS, WRS, DO, q0, T, dc, D);
  };
  if (n_steps > 0) {
    if (whole) {
      for (int ch = 0; ch < n_ch; ++ch) {
        copy_block<64, WDC>(tK + ch * WDC, rs, K, k0, T, ch * WDC, D);
        copy_block<64, WDC>(tV + ch * WDC, rs, V, k0, T, ch * WDC, D);
      }
      stage_tile(first_qt);
    } else {
      stage_step(0);
    }
    cp_async_commit();
  }

  const int a_row = 16 * warp + (lane & 15);
  const int a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) * 8;
  const int t_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int t_col = (lane >> 4) * 8;

  for (int qt = first_qt; qt < n_qt; ++qt) {
    const int q0 = qt * BN;
    const int set = qt & 1;
    // this Q tile's rows: whole, or the streamed column blocks
    const S* cQt = tQ + set * BN * rs;
    const S* cDOt = tDO + set * BN * rs;
    if (whole) {
      if (qt + 1 < n_qt) {           // prefetch the next Q tile
        stage_tile(qt + 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
    }
    float st[BN / 8][4], dpt[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) st[n][c] = dpt[n][c] = 0.f;

    for (int ch = 0; ch < n_ch; ++ch) {
      const int step = (qt - first_qt) * n_ch + ch;
      const int buf = step & 1;
      if (!whole) {
        // the tile's column blocks and rows ride with its first chunks; the
        // last tile is done with them (the barrier closing that tile)
        if (ch == 0) {
          copy_block<BN, WNC>(tQc, WCS, Q, q0, T, c0, D);
          copy_block<BN, WNC>(tDOc, WCS, DO, q0, T, c0, D);
          stage_rows(qt);
        }
        if (step + 1 < n_steps) {          // prefetch the next chunks
          stage_step(step + 1);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_commit();
          cp_async_wait<0>();
        }
        __syncthreads();
      }
      const uint32_t sK = smem_u32(whole ? tK + ch * WDC : tK + buf * 64 * WRS);
      const uint32_t sV = smem_u32(whole ? tV + ch * WDC : tV + buf * 64 * WRS);
      const uint32_t sQ = smem_u32(whole ? cQt + ch * WDC
                                         : tQ + buf * BN * WRS);
      const uint32_t sDO = smem_u32(whole ? cDOt + ch * WDC
                                          : tDO + buf * BN * WRS);
#pragma unroll
      for (int ks = 0; ks < WDC / 16; ++ks) {
        uint32_t ka[4], va[4];
        ldsm_x4(ka, sK + (a_row * rs + ks * 16 + a_col) * 2);
        ldsm_x4(va, sV + (a_row * rs + ks * 16 + a_col) * 2);
#pragma unroll
        for (int np = 0; np < BN / 16; ++np) {
          const uint32_t off = ((np * 16 + b_row) * rs + ks * 16 + b_col) * 2;
          uint32_t qb[4], ob[4];
          ldsm_x4(qb, sQ + off);
          ldsm_x4(ob, sDO + off);
          TR::mma(st[2 * np], ka, qb[0], qb[1]);
          TR::mma(st[2 * np + 1], ka, qb[2], qb[3]);
          TR::mma(dpt[2 * np], va, ob[0], ob[1]);
          TR::mma(dpt[2 * np + 1], va, ob[2], ob[3]);
        }
      }
      if (!whole) __syncthreads();   // every warp is done with this buffer
    }

    // p * keep into st, ds into dpt (both rounded below), as in
    // flash_bwd_dkv_tc_kernel
    const float* lse = sLse + set * BN;
    const float* del = sDel + set * BN;
    const uint32_t* keep = sKeep + set * 2 * BN;
    const uint32_t* redo = sRedo + set * 2 * BN;
    uint32_t risk = 0u, kept_bits = 0u;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c >> 1;
        const int kpos = k0 + rows[i];
        const int qc = n * 8 + 2 * t4 + (c & 1);
        const int qpos = q0 + qc;
        float x = __fmul_rn(st[n][c], p.scale);
        bool live = false;
        if (qpos >= T || kpos >= T) {
          x = NEG_INF;   // ragged last tiles: the query or key does not exist
        } else {
          if (brow != nullptr)
            x = __fadd_rn(x, brow[static_cast<size_t>(qpos) * T + kpos]);
          if ((p.causal && qpos < kpos) || dead[i])
            x = NEG_INF;
          else
            live = true;
        }
        float l = lse[qc];
        if (masked && !(l > MASKED_ROW)) l = 0.f;
        const float pj = expf(x - l);
        float ksf = 1.f;
        float dpj = dpt[n][c];
        if (p.dropout) {
          const bool kept =
              (keep[2 * qc + (rows[i] >> 5)] >> (rows[i] & 31)) & 1u;
          ksf = kept ? p.inv_keep : 0.f;
          dpj = __fmul_rn(dpj, ksf);
          kept_bits |= static_cast<uint32_t>(kept) << (4 * n + c);
        }
        if (live && ((redo[2 * qc + (rows[i] >> 5)] >> (rows[i] & 31)) & 1u))
          risk |= 1u << (4 * n + c);
        st[n][c] = p.dropout ? __fmul_rn(pj, ksf) : pj;
        dpt[n][c] = pj * (dpj - del[qc]) * p.scale;
      }

    // p * keep and ds again, in the plain version's order, where a
    // rounding is in doubt; the queue returns both rounded, (ds << 16) | pk
    const int total = enqueue<NSLOT>(risk, queue, [&](int e) {
      const int n = e >> 2, c = e & 3;
      return entry(g + 8 * (c >> 1), n * 8 + 2 * t4 + (c & 1),
                   (kept_bits >> e) & 1u);
    });
    if (total > 0) {
      if (c0 == 0 && p.stats != nullptr && lane == 0)
        atomicAdd(p.stats, static_cast<unsigned long long>(total));
      __syncwarp();
      for (int j = lane; j < total; j += 32) {
        const uint32_t en = queue[j];
        const int qc = en & 127;
        const int qpos = q0 + qc;
        const int kr = 16 * warp + ((en >> 7) & 15);
        const int kpos = k0 + kr;
        const size_t qrow = whole ? static_cast<size_t>(qc) * rs
                                  : static_cast<size_t>(qpos) * D;
        const size_t krow = whole ? static_cast<size_t>(kr) * rs
                                  : static_cast<size_t>(kpos) * D;
        const float2 sd = seq_dot2_rows<TR>(
            (whole ? cQt : Q) + qrow, (whole ? tK : K) + krow,
            (whole ? cDOt : DO) + qrow, (whole ? tV : V) + krow, D);
        float x = __fmul_rn(sd.x, p.scale);
        if (brow != nullptr)
          x = __fadd_rn(x, brow[static_cast<size_t>(qpos) * T + kpos]);
        float l = lse[qc];
        if (masked && !(l > MASKED_ROW)) l = 0.f;
        const float pj = expf(__fsub_rn(x, l));
        float pk = pj;
        float dpv = sd.y;
        if (p.dropout) {
          const float ksf = (en >> 11) & 1u ? p.inv_keep : 0.f;
          pk = __fmul_rn(pj, ksf);
          dpv = __fmul_rn(dpv, ksf);
        }
        const float ds =
            __fmul_rn(__fmul_rn(pj, __fsub_rn(dpv, del[qc])), p.scale);
        queue[j] = TR::bits(pk) | (TR::bits(ds) << 16);
      }
      __syncwarp();
      dequeue<NSLOT>(risk, queue, [&](int e, uint32_t r) {
        st[e >> 2][e & 3] = TR::value(r & 0xFFFFu);
        dpt[e >> 2][e & 3] = TR::value(r >> 16);
      });
    }

    // dv += (p keep)^T dO in dO's type, dk += ds^T q in q's type, over the
    // block's columns
    const uint32_t sQc = whole ? smem_u32(cQt + c0) : smem_u32(tQc);
    const uint32_t sDOc = whole ? smem_u32(cDOt + c0) : smem_u32(tDOc);
    const int ccs = whole ? rs : WCS;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[4], da[4];
      to_a_frag<TR>(pa, st[2 * kk], st[2 * kk + 1]);
      to_a_frag<TR>(da, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int n2 = 0; n2 < WNC / 16; ++n2) {
        if (c0 + 16 * n2 >= D) break;
        const uint32_t off = ((kk * 16 + t_row) * ccs + n2 * 16 + t_col) * 2;
        uint32_t ob[4], qb[4];
        ldsm_x4_t(ob, sDOc + off);
        TR::mma(dv[2 * n2], pa, ob[0], ob[1]);
        TR::mma(dv[2 * n2 + 1], pa, ob[2], ob[3]);
        ldsm_x4_t(qb, sQc + off);
        TR::mma(dk[2 * n2], da, qb[0], qb[1]);
        TR::mma(dk[2 * n2 + 1], da, qb[2], qb[3]);
      }
    }
    __syncthreads();   // every warp is done with this tile's buffers
  }
  cp_async_wait<0>();

  S* DK = static_cast<S*>(p.dk) + base;
  S* DV = static_cast<S*>(p.dv) + base;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kpos = k0 + rows[i];
    if (kpos >= T) continue;
#pragma unroll
    for (int n = 0; n < WNC / 8; ++n) {
      const int col = c0 + n * 8 + 2 * t4;
      store_pair<TR>(DK + static_cast<size_t>(kpos) * D, col, D, dk[n][2 * i],
                     dk[n][2 * i + 1]);
      store_pair<TR>(DV + static_cast<size_t>(kpos) * D, col, D, dv[n][2 * i],
                     dv[n][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
cudaError_t launch_kernel(void (*kernel)(Params), size_t smem,
                          const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<fold_grid((p.T + 63) / 64, p.B * p.H), NTHREADS, smem, stream>>>(
      p);
  return cudaGetLastError();
}

template <int D, bool DQ>
cudaError_t launch(const Params& p, int dtype, cudaStream_t stream) {
  if (dtype == 0)
    return DQ ? launch_kernel(flash_bwd_dq_f32_kernel<D>,
                              dq_f32_smem_bytes<D>(), p, stream)
              : launch_kernel(flash_bwd_dkv_f32_kernel<D>,
                              dkv_f32_smem_bytes<D>(), p, stream);
  if (dtype == 1)
    return DQ ? launch_kernel(flash_bwd_dq_tc_kernel<hopper::Bf16, D>,
                              dq_tc_smem_bytes<D>(), p, stream)
              : launch_kernel(flash_bwd_dkv_tc_kernel<hopper::Bf16, D>,
                              dkv_tc_smem_bytes<D>(), p, stream);
  if (dtype == 2)
    return DQ ? launch_kernel(flash_bwd_dq_tc_kernel<hopper::F16, D>,
                              dq_tc_smem_bytes<D>(), p, stream)
              : launch_kernel(flash_bwd_dkv_tc_kernel<hopper::F16, D>,
                              dkv_tc_smem_bytes<D>(), p, stream);
  return cudaErrorInvalidValue;
}

cudaError_t launch_wide(void (*kernel)(Params), size_t smem, int cols,
                        const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int gx = (p.T + 63) / 64 * ((p.Dt + cols - 1) / cols);
  kernel<<<fold_grid(gx, p.B * p.H), NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool DQ, typename TR>
cudaError_t launch_wide_tc(const Params& p, cudaStream_t stream) {
  return DQ ? launch_wide(flash_bwd_dq_wide_tc_kernel<TR>,
                          dq_wide_tc_smem(p.Dt), WNC, p, stream)
            : launch_wide(flash_bwd_dkv_wide_tc_kernel<TR>,
                          dkv_wide_tc_smem(p.Dt), WNC, p, stream);
}

template <bool DQ>
cudaError_t launch_any(const Params& p, int dtype, int d,
                       cudaStream_t stream) {
  if (d > 128) {
    if (p.Dt != d) return cudaErrorInvalidValue;   // taken unpadded
    if (dtype == 0)
      return DQ ? launch_wide(flash_bwd_dq_wide_kernel,
                              dq_wide_smem_bytes(), WCOL, p, stream)
                : launch_wide(flash_bwd_dkv_wide_kernel,
                              dkv_wide_smem_bytes(), WCOL, p, stream);
    if (dtype == 1) return launch_wide_tc<DQ, hopper::Bf16>(p, stream);
    if (dtype == 2) return launch_wide_tc<DQ, hopper::F16>(p, stream);
    return cudaErrorInvalidValue;
  }
  switch (d) {
    case 16: return launch<16, DQ>(p, dtype, stream);
    case 32: return launch<32, DQ>(p, dtype, stream);
    case 64: return launch<64, DQ>(p, dtype, stream);
    case 128: return launch<128, DQ>(p, dtype, stream);
  }
  return cudaErrorInvalidValue;
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, float* delta,
                   uint32_t* keep, unsigned long long* stats,
                   const int32_t* mask, const int32_t* kend,
                   const float* bias, long long bias_sb, long long bias_sh,
                   int batch, int heads, int seq, int true_dim, float scale,
                   int causal,
                   int dropout, const unsigned int* seed, unsigned int thr,
                   float inv_keep) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.out = nullptr;
  p.lse = lse;
  p.dlse = nullptr;
  p.delta = delta;
  p.keep = keep;
  p.stats = stats;
  p.dq = p.dk = p.dv = nullptr;
  p.mask = mask;
  p.kend = kend;
  p.bias = bias;
  p.bias_sb = bias_sb;
  p.bias_sh = bias_sh;
  p.B = batch;
  p.H = heads;
  p.T = seq;
  p.W = (seq + 31) / 32;
  p.Dt = true_dim;
  p.scale = scale;
  p.causal = causal;
  p.dropout = dropout;
  p.seed = seed;
  p.sum_bw = p.sum_by = 1;
  p.thr = thr;
  p.inv_keep = inv_keep;
  return p;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  head_dim is the row length
// of q, k, v, dout and out in device memory (16, 32, 64 or 128, or any
// length from 129 to MAX_HEAD_DIM, taken unpadded by the chunked kernels),
// true_dim the head dim before the wrapper's zero padding, over which delta
// is summed.  Every pointer is a device pointer; dlse, mask, kend, bias and
// stats may be null, and seed (the two threefry words) too without dropout.
// B4 writes dq, delta (B, H, T) f32 and the words (2, B, H, T, ceil(T/32))
// uint32 (the keep bits with dropout; the pairs derived again in bf16) that
// B5 then reads.  stats, when given, counts the bf16 elements whose rounding
// was derived again.  Each launches on `stream` and does not synchronise;
// it returns the CUDA error of the launch (0 on success).
// The lanes of torch's CUDA sum over the contiguous last dim of an f32
// tensor of `rows` rows of n >= 128 values (ATen Reduce.cuh
// setReduceConfig, the input vectorized by 4): *bw lanes along a row, and
// *by warps that split it (1 unless a lane would sum at least
// min(16 * block height, 256) values).
static void torch_sum_lanes(int n, long long rows, int* bw, int* by) {
  auto last_pow2 = [](long long v) {
    long long p = 1;
    while (p * 2 <= v) p *= 2;
    return p;
  };
  auto lesser = [](long long a, long long b) { return a < b ? a : b; };
  const long long mnt = 512;
  const long long dim0 = n / 4;
  const long long p0 = dim0 < mnt ? last_pow2(dim0) : mnt;
  const long long p1 = rows < mnt ? last_pow2(rows) : mnt;
  long long w = lesser(p0, 32);
  const long long h = lesser(p1, mnt / w);
  w = lesser(p0, mnt / h);
  *bw = static_cast<int>(w);
  *by = (n + w - 1) / w >= lesser(h * 16, 256) ? static_cast<int>(h) : 1;
}

static bool dims_ok(int head_dim, int true_dim, int dropout,
                    const unsigned int* seed) {
  return true_dim >= 1 && true_dim <= head_dim &&
         head_dim <= MAX_HEAD_DIM && (head_dim <= 128 || true_dim == head_dim)
         && !(dropout && seed == nullptr);
}

extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* out, const float* lse, const float* dlse, float* delta,
    unsigned int* keep, void* dq, unsigned long long* stats,
    const int32_t* mask, const int32_t* kend, const float* bias,
    long long bias_sb, long long bias_sh, int batch, int heads, int seq,
    int head_dim, int true_dim, int dtype, float scale, int causal,
    int dropout, const unsigned int* seed, unsigned int thr, float inv_keep,
    void* stream) {
  if (!dims_ok(head_dim, true_dim, dropout, seed))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(q, k, v, dout, lse, delta, keep, stats, mask, kend,
                         bias, bias_sb, bias_sh, batch, heads, seq, true_dim,
                         scale, causal, dropout, seed, thr, inv_keep);
  p.out = out;
  p.dlse = dlse;
  p.dq = dq;
  if (head_dim > 128)
    torch_sum_lanes(true_dim, static_cast<long long>(batch) * heads * seq,
                    &p.sum_bw, &p.sum_by);
  return static_cast<int>(launch_any<true>(
      p, dtype, head_dim, static_cast<cudaStream_t>(stream)));
}

extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, float* delta, unsigned int* keep, void* dk, void* dv,
    unsigned long long* stats, const int32_t* mask, const int32_t* kend,
    const float* bias, long long bias_sb, long long bias_sh, int batch,
    int heads, int seq, int head_dim, int true_dim, int dtype, float scale,
    int causal, int dropout, const unsigned int* seed, unsigned int thr,
    float inv_keep, void* stream) {
  if (!dims_ok(head_dim, true_dim, dropout, seed))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(q, k, v, dout, lse, delta, keep, stats, mask, kend,
                         bias, bias_sb, bias_sh, batch, heads, seq, true_dim,
                         scale, causal, dropout, seed, thr, inv_keep);
  p.dk = dk;
  p.dv = dv;
  return static_cast<int>(launch_any<false>(
      p, dtype, head_dim, static_cast<cudaStream_t>(stream)));
}
