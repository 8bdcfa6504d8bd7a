// Model-level dropout for Hopper (sm_90a), CUDA C++: a forward kernel that
// hashes the mask and writes it packed, and a backward kernel that reads it.
//
// Not the port of a Pallas kernel: the reference's dropout
// (mxnet_tpu/ops/nn.py:566 `dropout`) draws its mask from XLA's random bits,
// and no mask of the port matches them.  The port hashes its own from the
// two seed words of the draw, one Threefry-2x32 hash (20 rounds, the hash
// the flash kernels use) for each pair of elements, both output words used:
//
//   (w0, w1) = threefry2x32(seed0, seed1, j mod 2^32, j div 2^32), pair j
//   keep(2j) = w0 < thr,  keep(2j + 1) = w1 < thr   (an odd n's last
//                                                   element takes w0)
//   out[i]   = keep(i) ? x[i] * inv_keep : 0        (f32 product, one
//                                                   rounding)
//   bits[i / 32] bit (i mod 32) = keep(i)           (uint32 words; the bits
//                                                   past n are 0)
//
// The backward applies the same mask to the output gradient from the packed
// bits (n / 8 bytes) and hashes nothing:
//
//   dx[i] = keep(i) ? dy[i] * inv_keep : 0
//
// The seed words are read from device memory, so that a training step
// captured as a CUDA graph draws fresh bits at every replay from the words
// the host writes into its seed buffer.
//
// What bounds it.  The forward's integer work: a hash is about 70 integer
// instructions (add, rotate, xor and the key injections), some 35 an element
// at one hash a pair, against 4 bytes an element moved in bf16; at Hopper's
// 64 INT32 instructions a clock an SM the hashes take several times the
// bytes' time.  Using both words halves them against one hash an element.
// The backward moves bytes only (read dy and bits, write dx).  chip_smoke.py
// counts the forward's integer instructions in its SASS and holds its time
// against both bounds.
//
// Design.  Both kernels move the data in 16-byte vectors (8 bf16/f16 or 4
// f32 elements a thread), from the first element whose address is 16-byte
// aligned, `head` elements in; the head and the tail past the last whole
// vector move one element at a time.  The output is allocated with the
// input's offset from a 16-byte boundary (the wrapper sees to it), so one
// `head` serves both.  A forward block takes tiles of NTHREADS * V elements;
// thread t hashes the index-aligned group of V elements t * V.. of the tile
// (V / 2 independent hashes), the groups of a word OR their masks together
// by warp shuffles, and one lane writes the word.  Aligned data (head 0)
// takes the thread's own group; otherwise each group's mask goes through
// shared memory and a thread's vector, `head` elements later, takes its bits
// from its group and the next (the tile's last thread from the next tile's
// first group, hashed once more).  The backward reads its vector's V bits
// from one or two words.

#include "flash_attention_common.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr long long MAX_GRID = 132 * 32;
constexpr unsigned FULL = 0xffffffffu;

struct Words {
  uint32_t w0;
  uint32_t w1;
};

// Threefry-2x32, 20 rounds, both output words (`ops/threefry.threefry2x32`);
// flash::threefry2x32 is the same hash returning the first word.
__device__ __forceinline__ Words threefry2x32_both(uint32_t k0, uint32_t k1,
                                                   uint32_t c0, uint32_t c1) {
  const uint32_t ks2 = 0x1BD11BDAu ^ k0 ^ k1;
  const uint32_t inj[5][2] = {{k1, ks2}, {ks2, k0}, {k0, k1}, {k1, ks2},
                              {ks2, k0}};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = flash::rotl32(x1, rot[i % 2][j]);
      x1 ^= x0;
    }
    x0 += inj[i][0];
    x1 += inj[i][1] + static_cast<uint32_t>(i + 1);
  }
  return {x0, x1};
}

// keep bits of the V elements first.. (first even): bit k for first + k
template <int V>
__device__ __forceinline__ uint32_t keep_mask(uint32_t s0, uint32_t s1,
                                              long long first, uint32_t thr) {
  const unsigned long long j0 = static_cast<unsigned long long>(first) >> 1;
  uint32_t mask = 0;
#pragma unroll
  for (int q = 0; q < V / 2; ++q) {
    const unsigned long long j = j0 + q;
    const Words w = threefry2x32_both(s0, s1, static_cast<uint32_t>(j),
                                      static_cast<uint32_t>(j >> 32));
    mask |= static_cast<uint32_t>(w.w0 < thr) << (2 * q);
    mask |= static_cast<uint32_t>(w.w1 < thr) << (2 * q + 1);
  }
  return mask;
}

// the low `r` of V bits (none for r <= 0, all for r >= V)
template <int V>
__device__ __forceinline__ uint32_t low_bits(long long r) {
  return r <= 0 ? 0u : r >= V ? (1u << V) - 1u : (1u << r) - 1u;
}

// The 32 / V groups of one word (consecutive lanes, the first at a word
// boundary) OR their masks; the first lane writes the word.  Every lane of
// the warp calls it.
template <int V>
__device__ __forceinline__ void store_word(uint32_t mask, long long first,
                                           uint32_t* bits, long long n_words) {
  uint32_t w = mask << (first & 31);
#pragma unroll
  for (int s = 1; s < 32 / V; s <<= 1) w |= __shfl_xor_sync(FULL, w, s);
  if ((first & 31) == 0 && (first >> 5) < n_words) bits[first >> 5] = w;
}

template <typename S>
__device__ __forceinline__ S apply1(S v, uint32_t keep, float inv_keep) {
  return keep ? flash::from_f32<S>(flash::to_f32(v) * inv_keep)
              : flash::from_f32<S>(0.f);
}

// one 16-byte vector at element e (16-byte aligned in src and dst), bit k of
// `mask` keeping element e + k
template <typename S, int V>
__device__ __forceinline__ void apply_vec(const S* src, S* dst, long long e,
                                          uint32_t mask, float inv_keep) {
  alignas(16) S v[V];
  *reinterpret_cast<uint4*>(v) = __ldg(reinterpret_cast<const uint4*>(src + e));
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = apply1(v[k], (mask >> k) & 1u, inv_keep);
  *reinterpret_cast<uint4*>(dst + e) = *reinterpret_cast<const uint4*>(v);
}

// One forward tile with every bound checked: its groups hashed (past n the
// bits are 0) and their words written, then the data `head` elements later
// (the tensor's head too, in tile 0).  Every thread of the block calls it.
template <typename S, int V>
__device__ void forward_tile(const S* x, S* out, uint32_t* bits,
                             uint32_t s0, uint32_t s1, long long n,
                             long long n_words, int head, uint32_t thr,
                             float inv_keep, long long tile, uint32_t* sm) {
  constexpr long long TILE = static_cast<long long>(NTHREADS) * V;
  const int t = threadIdx.x;
  const long long tile0 = tile * TILE;
  const long long first = tile0 + static_cast<long long>(t) * V;
  const uint32_t mask = keep_mask<V>(s0, s1, first, thr) & low_bits<V>(n - first);
  store_word<V>(mask, first, bits, n_words);
  sm[t] = mask;
  if (t == 0) {
    const long long next = tile0 + TILE;
    sm[NTHREADS] = head > 0 && next < n
        ? keep_mask<V>(s0, s1, next, thr) & low_bits<V>(n - next)
        : 0u;
  }
  __syncthreads();
  if (tile == 0 && t < head && t < n)
    out[t] = apply1(x[t], (sm[0] >> t) & 1u, inv_keep);
  const long long e = first + head;
  const uint32_t m = (sm[t] | (sm[t + 1] << V)) >> head;
  if (e + V <= n) {
    apply_vec<S, V>(x, out, e, m, inv_keep);
  } else {
    for (int k = 0; k < V && e + k < n; ++k)
      out[e + k] = apply1(x[e + k], (m >> k) & 1u, inv_keep);
  }
  __syncthreads();
}

// SHIFTED: x and out start `head` > 0 elements before a 16-byte boundary;
// every tile takes the checked path.  Otherwise the whole tiles take the
// fast path (no bound, no shared memory) and the last, partial tile the
// checked one.
template <typename S, bool SHIFTED>
__global__ void __launch_bounds__(NTHREADS)
dropout_fwd_kernel(const S* __restrict__ x, S* __restrict__ out,
                   uint32_t* __restrict__ bits,
                   const uint32_t* __restrict__ seed, long long n, int head,
                   uint32_t thr, float inv_keep) {
  constexpr int V = 16 / sizeof(S);
  constexpr long long TILE = static_cast<long long>(NTHREADS) * V;
  __shared__ uint32_t sm[NTHREADS + 1];
  const uint32_t s0 = __ldg(seed);
  const uint32_t s1 = __ldg(seed + 1);
  const long long n_words = (n + 31) >> 5;
  const long long tiles = (n + TILE - 1) / TILE;
  if constexpr (SHIFTED) {
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x)
      forward_tile<S, V>(x, out, bits, s0, s1, n, n_words, head, thr,
                         inv_keep, tile, sm);
  } else {
    const long long whole = n / TILE;
    for (long long tile = blockIdx.x; tile < whole; tile += gridDim.x) {
      const long long first =
          tile * TILE + static_cast<long long>(threadIdx.x) * V;
      const uint32_t mask = keep_mask<V>(s0, s1, first, thr);
      store_word<V>(mask, first, bits, n_words);
      apply_vec<S, V>(x, out, first, mask, inv_keep);
    }
    if (whole < tiles && blockIdx.x == whole % gridDim.x)
      forward_tile<S, V>(x, out, bits, s0, s1, n, n_words, 0, thr, inv_keep,
                         whole, sm);
  }
}

// keep bits of the V elements e.. from the packed words (one or two)
template <int V>
__device__ __forceinline__ uint32_t bits_at(const uint32_t* bits, long long e) {
  const long long w = e >> 5;
  const int off = static_cast<int>(e & 31);
  unsigned long long both = __ldg(bits + w);
  if (off + V > 32)
    both |= static_cast<unsigned long long>(__ldg(bits + w + 1)) << 32;
  return static_cast<uint32_t>(both >> off) & ((1u << V) - 1u);
}

// dy and dx start `head` elements before a 16-byte boundary: whole vectors
// from there, grid-stride; the head and the tail one element a thread
template <typename S>
__global__ void __launch_bounds__(NTHREADS)
dropout_bwd_kernel(const S* __restrict__ dy, const uint32_t* __restrict__ bits,
                   S* __restrict__ dx, long long n, int head, float inv_keep) {
  constexpr int V = 16 / sizeof(S);
  const long long hd = head < n ? head : n;
  const long long vecs = (n - hd) / V;
  const long long tail0 = hd + vecs * V;
  const long long i0 =
      static_cast<long long>(blockIdx.x) * NTHREADS + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * NTHREADS;
  for (long long k = i0; k < vecs; k += stride) {
    const long long e = hd + k * V;
    apply_vec<S, V>(dy, dx, e, bits_at<V>(bits, e), inv_keep);
  }
  if (i0 < hd + (n - tail0)) {
    const long long i = i0 < hd ? i0 : tail0 + (i0 - hd);
    dx[i] = apply1(dy[i], (__ldg(bits + (i >> 5)) >> (i & 31)) & 1u,
                   inv_keep);
  }
}

long long grid_of(long long work) {
  return work < 1 ? 1 : work < MAX_GRID ? work : MAX_GRID;
}

// elements of size `esize` before `p`'s next 16-byte boundary, or -1 when
// `q` is not as far from one (or `p` is not a whole element from it)
int head_of(const void* p, const void* q, int esize) {
  const uintptr_t mp = reinterpret_cast<uintptr_t>(p) % 16;
  const uintptr_t mq = reinterpret_cast<uintptr_t>(q) % 16;
  if (mp != mq || mp % esize) return -1;
  return mp ? static_cast<int>((16 - mp) / esize) : 0;
}

template <typename S>
cudaError_t forward(const void* x, void* out, uint32_t* bits,
                    const uint32_t* seed, long long n, int head, uint32_t thr,
                    float inv_keep, cudaStream_t stream) {
  constexpr long long TILE = static_cast<long long>(NTHREADS) * (16 / sizeof(S));
  const int grid = static_cast<int>(grid_of((n + TILE - 1) / TILE));
  const S* xs = static_cast<const S*>(x);
  S* os = static_cast<S*>(out);
  if (head)
    dropout_fwd_kernel<S, true><<<grid, NTHREADS, 0, stream>>>(
        xs, os, bits, seed, n, head, thr, inv_keep);
  else
    dropout_fwd_kernel<S, false><<<grid, NTHREADS, 0, stream>>>(
        xs, os, bits, seed, n, 0, thr, inv_keep);
  return cudaGetLastError();
}

template <typename S>
cudaError_t backward(const void* dy, const uint32_t* bits, void* dx,
                     long long n, int head, float inv_keep,
                     cudaStream_t stream) {
  constexpr int V = 16 / sizeof(S);
  const int grid = static_cast<int>(grid_of((n / V + NTHREADS - 1) / NTHREADS));
  dropout_bwd_kernel<S><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const S*>(dy), bits, static_cast<S*>(dx), n, head,
      inv_keep);
  return cudaGetLastError();
}

int esize_of(int dtype) {
  return dtype == 0 ? 4 : (dtype == 1 || dtype == 2) ? 2 : 0;
}

}  // namespace

// x and out: n contiguous elements of dtype 0 = float32, 1 = bfloat16,
// 2 = float16, out a buffer of its own at x's offset from a 16-byte
// boundary; bits: ceil(n / 32) uint32 words written whole; seed: the two
// uint32 seed words; keep is bits < thr.  Every pointer is a device pointer.
// Launches on `stream` and does not synchronise; returns the CUDA error of
// the launch.
extern "C" int dropout_forward(const void* x, void* out, unsigned int* bits,
                               const unsigned int* seed, long long n,
                               int dtype, unsigned int thr, float inv_keep,
                               void* stream) {
  const int esize = esize_of(dtype);
  if (n < 1 || seed == nullptr || bits == nullptr || esize == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int head = head_of(x, out, esize);
  if (head < 0) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = forward<float>(x, out, bits, seed, n, head, thr, inv_keep, st);
  else if (dtype == 1)
    err = forward<__nv_bfloat16>(x, out, bits, seed, n, head, thr, inv_keep,
                                 st);
  else
    err = forward<__half>(x, out, bits, seed, n, head, thr, inv_keep, st);
  return static_cast<int>(err);
}

// dy and dx: n contiguous elements of dtype (as above), dx at dy's offset
// from a 16-byte boundary; bits: the forward's words.  Launches on `stream`
// and does not synchronise; returns the CUDA error of the launch.
extern "C" int dropout_backward(const void* dy, const unsigned int* bits,
                                void* dx, long long n, int dtype,
                                float inv_keep, void* stream) {
  const int esize = esize_of(dtype);
  if (n < 1 || bits == nullptr || esize == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int head = head_of(dy, dx, esize);
  if (head < 0) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = backward<float>(dy, bits, dx, n, head, inv_keep, st);
  else if (dtype == 1)
    err = backward<__nv_bfloat16>(dy, bits, dx, n, head, inv_keep, st);
  else
    err = backward<__half>(dy, bits, dx, n, head, inv_keep, st);
  return static_cast<int>(err);
}
