// Device helpers shared by the flash-attention kernels (forward B3 in
// flash_attention_fwd.cu, backward B4/B5 in flash_attention_bwd.cu) and the
// model-level dropout (dropout.cu), so that all of them draw bit-identical
// dropout bits from the same seed words and fold batch*heads over the grid
// alike.  The seed words are read from device memory, never passed by value:
// a captured CUDA graph replays its launches with the arguments it was
// captured with, so a step's words must live in a buffer that each replay
// rewrites.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace flash {

constexpr float NEG_INF = -1e30f;
// the largest head dim the kernels take (past 128 through the chunked
// kernels; B4's delta follows torch's one-block row sum up to here)
constexpr int MAX_HEAD_DIM = 32768;
constexpr float MASKED_ROW = -1e29f;
// threefry key word 0 of a (batch, head): seed0 ^ (batch*head * BH_FOLD), as
// the reference's `_keep_scale` folds it
constexpr uint32_t BH_FOLD = 0x9E3779B9u;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// f32 -> the storage type, rounded to nearest even
template <typename S>
__device__ __forceinline__ S from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// x rounded to the storage type and widened back (identity for f32)
template <typename S>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<S>(x));
}

// batch*head folded over gridDim.y x gridDim.z, so that it may exceed the
// 65535 one grid dimension takes: block (x, y, z) works on (batch, head)
// z * gridDim.y + y; blocks at or past batch*head have no work.
__device__ __forceinline__ int folded_bh() {
  return static_cast<int>(blockIdx.z * gridDim.y + blockIdx.y);
}

inline dim3 fold_grid(int gx, int bh) {
  const int gz = (bh + 65534) / 65535;
  return dim3(gx, (bh + gz - 1) / gz, gz);
}

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds, first output word: `_threefry2x32` of the
// reference, in native uint32 arithmetic (wraps at 2^32).
__device__ __forceinline__ uint32_t threefry2x32(uint32_t k0, uint32_t k1,
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
      x1 = rotl32(x1, rot[i % 2][j]);
      x1 ^= x0;
    }
    x0 += inj[i][0];
    x1 += inj[i][1] + static_cast<uint32_t>(i + 1);
  }
  return x0;
}

// The threefry key of one (batch, head): key word 0 folded with batch*head,
// and key word 1, from the two seed words at `seed` (device memory; zeros,
// and `seed` unread, without dropout).
struct SeedKey {
  uint32_t key0;
  uint32_t key1;
};

__device__ __forceinline__ SeedKey seed_key(const uint32_t* seed, int dropout,
                                            int bh) {
  if (!dropout) return {0u, 0u};
  return {__ldg(seed) ^ (static_cast<uint32_t>(bh) * BH_FOLD),
          __ldg(seed + 1)};
}

// Max / sum over the 8 lanes of a shuffle group (lanes 8g .. 8g+7).
__device__ __forceinline__ float row_max8(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  return x;
}

__device__ __forceinline__ float row_sum8(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

}  // namespace flash
