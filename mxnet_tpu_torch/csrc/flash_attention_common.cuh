// Device helpers shared by the flash-attention kernels (forward B3 in
// flash_attention_fwd.cu, backward B4/B5 in flash_attention_bwd.cu), so that
// all three draw bit-identical dropout masks and fold batch*heads over the
// grid alike.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace flash {

constexpr float NEG_INF = -1e30f;
constexpr float MASKED_ROW = -1e29f;
// threefry key word 0 of a (batch, head): seed0 ^ (batch*head * BH_FOLD), as
// the reference's `_keep_scale` folds it
constexpr uint32_t BH_FOLD = 0x9E3779B9u;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

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
