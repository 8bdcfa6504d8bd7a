// Tensor-core building blocks shared by the Hopper kernels that run their
// products on mma.sync: the stem conv (B2, stem_matmul.cu), the flash forward
// (B3, flash_attention_fwd.cu) and the flash backward (B4/B5,
// flash_attention_bwd.cu).  One copy of each helper:
//
// - 16- and 4-byte cp.async from global to shared memory (zero-filled when
//   the source is out of range), and their commit / wait;
// - ldmatrix of four 8x8 16-bit matrices, plain and transposed;
// - a traits struct per 16-bit input type (bf16, f16): the m16n8k16 MMA with
//   f32 accumulation, packing two f32 values into one register (round to
//   nearest even, as PyTorch's cast), the 16-bit pattern <-> value, and the
//   test whether an f32 value lies near a rounding tie of the type;
// - an A operand built straight from two accumulator fragments.
//
// Fragment layout (PTX ISA, mma.m16n8k16): lane = 4 g + t holds accumulator
// elements (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1) of a 16 x 8
// tile, and A elements (g, 2t..2t+1), (g + 8, 2t..), (g, 2t + 8..),
// (g + 8, 2t + 8..) of a 16 x 16 tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 (or 4) bytes from global to shared memory, zero-filled when !valid
// (src must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 16-bit matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// bfloat16: 8 significant bits, f32's exponent range.
struct Bf16 {
  using T = __nv_bfloat16;

  // c (16 x 8, f32) += a (16 x 16, row) * b (16 x 8, col)
  static __device__ __forceinline__ void mma(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }

  // Two floats rounded (to nearest even), lo in the low half.
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }

  static __device__ __forceinline__ float2 unpack(uint32_t w) {
    return make_float2(__uint_as_float(w << 16),
                       __uint_as_float(w & 0xFFFF0000u));
  }

  static __device__ __forceinline__ uint32_t bits(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }

  static __device__ __forceinline__ float value(uint32_t b) {
    return __uint_as_float(b << 16);
  }

  // Whether f32 x, known to within abs_err of the value the plain version
  // computes, could round to another bf16 than that value does: x lies
  // within abs_err (plus 4 ulps) of a bf16 rounding tie (low 16 bits
  // 0x8000).
  static __device__ __forceinline__ bool near_tie(float x, float abs_err) {
    const float ax = fabsf(x);
    const int dist =
        abs(static_cast<int>(__float_as_uint(x) & 0xFFFFu) - 0x8000);
    // ulp(x) >= |x| 2^-24, so abs_err spans at most abs_err 2^24 / |x| ulps
    return ax != 0.f && static_cast<float>(dist) * ax <=
                            abs_err * 16777216.f + 4.f * ax;
  }
};

// float16: 11 significant bits, normal down to 2^-14, then subnormal with a
// fixed ulp of 2^-24.
struct F16 {
  using T = __half;

  static __device__ __forceinline__ void mma(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }

  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }

  static __device__ __forceinline__ float2 unpack(uint32_t w) {
    return __half22float2(*reinterpret_cast<const __half2*>(&w));
  }

  static __device__ __forceinline__ uint32_t bits(float x) {
    return __half_as_ushort(__float2half_rn(x));
  }

  static __device__ __forceinline__ float value(uint32_t b) {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(b)));
  }

  // As Bf16::near_tie, with the tie taken from x's own f16 ulp: 2^(e - 10)
  // for |x| in [2^e, 2^(e+1)) from 2^-14 up, 2^-24 below (subnormal).  The
  // tie of the cell [n, n + 1) ulps is at n + 1/2; at the foot of a binade
  // the tie below it (a quarter of this ulp down) is checked too.
  static __device__ __forceinline__ bool near_tie(float x, float abs_err) {
    const float ax = fabsf(x);
    if (ax == 0.f) return false;
    const int e = static_cast<int>((__float_as_uint(ax) >> 23) & 0xFFu) - 127;
    const int ue = max(e - 10, -24);
    const float ulp = __uint_as_float(static_cast<uint32_t>(ue + 127) << 23);
    const float r = ax / ulp;   // exact: ulp is a power of two
    const float n = floorf(r);
    float dist = fabsf(r - (n + 0.5f)) * ulp;
    if (n == 1024.f && ue > -24) dist = fminf(dist, (r - n + 0.25f) * ulp);
    // 4 f32 ulps of x, each at most |x| 2^-23
    return dist <= abs_err + 4.f * 1.1920929e-7f * ax;
  }
};

// An A operand (16 x 16) from accumulator fragments n-blocks 2kk, 2kk + 1,
// each value rounded to the traits' type.
template <typename TR>
__device__ __forceinline__ void to_a_frag(uint32_t (&a)[4],
                                          const float (&c0)[4],
                                          const float (&c1)[4]) {
  a[0] = TR::pack(c0[0], c0[1]);
  a[1] = TR::pack(c0[2], c0[3]);
  a[2] = TR::pack(c1[0], c1[1]);
  a[3] = TR::pack(c1[2], c1[3]);
}

}  // namespace hopper
