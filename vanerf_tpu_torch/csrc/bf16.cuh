// bfloat16 <-> float32 for the bfloat16 bodies of kernels D, 10, 11 and 12.
//
// A bfloat16 is the upper half of a float32, so widening is a shift and
// is exact; narrowing rounds to nearest, ties to even (NaN stays NaN), as
// torch's `.to(torch.bfloat16)` does, so a kernel and its plain twin round
// a float32 value to the same bfloat16.
#pragma once

#include <cuda_bf16.h>

__device__ __forceinline__ float vt_bf16_float(unsigned short b) {
  return __uint_as_float(static_cast<unsigned>(b) << 16);
}

__device__ __forceinline__ unsigned short vt_bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// x rounded to bfloat16, held as a float32
__device__ __forceinline__ float vt_bf16_round(float x) {
  return vt_bf16_float(vt_bf16_bits(x));
}

// the low / high bfloat16 of a 32-bit word, widened
__device__ __forceinline__ float vt_bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float vt_bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// two floats rounded to bfloat16 and packed, `lo` in the low half
__device__ __forceinline__ unsigned vt_bf16_pack(float lo, float hi) {
  return static_cast<unsigned>(vt_bf16_bits(lo)) |
         (static_cast<unsigned>(vt_bf16_bits(hi)) << 16);
}
