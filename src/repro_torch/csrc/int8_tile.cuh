// Scalar int8 helpers shared by the int8 kernels (K1, K2, K3): the requant
// epilogue and byte packing. The tile products live in int8_mma.cuh (the
// int8 tensor cores) and in gemm_int8.cu (K1's skinny route, __dp4a).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rt {

// Four int8 values (low bytes of b0..b3) in one word, b0 in byte 0.
__device__ __forceinline__ int pack4(int b0, int b1, int b2, int b3) {
  return (b0 & 0xff) | ((b1 & 0xff) << 8) | ((b2 & 0xff) << 16) |
         ((b3 & 0xff) << 24);
}

// int32 -> int8: float32 multiply, round half to even, saturate. The same
// arithmetic as the plain version: float(acc) rounds to nearest even, the
// product is one correctly rounded multiply, __float2int_rn rounds halves
// to even (never floor(x + 0.5)).
__device__ __forceinline__ int requant1(int acc, float mult) {
  int r = __float2int_rn(__fmul_rn(__int2float_rn(acc), mult));
  return r < -128 ? -128 : (r > 127 ? 127 : r);
}

}  // namespace rt
