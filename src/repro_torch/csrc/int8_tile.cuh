// Shared int8 tile product for the GEMM, conv and megakernel kernels.
//
// One block of 256 threads computes a 64x64 int32 output tile. K advances
// in chunks of 32: each chunk of A (64 rows x 32) and B (32 x 64 columns)
// is packed into shared memory as int32 words of 4 consecutive K values,
// and every thread accumulates a 4x4 sub-tile with __dp4a (four signed
// int8 products summed into int32 per instruction). The accumulator stays
// in registers for the whole K loop; ragged M, N and K edges are masked on
// load (zeros contribute nothing) and on store, never padded in memory.
//
// A is read through a loader, so the same loop serves a plain GEMM
// (row-major x) and an implicit-im2col convolution (patches read straight
// from the NHWC input, with the conv padding done by the mask).
//
// Loads take a COHERENT flag: the megakernel reads buffers that other
// blocks wrote earlier in the same launch, so it loads through L2 only
// (__ldcg); the one-shot kernels use the read-only path (__ldg).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rt {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int BK4 = BK / 4;
constexpr int THREADS = 256;

struct __align__(16) TileSmem {
  int a[BK4][BM];
  int b[BK4][BN];
};

template <bool COHERENT>
__device__ __forceinline__ int ld8(const int8_t* p) {
  if (COHERENT) return (int)__ldcg((const signed char*)p);
  return (int)__ldg((const signed char*)p);
}

template <bool COHERENT>
__device__ __forceinline__ int ld32(const int8_t* p) {
  if (COHERENT) return __ldcg((const int*)p);
  return __ldg((const int*)p);
}

__device__ __forceinline__ bool aligned4(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 3) == 0;
}

__device__ __forceinline__ int pack4(int b0, int b1, int b2, int b3) {
  return (b0 & 0xff) | ((b1 & 0xff) << 8) | ((b2 & 0xff) << 16) |
         ((b3 & 0xff) << 24);
}

// Row-major x (M, K). Four K values are one 32-bit load when `vec` is set:
// K a multiple of 4 and x 4-byte aligned (every row is then aligned).
template <bool COHERENT>
struct GemmA {
  const int8_t* x;
  int M, K;
  bool vec;
  struct Row { const int8_t* p; bool valid; };
  __device__ Row row(int m) const {
    return Row{x + (size_t)m * K, m < M};
  }
  __device__ int pack(const Row& r, int k) const {
    if (!r.valid || k >= K) return 0;
    if (vec) return ld32<COHERENT>(r.p + k);
    int v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = (k + j < K) ? ld8<COHERENT>(r.p + k + j) : 0;
    return pack4(v[0], v[1], v[2], v[3]);
  }
};

// Implicit im2col over NHWC x (B, H, W, C): output row m is pixel
// (b, oy, ox); column k is (di*kw + dj)*C + c, the weight layout of
// (kh*kw*C, N). Out-of-image taps read as zero (the conv padding). `vec`:
// C a multiple of 4 and x 4-byte aligned, so 4 consecutive K values are
// channels c..c+3 of one pixel and one aligned 32-bit load.
template <bool COHERENT>
struct ConvA {
  const int8_t* x;
  int H, W, C, kw, stride, pad, oh, ow, M, K;
  bool vec;
  struct Row { const int8_t* xb; int iy0, ix0; bool valid; };
  __device__ Row row(int m) const {
    Row r{x, 0, 0, m < M};
    if (!r.valid) return r;
    int per = oh * ow;
    int b = m / per;
    int rem = m - b * per;
    int oy = rem / ow;
    int ox = rem - oy * ow;
    r.xb = x + (size_t)b * H * W * C;
    r.iy0 = oy * stride - pad;
    r.ix0 = ox * stride - pad;
    return r;
  }
  __device__ int tap(const Row& r, int k) const {
    int q = k / C;
    int c = k - q * C;
    int di = q / kw;
    int dj = q - di * kw;
    int iy = r.iy0 + di, ix = r.ix0 + dj;
    if (iy < 0 || iy >= H || ix < 0 || ix >= W) return 0;
    return ld8<COHERENT>(r.xb + ((size_t)iy * W + ix) * C + c);
  }
  __device__ int pack(const Row& r, int k) const {
    if (!r.valid || k >= K) return 0;
    if (vec) {
      int q = k / C;
      int c = k - q * C;
      int di = q / kw;
      int dj = q - di * kw;
      int iy = r.iy0 + di, ix = r.ix0 + dj;
      if (iy < 0 || iy >= H || ix < 0 || ix >= W) return 0;
      return ld32<COHERENT>(r.xb + ((size_t)iy * W + ix) * C + c);
    }
    int v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = (k + j < K) ? tap(r, k + j) : 0;
    return pack4(v[0], v[1], v[2], v[3]);
  }
};

// acc[4][4] += A[m0:m0+64, :] @ w[:, n0:n0+64] for this thread's sub-tile
// (rows m0 + ty*4 + i, columns n0 + tx*4 + j; tx = tid % 16, ty = tid / 16).
// Every thread of the block must call it (it synchronises the block).
template <bool COHERENT, class LoadA>
__device__ __forceinline__ void mma_tile(const LoadA& la,
                                         const int8_t* __restrict__ w, int K,
                                         int N, int m0, int n0, int acc[4][4],
                                         TileSmem& sm) {
  const int t = threadIdx.x;
  const int tx = t & 15, ty = t >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  const int am = t & 63;
  const typename LoadA::Row row = la.row(m0 + am);
  const int bn = n0 + (t & 63);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int k4 = (t >> 6) + 4 * p;
      const int k = k0 + 4 * k4;
      sm.a[k4][am] = la.pack(row, k);
      int v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = (bn < N && k + j < K) ? (int)__ldg(
                   (const signed char*)(w + (size_t)(k + j) * N + bn)) : 0;
      sm.b[k4][t & 63] = pack4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
#pragma unroll
    for (int k4 = 0; k4 < BK4; ++k4) {
      const int4 av = *reinterpret_cast<const int4*>(&sm.a[k4][ty * 4]);
      const int4 bv = *reinterpret_cast<const int4*>(&sm.b[k4][tx * 4]);
      const int a[4] = {av.x, av.y, av.z, av.w};
      const int b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// int32 -> int8: float32 multiply, round half to even, saturate. The same
// arithmetic as the plain version: float(acc) rounds to nearest even, the
// product is one correctly rounded multiply, __float2int_rn rounds halves
// to even (never floor(x + 0.5)).
__device__ __forceinline__ int requant1(int acc, float mult) {
  int r = __float2int_rn(__fmul_rn(__int2float_rn(acc), mult));
  return r < -128 ? -128 : (r > 127 ? 127 : r);
}

// Store this thread's 4x4 sub-tile of an (M, N) output: requantized int8
// when `mult` is given (scalar if mult_len == 1, else one per column),
// otherwise int32 (out_int8 = 0) or the int32 value cast to int8.
__device__ __forceinline__ void store_tile(const int acc[4][4], void* out,
                                           int M, int N, int m0, int n0,
                                           const float* mult, int mult_len,
                                           int out_int8) {
  const int t = threadIdx.x;
  const int tx = t & 15, ty = t >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      const size_t o = (size_t)m * N + n;
      if (mult != nullptr) {
        const float s = __ldg(mult + (mult_len == 1 ? 0 : n));
        reinterpret_cast<int8_t*>(out)[o] = (int8_t)requant1(acc[i][j], s);
      } else if (out_int8) {
        reinterpret_cast<int8_t*>(out)[o] = (int8_t)acc[i][j];
      } else {
        reinterpret_cast<int*>(out)[o] = acc[i][j];
      }
    }
  }
}

}  // namespace rt
