// K6: one mesh rank's share of an int8 conv or GEMM, given as a table of
// output rectangles (the rank's tiles), into an int32 partial that is zero
// outside them.
//
// Replaces src/repro/cluster/mesh.py::_tiled_partial of the JAX package (a
// fori_loop of lax.dot_general over the tile table, not a Pallas kernel).
// Every rank of the mesh's model axis computes only the tiles of its block
// of the schedule's cores; an all-reduce over the axis then sums the
// disjoint partials into the whole output.
//
// One launch takes the whole table of one op. The wrapper
// (kernels/tiled_int8.py) cuts the rectangles into 64 x 64 sub-blocks on
// the host: each sub-block is a work item (m0, m1, n0, n1), computed as a
// full 64 x 64 tile of int8_mma.cuh (implicit im2col for the conv; a GEMM
// is a 1 x 1 conv with H = M, W = 1, C = K, as K1 runs above M = 16) and
// stored only inside [m0, m1) x [n0, n1). grid.x walks the work items,
// grid.y the batch. Tiles are disjoint (the lowering checks that they
// cover each op exactly once), so no two blocks write one element and no
// atomics are needed; the products are int32 on the tensor cores, so
// every value is bit for bit the plain version's.
#include "int8_mma.cuh"

namespace {

// Store the clipped tile: rows [m0, m1), columns [n0, n1) of an output
// whose rows are N wide.
__device__ __forceinline__ void store_clipped(const int (&acc)[2][4][4],
                                              int* out, int N, int m0,
                                              int m1, int n0, int n1) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + (warp & 1) * 32 + 16 * mi + g + 8 * h;
      if (m >= m1) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + (warp >> 1) * 32 + 8 * ni + 2 * tig + e;
          if (n < n1) out[(size_t)m * N + n] = acc[mi][ni][2 * h + e];
        }
    }
}

template <bool VEC_A, bool VEC_B>
__global__ void __launch_bounds__(i8mma::THREADS)
tiled_int8_kernel(i8mma::ConvGeom g, const int4* __restrict__ items,
                  int* out, int chunks) {
  __shared__ i8mma::Smem sm;
  const int4 it = items[blockIdx.x];
  const size_t b = blockIdx.y;
  g.x += b * g.H * g.W * g.C;
  int acc[2][4][4];
  i8mma::conv_tile<VEC_A, VEC_B, false>(g, it.x, it.z, 0, chunks, acc, sm);
  store_clipped(acc, out + b * g.M * g.N, g.N, it.x, it.y, it.z, it.w);
}

}  // namespace

extern "C" {

// x (B, H, W, C) int8, w (kh*kw*C, N) int8, items (n_items, 4) int32 work
// items (m0, m1, n0, n1) with m1 - m0 <= 64 and n1 - n0 <= 64 -> out
// (B, oh*ow, N) int32, written inside the items only (the caller zeroes
// what they do not cover).
int tiled_int8_launch(const void* x, const void* w, const void* items,
                      int n_items, void* out, int B, int H, int W, int C,
                      int N, int kh, int kw, int stride, int pad,
                      void* stream) {
  const int oh = (H + 2 * pad - kh) / stride + 1;
  const int ow = (W + 2 * pad - kw) / stride + 1;
  const long long M = (long long)oh * ow;
  if (n_items == 0 || B == 0 || M <= 0 || N <= 0) return 0;
  if (n_items < 0 || B > 65535 || M > 0x7fffffffLL ||
      (long long)B * M * N > (1LL << 40))
    return (int)cudaErrorInvalidValue;
  const int K = kh * kw * C;
  const int chunks = (K + i8mma::BK - 1) / i8mma::BK;
  i8mma::ConvGeom g{(const int8_t*)x, (const int8_t*)w, H, W, C, N, kw,
                    stride, pad, oh, ow, (int)M, K};
  const bool vec_a = C % 16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool vec_b = N % 8 == 0 && (reinterpret_cast<uintptr_t>(w) & 7) == 0;
  dim3 grid((unsigned)n_items, (unsigned)B);
  auto kern = vec_a ? (vec_b ? tiled_int8_kernel<true, true>
                             : tiled_int8_kernel<true, false>)
                    : (vec_b ? tiled_int8_kernel<false, true>
                             : tiled_int8_kernel<false, false>);
  kern<<<grid, i8mma::THREADS, 0, (cudaStream_t)stream>>>(
      g, (const int4*)items, (int*)out, chunks);
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
