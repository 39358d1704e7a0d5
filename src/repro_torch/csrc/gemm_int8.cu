// K1: int8 x int8 -> int32 GEMM with an optional fused requant epilogue.
//
// Replaces src/repro/kernels/gemm_int8.py::gemm_int8_pallas (with
// _gemm_kernel, _gemm_requant_kernel and requant_epilogue) of the JAX
// package. On the TPU the K axis is the innermost sequential grid axis and
// the int32 accumulator persists in VMEM scratch across it; here each block
// owns one 64x64 output tile and loops over K itself, with the accumulator
// in registers (int8_tile.cuh). A leading batch axis is folded into M by the
// wrapper: the weights are shared, so (B, M, K) @ (K, N) is one (B*M, K)
// product.
//
// What bounds it on an H100: at the path's shape (the classifier, M = batch,
// K = 2048, N = 1000) the 2 MB of weights dominate the bytes, so the bound
// is memory (weights over 3.35 TB/s, under a microsecond), while the
// 64x64 tiles leave the grid at ceil(N/64) = 16 blocks, so the product runs
// on 16 of 132 SMs. This first version keeps the simple tile (dp4a, no
// tensor cores); a split-K grid and wgmma tiles are later work, measured in
// PERF.md.
#include "int8_tile.cuh"

namespace {

__global__ void __launch_bounds__(rt::THREADS)
gemm_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ mult, int mult_len, void* out,
                 int M, int K, int N) {
  __shared__ rt::TileSmem sm;
  const int m0 = blockIdx.x * rt::BM;
  const int n0 = blockIdx.y * rt::BN;
  rt::GemmA<false> la{x, M, K, (K & 3) == 0 && rt::aligned4(x)};
  int acc[4][4];
  rt::mma_tile<false>(la, w, K, N, m0, n0, acc, sm);
  rt::store_tile(acc, out, M, N, m0, n0, mult, mult_len, 0);
}

}  // namespace

extern "C" {

// out: int8 (M, N) when mult != NULL (requantized), else int32 (M, N).
int gemm_int8_launch(const void* x, const void* w, const void* mult,
                     int mult_len, void* out, int M, int K, int N, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  dim3 grid((M + rt::BM - 1) / rt::BM, (N + rt::BN - 1) / rt::BN);
  gemm_int8_kernel<<<grid, rt::THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const float*)mult, mult_len, out,
      M, K, N);
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
