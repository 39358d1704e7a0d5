// K2: NHWC int8 convolution as an implicit im2col GEMM on the int8 tensor
// cores, with split-K inside the one launch and the same optional fused
// requant epilogue as K1.
//
// Replaces src/repro/kernels/conv2d_im2col.py::conv2d_int8_pallas (with
// _make_kernel) of the JAX package. The TPU kernel streams one band of
// output rows plus its halo per grid step; because BlockSpec blocks cannot
// overlap, its wrapper materialises every overlapping band in HBM first.
// Here nothing is materialised: each block reads its patches straight from
// the NHWC input (int8_mma.cuh), the conv padding being the zero fill of
// out-of-image taps. The batch axis is folded into the pixel axis
// (M = B*oh*ow), the output is (M, N) row major = (B, oh, ow, N).
//
// What bounds it on an H100: ResNet50-224's 50 tiled convs do 3.7 GMAC,
// 3.8 us at the int8 tensor-core rate (1,979 TOP/s); their bytes (13 us at
// 3.35 TB/s) set the bound. What kept the first version (dp4a on CUDA
// cores, one block per 64 x 64 tile) far above it was the grid: the deep
// layers (7 x 7 and 14 x 14 maps) give 8-64 tiles on 132 SMs, each walking
// a K of up to 4,608 alone. This version multiplies with
// mma.sync.m16n8k32 (s8, int32 accumulators: exact, so every output is
// bit for bit the plain version's), feeds A with 16-byte cp.async copies
// through a 3-stage ring, and splits K over grid.y so that tiles x splits
// fill the card. The split count comes from the wrapper
// (kernels/conv2d_im2col.py::conv_splits); the partial tiles meet in an
// int32 workspace and the last block of each tile, chosen by a ticket
// counter, sums them and writes the output, all in this launch.
#include "int8_mma.cuh"

namespace {

template <bool VEC_A, bool VEC_B>
__global__ void __launch_bounds__(i8mma::THREADS)
conv2d_int8_kernel(i8mma::ConvGeom g, const float* __restrict__ mult,
                   int mult_len, void* out, int tiles_m, int chunks, int S,
                   int* ws, int* counters) {
  __shared__ i8mma::Smem sm;
  i8mma::run_item<VEC_A, VEC_B, false>(
      g, mult, mult_len, out,
      mult != nullptr ? i8mma::OUT_REQUANT : i8mma::OUT_I32, tiles_m, chunks,
      blockIdx.x, blockIdx.y, S, ws, counters, sm);
}

}  // namespace

extern "C" {

// x (B, H, W, C) int8, w (kh*kw*C, N) int8 -> out (B, oh, ow, N): int8 when
// mult != NULL (requantized), else int32. `splits` (1 <= splits <= the
// number of 64-deep K chunks) splits K over grid.y; with splits > 1, `ws`
// holds tiles*splits*64*64 int32 and `counters` tiles int32 zeros (left
// at zero on return).
int conv2d_int8_launch(const void* x, const void* w, const void* mult,
                       int mult_len, void* out, int B, int H, int W, int C,
                       int N, int kh, int kw, int stride, int pad, int splits,
                       void* ws, void* counters, void* stream) {
  const int oh = (H + 2 * pad - kh) / stride + 1;
  const int ow = (W + 2 * pad - kw) / stride + 1;
  const long long M = (long long)B * oh * ow;
  if (M <= 0 || N <= 0) return 0;
  const int K = kh * kw * C;
  const int chunks = (K + i8mma::BK - 1) / i8mma::BK;
  const long long tiles_m = (M + i8mma::BM - 1) / i8mma::BM;
  const long long tiles = tiles_m * ((N + i8mma::BN - 1) / i8mma::BN);
  if (M > 0x7fffffffLL || tiles > 0x7fffffffLL || splits < 1 ||
      splits > chunks || splits > 65535 ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  i8mma::ConvGeom g{(const int8_t*)x, (const int8_t*)w, H, W, C, N, kw,
                    stride, pad, oh, ow, (int)M, K};
  const bool vec_a = C % 16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool vec_b = N % 8 == 0 && (reinterpret_cast<uintptr_t>(w) & 7) == 0;
  dim3 grid((unsigned)tiles, splits);
  auto kern = vec_a ? (vec_b ? conv2d_int8_kernel<true, true>
                             : conv2d_int8_kernel<true, false>)
                    : (vec_b ? conv2d_int8_kernel<false, true>
                             : conv2d_int8_kernel<false, false>);
  kern<<<grid, i8mma::THREADS, 0, (cudaStream_t)stream>>>(
      g, (const float*)mult, mult_len, out, (int)tiles_m, chunks, splits,
      (int*)ws, (int*)counters);
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
