// K2: NHWC int8 convolution as an implicit im2col GEMM, with the same
// optional fused requant epilogue as K1.
//
// Replaces src/repro/kernels/conv2d_im2col.py::conv2d_int8_pallas (with
// _make_kernel) of the JAX package. The TPU kernel streams one band of
// output rows plus its halo per grid step; because BlockSpec blocks cannot
// overlap, its wrapper materialises every overlapping band in HBM first.
// Here nothing is materialised: each block owns a 64-pixel x 64-channel
// output tile and reads its patches straight from the NHWC input in global
// memory (the im2col loader of int8_tile.cuh), with the conv padding done by
// masking out-of-image taps to zero. The batch axis is folded into the
// pixel axis (M = B*oh*ow).
//
// What bounds it on an H100: ResNet50's convolutions do 2*M*N*K operations
// on a few MB of activations and weights, so at the path's shapes the bound
// is the int8 tensor-core rate; this first version uses dp4a on CUDA cores
// (no tensor cores), so it runs far above that bound. The deep layers
// (7x7 maps, N = 512..2048) also give few tiles, leaving SMs idle. wgmma,
// TMA-fed tiles and split-K are later work, measured in PERF.md.
#include "int8_tile.cuh"

namespace {

__global__ void __launch_bounds__(rt::THREADS)
conv2d_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ mult, int mult_len, void* out,
                   int B, int H, int W, int C, int N, int kh, int kw,
                   int stride, int pad, int oh, int ow) {
  __shared__ rt::TileSmem sm;
  const int M = B * oh * ow;
  const int K = kh * kw * C;
  const int m0 = blockIdx.x * rt::BM;
  const int n0 = blockIdx.y * rt::BN;
  rt::ConvA<false> la{x, H, W, C, kw, stride, pad, oh, ow, M, K,
                      (C & 3) == 0 && rt::aligned4(x)};
  int acc[4][4];
  rt::mma_tile<false>(la, w, K, N, m0, n0, acc, sm);
  rt::store_tile(acc, out, M, N, m0, n0, mult, mult_len, 0);
}

}  // namespace

extern "C" {

// x (B, H, W, C) int8, w (kh*kw*C, N) int8 -> out (B, oh, ow, N): int8 when
// mult != NULL (requantized), else int32.
int conv2d_int8_launch(const void* x, const void* w, const void* mult,
                       int mult_len, void* out, int B, int H, int W, int C,
                       int N, int kh, int kw, int stride, int pad,
                       void* stream) {
  const int oh = (H + 2 * pad - kh) / stride + 1;
  const int ow = (W + 2 * pad - kw) / stride + 1;
  const long long M = (long long)B * oh * ow;
  if (M <= 0 || N <= 0) return 0;
  dim3 grid((unsigned)((M + rt::BM - 1) / rt::BM),
            (N + rt::BN - 1) / rt::BN);
  conv2d_int8_kernel<<<grid, rt::THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const float*)mult, mult_len, out,
      B, H, W, C, N, kh, kw, stride, pad, oh, ow);
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
