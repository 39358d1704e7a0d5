// K1: int8 x int8 -> int32 GEMM with an optional fused requant epilogue.
//
// Replaces src/repro/kernels/gemm_int8.py::gemm_int8_pallas (with
// _gemm_kernel, _gemm_requant_kernel and requant_epilogue) of the JAX
// package. On the TPU the K axis is the innermost sequential grid axis and
// the int32 accumulator persists in VMEM scratch across it; here K is split
// over blocks that run side by side, and their int32 partials are summed
// inside the same launch. A leading batch axis is folded into M by the
// wrapper: the weights are shared, so (B, M, K) @ (K, N) is one (B*M, K)
// product.
//
// What bounds it on an H100: at the path's shape (the classifier, M =
// batch 1 or 8, K = 2048, N = 1000) the 2 MB of weights are the bytes, 0.6
// us at 3.35 TB/s, while the operations take 0.02 us at the int8
// tensor-core rate. The first version (64 x 64 dp4a tiles) ran 16 blocks,
// each walking K = 2048 alone with byte loads of the weights: 60 us. Two
// routes now, chosen by M (kernels/gemm_int8.py::gemm_splits mirrors the
// choice and the split count, and the CPU tests hold it):
//
//   M <= 16 (the path), the skinny route, on the CUDA cores: a tensor-core
//   tile would pad M to 16 rows and gain nothing on a product bound by its
//   weight bytes. A block of 256 threads covers 64 columns, 8 threads
//   across (8 columns each) and 32 K lanes down. Each thread reads 4 rows
//   x 8 columns of w as 8-byte loads (a row of N = 1000 bytes is 8-byte
//   aligned, not 16), keeps up to 16 of them in flight, turns each 4 x 8
//   block into 8 __dp4a words with byte permutes (int8_mma.cuh's
//   transpose_4x8) and multiplies them with every x row's 4-K word,
//   broadcast from shared memory. The 32 lanes of a column meet by warp
//   shuffles and shared-memory adds. K is split over grid.y so that column
//   tiles x splits fill the card (16 x 9 = 144 blocks at N 1000); each
//   block writes its M x 64 partial (at M = 8, 288 KB in all against the 2
//   MB of weights) to its slice of a workspace, and the last block of the
//   column tile, picked by a ticket counter, sums the slices, resets the
//   counter and runs the epilogue (the scheme of K2).
//
//   M > 16, the int8 tensor-core tile of K2 (int8_mma.cuh, mma.sync
//   m16n8k32) in the 1x1 conv geometry: one pixel per row (H = W = 1, C =
//   K), split over K as K2 splits it.
//
// Integer sums are exact in any order, so every output is bit for bit the
// plain version's; the epilogue is rt::requant1.
#include "int8_mma.cuh"

namespace {

constexpr int SK_M = 16;                   // the skinny route's largest M
constexpr int SK_THREADS = 256;
constexpr int SK_TX = 8;                   // column threads, 8 columns each
constexpr int SK_TY = SK_THREADS / SK_TX;  // K lanes (32)
constexpr int SK_BN = 8 * SK_TX;           // columns per block (64)
constexpr int SK_CHUNK = 4 * SK_TY;        // K rows per block step (128)
constexpr int SK_STEPS = 4;                // steps whose loads fly together
constexpr int SK_STAGE = SK_STEPS * SK_CHUNK;  // x rows staged at once

__host__ __device__ __forceinline__ bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// Rows k..k+3 of w at columns n..n+7, zero past K and N. VEC: N % 8 == 0
// and w 8-byte aligned (one 8-byte load per row).
template <bool VEC>
__device__ __forceinline__ void load_w(const int8_t* __restrict__ w, int K,
                                       int N, int k, int n, uint2 (&v)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (VEC) {
      v[r] = (n < N && k + r < K)
                 ? __ldg(reinterpret_cast<const uint2*>(
                       w + (size_t)(k + r) * N + n))
                 : make_uint2(0u, 0u);
    } else {
      int b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        b[j] = (n + j < N && k + r < K)
                   ? (int)__ldg((const signed char*)(w + (size_t)(k + r) * N +
                                                     n + j))
                   : 0;
      v[r] = make_uint2((uint32_t)rt::pack4(b[0], b[1], b[2], b[3]),
                        (uint32_t)rt::pack4(b[4], b[5], b[6], b[7]));
    }
  }
}

// The skinny route: MT (a power of two >= M) rows of x; grid (column
// tiles, S splits of the `chunks` K chunks of SK_CHUNK rows).
template <int MT, bool VEC_W>
__global__ void __launch_bounds__(SK_THREADS)
gemm_int8_kernel_skinny(const int8_t* __restrict__ x,
                        const int8_t* __restrict__ w,
                        const float* __restrict__ mult, int mult_len,
                        void* out, int M, int K, int N, int chunks, int S,
                        int* ws, int* counters) {
  __shared__ int xs[MT][SK_STAGE / 4];  // x words of the staged rows
  __shared__ int red[MT][SK_BN];        // the block's partial tile
  __shared__ int last;
  const int t = threadIdx.x;
  const int tx = t % SK_TX, ty = t / SK_TX;
  const int tile = blockIdx.x, split = blockIdx.y;
  const int n0 = tile * SK_BN;
  const int n = n0 + 8 * tx;
  const int k_lo = (int)((long long)split * chunks / S) * SK_CHUNK;
  const int k_hi =
      min(K, (int)((long long)(split + 1) * chunks / S) * SK_CHUNK);
  const bool vec_x = (K & 3) == 0 && aligned(x, 4);
  int* flat = &red[0][0];
  for (int i = t; i < MT * SK_BN; i += SK_THREADS) flat[i] = 0;
  int acc[MT][8];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] = 0;

  for (int ks = k_lo; ks < k_hi; ks += SK_STAGE) {
    const int kn = min(SK_STAGE, k_hi - ks);
    __syncthreads();  // the previous stage's words are consumed
    for (int i = t; i < MT * (SK_STAGE / 4); i += SK_THREADS) {
      const int m = i / (SK_STAGE / 4), q = i % (SK_STAGE / 4);
      const int k = ks + 4 * q;
      int v = 0;
      if (m < M && 4 * q < kn) {
        const int8_t* p = x + (size_t)m * K + k;
        if (vec_x) {
          v = __ldg(reinterpret_cast<const int*>(p));
        } else {
          int b[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            b[j] = k + j < K ? (int)__ldg((const signed char*)p + j) : 0;
          v = rt::pack4(b[0], b[1], b[2], b[3]);
        }
      }
      xs[m][q] = v;
    }
    __syncthreads();
    // all of this stage's weight loads first, then the products
    uint2 wv[SK_STEPS][4];
#pragma unroll
    for (int s = 0; s < SK_STEPS; ++s) {
      const int kk = 4 * ty + s * SK_CHUNK;
      if (kk < kn) {
        load_w<VEC_W>(w, K, N, ks + kk, n, wv[s]);
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) wv[s][r] = make_uint2(0u, 0u);
      }
    }
#pragma unroll
    for (int s = 0; s < SK_STEPS; ++s) {
      const int kk = 4 * ty + s * SK_CHUNK;
      if (kk < kn) {
        uint32_t wd[8];
        i8mma::transpose_4x8(wv[s], wd);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int xv = xs[m][kk / 4];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[m][j] = __dp4a(xv, (int)wd[j], acc[m][j]);
        }
      }
    }
  }

  // the 4 K lanes of a warp that share a column (lanes 8 apart), then the
  // 8 warps, into the block's partial tile
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int a = acc[m][j];
      a += __shfl_xor_sync(0xffffffffu, a, 8);
      a += __shfl_xor_sync(0xffffffffu, a, 16);
      acc[m][j] = a;
    }
  __syncthreads();
  if ((t & 31) < SK_TX) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
      if (m < M) {
#pragma unroll
        for (int j = 0; j < 8; ++j) atomicAdd(&red[m][8 * tx + j], acc[m][j]);
      }
  }
  __syncthreads();

  if (S > 1) {
    // split-K: this block's slice, a ticket, and the last block sums all
    int* slices = ws + (size_t)tile * S * (SK_M * SK_BN);
    int* mine = slices + (size_t)split * (SK_M * SK_BN);
    for (int i = t; i < MT * SK_BN; i += SK_THREADS) __stcg(mine + i, flat[i]);
    __threadfence();
    __syncthreads();
    if (t == 0) last = atomicAdd(counters + tile, 1) == S - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int i = t; i < MT * SK_BN; i += SK_THREADS) {
      int sum = 0;
      for (int s = 0; s < S; ++s)
        sum += __ldcg(slices + (size_t)s * (SK_M * SK_BN) + i);
      flat[i] = sum;
    }
    if (t == 0) counters[tile] = 0;
  }
  for (int i = t; i < MT * SK_BN; i += SK_THREADS) {
    const int m = i / SK_BN, nn = n0 + i % SK_BN;
    if (m >= M || nn >= N) continue;
    const size_t o = (size_t)m * N + nn;
    if (mult != nullptr)
      reinterpret_cast<int8_t*>(out)[o] = (int8_t)rt::requant1(
          flat[i], __ldg(mult + (mult_len == 1 ? 0 : nn)));
    else
      reinterpret_cast<int*>(out)[o] = flat[i];
  }
}

// The tensor-core route (M > 16): K2's work item in the 1x1 geometry.
template <bool VEC_A, bool VEC_B>
__global__ void __launch_bounds__(i8mma::THREADS)
gemm_int8_kernel_mma(i8mma::ConvGeom g, const float* __restrict__ mult,
                     int mult_len, void* out, int tiles_m, int chunks, int S,
                     int* ws, int* counters) {
  __shared__ i8mma::Smem sm;
  i8mma::run_item<VEC_A, VEC_B, false>(
      g, mult, mult_len, out,
      mult != nullptr ? i8mma::OUT_REQUANT : i8mma::OUT_I32, tiles_m, chunks,
      blockIdx.x, blockIdx.y, S, ws, counters, sm);
}

template <int MT>
void launch_skinny(bool vec_w, dim3 grid, cudaStream_t st, const int8_t* x,
                   const int8_t* w, const float* mult, int mult_len,
                   void* out, int M, int K, int N, int chunks, int S,
                   int* ws, int* counters) {
  auto kern = vec_w ? gemm_int8_kernel_skinny<MT, true>
                    : gemm_int8_kernel_skinny<MT, false>;
  kern<<<grid, SK_THREADS, 0, st>>>(x, w, mult, mult_len, out, M, K, N,
                                    chunks, S, ws, counters);
}

}  // namespace

extern "C" {

// out: int8 (M, N) when mult != NULL (requantized), else int32 (M, N).
// M <= 16 takes the skinny route (K chunks of 128 rows, column tiles of
// 64), M > 16 the tensor-core route (K chunks of 64, 64 x 64 tiles);
// `splits` (1 <= splits <= the route's K chunks) splits K over grid.y, and
// with splits > 1 `ws` holds tiles * splits * 1024 (skinny) or
// tiles * splits * 4096 (tensor cores) int32 and `counters` tiles int32
// zeros (left at zero on return).
int gemm_int8_launch(const void* x, const void* w, const void* mult,
                     int mult_len, void* out, int M, int K, int N, int splits,
                     void* ws, void* counters, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool skinny = M <= SK_M;
  const int chunk = skinny ? SK_CHUNK : i8mma::BK;
  const int chunks = (K + chunk - 1) / chunk;
  if (K < 0 || splits < 1 || splits > (chunks > 1 ? chunks : 1) ||
      splits > 65535 ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int8_t* xp = (const int8_t*)x;
  const int8_t* wp = (const int8_t*)w;
  const float* mp = (const float*)mult;
  int* wsp = (int*)ws;
  int* cp = (int*)counters;
  const bool vec_b = N % 8 == 0 && aligned(w, 8);
  if (skinny) {
    const dim3 grid((N + SK_BN - 1) / SK_BN, splits);
    if (M <= 1)
      launch_skinny<1>(vec_b, grid, st, xp, wp, mp, mult_len, out, M, K, N,
                       chunks, splits, wsp, cp);
    else if (M <= 2)
      launch_skinny<2>(vec_b, grid, st, xp, wp, mp, mult_len, out, M, K, N,
                       chunks, splits, wsp, cp);
    else if (M <= 4)
      launch_skinny<4>(vec_b, grid, st, xp, wp, mp, mult_len, out, M, K, N,
                       chunks, splits, wsp, cp);
    else if (M <= 8)
      launch_skinny<8>(vec_b, grid, st, xp, wp, mp, mult_len, out, M, K, N,
                       chunks, splits, wsp, cp);
    else
      launch_skinny<16>(vec_b, grid, st, xp, wp, mp, mult_len, out, M, K, N,
                        chunks, splits, wsp, cp);
    return (int)cudaGetLastError();
  }
  const int tiles_m = (M + i8mma::BM - 1) / i8mma::BM;
  const long long tiles =
      (long long)tiles_m * ((N + i8mma::BN - 1) / i8mma::BN);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // one pixel per row: H = W = 1, C = K, a 1x1 kernel, stride 1, no pad
  i8mma::ConvGeom g{xp, wp, 1, 1, K, N, 1, 1, 0, 1, 1, M, K};
  const bool vec_a = K % 16 == 0 && aligned(x, 16);
  auto kern = vec_a ? (vec_b ? gemm_int8_kernel_mma<true, true>
                             : gemm_int8_kernel_mma<true, false>)
                    : (vec_b ? gemm_int8_kernel_mma<false, true>
                             : gemm_int8_kernel_mma<false, false>);
  kern<<<dim3((unsigned)tiles, splits), i8mma::THREADS, 0, st>>>(
      g, mp, mult_len, out, tiles_m, chunks, splits, wsp, cp);
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
