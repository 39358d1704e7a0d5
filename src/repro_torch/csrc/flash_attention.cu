// K4: blockwise GQA attention with an online softmax (flash attention).
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_pallas (with
// _make_kernel) of the JAX package. On the TPU the grid's kv axis runs in
// order on one core and the (m, l, acc) state lives in VMEM scratch across
// it; here each block owns one (batch*q-head, 64-row q tile) and loops over
// its own 64-row kv tiles, with the state in registers. The semantics are
// the Pallas kernel's:
//   - GQA: q head h reads kv head h / (Hq / Hkv);
//   - query i sees kv j iff j <= i + (Skv - Sq) (causal, with the decode
//     offset) and j > i + (Skv - Sq) - window (sliding window, if any);
//     kv rows past Skv are masked; `scale` multiplies q (default 1/sqrt(D));
//   - the per-tile online softmax uses the -1e30 sentinel (not -inf) and
//     divides by max(l, 1e-30), so a row whose first visited tile is fully
//     masked never sees exp(-inf - -inf) = NaN, and a row with no visible
//     kv at all gives 0;
//   - tiles that the causal or window condition masks for every row of the
//     q tile are skipped (the loop bounds start and stop at the visible
//     range);
//   - inputs f32, f16 or bf16 (all three alike), math in f32, output in
//     q's dtype.
//
// Layout of a block: 64 q rows x TPR threads per row (TPR = 1, 2, 4 or 8,
// so that each thread holds at most 32 of the D <= 256 head dims of its
// row's q and accumulator in registers). A kv tile is staged in shared
// memory as f32 (K and V, 64 x D each); each row's 64 scores are reduced
// across its TPR lanes with warp shuffles and kept in shared memory, then
// the tile's max updates (m, l, acc) as in the Pallas kernel.
//
// What bounds it on an H100: at the path's shape (zamba2-1.2B prefill,
// q/k/v (1, 32, 128, 64) bf16, causal) the work is 2 x 2 x 32 x 128 x 128
// x 64 / 2 = about 0.07 GFLOP against 2 MB of q, k, v and output: bytes
// bound (about 0.6 us at 3.35 TB/s; the FLOPs take about 0.07 us at
// 989 TFLOP/s bf16 dense). This first version does the dot products on the
// CUDA cores in f32 and fills only ceil(Sq / 64) x B x Hq blocks (64 at
// the path's shape, on 132 SMs); tensor cores (mma / wgmma on bf16 tiles)
// and TMA-fed K/V tiles are the next step, measured in PERF.md.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;          // q rows per block
constexpr int BK = 64;          // kv rows per tile
constexpr int DC = 32;          // head dims per thread
constexpr float NEG = -1e30f;   // the Pallas kernel's masked-logit sentinel

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ bool visible(int kpos, int qpos, int Skv,
                                        int causal, int window) {
  bool ok = kpos < Skv;
  if (causal) ok = ok && kpos <= qpos;
  if (window >= 0) ok = ok && kpos > qpos - window;
  return ok;
}

template <typename T, int TPR>
__global__ void __launch_bounds__(BQ * TPR)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int Hq, int Hkv, int Sq, int Skv, int D, int causal,
                       int window, float scale) {
  extern __shared__ float smem[];
  float* Ks = smem;                       // BK x D
  float* Vs = Ks + BK * D;                // BK x D
  float* Ss = Vs + BK * D;                // BQ x (BK + 1) scores
  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int kvh = (bh % Hq) / (Hq / Hkv);
  const int i0 = blockIdx.x * BQ;
  const int row = threadIdx.x / TPR;      // q row inside the tile
  const int part = threadIdx.x % TPR;     // which 32-dim slice of the head
  const int d0 = part * DC;
  const int offs = Skv - Sq;
  const int qi = i0 + row;
  const bool live = qi < Sq;              // rows past Sq are padding
  const int qpos = qi + offs;

  float qr[DC], acc[DC];
  const T* qrow = q + ((long long)bh * Sq + (live ? qi : 0)) * D;
#pragma unroll
  for (int c = 0; c < DC; ++c) {
    const int d = d0 + c;
    qr[c] = (live && d < D) ? to_f32(qrow[d]) * scale : 0.f;
    acc[c] = 0.f;
  }
  float m = NEG, l = 0.f;

  // the kv range any row of this tile can see; tiles outside it are skipped
  const int last_q = min(i0 + BQ, Sq) - 1 + offs;
  const int j_end = causal ? min(Skv, last_q + 1) : Skv;
  int j_begin = window >= 0 ? max(0, i0 + offs - window + 1) : 0;
  j_begin = (j_begin / BK) * BK;

  const long long kv_base = ((long long)b * Hkv + kvh) * Skv * D;
  for (int j0 = j_begin; j0 < j_end; j0 += BK) {
    const int nk = min(BK, Skv - j0);
    __syncthreads();                      // the last tile's readers are done
    const long long tile = kv_base + (long long)j0 * D;
    for (int e = threadIdx.x; e < BK * D; e += blockDim.x) {
      const bool in = e < nk * D;
      Ks[e] = in ? to_f32(k[tile + e]) : 0.f;
      Vs[e] = in ? to_f32(v[tile + e]) : 0.f;
    }
    __syncthreads();

    // scores of this row against the tile (masked) and the tile's max
    float tmax = NEG;
    for (int jj = 0; jj < BK; ++jj) {
      const float* kr = Ks + jj * D + d0;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < DC; ++c)
        if (d0 + c < D) s = fmaf(qr[c], kr[c], s);
      // butterfly over the row's TPR lanes: every lane ends with the same sum
#pragma unroll
      for (int o = TPR / 2; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      s = visible(j0 + jj, qpos, Skv, causal, window) ? s : NEG;
      tmax = fmaxf(tmax, s);
      if (part == 0) Ss[row * (BK + 1) + jj] = s;
    }
    __syncwarp();                         // a row's lanes share one warp

    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[c] *= corr;
    for (int jj = 0; jj < nk; ++jj) {
      const float p = visible(j0 + jj, qpos, Skv, causal, window)
                          ? expf(Ss[row * (BK + 1) + jj] - m_new)
                          : 0.f;
      l += p;
      const float* vr = Vs + jj * D + d0;
#pragma unroll
      for (int c = 0; c < DC; ++c)
        if (d0 + c < D) acc[c] = fmaf(p, vr[c], acc[c]);
    }
    m = m_new;
  }

  if (live) {
    const float denom = fmaxf(l, 1e-30f);
    T* orow = out + ((long long)bh * Sq + qi) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      if (d0 + c < D) orow[d0 + c] = from_f32<T>(acc[c] / denom);
  }
}

template <typename T, int TPR>
int launch_t(const void* q, const void* k, const void* v, void* out, int B,
             int Hq, int Hkv, int Sq, int Skv, int D, int causal, int window,
             float scale, cudaStream_t stream) {
  const size_t smem =
      (size_t)(2 * BK * D + BQ * (BK + 1)) * sizeof(float);
  auto kern = flash_attention_kernel<T, TPR>;
  if (smem > 48 * 1024) {
    // above 48 KB a kernel must opt in, once per device and instantiation
    // (kept out of the launch path, so launches can be graph-captured)
    static int opted_in[64] = {0};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
    if (opted_in[dev] < (int)smem) {
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      opted_in[dev] = (int)smem;
    }
  }
  dim3 grid((Sq + BQ - 1) / BQ, B * Hq);
  kern<<<grid, BQ * TPR, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Hq, Hkv, Sq, Skv, D,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int B,
             int Hq, int Hkv, int Sq, int Skv, int D, int causal, int window,
             float scale, cudaStream_t s) {
  if (D <= 32)
    return launch_t<T, 1>(q, k, v, out, B, Hq, Hkv, Sq, Skv, D, causal,
                          window, scale, s);
  if (D <= 64)
    return launch_t<T, 2>(q, k, v, out, B, Hq, Hkv, Sq, Skv, D, causal,
                          window, scale, s);
  if (D <= 128)
    return launch_t<T, 4>(q, k, v, out, B, Hq, Hkv, Sq, Skv, D, causal,
                          window, scale, s);
  return launch_t<T, 8>(q, k, v, out, B, Hq, Hkv, Sq, Skv, D, causal, window,
                        scale, s);
}

}  // namespace

extern "C" {

// q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D), out (B, Hq, Sq, D), all
// contiguous and of one dtype: 0 = f32, 1 = f16, 2 = bf16. window < 0 means
// no sliding window. Returns a CUDA error code (cudaErrorInvalidValue for
// shapes the kernel does not take).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int Hq, int Hkv, int Sq, int Skv,
                           int D, int causal, int window, float scale,
                           int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0) return 0;
  if (D < 1 || D > 256 || Hkv < 1 || Hq % Hkv != 0 || B * Hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch_d<float>(q, k, v, out, B, Hq, Hkv, Sq, Skv, D, causal,
                             window, scale, s);
    case 1:
      return launch_d<__half>(q, k, v, out, B, Hq, Hkv, Sq, Skv, D, causal,
                              window, scale, s);
    case 2:
      return launch_d<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, Sq, Skv, D,
                                     causal, window, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
