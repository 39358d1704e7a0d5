// lut_int8: y[i] = table[x[i] + 128] over n int8 values, a 256-entry int8
// table applied elementwise (the int8 SiLU of a YOLOv5 Conv block).
//
// Replaces no TPU kernel: the JAX package has no table op. It was added for
// the int8 SiLU, which the port applies after every requantized conv of a
// YOLOv5 graph. What bounds it on an H100 is bytes: one read and one write
// of each int8 (the table is 256 bytes), no arithmetic to speak of. So each
// thread moves 16 bytes per load and per store (one int4 each way) over a
// grid-stride loop, and looks its 16 entries up in a copy of the table in
// shared memory. The int8 value v indexes entry v + 128, which is the byte
// of v with its top bit flipped. Pointers that are not 16-byte aligned
// take the one-byte loop alone.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;       // one table entry per thread to stage

__device__ __forceinline__ uint32_t lut4(const uint8_t* t, uint32_t u) {
  uint32_t r = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    r |= (uint32_t)t[((u >> (8 * b)) & 0xffu) ^ 0x80u] << (8 * b);
  return r;
}

__global__ void __launch_bounds__(THREADS)
lut_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ table,
                int8_t* __restrict__ y, long long n, long long n16) {
  __shared__ uint8_t t[256];
  t[threadIdx.x] = (uint8_t)table[threadIdx.x];
  __syncthreads();
  const long long stride = (long long)gridDim.x * THREADS;
  const long long first = (long long)blockIdx.x * THREADS + threadIdx.x;
  const int4* x4 = reinterpret_cast<const int4*>(x);
  int4* y4 = reinterpret_cast<int4*>(y);
  for (long long i = first; i < n16; i += stride) {
    const int4 v = __ldg(x4 + i);
    y4[i] = make_int4((int)lut4(t, (uint32_t)v.x), (int)lut4(t, (uint32_t)v.y),
                      (int)lut4(t, (uint32_t)v.z), (int)lut4(t, (uint32_t)v.w));
  }
  for (long long i = n16 * 16 + first; i < n; i += stride)
    y[i] = (int8_t)t[(uint8_t)x[i] ^ 0x80u];
}

}  // namespace

extern "C" {

// x (n,) int8, table (256,) int8 -> y (n,) int8, on `stream`.
int lut_int8_launch(const void* x, const void* table, void* y, long long n,
                    void* stream) {
  if (n <= 0) return 0;
  const bool vec = ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const long long n16 = vec ? n / 16 : 0;
  const long long work = n16 > 0 ? n16 : n;
  // at most 8 blocks of 256 threads per SM of an H100 (132 SMs)
  const long long blocks = (work + THREADS - 1) / THREADS;
  const int grid = (int)(blocks < 132 * 8 ? blocks : 132 * 8);
  lut_int8_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)table, (int8_t*)y, n, n16);
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
