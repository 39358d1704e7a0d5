// K5: the first-order gated linear recurrence h_t = a_t * h_{t-1} + x_t.
//
// Replaces src/repro/kernels/ssm_scan.py::ssm_scan_pallas (with _make_kernel)
// of the JAX package. On the TPU the time axis is cut into chunks of ct,
// each chunk is scanned by log2(ct) shift-doubling steps vectorized over D,
// and the carry crosses chunks in VMEM scratch. Here one thread owns one
// (b, d) column and walks T in order with h in a register: no carry ever
// leaves the thread, and loads and stores are coalesced across d. `h0`
// (B, D) seeds the carry; a null pointer means h_{-1} = 0. Each step is
// __fmul_rn then __fadd_rn, the two roundings of the plain torch version
// (a * h + x), so the two agree bit for bit.
//
// What bounds it on an H100: on the LM path (zamba2-1.2B decode) T = 1 and
// D = 2 * 2048 * 64 = 262,144 columns per row, so a call is one streaming
// pass: read a, x and h0, write y, 16 bytes per column, 16.8 MB at B = 4,
// about 5 us at 3.35 TB/s; the 2 flops per column are nothing. Long T at
// small B * D would leave the card under-filled (one thread per column, T
// steps in order); a chunked scan across T, the Pallas design, is the
// later step for that shape.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
ssm_scan_kernel(const float* __restrict__ a, const float* __restrict__ x,
                const float* __restrict__ h0, float* __restrict__ y, int T,
                long long D, long long columns) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= columns) return;
  const long long b = idx / D;
  const long long d = idx - b * D;
  float h = h0 != nullptr ? h0[idx] : 0.f;
  const long long base = b * (long long)T * D + d;
  for (int t = 0; t < T; ++t) {
    const long long o = base + (long long)t * D;
    h = __fadd_rn(__fmul_rn(a[o], h), x[o]);
    y[o] = h;
  }
}

}  // namespace

extern "C" {

// a, x, y: f32 (B, T, D) contiguous; h0: f32 (B, D) contiguous or NULL.
int ssm_scan_launch(const void* a, const void* x, const void* h0, void* y,
                    int B, int T, long long D, void* stream) {
  if (B <= 0 || T <= 0 || D <= 0) return 0;
  const long long columns = (long long)B * D;
  const long long blocks = (columns + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ssm_scan_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)x, (const float*)h0, (float*)y, T, D,
      columns);
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
