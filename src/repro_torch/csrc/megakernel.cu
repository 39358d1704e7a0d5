// K3: one launch per fused segment of the megakernel plan, replaying the
// segment's steps in order.
//
// Replaces src/repro/core/megakernel.py::_run_fused (with _emit_step,
// kernels/conv2d_im2col.py::im2col_patches, kernels/gemm_int8.py::
// dot_i32_exact and core/compiled.py::_jax_op) of the JAX package. There,
// one pallas_call holds a whole segment in VMEM, whose planned footprint
// (1 MiB to 16 MiB here) is far above the 227 KB of shared memory a block
// may use. So the plan stays the JAX package's (the sanitizer's SPM rules
// check the same thing), and on the card each step is tiled across the
// whole grid: the segment's intermediates live in a global workspace the
// wrapper allocates (they stay in the 50 MB L2 at these sizes), and
// dependent steps are separated by a grid-wide barrier.
//
// The grid is launched cooperatively (cudaLaunchCooperativeKernel, no
// larger than the co-resident blocks), which guarantees that every block is
// resident, so the software barrier below (an atomic arrival counter and a
// generation word in device memory, reset by the wrapper's memset at each
// launch) cannot deadlock. Buffers written inside the launch are read
// through L2 (__ldcg): L1 is not coherent across SMs.
//
// A step table (int64 rows, built once per program and segment by the
// wrapper, layout in core/megakernel.py) gives each step's kind, its buffer
// locations, shapes and attributes, and the device pointers of its weights
// and requant multipliers. Buffer locations: loc >= 0 is a byte offset in
// the workspace per sample (the workspace holds each buffer for the whole
// batch, so its base is ws + loc * B); loc < 0 is slot -loc-1 of the
// segment's external inputs and outputs, passed by value at each launch.
// Every buffer holds B samples back to back.
//
// What bounds it on an H100: the fused segments on the path are 3x3 convs
// at 56x56 (K = 576): operations dominate, so the bound is the int8
// tensor-core rate; the dp4a tile product leaves it far above that bound,
// and every barrier costs a few microseconds. Measured in PERF.md.
#include "int8_tile.cuh"

namespace {

constexpr int ROW = 32;
constexpr int MAX_IO = 96;

enum Kind {
  GEMM = 1, CONV = 2, REQUANT = 3, RELU = 4, ADD = 5, MAXPOOL = 6,
  AVGPOOL = 7, GAP = 8, COPY_CH = 9
};

// row fields
enum Field {
  F_KIND = 0, F_BARRIER = 1,
  F_OUT = 2, F_OUT_DT = 3, F_OUT_BYTES = 4,
  F_IN0 = 5, F_IN0_DT = 6, F_IN0_BYTES = 7,
  F_IN1 = 8, F_IN1_DT = 9, F_IN1_BYTES = 10,
  F_W = 11, F_MULT = 12, F_MULT_LEN = 13,
  F_A = 14  // F_A + i: kind-specific attributes
};

struct IoPtrs {
  long long p[MAX_IO];
};

__device__ __forceinline__ char* resolve(long long loc, const IoPtrs& io,
                                         char* ws, int B) {
  if (loc < 0) return reinterpret_cast<char*>(io.p[-loc - 1]);
  return ws + loc * (long long)B;
}

// dt: 0 int8, 1 int32
__device__ __forceinline__ int ldv(const char* base, int dt, size_t i) {
  if (dt == 0) return (int)__ldcg(reinterpret_cast<const signed char*>(base) + i);
  return __ldcg(reinterpret_cast<const int*>(base) + i);
}

__device__ __forceinline__ void stv(char* base, int dt, size_t i, int v) {
  if (dt == 0) reinterpret_cast<int8_t*>(base)[i] = (int8_t)v;
  else reinterpret_cast<int*>(base)[i] = v;
}

__device__ __forceinline__ int clamp8(int v) {
  return v < -128 ? -128 : (v > 127 ? 127 : v);
}

// round half to even of s / n (n > 0) with FLOOR division: C's / and %
// truncate toward zero, which differs for negative s, so the remainder is
// brought into [0, n) first (ref.round_half_even_div).
__device__ __forceinline__ int rhe_div(int s, int n) {
  int q = s / n;
  int r = s - q * n;
  if (r < 0) { q -= 1; r += n; }
  const bool up = (2 * r > n) || (2 * r == n && (q & 1));
  return q + (up ? 1 : 0);
}

// Grid-wide barrier over co-resident blocks. bar[0] counts arrivals,
// bar[1] is the generation: the last block to arrive resets the count and
// bumps the generation, the others spin until it changes.
__device__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) {
      }
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ void run_gemm(const long long* r, const IoPtrs& io, char* ws,
                         int B, rt::TileSmem& sm) {
  const int8_t* x = (const int8_t*)resolve(r[F_IN0], io, ws, B);
  char* out = resolve(r[F_OUT], io, ws, B);
  const int8_t* w = (const int8_t*)r[F_W];
  const float* mult = (const float*)r[F_MULT];
  const int mlen = (int)r[F_MULT_LEN];
  const int M = (int)r[F_A] * B, K = (int)r[F_A + 1], N = (int)r[F_A + 2];
  rt::GemmA<true> la{x, M, K, (K & 3) == 0 && rt::aligned4(x)};
  const int tm = (M + rt::BM - 1) / rt::BM, tn = (N + rt::BN - 1) / rt::BN;
  for (int tile = blockIdx.x; tile < tm * tn; tile += gridDim.x) {
    const int m0 = (tile / tn) * rt::BM, n0 = (tile % tn) * rt::BN;
    int acc[4][4];
    rt::mma_tile<true>(la, w, K, N, m0, n0, acc, sm);
    rt::store_tile(acc, out, M, N, m0, n0, mult, mlen,
                   r[F_OUT_DT] == 0 ? 1 : 0);
  }
}

__device__ void run_conv(const long long* r, const IoPtrs& io, char* ws,
                         int B, rt::TileSmem& sm) {
  const int8_t* x = (const int8_t*)resolve(r[F_IN0], io, ws, B);
  char* out = resolve(r[F_OUT], io, ws, B);
  const int8_t* w = (const int8_t*)r[F_W];
  const float* mult = (const float*)r[F_MULT];
  const int mlen = (int)r[F_MULT_LEN];
  const long long* a = r + F_A;
  const int H = (int)a[0], W = (int)a[1], C = (int)a[2], N = (int)a[3];
  const int kh = (int)a[4], kw = (int)a[5], s = (int)a[6], p = (int)a[7];
  const int oh = (int)a[8], ow = (int)a[9];
  const int M = B * oh * ow, K = kh * kw * C;
  rt::ConvA<true> la{x, H, W, C, kw, s, p, oh, ow, M, K,
                     (C & 3) == 0 && rt::aligned4(x)};
  const int tm = (M + rt::BM - 1) / rt::BM, tn = (N + rt::BN - 1) / rt::BN;
  for (int tile = blockIdx.x; tile < tm * tn; tile += gridDim.x) {
    const int m0 = (tile / tn) * rt::BM, n0 = (tile % tn) * rt::BN;
    int acc[4][4];
    rt::mma_tile<true>(la, w, K, N, m0, n0, acc, sm);
    rt::store_tile(acc, out, M, N, m0, n0, mult, mlen,
                   r[F_OUT_DT] == 0 ? 1 : 0);
  }
}

__device__ void run_elementwise(const long long* r, const IoPtrs& io,
                                char* ws, int B) {
  const int kind = (int)r[F_KIND];
  const char* x = resolve(r[F_IN0], io, ws, B);
  char* out = resolve(r[F_OUT], io, ws, B);
  const int xdt = (int)r[F_IN0_DT], odt = (int)r[F_OUT_DT];
  const long long* a = r + F_A;
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * blockDim.x;

  if (kind == REQUANT || kind == RELU || kind == ADD) {
    const size_t total = (size_t)a[0] * B;
    const float* mult = (const float*)r[F_MULT];
    const int mlen = (int)r[F_MULT_LEN];
    const int clast = (int)a[1];
    const char* y = kind == ADD ? resolve(r[F_IN1], io, ws, B) : nullptr;
    const int ydt = (int)r[F_IN1_DT];
    for (size_t e = tid; e < total; e += stride) {
      const int v = ldv(x, xdt, e);
      int o;
      if (kind == REQUANT) {
        o = rt::requant1(v, __ldg(mult + (mlen == 1 ? 0 : (int)(e % clast))));
      } else if (kind == RELU) {
        o = v > 0 ? v : 0;
      } else {
        o = v + ldv(y, ydt, e);
        if (odt == 0) o = clamp8(o);  // int8 add saturates, int32 wraps
      }
      stv(out, odt, e, o);
    }
  } else if (kind == MAXPOOL || kind == AVGPOOL) {
    const int H = (int)a[0], W = (int)a[1], C = (int)a[2], k = (int)a[3];
    const int s = (int)a[4], p = (int)a[5], oh = (int)a[6], ow = (int)a[7];
    const size_t total = (size_t)B * oh * ow * C;
    // maxpool pads with the dtype's minimum, avgpool with zeros
    const int fill = xdt == 0 ? -128 : (int)0x80000000;
    for (size_t e = tid; e < total; e += stride) {
      const int c = (int)(e % C);
      size_t q = e / C;
      const int ox = (int)(q % ow);
      q /= ow;
      const int oy = (int)(q % oh);
      const size_t b = q / oh;
      const size_t xb = b * (size_t)H * W * C;
      int acc = kind == MAXPOOL ? fill : 0;
      for (int di = 0; di < k; ++di) {
        const int iy = oy * s - p + di;
        for (int dj = 0; dj < k; ++dj) {
          const int ix = ox * s - p + dj;
          const bool in = iy >= 0 && iy < H && ix >= 0 && ix < W;
          const int v = in ? ldv(x, xdt, xb + ((size_t)iy * W + ix) * C + c)
                           : (kind == MAXPOOL ? fill : 0);
          if (kind == MAXPOOL) acc = v > acc ? v : acc;
          else acc += v;
        }
      }
      if (kind == AVGPOOL) acc = clamp8(rhe_div(acc, k * k));
      stv(out, odt, e, acc);
    }
  } else if (kind == GAP) {
    const int H = (int)a[0], W = (int)a[1], C = (int)a[2];
    const size_t total = (size_t)B * C;
    for (size_t e = tid; e < total; e += stride) {
      const int c = (int)(e % C);
      const size_t b = e / C;
      const size_t xb = b * (size_t)H * W * C;
      int acc = 0;
      for (int i = 0; i < H * W; ++i) acc += ldv(x, xdt, xb + (size_t)i * C + c);
      stv(out, odt, e, clamp8(rhe_div(acc, H * W)));
    }
  } else if (kind == COPY_CH) {
    // one input of a channel concat: out[..., off:off+ci] = x[..., :ci]
    const long long P = a[0];
    const int ci = (int)a[1], ctot = (int)a[2], off = (int)a[3];
    const size_t total = (size_t)B * P * ci;
    for (size_t e = tid; e < total; e += stride) {
      const size_t pix = e / ci;
      const int c = (int)(e % ci);
      stv(out, odt, pix * ctot + off + c, ldv(x, xdt, e));
    }
  }
}

__global__ void __launch_bounds__(rt::THREADS)
megakernel_kernel(const long long* __restrict__ table, int n_steps, IoPtrs io,
                  char* ws, int B, unsigned* bar) {
  __shared__ rt::TileSmem sm;
  for (int si = 0; si < n_steps; ++si) {
    const long long* r = table + (size_t)si * ROW;
    const int kind = (int)r[F_KIND];
    if (kind == GEMM) run_gemm(r, io, ws, B, sm);
    else if (kind == CONV) run_conv(r, io, ws, B, sm);
    else run_elementwise(r, io, ws, B);
    if (r[F_BARRIER] && si + 1 < n_steps) grid_barrier(bar);
  }
}

}  // namespace

extern "C" {

// Largest cooperative grid: co-resident blocks per SM times the SM count.
int megakernel_max_grid(int* out) {
  int dev = 0, per_sm = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, megakernel_kernel, rt::THREADS, 0);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *out = per_sm * sms;
  return (int)e;
}

// table: device int64 (n_steps, ROW); io: host int64[n_io] device pointers;
// ws: device workspace; bar: device uint32[2]; grid <= megakernel_max_grid.
int megakernel_launch(const void* table, int n_steps, const void* io,
                      int n_io, void* ws, int B, void* bar, int grid,
                      void* stream) {
  if (n_io > MAX_IO) return (int)cudaErrorInvalidValue;
  IoPtrs ptrs;
  for (int i = 0; i < MAX_IO; ++i)
    ptrs.p[i] = i < n_io ? reinterpret_cast<const long long*>(io)[i] : 0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(bar, 0, 2 * sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  const long long* tab = (const long long*)table;
  char* wsp = (char*)ws;
  unsigned* barp = (unsigned*)bar;
  void* args[] = {(void*)&tab, (void*)&n_steps, (void*)&ptrs, (void*)&wsp,
                  (void*)&B, (void*)&barp};
  e = cudaLaunchCooperativeKernel((const void*)megakernel_kernel, dim3(grid),
                                  dim3(rt::THREADS), args, 0, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
