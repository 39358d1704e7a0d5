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
// generation word in device memory) cannot deadlock. The last block to
// arrive resets the counter, so every launch leaves it at zero and the
// wrapper's buffer needs zeroing only once, when it is allocated. Buffers
// written inside the launch are read through L2 (__ldcg, cp.async.cg): L1
// is not coherent across SMs.
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
// Conv and gemm steps run on the int8 tensor cores: int8_mma.cuh's 64 x 64
// tile (mma.sync m16n8k32, the tile of K2), a gemm being the 1x1 conv
// geometry (one pixel per row, C = K). Their work items are tiles x S
// splits of K, walked grid-stride by the blocks; S is computed here at
// launch from M = B x the step's rows per sample by K2's rule
// (i8mma::split_count; core/megakernel.py::split_plan mirrors it for the
// CPU tests and to size the workspace). The splits' partial tiles meet in
// one workspace region shared by every split step of the launch, with one
// ticket counter per tile that the tile's last block resets; a grid
// barrier follows every conv and gemm step (the table sets it and the
// kernel adds it where a row does not), so no two split steps use the
// region at once. A block that is not a tile's last goes on to its next
// item and to the barrier: it never returns early. VEC_A / VEC_B (16-byte
// A copies, 8-byte weight loads) are chosen per step, four instantiations
// of the tile in this one kernel.
//
// What bounds it on an H100: the path's fused segments (ResNet50-224 on
// scaled_paper_machine(64): s1.b1.c2, s1.b2.c2, s1.b3.c2) each hold one
// step, a 3x3 conv 28x28x128 -> 128 (M 784 at batch 1, K 1152, N 128), so
// no barrier runs; 0.23 GOP each, 0.12 us at the int8 tensor-core rate,
// while its bytes (0.35 MB) take 0.10 us. The first version multiplied
// with __dp4a on the CUDA cores, 26 tiles on a grid of 264 blocks each
// walking K = 1152 alone (69 us per segment); this one splits K 6 ways at
// batch 1 (156 items) on the tensor cores, as K2 runs the same conv.
#include "int8_mma.cuh"

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

// Split-K workspace of the launch: partial tiles and per-tile counters,
// with their capacities (ints, tiles).
struct Splits {
  int* ws;
  long long ws_cap;
  int* counters;
  int counters_cap;
  int sms;
};

// A conv or gemm step: every (tile, split) work item, grid-stride.
__device__ void run_mm(const long long* r, const IoPtrs& io, char* ws,
                       int B, const Splits& sp, i8mma::Smem& sm) {
  const int8_t* x = (const int8_t*)resolve(r[F_IN0], io, ws, B);
  void* out = resolve(r[F_OUT], io, ws, B);
  const int8_t* w = (const int8_t*)r[F_W];
  const float* mult = (const float*)r[F_MULT];
  const int mlen = (int)r[F_MULT_LEN];
  const long long* a = r + F_A;
  i8mma::ConvGeom g;
  g.x = x;
  g.w = w;
  if (r[F_KIND] == GEMM) {  // one pixel per row: H = W = 1, C = K
    g.M = (int)a[0] * B;
    g.K = (int)a[1];
    g.N = (int)a[2];
    g.H = g.W = 1;
    g.C = g.K;
    g.kw = 1;
    g.stride = 1;
    g.pad = 0;
    g.oh = g.ow = 1;
  } else {
    g.H = (int)a[0];
    g.W = (int)a[1];
    g.C = (int)a[2];
    g.N = (int)a[3];
    g.kw = (int)a[5];
    g.stride = (int)a[6];
    g.pad = (int)a[7];
    g.oh = (int)a[8];
    g.ow = (int)a[9];
    g.M = B * g.oh * g.ow;
    g.K = (int)a[4] * g.kw * g.C;
  }
  const int mode = mult != nullptr ? i8mma::OUT_REQUANT
                   : r[F_OUT_DT] == 0 ? i8mma::OUT_I8
                                      : i8mma::OUT_I32;
  const int tiles_m = (g.M + i8mma::BM - 1) / i8mma::BM;
  const int tiles = tiles_m * ((g.N + i8mma::BN - 1) / i8mma::BN);
  const int chunks = (g.K + i8mma::BK - 1) / i8mma::BK;
  int S = i8mma::split_count(tiles, chunks, sp.sms);
  if (S > 1 && ((long long)tiles * S * (i8mma::BM * i8mma::BN) > sp.ws_cap ||
                tiles > sp.counters_cap))
    S = 1;  // the wrapper sized the region for every step: never taken
  const bool va = g.C % 16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool vb = g.N % 8 == 0 && (reinterpret_cast<uintptr_t>(w) & 7) == 0;
  for (int item = blockIdx.x; item < tiles * S; item += gridDim.x) {
    __syncthreads();  // every warp is done with the last item's stages
    const int tile = item % tiles, split = item / tiles;
    if (va) {
      if (vb)
        i8mma::run_item<true, true, true>(g, mult, mlen, out, mode, tiles_m,
                                          chunks, tile, split, S, sp.ws,
                                          sp.counters, sm);
      else
        i8mma::run_item<true, false, true>(g, mult, mlen, out, mode, tiles_m,
                                           chunks, tile, split, S, sp.ws,
                                           sp.counters, sm);
    } else {
      if (vb)
        i8mma::run_item<false, true, true>(g, mult, mlen, out, mode, tiles_m,
                                           chunks, tile, split, S, sp.ws,
                                           sp.counters, sm);
      else
        i8mma::run_item<false, false, true>(g, mult, mlen, out, mode,
                                            tiles_m, chunks, tile, split, S,
                                            sp.ws, sp.counters, sm);
    }
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

__global__ void __launch_bounds__(i8mma::THREADS)
megakernel_kernel(const long long* __restrict__ table, int n_steps, IoPtrs io,
                  char* ws, int B, unsigned* bar, Splits sp) {
  __shared__ i8mma::Smem sm;
  for (int si = 0; si < n_steps; ++si) {
    const long long* r = table + (size_t)si * ROW;
    const int kind = (int)r[F_KIND];
    const bool mm = kind == GEMM || kind == CONV;
    if (mm) run_mm(r, io, ws, B, sp, sm);
    else run_elementwise(r, io, ws, B);
    if ((r[F_BARRIER] || mm) && si + 1 < n_steps) grid_barrier(bar);
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
        &per_sm, megakernel_kernel, i8mma::THREADS, 0);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *out = per_sm * sms;
  return (int)e;
}

// table: device int64 (n_steps, ROW); io: host int64[n_io] device pointers;
// ws: device workspace; bar: device uint32[2] whose first word is zero
// (left at zero on return); grid <= megakernel_max_grid;
// sms: the SM count the split rule fills; partials / counters: the split-K
// region (partials_cap int32, counters_cap int32 zeros, left at zero), or
// null with capacity 0, which keeps every step unsplit.
int megakernel_launch(const void* table, int n_steps, const void* io,
                      int n_io, void* ws, int B, void* bar, int grid, int sms,
                      void* partials, long long partials_cap, void* counters,
                      int counters_cap, void* stream) {
  if (n_io > MAX_IO || sms < 1 || partials_cap < 0 || counters_cap < 0 ||
      (partials_cap > 0 && partials == nullptr) ||
      (counters_cap > 0 && counters == nullptr))
    return (int)cudaErrorInvalidValue;
  IoPtrs ptrs;
  for (int i = 0; i < MAX_IO; ++i)
    ptrs.p[i] = i < n_io ? reinterpret_cast<const long long*>(io)[i] : 0;
  cudaStream_t st = (cudaStream_t)stream;
  const long long* tab = (const long long*)table;
  char* wsp = (char*)ws;
  unsigned* barp = (unsigned*)bar;
  Splits sp{(int*)partials, partials_cap, (int*)counters, counters_cap, sms};
  void* args[] = {(void*)&tab, (void*)&n_steps, (void*)&ptrs, (void*)&wsp,
                  (void*)&B,   (void*)&barp,    (void*)&sp};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)megakernel_kernel, dim3(grid), dim3(i8mma::THREADS), args,
      0, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
