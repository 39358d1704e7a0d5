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
// What bounds it on an H100: a batch-1 ResNet50-224 program's 54 ops move
// about 80 MB (the int32 partials dominate), 24 us at 3.35 TB/s, against
// 4 us of int8 tensor-core work. What held the first version (one 64 x 64
// mma.sync tile per block, walking all of K alone) 34x above that was the
// grid: the 7 x 7 and 14 x 14 convs give 8-16 tiles on 132 SMs, each with a
// chain of up to 72 K chunks. This version:
//
//   * runs a host-made work list (kernels/tiled_int8.py::work_units): the
//     rank's tiles merged along M and cut into items of 64 rows x BN
//     columns (BN = 32, 64 or 128: the width whose units move the fewest
//     bytes through one SM), over rows that fold the batch in (row
//     b * M + m; a classifier's (B, 1) rows become one (B, K) product),
//     each item split over K into S units of a balanced, non-empty range
//     of 128-deep chunks, S chosen so the units reach the SM count where
//     the chunks allow;
//   * walks the units with a persistent grid of at most two blocks per SM,
//     one warpgroup each, through a 4-stage ring of 128-byte swizzled
//     tiles: B (the weights, prepared once as (N, Kp) K-major int8) by TMA,
//     A by TMA too where it is a plain matrix (a GEMM, a stride-1 1x1 conv),
//     else by an implicit-im2col cp.async loader (C % 16 == 0) or a
//     register loader (the stem, C = 3) that writes the same swizzle;
//   * multiplies with wgmma.m64nBNk32.s32.s8.s8 (int32 accumulators:
//     exact, so every value is bit for bit the plain version's);
//   * meets the splits of an item in an int32 workspace: each unit writes
//     its partial tile, takes a ticket from the item's counter, and the
//     last sums the others into its own, resets the counter (for the next
//     launch and a CUDA-graph replay) and stores the clipped rectangle. No
//     atomics touch the output: items are disjoint (the lowering checks
//     that the tiles cover each op exactly once).
#include "wgmma_int8.cuh"

namespace {

constexpr int BM = 64;        // rows of an item: wgmma's M
constexpr int BK = wg8::ROW;  // K values (bytes) of a chunk: one swizzle row
constexpr int THREADS = 128;  // one warpgroup
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * BK;
constexpr int MAX_CTAS_PER_SM = 2;

// how A reaches shared memory
enum AMode { A_TMA = 0, A_ASYNC = 1, A_REGS = 2 };

template <int BN>
constexpr int smem_bytes() {
  // the ring, its barriers, and slack to align the ring to 1024 bytes
  return STAGES * (A_BYTES + BN * BK) + STAGES * 8 + 1024;
}

// the conv seen as a GEMM over M = B * oh * ow output rows
struct Geom {
  const int8_t* x;
  int H, W, C, N, kw, stride, pad, oh, ow, M, K;
};

// The four A rows a thread fills, (t / 8) + 16 * i of the item: their
// sample's input, top-left input coordinate, and whether the row is live
// (rows at or past the item's end load zeros).
struct ARows {
  const int8_t* xb[4];
  int iy0[4], ix0[4];
  bool valid[4];
};

__device__ __forceinline__ ARows a_rows(const Geom& g, int m0, int m1) {
  ARows r;
  const int per = g.oh * g.ow;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + (threadIdx.x >> 3) + 16 * i;
    r.valid[i] = m < m1;
    const int mm = r.valid[i] ? m : m0;
    const int b = mm / per;
    const int rem = mm - b * per;
    const int oy = rem / g.ow;
    const int ox = rem - oy * g.ow;
    r.xb[i] = g.x + (size_t)b * g.H * g.W * g.C;
    r.iy0[i] = oy * g.stride - g.pad;
    r.ix0[i] = ox * g.stride - g.pad;
  }
  return r;
}

// (tap row, tap column, channel) of K index k
__device__ __forceinline__ void tap_of(const Geom& g, int k, int& di, int& dj,
                                       int& c) {
  const int q = k / g.C;
  c = k - q * g.C;
  di = q / g.kw;
  dj = q - di * g.kw;
}

// A by cp.async (C % 16 == 0, x 16-byte aligned): thread t copies the
// 16-byte chunk j = t % 8 of K (16 channels of one tap) for each of its
// four rows, zero-filling out-of-image taps, dead rows and K past the end.
__device__ __forceinline__ void load_a_async(const Geom& g, const ARows& r,
                                             int k0, uint8_t* as) {
  const int j = threadIdx.x & 7;
  const int k = k0 + 16 * j;
  const bool kin = k < g.K;
  int di = 0, dj = 0, c = 0;
  if (kin) tap_of(g, k, di, dj, c);
  const uint32_t base = wg8::smem_u32(as);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int iy = r.iy0[i] + di, ix = r.ix0[i] + dj;
    const bool ok = kin && r.valid[i] && iy >= 0 && iy < g.H && ix >= 0 &&
                    ix < g.W;
    const int8_t* src =
        ok ? r.xb[i] + ((size_t)iy * g.W + ix) * g.C + c : g.x;
    wg8::cp_async16(base + wg8::swizzle128((threadIdx.x >> 3) + 16 * i, j),
                    src, ok ? 16 : 0);
  }
}

// A bytewise (any C): the same four 16-byte chunks gathered into
// registers and stored; the tap of the chunk's first K is found once and
// stepped along its 16 values.
__device__ __forceinline__ void load_a_regs(const Geom& g, const ARows& r,
                                            int k0, uint8_t* as) {
  const int j = threadIdx.x & 7;
  const int kb = k0 + 16 * j;
  int di = 0, dj = 0, c = 0;
  if (kb < g.K) tap_of(g, kb, di, dj, c);
  uint32_t wd[4][4] = {};
#pragma unroll
  for (int v = 0; v < 16; ++v) {
    if (kb + v < g.K) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int iy = r.iy0[i] + di, ix = r.ix0[i] + dj;
        if (r.valid[i] && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W) {
          const int val = __ldg(reinterpret_cast<const signed char*>(
              r.xb[i] + ((size_t)iy * g.W + ix) * g.C + c));
          wd[i][v >> 2] |= (uint32_t)(val & 0xff) << (8 * (v & 3));
        }
      }
    }
    if (++c == g.C) {
      c = 0;
      if (++dj == g.kw) {
        dj = 0;
        ++di;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<uint4*>(as +
                              wg8::swizzle128((threadIdx.x >> 3) + 16 * i,
                                              j)) =
        make_uint4(wd[i][0], wd[i][1], wd[i][2], wd[i][3]);
}

// units: two int4 per unit, (m0, m1, n0, n1) over the (M, N) output and
// (c0, c1, item, split) over the K chunks; S splits per item. ws holds
// items * S partial tiles of BM x BN int32 and counters one zero per item
// (both unused when S == 1).
template <int BN, int AMODE>
__global__ void __launch_bounds__(THREADS)
tiled_int8_kernel(const __grid_constant__ CUtensorMap map_b,
                  const __grid_constant__ CUtensorMap map_a, Geom g,
                  const int4* __restrict__ units, int n_units, int S,
                  int* __restrict__ out, int* ws, int* counters) {
  constexpr int B_BYTES = BN * BK;
  constexpr int ACC = BN / 2;  // int32 accumulators a thread
  constexpr int TILE = BM * BN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sa = smem_raw + ((1024 - (wg8::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sb = sa + STAGES * A_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + STAGES * B_BYTES);
  __shared__ int last;
  const int t = threadIdx.x;
  if (t == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) wg8::mbar_init(&full[s], 1);
    wg8::fence_mbar_init();
  }
  __syncthreads();

  uint32_t step = 0;  // chunks this block has run: stage step % STAGES
  int acc[ACC];
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    const int4 lo = units[2 * u];
    const int4 hi = units[2 * u + 1];
    const int m0 = lo.x, m1 = lo.y, n0 = lo.z, n1 = lo.w;
    const int c0 = hi.x, n = hi.y - hi.x, item = hi.z, split = hi.w;
    ARows rows;
    if (AMODE != A_TMA) rows = a_rows(g, m0, m1);

    // the loads of the unit's chunk i into stage (step + i) % STAGES
    auto issue = [&](int i) {
      const int st = (step + i) % STAGES;
      const int k0 = (c0 + i) * BK;
      if (AMODE == A_ASYNC) load_a_async(g, rows, k0, sa + st * A_BYTES);
      if (AMODE == A_REGS) load_a_regs(g, rows, k0, sa + st * A_BYTES);
      if (t == 0) {
        wg8::mbar_expect_tx(&full[st],
                            B_BYTES + (AMODE == A_TMA ? A_BYTES : 0));
        wg8::tma_load_2d(sb + st * B_BYTES, &map_b, &full[st], k0, n0);
        if (AMODE == A_TMA)
          wg8::tma_load_2d(sa + st * A_BYTES, &map_a, &full[st], k0, m0);
      }
    };

    for (int i = 0; i < STAGES - 1; ++i) {
      if (i < n) issue(i);
      if (AMODE == A_ASYNC) wg8::cp_async_commit();
    }
#pragma unroll
    for (int r = 0; r < ACC; ++r) acc[r] = 0;
    for (int i = 0; i < n; ++i) {
      const uint32_t q = step + i;
      const int st = q % STAGES;
      if (AMODE == A_ASYNC) wg8::cp_async_wait<STAGES - 2>();
      if (AMODE != A_TMA) wg8::fence_proxy_async();
      wg8::mbar_wait(&full[st], (q / STAGES) & 1);
      // every thread's A of chunk i is in, and every thread is past the
      // wgmma of chunk i - 1, whose stage the next load reuses
      __syncthreads();
      if (i + STAGES - 1 < n) issue(i + STAGES - 1);
      if (AMODE == A_ASYNC) wg8::cp_async_commit();
#pragma unroll
      for (int r = 0; r < ACC; ++r) wg8::fence_operand(acc[r]);
      wg8::wgmma_fence();
      const uint64_t da = wg8::desc_sw128(sa + st * A_BYTES);
      const uint64_t db = wg8::desc_sw128(sb + st * B_BYTES);
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        wg8::Wgmma<BN>::mma(acc, wg8::desc_step(da, kk),
                            wg8::desc_step(db, kk), 1);
      wg8::wgmma_commit();
      wg8::wgmma_wait<0>();
#pragma unroll
      for (int r = 0; r < ACC; ++r) wg8::fence_operand(acc[r]);
    }
    step += n;
    if (AMODE == A_ASYNC) wg8::cp_async_wait<0>();

    // fragment of wgmma's D: warp w holds rows 16w..16w+15; register
    // 4j + 2h + e is row 16w + lane / 4 + 8h, column 8j + 2(lane % 4) + e
    const int warp = t >> 5, lane = t & 31;
    // a thread's rows are live (inside the item) if its first is
    const bool live = 16 * warp + (lane >> 2) < m1 - m0;
    bool write = true;
    if (S > 1) {
      // this split's partial, in fragment order (coalesced int4s; dead
      // rows neither written nor read), then a ticket; the item's last
      // split adds the others' to its own
      int4* slices =
          reinterpret_cast<int4*>(ws) + (size_t)item * S * (TILE / 4);
      int4* mine = slices + (size_t)split * (TILE / 4);
      if (live) {
#pragma unroll
        for (int r = 0; r < ACC / 4; ++r)
          __stcg(mine + r * THREADS + t,
                 make_int4(acc[4 * r], acc[4 * r + 1], acc[4 * r + 2],
                           acc[4 * r + 3]));
      }
      // one thread orders the block's writes before its ticket (the
      // barrier, then a cumulative fence) and, if last, the others' before
      // the block's reads
      __syncthreads();
      if (t == 0) {
        __threadfence();
        last = atomicAdd(counters + item, 1) == S - 1;
        if (last) __threadfence();
      }
      __syncthreads();
      write = last;
      if (write && live) {
        // the other splits' partials, R at a time in flight (one round
        // trip to L2 each time, not one per split)
        constexpr int R = BN == 128 ? 1 : 256 / BN;
        for (int s0 = 0; s0 < S; s0 += R) {
          int4 v[R][ACC / 4];
#pragma unroll
          for (int q = 0; q < R; ++q) {
            const int s = s0 + q;
#pragma unroll
            for (int r = 0; r < ACC / 4; ++r)
              v[q][r] = s < S && s != split
                            ? __ldcg(slices + (size_t)s * (TILE / 4) +
                                     r * THREADS + t)
                            : make_int4(0, 0, 0, 0);
          }
#pragma unroll
          for (int q = 0; q < R; ++q)
#pragma unroll
            for (int r = 0; r < ACC / 4; ++r) {
              acc[4 * r] += v[q][r].x;
              acc[4 * r + 1] += v[q][r].y;
              acc[4 * r + 2] += v[q][r].z;
              acc[4 * r + 3] += v[q][r].w;
            }
        }
      }
      if (write && t == 0) counters[item] = 0;
    }
    if (write) {
      const bool pairs = ((g.N | n0) & 1) == 0;  // 8-byte aligned pairs
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 16 * warp + (lane >> 2) + 8 * h;
        if (m >= m1) continue;
        int* row = out + (size_t)m * g.N;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int nn = n0 + 8 * j + 2 * (lane & 3);
          if (pairs && nn + 1 < n1) {
            *reinterpret_cast<int2*>(row + nn) =
                make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          } else {
            if (nn < n1) row[nn] = acc[4 * j + 2 * h];
            if (nn + 1 < n1) row[nn + 1] = acc[4 * j + 2 * h + 1];
          }
        }
      }
    }
    // the next unit's loads reuse the stages and `last`
    __syncthreads();
  }
}

template <int BN, int AMODE>
int launch(const CUtensorMap& map_b, const CUtensorMap& map_a,
           const Geom& g, const int4* units, int n_units, int S, int* out,
           int* ws, int* counters, int sms, cudaStream_t stream) {
  auto kern = tiled_int8_kernel<BN, AMODE>;
  constexpr int smem = smem_bytes<BN>();
  static std::atomic<int> opted_in[64];  // per device: the caller's current
  const int err = wg8::opt_in_smem(kern, smem, opted_in);
  if (err != 0) return err;
  const int grid =
      n_units < MAX_CTAS_PER_SM * sms ? n_units : MAX_CTAS_PER_SM * sms;
  kern<<<grid, THREADS, smem, stream>>>(map_b, map_a, g, units, n_units, S,
                                        out, ws, counters);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_bn(int amode, const CUtensorMap& map_b, const CUtensorMap& map_a,
              const Geom& g, const int4* units, int n_units, int S, int* out,
              int* ws, int* counters, int sms, cudaStream_t stream) {
  if (amode == A_TMA)
    return launch<BN, A_TMA>(map_b, map_a, g, units, n_units, S, out, ws,
                             counters, sms, stream);
  if (amode == A_ASYNC)
    return launch<BN, A_ASYNC>(map_b, map_a, g, units, n_units, S, out, ws,
                               counters, sms, stream);
  return launch<BN, A_REGS>(map_b, map_a, g, units, n_units, S, out, ws,
                            counters, sms, stream);
}

}  // namespace

extern "C" {

// x (B, H, W, C) int8; wt (N, Kp) int8, the (kh*kw*C, N) weights
// transposed and zero-padded to Kp (a multiple of 16, 16-byte aligned);
// units (n_units, 8) int32 (kernels/tiled_int8.py::work_units) of
// `items` items, S splits each, bn (32, 64 or 128) columns an item -> out
// (B, oh*ow, N) int32, written inside the items only (the caller zeroes
// what they do not cover). With S > 1, ws holds items*S*64*bn int32 and
// counters `items` int32 zeros (left at zero on return). Launches on the
// current device, which must hold every pointer; sms is its SM count.
int tiled_int8_launch(const void* x, const void* wt, int Kp,
                      const void* units, int n_units, int items, int S,
                      int bn, void* out, int B, int H, int W, int C, int N,
                      int kh, int kw, int stride, int pad, void* ws,
                      void* counters, int sms, void* stream) {
  const int oh = (H + 2 * pad - kh) / stride + 1;
  const int ow = (W + 2 * pad - kw) / stride + 1;
  const long long M = (long long)B * oh * ow;
  const int K = kh * kw * C;
  if (n_units == 0 || M <= 0 || N <= 0) return 0;
  if (n_units < 0 || M > 0x7fffffffLL || (long long)M * N > (1LL << 40) ||
      (bn != 32 && bn != 64 && bn != 128) || S < 1 || Kp < K || Kp % 16 != 0 ||
      (reinterpret_cast<uintptr_t>(wt) & 15) != 0 || sms < 1 ||
      (S > 1 && (ws == nullptr || counters == nullptr || items < 1)))
    return (int)cudaErrorInvalidValue;
  const bool x16 = C % 16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int amode = !x16 ? A_REGS
                    : (kh == 1 && kw == 1 && stride == 1 && pad == 0) ? A_TMA
                                                                      : A_ASYNC;
  CUtensorMap map_b, map_a;
  if (!wg8::make_map(&map_b, wt, (uint64_t)N, (uint64_t)Kp, (uint64_t)Kp,
                     (uint32_t)bn))
    return (int)cudaErrorNotSupported;
  if (amode == A_TMA) {
    if (!wg8::make_map(&map_a, x, (uint64_t)B * H * W, (uint64_t)C,
                       (uint64_t)C, (uint32_t)BM))
      return (int)cudaErrorNotSupported;
  } else {
    map_a = map_b;  // not read
  }
  Geom g{(const int8_t*)x, H, W, C, N, kw, stride, pad, oh, ow, (int)M, K};
  auto s = (cudaStream_t)stream;
  auto u = (const int4*)units;
  if (bn == 32)
    return launch_bn<32>(amode, map_b, map_a, g, u, n_units, S, (int*)out,
                         (int*)ws, (int*)counters, sms, s);
  if (bn == 64)
    return launch_bn<64>(amode, map_b, map_a, g, u, n_units, S, (int*)out,
                         (int*)ws, (int*)counters, sms, s);
  return launch_bn<128>(amode, map_b, map_a, g, u, n_units, S, (int*)out,
                        (int*)ws, (int*)counters, sms, s);
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
