// int8 tensor-core tile for the implicit-im2col convolution (K2), the
// GEMM at M > 16 (K1, as a 1x1 conv) and the megakernel's conv and gemm
// steps (K3).
//
// One block of 128 threads (4 warps, 2 x 2) computes a 64 x 64 int32 output
// tile with mma.sync.m16n8k32 (s8 x s8 -> s32): each warp owns 32 x 32, as
// 2 x 4 tensor-core tiles of 16 x 8, accumulated in registers. K advances
// in chunks of 64 through a 3-stage ring in shared memory:
//
//   A (the im2col patches, 64 pixels x 64 taps*channels): where C % 16 == 0,
//     16-byte cp.async copies straight from the NHWC input, one (pixel, tap,
//     16 channels) run each; out-of-image taps, rows past M and K past the
//     end are zero-filled by the src-size form of cp.async (the conv's
//     padding). Otherwise (the stem, C = 3) a scalar loader.
//   B (the weights, (K, N) row major): four rows of K are read as 8-byte
//     vectors (8 consecutive N), transposed in registers with byte permutes
//     into the .col operand's packing (4 consecutive K of one N column in
//     one 32-bit word) and stored as B^T rows (n, k); bytewise where
//     N % 8 != 0.
//
// COHERENT (K3): A was written earlier in the same launch by other blocks,
// and L1 is not coherent across SMs, so A goes through L2 only
// (cp.async.cg, __ldcg); K1 and K2 take the L1 path (cp.async.ca, __ldg).
// Weights and multipliers are never written in a launch: always __ldg.
//
// Both operands are read from shared memory with ldmatrix (rows padded to
// 80 bytes, so the 8 rows of one 8 x 16-byte matrix fall in distinct
// banks). Register-staged loads (B, and A on the scalar path) for chunk
// i + 2 are issued before the products of chunk i and stored after them.
//
// Split-K inside the launch: grid.y = S splits each take a balanced range
// of the K chunks. With S > 1 every block writes its int32 partial tile to
// its own slice of a workspace (in fragment order, coalesced), fences, and
// takes a ticket from the tile's counter; the last block to arrive sums
// the S slices, resets the counter to 0 (so the next launch and a
// CUDA-graph replay find it clean) and runs the epilogue. Integer sums are
// exact, so the order of the additions does not change a bit. (Adding the
// partials with red.global.add into one slot instead was 4-6 us slower per
// conv on an H100: the L2's atomic throughput, not the reads, is the
// limit.)
//
// The epilogue writes int32, int8 through rt::requant1 (int8_tile.cuh:
// float32 multiply, round half to even, saturate), per column or scalar,
// or (K3's int8 accumulators without a multiplier) the int32 value cast to
// int8; the multipliers are loaded before the K loop. `run_item` is one
// (tile, split) work item: tile, reduction and store.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "int8_tile.cuh"

namespace i8mma {

// BM, BN and BK are mirrored by kernels/conv2d_im2col.py (TILE_M, TILE_N,
// CHUNK_K), whose split chooser counts tiles and K chunks
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int LDS = BK + 16;   // bytes per shared-memory row (80)
constexpr int STAGES = 3;
constexpr int THREADS = 128;
constexpr int ACC = 32;        // int32 accumulators per thread

struct __align__(16) Smem {
  int8_t a[STAGES][BM * LDS];  // A rows (pixel m, k)
  int8_t b[STAGES][BN * LDS];  // B^T rows (channel n, k)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte async copy; src_bytes = 0 fills the 16 bytes with zeros.
// COHERENT: through L2 only (.cg), else cached in L1 too (.ca).
template <bool COHERENT>
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  if (COHERENT)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     dst),
                 "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     dst),
                 "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0,
                                            uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// d (16 x 8 s32) += a (16 x 32 s8, row) * b (32 x 8 s8, col)
__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct ConvGeom {
  const int8_t* x;
  const int8_t* w;
  int H, W, C, N, kw, stride, pad, oh, ow, M, K;
};

// The two A rows a thread fills (t / 4 and t / 4 + 32 of the tile), with
// their pixel's batch offset and top-left input coordinate.
struct ARows {
  const int8_t* xb[2];
  int iy0[2], ix0[2];
  bool valid[2];
};

__device__ __forceinline__ ARows a_rows(const ConvGeom& g, int m0) {
  ARows r;
  const int per = g.oh * g.ow;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + (threadIdx.x >> 2) + 32 * i;
    r.valid[i] = m < g.M;
    const int mm = r.valid[i] ? m : 0;
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

// A by cp.async (C % 16 == 0, x 16-byte aligned): thread t copies 16 bytes
// at k = k0 + 16 * (t % 4) for each of its two rows; the 16 channels lie
// in one tap.
template <bool COHERENT>
__device__ __forceinline__ void load_a_async(const ConvGeom& g,
                                             const ARows& r, int k0,
                                             int8_t* as) {
  const int t = threadIdx.x;
  const int k = k0 + 16 * (t & 3);
  const bool kin = k < g.K;
  int q = 0, c = 0, di = 0, dj = 0;
  if (kin) {
    q = k / g.C;
    c = k - q * g.C;
    di = q / g.kw;
    dj = q - di * g.kw;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int iy = r.iy0[i] + di, ix = r.ix0[i] + dj;
    const bool ok = kin && r.valid[i] && iy >= 0 && iy < g.H && ix >= 0 &&
                    ix < g.W;
    const int8_t* src =
        ok ? r.xb[i] + ((size_t)iy * g.W + ix) * g.C + c : g.x;
    const int row = (t >> 2) + 32 * i;
    cp_async16<COHERENT>(smem_u32(as + row * LDS + 16 * (t & 3)), src,
                         ok ? 16 : 0);
  }
}

// A bytewise (any C): the same 2 x 16 bytes, gathered into registers. The
// tap (di, dj) and channel c of k are found once and then stepped along
// the 16 values.
template <bool COHERENT>
__device__ __forceinline__ void load_a_regs(const ConvGeom& g,
                                            const ARows& r, int k0,
                                            uint4 (&v)[2]) {
  const int kb = k0 + 16 * (threadIdx.x & 3);
  int di = 0, dj = 0, c = 0;
  if (kb < g.K) {
    const int q = kb / g.C;
    c = kb - q * g.C;
    di = q / g.kw;
    dj = q - di * g.kw;
  }
  uint32_t wd[2][4] = {{0u, 0u, 0u, 0u}, {0u, 0u, 0u, 0u}};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (kb + j < g.K) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int iy = r.iy0[i] + di, ix = r.ix0[i] + dj;
        if (r.valid[i] && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W) {
          const signed char* p = (const signed char*)(
              r.xb[i] + ((size_t)iy * g.W + ix) * g.C + c);
          const int val = COHERENT ? __ldcg(p) : __ldg(p);
          wd[i][j >> 2] |= (uint32_t)(val & 0xff) << (8 * (j & 3));
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
  for (int i = 0; i < 2; ++i)
    v[i] = make_uint4(wd[i][0], wd[i][1], wd[i][2], wd[i][3]);
}

__device__ __forceinline__ void store_a_regs(const uint4 (&v)[2],
                                             int8_t* as) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2; ++i)
    *reinterpret_cast<uint4*>(as + ((t >> 2) + 32 * i) * LDS +
                              16 * (t & 3)) = v[i];
}

// Four rows of 8 int8 (v[r] = row r, columns 0..7) -> 8 words, word j =
// the 4 rows' values of column j (row r in byte r): the packing of
// mma's .col B operand and of a __dp4a weight word.
__device__ __forceinline__ void transpose_4x8(const uint2 (&v)[4],
                                              uint32_t (&wd)[8]) {
  const uint32_t lo01 = __byte_perm(v[0].x, v[1].x, 0x5140);
  const uint32_t lo23 = __byte_perm(v[2].x, v[3].x, 0x5140);
  const uint32_t hi01 = __byte_perm(v[0].x, v[1].x, 0x7362);
  const uint32_t hi23 = __byte_perm(v[2].x, v[3].x, 0x7362);
  wd[0] = __byte_perm(lo01, lo23, 0x5410);
  wd[1] = __byte_perm(lo01, lo23, 0x7632);
  wd[2] = __byte_perm(hi01, hi23, 0x5410);
  wd[3] = __byte_perm(hi01, hi23, 0x7632);
  const uint32_t lo01b = __byte_perm(v[0].y, v[1].y, 0x5140);
  const uint32_t lo23b = __byte_perm(v[2].y, v[3].y, 0x5140);
  const uint32_t hi01b = __byte_perm(v[0].y, v[1].y, 0x7362);
  const uint32_t hi23b = __byte_perm(v[2].y, v[3].y, 0x7362);
  wd[4] = __byte_perm(lo01b, lo23b, 0x5410);
  wd[5] = __byte_perm(lo01b, lo23b, 0x7632);
  wd[6] = __byte_perm(hi01b, hi23b, 0x5410);
  wd[7] = __byte_perm(hi01b, hi23b, 0x7632);
}

// B: thread t reads rows k0 + 4*(t % 16) + 0..3 at columns n0 + 8*(t / 16)
// + 0..7 and turns them into 8 words, word j = the 4 K values of column
// 8*(t / 16) + j. VEC: N % 8 == 0 and w 8-byte aligned (8-byte loads).
template <bool VEC>
__device__ __forceinline__ void load_b_regs(const ConvGeom& g, int k0,
                                            int n0, uint32_t (&wd)[8]) {
  const int t = threadIdx.x;
  const int k = k0 + 4 * (t & 15);
  const int n = n0 + 8 * (t >> 4);
  if (VEC) {
    uint2 v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      v[r] = (n < g.N && k + r < g.K)
                 ? __ldg(reinterpret_cast<const uint2*>(
                       g.w + (size_t)(k + r) * g.N + n))
                 : make_uint2(0u, 0u);
    transpose_4x8(v, wd);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        b[r] = (n + j < g.N && k + r < g.K)
                   ? (int)__ldg((const signed char*)(g.w +
                                                     (size_t)(k + r) * g.N +
                                                     n + j))
                   : 0;
      wd[j] = (uint32_t)rt::pack4(b[0], b[1], b[2], b[3]);
    }
  }
}

__device__ __forceinline__ void store_b_regs(const uint32_t (&wd)[8],
                                             int8_t* bs) {
  const int t = threadIdx.x;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    *reinterpret_cast<uint32_t*>(bs + (8 * (t >> 4) + j) * LDS +
                                 4 * (t & 15)) = wd[j];
}

// acc += the 64 x 64 x 64 product of one stage
__device__ __forceinline__ void mma_stage(const int8_t* as, const int8_t* bs,
                                          int (&acc)[2][4][4]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
#pragma unroll
  for (int ks = 0; ks < BK / 32; ++ks) {
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldmatrix_x4(smem_u32(as + (wm + 16 * mi + (lane & 15)) * LDS +
                           32 * ks + (lane >> 4) * 16),
                  a[mi][0], a[mi][1], a[mi][2], a[mi][3]);
#pragma unroll
    for (int np = 0; np < 2; ++np)
      ldmatrix_x4(smem_u32(bs + (wn + 16 * np + ((lane >> 4) << 3) +
                                 (lane & 7)) * LDS +
                           32 * ks + ((lane >> 3) & 1) * 16),
                  b[2 * np][0], b[2 * np][1], b[2 * np + 1][0],
                  b[2 * np + 1][1]);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
  }
}

// acc = the tile's product over K chunks [c0, c1)
template <bool VEC_A, bool VEC_B, bool COHERENT>
__device__ __forceinline__ void conv_tile(const ConvGeom& g, int m0, int n0,
                                          int c0, int c1,
                                          int (&acc)[2][4][4], Smem& sm) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
  const ARows rows = a_rows(g, m0);
  const int n = c1 - c0;
  uint4 av[2];
  uint32_t bw[8];
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) {
      const int k0 = (c0 + s) * BK;
      if (VEC_A) {
        load_a_async<COHERENT>(g, rows, k0, sm.a[s]);
      } else {
        load_a_regs<COHERENT>(g, rows, k0, av);
        store_a_regs(av, sm.a[s]);
      }
      load_b_regs<VEC_B>(g, k0, n0, bw);
      store_b_regs(bw, sm.b[s]);
    }
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = i + STAGES - 1;
    const int st = nxt % STAGES;
    if (nxt < n) {
      const int k0 = (c0 + nxt) * BK;
      if (VEC_A)
        load_a_async<COHERENT>(g, rows, k0, sm.a[st]);
      else
        load_a_regs<COHERENT>(g, rows, k0, av);
      load_b_regs<VEC_B>(g, k0, n0, bw);
    }
    cp_async_commit();
    mma_stage(sm.a[i % STAGES], sm.b[i % STAGES], acc);
    if (nxt < n) {
      if (!VEC_A) store_a_regs(av, sm.a[st]);
      store_b_regs(bw, sm.b[st]);
    }
  }
  cp_async_wait<0>();
}

// Split-K: write this block's partial tile to its own slice of the
// workspace (in fragment order, coalesced), fence, and take a ticket from
// the tile's counter; true for the last of the tile's S blocks, which then
// holds the sum of all S slices in acc (two slices in flight at a time)
// and has reset the tile's counter to 0 for the next launch.
__device__ __forceinline__ bool reduce_splits(int (&acc)[2][4][4], int* ws,
                                              int* counters, int tile,
                                              int split, int S) {
  __shared__ int last;
  const int t = threadIdx.x;
  int* flat = &acc[0][0][0];
  int4* slices = reinterpret_cast<int4*>(ws + (size_t)tile * S * (BM * BN));
  int4* mine = slices + (size_t)split * (BM * BN / 4);
#pragma unroll
  for (int r = 0; r < ACC / 4; ++r)
    __stcg(mine + r * THREADS + t,
           make_int4(flat[4 * r], flat[4 * r + 1], flat[4 * r + 2],
                     flat[4 * r + 3]));
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(counters + tile, 1) == S - 1;
  __syncthreads();
  if (!last) return false;
  __threadfence();
#pragma unroll
  for (int r = 0; r < ACC; ++r) flat[r] = 0;
  for (int s = 0; s < S; s += 2) {
    int4 v[2][ACC / 4];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int r = 0; r < ACC / 4; ++r)
        v[u][r] = s + u < S
                      ? __ldcg(slices + (size_t)(s + u) * (BM * BN / 4) +
                               r * THREADS + t)
                      : make_int4(0, 0, 0, 0);
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int r = 0; r < ACC / 4; ++r) {
        flat[4 * r] += v[u][r].x;
        flat[4 * r + 1] += v[u][r].y;
        flat[4 * r + 2] += v[u][r].z;
        flat[4 * r + 3] += v[u][r].w;
      }
  }
  if (t == 0) counters[tile] = 0;
  return true;
}

// The requant multipliers of this thread's 8 output columns, loaded before
// the K loop so the epilogue does not wait on them (1 when mult is null).
__device__ __forceinline__ void load_mults(const float* mult, int mult_len,
                                           int N, int n0, float (&mv)[4][2]) {
  const int lane = threadIdx.x & 31;
  const int nb = n0 + (threadIdx.x >> 6) * 32 + 2 * (lane & 3);
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = nb + 8 * ni + e;
      mv[ni][e] = (mult == nullptr || n >= N)
                      ? 1.f
                      : __ldg(mult + (mult_len == 1 ? 0 : n));
    }
}

// What the epilogue writes: int32, int8 through rt::requant1 with the
// thread's column multipliers, or the int32 value cast to int8.
enum OutMode { OUT_I32 = 0, OUT_REQUANT = 1, OUT_I8 = 2 };

// Store the tile in `mode`.
__device__ __forceinline__ void store_tile(const int (&acc)[2][4][4],
                                           void* out, int M, int N, int m0,
                                           int n0, int mode,
                                           const float (&mv)[4][2]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + (warp & 1) * 32 + 16 * mi + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + (warp >> 1) * 32 + 8 * ni + 2 * tig + e;
          if (n >= N) continue;
          const int v = acc[mi][ni][2 * h + e];
          const size_t o = (size_t)m * N + n;
          if (mode == OUT_REQUANT)
            reinterpret_cast<int8_t*>(out)[o] =
                (int8_t)rt::requant1(v, mv[ni][e]);
          else if (mode == OUT_I8)
            reinterpret_cast<int8_t*>(out)[o] = (int8_t)v;
          else
            reinterpret_cast<int*>(out)[o] = v;
        }
    }
}

// How many ways K is split: the least S for which tiles x S reaches `sms`
// blocks, at most one per K chunk (kernels/conv2d_im2col.py::conv_splits,
// which the CPU tests hold).
__host__ __device__ __forceinline__ int split_count(long long tiles,
                                                   int chunks, int sms) {
  long long s = (sms + tiles - 1) / tiles;
  if (s > chunks) s = chunks;
  return s > 1 ? (int)s : 1;
}

// One work item of an (M, N) = A (M, K) x B (K, N) product: tile `tile`
// (m-fastest over tiles_m rows of tiles), split `split` of S over the
// `chunks` K chunks; the tile's last split block stores it in `mode`.
// Every thread of the block calls it; it returns with the block's shared
// memory still in use by slow warps, so a caller that runs another item
// synchronises the block first.
template <bool VEC_A, bool VEC_B, bool COHERENT>
__device__ __forceinline__ void run_item(const ConvGeom& g,
                                         const float* mult, int mult_len,
                                         void* out, int mode, int tiles_m,
                                         int chunks, int tile, int split,
                                         int S, int* ws, int* counters,
                                         Smem& sm) {
  const int m0 = (tile % tiles_m) * BM;
  const int n0 = (tile / tiles_m) * BN;
  const int c0 = (int)((long long)split * chunks / S);
  const int c1 = (int)((long long)(split + 1) * chunks / S);
  float mv[4][2];
  load_mults(mult, mult_len, g.N, n0, mv);
  int acc[2][4][4];
  conv_tile<VEC_A, VEC_B, COHERENT>(g, m0, n0, c0, c1, acc, sm);
  if (S > 1 && !reduce_splits(acc, ws, counters, tile, split, S)) return;
  store_tile(acc, out, g.M, g.N, m0, n0, mode, mv);
}

}  // namespace i8mma
