// K4: blockwise GQA attention with an online softmax (flash attention).
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_pallas (with
// _make_kernel) of the JAX package. On the TPU the grid's kv axis runs in
// order on one core and the (m, l, acc) state lives in VMEM scratch across
// it; here each block owns one (batch*q-head, q tile) and loops over its own
// kv tiles, with the state in registers. The semantics are the Pallas
// kernel's:
//   - GQA: q head h reads kv head h / (Hq / Hkv);
//   - query i sees kv j iff j <= i + (Skv - Sq) (causal, with the decode
//     offset) and j > i + (Skv - Sq) - window (sliding window, if any);
//     kv rows past Skv are masked; `scale` defaults to 1/sqrt(D);
//   - the per-tile online softmax uses the -1e30 sentinel (not -inf) and
//     divides by max(l, 1e-30), so a row whose first visited tile is fully
//     masked never sees exp(-inf - -inf) = NaN, and a row with no visible
//     kv at all gives 0;
//   - tiles that the causal or window condition masks for every row of the
//     q tile are skipped (the loop bounds start and stop at the visible
//     range);
//   - output in q's dtype.
//
// What bounds it on an H100: at the path's shape (zamba2-1.2B prefill,
// q/k/v (1, 32, 128, 64) bf16, causal) the work is 2 x 2 x 32 x 128 x 128
// x 64 / 2 = about 0.07 GFLOP against 2 MB of q, k, v and output: bytes
// bound (about 0.6 us at 3.35 TB/s; the FLOPs take about 0.07 us at
// 989 TFLOP/s bf16 dense). At that size what the kernel can win is latency:
// enough blocks to fill the card, and a short critical path per block.
//
// Two kernels, by dtype:
//
// f16 and bf16 (flash_attention_kernel_tc): tensor cores. A block of four
// warps owns 32 q rows (128 blocks at the path's shape on 132 SMs): two row
// groups of 16 rows, each held by two warps, the kv lanes, that split every
// kv tile in halves. Each lane keeps its own online softmax over its halves;
// at the end lane 1 hands (m, l, acc) to lane 0 through shared memory, which
// merges them (m = max of the two, each side rescaled by exp(m_side - m)).
// The lanes halve the serial chain of dependent MMAs and exps a block walks
// per tile, which is what bounds the small grids of the LM paths (a prefill
// of 128 tokens, Sq = 1 in a decode step). The head dim is zero-padded to
// DP = 16, 32, 64, 128 or 256 in shared memory (k-steps and output tiles
// past D are skipped).
//   - S = Q K^T with mma.sync.m16n8k16 (16-bit operands, f32 accumulators);
//     the Q fragments are loaded once with ldmatrix and kept in registers
//     for the whole kv loop (read from shared memory instead at DP = 256,
//     where the f32 accumulator already takes 128 registers);
//   - K and V tiles (64 rows, 32 at DP = 256) stay 16-bit in shared memory,
//     fetched by 16-byte cp.async copies into two stages, so the next tile
//     loads while this one is used (element loads where D % 8 != 0);
//   - scores never leave registers: `scale` multiplies S in f32 after the
//     product (folded with log2 e, so exp2 is exp), the visible() mask
//     sets the sentinel, each row's max and sum are reduced over the 4
//     lanes of its quad; the correction exp(m - m_new) rescales acc and l;
//   - P is rounded to the input's type in registers and used directly as
//     the A operand of P V (V read with ldmatrix.trans); l sums the f32 P.
//     The TPU kernel's default-precision f32 dot also multiplies in bf16.
//     P is relative to its lane's running max, so its rounding differs from
//     one softmax over the whole tile by the same relative 2^-9 (bf16).
//
// f32 (flash_attention_kernel): CUDA cores, in f32 throughout. zamba2's
// float32 correctness cell (card against CPU, and Server streams equal to
// ServeEngine.serve token for token) holds K4 in f32 to atol 3e-5, which
// the tensor cores' TF32 or 16-bit rounding of the operands would break.
// 64 q rows x TPR threads per row (TPR = 1, 2, 4 or 8, so that each thread
// holds at most 32 of the D <= 256 head dims of its row's q and
// accumulator in registers); a kv tile of 64 rows is staged in shared
// memory as f32, each row's 64 scores are reduced across its TPR lanes
// with warp shuffles and kept in shared memory, then the tile's max
// updates (m, l, acc) as in the Pallas kernel; `scale` multiplies q.
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

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

__device__ __forceinline__ bool visible(int kpos, int qpos, int Skv,
                                        int causal, int window) {
  bool ok = kpos < Skv;
  if (causal) ok = ok && kpos <= qpos;
  if (window >= 0) ok = ok && kpos > qpos - window;
  return ok;
}

// -- f16 / bf16 on the tensor cores -----------------------------------------

constexpr int TC_ROWS = 2;             // row groups per block, 16 q rows each
constexpr int TC_LANES = 2;            // kv lanes: warps that split a tile
constexpr int TC_WARPS = TC_ROWS * TC_LANES;
constexpr int TC_BQ = 16 * TC_ROWS;    // q rows per block
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (16 x 8 f32) += a (16 x 16, row) * b (16 x 8, col)
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t* a,
                                         uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(
    float (&d)[4], const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float (&d)[4],
                                                 const uint32_t* a,
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to T, the lower column in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows x DP tile of 16-bit values into shared memory (row stride LD), rows
// past `valid` and columns past D zero; cp.async when `vec` (D % 8 == 0 and
// 16-byte aligned rows), element copies otherwise
template <int ROWS, int DP, int LD>
__device__ __forceinline__ void load_tile16(uint16_t* dst,
                                            const uint16_t* src, int valid,
                                            int D, bool vec) {
  if (vec) {
    constexpr int PER_ROW = DP / 8;
    for (int e = threadIdx.x; e < ROWS * PER_ROW; e += blockDim.x) {
      const int r = e / PER_ROW, c = (e % PER_ROW) * 8;
      const bool ok = r < valid && c < D;
      cp_async16(smem_u32(dst + r * LD + c),
                 ok ? src + (size_t)r * D + c : src, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * DP; e += blockDim.x) {
      const int r = e / DP, c = e % DP;
      dst[r * LD + c] = (r < valid && c < D) ? src[(size_t)r * D + c]
                                             : (uint16_t)0;
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(TC_WARPS * 32)
flash_attention_kernel_tc(const uint16_t* __restrict__ q,
                          const uint16_t* __restrict__ k,
                          const uint16_t* __restrict__ v,
                          uint16_t* __restrict__ out, int Hq, int Hkv,
                          int Sq, int Skv, int D, int causal, int window,
                          float scale, int vec) {
  constexpr int BKV = DP <= 128 ? 64 : 32;   // kv rows per tile
  constexpr int HB = BKV / TC_LANES;          // kv rows per lane per tile
  constexpr int LD = DP + 8;                  // row stride in elements
  constexpr bool QREG = DP <= 128;            // Q fragments in registers
  constexpr int KS = DP / 16;                 // k-steps of Q K^T
  constexpr int NT = HB / 8;                  // 8-column tiles of S
  constexpr int DT = DP / 8;                  // 8-column tiles of acc
  extern __shared__ uint4 smem_tc[];
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem_tc);   // TC_BQ x LD
  uint16_t* Ks = Qs + TC_BQ * LD;                        // 2 x BKV x LD
  uint16_t* Vs = Ks + 2 * BKV * LD;                      // 2 x BKV x LD

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // warp = kv lane * TC_ROWS + row group: the row group's 16 q rows
  // against the lane's half of every kv tile
  const int rg = warp % TC_ROWS, kl = warp / TC_ROWS;
  const int g = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int kvh = (bh % Hq) / (Hq / Hkv);
  const int i0 = blockIdx.x * TC_BQ;
  const int offs = Skv - Sq;
  const int D16 = (D + 15) & ~15;
  const float sl2 = scale * LOG2E;

  load_tile16<TC_BQ, DP, LD>(Qs, q + ((size_t)bh * Sq + i0) * D,
                             min(TC_BQ, Sq - i0), D, vec);
  cp_async_commit();

  // the kv range any row of this tile can see; tiles outside it are skipped
  const int last_q = min(i0 + TC_BQ, Sq) - 1 + offs;
  const int j_end = causal ? min(Skv, last_q + 1) : Skv;
  int j_begin = window >= 0 ? max(0, i0 + offs - window + 1) : 0;
  j_begin = (j_begin / BKV) * BKV;
  const int ntiles = j_end > j_begin ? (j_end - j_begin + BKV - 1) / BKV : 0;
  const size_t kv_base = ((size_t)b * Hkv + kvh) * Skv * D;
  if (ntiles > 0) {
    const size_t off = kv_base + (size_t)j_begin * D;
    load_tile16<BKV, DP, LD>(Ks, k + off, min(BKV, Skv - j_begin), D, vec);
    load_tile16<BKV, DP, LD>(Vs, v + off, min(BKV, Skv - j_begin), D, vec);
  }
  cp_async_commit();

  // this thread's two rows: g and g + 8 of the warp's 16
  const int qpos0 = i0 + rg * 16 + g + offs;
  const int qpos[2] = {qpos0, qpos0 + 8};
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};

  const uint32_t q_addr = smem_u32(Qs + (rg * 16 + (lane & 15)) * LD +
                                   (lane >> 4) * 8);
  uint32_t qf[QREG ? KS : 1][4];
  cp_async_wait_all();
  __syncthreads();
  if (QREG) {
#pragma unroll
    for (int ks = 0; ks < (QREG ? KS : 1); ++ks)
      ldsm_x4(q_addr + ks * 32, qf[ks]);
  }

  for (int t = 0; t < ntiles; ++t) {
    const int j0 = j_begin + t * BKV;
    const int st = t & 1;
    if (t > 0) {
      cp_async_wait_all();
      __syncthreads();   // tile t landed; every warp is done with tile t-1
    }
    if (t + 1 < ntiles) {
      const int jn = j0 + BKV;
      const size_t off = kv_base + (size_t)jn * D;
      load_tile16<BKV, DP, LD>(Ks + (st ^ 1) * BKV * LD, k + off,
                               min(BKV, Skv - jn), D, vec);
      load_tile16<BKV, DP, LD>(Vs + (st ^ 1) * BKV * LD, v + off,
                               min(BKV, Skv - jn), D, vec);
    }
    cp_async_commit();
    const uint16_t* Kt = Ks + (st * BKV + kl * HB) * LD;
    const uint16_t* Vt = Vs + (st * BKV + kl * HB) * LD;

    // S = Q K^T
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (ks * 16 >= D16) break;
      uint32_t a[4];
      if (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[QREG ? ks : 0][e];
      } else {
        ldsm_x4(q_addr + ks * 32, a);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        ldsm_x4(smem_u32(Kt + ((2 * np + (lane >> 4)) * 8 + (lane & 7)) * LD +
                         ks * 16 + ((lane >> 3) & 1) * 8),
                bf);
        mma16816<T>(s[2 * np], a, bf[0], bf[1]);
        mma16816<T>(s[2 * np + 1], a, bf[2], bf[3]);
      }
    }

    // scale, mask, and the tile's row max over the quad
    uint32_t vis = 0;
    float tmax[2] = {NEG, NEG};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = j0 + kl * HB + nt * 8 + 2 * tig + (e & 1);
        const bool ok = visible(kpos, qpos[e >> 1], Skv, causal, window);
        s[nt][e] = ok ? s[nt][e] * sl2 : NEG;
        vis |= (ok ? 1u : 0u) << (nt * 4 + e);
        tmax[e >> 1] = fmaxf(tmax[e >> 1], s[nt][e]);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 1));
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 2));
      const float m_new = fmaxf(m[h], tmax[h]);
      corr[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dt][e] *= corr[e >> 1];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (vis >> (nt * 4 + e)) & 1u
                            ? exp2f(s[nt][e] - m[e >> 1])
                            : 0.f;
        s[nt][e] = p;
        l[e >> 1] += p;
      }

    // acc += P V, P rounded to T in registers as the A operand
#pragma unroll
    for (int kk = 0; kk < HB / 16; ++kk) {
      const uint32_t a[4] = {pack2<T>(s[2 * kk][0], s[2 * kk][1]),
                             pack2<T>(s[2 * kk][2], s[2 * kk][3]),
                             pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        if (dp * 16 >= D16) break;
        uint32_t bf[4];
        ldsm_x4_trans(
            smem_u32(Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                     (2 * dp + (lane >> 4)) * 8),
            bf);
        mma16816<T>(acc[2 * dp], a, bf[0], bf[1]);
        mma16816<T>(acc[2 * dp + 1], a, bf[2], bf[3]);
      }
    }
  }

  // l over the quad
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  // lane 1 hands its (m, l, acc) to lane 0 through the K buffer (every
  // warp is done with it, and no copy is in flight into it), which merges
  // the two online softmaxes: m = max(m0, m1), each side rescaled by
  // exp(m_side - m)
  cp_async_wait_all();
  __syncthreads();
  float* xs = reinterpret_cast<float*>(Ks) + (rg * 32 + lane) * (4 * DT + 4);
  if (kl == 1) {
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) xs[dt * 4 + e] = acc[dt][e];
    xs[4 * DT] = m[0];
    xs[4 * DT + 1] = m[1];
    xs[4 * DT + 2] = l[0];
    xs[4 * DT + 3] = l[1];
  }
  __syncthreads();
  if (kl == 1) return;
  float c0[2], c1[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m1 = xs[4 * DT + h];
    const float m_new = fmaxf(m[h], m1);
    c0[h] = exp2f(m[h] - m_new);
    c1[h] = exp2f(m1 - m_new);
    l[h] = l[h] * c0[h] + xs[4 * DT + 2 + h] * c1[h];
  }
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[dt][e] = acc[dt][e] * c0[e >> 1] + xs[dt * 4 + e] * c1[e >> 1];

  // acc / max(l, 1e-30) in T
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = i0 + rg * 16 + g + 8 * h;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[h], 1e-30f);
    uint16_t* orow = out + ((size_t)bh * Sq + row) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int d = dt * 8 + 2 * tig;
      if (d >= D) continue;
      const uint32_t pr = pack2<T>(acc[dt][2 * h] / denom,
                                   acc[dt][2 * h + 1] / denom);
      if ((D & 1) == 0) {
        *reinterpret_cast<uint32_t*>(orow + d) = pr;
      } else {
        orow[d] = (uint16_t)(pr & 0xffffu);
        if (d + 1 < D) orow[d + 1] = (uint16_t)(pr >> 16);
      }
    }
  }
}

// Shared memory above 48 KB needs an opt-in, once per device and
// instantiation (kept out of the launch path, so launches can be
// graph-captured).
template <typename Kern>
int opt_in_smem(Kern kern, size_t smem, int (&opted_in)[64]) {
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (opted_in[dev] < (int)smem) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = (int)smem;
  }
  return 0;
}

template <typename T, int DP>
int launch_tc(const void* q, const void* k, const void* v, void* out, int B,
              int Hq, int Hkv, int Sq, int Skv, int D, int causal,
              int window, float scale, cudaStream_t stream) {
  constexpr int BKV = DP <= 128 ? 64 : 32;
  const size_t smem = (size_t)(TC_BQ + 4 * BKV) * (DP + 8) * sizeof(uint16_t);
  auto kern = flash_attention_kernel_tc<T, DP>;
  static int opted_in[64] = {0};
  const int err = opt_in_smem(kern, smem, opted_in);
  if (err != 0) return err;
  const bool vec = D % 8 == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) |
                     reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  dim3 grid((Sq + TC_BQ - 1) / TC_BQ, B * Hq);
  kern<<<grid, TC_WARPS * 32, smem, stream>>>(
      (const uint16_t*)q, (const uint16_t*)k, (const uint16_t*)v,
      (uint16_t*)out, Hq, Hkv, Sq, Skv, D, causal, window, scale, (int)vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tc_d(const void* q, const void* k, const void* v, void* out,
                int B, int Hq, int Hkv, int Sq, int Skv, int D, int causal,
                int window, float scale, cudaStream_t s) {
  if (D <= 16)
    return launch_tc<T, 16>(q, k, v, out, B, Hq, Hkv, Sq, Skv, D, causal,
                            window, scale, s);
  if (D <= 32)
    return launch_tc<T, 32>(q, k, v, out, B, Hq, Hkv, Sq, Skv, D, causal,
                            window, scale, s);
  if (D <= 64)
    return launch_tc<T, 64>(q, k, v, out, B, Hq, Hkv, Sq, Skv, D, causal,
                            window, scale, s);
  if (D <= 128)
    return launch_tc<T, 128>(q, k, v, out, B, Hq, Hkv, Sq, Skv, D, causal,
                             window, scale, s);
  return launch_tc<T, 256>(q, k, v, out, B, Hq, Hkv, Sq, Skv, D, causal,
                           window, scale, s);
}

// -- f32 on the CUDA cores ---------------------------------------------------

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
  static int opted_in[64] = {0};
  const int err = opt_in_smem(kern, smem, opted_in);
  if (err != 0) return err;
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
      return launch_tc_d<__half>(q, k, v, out, B, Hq, Hkv, Sq, Skv, D,
                                 causal, window, scale, s);
    case 2:
      return launch_tc_d<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, Sq, Skv, D,
                                        causal, window, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
