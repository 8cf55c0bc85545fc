// Weight-only quantized matmul for sm_90a: the body shared by
// int8_matmul.cu and int4_matmul.cu.
//
//   out[M, N] = (x[M, K] @ W[K, N]) * scales      (fp32 sums, FMA)
//
// x and out are both fp32 or both bf16 (out rounded to nearest even at
// the store).  W is one of:
//   * int8 codes [K, N] with per-column scales [N] (MODE kInt8);
//   * packed int4 [K2, N], K2 = ceil(K / 2), two codes a byte in split
//     halves: byte row r holds code r in its low nibble and code K2 + r in
//     its high nibble, each biased by +8; columns of x at K or beyond read
//     0 (odd K).  Per-column scales [N] (kInt4) or group scales [G, N]
//     over groups of g = K / G rows of W (kInt4Group): each group's fp32
//     partial dot is scaled, then added to the sum, as the TPU kernel does.
// They replace the three Pallas kernels of tpu_flash/kernels/quant.py:
// _matmul_kernel (:49, pallas_call at :103), _matmul4_kernel (:228, at
// :383) and _matmul4_group_kernel (:258, at :371), which feed the codes to
// the MXU in x's dtype with fp32 sums, block_m = min(256, round_up(M, 8)).
// A product of a bf16 or fp32 x and a small integer code is exact in an
// FMA and in a bf16 tensor-core product, so every form gives the TPU
// kernels' numbers up to the order of the sums.
//
// Six forms, picked by the wrapper (kernels/quant.py _plan), each a kernel
// of its own:
//   * decode on the tensor cores (bf16 x, M <= 8, groups and N a multiple
//     of 16): quant_matmul_dec_body below, one launch a call, no workspace;
//   * decode on the tensor cores for fp32 x (M <= 8; int8, int4 per
//     column, and int4 in groups that are a multiple of 16; N a multiple
//     of 16): the same body, x's slice split into three bf16 planes, three
//     products a product;
//   * prefill on the tensor cores (bf16 x, M > 8, groups a multiple of
//     16): quant_matmul_tc_body below;
//   * prefill on the tensor cores for fp32 x (M > 8; int8, int4 per
//     column, and int4 in groups that are a multiple of 16):
//     quant_matmul_x3_body below, x split into three bf16 planes, three
//     products a product;
//   * the CUDA-core forms (groups that are not a multiple of 16, at M <= 8
//     N that is not, and more code rows than the decode forms' clusters
//     take): quant_matmul_body, BM = 8 (M <= 8)
//     or 64 (such groups above M = 8, the only CUDA-core prefill kernel
//     left).
//
// The CUDA-core forms: one block of 256 threads (8 warps) per [BM, 128]
// tile of out and per split of the code rows (blockIdx.z).  Each slab of BK
// code rows is loaded as 16-byte pieces along N, the next slab's pieces
// issued before the current one is computed, and x's matching columns go to
// shared memory as fp32.  A lane owns 4 columns and 8 rows of out: one
// 32-bit word of codes a row feeds 32 FMAs (int8) or 64 (int4), and each
// code becomes a float once per warp, by a byte permute and an add.  BM = 8:
// BK = 128, the 8 warps split each slab's rows and sum their [8, 128] tiles
// in shared memory at the end; BM = 64: BK = 32, a warp per 8 rows of out.
// The wrapper splits the code rows over blockIdx.z until there are two
// blocks a streaming multiprocessor; with more than one split each block
// writes its fp32 partial sums to a [S, M, N] workspace and a second kernel
// sums them in split order, scales and rounds.  Grouped, a lane keeps the
// low and the high group's partial sums beside its total and scales them at
// a group's last row (and, when warps split a slab, at the end of its rows),
// so no group size is tied to the slab.
// Ragged M, N and K are masked in every kernel: nothing is padded.

#pragma once

#include <cooperative_groups.h>
#include <cuda.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 128;  // output columns per block

enum Mode { kInt8 = 0, kInt4 = 1, kInt4Group = 2 };

struct QParams {
  const void* x;         // [M, K], fp32 or bf16
  const uint8_t* w;      // int8 codes [K, N] or packed int4 [K2, N]
  const float* scales;   // [N], or [G, N] grouped
  void* out;             // [M, N] (one split)
  float* part;           // [S, M, N] fp32 partial sums (several splits)
  int M, N, K;
  int rows;              // code rows: K, or K2 packed
  int chunk;             // code rows a split, a multiple of BK
  int group;             // grouped: K / G
  bool bf16;             // x and out bf16, else fp32
};

// Four int8 codes of a word as exact floats: each byte, biased to
// unsigned, becomes the low byte of the mantissa of 2^23, and 2^23 + 128 is
// subtracted.
__device__ __forceinline__ void int8x4(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | e)) -
           8388736.f;
}

// The low and the high nibbles of a word's four bytes as exact floats of
// (nibble - 8), the same way.
__device__ __forceinline__ void int4x8(uint32_t w, float* lo, float* hi) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    lo[e] = __int_as_float(((w >> (8 * e)) & 0xFu) | 0x4B000000u) -
            8388616.f;
    hi[e] = __int_as_float(((w >> (8 * e + 4)) & 0xFu) | 0x4B000000u) -
            8388616.f;
  }
}

// Four sums of row m, columns n.. n+3: to the split's partial sums, or
// scaled (per-column modes) and rounded to out.
__device__ __forceinline__ void emit(const QParams& p, int m, int n,
                                     const float* v, bool scale) {
  if (m >= p.M) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (n + j >= p.N) return;
    if (p.part) {
      p.part[((size_t)blockIdx.z * p.M + m) * p.N + n + j] = v[j];
    } else {
      const float s = scale ? p.scales[n + j] : 1.f;
      store1(p.out, (size_t)m * p.N + n + j, v[j] * s, p.bf16);
    }
  }
}

// WM warps along M (8 rows each), the other 8 / WM along the slab's rows.
template <int WM, int BK, int MODE>
__device__ __forceinline__ void quant_matmul_body(const QParams& p) {
  constexpr int kWarps = kThreads / 32;
  constexpr int WK = kWarps / WM;
  constexpr int BM = 8 * WM;
  constexpr int RW = BK / WK;                // slab rows a warp
  constexpr bool INT4 = MODE != kInt8;
  constexpr int XT = INT4 ? 2 : 1;           // x tiles a slab: low, high half
  constexpr int XST = BM + 4;                // x row stride: 4-way conflicts
  constexpr int XS = XT * BK * XST;          // floats
  constexpr int PIECES = kBN / 16;           // 16-byte pieces a code row
  constexpr int LOADS = BK * PIECES / kThreads;
  constexpr int RED = WK > 1 ? WK * BM * kBN : 0;   // floats, warps' sums
  constexpr int BYTES = XS * 4 + BK * kBN > RED * 4 ? XS * 4 + BK * kBN
                                                    : RED * 4;
  static_assert(LOADS * kThreads == BK * PIECES && RW * WK == BK, "tiles");
  static_assert(WK == 1 || BM * kBN == 4 * kThreads, "warp sum");
  constexpr uint8_t kZero = INT4 ? 0x88 : 0;     // a code of value 0

  __shared__ __align__(16) unsigned char smem[BYTES];
  float* xs = reinterpret_cast<float*>(smem);       // [XT][BK][XST]
  uint8_t* ws = smem + XS * 4;                      // [BK][kBN]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wk = warp / WM;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * p.chunk;
  const int kend = min(p.rows, kbeg + p.chunk);
  const bool vec = p.N % 16 == 0;              // rows keep 16-byte alignment

  uint4 cw[LOADS];
  auto load_codes = [&](int k0) {
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
      const int idx = tid + l * kThreads;
      const int kr = k0 + idx / PIECES, n = n0 + (idx % PIECES) * 16;
      const uint8_t* src = p.w + (size_t)kr * p.N + n;
      if (vec && kr < kend && n + 16 <= p.N) {
        cw[l] = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
        uint32_t b[4] = {0, 0, 0, 0};
        for (int i = 0; i < 16; ++i) {
          const uint32_t c = kr < kend && n + i < p.N ? src[i] : kZero;
          b[i / 4] |= c << (8 * (i % 4));
        }
        cw[l] = make_uint4(b[0], b[1], b[2], b[3]);
      }
    }
  };

  float acc[8][4], plo[8][4], phi[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = plo[i][j] = phi[i][j] = 0.f;

  if (kbeg < kend) load_codes(kbeg);
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    __syncthreads();   // the previous slab is no longer read
    for (int i = tid; i < XT * BK * BM; i += kThreads) {
      const int t = i / (BK * BM), j = i % (BK * BM);
      const int r = j % BK, m = j / BK;   // neighbouring threads: along K
      const int kr = k0 + r;
      const int col = t ? p.rows + kr : kr;
      float v = 0.f;
      if (kr < kend && m0 + m < p.M && col < p.K)
        v = load1(p.x, (size_t)(m0 + m) * p.K + col, p.bf16);
      xs[(t * BK + r) * XST + m] = v;
    }
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
      const int idx = tid + l * kThreads;
      *reinterpret_cast<uint4*>(ws + (idx / PIECES) * kBN +
                                (idx % PIECES) * 16) = cw[l];
    }
    __syncthreads();
    if (k0 + BK < kend) load_codes(k0 + BK);   // in flight while computing

#pragma unroll 4
    for (int rr = 0; rr < RW; ++rr) {
      const int r = wk * RW + rr;
      const uint32_t word =
          *reinterpret_cast<const uint32_t*>(ws + r * kBN + 4 * lane);
      float xa[8], xb[8];
      const float4* xp =
          reinterpret_cast<const float4*>(xs + r * XST + wm * 8);
      const float4 a0 = xp[0], a1 = xp[1];
      xa[0] = a0.x; xa[1] = a0.y; xa[2] = a0.z; xa[3] = a0.w;
      xa[4] = a1.x; xa[5] = a1.y; xa[6] = a1.z; xa[7] = a1.w;
      if constexpr (MODE == kInt8) {
        float c[4];
        int8x4(word, c);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xa[i], c[j], acc[i][j]);
      } else {
        const float4* hp = reinterpret_cast<const float4*>(
            xs + (BK + r) * XST + wm * 8);
        const float4 b0 = hp[0], b1 = hp[1];
        xb[0] = b0.x; xb[1] = b0.y; xb[2] = b0.z; xb[3] = b0.w;
        xb[4] = b1.x; xb[5] = b1.y; xb[6] = b1.z; xb[7] = b1.w;
        float lo[4], hi[4];
        int4x8(word, lo, hi);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if constexpr (MODE == kInt4Group) {
              plo[i][j] = fmaf(xa[i], lo[j], plo[i][j]);
              phi[i][j] = fmaf(xb[i], hi[j], phi[i][j]);
            } else {
              acc[i][j] = fmaf(xa[i], lo[j], acc[i][j]);
              acc[i][j] = fmaf(xb[i], hi[j], acc[i][j]);
            }
          }
      }
      if constexpr (MODE == kInt4Group) {
        // a group's last row, this split's, or the last of the warp's rows
        // in the slab (its next rows lie in another group): scale the low
        // half's and the high half's partial dots and add them
        const int kr = k0 + r;
        if (kr < kend && ((kr + 1) % p.group == 0 || kr + 1 == kend ||
                          (WK > 1 && rr == RW - 1))) {
          const float* slo = p.scales + (size_t)(kr / p.group) * p.N;
          const float* shi =
              p.scales + (size_t)((p.rows + kr) / p.group) * p.N;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = min(n0 + 4 * lane + j, p.N - 1);
            const float a = slo[n], b = shi[n];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              acc[i][j] += plo[i][j] * a;
              acc[i][j] += phi[i][j] * b;
              plo[i][j] = phi[i][j] = 0.f;
            }
          }
        }
      }
    }
  }

  constexpr bool scale = MODE != kInt4Group;
  if constexpr (WK == 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      emit(p, m0 + wm * 8 + i, n0 + 4 * lane, acc[i], scale);
  } else {
    // the warps' [8, 128] sums, added in warp order
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem);    // [WK][BM][kBN]
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<float4*>(red + (wk * BM + wm * 8 + i) * kBN +
                                 4 * lane) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    __syncthreads();
    const int m = 4 * tid / kBN, c = 4 * tid % kBN;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    for (int w = 0; w < WK; ++w) {
      const float4 q =
          *reinterpret_cast<const float4*>(red + (w * BM + m) * kBN + c);
      v[0] += q.x; v[1] += q.y; v[2] += q.z; v[3] += q.w;
    }
    emit(p, m0 + m, n0 + c, v, scale);
  }
}

// --- the tensor-core prefill form ------------------------------------------
//
// For bf16 x at M > 8 (and groups that are a multiple of 16): bf16 products
// with fp32 sums on the tensor cores (mma.sync.m16n8k16), the arithmetic of
// the TPU kernels, which feed the codes to the MXU in x's dtype: every code
// (|c| <= 127) is exact in bf16, and no scale touches a code before the
// product.  One block of 256 threads (8 warps, 4 along M by 2 along N, a
// warp 32 x 32 of out) per [128, 64] tile of out and per split of the code
// rows.  A step covers 64 of x's columns and the 64 code rows that meet
// them: int8, 64 code rows; int4, 64 packed rows, whose low codes meet x's
// first half and whose high codes its second, so the block walks its
// packed rows twice, the low codes first (the second pass reads the same
// bytes again from L2, and converts the other nibbles).
//   * x's [128, 64] bf16 and the raw codes' [64, 64] bytes come by cp.async
//     into a ring of kTcStages stages, so that three steps' loads are in
//     flight while one is computed;
//   * each thread converts the 16 code bytes it loaded to bf16 into a
//     shared [64, 64] tile (two buffers), one step ahead, once per block:
//     each code feeds the 4 warps along M;
//   * each warp reads its fragments with ldmatrix (.trans for the codes,
//     stored K by N) from rows padded by 16 bytes, which keeps both reads
//     free of bank conflicts.
// Grouped, a warp keeps the current group's partial products apart and
// scales them into the sum at the group's last 16 rows (or its split's
// last), as _matmul4_group_kernel does; one walk over a half at a time
// needs one partial, not two.
// mma.sync and not wgmma: the simpler operand layouts (no shared-memory
// descriptors, no warpgroup-wide asynchrony) are the ones a first tensor-core
// form could be made right with; wgmma would add the rate of a warpgroup-wide
// product and TMA loads (ROADMAP.md).

constexpr int kTcThreads = 256;
constexpr int kTcBM = 128;     // rows of out a block
constexpr int kTcBN = 64;      // columns of out a block
constexpr int kTcRows = 64;    // code rows a step (int4: packed rows)
constexpr int kTcStages = 4;   // steps of x and raw codes in shared memory
constexpr int kTcP = 64 + 8;   // tile row pitch, bf16: x rows, code rows
constexpr int kTcXs = kTcBM * kTcP;          // bf16, x, a stage
constexpr int kTcRaw = kTcRows * kTcBN;      // bytes, raw codes, a stage
constexpr int kTcCs = kTcRows * kTcP;        // bf16, converted codes
constexpr int kTcSmem = kTcStages * (2 * kTcXs + kTcRaw) + 2 * 2 * kTcCs;

// (nibble - 8) of the low byte of each half of a word as a bf16 pair:
// 0x4300 | nibble is the bf16 128 + nibble, less 136 (0xC308) exactly.
__device__ __forceinline__ uint32_t nibbles_bf16(uint32_t h) {
  uint32_t r;
  const uint32_t v = (h & 0x000F000Fu) | 0x43004300u;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;"
      : "=r"(r) : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

// Two int8 codes c, in the low bytes of a word's halves, as an exact bf16
// pair: 0x4300 | (c & 0x7f) is the bf16 128 + (c & 0x7f), and the bias
// 0xC300 | (c & 0x80), -128 or (sign bit set) -256, makes it c.
__device__ __forceinline__ uint32_t int8x2_bf16(uint32_t h) {
  uint32_t r;
  const uint32_t v = (h & 0x007F007Fu) | 0x43004300u;
  const uint32_t b = (h & 0x00800080u) | 0xC300C300u;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;"
      : "=r"(r) : "r"(v), "r"(0x3F803F80u), "r"(b));
  return r;
}

// Sixteen code bytes (a row's piece) as sixteen exact bf16, out[0..15]:
// int8 codes, or the low (shift 0) or the high (shift 4) nibbles of packed
// bytes.
template <bool INT4>
__device__ __forceinline__ void codes16_bf16(uint4 w, int shift, uint4* out) {
  const uint32_t word[4] = {w.x, w.y, w.z, w.w};
  uint32_t o[8];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if constexpr (INT4) {
      o[2 * e] = nibbles_bf16(__byte_perm(word[e], 0u, 0x4140) >> shift);
      o[2 * e + 1] = nibbles_bf16(__byte_perm(word[e], 0u, 0x4342) >> shift);
    } else {
      float f[4];
      int8x4(word[e], f);
      o[2 * e] = bf16_pair(f[0], f[1]);
      o[2 * e + 1] = bf16_pair(f[2], f[3]);
    }
  }
  out[0] = make_uint4(o[0], o[1], o[2], o[3]);
  out[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

// c[2][4] (two m16 tiles by four n8 tiles of the warp) += x tile . code
// tile over the 16 columns at kk of the step.
__device__ __forceinline__ void mma_k16(float (&c)[2][4][4],
                                        const __nv_bfloat16* xs,
                                        const __nv_bfloat16* cs, int kk,
                                        int wm, int wn, int lane) {
  uint32_t a[2][4], b[4][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    ldmatrix_x4(a[i], xs + (wm * 32 + i * 16 + (lane & 15)) * kTcP +
                          kk * 16 + (lane >> 4) * 8);
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    uint32_t r[4];
    ldmatrix_x4_trans(r, cs + (kk * 16 + (lane & 15)) * kTcP + wn * 32 +
                             jj * 16 + (lane >> 4) * 8);
    b[2 * jj][0] = r[0];
    b[2 * jj][1] = r[1];
    b[2 * jj + 1][0] = r[2];
    b[2 * jj + 1][1] = r[3];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_bf16(c[i][j], a[i], b[j]);
}

template <int MODE>
__device__ __forceinline__ void quant_matmul_tc_body(const QParams& p) {
  constexpr bool INT4 = MODE != kInt8, GROUP = MODE == kInt4Group;
  constexpr uint8_t kZero = INT4 ? 0x88 : 0;     // a code of value 0
  extern __shared__ uint4 tc_smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  uint8_t* raw = reinterpret_cast<uint8_t*>(xs + kTcStages * kTcXs);
  __nv_bfloat16* cs =
      reinterpret_cast<__nv_bfloat16*>(raw + kTcStages * kTcRaw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int n0 = blockIdx.x * kTcBN, m0 = blockIdx.y * kTcBM;
  const int kbeg = blockIdx.z * p.chunk;
  const int kend = min(p.rows, kbeg + p.chunk);
  // steps over the split's rows, twice for int4 (low codes, then high)
  const int walk = kbeg < kend ? (kend - kbeg + kTcRows - 1) / kTcRows : 0;
  const int steps = INT4 ? 2 * walk : walk;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  // 16-byte pieces of x's rows (int4: its second half's too) and of the
  // code rows stay aligned
  const bool xvec = INT4 ? p.K % 16 == 0 : p.K % 8 == 0;
  const bool cvec = p.N % 16 == 0;

  // this thread's code piece: row crow of the step, columns ccol .. + 16
  const int crow = tid >> 2, ccol = (tid & 3) * 16;

  // the loads of step s into ring stage st: x's 64 columns (piece idx:
  // row idx / 8, columns (idx % 8) * 8 .. + 8) and the raw codes
  auto load_step = [&](int st, int s) {
    const int half = INT4 && s >= walk;
    const int k0 = kbeg + (s - half * walk) * kTcRows;
#pragma unroll
    for (int l = 0; l < kTcBM * 8 / kTcThreads; ++l) {
      const int idx = tid + l * kTcThreads;
      const int row = idx >> 3, tc = (idx & 7) * 8;
      const int r = k0 + tc, col = half * p.rows + r, m = m0 + row;
      __nv_bfloat16* dst = xs + st * kTcXs + row * kTcP + tc;
      if (xvec) {
        const bool ok = m < p.M && r < kend;
        cp_async16(dst, ok ? x + (size_t)m * p.K + col : x, ok);
      } else {
        for (int e = 0; e < 8; ++e) {
          const bool ok = m < p.M && r + e < kend && col + e < p.K;
          dst[e] = ok ? x[(size_t)m * p.K + col + e] : __float2bfloat16(0.f);
        }
      }
    }
    const int kr = k0 + crow, n = n0 + ccol;
    const uint8_t* src = p.w + (size_t)kr * p.N + n;
    uint8_t* dst = raw + st * kTcRaw + crow * kTcBN + ccol;
    if (cvec && kr < kend && n < p.N) {
      cp_async16(dst, src, true);
    } else {
      for (int i = 0; i < 16; ++i)
        dst[i] = kr < kend && n + i < p.N ? src[i] : kZero;
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  // the raw codes this thread loaded for step s (ring stage st) as bf16
  // into code buffer buf (int4: the nibbles of the step's half)
  auto convert = [&](int st, int buf, int s) {
    uint4 out[2];
    codes16_bf16<INT4>(
        *reinterpret_cast<const uint4*>(raw + st * kTcRaw + crow * kTcBN +
                                        ccol),
        INT4 && s >= walk ? 4 : 0, out);
    uint4* dst = reinterpret_cast<uint4*>(cs + buf * kTcCs + crow * kTcP +
                                          ccol);
    dst[0] = out[0];
    dst[1] = out[1];
  };

  float acc[2][4][4], part[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = part[i][j][e] = 0.f;

  // the columns of out this thread holds in each n8 tile: n, n + 1
  const int nq = n0 + wn * 32 + 2 * (lane & 3);
  // scale the group's partial into the sum: srow is a code row of the
  // group (int4's high half counts from K2)
  auto fold = [&](int srow) {
    const float* sc = p.scales + (size_t)(srow / p.group) * p.N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = nq + 8 * j;
      const float s0 = __ldg(sc + min(n, p.N - 1));
      const float s1 = __ldg(sc + min(n + 1, p.N - 1));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[i][j][0] = fmaf(part[i][j][0], s0, acc[i][j][0]);
        acc[i][j][1] = fmaf(part[i][j][1], s1, acc[i][j][1]);
        acc[i][j][2] = fmaf(part[i][j][2], s0, acc[i][j][2]);
        acc[i][j][3] = fmaf(part[i][j][3], s1, acc[i][j][3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < steps) {
      load_step(s, s);
    } else {
      asm volatile("cp.async.commit_group;" ::: "memory");
    }
  }
  cp_async_wait<kTcStages - 2>();
  if (steps > 0) convert(0, 0, 0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int ahead = s + kTcStages - 1;
    if (ahead < steps) {
      load_step(ahead % kTcStages, ahead);
    } else {
      asm volatile("cp.async.commit_group;" ::: "memory");
    }
    cp_async_wait<kTcStages - 2>();      // step s + 1 has landed
    if (s + 1 < steps) convert((s + 1) % kTcStages, (s + 1) & 1, s + 1);
    const __nv_bfloat16* xst = xs + (s % kTcStages) * kTcXs;
    const __nv_bfloat16* cst = cs + (s & 1) * kTcCs;
    const int half = INT4 && s >= walk;
    const int k0 = kbeg + (s - half * walk) * kTcRows;
#pragma unroll
    for (int kk = 0; kk < kTcRows / 16; ++kk) {
      if constexpr (GROUP) {
        mma_k16(part, xst, cst, kk, wm, wn, lane);
        const int r0 = k0 + 16 * kk;   // the 16 rows' first code row
        if (r0 < kend && ((r0 + 16) % p.group == 0 || r0 + 16 >= kend))
          fold(half * p.rows + r0);
      } else {
        mma_k16(acc, xst, cst, kk, wm, wn, lane);
      }
    }
    __syncthreads();
  }

  // out (or the split's partial sums), two columns at a time
  const bool pairs = p.N % 2 == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = m0 + wm * 32 + i * 16 + (lane >> 2) + 8 * hh;
        const int n = nq + 8 * j;
        if (m >= p.M || n >= p.N) continue;
        float v0 = acc[i][j][2 * hh], v1 = acc[i][j][2 * hh + 1];
        const bool two = n + 1 < p.N;
        if (p.part) {
          float* dst = p.part + ((size_t)blockIdx.z * p.M + m) * p.N + n;
          if (pairs && two) {
            *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          } else {
            dst[0] = v0;
            if (two) dst[1] = v1;
          }
          continue;
        }
        if constexpr (!GROUP) {
          v0 *= p.scales[n];
          if (two) v1 *= p.scales[n + 1];
        }
        __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(p.out) +
                             (size_t)m * p.N + n;
        if (pairs && two) {
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          dst[0] = __float2bfloat16_rn(v0);
          if (two) dst[1] = __float2bfloat16_rn(v1);
        }
      }
}

// --- the fp32-x prefill form ----------------------------------------------
//
// For fp32 x at M > 8 (int8, int4 per column, and int4 in groups that are
// a multiple of 16): the tensor-core prefill form's steps, code conversion
// and warps' 32 rows, on tiles twice as wide.  A code is exact in bf16, so with x = hi + mid +
// lo (split3_pair, exact) x c = hi c + mid c + lo c, each of the three
// products exact in the tensor cores: three bf16 products a product, where
// two fp32 operands take six, and as accurate as an fp32 FMA up to the
// order of the sums.
//   * x's [128, 64] fp32 tile (32 KB, twice the bf16 tile) comes by
//     cp.async into a ring of kX3Stages stages.  Each thread splits the x
//     pieces it loaded itself, one step ahead as it converts its codes, into
//     x's three bf16 planes (two buffers of [3][128][72]), which the warps
//     read with ldmatrix as the bf16 form reads x.  Only the thread that
//     loads a piece reads it from the ring, so it refills the stage as soon
//     as it has split it, with no block barrier: with two stages the loads
//     run two steps ahead of the split.
//   * [128, 128] tiles of out (a warp 32 x 64): each block splits its x
//     tiles, and reads them from L2, once for each 128 columns of out (N /
//     128 times: 128 MB of x at M1024 K1024 N4096 where 64 columns read
//     256 MB), and each A fragment meets eight n8 tiles of codes.
//   * Shared memory: ring 2 x (32 + 8) KB, planes 2 x 54 KB, codes 2 x 17
//     KB: 222 KB, one block an SM (the bf16 form's 106 KB fits two); a
//     third stage does not fit in the 227 KB a block may have.
//   * int4 walks a split's packed rows twice, the low nibbles against x's
//     first K2 columns, then the high ones against the rest.  Where 8
//     does not divide K, x's rows or their second half are not 16-byte
//     aligned and x comes by single values; an odd K (per column only: an
//     even group divides K) reads x's column K as 0 against the last
//     packed row's high nibble (the zero code 8).
//   * The tensor cores truncate each fp32 sum (mma.cuh).  Per column, a
//     step's twelve products of each tile go in place into a fresh sum,
//     added to the total rounded to nearest; grouped, each 16 code rows'
//     three into a fresh sum added to the group's partial (mma_x3_add),
//     which a rounded fmaf scales into the total at the group's end.
// A body of its own, beside quant_matmul_tc_body: the two share the
// conversion of the codes (codes16_bf16) and the tiles' layout, and a
// template of both compiled the bf16 form 4-5 % slower.

// Columns of out a block; the row pitch of the converted codes (bf16); the
// ring's stages of fp32 x (rows unpadded: a piece is read by the thread
// that loaded it, as a float4) and raw codes; the bytes: the ring, the two
// buffers of converted codes and of x's three planes, 227,328 in all.
constexpr int kX3BN = 128;
constexpr int kX3CP = kX3BN + 8;
constexpr int kX3Stages = 2;
constexpr int kX3Smem = kX3Stages * (4 * kTcBM * kTcRows + kTcRows * kX3BN) +
                        2 * 2 * kTcRows * kX3CP + 2 * 3 * 2 * kTcXs;
static_assert(kX3Smem <= 232448, "the fp32-x form's shared memory");

// The B fragments of the warp's NT n8 tiles of codes (rows of kX3CP bf16)
// over the 16 rows at kk of the step.
template <int NT>
__device__ __forceinline__ void x3_code_fragments(uint32_t (&b)[NT][2],
                                                  const __nv_bfloat16* cs,
                                                  int kk, int wn, int lane) {
#pragma unroll
  for (int jj = 0; jj < NT / 2; ++jj) {
    uint32_t r[4];
    ldmatrix_x4_trans(r, cs + (kk * 16 + (lane & 15)) * kX3CP + wn * NT * 8 +
                             jj * 16 + (lane >> 4) * 8);
    b[2 * jj][0] = r[0];
    b[2 * jj][1] = r[1];
    b[2 * jj + 1][0] = r[2];
    b[2 * jj + 1][1] = r[3];
  }
}

// c[2][NT] (two m16 tiles by NT n8 tiles of the warp) += x tile . code
// tile over the 16 columns at kk of the step, x from its three planes (hi
// at pl, mid and lo kTcXs apart): each code fragment meets the three, in
// place (mma_x3) or into a fresh sum (FRESH: mma_x3_add).
template <int NT, bool FRESH>
__device__ __forceinline__ void mma_k16_x3(float (&c)[2][NT][4],
                                           const __nv_bfloat16* pl,
                                           const __nv_bfloat16* cs, int kk,
                                           int wm, int wn, int lane) {
  uint32_t a[2][3][4], b[NT][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int q = 0; q < 3; ++q)
      ldmatrix_x4(a[i][q], pl + q * kTcXs +
                               (wm * 32 + i * 16 + (lane & 15)) * kTcP +
                               kk * 16 + (lane >> 4) * 8);
  x3_code_fragments<NT>(b, cs, kk, wn, lane);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if constexpr (FRESH) {
        mma_x3_add(c[i][j], a[i], b[j]);
      } else {
        mma_x3(c[i][j], a[i], b[j]);
      }
    }
}

template <int MODE>
__device__ __forceinline__ void quant_matmul_x3_body(const QParams& p) {
  constexpr bool INT4 = MODE != kInt8, GROUP = MODE == kInt4Group;
  constexpr uint8_t kZero = INT4 ? 0x88 : 0;     // a code of value 0
  constexpr int NT = kX3BN / 16;                 // n8 tiles a warp
  constexpr int CR = kX3BN / 16;                 // 16-byte pieces a code row
  constexpr int XS = kTcBM * kTcRows;            // floats, x, a ring stage
  constexpr int RAW = kTcRows * kX3BN;           // bytes, raw codes, a stage
  constexpr int CS = kTcRows * kX3CP;            // bf16, converted codes
  extern __shared__ uint4 tc_smem[];
  float* xring = reinterpret_cast<float*>(tc_smem);
  uint8_t* raw = reinterpret_cast<uint8_t*>(xring + kX3Stages * XS);
  __nv_bfloat16* cs =
      reinterpret_cast<__nv_bfloat16*>(raw + kX3Stages * RAW);
  __nv_bfloat16* planes = cs + 2 * CS;   // [2][hi, mid, lo][BM][kTcP]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int n0 = blockIdx.x * kX3BN, m0 = blockIdx.y * kTcBM;
  const int kbeg = blockIdx.z * p.chunk;
  const int kend = min(p.rows, kbeg + p.chunk);
  // steps over the split's rows, twice for int4 (low codes, then high)
  const int walk = kbeg < kend ? (kend - kbeg + kTcRows - 1) / kTcRows : 0;
  const int steps = INT4 ? 2 * walk : walk;
  const float* x = static_cast<const float*>(p.x);
  // 16-byte pieces of x's rows (int4: its second half's too) and of the
  // code rows stay aligned
  const bool xvec = INT4 ? p.K % 8 == 0 : p.K % 4 == 0;
  const bool cvec = p.N % 16 == 0;

  // the loads of step s into ring stage st: x's 64 columns (piece idx =
  // tid + 256 l: row idx / 16, columns (idx % 16) * 4 .. + 4) and the raw
  // codes (piece idx = tid + 256 c: row idx / CR, columns (idx % CR) * 16
  // .. + 16)
  auto load_step = [&](int st, int s) {
    const int half = INT4 && s >= walk;
    const int k0 = kbeg + (s - half * walk) * kTcRows;
#pragma unroll
    for (int l = 0; l < kTcBM * 16 / kTcThreads; ++l) {
      const int idx = tid + l * kTcThreads;
      const int row = idx >> 4, tc = (idx & 15) * 4;
      const int r = k0 + tc, col = half * p.rows + r, m = m0 + row;
      float* dst = xring + st * XS + row * kTcRows + tc;
      if (xvec) {
        const bool ok = m < p.M && r < kend;
        cp_async16(dst, ok ? x + (size_t)m * p.K + col : x, ok);
      } else {
        for (int e = 0; e < 4; ++e) {
          const bool ok = m < p.M && r + e < kend && col + e < p.K;
          dst[e] = ok ? x[(size_t)m * p.K + col + e] : 0.f;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kTcRows * CR / kTcThreads; ++c) {
      const unsigned idx = tid + c * kTcThreads;
      const int crow = idx / CR, ccol = idx % CR * 16;
      const int kr = k0 + crow, n = n0 + ccol;
      const uint8_t* src = p.w + (size_t)kr * p.N + n;
      uint8_t* dst = raw + st * RAW + crow * kX3BN + ccol;
      if (cvec && kr < kend && n < p.N) {
        cp_async16(dst, src, true);
      } else {
        for (int i = 0; i < 16; ++i)
          dst[i] = kr < kend && n + i < p.N ? src[i] : kZero;
      }
    }
    cp_async_commit();
  };
  // the raw codes this thread loaded for step s (ring stage st) as bf16
  // into code buffer buf (int4: the nibbles of the step's half), and the x
  // pieces it loaded split into plane buffer buf
  auto convert = [&](int st, int buf, int s) {
#pragma unroll
    for (int c = 0; c < kTcRows * CR / kTcThreads; ++c) {
      const unsigned idx = tid + c * kTcThreads;
      const int crow = idx / CR, ccol = idx % CR * 16;
      uint4 out[2];
      codes16_bf16<INT4>(
          *reinterpret_cast<const uint4*>(raw + st * RAW + crow * kX3BN +
                                          ccol),
          INT4 && s >= walk ? 4 : 0, out);
      uint4* dst =
          reinterpret_cast<uint4*>(cs + buf * CS + crow * kX3CP + ccol);
      dst[0] = out[0];
      dst[1] = out[1];
    }
#pragma unroll
    for (int l = 0; l < kTcBM * 16 / kTcThreads; ++l) {
      const int idx = tid + l * kTcThreads;
      const int row = idx >> 4, tc = (idx & 15) * 4;
      const float4 v = *reinterpret_cast<const float4*>(
          xring + st * XS + row * kTcRows + tc);
      uint32_t h[2], m[2], o[2];
      split3_pair(v.x, v.y, h[0], m[0], o[0]);
      split3_pair(v.z, v.w, h[1], m[1], o[1]);
      __nv_bfloat16* at = planes + buf * 3 * kTcXs + row * kTcP + tc;
      *reinterpret_cast<uint2*>(at) = make_uint2(h[0], h[1]);
      *reinterpret_cast<uint2*>(at + kTcXs) = make_uint2(m[0], m[1]);
      *reinterpret_cast<uint2*>(at + 2 * kTcXs) = make_uint2(o[0], o[1]);
    }
  };

  // acc: the sum; part: grouped, the group's partial; fresh: per column,
  // the step's products
  float acc[2][NT][4], part[2][NT][4], fresh[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = part[i][j][e] = 0.f;

  // the columns of out this thread holds in each n8 tile: n, n + 1
  const int nq = n0 + wn * NT * 8 + 2 * (lane & 3);
  // scale the group's partial into the sum: srow is a code row of the
  // group (int4's high half counts from K2)
  auto fold = [&](int srow) {
    const float* sc = p.scales + (size_t)(srow / p.group) * p.N;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = nq + 8 * j;
      const float s0 = __ldg(sc + min(n, p.N - 1));
      const float s1 = __ldg(sc + min(n + 1, p.N - 1));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[i][j][0] = fmaf(part[i][j][0], s0, acc[i][j][0]);
        acc[i][j][1] = fmaf(part[i][j][1], s1, acc[i][j][1]);
        acc[i][j][2] = fmaf(part[i][j][2], s0, acc[i][j][2]);
        acc[i][j][3] = fmaf(part[i][j][3], s1, acc[i][j][3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
      }
    }
  };

  // every stage loaded ahead; a thread refills the stage of step s + 1
  // with step s + 1 + kX3Stages once it has converted its own pieces of it
#pragma unroll
  for (int s = 0; s < kX3Stages; ++s) {
    if (s < steps) {
      load_step(s, s);
    } else {
      cp_async_commit();
    }
  }
  cp_async_wait<kX3Stages - 1>();          // step 0 has landed
  if (steps > 0) convert(0, 0, 0);
  if (kX3Stages < steps) {
    load_step(0, kX3Stages);
  } else {
    cp_async_commit();
  }
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kX3Stages - 1>();        // step s + 1 has landed
    if (s + 1 < steps) convert((s + 1) % kX3Stages, (s + 1) & 1, s + 1);
    if (s + 1 + kX3Stages < steps) {
      load_step((s + 1) % kX3Stages, s + 1 + kX3Stages);
    } else {
      cp_async_commit();
    }
    const __nv_bfloat16* pst = planes + (s & 1) * 3 * kTcXs;
    const __nv_bfloat16* cst = cs + (s & 1) * CS;
    const int half = INT4 && s >= walk;
    const int k0 = kbeg + (s - half * walk) * kTcRows;
    if constexpr (!GROUP) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) fresh[i][j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kTcRows / 16; ++kk) {
      if constexpr (GROUP) {
        mma_k16_x3<NT, true>(part, pst, cst, kk, wm, wn, lane);
        const int r0 = k0 + 16 * kk;   // the 16 rows' first code row
        if (r0 < kend && ((r0 + 16) % p.group == 0 || r0 + 16 >= kend))
          fold(half * p.rows + r0);
      } else {
        mma_k16_x3<NT, false>(fresh, pst, cst, kk, wm, wn, lane);
      }
    }
    if constexpr (!GROUP) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += fresh[i][j][e];
    }
    __syncthreads();
  }

  // out (or the split's partial sums), two columns at a time
  const bool pairs = p.N % 2 == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = m0 + wm * 32 + i * 16 + (lane >> 2) + 8 * hh;
        const int n = nq + 8 * j;
        if (m >= p.M || n >= p.N) continue;
        float v0 = acc[i][j][2 * hh], v1 = acc[i][j][2 * hh + 1];
        const bool two = n + 1 < p.N;
        float* dst;
        if (p.part) {
          dst = p.part + ((size_t)blockIdx.z * p.M + m) * p.N + n;
        } else {
          dst = static_cast<float*>(p.out) + (size_t)m * p.N + n;
          if constexpr (!GROUP) {
            v0 *= p.scales[n];
            if (two) v1 *= p.scales[n + 1];
          }
        }
        if (pairs && two) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          dst[0] = v0;
          if (two) dst[1] = v1;
        }
      }
}

// --- the tensor-core decode form -------------------------------------------
//
// For bf16 x at M <= 8 (groups a multiple of 16): every decode step of a
// quantized server.  What bounds it is the code bytes, read once: int8 at
// K1024 N4096 moves 4.29 MB (1.28 us at 3.35 TB/s), the K1024 N1024
// projections 0.5-1 MB (0.16-0.31 us), so the launch, the latency of the
// first bytes and the sum over a split count as much as the stream.  The
// design:
//   * one launch a call, no workspace.  A block owns a [8, BN] tile of out
//     (BN = 32, 64 or 128 code bytes a row: whole 32-byte sectors) and a
//     range of `chunk` code rows; where the tiles alone would not fill the
//     card, the ranges of a tile are the blocks of one thread-block cluster
//     (up to 8, set at launch).  Each rank adds its warps' partials in warp
//     order and stores the [8, BN] sum, a share of the columns to each rank,
//     into that rank's shared memory (distributed shared memory); after one
//     cluster barrier each rank adds what it received in rank order, scales
//     and rounds.  The barrier's first phase (every block has started) is
//     arrived at when the block starts and waited for only then.  A fixed
//     order, so two calls give the same bits;
//   * the plan (kernels/quant.py _plan) gives every serving linear at
//     least a block an SM (256 at each): tiles of 128 bytes where they
//     alone do (lm_head), else 64 where clusters of up to 8 make it
//     (N 4096), else 32 (N 1024), and the smallest cluster that makes up
//     the rest; long rows, and few blocks reading each element of x;
//   * each of the 4 warps owns the tile's columns and a contiguous quarter
//     of the block's rows, and streams them through a ring of its own of
//     stages of up to 4 KB, each stage one TMA copy
//     (cp.async.bulk.tensor of a [rows, BN] box of a 2D tensor map of the
//     codes, issued by the warp's first lane) completing on an mbarrier,
//     and no block barrier inside the loop.  N must be a multiple of 16
//     (the tensor map's row stride); the plan sends other N to the
//     CUDA-core decode kernels.  The block's slice of x
//     (M x chunk bf16, twice for int4's two halves) is copied to shared
//     memory once, first, with the tile's column scales, by 16-byte
//     cp.async on an mbarrier of its own: the load path, so that x does
//     not queue behind the codes in the copy engine (plain loads where the
//     slice or the tile is ragged).  Fewer, larger TMA copies beat more,
//     smaller ones with the same bytes in flight, and at lm_head two 4 KB
//     stages a warp beat three or four (tools/torch_decode_plans.py): the
//     plan gives a warp's ring up to 2 stages, the kernel takes up to 4;
//   * the tensor cores with the tokens as the narrow side: out^T = W^T .
//     x^T by mma.sync.m16n8k16, 16 output columns as m16, the <= 8 tokens
//     as n8 (tokens beyond M read zero), fp32 sums.  In each 32-column
//     group, lane (g, t) reads one 32-bit word of codes (columns 4g .. 4g +
//     3) from each of rows 2t, 2t + 1, 2t + 8, 2t + 9 of a 16-row step, the
//     rows of its A fragments' k pairs, and byte permutes turn the four
//     words into the A fragments of two m16 tiles: row g of tile j is
//     column 4g + 2j, row g + 8 column 4g + 2j + 1.  The lane's B fragment
//     is two 32-bit loads of x (rows 2t, 2t + 1 and 2t + 8, 2t + 9 of token
//     g).  A byte permute puts a fragment's two codes in the low bytes of a
//     word's halves, and three operations make them an exact bf16 pair
//     (int8x2_bf16, nibbles_bf16); int4's high nibbles are a second product
//     against x's second half;
//   * grouped, a warp keeps the current group's partial products of each
//     half apart and scales them into the sum at the group's last step or
//     its range's last, as _matmul4_group_kernel scales each group's
//     partial dot before adding it; the next group's scales are loaded at
//     the fold, ahead of their use;
//   * fp32 x (X3: int8, int4 per column, and int4 in groups that 16
//     divides), every decode step of fp32 quantized serving: the same
//     launch, cluster, rings and sums.  The warps' first TMA copies are
//     issued first; then each thread loads 16-byte pieces of the block's
//     fp32 slice of x (single values where the slice is ragged or
//     unaligned, an odd K among them: columns at K or beyond read 0) and
//     splits each once, as it lands, into three bf16 planes in shared
//     memory (split3_pair: hi + mid + lo == x exactly), 1.5 times the fp32
//     slice's bytes, so the plan caps a block's code rows at 1024 (int4 at
//     M = 8: 96 KB of planes, ~180 KB with the rings and sums at BN 128).
//     Each A fragment of codes meets the three planes' B
//     fragments in three products, lo, mid and hi (mma_x3_b), each exact,
//     so a product is as accurate as an fp32 FMA; out is fp32, scaled in
//     fp32.  The tensor cores truncate each fp32 sum (mma.cuh), so each
//     16-row step's three products of a tile go into a fresh sum added
//     rounded to nearest (mma_x3_b): summed in place over a warp's rows,
//     the error against float64 exceeded twice the plain fp32 version's at
//     lm_head, and grouped int4 at BN 64 spilled (chip_smoke.py holds the
//     error to twice plain's).

constexpr int kDecThreads = 128;        // 4 warps, each a quarter of the rows
constexpr int kDecStages = 4;           // ring stages a warp at most
constexpr int kDecStageBytes = 4096;    // code bytes a warp's stage at most
constexpr int kDecCluster = 8;          // blocks a cluster at most (portable)

struct QDecParams {
  CUtensorMap codes;   // [rows, N] uint8, box [stage_rows, bn]
  QParams p;           // p.chunk: code rows a block; part unused
  int stage_rows;      // code rows a warp's ring stage, a multiple of 16
  int stages;          // a warp's ring stages, 1 .. kDecStages
  int xpitch;          // bf16 a token's row of the x slice (of each plane)
  bool xaligned;       // x's rows 16-byte aligned: 16-byte copies where whole
};

// Shared memory of the decode form at a tile of bn columns, in bytes: the
// warps' rings, x's slice (fp32 x: its three planes), the warps' sums, the
// partials received from the cluster, the tile's column scales, the
// mbarriers.
__host__ __device__ __forceinline__ int dec_x_bytes(const QDecParams& d) {
  return (d.p.M * d.xpitch * 2 * (d.p.bf16 ? 1 : 3) + 15) / 16 * 16;
}

__host__ __device__ __forceinline__ int dec_smem_bytes(const QDecParams& d,
                                                       int bn, int cluster) {
  return 4 * d.stages * d.stage_rows * bn + dec_x_bytes(d) +
         4 * ((4 + cluster) * 8 + 1) * bn + 8 * (4 * d.stages + 1);
}

// c += a b of an A fragment of codes and x's B fragment: bf16 x one
// product, fp32 x (X3) three, one a plane (mma_x3_b).
template <bool X3>
__device__ __forceinline__ void mma_dec(float* c, const uint32_t* a,
                                        const uint32_t (&b)[X3 ? 3 : 1][2]) {
  if constexpr (X3) {
    mma_x3_b(c, a, b);
  } else {
    mma_bf16(c, a, b[0]);
  }
}

template <int MODE, int BN, bool X3>
__device__ __forceinline__ void quant_matmul_dec_body(const QDecParams& d) {
  namespace cg = cooperative_groups;
  constexpr bool INT4 = MODE != kInt8, GROUP = MODE == kInt4Group;
  constexpr int XT = INT4 ? 2 : 1;   // x's halves a code row meets
  constexpr int PL = X3 ? 3 : 1;     // x's planes: hi (, mid, lo)
  constexpr int T = 2 * BN / 32;     // m16 tiles: two a 32-column group
  constexpr int N4 = 2 * BN;         // float4s of an [8, BN] tile
  const QParams& p = d.p;
  extern __shared__ __align__(128) unsigned char dec_smem[];
  const int srows = d.stage_rows, stages = d.stages;
  const cg::cluster_group cluster = cg::this_cluster();
  const int C = cluster.num_blocks(), rank = cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x / C * BN;
  const int rbeg = rank * p.chunk;
  const int nrows = max(0, min(p.rows, rbeg + p.chunk) - rbeg);
  const int rw = p.chunk / 4, wbeg = warp * rw;   // the warp's rows, local
  const int wrows = max(0, min(nrows - wbeg, rw));
  const int nstage = (wrows + srows - 1) / srows, nsteps = (wrows + 15) / 16;
  const int sps = srows / 16;                     // steps a stage

  uint8_t* ring = dec_smem + warp * stages * srows * BN;  // [stages][srows][BN]
  __nv_bfloat16* xs =
      reinterpret_cast<__nv_bfloat16*>(dec_smem + 4 * stages * srows * BN);
  float* red = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(xs) +
                                        dec_x_bytes(d));  // [warp][8][BN]
  float* recv = red + 4 * 8 * BN;                         // [C][8][BN]
  float* ss = recv + C * 8 * BN;                          // [BN]
  uint64_t* bars = reinterpret_cast<uint64_t*>(ss + BN);
  uint64_t* full = bars + warp * stages;
  uint64_t* xbar = bars + 4 * stages;

  if (C > 1) cluster_arrive_relaxed();   // phase 0: this block has started
  if (warp == 0 && lane <= 4 * stages) {
    mbar_init(bars + lane, lane == 4 * stages ? kDecThreads : 1);
    fence_mbarrier_init();
  }
  if (warp == 1 && lane == 0)
    asm volatile("prefetch.tensormap [%0];"
                 :: "l"(reinterpret_cast<uint64_t>(&d.codes)) : "memory");
  __syncthreads();

  // stage s of the warp's rows into its ring slot s % stages
  auto issue = [&](int s) {
    if (lane == 0) {
      uint64_t* bar = full + s % stages;
      mbar_expect_tx(bar, srows * BN);
      tma_load_2d(ring + s % stages * srows * BN, &d.codes, n0,
                  rbeg + wbeg + s * srows, bar);
    }
  };
  // fp32 x: the codes first, while x is loaded and split
  if constexpr (X3)
    for (int s = 0; s < min(stages, nstage); ++s) issue(s);

  // x's slice, and the tile's column scales (per-column modes):
  // xs[m][h * chunk + k] = x[m][h * rows + rbeg + k] (fp32 x: plane q at xs
  // + q * M * xpitch), ss[i] = scales[n0 + i].  bf16 x first, by 16-byte
  // cp.async (the load path, not the copy engine the codes queue on) where
  // the rows are whole; fp32 x by 16-byte loads split in registers; else
  // plain loads (zeros past the range or K).  Every thread arrives on xbar
  // when its copies land.
  const bool xvec = d.xaligned && nrows == p.chunk &&
                    (!INT4 || p.rows + rbeg + p.chunk <= p.K);
  const int plane = p.M * d.xpitch;             // bf16 a plane
  auto load_scales = [&] {
    if constexpr (!GROUP) {
      if (n0 + BN <= p.N) {
        if (tid < BN / 4)
          cp_async16(ss + 4 * tid, p.scales + n0 + 4 * tid, true);
      } else {
        for (int i = tid; i < BN; i += kDecThreads)
          ss[i] = n0 + i < p.N ? p.scales[n0 + i] : 0.f;
      }
    }
  };
  if constexpr (X3) {
    load_scales();
    // 4 pieces of 4 floats a thread in flight, then split
    const float* x = static_cast<const float*>(p.x);
    const int xpieces = p.M * XT * p.chunk / 4;
    for (int i0 = tid; i0 < xpieces; i0 += 4 * kDecThreads) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kDecThreads;
        const int k = i * 4 % p.chunk, h = i * 4 / p.chunk % XT;
        const float* src = x + (size_t)(i * 4 / (p.chunk * XT)) * p.K +
                           h * p.rows + rbeg + k;
        if (i >= xpieces) {
          v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        } else if (xvec) {
          v[u] = __ldg(reinterpret_cast<const float4*>(src));
        } else {
          float e[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            e[j] = k + j < nrows && h * p.rows + rbeg + k + j < p.K ? src[j]
                                                                    : 0.f;
          v[u] = make_float4(e[0], e[1], e[2], e[3]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kDecThreads;
        if (i >= xpieces) break;
        const int k = i * 4 % p.chunk, h = i * 4 / p.chunk % XT;
        uint32_t hi[2], mid[2], lo[2];
        split3_pair(v[u].x, v[u].y, hi[0], mid[0], lo[0]);
        split3_pair(v[u].z, v[u].w, hi[1], mid[1], lo[1]);
        __nv_bfloat16* dst =
            xs + i * 4 / (p.chunk * XT) * d.xpitch + h * p.chunk + k;
        *reinterpret_cast<uint2*>(dst) = make_uint2(hi[0], hi[1]);
        *reinterpret_cast<uint2*>(dst + plane) = make_uint2(mid[0], mid[1]);
        *reinterpret_cast<uint2*>(dst + 2 * plane) = make_uint2(lo[0], lo[1]);
      }
    }
  } else {
    const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
    const int xpieces = p.M * XT * p.chunk / 8;   // 16-byte pieces
    for (int i = tid; i < xpieces; i += kDecThreads) {
      const int k = i * 8 % p.chunk, h = i * 8 / p.chunk % XT;
      const int m = i * 8 / (p.chunk * XT);
      __nv_bfloat16* dst = xs + m * d.xpitch + h * p.chunk + k;
      const __nv_bfloat16* src = x + (size_t)m * p.K + h * p.rows + rbeg + k;
      if (xvec) {
        cp_async16(dst, src, true);
      } else {
        for (int e = 0; e < 8; ++e)
          dst[e] = k + e < nrows && h * p.rows + rbeg + k + e < p.K
                       ? src[e] : __float2bfloat16(0.f);
      }
    }
  }
  if constexpr (!X3) load_scales();
  if (!X3 && xvec && (GROUP || n0 + BN <= p.N)) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
                 :: "r"(smem_addr(xbar)) : "memory");
  } else {   // plain stores too: arrive, releasing them, once all landed
    cp_async_commit();
    cp_async_wait<0>();
    mbar_arrive(xbar);
  }
  if constexpr (!X3)
    for (int s = 0; s < min(stages, nstage); ++s) issue(s);

  // grouped: the scales of the warp's first group, loaded ahead; this
  // lane's columns in 32-column group c are n0 + 32c + 4g + 0 .. 3
  float glo[BN / 32][4], ghi[BN / 32][4];
  auto load_group = [&](int kr) {   // kr: a code row of the group
    const float* lo = p.scales + (size_t)(kr / p.group) * p.N;
    const float* hi = p.scales + (size_t)((p.rows + kr) / p.group) * p.N;
#pragma unroll
    for (int c = 0; c < BN / 32; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = min(n0 + 32 * c + 4 * g + e, p.N - 1);
        glo[c][e] = __ldg(lo + n);
        ghi[c][e] = __ldg(hi + n);
      }
  };
  if (GROUP && wrows > 0) load_group(rbeg + wbeg);

  // acc[j][e]: tile j's C fragment (j = 2c + jj in 32-column group c); e =
  // 0, 1 column 4g + 2jj, e = 2, 3 column 4g + 2jj + 1, tokens 2t (even e)
  // and 2t + 1 (odd e)
  float acc[T][4], plo[GROUP ? T : 1][4], phi[GROUP ? T : 1][4];
#pragma unroll
  for (int j = 0; j < T; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  if constexpr (GROUP)
#pragma unroll
    for (int j = 0; j < T; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) plo[j][e] = phi[j][e] = 0.f;
  const bool token = g < p.M;
  const uint32_t* xrow = reinterpret_cast<const uint32_t*>(
      xs + g * d.xpitch + wbeg + 2 * t);
  mbar_wait(xbar, 0);

  for (int s = 0; s < nstage; ++s) {
    mbar_wait(full + s % stages, s / stages & 1);
    const uint8_t* cs = ring + s % stages * srows * BN + 2 * t * BN + 4 * g;
    const int qend = min(nsteps, (s + 1) * sps);
#pragma unroll 2
    for (int q = s * sps; q < qend; ++q) {
      const uint8_t* cq = cs + (q - s * sps) * 16 * BN;
      uint32_t b[XT][PL][2];
#pragma unroll
      for (int h = 0; h < XT; ++h)     // x's rows 2t, 2t + 1; 2t + 8, 2t + 9
#pragma unroll
        for (int v = 0; v < PL; ++v) {
          const uint32_t* xp = xrow + (v * plane + h * p.chunk + 16 * q) / 2;
          b[h][v][0] = token ? xp[0] : 0u;
          b[h][v][1] = token ? xp[4] : 0u;
        }
#pragma unroll
      for (int c = 0; c < BN / 32; ++c) {
        uint32_t w[4];   // rows 2t, 2t + 1, 2t + 8, 2t + 9; columns 4g ..
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[i] = *reinterpret_cast<const uint32_t*>(
              cq + ((i & 1) + 8 * (i >> 1)) * BN + 32 * c);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * c + jj;
          // byte 2jj + u (column 4g + 2jj + u: A's row g + 8u) of rows
          // (2t, 2t + 1) and (2t + 8, 2t + 9), at bits 0 and 16
          uint32_t p01[2], p23[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int e = 2 * jj + u;
            const int sel = e | e << 4 | (e + 4) << 8 | (e + 4) << 12;
            p01[u] = __byte_perm(w[0], w[1], sel);
            p23[u] = __byte_perm(w[2], w[3], sel);
          }
          if constexpr (INT4) {
            const uint32_t lo[4] = {nibbles_bf16(p01[0]), nibbles_bf16(p01[1]),
                                    nibbles_bf16(p23[0]), nibbles_bf16(p23[1])};
            const uint32_t hi[4] = {
                nibbles_bf16(p01[0] >> 4), nibbles_bf16(p01[1] >> 4),
                nibbles_bf16(p23[0] >> 4), nibbles_bf16(p23[1] >> 4)};
            if constexpr (GROUP) {
              mma_dec<X3>(plo[j], lo, b[0]);
              mma_dec<X3>(phi[j], hi, b[1]);
            } else {
              mma_dec<X3>(acc[j], lo, b[0]);
              mma_dec<X3>(acc[j], hi, b[1]);
            }
          } else {
            const uint32_t a[4] = {int8x2_bf16(p01[0]), int8x2_bf16(p01[1]),
                                   int8x2_bf16(p23[0]), int8x2_bf16(p23[1])};
            mma_dec<X3>(acc[j], a, b[0]);
          }
        }
      }
      if constexpr (GROUP) {
        // the group or the range ends with this step: scale both halves'
        // partials into the sum (K2 = rows is a multiple of the group),
        // then load the next group's scales
        const int kr = rbeg + wbeg + 16 * q;
        if (q + 1 == nsteps || kr / p.group != (kr + 16) / p.group) {
#pragma unroll
          for (int j = 0; j < T; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = 2 * (j % 2) + e / 2;
              acc[j][e] = fmaf(plo[j][e], glo[j / 2][col], acc[j][e]);
              acc[j][e] = fmaf(phi[j][e], ghi[j / 2][col], acc[j][e]);
              plo[j][e] = phi[j][e] = 0.f;
            }
          if (q + 1 < nsteps) load_group(kr + 16);
        }
      }
    }
    __syncwarp();   // slot s % stages is no longer read
    if (s + stages < nstage) issue(s + stages);
  }

  // the warps' sums, added in warp order into the block's partial
#pragma unroll
  for (int c = 0; c < BN / 32; ++c) {
    float* r = red + warp * 8 * BN + 32 * c + 4 * g;
    const float* a0 = acc[2 * c];
    const float* a1 = acc[2 * c + 1];
    *reinterpret_cast<float4*>(r + 2 * t * BN) =
        make_float4(a0[0], a0[2], a1[0], a1[2]);
    *reinterpret_cast<float4*>(r + (2 * t + 1) * BN) =
        make_float4(a0[1], a0[3], a1[1], a1[3]);
  }
  __syncthreads();
  constexpr int U = N4 > kDecThreads ? N4 / kDecThreads : 1;
  float4 v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = tid + u * kDecThreads;
    v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < N4) {
      const float4* r4 = reinterpret_cast<const float4*>(red);
      for (int w = 0; w < 4; ++w) {
        const float4 a = r4[w * N4 + i];
        v[u].x += a.x; v[u].y += a.y; v[u].z += a.z; v[u].w += a.w;
      }
    }
  }
  if (C > 1) {
    // every rank's partial of four columns to the rank that owns them
    // (their float4's index % C), added there in rank order after the
    // barrier
    cluster_wait();   // phase 0: every block of the cluster has started
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = tid + u * kDecThreads;
      if (i < N4)
        cluster.map_shared_rank(reinterpret_cast<float4*>(recv),
                                i % C)[rank * N4 + i] = v[u];
    }
    cluster_arrive();
    cluster_wait();
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = tid + u * kDecThreads;
      if (i < N4 && i % C == rank) {
        const float4* r4 = reinterpret_cast<const float4*>(recv);
        v[u] = r4[i];
        for (int r = 1; r < C; ++r) {
          const float4 a = r4[r * N4 + i];
          v[u].x += a.x; v[u].y += a.y; v[u].z += a.z; v[u].w += a.w;
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = tid + u * kDecThreads;
    const int m = 4 * i / BN, on = n0 + 4 * i % BN;
    if (i >= N4 || i % C != rank || m >= p.M || on >= p.N) continue;
    float o[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
    if constexpr (!GROUP)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] *= ss[4 * i % BN + e];
    const int cnt = min(4, p.N - on);
    if constexpr (X3) {
      float* dst = static_cast<float*>(p.out) + (size_t)m * p.N + on;
      if (cnt == 4 && p.N % 4 == 0) {
        *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
        for (int e = 0; e < cnt; ++e) dst[e] = o[e];
      }
    } else {
      __nv_bfloat16* dst =
          static_cast<__nv_bfloat16*>(p.out) + (size_t)m * p.N + on;
      if (cnt == 4 && p.N % 4 == 0) {
        *reinterpret_cast<uint2*>(dst) =
            make_uint2(bf16_pair_rn(o[0], o[1]), bf16_pair_rn(o[2], o[3]));
      } else {
        for (int e = 0; e < cnt; ++e) dst[e] = __float2bfloat16_rn(o[e]);
      }
    }
  }
}

// The splits' partial sums, added in split order; then the column scale
// (per-column modes) and the rounding to out's dtype.
__global__ void __launch_bounds__(kThreads)
quant_matmul_reduce_kernel(const float* part, const float* scales, void* out,
                           int splits, int M, int N, bool scale, bool bf16) {
  const size_t total = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += part[s * total + i];
  if (scale) v *= scales[i % N];
  store1(out, i, v, bf16);
}

// The forms, as the C entries take them (kernels/quant.py _FORM_IDS).
enum Form {
  kDecode = 0, kCudaCore = 1, kTensorCore = 2, kDecodeTc = 3,
  kTensorCoreX3 = 4, kDecodeTcX3 = 5
};

typedef void (*QKernel)(QParams);
typedef void (*QDecKernel)(QDecParams);

// A source's kernels: the CUDA-core forms (BM 8 and 64; m64 null where the
// tensor-core forms take every M > 8), the tensor-core prefill forms for
// bf16 x and for fp32 x, and the tensor-core decode forms for bf16 x and
// for fp32 x at BN 32, 64 and 128.
struct QKernels {
  QKernel m8, m64, tc, x3;
  QDecKernel dec[3], dec_x3[3];
};

// cuTensorMapEncodeTiled, a driver entry point, reached through the
// runtime (the libraries link no libcuda); null where the driver lacks it.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// The tensor-core decode forms (kDecodeTc bf16 x, kDecodeTcX3 fp32 x): one
// launch of the kernel for bn, clusters of `splits` blocks along x, one a
// range of `chunk` code rows of a [8, bn] tile.
int quant_matmul_dec_launch(const QKernels& ks, QParams p, bool int4,
                            int form, int bn, int splits, int stage_rows,
                            int stages, cudaStream_t stream) {
  const bool x3 = form == kDecodeTcX3;
  if (p.bf16 == x3 || p.M > 8 || (bn != 32 && bn != 64 && bn != 128) ||
      p.N % 16 || p.chunk % 64 || splits > kDecCluster ||
      (long long)(splits - 1) * p.chunk >= p.rows || p.part ||
      stage_rows % 16 || stage_rows <= 0 || stage_rows * bn > kDecStageBytes ||
      stages < 1 || stages > kDecStages)
    return cudaErrorInvalidValue;
  const QDecKernel k = (x3 ? ks.dec_x3 : ks.dec)[bn == 32 ? 0 : bn == 64 ? 1
                                                                          : 2];
  QDecParams d{};
  d.p = p;
  d.stage_rows = stage_rows;
  d.stages = stages;
  d.xpitch = (int4 ? 2 : 1) * p.chunk + 8;   // 16-byte rows, no conflicts
  // x's rows (and int4's second halves) start on 16 bytes
  const int per16 = x3 ? 4 : 8;
  d.xaligned = p.K % per16 == 0 && p.rows % per16 == 0;
  const EncodeTiled encode = tensor_map_encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)p.N, (cuuint64_t)p.rows};
  const cuuint64_t strides[1] = {(cuuint64_t)p.N};
  const cuuint32_t box[2] = {(cuuint32_t)bn, (cuuint32_t)stage_rows};
  const cuuint32_t ones[2] = {1, 1};
  if (encode(&d.codes, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
             const_cast<uint8_t*>(p.w), dims, strides, box, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const int smem = dec_smem_bytes(d, bn, splits);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = splits;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.N + bn - 1) / bn * splits);
  cfg.blockDim = dim3(kDecThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, k, d);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Checks the arguments and launches the kernel of `form`: the tensor-core
// decode form (above), or the tile kernel of the others (kDecode BM = 8
// and kCudaCore BM = 64, columns of 128; kTensorCore bf16 only, columns of
// 64, and kTensorCoreX3 fp32 only, columns of 128, both chunks of 64 rows)
// and, with more than one split, the reduction.
// Returns cudaGetLastError() after each launch, or cudaErrorInvalidValue for
// arguments the kernels do not take.
int quant_matmul_launch(const QKernels& k, QParams p, bool int4, int form,
                        int bn, int splits, int stage_rows, int stages,
                        bool scale, cudaStream_t stream) {
  if (p.M <= 0 || p.N <= 0 || p.K <= 0 || p.rows <= 0 || p.chunk <= 0 ||
      splits < 1 || (long long)splits * p.chunk < p.rows)
    return cudaErrorInvalidValue;
  if (form == kDecodeTc || form == kDecodeTcX3)
    return quant_matmul_dec_launch(k, p, int4, form, bn, splits, stage_rows,
                                   stages, stream);
  const bool tc = form == kTensorCore || form == kTensorCoreX3;
  const int bm = form == kDecode ? 8 : form == kCudaCore ? 64 : kTcBM;
  const int bk = form == kDecode ? 128 : tc ? kTcRows : 32;
  if (form < kDecode || form > kTensorCoreX3 ||
      bn != (form == kTensorCore ? kTcBN : form == kTensorCoreX3 ? kX3BN
                                                                 : kBN) ||
      (form == kTensorCore && !p.bf16) ||
      (form == kCudaCore && !k.m64) ||
      (form == kTensorCoreX3 && (p.bf16 || !k.x3)) || p.chunk % bk ||
      (splits > 1) != (p.part != 0))
    return cudaErrorInvalidValue;
  if (tc) {
    const QKernel kern = form == kTensorCore ? k.tc : k.x3;
    const int smem = form == kTensorCore ? kTcSmem : kX3Smem;
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.N + bn - 1) / bn, (p.M + kTcBM - 1) / kTcBM, splits);
    kern<<<grid, kTcThreads, smem, stream>>>(p);
  } else {
    const dim3 grid((p.N + kBN - 1) / kBN, (p.M + bm - 1) / bm, splits);
    if (form == kDecode)
      k.m8<<<grid, kThreads, 0, stream>>>(p);
    else
      k.m64<<<grid, kThreads, 0, stream>>>(p);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t total = (size_t)p.M * p.N;
  quant_matmul_reduce_kernel<<<(unsigned)((total + kThreads - 1) / kThreads),
                               kThreads, 0, stream>>>(
      p.part, p.scales, p.out, splits, p.M, p.N, scale, p.bf16);
  return cudaGetLastError();
}

}  // namespace
