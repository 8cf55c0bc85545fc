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
// A product of a bf16 or fp32 x and a small integer code is exact in an
// FMA, so the CUDA cores' fp32 FMA gives the TPU kernel's numbers up to
// the order of the sums.
//
// One block of 256 threads (8 warps) per [BM, 128] tile of out and per
// split of the code rows (blockIdx.z).  Each slab of BK code rows is loaded
// as 16-byte pieces along N, the next slab's pieces issued before the
// current one is computed, and x's matching columns go to shared memory as
// fp32.  A lane owns 4 columns and 8 rows of out: one 32-bit word of codes
// a row feeds 32 FMAs (int8) or 64 (int4), and each code becomes a float
// once per warp, by a byte permute and an add (the int-to-float conversion
// runs at a quarter of the FMA rate).  Two shapes:
//   decode  (M <= 8):  BM = 8,  BK = 128, the 8 warps split each slab's
//           rows and sum their [8, 128] tiles in shared memory at the end.
//           Bounded by the code bytes; four 16-byte loads in flight a
//           thread;
//   prefill (M > 8):   BM = 64, BK = 32, a warp per 8 rows of out.
//           Bounded by operations on the CUDA cores.
// The wrapper splits the code rows over blockIdx.z until there are two
// blocks a streaming multiprocessor: at decode N / 128 tiles alone would
// leave most of the card idle (8 blocks at N = 1024).  With more than one
// split each block writes its fp32 partial sums to a [S, M, N] workspace
// and a second kernel sums them in split order, scales and rounds.
// Grouped, a lane keeps the low and the high group's partial sums beside
// its total and scales them at a group's last row (and, when warps split a
// slab, at the end of its rows), so no group size is tied to the slab.
// Ragged M, N and K are masked in the kernel: nothing is padded.

#pragma once

#include "common.cuh"

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

// Checks the arguments, launches the tile kernel for BM (k8: BM = 8, k64:
// BM = 64) and, with more than one split, the reduction.  Returns
// cudaGetLastError() after each launch, or cudaErrorInvalidValue for
// arguments the kernels do not take.
typedef void (*QKernel)(QParams);

int quant_matmul_launch(QKernel k8, QKernel k64, QParams p, int bm,
                        int splits, bool scale, cudaStream_t stream) {
  const int bk = bm == 8 ? 128 : 32;
  if ((bm != 8 && bm != 64) || p.M <= 0 || p.N <= 0 || p.K <= 0 ||
      p.rows <= 0 || p.chunk <= 0 || p.chunk % bk || splits < 1 ||
      (long long)splits * p.chunk < p.rows || (splits > 1) != (p.part != 0))
    return cudaErrorInvalidValue;
  const dim3 grid((p.N + kBN - 1) / kBN, (p.M + bm - 1) / bm, splits);
  if (bm == 8)
    k8<<<grid, kThreads, 0, stream>>>(p);
  else
    k64<<<grid, kThreads, 0, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t total = (size_t)p.M * p.N;
  quant_matmul_reduce_kernel<<<(unsigned)((total + kThreads - 1) / kThreads),
                               kThreads, 0, stream>>>(
      p.part, p.scales, p.out, splits, p.M, p.N, scale, p.bf16);
  return cudaGetLastError();
}

}  // namespace
