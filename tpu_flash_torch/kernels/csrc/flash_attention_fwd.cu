// Flash-attention forward (FA2 loop order) for sm_90a.
//
// Replaces tpu_flash/kernels/flash_attention.py::_fwd_kernel
// (flash_attention.py:498, launched by pl.pallas_call at :985).  q
// [B, H, Lq, D], k and v [B, Hkv, Lk, D] (query head h reads KV head
// h / (H / Hkv): GQA without a materialized repeat), fp32 or bf16.  Writes out
// [B, H, Lq, D] in q's dtype and lse (and, when asked, m) fp32 [B, H, Lq] in
// natural-log units; m is the row max of the scaled scores.
//
// What bounds it: operations.  At the training shape (B4 H8 L2048 d64,
// causal) the causal half of QK^T and P.V is 1.7e10 flops against 34 MB of
// q, k, v and out, some 500 flops per byte, so the design is about keeping
// the arithmetic units fed, not about bytes:
//   * one block of kRows query rows per (batch * head, Q tile); a row belongs
//     to one thread (two for D = 128, each owning half of the head dims), so
//     q * scale * log2(e), the online-softmax state (m, l) and the fp32
//     output accumulator stay in registers for the whole loop;
//   * K and V tiles of kTileK keys are staged in shared memory, converted to
//     fp32 once; every thread of a warp reads the same key at a time, so each
//     16-byte shared load is a broadcast that feeds 4 FMAs;
//   * keys are taken kChunk at a time: kChunk independent dot products hide
//     the FMA latency, and the running max is rescaled once per chunk;
//   * the loop ends at the causal limit of the block's last row, so tiles
//     above the diagonal are never loaded; a warp stops at its own last
//     row's limit.  This replaces the TPU's trace-time packed schedule
//     (_tile_schedule, _packed_schedule, _width_class), which exists because
//     a Mosaic grid cannot branch;
//   * heavy Q tiles (late rows, more keys under the causal mask) launch first.
// Dots are exact fp32 FMAs, never TF32 (the TPU runs fp32 at
// Precision.HIGHEST).  bf16 inputs: q * scale * log2(e) and p are rounded to
// bf16 before their dots, as the TPU feeds its MXU in the input dtype; every
// sum is fp32.  Softmax runs in base 2 (exp2f).  A row that sees no key
// (causal with Lq > Lk) gives out 0, lse -inf and m -inf, whatever the tiling.
// Tensor cores (mma.sync / wgmma), TMA and pipelining are later work
// (ROADMAP.md).
//
// C entry: tf_flash_attention_fwd(...) launches on the given stream,
// allocates nothing and returns cudaGetLastError() (or cudaErrorInvalidValue
// for a shape or dtype it does not take).

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kRows = 128;   // query rows per block
constexpr int kTileK = 64;   // keys per shared-memory tile
constexpr int kChunk = 16;   // keys per online-softmax update
constexpr float kInvLog2e = 0.6931471805599453f;  // 1 / log2(e)

struct Params {
  const void* q;   // [B, H, Lq, D]
  const void* k;   // [B, Hkv, Lk, D]
  const void* v;
  void* out;       // [B, H, Lq, D], q's dtype
  float* lse;      // [B, H, Lq]
  float* m;        // [B, H, Lq] or null
  int B, H, Hkv, Lq, Lk, q_offset, causal;
  float scale2;    // softmax scale * log2(e)
};

template <int D>
__host__ __device__ constexpr int threads_per_row() { return D > 64 ? 2 : 1; }

template <int D, bool BF16>
__global__ void __launch_bounds__(kRows * threads_per_row<D>())
flash_attention_fwd_kernel(const Params p) {
  constexpr int kTpr = threads_per_row<D>();
  constexpr int kDt = D / kTpr;            // head dims per thread
  constexpr int kRowsPerWarp = 32 / kTpr;
  constexpr int kThreads = kRows * kTpr;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);   // [kTileK][D]
  float* vs = ks + kTileK * D;                    // [kTileK][D]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int part = lane / kRowsPerWarp;           // which half of D (D = 128)
  const int row_in_block = warp * kRowsPerWarp + lane % kRowsPerWarp;
  const int qt = gridDim.x - 1 - blockIdx.x;      // heavy tiles first
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int row0 = qt * kRows;
  const int r = row0 + row_in_block;
  const bool row_ok = r < p.Lq;

  // Keys this block needs, and the keys each row and each warp may see.
  const int block_last = min(row0 + kRows, p.Lq) - 1;
  const int kend = p.causal ? max(0, min(p.Lk, block_last + p.q_offset + 1))
                            : p.Lk;
  const int limit = p.causal ? min(p.Lk, r + p.q_offset + 1) : p.Lk;
  const int warp_last = min(row0 + (warp + 1) * kRowsPerWarp, p.Lq) - 1;
  const int warp_limit =
      warp_last < row0 + warp * kRowsPerWarp
          ? 0  // every row of this warp is padding
          : (p.causal ? min(p.Lk, warp_last + p.q_offset + 1) : p.Lk);

  const size_t q_off = ((size_t)bh * p.Lq + (row_ok ? r : 0)) * D + part * kDt;
  float q[kDt];
#pragma unroll
  for (int e = 0; e < kDt; e += 8) {
    float f[8];
    load8<BF16>(p.q, q_off + e, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float x = row_ok ? f[i] * p.scale2 : 0.f;
      q[e + i] = BF16 ? round_bf16(x) : x;
    }
  }

  float m = -INFINITY, l = 0.f, acc[kDt];
#pragma unroll
  for (int e = 0; e < kDt; ++e) acc[e] = 0.f;

  const size_t kv_base = ((size_t)b * p.Hkv + hk) * p.Lk * D;
  for (int k0 = 0; k0 < kend; k0 += kTileK) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = tid; idx < kTileK * D / 8; idx += kThreads) {
      const int kr = idx / (D / 8), c = (idx % (D / 8)) * 8;
      float fk[8], fv[8];
      if (k0 + kr < p.Lk) {
        const size_t off = kv_base + (size_t)(k0 + kr) * D + c;
        load8<BF16>(p.k, off, fk);
        load8<BF16>(p.v, off, fv);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) fk[i] = fv[i] = 0.f;
      }
      float4* kd = reinterpret_cast<float4*>(ks + kr * D + c);
      float4* vd = reinterpret_cast<float4*>(vs + kr * D + c);
      kd[0] = make_float4(fk[0], fk[1], fk[2], fk[3]);
      kd[1] = make_float4(fk[4], fk[5], fk[6], fk[7]);
      vd[0] = make_float4(fv[0], fv[1], fv[2], fv[3]);
      vd[1] = make_float4(fv[4], fv[5], fv[6], fv[7]);
    }
    __syncthreads();

    const int nk = min(kTileK, warp_limit - k0);  // warp-uniform
    for (int c = 0; c < nk; c += kChunk) {
      float s[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) s[j] = 0.f;
#pragma unroll
      for (int e = 0; e < kDt; e += 4) {
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const float4 kv = *reinterpret_cast<const float4*>(
              ks + (c + j) * D + part * kDt + e);
          s[j] = fmaf(q[e], kv.x, s[j]);
          s[j] = fmaf(q[e + 1], kv.y, s[j]);
          s[j] = fmaf(q[e + 2], kv.z, s[j]);
          s[j] = fmaf(q[e + 3], kv.w, s[j]);
        }
      }
      if constexpr (kTpr == 2) {
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
          s[j] += __shfl_xor_sync(kFull, s[j], kRowsPerWarp);
      }
      float mx = m;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (k0 + c + j >= limit) s[j] = -INFINITY;
        mx = fmaxf(mx, s[j]);
      }
      if (mx == -INFINITY) continue;  // nothing visible to this row yet
      const float alpha = exp2f(m - mx);  // 0 while m is -inf
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float pj = exp2f(s[j] - mx);  // masked keys: exp2(-inf) = 0
        psum += pj;
        s[j] = BF16 ? round_bf16(pj) : pj;
      }
      l = l * alpha + psum;
      m = mx;
#pragma unroll
      for (int e = 0; e < kDt; ++e) acc[e] *= alpha;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
#pragma unroll
        for (int e = 0; e < kDt; e += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(
              vs + (c + j) * D + part * kDt + e);
          acc[e] = fmaf(s[j], vv.x, acc[e]);
          acc[e + 1] = fmaf(s[j], vv.y, acc[e + 1]);
          acc[e + 2] = fmaf(s[j], vv.z, acc[e + 2]);
          acc[e + 3] = fmaf(s[j], vv.w, acc[e + 3]);
        }
      }
    }
  }

  if (!row_ok) return;
  const bool empty = m == -INFINITY;
  const size_t o_off = ((size_t)bh * p.Lq + r) * D + part * kDt;
#pragma unroll
  for (int e = 0; e < kDt; ++e) {
    const float o = empty ? 0.f : acc[e] / l;
    if constexpr (BF16)
      static_cast<__nv_bfloat16*>(p.out)[o_off + e] = __float2bfloat16_rn(o);
    else
      static_cast<float*>(p.out)[o_off + e] = o;
  }
  if (part == 0) {
    const size_t row = (size_t)bh * p.Lq + r;
    const float m_nat = m * kInvLog2e;
    p.lse[row] = empty ? -INFINITY : m_nat + logf(l);
    if (p.m) p.m[row] = empty ? -INFINITY : m_nat;
  }
}

template <int D, bool BF16>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int kThreads = kRows * threads_per_row<D>();
  constexpr int kSmem = 2 * kTileK * D * sizeof(float);
  auto kernel = flash_attention_fwd_kernel<D, BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lq + kRows - 1) / kRows, p.B * p.H);
  kernel<<<grid, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dtype(const Params& p, int bf16, cudaStream_t stream) {
  return bf16 ? launch<D, true>(p, stream) : launch<D, false>(p, stream);
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16 (q, k, v and out share it).
int tf_flash_attention_fwd(const void* q, const void* k, const void* v,
                           void* out, float* lse, float* m, int B, int H,
                           int Hkv, int Lq, int Lk, int d, int dtype,
                           int causal, int q_offset, float scale2,
                           void* stream) {
  if ((dtype != 0 && dtype != 1) || Hkv <= 0 || H % Hkv || B * H > 65535 ||
      Lk <= 0)
    return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || Lq == 0) return cudaSuccess;
  const Params p{q, k, v, out, lse, m, B, H, Hkv, Lq, Lk, q_offset,
                 causal != 0, scale2};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_dtype<16>(p, dtype, st);
    case 32: return launch_dtype<32>(p, dtype, st);
    case 64: return launch_dtype<64>(p, dtype, st);
    case 128: return launch_dtype<128>(p, dtype, st);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
