// Flash-attention forward (FA2 loop order) for sm_90a.
//
// Replaces tpu_flash/kernels/flash_attention.py::_fwd_kernel
// (flash_attention.py:498, launched by pl.pallas_call at :985).  q
// [B, H, Lq, D], k and v [B, Hkv, Lk, D] (query head h reads KV head
// h / (H / Hkv): GQA without a materialized repeat), fp32 or bf16.  Writes out
// [B, H, Lq, D] in q's dtype and lse (and, when asked, m) fp32 [B, H, Lq] in
// natural-log units; m is the row max of the scaled scores.  Softmax runs in
// base 2 (exp2f) with scale * log2(e) folded into q.  A row that sees no key
// (causal with Lq > Lk) gives out 0, lse -inf and m -inf, whatever the
// tiling.  The loop ends at the causal limit of the block's last row, so
// tiles above the diagonal are never loaded, and heavy Q tiles (late rows,
// more keys under the causal mask) launch first.  This replaces the TPU's
// trace-time packed schedule (_tile_schedule, _packed_schedule,
// _width_class), which exists because a Mosaic grid cannot branch.
//
// What bounds it: operations.  At the training shape (B4 H8 L2048 d64,
// causal) the causal half of QK^T and P.V is 1.7e10 flops against 34 MB of
// q, k, v and out, some 500 flops per byte.  Two forms, chosen by the
// wrapper (kernels/flash_attention.py _form_name) and exported as separate
// C entries:
//   * bf16: the tensor-core form (tf_flash_attention_fwd_tc, below).  The
//     TPU kernel rounds q * scale * log2(e) and P to bf16 before its dots
//     and sums in fp32, exactly a bf16 x bf16 -> fp32 product, so both
//     products are mma.sync.m16n8k16 and only the order of the fp32 sums
//     differs from the plain version;
//   * fp32: the CUDA-core form (tf_flash_attention_fwd), exact fp32 FMAs,
//     never TF32 (the TPU runs fp32 at Precision.HIGHEST): one block of
//     kRows query rows per (batch * head, Q tile); a row belongs to one
//     thread (two for D = 128, each owning half of the head dims), so
//     q * scale * log2(e), the online-softmax state (m, l) and the output
//     accumulator stay in registers; K and V tiles of kTileK keys are staged
//     in shared memory, and every thread of a warp reads the same key at a
//     time (each 16-byte shared load a broadcast feeding 4 FMAs); keys are
//     taken kChunk at a time, the running max rescaled once per chunk.
// wgmma, TMA and warp specialisation are later work (ROADMAP.md).
//
// C entries launch on the given stream, allocate nothing and return
// cudaGetLastError() (or cudaErrorInvalidValue for a shape or dtype they do
// not take).

#include <math.h>

#include "flash_attention_tc.cuh"

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

template <int D>
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
    load8<false>(p.q, q_off + e, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) q[e + i] = row_ok ? f[i] * p.scale2 : 0.f;
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
        load8<false>(p.k, off, fk);
        load8<false>(p.v, off, fv);
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
        s[j] = exp2f(s[j] - mx);  // masked keys: exp2(-inf) = 0
        psum += s[j];
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
  for (int e = 0; e < kDt; ++e)
    static_cast<float*>(p.out)[o_off + e] = empty ? 0.f : acc[e] / l;
  if (part == 0) {
    const size_t row = (size_t)bh * p.Lq + r;
    const float m_nat = m * kInvLog2e;
    p.lse[row] = empty ? -INFINITY : m_nat + logf(l);
    if (p.m) p.m[row] = empty ? -INFINITY : m_nat;
  }
}


// --- the tensor-core form (bf16) --------------------------------------------
//
// One block of 4 warps per (batch * head, tile of 64 query rows), heavy
// tiles first; each warp owns 16 query rows, whose q * scale2 (rounded to
// bf16) are its A fragments for the whole loop.  K and V tiles of 64 keys of
// the row's KV head stream through kStages shared-memory stages filled by
// cp.async, ending at the causal limit of the block's last row; one
// __syncthreads a tile.  A warp takes kStep keys at a time: S = (q scale2)
// K^T into m16n8 fp32 accumulators (the element mask only in steps that
// cross the causal diagonal or the ragged end of Lk, a warp-uniform test),
// the row max across the quad of lanes that share a row, then the online
// softmax in registers, and P, rounded to bf16, becomes the A fragment of
// acc += P V (V's B fragments by ldmatrix.trans).  The normaliser l sums the
// same bf16 P below d = 128, where the TPU kernel's ones column rides the
// P.V product (_fold_l, flash_attention.py:403), and the fp32 P at d = 128;
// each lane keeps its part of l, summed across the quad at the end.

template <int D>
__host__ __device__ constexpr int fwd_tc_smem_bytes() {
  // q * scale2 of the block's rows; k and v tiles a stage
  return (1 + 2 * TcShape<D>::kStages) * TcShape<D>::kTileBytes;
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_attention_fwd_tc_kernel(const Params p) {
  using S = TcShape<D>;
  constexpr int P = S::P, kStages = S::kStages, NK = S::kStep;
  constexpr bool kFoldL = D < 128;
  extern __shared__ uint4 tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);   // [64][P] q * scale2
  bf16* ring = qs + kTcBlock * P;                 // stage st: k, v [64][P]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kTcBlock;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const size_t rows = (size_t)bh * p.Lq;
  const size_t kv_rows = ((size_t)b * p.Hkv + hk) * p.Lk;

  // Keys the block needs; the warp's rows and the keys they may see.
  const int block_last = min(row0 + kTcBlock, p.Lq) - 1;
  const int kend = p.causal ? max(0, min(p.Lk, block_last + p.q_offset + 1))
                            : p.Lk;
  const int tiles = (kend + kTcTile - 1) / kTcTile;
  const int rw = row0 + warp * 16;
  const int wlimit =
      rw >= p.Lq ? 0
                 : (p.causal ? min(p.Lk, min(rw + 15, p.Lq - 1) +
                                             p.q_offset + 1)
                             : p.Lk);

  load_tile<D>(qs, p.q, rows, row0, p.Lq, tid);
  cp_async_commit();
  auto load_stage = [&](int st, int t) {
    bf16* kt = ring + 2 * st * kTcTile * P;
    load_tile<D>(kt, p.k, kv_rows, t * kTcTile, p.Lk, tid);
    load_tile<D>(kt + kTcTile * P, p.v, kv_rows, t * kTcTile, p.Lk, tid);
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) load_stage(s, s);
    else cp_async_commit();
  }
  cp_async_wait<kStages - 2>();   // q and the first tile
  scale_tile<D>(qs, qs, p.scale2, tid);
  __syncthreads();

  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    a_frag<D>(qa[kk], qs, warp * 16, kk, lane);
  // this thread's rows rw + lane / 4 and rw + lane / 4 + 8: running max,
  // its part of l, and the output accumulators
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    if (t + kStages - 1 < tiles) load_stage((t + kStages - 1) % kStages,
                                            t + kStages - 1);
    else cp_async_commit();
    const bf16* kt = ring + 2 * (t % kStages) * kTcTile * P;
    const bf16* vt = kt + kTcTile * P;
#pragma unroll
    for (int sub = 0; sub < kTcTile; sub += NK) {
      const int kc = t * kTcTile + sub;   // the step's first key
      if (kc >= wlimit) continue;         // the warp's rows see none of them
      const bool full = kc + NK <= p.Lk &&
                        !(p.causal && kc + NK - 1 > rw + p.q_offset);
      // S = (q scale2) K^T
      float s[NK / 8][4];
#pragma unroll
      for (int j = 0; j < NK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int n2 = 0; n2 < NK / 16; ++n2) {
          uint32_t bk[4];
          b_frags_nk<D>(bk, kt, sub + 16 * n2, kk, lane);
          mma_bf16(s[2 * n2], qa[kk], bk);
          mma_bf16(s[2 * n2 + 1], qa[kk], bk + 2);
        }
      if (!full) {
#pragma unroll
        for (int j = 0; j < NK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kc + 8 * j + 2 * (lane & 3) + (e & 1);
            const int i = rw + (lane >> 2) + 8 * (e >> 1);
            if (key >= p.Lk || (p.causal && key > i + p.q_offset))
              s[j][e] = -INFINITY;
          }
      }
      // the online softmax of the thread's two rows (e / 2)
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      float base[2], alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
        base[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // nothing seen yet
        alpha[r] = exp2f(m[r] - base[r]);            // 0 while m is -inf
        m[r] = mx[r];
      }
#pragma unroll
      for (int j = 0; j < NK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // masked keys: exp2(-inf) = 0
          const float pr = exp2f(s[j][e] - base[e >> 1]);
          s[j][e] = kFoldL ? round_bf16(pr) : pr;
          psum[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }
      // acc += P V over the step's keys
#pragma unroll
      for (int kk = 0; kk < NK / 16; ++kk) {
        uint32_t pa[4];
        acc_as_a(pa, s, kk);
#pragma unroll
        for (int n2 = 0; n2 < D / 16; ++n2) {
          uint32_t bv[4];
          b_frags_kn<D>(bv, vt, sub + 16 * kk, 16 * n2, lane);
          mma_bf16(acc[2 * n2], pa, bv);
          mma_bf16(acc[2 * n2 + 1], pa, bv + 2);
        }
      }
    }
    cp_async_wait<kStages - 2>();   // tile t + 1 has landed
    __syncthreads();
  }

  // out = acc / l; a row that saw no key gives out 0, lse -inf and m -inf
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
  }
  const bool empty[2] = {m[0] == -INFINITY, m[1] == -INFINITY};
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[j][e] = empty[e >> 1] ? 0.f : acc[j][e] / l[e >> 1];
  store_rows<D>(p.out, rows, rw, p.Lq, acc, 1.f, lane);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = rw + (lane >> 2) + 8 * r;
      if (i >= p.Lq) continue;
      const float m_nat = m[r] * kInvLog2e;
      p.lse[rows + i] = empty[r] ? -INFINITY : m_nat + logf(l[r]);
      if (p.m) p.m[rows + i] = empty[r] ? -INFINITY : m_nat;
    }
  }
}

// --- launches ---------------------------------------------------------------

template <int D>
cudaError_t launch(const Params& p, bool tc, cudaStream_t stream) {
  const int threads = tc ? kTcThreads : kRows * threads_per_row<D>();
  const int rows = tc ? kTcBlock : kRows;
  const int smem = tc ? fwd_tc_smem_bytes<D>()
                      : 2 * kTileK * D * (int)sizeof(float);
  auto kernel = tc ? flash_attention_fwd_tc_kernel<D>
                   : flash_attention_fwd_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lq + rows - 1) / rows, p.B * p.H);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 fp32 (the CUDA-core form); the _tc entry takes 1, bf16 (the
// tensor-core form).  q, k, v and out share it.
#define TF_FWD_ENTRY(symbol, tc)                                              \
  int symbol(const void* q, const void* k, const void* v, void* out,         \
             float* lse, float* m, int B, int H, int Hkv, int Lq, int Lk,    \
             int d, int dtype, int causal, int q_offset, float scale2,       \
             void* stream) {                                                 \
    if (dtype != (tc ? 1 : 0) || Hkv <= 0 || H % Hkv || B * H > 65535 ||     \
        Lk <= 0)                                                             \
      return cudaErrorInvalidValue;                                          \
    if (B == 0 || H == 0 || Lq == 0) return cudaSuccess;                     \
    const Params p{q, k, v, out, lse, m, B, H, Hkv, Lq, Lk, q_offset,        \
                   causal != 0, scale2};                                     \
    const cudaStream_t st = static_cast<cudaStream_t>(stream);              \
    switch (d) {                                                             \
      case 16: return launch<16>(p, tc, st);                                 \
      case 32: return launch<32>(p, tc, st);                                 \
      case 64: return launch<64>(p, tc, st);                                 \
      case 128: return launch<128>(p, tc, st);                               \
    }                                                                        \
    return cudaErrorInvalidValue;                                            \
  }

TF_FWD_ENTRY(tf_flash_attention_fwd, false)
TF_FWD_ENTRY(tf_flash_attention_fwd_tc, true)

}  // extern "C"
