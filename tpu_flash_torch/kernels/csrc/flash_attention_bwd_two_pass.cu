// Flash-attention backward in two passes, for sm_90a: a dK/dV pass, then a
// dQ pass.  Neither uses atomics: every output element is summed in one
// block, in a fixed order, and written once, so two calls give the same bits.
//
// Replaces the two-pass form of tpu_flash/kernels/flash_attention.py's
// flash_attention_backward, which the JAX package takes where its fused
// single pass would not fit a TensorCore's VMEM or costs more grid steps
// (select_bwd_fused_config, :1472; bf16 causal from L = 16384, fp32 from 8192
// at d = 64; the port keeps that rule, kernels/backward_form.py):
//   * the dK/dV pass replaces _bwd_dkv_kernel (:1134, launched by
//     pl.pallas_call at :2099), which is _bwd_kv_outer_body with dQ disabled:
//     one block per (batch * KV head, tile of 64 keys) walking the query rows
//     that can see its keys, for each head of the GQA group, dK and dV summed
//     over the group in fp32 and written once, scale * dK and dV, in the input
//     dtype;
//   * the dQ pass replaces _bwd_dq_kernel (:1159, launched at :2135): one
//     block per (batch * head, tile of 64 query rows) walking the key tiles up
//     to its causal limit (q_offset = Lk - Lq puts the diagonal at the bottom
//     right), heavy query tiles first, scale * dQ written once in the input
//     dtype, the JAX epilogue at :1223-1225.
// Each has two forms, chosen by the wrapper (kernels/flash_attention.py
// _form_name) and exported as separate C entries:
//   * bf16: the tensor-core form (tf_flash_attention_bwd_dkv_tc,
//     tf_flash_attention_bwd_dq_tc).  The TPU kernels feed their MXU bf16
//     operands with fp32 sums, rounding q * scale * log2(e), P before dV and
//     dS before dK and dQ to bf16: exactly a bf16 x bf16 -> fp32 product, so
//     every product here is an mma.sync.m16n8k16 on the tensor cores and only
//     the order of the fp32 sums differs from the plain version.  4 warps a
//     block, 16 keys (dK/dV) or 16 query rows (dQ) each; the other operand's
//     tiles of 64 rows stream through a ring of shared-memory stages filled by
//     cp.async; S, dP, P and dS live in the mma accumulators, and P and dS
//     become the next product's A fragments without passing through shared
//     memory (an m16n8 C tile is half an m16n8k16 A tile); the dK/dV pass
//     shares its body with the fused kernel (flash_attention_bwd.cuh);
//   * fp32: the CUDA-core form (tf_flash_attention_bwd_dkv / _dq), exact fp32
//     FMAs, never TF32: the dK/dV pass is kv_outer_body
//     (flash_attention_bwd.cuh); the dQ pass holds a query row's
//     q, dO and dQ in registers (D / 16 threads a row) and stages K and V
//     tiles in shared memory in fp32.
//
// What bounds them: operations.  At B1 H8 L16384 d64 causal one causal
// L^2 * d product is 1.37e11 flops; the dK/dV pass does four (S, dP, dV, dK)
// and the dQ pass three (S, dP, dQ), against ~100 MB of traffic each.  The
// tensor-core form uses mma.sync with ldmatrix fragments; wgmma, TMA and
// warp specialisation are later work (ROADMAP.md).  Numerics as in
// flash_attention_bwd.cuh.
//
// C entries launch on the given stream, allocate nothing and return
// cudaGetLastError() (or cudaErrorInvalidValue for a shape or dtype they do
// not take).

#include "flash_attention_bwd.cuh"

namespace {

// --- the CUDA-core forms (fp32) ---------------------------------------------

template <int D>
__global__ void __launch_bounds__(kv_outer_threads<D>())
flash_attention_bwd_dkv_kernel(const BwdParams p) {
  kv_outer_body<D>(p);
}

// --- the dQ pass ------------------------------------------------------------
//
// The mirror of kv_outer_body: there a key's k, v, dK and dV rows sit in
// registers and the query rows stream through shared memory; here a query
// row's q, dO and dQ sit in registers and the keys stream through it.  A row
// belongs to D / 16 threads, each owning 16 head dims; one key at a time,
// the partial dots over a thread's dims meet through shuffles.

constexpr int kRowsQ = 64;   // query rows per block
constexpr int kTileK = 64;   // keys per shared-memory tile

template <int D>
__host__ __device__ constexpr int dq_threads() {
  return kRowsQ * (D / kDt);
}

template <int D>
__global__ void __launch_bounds__(dq_threads<D>())
flash_attention_bwd_dq_kernel(const BwdParams p) {
  constexpr int kTpr = D / kDt;            // threads per query row
  constexpr int kRowsPerWarp = 32 / kTpr;
  constexpr int kThreads = dq_threads<D>();
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);   // [kTileK][D]
  float* vs = ks + kTileK * D;                    // [kTileK][D]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int part = lane / kRowsPerWarp;           // which 16 dims of the row
  const int row_in_block = warp * kRowsPerWarp + lane % kRowsPerWarp;
  const int qt = gridDim.x - 1 - blockIdx.x;      // heavy tiles first
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int row0 = qt * kRowsQ;
  const int r = row0 + row_in_block;
  const bool row_ok = r < p.Lq;

  // Keys this block needs, and the keys each row and each warp may see.
  const int block_last = min(row0 + kRowsQ, p.Lq) - 1;
  const int kend = p.causal ? max(0, min(p.Lk, block_last + p.q_offset + 1))
                            : p.Lk;
  const int limit = p.causal ? min(p.Lk, r + p.q_offset + 1) : p.Lk;
  const int warp_last = min(row0 + (warp + 1) * kRowsPerWarp, p.Lq) - 1;
  const int warp_limit =
      warp_last < row0 + warp * kRowsPerWarp
          ? 0  // every row of this warp is padding
          : (p.causal ? min(p.Lk, warp_last + p.q_offset + 1) : p.Lk);

  const size_t row_idx = (size_t)bh * p.Lq + (row_ok ? r : 0);
  const size_t q_off = row_idx * D + part * kDt;
  float qr[kDt], dor[kDt], dq[kDt];
#pragma unroll
  for (int e = 0; e < kDt; e += 8) {
    load8<false>(p.q, q_off + e, qr + e);
    load8<false>(p.dout, q_off + e, dor + e);
  }
#pragma unroll
  for (int e = 0; e < kDt; ++e) {
    qr[e] = row_ok ? qr[e] * p.scale2 : 0.f;
    if (!row_ok) dor[e] = 0.f;
    dq[e] = 0.f;
  }
  const float lse2 = row_ok ? bwd_lse2(p.lse[row_idx]) : INFINITY;
  const float delta = row_ok ? p.delta[row_idx] : 0.f;

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
    for (int jj = 0; jj < nk; ++jj) {
      const float* krow = ks + jj * D + part * kDt;
      const float* vrow = vs + jj * D + part * kDt;
      float s4[4] = {0.f, 0.f, 0.f, 0.f}, dp4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int e = 0; e < kDt; e += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(krow + e);
        const float4 vv = *reinterpret_cast<const float4*>(vrow + e);
        s4[0] = fmaf(qr[e], kk.x, s4[0]);
        s4[1] = fmaf(qr[e + 1], kk.y, s4[1]);
        s4[2] = fmaf(qr[e + 2], kk.z, s4[2]);
        s4[3] = fmaf(qr[e + 3], kk.w, s4[3]);
        dp4[0] = fmaf(dor[e], vv.x, dp4[0]);
        dp4[1] = fmaf(dor[e + 1], vv.y, dp4[1]);
        dp4[2] = fmaf(dor[e + 2], vv.z, dp4[2]);
        dp4[3] = fmaf(dor[e + 3], vv.w, dp4[3]);
      }
      float s = (s4[0] + s4[1]) + (s4[2] + s4[3]);
      float dp = (dp4[0] + dp4[1]) + (dp4[2] + dp4[3]);
#pragma unroll
      for (int off = kRowsPerWarp; off < 32; off <<= 1) {
        s += __shfl_xor_sync(kFull, s, off);
        dp += __shfl_xor_sync(kFull, dp, off);
      }
      const float ds =
          bwd_p_ds(s, dp, lse2, delta, k0 + jj < limit).ds;
#pragma unroll
      for (int e = 0; e < kDt; e += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(krow + e);
        dq[e] = fmaf(ds, kk.x, dq[e]);
        dq[e + 1] = fmaf(ds, kk.y, dq[e + 1]);
        dq[e + 2] = fmaf(ds, kk.z, dq[e + 2]);
        dq[e + 3] = fmaf(ds, kk.w, dq[e + 3]);
      }
    }
  }

  if (!row_ok) return;
#pragma unroll
  for (int e = 0; e < kDt; ++e)
    static_cast<float*>(p.dq)[q_off + e] = p.scale * dq[e];
}

template <int D>
cudaError_t launch_dq(const BwdParams& p, cudaStream_t stream) {
  constexpr int kSmem = 2 * kTileK * D * sizeof(float);
  auto kernel = flash_attention_bwd_dq_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lq + kRowsQ - 1) / kRowsQ, p.B * p.H);
  kernel<<<grid, dq_threads<D>(), kSmem, stream>>>(p);
  return cudaGetLastError();
}

// --- the tensor-core forms (bf16) -------------------------------------------
//
// Both passes are the same shape of kernel (flash_attention_tc.cuh).  The
// dK/dV pass is kv_outer_tc_body without dQ (flash_attention_bwd.cuh, which
// the fused kernel runs with dQ).  The dQ pass is its mirror: a block's warps
// each own 16 query rows, whose q * scale2 and dO are its A fragments, and
// the keys come in tiles of 64 through kStages shared-memory stages, each
// thread's cp.async pieces for tile t + kStages - 1 issued before tile t is
// computed; one __syncthreads a tile.  A warp computes S and dP for kStep
// keys at a time into m16n8 accumulators, turns them into dS in place
// (bwd_p_ds's arithmetic; the element mask only in steps that cross the
// causal diagonal or the ragged end of Lk), and feeds dS, packed to bf16
// pairs, as the A fragments of dQ += dS K.  lse2 and D are indexed by row
// here, by column in the dK/dV pass (S^T there).

// dK/dV: one block per (batch * KV head, tile of 64 keys), key-tile major,
// so the low tiles, which see the most query rows, start first.  Two blocks
// an SM: without the bound, ptxas caps d = 32 at 168 registers
// (three blocks) and spills.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_attention_bwd_dkv_tc_kernel(const BwdParams p) {
  kv_outer_tc_body<D, false>(p);
}

template <int D>
__host__ __device__ constexpr int dq_tc_smem_bytes() {
  // q * scale2 and dO of the block's rows; k and v tiles a stage
  return (2 + 2 * TcShape<D>::kStages) * TcShape<D>::kTileBytes;
}

// dQ: one block per (batch * head, tile of 64 query rows); heavy tiles (more
// keys under the causal mask) first.
template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_attention_bwd_dq_tc_kernel(const BwdParams p) {
  using S = TcShape<D>;
  constexpr int P = S::P, kStages = S::kStages, NK = S::kStep;
  extern __shared__ uint4 tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);   // [64][P] q * scale2
  bf16* os = qs + kTcBlock * P;                   // [64][P] dO
  bf16* ring = os + kTcBlock * P;                 // stage st: k, v [64][P]

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
  load_tile<D>(os, p.dout, rows, row0, p.Lq, tid);
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
  cp_async_wait<kStages - 2>();   // q, dO and the first tile
  scale_tile<D>(qs, qs, p.scale2, tid);
  __syncthreads();

  uint32_t qa[S::kRegs ? D / 16 : 1][4], oa[S::kRegs ? D / 16 : 1][4];
  if constexpr (S::kRegs) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      a_frag<D>(qa[kk], qs, warp * 16, kk, lane);
      a_frag<D>(oa[kk], os, warp * 16, kk, lane);
    }
  }
  // this thread's rows rw + lane / 4 and rw + lane / 4 + 8
  float lse2[2], delta[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = rw + (lane >> 2) + 8 * hh;
    lse2[hh] = i < p.Lq ? bwd_lse2(p.lse[rows + i]) : INFINITY;
    delta[hh] = i < p.Lq ? p.delta[rows + i] : 0.f;
  }
  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

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
      // S = (q scale2) K^T and dP = dO V^T
      float s[NK / 8][4], dp[NK / 8][4];
#pragma unroll
      for (int j = 0; j < NK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qf[4], of[4];
        const uint32_t* aq = qf;
        const uint32_t* ao = of;
        if constexpr (S::kRegs) {
          aq = qa[kk];
          ao = oa[kk];
        } else {
          a_frag<D>(qf, qs, warp * 16, kk, lane);
          a_frag<D>(of, os, warp * 16, kk, lane);
        }
#pragma unroll
        for (int n2 = 0; n2 < NK / 16; ++n2) {
          uint32_t bk[4], bv[4];
          b_frags_nk<D>(bk, kt, sub + 16 * n2, kk, lane);
          b_frags_nk<D>(bv, vt, sub + 16 * n2, kk, lane);
          mma_bf16(s[2 * n2], aq, bk);
          mma_bf16(s[2 * n2 + 1], aq, bk + 2);
          mma_bf16(dp[2 * n2], ao, bv);
          mma_bf16(dp[2 * n2 + 1], ao, bv + 2);
        }
      }
      // dS in place of dP; row r is the thread's row lane / 4 + 8 (e / 2)
#pragma unroll
      for (int j = 0; j < NK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pr = exp2f(s[j][e] - lse2[e >> 1]);
          if (!full) {
            const int key = kc + 8 * j + 2 * (lane & 3) + (e & 1);
            const int i = rw + (lane >> 2) + 8 * (e >> 1);
            if (key >= p.Lk || (p.causal && key > i + p.q_offset)) pr = 0.f;
          }
          dp[j][e] = pr * (dp[j][e] - delta[e >> 1]);
        }
      // dQ += dS K over the step's keys
#pragma unroll
      for (int kk = 0; kk < NK / 16; ++kk) {
        uint32_t da[4];
        acc_as_a(da, dp, kk);
#pragma unroll
        for (int n2 = 0; n2 < D / 16; ++n2) {
          uint32_t bk[4];
          b_frags_kn<D>(bk, kt, sub + 16 * kk, 16 * n2, lane);
          mma_bf16(dq[2 * n2], da, bk);
          mma_bf16(dq[2 * n2 + 1], da, bk + 2);
        }
      }
    }
    cp_async_wait<kStages - 2>();   // tile t + 1 has landed
    __syncthreads();
  }

  store_rows<D>(p.dq, rows, rw, p.Lq, dq, p.scale, lane);
}

template <int D>
cudaError_t launch_dq_tc(const BwdParams& p, cudaStream_t stream) {
  constexpr int kSmem = dq_tc_smem_bytes<D>();
  auto kernel = flash_attention_bwd_dq_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lq + kTcBlock - 1) / kTcBlock, p.B * p.H);
  kernel<<<grid, kTcThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

// --- launches ---------------------------------------------------------------

template <int D>
cudaError_t launch_pass(const BwdParams& p, bool dkv, bool tc,
                        cudaStream_t stream) {
  if (tc)
    return dkv ? launch_kv_outer_tc<D, false>(
                     flash_attention_bwd_dkv_tc_kernel<D>, p, stream)
               : launch_dq_tc<D>(p, stream);
  return dkv ? launch_kv_outer<D>(flash_attention_bwd_dkv_kernel<D>, p,
                                  stream)
             : launch_dq<D>(p, stream);
}

// The checks every entry makes (tc: bf16 only; else fp32 only), then the
// launch of the pass at head dim d.
cudaError_t launch_any(const BwdParams& p, bool dkv, int d, int dtype,
                       bool tc, cudaStream_t stream) {
  if (dtype != (tc ? 1 : 0) ||
      !bwd_args_ok(dtype, p.H, p.Hkv, d,
                   (long long)p.B * (dkv ? p.Hkv : p.H)))
    return cudaErrorInvalidValue;
  if (p.B == 0 || p.H == 0 || (dkv ? p.Lk : p.Lq) == 0) return cudaSuccess;
  switch (d) {
    case 16: return launch_pass<16>(p, dkv, tc, stream);
    case 32: return launch_pass<32>(p, dkv, tc, stream);
    case 64: return launch_pass<64>(p, dkv, tc, stream);
    case 128: return launch_pass<128>(p, dkv, tc, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The dK/dV pass.  dtype: 0 fp32 (the CUDA-core form); the _tc entry takes
// 1, bf16 (the tensor-core form).  q, k, v, dout, dk and dv share it.
// Writes dk and dv [B, Hkv, Lk, d] (zeros for keys no query row sees).
#define TF_DKV_ENTRY(symbol, tc)                                              \
  int symbol(const void* q, const void* k, const void* v, const void* dout,  \
             const float* lse, const float* delta, void* dk, void* dv,       \
             int B, int H, int Hkv, int Lq, int Lk, int d, int dtype,        \
             int causal, int q_offset, float scale, float scale2,            \
             void* stream) {                                                 \
    const BwdParams p{q, k, v, dout, lse, delta, nullptr, dk, dv, B, H, Hkv, \
                      Lq, Lk, q_offset, causal != 0, scale, scale2};         \
    return launch_any(p, true, d, dtype, tc,                                 \
                      static_cast<cudaStream_t>(stream));                    \
  }

// The dQ pass.  dtype as above.  Writes dq [B, H, Lq, d] in the input dtype
// (zeros for rows that see no key).
#define TF_DQ_ENTRY(symbol, tc)                                               \
  int symbol(const void* q, const void* k, const void* v, const void* dout,  \
             const float* lse, const float* delta, void* dq, int B, int H,   \
             int Hkv, int Lq, int Lk, int d, int dtype, int causal,          \
             int q_offset, float scale, float scale2, void* stream) {        \
    const BwdParams p{q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, H, \
                      Hkv, Lq, Lk, q_offset, causal != 0, scale, scale2};    \
    return launch_any(p, false, d, dtype, tc,                                \
                      static_cast<cudaStream_t>(stream));                    \
  }

TF_DKV_ENTRY(tf_flash_attention_bwd_dkv, false)
TF_DKV_ENTRY(tf_flash_attention_bwd_dkv_tc, true)
TF_DQ_ENTRY(tf_flash_attention_bwd_dq, false)
TF_DQ_ENTRY(tf_flash_attention_bwd_dq_tc, true)

}  // extern "C"
