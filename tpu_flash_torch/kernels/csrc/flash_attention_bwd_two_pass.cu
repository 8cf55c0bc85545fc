// Flash-attention backward in two passes, for sm_90a: a dK/dV pass, then a
// dQ pass.  Neither uses atomics: every output element is summed in one
// block, in a fixed order, and written once, so two calls give the same bits.
//
// Replaces the two-pass form of tpu_flash/kernels/flash_attention.py's
// flash_attention_backward, which the JAX package takes where its fused
// single pass would not fit a TensorCore's VMEM or costs more grid steps
// (select_bwd_fused_config, :1472; bf16 causal from L = 16384, fp32 from 8192
// at d = 64; the port keeps that rule, kernels/backward_form.py):
//   * tf_flash_attention_bwd_dkv replaces _bwd_dkv_kernel (:1134, launched by
//     pl.pallas_call at :2099), which is _bwd_kv_outer_body with dQ disabled.
//     Here it is kv_outer_body (flash_attention_bwd.cuh) without dQ: one
//     block per (batch * KV head, tile of 64 keys) walking the live query
//     rows of each head of the GQA group, dK and dV in registers summed over
//     the group in fp32, scale * dK and dV written once in the input dtype.
//   * tf_flash_attention_bwd_dq replaces _bwd_dq_kernel (:1159, launched at
//     :2135): one block per (batch * head, tile of 64 query rows); a row
//     belongs to D / 16 threads, each holding 16 of its head dims of
//     q * scale * log2(e), dO and the fp32 dQ accumulator in registers (the
//     mirror of the KV-outer body, where a key's rows sit in registers).
//     K and V tiles of 64 keys are staged in shared memory in fp32; every
//     thread of a warp reads the same key at a time (broadcast 16-byte
//     loads).  For each live key it recomputes S, P = exp2(S - lse * log2e),
//     dP = dO . v and dS = P * (dP - D) (bwd_p_ds, shared with the other two
//     kernels) and adds dS * k to dQ; the loop over KV tiles ends at the
//     causal limit of the block's last row (q_offset = Lk - Lq puts the
//     diagonal at the bottom right), and a warp stops at its own last row's
//     limit.  It writes scale * dQ once in the input dtype, the JAX epilogue
//     at :1223-1225.  Heavy query tiles (more keys under the causal mask)
//     launch first.
//
// What bounds them: operations.  At B1 H8 L16384 d64 causal one causal
// L^2 * d product is 1.37e11 flops; the dK/dV pass does four (S, dP, dV, dK)
// and the dQ pass three (S, dP, dQ), against ~100 MB of traffic each.  Both
// run fp32 FMAs on the CUDA cores; tensor cores (wgmma), TMA and pipelining
// are later work (ROADMAP.md).  Numerics as in flash_attention_bwd.cuh.
//
// C entries launch on the given stream, allocate nothing and return
// cudaGetLastError() (or cudaErrorInvalidValue for a shape or dtype they do
// not take).

#include "flash_attention_bwd.cuh"

namespace {

template <int D, bool BF16>
__global__ void __launch_bounds__(kv_outer_threads<D>())
flash_attention_bwd_dkv_kernel(const BwdParams p) {
  kv_outer_body<D, BF16, false>(p);
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

template <int D, bool BF16>
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
    load8<BF16>(p.q, q_off + e, qr + e);
    load8<BF16>(p.dout, q_off + e, dor + e);
  }
#pragma unroll
  for (int e = 0; e < kDt; ++e) {
    qr[e] = row_ok ? bwd_scaled_q<BF16>(qr[e], p.scale2) : 0.f;
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
          bwd_p_ds<BF16>(s, dp, lse2, delta, k0 + jj < limit).ds;
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
    store_as<BF16>(p.dq, q_off + e, p.scale * dq[e]);
}

template <int D, bool BF16>
cudaError_t launch_dq(const BwdParams& p, cudaStream_t stream) {
  constexpr int kSmem = 2 * kTileK * D * sizeof(float);
  auto kernel = flash_attention_bwd_dq_kernel<D, BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lq + kRowsQ - 1) / kRowsQ, p.B * p.H);
  kernel<<<grid, dq_threads<D>(), kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_pass(const BwdParams& p, bool dkv, int bf16,
                        cudaStream_t stream) {
  if (dkv)
    return bf16 ? launch_kv_outer<D, false>(
                      flash_attention_bwd_dkv_kernel<D, true>, p, stream)
                : launch_kv_outer<D, false>(
                      flash_attention_bwd_dkv_kernel<D, false>, p, stream);
  return bf16 ? launch_dq<D, true>(p, stream) : launch_dq<D, false>(p, stream);
}

cudaError_t launch_any(const BwdParams& p, bool dkv, int d, int bf16,
                       cudaStream_t stream) {
  switch (d) {
    case 16: return launch_pass<16>(p, dkv, bf16, stream);
    case 32: return launch_pass<32>(p, dkv, bf16, stream);
    case 64: return launch_pass<64>(p, dkv, bf16, stream);
    case 128: return launch_pass<128>(p, dkv, bf16, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16 (q, k, v, dout, dk and dv share it).  Writes dk and
// dv [B, Hkv, Lk, d] (zeros for keys no query row sees).
int tf_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, void* dk, void* dv, int B,
                               int H, int Hkv, int Lq, int Lk, int d,
                               int dtype, int causal, int q_offset,
                               float scale, float scale2, void* stream) {
  if (!bwd_args_ok(dtype, H, Hkv, d, (long long)B * Hkv))
    return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || Lk == 0) return cudaSuccess;
  const BwdParams p{q, k, v, dout, lse, delta, nullptr, dk, dv, B, H, Hkv,
                    Lq, Lk, q_offset, causal != 0, scale, scale2};
  return launch_any(p, true, d, dtype, static_cast<cudaStream_t>(stream));
}

// dtype as above.  Writes dq [B, H, Lq, d] in the input dtype (zeros for
// rows that see no key).
int tf_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, void* dq, int B, int H,
                              int Hkv, int Lq, int Lk, int d, int dtype,
                              int causal, int q_offset, float scale,
                              float scale2, void* stream) {
  if (!bwd_args_ok(dtype, H, Hkv, d, (long long)B * H))
    return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || Lq == 0) return cudaSuccess;
  const BwdParams p{q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, H,
                    Hkv, Lq, Lk, q_offset, causal != 0, scale, scale2};
  return launch_any(p, false, d, dtype, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
