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
// _form_name) and exported as separate C entries, both on the tensor cores
// with 4 warps a block, 16 keys (dK/dV) or 16 query rows (dQ) each; the
// other operand's tiles stream through shared-memory stages filled by
// cp.async; S, dP, P and dS live in the mma accumulators, and P and dS
// become the next product's A fragments without passing through shared
// memory (an m16n8 C tile is half an m16n8k16 A tile); the dK/dV pass
// shares its body with the fused kernel (flash_attention_bwd.cuh):
//   * bf16: the tensor-core form (tf_flash_attention_bwd_dkv_tc,
//     tf_flash_attention_bwd_dq_tc).  The TPU kernels feed their MXU bf16
//     operands with fp32 sums, rounding q * scale * log2(e), P before dV and
//     dS before dK and dQ to bf16: exactly a bf16 x bf16 -> fp32 product, so
//     every product here is an mma.sync.m16n8k16 and only the order of the
//     fp32 sums differs from the plain version; the other operand's tiles
//     of 64 rows come through a ring of kStages bf16 stages;
//   * fp32: the six-product form (tf_flash_attention_bwd_dkv_x6,
//     tf_flash_attention_bwd_dq_x6), every product six bf16 products of the
//     operands split in three (mma_x6, mma.cuh), as the TPU runs fp32 dots
//     at Precision.HIGHEST; each tile arrives in fp32 into one stage while
//     the tile before it is computed and is split once by the whole block
//     into three bf16 planes in shared memory, which every warp reads.  The
//     sums over the sequence (dK and dV over query rows, dQ over keys) take
//     mma_x6_add, each 16-row or 16-key step's products summed apart and
//     added in fp32 rounded to nearest; the sums over the head dim (S, dP)
//     accumulate in place.
//
// What bounds them: operations.  At B1 H8 L16384 d64 causal one causal
// L^2 * d product is 1.37e11 flops; the dK/dV pass does four (S, dP, dV, dK)
// and the dQ pass three (S, dP, dQ), against ~100 MB of traffic each; in
// fp32 each is six bf16 products.  Both forms use mma.sync with ldmatrix
// fragments; wgmma, TMA and warp specialisation are later work
// (ROADMAP.md).  Numerics as in flash_attention_bwd.cuh.
//
// Each kernel has a masked instantiation (kMask: a sliding window and
// segment ids, flash_attention_tc.cuh), launched only where the call has
// either: the dK/dV pass's query walk ends at the band's last row, the dQ
// pass's key loop starts at the band's first tile.  Each form, masked or
// not, has a dropout instantiation (kDrop, flash_attention_tc.cuh),
// launched for a call with a seed: dP is scaled by the forward's keep bits
// before D is taken off, and dV takes P keep / (1 - rate).  And each has
// quantized instantiations (kQuant, flash_attention_tc.cuh), the _kvq C
// entries of a library of their own (flash_attention_bwd_two_pass_kvq.cu
// builds this file with TF_KVQ): the dK/dV pass is the KV-outer body's
// (flash_attention_bwd.cuh); the dQ pass takes its K and V tiles as codes
// through its stages and turns each into bf16 (one plane each in fp32),
// token scales multiply S and dP by key and dS before dQ (_bwd_dq_kernel,
// :1180-1210), and in fp32 each product with codes takes three products.
//
// C entries launch on the given stream, allocate nothing and return
// cudaGetLastError() (or cudaErrorInvalidValue for a shape or dtype they do
// not take).

#include "flash_attention_bwd.cuh"

namespace {

// --- the tensor-core forms (bf16) -------------------------------------------
//
// Both passes are the same shape of kernel (flash_attention_tc.cuh).  The
// dK/dV pass is kv_outer_tc_body without dQ (flash_attention_bwd.cuh, which
// the fused kernel runs with dQ).  The dQ pass is its mirror: a block's warps
// each own 16 query rows, whose q * scale2 and dO are its A fragments, and
// the keys come in tiles of 64 through kStages shared-memory stages, each
// thread's cp.async pieces for tile t + kStages - 1 issued before tile t is
// computed; one __syncthreads a tile.  A warp computes S and dP for kStep
// keys at a time into m16n8 accumulators, turns them into P = exp2(S -
// lse2) and dS = P (dP - D) in place (the element mask only in steps that
// cross the causal diagonal or the ragged end of Lk), and feeds dS, packed
// to bf16
// pairs, as the A fragments of dQ += dS K.  lse2 and D are indexed by row
// here, by column in the dK/dV pass (S^T there).

// dK/dV: one block per (batch * KV head, tile of 64 keys), key-tile major,
// so the low tiles, which see the most query rows, start first.  Two blocks
// an SM: without the bound, ptxas caps d = 32 at 168 registers
// (three blocks) and spills.
template <int D, bool kMask, bool kDrop, int kQuant>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_attention_bwd_dkv_tc_kernel(
    const BwdParamsOf<kMask, kDrop, kQuant> p) {
  kv_outer_tc_body<D, false, kMask, kDrop, kQuant>(p);
}

template <int D, int kQuant = kKvNone>
__host__ __device__ constexpr int dq_tc_smem_bytes() {
  // q * scale2 and dO of the block's rows; k and v tiles a stage (quantized:
  // the tile's k and v in bf16, then their codes and scales a stage)
  if constexpr (kQuant == kKvNone)
    return (2 + 2 * TcShape<D>::kStages) * TcShape<D>::kTileBytes;
  else
    return 4 * TcShape<D>::kTileBytes +
           TcShape<D>::kStages * kv_code_stage_bytes<D, kTcTile>();
}

// dQ: one block per (batch * head, tile of 64 query rows); heavy tiles (more
// keys under the causal mask) first.
template <int D, bool kMask, bool kDrop, int kQuant>
__global__ void __launch_bounds__(kTcThreads)
flash_attention_bwd_dq_tc_kernel(const BwdParamsOf<kMask, kDrop, kQuant> p) {
  using S = TcShape<D>;
  constexpr int P = S::P, kStages = S::kStages, NK = S::kStep;
  constexpr bool kQ = kQuant != kKvNone;
  extern __shared__ uint4 tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);   // [64][P] q * scale2
  bf16* os = qs + kTcBlock * P;                   // [64][P] dO
  bf16* ring = os + kTcBlock * P;                 // stage st: k, v [64][P]
  // kQ: the tile's k and v [64][P] at ring, then stage st's codes and
  // scales (kv_code_stage_bytes)
  [[maybe_unused]] auto code_stage = [&](int st) {
    return reinterpret_cast<uint8_t*>(ring + 2 * kTcTile * P) +
           st * kv_code_stage_bytes<D, kTcTile>();
  };

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
  // kMask: the band's first tile starts the key loop; the mask's view of
  // the block's rows after the form's shared memory
  const int t0 = band_first_tile<kMask, kTcTile>(p, row0, tiles);
  [[maybe_unused]] const volatile MaskSmem* ms = nullptr;
  if constexpr (kMask)
    ms = mask_setup(reinterpret_cast<char*>(tc_smem) +
                        dq_tc_smem_bytes<D, kQuant>(),
                    p.seg, b, p.Lq, row0, tid);
  // kDrop: the hash's terms of the block's rows after the mask's view
  [[maybe_unused]] volatile DropSmem* ds = nullptr;
  if constexpr (kDrop)
    ds = drop_setup(reinterpret_cast<char*>(tc_smem) +
                        dq_tc_smem_bytes<D, kQuant>() +
                        (kMask ? kMaskSmemBytes : 0),
                    kDropRow, drop_bh(p.seed, b, h), row0, tid);

  load_tile<D>(qs, p.q, rows, row0, p.Lq, tid);
  load_tile<D>(os, p.dout, rows, row0, p.Lq, tid);
  cp_async_commit();
  auto load_stage = [&](int st, int t) {
    if constexpr (kQ) {
      uint8_t* c = code_stage(st);
      load_codes<D, kTcTile>(c, p.k, kv_rows, t * kTcTile, p.Lk, tid);
      load_codes<D, kTcTile>(c + kTcTile * D, p.v, kv_rows, t * kTcTile,
                             p.Lk, tid);
      if constexpr (kQuant == kKvToken) {
        float* sc = reinterpret_cast<float*>(c + 2 * kTcTile * D);
        load_kv_scales<kTcTile>(sc, sc + kTcTile, p.k_scale, p.v_scale,
                                kv_rows, t * kTcTile, p.Lk, tid);
      }
    } else {
      bf16* kt = ring + 2 * st * kTcTile * P;
      load_tile<D>(kt, p.k, kv_rows, t * kTcTile, p.Lk, tid);
      load_tile<D>(kt + kTcTile * P, p.v, kv_rows, t * kTcTile, p.Lk, tid);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (t0 + s < tiles) load_stage(s, t0 + s);
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

  for (int t = t0; t < tiles; ++t) {
    const int u = t - t0;   // the tile's place in the ring
    if (t + kStages - 1 < tiles) load_stage((u + kStages - 1) % kStages,
                                            t + kStages - 1);
    else cp_async_commit();
    const bf16* kt = ring + 2 * (u % kStages) * kTcTile * P;
    const bf16* vt = kt + kTcTile * P;
    // kQuant: the tile's codes into k and v in bf16 (read by every warp
    // after the barrier), and its token scales
    [[maybe_unused]] const float* ksc = nullptr;
    [[maybe_unused]] const float* vsc = nullptr;
    if constexpr (kQ) {
      const uint8_t* c = code_stage(u % kStages);
      convert_codes<D, kTcTile>(ring, c, p.fp8, tid);
      convert_codes<D, kTcTile>(ring + kTcTile * P, c + kTcTile * D, p.fp8,
                                tid);
      ksc = reinterpret_cast<const float*>(c + 2 * kTcTile * D);
      vsc = ksc + kTcTile;
      kt = ring;
      vt = ring + kTcTile * P;
      __syncthreads();
    }
#pragma unroll
    for (int sub = 0; sub < kTcTile; sub += NK) {
      const int kc = t * kTcTile + sub;   // the step's first key
      if (kc >= wlimit) continue;         // the warp's rows see none of them
      bool full = kc + NK <= p.Lk &&
                  !(p.causal && kc + NK - 1 > rw + p.q_offset);
      if constexpr (kMask)
        if (!keys_live<NK>(p, ms, kc, rw, warp, lane, full)) continue;
      if constexpr (kDrop)
        drop_step<NK>(ds, 0u, kc, kDropCol, p.threshold, tid);
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
      if constexpr (kQuant == kKvToken) {   // by key: S ks, dP vs
        scale_cols<NK>(s, ksc, sub, lane);
        scale_cols<NK>(dp, vsc, sub, lane);
      }
      // dS in place of dP; row r is the thread's row lane / 4 + 8 (e / 2)
      if constexpr (kMask)
        if (!full) mask_scores<NK>(s, p, ms, kc, rw, warp, lane);
      [[maybe_unused]] uint32_t bits = 0;
      if constexpr (kDrop) bits = ds->bits[tid];
#pragma unroll
      for (int j = 0; j < NK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pr = exp2f(s[j][e] - lse2[e >> 1]);
          if constexpr (!kMask) {
            if (!full) {
              const int key = kc + 8 * j + 2 * (lane & 3) + (e & 1);
              const int i = rw + (lane >> 2) + 8 * (e >> 1);
              if (key >= p.Lk || (p.causal && key > i + p.q_offset))
                pr = 0.f;
            }
          }
          if constexpr (kDrop) {
            // dP scaled by the keep mask before D is taken off
            const float ks = drop_scale(bits, j, e, p.keep_scale);
            dp[j][e] = pr * (__fmul_rn(dp[j][e], ks) - delta[e >> 1]);
          } else {
            dp[j][e] = pr * (dp[j][e] - delta[e >> 1]);
          }
        }
      // token scales: dQ's operand is dS ks
      if constexpr (kQuant == kKvToken) scale_cols<NK>(dp, ksc, sub, lane);
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

template <int D, bool kMask, bool kDrop, int kQuant>
cudaError_t launch_dq_tc(const BwdParamsOf<kMask, kDrop, kQuant>& p,
                         cudaStream_t stream) {
  constexpr int kSmem = dq_tc_smem_bytes<D, kQuant>() +
                        (kMask ? kMaskSmemBytes : 0) +
                        (kDrop ? kDropSmemBytes : 0);
  auto kernel = flash_attention_bwd_dq_tc_kernel<D, kMask, kDrop, kQuant>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lq + kTcBlock - 1) / kTcBlock, p.B * p.H);
  kernel<<<grid, kTcThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

// --- the six-product forms (fp32) ------------------------------------------
//
// The dK/dV pass is kv_outer_x6_body without dQ (flash_attention_bwd.cuh,
// which the fused kernel runs with dQ): query tiles of 32 rows, 106 KB of
// shared memory at d = 64, two blocks an SM below d = 128.

template <int D, bool kMask, bool kDrop, int kQuant>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_attention_bwd_dkv_x6_kernel(
    const BwdParamsOf<kMask, kDrop, kQuant> p) {
  kv_outer_x6_body<D, false, kMask, kDrop, kQuant>(p, kvq_of(p));
}

// The dQ pass is flash_attention_bwd_dq_tc_kernel's mirror with every
// product mma_x6: one block per (batch * head, tile of 64 query rows),
// heavy tiles first, each warp owning 16 rows.  The block's q * scale2 and
// dO arrive in fp32 once and are split once into three planes each, from
// which the warps read their A fragments each step (held in registers, the
// six planes of both would cost 24 D / 16 registers a thread).  K and V
// tiles of kKT keys arrive in fp32 by cp.async into one stage while the
// tile before is computed, and the whole block splits each once into three
// planes a tensor.  A warp computes S and dP for NK keys at a time, turns
// them into dS in place in fp32 (exp2f, the mask, dS = P (dP - D) with
// __fmul_rn: the fused x6 body's arithmetic), splits dS in registers into
// the A fragments of dQ += dS K (acc_as_a_x6), and adds each 16 keys'
// products to dQ by mma_x6_add: a row's dQ stays in registers across all
// its keys, so the sums are fresh ones, as an fp32 sum's error grows.
// Tiles of 32 keys: 98 KB of shared memory at d = 64, two blocks an SM
// below d = 128 (64 keys would take 142 KB at d = 64 and 276 KB at 128).
// The quantized forms keep that layout: a tile's codes (and token scales)
// arrive in the stage and become one plane each of K and V, the scales
// copied into K's second plane; S, dP and dQ take three products.

template <int D>
struct DqX6 {
  static constexpr int kKT = 32;                  // keys a tile
  static constexpr int NK = D <= 64 ? 32 : 16;    // keys a step (at d = 128
                                                  // 32 spill)
  static constexpr int P = TcShape<D>::P;
  static constexpr int F = kF32Pitch<D>;
  static constexpr int kQPlane = kTcBlock * P;    // elements of a plane
  static constexpr int kKPlane = kKT * P;
  // at d = 128 the products' loops over the head dim are not unrolled
  static constexpr int kUnroll = D <= 64 ? 8 : 1;
  // byte offsets: the planes of q * scale2 and dO, those of k and v, and
  // the fp32 stage (k, v [kKT][F]); q and dO arrive in fp32 over the
  // planes of k and v and the stage
  static constexpr int kKvOff = 6 * kQPlane * 2;
  static constexpr int kStageOff = kKvOff + 6 * kKPlane * 2;
  static constexpr int kSmem = kStageOff + 2 * kKT * F * 4;
  static_assert(2 * kTcBlock * F * 4 <= kSmem - kKvOff, "q, dO staging");
  static_assert(kSmem <= 232448, "shared memory");
};

template <int D, bool kMask, bool kDrop, int kQuant>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_attention_bwd_dq_x6_kernel(const BwdParamsOf<kMask, kDrop, kQuant> p) {
  using X = DqX6<D>;
  constexpr bool kQ = kQuant != kKvNone;
  constexpr int kKT = X::kKT, NK = X::NK, F = X::F;
  constexpr int kQPlane = X::kQPlane, kKPlane = X::kKPlane;
  extern __shared__ uint4 x6_smem[];
  char* sm = reinterpret_cast<char*>(x6_smem);
  bf16* qpl = reinterpret_cast<bf16*>(sm);       // q * scale2's [64][P] x 3
  bf16* opl = qpl + 3 * kQPlane;                 // dO's
  bf16* kpl = reinterpret_cast<bf16*>(sm + X::kKvOff);   // k's [kKT][P] x 3
  bf16* vpl = kpl + 3 * kKPlane;                 // v's
  float* kst = reinterpret_cast<float*>(sm + X::kStageOff);  // k [kKT][F]
  float* vst = kst + kKT * F;                    // v
  float* qdst = reinterpret_cast<float*>(sm + X::kKvOff);  // q, dO [64][F]
  // kQ: the tile's token scales (k, then v [kKT]) in K's second plane
  [[maybe_unused]] float* cur = reinterpret_cast<float*>(kpl + kKPlane);

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
  const int tiles = (kend + kKT - 1) / kKT;
  const int rw = row0 + warp * 16;
  const int wlimit =
      rw >= p.Lq ? 0
                 : (p.causal ? min(p.Lk, min(rw + 15, p.Lq - 1) +
                                             p.q_offset + 1)
                             : p.Lk);
  // kMask: the band's first tile starts the key loop; the mask's view of
  // the block's rows after the form's shared memory
  const int t0 = band_first_tile<kMask, kKT>(p, row0, tiles);
  [[maybe_unused]] const volatile MaskSmem* ms = nullptr;
  if constexpr (kMask)
    ms = mask_setup(sm + X::kSmem, p.seg, b, p.Lq, row0, tid);
  // kDrop: the hash's terms of the block's rows after the mask's view
  [[maybe_unused]] volatile DropSmem* ds = nullptr;
  if constexpr (kDrop)
    ds = drop_setup(sm + X::kSmem + (kMask ? kMaskSmemBytes : 0), kDropRow,
                    drop_bh(p.seed, b, h), row0, tid);

  auto load_stage = [&](int t) {
    if constexpr (kQ) {
      uint8_t* c = reinterpret_cast<uint8_t*>(kst);
      load_codes<D, kKT>(c, p.k, kv_rows, t * kKT, p.Lk, tid);
      load_codes<D, kKT>(c + kKT * D, p.v, kv_rows, t * kKT, p.Lk, tid);
      if constexpr (kQuant == kKvToken) {
        float* sc = reinterpret_cast<float*>(c + 2 * kKT * D);
        load_kv_scales<kKT>(sc, sc + kKT, p.k_scale, p.v_scale, kv_rows,
                            t * kKT, p.Lk, tid);
      }
    } else {
      load_tile_f32<D, kKT>(kst, p.k, kv_rows, t * kKT, p.Lk, tid);
      load_tile_f32<D, kKT>(vst, p.v, kv_rows, t * kKT, p.Lk, tid);
    }
  };
  auto split_stage = [&]() {
    if constexpr (kQ) {
      const uint8_t* c = reinterpret_cast<const uint8_t*>(kst);
      convert_codes<D, kKT>(kpl, c, p.fp8, tid);
      convert_codes<D, kKT>(vpl, c + kKT * D, p.fp8, tid);
      if constexpr (kQuant == kKvToken)
        if (tid < 2 * kKT)
          cur[tid] = reinterpret_cast<const float*>(c + 2 * kKT * D)[tid];
    } else {
      split_tile<D, kKT>(kpl, kKPlane, kst, 1.f, tid);
      split_tile<D, kKT>(vpl, kKPlane, vst, 1.f, tid);
    }
  };

  // q and dO, then the first tile
  load_tile_f32<D, kTcBlock>(qdst, p.q, rows, row0, p.Lq, tid);
  load_tile_f32<D, kTcBlock>(qdst + kTcBlock * F, p.dout, rows, row0, p.Lq,
                             tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  split_tile<D, kTcBlock>(qpl, kQPlane, qdst, p.scale2, tid);
  split_tile<D, kTcBlock>(opl, kQPlane, qdst + kTcBlock * F, 1.f, tid);
  __syncthreads();   // q and dO in fp32 read before their space is reused
  if (t0 < tiles) load_stage(t0);
  cp_async_commit();
  // this thread's rows rw + lane / 4 and rw + lane / 4 + 8: lse in base 2
  // (+inf past Lq, so that P is 0 there) and D
  float lse2[2], delta[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = rw + (lane >> 2) + 8 * hh;
    lse2[hh] = i < p.Lq ? bwd_lse2(p.lse[rows + i]) : INFINITY;
    delta[hh] = i < p.Lq ? p.delta[rows + i] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();
  if (t0 < tiles) split_stage();
  __syncthreads();
  if (t0 + 1 < tiles) load_stage(t0 + 1);
  cp_async_commit();

  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  for (int t = t0; t < tiles; ++t) {
#pragma unroll
    for (int sub = 0; sub < kKT; sub += NK) {
      const int kc = t * kKT + sub;   // the step's first key
      if (kc >= wlimit) continue;     // the warp's rows see none of them
      bool full = kc + NK <= p.Lk &&
                  !(p.causal && kc + NK - 1 > rw + p.q_offset);
      if constexpr (kMask)
        if (!keys_live<NK>(p, ms, kc, rw, warp, lane, full)) continue;
      if constexpr (kDrop)
        drop_step<NK>(ds, 0u, kc, kDropCol, p.threshold, tid);
      // S = (q scale2) K^T and dP = dO V^T
      float s[NK / 8][4], dp[NK / 8][4];
#pragma unroll
      for (int j = 0; j < NK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll (X::kUnroll)
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qa[3][4];
#pragma unroll
        for (int pl = 0; pl < 3; ++pl)
          a_frag<D>(qa[pl], qpl + pl * kQPlane, warp * 16, kk, lane);
#pragma unroll
        for (int n2 = 0; n2 < NK / 16; ++n2) {
          if constexpr (kQ) {   // the codes: one plane, three products
            uint32_t bk[4];
            b_frags_nk<D>(bk, kpl, sub + 16 * n2, kk, lane);
            mma_x3(s[2 * n2], qa, bk);
            mma_x3(s[2 * n2 + 1], qa, bk + 2);
          } else {
            uint32_t bk[3][4];
#pragma unroll
            for (int pl = 0; pl < 3; ++pl)
              b_frags_nk<D>(bk[pl], kpl + pl * kKPlane, sub + 16 * n2, kk,
                            lane);
            mma_x6(s[2 * n2], qa, bk[0], bk[1], bk[2]);
            mma_x6(s[2 * n2 + 1], qa, bk[0] + 2, bk[1] + 2, bk[2] + 2);
          }
        }
      }
#pragma unroll (X::kUnroll)
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t oa[3][4];
#pragma unroll
        for (int pl = 0; pl < 3; ++pl)
          a_frag<D>(oa[pl], opl + pl * kQPlane, warp * 16, kk, lane);
#pragma unroll
        for (int n2 = 0; n2 < NK / 16; ++n2) {
          if constexpr (kQ) {
            uint32_t bv[4];
            b_frags_nk<D>(bv, vpl, sub + 16 * n2, kk, lane);
            mma_x3(dp[2 * n2], oa, bv);
            mma_x3(dp[2 * n2 + 1], oa, bv + 2);
          } else {
            uint32_t bv[3][4];
#pragma unroll
            for (int pl = 0; pl < 3; ++pl)
              b_frags_nk<D>(bv[pl], vpl + pl * kKPlane, sub + 16 * n2, kk,
                            lane);
            mma_x6(dp[2 * n2], oa, bv[0], bv[1], bv[2]);
            mma_x6(dp[2 * n2 + 1], oa, bv[0] + 2, bv[1] + 2, bv[2] + 2);
          }
        }
      }
      if constexpr (kQuant == kKvToken) {   // by key: S ks, dP vs
        scale_cols<NK>(s, cur, sub, lane);
        scale_cols<NK>(dp, cur + kKT, sub, lane);
      }
      // P = exp2(S - lse2) and dS = P (dP - D) in place of dP, in fp32; row
      // r is the thread's row lane / 4 + 8 (e / 2)
      if constexpr (kMask)
        if (!full) mask_scores<NK>(s, p, ms, kc, rw, warp, lane);
      [[maybe_unused]] uint32_t bits = 0;
      if constexpr (kDrop) bits = ds->bits[tid];
#pragma unroll
      for (int j = 0; j < NK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pr = exp2f(s[j][e] - lse2[e >> 1]);
          if constexpr (!kMask) {
            if (!full) {
              const int key = kc + 8 * j + 2 * (lane & 3) + (e & 1);
              const int i = rw + (lane >> 2) + 8 * (e >> 1);
              if (key >= p.Lk || (p.causal && key > i + p.q_offset))
                pr = 0.f;
            }
          }
          if constexpr (kDrop) {
            // dP scaled by the keep mask before D is taken off
            const float ks = drop_scale(bits, j, e, p.keep_scale);
            dp[j][e] =
                __fmul_rn(pr, __fmul_rn(dp[j][e], ks) - delta[e >> 1]);
          } else {
            // __fmul_rn: no fused multiply-add into the split
            dp[j][e] = __fmul_rn(pr, dp[j][e] - delta[e >> 1]);
          }
        }
      // token scales: dQ's operand is dS ks
      if constexpr (kQuant == kKvToken) scale_cols<NK>(dp, cur, sub, lane);
      // dQ += dS K over the step's keys, 16 at a time
#pragma unroll
      for (int kk = 0; kk < NK / 16; ++kk) {
        uint32_t da[3][4];
        acc_as_a_x6(da, dp, kk);
#pragma unroll
        for (int n2 = 0; n2 < D / 16; ++n2) {
          if constexpr (kQ) {
            uint32_t bk[4];
            b_frags_kn<D>(bk, kpl, sub + 16 * kk, 16 * n2, lane);
            mma_x3_add(dq[2 * n2], da, bk);
            mma_x3_add(dq[2 * n2 + 1], da, bk + 2);
          } else {
            uint32_t bk[3][4];
#pragma unroll
            for (int pl = 0; pl < 3; ++pl)
              b_frags_kn<D>(bk[pl], kpl + pl * kKPlane, sub + 16 * kk,
                            16 * n2, lane);
            mma_x6_add(dq[2 * n2], da, bk[0], bk[1], bk[2]);
            mma_x6_add(dq[2 * n2 + 1], da, bk[0] + 2, bk[1] + 2,
                       bk[2] + 2);
          }
        }
      }
    }
    cp_async_wait<0>();   // tile t + 1 has landed
    __syncthreads();      // the planes of tile t are no longer read
    if (t + 1 < tiles) split_stage();
    __syncthreads();      // the planes of tile t + 1 written, the stage read
    if (t + 2 < tiles) load_stage(t + 2);
    cp_async_commit();
  }

  store_rows_f32<D>(p.dq, rows, rw, p.Lq, dq, p.scale, lane);
}

template <int D, bool kMask, bool kDrop, int kQuant>
cudaError_t launch_dq_x6(const BwdParamsOf<kMask, kDrop, kQuant>& p,
                         cudaStream_t stream) {
  constexpr int kSmem = DqX6<D>::kSmem + (kMask ? kMaskSmemBytes : 0) +
                        (kDrop ? kDropSmemBytes : 0);
  auto kernel = flash_attention_bwd_dq_x6_kernel<D, kMask, kDrop, kQuant>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lq + kTcBlock - 1) / kTcBlock, p.B * p.H);
  kernel<<<grid, kTcThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

// --- launches ---------------------------------------------------------------

template <int D, bool kMask, bool kDrop, int kQuant>
cudaError_t launch_pass(const BwdParamsOf<kMask, kDrop, kQuant>& p, bool dkv,
                        bool tc, cudaStream_t stream) {
  if (tc)
    return dkv ? launch_kv_outer_tc<D, false, kMask, kDrop, kQuant>(
                     flash_attention_bwd_dkv_tc_kernel<D, kMask, kDrop,
                                                       kQuant>,
                     p, stream)
               : launch_dq_tc<D, kMask, kDrop, kQuant>(p, stream);
  return dkv ? launch_kv_outer_x6<D, false, kMask, kDrop, kQuant>(
                   flash_attention_bwd_dkv_x6_kernel<D, kMask, kDrop, kQuant>,
                   p, stream)
             : launch_dq_x6<D, kMask, kDrop, kQuant>(p, stream);
}

template <typename Prm>
cudaError_t launch_d(const Prm& p, bool dkv, int d, bool tc,
                     cudaStream_t stream) {
  constexpr bool kMask = kMaskOf<Prm>, kDrop = kDropOf<Prm>;
  constexpr int kQuant = kQuantOf<Prm>;
  switch (d) {
    case 16: return launch_pass<16, kMask, kDrop, kQuant>(p, dkv, tc, stream);
    case 32: return launch_pass<32, kMask, kDrop, kQuant>(p, dkv, tc, stream);
    case 64: return launch_pass<64, kMask, kDrop, kQuant>(p, dkv, tc, stream);
    case 128:
      return launch_pass<128, kMask, kDrop, kQuant>(p, dkv, tc, stream);
  }
  return cudaErrorInvalidValue;
}

// The checks every entry makes (tc: bf16 only; else, the six-product
// form, fp32 only), then the launch of the pass at head dim d, in its
// masked form where the call has a window or segment ids, in its dropout
// form where it has a seed, and quantized as kQuant says (kKvNone in the
// library without quantization, TF_KVQ's in a kvq library).
template <int kQuant>
cudaError_t launch_any(const BwdParams& p, int window, const int* seg,
                       const DropCall& drop, const KvqCall& kvq, bool dkv,
                       int d, int dtype, bool tc, cudaStream_t stream) {
  if (dtype != (tc ? 1 : 0) ||
      !bwd_args_ok(dtype, p.H, p.Hkv, d,
                   (long long)p.B * (dkv ? p.Hkv : p.H)) ||
      !mask_args_ok(window, p.causal, seg, p.Lq, p.Lk) ||
      !kvq_args_ok(kQuant, kvq))
    return cudaErrorInvalidValue;
  if (p.B == 0 || p.H == 0 || (dkv ? p.Lk : p.Lq) == 0) return cudaSuccess;
  return launch_form_of<kQuant>(p, window, seg, drop, kvq,
                                [&](const auto& prm) {
                                  return launch_d(prm, dkv, d, tc, stream);
                                });
}

}  // namespace

extern "C" {

// The dK/dV pass.  dtype: the _x6 entry takes 0, fp32 (the six-product
// form); the _tc entry 1, bf16 (the tensor-core form).  q, k, v, dout, dk
// and dv share it.  window (0 for none) and seg (or null), seed (null for
// no dropout), threshold and keep_scale as the forward's entries take them.
// Writes dk and dv [B, Hkv, Lk, d] (zeros for keys no query row sees).
#define TF_DKV_ARGS                                                          \
  const void *q, const void *k, const void *v, const void *dout,            \
      const float *lse, const float *delta, void *dk, void *dv, int B,      \
      int H, int Hkv, int Lq, int Lk, int d, int dtype, int causal,         \
      int q_offset, float scale, float scale2, int window, const int *seg,  \
      const int *seed, unsigned threshold, float keep_scale
#define TF_DKV_PARAMS                                                        \
  BwdParams {                                                                \
    q, k, v, dout, lse, delta, nullptr, dk, dv, B, H, Hkv, Lq, Lk,           \
        q_offset, causal != 0, scale, scale2                                 \
  }
// The dQ pass.  dtype as above.  Writes dq [B, H, Lq, d] in the input dtype
// (zeros for rows that see no key).
#define TF_DQ_ARGS                                                           \
  const void *q, const void *k, const void *v, const void *dout,            \
      const float *lse, const float *delta, void *dq, int B, int H,         \
      int Hkv, int Lq, int Lk, int d, int dtype, int causal, int q_offset,  \
      float scale, float scale2, int window, const int *seg,                \
      const int *seed, unsigned threshold, float keep_scale
#define TF_DQ_PARAMS                                                         \
  BwdParams {                                                                \
    q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, H, Hkv, Lq, Lk,      \
        q_offset, causal != 0, scale, scale2                                 \
  }

#ifndef TF_KVQ
#define TF_PASS_ENTRY(symbol, ARGS, PARAMS, dkv, tc)                         \
  int symbol(ARGS, void* stream) {                                          \
    return launch_any<kKvNone>(PARAMS, window, seg,                         \
                             DropCall{seed, threshold, keep_scale},         \
                             KvqCall{}, dkv, d, dtype, tc,                  \
                             static_cast<cudaStream_t>(stream));            \
  }

TF_PASS_ENTRY(tf_flash_attention_bwd_dkv_x6, TF_DKV_ARGS, TF_DKV_PARAMS,
              true, false)
TF_PASS_ENTRY(tf_flash_attention_bwd_dkv_tc, TF_DKV_ARGS, TF_DKV_PARAMS,
              true, true)
TF_PASS_ENTRY(tf_flash_attention_bwd_dq_x6, TF_DQ_ARGS, TF_DQ_PARAMS, false,
              false)
TF_PASS_ENTRY(tf_flash_attention_bwd_dq_tc, TF_DQ_ARGS, TF_DQ_PARAMS, false,
              true)
#else
// The quantized forms of TF_KVQ's granularity
// (flash_attention_bwd_two_pass_kvq.cu, token: k_scale and v_scale fp32
// [B, Hkv, Lk]; flash_attention_bwd_two_pass_kvqc.cu, channel codes: both
// null): k and v int8 or e4m3 codes (fp8 != 0); dtype as above is q's.
#define TF_PASS_KVQ_ENTRY(symbol, ARGS, PARAMS, dkv, tc)                     \
  int symbol(ARGS, const float* k_scale, const float* v_scale, int fp8,     \
             void* stream) {                                                \
    return launch_any<TF_KVQ>(PARAMS, window, seg,                          \
                            DropCall{seed, threshold, keep_scale},          \
                            KvqCall{k_scale, v_scale, fp8}, dkv, d, dtype,  \
                            tc, static_cast<cudaStream_t>(stream));         \
  }

TF_PASS_KVQ_ENTRY(tf_flash_attention_bwd_dkv_x6_kvq, TF_DKV_ARGS,
                  TF_DKV_PARAMS, true, false)
TF_PASS_KVQ_ENTRY(tf_flash_attention_bwd_dkv_tc_kvq, TF_DKV_ARGS,
                  TF_DKV_PARAMS, true, true)
TF_PASS_KVQ_ENTRY(tf_flash_attention_bwd_dq_x6_kvq, TF_DQ_ARGS, TF_DQ_PARAMS,
                  false, false)
TF_PASS_KVQ_ENTRY(tf_flash_attention_bwd_dq_tc_kvq, TF_DQ_ARGS, TF_DQ_PARAMS,
                  false, true)
#endif

}  // extern "C"
