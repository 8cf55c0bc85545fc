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
// q, k, v and out, some 500 flops per byte.  Two forms on the tensor cores,
// chosen by the wrapper (kernels/flash_attention.py _form_name) and exported
// as separate C entries, both one block of 4 warps per (batch * head, tile
// of 64 query rows):
//   * bf16 (tf_flash_attention_fwd_tc): the TPU kernel rounds
//     q * scale * log2(e) and P to bf16 before its dots and sums in fp32,
//     exactly a bf16 x bf16 -> fp32 product, so both products are
//     mma.sync.m16n8k16 and only the order of the fp32 sums differs from the
//     plain version;
//   * fp32 (tf_flash_attention_fwd_x6): the TPU runs fp32 dots at
//     Precision.HIGHEST, bf16 passes on its MXU; here each fp32 product is
//     six bf16 mma.sync products of the operands split in three (mma_x6,
//     mma.cuh), which keeps fp32 accuracy at up to 989 / 6 = 165 TFLOP/s
//     where the CUDA cores' FMAs stop at 67.
// wgmma, TMA and warp specialisation are later work (ROADMAP.md).
//
// Sliding windows and packed segments (tpu_flash/kernels/flash_attention.py
// _apply_mask, :359, and the dead-tile schedule of _tile_schedule, :132):
// each form has a masked instantiation (kMask, flash_attention_tc.cuh),
// launched only for a call with a window or segment ids.  Its key loop and
// the cp.async ring start at the band's first tile, so tiles wholly behind
// every row's window are never loaded (O(L window) work), and a step of
// keys is skipped, or taken without the element mask, by the tests of
// keys_live.
//
// Attention dropout (_fwd_kernel's dropout_rate, :596-626): each form,
// masked or not, has a dropout instantiation (kDrop, flash_attention_tc.cuh),
// launched only for a call with a seed.  Where a step's P is formed, the
// normaliser sums the undropped fp32 P (fold_l is off under dropout, :890),
// and P.V takes P keep / (1 - rate), rounded to bf16 in the bf16 form, the
// keep bit the hash of (query row, key, batch, head, seed).  The hash costs
// integer operations per score and no memory traffic.
//
// Quantized K/V (_fwd_kernel's quantized and scaled forms, :541-617): each
// form, masked and dropped or not, has quantized instantiations (kQuant,
// flash_attention_tc.cuh), exported as the _kvq C entries of a library of
// their own (flash_attention_fwd_kvq.cu builds this file with TF_KVQ), so
// that both compile at once.  The K and V tiles come as one-byte codes
// through the cp.async ring and are turned into bf16 tiles in shared memory
// once a tile; token scales multiply S and P in registers, and the
// normaliser sums the undropped fp32 P at every d (fold_l is off, :890).  In
// the fp32 form a product with codes as an operand takes three bf16
// products (mma_x3: q's or P's three planes by the codes' one), not six.
//
// C entries launch on the given stream, allocate nothing and return
// cudaGetLastError() (or cudaErrorInvalidValue for a shape or dtype they do
// not take).

#include <math.h>

#include <type_traits>

#include "flash_attention_tc.cuh"

namespace {

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

// The masked form's parameters (flash_attention_tc.cuh).
struct MaskedParams : Params {
  int window;      // keys > i + q_offset - window; kNoBand for none
  const int* seg;  // [B, L] segment ids, or null
};

// The parameters of a form: masked or not, with dropout's or without, with
// quantized K/V or without (flash_attention_tc.cuh).
template <bool kMask, bool kDrop, int kQuant = kKvNone>
using ParamsOf = QuantOf<
    std::conditional_t<
        kDrop, Dropped<std::conditional_t<kMask, MaskedParams, Params>>,
        std::conditional_t<kMask, MaskedParams, Params>>,
    kQuant>;

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

template <int D, int kQuant = kKvNone>
__host__ __device__ constexpr int fwd_tc_smem_bytes() {
  // q * scale2 of the block's rows; k and v tiles a stage (quantized: the
  // tile's k and v in bf16, then their codes and scales a stage)
  if constexpr (kQuant == kKvNone)
    return (1 + 2 * TcShape<D>::kStages) * TcShape<D>::kTileBytes;
  else
    return 3 * TcShape<D>::kTileBytes + 2 * kTcTile * 4 +
           TcShape<D>::kStages * kv_code_stage_bytes<D, kTcTile>();
}

template <int D, bool kMask, bool kDrop, int kQuant>
__global__ void __launch_bounds__(kTcThreads)
flash_attention_fwd_tc_kernel(const ParamsOf<kMask, kDrop, kQuant> p) {
  using S = TcShape<D>;
  // the token-scaled forms take 32 keys a step: 16 registers of S fewer
  // beside the scales' (with 64, ptxas holds 128 and spills); the channel
  // forms keep the unquantized step, whose rounding of P against the
  // running max their bf16 normaliser sums, as the unquantized one does
  constexpr int P = S::P, kStages = S::kStages,
                NK = kQuant == kKvToken ? 32 : S::kStep;
  // token scales: P.V takes P vs, so l sums the fp32 P (JAX's fold_l off)
  constexpr bool kFoldL = D < 128 && kQuant != kKvToken;
  constexpr bool kQ = kQuant != kKvNone;
  extern __shared__ uint4 tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);   // [64][P] q * scale2
  bf16* ring = qs + kTcBlock * P;                 // stage st: k, v [64][P]
  // kQ: the tile's k and v [64][P] at ring and its token scales (k, then
  // v [64]) at a fixed place after them, so that no register holds their
  // address; then stage st's codes and scales (kv_code_stage_bytes)
  [[maybe_unused]] float* cur = reinterpret_cast<float*>(ring + 2 * kTcTile * P);
  [[maybe_unused]] auto code_stage = [&](int st) {
    return reinterpret_cast<uint8_t*>(cur + 2 * kTcTile) +
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
                        fwd_tc_smem_bytes<D, kQuant>(),
                    p.seg, b, p.Lq, row0, tid);
  // kDrop: the hash's terms of the block's rows after the mask's view
  [[maybe_unused]] volatile DropSmem* ds = nullptr;
  if constexpr (kDrop)
    ds = drop_setup(reinterpret_cast<char*>(tc_smem) +
                        fwd_tc_smem_bytes<D, kQuant>() +
                        (kMask ? kMaskSmemBytes : 0),
                    kDropRow, drop_bh(p.seed, b, h), row0, tid);

  load_tile<D>(qs, p.q, rows, row0, p.Lq, tid);
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

  for (int t = t0; t < tiles; ++t) {
    const int u = t - t0;   // the tile's place in the ring
    if (t + kStages - 1 < tiles) load_stage((u + kStages - 1) % kStages,
                                            t + kStages - 1);
    else cp_async_commit();
    const bf16* kt = ring + 2 * (u % kStages) * kTcTile * P;
    const bf16* vt = kt + kTcTile * P;
    // kQuant: the tile's codes into k and v in bf16 and its token scales
    // into cur (read by every warp after the barrier)
    if constexpr (kQ) {
      const uint8_t* c = code_stage(u % kStages);
      convert_codes<D, kTcTile>(ring, c, p.fp8, tid);
      convert_codes<D, kTcTile>(ring + kTcTile * P, c + kTcTile * D, p.fp8,
                                tid);
      if constexpr (kQuant == kKvToken)
        cur[tid] = reinterpret_cast<const float*>(c + 2 * kTcTile * D)[tid];
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
      if constexpr (kQuant == kKvToken) scale_cols<NK>(s, cur, sub, lane);
      if (!full) {
        if constexpr (kMask) {
          mask_scores<NK>(s, p, ms, kc, rw, warp, lane);
        } else {
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
      [[maybe_unused]] uint32_t bits = 0;
      if constexpr (kDrop) bits = ds->bits[tid];
#pragma unroll
      for (int j = 0; j < NK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // masked keys: exp2(-inf) = 0
          const float pr = exp2f(s[j][e] - base[e >> 1]);
          if constexpr (kDrop || kQuant == kKvToken) {
            // l sums the undropped fp32 P; P.V takes P keep / (1 - rate)
            // (times the key's v scale)
            psum[e >> 1] += pr;
            float pv = pr;
            if constexpr (kDrop)
              pv = __fmul_rn(pv, drop_scale(bits, j, e, p.keep_scale));
            if constexpr (kQuant == kKvToken)
              pv = __fmul_rn(pv, cur[kTcTile + sub + 8 * j + 2 * (lane & 3) +
                                     (e & 1)]);
            s[j][e] = pv;
          } else {
            s[j][e] = kFoldL ? round_bf16(pr) : pr;
            psum[e >> 1] += s[j][e];
          }
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

// --- the fp32 form on the tensor cores (six bf16 products a product) -----
//
// The same walk as the bf16 form, with every product mma_x6.  The block's
// q rows arrive in fp32 by cp.async beside the first K and V tile, and are
// scaled by scale2 (one fp32 rounding, as the plain version's) and split
// once into three bf16 planes; below d = 128 each warp then holds its rows'
// planes as A fragments (48 registers at d = 64), at d = 128 (96 would not
// fit beside the 64 of the output accumulator) it reads them from shared
// memory each step of 16 keys.  Each K and V tile arrives in fp32 by cp.async into one
// stage, while the tile before it is computed, and is split once by the
// whole block into three planes each, which the 4 warps share; the stage is
// refilled as soon as it is split, so two __syncthreads a tile fence the
// planes.  P stays fp32 and is split in registers into the A fragments of
// acc += P V, each step's six products summed apart and added to acc
// rounded to nearest (mma_x6_add: acc sums over the whole key length); l
// sums the fp32 P at every d, and scores, the online max and exp2 are the
// plain version's fp32 arithmetic.  Shared memory at d = 64:
// K and V planes 54 KB and the stage 34 KB (q staged over the planes before
// the first tile), so that two blocks share an SM.  The quantized forms keep
// that layout: a tile's codes (and token scales) arrive in the stage and
// are turned into one plane each of K and V (a code is one exact bf16), the
// scales copied beside V's plane (the stage holds the next tile's while
// this one is computed); S and P.V take mma_x3, three products, not six.

template <int D>
struct FwdX6 {
  static constexpr int P = TcShape<D>::P;
  static constexpr int F = kF32Pitch<D>;
  static constexpr bool kQRegs = D <= 64;        // q's planes in registers
  // keys of S a warp holds at once: at d = 128 16 keys a step, and the
  // steps of a tile not unrolled, or ptxas spills
  static constexpr int NK = kQRegs ? TcShape<D>::kStep : 16;
  static constexpr int kPlane = kTcTile * P;     // elements of one plane
  static constexpr int kPlanesBytes = 6 * kPlane * 2;          // K, V
  static constexpr int kQPlanesBytes = kQRegs ? 0 : 3 * kPlane * 2;
  static constexpr int kSmem = kPlanesBytes + kQPlanesBytes +
                               2 * kTcTile * F * 4;            // the stage
  static_assert(kTcTile * F * 4 <= 3 * kPlane * 2, "q staged over V's planes");
  static_assert(kSmem <= 232448, "shared memory");
};

template <int D, bool kMask, bool kDrop, int kQuant>
__global__ void __launch_bounds__(kTcThreads, D <= 64 ? 2 : 1)
flash_attention_fwd_x6_kernel(const ParamsOf<kMask, kDrop, kQuant> p) {
  using X = FwdX6<D>;
  constexpr bool kQ = kQuant != kKvNone;
  // the dropout and quantized forms at d = 64 take 32 keys a step: 16
  // registers of S fewer, where the form without either holds 255
  constexpr int NK = (kDrop || kQ) && X::kQRegs ? 32 : X::NK;
  constexpr int kUnrollSteps = X::kQRegs ? kTcTile / NK : 1;
  constexpr int kPlane = X::kPlane, F = X::F;
  extern __shared__ uint4 x6_smem[];
  char* base = reinterpret_cast<char*>(x6_smem);
  bf16* kpl = reinterpret_cast<bf16*>(base);     // K's planes [64][P] x 3
  bf16* vpl = kpl + 3 * kPlane;                  // V's
  // q * scale2's planes: over K's before the first tile below d = 128
  bf16* qpl = X::kQRegs ? kpl : vpl + 3 * kPlane;
  float* stage = reinterpret_cast<float*>(base + X::kPlanesBytes +
                                          X::kQPlanesBytes);  // K, V [64][F]
  float* qstage = reinterpret_cast<float*>(vpl);  // q [64][F], once
  // kQ: the tile's token scales (k, then v [64]) in V's second plane
  [[maybe_unused]] float* cur = reinterpret_cast<float*>(vpl + kPlane);

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
    ms = mask_setup(base + X::kSmem, p.seg, b, p.Lq, row0, tid);
  // kDrop: the hash's terms of the block's rows after the mask's view
  [[maybe_unused]] volatile DropSmem* ds = nullptr;
  if constexpr (kDrop)
    ds = drop_setup(base + X::kSmem + (kMask ? kMaskSmemBytes : 0),
                    kDropRow, drop_bh(p.seed, b, h), row0, tid);

  auto load_stage = [&](int t) {
    if constexpr (kQ) {
      uint8_t* c = reinterpret_cast<uint8_t*>(stage);
      load_codes<D, kTcTile>(c, p.k, kv_rows, t * kTcTile, p.Lk, tid);
      load_codes<D, kTcTile>(c + kTcTile * D, p.v, kv_rows, t * kTcTile,
                             p.Lk, tid);
      if constexpr (kQuant == kKvToken) {
        float* sc = reinterpret_cast<float*>(c + 2 * kTcTile * D);
        load_kv_scales<kTcTile>(sc, sc + kTcTile, p.k_scale, p.v_scale,
                                kv_rows, t * kTcTile, p.Lk, tid);
      }
    } else {
      load_tile_f32<D, kTcTile>(stage, p.k, kv_rows, t * kTcTile, p.Lk,
                                tid);
      load_tile_f32<D, kTcTile>(stage + kTcTile * F, p.v, kv_rows,
                                t * kTcTile, p.Lk, tid);
    }
  };
  auto split_stage = [&]() {
    if constexpr (kQ) {
      const uint8_t* c = reinterpret_cast<const uint8_t*>(stage);
      convert_codes<D, kTcTile>(kpl, c, p.fp8, tid);
      convert_codes<D, kTcTile>(vpl, c + kTcTile * D, p.fp8, tid);
      if constexpr (kQuant == kKvToken)
        if (tid < 2 * kTcTile)
          cur[tid] = reinterpret_cast<const float*>(c + 2 * kTcTile * D)[tid];
    } else {
      split_tile<D, kTcTile>(kpl, kPlane, stage, 1.f, tid);
      split_tile<D, kTcTile>(vpl, kPlane, stage + kTcTile * F, 1.f, tid);
    }
  };
  load_tile_f32<D, kTcTile>(qstage, p.q, rows, row0, p.Lq, tid);
  if (t0 < tiles) load_stage(t0);
  cp_async_commit();
  cp_async_wait<0>();   // q and the first tile
  __syncthreads();
  split_tile<D, kTcTile>(qpl, kPlane, qstage, p.scale2, tid);
  __syncthreads();
  uint32_t qa[X::kQRegs ? D / 16 : 1][3][4];
  if constexpr (X::kQRegs) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int pl = 0; pl < 3; ++pl)
        a_frag<D>(qa[kk][pl], qpl + pl * kPlane, warp * 16, kk, lane);
    __syncthreads();    // q's planes are read before K's overwrite them
  }
  if (t0 < tiles) split_stage();
  __syncthreads();
  if (t0 + 1 < tiles) load_stage(t0 + 1);
  cp_async_commit();

  // this thread's rows rw + lane / 4 and rw + lane / 4 + 8: running max,
  // its part of l, and the output accumulators
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = t0; t < tiles; ++t) {
#pragma unroll (kUnrollSteps)
    for (int sub = 0; sub < kTcTile; sub += NK) {
      const int kc = t * kTcTile + sub;   // the step's first key
      if (kc >= wlimit) continue;         // the warp's rows see none of them
      bool full = kc + NK <= p.Lk &&
                  !(p.causal && kc + NK - 1 > rw + p.q_offset);
      if constexpr (kMask)
        if (!keys_live<NK>(p, ms, kc, rw, warp, lane, full)) continue;
      if constexpr (kDrop)
        drop_step<NK>(ds, 0u, kc, kDropCol, p.threshold, tid);
      // S = (q scale2) K^T
      float s[NK / 8][4];
#pragma unroll
      for (int j = 0; j < NK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qf[3][4];
#pragma unroll
        for (int pl = 0; pl < 3; ++pl) {
          if constexpr (X::kQRegs) {
#pragma unroll
            for (int e = 0; e < 4; ++e) qf[pl][e] = qa[kk][pl][e];
          } else {
            a_frag<D>(qf[pl], qpl + pl * kPlane, warp * 16, kk, lane);
          }
        }
#pragma unroll
        for (int n2 = 0; n2 < NK / 16; ++n2) {
          if constexpr (kQ) {   // the codes: one plane, three products
            uint32_t bk[4];
            b_frags_nk<D>(bk, kpl, sub + 16 * n2, kk, lane);
            mma_x3(s[2 * n2], qf, bk);
            mma_x3(s[2 * n2 + 1], qf, bk + 2);
          } else {
            uint32_t bk[3][4];
#pragma unroll
            for (int pl = 0; pl < 3; ++pl)
              b_frags_nk<D>(bk[pl], kpl + pl * kPlane, sub + 16 * n2, kk,
                            lane);
            mma_x6(s[2 * n2], qf, bk[0], bk[1], bk[2]);
            mma_x6(s[2 * n2 + 1], qf, bk[0] + 2, bk[1] + 2, bk[2] + 2);
          }
        }
      }
      if constexpr (kQuant == kKvToken) scale_cols<NK>(s, cur, sub, lane);
      if (!full) {
        if constexpr (kMask) {
          mask_scores<NK>(s, p, ms, kc, rw, warp, lane);
        } else {
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
      }
      // the online softmax of the thread's two rows (e / 2)
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      float base2[2], alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
        base2[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // nothing seen yet
        alpha[r] = exp2f(m[r] - base2[r]);            // 0 while m is -inf
        m[r] = mx[r];
      }
      [[maybe_unused]] uint32_t bits = 0;
      if constexpr (kDrop) bits = ds->bits[tid];
#pragma unroll
      for (int j = 0; j < NK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // masked keys: exp2(-inf) = 0
          if constexpr (kDrop || kQuant == kKvToken) {
            // l sums the undropped P; P.V takes P keep / (1 - rate) (times
            // the key's v scale)
            const float pr = exp2f(s[j][e] - base2[e >> 1]);
            psum[e >> 1] += pr;
            float pv = pr;
            if constexpr (kDrop)
              pv = __fmul_rn(pv, drop_scale(bits, j, e, p.keep_scale));
            if constexpr (kQuant == kKvToken)
              pv = __fmul_rn(pv, cur[kTcTile + sub + 8 * j +
                                     2 * (lane & 3) + (e & 1)]);
            s[j][e] = pv;
          } else {
            s[j][e] = exp2f(s[j][e] - base2[e >> 1]);
            psum[e >> 1] += s[j][e];
          }
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
        uint32_t pa[3][4];
        acc_as_a_x6(pa, s, kk);
#pragma unroll
        for (int n2 = 0; n2 < D / 16; ++n2) {
          if constexpr (kQ) {
            uint32_t bv[4];
            b_frags_kn<D>(bv, vpl, sub + 16 * kk, 16 * n2, lane);
            mma_x3_add(acc[2 * n2], pa, bv);
            mma_x3_add(acc[2 * n2 + 1], pa, bv + 2);
          } else {
            uint32_t bv[3][4];
#pragma unroll
            for (int pl = 0; pl < 3; ++pl)
              b_frags_kn<D>(bv[pl], vpl + pl * kPlane, sub + 16 * kk,
                            16 * n2, lane);
            mma_x6_add(acc[2 * n2], pa, bv[0], bv[1], bv[2]);
            mma_x6_add(acc[2 * n2 + 1], pa, bv[0] + 2, bv[1] + 2,
                       bv[2] + 2);
          }
        }
      }
    }
    if (t + 1 < tiles) {
      cp_async_wait<0>();   // tile t + 1 has landed
      __syncthreads();      // and every warp is done with tile t's planes
      split_stage();
      __syncthreads();
      if (t + 2 < tiles) load_stage(t + 2);
      cp_async_commit();
    }
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
  store_rows_f32<D>(p.out, rows, rw, p.Lq, acc, 1.f, lane);
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

template <int D, bool kMask, bool kDrop, int kQuant>
cudaError_t launch(const ParamsOf<kMask, kDrop, kQuant>& p, bool x6,
                   cudaStream_t stream) {
  const int smem = (x6 ? FwdX6<D>::kSmem : fwd_tc_smem_bytes<D, kQuant>()) +
                   (kMask ? kMaskSmemBytes : 0) +
                   (kDrop ? kDropSmemBytes : 0);
  auto kernel = x6 ? flash_attention_fwd_x6_kernel<D, kMask, kDrop, kQuant>
                   : flash_attention_fwd_tc_kernel<D, kMask, kDrop, kQuant>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lq + kTcBlock - 1) / kTcBlock, p.B * p.H);
  kernel<<<grid, kTcThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kMask, bool kDrop, int kQuant>
cudaError_t launch_d(const ParamsOf<kMask, kDrop, kQuant>& p, int d, bool x6,
                     cudaStream_t stream) {
  switch (d) {
    case 16: return launch<16, kMask, kDrop, kQuant>(p, x6, stream);
    case 32: return launch<32, kMask, kDrop, kQuant>(p, x6, stream);
    case 64: return launch<64, kMask, kDrop, kQuant>(p, x6, stream);
    case 128: return launch<128, kMask, kDrop, kQuant>(p, x6, stream);
  }
  return cudaErrorInvalidValue;
}

// The form for the call: masked where it has a window or segment ids,
// with dropout where it has a seed, quantized as kQuant says.
template <bool kMask, int kQuant>
cudaError_t launch_drop(const ParamsOf<kMask, false>& p, int d, bool x6,
                        const int* seed, uint32_t threshold, float keep_scale,
                        const KvqCall& kvq, cudaStream_t stream) {
  if (seed)
    return launch_d<kMask, true, kQuant>(
        quantized<kQuant>(
            Dropped<ParamsOf<kMask, false>>{p, seed, threshold, keep_scale},
            kvq),
        d, x6, stream);
  return launch_d<kMask, false, kQuant>(quantized<kQuant>(p, kvq), d, x6,
                                        stream);
}

// The checks and the launch of every entry (kQuant: kKvNone in the library
// without quantization, TF_KVQ's in a kvq library).
template <int kQuant>
int fwd_entry(bool x6, const void* q, const void* k, const void* v,
              void* out, float* lse, float* m, int B, int H, int Hkv, int Lq,
              int Lk, int d, int dtype, int causal, int q_offset,
              float scale2, int window, const int* seg, const int* seed,
              unsigned threshold, float keep_scale, const KvqCall& kvq,
              cudaStream_t st) {
  if (dtype != (x6 ? 0 : 1) || Hkv <= 0 || H % Hkv || B * H > 65535 ||
      Lk <= 0 || window < 0 || (window > 0 && !causal) ||
      (seg && Lq != Lk) || !kvq_args_ok(kQuant, kvq))
    return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || Lq == 0) return cudaSuccess;
  const Params p{q, k, v, out, lse, m, B, H, Hkv, Lq, Lk, q_offset,
                 causal != 0, scale2};
  if (window > 0 || seg)
    return launch_drop<true, kQuant>(
        MaskedParams{p, window > 0 ? window : kNoBand, seg}, d, x6, seed,
        threshold, keep_scale, kvq, st);
  return launch_drop<false, kQuant>(p, d, x6, seed, threshold, keep_scale,
                                    kvq, st);
}

}  // namespace

extern "C" {

// dtype: the _tc entry takes 1, bf16 (the tensor-core form), the _x6 entry
// 0, fp32 (six bf16 products a product).  q, k, v and out share it.
// window: 0 for none, else >= 1 with causal; seg: int32 [B, Lq] segment ids
// (Lq == Lk) or null.  Either launches the masked form.  seed: null for no
// dropout, else int32 [3] on the device (seed, batch offset, head offset),
// with the keep threshold and 1 / (1 - rate): the dropout form.
#define TF_FWD_ARGS                                                         \
  const void *q, const void *k, const void *v, void *out, float *lse,      \
      float *m, int B, int H, int Hkv, int Lq, int Lk, int d, int dtype,   \
      int causal, int q_offset, float scale2, int window, const int *seg,  \
      const int *seed, unsigned threshold, float keep_scale
#define TF_FWD_CALL                                                         \
  q, k, v, out, lse, m, B, H, Hkv, Lq, Lk, d, dtype, causal, q_offset,     \
      scale2, window, seg, seed, threshold, keep_scale

#ifndef TF_KVQ
#define TF_FWD_ENTRY(symbol, x6)                                            \
  int symbol(TF_FWD_ARGS, void* stream) {                                  \
    return fwd_entry<kKvNone>(x6, TF_FWD_CALL, KvqCall{},                  \
                              static_cast<cudaStream_t>(stream));          \
  }

TF_FWD_ENTRY(tf_flash_attention_fwd_tc, false)
TF_FWD_ENTRY(tf_flash_attention_fwd_x6, true)
#else
// The quantized forms of TF_KVQ's granularity (flash_attention_fwd_kvq.cu,
// token: k_scale and v_scale fp32 [B, Hkv, Lk]; flash_attention_fwd_kvqc.cu,
// channel codes: both null, the wrapper folds their scales): k and v int8
// or e4m3 codes (fp8 != 0); dtype as above is q's and out's.
#define TF_FWD_KVQ_ENTRY(symbol, x6)                                        \
  int symbol(TF_FWD_ARGS, const float* k_scale, const float* v_scale,      \
             int fp8, void* stream) {                                      \
    return fwd_entry<TF_KVQ>(x6, TF_FWD_CALL,                              \
                             KvqCall{k_scale, v_scale, fp8},               \
                             static_cast<cudaStream_t>(stream));           \
  }

TF_FWD_KVQ_ENTRY(tf_flash_attention_fwd_tc_kvq, false)
TF_FWD_KVQ_ENTRY(tf_flash_attention_fwd_x6_kvq, true)
#endif

}  // extern "C"
