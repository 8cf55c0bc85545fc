// What the flash-attention backward kernels share: the parameters, lse in
// base 2, the ordered dQ adds' handshake, and the KV-outer bodies, one for
// each dtype, which both the fused single pass (flash_attention_bwd.cu, with
// dQ) and the dK/dV pass of the two-pass form
// (flash_attention_bwd_two_pass.cu, without dQ) run: kv_outer_tc_body (bf16,
// one bf16 product a product) and kv_outer_x6_body (fp32, six bf16 products
// a product), as tpu_flash/kernels/flash_attention.py shares
// _bwd_kv_outer_body (:1254) between its fused and dK/dV kernels.  Every
// form applies the recompute of _bwd_p_ds (:1107), P = exp2(S2 - lse2) and
// dS = P * (dP - D), to whole accumulator fragments.
//
// Numerics follow the TPU kernels: base-2 softmax with scale * log2(e) folded
// into q; with bf16 inputs the scaled q, P before dV, and dS before dK and dQ
// are rounded to bf16, each product a bf16 x bf16 -> fp32 mma.sync; fp32
// products are six bf16 products of the operands split in three (mma_x6,
// mma.cuh: the TPU's Precision.HIGHEST, never TF32); every sum is fp32.  A
// row whose lse is -inf (it saw no key) gets P = 0, not exp(+inf), so its dS
// and dQ are 0.
//
// Each body has a masked instantiation (kMask: a sliding window and segment
// ids, flash_attention_tc.cuh): the query walk ends at the band's last row
// (query_tiles), steps of query rows are skipped or taken without the
// element mask by rows_live, and under a window the fused pass's ordered
// dQ adds wait at each chunk only for the key tiles that reach it
// (dq_turn).  Each body has a dropout instantiation too (kDrop, with or
// without kMask): P^T is held transposed, keys by query rows, so the keep
// bit of element (key, row) is the hash of (row, key), the forward's; dP^T
// is scaled by it before D is taken off, and dV takes P^T keep / (1 -
// rate), as _bwd_finish (:1093-1105) does.  And each has quantized
// instantiations (kQuant, flash_attention_tc.cuh): the block's K and V
// codes arrive once and are turned into its bf16 tiles (the fp32 body: one
// plane each), token scales multiply S^T and dP^T by key in registers
// (_bwd_s2_dp, :1014-1066), and the fused pass's dQ takes dS^T times K's
// scales (:1370-1382); dK and dV are formed as without quantization
// (straight-through).  In the fp32 body a product with codes as an operand
// takes three bf16 products (S^T, dP^T, dQ), dK and dV six.
//
// kernels/common.py hashes every .cuh into each library's name, so an edit
// here rebuilds every kernel that includes it.

#pragma once

#include <math.h>

#include <type_traits>

#include "flash_attention_tc.cuh"

namespace {

constexpr float kBwdLog2e = 1.4426950408889634f;

struct BwdParams {
  const void* q;       // [B, H, Lq, D]
  const void* k;       // [B, Hkv, Lk, D]
  const void* v;
  const void* dout;    // [B, H, Lq, D]
  const float* lse;    // [B, H, Lq], natural-log units
  const float* delta;  // [B, H, Lq]: rowsum(dO * O) - dlse
  void* dq;            // fused: fp32 [B, H, Lq, D] zeroed by the caller;
                       // dQ pass: [B, H, Lq, D] in the input dtype
  void* dk;            // [B, Hkv, Lk, D], the input dtype (dK/dV and fused)
  void* dv;
  int B, H, Hkv, Lq, Lk, q_offset, causal;
  float scale, scale2;  // softmax scale, and scale * log2(e)
  int* dq_order;       // fused: int32 [B * H, ceil(Lq / chunk)] zeroed by
                       // the caller, the dQ adds made to each query chunk
                       // (the form's tile of query rows)
};

// The masked forms' parameters (flash_attention_tc.cuh).
struct MaskedBwdParams : BwdParams {
  int window;          // keys > i + q_offset - window; kNoBand for none
  const int* seg;      // [B, L] segment ids, or null
};

// The parameters of a form: masked or not, with dropout's or without,
// with quantized K/V or without (flash_attention_tc.cuh).
template <bool kMask, bool kDrop = false, int kQuant = kKvNone>
using BwdParamsOf = QuantOf<
    std::conditional_t<
        kDrop,
        Dropped<std::conditional_t<kMask, MaskedBwdParams, BwdParams>>,
        std::conditional_t<kMask, MaskedBwdParams, BwdParams>>,
    kQuant>;

// The KV-outer bodies' query tiles of kTile rows from q_start, to the last
// row that sees the block's keys from k0 (the masked forms: the band's
// end, which rises with the key tile).
template <bool kMask, int kTile, typename Prm>
__device__ __forceinline__ int query_tiles(const Prm& p, int q_start,
                                           int k0) {
  if constexpr (kMask) {
    const int last = (int)min((long long)p.Lq - 1,
                              (long long)k0 + kTcBlock - 1 + p.window - 1 -
                                  p.q_offset);
    return q_start <= last ? (last - q_start) / kTile + 1 : 0;
  } else {
    return q_start < p.Lq ? (p.Lq - q_start + kTile - 1) / kTile : 0;
  }
}

// The masked fused kernels' ordered dQ adds: the adds that key tile `tile`
// waits for at the query chunk from row i0.  Those are the key tiles below
// it that reach the chunk: every tile below it without a window (the
// unmasked forms wait for `tile`); under one, those from the first whose
// band reaches row i0 (the band's end rises with the tile, and the causal
// limit only adds tiles above), so the wait is tile - that first tile's
// index, and the adds stay in key-tile order.
template <typename Prm>
__device__ __forceinline__ int dq_turn(const Prm& p, int tile, int i0) {
  const long long x = (long long)i0 + p.q_offset - p.window - (kTcBlock - 2);
  return tile - (x > 0 ? (int)((x + kTcBlock - 1) / kTcBlock) : 0);
}

// The masked forms' test of a step of NQ query rows from r0 against the
// warp's keys kw .. kw + 15: false where no pair is visible (every row is
// past the band of the warp's last key, or the rows' segment ids share no
// value with the keys'); else full is cleared where some pair is not.
template <int NQ, typename Prm>
__device__ __forceinline__ bool rows_live(const Prm& p,
                                          const volatile MaskSmem* ms,
                                          int r0, int kw, int warp, int lane,
                                          bool& full) {
  if (r0 > kw + 15 + p.window - 1 - p.q_offset) return false;
  full = full && kw > r0 + NQ - 1 + p.q_offset - p.window;
  return !p.seg || seg_step_live<NQ>(ms, p.Lq, r0, warp, lane, full);
}

// The masked forms' element mask of a step's S^T (rows the thread's two
// keys, columns query rows from r0): -inf where the lengths, the causal
// limit, the band or the segments hide the key, so that P^T is 0 there.
template <int NQ, typename Prm>
__device__ __forceinline__ void mask_scores_t(float (&s)[NQ / 8][4],
                                              const Prm& p,
                                              const volatile MaskSmem* ms,
                                              int r0, int kw, int warp,
                                              int lane) {
  SegVals<NQ> qs{};
  int own[2] = {0, 0};
  if (p.seg) {
    qs = seg_vals<NQ>(ms->seg, p.Lq, r0, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      own[h] = ms->own[warp * 16 + (lane >> 2) + 8 * h];
  }
#pragma unroll
  for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int off = 2 * (lane & 3) + (e & 1);
      const int i = r0 + 8 * j + off;
      const int key = kw + (lane >> 2) + 8 * (e >> 1);
      const int qseg = p.seg ? seg_at(qs, 8 * j, off) : 0;
      if (i >= p.Lq || key >= p.Lk || (p.causal && key > i + p.q_offset) ||
          key <= i + p.q_offset - p.window ||
          (p.seg && qseg != own[e >> 1]))
        s[j][e] = -INFINITY;
    }
}

// lse in base 2; +inf for a row that saw no key, so that its P is 0.
__device__ __forceinline__ float bwd_lse2(float lse) {
  return lse == -INFINITY ? INFINITY : lse * kBwdLog2e;
}

// A counter read with acquire semantics at the scope of the whole card, and
// written after a fence that releases what the block wrote before its last
// __syncthreads: the handshake of the ordered dQ adds below.
__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("fence.acq_rel.gpu;\n\tst.relaxed.gpu.global.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// Returns to every thread of the block once the chunk's counter has counted
// `tile` adds (the key tiles below this one).
__device__ __forceinline__ void await_turn(const int* order, int tile) {
  if (threadIdx.x == 0)
    for (long long spins = 0; load_acquire(order) < tile; ++spins) {
      // an add that never comes (seconds): fail the launch, not hang
      if (spins > (1ll << 26)) __trap();
      __nanosleep(32);
    }
  __syncthreads();
}

// --- the KV-outer body on the tensor cores (bf16) ---------------------------
//
// Every product an mma.sync (the TPU kernels feed their MXU the scaled q, P
// and dS rounded to bf16 with fp32 sums, which is exactly a bf16 x bf16 ->
// fp32 product): one block of 4 warps per (batch * KV head, tile of 64
// keys), each warp owning 16 keys, whose k and v rows are its A fragments.
// The block walks the query rows that can see its keys (the causal limit
// sets the first one, so dead tiles are never loaded), for each query head
// of the GQA group.  They come in tiles of 64 through kStages shared-memory
// stages (q, q * scale2 and dO in bf16, lse2 and D in fp32), each thread's
// cp.async pieces for tile t + kStages - 1 issued before tile t is computed.
// A warp computes S^T = K (q scale2)^T and dP^T = V dO^T for NQ query rows
// at a time into m16n8 accumulators (rows keys, columns query rows, so lse2
// and D are read by column), turns them into P^T = exp2(S^T - lse2) and
// dS^T = P^T (dP^T - D) in place (the element mask only in steps that cross
// the causal diagonal or the ragged end of Lq or Lk, a warp-uniform test),
// and feeds them, packed to bf16 pairs, as the A fragments of dV += P^T dO
// and dK += dS^T q (an m16n8 C tile is half an m16n8k16 A tile).  dK and dV
// are summed over the GQA group in fp32 and written once, scale * dK and dV
// in bf16.
//
// With kDQ (the fused pass) each warp also writes its dS^T [16 keys, 64
// rows] in bf16 to shared memory; after a __syncthreads each warp forms dQ
// of 16 of the tile's query rows, dS [16, 64 keys] . K [64 keys, D], its A
// fragments read from dS^T by ldmatrix.trans and its B fragments from the
// block's k, and adds it to the fp32 workspace in a fixed order, the tile
// of 64 query rows being the chunk:
//   * the blocks of a (batch * query head) that reach a chunk add their
//     parts in the order of their key tiles, each after waiting on the
//     chunk's counter in dq_order (acquire, await_turn) to count the tiles
//     below it, then bumping it (release).  Chunks start at multiples of
//     the tile in every block (rows before a key tile's causal limit see
//     none of its keys and add 0), so the blocks agree on what a chunk is;
//   * the block walks its query tiles from the last down, each for every
//     head of the group, so that every key tile reaches a given chunk after
//     the same number of chunks: the tiles of a head move in step.
// A warp adds its rows as
// float4 atomic adds (reductions at L2; lanes t and t ^ 1 trade halves of
// their C fragments first) that nothing waits on: the block releases the
// chunk one tile later, after the next tile's products, when the adds have
// long been made, so neither their round trip nor the release's fence
// sits on its path.  The order of the adds to every element is still the
// order of the key tiles, so two calls give the same bits.
//
// The grid is key-tile major: blockIdx.y is the key tile and blockIdx.x the
// batch * KV head, so blocks are dispatched tile by tile across every head,
// the heavy low tiles first.  Key tile t of a head then starts after tile
// t - 1 of that head has started (so it waits only on blocks dispatched
// before it, and cannot deadlock), and, past the first wave, after it has
// moved on: in head-major order all of a head's tiles start on the same
// chunk and wait on one another while holding their SMs.

constexpr int kDsTPitch = kTcTile + 8;   // bf16 row pitch of dS^T [64][72]

template <int D>
__host__ __device__ constexpr int kv_tc_stage_bytes() {
  // q, q * scale2 and dO tiles; lse2 and D, 64 floats each
  return 3 * TcShape<D>::kTileBytes + 2 * kTcTile * 4;
}

template <int D, bool kDQ, int kQuant = kKvNone>
__host__ __device__ constexpr int kv_outer_tc_smem_bytes() {
  // k and v; the stages; with dQ the tile's dS^T; with token scales the
  // block's keys' k and v scales
  return 2 * TcShape<D>::kTileBytes +
         TcShape<D>::kStages * kv_tc_stage_bytes<D>() +
         (kDQ ? kTcBlock * kDsTPitch * 2 : 0) +
         (kQuant == kKvToken ? 2 * kTcBlock * 4 : 0);
}

// The token scales of a KV-outer body's two keys of this thread (rows
// lane / 4 and lane / 4 + 8 of the warp's 16), read afresh from the
// block's scales sc [64].
__device__ __forceinline__ void key_scales(float (&x)[2],
                                           const volatile float* sc,
                                           int warp, int lane) {
  x[0] = sc[warp * 16 + (lane >> 2)];
  x[1] = sc[warp * 16 + (lane >> 2) + 8];
}

// A warp's dS^T accumulators over N query rows (zeros where c is null) as
// bf16 pairs into its 16 rows of dS^T, columns col0 .. col0 + N - 1.
template <int N>
__device__ __forceinline__ void store_ds_t(bf16* dst, const float (*c)[4],
                                           int row0, int col0, int lane) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(
          dst + (row0 + (lane >> 2) + 8 * h) * kDsTPitch + col0 + 8 * j +
          2 * (lane & 3)) =
          c ? bf16_pair_rn(c[j][2 * h], c[j][2 * h + 1]) : 0u;
}

// store_ds_t of dS^T times its keys' k scales x (each product rounded to
// fp32, then to bf16): the dQ operand of the token-scaled forms.
template <int N>
__device__ __forceinline__ void store_ds_t_scaled(bf16* dst,
                                                  const float (*c)[4],
                                                  const float (&x)[2],
                                                  int row0, int col0,
                                                  int lane) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(
          dst + (row0 + (lane >> 2) + 8 * h) * kDsTPitch + col0 + 8 * j +
          2 * (lane & 3)) = bf16_pair_rn(__fmul_rn(c[j][2 * h], x[h]),
                                         __fmul_rn(c[j][2 * h + 1], x[h]));
}

template <int D, bool kDQ, bool kMask, bool kDrop, int kQuant>
__device__ __forceinline__ void kv_outer_tc_body(
    const BwdParamsOf<kMask, kDrop, kQuant>& p) {
  using S = TcShape<D>;
  constexpr bool kQ = kQuant != kKvNone;
  // query rows of S^T a warp holds at once: with dQ, 32 (at 64, d = 64
  // spills); the dropout forms at d = 128 16, or they spill
  constexpr int P = S::P, kStages = S::kStages;
  constexpr int NQ = kDrop && D > 64 ? 16 : kDQ ? 32 : S::kStep;
  extern __shared__ uint4 tc_smem[];
  bf16* ks = reinterpret_cast<bf16*>(tc_smem);   // [64][P] k
  bf16* vs = ks + kTcBlock * P;                   // [64][P] v
  char* ring = reinterpret_cast<char*>(vs + kTcBlock * P);
  // stage st: q, q * scale2, dO [64][P] bf16, then lse2 and D [64] fp32
  auto stage_q = [&](int st, int which) {
    return reinterpret_cast<bf16*>(ring + st * kv_tc_stage_bytes<D>() +
                                   which * S::kTileBytes);
  };
  auto stage_f = [&](int st, int which) {
    return reinterpret_cast<float*>(ring + st * kv_tc_stage_bytes<D>() +
                                    3 * S::kTileBytes + which * kTcTile * 4);
  };
  // kDQ: the tile's dS^T [64 keys][kDsTPitch]
  bf16* dst = reinterpret_cast<bf16*>(ring + kStages * kv_tc_stage_bytes<D>());
  // kKvToken: the block's keys' k scales, then v scales [64], after dS^T
  [[maybe_unused]] float* kvs = reinterpret_cast<float*>(
      ring + kStages * kv_tc_stage_bytes<D>() +
      (kDQ ? kTcBlock * kDsTPitch * 2 : 0));
  [[maybe_unused]] const volatile float* kvs_v = kvs;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile = blockIdx.y;
  const int k0 = tile * kTcBlock;
  const int bhk = blockIdx.x, b = bhk / p.Hkv, hk = bhk % p.Hkv;
  const int g = p.H / p.Hkv;
  const size_t kv_rows = ((size_t)b * p.Hkv + hk) * p.Lk;
  const int kw = k0 + warp * 16;   // the warp's first key

  // The first query row that can see key k0 (fused: rounded down to a
  // tile's start, so that every block's tiles are the same chunks), and
  // the tiles of each head.
  const int first = p.causal ? max(0, k0 - p.q_offset) : 0;
  const int q_start = kDQ ? first - first % kTcTile : first;
  const int nt = query_tiles<kMask, kTcTile>(p, q_start, k0);
  const int tiles = g * nt;
  // kMask: the mask's view of the block's keys after the form's shared
  // memory
  [[maybe_unused]] const volatile MaskSmem* ms = nullptr;
  if constexpr (kMask)
    ms = mask_setup(reinterpret_cast<char*>(tc_smem) +
                        kv_outer_tc_smem_bytes<D, kDQ, kQuant>(),
                    p.seg, b, p.Lk, k0, tid);
  // kDrop: the hash's terms of the block's keys after the mask's view (the
  // batch's and head's terms are taken afresh each step: the head changes
  // with the tile under GQA)
  [[maybe_unused]] volatile DropSmem* ds = nullptr;
  if constexpr (kDrop)
    ds = drop_setup(reinterpret_cast<char*>(tc_smem) +
                        kv_outer_tc_smem_bytes<D, kDQ, kQuant>() +
                        (kMask ? kMaskSmemBytes : 0),
                    kDropCol, 0u, k0, tid);

  // kQ: the block's codes land in the ring's last stage, which the loop
  // fills first, and its token scales in kvs
  [[maybe_unused]] uint8_t* codes = reinterpret_cast<uint8_t*>(
      ring + (kStages - 1) * kv_tc_stage_bytes<D>());
  if constexpr (kQ) {
    load_codes<D, kTcBlock>(codes, p.k, kv_rows, k0, p.Lk, tid);
    load_codes<D, kTcBlock>(codes + kTcBlock * D, p.v, kv_rows, k0, p.Lk,
                            tid);
    if constexpr (kQuant == kKvToken)
      load_kv_scales<kTcBlock>(kvs, kvs + kTcBlock, p.k_scale, p.v_scale,
                               kv_rows, k0, p.Lk, tid);
  } else {
    load_tile<D>(ks, p.k, kv_rows, k0, p.Lk, tid);
    load_tile<D>(vs, p.v, kv_rows, k0, p.Lk, tid);
  }
  cp_async_commit();

  // tile it: query rows from tile_i0(it) of head tile_head(it) of the
  // group, whose row 0 is row tile_rows(it) of q, dO, lse and D.  The
  // dK/dV pass walks each head's tiles upward in turn; the fused pass walks
  // the tiles from the last down, each for every head, so that the key
  // tiles of a head reach a chunk in step.
  auto tile_i0 = [&](int it) {
    return q_start + (kDQ ? nt - 1 - it / g : it % nt) * kTcTile;
  };
  auto tile_head = [&](int it) { return kDQ ? it % g : it / nt; };
  auto tile_rows = [&](int it) {
    return ((size_t)b * p.H + hk * g + tile_head(it)) * p.Lq;
  };
  auto load_stage = [&](int st, int it) {
    const int i0 = tile_i0(it);
    const size_t rows = tile_rows(it);
    load_tile<D>(stage_q(st, 0), p.q, rows, i0, p.Lq, tid);
    load_tile<D>(stage_q(st, 2), p.dout, rows, i0, p.Lq, tid);
    const int r = tid % kTcTile, i = i0 + r;
    const float* src = tid < kTcTile ? p.lse : p.delta;
    cp_async4(stage_f(st, tid / kTcTile) + r, src + rows + (i < p.Lq ? i : 0),
              i < p.Lq);
    cp_async_commit();
  };
  // after the stage has landed: this thread's q pieces scaled, its lse in
  // base 2 (+inf past Lq, so that P is 0 there)
  auto convert = [&](int st, int it) {
    const int i0 = tile_i0(it);
    scale_tile<D>(stage_q(st, 1), stage_q(st, 0), p.scale2, tid);
    if (tid < kTcTile) {
      float* l2 = stage_f(st, 0) + tid;
      *l2 = i0 + tid < p.Lq ? bwd_lse2(*l2) : INFINITY;
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) load_stage(s, s);
    else cp_async_commit();
  }
  cp_async_wait<kStages - 2>();   // k, v and the first tile
  if (tiles > 0) convert(0, 0);
  if constexpr (kQ) {   // the codes into k and v in bf16
    __syncthreads();
    convert_codes<D, kTcBlock>(ks, codes, p.fp8, tid);
    convert_codes<D, kTcBlock>(vs, codes + kTcBlock * D, p.fp8, tid);
  }
  __syncthreads();

  uint32_t ka[S::kRegs ? D / 16 : 1][4], va[S::kRegs ? D / 16 : 1][4];
  if constexpr (S::kRegs) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      a_frag<D>(ka[kk], ks, warp * 16, kk, lane);
      a_frag<D>(va[kk], vs, warp * 16, kk, lane);
    }
  }
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  // kDQ: the counter of tile it's chunk (of 64 query rows of its head)
  auto order_of = [&](int it) {
    return p.dq_order +
           ((size_t)b * p.H + hk * g + tile_head(it)) *
               ((p.Lq + kTcTile - 1) / kTcTile) +
           tile_i0(it) / kTcTile;
  };

  for (int it = 0; it < tiles; ++it) {
    const int st = it % kStages;
    if (it + kStages - 1 < tiles) load_stage((it + kStages - 1) % kStages,
                                             it + kStages - 1);
    else cp_async_commit();
    const int i0 = tile_i0(it);
    const bf16* qt = stage_q(st, 0);
    const bf16* qst = stage_q(st, 1);
    const bf16* ot = stage_q(st, 2);
    const float* l2 = stage_f(st, 0);
    const float* dl = stage_f(st, 1);
#pragma unroll
    for (int sub = 0; sub < kTcTile; sub += NQ) {
      const int r0 = i0 + sub;   // the step's first query row
      // every row of the step is past Lq, or sees none of the warp's keys
      if (r0 >= p.Lq || (p.causal && kw > r0 + NQ - 1 + p.q_offset)) {
        if constexpr (kDQ) store_ds_t<NQ>(dst, nullptr, warp * 16, sub, lane);
        continue;
      }
      bool full = r0 + NQ <= p.Lq && !(p.causal && kw + 15 > r0 + p.q_offset);
      if constexpr (kMask)
        if (!rows_live<NQ>(p, ms, r0, kw, warp, lane, full)) {
          if constexpr (kDQ)
            store_ds_t<NQ>(dst, nullptr, warp * 16, sub, lane);
          continue;
        }
      if constexpr (kDrop)
        drop_step<NQ>(ds, drop_bh(p.seed, b, hk * g + tile_head(it)), r0,
                      kDropRow, p.threshold, tid);
      // S^T = K (q scale2)^T and dP^T = V dO^T: rows keys, columns query rows
      float s[NQ / 8][4], dp[NQ / 8][4];
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t kf[4], vf[4];
        const uint32_t* ak = kf;
        const uint32_t* av = vf;
        if constexpr (S::kRegs) {
          ak = ka[kk];
          av = va[kk];
        } else {
          a_frag<D>(kf, ks, warp * 16, kk, lane);
          a_frag<D>(vf, vs, warp * 16, kk, lane);
        }
#pragma unroll
        for (int n2 = 0; n2 < NQ / 16; ++n2) {
          uint32_t bq[4], bo[4];
          b_frags_nk<D>(bq, qst, sub + 16 * n2, kk, lane);
          b_frags_nk<D>(bo, ot, sub + 16 * n2, kk, lane);
          mma_bf16(s[2 * n2], ak, bq);
          mma_bf16(s[2 * n2 + 1], ak, bq + 2);
          mma_bf16(dp[2 * n2], av, bo);
          mma_bf16(dp[2 * n2 + 1], av, bo + 2);
        }
      }
      if constexpr (kQuant == kKvToken) {   // by key: S^T ks, dP^T vs
        float x[2];
        key_scales(x, kvs_v, warp, lane);
        scale_rows<NQ>(s, x);
        key_scales(x, kvs_v + kTcBlock, warp, lane);
        scale_rows<NQ>(dp, x);
      }
      // P^T and dS^T in place; column c is query row i0 + c
      if constexpr (kMask)
        if (!full) mask_scores_t<NQ>(s, p, ms, r0, kw, warp, lane);
      [[maybe_unused]] uint32_t bits = 0;
      if constexpr (kDrop) bits = ds->bits[tid];
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j) {
        const int c = sub + 8 * j + 2 * (lane & 3);
        const float2 lse2 = *reinterpret_cast<const float2*>(l2 + c);
        const float2 delta = *reinterpret_cast<const float2*>(dl + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pr = exp2f(s[j][e] - (e & 1 ? lse2.y : lse2.x));
          if constexpr (!kMask) {
            if (!full) {
              const int key = kw + (lane >> 2) + 8 * (e >> 1);
              const int i = i0 + c + (e & 1);
              if (i >= p.Lq || (p.causal && key > i + p.q_offset)) pr = 0.f;
            }
          }
          if constexpr (kDrop) {
            // dV takes P^T keep / (1 - rate); dP^T is scaled by the same
            // before D is taken off (the JAX _bwd_finish)
            const float ks = drop_scale(bits, j, e, p.keep_scale);
            s[j][e] = __fmul_rn(pr, ks);
            dp[j][e] = pr * (__fmul_rn(dp[j][e], ks) -
                             (e & 1 ? delta.y : delta.x));
          } else {
            s[j][e] = pr;
            dp[j][e] = pr * (dp[j][e] - (e & 1 ? delta.y : delta.x));
          }
        }
      }
      if constexpr (kDQ) {
        if constexpr (kQuant == kKvToken) {   // dQ's operand: dS^T ks
          float x[2];
          key_scales(x, kvs_v, warp, lane);
          store_ds_t_scaled<NQ>(dst, dp, x, warp * 16, sub, lane);
        } else {
          store_ds_t<NQ>(dst, dp, warp * 16, sub, lane);
        }
      }
      // dV += P^T dO and dK += dS^T q over the step's query rows
#pragma unroll
      for (int kk = 0; kk < NQ / 16; ++kk) {
        uint32_t pa[4], da[4];
        acc_as_a(pa, s, kk);
        acc_as_a(da, dp, kk);
#pragma unroll
        for (int n2 = 0; n2 < D / 16; ++n2) {
          uint32_t bo[4], bq[4];
          b_frags_kn<D>(bo, ot, sub + 16 * kk, 16 * n2, lane);
          b_frags_kn<D>(bq, qt, sub + 16 * kk, 16 * n2, lane);
          mma_bf16(dv[2 * n2], pa, bo);
          mma_bf16(dv[2 * n2 + 1], pa, bo + 2);
          mma_bf16(dk[2 * n2], da, bq);
          mma_bf16(dk[2 * n2 + 1], da, bq + 2);
        }
      }
    }
    if constexpr (kDQ) {
      // dQ of the warp's 16 rows of the tile, kPiece columns at a time (all
      // of them below d = 128, formed before the wait; 32 at d = 128,
      // formed in turn, where registers are scarce)
      constexpr int kPiece = D <= 64 ? D : 32;
      const size_t rows = tile_rows(it);
      float dq[kPiece / 8][4];
      auto form = [&](int n0) {
#pragma unroll
        for (int j = 0; j < kPiece / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kTcBlock / 16; ++kk) {
          uint32_t da[4];
          a_frag_t(da, dst, kDsTPitch, 16 * kk, warp * 16, lane);
#pragma unroll
          for (int n2 = 0; n2 < kPiece / 16; ++n2) {
            uint32_t bk[4];
            b_frags_kn<D>(bk, ks, 16 * kk, n0 + 16 * n2, lane);
            mma_bf16(dq[2 * n2], da, bk);
            mma_bf16(dq[2 * n2 + 1], da, bk + 2);
          }
        }
      };
      // lanes t and t ^ 1 trade halves: even t then holds four columns of
      // row lane / 4, odd t four columns of row lane / 4 + 8
      const bool odd = lane & 1;
      const int r = i0 + warp * 16 + (lane >> 2) + (odd ? 8 : 0);
      float* dqg =
          static_cast<float*>(p.dq) + (rows + r) * D + 2 * (lane & 2);
      auto add = [&](int n0) {
#pragma unroll
        for (int j = 0; j < kPiece / 8; ++j) {
          const float x =
              __shfl_xor_sync(kFull, odd ? dq[j][0] : dq[j][2], 1);
          const float y =
              __shfl_xor_sync(kFull, odd ? dq[j][1] : dq[j][3], 1);
          const float4 part =
              odd ? make_float4(x, y, dq[j][2], dq[j][3])
                  : make_float4(dq[j][0], dq[j][1], x, y);
          if (r < p.Lq)
            atomicAdd(reinterpret_cast<float4*>(dqg + n0 + 8 * j), part);
        }
      };
      __syncthreads();   // the tile's dS^T is whole; the last adds issued
      if constexpr (kMask) {
        if (tid == 0 && it > 0)
          store_release(order_of(it - 1),
                        dq_turn(p, tile, tile_i0(it - 1)) + 1);
      } else {
        if (tid == 0 && it > 0) store_release(order_of(it - 1), tile + 1);
      }
      if constexpr (kPiece == D) form(0);
      // the key tiles below this one that reach this chunk add first: all
      // of them without a window
      if constexpr (kMask)
        await_turn(order_of(it), dq_turn(p, tile, tile_i0(it)));
      else
        await_turn(order_of(it), tile);
#pragma unroll
      for (int n0 = 0; n0 < D; n0 += kPiece) {
        if constexpr (kPiece != D) form(n0);
        add(n0);
      }
      cp_async_wait<kStages - 2>();   // tile it + 1 has landed
      if (it + 1 < tiles) convert((it + 1) % kStages, it + 1);
      __syncthreads();
    } else {
      cp_async_wait<kStages - 2>();   // tile it + 1 has landed
      if (it + 1 < tiles) convert((it + 1) % kStages, it + 1);
      __syncthreads();
    }
  }

  if constexpr (kDQ) {   // after the loop's last __syncthreads
    if constexpr (kMask) {
      if (tid == 0 && tiles > 0)
        store_release(order_of(tiles - 1),
                      dq_turn(p, tile, tile_i0(tiles - 1)) + 1);
    } else {
      if (tid == 0 && tiles > 0) store_release(order_of(tiles - 1), tile + 1);
    }
  }
  store_rows<D>(p.dk, kv_rows, kw, p.Lk, dk, p.scale, lane);
  store_rows<D>(p.dv, kv_rows, kw, p.Lk, dv, 1.f, lane);
}

// Launches kernel<D> over the KV-outer grid of the tensor-core form, key
// tiles along y.
template <int D, bool kDQ, bool kMask, bool kDrop, int kQuant,
          typename Kernel>
cudaError_t launch_kv_outer_tc(Kernel kernel,
                               const BwdParamsOf<kMask, kDrop, kQuant>& p,
                               cudaStream_t stream) {
  constexpr int kSmem = kv_outer_tc_smem_bytes<D, kDQ, kQuant>() +
                        (kMask ? kMaskSmemBytes : 0) +
                        (kDrop ? kDropSmemBytes : 0);
  const int tiles = (p.Lk + kTcBlock - 1) / kTcBlock;
  if (tiles > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.Hkv, tiles);
  kernel<<<grid, kTcThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

// --- the KV-outer body in fp32 on the tensor cores (six bf16 products) ----
//
// kv_outer_tc_body's block, grid and, with kDQ, order of dQ adds, with
// every product mma_x6 (mma.cuh), as the TPU runs fp32 dots at
// Precision.HIGHEST.  Shared memory cannot hold three planes of everything
// the bf16 form keeps in bf16 (at d = 64: k, v, and per stage q,
// q * scale2 and dO, plus dS^T, tripled, is over 227 KB), so:
//   * k and v arrive in fp32 once and are split into three planes each,
//     from which every warp reads its A fragments (k also B fragments of
//     dQ);
//   * a tile of kQT query rows (q, dO, lse and D) arrives in fp32 by
//     cp.async into one stage while the tile before it is computed, and is
//     split once by the whole block into the planes of q * scale2 and dO;
//     dK sums dS^T (q * scale2) and is scaled by scale / scale2 at the end,
//     so that q needs one set of planes;
//   * with kDQ, dS^T goes to shared memory as three planes for dQ = dS K.
// P and dS stay fp32 in the accumulators and are split in registers into
// the A fragments of dV and dK, whose sums over every query row the block
// sees take mma_x6_add (each step's products summed apart, then added
// rounded to nearest); S^T, dP^T (over the head dim) and a tile's dQ (over
// 64 keys) accumulate in place.  The block walks its query tiles from the
// last down, each for every head of the group.  With dQ, kQT is 64 below
// d = 128 and 32 at 128, the chunk of the ordered dQ adds
// (kernels/flash_attention.py _dq_chunk), and one block fits an SM (170 KB
// of shared memory at d = 64, 202 KB at 128); without it kQT is 32, and
// two blocks fit an SM below d = 128 (106 KB at d = 64; 202 KB at 128).

template <int D, bool kDQ>
struct BwdX6 {
  // query rows a tile, and rows of S^T a warp holds: without dQ 32 and
  // 16, so that two blocks fit an SM below d = 128 (and no spill at 64)
  static constexpr int kQT = D <= 64 && kDQ ? 64 : 32;
  static constexpr int NQ = D <= 64 && kDQ ? 32 : 16;
  static constexpr int P = TcShape<D>::P;
  static constexpr int F = kF32Pitch<D>;
  static constexpr int kDsP = kQT + 8;            // dS^T's bf16 pitch
  static constexpr int kKPlane = kTcBlock * P;    // elements of a plane
  static constexpr int kQPlane = kQT * P;
  static constexpr int kDsPlane = kTcBlock * kDsP;
  // dQ of a tile: kRowGroups warps along its rows, each forming kDqCols
  // columns of 16 rows
  static constexpr int kRowGroups = kQT / 16;
  static constexpr int kDqCols = D * kRowGroups / 4;
  // At d = 128 dK and dV hold 128 registers a thread: there the walk over
  // a tile's steps and the products' loops over the contraction are not
  // unrolled, and dQ is formed 16 columns at a time, or ptxas spills
  static constexpr int kUnroll = D <= 64 ? 8 : 1;
  static constexpr int kDqPiece = D <= 64 ? kDqCols : 16;
  // byte offsets: k and v planes, then q * scale2 and dO planes, with kDQ
  // dS^T planes, the fp32 stage (q, dO [kQT][F], lse, D [kQT]), and lse2
  // and D of the tile in the planes.  k and v in fp32 arrive over the
  // planes of q, dO and dS^T, and past them where those are smaller.
  static constexpr int kQdOff = 6 * kKPlane * 2;
  static constexpr int kDsOff = kQdOff + 6 * kQPlane * 2;
  static constexpr int kPlanesEnd = kDsOff + (kDQ ? 3 * kDsPlane * 2 : 0);
  static constexpr int kKvEnd = kQdOff + 2 * kTcBlock * F * 4;
  static constexpr int kStageOff = kPlanesEnd > kKvEnd ? kPlanesEnd : kKvEnd;
  static constexpr int kCurOff = kStageOff + (2 * kQT * F + 2 * kQT) * 4;
  static constexpr int kSmem = kCurOff + 2 * kQT * 4;
  static_assert(kSmem <= 232448, "shared memory");
};

// The quantized fp32 KV-outer forms at d = 128, and the fused channel
// forms at d = 64, split D over two blocks (grid z): each forms dK and dV
// of half the columns (D / 4 accumulator registers fewer), both form S^T
// and dP^T, and the first alone the fused pass's dQ.  With all of D a
// block, those forms hold 255 registers and spilled 4-92 bytes in each of
// the 12 layouts tried (the forms without quantization fit 255 with none).
template <int D, bool kDQ, int kQuant>
__host__ __device__ constexpr bool x6_split_d() {
  return kQuant != kKvNone &&
         (D > 64 || (D == 64 && kDQ && kQuant == kKvChannel));
}

// A warp's [16, N] fp32 accumulators times scale into columns c0 .. c0 +
// N - 1 of rows row0 .. row0 + 15 (after row base) of a [rows, D] array;
// rows at or past n are skipped.
template <int D, int N>
__device__ __forceinline__ void store_cols_f32(void* out, size_t base,
                                               int row0, int n,
                                               const float (&acc)[N / 8][4],
                                               float scale, int c0,
                                               int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + (lane >> 2) + 8 * h;
    if (r >= n) continue;
    float* dst = static_cast<float*>(out) + (base + r) * D + c0 +
                 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(scale * acc[j][2 * h], scale * acc[j][2 * h + 1]);
  }
}

// A warp's dS^T accumulators over N query rows (zeros where c is null),
// split in three, into its 16 rows of the planes of dS^T [64][kDsP],
// columns col0 .. col0 + N - 1; with kScaled, each of its two rows (keys)
// times its k scale x[h] first (rounded to fp32: the token-scaled forms'
// dQ operand).
template <int N, int kDsP, bool kScaled = false>
__device__ __forceinline__ void store_ds_t_x6(bf16* dst, int plane,
                                              const float (*c)[4], int row0,
                                              int col0, int lane,
                                              const float* x = nullptr) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t pieces[3] = {0u, 0u, 0u};
      if constexpr (kScaled) {
        if (c) split3_pair(__fmul_rn(c[j][2 * h], x[h]),
                           __fmul_rn(c[j][2 * h + 1], x[h]), pieces[0],
                           pieces[1], pieces[2]);
      } else {
        if (c) split3_pair(c[j][2 * h], c[j][2 * h + 1], pieces[0],
                           pieces[1], pieces[2]);
      }
      bf16* at = dst + (row0 + (lane >> 2) + 8 * h) * kDsP + col0 + 8 * j +
                 2 * (lane & 3);
#pragma unroll
      for (int pl = 0; pl < 3; ++pl)
        *reinterpret_cast<uint32_t*>(at + pl * plane) = pieces[pl];
    }
}

// p by value: ptxas then allocates the fused kernel's registers without a
// spill (taken by reference, it spilled 8 bytes at d = 64 and 4 at 32).
// The quantized forms take the same p (the kernel's parameters less the
// quantization's) and the quantization apart, q, whose fields are read
// before the walk only (in p, 20 more bytes held across it spilled).
// They hold K's and V's codes as one plane each (a code is one exact
// bf16), three bf16 products a product with codes; some forms split D
// over two blocks (x6_split_d).
template <int D, bool kDQ, bool kMask, bool kDrop, int kQuant>
__device__ __forceinline__ void kv_outer_x6_body(
    const BwdParamsOf<kMask, kDrop> p, const KvqCall q) {
  using X = BwdX6<D, kDQ>;
  constexpr bool kQ = kQuant != kKvNone;
  // the columns of dK and dV this block forms (x6_split_d)
  constexpr bool kSplitD = x6_split_d<D, kDQ, kQuant>();
  constexpr int DC = kSplitD ? D / 2 : D;
  [[maybe_unused]] const int c0 = kSplitD ? blockIdx.z * DC : 0;
  // the fused dropout and quantized forms at d = 64 hold 16 query rows of
  // S^T a step, not 32: the form without either holds 255 registers
  constexpr int kQT = X::kQT,
                NQ = (kDrop || kQ) && D <= 64 && kDQ ? 16 : X::NQ;
  constexpr int kUnrollSteps = D <= 64 ? kQT / NQ : 1;
  constexpr int F = X::F;
  constexpr int kKPlane = X::kKPlane, kQPlane = X::kQPlane;
  extern __shared__ uint4 x6_smem[];
  char* sm = reinterpret_cast<char*>(x6_smem);
  bf16* kpl = reinterpret_cast<bf16*>(sm);       // k's planes [64][P] x 3
  bf16* vpl = kpl + 3 * kKPlane;                 // v's
  bf16* qpl = reinterpret_cast<bf16*>(sm + X::kQdOff);   // q * scale2's
  bf16* opl = qpl + 3 * kQPlane;                 // dO's [kQT][P] x 3
  bf16* dspl = reinterpret_cast<bf16*>(sm + X::kDsOff);  // kDQ: dS^T's
  float* qst = reinterpret_cast<float*>(sm + X::kStageOff);  // q [kQT][F]
  float* ost = qst + kQT * F;                    // dO
  float* lst = ost + kQT * F;                    // lse, then D [kQT]
  float* cur = reinterpret_cast<float*>(sm + X::kCurOff);  // lse2, then D
  float* kvst = reinterpret_cast<float*>(sm + X::kQdOff);  // k, v [64][F]
  // kQ: k's and v's codes arrive at kvst and become one plane each (the
  // first); kKvToken: the block's keys' k and v scales [64] in k's second
  [[maybe_unused]] float* kvs = reinterpret_cast<float*>(kpl + kKPlane);
  [[maybe_unused]] const volatile float* kvs_v = kvs;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile = blockIdx.y;
  const int k0 = tile * kTcBlock;
  const int bhk = blockIdx.x, b = bhk / p.Hkv, hk = bhk % p.Hkv;
  const int g = p.H / p.Hkv;
  const size_t kv_rows = ((size_t)b * p.Hkv + hk) * p.Lk;
  const int kw = k0 + warp * 16;   // the warp's first key

  // The first query row that can see key k0 (with kDQ rounded down to a
  // tile's start, so that every block's tiles are the same chunks), and
  // the tiles of each head, walked from the last down, each for every head.
  const int first = p.causal ? max(0, k0 - p.q_offset) : 0;
  const int q_start = kDQ ? first - first % kQT : first;
  const int nt = query_tiles<kMask, kQT>(p, q_start, k0);
  const int tiles = g * nt;
  // kMask: the mask's view of the block's keys after the form's shared
  // memory
  [[maybe_unused]] const volatile MaskSmem* ms = nullptr;
  if constexpr (kMask)
    ms = mask_setup(sm + X::kSmem, p.seg, b, p.Lk, k0, tid);
  // kDrop: the hash's terms of the block's keys after the mask's view (the
  // batch's and head's terms are taken afresh each step)
  [[maybe_unused]] volatile DropSmem* ds = nullptr;
  if constexpr (kDrop)
    ds = drop_setup(sm + X::kSmem + (kMask ? kMaskSmemBytes : 0), kDropCol,
                    0u, k0, tid);
  auto tile_i0 = [&](int it) { return q_start + (nt - 1 - it / g) * kQT; };
  auto tile_rows = [&](int it) {
    return ((size_t)b * p.H + hk * g + it % g) * p.Lq;
  };
  // kDQ: the counter of tile it's chunk (kQT query rows of its head)
  [[maybe_unused]] auto order_of = [&](int it) {
    return p.dq_order + ((size_t)b * p.H + hk * g + it % g) *
                            ((p.Lq + kQT - 1) / kQT) +
           tile_i0(it) / kQT;
  };
  auto load_stage = [&](int it) {
    const int i0 = tile_i0(it);
    const size_t rows = tile_rows(it);
    load_tile_f32<D, kQT>(qst, p.q, rows, i0, p.Lq, tid);
    load_tile_f32<D, kQT>(ost, p.dout, rows, i0, p.Lq, tid);
    if (tid < 2 * kQT) {
      const int i = i0 + tid % kQT;
      cp_async4(lst + tid, (tid < kQT ? p.lse : p.delta) + rows +
                               (i < p.Lq ? i : 0),
                i < p.Lq);
    }
  };
  // the landed stage into the planes, and its lse in base 2 (+inf past Lq,
  // so that P is 0 there) and D beside them
  auto split_stage = [&](int it) {
    split_tile<D, kQT>(qpl, kQPlane, qst, p.scale2, tid);
    split_tile<D, kQT>(opl, kQPlane, ost, 1.f, tid);
    if (tid < 2 * kQT)
      cur[tid] = tid >= kQT ? lst[tid]
                 : tile_i0(it) + tid < p.Lq ? bwd_lse2(lst[tid])
                                            : INFINITY;
  };

  // k, v and the first tile
  if constexpr (kQ) {
    uint8_t* c = reinterpret_cast<uint8_t*>(kvst);
    load_codes<D, kTcBlock>(c, p.k, kv_rows, k0, p.Lk, tid);
    load_codes<D, kTcBlock>(c + kTcBlock * D, p.v, kv_rows, k0, p.Lk, tid);
    if constexpr (kQuant == kKvToken)
      load_kv_scales<kTcBlock>(kvs, kvs + kTcBlock, q.k_scale, q.v_scale,
                               kv_rows, k0, p.Lk, tid);
  } else {
    load_tile_f32<D, kTcBlock>(kvst, p.k, kv_rows, k0, p.Lk, tid);
    load_tile_f32<D, kTcBlock>(kvst + kTcBlock * F, p.v, kv_rows, k0, p.Lk,
                               tid);
  }
  if (tiles > 0) load_stage(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (kQ) {
    const uint8_t* c = reinterpret_cast<const uint8_t*>(kvst);
    convert_codes<D, kTcBlock>(kpl, c, q.fp8, tid);
    convert_codes<D, kTcBlock>(vpl, c + kTcBlock * D, q.fp8, tid);
  } else {
    split_tile<D, kTcBlock>(kpl, kKPlane, kvst, 1.f, tid);
    split_tile<D, kTcBlock>(vpl, kKPlane, kvst + kTcBlock * F, 1.f, tid);
  }
  __syncthreads();   // k and v in fp32 read before their space is reused
  if (tiles > 0) split_stage(0);
  __syncthreads();
  if (tiles > 1) load_stage(1);
  cp_async_commit();

  float dk[DC / 8][4], dv[DC / 8][4];
#pragma unroll
  for (int j = 0; j < DC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  // kDQ: this warp's part of a tile's dQ, rows dq_r .., columns dq_c ..
  [[maybe_unused]] const int dq_r = (warp % X::kRowGroups) * 16;
  [[maybe_unused]] const int dq_c = (warp / X::kRowGroups) * X::kDqCols;

  for (int it = 0; it < tiles; ++it) {
    const int i0 = tile_i0(it);
#pragma unroll (kUnrollSteps)
    for (int sub = 0; sub < kQT; sub += NQ) {
      const int r0 = i0 + sub;   // the step's first query row
      // every row of the step is past Lq, or sees none of the warp's keys
      if (r0 >= p.Lq || (p.causal && kw > r0 + NQ - 1 + p.q_offset)) {
        if constexpr (kDQ)
          store_ds_t_x6<NQ, X::kDsP>(dspl, X::kDsPlane, nullptr, warp * 16,
                                     sub, lane);
        continue;
      }
      bool full = kw + 16 <= p.Lk && r0 + NQ <= p.Lq &&
                  !(p.causal && kw + 15 > r0 + p.q_offset);
      if constexpr (kMask)
        if (!rows_live<NQ>(p, ms, r0, kw, warp, lane, full)) {
          if constexpr (kDQ)
            store_ds_t_x6<NQ, X::kDsP>(dspl, X::kDsPlane, nullptr,
                                       warp * 16, sub, lane);
          continue;
        }
      if constexpr (kDrop)
        drop_step<NQ>(ds, drop_bh(p.seed, b, hk * g + it % g), r0, kDropRow,
                      p.threshold, tid);
      // S^T = K (q scale2)^T and dP^T = V dO^T: rows keys, columns query rows
      float s[NQ / 8][4], dp[NQ / 8][4];
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll (X::kUnroll)
      for (int kk = 0; kk < D / 16; ++kk) {
        if constexpr (kQ) {   // the codes: one plane, three
                                     // products, each plane of q * scale2
                                     // read as it is used
          uint32_t ka[4];
          a_frag<D>(ka, kpl, warp * 16, kk, lane);
#pragma unroll
          for (int n2 = 0; n2 < NQ / 16; ++n2)
#pragma unroll
            for (int pl = 2; pl >= 0; --pl) {   // lo, mid, hi: mma_x6's
              uint32_t bq[4];                    // order, its a.mid and
                                                 // a.lo terms 0
              b_frags_nk<D>(bq, qpl + pl * kQPlane, sub + 16 * n2, kk, lane);
              mma_bf16(s[2 * n2], ka, bq);
              mma_bf16(s[2 * n2 + 1], ka, bq + 2);
            }
        } else {
          uint32_t ka[3][4];
#pragma unroll
          for (int pl = 0; pl < 3; ++pl)
            a_frag<D>(ka[pl], kpl + pl * kKPlane, warp * 16, kk, lane);
#pragma unroll
          for (int n2 = 0; n2 < NQ / 16; ++n2) {
            uint32_t bq[3][4];
#pragma unroll
            for (int pl = 0; pl < 3; ++pl)
              b_frags_nk<D>(bq[pl], qpl + pl * kQPlane, sub + 16 * n2, kk,
                            lane);
            mma_x6(s[2 * n2], ka, bq[0], bq[1], bq[2]);
            mma_x6(s[2 * n2 + 1], ka, bq[0] + 2, bq[1] + 2, bq[2] + 2);
          }
        }
      }
#pragma unroll (X::kUnroll)
      for (int kk = 0; kk < D / 16; ++kk) {
        if constexpr (kQ) {
          uint32_t va[4];
          a_frag<D>(va, vpl, warp * 16, kk, lane);
#pragma unroll
          for (int n2 = 0; n2 < NQ / 16; ++n2)
#pragma unroll
            for (int pl = 2; pl >= 0; --pl) {
              uint32_t bo[4];
              b_frags_nk<D>(bo, opl + pl * kQPlane, sub + 16 * n2, kk, lane);
              mma_bf16(dp[2 * n2], va, bo);
              mma_bf16(dp[2 * n2 + 1], va, bo + 2);
            }
        } else {
          uint32_t va[3][4];
#pragma unroll
          for (int pl = 0; pl < 3; ++pl)
            a_frag<D>(va[pl], vpl + pl * kKPlane, warp * 16, kk, lane);
#pragma unroll
          for (int n2 = 0; n2 < NQ / 16; ++n2) {
            uint32_t bo[3][4];
#pragma unroll
            for (int pl = 0; pl < 3; ++pl)
              b_frags_nk<D>(bo[pl], opl + pl * kQPlane, sub + 16 * n2, kk,
                            lane);
            mma_x6(dp[2 * n2], va, bo[0], bo[1], bo[2]);
            mma_x6(dp[2 * n2 + 1], va, bo[0] + 2, bo[1] + 2, bo[2] + 2);
          }
        }
      }
      if constexpr (kQuant == kKvToken) {   // by key: S^T ks, dP^T vs
        float x[2];
        key_scales(x, kvs_v, warp, lane);
        scale_rows<NQ>(s, x);
        key_scales(x, kvs_v + kTcBlock, warp, lane);
        scale_rows<NQ>(dp, x);
      }
      // P^T = exp2(S^T - lse2) and dS^T = P^T (dP^T - D) in place, in fp32;
      // column c is query row i0 + c
      if constexpr (kMask)
        if (!full) mask_scores_t<NQ>(s, p, ms, r0, kw, warp, lane);
      [[maybe_unused]] uint32_t bits = 0;
      if constexpr (kDrop) bits = ds->bits[tid];
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j) {
        const int c = sub + 8 * j + 2 * (lane & 3);
        const float2 lse2 = *reinterpret_cast<const float2*>(cur + c);
        const float2 delta = *reinterpret_cast<const float2*>(cur + kQT + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pr = exp2f(s[j][e] - (e & 1 ? lse2.y : lse2.x));
          if constexpr (!kMask) {
            if (!full) {
              const int key = kw + (lane >> 2) + 8 * (e >> 1);
              const int i = i0 + c + (e & 1);
              if (key >= p.Lk || i >= p.Lq ||
                  (p.causal && key > i + p.q_offset))
                pr = 0.f;
            }
          }
          if constexpr (kDrop) {
            // dV takes P^T keep / (1 - rate); dP^T is scaled by the same
            // before D is taken off (the JAX _bwd_finish)
            float ks;
            if constexpr (D <= 64)
              ks = drop_scale(bits, j, e, p.keep_scale);
            else   // re-read for each element where dK and dV hold 128
                   // registers (held, the masked dK/dV pass spills)
              ks = drop_scale(ds->bits[tid], j, e, p.keep_scale);
            s[j][e] = __fmul_rn(pr, ks);
            dp[j][e] = __fmul_rn(pr, __fmul_rn(dp[j][e], ks) -
                                         (e & 1 ? delta.y : delta.x));
          } else {
            s[j][e] = pr;
            // __fmul_rn: no fused multiply-add into the split
            dp[j][e] =
                __fmul_rn(pr, dp[j][e] - (e & 1 ? delta.y : delta.x));
          }
        }
      }
      if constexpr (kDQ) {
        if constexpr (kQuant == kKvToken) {   // dQ's operand: dS^T ks
          float x[2];
          key_scales(x, kvs_v, warp, lane);
          store_ds_t_x6<NQ, X::kDsP, true>(dspl, X::kDsPlane, dp, warp * 16,
                                           sub, lane, x);
        } else {
          store_ds_t_x6<NQ, X::kDsP>(dspl, X::kDsPlane, dp, warp * 16, sub,
                                     lane);
        }
      }
      // dV += P^T dO and dK += dS^T (q scale2) over the step's query rows
#pragma unroll
      for (int kk = 0; kk < NQ / 16; ++kk) {
        uint32_t pa[3][4];
        acc_as_a_x6(pa, s, kk);
#pragma unroll
        for (int n2 = 0; n2 < DC / 16; ++n2) {
          uint32_t bo[3][4];
#pragma unroll
          for (int pl = 0; pl < 3; ++pl)
            b_frags_kn<D>(bo[pl], opl + pl * kQPlane, sub + 16 * kk,
                          c0 + 16 * n2, lane);
          mma_x6_add(dv[2 * n2], pa, bo[0], bo[1], bo[2]);
          mma_x6_add(dv[2 * n2 + 1], pa, bo[0] + 2, bo[1] + 2, bo[2] + 2);
        }
        uint32_t da[3][4];
        acc_as_a_x6(da, dp, kk);
#pragma unroll
        for (int n2 = 0; n2 < DC / 16; ++n2) {
          uint32_t bq[3][4];
#pragma unroll
          for (int pl = 0; pl < 3; ++pl)
            b_frags_kn<D>(bq[pl], qpl + pl * kQPlane, sub + 16 * kk,
                          c0 + 16 * n2, lane);
          mma_x6_add(dk[2 * n2], da, bq[0], bq[1], bq[2]);
          mma_x6_add(dk[2 * n2 + 1], da, bq[0] + 2, bq[1] + 2, bq[2] + 2);
        }
      }
    }
    cp_async_wait<0>();   // tile it + 1 has landed
    // the planes of tile it are no longer read (with kDQ: dS^T is whole,
    // and the block's dQ adds of tile it - 1 were issued before the last
    // barrier)
    __syncthreads();
    if (kDQ && kSplitD && c0 != 0) {   // D's second half: no dQ
      if (it + 1 < tiles) split_stage(it + 1);
      __syncthreads();   // the planes of tile it + 1 written, the stage read
    } else if constexpr (kDQ) {
      if constexpr (kMask) {
        if (tid == 0 && it > 0)
          store_release(order_of(it - 1),
                        dq_turn(p, tile, tile_i0(it - 1)) + 1);
      } else {
        if (tid == 0 && it > 0) store_release(order_of(it - 1), tile + 1);
      }
      // dQ [kQT, D] = dS [kQT, 64 keys] K [64 keys, D], this warp's part,
      // kPiece columns at a time (all of them below d = 128, formed before
      // the wait; 16 at d = 128, formed in turn after it)
      constexpr int kPiece = X::kDqPiece;
      float dq[kPiece / 8][4];
      auto form = [&](int n0) {
#pragma unroll
        for (int j = 0; j < kPiece / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
#pragma unroll (X::kUnroll)
        for (int kk = 0; kk < kTcBlock / 16; ++kk) {
          uint32_t da[3][4];
#pragma unroll
          for (int pl = 0; pl < 3; ++pl)
            a_frag_t(da[pl], dspl + pl * X::kDsPlane, X::kDsP, 16 * kk, dq_r,
                     lane);
#pragma unroll
          for (int n2 = 0; n2 < kPiece / 16; ++n2) {
            if constexpr (kQ) {   // the codes: one plane, three
              uint32_t bk[4];              // products
              b_frags_kn<D>(bk, kpl, 16 * kk, dq_c + n0 + 16 * n2, lane);
              mma_x3(dq[2 * n2], da, bk);
              mma_x3(dq[2 * n2 + 1], da, bk + 2);
            } else {
              uint32_t bk[3][4];
#pragma unroll
              for (int pl = 0; pl < 3; ++pl)
                b_frags_kn<D>(bk[pl], kpl + pl * kKPlane, 16 * kk,
                              dq_c + n0 + 16 * n2, lane);
              mma_x6(dq[2 * n2], da, bk[0], bk[1], bk[2]);
              mma_x6(dq[2 * n2 + 1], da, bk[0] + 2, bk[1] + 2, bk[2] + 2);
            }
          }
        }
      };
      // lanes t and t ^ 1 trade halves: even t then holds four columns of
      // row lane / 4, odd t four columns of row lane / 4 + 8
      const bool odd = lane & 1;
      const int r = i0 + dq_r + (lane >> 2) + (odd ? 8 : 0);
      float* dqg = static_cast<float*>(p.dq) + (tile_rows(it) + r) * D +
                   dq_c + 2 * (lane & 2);
      auto add = [&](int n0) {
#pragma unroll
        for (int j = 0; j < kPiece / 8; ++j) {
          const float x =
              __shfl_xor_sync(kFull, odd ? dq[j][0] : dq[j][2], 1);
          const float y =
              __shfl_xor_sync(kFull, odd ? dq[j][1] : dq[j][3], 1);
          const float4 part = odd ? make_float4(x, y, dq[j][2], dq[j][3])
                                  : make_float4(dq[j][0], dq[j][1], x, y);
          if (r < p.Lq)
            atomicAdd(reinterpret_cast<float4*>(dqg + n0 + 8 * j), part);
        }
      };
      if constexpr (kPiece == X::kDqCols) form(0);
      if (it + 1 < tiles) split_stage(it + 1);
      // the key tiles below this one that reach this chunk add first (all
      // of them without a window); the barrier inside also fences the
      // planes of tile it + 1 and the stage
      if constexpr (kMask)
        await_turn(order_of(it), dq_turn(p, tile, tile_i0(it)));
      else
        await_turn(order_of(it), tile);
#pragma unroll
      for (int n0 = 0; n0 < X::kDqCols; n0 += kPiece) {
        if constexpr (kPiece != X::kDqCols) form(n0);
        add(n0);
      }
      // dS^T is read before the next tile's steps write it
      if constexpr (kPiece != X::kDqCols) __syncthreads();
    } else {
      if (it + 1 < tiles) split_stage(it + 1);
      __syncthreads();   // the planes of tile it + 1 written, the stage read
    }
    if (it + 2 < tiles) load_stage(it + 2);
    cp_async_commit();
  }

  if constexpr (kDQ) {
    if (!kSplitD || c0 == 0) {
      __syncthreads();   // the last adds are issued before the release
      if constexpr (kMask) {
        if (tid == 0 && tiles > 0)
          store_release(order_of(tiles - 1),
                        dq_turn(p, tile, tile_i0(tiles - 1)) + 1);
      } else {
        if (tid == 0 && tiles > 0)
          store_release(order_of(tiles - 1), tile + 1);
      }
    }
  }
  if constexpr (kSplitD) {
    store_cols_f32<D, DC>(p.dk, kv_rows, kw, p.Lk, dk, p.scale / p.scale2,
                          c0, lane);
    store_cols_f32<D, DC>(p.dv, kv_rows, kw, p.Lk, dv, 1.f, c0, lane);
  } else {
    store_rows_f32<D>(p.dk, kv_rows, kw, p.Lk, dk, p.scale / p.scale2, lane);
    store_rows_f32<D>(p.dv, kv_rows, kw, p.Lk, dv, 1.f, lane);
  }
}

// Launches kernel<D> over the KV-outer grid of the six-product form, key
// tiles along y.
template <int D, bool kDQ, bool kMask, bool kDrop, int kQuant,
          typename Kernel>
cudaError_t launch_kv_outer_x6(Kernel kernel,
                               const BwdParamsOf<kMask, kDrop, kQuant>& p,
                               cudaStream_t stream) {
  constexpr int kSmem = BwdX6<D, kDQ>::kSmem +
                        (kMask ? kMaskSmemBytes : 0) +
                        (kDrop ? kDropSmemBytes : 0);
  const int tiles = (p.Lk + kTcBlock - 1) / kTcBlock;
  if (tiles > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.Hkv, tiles, x6_split_d<D, kDQ, kQuant>() ? 2 : 1);
  kernel<<<grid, kTcThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

// The checks every backward entry makes: dtype 0 (fp32) or 1 (bf16), whole
// GQA groups, a head dim the kernels take, and grid_y (the grid's second
// dimension) within CUDA's limit.
__host__ inline bool bwd_args_ok(int dtype, int H, int Hkv, int d,
                                 long long grid_y) {
  return (dtype == 0 || dtype == 1) && Hkv > 0 && H % Hkv == 0 &&
         grid_y <= 65535 && (d == 16 || d == 32 || d == 64 || d == 128);
}

// The masked forms' arguments: a window of 0 (none) or >= 1 with causal,
// segment ids only where Lq == Lk.
__host__ inline bool mask_args_ok(int window, int causal, const int* seg,
                                  int Lq, int Lk) {
  return window >= 0 && (window == 0 || causal) && (!seg || Lq == Lk);
}

// The masked forms' parameters from a call's: the window kNoBand where the
// call has none.
__host__ inline MaskedBwdParams masked(const BwdParams& p, int window,
                                       const int* seg) {
  return MaskedBwdParams{p, window > 0 ? window : kNoBand, seg};
}

// The form of a parameter struct: masked, with dropout.
template <typename Prm>
constexpr bool kMaskOf = std::is_base_of_v<MaskedBwdParams, Prm>;
template <typename Prm>
constexpr bool kDropOf =
    std::is_base_of_v<Dropped<BwdParams>, Prm> ||
    std::is_base_of_v<Dropped<MaskedBwdParams>, Prm>;

// A call's dropout (the C entries' last arguments before the stream): the
// seed on the device, null for none, the keep threshold and the scale.
struct DropCall {
  const int* seed;
  uint32_t threshold;
  float keep_scale;
};

// launch(params) for the call's form: masked where it has a window or
// segment ids, with dropout where it has a seed, quantized as kQuant says.
template <int kQuant, typename Launch>
__host__ inline cudaError_t launch_form_of(const BwdParams& p, int window,
                                           const int* seg,
                                           const DropCall& drop,
                                           const KvqCall& kvq,
                                           Launch launch) {
  if (window > 0 || seg) {
    const MaskedBwdParams mp = masked(p, window, seg);
    if (drop.seed)
      return launch(quantized<kQuant>(
          Dropped<MaskedBwdParams>{mp, drop.seed, drop.threshold,
                                   drop.keep_scale},
          kvq));
    return launch(quantized<kQuant>(mp, kvq));
  }
  if (drop.seed)
    return launch(quantized<kQuant>(
        Dropped<BwdParams>{p, drop.seed, drop.threshold, drop.keep_scale},
        kvq));
  return launch(quantized<kQuant>(p, kvq));
}

}  // namespace
