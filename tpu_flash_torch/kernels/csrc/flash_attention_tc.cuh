// The tiles and fragments that the flash-attention kernels' tensor-core
// forms (bf16 products with fp32 sums through mma.sync, and for fp32 inputs
// six such products a product) share: the forward (flash_attention_fwd.cu),
// the fused backward (flash_attention_bwd.cu) and the two passes
// (flash_attention_bwd_two_pass.cu).
//
// A block has 4 warps, each owning 16 rows of its fixed side (query rows in
// the forward and the dQ pass, keys in the KV-outer kernels); the other
// side's rows come in tiles of 64 through a ring of shared-memory stages
// filled by cp.async.  Tiles are stored row major in bf16 with rows padded
// by 16 bytes, so that the 8 rows an ldmatrix reads fall in distinct banks.
// Quantized K/V arrive as one-byte codes and are turned into such tiles in
// shared memory (the kvq forms, below).
//
// kernels/common.py hashes every .cuh into each library's name, so an edit
// here rebuilds every kernel.

#pragma once

#include <cuda_fp8.h>

#include <type_traits>

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 128;  // 4 warps, 16 fixed rows each
constexpr int kTcBlock = 64;     // fixed rows a block
constexpr int kTcTile = 64;      // streamed rows a stage

template <int D>
struct TcShape {
  static constexpr int P = D + 8;             // bf16 row pitch in shared memory
  static constexpr int kStages = D <= 64 ? 3 : 2;
  // columns of S a warp holds at once: 32 at d = 128 keeps S and the
  // accumulators in registers
  static constexpr int kStep = D <= 64 ? 64 : 32;
  // the backward's fixed A fragments in registers (else read by ldmatrix
  // each time, at d = 128)
  static constexpr bool kRegs = D <= 64;
  static constexpr int kPieces = kTcTile * D / 8 / kTcThreads;  // a thread's
                                               // 16-byte pieces of one tile
  static constexpr int kTileBytes = kTcTile * P * 2;
  static_assert(kPieces * kTcThreads * 8 == kTcTile * D, "piece mapping");
};

// The 16-byte pieces of a [64, D] tile (rows r0 .. r0 + 63 of a [rows, D]
// array at src) that this thread copies into dst [64][P]; rows at or past
// n are zeros.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const void* src,
                                          size_t base, int r0, int n,
                                          int tid) {
  using S = TcShape<D>;
#pragma unroll
  for (int l = 0; l < S::kPieces; ++l) {
    const int idx = tid + l * kTcThreads;
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * S::P + c,
               static_cast<const bf16*>(src) +
                   (base + (ok ? r0 + r : 0)) * D + c,
               ok);
  }
}

// This thread's pieces of a q tile (as load_tile copied them) times
// scale * log2(e), rounded to bf16, into dst (which may be src).
template <int D>
__device__ __forceinline__ void scale_tile(bf16* dst, const bf16* src,
                                           float scale2, int tid) {
  using S = TcShape<D>;
#pragma unroll
  for (int l = 0; l < S::kPieces; ++l) {
    const int idx = tid + l * kTcThreads;
    const int off = idx / (D / 8) * S::P + (idx % (D / 8)) * 8;
    const uint4 w = *reinterpret_cast<const uint4*>(src + off);
    float f[8];
    bf16x2(w.x, f);
    bf16x2(w.y, f + 2);
    bf16x2(w.z, f + 4);
    bf16x2(w.w, f + 6);
    *reinterpret_cast<uint4*>(dst + off) = make_uint4(
        bf16_pair_rn(f[0] * scale2, f[1] * scale2),
        bf16_pair_rn(f[2] * scale2, f[3] * scale2),
        bf16_pair_rn(f[4] * scale2, f[5] * scale2),
        bf16_pair_rn(f[6] * scale2, f[7] * scale2));
  }
}

// The A fragment of rows row0 .. row0 + 15, columns 16 kk .. 16 kk + 15.
template <int D>
__device__ __forceinline__ void a_frag(uint32_t* a, const bf16* tile,
                                       int row0, int kk, int lane) {
  ldmatrix_x4(a, tile + (row0 + (lane & 15)) * TcShape<D>::P + kk * 16 +
                     (lane >> 4) * 8);
}

// The A fragment of rows (m) m0 .. m0 + 15, columns (k) k0 .. k0 + 15 of a
// matrix stored transposed, k by m, with row pitch `pitch`.
__device__ __forceinline__ void a_frag_t(uint32_t* a, const bf16* t,
                                         int pitch, int k0, int m0,
                                         int lane) {
  ldmatrix_x4_trans(a, t + (k0 + (lane & 7) + ((lane >> 4) << 3)) * pitch +
                           m0 + ((lane >> 3) & 1) * 8);
}

// B fragments of two n8 tiles (b[0..1] and b[2..3]) from a tile stored n by
// k (the rows are the product's columns): rows n0 .. n0 + 15, columns
// 16 kk .. 16 kk + 15.
template <int D>
__device__ __forceinline__ void b_frags_nk(uint32_t* b, const bf16* tile,
                                           int n0, int kk, int lane) {
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) *
                            TcShape<D>::P +
                     kk * 16 + ((lane >> 3) & 1) * 8);
}

// B fragments of two n8 tiles from a tile stored k by n: rows (k)
// k0 .. k0 + 15, columns (n) n0 .. n0 + 15.
template <int D>
__device__ __forceinline__ void b_frags_kn(uint32_t* b, const bf16* tile,
                                           int k0, int n0, int lane) {
  ldmatrix_x4_trans(b, tile + (k0 + (lane & 15)) * TcShape<D>::P + n0 +
                           (lane >> 4) * 8);
}

// The A fragment over the 16 accumulator columns 16 kk .. 16 kk + 15.
template <int N>
__device__ __forceinline__ void acc_as_a(uint32_t* a, const float (&c)[N][4],
                                         int kk) {
  a[0] = bf16_pair_rn(c[2 * kk][0], c[2 * kk][1]);
  a[1] = bf16_pair_rn(c[2 * kk][2], c[2 * kk][3]);
  a[2] = bf16_pair_rn(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = bf16_pair_rn(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// scale * acc, a warp's [16, D] accumulators, as bf16 pairs into rows
// row0 .. row0 + 15 (after row base) of a [rows, D] array; rows at or past
// n are skipped.
template <int D>
__device__ __forceinline__ void store_rows(void* out, size_t base, int row0,
                                           int n, const float (&acc)[D / 8][4],
                                           float scale, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + (lane >> 2) + 8 * h;
    if (r >= n) continue;
    bf16* dst = static_cast<bf16*>(out) + (base + r) * D + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          bf16_pair_rn(scale * acc[j][2 * h], scale * acc[j][2 * h + 1]);
  }
}

// --- sliding windows and packed segments (the masked forms) ----------------
//
// Each flash kernel has a masked form (template flag kMask) beside the one
// that takes neither, launched only for a call with a window or segment
// ids; the unmasked form is compiled from the same code as before the
// masked one existed.  Query row i sees key j where the causal and length
// tests pass and, in the masked form, j > i + q_offset - window and
// seg[i] == seg[j] (seg null: no segments; Lq == Lk).  The masked form's
// parameters add window (kNoBand where the call has none) and seg.  The
// kernels skip whole tiles behind the band and test each step (NK keys, or
// NQ query rows) once: a step wholly outside the band, or whose segment ids
// share no value with those of the warp's 16 fixed rows (query rows, or
// keys in the KV-outer kernels), is skipped; a step inside the band whose
// ids are all the fixed rows' one id needs no element mask.  The mask holds
// nothing in registers across a step's products: the block's view sits in
// shared memory after the form's own (MaskSmem, read through a volatile
// pointer so that it is re-read where used), and the step's ids are
// re-read from global memory (L1) by loads the compiler neither merges nor
// hoists (ld_fresh).

constexpr int kNoBand = 1 << 30;   // a window wider than any sequence

__device__ __forceinline__ int ld_fresh(const int* p) {
  int v;
  asm volatile("ld.global.nc.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

struct MaskSmem {
  const int* seg;          // the batch row's segment ids, or null
  int lo[4], hi[4];        // each warp's fixed rows' least and greatest id
  int own[kTcBlock];       // each fixed row's id
};
constexpr int kMaskSmemBytes = (sizeof(MaskSmem) + 15) / 16 * 16;

// Every thread of the block, before a __syncthreads: the block's view at
// `at` (the end of the form's shared memory) of batch row b of the
// segment ids seg [B, n] (null: none), for its fixed rows fixed0 ..
// fixed0 + 63 (clipped to n - 1); returns it.
__device__ __forceinline__ const volatile MaskSmem* mask_setup(
    char* at, const int* seg, int b, int n, int fixed0, int tid) {
  MaskSmem* ms = reinterpret_cast<MaskSmem*>(at);
  if (seg) seg += (size_t)b * n;
  if (tid == 0) ms->seg = seg;
  if (seg) {
    const int lane = tid & 31, warp = tid >> 5;
    const int v = __ldg(seg + min(fixed0 + warp * 16 + (lane & 15), n - 1));
    const int lo = __reduce_min_sync(kFull, v);
    const int hi = __reduce_max_sync(kFull, v);
    if (lane < 16) ms->own[warp * 16 + lane] = v;
    if (lane == 0) {
      ms->lo[warp] = lo;
      ms->hi[warp] = hi;
    }
  }
  return ms;
}

// The ids of positions i0 .. i0 + N - 1 (N 16, 32 or 64), clipped to
// n - 1: v[h] is position i0 + 32 h + lane (lane % N for N = 16).
template <int N>
struct SegVals {
  int v[(N + 31) / 32];
};

template <int N>
__device__ __forceinline__ SegVals<N> seg_vals(const int* seg, int n,
                                               int i0, int lane) {
  SegVals<N> r;
#pragma unroll
  for (int h = 0; h < (N + 31) / 32; ++h)
    r.v[h] = ld_fresh(seg + min(i0 + 32 * h + (N < 32 ? lane % N : lane),
                                n - 1));
  return r;
}

// The least and greatest of a run's ids over the warp.  Every lane calls it.
template <int N>
__device__ __forceinline__ void seg_range(const SegVals<N>& r, int& lo,
                                          int& hi) {
  lo = hi = r.v[0];
#pragma unroll
  for (int h = 1; h < (N + 31) / 32; ++h) {
    lo = min(lo, r.v[h]);
    hi = max(hi, r.v[h]);
  }
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
}

// The id of position i0 + base + off of a run (base a multiple of 8 known
// at compile time once unrolled, off < 8).  Every lane calls it.
template <int N>
__device__ __forceinline__ int seg_at(const SegVals<N>& r, int base,
                                      int off) {
  return __shfl_sync(kFull, r.v[base / 32], (base + off) & 31);
}

// A step of N streamed positions from s0 against the warp's 16 fixed rows
// (ms's view): false where their ids share no value; else full is cleared
// unless every id is the fixed rows' one id.  Every lane calls it.
template <int N>
__device__ __forceinline__ bool seg_step_live(const volatile MaskSmem* ms,
                                              int n, int s0, int warp,
                                              int lane, bool& full) {
  int lo, hi;
  seg_range(seg_vals<N>(ms->seg, n, s0, lane), lo, hi);
  const int wlo = ms->lo[warp], whi = ms->hi[warp];
  if (hi < wlo || lo > whi) return false;
  full = full && lo == hi && wlo == whi && lo == wlo;
  return true;
}

// The first tile of kTile keys that a block of query rows from row0 sees
// under the window's band (0 in the unmasked form).
template <bool kMask, int kTile, typename Prm>
__device__ __forceinline__ int band_first_tile(const Prm& p, int row0,
                                               int tiles) {
  if constexpr (kMask)
    return min(tiles, max(0, row0 + p.q_offset - p.window + 1) / kTile);
  else
    return 0;
}

// The masked forms' test of a step of NK keys from kc against the warp's
// query rows rw .. rw + 15 (the forward and the dQ pass): false where no
// pair is visible; else full is cleared where some pair is not.
template <int NK, typename Prm>
__device__ __forceinline__ bool keys_live(const Prm& p,
                                          const volatile MaskSmem* ms,
                                          int kc, int rw, int warp, int lane,
                                          bool& full) {
  if (kc + NK <= rw + p.q_offset - p.window + 1) return false;
  full = full && kc > rw + 15 + p.q_offset - p.window;
  return !p.seg || seg_step_live<NK>(ms, p.Lk, kc, warp, lane, full);
}

// The masked forms' element mask of a step's scores s (rows the thread's
// two query rows, columns keys from kc): -inf where the length, the causal
// limit, the band or the segments hide the key.
template <int NK, typename Prm>
__device__ __forceinline__ void mask_scores(float (&s)[NK / 8][4],
                                            const Prm& p,
                                            const volatile MaskSmem* ms,
                                            int kc, int rw, int warp,
                                            int lane) {
  SegVals<NK> ks{};
  int own[2] = {0, 0};
  if (p.seg) {
    ks = seg_vals<NK>(ms->seg, p.Lk, kc, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      own[h] = ms->own[warp * 16 + (lane >> 2) + 8 * h];
  }
#pragma unroll
  for (int j = 0; j < NK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int off = 2 * (lane & 3) + (e & 1);
      const int key = kc + 8 * j + off;
      const int i = rw + (lane >> 2) + 8 * (e >> 1);
      const int kseg = p.seg ? seg_at(ks, 8 * j, off) : 0;
      if (key >= p.Lk || (p.causal && key > i + p.q_offset) ||
          key <= i + p.q_offset - p.window ||
          (p.seg && kseg != own[e >> 1]))
        s[j][e] = -INFINITY;
    }
}

// --- attention dropout (the dropout forms) ----------------------------------
//
// tpu_flash/kernels/flash_attention.py dropout_keep_mask (:443): the keep
// bit of query row i, key j (the call's indices from 0: q_offset is not
// added), batch b and query head h is a hash of them and the seed, uint32
// multiply, xor and shift, kept where the hash is at least the call's
// threshold, min(round(rate 2^32), 2^32 - 1); kept entries are scaled by
// 1 / (1 - rate) (keep_scale, rounded to fp32 by the caller).  Every
// kernel computes the same bits, so the backward regenerates the forward's
// mask.  Each flash kernel has a dropout form (template flag kDrop) beside
// its forms without, with or without the mask; the forms without dropout
// are compiled from the same code as before it existed.  The seed stays
// on the device: int32 [seed, batch offset, head offset], read by the
// kernel (the offsets shift b and h, as the JAX kernels' _global_bh).

constexpr uint32_t kDropRow = 0x9E3779B1u, kDropCol = 0x85EBCA77u,
                   kDropB = 0xC2B2AE3Du, kDropH = 0x27D4EB2Fu;

// A form's parameters with dropout's beside them.
template <typename Base>
struct Dropped : Base {
  const int* seed;      // int32 [3] on the device
  uint32_t threshold;   // keep where the hash >= threshold
  float keep_scale;     // 1 / (1 - rate)
};

// The hash's terms of batch b and query head h: the same for every score
// of a (batch, head).  The seed is re-read by loads the compiler neither
// merges nor hoists (ld_fresh), so that a step can take them afresh
// without holding a register across the steps.
__device__ __forceinline__ uint32_t drop_bh(const int* seed, int b, int h) {
  return ((uint32_t)b + (uint32_t)ld_fresh(seed + 1)) * kDropB ^
         ((uint32_t)h + (uint32_t)ld_fresh(seed + 2)) * kDropH ^
         (uint32_t)ld_fresh(seed);
}

// The keep bit from the hash's terms: the fixed ones (drop_bh xor one
// index's product) and the other index's product.
__device__ __forceinline__ bool drop_keep(uint32_t fixed, uint32_t other,
                                          uint32_t threshold) {
  uint32_t u = fixed ^ other;
  u ^= u >> 16;
  u *= 0x7FEB352Du;
  u ^= u >> 15;
  u *= 0x846CA68Bu;
  u ^= u >> 16;
  return u >= threshold;
}

// The dropout forms' view of the block in shared memory, after the form's
// own and the mask's: each of the 64 fixed rows' term of the hash (query
// rows in the forward and the dQ pass, with the batch's and head's terms;
// keys in the KV-outer bodies), and each thread's keep bits of its current
// step.  A thread hashes its step's scores before the step's products and
// parks the bits here (through a volatile pointer), so that nothing of the
// hash stays in registers across the products (the _x6 forms sit at 255).
struct DropSmem {
  uint32_t terms[kTcBlock];
  uint32_t bits[kTcThreads];
};
constexpr int kDropSmemBytes = sizeof(DropSmem);

// Every thread of the block, before a __syncthreads: the view at `at`, the
// terms of fixed rows fixed0 .. fixed0 + 63 being index times mul xor mix.
__device__ __forceinline__ volatile DropSmem* drop_setup(char* at,
                                                         uint32_t mul,
                                                         uint32_t mix,
                                                         int fixed0,
                                                         int tid) {
  DropSmem* ds = reinterpret_cast<DropSmem*>(at);
  if (tid < kTcBlock) ds->terms[tid] = (uint32_t)(fixed0 + tid) * mul ^ mix;
  return ds;
}

// Every thread, before a step's products: the keep bits of its N / 8 m16n8
// accumulator tiles over the step's N streamed positions from `first`
// (N <= 64), bit 4 j + e of element [j][e], into its slot.  Element
// [j][e] is fixed row lane / 4 + 8 (e / 2) of the warp's 16 (its term xor
// bh) and streamed position first + 8 j + 2 (lane % 4) + e % 2 (times mul).
template <int N>
__device__ __forceinline__ void drop_step(volatile DropSmem* ds, uint32_t bh,
                                          int first, uint32_t mul,
                                          uint32_t threshold, int tid) {
  static_assert(N <= 64, "32 keep bits a step");
  const int warp = tid >> 5, lane = tid & 31;
  const uint32_t fixed[2] = {ds->terms[warp * 16 + (lane >> 2)] ^ bh,
                             ds->terms[warp * 16 + (lane >> 2) + 8] ^ bh};
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (drop_keep(fixed[e >> 1],
                    (uint32_t)(first + 8 * j + 2 * (lane & 3) + (e & 1)) * mul,
                    threshold))
        bits |= 1u << (4 * j + e);
  ds->bits[tid] = bits;
}

// The multiplier of element [j][e] from a step's keep bits: keep_scale
// where kept, 0 where dropped.
__device__ __forceinline__ float drop_scale(uint32_t bits, int j, int e,
                                            float keep_scale) {
  return (bits >> (4 * j + e)) & 1u ? keep_scale : 0.f;
}

// --- quantized K/V (the kvq forms) ------------------------------------------
//
// tpu_flash/kernels/flash_attention.py's quantized forms (quantized, scaled;
// _fwd_kernel :541-573, :609-617, _bwd_s2_dp :1014, the dQ products :1204,
// :1370): k and v are one-byte codes [B, Hkv, Lk, D], int8, or e4m3 where
// the call says fp8 (a run-time flag of the conversion).  Each flash kernel
// has quantized forms (template value kQuant) beside its others, for every
// mask and dropout form: kKvToken reads fp32 scales [B, Hkv, Lk] by key,
// which multiply the fp32 scores and P in the forward (S2 = (q scale2 .
// codes) ks, P.V on P vs) and dP and dS in the backward (dP = (dO . codes)
// vs, dQ on dS ks), as the JAX bodies fold them, each product rounded to
// fp32; kKvChannel reads no scale (the wrapper folds the [B, Hkv, D] scales
// into q and dO and unfolds the outputs).  The codes arrive by cp.async, a
// byte an element, into shared memory, and one pass of the block turns each
// tile into the bf16 tile [R][P] that the ldmatrix / mma.sync path reads:
// every int8 and e4m3 value is a bf16, so the products are exact in the
// codes.  e4m3 converts by the card's cvt (subnormals kept, where the JAX
// package's bit rebuild flushes them).  The forms without quantization are
// compiled from the same code with kQuant kKvNone, every quantized branch
// under if constexpr.

constexpr int kKvNone = 0, kKvToken = 1, kKvChannel = 2;

// A form's parameters with the quantized K/V's beside them.
template <typename Base, int kQuant>
struct Quantized : Base {
  const float* k_scale;   // kKvToken: fp32 [B, Hkv, Lk]; else null
  const float* v_scale;
  int fp8;                // the codes are e4m3 (else int8)
};

template <typename Base, int kQuant>
using QuantOf =
    std::conditional_t<kQuant == kKvNone, Base, Quantized<Base, kQuant>>;

template <typename Prm>
struct QuantTrait {
  static constexpr int value = kKvNone;
};
template <typename Base, int kQuant>
struct QuantTrait<Quantized<Base, kQuant>> {
  static constexpr int value = kQuant;
};
// The quantization of a parameter struct.
template <typename Prm>
constexpr int kQuantOf = QuantTrait<Prm>::value;

// A call's quantized K/V (the kvq entries' last arguments before the
// stream): the token scales (null for channel codes) and the code type.
struct KvqCall {
  const float* k_scale;
  const float* v_scale;
  int fp8;
};

// Whether a call's quantized K/V suit the forms of kQuant: token scales,
// both, for kKvToken; none for kKvChannel (and kKvNone).
__host__ inline bool kvq_args_ok(int kQuant, const KvqCall& kvq) {
  return kQuant == kKvToken ? kvq.k_scale && kvq.v_scale
                            : !kvq.k_scale && !kvq.v_scale;
}

// The quantized K/V of a form's parameters (nulls without).
template <typename Prm>
__host__ __device__ inline KvqCall kvq_of(const Prm& p) {
  if constexpr (kQuantOf<Prm> == kKvNone)
    return KvqCall{nullptr, nullptr, 0};
  else
    return KvqCall{p.k_scale, p.v_scale, p.fp8};
}

// p as the form for kQuant takes it.
template <int kQuant, typename Prm>
__host__ inline QuantOf<Prm, kQuant> quantized(const Prm& p,
                                               const KvqCall& q) {
  if constexpr (kQuant == kKvNone)
    return p;
  else
    return Quantized<Prm, kQuant>{p, q.k_scale, q.v_scale, q.fp8};
}

// Bytes of a stage of R rows of K and V codes and their token scales:
// k codes [R][D], v codes [R][D], k scales [R], v scales [R].
template <int D, int R>
__host__ __device__ constexpr int kv_code_stage_bytes() {
  return 2 * R * D + 2 * R * 4;
}

// The 16-byte pieces of rows r0 .. r0 + R - 1 of a [rows, D] array of
// one-byte codes at src (after row base) into dst [R][D]; rows at or past
// n are zeros.
template <int D, int R>
__device__ __forceinline__ void load_codes(uint8_t* dst, const void* src,
                                           size_t base, int r0, int n,
                                           int tid) {
  constexpr int kPieces = R * D / 16;
#pragma unroll
  for (int l = 0; l < (kPieces + kTcThreads - 1) / kTcThreads; ++l) {
    const int idx = tid + l * kTcThreads;
    if (kPieces % kTcThreads != 0 && idx >= kPieces) break;
    const int r = idx / (D / 16), c = (idx % (D / 16)) * 16;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * D + c,
               static_cast<const uint8_t*>(src) +
                   (base + (ok ? r0 + r : 0)) * D + c,
               ok);
  }
}

// The token scales of rows r0 .. r0 + R - 1 (after row base) of k_scale
// and v_scale into ks [R] and vs [R], 0 at or past n: threads 0 .. 2R - 1.
template <int R>
__device__ __forceinline__ void load_kv_scales(float* ks, float* vs,
                                               const float* k_scale,
                                               const float* v_scale,
                                               size_t base, int r0, int n,
                                               int tid) {
  static_assert(2 * R <= kTcThreads, "a thread a scale");
  if (tid < 2 * R) {
    const int r = tid % R;
    const bool ok = r0 + r < n;
    cp_async4((tid < R ? ks : vs) + r,
              (tid < R ? k_scale : v_scale) + base + (ok ? r0 + r : 0), ok);
  }
}

// Four codes (the lowest byte first), int8 or e4m3, as two bf16 pairs,
// exactly.
__device__ __forceinline__ uint2 codes4_bf16(uint32_t w, bool fp8) {
  float f[4];
  if (fp8) {
    const float2 a = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(w & 0xffffu), __NV_E4M3)));
    const float2 b = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(w >> 16), __NV_E4M3)));
    f[0] = a.x;
    f[1] = a.y;
    f[2] = b.x;
    f[3] = b.y;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[i] = static_cast<float>(static_cast<int>(w << (24 - 8 * i)) >> 24);
  }
  return make_uint2(bf16_pair_rn(f[0], f[1]), bf16_pair_rn(f[2], f[3]));
}

// A tile of R rows of D codes [R][D] into bf16 [R][P] (TcShape's layout,
// also one plane of the fp32 forms'), 16 codes a thread at a time.
template <int D, int R>
__device__ __forceinline__ void convert_codes(bf16* dst, const uint8_t* src,
                                              bool fp8, int tid) {
  constexpr int kPieces = R * D / 16;
#pragma unroll
  for (int l = 0; l < (kPieces + kTcThreads - 1) / kTcThreads; ++l) {
    const int idx = tid + l * kTcThreads;
    if (kPieces % kTcThreads != 0 && idx >= kPieces) break;
    const int r = idx / (D / 16), c = (idx % (D / 16)) * 16;
    const uint4 w = *reinterpret_cast<const uint4*>(src + r * D + c);
    const uint2 a = codes4_bf16(w.x, fp8), b = codes4_bf16(w.y, fp8);
    const uint2 e = codes4_bf16(w.z, fp8), f = codes4_bf16(w.w, fp8);
    bf16* row = dst + r * TcShape<D>::P + c;
    *reinterpret_cast<uint4*>(row) = make_uint4(a.x, a.y, b.x, b.y);
    *reinterpret_cast<uint4*>(row + 8) = make_uint4(e.x, e.y, f.x, f.y);
  }
}

// A step's scores times their keys' scales, where the columns are keys
// (the forward and the dQ pass): element [j][e] is key k0 + 8 j +
// 2 (lane % 4) + e % 2 of the tile whose scales sc holds; each product
// rounded to fp32 (no fused add).
template <int N>
__device__ __forceinline__ void scale_cols(float (&s)[N / 8][4],
                                           const float* sc, int k0,
                                           int lane) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 x =
        *reinterpret_cast<const float2*>(sc + k0 + 8 * j + 2 * (lane & 3));
    s[j][0] = __fmul_rn(s[j][0], x.x);
    s[j][1] = __fmul_rn(s[j][1], x.y);
    s[j][2] = __fmul_rn(s[j][2], x.x);
    s[j][3] = __fmul_rn(s[j][3], x.y);
  }
}

// The same where the rows are keys (the KV-outer bodies' S^T and dP^T):
// the thread's two rows have the scales x[0] and x[1].
template <int N>
__device__ __forceinline__ void scale_rows(float (&s)[N / 8][4],
                                           const float (&x)[2]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = __fmul_rn(s[j][e], x[e >> 1]);
}

// --- the fp32 forms: six bf16 products a product (mma_x6) -------------------
//
// fp32 tiles arrive by cp.async into rows padded by 4 floats (kF32Pitch),
// and each is split once, by the whole block, into three bf16 planes (hi,
// mid, lo) of TcShape's layout, plane pl at pl * plane elements after the
// first: the planes are what every warp's ldmatrix reads.

template <int D>
constexpr int kF32Pitch = D + 4;   // fp32 row pitch in shared memory

// The 16-byte pieces of rows r0 .. r0 + R - 1 of an fp32 [rows, D] array
// at src (after row base) into dst [R][D + 4]; rows at or past n are zeros.
template <int D, int R>
__device__ __forceinline__ void load_tile_f32(float* dst, const void* src,
                                              size_t base, int r0, int n,
                                              int tid) {
  constexpr int kPieces = R * D / 4;
  static_assert(kPieces % kTcThreads == 0, "piece mapping");
#pragma unroll
  for (int l = 0; l < kPieces / kTcThreads; ++l) {
    const int idx = tid + l * kTcThreads;
    const int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * kF32Pitch<D> + c,
               static_cast<const float*>(src) +
                   (base + (ok ? r0 + r : 0)) * D + c,
               ok);
  }
}

// An fp32 tile [R][D + 4] times scale (rounded once in fp32; 1 leaves it
// as it is) split into its three planes [R][P]; four values a thread at a
// time, so that each quarter warp reads 128 contiguous bytes.
template <int D, int R>
__device__ __forceinline__ void split_tile(bf16* dst, int plane,
                                           const float* src, float scale,
                                           int tid) {
  constexpr int kQuads = R * D / 4;
  static_assert(kQuads % kTcThreads == 0, "quad mapping");
#pragma unroll
  for (int l = 0; l < kQuads / kTcThreads; ++l) {
    const int idx = tid + l * kTcThreads;
    const int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
    const float4 x =
        *reinterpret_cast<const float4*>(src + r * kF32Pitch<D> + c);
    // __fmul_rn: no fused multiply-add into the split
    uint32_t a[3], b[3];
    split3_pair(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale), a[0], a[1],
                a[2]);
    split3_pair(__fmul_rn(x.z, scale), __fmul_rn(x.w, scale), b[0], b[1],
                b[2]);
    bf16* row = dst + r * TcShape<D>::P + c;
#pragma unroll
    for (int pl = 0; pl < 3; ++pl)
      *reinterpret_cast<uint2*>(row + pl * plane) = make_uint2(a[pl], b[pl]);
  }
}

// The A fragments of the three planes over the 16 accumulator columns
// 16 kk .. 16 kk + 15 (acc_as_a, each value split in three).
template <int N>
__device__ __forceinline__ void acc_as_a_x6(uint32_t (&a)[3][4],
                                            const float (&c)[N][4], int kk) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* v = c[2 * kk + (i >> 1)] + 2 * (i & 1);
    split3_pair(v[0], v[1], a[0][i], a[1][i], a[2][i]);
  }
}

// scale * acc, a warp's [16, D] accumulators, in fp32 into rows
// row0 .. row0 + 15 (after row base) of a [rows, D] array; rows at or past
// n are skipped.
template <int D>
__device__ __forceinline__ void store_rows_f32(void* out, size_t base,
                                               int row0, int n,
                                               const float (&acc)[D / 8][4],
                                               float scale, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + (lane >> 2) + 8 * h;
    if (r >= n) continue;
    float* dst = static_cast<float*>(out) + (base + r) * D + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(scale * acc[j][2 * h], scale * acc[j][2 * h + 1]);
  }
}

}  // namespace
