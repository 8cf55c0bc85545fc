// Flash-attention backward, single pass in KV-outer order, for sm_90a.
//
// Replaces tpu_flash/kernels/flash_attention.py::_bwd_fused_kernel
// (flash_attention.py:1228) and its body _bwd_kv_outer_body (:1254), launched
// by pl.pallas_call at :2045.  From q [B, H, Lq, D], k and v [B, Hkv, Lk, D],
// dO [B, H, Lq, D], the saved lse and delta = rowsum(dO * O) - dlse (fp32
// [B, H, Lq], formed by the caller) it computes
//   P  = exp(S - lse),  dP = dO V^T,  dS = P * (dP - delta),
//   dV = P^T dO,  dK = scale * dS^T Q,  dQ = scale * dS K.
// dK and dV ([B, Hkv, Lk, D], the input dtype) are summed over the query heads
// of each GQA group inside the block, in fp32.  dQ is added into a zeroed
// [B, H, Lq, D] fp32 workspace that the caller scales and casts: the TPU keeps
// it race-free by running one (batch, head) in order against a full-sequence
// VMEM scratch (:1290-1293), which does not fit in a Hopper block's 227 KB of
// shared memory at L = 2048.  Here the blocks that reach a chunk of query
// rows add to it one after another, in the order of their key tiles, each
// waiting on a counter per chunk (dq_order, int32 zeroed by the caller) that
// the one before it released; so dQ's sums run in one order, and two calls
// give the same bits, as the TPU's and the two-pass form's do.  The blocks
// walk their chunks from the last down, so that the tiles of a head reach
// each chunk in step (flash_attention_bwd.cuh).
//
// Two forms on the tensor cores, chosen by the wrapper
// (kernels/flash_attention.py _form_name) and exported as separate C
// entries, both one block of 4 warps per (batch * KV head, tile of 64 keys):
//   * bf16 (tf_flash_attention_bwd_tc): kv_outer_tc_body with dQ, every
//     product an mma.sync.m16n8k16 with fp32 sums (the TPU rounds
//     q * scale * log2(e), P and dS to bf16 before its dots, which makes
//     each dot a bf16 x bf16 -> fp32 product), P^T and dS^T reused from the
//     accumulators as A fragments, the query tiles of 64 rows (the chunk of
//     the ordered dQ adds) through a cp.async ring, and dQ of a tile formed
//     on the tensor cores from dS^T in shared memory;
//   * fp32 (tf_flash_attention_bwd_x6): the same walk with every product
//     six bf16 products of the operands split in three (mma_x6, mma.cuh),
//     as the TPU runs fp32 dots at Precision.HIGHEST; below.
//
// What bounds it: operations (five L^2 * D products, 4.3e10 useful flops at
// B4 H8 L2048 d64 causal, against ~50 MB of traffic).  In bf16 the dQ adds
// set the pace: one 64 x 64 fp32 tile per (key tile, query tile) pair, 0.28
// GB of reductions into L2 at that shape and 4.3 GB at B1 H8 L16384 (PERF.md
// measures their share).  More keys a block, wgmma, TMA and warp
// specialisation are later work (ROADMAP.md).
//
// C entries launch on the given stream, allocate nothing and return
// cudaGetLastError() (or cudaErrorInvalidValue for a shape or dtype they do
// not take).

#include "flash_attention_bwd.cuh"

namespace {

// Two blocks an SM (as the dK/dV pass: without the bound ptxas caps d = 32
// at 168 registers and spills).
template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_attention_bwd_tc_kernel(const BwdParams p) {
  kv_outer_tc_body<D, true>(p);
}

// --- the fp32 form on the tensor cores (six bf16 products a product) -----
//
// kv_outer_tc_body's walk, order of dQ adds and grid (flash_attention_bwd.cuh)
// with every product mma_x6.  Shared memory cannot hold three planes of
// everything the bf16 form keeps in bf16 (at d = 64: k, v, and per stage q,
// q * scale2 and dO, plus dS^T, tripled, is over 227 KB), so:
//   * k and v arrive in fp32 once and are split into three planes each,
//     from which every warp reads its A fragments (k also B fragments of
//     dQ);
//   * a tile of kQT query rows (q, dO, lse and D) arrives in fp32 by
//     cp.async into one stage while the tile before it is computed, and is
//     split once by the whole block into the planes of q * scale2 and dO;
//     dK sums dS^T (q * scale2) and is scaled by scale / scale2 at the end,
//     so that q needs one set of planes;
//   * dS^T goes to shared memory as three planes for dQ = dS K.
// P and dS stay fp32 in the accumulators and are split in registers into
// the A fragments of dV and dK, whose sums over every query row the block
// sees take mma_x6_add (each step's products summed apart, then added
// rounded to nearest); S^T, dP^T (over the head dim) and a tile's dQ (over
// 64 keys) accumulate in place.  kQT is 64 below d = 128 and 32 at 128, the
// chunk of the ordered dQ adds (kernels/flash_attention.py _dq_chunk).  One
// block an SM: 170 KB of shared memory at d = 64, 202 KB at 128.

template <int D>
struct BwdX6 {
  static constexpr int kQT = D <= 64 ? 64 : 32;   // query rows a tile
  static constexpr int NQ = D <= 64 ? 32 : 16;    // rows of S^T a warp holds
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
  static constexpr int kUnrollSteps = D <= 64 ? kQT / NQ : 1;
  static constexpr int kDqPiece = D <= 64 ? kDqCols : 16;
  // byte offsets: k and v planes, then q * scale2 and dO planes, dS^T
  // planes, the fp32 stage (q, dO [kQT][F], lse, D [kQT]), and lse2 and D
  // of the tile in the planes
  static constexpr int kQdOff = 6 * kKPlane * 2;
  static constexpr int kDsOff = kQdOff + 6 * kQPlane * 2;
  static constexpr int kStageOff = kDsOff + 3 * kDsPlane * 2;
  static constexpr int kCurOff = kStageOff + (2 * kQT * F + 2 * kQT) * 4;
  static constexpr int kSmem = kCurOff + 2 * kQT * 4;
  // k and v in fp32 arrive over the planes of q, dO and dS^T
  static_assert(2 * kTcBlock * F * 4 <= kStageOff - kQdOff, "k, v staging");
  static_assert(kSmem <= 232448, "shared memory");
};

// A warp's dS^T accumulators over N query rows (zeros where c is null),
// split in three, into its 16 rows of the planes of dS^T [64][kDsP],
// columns col0 .. col0 + N - 1.
template <int N, int kDsP>
__device__ __forceinline__ void store_ds_t_x6(bf16* dst, int plane,
                                              const float (*c)[4], int row0,
                                              int col0, int lane) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t pieces[3] = {0u, 0u, 0u};
      if (c) split3_pair(c[j][2 * h], c[j][2 * h + 1], pieces[0], pieces[1],
                         pieces[2]);
      bf16* at = dst + (row0 + (lane >> 2) + 8 * h) * kDsP + col0 + 8 * j +
                 2 * (lane & 3);
#pragma unroll
      for (int pl = 0; pl < 3; ++pl)
        *reinterpret_cast<uint32_t*>(at + pl * plane) = pieces[pl];
    }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_attention_bwd_x6_kernel(const BwdParams p) {
  using X = BwdX6<D>;
  constexpr int kQT = X::kQT, NQ = X::NQ, F = X::F;
  constexpr int kKPlane = X::kKPlane, kQPlane = X::kQPlane;
  extern __shared__ uint4 x6_smem[];
  char* sm = reinterpret_cast<char*>(x6_smem);
  bf16* kpl = reinterpret_cast<bf16*>(sm);       // k's planes [64][P] x 3
  bf16* vpl = kpl + 3 * kKPlane;                 // v's
  bf16* qpl = reinterpret_cast<bf16*>(sm + X::kQdOff);   // q * scale2's
  bf16* opl = qpl + 3 * kQPlane;                 // dO's [kQT][P] x 3
  bf16* dspl = reinterpret_cast<bf16*>(sm + X::kDsOff);  // dS^T's
  float* qst = reinterpret_cast<float*>(sm + X::kStageOff);  // q [kQT][F]
  float* ost = qst + kQT * F;                    // dO
  float* lst = ost + kQT * F;                    // lse, then D [kQT]
  float* cur = reinterpret_cast<float*>(sm + X::kCurOff);  // lse2, then D
  float* kvst = reinterpret_cast<float*>(sm + X::kQdOff);  // k, v [64][F]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile = blockIdx.y;
  const int k0 = tile * kTcBlock;
  const int bhk = blockIdx.x, b = bhk / p.Hkv, hk = bhk % p.Hkv;
  const int g = p.H / p.Hkv;
  const size_t kv_rows = ((size_t)b * p.Hkv + hk) * p.Lk;
  const int kw = k0 + warp * 16;   // the warp's first key

  // The first query row that can see key k0, rounded down to a tile's
  // start (so that every block's tiles are the same chunks), and the tiles
  // of each head, walked from the last down, each for every head.
  const int first = p.causal ? max(0, k0 - p.q_offset) : 0;
  const int q_start = first - first % kQT;
  const int nt = q_start < p.Lq ? (p.Lq - q_start + kQT - 1) / kQT : 0;
  const int tiles = g * nt;
  auto tile_i0 = [&](int it) { return q_start + (nt - 1 - it / g) * kQT; };
  auto tile_rows = [&](int it) {
    return ((size_t)b * p.H + hk * g + it % g) * p.Lq;
  };
  // the counter of tile it's chunk (kQT query rows of its head)
  auto order_of = [&](int it) {
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
  load_tile_f32<D, kTcBlock>(kvst, p.k, kv_rows, k0, p.Lk, tid);
  load_tile_f32<D, kTcBlock>(kvst + kTcBlock * F, p.v, kv_rows, k0, p.Lk,
                             tid);
  if (tiles > 0) load_stage(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  split_tile<D, kTcBlock>(kpl, kKPlane, kvst, 1.f, tid);
  split_tile<D, kTcBlock>(vpl, kKPlane, kvst + kTcBlock * F, 1.f, tid);
  __syncthreads();   // k and v in fp32 read before their space is reused
  if (tiles > 0) split_stage(0);
  __syncthreads();
  if (tiles > 1) load_stage(1);
  cp_async_commit();

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  // this warp's part of a tile's dQ: rows dq_r .., columns dq_c ..
  const int dq_r = (warp % X::kRowGroups) * 16;
  const int dq_c = (warp / X::kRowGroups) * X::kDqCols;

  for (int it = 0; it < tiles; ++it) {
    const int i0 = tile_i0(it);
#pragma unroll (X::kUnrollSteps)
    for (int sub = 0; sub < kQT; sub += NQ) {
      const int r0 = i0 + sub;   // the step's first query row
      // every row of the step is past Lq, or sees none of the warp's keys
      if (r0 >= p.Lq || (p.causal && kw > r0 + NQ - 1 + p.q_offset)) {
        store_ds_t_x6<NQ, X::kDsP>(dspl, X::kDsPlane, nullptr, warp * 16,
                                   sub, lane);
        continue;
      }
      const bool full = kw + 16 <= p.Lk && r0 + NQ <= p.Lq &&
                        !(p.causal && kw + 15 > r0 + p.q_offset);
      // S^T = K (q scale2)^T and dP^T = V dO^T: rows keys, columns query rows
      float s[NQ / 8][4], dp[NQ / 8][4];
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll (X::kUnroll)
      for (int kk = 0; kk < D / 16; ++kk) {
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
#pragma unroll (X::kUnroll)
      for (int kk = 0; kk < D / 16; ++kk) {
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
      // P^T and dS^T in place (fp32, bwd_p_ds's arithmetic); column c is
      // query row i0 + c
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j) {
        const int c = sub + 8 * j + 2 * (lane & 3);
        const float2 lse2 = *reinterpret_cast<const float2*>(cur + c);
        const float2 delta = *reinterpret_cast<const float2*>(cur + kQT + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pr = exp2f(s[j][e] - (e & 1 ? lse2.y : lse2.x));
          if (!full) {
            const int key = kw + (lane >> 2) + 8 * (e >> 1);
            const int i = i0 + c + (e & 1);
            if (key >= p.Lk || i >= p.Lq ||
                (p.causal && key > i + p.q_offset))
              pr = 0.f;
          }
          s[j][e] = pr;
          // __fmul_rn: no fused multiply-add into the split
          dp[j][e] = __fmul_rn(pr, dp[j][e] - (e & 1 ? delta.y : delta.x));
        }
      }
      store_ds_t_x6<NQ, X::kDsP>(dspl, X::kDsPlane, dp, warp * 16, sub,
                                 lane);
      // dV += P^T dO and dK += dS^T (q scale2) over the step's query rows
#pragma unroll
      for (int kk = 0; kk < NQ / 16; ++kk) {
        uint32_t pa[3][4];
        acc_as_a_x6(pa, s, kk);
#pragma unroll
        for (int n2 = 0; n2 < D / 16; ++n2) {
          uint32_t bo[3][4];
#pragma unroll
          for (int pl = 0; pl < 3; ++pl)
            b_frags_kn<D>(bo[pl], opl + pl * kQPlane, sub + 16 * kk, 16 * n2,
                          lane);
          mma_x6_add(dv[2 * n2], pa, bo[0], bo[1], bo[2]);
          mma_x6_add(dv[2 * n2 + 1], pa, bo[0] + 2, bo[1] + 2, bo[2] + 2);
        }
        uint32_t da[3][4];
        acc_as_a_x6(da, dp, kk);
#pragma unroll
        for (int n2 = 0; n2 < D / 16; ++n2) {
          uint32_t bq[3][4];
#pragma unroll
          for (int pl = 0; pl < 3; ++pl)
            b_frags_kn<D>(bq[pl], qpl + pl * kQPlane, sub + 16 * kk, 16 * n2,
                          lane);
          mma_x6_add(dk[2 * n2], da, bq[0], bq[1], bq[2]);
          mma_x6_add(dk[2 * n2 + 1], da, bq[0] + 2, bq[1] + 2, bq[2] + 2);
        }
      }
    }
    cp_async_wait<0>();   // tile it + 1 has landed
    // dS^T is whole, the planes of tile it are no longer read, and the
    // block's dQ adds of tile it - 1 were issued before the last barrier
    __syncthreads();
    if (tid == 0 && it > 0) store_release(order_of(it - 1), tile + 1);
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
          uint32_t bk[3][4];
#pragma unroll
          for (int pl = 0; pl < 3; ++pl)
            b_frags_kn<D>(bk[pl], kpl + pl * kKPlane, 16 * kk,
                          dq_c + n0 + 16 * n2, lane);
          mma_x6(dq[2 * n2], da, bk[0], bk[1], bk[2]);
          mma_x6(dq[2 * n2 + 1], da, bk[0] + 2, bk[1] + 2, bk[2] + 2);
        }
      }
    };
    // lanes t and t ^ 1 trade halves: even t then holds four columns of
    // row lane / 4, odd t four columns of row lane / 4 + 8
    const bool odd = lane & 1;
    const int r = i0 + dq_r + (lane >> 2) + (odd ? 8 : 0);
    float* dqg = static_cast<float*>(p.dq) + (tile_rows(it) + r) * D + dq_c +
                 2 * (lane & 2);
    auto add = [&](int n0) {
#pragma unroll
      for (int j = 0; j < kPiece / 8; ++j) {
        const float x = __shfl_xor_sync(kFull, odd ? dq[j][0] : dq[j][2], 1);
        const float y = __shfl_xor_sync(kFull, odd ? dq[j][1] : dq[j][3], 1);
        const float4 part = odd ? make_float4(x, y, dq[j][2], dq[j][3])
                                : make_float4(dq[j][0], dq[j][1], x, y);
        if (r < p.Lq)
          atomicAdd(reinterpret_cast<float4*>(dqg + n0 + 8 * j), part);
      }
    };
    if constexpr (kPiece == X::kDqCols) form(0);
    if (it + 1 < tiles) split_stage(it + 1);
    // key tiles 0 .. tile - 1 reach this chunk too, and add first; the
    // barrier inside also fences the planes of tile it + 1 and the stage
    await_turn(order_of(it), tile);
#pragma unroll
    for (int n0 = 0; n0 < X::kDqCols; n0 += kPiece) {
      if constexpr (kPiece != X::kDqCols) form(n0);
      add(n0);
    }
    // dS^T is read before the next tile's steps write it
    if constexpr (kPiece != X::kDqCols) __syncthreads();
    if (it + 2 < tiles) load_stage(it + 2);
    cp_async_commit();
  }

  __syncthreads();   // the last adds are issued before the release
  if (tid == 0 && tiles > 0) store_release(order_of(tiles - 1), tile + 1);
  store_rows_f32<D>(p.dk, kv_rows, kw, p.Lk, dk, p.scale / p.scale2, lane);
  store_rows_f32<D>(p.dv, kv_rows, kw, p.Lk, dv, 1.f, lane);
}

template <int D>
cudaError_t launch_x6(const BwdParams& p, cudaStream_t stream) {
  constexpr int kSmem = BwdX6<D>::kSmem;
  const int tiles = (p.Lk + kTcBlock - 1) / kTcBlock;
  if (tiles > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bwd_x6_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.Hkv, tiles);
  flash_attention_bwd_x6_kernel<D><<<grid, kTcThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_form(const BwdParams& p, bool x6, cudaStream_t stream) {
  return x6 ? launch_x6<D>(p, stream)
            : launch_kv_outer_tc<D, true>(flash_attention_bwd_tc_kernel<D>, p,
                                          stream);
}

}  // namespace

extern "C" {

// dtype: the _tc entry takes 1, bf16 (the tensor-core form), the _x6 entry
// 0, fp32.  q, k, v, dout, dk and dv share it.  dq: fp32 [B, H, Lq, d] and
// dq_order: int32 [B * H, ceil(Lq / chunk)], both zeroed; chunk is the
// form's query tile: 64 rows, and 32 in fp32 at d = 128.
#define TF_BWD_ENTRY(symbol, x6)                                               \
  int symbol(const void* q, const void* k, const void* v, const void* dout,   \
             const float* lse, const float* delta, float* dq, int* dq_order,  \
             void* dk, void* dv, int B, int H, int Hkv, int Lq, int Lk,       \
             int d, int dtype, int causal, int q_offset, float scale,         \
             float scale2, void* stream) {                                    \
    if (dtype != (x6 ? 0 : 1) ||                                              \
        !bwd_args_ok(dtype, H, Hkv, d, (long long)B * Hkv))                   \
      return cudaErrorInvalidValue;                                           \
    if (B == 0 || H == 0 || Lk == 0) return cudaSuccess;                      \
    const BwdParams p{q,  k,  v,        dout,        lse,   delta,            \
                      dq, dk, dv,       B,           H,     Hkv,              \
                      Lq, Lk, q_offset, causal != 0, scale, scale2,           \
                      dq_order};                                              \
    const cudaStream_t st = static_cast<cudaStream_t>(stream);               \
    switch (d) {                                                              \
      case 16: return launch_form<16>(p, x6, st);                             \
      case 32: return launch_form<32>(p, x6, st);                             \
      case 64: return launch_form<64>(p, x6, st);                             \
      case 128: return launch_form<128>(p, x6, st);                           \
    }                                                                         \
    return cudaErrorInvalidValue;                                             \
  }

TF_BWD_ENTRY(tf_flash_attention_bwd_tc, false)
TF_BWD_ENTRY(tf_flash_attention_bwd_x6, true)

}  // extern "C"
