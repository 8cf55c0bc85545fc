// What the flash-attention backward kernels share: the recompute of P and dS
// for one (query row, key) pair, and the KV-outer bodies: kv_outer_body, the
// fp32 dK/dV pass of the two-pass form on the CUDA cores
// (flash_attention_bwd_two_pass.cu), and kv_outer_tc_body on the tensor
// cores (bf16), which both the fused single pass (flash_attention_bwd.cu,
// with dQ) and the bf16 dK/dV pass (without dQ) run.  The fp32 dQ pass calls
// the same recompute, so they cannot disagree on it, as
// tpu_flash/kernels/flash_attention.py shares _bwd_p_ds (:1107) between its
// fused, dK/dV and dQ kernels and _bwd_kv_outer_body (:1254) between the
// first two.  The tensor-core forms apply bwd_p_ds's arithmetic to whole
// accumulator fragments.
//
// Numerics follow the TPU kernels: base-2 softmax with scale * log2(e) folded
// into q; fp32 dots here are exact FMAs (never TF32); with bf16 inputs the
// scaled q, P before dV, and dS before dK and dQ are rounded to bf16; every
// sum is fp32.  A row whose lse is -inf (it saw no key) gets P = 0, not
// exp(+inf), so its dS and dQ are 0.
//
// kernels/common.py hashes every .cuh into each library's name, so an edit
// here rebuilds every kernel that includes it.

#pragma once

#include <math.h>

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

// lse in base 2; +inf for a row that saw no key, so that its P is 0.
__device__ __forceinline__ float bwd_lse2(float lse) {
  return lse == -INFINITY ? INFINITY : lse * kBwdLog2e;
}

struct PDs {
  float p;   // P as dV's operand
  float ds;  // dS as dK's and dQ's operand
};

// P = exp2(s2 - lse2) and dS = P * (dP - D) of one pair from its base-2
// score s2 and dP = dO . v; a key the row may not see has P = 0.
__device__ __forceinline__ PDs bwd_p_ds(float s2, float dp, float lse2,
                                        float delta, bool visible) {
  const float pr = visible ? exp2f(s2 - lse2) : 0.f;
  return {pr, pr * (dp - delta)};
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

// --- the KV-outer body (the fp32 dK/dV pass) -------------------------------
//
// One block per (batch * KV head, tile of kKeys keys).  A key belongs to
// D / 16 threads, each owning 16 head dims of its k, v, dK and dV rows in
// registers; the block walks the query rows that can see its keys (the
// causal limit sets the first one, so dead tiles are never loaded), kQC rows
// at a time, for each query head of the GQA group in turn, chunks upward,
// and sums dK and dV over the group in fp32 before writing scale * dK and dV
// once in the input dtype.  A chunk's q, q * scale * log2(e) and dO rows are
// staged in shared memory in fp32; the threads of a warp read the same query
// row at a time (broadcast 16-byte loads), and the partial dots over a
// thread's 16 dims meet through shuffles.

constexpr int kKeys = 64;   // keys per block
constexpr int kDt = 16;     // head dims per thread
constexpr int kQC = 32;     // query rows per chunk

template <int D>
__host__ __device__ constexpr int kv_outer_threads() {
  return kKeys * (D / kDt);
}

template <int D>
__host__ __device__ constexpr size_t kv_outer_smem_bytes() {
  return sizeof(float) * (3 * kQC * D + 2 * kQC);
}

template <int D>
__device__ __forceinline__ void kv_outer_body(const BwdParams& p) {
  constexpr int kTpk = D / kDt;            // threads per key
  constexpr int kKeysPerWarp = 32 / kTpk;
  constexpr int kThreads = kv_outer_threads<D>();
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kQC][D] q
  float* qss = qs + kQC * D;                     // [kQC][D] q * scale2
  float* dos = qss + kQC * D;                    // [kQC][D] dO
  float* lse2 = dos + kQC * D;                   // [kQC] lse * log2(e)
  float* dls = lse2 + kQC;                       // [kQC] delta

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int part = lane / kKeysPerWarp;
  const int key_in_block = warp * kKeysPerWarp + lane % kKeysPerWarp;
  const int k0 = blockIdx.x * kKeys;
  const int bhk = blockIdx.y, b = bhk / p.Hkv, hk = bhk % p.Hkv;
  const int g = p.H / p.Hkv;
  const int j = k0 + key_in_block;
  const bool key_ok = j < p.Lk;

  const size_t kv_off = (((size_t)b * p.Hkv + hk) * p.Lk + (key_ok ? j : 0)) *
                            D + part * kDt;
  float kr[kDt], vr[kDt], dk[kDt], dv[kDt];
#pragma unroll
  for (int e = 0; e < kDt; e += 8) {
    load8<false>(p.k, kv_off + e, kr + e);
    load8<false>(p.v, kv_off + e, vr + e);
  }
#pragma unroll
  for (int e = 0; e < kDt; ++e) {
    if (!key_ok) kr[e] = vr[e] = 0.f;
    dk[e] = dv[e] = 0.f;
  }

  // The first query row that can see key k0, and the query chunks the
  // block walks for a head.
  const int q_start = p.causal ? max(0, k0 - p.q_offset) : 0;
  const int chunks = q_start < p.Lq ? (p.Lq - q_start + kQC - 1) / kQC : 0;

  for (int it = 0; it < g * chunks; ++it) {
    const int bh = b * p.H + hk * g + it / chunks;
    const int i0 = q_start + (it % chunks) * kQC;
    __syncthreads();  // the previous chunk's rows are no longer read
    for (int idx = tid; idx < kQC * D / 8; idx += kThreads) {
      const int rr = idx / (D / 8), c = (idx % (D / 8)) * 8;
      const int i = i0 + rr;
      float fq[8], fd[8];
      if (i < p.Lq) {
        const size_t off = ((size_t)bh * p.Lq + i) * D + c;
        load8<false>(p.q, off, fq);
        load8<false>(p.dout, off, fd);
      } else {
#pragma unroll
        for (int t = 0; t < 8; ++t) fq[t] = fd[t] = 0.f;
      }
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        qs[rr * D + c + t] = fq[t];
        qss[rr * D + c + t] = fq[t] * p.scale2;
        dos[rr * D + c + t] = fd[t];
      }
    }
    for (int rr = tid; rr < kQC; rr += kThreads) {
      const int i = i0 + rr;
      float l2 = INFINITY, dl = 0.f;  // rows past Lq: P = 0
      if (i < p.Lq) {
        l2 = bwd_lse2(p.lse[(size_t)bh * p.Lq + i]);
        dl = p.delta[(size_t)bh * p.Lq + i];
      }
      lse2[rr] = l2;
      dls[rr] = dl;
    }
    __syncthreads();

    // dV and dK, one query row at a time.
    for (int rr = 0; rr < kQC; ++rr) {
      const float* qrow = qs + rr * D + part * kDt;
      const float* qsrow = qss + rr * D + part * kDt;
      const float* drow = dos + rr * D + part * kDt;
      float s4[4] = {0.f, 0.f, 0.f, 0.f}, dp4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int e = 0; e < kDt; e += 4) {
        const float4 a = *reinterpret_cast<const float4*>(qsrow + e);
        const float4 d = *reinterpret_cast<const float4*>(drow + e);
        s4[0] = fmaf(a.x, kr[e], s4[0]);
        s4[1] = fmaf(a.y, kr[e + 1], s4[1]);
        s4[2] = fmaf(a.z, kr[e + 2], s4[2]);
        s4[3] = fmaf(a.w, kr[e + 3], s4[3]);
        dp4[0] = fmaf(d.x, vr[e], dp4[0]);
        dp4[1] = fmaf(d.y, vr[e + 1], dp4[1]);
        dp4[2] = fmaf(d.z, vr[e + 2], dp4[2]);
        dp4[3] = fmaf(d.w, vr[e + 3], dp4[3]);
      }
      float s = (s4[0] + s4[1]) + (s4[2] + s4[3]);
      float dp = (dp4[0] + dp4[1]) + (dp4[2] + dp4[3]);
#pragma unroll
      for (int off = kKeysPerWarp; off < 32; off <<= 1) {
        s += __shfl_xor_sync(kFull, s, off);
        dp += __shfl_xor_sync(kFull, dp, off);
      }
      const int i = i0 + rr;
      const bool visible = key_ok && (!p.causal || j <= i + p.q_offset);
      const PDs pd = bwd_p_ds(s, dp, lse2[rr], dls[rr], visible);
#pragma unroll
      for (int e = 0; e < kDt; e += 4) {
        const float4 a = *reinterpret_cast<const float4*>(qrow + e);
        const float4 d = *reinterpret_cast<const float4*>(drow + e);
        dv[e] = fmaf(pd.p, d.x, dv[e]);
        dv[e + 1] = fmaf(pd.p, d.y, dv[e + 1]);
        dv[e + 2] = fmaf(pd.p, d.z, dv[e + 2]);
        dv[e + 3] = fmaf(pd.p, d.w, dv[e + 3]);
        dk[e] = fmaf(pd.ds, a.x, dk[e]);
        dk[e + 1] = fmaf(pd.ds, a.y, dk[e + 1]);
        dk[e + 2] = fmaf(pd.ds, a.z, dk[e + 2]);
        dk[e + 3] = fmaf(pd.ds, a.w, dk[e + 3]);
      }
    }
  }

  if (!key_ok) return;
#pragma unroll
  for (int e = 0; e < kDt; ++e) {
    static_cast<float*>(p.dk)[kv_off + e] = p.scale * dk[e];
    static_cast<float*>(p.dv)[kv_off + e] = dv[e];
  }
}

// Launches kernel<D> over the KV-outer grid with its shared memory.
template <int D, typename Kernel>
cudaError_t launch_kv_outer(Kernel kernel, const BwdParams& p,
                            cudaStream_t stream) {
  constexpr size_t kSmem = kv_outer_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lk + kKeys - 1) / kKeys, p.B * p.Hkv);
  kernel<<<grid, kv_outer_threads<D>(), kSmem, stream>>>(p);
  return cudaGetLastError();
}

// --- the KV-outer body on the tensor cores (bf16) ---------------------------
//
// The same walk as kv_outer_body, with every product an mma.sync (the TPU
// kernels feed their MXU the scaled q, P and dS rounded to bf16 with fp32
// sums, which is exactly a bf16 x bf16 -> fp32 product): one block of 4
// warps per (batch * KV head, tile of 64 keys), each warp owning 16 keys,
// whose k and v rows are its A fragments.  The query rows come in tiles of
// 64 through kStages shared-memory stages (q, q * scale2 and dO in bf16,
// lse2 and D in fp32), each thread's cp.async pieces for tile t + kStages - 1
// issued before tile t is computed.  A warp computes S^T = K (q scale2)^T
// and dP^T = V dO^T for NQ query rows at a time into m16n8 accumulators
// (rows keys, columns query rows, so lse2 and D are read by column), turns
// them into P^T and dS^T in place (bwd_p_ds's arithmetic; the element mask
// only in steps that cross the causal diagonal or the ragged end of Lq or
// Lk, a warp-uniform test), and feeds them, packed to bf16 pairs, as the A
// fragments of dV += P^T dO and dK += dS^T q (an m16n8 C tile is half an
// m16n8k16 A tile).  dK and dV are summed over the GQA group in fp32 and
// written once, scale * dK and dV in bf16.
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

template <int D, bool kDQ>
__host__ __device__ constexpr int kv_outer_tc_smem_bytes() {
  return 2 * TcShape<D>::kTileBytes +
         TcShape<D>::kStages * kv_tc_stage_bytes<D>() +
         (kDQ ? kTcBlock * kDsTPitch * 2 : 0);
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

template <int D, bool kDQ>
__device__ __forceinline__ void kv_outer_tc_body(const BwdParams& p) {
  using S = TcShape<D>;
  // query rows of S^T a warp holds at once: with dQ, 32 (at 64, d = 64
  // spills)
  constexpr int P = S::P, kStages = S::kStages, NQ = kDQ ? 32 : S::kStep;
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
  const int nt = q_start < p.Lq ? (p.Lq - q_start + kTcTile - 1) / kTcTile : 0;
  const int tiles = g * nt;

  load_tile<D>(ks, p.k, kv_rows, k0, p.Lk, tid);
  load_tile<D>(vs, p.v, kv_rows, k0, p.Lk, tid);
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
      const bool full = r0 + NQ <= p.Lq &&
                        !(p.causal && kw + 15 > r0 + p.q_offset);
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
      // P^T and dS^T in place; column c is query row i0 + c
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j) {
        const int c = sub + 8 * j + 2 * (lane & 3);
        const float2 lse2 = *reinterpret_cast<const float2*>(l2 + c);
        const float2 delta = *reinterpret_cast<const float2*>(dl + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pr = exp2f(s[j][e] - (e & 1 ? lse2.y : lse2.x));
          if (!full) {
            const int key = kw + (lane >> 2) + 8 * (e >> 1);
            const int i = i0 + c + (e & 1);
            if (i >= p.Lq || (p.causal && key > i + p.q_offset)) pr = 0.f;
          }
          s[j][e] = pr;
          dp[j][e] = pr * (dp[j][e] - (e & 1 ? delta.y : delta.x));
        }
      }
      if constexpr (kDQ) store_ds_t<NQ>(dst, dp, warp * 16, sub, lane);
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
      if (tid == 0 && it > 0) store_release(order_of(it - 1), tile + 1);
      if constexpr (kPiece == D) form(0);
      // key tiles 0 .. tile - 1 reach this chunk too, and add first
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

  if constexpr (kDQ)   // after the loop's last __syncthreads
    if (tid == 0 && tiles > 0) store_release(order_of(tiles - 1), tile + 1);
  store_rows<D>(p.dk, kv_rows, kw, p.Lk, dk, p.scale, lane);
  store_rows<D>(p.dv, kv_rows, kw, p.Lk, dv, 1.f, lane);
}

// Launches kernel<D> over the KV-outer grid of the tensor-core form, key
// tiles along y.
template <int D, bool kDQ, typename Kernel>
cudaError_t launch_kv_outer_tc(Kernel kernel, const BwdParams& p,
                               cudaStream_t stream) {
  constexpr int kSmem = kv_outer_tc_smem_bytes<D, kDQ>();
  const int tiles = (p.Lk + kTcBlock - 1) / kTcBlock;
  if (tiles > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.Hkv, tiles);
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

}  // namespace
