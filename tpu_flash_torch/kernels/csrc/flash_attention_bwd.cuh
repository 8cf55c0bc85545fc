// What the flash-attention backward kernels share: the recompute of P and dS
// for one (query row, key) pair, and the KV-outer body that both the fused
// single pass (flash_attention_bwd.cu, with dQ) and the fp32 dK/dV pass of
// the two-pass form (flash_attention_bwd_two_pass.cu, without dQ) run.  The
// fp32 dQ pass calls the same recompute, so they cannot disagree on it, as
// tpu_flash/kernels/flash_attention.py shares _bwd_p_ds (:1107) between its
// fused, dK/dV and dQ kernels and _bwd_kv_outer_body (:1254) between the
// first two.  The two passes' bf16 tensor-core forms apply bwd_p_ds's
// arithmetic to whole accumulator fragments (BwdParams and bwd_lse2 from
// here).
//
// Numerics follow the TPU kernels: base-2 softmax with scale * log2(e) folded
// into q; fp32 dots are exact FMAs (never TF32); with bf16 inputs the scaled
// q, P before dV, and dS before dK and dQ are rounded to bf16; every sum is
// fp32.  A row whose lse is -inf (it saw no key) gets P = 0, not exp(+inf),
// so its dS and dQ are 0.
//
// kernels/common.py hashes every .cuh into each library's name, so an edit
// here rebuilds every kernel that includes it.

#pragma once

#include <math.h>

#include "common.cuh"

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
  int* dq_order;       // fused: int32 [B * H, ceil(Lq / kQC)] zeroed by the
                       // caller, the dQ adds made to each query chunk
};

// lse in base 2; +inf for a row that saw no key, so that its P is 0.
__device__ __forceinline__ float bwd_lse2(float lse) {
  return lse == -INFINITY ? INFINITY : lse * kBwdLog2e;
}

// q * scale * log2(e), rounded to bf16 where the inputs are bf16.
template <bool BF16>
__device__ __forceinline__ float bwd_scaled_q(float x, float scale2) {
  const float y = x * scale2;
  return BF16 ? round_bf16(y) : y;
}

struct PDs {
  float p;   // P as dV's operand
  float ds;  // dS as dK's and dQ's operand
};

// P = exp2(s2 - lse2) and dS = P * (dP - D) of one pair from its base-2
// score s2 and dP = dO . v; a key the row may not see has P = 0.
template <bool BF16>
__device__ __forceinline__ PDs bwd_p_ds(float s2, float dp, float lse2,
                                        float delta, bool visible) {
  const float pr = visible ? exp2f(s2 - lse2) : 0.f;
  const float ds = pr * (dp - delta);
  return {BF16 ? round_bf16(pr) : pr, BF16 ? round_bf16(ds) : ds};
}

template <bool BF16>
__device__ __forceinline__ void store_as(void* base, size_t off, float x) {
  if constexpr (BF16)
    static_cast<__nv_bfloat16*>(base)[off] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(base)[off] = x;
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

// --- the KV-outer body ------------------------------------------------------
//
// One block per (batch * KV head, tile of kKeys keys).  A key belongs to
// D / 16 threads, each owning 16 head dims of its k, v, dK and dV rows in
// registers; the block walks the query rows that can see its keys (the
// causal limit sets the first one, so dead tiles are never loaded), kQC rows
// at a time, for each query head of the GQA group, and sums dK and dV over
// the group in fp32 before writing scale * dK and dV once in the input dtype.
// A chunk's q, q * scale * log2(e) and dO rows are staged in shared memory in
// fp32; the threads of a warp read the same query row at a time (broadcast
// 16-byte loads), and the partial dots over a thread's 16 dims meet through
// shuffles.  With kDQ (the fused pass) the chunk's dS [kKeys, kQC] also goes
// to shared memory, and the block forms dQ [kQC, D] = dS^T K as a small
// product (each thread 2 rows x 4 dims) added to the fp32 workspace in a
// fixed order, so that two calls give the same bits:
//   * the blocks of a (batch * query head) that reach a query chunk add
//     their parts in the order of their key tiles, each after waiting on
//     the chunk's counter in dq_order (acquire) to count the tiles below
//     it, then bumping it (release).  Chunks start at multiples of kQC in
//     every block (rows before a tile's causal limit see none of its keys
//     and add 0), so the blocks agree on what a chunk is;
//   * the block walks its query chunks from the last down to its causal
//     limit, so every tile reaches a given chunk after the same number of
//     chunks: the tiles of a head move in step, tile t one add behind tile
//     t - 1 after the first chunk, and seldom wait;
//   * blockIdx.x is the key tile, so a block waits only on blocks
//     dispatched before it (blocks are dispatched in increasing index),
//     which are running or done: spinning blocks cannot hold the SMs that
//     the blocks they wait on need.  The low tiles, which walk the most
//     chunks, start first.
// The dK/dV pass (kDQ false) walks its chunks upward from its causal limit.

constexpr int kKeys = 64;   // keys per block
constexpr int kDt = 16;     // head dims per thread
constexpr int kQC = 32;     // query rows per chunk
constexpr int kDsPitch = kQC + 2;

template <int D>
__host__ __device__ constexpr int kv_outer_threads() {
  return kKeys * (D / kDt);
}

template <int D, bool kDQ>
__host__ __device__ constexpr size_t kv_outer_smem_bytes() {
  return sizeof(float) * (3 * kQC * D + 2 * kQC +
                          (kDQ ? kKeys * D + kKeys * kDsPitch : 0));
}

template <int D, bool BF16, bool kDQ>
__device__ __forceinline__ void kv_outer_body(const BwdParams& p) {
  constexpr int kTpk = D / kDt;            // threads per key
  constexpr int kKeysPerWarp = 32 / kTpk;
  constexpr int kThreads = kv_outer_threads<D>();
  constexpr int kCols = D / 4;             // float4 columns of a dQ row
  constexpr int kGroups = kThreads / kCols;
  constexpr int kRq = kQC / kGroups;       // dQ rows per thread
  static_assert(kGroups * kRq == kQC, "dQ mapping");
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kQC][D] q
  float* qss = qs + kQC * D;                     // [kQC][D] q * scale2
  float* dos = qss + kQC * D;                    // [kQC][D] dO
  float* lse2 = dos + kQC * D;                   // [kQC] lse * log2(e)
  float* dls = lse2 + kQC;                       // [kQC] delta
  float* ks = dls + kQC;                         // [kKeys][D] (kDQ)
  float* dss = ks + kKeys * D;                   // [kKeys][kDsPitch] (kDQ)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int part = lane / kKeysPerWarp;
  const int key_in_block = warp * kKeysPerWarp + lane % kKeysPerWarp;
  const int tile = blockIdx.x;
  const int k0 = tile * kKeys;
  const int bhk = blockIdx.y, b = bhk / p.Hkv, hk = bhk % p.Hkv;
  const int g = p.H / p.Hkv;
  const int j = k0 + key_in_block;
  const bool key_ok = j < p.Lk;

  const size_t kv_off = (((size_t)b * p.Hkv + hk) * p.Lk + (key_ok ? j : 0)) *
                            D + part * kDt;
  float kr[kDt], vr[kDt], dk[kDt], dv[kDt];
#pragma unroll
  for (int e = 0; e < kDt; e += 8) {
    load8<BF16>(p.k, kv_off + e, kr + e);
    load8<BF16>(p.v, kv_off + e, vr + e);
  }
#pragma unroll
  for (int e = 0; e < kDt; ++e) {
    if (!key_ok) kr[e] = vr[e] = 0.f;
    if constexpr (kDQ) ks[key_in_block * D + part * kDt + e] = kr[e];
    dk[e] = dv[e] = 0.f;
  }

  // The first query row that can see key k0; fused, rounded down to a
  // chunk's start.  chunks: the query chunks the block walks for a head.
  int q_start = p.causal ? max(0, k0 - p.q_offset) : 0;
  if constexpr (kDQ) q_start -= q_start % kQC;
  const int chunks = q_start < p.Lq ? (p.Lq - q_start + kQC - 1) / kQC : 0;
  const int cc = tid % kCols, grp = tid / kCols;   // dQ mapping

  // (query head u of the group, chunk c): the dK/dV pass walks each head's
  // chunks upward in turn; the fused pass walks the chunks from the last
  // down, each for every head, so that the tiles stay in step across heads
  // (see the order of the dQ adds)
  for (int it = 0; it < g * chunks; ++it) {
    const int u = kDQ ? it % g : it / chunks, ci = kDQ ? it / g : it % chunks;
    const int bh = b * p.H + hk * g + u;
    const int i0 = q_start + (kDQ ? chunks - 1 - ci : ci) * kQC;
    __syncthreads();  // the previous chunk's rows are no longer read
    for (int idx = tid; idx < kQC * D / 8; idx += kThreads) {
      const int rr = idx / (D / 8), c = (idx % (D / 8)) * 8;
      const int i = i0 + rr;
      float fq[8], fd[8];
      if (i < p.Lq) {
        const size_t off = ((size_t)bh * p.Lq + i) * D + c;
        load8<BF16>(p.q, off, fq);
        load8<BF16>(p.dout, off, fd);
      } else {
#pragma unroll
        for (int t = 0; t < 8; ++t) fq[t] = fd[t] = 0.f;
      }
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        qs[rr * D + c + t] = fq[t];
        qss[rr * D + c + t] = bwd_scaled_q<BF16>(fq[t], p.scale2);
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

    // dV, dK and this chunk's dS, one query row at a time.
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
      const PDs pd = bwd_p_ds<BF16>(s, dp, lse2[rr], dls[rr], visible);
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
      if constexpr (kDQ)
        if (part == 0) dss[key_in_block * kDsPitch + rr] = pd.ds;
    }

    if constexpr (kDQ) {
      __syncthreads();
      // dQ rows of the chunk: [kQC, D] = dS^T [kQC, kKeys] . K [kKeys, D].
      float acc[kRq][4];
#pragma unroll
      for (int t = 0; t < kRq; ++t)
        acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
      for (int jj = 0; jj < kKeys; ++jj) {
        const float4 kv =
            *reinterpret_cast<const float4*>(ks + jj * D + cc * 4);
#pragma unroll
        for (int t = 0; t < kRq; ++t) {
          const float w = dss[jj * kDsPitch + grp * kRq + t];
          acc[t][0] = fmaf(w, kv.x, acc[t][0]);
          acc[t][1] = fmaf(w, kv.y, acc[t][1]);
          acc[t][2] = fmaf(w, kv.z, acc[t][2]);
          acc[t][3] = fmaf(w, kv.w, acc[t][3]);
        }
      }
      // Tiles 0 .. tile - 1 reach this chunk too, and add first.
      int* order = p.dq_order + (size_t)bh * ((p.Lq + kQC - 1) / kQC) +
                   i0 / kQC;
      if (tid == 0)
        for (long long spins = 0; load_acquire(order) < tile; ++spins) {
          // an add that never comes (seconds): fail the launch, not hang
          if (spins > (1ll << 26)) __trap();
          __nanosleep(32);
        }
      __syncthreads();
      float* dq = static_cast<float*>(p.dq);
#pragma unroll
      for (int t = 0; t < kRq; ++t) {
        const int i = i0 + grp * kRq + t;
        if (i < p.Lq) {
          float4* at = reinterpret_cast<float4*>(
              dq + ((size_t)bh * p.Lq + i) * D + cc * 4);
          float4 sum = __ldcg(at);
          sum.x += acc[t][0];
          sum.y += acc[t][1];
          sum.z += acc[t][2];
          sum.w += acc[t][3];
          __stcg(at, sum);
        }
      }
      __syncthreads();   // every thread's add is made before the release
      if (tid == 0) store_release(order, tile + 1);
    }
  }

  if (!key_ok) return;
#pragma unroll
  for (int e = 0; e < kDt; ++e) {
    store_as<BF16>(p.dk, kv_off + e, p.scale * dk[e]);
    store_as<BF16>(p.dv, kv_off + e, dv[e]);
  }
}

// Launches kernel<D, BF16> over the KV-outer grid with its shared memory.
template <int D, bool kDQ, typename Kernel>
cudaError_t launch_kv_outer(Kernel kernel, const BwdParams& p,
                            cudaStream_t stream) {
  constexpr size_t kSmem = kv_outer_smem_bytes<D, kDQ>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lk + kKeys - 1) / kKeys, p.B * p.Hkv);
  kernel<<<grid, kv_outer_threads<D>(), kSmem, stream>>>(p);
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
