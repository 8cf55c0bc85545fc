// Flash-attention backward, single pass in KV-outer order, for sm_90a.
//
// Replaces tpu_flash/kernels/flash_attention.py::_bwd_fused_kernel
// (flash_attention.py:1228) and its body _bwd_kv_outer_body (:1254), launched
// by pl.pallas_call at :2045.  From q [B, H, Lq, D], k and v [B, Hkv, Lk, D],
// dO [B, H, Lq, D] (fp32 or bf16), the saved lse and delta = rowsum(dO * O)
// - dlse (fp32 [B, H, Lq], formed by the caller) it computes
//   P  = exp(S - lse),  dP = dO V^T,  dS = P * (dP - delta),
//   dV = P^T dO,  dK = scale * dS^T Q,  dQ = scale * dS K.
// dK and dV ([B, Hkv, Lk, D], the input dtype) are summed over the query heads
// of each GQA group inside the block, in fp32.  dQ is added with fp32 atomics
// into a zeroed [B, H, Lq, D] fp32 workspace that the caller scales and casts:
// the TPU keeps it race-free by running one (batch, head) in order against a
// full-sequence VMEM scratch (:1290-1293), which does not fit in a Hopper
// block's 227 KB of shared memory at L = 2048; the original CUDA kernel
// (src/flash_attn2_bw.cpp:228) used atomics too.
//
// What bounds it: operations (five L^2 * D products, 4.3e10 useful flops at
// B4 H8 L2048 d64 causal, against ~50 MB of traffic).  Design:
//   * one block per (batch * KV head, tile of kKeys keys).  A key belongs to
//     D / 16 threads, each owning 16 head dims of its k, v, dK and dV rows in
//     registers; the block walks the query rows that can see its keys
//     (the causal limit sets the first one, so dead tiles are never loaded),
//     kQC rows at a time, for each query head of the group;
//   * a chunk's q, q * scale * log2(e), and dO rows are staged in shared
//     memory in fp32; threads of a warp read the same query row at a time
//     (broadcast 16-byte loads).  The partial dots over a thread's 16 dims
//     meet through shuffles;
//   * after a chunk, dS [kKeys, kQC] sits in shared memory and the block
//     forms dQ [kQC, D] = dS^T K as a small product (each thread 2 rows x 4
//     dims) and adds it to the workspace with one 16-byte atomic per 4 dims.
// Numerics follow the TPU kernel: fp32 dots are exact FMAs (never TF32); with
// bf16 inputs q * scale * log2(e) is rounded to bf16 before the score dot, P
// to bf16 before dV, and dS to bf16 before dK and dQ; every sum is fp32.  A
// row whose lse is -inf (it saw no key) gets P = 0, not exp(+inf), so its dQ
// is 0.  Tensor cores, TMA and pipelining are later work (ROADMAP.md).
//
// C entry: tf_flash_attention_bwd(...) launches on the given stream,
// allocates nothing and returns cudaGetLastError() (or cudaErrorInvalidValue
// for a shape or dtype it does not take).

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kKeys = 64;   // keys per block
constexpr int kDt = 16;     // head dims per thread
constexpr int kQC = 32;     // query rows per chunk
constexpr int kDsPitch = kQC + 2;
constexpr float kLog2e = 1.4426950408889634f;

template <bool BF16>
__device__ __forceinline__ void store(void* base, size_t off, float x) {
  if constexpr (BF16)
    static_cast<__nv_bfloat16*>(base)[off] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(base)[off] = x;
}

__device__ __forceinline__ void atomic_add4(float* addr, float4 v) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  atomicAdd(reinterpret_cast<float4*>(addr), v);
#else
  atomicAdd(addr, v.x);
  atomicAdd(addr + 1, v.y);
  atomicAdd(addr + 2, v.z);
  atomicAdd(addr + 3, v.w);
#endif
}

struct Params {
  const void* q;       // [B, H, Lq, D]
  const void* k;       // [B, Hkv, Lk, D]
  const void* v;
  const void* dout;    // [B, H, Lq, D]
  const float* lse;    // [B, H, Lq]
  const float* delta;  // [B, H, Lq]
  float* dq;           // [B, H, Lq, D] fp32, zeroed by the caller
  void* dk;            // [B, Hkv, Lk, D], the input dtype
  void* dv;
  int B, H, Hkv, Lq, Lk, q_offset, causal;
  float scale, scale2;  // softmax scale, and scale * log2(e)
};

template <int D>
__host__ __device__ constexpr int block_threads() { return kKeys * (D / kDt); }

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kKeys * D + 3 * kQC * D + kKeys * kDsPitch + 2 * kQC);
}

template <int D, bool BF16>
__global__ void __launch_bounds__(block_threads<D>())
flash_attention_bwd_kernel(const Params p) {
  constexpr int kTpk = D / kDt;            // threads per key
  constexpr int kKeysPerWarp = 32 / kTpk;
  constexpr int kThreads = block_threads<D>();
  constexpr int kCols = D / 4;             // float4 columns of a dQ row
  constexpr int kGroups = kThreads / kCols;
  constexpr int kRq = kQC / kGroups;       // dQ rows per thread
  static_assert(kGroups * kRq == kQC, "dQ mapping");
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [kKeys][D]
  float* qs = ks + kKeys * D;                    // [kQC][D] q
  float* qss = qs + kQC * D;                     // [kQC][D] q * scale2
  float* dos = qss + kQC * D;                    // [kQC][D] dO
  float* dss = dos + kQC * D;                    // [kKeys][kDsPitch] dS
  float* lse2 = dss + kKeys * kDsPitch;          // [kQC] lse * log2(e)
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
    load8<BF16>(p.k, kv_off + e, kr + e);
    load8<BF16>(p.v, kv_off + e, vr + e);
  }
#pragma unroll
  for (int e = 0; e < kDt; ++e) {
    if (!key_ok) kr[e] = vr[e] = 0.f;
    ks[key_in_block * D + part * kDt + e] = kr[e];
    dk[e] = dv[e] = 0.f;
  }

  // The first query row that can see key k0.
  const int q_start = p.causal ? max(0, k0 - p.q_offset) : 0;
  const int cc = tid % kCols, grp = tid / kCols;   // dQ mapping

  for (int u = 0; u < g; ++u) {
    const int bh = b * p.H + hk * g + u;
    for (int i0 = q_start; i0 < p.Lq; i0 += kQC) {
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
          const float x = fq[t] * p.scale2;
          qs[rr * D + c + t] = fq[t];
          qss[rr * D + c + t] = BF16 ? round_bf16(x) : x;
          dos[rr * D + c + t] = fd[t];
        }
      }
      for (int rr = tid; rr < kQC; rr += kThreads) {
        const int i = i0 + rr;
        float l2 = INFINITY, dl = 0.f;  // rows past Lq: P = 0
        if (i < p.Lq) {
          const float lse = p.lse[(size_t)bh * p.Lq + i];
          l2 = lse == -INFINITY ? INFINITY : lse * kLog2e;
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
        const float pr = visible ? exp2f(s - lse2[rr]) : 0.f;
        const float ds = pr * (dp - dls[rr]);
        const float pb = BF16 ? round_bf16(pr) : pr;
        const float dsb = BF16 ? round_bf16(ds) : ds;
#pragma unroll
        for (int e = 0; e < kDt; e += 4) {
          const float4 a = *reinterpret_cast<const float4*>(qrow + e);
          const float4 d = *reinterpret_cast<const float4*>(drow + e);
          dv[e] = fmaf(pb, d.x, dv[e]);
          dv[e + 1] = fmaf(pb, d.y, dv[e + 1]);
          dv[e + 2] = fmaf(pb, d.z, dv[e + 2]);
          dv[e + 3] = fmaf(pb, d.w, dv[e + 3]);
          dk[e] = fmaf(dsb, a.x, dk[e]);
          dk[e + 1] = fmaf(dsb, a.y, dk[e + 1]);
          dk[e + 2] = fmaf(dsb, a.z, dk[e + 2]);
          dk[e + 3] = fmaf(dsb, a.w, dk[e + 3]);
        }
        if (part == 0) dss[key_in_block * kDsPitch + rr] = dsb;
      }
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
#pragma unroll
      for (int t = 0; t < kRq; ++t) {
        const int i = i0 + grp * kRq + t;
        if (i < p.Lq)
          atomic_add4(p.dq + ((size_t)bh * p.Lq + i) * D + cc * 4,
                      make_float4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]));
      }
    }
  }

  if (!key_ok) return;
#pragma unroll
  for (int e = 0; e < kDt; ++e) {
    store<BF16>(p.dk, kv_off + e, p.scale * dk[e]);
    store<BF16>(p.dv, kv_off + e, dv[e]);
  }
}

template <int D, bool BF16>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t kSmem = smem_bytes<D>();
  auto kernel = flash_attention_bwd_kernel<D, BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lk + kKeys - 1) / kKeys, p.B * p.Hkv);
  kernel<<<grid, block_threads<D>(), kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dtype(const Params& p, int bf16, cudaStream_t stream) {
  return bf16 ? launch<D, true>(p, stream) : launch<D, false>(p, stream);
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16 (q, k, v, dout, dk and dv share it).
int tf_flash_attention_bwd(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, float* dq, void* dk, void* dv,
                           int B, int H, int Hkv, int Lq, int Lk, int d,
                           int dtype, int causal, int q_offset, float scale,
                           float scale2, void* stream) {
  if ((dtype != 0 && dtype != 1) || Hkv <= 0 || H % Hkv ||
      B * Hkv > 65535)
    return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || Lk == 0) return cudaSuccess;
  const Params p{q, k, v, dout, lse, delta, dq, dk, dv, B, H, Hkv, Lq, Lk,
                 q_offset, causal != 0, scale, scale2};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_dtype<16>(p, dtype, st);
    case 32: return launch_dtype<32>(p, dtype, st);
    case 64: return launch_dtype<64>(p, dtype, st);
    case 128: return launch_dtype<128>(p, dtype, st);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
