// Flash-decode attention over a heads-minor KV cache, for sm_90a.
//
// Replaces tpu_flash/kernels/decode.py::_decode_kernel (decode.py:93, launched
// by pl.pallas_call at decode.py:380).  Lq small query tokens per sequence
// (Lq <= 8 on the serving path) attend that sequence's cached prefix; query
// head h*g + u reads KV head h (GQA); an optional sliding window; int8 or
// float8_e4m3fn codes with per-(sequence, KV head, position) fp32 scales.
//
// What bounds it: HBM bytes.  For each (sequence, KV head) the K and V
// stripes of every live position (d * itemsize bytes each) must be read once,
// plus two fp32 scales per position for a quantized cache; q and the output
// are a few KB.  A position costs about 4 * G * d flops for 2 * d * itemsize
// bytes (G query rows share it), far below the card's ~295 flops per byte, so
// tensor cores would not help and the design is about the memory system.
// The first form (a block of 8 warps for each (sequence, KV head), 128 at
// the serving shape, one an SM; each lane's K and V loads in registers, 32
// KB in flight an SM, waited on before the next were issued) was held by
// latency (PERF.md).  This form:
//   * split-KV over a thread-block cluster, one launch: each (sequence,
//     group of KV heads, chunk of query rows) is a cluster of C <= 8 blocks
//     (C from kernels/decode.py _plan, so that the blocks fill the card
//     about once: 128 blocks at the serving shape, clusters of 2 over an
//     int8 cache and none over bf16; more, smaller blocks were slower).
//     The positions to read, [first position of the window, min(length,
//     S)), are read on the device with no host sync and cut into C equal
//     shares, block r of the cluster taking the r-th: no position past the
//     length is loaded (the TPU kernel's clamped index map,
//     decode.py:335-345), and a share may be empty (a length below C, a
//     window);
//   * a block takes the KV heads whose stripes of a position are at least
//     kChunkBytes contiguous bytes (the cache is heads-minor: 2 heads of
//     int8 at d = 64, 1 of bf16), a lane one head: 64-byte pieces scattered
//     1 KB apart read the HBM more slowly than 128-byte ones (PERF.md);
//   * each lane of the block's 8 warps streams the K and V pieces (and
//     scales) it will use through a ring of its own in shared memory:
//     kStages stages of kUnroll warp steps, each a 16-byte cp.async (4-byte
//     for a scale) zero-filled past the share, 8 positions' K and V a lane
//     and 64 KB a block in flight without holding registers; a lane reads
//     back only what it copied, so the ring needs no barrier, only
//     cp.async.wait_group;
//   * the G = Lq * g query rows of the group (token-major) share every
//     stripe they load: q, the scores, the online-softmax state and the fp32
//     accumulator stay in registers.  Each group of lanes keeps its own
//     running max over the positions it reads; the groups of a warp are
//     merged by shuffles, the warps through shared memory, and the blocks of
//     the cluster through distributed shared memory: each rank sends every
//     owner rank its share of the outputs (after the cluster barrier's
//     first phase, arrived at when the block starts), and after one more
//     barrier each owner merges what it received in rank order: the same
//     bits on every call, no workspace and no combine kernel.  A block
//     holds at most 32 / (values per 16-byte load) rows in registers;
//     larger groups take more clusters, each reading the stripes again;
//   * int8 codes become floats by a byte permute and an add (exact), not the
//     converter's quarter-rate instruction; fp8 codes by the converter; the
//     K scale multiplies the score and the V scale the probability, as on
//     the TPU.
// Numerics follow the TPU kernel: q * scale is rounded to q's dtype before the
// dot, sums are fp32, l sums p before the V scale, p * v_scale is rounded to
// q's dtype before P.V, and a row that sees no position outputs 0.
// Positions masked by the causal limit or the window get p = 0 and do not
// move the running max, which is what the TPU kernel's -1e7 mask amounts to.
//
// C entry: tf_flash_decode(...) launches on the given stream, allocates
// nothing and returns cudaGetLastError() (or cudaErrorInvalidValue for a
// shape, dtype or plan it does not take).

#include <cooperative_groups.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <math.h>

#include "mma.cuh"

namespace {

namespace cg = cooperative_groups;

enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2, kF8E4M3 = 3 };

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;      // warp steps (positions a lane) a ring stage
constexpr int kStages = 2;      // ring stages a lane
constexpr int kMaxCluster = 8;  // portable
constexpr int kChunkBytes = 128;  // contiguous cache bytes a position, at least
constexpr int kMaxHeads = 4;      // KV heads a block at most

// Four int8 codes (the low byte first) as floats, exactly: each code + 128
// as an unsigned byte u, the float 2^23 + u built by a byte permute, less
// 2^23 + 128.
__device__ __forceinline__ void i8x4(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7543)) - 8388736.f;
}

// Two e4m3 codes (the low byte is the first) to two floats, exactly.
__device__ __forceinline__ void e4m3x2(uint32_t w, float* f) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      (__nv_fp8x2_storage_t)(w & 0xffffu), __NV_E4M3);
  const float2 v = __half22float2(__half2(h));
  f[0] = v.x;
  f[1] = v.y;
}

// 16 bytes of cache -> kVec floats.
template <int KV> struct Codes;

template <> struct Codes<kF32> {
  static constexpr int kVec = 4;
  __device__ static void unpack(const uint4& w, float* f) {
    f[0] = __uint_as_float(w.x);
    f[1] = __uint_as_float(w.y);
    f[2] = __uint_as_float(w.z);
    f[3] = __uint_as_float(w.w);
  }
};

template <> struct Codes<kBF16> {
  static constexpr int kVec = 8;
  __device__ static void unpack(const uint4& w, float* f) {
    bf16x2(w.x, f);
    bf16x2(w.y, f + 2);
    bf16x2(w.z, f + 4);
    bf16x2(w.w, f + 6);
  }
};

template <> struct Codes<kI8> {
  static constexpr int kVec = 16;
  __device__ static void unpack(const uint4& w, float* f) {
    i8x4(w.x, f);
    i8x4(w.y, f + 4);
    i8x4(w.z, f + 8);
    i8x4(w.w, f + 12);
  }
};

template <> struct Codes<kF8E4M3> {
  static constexpr int kVec = 16;
  __device__ static void unpack(const uint4& w, float* f) {
    e4m3x2(w.x, f);
    e4m3x2(w.x >> 16, f + 2);
    e4m3x2(w.y, f + 4);
    e4m3x2(w.y >> 16, f + 6);
    e4m3x2(w.z, f + 8);
    e4m3x2(w.z >> 16, f + 10);
    e4m3x2(w.w, f + 12);
    e4m3x2(w.w >> 16, f + 14);
  }
};

struct Params {
  const void* q;          // [B, Hq, Lq, D] fp32 or bf16
  const void* k;          // [B, S, Hkv * D] codes
  const void* v;
  const float* k_scale;   // [B, Hkv, S] or null
  const float* v_scale;
  const int* lengths;     // [B]
  void* out;              // [B, Hq, Lq, D], q's dtype
  int B, Hq, Hkv, Lq, S;
  int q_bf16;
  float scale;
  int window;             // 0: none
  int chunks;             // clusters along the group's rows: ceil(G / RB)
};

// KV heads a block takes (a lane one head): enough that a position's
// stripes of them are kChunkBytes contiguous bytes (the heads-minor cache
// keeps them side by side), within a warp's lanes and kMaxHeads (kernels/
// decode.py _plan repeats this rule).
template <int D, int KV>
__host__ __device__ constexpr int heads_a_block() {
  constexpr int lanes = D / Codes<KV>::kVec;
  constexpr int want = kChunkBytes / (D * (16 / Codes<KV>::kVec));
  constexpr int h = want < 32 / lanes ? want : 32 / lanes;
  return h < 1 ? 1 : h > kMaxHeads ? kMaxHeads : h;
}

// Shared memory: the lanes' rings (K, V, and for a quantized cache the two
// scales: [kWarps][kStages][kUnroll][32] each), reused after the loop for
// the warps' merge: (m, l, acc) [kWarps][NR], [kWarps][NR], [kWarps][NR][D]
// for the block's NR = heads x RB rows; then, apart, what the cluster's
// ranks send this block: acc [C][per] (its share of the NR x D outputs,
// per = ceil(NR D / C)), m and l [C][NR] each.
template <int D, int KV, int RB>
__host__ __device__ constexpr int ring_bytes() {
  constexpr int slots = kWarps * kStages * kUnroll * 32;
  constexpr int ring =
      slots * (32 + (KV == kI8 || KV == kF8E4M3 ? 8 : 0));
  constexpr int merge = 4 * kWarps * heads_a_block<D, KV>() * RB * (D + 2);
  return ring > merge ? ring : merge;
}

template <int D, int KV, int RB>
__host__ __device__ constexpr int smem_bytes() {
  constexpr int nr = heads_a_block<D, KV>() * RB;
  return ring_bytes<D, KV, RB>() + 4 * (nr * D + kMaxCluster * (2 * nr + 1));
}

// One block an SM is the plan (the ring takes 64-80 KB): without the
// bound ptxas held some forms to 64 registers and spilled.
template <int D, int KV, int RB>
__global__ void __launch_bounds__(kThreads, 1)
flash_decode_kernel(const Params p) {
  constexpr int kVec = Codes<KV>::kVec;
  constexpr int kElt = 16 / kVec;     // bytes per code
  constexpr int kLanes = D / kVec;    // lanes per head's position stripe
  static_assert(kLanes >= 1 && kLanes <= 32 && 32 % kLanes == 0, "stripe");
  constexpr int kHeads = heads_a_block<D, KV>();
  constexpr int kPos = 32 / (kLanes * kHeads);  // positions per warp step
  constexpr int NR = kHeads * RB;     // the block's (head, row) pairs
  constexpr int kTile = kUnroll * kPos;  // positions of a warp's ring stage
  constexpr bool kScaled = KV == kI8 || KV == kF8E4M3;
  constexpr int kSlots = kWarps * kStages * kUnroll * 32;

  extern __shared__ __align__(16) unsigned char smem[];
  uint4* ring_k = reinterpret_cast<uint4*>(smem);
  uint4* ring_v = ring_k + kSlots;
  float* ring_ks = reinterpret_cast<float*>(ring_v + kSlots);
  float* ring_vs = ring_ks + kSlots;

  const cg::cluster_group cluster = cg::this_cluster();
  const int C = cluster.num_blocks(), rank = cluster.block_rank();
  if (C > 1) cluster_arrive_relaxed();   // phase 0: this block has started
  const int b = blockIdx.z / p.chunks, r0 = blockIdx.z % p.chunks * RB;
  const int g = p.Hq / p.Hkv, G = p.Lq * g;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // lane (sub, hh, part): the part-th 16 bytes of KV head h's stripe of
  // positions sub, sub + kPos, ...
  const int part = lane % kLanes, hh = lane / kLanes % kHeads;
  const int sub = lane / (kLanes * kHeads);
  const int h0 = blockIdx.y * kHeads, h = min(h0 + hh, p.Hkv - 1);
  const bool hlive = h0 + hh < p.Hkv;

  const int len = p.lengths[b];
  const int end = min(len, p.S);  // idle engine slots count past the buffer

  // Row r of the block is group row r0 + r: token i, query head h*g + u.
  // It attends positions in [first, limit).
  float q[RB][kVec];
  int limit[RB], first[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int row = r0 + r, i = row / g, u = row % g;
    const bool ok = row < G && hlive;
    limit[r] = row < G ? len - p.Lq + i + 1 : -1;
    first[r] = p.window > 0 ? limit[r] - p.window : 0;
    const size_t off =
        (((size_t)b * p.Hq + h * g + u) * p.Lq + i) * D + part * kVec;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      float x = 0.f;
      if (ok) {
        x = p.q_bf16 ? __bfloat162float(
                           static_cast<const __nv_bfloat16*>(p.q)[off + e])
                     : static_cast<const float*>(p.q)[off + e];
        x *= p.scale;
        if (p.q_bf16) x = round_bf16(x);
      }
      q[r][e] = x;
    }
  }
  // Rows ascend in i, so the block's first row has the lowest bound.  This
  // block's share of [start, end):
  const int start = p.window > 0 ? max(0, first[0]) : 0;
  const int share = (max(0, end - start) + C - 1) / C;
  const int s0 = min(end, start + rank * share), s1 = min(end, s0 + share);

  float m[RB], l[RB], acc[RB][kVec];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[r][e] = 0.f;
  }

  const size_t hd = (size_t)p.Hkv * D;
  const size_t row_bytes = hd * kElt;
  const size_t stripe = ((size_t)b * p.S * hd + (size_t)h * D) * kElt + part * 16;
  const uint8_t* kp = static_cast<const uint8_t*>(p.k) + stripe;
  const uint8_t* vp = static_cast<const uint8_t*>(p.v) + stripe;
  const size_t srow = ((size_t)b * p.Hkv + h) * p.S;
  const float* ksp = kScaled ? p.k_scale + srow : nullptr;
  const float* vsp = kScaled ? p.v_scale + srow : nullptr;

  // The warp takes the share's tiles of kTile positions warp, warp +
  // kWarps, ...; its j-th goes through ring stage j % kStages.  Each lane
  // copies and reads its own 16 bytes of positions sub, sub + kPos, ... of
  // the tile (none for a head past Hkv).
  const int ntiles = (s1 - s0 + kTile - 1) / kTile;
  const int mine = warp < ntiles ? (ntiles - 1 - warp) / kWarps + 1 : 0;
  const int slot0 = warp * kStages * kUnroll * 32 + lane;
  auto position = [&](int j, int t) {
    return s0 + ((warp + j * kWarps) * kUnroll + t) * kPos + sub;
  };
  auto issue = [&](int j) {
    const int st = j % kStages;
#pragma unroll
    for (int t = 0; t < kUnroll; ++t) {
      const int pos = position(j, t), i = slot0 + (st * kUnroll + t) * 32;
      const bool ok = hlive && pos < s1;
      const size_t o = ok ? pos * row_bytes : 0;
      cp_async16(ring_k + i, kp + o, ok);
      cp_async16(ring_v + i, vp + o, ok);
      if constexpr (kScaled) {
        cp_async4(ring_ks + i, ksp + (ok ? pos : 0), ok);
        cp_async4(ring_vs + i, vsp + (ok ? pos : 0), ok);
      }
    }
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < mine) issue(j);
    cp_async_commit();
  }

  for (int j = 0; j < mine; ++j) {
    if (j + kStages - 1 < mine) issue(j + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();   // this lane's copies of tile j landed
    const int st = j % kStages;
    uint4 kw[kUnroll], vw[kUnroll];
    float ks[kUnroll], vs[kUnroll];
    int pos[kUnroll];
#pragma unroll
    for (int t = 0; t < kUnroll; ++t) {
      const int i = slot0 + (st * kUnroll + t) * 32;
      pos[t] = position(j, t);
      kw[t] = ring_k[i];
      vw[t] = ring_v[i];
      ks[t] = kScaled ? ring_ks[i] : 1.f;
      vs[t] = kScaled ? ring_vs[i] : 1.f;
    }

    // Partial dots over this lane's kVec values, summed over the stripe's
    // lanes by a butterfly (every lane of the group gets the same sum).
    float s[RB][kUnroll];
#pragma unroll
    for (int t = 0; t < kUnroll; ++t) {
      float kf[kVec];
      Codes<KV>::unpack(kw[t], kf);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        float d0 = 0.f, d1 = 0.f;   // two chains: half the latency
#pragma unroll
        for (int e = 0; e < kVec; e += 2) {
          d0 = fmaf(q[r][e], kf[e], d0);
          d1 = fmaf(q[r][e + 1], kf[e + 1], d1);
        }
        s[r][t] = d0 + d1;
      }
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
#pragma unroll
        for (int t = 0; t < kUnroll; ++t)
          s[r][t] += __shfl_xor_sync(kFull, s[r][t], off);
      }
    }

    // Online softmax; s[r][t] becomes the weight of position t in P.V.
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      bool valid[kUnroll];
      float mx = m[r];
#pragma unroll
      for (int t = 0; t < kUnroll; ++t) {
        s[r][t] *= ks[t];
        valid[t] = hlive && pos[t] < s1 && pos[t] < limit[r] &&
                   pos[t] >= first[r];
        if (valid[t]) mx = fmaxf(mx, s[r][t]);
      }
      if (mx == -INFINITY) {  // nothing seen yet by this lane group
#pragma unroll
        for (int t = 0; t < kUnroll; ++t) s[r][t] = 0.f;
        continue;
      }
      const float alpha = __expf(m[r] - mx);  // 0 while m is -inf
      float psum = 0.f;
#pragma unroll
      for (int t = 0; t < kUnroll; ++t) {
        const float pt = valid[t] ? __expf(s[r][t] - mx) : 0.f;
        psum += pt;
        float w = pt * vs[t];
        if (p.q_bf16) w = round_bf16(w);
        s[r][t] = w;
      }
      l[r] = l[r] * alpha + psum;
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[r][e] *= alpha;
      m[r] = mx;
    }

#pragma unroll
    for (int t = 0; t < kUnroll; ++t) {
      float vf[kVec];
      Codes<KV>::unpack(vw[t], vf);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[r][e] = fmaf(s[r][t], vf[e], acc[r][e]);
      }
    }
  }
  cp_async_wait<0>();

  // Merge the lane groups of the warp (lanes that hold the same head's
  // stripe part).
#pragma unroll
  for (int off = kLanes * kHeads; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const float mo = __shfl_xor_sync(kFull, m[r], off);
      const float lo = __shfl_xor_sync(kFull, l[r], off);
      const float mn = fmaxf(m[r], mo);
      const float a = m[r] == -INFINITY ? 0.f : __expf(m[r] - mn);
      const float c = mo == -INFINITY ? 0.f : __expf(mo - mn);
      l[r] = l[r] * a + lo * c;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float ao = __shfl_xor_sync(kFull, acc[r][e], off);
        acc[r][e] = acc[r][e] * a + ao * c;
      }
      m[r] = mn;
    }
  }

  // The warps' merge takes the rings' place once every warp is done.
  float* sm_m = reinterpret_cast<float*>(smem);   // [kWarps][NR]
  float* sm_l = sm_m + kWarps * NR;                // [kWarps][NR]
  float* sm_acc = sm_l + kWarps * NR;              // [kWarps][NR][D]
  __syncthreads();
  if (sub == 0) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int k = (warp * kHeads + hh) * RB + r;
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        sm_acc[k * D + part * kVec + e] = acc[r][e];
      if (part == 0) {
        sm_m[k] = m[r];
        sm_l[k] = l[r];
      }
    }
  }
  __syncthreads();

  // (m, l, acc) of output idx = k * D + c (k = hh * RB + r) merged over n
  // parts in order: mpart(w, k), lpart(w, k), apart(w, idx).
  auto merged = [&](int n, auto mpart, auto lpart, auto apart, int idx) {
    const int k = idx / D;
    float mx = -INFINITY;
    for (int w = 0; w < n; ++w) mx = fmaxf(mx, mpart(w, k));
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < n; ++w) {
      const float mw = mpart(w, k);
      if (mw != -INFINITY) {
        const float f = __expf(mw - mx);
        lsum += lpart(w, k) * f;
        a += apart(w, idx) * f;
      }
    }
    return make_float3(mx, lsum, a);
  };
  auto store = [&](int idx, float lsum, float a) {
    const int k = idx / D, c = idx % D, row = r0 + k % RB;
    const int head = h0 + k / RB;
    if (row >= G || head >= p.Hkv) return;
    const float o = lsum > 0.f ? a / lsum : 0.f;
    const int i = row / g, u = row % g;
    const size_t off =
        (((size_t)b * p.Hq + head * g + u) * p.Lq + i) * D + c;
    if (p.q_bf16)
      static_cast<__nv_bfloat16*>(p.out)[off] = __float2bfloat16_rn(o);
    else
      static_cast<float*>(p.out)[off] = o;
  };
  auto wm = [&](int w, int k) { return sm_m[w * NR + k]; };
  auto wl = [&](int w, int k) { return sm_l[w * NR + k]; };
  auto wa = [&](int w, int idx) { return sm_acc[w * NR * D + idx]; };

  // Merge the warps: the output (one block), or this block's (m, l, acc)
  // sent to the rank that owns the output (the idx / per-th), into its
  // shared memory beside the other ranks'.
  constexpr int NO = NR * D;
  const int per = (NO + C - 1) / C;
  float* recv_a = reinterpret_cast<float*>(smem + ring_bytes<D, KV, RB>());
  float* recv_m = recv_a + NO + kMaxCluster;       // [C][NR]
  float* recv_l = recv_m + kMaxCluster * NR;       // [C][NR]
  if (C > 1) cluster_wait();   // phase 0: every block of the cluster started
  for (int idx = threadIdx.x; idx < NO; idx += kThreads) {
    const float3 v = merged(kWarps, wm, wl, wa, idx);
    if (C == 1) {
      store(idx, v.y, v.z);
      continue;
    }
    const int o = idx / per;
    cluster.map_shared_rank(recv_a, o)[rank * per + idx - o * per] = v.z;
    if (idx % D == 0) {
      for (int q = 0; q < C; ++q) {
        cluster.map_shared_rank(recv_m, q)[rank * NR + idx / D] = v.x;
        cluster.map_shared_rank(recv_l, q)[rank * NR + idx / D] = v.y;
      }
    }
  }
  if (C == 1) return;

  // Merge the ranks' parts of this block's outputs, in rank order, from its
  // own shared memory.  After the barrier no block touches another's.
  cluster_arrive();
  cluster_wait();
  auto rm = [&](int w, int k) { return recv_m[w * NR + k]; };
  auto rl = [&](int w, int k) { return recv_l[w * NR + k]; };
  auto ra = [&](int w, int idx) { return recv_a[w * per + idx - rank * per]; };
  const int hi = min(NO, (rank + 1) * per);
  for (int idx = rank * per + threadIdx.x; idx < hi; idx += kThreads) {
    const float3 v = merged(C, rm, rl, ra, idx);
    store(idx, v.y, v.z);
  }
}

template <int D, int KV, int RB>
cudaError_t launch(const Params& p, int cluster, cudaStream_t stream) {
  const auto kernel = flash_decode_kernel<D, KV, RB>;
  constexpr int smem = smem_bytes<D, KV, RB>();
  if constexpr (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  constexpr int heads = heads_a_block<D, KV>();
  cfg.gridDim = dim3(cluster, (p.Hkv + heads - 1) / heads, p.B * p.chunks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Rows a block (kernels/decode.py _plan): a power of two up to 32 / (values
// a 16-byte load), so that q and the accumulator stay within 64 registers
// a lane.
template <int D, int KV>
cudaError_t launch_rows(const Params& p, int rows, int cluster,
                        cudaStream_t stream) {
  constexpr int kCap = 32 / Codes<KV>::kVec;
  if (rows > kCap) return cudaErrorInvalidValue;
  switch (rows) {
    case 1: return launch<D, KV, 1>(p, cluster, stream);
    case 2: return launch<D, KV, 2>(p, cluster, stream);
    case 4:
      if constexpr (kCap >= 4) return launch<D, KV, 4>(p, cluster, stream);
      break;
    case 8:
      if constexpr (kCap >= 8) return launch<D, KV, 8>(p, cluster, stream);
      break;
  }
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_codes(const Params& p, int kv_dtype, int rows, int cluster,
                         cudaStream_t stream) {
  switch (kv_dtype) {
    case kF32: return launch_rows<D, kF32>(p, rows, cluster, stream);
    case kBF16: return launch_rows<D, kBF16>(p, rows, cluster, stream);
    case kI8: return launch_rows<D, kI8>(p, rows, cluster, stream);
    case kF8E4M3: return launch_rows<D, kF8E4M3>(p, rows, cluster, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype codes: 0 fp32, 1 bf16, 2 int8, 3 float8_e4m3fn.  rows: query rows a
// block (1, 2, 4 or 8, at most 32 / values a 16-byte load of the cache);
// cluster: blocks a cluster, 1 to 8.
int tf_flash_decode(const void* q, const void* k, const void* v,
                    const float* k_scale, const float* v_scale,
                    const int* lengths, void* out, int B, int Hq, int Hkv,
                    int Lq, int S, int d, int q_dtype, int kv_dtype,
                    float scale, int window, int rows, int cluster,
                    void* stream) {
  if ((q_dtype != kF32 && q_dtype != kBF16) || Hkv <= 0 || Hq % Hkv ||
      Hkv > 65535 || window < 0 || rows < 1 || cluster < 1 ||
      cluster > kMaxCluster)
    return cudaErrorInvalidValue;
  if (B == 0 || Hq == 0 || Lq == 0) return cudaSuccess;
  const int G = Lq * (Hq / Hkv), chunks = (G + rows - 1) / rows;
  if ((long long)B * chunks > 65535) return cudaErrorInvalidValue;
  if ((kv_dtype == kI8 || kv_dtype == kF8E4M3) && (!k_scale || !v_scale))
    return cudaErrorInvalidValue;
  const Params p{q, k, v, k_scale, v_scale, lengths, out, B, Hq, Hkv, Lq, S,
                 q_dtype == kBF16, scale, window, chunks};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_codes<16>(p, kv_dtype, rows, cluster, st);
    case 32: return launch_codes<32>(p, kv_dtype, rows, cluster, st);
    case 64: return launch_codes<64>(p, kv_dtype, rows, cluster, st);
    case 128: return launch_codes<128>(p, kv_dtype, rows, cluster, st);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
