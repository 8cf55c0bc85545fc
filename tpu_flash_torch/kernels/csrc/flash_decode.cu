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
// tensor cores would not help and the design is about the memory system:
//   * one block of 8 warps per (sequence, KV head[, chunk of query rows]).
//     The loop starts at the first position inside the window and stops at
//     min(length, S), read on the device with no host sync, so positions past
//     the length are never loaded (the TPU kernel's clamped index map,
//     decode.py:335-345): traffic scales with the true prefix;
//   * every lane issues 16-byte loads.  One position's head stripe is
//     d * itemsize contiguous bytes (128 B for bf16 at d = 64), covered by
//     d * itemsize / 16 neighbouring lanes, so one warp instruction reads
//     512 B of consecutive positions, and each lane issues kUnroll K and V
//     loads before it uses any of them, to keep bytes in flight;
//   * the G = Lq * g query rows of the group (token-major) share every
//     stripe they load: q, the scores, the online-softmax state and the fp32
//     accumulator stay in registers.  Each group of lanes keeps its own
//     running max over the positions it reads; the groups of a warp are
//     merged by shuffles and the warps through shared memory, once, at the
//     end.  A block holds at most 32 / (values per 16-byte load) rows in
//     registers; larger groups take more blocks (grid z), each reading the
//     stripes again;
//   * int8 / fp8 codes are converted in registers; the K scale multiplies the
//     score and the V scale the probability, as on the TPU.
// Numerics follow the TPU kernel: q * scale is rounded to q's dtype before the
// dot, sums are fp32, l sums p before the V scale, p * v_scale is rounded to
// q's dtype before P.V, and a row that sees no position outputs 0.
// Positions masked by the causal limit or the window get p = 0 and do not
// move the running max, which is what the TPU kernel's -1e7 mask amounts to.
// Split-KV with a combine pass, TMA and wgmma are later work (ROADMAP.md).
//
// C entry: tf_flash_decode(...) launches on the given stream, allocates
// nothing and returns cudaGetLastError() (or cudaErrorInvalidValue for a
// shape or dtype it does not take).

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <math.h>

#include "common.cuh"

namespace {

enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2, kF8E4M3 = 3 };

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;  // positions per lane group per loop step

__device__ __forceinline__ void i8x4(uint32_t w, float* f) {
  f[0] = (float)(int8_t)(uint8_t)(w);
  f[1] = (float)(int8_t)(uint8_t)(w >> 8);
  f[2] = (float)(int8_t)(uint8_t)(w >> 16);
  f[3] = (float)(int8_t)(uint8_t)(w >> 24);
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
};

template <int D, int KV, int RB>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const Params p) {
  constexpr int kVec = Codes<KV>::kVec;
  constexpr int kElt = 16 / kVec;     // bytes per code
  constexpr int kLanes = D / kVec;    // lanes per position stripe
  static_assert(kLanes >= 1 && kLanes <= 32 && 32 % kLanes == 0, "stripe");
  constexpr int kPos = 32 / kLanes;   // positions per warp load
  constexpr int kWarpStep = kPos * kUnroll;
  constexpr int kBlockStep = kWarps * kWarpStep;

  __shared__ float sm_m[kWarps][RB];
  __shared__ float sm_l[kWarps][RB];
  __shared__ float sm_acc[kWarps][RB][D];

  const int h = blockIdx.x, b = blockIdx.y, r0 = blockIdx.z * RB;
  const int g = p.Hq / p.Hkv, G = p.Lq * g;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / kLanes, part = lane % kLanes;

  const int len = p.lengths[b];
  const int end = min(len, p.S);  // idle engine slots count past the buffer

  // Row r of the block is group row r0 + r: token i, query head h*g + u.
  // It attends positions in [first, limit).
  float q[RB][kVec];
  int limit[RB], first[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int row = r0 + r, i = row / g, u = row % g;
    const bool ok = row < G;
    limit[r] = ok ? len - p.Lq + i + 1 : -1;
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
  // Rows ascend in i, so the block's first row has the lowest bound.
  const int start = p.window > 0 ? max(0, first[0]) : 0;

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
  const float* ksp = p.k_scale ? p.k_scale + srow : nullptr;
  const float* vsp = p.v_scale ? p.v_scale + srow : nullptr;

  for (int base = start + warp * kWarpStep; base < end; base += kBlockStep) {
    uint4 kw[kUnroll], vw[kUnroll];
    float ks[kUnroll], vs[kUnroll];
    int pos[kUnroll];
#pragma unroll
    for (int t = 0; t < kUnroll; ++t) {
      pos[t] = base + t * kPos + sub;
      kw[t] = make_uint4(0u, 0u, 0u, 0u);
      vw[t] = kw[t];
      ks[t] = 1.f;
      vs[t] = 1.f;
      if (pos[t] < end) {
        kw[t] = __ldg(reinterpret_cast<const uint4*>(kp + pos[t] * row_bytes));
        vw[t] = __ldg(reinterpret_cast<const uint4*>(vp + pos[t] * row_bytes));
        if (ksp) {
          ks[t] = __ldg(ksp + pos[t]);
          vs[t] = __ldg(vsp + pos[t]);
        }
      }
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
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) dot = fmaf(q[r][e], kf[e], dot);
        s[r][t] = dot;
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
        valid[t] = pos[t] < end && pos[t] < limit[r] && pos[t] >= first[r];
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

  // Merge the lane groups of the warp (lanes that hold the same stripe part).
#pragma unroll
  for (int off = kLanes; off < 32; off <<= 1) {
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
  if (sub == 0) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) sm_acc[warp][r][part * kVec + e] = acc[r][e];
      if (part == 0) {
        sm_m[warp][r] = m[r];
        sm_l[warp][r] = l[r];
      }
    }
  }
  __syncthreads();

  // Merge the warps and write the output rows.
  for (int idx = threadIdx.x; idx < RB * D; idx += kThreads) {
    const int r = idx / D, c = idx % D, row = r0 + r;
    if (row >= G) continue;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][r]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = sm_m[w][r];
      if (mw != -INFINITY) {
        const float f = __expf(mw - mx);
        lsum += sm_l[w][r] * f;
        a += sm_acc[w][r][c] * f;
      }
    }
    const float o = lsum > 0.f ? a / lsum : 0.f;
    const int i = row / g, u = row % g;
    const size_t off = (((size_t)b * p.Hq + h * g + u) * p.Lq + i) * D + c;
    if (p.q_bf16)
      static_cast<__nv_bfloat16*>(p.out)[off] = __float2bfloat16_rn(o);
    else
      static_cast<float*>(p.out)[off] = o;
  }
}

template <int D, int KV, int RB>
cudaError_t launch(const Params& p, int G, cudaStream_t stream) {
  const dim3 grid(p.Hkv, p.B, (G + RB - 1) / RB);
  flash_decode_kernel<D, KV, RB><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// Rows per block: the smallest power of two covering the group, capped so
// q and the accumulator stay within 64 registers a lane.
template <int D, int KV>
cudaError_t launch_rows(const Params& p, cudaStream_t stream) {
  constexpr int kCap = 32 / Codes<KV>::kVec;
  const int G = p.Lq * (p.Hq / p.Hkv);
  int rb = 1;
  while (rb < G && rb < kCap) rb *= 2;
  switch (rb) {
    case 1: return launch<D, KV, 1>(p, G, stream);
    case 2: return launch<D, KV, 2>(p, G, stream);
    case 4:
      if constexpr (kCap >= 4) return launch<D, KV, 4>(p, G, stream);
      break;
    case 8:
      if constexpr (kCap >= 8) return launch<D, KV, 8>(p, G, stream);
      break;
  }
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_codes(const Params& p, int kv_dtype, cudaStream_t stream) {
  switch (kv_dtype) {
    case kF32: return launch_rows<D, kF32>(p, stream);
    case kBF16: return launch_rows<D, kBF16>(p, stream);
    case kI8: return launch_rows<D, kI8>(p, stream);
    case kF8E4M3: return launch_rows<D, kF8E4M3>(p, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype codes: 0 fp32, 1 bf16, 2 int8, 3 float8_e4m3fn.
int tf_flash_decode(const void* q, const void* k, const void* v,
                    const float* k_scale, const float* v_scale,
                    const int* lengths, void* out, int B, int Hq, int Hkv,
                    int Lq, int S, int d, int q_dtype, int kv_dtype,
                    float scale, int window, void* stream) {
  if ((q_dtype != kF32 && q_dtype != kBF16) || Hkv <= 0 || Hq % Hkv ||
      B > 65535 || Hkv > 65535 || window < 0)
    return cudaErrorInvalidValue;
  if (B == 0 || Hq == 0 || Lq == 0) return cudaSuccess;
  const Params p{q, k, v, k_scale, v_scale, lengths, out, B, Hq, Hkv, Lq, S,
                 q_dtype == kBF16, scale, window};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_codes<16>(p, kv_dtype, st);
    case 32: return launch_codes<32>(p, kv_dtype, st);
    case 64: return launch_codes<64>(p, kv_dtype, st);
    case 128: return launch_codes<128>(p, kv_dtype, st);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
