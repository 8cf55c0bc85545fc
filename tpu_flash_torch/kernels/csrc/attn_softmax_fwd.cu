// Masked attention-softmax forward for sm_90a.
//
// Replaces tpu_flash/kernels/softmax.py::_fwd_kernel (softmax.py:48,
// launched by pl.pallas_call at :99).  Softmax over the last axis of scores
// x [B, H, Lq, Lk] (fp32 or bf16), written in x's dtype.  Per row, in fp32
// and in the TPU kernel's order:
//   * add the optional pad mask [B, Lk] (fp32) of the row's batch;
//   * with mask_future, replace every score above the bottom-right diagonal
//     (key c > row + q_offset, q_offset = Lk - Lq) by MASK_VALUE = -1e7:
//     replaced, not added, so a row that sees no key comes out uniform;
//   * the TPU kernel runs over Lk padded to a multiple of 128 and sets the
//     pad_cols padded columns to MASK_VALUE too, so they take part in the
//     max and the sum: they change only rows whose every score is at most
//     about -1e7 (a row that sees no key, a batch row whose pad mask hides
//     every key).  The wrapper passes pad_cols and this kernel counts them
//     without storing anything for them;
//   * out = exp(x - max) / (sum(exp(x - max)) + 1e-8), expf, one IEEE
//     reciprocal a row and a multiply a score.
//
// What bounds it: bytes.  Each visible score is read once and every
// probability written once, with ~6 flops a score; causal, a score above
// the diagonal need not be read.  At the reference MT shape
// ([32, 8, 256, 256] causal, 8.42 M of 16.8 M scores visible) that is
// 100.8 MB in fp32, 30.1 us at 3.35 TB/s (15.0 us in bf16).
//
// The first form (one warp a row, a value a lane per load, the dtype, the
// causal test and the pad mask tested at run time inside every load and
// store, an IEEE division a score) reached 34 % (fp32) and 18 % (bf16) of
// that bound on an H100, the same time in both dtypes: it was held by the
// instructions it issued and the latency of its one row, not by the bytes
// (timed ablations of it, PERF.md).  This form:
//   * 16-byte loads and stores where Lk allows them (a multiple of 4 fp32
//     or 8 bf16 values; others take single values in the same layout): a
//     lane holds 8 values of each 256-column chunk, as 8 / V vectors of V
//     neighbouring columns, vector j of lane l at columns (32 j + l) V, so
//     each load and store of a warp covers 512 neighbouring bytes;
//   * one row a warp, 4 a block: two or four rows a warp, their loads in
//     flight together, were slower on the causal rows (PERF.md);
//   * the dtype, the vector width, the causal flag, the pad mask and the
//     chunks held (1 for Lk <= 256, 2 above) are template parameters;
//   * a causally masked vector is not loaded; its scores are MASK_VALUE
//     and take their expf like every other (0 where the row sees a key):
//     skipping those expf behind a test was 16 % slower in bf16;
//   * a row of up to 512 columns is read once and stays in registers; a
//     longer row keeps its first 512 there and reads the rest three times
//     (max, sum, store), the second and third from L1 or L2;
//   * the max and the sum are warp shuffles: no shared memory, no barrier.
//
// C entry: tf_attn_softmax_fwd(...) launches on the given stream, allocates
// nothing and returns cudaGetLastError() (or cudaErrorInvalidValue for a
// shape or dtype it does not take).

#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;            // rows a block, a warp each
constexpr int kPer = 8;              // values a lane holds of a chunk
constexpr int kChunk = 32 * kPer;    // columns a chunk
constexpr float kMaskValue = -1e7f;  // the JAX package's MASK_VALUE
constexpr float kEps = 1e-8f;

struct Params {
  const void* x;      // [B, H, Lq, Lk]
  const float* mask;  // [B, Lk] additive, or null
  void* out;          // [B, H, Lq, Lk], x's dtype
  int rows;           // B H Lq
  int HLq, Lq, Lk, q_offset, pad_cols;
};

// V neighbouring pad-mask values: 16-byte loads where V is a multiple of 4.
template <int V>
__device__ __forceinline__ void load_mask(const float* src, float* f) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int e = 0; e < V; e += 4) {
      const float4 w = *reinterpret_cast<const float4*>(src + e);
      f[e] = w.x;
      f[e + 1] = w.y;
      f[e + 2] = w.z;
      f[e + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) f[e] = src[e];
  }
}

// T: float or __nv_bfloat16; V: values a vector (16 bytes, or 1 where Lk
// is not a multiple of 16 bytes); HELD: chunks held in registers, 1 where
// Lk <= 256, else 2; CAUSAL: mask_future; MASK: a pad mask.
template <typename T, int V, int HELD, bool CAUSAL, bool MASK>
__global__ void __launch_bounds__(kWarps * 32)
attn_softmax_fwd_kernel(const Params p) {
  constexpr int NV = kPer / V;   // vectors a lane holds of a chunk
  const int lane = threadIdx.x & 31;
  const unsigned row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= (unsigned)p.rows) return;
  const int Lk = p.Lk;
  const T* xr = static_cast<const T*>(p.x) + (size_t)row * Lk;
  T* yr = static_cast<T*>(p.out) + (size_t)row * Lk;
  const float* mr =
      MASK ? p.mask + (size_t)(row / (unsigned)p.HLq) * Lk : nullptr;
  const int last =                                    // the last key seen
      CAUSAL ? (int)(row % (unsigned)p.Lq) + p.q_offset : Lk - 1;

  // The scores of the chunk at column c0 into f: the pad mask added, a
  // causally masked score MASK_VALUE (not loaded where its whole vector is
  // masked), a column past Lk -inf (it leaves the max and the sum alone).
  auto scores = [&](int c0, float* f) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = c0 + (32 * j + lane) * V;
      float* fj = f + j * V;
      if (c < Lk && (!CAUSAL || c <= last)) {
        load_v<T, V>(xr + c, fj);
        if constexpr (MASK) {
          float mk[V];
          load_mask<V>(mr + c, mk);
#pragma unroll
          for (int e = 0; e < V; ++e) fj[e] += mk[e];
        }
        if constexpr (CAUSAL && V > 1) {
#pragma unroll
          for (int e = 0; e < V; ++e)
            if (c + e > last) fj[e] = kMaskValue;
        }
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) fj[e] = c < Lk ? kMaskValue : -INFINITY;
      }
    }
  };
  // exp(f - m) of a chunk's values in place, added to sum
  auto exps = [&](float* f, float m, float& sum) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      f[k] = expf(f[k] - m);
      sum += f[k];
    }
  };
  auto store = [&](int c0, const float* f, float inv) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = c0 + (32 * j + lane) * V;
      if (c < Lk) {
        float o[V];
#pragma unroll
        for (int e = 0; e < V; ++e) o[e] = f[j * V + e] * inv;
        store_v<T, V>(yr + c, o);
      }
    }
  };

  float v[HELD][kPer];
  float m = -INFINITY;
#pragma unroll
  for (int h = 0; h < HELD; ++h) {
    scores(h * kChunk, v[h]);
#pragma unroll
    for (int k = 0; k < kPer; ++k) m = fmaxf(m, v[h][k]);
  }
  for (int c0 = HELD * kChunk; c0 < Lk; c0 += kChunk) {
    float f[kPer];
    scores(c0, f);
#pragma unroll
    for (int k = 0; k < kPer; ++k) m = fmaxf(m, f[k]);
  }
  m = warp_max(m);
  if (p.pad_cols > 0) m = fmaxf(m, kMaskValue);

  float sum = 0.f;
#pragma unroll
  for (int h = 0; h < HELD; ++h) exps(v[h], m, sum);
  for (int c0 = HELD * kChunk; c0 < Lk; c0 += kChunk) {
    float f[kPer];
    scores(c0, f);
    exps(f, m, sum);
  }
  sum = warp_sum(sum);
  if (p.pad_cols > 0) sum += p.pad_cols * expf(kMaskValue - m);
  const float inv = 1.f / (sum + kEps);

#pragma unroll
  for (int h = 0; h < HELD; ++h) store(h * kChunk, v[h], inv);
  for (int c0 = HELD * kChunk; c0 < Lk; c0 += kChunk) {
    float f[kPer], unused = 0.f;
    scores(c0, f);
    exps(f, m, unused);
    store(c0, f, inv);
  }
}

using Kernel = void (*)(Params);

template <typename T, int V, int HELD>
Kernel pick_flags(bool causal, bool mask) {
  if (causal)
    return mask ? attn_softmax_fwd_kernel<T, V, HELD, true, true>
                : attn_softmax_fwd_kernel<T, V, HELD, true, false>;
  return mask ? attn_softmax_fwd_kernel<T, V, HELD, false, true>
              : attn_softmax_fwd_kernel<T, V, HELD, false, false>;
}

template <typename T, int V>
Kernel pick(int Lk, bool causal, bool mask) {
  return Lk <= kChunk ? pick_flags<T, V, 1>(causal, mask)
                      : pick_flags<T, V, 2>(causal, mask);
}

}  // namespace

extern "C" {

// dtype (x and out): 0 fp32, 1 bf16.  mask: fp32 [B, Lk] or null.  B H Lq
// rows at most INT_MAX.
int tf_attn_softmax_fwd(const void* x, const float* mask, void* out, int B,
                        int H, int Lq, int Lk, int causal, int q_offset,
                        int pad_cols, int dtype, void* stream) {
  if ((dtype != 0 && dtype != 1) || B < 0 || H < 0 || Lq < 0 || Lk <= 0 ||
      pad_cols < 0 || (long long)B * H * Lq > INT_MAX)
    return cudaErrorInvalidValue;
  const int rows = B * H * Lq;
  if (rows == 0) return cudaSuccess;
  const bool c = causal != 0, m = mask != nullptr;
  const Kernel k =
      dtype == 1 ? (Lk % 8 ? pick<__nv_bfloat16, 1>(Lk, c, m)
                           : pick<__nv_bfloat16, 8>(Lk, c, m))
                 : (Lk % 4 ? pick<float, 1>(Lk, c, m)
                           : pick<float, 4>(Lk, c, m));
  const Params p{x, mask, out, rows, H * Lq, Lq, Lk, q_offset, pad_cols};
  k<<<(rows + kWarps - 1) / kWarps, kWarps * 32, 0,
      static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

}  // extern "C"
