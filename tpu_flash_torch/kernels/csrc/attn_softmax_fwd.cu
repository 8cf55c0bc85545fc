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
//   * out = exp(x - max) / (sum(exp(x - max)) + 1e-8), expf and an IEEE
//     division.
//
// What bounds it: bytes.  Each visible score is read once and every
// probability written once, with ~6 flops a score; causal, a score above
// the diagonal need not be read.  At the reference MT shape
// ([32, 8, 256, 256] causal, 8.42 M of 16.8 M scores visible) that is
// 100.8 MB in fp32, 30.1 us at 3.35 TB/s (15.0 us in bf16).  The design
// moves each needed byte over HBM once:
//   * one warp per row, 8 rows a block; lane l takes columns l, l + 32, ...,
//     so each load and store of a warp covers 32 neighbouring values;
//   * a causally masked score is not loaded;
//   * a row is taken 256 columns at a time, 8 values a lane in registers:
//     at Lk <= 256 the row is read once and stays in registers for the max,
//     the sum (one expf a score, kept) and the store; a longer row is read
//     three times (max, sum, store), the second and third from L1 or L2;
//   * the max and the sum are warp shuffles: no shared memory, no barrier.
// On an H100 (700 W) it reaches 34 % (fp32) and 18 % (bf16) of that bound
// (PERF.md), at about the same time in both dtypes: the bytes do not limit
// it, and what does is not measured yet.
//
// C entry: tf_attn_softmax_fwd(...) launches on the given stream, allocates
// nothing and returns cudaGetLastError() (or cudaErrorInvalidValue for a
// shape or dtype it does not take).

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;            // rows per block, one warp each
constexpr int kPer = 8;              // values a lane holds per chunk
constexpr int kChunk = 32 * kPer;    // columns per chunk
constexpr float kMaskValue = -1e7f;  // the JAX package's MASK_VALUE
constexpr float kEps = 1e-8f;

struct Params {
  const void* x;      // [B, H, Lq, Lk]
  const float* mask;  // [B, Lk] additive, or null
  void* out;          // [B, H, Lq, Lk], x's dtype
  int B, H, Lq, Lk, q_offset, pad_cols;
  bool causal, bf16;
};

__global__ void __launch_bounds__(kWarps * 32)
attn_softmax_fwd_kernel(const Params p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * kWarps + warp;
  if (row >= (size_t)p.B * p.H * p.Lq) return;
  const int i = row % p.Lq;
  const int b = row / ((size_t)p.H * p.Lq);
  const size_t base = row * p.Lk;
  const float* mrow = p.mask ? p.mask + (size_t)b * p.Lk : nullptr;
  const long long last = (long long)i + p.q_offset;  // last visible key

  // A causally masked score is replaced whatever x and the pad mask hold,
  // so neither is read there.
  auto score = [&](int c) {
    if (p.causal && c > last) return kMaskValue;
    float s = load1(p.x, base + c, p.bf16);
    if (mrow) s += mrow[c];
    return s;
  };

  float v[kPer];
  const bool single = p.Lk <= kChunk;  // the row stays in registers
  float m = -INFINITY;
  for (int c0 = 0; c0 < p.Lk; c0 += kChunk) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = c0 + j * 32 + lane;
      v[j] = c < p.Lk ? score(c) : -INFINITY;
      m = fmaxf(m, v[j]);
    }
  }
  m = warp_max(m);
  if (p.pad_cols > 0) m = fmaxf(m, kMaskValue);

  float sum = 0.f;
  for (int c0 = 0; c0 < p.Lk; c0 += kChunk) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = c0 + j * 32 + lane;
      if (c < p.Lk) {
        const float e = expf((single ? v[j] : score(c)) - m);
        if (single) v[j] = e;  // kept for the store
        sum += e;
      }
    }
  }
  sum = warp_sum(sum);
  if (p.pad_cols > 0) sum += p.pad_cols * expf(kMaskValue - m);
  const float denom = sum + kEps;

  for (int c0 = 0; c0 < p.Lk; c0 += kChunk) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = c0 + j * 32 + lane;
      if (c < p.Lk)
        store1(p.out, base + c,
               (single ? v[j] : expf(score(c) - m)) / denom, p.bf16);
    }
  }
}

}  // namespace

extern "C" {

// dtype (x and out): 0 fp32, 1 bf16.  mask: fp32 [B, Lk] or null.
int tf_attn_softmax_fwd(const void* x, const float* mask, void* out, int B,
                        int H, int Lq, int Lk, int causal, int q_offset,
                        int pad_cols, int dtype, void* stream) {
  if ((dtype != 0 && dtype != 1) || B < 0 || H < 0 || Lq < 0 || Lk <= 0 ||
      pad_cols < 0)
    return cudaErrorInvalidValue;
  const size_t rows = (size_t)B * H * Lq;
  if (rows == 0) return cudaSuccess;
  const size_t blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const Params p{x, mask, out, B, H, Lq, Lk, q_offset, pad_cols,
                 causal != 0, dtype == 1};
  attn_softmax_fwd_kernel<<<(unsigned)blocks, kWarps * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

}  // extern "C"
