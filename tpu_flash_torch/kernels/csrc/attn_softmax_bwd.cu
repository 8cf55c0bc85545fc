// Masked attention-softmax backward for sm_90a.
//
// Replaces tpu_flash/kernels/softmax.py::_bwd_kernel (softmax.py:116,
// launched by pl.pallas_call at :137).  From the forward's probabilities p
// and their cotangent dp (rows of Lk, fp32 or bf16, each its own):
//   dx = p * (dp - sum(dp * p)),
// per row in fp32, stored in p's dtype.  The masks need no handling here:
// a masked entry has p = 0 and so dx = 0.
//
// What bounds it: bytes.  p and dp are read once and dx written once with
// 3 flops a value; at the reference MT shape ([32, 8, 256, 256], fp32)
// 201 MB take 60 us at 3.35 TB/s.  The design, as in the forward: one warp
// per row, 8 rows a block, lane l on columns l, l + 32, ... (each load and
// store of a warp covers 32 neighbouring values), 256 columns at a time
// with 8 values of p and dp a lane in registers, so a row of Lk <= 256 is
// read once; a longer row is read twice, the second time from L1 or L2.
// The row sum is a warp shuffle.
//
// C entry: tf_attn_softmax_bwd(...) launches on the given stream, allocates
// nothing and returns cudaGetLastError() (or cudaErrorInvalidValue for a
// shape or dtype it does not take).

#include "common.cuh"

namespace {

constexpr int kWarps = 8;          // rows per block, one warp each
constexpr int kPer = 8;            // values a lane holds per chunk
constexpr int kChunk = 32 * kPer;  // columns per chunk

struct Params {
  const void* p;   // [rows, Lk]
  const void* dp;  // [rows, Lk]
  void* dx;        // [rows, Lk], p's dtype
  long long rows;
  int Lk;
  bool pbf16, dpbf16;
};

__global__ void __launch_bounds__(kWarps * 32)
attn_softmax_bwd_kernel(const Params a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= a.rows) return;
  const size_t base = (size_t)row * a.Lk;
  const bool single = a.Lk <= kChunk;  // the row stays in registers

  float pv[kPer], dv[kPer];
  float dot = 0.f;
  for (int c0 = 0; c0 < a.Lk; c0 += kChunk) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = c0 + j * 32 + lane;
      pv[j] = c < a.Lk ? load1(a.p, base + c, a.pbf16) : 0.f;
      dv[j] = c < a.Lk ? load1(a.dp, base + c, a.dpbf16) : 0.f;
      dot += dv[j] * pv[j];
    }
  }
  dot = warp_sum(dot);

  for (int c0 = 0; c0 < a.Lk; c0 += kChunk) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = c0 + j * 32 + lane;
      if (c >= a.Lk) continue;
      const float pj = single ? pv[j] : load1(a.p, base + c, a.pbf16);
      const float dj = single ? dv[j] : load1(a.dp, base + c, a.dpbf16);
      store1(a.dx, base + c, pj * (dj - dot), a.pbf16);
    }
  }
}

}  // namespace

extern "C" {

// p_dtype (p and dx), dp_dtype: 0 fp32, 1 bf16.  rows: the product of
// every axis but the last.
int tf_attn_softmax_bwd(const void* p, const void* dp, void* dx,
                        long long rows, int Lk, int p_dtype, int dp_dtype,
                        void* stream) {
  if ((p_dtype != 0 && p_dtype != 1) || (dp_dtype != 0 && dp_dtype != 1) ||
      rows < 0 || Lk <= 0)
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const Params a{p, dp, dx, rows, Lk, p_dtype == 1, dp_dtype == 1};
  attn_softmax_bwd_kernel<<<(unsigned)blocks, kWarps * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
