// Row LayerNorm forward for sm_90a.
//
// Replaces tpu_flash/kernels/layernorm.py::_fwd_kernel (layernorm.py:42,
// launched by pl.pallas_call at :73).  x [R, H] (every leading axis folded
// into R), fp32 or bf16; gamma and beta [H] in their own dtype (fp32 or
// bf16).  Writes y [R, H] in x's dtype and mean, var fp32 [R]:
//   mean = sum(x) / H,  var = sum(x^2) / H - mean^2   (the TPU formula, not
//   Welford: the numbers stay those of the reference),
//   y = (x - mean) * rsqrt(var + 1e-8) * gamma + beta, all in fp32.
//
// What bounds it: bytes.  Each element is read once and written once with
// a handful of flops, ~2 flops per byte against the card's ~20 (fp32) at
// 3.35 TB/s; at the reference MT shape (R = 8192, H = 256, fp32) the 16.8
// MB of x and y take 5.0 us.  The design moves each byte of x and y once
// over HBM:
//   * one warp per row, 8 rows a block, so a row's sums are one warp
//     shuffle and no shared memory or barrier;
//   * 4-element loads and stores (16 bytes fp32, 8 bytes bf16) where
//     H % 4 == 0, neighbouring lanes on neighbouring addresses, and a
//     scalar loop over the ragged rest otherwise;
//   * the second pass over the row (normalise and store) reads x again
//     right after the first, from L1 or L2, not from HBM.
// No tiling across rows: a row of up to tens of thousands of values needs
// nothing but its warp.
//
// C entry: tf_layernorm_fwd(...) launches on the given stream, allocates
// nothing and returns cudaGetLastError() (or cudaErrorInvalidValue for a
// shape or dtype it does not take).

#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // rows per block, one warp each
constexpr float kEps = 1e-8f;

struct Params {
  const void* x;      // [R, H]
  const void* gamma;  // [H]
  const void* beta;   // [H]
  void* y;            // [R, H], x's dtype
  float* mean;        // [R]
  float* var;         // [R]
  int R, H;
  bool xbf16, pbf16;  // x and y / gamma and beta are bf16
};

__global__ void __launch_bounds__(kWarps * 32)
layernorm_fwd_kernel(const Params p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= p.R) return;
  const size_t base = (size_t)row * p.H;
  const int nvec = (p.H & 3) ? 0 : p.H >> 2;  // 4-element groups

  float s = 0.f, s2 = 0.f;
  for (int i = lane; i < nvec; i += 32) {
    const float4 v = load4(p.x, base + 4 * (size_t)i, p.xbf16);
    s += v.x + v.y + v.z + v.w;
    s2 += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
  }
  for (int c = 4 * nvec + lane; c < p.H; c += 32) {
    const float v = load1(p.x, base + c, p.xbf16);
    s += v;
    s2 += v * v;
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mean = s / p.H;
  const float var = s2 / p.H - mean * mean;
  const float rstd = rsqrtf(var + kEps);

  for (int i = lane; i < nvec; i += 32) {
    const size_t c = 4 * (size_t)i;
    const float4 v = load4(p.x, base + c, p.xbf16);
    const float4 g = load4(p.gamma, c, p.pbf16);
    const float4 b = load4(p.beta, c, p.pbf16);
    const float4 y = make_float4((v.x - mean) * rstd * g.x + b.x,
                                 (v.y - mean) * rstd * g.y + b.y,
                                 (v.z - mean) * rstd * g.z + b.z,
                                 (v.w - mean) * rstd * g.w + b.w);
    store4(p.y, base + c, y, p.xbf16);
  }
  for (int c = 4 * nvec + lane; c < p.H; c += 32) {
    const float xhat = (load1(p.x, base + c, p.xbf16) - mean) * rstd;
    store1(p.y, base + c,
           xhat * load1(p.gamma, c, p.pbf16) + load1(p.beta, c, p.pbf16),
           p.xbf16);
  }
  if (lane == 0) {
    p.mean[row] = mean;
    p.var[row] = var;
  }
}

}  // namespace

extern "C" {

// x_dtype (x and y), p_dtype (gamma and beta): 0 fp32, 1 bf16.
int tf_layernorm_fwd(const void* x, const void* gamma, const void* beta,
                     void* y, float* mean, float* var, int R, int H,
                     int x_dtype, int p_dtype, void* stream) {
  if ((x_dtype != 0 && x_dtype != 1) || (p_dtype != 0 && p_dtype != 1) ||
      R < 0 || H <= 0)
    return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  const Params p{x, gamma, beta, y, mean, var, R, H, x_dtype == 1,
                 p_dtype == 1};
  const int blocks = (R + kWarps - 1) / kWarps;
  layernorm_fwd_kernel<<<blocks, kWarps * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

}  // extern "C"
