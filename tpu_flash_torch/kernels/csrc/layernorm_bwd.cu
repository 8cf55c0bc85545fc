// Row LayerNorm backward for sm_90a.
//
// Replaces tpu_flash/kernels/layernorm.py::_bwd_kernel (layernorm.py:102,
// launched by pl.pallas_call at :153).  From dy and x [R, H] (fp32 or
// bf16, each its own), gamma [H] and the forward's mean and var (fp32 [R]):
//   rstd = rsqrt(var + 1e-8),  xhat = (x - mean) * rstd,  dxhat = dy * gamma,
//   dx = (dxhat - (sum(dxhat) + xhat * sum(dxhat * xhat)) / H) * rstd,
// stored in x's dtype, and fp32 partial sums of dy * xhat (for dgamma) and
// dy (for dbeta) over each block's rows, [n_blocks, H] each.  The wrapper
// sums the partials over the blocks with one torch op, as the JAX package
// sums its per-tile slabs with XLA after the Pallas call (:179-181): no
// atomics, so dgamma and dbeta are the same from run to run.
//
// What bounds it: bytes.  dy and x are read and dx written, ~3 flops per
// byte; at the reference MT shape (R = 8192, H = 256, fp32) 25.2 MB take
// 7.5 us at 3.35 TB/s.  The design reads each byte of dy and x once over
// HBM:
//   * a block owns rows_per_block consecutive rows; phase 1 gives each row
//     to a warp (the two row sums are warp shuffles), 4-element loads where
//     H % 4 == 0 and a scalar loop over the ragged rest;
//   * phase 2, after one barrier, gives each column to a thread, which sums
//     dy * xhat and dy down the block's rows (neighbouring threads on
//     neighbouring addresses), re-reading dy and x from L1 or L2, with the
//     rows' mean and rstd from shared memory;
//   * the partials are a small fraction of the traffic: 2 * H floats per
//     block of rows_per_block rows, 1/32 of the bytes of dy and x at 32 rows.
//
// C entry: tf_layernorm_bwd(...) launches on the given stream, allocates
// nothing and returns cudaGetLastError() (or cudaErrorInvalidValue for a
// shape or dtype it does not take).

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kEps = 1e-8f;

struct Params {
  const void* dy;      // [R, H]
  const void* x;       // [R, H]
  const void* gamma;   // [H]
  const float* mean;   // [R]
  const float* var;    // [R]
  void* dx;            // [R, H], x's dtype
  float* dg_part;      // [n_blocks, H]
  float* db_part;      // [n_blocks, H]
  int R, H, rows_per_block;
  bool dybf16, xbf16, pbf16;
};

__global__ void __launch_bounds__(kThreads)
layernorm_bwd_kernel(const Params p) {
  extern __shared__ float smem[];
  float* s_mean = smem;                    // [rows_per_block]
  float* s_rstd = smem + p.rows_per_block;  // [rows_per_block]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * p.rows_per_block;
  const int nrows = min(p.rows_per_block, p.R - row0);
  const int nvec = (p.H & 3) ? 0 : p.H >> 2;

  // Phase 1: dx, one warp per row.
  for (int rr = warp; rr < nrows; rr += kWarps) {
    const int row = row0 + rr;
    const size_t base = (size_t)row * p.H;
    const float mean = p.mean[row];
    const float rstd = rsqrtf(p.var[row] + kEps);
    if (lane == 0) {
      s_mean[rr] = mean;
      s_rstd[rr] = rstd;
    }
    float sd = 0.f, sdx = 0.f;  // sum(dxhat), sum(dxhat * xhat)
    for (int i = lane; i < nvec; i += 32) {
      const size_t c = 4 * (size_t)i;
      const float4 d = load4(p.dy, base + c, p.dybf16);
      const float4 v = load4(p.x, base + c, p.xbf16);
      const float4 g = load4(p.gamma, c, p.pbf16);
      const float dh[4] = {d.x * g.x, d.y * g.y, d.z * g.z, d.w * g.w};
      const float xh[4] = {(v.x - mean) * rstd, (v.y - mean) * rstd,
                           (v.z - mean) * rstd, (v.w - mean) * rstd};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sd += dh[j];
        sdx += dh[j] * xh[j];
      }
    }
    for (int c = 4 * nvec + lane; c < p.H; c += 32) {
      const float dh = load1(p.dy, base + c, p.dybf16) *
                       load1(p.gamma, c, p.pbf16);
      const float xh = (load1(p.x, base + c, p.xbf16) - mean) * rstd;
      sd += dh;
      sdx += dh * xh;
    }
    sd = warp_sum(sd);
    sdx = warp_sum(sdx);

    for (int i = lane; i < nvec; i += 32) {
      const size_t c = 4 * (size_t)i;
      const float4 d = load4(p.dy, base + c, p.dybf16);
      const float4 v = load4(p.x, base + c, p.xbf16);
      const float4 g = load4(p.gamma, c, p.pbf16);
      const float4 dx = make_float4(
          (d.x * g.x - (sd + (v.x - mean) * rstd * sdx) / p.H) * rstd,
          (d.y * g.y - (sd + (v.y - mean) * rstd * sdx) / p.H) * rstd,
          (d.z * g.z - (sd + (v.z - mean) * rstd * sdx) / p.H) * rstd,
          (d.w * g.w - (sd + (v.w - mean) * rstd * sdx) / p.H) * rstd);
      store4(p.dx, base + c, dx, p.xbf16);
    }
    for (int c = 4 * nvec + lane; c < p.H; c += 32) {
      const float dh = load1(p.dy, base + c, p.dybf16) *
                       load1(p.gamma, c, p.pbf16);
      const float xh = (load1(p.x, base + c, p.xbf16) - mean) * rstd;
      store1(p.dx, base + c, (dh - (sd + xh * sdx) / p.H) * rstd, p.xbf16);
    }
  }
  __syncthreads();

  // Phase 2: this block's partial column sums of dy * xhat and dy.
  for (int c = threadIdx.x; c < p.H; c += kThreads) {
    float dg = 0.f, db = 0.f;
    for (int rr = 0; rr < nrows; ++rr) {
      const size_t i = (size_t)(row0 + rr) * p.H + c;
      const float d = load1(p.dy, i, p.dybf16);
      dg += d * ((load1(p.x, i, p.xbf16) - s_mean[rr]) * s_rstd[rr]);
      db += d;
    }
    const size_t o = (size_t)blockIdx.x * p.H + c;
    p.dg_part[o] = dg;
    p.db_part[o] = db;
  }
}

}  // namespace

extern "C" {

// dy_dtype, x_dtype (x and dx), p_dtype (gamma): 0 fp32, 1 bf16.  The
// partials hold ceil(R / rows_per_block) rows of H.
int tf_layernorm_bwd(const void* dy, const void* x, const void* gamma,
                     const float* mean, const float* var, void* dx,
                     float* dg_part, float* db_part, int R, int H,
                     int rows_per_block, int dy_dtype, int x_dtype,
                     int p_dtype, void* stream) {
  const bool ok_dtype = (dy_dtype == 0 || dy_dtype == 1) &&
                        (x_dtype == 0 || x_dtype == 1) &&
                        (p_dtype == 0 || p_dtype == 1);
  if (!ok_dtype || R < 0 || H <= 0 || rows_per_block < 1 ||
      rows_per_block > 4096)
    return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  const Params p{dy, x, gamma, mean, var, dx, dg_part, db_part, R, H,
                 rows_per_block, dy_dtype == 1, x_dtype == 1, p_dtype == 1};
  const int blocks = (R + rows_per_block - 1) / rows_per_block;
  const size_t smem = 2 * rows_per_block * sizeof(float);
  layernorm_bwd_kernel<<<blocks, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

}  // extern "C"
