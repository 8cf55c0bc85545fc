// Row LayerNorm backward for sm_90a.
//
// Replaces tpu_flash/kernels/layernorm.py::_bwd_kernel (layernorm.py:102,
// launched by pl.pallas_call at :153).  From dy and x [R, H] (fp32 or
// bf16, each its own), gamma [H] and the forward's mean and var (fp32 [R]):
//   rstd = rsqrt(var + 1e-8),  xhat = (x - mean) * rstd,  dxhat = dy * gamma,
//   dx = (dxhat - (sum(dxhat) + xhat * sum(dxhat * xhat)) / H) * rstd,
// stored in x's dtype, and dgamma = sum over rows of dy * xhat, dbeta = sum
// of dy, both from fp32 sums, stored in gamma's dtype.  The JAX package
// writes per-tile slabs and sums them with XLA after the Pallas call
// (:179-181); this kernel finishes the sums itself, in one launch.
//
// What bounds it: bytes.  dy and x are read and dx written, ~3 flops per
// byte; at the reference MT shape (R = 8192, H = 256, fp32) 25.2 MB take
// 7.5 us at 3.35 TB/s.
//
// The first form (a block of 32 rows; each row's dy, x and gamma read twice
// by a warp, for the sums and for dx, and a third time by column for the
// block's dgamma / dbeta partials; the dtypes run-time flags; a torch sum of
// the [R / 32, H] partials after it) took 2.8x that bound for the whole
// call on an H100, a third of it in the launches after the kernel (PERF.md).
// This form:
//   * the dtypes of dy, x and gamma are template parameters;
//   * a warp owns a row at a time and reads it once: lane l holds columns
//     V (32 j + l) .. + V - 1 of dy and x in registers (V = 8 where dy and x
//     are bf16 and H allows it, else 4: 16-byte loads where the dtype gives
//     16 bytes), up to H = 1024, and both row sums and dx come from them.
//     Wider rows and H % 4 != 0 take a looped form with the same arithmetic
//     that reads each row twice, the second time from L1 or L2;
//   * a lane owns the same columns on every row its warp takes, so its
//     dgamma / dbeta sums stay in registers across rows (the looped form
//     keeps them in the warp's own slab of shared memory), and gamma is read
//     once a lane;
//   * a persistent grid (kernels/layernorm.py _bwd_clusters: up to four
//     blocks of 8 warps an SM, and no more clusters than the card holds at
//     once) walks the rows, warp w of the grid taking rows w, w + W, ...
//     (two at a time in fp32 up to H = 256, their loads in flight
//     together); a block adds its warps' sums in warp order;
//   * the blocks are clusters of 8: rank r adds the r-th eighth of the
//     columns of the cluster's 8 block sums in rank order, through
//     distributed shared memory, and stores them in the workspace; the
//     rank r that stores its eighth last (a ticket: an acquire-release
//     atomic add on the eighth's counter) adds every cluster's r-th
//     eighth in cluster order, writes those columns of dgamma and dbeta
//     and resets the counter.  No float atomics, a fixed order: the same
//     bits on every call at a shape on a card.
//
// C entry: tf_layernorm_bwd(...) launches on the given stream, allocates
// nothing and returns cudaGetLastError() (or cudaErrorInvalidValue for a
// shape or dtype it does not take).

#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCluster = 8;     // blocks a cluster
constexpr int kSplit = 8;       // threads that sum one column's partials
constexpr int kBatch = 16;      // partials a thread loads at a time
constexpr int kHeldMax = 1024;  // the widest row held in registers
constexpr int kLoopedMax = 3072;  // the looped form's slabs fit in 227 KB
constexpr float kEps = 1e-8f;

struct Params {
  const void* dy;      // [R, H]
  const void* x;       // [R, H]
  const void* gamma;   // [H]
  const float* mean;   // [R]
  const float* var;    // [R]
  void* dx;            // [R, H], x's dtype
  void* dgamma;        // [H], gamma's dtype
  void* dbeta;         // [H], gamma's dtype
  float* part;         // [clusters, 2H]: the clusters' partials
  unsigned* ticket;    // [kCluster]: clusters that stored each eighth; 0
                       // between calls
  int R, H;
  float inv_h;         // 1 / H
};

// Shared memory: kWarps slabs of [2H] (each warp's dgamma then dbeta sums),
// then the block's [2H] sums.
inline size_t smem_bytes(int H) { return (kWarps + 1) * 2 * (size_t)H * 4; }

// Columns lo .. lo + n of every cluster's partial, summed in cluster order
// into dgamma / dbeta: thread (k, c) sums the k-th of S runs of the
// clusters into smem[k * n + c], kBatch loads in flight at a time, then the
// runs are added in order.
template <typename TG>
__device__ __forceinline__ void final_sums(const Params& p, float* smem,
                                           int lo, int n, int clusters) {
  const int H2 = 2 * p.H, tid = threadIdx.x;
  const int S = max(1, min(kSplit, kThreads / n));
  for (int i = tid; i < n * S; i += kThreads) {
    const int c = lo + i % n, k = i / n;
    const int q0 = k * clusters / S, q1 = (k + 1) * clusters / S;
    float s = 0.f;
    for (int q = q0; q < q1; q += kBatch) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        v[u] = q + u < q1 ? __ldcg(p.part + (size_t)(q + u) * H2 + c) : 0.f;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) s += v[u];
    }
    smem[i] = s;
  }
  __syncthreads();
  for (int i = tid; i < n; i += kThreads) {
    float s = smem[i];
    for (int k = 1; k < S; ++k) s += smem[k * n + i];
    const int c = lo + i;
    if (c < p.H)
      static_cast<TG*>(p.dgamma)[c] = from_float<TG>(s);
    else
      static_cast<TG*>(p.dbeta)[c - p.H] = from_float<TG>(s);
  }
}

// The block's warp slabs summed in warp order into its own [2H] sums; the
// cluster's 8 block sums into the cluster's partial (rank r the r-th eighth
// of the 2H columns, the ranks in order); and, by the rank r that stores
// its eighth last, every cluster's r-th eighth in cluster order into dgamma
// and dbeta.
template <typename TG>
__device__ __forceinline__ void finish(const Params& p, float* smem) {
  const int H2 = 2 * p.H, tid = threadIdx.x;
  float* bsum = smem + kWarps * H2;
  __syncthreads();                          // every warp's slab is written
  for (int i = tid; i < H2; i += kThreads) {
    float s = smem[i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += smem[w * H2 + i];
    bsum[i] = s;
  }
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = cluster.block_rank();
  const int clusters = gridDim.x / kCluster, cid = blockIdx.x / kCluster;
  const int per = (H2 + kCluster - 1) / kCluster;
  const int lo = min(H2, rank * per), hi = min(H2, lo + per), n = hi - lo;
  cluster_sync();                           // every rank's block sums
  for (int i = lo + tid; i < hi; i += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) s += cluster.map_shared_rank(bsum, r)[i];
    p.part[(size_t)cid * H2 + i] = s;
  }
  // A ticket on the eighth's counter: the block barrier orders the block's
  // stores before one thread's gpu-wide release; its acquire, and the
  // barrier after it, order every cluster's stores before the final sums.
  __syncthreads();
  __shared__ int last;
  if (tid == 0) {
    unsigned t;
    asm volatile("atom.acq_rel.gpu.add.u32 %0, [%1], 1;"
                 : "=r"(t) : "l"(p.ticket + rank) : "memory");
    last = t == (unsigned)clusters - 1;
    if (last) p.ticket[rank] = 0;   // every cluster has stored its eighth
  }
  __syncthreads();
  if (last && n > 0) final_sums<TG>(p, smem, lo, n, clusters);
  cluster_sync();        // no block exits while a peer may read its sums
}

// The row held in registers: V values a vector, NV vectors a lane (H <=
// 32 V NV, H % V == 0).
template <typename TD, typename TX, typename TG, int V, int NV>
__global__ void __launch_bounds__(kThreads)
layernorm_bwd_kernel(const Params p) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int H = p.H;
  const TD* dyp = static_cast<const TD*>(p.dy);
  const TX* xp = static_cast<const TX*>(p.x);
  TX* dxp = static_cast<TX*>(p.dx);

  float g[NV][V], ag[NV][V], ab[NV][V];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = V * (32 * j + lane);
    if (c < H) {
      load_v<TG, V>(static_cast<const TG*>(p.gamma) + c, g[j]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) g[j][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) ag[j][e] = ab[j][e] = 0.f;
  }

  // RP rows a pass, their loads in flight together: two where a row is 8
  // values a lane in 16-byte fp32 vectors (H <= 256: bf16 rows, and wider
  // ones, whose registers would halve the blocks an SM holds, were slower)
  constexpr int RP = V == 4 && NV <= 2 ? 2 : 1;
  const int W = gridDim.x * kWarps;
  for (int row0 = blockIdx.x * kWarps + warp; row0 < p.R; row0 += RP * W) {
    float d[RP][NV][V], xh[RP][NV][V], mean[RP], rstd[RP];
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      const int row = row0 + r * W;
      const bool live = row < p.R;
      const size_t base = (size_t)row * H;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int c = V * (32 * j + lane);
        if (live && c < H) {
          load_v<TD, V>(dyp + base + c, d[r][j]);
          load_v<TX, V>(xp + base + c, xh[r][j]);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) d[r][j][e] = xh[r][j][e] = 0.f;
        }
      }
      mean[r] = live ? p.mean[row] : 0.f;
      rstd[r] = live ? rsqrtf(p.var[row] + kEps) : 0.f;
    }
    float sd[RP], sdx[RP];  // sum(dxhat), sum(dxhat * xhat)
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      sd[r] = sdx[r] = 0.f;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          xh[r][j][e] = (xh[r][j][e] - mean[r]) * rstd[r];
          const float dh = d[r][j][e] * g[j][e];
          sd[r] += dh;
          sdx[r] += dh * xh[r][j][e];
          ag[j][e] += d[r][j][e] * xh[r][j][e];
          ab[j][e] += d[r][j][e];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      sd[r] = warp_sum(sd[r]) * p.inv_h;
      sdx[r] = warp_sum(sdx[r]) * p.inv_h;
    }
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      const int row = row0 + r * W;
      if (row >= p.R) break;
      const size_t base = (size_t)row * H;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int c = V * (32 * j + lane);
        if (c < H) {
          float o[V];
#pragma unroll
          for (int e = 0; e < V; ++e)
            o[e] = (d[r][j][e] * g[j][e] - (sd[r] + xh[r][j][e] * sdx[r])) *
                   rstd[r];
          store_v<TX, V>(dxp + base + c, o);
        }
      }
    }
  }

  float* slab = smem + warp * 2 * H;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = V * (32 * j + lane);
    if (c < H) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        slab[c + e] = ag[j][e];
        slab[H + c + e] = ab[j][e];
      }
    }
  }
  finish<TG>(p, smem);
}

// Wider rows and H % 4 != 0: lane l owns columns l, l + 32, ...; each row
// read twice (the sums, then dx), the warp's dgamma / dbeta sums in its slab.
template <typename TD, typename TX, typename TG>
__global__ void __launch_bounds__(kThreads)
layernorm_bwd_looped_kernel(const Params p) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int H = p.H;
  const TD* dyp = static_cast<const TD*>(p.dy);
  const TX* xp = static_cast<const TX*>(p.x);
  const TG* gp = static_cast<const TG*>(p.gamma);
  TX* dxp = static_cast<TX*>(p.dx);
  float* slab = smem + warp * 2 * H;
  for (int c = lane; c < 2 * H; c += 32) slab[c] = 0.f;

  const int W = gridDim.x * kWarps;
  for (int row = blockIdx.x * kWarps + warp; row < p.R; row += W) {
    const size_t base = (size_t)row * H;
    const float mean = p.mean[row];
    const float rstd = rsqrtf(p.var[row] + kEps);
    float sd = 0.f, sdx = 0.f;
    for (int c = lane; c < H; c += 32) {
      const float dh = to_float(dyp[base + c]) * to_float(gp[c]);
      const float xh = (to_float(xp[base + c]) - mean) * rstd;
      sd += dh;
      sdx += dh * xh;
    }
    sd = warp_sum(sd) * p.inv_h;
    sdx = warp_sum(sdx) * p.inv_h;
    for (int c = lane; c < H; c += 32) {
      const float d = to_float(dyp[base + c]);
      const float xh = (to_float(xp[base + c]) - mean) * rstd;
      dxp[base + c] =
          from_float<TX>((d * to_float(gp[c]) - (sd + xh * sdx)) * rstd);
      slab[c] += d * xh;
      slab[H + c] += d;
    }
  }
  finish<TG>(p, smem);
}

using Kernel = void (*)(Params);

// Clusters of kernel k (with smem bytes of shared memory a block) the card
// holds at once, asked once: the grid is persistent, and a second wave of
// clusters would wait for the first.
int resident_clusters(Kernel k, size_t smem) {
  static struct { Kernel k; size_t smem; int n; } seen[64];
  static int nseen = 0;
  for (int i = 0; i < nseen; ++i)
    if (seen[i].k == k && seen[i].smem == smem) return seen[i].n;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = kCluster;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, k, &cfg) != cudaSuccess || n < 1)
    n = 1;
  if (nseen < 64) seen[nseen++] = {k, smem, n};
  return n;
}

template <typename TD, typename TX, typename TG>
Kernel pick(int H) {
  if constexpr (sizeof(TD) == 2 && sizeof(TX) == 2) {
    if (H % 8 == 0 && H <= kHeldMax)
      return H <= 256   ? layernorm_bwd_kernel<TD, TX, TG, 8, 1>
             : H <= 512 ? layernorm_bwd_kernel<TD, TX, TG, 8, 2>
                        : layernorm_bwd_kernel<TD, TX, TG, 8, 4>;
  }
  if (H % 4 == 0 && H <= kHeldMax)
    return H <= 256   ? layernorm_bwd_kernel<TD, TX, TG, 4, 2>
           : H <= 512 ? layernorm_bwd_kernel<TD, TX, TG, 4, 4>
                      : layernorm_bwd_kernel<TD, TX, TG, 4, 8>;
  return layernorm_bwd_looped_kernel<TD, TX, TG>;
}

template <typename TD, typename TX>
Kernel pick_gamma(int H, int p_dtype) {
  return p_dtype ? pick<TD, TX, __nv_bfloat16>(H) : pick<TD, TX, float>(H);
}

template <typename TD>
Kernel pick_x(int H, int x_dtype, int p_dtype) {
  return x_dtype ? pick_gamma<TD, __nv_bfloat16>(H, p_dtype)
                 : pick_gamma<TD, float>(H, p_dtype);
}

}  // namespace

extern "C" {

// dy_dtype, x_dtype (x and dx), p_dtype (gamma, dgamma, dbeta): 0 fp32, 1
// bf16.  workspace: 8 words of counters (0 between calls) then clusters *
// 2H floats; the grid is clusters of 8 blocks, at most as many as the card
// holds at once.
int tf_layernorm_bwd(const void* dy, const void* x, const void* gamma,
                     const float* mean, const float* var, void* dx,
                     void* dgamma, void* dbeta, float* workspace, int R,
                     int H, int clusters, int dy_dtype, int x_dtype,
                     int p_dtype, void* stream) {
  const bool ok_dtype = (dy_dtype == 0 || dy_dtype == 1) &&
                        (x_dtype == 0 || x_dtype == 1) &&
                        (p_dtype == 0 || p_dtype == 1);
  if (!ok_dtype || R < 0 || H <= 0 || H > kLoopedMax || clusters < 1)
    return cudaErrorInvalidValue;
  const Kernel k = dy_dtype ? pick_x<__nv_bfloat16>(H, x_dtype, p_dtype)
                            : pick_x<float>(H, x_dtype, p_dtype);
  const Params p{dy, x, gamma, mean, var, dx, dgamma, dbeta,
                 workspace + kCluster,
                 reinterpret_cast<unsigned*>(workspace), R, H, 1.f / H};
  const size_t smem = smem_bytes(H);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  clusters = std::min(clusters, resident_clusters(k, smem));
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = kCluster;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, k, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // extern "C"
