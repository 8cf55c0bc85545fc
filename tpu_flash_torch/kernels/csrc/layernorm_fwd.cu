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
// a handful of flops; at the reference MT shape (R = 8192, H = 256) the 8.4
// MB of bf16 x and y take 2.5 us at 3.35 TB/s, about as long as a few
// round trips to device memory, so the kernel is bound by how many bytes
// it keeps in flight and how few round trips each warp waits on.
//
// The first form (PR 3: one warp a row, 8-byte bf16 loads, the dtypes as
// run-time flags inside every load and store, a second pass reading x
// again for y) took 2.7x that bound in bf16.  This form:
//   * the dtypes of x and of gamma / beta are template parameters;
//   * a warp holds a whole row in registers: lane l holds columns
//     V (32 j + l) .. + V - 1, j < NV, as 16-byte vectors (V = 8 in bf16, 4
//     in fp32; 8-byte bf16 vectors where H % 8 != 0), kept packed until
//     they are used, so x is read once and y written once, 16 bytes a
//     lane at a time;
//   * gamma and beta are read once a lane, after the first row's loads are
//     issued, and reused for every row the warp takes;
//   * the grid is sized to the card (kernels/layernorm.py _fwd_plan: 2
//     blocks of 8 warps an SM) and warp w of the grid takes rows w, w + W,
//     ... RP at a time (two where a row is at most 32 bytes a lane); the
//     next pass's loads are issued before this pass's shuffles, so a lane
//     has two or more loads in flight and a warp's reads of one pass run
//     under its stores of the one before (at R8192 a warp takes two
//     passes, 6 % faster than one pass at H256 in bf16 on an H100,
//     tools/torch_ln_fwd_plans.py);
//   * mean and var are stored by one lane a row.
// Rows wider than 1024 and H % 4 != 0 take a looped form with the same
// arithmetic: lane l owns columns l, l + 32, ..., and the row is read
// twice, the second time from L1 or L2.
//
// C entry: tf_layernorm_fwd(...) takes the plan (V, NV, blocks; V = 0 the
// looped form), launches on the given stream, allocates
// nothing and returns cudaGetLastError() (or cudaErrorInvalidValue for a
// shape, dtype or plan it was not built for).

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kHeldMax = 1024;  // the widest row held in registers
constexpr float kEps = 1e-8f;

struct Params {
  const void* x;      // [R, H]
  const void* gamma;  // [H]
  const void* beta;   // [H]
  void* y;            // [R, H], x's dtype
  float* mean;        // [R]
  float* var;         // [R]
  int R, H;
};

// Rows a warp loads at once in the held form: two where a row is at most
// 32 bytes a lane (kernels/layernorm.py _fwd_plan sizes the grid by it).
__host__ __device__ constexpr int held_rows(int V, int NV, int item) {
  return V * NV * item <= 32 ? 2 : 1;
}

// V values of T as one load: 16 bytes, or 8 (four bf16).
template <typename T, int V>
using Packed = std::conditional_t<V * sizeof(T) == 16, uint4, uint2>;

template <typename T, int V>
__device__ __forceinline__ void unpack(const Packed<T, V>& w, float* f) {
  if constexpr (sizeof(T) == 4) {
    f[0] = __uint_as_float(w.x);
    f[1] = __uint_as_float(w.y);
    f[2] = __uint_as_float(w.z);
    f[3] = __uint_as_float(w.w);
  } else if constexpr (V == 8) {
    bf16x2(w.x, f);
    bf16x2(w.y, f + 2);
    bf16x2(w.z, f + 4);
    bf16x2(w.w, f + 6);
  } else {
    bf16x2(w.x, f);
    bf16x2(w.y, f + 2);
  }
}

// The held form: V values a vector, NV vectors a lane (H <= 32 V NV,
// H % V == 0), RP rows a pass.
template <typename TX, typename TP, int V, int NV>
__global__ void __launch_bounds__(kThreads)
layernorm_fwd_kernel(const Params p) {
  constexpr int RP = held_rows(V, NV, sizeof(TX));
  using Vec = Packed<TX, V>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int H = p.H, W = gridDim.x * kWarps;
  const TX* xp = static_cast<const TX*>(p.x);
  TX* yp = static_cast<TX*>(p.y);
  int row0 = blockIdx.x * kWarps + warp;
  if (row0 >= p.R) return;

  // the pass of rows r0, r0 + W, ...: this lane's vectors (zeros past the
  // row or past R)
  auto load_pass = [&](Vec (&v)[RP][NV], int r0) {
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      const int row = r0 + r * W;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int c = V * (32 * j + lane);
        if (row < p.R && c < H)
          v[r][j] = *reinterpret_cast<const Vec*>(xp + (size_t)row * H + c);
        else
          v[r][j] = Vec{};
      }
    }
  };
  Vec cur[RP][NV], nxt[RP][NV];
  load_pass(cur, row0);
  float g[NV][V], bt[NV][V];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = V * (32 * j + lane);
    if (c < H) {
      load_v<TP, V>(static_cast<const TP*>(p.gamma) + c, g[j]);
      load_v<TP, V>(static_cast<const TP*>(p.beta) + c, bt[j]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) g[j][e] = bt[j][e] = 0.f;
    }
  }

  for (;;) {
    const int next0 = row0 + RP * W;
    if (next0 < p.R) load_pass(nxt, next0);   // before this pass's shuffles
    float s[RP], s2[RP];
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      s[r] = s2[r] = 0.f;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        float f[V];
        unpack<TX, V>(cur[r][j], f);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          s[r] += f[e];
          s2[r] += f[e] * f[e];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      s[r] = warp_sum(s[r]);
      s2[r] = warp_sum(s2[r]);
    }
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      const int row = row0 + r * W;
      if (row >= p.R) break;
      const float mean = s[r] / H;
      const float var = s2[r] / H - mean * mean;
      const float rstd = rsqrtf(var + kEps);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int c = V * (32 * j + lane);
        if (c < H) {
          float f[V];
          unpack<TX, V>(cur[r][j], f);
#pragma unroll
          for (int e = 0; e < V; ++e)
            f[e] = (f[e] - mean) * rstd * g[j][e] + bt[j][e];
          store_v<TX, V>(yp + (size_t)row * H + c, f);
        }
      }
      if (lane == 0) {
        p.mean[row] = mean;
        p.var[row] = var;
      }
    }
    if (next0 >= p.R) break;
    row0 = next0;
#pragma unroll
    for (int r = 0; r < RP; ++r)
#pragma unroll
      for (int j = 0; j < NV; ++j) cur[r][j] = nxt[r][j];
  }
}

// Wider rows and H % 4 != 0: lane l owns columns l, l + 32, ...; each row
// read twice (the sums, then y).
template <typename TX, typename TP>
__global__ void __launch_bounds__(kThreads)
layernorm_fwd_looped_kernel(const Params p) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int H = p.H, W = gridDim.x * kWarps;
  const TX* xp = static_cast<const TX*>(p.x);
  const TP* gp = static_cast<const TP*>(p.gamma);
  const TP* bp = static_cast<const TP*>(p.beta);
  TX* yp = static_cast<TX*>(p.y);
  for (int row = blockIdx.x * kWarps + warp; row < p.R; row += W) {
    const TX* xr = xp + (size_t)row * H;
    float s = 0.f, s2 = 0.f;
    for (int c = lane; c < H; c += 32) {
      const float v = to_float(xr[c]);
      s += v;
      s2 += v * v;
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float mean = s / H;
    const float var = s2 / H - mean * mean;
    const float rstd = rsqrtf(var + kEps);
    for (int c = lane; c < H; c += 32)
      yp[(size_t)row * H + c] = from_float<TX>(
          (to_float(xr[c]) - mean) * rstd * to_float(gp[c]) +
          to_float(bp[c]));
    if (lane == 0) {
      p.mean[row] = mean;
      p.var[row] = var;
    }
  }
}

using Kernel = void (*)(Params);

// The instantiation for the plan (V = 0 the looped form), or null.
template <typename TX, typename TP>
Kernel pick(int V, int NV) {
  if (V == 0) return layernorm_fwd_looped_kernel<TX, TP>;
  if constexpr (sizeof(TX) == 2) {
    if (V == 8) switch (NV) {
        case 1: return layernorm_fwd_kernel<TX, TP, 8, 1>;
        case 2: return layernorm_fwd_kernel<TX, TP, 8, 2>;
        case 4: return layernorm_fwd_kernel<TX, TP, 8, 4>;
      }
  }
  if (V == 4) switch (NV) {
      case 1: return layernorm_fwd_kernel<TX, TP, 4, 1>;
      case 2: return layernorm_fwd_kernel<TX, TP, 4, 2>;
      case 4: return layernorm_fwd_kernel<TX, TP, 4, 4>;
      case 8: return layernorm_fwd_kernel<TX, TP, 4, 8>;
    }
  return nullptr;
}

template <typename TX>
Kernel pick_gamma(int V, int NV, int p_dtype) {
  return p_dtype ? pick<TX, __nv_bfloat16>(V, NV) : pick<TX, float>(V, NV);
}

}  // namespace

extern "C" {

// x_dtype (x and y), p_dtype (gamma and beta): 0 fp32, 1 bf16.  The plan:
// V values a vector and NV vectors a lane (V = 0: the looped form), blocks
// of 8 warps.
int tf_layernorm_fwd(const void* x, const void* gamma, const void* beta,
                     void* y, float* mean, float* var, int R, int H,
                     int x_dtype, int p_dtype, int V, int NV, int blocks,
                     void* stream) {
  if ((x_dtype != 0 && x_dtype != 1) || (p_dtype != 0 && p_dtype != 1) ||
      R < 0 || H <= 0 || blocks < 1)
    return cudaErrorInvalidValue;
  const int item = x_dtype ? 2 : 4;
  const bool held_ok = V > 0 && V * item >= 8 && H % V == 0 &&
                       H <= 32 * V * NV && H <= kHeldMax;
  if (!(V == 0 || held_ok)) return cudaErrorInvalidValue;
  const Kernel k = x_dtype ? pick_gamma<__nv_bfloat16>(V, NV, p_dtype)
                           : pick_gamma<float>(V, NV, p_dtype);
  if (k == nullptr) return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  const Params p{x, gamma, beta, y, mean, var, R, H};
  k<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

}  // extern "C"
