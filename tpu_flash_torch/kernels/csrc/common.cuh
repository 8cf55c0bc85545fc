// Device helpers shared by the kernels in this directory: how bf16 is
// unpacked and rounded, loads and stores of fp32 or bf16 rows as floats
// (the dtype a run-time flag or a template parameter), warp reductions, the
// thread-block cluster barrier, and the error-string entry every library
// exports.
// Each .cu file builds into a shared library of its own and includes this
// header once; kernels/common.py hashes it into every library's name, so an
// edit here rebuilds them all.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// Round to the nearest bf16 (ties to even) and widen back to fp32.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Two bf16 packed in a word (the low half first) to two floats, exactly.
__device__ __forceinline__ void bf16x2(uint32_t w, float* f) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}

// The masked-softmax backward takes fp32 or bf16 per array, chosen at run
// time by a flag (the branch is uniform across the grid; the softmax
// forward and both LayerNorm kernels take their dtypes as template
// arguments, load_v and store_v below).  One value as a float:
__device__ __forceinline__ float load1(const void* base, size_t i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i])
              : static_cast<const float*>(base)[i];
}

// Four consecutive values as floats: one 16-byte load (fp32) or 8-byte load
// (bf16); i is a multiple of 4 and the base 16-byte aligned.
__device__ __forceinline__ float4 load4(const void* base, size_t i, bool bf16) {
  if (bf16) {
    const uint2 w = *reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(base) + i);
    float f[4];
    bf16x2(w.x, f);
    bf16x2(w.y, f + 2);
    return make_float4(f[0], f[1], f[2], f[3]);
  }
  return *reinterpret_cast<const float4*>(static_cast<const float*>(base) + i);
}

// Stores, rounding to the nearest bf16 (ties to even) where bf16.
__device__ __forceinline__ void store1(void* base, size_t i, float x,
                                       bool bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(base)[i] = x;
}

__device__ __forceinline__ void store4(void* base, size_t i, float4 x,
                                       bool bf16) {
  if (bf16) {
    __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(
        static_cast<__nv_bfloat16*>(base) + i);
    d[0] = __floats2bfloat162_rn(x.x, x.y);
    d[1] = __floats2bfloat162_rn(x.z, x.w);
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(base) + i) = x;
  }
}

// Two floats rounded to the nearest bf16 (ties to even), as a bf16 pair:
// a in the low half.
__device__ __forceinline__ uint32_t bf16_pair_rn(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The dtype as a template argument: T is float or __nv_bfloat16.
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V neighbouring values of T as floats: one 16-byte load where they are 16
// bytes, one 8-byte load where they are 8 (four bf16), else single values;
// the address aligned to the load.
template <typename T, int V>
__device__ __forceinline__ void load_v(const T* src, float* f) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 w = *reinterpret_cast<const uint4*>(src);
    if constexpr (sizeof(T) == 4) {
      f[0] = __uint_as_float(w.x);
      f[1] = __uint_as_float(w.y);
      f[2] = __uint_as_float(w.z);
      f[3] = __uint_as_float(w.w);
    } else {
      bf16x2(w.x, f);
      bf16x2(w.y, f + 2);
      bf16x2(w.z, f + 4);
      bf16x2(w.w, f + 6);
    }
  } else if constexpr (V * sizeof(T) == 8 && sizeof(T) == 2) {
    const uint2 w = *reinterpret_cast<const uint2*>(src);
    bf16x2(w.x, f);
    bf16x2(w.y, f + 2);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) f[e] = to_float(src[e]);
  }
}

// V floats stored as T (rounded to the nearest bf16, ties to even), by the
// same loads' widths.
template <typename T, int V>
__device__ __forceinline__ void store_v(T* dst, const float* f) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 w;
    if constexpr (sizeof(T) == 4) {
      w = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                     __float_as_uint(f[2]), __float_as_uint(f[3]));
    } else {
      w = make_uint4(bf16_pair_rn(f[0], f[1]), bf16_pair_rn(f[2], f[3]),
                     bf16_pair_rn(f[4], f[5]), bf16_pair_rn(f[6], f[7]));
    }
    *reinterpret_cast<uint4*>(dst) = w;
  } else if constexpr (V * sizeof(T) == 8 && sizeof(T) == 2) {
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(bf16_pair_rn(f[0], f[1]), bf16_pair_rn(f[2], f[3]));
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) dst[e] = from_float<T>(f[e]);
  }
}

// Sum and max over the 32 lanes of a warp; every lane gets the result.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// The split barrier of a thread-block cluster: arrive (relaxed, or
// releasing this thread's writes) and wait (acquiring the others').  Every
// thread of every block of the cluster takes part; arrivals and waits
// alternate.  A block reads or writes a peer's shared memory only between a
// wait and the peer's next arrival, and no block exits while a peer may
// still reach into its shared memory.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// Both halves: every block of the cluster has reached this point.
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

}  // namespace

extern "C" const char* tf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
