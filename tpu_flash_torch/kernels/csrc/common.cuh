// Device helpers shared by the kernels in this directory: how bf16 is
// unpacked and rounded, loads and stores of fp32 or bf16 rows as floats,
// warp reductions, and the error-string entry every library exports.
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

// The LayerNorm kernels and the masked-softmax backward take fp32 or bf16
// per array, chosen at run time by a flag (the branch is uniform across the
// grid; the softmax forward takes its dtype as a template argument).  One
// value as a float:
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

}  // namespace

extern "C" const char* tf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
