// Device helpers shared by the kernels in this directory: how bf16 is
// unpacked and rounded, and the error-string entry every library exports.
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

// Eight consecutive values of a row as floats (16 bytes of bf16, or two
// 16-byte fp32 loads); off counts elements and keeps 16-byte alignment.
template <bool BF16>
__device__ __forceinline__ void load8(const void* base, size_t off, float* f) {
  if constexpr (BF16) {
    const uint4 w = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(base) + off);
    bf16x2(w.x, f);
    bf16x2(w.y, f + 2);
    bf16x2(w.z, f + 4);
    bf16x2(w.w, f + 6);
  } else {
    const float4* p = reinterpret_cast<const float4*>(
        static_cast<const float*>(base) + off);
    const float4 a = p[0], b = p[1];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
}

}  // namespace

extern "C" const char* tf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
