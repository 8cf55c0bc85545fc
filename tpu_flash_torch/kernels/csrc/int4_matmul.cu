// Packed-int4 weight-only matmul for sm_90a, per-column or group scales.
//
// Replaces tpu_flash/kernels/quant.py::_matmul4_kernel (quant.py:228,
// launched by pl.pallas_call at :383) and ::_matmul4_group_kernel (:258,
// launched at :371):
//   out[M, N] = sum over k of x[M, k] * (code[k, N] - 8) * scale
// with the codes packed two a byte in split halves (byte row r: code r in
// the low nibble, code K2 + r in the high nibble, K2 = ceil(K / 2); x's
// column K of an odd K reads 0), scales fp32 [N] applied in the epilogue
// (kInt4) or [G, N] over groups of K / G rows, each group's fp32 partial
// dot scaled before it is added (kInt4Group).  x fp32 or bf16, out in x's
// dtype.  The body is quant_matmul.cuh's: a 16-byte load of packed codes
// feeds two FMAs a byte, one against x's low half and one against its high
// half, kept in shared memory side by side.
//
// What bounds it: at decode (M = 8) the packed bytes, half those of int8
// (0.5 MB for a 1024 x 1024 projection: 0.16 us at 3.35 TB/s); at prefill
// the 2 M K N operations.  Decode and fp32 x at M > 8 run fp32 FMAs on the
// CUDA cores: grouped, each thread keeps the low and the high group's
// partial sums beside its total and scales them at the group's last row,
// so the group size needs no relation to the slab; those sums take
// registers (~170 a thread, one block a multiprocessor), and holding the
// kernels to two blocks spilled and made decode slower.  bf16 x at M > 8
// (groups a multiple of 16) runs the tensor-core form (*_tc_kernel,
// quant_matmul.cuh): one packed tile converted once per block into the low
// and the high codes as bf16, each multiplied with its half of x's columns
// by mma.sync, fp32 sums, group partials scaled at the group's end.
//
// C entry: tf_int4_matmul(...) launches on the given stream, allocates
// nothing and returns cudaGetLastError() (or cudaErrorInvalidValue for
// arguments it does not take).

#include "quant_matmul.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
int4_matmul_kernel_m8(const QParams p) {
  quant_matmul_body<1, 128, kInt4>(p);
}

__global__ void __launch_bounds__(kThreads)
int4_matmul_kernel_m64(const QParams p) {
  quant_matmul_body<8, 32, kInt4>(p);
}

__global__ void __launch_bounds__(kThreads)
int4_matmul_group_kernel_m8(const QParams p) {
  quant_matmul_body<1, 128, kInt4Group>(p);
}

__global__ void __launch_bounds__(kThreads)
int4_matmul_group_kernel_m64(const QParams p) {
  quant_matmul_body<8, 32, kInt4Group>(p);
}

__global__ void __launch_bounds__(kTcThreads)
int4_matmul_tc_kernel(const QParams p) {
  quant_matmul_tc_body<kInt4>(p);
}

__global__ void __launch_bounds__(kTcThreads)
int4_matmul_group_tc_kernel(const QParams p) {
  quant_matmul_tc_body<kInt4Group>(p);
}

}  // namespace

extern "C" {

// groups: 0 for per-column scales [N], else G for scales [G, N] (G even
// and dividing K).  The other arguments as tf_int8_matmul's, with the
// packed rows K2 = ceil(K / 2) split into ranges of `chunk`.
int tf_int4_matmul(const void* x, const void* packed, const float* scales,
                   void* out, float* part, int M, int N, int K, int groups,
                   int bm, int chunk, int splits, int dtype, void* stream) {
  if ((dtype != 0 && dtype != 1) || groups < 0 ||
      (groups > 0 && (groups % 2 || K % groups)))
    return cudaErrorInvalidValue;
  const QParams p{x, static_cast<const uint8_t*>(packed), scales, out, part,
                  M, N, K, (K + 1) / 2, chunk, groups ? K / groups : 1,
                  dtype == 1};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (groups)
    return (bm == kTcBM && (K / groups) % 16)   // the tensor-core form's k
               ? cudaErrorInvalidValue          // depth divides the group
               : quant_matmul_launch(int4_matmul_group_kernel_m8,
                                     int4_matmul_group_kernel_m64,
                                     int4_matmul_group_tc_kernel, p, bm,
                                     splits, false, s);
  return quant_matmul_launch(int4_matmul_kernel_m8, int4_matmul_kernel_m64,
                             int4_matmul_tc_kernel, p, bm, splits, true,
                             s);
}

}  // extern "C"
