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
// dtype.  The bodies are quant_matmul.cuh's; every form reads a packed byte
// once for both of its codes, the low one against x's first half and the
// high one against its second.
//
// What bounds it: at decode (M <= 8) the packed bytes, half those of int8
// (0.5 MB for a 1024 x 1024 projection: 0.16 us at 3.35 TB/s; 2.1 MB at
// K1024 N4096: 0.65 us); at prefill the 2 M K N operations.  bf16 x at
// M <= 8 (groups and N a multiple of 16) runs the tensor-core decode form
// (*_dec_kernel, quant_matmul.cuh): one launch, the packed rows split over a
// thread-block cluster and summed in distributed shared memory, a TMA ring,
// mma.sync with the tokens as the n8 side; each loaded word of packed codes
// gives the A fragments of two products, its low nibbles against x's first
// half and its high nibbles against the second; grouped, each half's
// current group partial (8 floats a lane) is scaled into the sum at the
// group's end.  bf16 x at M > 8 runs the tensor-core prefill form
// (*_tc_kernel): one packed tile converted once per block into the low and
// the high codes as bf16 in shared memory, fp32 sums, group partials scaled
// at the group's end.  fp32 x at M > 8, per column or in groups that are a
// multiple of 16, runs int4_matmul_x3_kernel / int4_matmul_group_x3_kernel:
// the same tiles, x split into three bf16 planes in shared memory, each
// code product three bf16 products on the tensor cores (2 M K N / 329.7
// TFLOP/s at best); per column an odd K takes x by single values, its
// column K read as 0 against the last packed row's high nibble.  fp32 x at
// M <= 8, per column or in groups that are a multiple of 16 (N a multiple
// of 16, up to 8 x 1024 packed rows), runs int4_matmul_dec_x3_kernel /
// int4_matmul_group_dec_x3_kernel: the bf16 decode form's launch, the
// block's slice of x, both halves, split into three bf16 planes in shared
// memory, each code product three bf16 products, the per-column scales
// applied to the fp32 sum in the epilogue; per column an odd K takes x by
// single values, its column K read as 0.  fp32 x at M <= 8 with other N or
// more rows runs fp32 FMAs on the CUDA cores (_m8, a second kernel summing
// its splits), as do groups the tensor-core forms do not take (_m8, and
// _m64 above M = 8): grouped, each thread keeps the low and the high
// group's partial sums beside its total (~170 registers, one block a
// multiprocessor).  Per column the tensor-core forms take every M > 8, so
// there is no per-column CUDA-core prefill kernel.
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

__global__ void __launch_bounds__(kTcThreads)
int4_matmul_x3_kernel(const QParams p) {
  quant_matmul_x3_body<kInt4>(p);
}

__global__ void __launch_bounds__(kTcThreads)
int4_matmul_group_x3_kernel(const QParams p) {
  quant_matmul_x3_body<kInt4Group>(p);
}

template <int BN>
__global__ void __launch_bounds__(kDecThreads)
int4_matmul_dec_kernel(const __grid_constant__ QDecParams d) {
  quant_matmul_dec_body<kInt4, BN, false>(d);
}

template <int BN>
__global__ void __launch_bounds__(kDecThreads)
int4_matmul_dec_x3_kernel(const __grid_constant__ QDecParams d) {
  quant_matmul_dec_body<kInt4, BN, true>(d);
}

template <int BN>
__global__ void __launch_bounds__(kDecThreads)
int4_matmul_group_dec_kernel(const __grid_constant__ QDecParams d) {
  quant_matmul_dec_body<kInt4Group, BN, false>(d);
}

template <int BN>
__global__ void __launch_bounds__(kDecThreads)
int4_matmul_group_dec_x3_kernel(const __grid_constant__ QDecParams d) {
  quant_matmul_dec_body<kInt4Group, BN, true>(d);
}

}  // namespace

extern "C" {

// groups: 0 for per-column scales [N], else G for scales [G, N] (G even
// and dividing K; the tensor-core forms 2 to 5 need K / G a multiple of
// 16; form 1, the CUDA-core prefill form, is there for group scales
// only).  The other arguments as
// tf_int8_matmul's, with the packed rows K2 = ceil(K / 2) split into ranges
// of `chunk`.
int tf_int4_matmul(const void* x, const void* packed, const float* scales,
                   void* out, float* part, int M, int N, int K, int groups,
                   int form, int bn, int chunk, int splits, int stage_rows,
                   int stages, int dtype, void* stream) {
  if ((dtype != 0 && dtype != 1) || groups < 0 ||
      (groups > 0 && (groups % 2 || K % groups)) ||
      (groups > 0 && form >= kTensorCore && (K / groups) % 16))
    return cudaErrorInvalidValue;
  const QParams p{x, static_cast<const uint8_t*>(packed), scales, out, part,
                  M, N, K, (K + 1) / 2, chunk, groups ? K / groups : 1,
                  dtype == 1};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (groups)
    return quant_matmul_launch(
        {int4_matmul_group_kernel_m8,
         int4_matmul_group_kernel_m64,
         int4_matmul_group_tc_kernel,
         int4_matmul_group_x3_kernel,
         {int4_matmul_group_dec_kernel<32>, int4_matmul_group_dec_kernel<64>,
          int4_matmul_group_dec_kernel<128>},
         {int4_matmul_group_dec_x3_kernel<32>,
          int4_matmul_group_dec_x3_kernel<64>,
          int4_matmul_group_dec_x3_kernel<128>}},
        p, true, form, bn, splits, stage_rows, stages, false, s);
  return quant_matmul_launch(
      {int4_matmul_kernel_m8,
       nullptr,
       int4_matmul_tc_kernel,
       int4_matmul_x3_kernel,
       {int4_matmul_dec_kernel<32>, int4_matmul_dec_kernel<64>,
        int4_matmul_dec_kernel<128>},
       {int4_matmul_dec_x3_kernel<32>, int4_matmul_dec_x3_kernel<64>,
        int4_matmul_dec_x3_kernel<128>}},
      p, true, form, bn, splits, stage_rows, stages, true, s);
}

}  // extern "C"
