// int8 weight-only matmul for sm_90a.
//
// Replaces tpu_flash/kernels/quant.py::_matmul_kernel (quant.py:49,
// launched by pl.pallas_call at :103):
//   out[M, N] = (x[M, K] @ codes[K, N], fp32 sums) * scales[N]
// with x fp32 or bf16, codes int8 in the JAX package's [K, N] layout (N
// contiguous: 16-byte loads along N), scales fp32 applied once in the
// epilogue, out in x's dtype.  The body is quant_matmul.cuh's (MODE kInt8).
//
// What bounds it: at decode (M <= 8) the code bytes, read once (4.29 MB at
// K1024 N4096: 1.28 us at 3.35 TB/s; 1 MB for a 1024 x 1024 projection:
// 0.31 us); at prefill (M up to 1024) the operations, 2 M K N of them (fp32
// x: three bf16 products each, 2 M K N / 329.7 TFLOP/s).
// Five forms, chosen by the wrapper (kernels/quant.py _plan), each
// described in quant_matmul.cuh: bf16 x at M <= 8 (N a multiple of 16)
// runs int8_matmul_dec_kernel (one launch, the code rows split over a thread-
// block cluster and summed in distributed shared memory, a TMA ring, the
// tensor cores with the tokens as the n8 side); fp32 x at M <= 8 (N a
// multiple of 16, up to 8 x 1024 code rows) int8_matmul_dec_x3_kernel (the
// same launch, the block's slice of x split into three bf16 planes in
// shared memory, each code product three bf16 products); bf16 x at M > 8
// int8_matmul_tc_kernel (bf16 products of x and the codes converted exactly
// to bf16 in shared memory, fp32 sums on the tensor cores); fp32 x at M > 8
// int8_matmul_x3_kernel (x split into three bf16 planes in shared memory,
// each code product three bf16 products on the tensor cores); at M <= 8
// other N, and fp32 x beyond 8 x 1024 code rows, the CUDA-core kernel (_m8:
// fp32 FMAs, a second kernel summing its splits).  The tensor-core forms
// take every M > 8, so int8 has no CUDA-core prefill kernel.  No form
// writes a dequantized copy of W.
//
// C entry: tf_int8_matmul(...) launches on the given stream, allocates
// nothing and returns cudaGetLastError() (or cudaErrorInvalidValue for
// arguments it does not take).

#include "quant_matmul.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel_m8(const QParams p) {
  quant_matmul_body<1, 128, kInt8>(p);
}

__global__ void __launch_bounds__(kTcThreads)
int8_matmul_tc_kernel(const QParams p) {
  quant_matmul_tc_body<kInt8>(p);
}

__global__ void __launch_bounds__(kTcThreads)
int8_matmul_x3_kernel(const QParams p) {
  quant_matmul_x3_body<kInt8>(p);
}

template <int BN>
__global__ void __launch_bounds__(kDecThreads)
int8_matmul_dec_kernel(const __grid_constant__ QDecParams d) {
  quant_matmul_dec_body<kInt8, BN, false>(d);
}

template <int BN>
__global__ void __launch_bounds__(kDecThreads)
int8_matmul_dec_x3_kernel(const __grid_constant__ QDecParams d) {
  quant_matmul_dec_body<kInt8, BN, true>(d);
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16, of x and out.  form: 0 decode on the CUDA cores
// (bn 128, chunks a multiple of 128 rows), 1 (the CUDA-core prefill) is
// refused, 2 prefill on the tensor cores (bf16, bn 64, chunks of
// 64), 3 decode on the tensor cores (bf16, M <= 8, N a multiple of 16, bn
// 32, 64 or 128, chunks a multiple of 64, `splits` <= 8 the cluster,
// stage_rows and stages each warp's ring, no workspace), 4 prefill on the
// tensor cores for fp32 x (fp32, bn 128, chunks of 64), 5 decode on the
// tensor cores for fp32 x (fp32, as form 3 otherwise).  The code rows are
// split into `splits` ranges of `chunk` rows; forms 0-2 and 4 with splits >
// 1 take part, an fp32 [splits, M, N] workspace.
int tf_int8_matmul(const void* x, const void* codes, const float* scales,
                   void* out, float* part, int M, int N, int K, int form,
                   int bn, int chunk, int splits, int stage_rows, int stages,
                   int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const QParams p{x, static_cast<const uint8_t*>(codes), scales, out, part,
                  M, N, K, K, chunk, 1, dtype == 1};
  return quant_matmul_launch(
      {int8_matmul_kernel_m8,
       nullptr,
       int8_matmul_tc_kernel,
       int8_matmul_x3_kernel,
       {int8_matmul_dec_kernel<32>, int8_matmul_dec_kernel<64>,
        int8_matmul_dec_kernel<128>},
       {int8_matmul_dec_x3_kernel<32>, int8_matmul_dec_x3_kernel<64>,
        int8_matmul_dec_x3_kernel<128>}},
      p, false, form, bn, splits, stage_rows, stages, true,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
