// int8 weight-only matmul for sm_90a.
//
// Replaces tpu_flash/kernels/quant.py::_matmul_kernel (quant.py:49,
// launched by pl.pallas_call at :103):
//   out[M, N] = (x[M, K] @ codes[K, N], fp32 sums) * scales[N]
// with x fp32 or bf16, codes int8 in the JAX package's [K, N] layout (N
// contiguous: 16-byte loads along N), scales fp32 applied once in the
// epilogue, out in x's dtype.  The body is quant_matmul.cuh's (MODE kInt8).
//
// What bounds it: at decode (M = 8) the code bytes, read once (1 MB for a
// 1024 x 1024 projection: 0.32 us at 3.35 TB/s); at prefill (M up to
// 1024) the operations, 2 M K N of them.  Three forms, chosen by the
// wrapper (kernels/quant.py _plan): decode (M <= 8) and fp32 x at M > 8 run
// fp32 FMAs on the CUDA cores; bf16 x at M > 8 runs int8_matmul_tc_kernel,
// bf16 products of x and the codes converted exactly to bf16 in shared
// memory, fp32 sums on the tensor cores (mma.sync).  The design keeps the
// weight in int8 from device memory to the chip (no dequantized copy of W
// is ever written), and splits the code rows over blocks when the output
// alone gives too few.
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

__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel_m64(const QParams p) {
  quant_matmul_body<8, 32, kInt8>(p);
}

__global__ void __launch_bounds__(kTcThreads)
int8_matmul_tc_kernel(const QParams p) {
  quant_matmul_tc_body<kInt8>(p);
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16, of x and out.  bm: the form, by its rows a block:
// 8 (decode), 64 (CUDA-core prefill) or 128 (tensor-core prefill, bf16
// only); the code rows are split into `splits` ranges of `chunk` rows (a
// multiple of 128 for bm 8, of 32 otherwise); with splits > 1, part is an
// fp32 [splits, M, N] workspace.
int tf_int8_matmul(const void* x, const void* codes, const float* scales,
                   void* out, float* part, int M, int N, int K, int bm,
                   int chunk, int splits, int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const QParams p{x, static_cast<const uint8_t*>(codes), scales, out, part,
                  M, N, K, K, chunk, 1, dtype == 1};
  return quant_matmul_launch(int8_matmul_kernel_m8, int8_matmul_kernel_m64,
                             int8_matmul_tc_kernel, p, bm, splits, true,
                             static_cast<cudaStream_t>(stream));
}

}  // extern "C"
