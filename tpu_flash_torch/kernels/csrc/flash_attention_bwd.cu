// Flash-attention backward, single pass in KV-outer order, for sm_90a.
//
// Replaces tpu_flash/kernels/flash_attention.py::_bwd_fused_kernel
// (flash_attention.py:1228) and its body _bwd_kv_outer_body (:1254), launched
// by pl.pallas_call at :2045.  From q [B, H, Lq, D], k and v [B, Hkv, Lk, D],
// dO [B, H, Lq, D] (fp32 or bf16), the saved lse and delta = rowsum(dO * O)
// - dlse (fp32 [B, H, Lq], formed by the caller) it computes
//   P  = exp(S - lse),  dP = dO V^T,  dS = P * (dP - delta),
//   dV = P^T dO,  dK = scale * dS^T Q,  dQ = scale * dS K.
// dK and dV ([B, Hkv, Lk, D], the input dtype) are summed over the query heads
// of each GQA group inside the block, in fp32.  dQ is added into a zeroed
// [B, H, Lq, D] fp32 workspace that the caller scales and casts: the TPU keeps
// it race-free by running one (batch, head) in order against a full-sequence
// VMEM scratch (:1290-1293), which does not fit in a Hopper block's 227 KB of
// shared memory at L = 2048.  Here the blocks that reach a chunk of 32 query
// rows add to it one after another, in the order of their key tiles, each
// waiting on a counter per chunk (dq_order, int32 zeroed by the caller) that
// the one before it released; so dQ's sums run in one order, and two calls
// give the same bits, as the TPU's and the two-pass form's do.  The blocks
// walk their chunks from the last down, so that the tiles of a head reach
// each chunk in step (flash_attention_bwd.cuh).
//
// What bounds it: operations (five L^2 * D products, 4.3e10 useful flops at
// B4 H8 L2048 d64 causal, against ~50 MB of traffic).  The body, shared with
// the dK/dV pass of the two-pass form, is kv_outer_body in
// flash_attention_bwd.cuh: one block per (batch * KV head, tile of 64 keys),
// k, v, dK and dV rows in registers, query rows staged in shared memory in
// chunks, and dQ of a chunk formed as a small product in the block and added
// in the fixed order above.  Tensor cores, TMA and pipelining are later work
// (ROADMAP.md).
//
// C entry: tf_flash_attention_bwd(...) launches on the given stream,
// allocates nothing and returns cudaGetLastError() (or cudaErrorInvalidValue
// for a shape or dtype it does not take).

#include "flash_attention_bwd.cuh"

namespace {

template <int D, bool BF16>
__global__ void __launch_bounds__(kv_outer_threads<D>())
flash_attention_bwd_kernel(const BwdParams p) {
  kv_outer_body<D, BF16, true>(p);
}

template <int D>
cudaError_t launch_dtype(const BwdParams& p, int bf16, cudaStream_t stream) {
  return bf16 ? launch_kv_outer<D, true>(flash_attention_bwd_kernel<D, true>,
                                         p, stream)
              : launch_kv_outer<D, true>(flash_attention_bwd_kernel<D, false>,
                                         p, stream);
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16 (q, k, v, dout, dk and dv share it).  dq: fp32
// [B, H, Lq, d] and dq_order: int32 [B * H, ceil(Lq / 32)], both zeroed.
int tf_flash_attention_bwd(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, float* dq, int* dq_order,
                           void* dk, void* dv, int B, int H, int Hkv, int Lq,
                           int Lk, int d, int dtype, int causal, int q_offset,
                           float scale, float scale2, void* stream) {
  if (!bwd_args_ok(dtype, H, Hkv, d, (long long)B * Hkv))
    return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || Lk == 0) return cudaSuccess;
  const BwdParams p{q,  k,  v,        dout,        lse,   delta,
                    dq, dk, dv,       B,           H,     Hkv,
                    Lq, Lk, q_offset, causal != 0, scale, scale2,
                    dq_order};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_dtype<16>(p, dtype, st);
    case 32: return launch_dtype<32>(p, dtype, st);
    case 64: return launch_dtype<64>(p, dtype, st);
    case 128: return launch_dtype<128>(p, dtype, st);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
