// Flash-attention backward, single pass in KV-outer order, for sm_90a.
//
// Replaces tpu_flash/kernels/flash_attention.py::_bwd_fused_kernel
// (flash_attention.py:1228) and its body _bwd_kv_outer_body (:1254), launched
// by pl.pallas_call at :2045.  From q [B, H, Lq, D], k and v [B, Hkv, Lk, D],
// dO [B, H, Lq, D], the saved lse and delta = rowsum(dO * O) - dlse (fp32
// [B, H, Lq], formed by the caller) it computes
//   P  = exp(S - lse),  dP = dO V^T,  dS = P * (dP - delta),
//   dV = P^T dO,  dK = scale * dS^T Q,  dQ = scale * dS K.
// dK and dV ([B, Hkv, Lk, D], the input dtype) are summed over the query heads
// of each GQA group inside the block, in fp32.  dQ is added into a zeroed
// [B, H, Lq, D] fp32 workspace that the caller scales and casts: the TPU keeps
// it race-free by running one (batch, head) in order against a full-sequence
// VMEM scratch (:1290-1293), which does not fit in a Hopper block's 227 KB of
// shared memory at L = 2048.  Here the blocks that reach a chunk of query
// rows add to it one after another, in the order of their key tiles, each
// waiting on a counter per chunk (dq_order, int32 zeroed by the caller) that
// the one before it released; so dQ's sums run in one order, and two calls
// give the same bits, as the TPU's and the two-pass form's do.  The blocks
// walk their chunks from the last down, so that the tiles of a head reach
// each chunk in step (flash_attention_bwd.cuh).
//
// Two forms on the tensor cores, chosen by the wrapper
// (kernels/flash_attention.py _form_name) and exported as separate C
// entries, both one block of 4 warps per (batch * KV head, tile of 64 keys):
//   * bf16 (tf_flash_attention_bwd_tc): kv_outer_tc_body with dQ, every
//     product an mma.sync.m16n8k16 with fp32 sums (the TPU rounds
//     q * scale * log2(e), P and dS to bf16 before its dots, which makes
//     each dot a bf16 x bf16 -> fp32 product), P^T and dS^T reused from the
//     accumulators as A fragments, the query tiles of 64 rows (the chunk of
//     the ordered dQ adds) through a cp.async ring, and dQ of a tile formed
//     on the tensor cores from dS^T in shared memory;
//   * fp32 (tf_flash_attention_bwd_x6): kv_outer_x6_body with dQ, the
//     same walk with every product six bf16 products of the operands split
//     in three (mma_x6, mma.cuh), as the TPU runs fp32 dots at
//     Precision.HIGHEST, k, v and each query tile arriving in fp32 and split
//     once into bf16 planes in shared memory.
// Both bodies are flash_attention_bwd.cuh's, which the dK/dV pass of the
// two-pass form runs without dQ.  Each form has a masked instantiation
// (kMask: a sliding window and segment ids), launched only where the call
// has either; under a window a key tile waits at a chunk only for the key
// tiles below it whose band reaches the chunk (dq_turn), so the adds keep
// the key tiles' order and two calls still give the same bits.  Each form,
// masked or not, has a dropout instantiation (kDrop), which regenerates
// the forward's keep bits (flash_attention_tc.cuh), and quantized ones
// (kQuant: K and V as one-byte codes with token scales or channel codes;
// flash_attention_bwd.cuh), the _kvq C entries of a library of their own
// (flash_attention_bwd_kvq.cu builds this file with TF_KVQ).
//
// What bounds it: operations (five L^2 * D products, 4.3e10 useful flops at
// B4 H8 L2048 d64 causal, against ~50 MB of traffic).  In bf16 the dQ adds
// set the pace: one 64 x 64 fp32 tile per (key tile, query tile) pair, 0.28
// GB of reductions into L2 at that shape and 4.3 GB at B1 H8 L16384 (PERF.md
// measures their share).  More keys a block, wgmma, TMA and warp
// specialisation are later work (ROADMAP.md).
//
// C entries launch on the given stream, allocate nothing and return
// cudaGetLastError() (or cudaErrorInvalidValue for a shape or dtype they do
// not take).

#include "flash_attention_bwd.cuh"

namespace {

// Two blocks an SM (as the dK/dV pass: without the bound ptxas caps d = 32
// at 168 registers and spills).
template <int D, bool kMask, bool kDrop, int kQuant>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_attention_bwd_tc_kernel(const BwdParamsOf<kMask, kDrop, kQuant> p) {
  kv_outer_tc_body<D, true, kMask, kDrop, kQuant>(p);
}

// The fp32 form: kv_outer_x6_body with dQ (flash_attention_bwd.cuh), one
// block an SM.
template <int D, bool kMask, bool kDrop, int kQuant>
__global__ void __launch_bounds__(kTcThreads)
flash_attention_bwd_x6_kernel(const BwdParamsOf<kMask, kDrop, kQuant> p) {
  kv_outer_x6_body<D, true, kMask, kDrop, kQuant>(p, kvq_of(p));
}

// Its quantized forms, a kernel of their own bounded to two blocks an SM
// (the shared memory allows one): without the bound ptxas holds 96-168
// registers and spills, and the bound on the forms without quantization
// would move their registers.
template <int D, bool kMask, bool kDrop, int kQuant>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_attention_bwd_kvq_x6_kernel(
    const BwdParamsOf<kMask, kDrop, kQuant> p) {
  kv_outer_x6_body<D, true, kMask, kDrop, kQuant>(p, kvq_of(p));
}

template <int D, bool kMask, bool kDrop, int kQuant>
cudaError_t launch_form(const BwdParamsOf<kMask, kDrop, kQuant>& p, bool x6,
                        cudaStream_t stream) {
  if (!x6)
    return launch_kv_outer_tc<D, true, kMask, kDrop, kQuant>(
        flash_attention_bwd_tc_kernel<D, kMask, kDrop, kQuant>, p, stream);
  if constexpr (kQuant != kKvNone)
    return launch_kv_outer_x6<D, true, kMask, kDrop, kQuant>(
        flash_attention_bwd_kvq_x6_kernel<D, kMask, kDrop, kQuant>, p,
        stream);
  else
    return launch_kv_outer_x6<D, true, kMask, kDrop, kQuant>(
        flash_attention_bwd_x6_kernel<D, kMask, kDrop, kQuant>, p, stream);
}

template <typename Prm>
cudaError_t launch_d(const Prm& p, int d, bool x6, cudaStream_t stream) {
  constexpr bool kMask = kMaskOf<Prm>, kDrop = kDropOf<Prm>;
  constexpr int kQuant = kQuantOf<Prm>;
  switch (d) {
    case 16: return launch_form<16, kMask, kDrop, kQuant>(p, x6, stream);
    case 32: return launch_form<32, kMask, kDrop, kQuant>(p, x6, stream);
    case 64: return launch_form<64, kMask, kDrop, kQuant>(p, x6, stream);
    case 128: return launch_form<128, kMask, kDrop, kQuant>(p, x6, stream);
  }
  return cudaErrorInvalidValue;
}

// The checks every entry makes, then the launch of the call's form
// (kQuant: kKvNone in the library without quantization, TF_KVQ's in a
// kvq library).
template <int kQuant>
int bwd_entry(bool x6, const void* q, const void* k, const void* v,
              const void* dout, const float* lse, const float* delta,
              float* dq, int* dq_order, void* dk, void* dv, int B, int H,
              int Hkv, int Lq, int Lk, int d, int dtype, int causal,
              int q_offset, float scale, float scale2, int window,
              const int* seg, const DropCall& drop, const KvqCall& kvq,
              cudaStream_t st) {
  if (dtype != (x6 ? 0 : 1) ||
      !bwd_args_ok(dtype, H, Hkv, d, (long long)B * Hkv) ||
      !mask_args_ok(window, causal, seg, Lq, Lk) ||
      !kvq_args_ok(kQuant, kvq))
    return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || Lk == 0) return cudaSuccess;
  const BwdParams p{q,  k,  v,        dout,        lse,   delta,
                    dq, dk, dv,       B,           H,     Hkv,
                    Lq, Lk, q_offset, causal != 0, scale, scale2,
                    dq_order};
  return launch_form_of<kQuant>(
      p, window, seg, drop, kvq,
      [&](const auto& prm) { return launch_d(prm, d, x6, st); });
}

}  // namespace

extern "C" {

// dtype: the _tc entry takes 1, bf16 (the tensor-core form), the _x6 entry
// 0, fp32.  q, k, v, dout, dk and dv share it.  dq: fp32 [B, H, Lq, d] and
// dq_order: int32 [B * H, ceil(Lq / chunk)], both zeroed; chunk is the
// form's query tile: 64 rows, and 32 in fp32 at d = 128.  window and seg
// (the masked form), seed, threshold and keep_scale (the dropout form) as
// the forward's entries take them.
#define TF_BWD_ARGS                                                          \
  const void *q, const void *k, const void *v, const void *dout,            \
      const float *lse, const float *delta, float *dq, int *dq_order,       \
      void *dk, void *dv, int B, int H, int Hkv, int Lq, int Lk, int d,     \
      int dtype, int causal, int q_offset, float scale, float scale2,       \
      int window, const int *seg, const int *seed, unsigned threshold,      \
      float keep_scale
#define TF_BWD_CALL                                                          \
  q, k, v, dout, lse, delta, dq, dq_order, dk, dv, B, H, Hkv, Lq, Lk, d,    \
      dtype, causal, q_offset, scale, scale2, window, seg,                  \
      DropCall{seed, threshold, keep_scale}

#ifndef TF_KVQ
#define TF_BWD_ENTRY(symbol, x6)                                             \
  int symbol(TF_BWD_ARGS, void* stream) {                                   \
    return bwd_entry<kKvNone>(x6, TF_BWD_CALL, KvqCall{},                   \
                            static_cast<cudaStream_t>(stream));             \
  }

TF_BWD_ENTRY(tf_flash_attention_bwd_tc, false)
TF_BWD_ENTRY(tf_flash_attention_bwd_x6, true)
#else
// The quantized forms of TF_KVQ's granularity (flash_attention_bwd_kvq.cu,
// token: k_scale and v_scale fp32 [B, Hkv, Lk]; flash_attention_bwd_kvqc.cu,
// channel codes: both null): k and v int8 or e4m3 codes (fp8 != 0); dtype
// as above is q's, dout's, dk's and dv's.
#define TF_BWD_KVQ_ENTRY(symbol, x6)                                         \
  int symbol(TF_BWD_ARGS, const float* k_scale, const float* v_scale,       \
             int fp8, void* stream) {                                       \
    return bwd_entry<TF_KVQ>(x6, TF_BWD_CALL,                               \
                           KvqCall{k_scale, v_scale, fp8},                  \
                           static_cast<cudaStream_t>(stream));              \
  }

TF_BWD_KVQ_ENTRY(tf_flash_attention_bwd_tc_kvq, false)
TF_BWD_KVQ_ENTRY(tf_flash_attention_bwd_x6_kvq, true)
#endif

}  // extern "C"
