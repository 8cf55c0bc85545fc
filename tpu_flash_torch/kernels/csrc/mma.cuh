// Tensor-core building blocks shared by the kernels that run bf16 products
// with fp32 sums on Hopper's tensor cores through mma.sync: the quantized
// matmuls' tensor-core forms (quant_matmul.cuh) and the flash-attention
// kernels' tensor-core forms (flash_attention_tc.cuh).  Copies from global to
// shared memory by cp.async or by TMA (cp.async.bulk.tensor) completing on
// an mbarrier, fragment loads by ldmatrix, the m16n8k16 product, the
// packing of two values into a bf16 pair, and an fp32-accurate product as
// six bf16 products (the flash kernels' fp32 forms) or, where the other
// operand is exact in bf16, three (the quantized matmuls' fp32-x forms).
//
// Fragments of mma.sync.m16n8k16 (lane = 4 * g + t, g = lane / 4):
//   A (16 x 16, row major): a[0] row g, columns 2t, 2t + 1; a[1] row g + 8;
//     a[2] and a[3] the same rows, columns 2t + 8, 2t + 9;
//   B (16 x 8):  b[0] rows (k) 2t, 2t + 1 of column g; b[1] rows 2t + 8, 9;
//   C (16 x 8, fp32): c[0], c[1] row g, columns 2t, 2t + 1; c[2], c[3] row
//     g + 8.
// So the C tiles of two neighbouring n8 tiles, packed to bf16 pairs, are
// the A fragment of a product over those 16 columns.
//
// kernels/common.py hashes every .cuh into each library's name, so an edit
// here rebuilds every kernel.

#pragma once

#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or zeros where !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes from global to shared memory, or zeros where !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits until at most N of this thread's groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// mbarriers in shared memory: init (one thread, then fence_mbarrier_init
// and a block barrier), arrive, arrive announcing the bytes a TMA copy will
// deliver, and a wait for the phase of the given parity to complete.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{ .reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// TMA: the box at (c0 along the inner dimension, c1) of a 2D tensor map
// (in .param space: a __grid_constant__ kernel argument) into shared
// memory, completing on bar; elements outside the tensor read zero.
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The high 16 bits of two floats that are exact in bf16, as a bf16 pair.
__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// fp32-accurate products on the tensor cores, as the TPU computes a dot at
// Precision.HIGHEST: each fp32 operand x is split into three bf16 planes,
// hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), whose sum is x
// exactly (each subtraction is exact in fp32; a residual below fp32's
// normal range may lose bits), and a b is summed from the six products
// that matter.  The plain version is kernels/flash_attention.py matmul_x6.

// Two floats (a in the low halves) split into their hi, mid and lo pairs.
__device__ __forceinline__ void split3_pair(float a, float b, uint32_t& hi,
                                            uint32_t& mid, uint32_t& lo) {
  float f[2];
  hi = bf16_pair_rn(a, b);
  bf16x2(hi, f);
  const float ra = a - f[0], rb = b - f[1];
  mid = bf16_pair_rn(ra, rb);
  bf16x2(mid, f);
  lo = bf16_pair_rn(ra - f[0], rb - f[1]);
}

// c += a b from the planes of a (a[0] hi, a[1] mid, a[2] lo: A fragments)
// and of b (B fragments bh, bm, bl): hi.lo, mid.mid, lo.hi, then hi.mid,
// mid.hi, then hi.hi, smallest first, so that hi.hi does not swamp the
// small terms in the tensor cores' fp32 sum.  The three products left out
// (mid.lo, lo.mid, lo.lo) are below 2^-24 of |a| |b|.  The tensor cores
// truncate each fp32 sum, by up to an ulp of c: fine for a sum over a head
// dim or one tile, but over a sequence the bias would grow with its length.
__device__ __forceinline__ void mma_x6(float* c, const uint32_t (&a)[3][4],
                                       const uint32_t* bh, const uint32_t* bm,
                                       const uint32_t* bl) {
  mma_bf16(c, a[0], bl);
  mma_bf16(c, a[1], bm);
  mma_bf16(c, a[2], bh);
  mma_bf16(c, a[0], bm);
  mma_bf16(c, a[1], bh);
  mma_bf16(c, a[0], bh);
}

// mma_x6 for sums over a sequence: the six products into a fresh
// accumulator, added to c in fp32 rounded to nearest, so that the tensor
// cores' truncation stays within one product and the error of c grows as
// an fp32 sum's does.
__device__ __forceinline__ void mma_x6_add(float* c,
                                           const uint32_t (&a)[3][4],
                                           const uint32_t* bh,
                                           const uint32_t* bm,
                                           const uint32_t* bl) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_x6(t, a, bh, bm, bl);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += t[i];
}

// c += a b where only a is fp32 (its planes a[0] hi, a[1] mid, a[2] lo) and
// b is exact in bf16 (the quantized matmuls' integer codes): hi.b + mid.b
// + lo.b is the whole product, each of the three exact in the tensor cores,
// summed lo first.  The plain version is kernels/quant.py matmul_x3.
__device__ __forceinline__ void mma_x3(float* c, const uint32_t (&a)[3][4],
                                       const uint32_t* b) {
  mma_bf16(c, a[2], b);
  mma_bf16(c, a[1], b);
  mma_bf16(c, a[0], b);
}

// mma_x3 into a fresh accumulator, added to c rounded to nearest, as
// mma_x6_add.
__device__ __forceinline__ void mma_x3_add(float* c, const uint32_t (&a)[3][4],
                                           const uint32_t* b) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_x3(t, a, b);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += t[i];
}

// mma_x3 with the operands' roles swapped: a is exact in bf16 (the codes as
// A fragments, the quantized matmuls' decode form) and b is fp32, its
// planes b[0] hi, b[1] mid, b[2] lo as B fragments; the three products go
// into a fresh accumulator, smallest first, added to c rounded to nearest.
__device__ __forceinline__ void mma_x3_b(float* c, const uint32_t* a,
                                         const uint32_t (&b)[3][2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16(t, a, b[2]);
  mma_bf16(t, a, b[1]);
  mma_bf16(t, a, b[0]);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += t[i];
}

}  // namespace
