// The quantized-K/V forms of the flash-attention two-pass backward (the dK/dV
// and dQ passes) for token-scaled codes (fp32 scales [B, Hkv, Lk] by key):
// every form of flash_attention_bwd_two_pass.cu (each dtype, head dim, mask
// and dropout form) with K and V as one-byte codes, behind the _kvq C entries
// (flash_attention_tc.cuh, "quantized K/V").  A library of each granularity,
// so that nvcc compiles them beside the forms without quantization
// (kernels/common.py starts one nvcc a source, all at once).

#define TF_KVQ kKvToken
#include "flash_attention_bwd_two_pass.cu"
