// Paged decode / verify attention over the int8 KV block pool, for Hopper
// (sm_90a): the int8 K/V tiles and their fp32 scales are read straight off
// the shared pools through each sequence's block table, so the fp K/V never
// exists in device memory.  The kernel body is in paged_verify.cuh (shared
// with the fp pool's kernel); this file binds it to int8 pools.  int8
// values are exact in bf16 and in TF32, so K and V enter the tensor-core
// products unscaled: each slot's k_scale multiplies its score and its
// v_scale its probability (one rounding moved against the reference's
// "dequantize, then dot"; paged_verify.cuh).
//
// Replaces the TPU kernel `paged_ragged_verify_attention_quant`
// (src/repro/kernels/ragged_attention.py, body `_paged_quant_kernel`):
// pools [N,BS,KV,D] int8, scales [N,BS,KV] fp32, otherwise B1's function.
//
// Bound on this card (H100 SXM: 3.35 TB/s; 989 TFLOP/s bf16 tensor cores,
// 67 TFLOP/s fp32): every allocated int8 K/V slot once per KV head plus
// its two fp32 scales, B * ctx * KV * (2 * D + 8) bytes, plus kv_pos,
// against 4 * B * H * T * ctx * D operations.  At B 4, H 9 / KV 3, D 64,
// ctx 2048: T 1 moves 3.4 MB (1.0 us); T 11 with bf16 q moves 3.5 MB
// (1.0 us) against 208 MFLOP (0.2 us on bf16 tensor cores): bytes bound.
// With fp32 q the same operations count at the fp32 peak (3.1 us), so
// that shape is bound by operations.  What the design does about it: the
// split grid, the cp.async ring (16-byte copies of the int8 rows, one
// 4-byte copy of each scale a slot) and tensor-core products of
// paged_verify.cuh.

#include "paged_verify.cuh"

// dtype: 0 = float32, 1 = bfloat16 (q and out share it; the pools are int8,
// the scales float32).  window <= 0 means no window.  bs must be a power of
// two <= 32.  splits >= 1; with splits > 1, scratch holds
// (D + 2) * B * KV * splits * G * T floats.  Returns cudaGetLastError()
// after the last launch.
extern "C" int paged_attention_quant(const void* q, const void* pool_k,
                                     const void* pool_v, const void* k_scale,
                                     const void* v_scale,
                                     const int* block_table, const int* q_pos,
                                     const int* kv_pos, void* out, int n_b,
                                     int n_t, int n_h, int n_kv, int d, int bs,
                                     int maxb, int window, float scale,
                                     int dtype, int splits, void* scratch,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int bs_log2 = 0;
  while ((1 << bs_log2) < bs) ++bs_log2;
  if ((1 << bs_log2) != bs) return (int)cudaErrorInvalidValue;
  pv::Args a{q, pool_k, pool_v, static_cast<const float*>(k_scale),
             static_cast<const float*>(v_scale), block_table, q_pos, kv_pos,
             out, static_cast<float*>(scratch), n_b, n_t, n_h, n_kv, bs_log2,
             maxb, window, splits, scale};
  if (dtype == 0) return pv::launch<pv::TableAddr, float, int8_t>(a, d, s);
  if (dtype == 1) return pv::launch<pv::TableAddr, __nv_bfloat16, int8_t>(a, d, s);
  return (int)cudaErrorInvalidValue;
}
