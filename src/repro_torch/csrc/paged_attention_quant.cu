// Paged decode / verify attention over the int8 KV block pool, for Hopper
// (sm_90a): the int8 K/V tiles and their fp32 scales are read straight off
// the shared pools through each sequence's block table and dequantized on
// chip, so the fp K/V never exists in device memory.  The kernel body is in
// paged_attention.cuh (shared with the fp pool's kernel); this file binds
// it to int8 pools (`paged::Int8Pool`: each element dequantized as
// float(int8) * its slot's scale before it enters a dot, the reference's
// order).
//
// Replaces the TPU kernel `paged_ragged_verify_attention_quant`
// (src/repro/kernels/ragged_attention.py, body `_paged_quant_kernel`):
// pools [N,BS,KV,D] int8, scales [N,BS,KV] fp32, otherwise B1's function.
//
// Bound: every allocated int8 K/V slot once per KV head plus its two fp32
// scales, about B * ctx * KV * (2 * D + 8) bytes, against
// 2 * 2 * B * H * T * ctx * D fp32 operations (the reference dequantizes to
// fp32 before the dots): bytes at T = 1, operations at T = 11.  16-byte
// vector loads of the int8 tile are later work.

#include "paged_attention.cuh"

// dtype: 0 = float32, 1 = bfloat16 (q and out share it; the pools are int8,
// the scales float32).  window <= 0 means no window.  Returns
// cudaGetLastError() after the launch.
extern "C" int paged_attention_quant(const void* q, const void* pool_k,
                                     const void* pool_v, const void* k_scale,
                                     const void* v_scale,
                                     const int* block_table, const int* q_pos,
                                     const int* kv_pos, void* out, int n_b,
                                     int n_t, int n_h, int n_kv, int d, int bs,
                                     int maxb, int window, float scale,
                                     int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  paged::TableAddr table{block_table, maxb, bs};
  paged::Int8Pool pool{static_cast<const int8_t*>(pool_k),
                       static_cast<const int8_t*>(pool_v),
                       static_cast<const float*>(k_scale),
                       static_cast<const float*>(v_scale)};
  if (dtype == 0)
    return paged::launch<float>(q, pool, table, q_pos, kv_pos, out, n_b,
                                n_t, n_h, n_kv, d, bs, window, scale, s);
  if (dtype == 1)
    return paged::launch<__nv_bfloat16>(q, pool, table, q_pos, kv_pos,
                                        out, n_b, n_t, n_h, n_kv, d, bs, window,
                                        scale, s);
  return (int)cudaErrorInvalidValue;
}
