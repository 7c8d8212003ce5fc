// Paged decode / verify attention over the fp32 or bf16 KV block pool, for
// Hopper (sm_90a).  The kernel body is in paged_attention.cuh (shared with
// the int8 pool's kernel); this file binds it to fp pools.
//
// Replaces the TPU kernel `paged_ragged_verify_attention`
// (src/repro/kernels/ragged_attention.py, body `_paged_kernel`).
//
// Bound: the kernel must read every allocated K/V slot of the sequence
// once per KV head, about B * ctx * KV * D * 2 * sizeof(dtype) bytes,
// against 2 * 2 * B * H * T * ctx * D operations; at decode shapes the
// bytes dominate.

#include "paged_attention.cuh"

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it).
// window <= 0 means no window.  Returns cudaGetLastError() after launch.
extern "C" int paged_attention(const void* q, const void* pool_k,
                               const void* pool_v, const int* block_table,
                               const int* q_pos, const int* kv_pos, void* out,
                               int n_b, int n_t, int n_h, int n_kv, int d,
                               int bs, int maxb, int window, float scale,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  paged::TableAddr table{block_table, maxb, bs};
  if (dtype == 0) {
    paged::FpPool<float> pool{static_cast<const float*>(pool_k),
                              static_cast<const float*>(pool_v)};
    return paged::launch<float>(q, pool, table, q_pos, kv_pos, out, n_b,
                                n_t, n_h, n_kv, d, bs, window, scale, s);
  }
  if (dtype == 1) {
    paged::FpPool<__nv_bfloat16> pool{static_cast<const __nv_bfloat16*>(pool_k),
                                      static_cast<const __nv_bfloat16*>(pool_v)};
    return paged::launch<__nv_bfloat16>(q, pool, table, q_pos, kv_pos, out,
                                        n_b, n_t, n_h, n_kv, d, bs, window,
                                        scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
