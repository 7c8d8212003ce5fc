// Paged decode / verify attention over the fp32 or bf16 KV block pool, for
// Hopper (sm_90a).  The kernel body is in paged_verify.cuh (shared with the
// int8 pool's kernel); this file binds it to fp pools.
//
// Replaces the TPU kernel `paged_ragged_verify_attention`
// (src/repro/kernels/ragged_attention.py, body `_paged_kernel`).
//
// Bound on this card (H100 SXM: 3.35 TB/s; 989 TFLOP/s bf16 tensor cores,
// 67 TFLOP/s fp32): every allocated K/V slot once per KV head,
// B * ctx * KV * D * 2 * sizeof(dtype) bytes, plus kv_pos, against
// 4 * B * H * T * ctx * D operations.  At B 4, H 9 / KV 3, D 64, ctx 2048:
// fp32 T 1 moves 12.6 MB (3.8 us); bf16 T 11 moves 6.4 MB (1.9 us) against
// 208 MFLOP (0.2 us on bf16 tensor cores), about 32 operations a byte,
// far below the ~295 at which the card stops being memory-bound: bytes
// bound every shape the serves run.  What the design does about it: the
// grid splits each sequence's blocks over S thread blocks so that
// B * KV * S fills the 132 SMs about twice; 16-byte cp.async copies stage
// 64-slot tiles in a 2-stage ring so loads overlap compute; QK^T and PV run
// on tensor cores (bf16, or 3xTF32 for fp32), so the rows of a verify
// pass share every K/V load (paged_verify.cuh has the details).

#include "paged_verify.cuh"

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it).  window
// <= 0 means no window.  bs must be a power of two <= 32.  splits >= 1;
// with splits > 1, scratch holds (D + 2) * B * KV * splits * G * T floats.
// Returns cudaGetLastError() after the last launch.
extern "C" int paged_attention(const void* q, const void* pool_k,
                               const void* pool_v, const int* block_table,
                               const int* q_pos, const int* kv_pos, void* out,
                               int n_b, int n_t, int n_h, int n_kv, int d,
                               int bs, int maxb, int window, float scale,
                               int dtype, int splits, void* scratch,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int bs_log2 = 0;
  while ((1 << bs_log2) < bs) ++bs_log2;
  if ((1 << bs_log2) != bs) return (int)cudaErrorInvalidValue;
  pv::Args a{q, pool_k, pool_v, nullptr, nullptr, block_table, q_pos, kv_pos,
             out, static_cast<float*>(scratch), n_b, n_t, n_h, n_kv, bs_log2,
             maxb, window, splits, scale};
  if (dtype == 0) return pv::launch<pv::TableAddr, float, float>(a, d, s);
  if (dtype == 1)
    return pv::launch<pv::TableAddr, __nv_bfloat16, __nv_bfloat16>(a, d, s);
  return (int)cudaErrorInvalidValue;
}
