// Decode / verify attention over the dense per-slot KV ring, for Hopper
// (sm_90a).  The kernel body is in paged_attention.cuh (the block-pool
// kernels' body until they moved to paged_verify.cuh); this file binds it
// to fp32 / bf16 rings read in 32-slot tiles (`paged::RingAddr`): tile p
// of row b starts at ring slot b*W + p*32, its positions at
// kv_pos[b, p*32 ...], and the short last tile of a W that is no multiple
// of 32 is masked in the kernel, so the ring is never padded or copied.
//
// Replaces the TPU kernel `ragged_verify_attention`
// (src/repro/kernels/ragged_attention.py, body `_kernel`): q [B,T,H,D],
// k_buf/v_buf [B,W,KV,D], q_pos [B,T], kv_pos [B,W] (-1 = empty).
//
// Bound: every ring slot once per KV head, 2 * B * W * KV * D * sizeof(dtype)
// bytes plus kv_pos, against 2 * 2 * B * H * T * W * D operations; bytes at
// T = 1, operations at T = 11 in fp32.  The serial tile sweep of one block
// per (b, kv head) is what bounds it in practice (B1's follow-ups apply).

#include "paged_attention.cuh"

// dtype: 0 = float32, 1 = bfloat16 (q, rings and out share it).
// window <= 0 means no window.  Returns cudaGetLastError() after launch.
extern "C" int ragged_attention(const void* q, const void* k_buf,
                                const void* v_buf, const int* q_pos,
                                const int* kv_pos, void* out, int n_b, int n_t,
                                int n_h, int n_kv, int d, int w, int window,
                                float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  paged::RingAddr ring{w};
  const int tw = paged::RingAddr::kTile;
  if (dtype == 0) {
    paged::FpPool<float> pool{static_cast<const float*>(k_buf),
                              static_cast<const float*>(v_buf)};
    return paged::launch<float>(q, pool, ring, q_pos, kv_pos, out, n_b, n_t,
                                n_h, n_kv, d, tw, window, scale, s);
  }
  if (dtype == 1) {
    paged::FpPool<__nv_bfloat16> pool{static_cast<const __nv_bfloat16*>(k_buf),
                                      static_cast<const __nv_bfloat16*>(v_buf)};
    return paged::launch<__nv_bfloat16>(q, pool, ring, q_pos, kv_pos, out, n_b,
                                        n_t, n_h, n_kv, d, tw, window, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
