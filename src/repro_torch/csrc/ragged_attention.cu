// Decode / verify attention over the dense per-slot KV ring, for Hopper
// (sm_90a).  The kernel body is in paged_verify.cuh (shared with the block
// pools' kernels B1 and B4); this file binds it to fp32 / bf16 rings with
// the ring addressing (`pv::RingAddr`): a row's W slots are ceil(W/16)
// units of 16 slots, chunk j of row b at flat slot b*W + 16j, the slots of
// a last chunk past W staged empty in the kernel, so the ring is never
// padded or copied.
//
// Replaces the TPU kernel `ragged_verify_attention`
// (src/repro/kernels/ragged_attention.py, body `_kernel`): q [B,T,H,D],
// k_buf/v_buf [B,W,KV,D], q_pos [B,T], kv_pos [B,W] (-1 = empty).
//
// Bound on this card (H100 SXM: 3.35 TB/s; 989 TFLOP/s bf16 tensor cores,
// 67 TFLOP/s fp32): the kv_pos row, W * 4 bytes a sequence, plus the K/V
// of the slots that hold a position valid for the call (2 * KV * D *
// sizeof(dtype) bytes a slot), against 4 * B * H * T * slots * D
// operations; on a full ring every slot is live.  At B 4, H 9 / KV 3,
// D 64, W 2048 full: fp32 T 1 moves 12.6 MB (3.8 us), bf16 T 11 6.3 MB
// (1.9 us) against 208 MFLOP (0.2 us on bf16 tensor cores): bytes bound.
// What the design does about it: the split grid (B, KV, S) over the
// ring's chunks, the kv_pos-first skip that neither copies nor multiplies
// a chunk without a live slot (a serve's rows hold a fraction of W), the
// cp.async stage ring and tensor-core products of paged_verify.cuh.

#include "paged_verify.cuh"

// dtype: 0 = float32, 1 = bfloat16 (q, rings and out share it).  window
// <= 0 means no window.  splits >= 1 splits each row's ceil(W/16) chunks;
// with splits > 1, scratch holds (D + 2) * B * KV * splits * G * T floats.
// Returns cudaGetLastError() after the last launch.
extern "C" int ragged_attention(const void* q, const void* k_buf,
                                const void* v_buf, const int* q_pos,
                                const int* kv_pos, void* out, int n_b, int n_t,
                                int n_h, int n_kv, int d, int w, int window,
                                float scale, int dtype, int splits,
                                void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kChunk = pv::RingAddr::kChunk;
  int chunk_log2 = 0;
  while ((1 << chunk_log2) < kChunk) ++chunk_log2;
  pv::Args a{q, k_buf, v_buf, nullptr, nullptr, nullptr, q_pos, kv_pos, out,
             static_cast<float*>(scratch), n_b, n_t, n_h, n_kv, chunk_log2,
             (w + kChunk - 1) / kChunk, window, splits, scale, w};
  if (dtype == 0) return pv::launch<pv::RingAddr, float, float>(a, d, s);
  if (dtype == 1)
    return pv::launch<pv::RingAddr, __nv_bfloat16, __nv_bfloat16>(a, d, s);
  return (int)cudaErrorInvalidValue;
}
