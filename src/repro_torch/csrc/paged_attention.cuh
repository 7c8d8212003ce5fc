// Paged decode / verify attention for Hopper (sm_90a), read straight off
// the shared KV block pool through each sequence's block table: the kernel
// body shared by paged_attention.cu (fp32 / bf16 pools) and
// paged_attention_quant.cu (int8 pools with per-slot scales).  The two
// differ only in how a K/V element is read (the `Pool` parameter).
//
// Function: GQA attention of q [B,T,H,D] over the pool [N,BS,KV,D]; slot
// (block p, offset s) is valid for query position qp iff
// 0 <= kv_pos[p,s] <= qp (and qp - kv_pos < window when a window is set);
// an unallocated table entry (-1) masks its whole logical block; scale
// 1/sqrt(D); out = acc / max(l, 1e-30), so a row with no valid slot is 0.
//
// Layout: one thread block per (sequence b, KV head).  The block holds the
// G*T query rows of its KV head (G = H/KV) in shared memory together with
// their online-softmax state (m, l, acc) in fp32, and walks the sequence's
// logical blocks in a loop -- the loop takes the place of the TPU grid's
// sequential block axis.  Per logical block it reads its own table entry,
// skips the block if it is unallocated (identical to masking every score:
// a fully masked tile leaves (m, l, acc) unchanged), stages the K/V tile in
// fp32 and its kv_pos row in shared memory, and each warp updates its query
// rows: lane s < BS scores slot s, the warp reduces max and sum, and lane
// d updates acc[d], acc[d+32], ...
//
// This first version keeps one block per (b, kv) and plain loads;
// splitting the sweep over blocks (flash-decoding), cp.async or TMA
// staging and tensor cores are later work.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace paged {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Pools stored in the compute type's storage type (float or bfloat16).
// `slot` is the flat (block, offset, KV head) index; c the head-dim lane.
template <typename T>
struct FpPool {
  const T* k;
  const T* v;
  __device__ __forceinline__ float key(size_t slot, int c, int d) const {
    return to_f(k[slot * d + c]);
  }
  __device__ __forceinline__ float value(size_t slot, int c, int d) const {
    return to_f(v[slot * d + c]);
  }
};

// int8 pools with one fp32 scale per stored vector: every element is
// dequantized as float(int8) * scale, one fp32 product, BEFORE it enters a
// dot -- the reference's order (scaling the finished dot rounds otherwise).
struct Int8Pool {
  const int8_t* k;
  const int8_t* v;
  const float* k_scale;
  const float* v_scale;
  __device__ __forceinline__ float key(size_t slot, int c, int d) const {
    return (float)k[slot * d + c] * k_scale[slot];
  }
  __device__ __forceinline__ float value(size_t slot, int c, int d) const {
    return (float)v[slot * d + c] * v_scale[slot];
  }
};

template <typename Q, typename Pool>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const Q* __restrict__ q, Pool pool,
                       const int* __restrict__ block_table,
                       const int* __restrict__ q_pos,
                       const int* __restrict__ kv_pos, Q* __restrict__ out,
                       int n_t, int n_h, int n_kv, int d, int bs, int maxb,
                       int window, float scale) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int g = n_h / n_kv;
  const int rows = g * n_t;              // query rows of this KV head
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = kThreads / 32;

  extern __shared__ float smem[];
  float* q_s = smem;                     // [rows, d]
  float* acc = q_s + rows * d;           // [rows, d]
  float* m_s = acc + rows * d;           // [rows]
  float* l_s = m_s + rows;               // [rows]
  float* k_s = l_s + rows;               // [bs, d + 1] (padded: no bank conflicts)
  float* v_s = k_s + bs * (d + 1);       // [bs, d]
  float* p_w = v_s + bs * d;             // [nwarps, bs] probabilities
  int* pos_s = reinterpret_cast<int*>(p_w + nwarps * bs);   // [bs]
  int* qp_s = pos_s + bs;                // [n_t]

  // row r <-> (t = r / g, head h = kvh * g + r % g): the reference's
  // q.reshape(b, t, kv, g, d) grouping
  for (int i = tid; i < rows * d; i += kThreads) {
    const int r = i / d, c = i % d;
    const int t = r / g, h = kvh * g + r % g;
    q_s[i] = to_f(q[((size_t)(b * n_t + t) * n_h + h) * d + c]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < rows; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  for (int t = tid; t < n_t; t += kThreads) qp_s[t] = q_pos[b * n_t + t];
  __syncthreads();

  for (int lb = 0; lb < maxb; ++lb) {
    const int phys = block_table[b * maxb + lb];
    if (phys < 0) continue;              // uniform across the block
    for (int i = tid; i < bs * d; i += kThreads) {
      const int s = i / d, c = i % d;
      const size_t slot = ((size_t)phys * bs + s) * n_kv + kvh;
      k_s[s * (d + 1) + c] = pool.key(slot, c, d);
      v_s[s * d + c] = pool.value(slot, c, d);
    }
    for (int s = tid; s < bs; s += kThreads) pos_s[s] = kv_pos[phys * bs + s];
    __syncthreads();

    for (int r = warp; r < rows; r += nwarps) {
      const int qp = qp_s[r / g];
      float sc = kNegInf;
      bool valid = false;
      if (lane < bs) {
        const int kp = pos_s[lane];
        valid = kp >= 0 && kp <= qp && (window <= 0 || qp - kp < window);
        if (valid) {
          float dot = 0.f;
          const float* qr = q_s + r * d;
          const float* kr = k_s + lane * (d + 1);
          for (int c = 0; c < d; ++c) dot = fmaf(qr[c], kr[c], dot);
          sc = dot * scale;
        }
      }
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(sc));
      const float alpha = expf(m_prev - m_new);
      const float p = valid ? expf(sc - m_new) : 0.f;
      const float psum = warp_sum(p);
      if (lane < bs) p_w[warp * bs + lane] = p;
      __syncwarp();
      for (int c = lane; c < d; c += 32) {
        float a = acc[r * d + c] * alpha;
        for (int s = 0; s < bs; ++s) a = fmaf(p_w[warp * bs + s], v_s[s * d + c], a);
        acc[r * d + c] = a;
      }
      __syncwarp();                      // m_prev and p_w read by every lane
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + psum;
      }
      __syncwarp();
    }
    __syncthreads();                     // before the next tile overwrites
  }

  for (int i = tid; i < rows * d; i += kThreads) {
    const int r = i / d, c = i % d;
    const int t = r / g, h = kvh * g + r % g;
    store(&out[((size_t)(b * n_t + t) * n_h + h) * d + c],
          acc[i] / fmaxf(l_s[r], 1e-30f));
  }
}

inline size_t smem_bytes(int rows, int d, int bs, int n_t) {
  const int nwarps = kThreads / 32;
  return sizeof(float) * (2 * (size_t)rows * d + 2 * rows + (size_t)bs * (d + 1)
                          + (size_t)bs * d + nwarps * bs)
         + sizeof(int) * (bs + n_t);
}

// Launches on `stream`; returns cudaGetLastError() after the launch.
template <typename Q, typename Pool>
int launch(const void* q, Pool pool, const int* block_table, const int* q_pos,
           const int* kv_pos, void* out, int n_b, int n_t, int n_h, int n_kv,
           int d, int bs, int maxb, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes((n_h / n_kv) * n_t, d, bs, n_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<Q, Pool>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(n_b, n_kv);
  paged_attention_kernel<Q, Pool><<<grid, kThreads, smem, stream>>>(
      static_cast<const Q*>(q), pool, block_table, q_pos, kv_pos,
      static_cast<Q*>(out), n_t, n_h, n_kv, d, bs, maxb, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace paged
