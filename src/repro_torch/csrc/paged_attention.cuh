// Decode / verify attention for Hopper (sm_90a) read straight off the
// dense per-slot KV ring: the kernel body of ragged_attention.cu (B5).  The
// block-pool kernels B1 and B4 moved to paged_verify.cuh (split-KV grid,
// cp.async staging, tensor cores); B5 moves to that body in the next
// kernel PR, and this header goes then.  The body still takes a `Pool`
// (how a K/V element is read) and an `Addr` (where a tile of a sequence's
// cache lies) parameter; the ring is the one addressing left.
//
// Function: GQA attention of q [B,T,H,D] over the sequence's cache slots;
// a slot is valid for query position qp iff 0 <= kv_pos[slot] <= qp (and
// qp - kv_pos < window when a window is set); scale 1/sqrt(D);
// out = acc / max(l, 1e-30), so a row with no valid slot is 0.
//
// Addressing (`RingAddr`): a sequence's cache is a list of tiles of 32
// slots; tile p holds ring slots p*32 ... of row b, at flat slot
// b*W + p*32; the last tile of a ring whose W is no multiple of 32 is
// short, and its missing slots are staged as empty (kv_pos -1, zero K/V),
// so the buffers are never padded.  kv_pos sits beside K/V at the same
// flat slot.
//
// Layout: one thread block per (sequence b, KV head).  The block holds the
// G*T query rows of its KV head (G = H/KV) in shared memory together with
// their online-softmax state (m, l, acc) in fp32, and walks the sequence's
// tiles in a loop -- the loop takes the place of the TPU grid's sequential
// kv axis.  Per tile it stages the K/V tile in fp32 and its kv_pos row in
// shared memory, and each warp updates its query rows: lane s scores slot
// s, the warp reduces max and sum, and lane d updates acc[d], acc[d+32], ...
//
// This first version keeps one block per (b, kv) and plain loads.

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

// Tiles of the dense ring [B,W,...]: 32 ring slots each, the last one
// ragged when W is no multiple of 32.
struct RingAddr {
  static constexpr bool kRagged = true;    // the last tile may be short
  static constexpr int kTile = 32;
  int w;
  __device__ __forceinline__ int n_tiles() const { return (w + kTile - 1) / kTile; }
  __device__ __forceinline__ int tile(int b, int p, int* len) const {
    *len = min(kTile, w - p * kTile);
    return b * w + p * kTile;
  }
};

// `tw` is the widest tile (<= 32, one lane per slot).
template <typename Q, typename Pool, typename Addr>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const Q* __restrict__ q, Pool pool, Addr addr,
                       const int* __restrict__ q_pos,
                       const int* __restrict__ kv_pos, Q* __restrict__ out,
                       int n_t, int n_h, int n_kv, int d, int tw,
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
  float* k_s = l_s + rows;               // [tw, d + 1] (padded: no bank conflicts)
  float* v_s = k_s + tw * (d + 1);       // [tw, d]
  float* p_w = v_s + tw * d;             // [nwarps, tw] probabilities
  int* pos_s = reinterpret_cast<int*>(p_w + nwarps * tw);   // [tw]
  int* qp_s = pos_s + tw;                // [n_t]

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

  const int n_tiles = addr.n_tiles();
  for (int tile = 0; tile < n_tiles; ++tile) {
    int len;
    const int base = addr.tile(b, tile, &len);
    if (base < 0) continue;              // uniform across the block
    // stage the K/V tile in fp32.  A full tile copies without a bound
    // check per element; only a short ring tail (compiled only where a
    // tile can be short; uniform across the block) stages its missing
    // slots empty, zero K/V, so their zero probabilities never meet
    // garbage in the acc update.
    if (!Addr::kRagged || len == tw) {
      for (int i = tid; i < tw * d; i += kThreads) {
        const int s = i / d, c = i % d;
        const size_t slot = ((size_t)base + s) * n_kv + kvh;
        k_s[s * (d + 1) + c] = pool.key(slot, c, d);
        v_s[s * d + c] = pool.value(slot, c, d);
      }
    } else {
      for (int i = tid; i < tw * d; i += kThreads) {
        const int s = i / d, c = i % d;
        const size_t slot = ((size_t)base + s) * n_kv + kvh;
        k_s[s * (d + 1) + c] = s < len ? pool.key(slot, c, d) : 0.f;
        v_s[s * d + c] = s < len ? pool.value(slot, c, d) : 0.f;
      }
    }
    for (int s = tid; s < tw; s += kThreads) pos_s[s] = s < len ? kv_pos[base + s] : -1;
    __syncthreads();

    for (int r = warp; r < rows; r += nwarps) {
      const int qp = qp_s[r / g];
      float sc = kNegInf;
      bool valid = false;
      if (lane < tw) {
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
      if (lane < tw) p_w[warp * tw + lane] = p;
      __syncwarp();
      for (int c = lane; c < d; c += 32) {
        float a = acc[r * d + c] * alpha;
        for (int s = 0; s < tw; ++s) a = fmaf(p_w[warp * tw + s], v_s[s * d + c], a);
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

inline size_t smem_bytes(int rows, int d, int tw, int n_t) {
  const int nwarps = kThreads / 32;
  return sizeof(float) * (2 * (size_t)rows * d + 2 * rows + (size_t)tw * (d + 1)
                          + (size_t)tw * d + nwarps * tw)
         + sizeof(int) * (tw + n_t);
}

// Launches on `stream`; returns cudaGetLastError() after the launch.
template <typename Q, typename Pool, typename Addr>
int launch(const void* q, Pool pool, Addr addr, const int* q_pos,
           const int* kv_pos, void* out, int n_b, int n_t, int n_h, int n_kv,
           int d, int tw, int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes((n_h / n_kv) * n_t, d, tw, n_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<Q, Pool, Addr>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(n_b, n_kv);
  paged_attention_kernel<Q, Pool, Addr><<<grid, kThreads, smem, stream>>>(
      static_cast<const Q*>(q), pool, addr, q_pos, kv_pos,
      static_cast<Q*>(out), n_t, n_h, n_kv, d, tw, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace paged
