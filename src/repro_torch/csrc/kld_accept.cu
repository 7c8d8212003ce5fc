// Fused KLD / acceptance signals for Hopper (sm_90a): one streaming pass
// over the vocabulary, each (b, t) row split over a cluster of blocks.
//
// Replaces the TPU kernel `fused_kld_accept` (src/repro/kernels/
// kld_accept.py, body `_kernel`).  Same function: for target logits tl
// and draft logits dl of one row and the proposed token tok,
//   KL(p || q) floored at 0, H(q), p(tok) and q(tok),
// with p = softmax(tl), q = softmax(dl), all in fp32.
//
// Bound: the kernel reads both logit rows once, 2 * rows * V * 4 bytes,
// and does a few operations per element, so it is bound by device memory:
// 40 rows x V 49280 move 15.8 MB, 4.7 us at 3.35 TB/s.  Streaming at that
// rate takes about 2 MB in flight; one block of dependent 4-byte loads a
// row kept about 0.16 MB in flight and ran near 0.27 TB/s.
//
// Layout.  Row r's V logits are cut into C chunks, one thread block each
// (C <= 8, from the shapes and the SM count alone: kernels/kld_accept.py,
// `kld_chunks`; 8 at the round's 40 rows, 320 blocks).  A thread reads
// both rows with 16-byte loads, kUnroll of each in flight, and keeps the
// online-logsumexp state of both distributions -- target (m_p, s_p,
// a_pd = sum e^{tl-m_p} (tl-dl)) and draft (m_q, s_q, a_qq = sum
// e^{dl-m_q} dl).  It folds a batch of loads at once: the batch's max,
// one rescale of the state, then independent exponentials, so the
// exponentials of a batch overlap instead of forming one dependent
// chain with a branch per element.  Few registers matter more than a
// deep batch: at kUnroll 2 (56 registers) four blocks fit an SM and all
// of the round's 320 are resident at once; at kUnroll 8 (112 registers)
// two do, and the last 56 blocks run as a second wave, which made that
// version slower on the card.  A row whose tl and dl starts are not
// equally placed modulo 16 bytes is read with 4-byte loads; otherwise the
// scalars before the first 16-byte boundary (the head, at most 3) go to
// chunk 0 and the scalars after the last whole vector (the tail, at most
// 3) to chunk C-1.  So any unit-stride view is taken as it is, e.g. the
// round's t_logits[:, :K] or a V that is no multiple of 4.
//
// Merge.  Each block merges its threads' states (shuffles, then warps in
// order through shared memory).  The C blocks of a row form one
// thread-block cluster; block 0 reads the other blocks' states through
// distributed shared memory (cluster.map_shared_rank) and merges them in
// rank order.  A cluster rather than a second merge kernel over partials in
// scratch: one launch, no scratch, and the merge costs a cluster barrier
// instead of a second kernel's launch and a DRAM round trip.  No atomics:
// one input gives the same bits on every call.  Block 0 finalises as the
// TPU kernel does:
//   lse = m + log s,  KL = a_pd/s_p - lse_p + lse_q,  H = lse_q - a_qq/s_q,
//   p(tok) = exp(tl[tok] - lse_p),  q(tok) = exp(dl[tok] - lse_q).
// tl[tok] and dl[tok] are read by that thread at the start, so their
// latency hides under the stream.  A token outside [0, V) has probability 0.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kUnroll = 2;         // vectors of each row in flight a thread
constexpr int kMaxChunks = 8;      // the portable cluster size

struct Lse {
  float m, s, a;
};

// fold element x (with weight term w) into an online-logsumexp state
__device__ __forceinline__ void push(Lse& st, float x, float w) {
  if (x > st.m) {
    const float e = expf(st.m - x);
    st.s = st.s * e + 1.f;
    st.a = st.a * e + w;
    st.m = x;
  } else {
    const float e = expf(x - st.m);
    st.s += e;
    st.a += e * w;
  }
}

__device__ __forceinline__ void push2(Lse& p, Lse& q, float x, float y) {
  push(p, x, x - y);
  push(q, y, y);
}

// fold the first n of x[] (weights w[]) into a state: one max, one
// rescale, then independent exponentials
template <int N>
__device__ __forceinline__ void fold(Lse& st, const float (&x)[N],
                                     const float (&w)[N], int n) {
  if (n <= 0) return;
  float m = st.m;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < n) m = fmaxf(m, x[i]);
  const float r = expf(st.m - m);
  float s = 0.f, a = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i < n) {
      const float e = expf(x[i] - m);
      s += e;
      a += e * w[i];
    }
  }
  st = {m, st.s * r + s, st.a * r + a};
}

__device__ __forceinline__ Lse merge(Lse x, Lse y) {
  const float m = fmaxf(x.m, y.m);
  const float ex = expf(x.m - m), ey = expf(y.m - m);
  return {m, x.s * ex + y.s * ey, x.a * ex + y.a * ey};
}

__device__ __forceinline__ Lse shfl(Lse x, int o) {
  return {__shfl_xor_sync(0xffffffffu, x.m, o),
          __shfl_xor_sync(0xffffffffu, x.s, o),
          __shfl_xor_sync(0xffffffffu, x.a, o)};
}

__global__ void __launch_bounds__(kThreads)
kld_accept_kernel(const float* __restrict__ tl, const float* __restrict__ dl,
                  const int* __restrict__ tokens, float* __restrict__ kld,
                  float* __restrict__ ent, float* __restrict__ p_tok,
                  float* __restrict__ q_tok, int n_t, int v,
                  long long tl_sb, long long tl_st, long long dl_sb,
                  long long dl_st, int chunks) {
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();       // this block's chunk
  const int row = blockIdx.x / chunks;
  const int b = row / n_t, t = row % n_t;
  const int tid = threadIdx.x;
  const float* x = tl + b * tl_sb + t * tl_st;
  const float* y = dl + b * dl_sb + t * dl_st;

  const bool fin = c == 0 && tid == 0;           // the thread that finalises
  const int tok = fin ? tokens[row] : -1;
  const bool in = tok >= 0 && tok < v;
  const float x_tok = in ? x[tok] : 0.f, y_tok = in ? y[tok] : 0.f;

  // units: float4s where both rows sit alike modulo 16 bytes, else floats
  const int px = (int)((reinterpret_cast<uintptr_t>(x) >> 2) & 3);
  const int py = (int)((reinterpret_cast<uintptr_t>(y) >> 2) & 3);
  const bool vec = px == py;
  const int head = vec ? min((4 - px) & 3, v) : 0;
  const int n = vec ? (v - head) >> 2 : v;
  const int per = (n + chunks - 1) / chunks;
  const int u0 = min(c * per, n), u1 = min(u0 + per, n);

  Lse p = {kNegInf, 0.f, 0.f}, q = {kNegInf, 0.f, 0.f};
  if (c == 0 && tid < head) push2(p, q, x[tid], y[tid]);
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(x + head);
    const float4* y4 = reinterpret_cast<const float4*>(y + head);
    for (int u = u0 + tid; u < u1; u += kThreads * kUnroll) {
      float xs[4 * kUnroll], ys[4 * kUnroll], ws[4 * kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (u + k * kThreads < u1) {
          const float4 xv = __ldg(x4 + u + k * kThreads);
          const float4 yv = __ldg(y4 + u + k * kThreads);
          xs[4 * k] = xv.x, xs[4 * k + 1] = xv.y, xs[4 * k + 2] = xv.z, xs[4 * k + 3] = xv.w;
          ys[4 * k] = yv.x, ys[4 * k + 1] = yv.y, ys[4 * k + 2] = yv.z, ys[4 * k + 3] = yv.w;
        }
      }
      const int n_in = 4 * min(kUnroll, (u1 - u + kThreads - 1) / kThreads);
#pragma unroll
      for (int i = 0; i < 4 * kUnroll; ++i) ws[i] = xs[i] - ys[i];
      fold(p, xs, ws, n_in);
      fold(q, ys, ys, n_in);
    }
    const int tail = v - head - 4 * n;
    if (c == chunks - 1 && tid < tail)
      push2(p, q, x[head + 4 * n + tid], y[head + 4 * n + tid]);
  } else {
    for (int u = u0 + tid; u < u1; u += kThreads * kUnroll) {
      float xs[kUnroll], ys[kUnroll], ws[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (u + k * kThreads < u1) {
          xs[k] = __ldg(x + u + k * kThreads);
          ys[k] = __ldg(y + u + k * kThreads);
        }
      }
      const int n_in = min(kUnroll, (u1 - u + kThreads - 1) / kThreads);
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) ws[k] = xs[k] - ys[k];
      fold(p, xs, ws, n_in);
      fold(q, ys, ys, n_in);
    }
  }

  for (int o = 16; o > 0; o >>= 1) {
    p = merge(p, shfl(p, o));
    q = merge(q, shfl(q, o));
  }
  __shared__ Lse sp[kThreads / 32], sq[kThreads / 32];
  __shared__ Lse part[2];                        // this block's (p, q)
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) {
    sp[warp] = p;
    sq[warp] = q;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kThreads / 32; ++w) {
      p = merge(p, sp[w]);
      q = merge(q, sq[w]);
    }
    part[0] = p;
    part[1] = q;
  }
  cluster.sync();                                // every block's part written
  if (fin) {
    Lse op[kMaxChunks], oq[kMaxChunks];          // all remote reads first
#pragma unroll
    for (int r = 1; r < kMaxChunks; ++r) {
      if (r < chunks) {
        const Lse* o = cluster.map_shared_rank(&part[0], r);
        op[r] = o[0];
        oq[r] = o[1];
      }
    }
#pragma unroll
    for (int r = 1; r < kMaxChunks; ++r) {
      if (r < chunks) {
        p = merge(p, op[r]);
        q = merge(q, oq[r]);
      }
    }
    const float s_p = fmaxf(p.s, 1e-30f), s_q = fmaxf(q.s, 1e-30f);
    const float lse_p = p.m + logf(s_p), lse_q = q.m + logf(s_q);
    kld[row] = fmaxf(p.a / s_p - lse_p + lse_q, 0.f);
    ent[row] = lse_q - q.a / s_q;
    p_tok[row] = in ? expf(x_tok - lse_p) : 0.f;
    q_tok[row] = in ? expf(y_tok - lse_q) : 0.f;
  }
  cluster.sync();                                // no block leaves while read
}

}  // namespace

// Logits are fp32 with a unit stride along the vocabulary; row (b, t)
// starts at b * s_b + t * s_t (element strides).  tokens and the four
// outputs are contiguous [rows].  chunks (1-8) blocks a row, one cluster.
// Returns the launch's error, else cudaGetLastError() after it.
extern "C" int kld_accept(const float* tl, const float* dl, const int* tokens,
                          float* kld, float* ent, float* p_tok, float* q_tok,
                          int n_b, int n_t, int v, long long tl_sb,
                          long long tl_st, long long dl_sb, long long dl_st,
                          int chunks, void* stream) {
  const long long blocks = (long long)chunks * n_b * n_t;
  if (chunks < 1 || chunks > kMaxChunks || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = chunks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kld_accept_kernel, tl, dl,
                                           tokens, kld, ent, p_tok, q_tok,
                                           n_t, v, tl_sb, tl_st, dl_sb,
                                           dl_st, chunks);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
