// Fused KLD / acceptance signals for Hopper (sm_90a): one streaming pass
// over the vocabulary per (b, t) row.
//
// Replaces the TPU kernel `fused_kld_accept` (src/repro/kernels/
// kld_accept.py, body `_kernel`).  Same function: for target logits tl
// and draft logits dl of one row and the proposed token tok,
//   KL(p || q) floored at 0, H(q), p(tok) and q(tok),
// with p = softmax(tl), q = softmax(dl), all in fp32.
//
// Layout: one thread block per row.  Each thread walks the row with a
// stride of the block size and keeps the online-logsumexp state of both
// distributions -- target (m_p, s_p, a_pd = sum e^{tl-m_p} (tl-dl)) and
// draft (m_q, s_q, a_qq = sum e^{dl-m_q} dl) -- which is then merged
// across the warp with shuffles and across warps through shared memory.
// Thread 0 finalises as the TPU kernel does:
//   lse = m + log s,  KL = a_pd/s_p - lse_p + lse_q,  H = lse_q - a_qq/s_q,
//   p(tok) = exp(tl[tok] - lse_p),  q(tok) = exp(dl[tok] - lse_q).
// A token outside [0, V) has probability 0.
//
// Bound: the kernel reads both logit rows once, 2 * rows * V * 4 bytes,
// and does a few operations per element, so it is bound by device memory.
// One block per row leaves most SMs idle at 40 rows; splitting a row over
// several blocks with a second merge pass is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 512;

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
                  long long dl_st) {
  const int row = blockIdx.x;
  const int b = row / n_t, t = row % n_t;
  const float* x = tl + b * tl_sb + t * tl_st;
  const float* y = dl + b * dl_sb + t * dl_st;

  Lse p = {kNegInf, 0.f, 0.f}, q = {kNegInf, 0.f, 0.f};
  for (int i = threadIdx.x; i < v; i += kThreads) {
    const float a = x[i], c = y[i];
    push(p, a, a - c);
    push(q, c, c);
  }
  for (int o = 16; o > 0; o >>= 1) {
    p = merge(p, shfl(p, o));
    q = merge(q, shfl(q, o));
  }
  __shared__ Lse sp[kThreads / 32], sq[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sp[warp] = p;
    sq[warp] = q;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < kThreads / 32; ++w) {
    p = merge(p, sp[w]);
    q = merge(q, sq[w]);
  }
  const float s_p = fmaxf(p.s, 1e-30f), s_q = fmaxf(q.s, 1e-30f);
  const float lse_p = p.m + logf(s_p), lse_q = q.m + logf(s_q);
  kld[row] = fmaxf(p.a / s_p - lse_p + lse_q, 0.f);
  ent[row] = lse_q - q.a / s_q;
  const int tok = tokens[row];
  const bool in = tok >= 0 && tok < v;
  p_tok[row] = in ? expf(x[tok] - lse_p) : 0.f;
  q_tok[row] = in ? expf(y[tok] - lse_q) : 0.f;
}

}  // namespace

// Logits are fp32 with a unit stride along the vocabulary; row (b, t)
// starts at b * s_b + t * s_t (element strides).  tokens and the four
// outputs are contiguous [rows].  Returns cudaGetLastError() after launch.
extern "C" int kld_accept(const float* tl, const float* dl, const int* tokens,
                          float* kld, float* ent, float* p_tok, float* q_tok,
                          int n_b, int n_t, int v, long long tl_sb,
                          long long tl_st, long long dl_sb, long long dl_st,
                          void* stream) {
  kld_accept_kernel<<<n_b * n_t, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tl, dl, tokens, kld, ent, p_tok, q_tok, n_t, v, tl_sb, tl_st, dl_sb, dl_st);
  return (int)cudaGetLastError();
}
