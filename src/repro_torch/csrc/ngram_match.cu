// Prompt-lookup suffix match for the n-gram drafter, for Hopper (sm_90a).
//
// Replaces the TPU kernel `ngram_suffix_propose`
// (src/repro/kernels/ngram_match.py, body `_kernel`).  Same function, bit for
// bit: per row of tokens [B, L] int32 with ctx c = ctx_len[b], the suffix
// values are s_j = row[c - n + j] (0 where that index is outside [0, L)); a
// start i matches iff row[i + j] == s_j for j < n (row read as -1 past L),
// i + n <= c - 1 (at least one known continuation, which also excludes the
// trivial occurrence at c - n) and c >= n + 1.  best = the largest matching
// i, or -1; cnt = best >= 0 ? min(k, c - (best + n)) : 0; out[m] =
// row[best + n + m] (0 outside [0, L)) for m < cnt, else 0.
//
// Layout: one thread block per row.  The block reads the n suffix values,
// then its threads stride over i in [0, L) and AND the n shifted
// equalities; each keeps its largest matching i, and a block-wide max
// (warp shuffles, then one value per warp in shared memory) picks the most
// recent match.  Threads m < k then write the continuation and thread 0
// the count.  Integer-only, so it is exact.
//
// Bound: the function needs each row's first ctx tokens once, about
// sum_b min(ctx_b, L) * 4 bytes, and does n compares per start: bytes
// dominate.  Reading the row once per shift j (n reads, served from L1/L2)
// and one block per row are this first version's simplifications; staging
// the row in shared memory and several rows per block are later work.

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int warp_max(int x) {
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__global__ void __launch_bounds__(kThreads)
ngram_match_kernel(const int* __restrict__ tokens, const int* __restrict__ ctx_len,
                   int* __restrict__ out, int* __restrict__ count, int l, int n,
                   int k) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int* row = tokens + (size_t)b * l;
  const int c = ctx_len[b];
  __shared__ int warp_best[kThreads / 32];

  int best = -1;
  if (c >= n + 1) {
    // i + n <= c - 1 bounds the starts; L bounds the array
    const int last = min(l - 1, c - 1 - n);
    for (int i = tid; i <= last; i += kThreads) {
      bool match = true;
      for (int j = 0; j < n && match; ++j) {
        const int sp = c - n + j;
        const int sj = (sp >= 0 && sp < l) ? row[sp] : 0;
        const int v = (i + j < l) ? row[i + j] : -1;
        match = v == sj;
      }
      if (match) best = i;               // i grows: the last hit is the largest
    }
  }
  best = warp_max(best);
  if ((tid & 31) == 0) warp_best[tid >> 5] = best;
  __syncthreads();
  if (tid < 32) {
    int x = tid < kThreads / 32 ? warp_best[tid] : -1;
    x = warp_max(x);
    if (tid == 0) warp_best[0] = x;
  }
  __syncthreads();
  best = warp_best[0];
  const int cnt = best >= 0 ? min(k, c - (best + n)) : 0;
  for (int m = tid; m < k; m += kThreads) {
    const int p = best + n + m;
    out[(size_t)b * k + m] = (m < cnt && p >= 0 && p < l) ? row[p] : 0;
  }
  if (tid == 0) count[b] = cnt;
}

}  // namespace

// tokens [B, L] int32, ctx_len [B] int32 -> out [B, K] int32, count [B]
// int32.  Requires n >= 1 and k >= 1.  Returns cudaGetLastError() after the
// launch.
extern "C" int ngram_match(const int* tokens, const int* ctx_len, int* out,
                           int* count, int n_b, int l, int n, int k,
                           void* stream) {
  if (n < 1 || k < 1 || n_b < 1 || l < 1) return (int)cudaErrorInvalidValue;
  ngram_match_kernel<<<n_b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tokens, ctx_len, out, count, l, n, k);
  return (int)cudaGetLastError();
}
