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
// The drafter's entry (`ngram_match_history`) takes the history buffer, its
// committed length and the pending token instead, and computes the same
// function of row' = row with row'[length] = pending (no write where length
// is outside [0, L)) and c = min(length + 1, L), as the reference drafter's
// `buf.at[bi, ln].set(pending, mode="drop")` and `min(ln + 1, h)` do.  The
// buffer is never written: the comparisons read positions below c - 1 =
// length only, so the pending token enters where the kernel reads position
// `length` (the suffix's last value and the continuation), by a select.
//
// Bound: the function needs each row's first ctx tokens once, about
// sum_b min(ctx_b, L) * 4 bytes (16 KB at B 4, L 4096: 5 ns at 3.35 TB/s),
// and n compares per start.  So the time is latency: the first version
// (one block a row, n dependent global loads per start, 256 starts per
// thread-iteration) made about four dependent trips to memory and 16
// serial iterations a thread at L 4096.
//
// Design:
// * The row is cut into C <= 8 chunks (the portable cluster size; C from L
//   alone, one chunk per 512 tokens), one CTA each, the C CTAs of a row one
//   thread-block cluster.  A CTA stages its chunk plus an (n-1)-token halo
//   (rounded up to 4) into shared memory in one trip, issued before
//   ctx_len is read: a TMA 1-D bulk copy (cp.async.bulk, completed on an
//   mbarrier) when the row starts on 16 bytes and L is a multiple of 4,
//   else 16-byte vector loads (scalars at the unaligned ends).
// * Each thread reads the n suffix values once into registers: from shared
//   memory where they lie in its CTA's staged range, else from global
//   memory, issued while the stage is in flight.  It walks its starts from
//   the highest down and stops at its first match; the CTA takes the max
//   with warp shuffles, and every warp takes the cluster's max over the C
//   CTAs' values through distributed shared memory.  An integer max does
//   not depend on order: the result is exact.  A row of one CTA (L <= 512,
//   the serves' rows) launches without a cluster and skips its barriers.
// * A row longer than C chunks of 8192 tokens (32 KB) has more chunks than
//   CTAs: CTA r owns chunks r, r + C, ..., stages its highest first, and
//   walks down (skipping chunks past the last start) until a chunk holds a
//   match.
// * The continuation comes from the staged row: each CTA writes the
//   tokens that lie in its own chunk (rank 0 the zeros and the count); a
//   row of several chunks per CTA reads it from global memory (L2).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunks = 8;      // the portable cluster size
constexpr int kMinChunk = 512;     // tokens a CTA takes at least
constexpr int kCap = 8192;         // tokens a CTA stages at a time (32 KB)
constexpr int kMaxN = 16;          // suffix values a thread holds
constexpr int kBatch = 8;          // 16-byte loads in flight a thread

__device__ __forceinline__ int warp_max(int x) {
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one thread: arm the barrier for `bytes` and start their bulk copy
__device__ __forceinline__ void bulk_load(int* dst, const int* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// tokens [g0, e) of the row into tok[0, e - g0) with 16-byte loads, kBatch
// in flight a thread; the caller synchronises the block before reading
__device__ __forceinline__ void vector_stage(int* tok, const int* src, int cnt,
                                             int tid) {
  const int head =
      min((int)(((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15) >> 2), cnt);
  const int nvec = (cnt - head) >> 2;
  const int4* src4 = reinterpret_cast<const int4*>(src + head);
  for (int base = 0; base < nvec; base += kThreads * kBatch) {
    int4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kThreads + tid;
      if (i < nvec) v[u] = __ldg(src4 + i);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kThreads + tid;
      if (i < nvec) {
        int* d = tok + head + 4 * i;
        d[0] = v[u].x, d[1] = v[u].y, d[2] = v[u].z, d[3] = v[u].w;
      }
    }
  }
  const int tail = head + 4 * nvec;
  if (tid < head) tok[tid] = __ldg(src + tid);
  if (tid < cnt - tail) tok[tail + tid] = __ldg(src + tail + tid);
}

// kHistory: `ctx` is the committed length and `pending` the token at it;
// else `ctx` is ctx_len and `pending` unused.  per: tokens of a chunk (a
// multiple of 4), halo: n - 1 rounded up to 4, chunks: CTAs a row.
template <bool kHistory>
__global__ void __launch_bounds__(kThreads)
ngram_match_kernel(const int* __restrict__ tokens, const int* __restrict__ ctx,
                   const int* __restrict__ pending, int* __restrict__ out,
                   int* __restrict__ count, int l, int n, int k, int chunks,
                   int per, int halo) {
  extern __shared__ __align__(16) int tok[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ int warp_best[kThreads / 32];
  __shared__ int part;                            // this CTA's best start
  cg::cluster_group cluster = cg::this_cluster();
  const int r = chunks > 1 ? (int)cluster.block_rank() : 0;
  const int b = blockIdx.x / chunks;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* row = tokens + (size_t)b * l;
  const int nc = (l + per - 1) / per;             // chunks of the row
  const bool single = nc <= chunks;               // one chunk a CTA at most
  const bool bulk =
      (reinterpret_cast<uintptr_t>(row) & 15) == 0 && (l & 3) == 0;

  // this CTA's chunks are r, r + chunks, ...: stage the highest first
  int q = r < nc ? r + (nc - 1 - r) / chunks * chunks : -1;
  const int q0 = q;
  auto stage = [&](int qi) {
    const int g0 = qi * per, e = min(g0 + per + halo, l);
    if (bulk) {
      if (tid == 0) bulk_load(tok, row + g0, (uint32_t)(e - g0) * 4u, &bar);
    } else {
      vector_stage(tok, row + g0, e - g0, tid);
    }
  };
  if (bulk && tid == 0) bar_init(&bar);
  if (bulk) __syncthreads();                      // the barrier is set up
  if (q >= 0) stage(q);

  // the context, read while the stage is in flight
  int c, len = 0, pend = 0;
  if (kHistory) {
    len = ctx[b];
    pend = pending[b];
    c = len < l ? len + 1 : l;                    // min(length + 1, L)
  } else {
    c = ctx[b];
  }
  auto value = [&](int p, int staged) {           // row'[p] from a staged p
    return kHistory && p == len ? pend : staged;
  };
  const int last = c >= n + 1 ? min(l - 1, c - 1 - n) : -1;  // largest start

  // suffix values: from global memory now where the first stage does not
  // hold them, from shared memory once it has landed
  const int f0 = q >= 0 ? q * per : 0;
  const int f1 = q >= 0 ? min(f0 + per + halo, l) : 0;
  int s[kMaxN];
#pragma unroll
  for (int j = 0; j < kMaxN; ++j) {
    s[j] = 0;
    const int p = c - n + j;
    if (j < n && p >= 0 && p < l && (p < f0 || p >= f1))
      s[j] = value(p, __ldg(row + p));
  }

  uint32_t phase = 0;
  int bb = -1;                                    // the CTA's best start
  bool first = true;
  while (q >= 0) {
    if (bulk) bar_wait(&bar, phase);
    else __syncthreads();
    const int lo = q * per;
    if (first) {
#pragma unroll
      for (int j = 0; j < kMaxN; ++j) {
        const int p = c - n + j;
        if (j < n && p >= f0 && p < f1) s[j] = value(p, tok[p - f0]);
      }
      first = false;
    }
    // this thread's starts from the highest down: the first hit is its max
    int best = -1;
    const int top = min(min(lo + per, l) - 1, last);
    for (int i = top - tid; i >= lo; i -= kThreads) {
      bool hit = true;
#pragma unroll
      for (int j = 0; j < kMaxN; ++j) {
        if (j < n) {
          const int p = i + j;
          hit &= (p < l ? tok[p - lo] : -1) == s[j];
        }
      }
      if (hit) {
        best = i;
        break;
      }
    }
    best = warp_max(best);
    if (lane == 0) warp_best[warp] = best;
    __syncthreads();
    bb = warp_best[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) bb = max(bb, warp_best[w]);
    if (bb >= 0) break;
    int nq = q - chunks;                          // next chunk with a start
    while (nq >= 0 && nq * per > last) nq -= chunks;
    if (nq < 0) break;
    __syncthreads();                              // tok and warp_best read
    if (bulk && tid == 0)                         // generic reads before the
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // copy
    q = nq;
    stage(q);
    phase ^= 1u;
  }

  int best = bb;
  if (chunks > 1) {
    if (tid == 0) part = bb;
    cluster_arrive();
    cluster_wait();                               // every CTA's part written
    int x = -1;
    if (lane < chunks) x = *cluster.map_shared_rank(&part, lane);
    best = warp_max(x);                           // the cluster's max
    cluster_arrive();                             // done with the peers
  }

  const int cnt = best >= 0 ? min(k, c - (best + n)) : 0;
  const int lo0 = q0 * per, hi0 = min(lo0 + per, l);
  for (int m = tid; m < k; m += kThreads) {
    const int p = best + n + m;
    const bool real = m < cnt && p >= 0 && p < l;
    if (single) {
      if (real && q0 >= 0 && p >= lo0 && p < hi0)
        out[(size_t)b * k + m] = value(p, tok[p - lo0]);
      else if (!real && r == 0)
        out[(size_t)b * k + m] = 0;
    } else if (r == 0) {
      out[(size_t)b * k + m] = real ? value(p, __ldg(row + p)) : 0;
    }
  }
  if (r == 0 && tid == 0) count[b] = cnt;
  if (chunks > 1) cluster_wait();                 // no CTA leaves while read
}

int launch(const int* tokens, const int* ctx, const int* pending, int* out,
           int* count, int n_b, int l, int n, int k, void* stream) {
  if (n < 1 || n > kMaxN || k < 1 || n_b < 1 || l < 1)
    return (int)cudaErrorInvalidValue;
  const int chunks = min(kMaxChunks, max(1, (l + kMinChunk - 1) / kMinChunk));
  const int per = min(kCap, (((l + chunks - 1) / chunks) + 3) & ~3);
  const int halo = (n - 1 + 3) & ~3;
  const long long blocks = (long long)chunks * n_b;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)(per + halo) * sizeof(int);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = chunks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = chunks > 1 ? 1 : 0;              // a row of one CTA: no cluster
  const cudaError_t e =
      pending != nullptr
          ? cudaLaunchKernelEx(&cfg, ngram_match_kernel<true>, tokens, ctx,
                               pending, out, count, l, n, k, chunks, per, halo)
          : cudaLaunchKernelEx(&cfg, ngram_match_kernel<false>, tokens, ctx,
                               pending, out, count, l, n, k, chunks, per, halo);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// tokens [B, L] int32, ctx_len [B] int32 -> out [B, K] int32, count [B]
// int32.  Requires 1 <= n <= 16 and k >= 1.  Returns the launch's error,
// else cudaGetLastError() after it.
extern "C" int ngram_match(const int* tokens, const int* ctx_len, int* out,
                           int* count, int n_b, int l, int n, int k,
                           void* stream) {
  return launch(tokens, ctx_len, nullptr, out, count, n_b, l, n, k, stream);
}

// The drafter's entry: buf [B, L] int32 (never written), length [B] int32,
// pending [B] int32 -> the function of the buffer with pending at length
// (see the header), out [B, K] and count [B] as above.
extern "C" int ngram_match_history(const int* buf, const int* length,
                                   const int* pending, int* out, int* count,
                                   int n_b, int l, int n, int k, void* stream) {
  return launch(buf, length, pending, out, count, n_b, l, n, k, stream);
}
