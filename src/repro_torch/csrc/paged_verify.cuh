// Decode / verify attention for Hopper (sm_90a) read straight off the KV
// cache: the kernel body shared by paged_attention.cu (B1: fp32 / bf16
// block pools), paged_attention_quant.cu (B4: int8 block pools with one
// fp32 scale per stored vector) and ragged_attention.cu (B5: the dense
// fp32 / bf16 ring).  They differ in the storage type and in the
// addressing policy (`TableAddr` for the pools, `RingAddr` for the ring),
// which is the kernel's first template parameter, so a profile tells the
// pools' kernel from the ring's by name.
//
// Function: GQA attention of q [B,T,H,D] over sequence b's cache slots (a
// pool: the slots of its blocks, table [B,MAXB], -1 = unallocated; the
// ring: the W slots of row b of k/v [B,W,KV,D]); a slot is valid for
// query position qp iff 0 <= kv_pos[slot] <= qp (and qp - kv_pos < window
// when a window is set); scale 1/sqrt(D); out = acc / max(l, 1e-30), so a
// row with no valid slot is 0.
//
// Design.
// * Units.  A row's cache is MAXB units of BS slots: a pool's table
//   entries (BS its block size), or the ring's 16-slot chunks (BS 16,
//   MAXB = ceil(W/16); chunk j of row b is ring slots [16j, 16j + 16) at
//   flat slot b*W + 16j, and the slots of a last chunk past W are staged
//   empty -- position -1, zero K/V, no copy -- so the ring is never padded
//   or copied).
// * Split-KV (flash-decoding).  Grid (B, KV, S): split s of row b covers
//   its units [s*per, min((s+1)*per, MAXB)), per = ceil(MAXB/S).  The host
//   picks S from the shapes and the card's SM count alone
//   (kernels/paged_attention.py, `split_plan`, for both policies).  With
//   S > 1 every split writes its partial (m, l, acc) in fp32 to scratch
//   that the wrapper keeps, and `merge_kernel` combines the splits in the
//   fixed order s = 0, 1, ...: no atomics, so one input gives the same
//   bits on every call, and a row with no valid slot in any split (L = 0,
//   acc = 0) comes out exactly 0.  With S = 1 the split kernel writes the
//   output itself and nothing is merged.
// * Staging.  A stage is kTile = 64 slots; each of the 4 warps takes 16
//   of them.  The stage's K and V rows are copied with 16-byte cp.async
//   into a 2-stage ring in shared memory, kv_pos and the int8 scales with
//   4-byte cp.async, once per slot; the next stage loads while this one
//   computes.  cp.async needs 16-byte aligned sources: a K/V row is
//   D * sizeof(storage) bytes, a multiple of 16 for every D the wrappers
//   take (32, 64, 128) in int8, bf16 and fp32, and the tensors are
//   contiguous from an aligned base.  A slot staged empty (position -1,
//   zero K/V, no copy) adds nothing: its probability is 0.
//   - TableAddr: a stage is 64 / BS consecutive table entries; the entries
//     are read one stage further ahead, and an entry of -1 stages empty.
//   - RingAddr, kv_pos first: before it stages any K/V, a split reads the
//     positions of its slots (4 bytes a slot against 2 * D * sizeof(dtype)
//     of K/V) and keeps only its live chunks: those holding a slot with
//     0 <= kv_pos <= max q_pos and, with a window, kv_pos > min q_pos -
//     window (the call's query positions).  A dead chunk is neither
//     copied nor multiplied; a split with no live chunk writes the empty
//     partial (m = -1e30, l = 0, acc = 0).  Chunk c of a split belongs to
//     warp c % 4, always: each warp compacts its own live chunks into a
//     list in shared memory, in order, and stage i holds the i-th live
//     chunk of every warp (a warp whose list is shorter stages nothing).
//     So each warp folds the same chunks in the same order as without the
//     skip -- a dead chunk would only have multiplied by probabilities of
//     0 -- and the result has the same bits.  The stage ring stays full:
//     a row's live slots are one run of the ring (two where it wraps), so
//     the warps' lists differ in length by at most one or two, and the
//     sweep runs max over warps of the list lengths stages.  A split's
//     chunks are scanned 128 at a time (32 a warp, one bit a lane), the
//     first scan's loads issued with q's in the prologue.
//   - Both: a warp whose 16 staged slots hold none valid for any query
//     row of the call skips its products (the same bits as computing
//     them: all its probabilities would be 0).
// * Tensor cores (mma.sync, FlashAttention-2 style).  The G*T query rows
//   of the KV head are M, padded to 16*MT (MT <= 4, MT*D <= 256); a warp's
//   16 slots are N of QK^T and K of PV.  Each warp keeps the online
//   softmax of its row fragments in registers; the 4 warps merge in a
//   fixed order at the end of the split.
//   - bf16 q (B1, B5 bf16; B4 with bf16 q): m16n8k16 bf16 -> fp32.  q, bf16
//     K/V and int8 K/V are exact in bf16, so QK^T is exact products summed
//     in fp32; P enters PV as hi + lo bf16 terms (two mmas), which leaves
//     it below 2^-16 relative error.
//   - fp32 q (B1, B5 fp32; B4 with fp32 q): 3xTF32 on m16n8k8.  Each operand
//     x = big + small, both rounded to TF32 (cvt.rna), and
//     a*b ~ big_a*big_b + big_a*small_b + small_a*big_b: the dropped
//     small*small term and the roundings leave about 2^-21 relative error
//     a product, against 2^-11 for single-pass TF32, which would miss the
//     fp32 tolerance (atol 2e-5 / rtol 1e-4) and is not used.  int8 K/V
//     are exact in TF32 and take one term.
//   - int8 (B4): K enters the product unscaled and the slot's k_scale
//     multiplies its score; v_scale multiplies the slot's probability
//     before PV.  This moves one fp32 rounding against the reference's
//     "dequantize, then dot" order: relative 2^-24 per term, far inside
//     both tolerances.
//   A thread of an mma holds the adjacent pair (2t, 2t+1) of every 8
//   values along the depth; for TF32 the pair stands in for the PTX
//   layout's (t, t+4), a permutation of the summed index applied to both
//   operands alike, so fragments load as 8-byte words and the softmax
//   probabilities feed PV straight from the QK^T accumulators.
//
// Shared memory (bytes, `Layout::kBytes`): the stage ring (or, after the
// sweep, the warps' merge buffers, whichever is larger), q in operand form,
// the rows' positions, two stages of table entries (the ring: the warps'
// live-chunk lists) and the lists' lengths; rows are padded (16-32 bytes)
// so the fragment loads of a warp hit distinct banks.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace pv {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16 * kWarps;       // slots per stage (STAGE_SLOTS in Python)
constexpr int kStages = 2;
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  const void* pk;
  const void* pv;
  const float* k_scale;                  // int8 pools only
  const float* v_scale;
  const int* table;
  const int* q_pos;
  const int* kv_pos;
  void* out;
  float* part;                           // S > 1: [B,KV,S,rows,D] acc, then m, l
  int n_b, n_t, n_h, n_kv, bs_log2, maxb, window, splits;
  float scale;
  int ring_w;                            // RingAddr: W slots a row
};

// Addressing policies (see the header): a pool read through its block
// table, or the dense ring read in 16-slot chunks after its positions.
struct TableAddr {
  static constexpr bool kRing = false;
};
struct RingAddr {
  static constexpr bool kRing = true;
  static constexpr int kChunk = 16;              // slots a unit (a warp's share)
  static constexpr int kScan = 32 * kWarps;      // chunks a scan: a bit a lane
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x -> (big, small), both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}
// (x0, x1) -> bf16x2 with x0 in the low half (the lower depth index)
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 x0, __nv_bfloat16 x1) {
  __nv_bfloat162 v = __halves2bfloat162(x0, x1);
  return *reinterpret_cast<uint32_t*>(&v);
}
// (x0, x1) -> hi + lo, each a bf16x2
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Compile-time shape of one instantiation: q type Q, pool storage KT,
// head dim D, MT row tiles of 16.
template <class Q, class KT, int D, int MT>
struct Layout {
  static constexpr bool kTf32 = std::is_same<Q, float>::value;
  static constexpr bool kInt8 = std::is_same<KT, int8_t>::value;
  static constexpr int kKK = kTf32 ? 8 : 16;            // depth of one mma
  static constexpr int kQTerms = kTf32 ? 2 : 1;
  static constexpr int kKvTerms = (kTf32 && !kInt8) ? 2 : 1;
  static constexpr int kMPad = 16 * MT;
  static constexpr int kKRow = D * (int)sizeof(KT) + (sizeof(KT) == 4 ? 32 : 16);
  static constexpr int kVRow = D * (int)sizeof(KT) + 16;
  static constexpr int kStage = kTile * (kKRow + kVRow) + 3 * kTile * 4;
  static constexpr int kRed = kWarps * kMPad * (D + 2) * 4;
  static constexpr int kRing = kStages * kStage > kRed ? kStages * kStage : kRed;
  static constexpr int kQRow = kTf32 ? (D + 8) * 4 : (D + 8) * 2;   // bytes
  static constexpr int kQ = kQTerms * kMPad * kQRow;
  static constexpr int kBytes = kRing + kQ + kMPad * 4 + kStages * kTile * 4
                                + kWarps * 4;
  static_assert(D % 16 == 0 && MT * D <= 256, "unsupported head dim / rows");
};

// The B fragment of QK^T for the 8 slots whose row `row` (slot g of the
// n-tile) this thread reads, depth step kk: kv terms x 2 registers.
template <class L, class KT>
__device__ __forceinline__ void k_frag(const unsigned char* row, int kk, int t4,
                                       uint32_t (&b)[L::kKvTerms][2]) {
  const KT* r = reinterpret_cast<const KT*>(row);
  if constexpr (L::kTf32) {
    const int c = kk * 8 + 2 * t4;
    if constexpr (L::kInt8) {
      b[0][0] = __float_as_uint((float)r[c]);
      b[0][1] = __float_as_uint((float)r[c + 1]);
    } else {
      const float2 x = *reinterpret_cast<const float2*>(r + c);
      split_tf32(x.x, b[0][0], b[1][0]);
      split_tf32(x.y, b[0][1], b[1][1]);
    }
  } else {
    const int c = kk * 16 + 2 * t4;
    if constexpr (L::kInt8) {
      b[0][0] = pack_bf16((float)r[c], (float)r[c + 1]);
      b[0][1] = pack_bf16((float)r[c + 8], (float)r[c + 9]);
    } else {
      b[0][0] = *reinterpret_cast<const uint32_t*>(r + c);
      b[0][1] = *reinterpret_cast<const uint32_t*>(r + c + 8);
    }
  }
}

// The B fragment of PV: slots s0, s0 + 1 (TF32, one k-step of 8) or
// s0, s0 + 1, s0 + 8, s0 + 9 (bf16, one k-step of 16), head-dim lane c.
template <class L, class KT>
__device__ __forceinline__ void v_frag(const unsigned char* v_s, int s0, int c,
                                       uint32_t (&b)[L::kKvTerms][2]) {
  auto at = [&](int s) {
    return reinterpret_cast<const KT*>(v_s + s * L::kVRow)[c];
  };
  if constexpr (L::kTf32) {
    if constexpr (L::kInt8) {
      b[0][0] = __float_as_uint(to_f(at(s0)));
      b[0][1] = __float_as_uint(to_f(at(s0 + 1)));
    } else {
      split_tf32(at(s0), b[0][0], b[1][0]);
      split_tf32(at(s0 + 1), b[0][1], b[1][1]);
    }
  } else if constexpr (L::kInt8) {
    b[0][0] = pack_bf16(to_f(at(s0)), to_f(at(s0 + 1)));
    b[0][1] = pack_bf16(to_f(at(s0 + 8)), to_f(at(s0 + 9)));
  } else {
    b[0][0] = pack_raw(at(s0), at(s0 + 1));
    b[0][1] = pack_raw(at(s0 + 8), at(s0 + 9));
  }
}

// Products of a split pair: every (i, j) with i + j < max(terms), so 1 x 1
// is one mma, big/small x big/small is three and hi/lo x exact two.
template <bool kTf32, int NA, int NB>
__device__ __forceinline__ void mma_terms(float* c, const uint32_t (&a)[NA][4],
                                          const uint32_t (&b)[NB][2]) {
  constexpr int kMax = NA > NB ? NA : NB;
#pragma unroll
  for (int i = NA - 1; i >= 0; --i)
#pragma unroll
    for (int j = NB - 1; j >= 0; --j)
      if (i + j < kMax) {
        if constexpr (kTf32) mma_tf32(c, a[i], b[j]);
        else mma_bf16(c, a[i], b[j]);
      }
}

template <class Addr, class Q, class KT, int D, int MT>
__global__ void __launch_bounds__(kThreads)
verify_kernel(const Args a) {
  using L = Layout<Q, KT, D, MT>;
  constexpr bool kRing = Addr::kRing;
  constexpr int kNP = 2;                 // terms of a probability
  constexpr int kCh = D * (int)sizeof(KT) / 16;   // 16-byte chunks a row
  constexpr int kScanIt = RingAddr::kScan / kWarps / 2;   // loads a scan, a lane

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  unsigned char* q_op = smem + L::kRing;
  int* qp_s = reinterpret_cast<int*>(q_op + L::kQ);
  int* ent_s = qp_s + L::kMPad;          // table entries; the ring's chunk lists
  int* cnt_s = ent_s + kStages * kTile;  // the ring's list lengths

  const int b = blockIdx.x, kvh = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int grp = a.n_h / a.n_kv;
  const int rows = grp * a.n_t;
  const int bs = 1 << a.bs_log2;
  const int ept = kTile >> a.bs_log2;    // units a stage
  const int per = (a.maxb + a.splits - 1) / a.splits;
  const int e_begin = min(split * per, a.maxb);
  const int e_end = min(e_begin + per, a.maxb);
  const int* table = kRing ? nullptr : a.table + (size_t)b * a.maxb;
  const int* ring_pos = kRing ? a.kv_pos + (size_t)b * a.ring_w : nullptr;

  // RingAddr: the positions of this warp's chunks seg + warp + 4k, k < 32,
  // two chunks a load (half-warp h reads chunk k = 2j + h).
  auto scan_load = [&](int seg, int (&p)[kScanIt]) {
#pragma unroll
    for (int j = 0; j < kScanIt; ++j) {
      const int c = seg + warp + 4 * (2 * j + (lane >> 4));
      const int sl = c * RingAddr::kChunk + (lane & 15);
      p[j] = c < e_end && sl < a.ring_w ? ring_pos[sl] : -1;
    }
  };
  // ... and their live ones, in order, into the warp's list
  // ent_s[32 * warp ...], its length into cnt_s[warp]: lane k holds the
  // bit of chunk k, and the live chunks below it give its list index.
  auto scan_lists = [&](int seg, const int (&p)[kScanIt], int qp_min, int qp_max) {
    unsigned live = 0;
#pragma unroll
    for (int j = 0; j < kScanIt; ++j) {
      const bool ok = p[j] >= 0 && p[j] <= qp_max
                      && (a.window <= 0 || p[j] > qp_min - a.window);
      const unsigned m = __ballot_sync(0xffffffffu, ok);
      live |= ((m & 0xffffu) ? 1u : 0u) << (2 * j);
      live |= ((m >> 16) ? 1u : 0u) << (2 * j + 1);
    }
    if (live >> lane & 1u)
      ent_s[warp * 32 + __popc(live & ((1u << lane) - 1u))] = seg + warp + 4 * lane;
    if (lane == 0) cnt_s[warp] = __popc(live);
  };

  // The prologue's global reads (q, q_pos and the first two stages'
  // table entries, or the ring's first scan) are all issued before its
  // first shared store, so their latencies overlap: one round trip, not
  // one per row.
  // q rows in operand form; row r <-> (t = r / G, head kvh * G + r % G),
  // the reference's q.reshape(b, t, kv, g, d) grouping; padded rows are 0.
  constexpr int kQPer = L::kMPad * D / kThreads;   // q elements a thread
  const Q* q = static_cast<const Q*>(a.q);
  int ent0 = -1, ent1 = -1;
  int scan[kScanIt];
  if constexpr (kRing) {
    scan_load(e_begin, scan);
  } else {
    ent0 = tid < ept && e_begin + tid < e_end ? table[e_begin + tid] : -1;
    ent1 = tid < ept && e_begin + ept + tid < e_end ? table[e_begin + ept + tid] : -1;
  }
  const int qp_r = tid < rows && tid < L::kMPad ? a.q_pos[b * a.n_t + tid / grp] : -1;
  float xq[kQPer];
#pragma unroll
  for (int k = 0; k < kQPer; ++k) {
    const int r = (tid + k * kThreads) / D, c = (tid + k * kThreads) % D;
    xq[k] = r < rows
        ? to_f(q[((size_t)(b * a.n_t + r / grp) * a.n_h + kvh * grp + r % grp) * D + c])
        : 0.f;
  }
#pragma unroll
  for (int k = 0; k < kQPer; ++k) {
    const int r = (tid + k * kThreads) / D, c = (tid + k * kThreads) % D;
    if constexpr (L::kTf32) {
      uint32_t* qo = reinterpret_cast<uint32_t*>(q_op);
      constexpr int w = L::kQRow / 4;
      split_tf32(xq[k], qo[r * w + c], qo[(L::kMPad + r) * w + c]);
    } else {
      reinterpret_cast<__nv_bfloat16*>(q_op)[r * (L::kQRow / 2) + c] =
          __float2bfloat16_rn(xq[k]);
    }
  }
  if (tid < L::kMPad) qp_s[tid] = qp_r;
  if (!kRing && tid < ept) {
    ent_s[tid] = ent0;
    ent_s[kTile + tid] = ent1;
  }

  auto fill_entries = [&](int tile) {
    int* e = ent_s + (tile % kStages) * kTile;
    for (int i = tid; i < ept; i += kThreads) {
      const int idx = e_begin + tile * ept + i;
      e[i] = idx < e_end ? table[idx] : -1;
    }
  };
  auto stage = [&](int st) { return ring + st * L::kStage; };
  auto issue = [&](int tile) {
    const int st = tile % kStages;
    unsigned char* k_s = stage(st);
    unsigned char* v_s = k_s + kTile * L::kKRow;
    int* pos_s = reinterpret_cast<int*>(v_s + kTile * L::kVRow);
    float* ks_s = reinterpret_cast<float*>(pos_s + kTile);
    float* vs_s = ks_s + kTile;
    if constexpr (kRing) {
      // slot s of the stage: chunk `tile` of warp s / 16's list, or none
      auto slot_of = [&](int s) {
        const int w = s >> 4;
        return tile < cnt_s[w]
            ? ent_s[w * 32 + tile] * RingAddr::kChunk + (s & 15) : a.ring_w;
      };
      for (int i = tid; i < 2 * kTile * kCh; i += kThreads) {
        const int which = i / (kTile * kCh);        // 0: K, 1: V
        const int s = (i / kCh) % kTile, ch = i % kCh;
        const int sl = slot_of(s);
        unsigned char* dst = (which ? v_s + s * L::kVRow : k_s + s * L::kKRow) + ch * 16;
        if (sl >= a.ring_w) {
          *reinterpret_cast<int4*>(dst) = make_int4(0, 0, 0, 0);
          continue;
        }
        const size_t flat = ((size_t)b * a.ring_w + sl) * a.n_kv + kvh;
        const unsigned char* src = static_cast<const unsigned char*>(which ? a.pv : a.pk)
                                   + flat * (D * sizeof(KT)) + ch * 16;
        cp_async16(dst, src);
      }
      for (int s = tid; s < kTile; s += kThreads) {
        const int sl = slot_of(s);
        if (sl >= a.ring_w) {
          pos_s[s] = -1;
          ks_s[s] = 0.f;
          vs_s[s] = 0.f;
          continue;
        }
        cp_async4(pos_s + s, ring_pos + sl);
      }
      return;
    }
    const int* e = ent_s + st * kTile;
    for (int i = tid; i < 2 * kTile * kCh; i += kThreads) {
      const int which = i / (kTile * kCh);          // 0: K, 1: V
      const int s = (i / kCh) % kTile, ch = i % kCh;
      const int phys = e[s >> a.bs_log2];
      unsigned char* dst = (which ? v_s + s * L::kVRow : k_s + s * L::kKRow) + ch * 16;
      if (phys < 0) {
        *reinterpret_cast<int4*>(dst) = make_int4(0, 0, 0, 0);
        continue;
      }
      const size_t slot = ((size_t)phys * bs + (s & (bs - 1))) * a.n_kv + kvh;
      const unsigned char* src = static_cast<const unsigned char*>(which ? a.pv : a.pk)
                                 + slot * (D * sizeof(KT)) + ch * 16;
      cp_async16(dst, src);
    }
    for (int s = tid; s < kTile; s += kThreads) {
      const int phys = e[s >> a.bs_log2];
      if (phys < 0) {
        pos_s[s] = -1;
        ks_s[s] = 0.f;
        vs_s[s] = 0.f;
        continue;
      }
      const size_t flat = (size_t)phys * bs + (s & (bs - 1));
      cp_async4(pos_s + s, a.kv_pos + flat);
      if constexpr (L::kInt8) {
        cp_async4(ks_s + s, a.k_scale + flat * a.n_kv + kvh);
        cp_async4(vs_s + s, a.v_scale + flat * a.n_kv + kvh);
      }
    }
  };

  float acc[MT][D / 8][4];
  float m_r[MT][2], l_r[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][dn][e] = 0.f;
    m_r[mt][0] = m_r[mt][1] = kNegInf;
    l_r[mt][0] = l_r[mt][1] = 0.f;
  }

  const int sb = warp * 16;              // this warp's slots in a stage
  __syncthreads();                       // q_op, qp_s, the first entries
  // TableAddr: one sweep over the split's stages, its first stage issued
  // before anything else.  RingAddr: one sweep per scan of 128 chunks,
  // over the stages of the warps' live chunks, which need the call's
  // query positions first.
  auto ring_tiles = [&] {
    return max(max(cnt_s[0], cnt_s[1]), max(cnt_s[2], cnt_s[3]));
  };
  int n_tiles = kRing ? 0 : (e_end - e_begin + ept - 1) / ept;
  if (!kRing && n_tiles > 0) issue(0);
  int qp_min = 0x7fffffff, qp_max = -1;  // over the call's query positions
  for (int t = 0; t < a.n_t; ++t) {
    qp_min = min(qp_min, qp_s[t * grp]);
    qp_max = max(qp_max, qp_s[t * grp]);
  }
  if constexpr (kRing) {
    scan_lists(e_begin, scan, qp_min, qp_max);
    __syncthreads();
    n_tiles = ring_tiles();
    if (n_tiles > 0) issue(0);
  }
  cp_commit();

  for (int seg = e_begin;;) {
    for (int tile = 0; tile < n_tiles; ++tile) {
      __syncthreads();   // entries of tile + 1 visible; its stage no longer read
      if (tile + 1 < n_tiles) issue(tile + 1);
      cp_commit();
      // issue(tile) read this buffer before the barrier above
      if (!kRing && tile + 2 < n_tiles) fill_entries(tile + 2);
      cp_wait<1>();
      __syncthreads();                     // tile's stage landed for every thread

      const unsigned char* k_s = stage(tile % kStages);
      const unsigned char* v_s = k_s + kTile * L::kKRow;
      const int* pos_s = reinterpret_cast<const int*>(v_s + kTile * L::kVRow);
      const float* ks_s = reinterpret_cast<const float*>(pos_s + kTile);
      const float* vs_s = ks_s + kTile;

      bool need = false;
      if (lane < 16) {
        const int kp = pos_s[sb + lane];
        need = kp >= 0 && kp <= qp_max && (a.window <= 0 || kp > qp_min - a.window);
      }
      if (!__any_sync(0xffffffffu, need)) continue;   // warp-uniform

      // S = Q K^T over the warp's 16 slots (two n-tiles of 8)
      float s[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / L::kKK; ++kk) {
        uint32_t kb[2][L::kKvTerms][2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          k_frag<L, KT>(k_s + (sb + j * 8 + g) * L::kKRow, kk, t4, kb[j]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t qa[L::kQTerms][4];
          const int r0 = mt * 16 + g;
#pragma unroll
          for (int iq = 0; iq < L::kQTerms; ++iq) {
            if constexpr (L::kTf32) {
              constexpr int w = L::kQRow / 4;
              const uint32_t* qo = reinterpret_cast<const uint32_t*>(q_op)
                                   + iq * L::kMPad * w + kk * 8 + 2 * t4;
              const uint2 lo = *reinterpret_cast<const uint2*>(qo + r0 * w);
              const uint2 hi = *reinterpret_cast<const uint2*>(qo + (r0 + 8) * w);
              qa[iq][0] = lo.x; qa[iq][1] = hi.x; qa[iq][2] = lo.y; qa[iq][3] = hi.y;
            } else {
              constexpr int w = L::kQRow / 4;
              const uint32_t* qo = reinterpret_cast<const uint32_t*>(q_op) + kk * 8 + t4;
              qa[iq][0] = qo[r0 * w];
              qa[iq][1] = qo[(r0 + 8) * w];
              qa[iq][2] = qo[r0 * w + 4];
              qa[iq][3] = qo[(r0 + 8) * w + 4];
            }
          }
#pragma unroll
          for (int j = 0; j < 2; ++j)
            mma_terms<L::kTf32>(s[mt][j], qa, kb[j]);
        }
      }

      // masked online softmax; s becomes P (times v_scale for int8).  This
      // thread holds slots j*8 + 2*t4 + e of rows mt*16 + g + 8*hh.
      int kp[2][2];
      float ksc[2][2], vsc[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int sl = sb + j * 8 + 2 * t4 + e;
          kp[j][e] = pos_s[sl];
          ksc[j][e] = L::kInt8 ? ks_s[sl] * a.scale : a.scale;
          vsc[j][e] = L::kInt8 ? vs_s[sl] : 1.f;
        }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int qp = qp_s[mt * 16 + g + 8 * hh];
          bool ok[2][2];
          float mx = kNegInf;
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int p = kp[j][e];
              ok[j][e] = p >= 0 && p <= qp && (a.window <= 0 || qp - p < a.window);
              s[mt][j][2 * hh + e] = ok[j][e] ? s[mt][j][2 * hh + e] * ksc[j][e] : kNegInf;
              mx = fmaxf(mx, s[mt][j][2 * hh + e]);
            }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m_r[mt][hh], mx);
          const float alpha = expf(m_r[mt][hh] - m_new);
          m_r[mt][hh] = m_new;
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float p = ok[j][e] ? expf(s[mt][j][2 * hh + e] - m_new) : 0.f;
              sum += p;
              s[mt][j][2 * hh + e] = p * vsc[j][e];
            }
          l_r[mt][hh] = l_r[mt][hh] * alpha + sum;   // this thread's part
#pragma unroll
          for (int dn = 0; dn < D / 8; ++dn) {
            acc[mt][dn][2 * hh] *= alpha;
            acc[mt][dn][2 * hh + 1] *= alpha;
          }
        }

      // acc += P V
      if constexpr (L::kTf32) {
        uint32_t pa[MT][2][kNP][4];        // [mt][k-step of 8 slots][term]
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            // A (row, k): k = t4 <-> slot 2*t4, k = t4 + 4 <-> slot 2*t4 + 1
            split_tf32(s[mt][j][0], pa[mt][j][0][0], pa[mt][j][1][0]);
            split_tf32(s[mt][j][2], pa[mt][j][0][1], pa[mt][j][1][1]);
            split_tf32(s[mt][j][1], pa[mt][j][0][2], pa[mt][j][1][2]);
            split_tf32(s[mt][j][3], pa[mt][j][0][3], pa[mt][j][1][3]);
          }
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            uint32_t vb[L::kKvTerms][2];
            v_frag<L, KT>(v_s, sb + j * 8 + 2 * t4, dn * 8 + g, vb);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              mma_terms<true>(acc[mt][dn], pa[mt][j], vb);
          }
      } else {
        uint32_t pa[MT][kNP][4];           // one k-step of 16 slots
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          split_bf16(s[mt][0][0], s[mt][0][1], pa[mt][0][0], pa[mt][1][0]);
          split_bf16(s[mt][0][2], s[mt][0][3], pa[mt][0][1], pa[mt][1][1]);
          split_bf16(s[mt][1][0], s[mt][1][1], pa[mt][0][2], pa[mt][1][2]);
          split_bf16(s[mt][1][2], s[mt][1][3], pa[mt][0][3], pa[mt][1][3]);
        }
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          uint32_t vb[1][2];
          v_frag<L, KT>(v_s, sb + 2 * t4, dn * 8 + g, vb);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_terms<false>(acc[mt][dn], pa[mt], vb);
        }
      }
    }
    if (!kRing || (seg += RingAddr::kScan) >= e_end) break;
    cp_wait<0>();
    __syncthreads();                       // the sweep no longer reads lists or stages
    int next[kScanIt];
    scan_load(seg, next);
    scan_lists(seg, next, qp_min, qp_max);
    __syncthreads();
    n_tiles = ring_tiles();
    if (n_tiles > 0) issue(0);
    cp_commit();
  }

  // merge the 4 warps in warp order (the ring is free once every copy landed)
  cp_wait<0>();
  __syncthreads();
  float* red_acc = reinterpret_cast<float*>(ring);         // [warps][MPad][D]
  float* red_m = red_acc + kWarps * L::kMPad * D;           // [warps][MPad]
  float* red_l = red_m + kWarps * L::kMPad;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float l = l_r[mt][hh];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int r = warp * L::kMPad + mt * 16 + g + 8 * hh;
      if (t4 == 0) {
        red_m[r] = m_r[mt][hh];
        red_l[r] = l;
      }
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        red_acc[r * D + dn * 8 + 2 * t4] = acc[mt][dn][2 * hh];
        red_acc[r * D + dn * 8 + 2 * t4 + 1] = acc[mt][dn][2 * hh + 1];
      }
    }
  __syncthreads();

  Q* out = static_cast<Q*>(a.out);
  const size_t parts = (size_t)a.n_b * a.n_kv * a.splits * rows;
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, red_m[w * L::kMPad + r]);
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(red_m[w * L::kMPad + r] - m);
      l += red_l[w * L::kMPad + r] * f;
      o += red_acc[(w * L::kMPad + r) * D + c] * f;
    }
    if (a.splits == 1) {
      store(&out[((size_t)(b * a.n_t + r / grp) * a.n_h + kvh * grp + r % grp) * D + c],
            o / fmaxf(l, 1e-30f));
    } else {
      const size_t p = ((size_t)(b * a.n_kv + kvh) * a.splits + split) * rows + r;
      a.part[p * D + c] = o;
      if (c == 0) {
        a.part[parts * D + p] = m;
        a.part[parts * (D + 1) + p] = l;
      }
    }
  }
}

// Combines the S partials of one (row, KV head, sequence) in split order;
// one thread per head-dim lane.
template <class Addr, class Q>
__global__ void merge_kernel(const Args a, int d) {
  const int r = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z, c = threadIdx.x;
  const int grp = a.n_h / a.n_kv;
  const int rows = grp * a.n_t;
  const size_t parts = (size_t)a.n_b * a.n_kv * a.splits * rows;
  const size_t p0 = (size_t)(b * a.n_kv + kvh) * a.splits * rows + r;
  const float* pm = a.part + parts * d;
  const float* pl = pm + parts;
  float m = kNegInf;
#pragma unroll 4
  for (int s = 0; s < a.splits; ++s) m = fmaxf(m, __ldg(pm + p0 + (size_t)s * rows));
  float l = 0.f, o = 0.f;
#pragma unroll 4
  for (int s = 0; s < a.splits; ++s) {
    const size_t p = p0 + (size_t)s * rows;
    const float f = expf(__ldg(pm + p) - m);
    l += __ldg(pl + p) * f;
    o += __ldg(a.part + p * d + c) * f;
  }
  Q* out = static_cast<Q*>(a.out);
  store(&out[((size_t)(b * a.n_t + r / grp) * a.n_h + kvh * grp + r % grp) * d + c],
        o / fmaxf(l, 1e-30f));
}

template <class Addr, class Q, class KT, int D, int MT>
int launch_mt(const Args& a, cudaStream_t stream) {
  using L = Layout<Q, KT, D, MT>;
  auto kernel = verify_kernel<Addr, Q, KT, D, MT>;
  // set once per device (bit = device ordinal): above 48 KB needs opting in
  static unsigned opted = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (L::kBytes > 48 * 1024 && !(opted >> (dev & 31) & 1u)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::kBytes);
    if (e != cudaSuccess) return (int)e;
    opted |= 1u << (dev & 31);
  }
  kernel<<<dim3(a.n_b, a.n_kv, a.splits), kThreads, L::kBytes, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return (int)e;
  const int rows = (a.n_h / a.n_kv) * a.n_t;
  merge_kernel<Addr, Q><<<dim3(rows, a.n_kv, a.n_b), D, 0, stream>>>(a, D);
  return (int)cudaGetLastError();
}

template <class Addr, class Q, class KT, int D>
int launch_d(const Args& a, int mt, cudaStream_t stream) {
  if (mt == 1) return launch_mt<Addr, Q, KT, D, 1>(a, stream);
  if (mt == 2) return launch_mt<Addr, Q, KT, D, 2>(a, stream);
  if constexpr (D <= 64) {
    if (mt == 3) return launch_mt<Addr, Q, KT, D, 3>(a, stream);
    if (mt == 4) return launch_mt<Addr, Q, KT, D, 4>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// Launches on `stream` (the split kernel and, for S > 1, the merge);
// returns cudaGetLastError() after the last launch.  Takes D 32, 64 or 128,
// G*T <= 64 rows (<= 32 at D 128), BS a power of two <= 32 (RingAddr:
// units of 16 slots, MAXB = ceil(W / 16)), S >= 1.
template <class Addr, class Q, class KT>
int launch(const Args& a, int d, cudaStream_t stream) {
  const int rows = (a.n_h / a.n_kv) * a.n_t;
  if (a.splits < 1 || a.bs_log2 < 0 || a.bs_log2 > 5 || rows < 1)
    return (int)cudaErrorInvalidValue;
  if (Addr::kRing && ((1 << a.bs_log2) != RingAddr::kChunk || a.ring_w < 0
                      || a.maxb != (a.ring_w + RingAddr::kChunk - 1) / RingAddr::kChunk))
    return (int)cudaErrorInvalidValue;
  const int mt = (rows + 15) / 16;
  if (d == 32) return launch_d<Addr, Q, KT, 32>(a, mt, stream);
  if (d == 64) return launch_d<Addr, Q, KT, 64>(a, mt, stream);
  if (d == 128) return launch_d<Addr, Q, KT, 128>(a, mt, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace pv
