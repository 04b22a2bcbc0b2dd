// K2/K3: merge-path partitioned FLiMS merge of R run pairs, as persistent
// warp-synchronous blocks.
//
// Replaces `flims_merge_pallas` / `flims_merge_kv_pallas`
// (src/repro/kernels/flims_merge.py:159, :330) and `segmented_merge_runs` /
// `segmented_merge_runs_kv` (src/repro/kernels/segmented_merge.py:140,
// :299); K2 is this kernel with R = 1.
//
// Pair s merges a[a_starts[s] :+ a_lens[s]] with b[b_starts[s] :+ b_lens[s]]
// into out[out_off[s] :], cut into C-wide output blocks (blk0[s] the pair's
// first block in the flat order) and clipped at n_out. A block at output
// offset o runs ceil(valid / w) FLiMS cycles from the merge-path co-rank of
// o: the MAX selector (key-only, ties to B) or the compound order (KV) over
// the A heads and the reversed B heads, a log2(w) butterfly, and two-row
// windows that advance by the selector count. Runs are read in place and
// each block is written straight to its flat offset, so the TPU kernel's
// sentinel-padded banks and its (G, C) output plus gather do not exist.
//
// What bounds it on this card. Bytes: each element is read once and written
// once, 0.040 ms key-only and 0.080 KV for 2^24 keys at 3.35 TB/s. But a
// block is a chain, cycle t + 1 needing cycle t's count, so the kernel is
// latency-bound unless many chains are in flight, each with its loads well
// ahead. The first version ran one 128-thread CTA per block: a cooperative
// co-rank search of CTA barriers and dependent loads, then five CTA
// barriers a cycle (two butterfly stages and the count through shared
// memory) with its loads one row ahead.
//
// The design:
// - offsets_kernel (one CTA, R > 1): out_off and blk0 from the run lengths,
//   on the card.
// - merge_kernel: persistent warps, as many CTAs as the card holds
//   (`flims_merge_blocks_occupancy`); warp W of the grid takes blocks W, W +
//   warps, ... A block
//   - finds its pair by a 32-ary search over blk0 (a ballot a round);
//   - finds its co-rank by the JAX kernels' fixed-step binary search
//     (`_corank`, flims_merge.py:121; `_corank_runs`, segmented_merge.py:101)
//     five steps at a time: lane n - 1 probes node n of the next five levels
//     of the search tree, its (lo, hi) replayed from the node's path, and
//     one ballot then walks the path. Those are the binary search's own
//     probes, so it gives its answer on every input, runs holding NaNs
//     (where the predicate is not monotone) included;
//   - runs its cycles within the warp: thread t holds lanes t, t + 32, ...
//     (M = w/32; a partial warp below 32), butterfly stages >= 32 within a
//     thread and < 32 by shuffle, key-only float warps without a NaN on
//     monotone bits (`warp_butterfly_mono`), the count a sum of ballots; no
//     CTA barrier;
//   - streams each side's rows through a ring of kRing rows of the warp's
//     shared memory by cp.async (16 B a lane where a row is whole and its
//     source 16-byte aligned, 4 B a lane otherwise, nothing past the run's
//     end), each slot completing on an mbarrier; a row is issued when the
//     row kRing before it leaves the window, kRing - 2 rows ahead of use;
//   - stores 4 B a lane, each of a thread's M stores 128 contiguous bytes
//     of the warp.

// Clock counters for scripts/k23_profile.py, compiled in only under
// -DK23_PROFILE: per warp, summed by its lane 0 in shared memory and
// written to k23_prof[cta][warp][counter] at the CTA's end for the first
// K23_PROF_CTAS CTAs, with each CTA's start, end (globaltimer) and SM in
// k23_when. Without the define every K23_* macro is empty.
#ifdef K23_PROFILE
#include <cstdint>
#ifndef K23_PROF_CTAS
#define K23_PROF_CTAS 8192
#endif
constexpr int kK23Counters = 8;
constexpr int kK23Warps = 8;
__device__ unsigned long long k23_prof[K23_PROF_CTAS * kK23Warps * kK23Counters];
__device__ unsigned long long k23_when[K23_PROF_CTAS * 3];
__shared__ unsigned long long s_k23[kK23Warps][kK23Counters];
__device__ __forceinline__ unsigned long long k23_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define K23_T(t) const long long t = clock64()
#define K23_ACC(c, t)                                                         \
  do {                                                                        \
    if ((threadIdx.x & 31) == 0 && (threadIdx.x >> 5) < kK23Warps)           \
      s_k23[threadIdx.x >> 5][c] += clock64() - (t);                          \
  } while (0)
#define K23_COUNT(c)                                                          \
  do {                                                                        \
    if ((threadIdx.x & 31) == 0 && (threadIdx.x >> 5) < kK23Warps) s_k23[threadIdx.x >> 5][c] += 1; \
  } while (0)
#define K23_INIT()                                                            \
  do {                                                                        \
    if (threadIdx.x == 0 && blockIdx.x < K23_PROF_CTAS) {                     \
      unsigned s_;                                                            \
      asm volatile("mov.u32 %0, %%smid;" : "=r"(s_));                         \
      k23_when[blockIdx.x * 3] = k23_now();                                   \
      k23_when[blockIdx.x * 3 + 2] = s_;                                      \
    }                                                                         \
    for (int i_ = threadIdx.x; i_ < kK23Warps * kK23Counters; i_ += blockDim.x) \
      s_k23[i_ / kK23Counters][i_ % kK23Counters] = 0;                        \
    __syncthreads();                                                          \
  } while (0)
#define K23_FLUSH()                                                           \
  do {                                                                        \
    __syncthreads();                                                          \
    if ((threadIdx.x & 31) == 0 && (threadIdx.x >> 5) < kK23Warps &&         \
        blockIdx.x < K23_PROF_CTAS)                                           \
      for (int k_ = 0; k_ < kK23Counters; ++k_)                               \
        k23_prof[((size_t)blockIdx.x * kK23Warps + (threadIdx.x >> 5)) * kK23Counters + k_] = \
            s_k23[threadIdx.x >> 5][k_];                                      \
    if (threadIdx.x == 0 && blockIdx.x < K23_PROF_CTAS)                       \
      k23_when[blockIdx.x * 3 + 1] = k23_now();                               \
  } while (0)
#else
#define K23_T(t)
#define K23_ACC(c, t) do { } while (0)
#define K23_COUNT(c) do { } while (0)
#define K23_INIT() do { } while (0)
#define K23_FLUSH() do { } while (0)
#endif


#include "flims.cuh"

namespace flims {
namespace k23 {

constexpr int kRing = 4;           // rows a side in a warp's ring (a power of 2)
constexpr int kMaxWarps = 8;       // warps a CTA
constexpr int kOffsetThreads = 1024;

// One warp's shared memory: the 2 x kRing slot barriers, then the two
// sides' key rows, then (KV) their rank rows.
__host__ __device__ inline size_t warp_smem(int w, bool kv, int tsize) {
  const size_t rows = (size_t)2 * kRing * w;
  return (2 * kRing * sizeof(uint64_t) + rows * tsize + (kv ? rows * 4 : 0) + 127) / 128 * 128;
}
__host__ inline int cta_warps(int w, bool kv, int tsize) {
  const int n = (int)((96 * 1024) / warp_smem(w, kv, tsize));
  return n < 1 ? 1 : (n > kMaxWarps ? kMaxWarps : n);
}

// The run vectors; null vectors stand for one pair a[0:na], b[0:nb] (K2).
struct Runs {
  const int32_t *as, *al, *bs, *bl;
  int na, nb;
  __device__ int a_start(int s) const { return as ? as[s] : 0; }
  __device__ int a_len(int s) const { return al ? al[s] : na; }
  __device__ int b_start(int s) const { return bs ? bs[s] : 0; }
  __device__ int b_len(int s) const { return bl ? bl[s] : nb; }
};

// out_off / blk0 (R + 1 entries each): exclusive sums of the pairs'
// lengths and of their ceil(len / C) blocks. Thread t takes a contiguous
// share of the pairs.
__global__ void __launch_bounds__(kOffsetThreads)
    offsets_kernel(Runs runs, int R, int C, int32_t* __restrict__ out_off,
                   int32_t* __restrict__ blk0) {
  __shared__ int32_t s_len[kOffsetThreads], s_blk[kOffsetThreads];
  const int t = threadIdx.x;
  const int s0 = (int)((long long)t * R / kOffsetThreads);
  const int s1 = (int)((long long)(t + 1) * R / kOffsetThreads);
  int sl = 0, sb = 0;
  for (int s = s0; s < s1; ++s) {
    const int l = runs.a_len(s) + runs.b_len(s);
    sl += l;
    sb += (l + C - 1) / C;
  }
  s_len[t] = sl;
  s_blk[t] = sb;
  __syncthreads();
  for (int d = 1; d < kOffsetThreads; d <<= 1) {
    const int x = t >= d ? s_len[t - d] : 0, y = t >= d ? s_blk[t - d] : 0;
    __syncthreads();
    s_len[t] += x;
    s_blk[t] += y;
    __syncthreads();
  }
  int ol = s_len[t] - sl, ob = s_blk[t] - sb;
  for (int s = s0; s < s1; ++s) {
    out_off[s] = ol;
    blk0[s] = ob;
    const int l = runs.a_len(s) + runs.b_len(s);
    ol += l;
    ob += (l + C - 1) / C;
  }
  if (t == kOffsetThreads - 1) {
    out_off[R] = s_len[t];
    blk0[R] = s_blk[t];
  }
}

// The pair of flat block g: the largest s with blk0[s] <= g, 32 candidates
// a round (blk0 does not decrease).
__device__ int pair_of(const int32_t* __restrict__ blk0, int R, int g, int lane) {
  int lo = 0, hi = R - 1;
  while (lo < hi) {
    const long long span = hi - lo;
    auto cand = [&](int j) { return lo + 1 + (int)((long long)j * span / 32); };
    const int cnt = __popc(__ballot_sync(kFullWarp, blk0[cand(lane)] <= g));
    if (cnt == 0) break;
    const int nlo = cand(cnt - 1);
    hi = cnt < 32 ? cand(cnt) - 1 : hi;
    lo = nlo;
  }
  return lo;
}

// One side of a block: the run, read from element `base` on in w-wide rows
// through the warp's ring of kRing slots (row q in slot q % kRing).
template <typename T, bool KV, bool DESC> struct Side {
  T* sk;
  int32_t* sr;
  uint64_t* full;
  const T* k;
  const int32_t* r;
  long long len, base;
  uint32_t ph;  // per slot: the parity of its next phase
  int head;     // the window's first row
  int w;
  bool vec;

  __device__ bool has(int row) const { return base + (long long)row * w < len; }
  __device__ void issue(int row, int lane) {
    if (!has(row)) return;
    K23_T(t_issue);
    const int s = row & (kRing - 1);
    T* dk = sk + (size_t)s * w;
    int32_t* dr = KV ? sr + (size_t)s * w : nullptr;
    const long long p0 = base + (long long)row * w;
    if (vec && p0 + w <= len) {
      for (int c = 4 * lane; c < w; c += 128) {
        cp_async16(dk + c, k + p0 + c);
        if (KV) cp_async16(dr + c, r + p0 + c);
      }
    } else {
      for (int i = lane; i < w && p0 + i < len; i += 32) {
        cp_async4(dk + i, k + p0 + i);
        if (KV) cp_async4(dr + i, r + p0 + i);
      }
    }
    cp_async_arrive(&full[s]);
    ph ^= 1u << s;
    K23_ACC(4, t_issue);
  }
  __device__ void wait(int row) {
    if (!has(row)) return;
    K23_T(t_wait);
    const int s = row & (kRing - 1);
    mbar_wait(&full[s], ((ph >> s) & 1u) ^ 1u);
    K23_ACC(1, t_wait);
  }
  __device__ void begin(const T* k_, const int32_t* r_, int len_, int base_, int lane) {
    k = k_;
    r = r_;
    len = len_;
    base = base_;
    head = 0;
    vec = w % 4 == 0 && !(reinterpret_cast<uintptr_t>(k + base) & 15) &&
          (!KV || !(reinterpret_cast<uintptr_t>(r + base) & 15));
    for (int q = 0; q < kRing; ++q) issue(q, lane);
    wait(0);
    wait(1);
  }
  // the rows issued ahead and not reached: the ring ends each block empty
  __device__ void drain() {
    for (int q = head + 2; q < head + kRing; ++q) wait(q);
  }
  __device__ Lane<T> at(int row, int c) const {
    Lane<T> v;
    if (base + (long long)row * w + c < len) {
      const int s = row & (kRing - 1);
      v.k = sk[s * w + c];
      v.r = KV ? sr[s * w + c] : 0;
    } else {
      v.k = last_key<T, DESC>();
      v.r = kInvalidRank;
    }
    return v;
  }
  // `consumed` more heads taken at rotation l; a row leaving the window
  // frees its slot for the row kRing on
  __device__ void advance(int& l, int consumed, int lane) {
    const int l2 = l + consumed;
    if (l2 < w) {
      l = l2;
      return;
    }
    l = l2 - w;
    __syncwarp();  // every lane has read the slot
    issue(head + kRing, lane);
    ++head;
    wait(head + 1);
  }
};

template <typename T, bool KV, bool DESC, int M>
__global__ void __launch_bounds__(32 * kMaxWarps)
    merge_kernel(const T* __restrict__ a, const int32_t* __restrict__ ra,
                 const T* __restrict__ b, const int32_t* __restrict__ rb, Runs runs,
                 const int32_t* __restrict__ out_off, const int32_t* __restrict__ blk0,
                 T* __restrict__ out, int32_t* __restrict__ out_r, int R, int n_out, int C,
                 int w, int steps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned char* mine = smem + (size_t)warp * warp_smem(w, KV, sizeof(T));
  uint64_t* full = reinterpret_cast<uint64_t*>(mine);
  T* rk = reinterpret_cast<T*>(mine + 2 * kRing * sizeof(uint64_t));
  int32_t* rr = reinterpret_cast<int32_t*>(rk + (size_t)2 * kRing * w);
  K23_INIT();
  K23_T(t_total);
  if (lane < 2 * kRing) mbar_init(&full[lane], 32);
  mbar_init_fence();
  __syncwarp();
  Side<T, KV, DESC> A{rk, KV ? rr : nullptr, full, a, ra, 0, 0, 0u, 0, w, false};
  Side<T, KV, DESC> B{rk + (size_t)kRing * w, KV ? rr + (size_t)kRing * w : nullptr,
                      full + kRing, b, rb, 0, 0, 0u, 0, w, false};
  const int blocks = R > 1 ? blk0[R] : (runs.a_len(0) + runs.b_len(0) + C - 1) / C;
  const int stride = gridDim.x * (blockDim.x >> 5);
  for (int g = blockIdx.x * (blockDim.x >> 5) + warp; g < blocks; g += stride) {
    K23_T(t_search);
    const int s = R > 1 ? pair_of(blk0, R, g, lane) : 0;
    const int la = runs.a_len(s), lb = runs.b_len(s);
    const long long o = (long long)(g - (R > 1 ? blk0[s] : 0)) * C;
    const long long ooff = R > 1 ? out_off[s] : 0;
    // a block never writes past its pair, nor past the output
    const int valid = (int)min(min((long long)C, (long long)la + lb - o), (long long)n_out - ooff - o);
    if (valid <= 0) continue;
    const T* ak = a + runs.a_start(s);
    const T* bk = b + runs.b_start(s);
    const int32_t* ark = KV ? ra + runs.a_start(s) : nullptr;
    const int32_t* brk = KV ? rb + runs.b_start(s) : nullptr;
    const int acut = corank<T, KV, DESC>(ak, ark, la, bk, brk, lb, (int)o, steps, lane);
    const int bcut = (int)o - acut;
    K23_ACC(0, t_search);
    int lA = acut % w, lB = bcut % w;
    A.begin(ak, ark, la, acut - lA, lane);
    B.begin(bk, brk, lb, bcut - lB, lane);
    T* ok = out + ooff + o;
    int32_t* orr = KV ? out_r + ooff + o : nullptr;
    const int cycles = (valid + w - 1) / w;
    for (int t = 0; t < cycles; ++t) {
      K23_T(t_sel);
      Lane<T> v[M];
      int taken = 0;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int i = lane + 32 * m, j = w - 1 - i;
        const bool live = i < w;
        Lane<T> ca{last_key<T, DESC>(), kInvalidRank}, cb = ca;
        if (live) {
          ca = A.at(A.head + (i < lA), i);
          cb = B.at(B.head + (j < lB), j);
        }
        const bool take = live && wins<T, KV, DESC>(ca, cb);
        v[m] = pick(take, ca, cb);
        if (!KV) v[m].k = xmax(ca.k, cb.k);
        taken += __popc(__ballot_sync(kFullWarp, take));
      }
      K23_ACC(2, t_sel);
      K23_T(t_bf);
      warp_butterfly_mono<T, KV, DESC, M>(v, w);
      K23_ACC(3, t_bf);
      K23_T(t_st);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int i = lane + 32 * m, p = t * w + i;
        if (i < w && p < valid) {
          ok[p] = v[m].k;
          if (KV) orr[p] = v[m].r;
        }
      }
      K23_ACC(5, t_st);
      A.advance(lA, taken, lane);
      B.advance(lB, w - taken, lane);
    }
    A.drain();
    B.drain();
    K23_COUNT(7);
  }
  K23_ACC(6, t_total);
  K23_FLUSH();
}

struct Args {
  const void *a, *ra, *b, *rb;
  Runs runs;
  int32_t* meta;  // out_off, then blk0: R + 1 entries each (R > 1)
  void *out, *out_r;
  int R, n_out, G, C, w, steps, ctas;
  cudaStream_t st;
  int* per_sm;  // set: report the CTAs an SM holds instead of launching
};

template <typename T, bool KV, bool DESC, int M>
static cudaError_t run(const Args& x) {
  const int warps = cta_warps(x.w, KV, sizeof(T));
  const size_t smem = (size_t)warps * warp_smem(x.w, KV, sizeof(T));
  auto kern = merge_kernel<T, KV, DESC, M>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  if (x.per_sm) return cudaOccupancyMaxActiveBlocksPerMultiprocessor(x.per_sm, kern, 32 * warps, smem);
  int32_t *out_off = x.meta, *blk0 = x.meta ? x.meta + x.R + 1 : nullptr;
  if (x.R > 1) {
    offsets_kernel<<<1, kOffsetThreads, 0, x.st>>>(x.runs, x.R, x.C, out_off, blk0);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const long long need = ((long long)x.G + warps - 1) / warps;
  const int grid = (int)(need < x.ctas ? need : x.ctas);
  kern<<<grid, 32 * warps, smem, x.st>>>((const T*)x.a, (const int32_t*)x.ra, (const T*)x.b,
                                        (const int32_t*)x.rb, x.runs, out_off, blk0, (T*)x.out,
                                        (int32_t*)x.out_r, x.R, x.n_out, x.C, x.w, x.steps);
  return cudaGetLastError();
}

// M = w / 32 lanes a thread (1 below 32)
template <typename T, bool KV, bool DESC>
static cudaError_t by_width(const Args& x) {
  switch (x.w) {
    case 64: return run<T, KV, DESC, 2>(x);
    case 128: return run<T, KV, DESC, 4>(x);
    case 256: return run<T, KV, DESC, 8>(x);
    case 512: return run<T, KV, DESC, 16>(x);
    case 1024: return run<T, KV, DESC, 32>(x);
    default: return run<T, KV, DESC, 1>(x);
  }
}

template <typename T>
static cudaError_t dispatch(int kv, int desc, const Args& x) {
  if (!kv && desc) return by_width<T, false, true>(x);
  if (kv && desc) return by_width<T, true, true>(x);
  if (kv && !desc) return by_width<T, true, false>(x);
  return cudaErrorInvalidValue;  // key-only lanes merge descending only
}

static cudaError_t by_dtype(int dtype, int kv, int desc, const Args& x) {
  if (x.w < 1 || x.w > 1024 || (x.w & (x.w - 1))) return cudaErrorInvalidValue;
  if (dtype == kInt32) return dispatch<int32_t>(kv, desc, x);
  if (dtype == kFloat32) return dispatch<float>(kv, desc, x);
  return cudaErrorInvalidValue;
}

}  // namespace k23
}  // namespace flims

// a_starts .. b_lens null: one pair a[0:na], b[0:nb] (R = 1); meta: 2 (R + 1)
// int32 of scratch for R > 1; G bounds the blocks (sizes the grid); steps:
// the co-rank search's steps; ctas: the most CTAs to launch
extern "C" int flims_merge_blocks(int dtype, int kv, int desc, const void* a, const void* ra,
                                  const void* b, const void* rb, const void* a_starts,
                                  const void* a_lens, const void* b_starts, const void* b_lens,
                                  int na, int nb, void* meta, void* out, void* out_r, int R,
                                  int n_out, int G, int C, int w, int steps, int ctas,
                                  void* stream) {
  using namespace flims::k23;
  auto I = [](const void* p) { return (const int32_t*)p; };
  const Runs runs{I(a_starts), I(a_lens), I(b_starts), I(b_lens), na, nb};
  if (G <= 0 || ctas <= 0 || R < 1 || w < 1 || C % w || (R > 1 && (!meta || !a_lens || !b_lens)))
    return cudaErrorInvalidValue;
  const Args x{a, ra, b, rb, runs, (int32_t*)meta, out, out_r, R, n_out, G, C, w, steps,
               ctas, (cudaStream_t)stream, nullptr};
  return by_dtype(dtype, kv, desc, x);
}

// CTAs of the merge kernel an SM holds at w
extern "C" int flims_merge_blocks_occupancy(int dtype, int kv, int desc, int w) {
  using namespace flims::k23;
  int per_sm = 0;
  Args x{};
  x.w = w;
  x.per_sm = &per_sm;
  const cudaError_t e = by_dtype(dtype, kv, desc, x);
  return e != cudaSuccess ? -(int)e : per_sm;
}

#ifdef K23_PROFILE
// search (the block's segment and co-rank), wait (on a ring row's
// barrier), select (the heads from the ring, the selector and the count's
// ballots), bfly (the butterfly), issue (a row's copies into the ring),
// store, total, blocks (count)
extern "C" const char* k23_prof_names() {
  return "search,wait,select,bfly,issue,store,total,blocks";
}
extern "C" int k23_prof_layout(int* ctas, int* warps, int* counters) {
  *ctas = K23_PROF_CTAS;
  *warps = kK23Warps;
  *counters = kK23Counters;
  return 0;
}
extern "C" int k23_prof_read(void* dst) {
  return cudaMemcpyFromSymbol(dst, k23_prof, sizeof(k23_prof));
}
extern "C" int k23_prof_zero() {
  void* p = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&p, k23_prof);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(k23_prof));
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&p, k23_when);
  return e != cudaSuccess ? e : cudaMemset(p, 0, sizeof(k23_when));
}
// (start ns, end ns, SM) per CTA
extern "C" int k23_when_read(void* dst) {
  return cudaMemcpyFromSymbol(dst, k23_when, sizeof(k23_when));
}
#endif
