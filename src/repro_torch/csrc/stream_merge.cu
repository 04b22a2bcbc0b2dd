// K8: streaming k-way merge of uniform device-resident runs, as a
// persistent streaming merge tree.
//
// Replaces `_stream_call` (src/repro/kernels/stream_merge.py:225; body
// `_stream_kernel` :101, nested co-rank `_stream_meta_one` :69) behind
// `stream_merge_runs` / `stream_merge_runs_kv`. Groups of 2^L uniform runs
// (L from 1 to 4) merge through L fused FLiMS levels; leaf j of group `grp`
// is the run at flat offset (grp * 2^L + j) * run_len.
//
// What bounds it on this card. Bytes: every element is read once and
// written once per pass (0.32 ms key-only at 2^27 keys, 3.35 TB/s). But a
// FLiMS node is a chain, cycle t + 1 needing cycle t's take count, of a few
// hundred instructions a w-row; 2^L - 1 nodes run per output row. So the
// kernel is bound by latency unless many node chains are in flight, and by
// barriers when a chain waits on the whole CTA. The first version, one CTA
// per C-wide output block, had both: each block re-ran the nested partition
// (about 230 dependent loads), each cycle ended in a CTA barrier, leaf rows
// came one cycle ahead, and whole-block inner-node slots (68 KB key-only and
// 137 KB KV at C 4096, w 128, L 3) left one to three CTAs on an SM.
//
// The design.
// - Persistent CTAs over spans. The grid is at most what the card holds at
//   once (the wrapper's `ctas`). Each group splits into `spg` spans of
//   consecutive C-blocks (span s: blocks [s bpg / spg, (s + 1) bpg / spg)),
//   never crossing a group; a CTA takes spans blockIdx.x, += gridDim.x. The
//   partition runs once at a span's first block and the tree streams to the
//   span's end with no restart. That is the per-block kernel bit for bit: a
//   node takes A on lane i iff wins(a_i, b_{w-1-i}), monotone in i, so after
//   t chunks it has consumed the co-rank of t w under the partition's order
//   (key, leaf descending, position); its state (two head rows a side, row
//   pointers, lA / lB) is a function of those counts alone, its rows on a
//   grid of w from the stream's start, so the stream meets each block
//   boundary in the state a restart computes, sign bits of +-0 included. A
//   node reads a child's rows below R + d + 1 (leaf rows below the run's
//   end) and fill lanes past them, as the per-block kernel read rows below
//   C/w + d + 1; but a child gives rows only as its parent frees ring slots
//   and stops when the parent is done (a per-edge handshake), so the tree
//   does about L R node cycles a span, not the (2^L - 1) R of producing
//   every row a worst-case split could need.
// - One warp per tree node, synchronous within the warp only. Thread t
//   holds lanes t, t + 32, ... (w/32 of them; lane t < w for w < 32);
//   butterfly stages d >= 32 exchange registers, d < 32 shuffle, every
//   compare-exchange a select (a branch per lane would split the warp); the
//   take count is a sum of ballots. No CTA barrier in the cycle loop.
//   Key-only float rows without a NaN in the warp go through the butterfly
//   as monotone int32 bits (warp_butterfly_mono): XLA's max / min is their
//   integer order there, and a NaN rule on every float compare cost a fan-8
//   pass 1.5x (PERF.md §6).
// - FIFOs in shared memory between nodes: a child writes rows into a ring of
//   kRingRows rows that its parent warp reads, each slot with a full and an
//   empty mbarrier. (2^(L+1) - 2) rings, independent of C: 30,592 B
//   key-only and 59,264 B KV a CTA at w 128, L 3, static scratch included
//   (`flims_stream_merge_smem` reads it from the compiled kernel).
// - Leaves through cp.async.bulk: the last warp is a producer, lane j
//   keeping up to kRingRows row copies of leaf j in flight into its ring,
//   each completing on the slot's full mbarrier (expect_tx). Rows at or
//   past a run's end are not copied: the parent reads them as sentinels.
//   A parent fences its reads of a slot (fence.proxy.async) before freeing
//   it: the refill is an async-proxy write the mbarrier does not order
//   after generic reads (without it about 1 fan-2 pass in 400 went wrong).
// - The root writes its rows straight to HBM, coalesced.
// CTAs also write the `out_slack` trailing sentinels, so passes chain with
// no copy.
//
// The partition. The TPU kernel takes each node's co-rank from a nested
// binary search on the host (`_stream_meta_one`): (log n)^L work and
// (log n)^(L-1) dependent loads. K8 finds the same numbers another way. The
// nested merges order a node's elements by key (with rank on KV lanes),
// then by leaf DESCENDING (ties go to the right child at every level), then
// by position, a strict total order. Under it the rank of element p of leaf
// j within a node is p plus, for every other leaf j' of the node, the count
// of its elements that precede it: one binary search per leaf j', all
// independent. The count of leaf j among the node's top-a is the largest p
// whose element p-1 ranks below a. A node's co-rank is the sum of its left
// leaves' counts; its children's aligned offsets follow, and the next level
// repeats with them, one warp per leaf searching 33-ary over its positions.
// Below the root a leaf's count lies within w - 1 under its count at the
// parent, so those searches take two or three rounds instead of five.
#include "flims.cuh"

// Clock counters for scripts/k8_profile.py, compiled in only under
// -DK8_PROFILE (and the butterfly left out under -DK8_NO_BUTTERFLY, a
// floor with wrong results): per warp, summed in shared memory and written
// to k8_prof[cta][warp][counter] at the kernel's end, for the first
// K8_PROF_CTAS CTAs. Without the define every PROF* macro is empty.
#ifdef K8_PROFILE
#ifndef K8_PROF_CTAS
#define K8_PROF_CTAS 8192
#endif
constexpr int kProfCounters = 8;
__device__ unsigned long long k8_prof[K8_PROF_CTAS * 32 * kProfCounters];
__shared__ unsigned long long s_prof[16][kProfCounters];
#define PROF_START(t) const long long t = clock64()
#define PROF(k, t)                                                       \
  do {                                                                   \
    if ((threadIdx.x & 31) == 0) s_prof[threadIdx.x >> 5][k] += clock64() - (t); \
  } while (0)
#define PROF_INIT()                                                      \
  do {                                                                   \
    if (threadIdx.x < 16 * kProfCounters)                                \
      s_prof[threadIdx.x / kProfCounters][threadIdx.x % kProfCounters] = 0; \
  } while (0)
#define PROF_FLUSH()                                                     \
  do {                                                                   \
    if ((threadIdx.x & 31) == 0 && blockIdx.x < K8_PROF_CTAS)            \
      for (int k_ = 0; k_ < kProfCounters; ++k_)                         \
        k8_prof[((size_t)blockIdx.x * 32 + (threadIdx.x >> 5)) * kProfCounters + k_] = \
            s_prof[threadIdx.x >> 5][k_];                                \
  } while (0)
#else
#define PROF_START(t)
#define PROF(k, t) do { } while (0)
#define PROF_INIT() do { } while (0)
#define PROF_FLUSH() do { } while (0)
#endif

namespace flims {

constexpr int kMaxGroup = 16;

// The group's uniform runs: element p of leaf j.
template <typename T, bool KV> struct Leaves {
  const T* k;
  const int32_t* r;
  long long leaf0;  // flat offset of leaf 0
  int run_len;
  __device__ Lane<T> at(int j, int p) const {
    const long long q = leaf0 + (long long)j * run_len + p;
    Lane<T> v;
    v.k = k[q];
    v.r = KV ? r[q] : 0;
    return v;
  }
};

// Sum over the other leaves j' of node [lo, lo + span) of the count of
// elements preceding x (element of leaf j) in the node's order, each count
// capped at `cap`. A leaf right of j precedes x on ties, one left of it
// does not. All searches advance together, one step each per round.
template <typename T, bool KV, bool DESC, int GROUP>
__device__ long long rank_others(const Leaves<T, KV>& lv, int j, const Lane<T>& x, int lo,
                                 int span, int cap) {
  int a[GROUP], b[GROUP];
#pragma unroll
  for (int jj = 0; jj < GROUP; ++jj) {
    a[jj] = 0;
    b[jj] = (jj >= lo && jj < lo + span && jj != j) ? cap : 0;
  }
  const int steps = 32 - __clz(cap);
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int jj = 0; jj < GROUP; ++jj) {
      if (a[jj] < b[jj]) {
        const int m = (a[jj] + b[jj] + 1) >> 1;
        const Lane<T> y = lv.at(jj, m - 1);
        const bool before = jj > j ? !wins<T, KV, DESC>(x, y) : wins<T, KV, DESC>(y, x);
        if (before) a[jj] = m; else b[jj] = m - 1;
      }
    }
  }
  long long sum = 0;
#pragma unroll
  for (int jj = 0; jj < GROUP; ++jj) sum += a[jj];
  return sum;
}

// The nested partition of one block at group offset o: per internal node
// (heap index h, root 1, children 2h and 2h + 1) the (left, right) initial
// rotations rot[2h], rot[2h + 1], and per leaf its aligned start base[j].
template <typename T, bool KV, bool DESC, int L>
__device__ void partition(const Leaves<T, KV>& lv, long long o, int w, int* rot, int* base,
                          long long* off, int* cnt) {
  constexpr int GROUP = 1 << L;
  const int t = threadIdx.x;
  const int tpl = min(32, (int)blockDim.x / GROUP);  // threads per leaf team
  const int j = t / tpl, u = t % tpl;
  const bool member = j < GROUP;
  const int lane = t & 31;
  const unsigned team = tpl == 32 ? 0xffffffffu : ((1u << tpl) - 1u);
  if (t == 0) off[1] = o;
  __syncthreads();
  for (int d = 0; d < L; ++d) {
    const int span = GROUP >> d;
    const int lo_leaf = member ? (j / span) * span : 0;
    const long long a_node = member ? off[(1 << d) + j / span] : 0;
    const int cap = (int)min(a_node, (long long)lv.run_len);
    long long lo = 0, hi = member ? cap : 0;
    if (member && d > 0) {
      // a child's top-a' (a' = s - s % w) is its top-s, which holds the
      // leaf's parent count, less at most w - 1 elements
      hi = min(hi, (long long)cnt[j]);
      lo = max(0LL, (long long)cnt[j] - (w - 1));
    }
    // largest p in [0, hi] whose element p - 1 ranks below a_node
    while (__any_sync(0xffffffffu, lo < hi)) {
      const long long width = hi - lo;
      auto cand = [&](long long v) { return lo + 1 + (v * width) / tpl; };
      bool ok = false;
      if (lo < hi) {
        const int p = (int)cand(u);
        const Lane<T> x = lv.at(j, p - 1);
        ok = (p - 1) + rank_others<T, KV, DESC, GROUP>(lv, j, x, lo_leaf, span, cap) < a_node;
      }
      const int n_ok = __popc((__ballot_sync(0xffffffffu, ok) >> (lane - u)) & team);
      if (lo < hi) {
        if (n_ok == 0) {
          hi = lo;
        } else {
          const long long nlo = cand(n_ok - 1);
          hi = n_ok < tpl ? cand(n_ok) - 1 : hi;
          lo = nlo;
        }
      }
    }
    if (member && u == 0) cnt[j] = (int)lo;
    __syncthreads();
    if (t < (1 << d)) {  // one thread per node of this depth
      const int h = (1 << d) + t, first = t * span, mid = first + span / 2;
      long long sx = 0;
      for (int jj = first; jj < mid; ++jj) sx += cnt[jj];
      const long long sy = off[h] - sx;
      rot[2 * h] = (int)(sx % w);
      rot[2 * h + 1] = (int)(sy % w);
      if (span == 2) {
        base[first] = (int)(sx - sx % w);
        base[first + 1] = (int)(sy - sy % w);
      } else {
        off[2 * h] = sx - sx % w;
        off[2 * h + 1] = sy - sy % w;
      }
    }
    __syncthreads();
  }
}

// Rows per FIFO ring, inner-node and leaf edges alike. A node's cycle takes
// several hundred SM clocks, so four leaf rows in flight cover HBM latency.
constexpr int kRingRows = 4;

// Per-edge stop handshake (edge c = the child's heap index). When a parent
// has taken its last row it sets stop[c]; the child then gives no more rows,
// publishes how many it gave over the CTA's life in given[c] and sets
// done[c]; the parent releases the rows it did not read. A child gives at
// most kRingRows + 1 rows past the parent's need, where the per-block kernel
// produced every row a worst-case split could need (R + d at depth d, of
// which about R / 2^d are read).
struct Handshake {
  volatile int stop[2 * kMaxGroup];
  volatile int done[2 * kMaxGroup];
  volatile uint32_t given[2 * kMaxGroup];
};

// One FIFO edge from a child (inner node or leaf) to its parent: a ring of
// kRingRows rows of w lanes, slot s guarded by full[s] (the child has
// written it) and empty[s] (the parent has read it). Row q of the edge's
// life lies in slot q % kRingRows and completes the barriers' phase
// q / kRingRows.
template <typename T, bool KV> struct Fifo {
  T* k;
  int32_t* r;
  uint64_t* full;
  uint64_t* empty;
  __device__ static int slot(uint32_t q) { return (int)(q % kRingRows); }
  __device__ static uint32_t parity(uint32_t q) { return (q / kRingRows) & 1u; }
};

// A parent's read side of edge c. Rows are taken in order, each once: row
// `taken` of this span is real if below `limit` (the rows a per-block
// restart would see: a child's R + d + 1, a leaf's rows before its run's
// end) and the fill lane (last key, INVALID_RANK) otherwise. `rev` reads
// column w-1-i into lane i (side B).
template <typename T, bool KV, bool DESC, int M> struct Source {
  Fifo<T, KV> f;
  uint32_t q;  // rows taken from the ring over the CTA's life
  int taken, limit, w, c;
  bool rev;
  __device__ void release(int s) {
    fence_proxy_async();  // a leaf slot is refilled by a bulk copy
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&f.empty[s]);
    ++q;
  }
  __device__ void next(Lane<T> (&x)[M]) {
    const int lane = threadIdx.x & 31;
    PROF_START(t_next);
    if (taken < limit) {
      const int s = f.slot(q);
      PROF_START(t_wait);
      mbar_wait(&f.full[s], f.parity(q));
      PROF(0, t_wait);
      const T* rk = f.k + (size_t)s * w;
      const int32_t* rr = KV ? f.r + (size_t)s * w : nullptr;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int i = lane + 32 * m, col = rev ? w - 1 - i : i;
        if (i < w) {
          x[m].k = rk[col];
          x[m].r = KV ? rr[col] : 0;
        }
      }
      release(s);
    } else {
#pragma unroll
      for (int m = 0; m < M; ++m) {
        x[m].k = last_key<T, DESC>();
        x[m].r = kInvalidRank;
      }
    }
    ++taken;
    PROF(7, t_next);
  }
  // stop the child, then release the rows it gave that were not read, so
  // the edge starts the next span empty
  __device__ void finish(Handshake& hs) {
    if ((threadIdx.x & 31) == 0) hs.stop[c] = 1;
    while (!hs.done[c]) {
    }
    __threadfence_block();
    const uint32_t end = hs.given[c];
    while (q != end) {
      mbar_wait(&f.full[f.slot(q)], f.parity(q));
      release(f.slot(q));
    }
  }
};

// A child's publication of what it gave, once it stops.
__device__ __forceinline__ void give_up(Handshake& hs, int c, uint32_t given) {
  if ((threadIdx.x & 31) == 0) {
    hs.given[c] = given;
    __threadfence_block();
    hs.done[c] = 1;
  }
}

// Heap node h's dataflow over one span: up to `cycles` chunks from sides A
// (left child) and B (right child) at rotations lA, lB, each chunk handed
// to put(t, v), which returns false once the parent wants no more. The
// selector, the butterfly and the window advance are K2 / K3's (csrc/flims_merge.cu), run
// by one warp: the take count k is a ballot sum and every branch on it is
// uniform across the warp. Row rA (rB) of a side is taken once, right after
// the window advances past row rA - 1.
template <typename T, bool KV, bool DESC, int M, class Put>
__device__ void node_stream(Source<T, KV, DESC, M>& A, Source<T, KV, DESC, M>& B, int lA, int lB,
                            int cycles, int w, Put put) {
  const int lane = threadIdx.x & 31;
  Lane<T> a0[M], a1[M], na[M], b0[M], b1[M], nb[M];
  A.next(a0); A.next(a1); A.next(na);
  B.next(b0); B.next(b1); B.next(nb);
  for (int t = 0; t < cycles; ++t) {
    Lane<T> v[M];
    int k = 0;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int i = lane + 32 * m, j = w - 1 - i;
      const Lane<T> ca = pick(i < lA, a1[m], a0[m]);
      const Lane<T> cb = pick(j < lB, b1[m], b0[m]);
      const bool take = (i < w) & wins<T, KV, DESC>(ca, cb);
      v[m] = pick(take, ca, cb);
      k += __popc(__ballot_sync(kFullWarp, take));
    }
    PROF_START(t_bfly);
#ifndef K8_NO_BUTTERFLY
    warp_butterfly_mono<T, KV, DESC, M>(v, w);
#endif
    PROF(5, t_bfly);
    PROF_START(t_put);
    if (!put(t, v)) return;
    PROF(6, t_put);
    int l2 = lA + k;
    if (l2 >= w) {
#pragma unroll
      for (int m = 0; m < M; ++m) { a0[m] = a1[m]; a1[m] = na[m]; }
      lA = l2 - w;
      A.next(na);
    } else {
      lA = l2;
    }
    l2 = lB + (w - k);
    if (l2 >= w) {
#pragma unroll
      for (int m = 0; m < M; ++m) { b0[m] = b1[m]; b1[m] = nb[m]; }
      lB = l2 - w;
      B.next(nb);
    } else {
      lB = l2;
    }
  }
}

// Shared-memory layout, in bytes from the dynamic base: full barriers
// [edge c][slot], empty barriers alike (edges c = 2 .. 2^(L+1) - 1, the heap
// index of the child), then the key rings and, on KV lanes, the rank rings.
__host__ __device__ inline size_t bar_bytes(int L) {
  return ((size_t)2 * (2 << L) * kRingRows * sizeof(uint64_t) + 127) / 128 * 128;
}
__host__ __device__ inline int ring_rows(int L) { return ((2 << L) - 2) * kRingRows; }

size_t stream_smem_bytes(int L, int kv, int key_bytes, int w) {
  return bar_bytes(L) + (size_t)ring_rows(L) * w * (key_bytes + (kv ? 4 : 0));
}

// Grid: persistent CTAs of 2^L warps. Warps 0 .. 2^L - 2 run heap nodes
// 1 .. 2^L - 1 (node h at depth floor(log2 h)); the last warp is the leaf
// producer, lane j feeding leaf j. A CTA takes spans sp = blockIdx.x,
// += gridDim.x, of groups * spg.
template <typename T, bool KV, bool DESC, int L, int M>
__global__ void __launch_bounds__(32 << L)
    stream_merge_kernel(const T* __restrict__ buf, const int32_t* __restrict__ rbuf,
                        T* __restrict__ out, int32_t* __restrict__ out_r, long long n_val,
                        long long n_out, int run_len, int C, int w, int groups, int spg,
                        const int32_t* __restrict__ skip) {
  constexpr int GROUP = 1 << L;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ long long s_off[2 * kMaxGroup];
  __shared__ int s_cnt[kMaxGroup], s_rot[2 * kMaxGroup], s_base[kMaxGroup];
  __shared__ Handshake hs;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // the out_slack trailing sentinels
  for (long long p = n_val + (long long)blockIdx.x * blockDim.x + tid; p < n_out;
       p += (long long)gridDim.x * blockDim.x) {
    out[p] = last_key<T, DESC>();
    if (KV) out_r[p] = kInvalidRank;
  }

  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + (2 << L) * kRingRows;
  T* ring_k = reinterpret_cast<T*>(smem + bar_bytes(L));
  int32_t* ring_r = reinterpret_cast<int32_t*>(ring_k + (size_t)ring_rows(L) * w);
  auto fifo = [&](int c) {
    const size_t o = (size_t)(c - 2) * kRingRows * w;
    return Fifo<T, KV>{ring_k + o, KV ? ring_r + o : nullptr, full + c * kRingRows,
                       empty + c * kRingRows};
  };
  PROF_INIT();
  if (tid < 2 * GROUP && tid >= 2) {
    const Fifo<T, KV> f = fifo(tid);
    for (int s = 0; s < kRingRows; ++s) {
      mbar_init(&f.full[s], 1);
      mbar_init(&f.empty[s], 1);
    }
  }
  mbar_init_fence();
  __syncthreads();

  const long long glen = (long long)GROUP * run_len;
  const int bpg = (int)(glen / C);
  const int h = warp + 1, depth = 31 - __clz(h);
  const bool producer = warp == GROUP - 1;
  // rows taken or given over the CTA's life, per edge this warp touches
  uint32_t q_in[2] = {0, 0}, q_out = 0;

  for (int sp = blockIdx.x; sp < groups * spg; sp += gridDim.x) {
    const int grp = sp / spg, s = sp % spg;
    if (skip && skip[grp]) continue;  // a flagged group: the wide form's
    const int blk0 = (int)((long long)s * bpg / spg), blk1 = (int)((long long)(s + 1) * bpg / spg);
    const long long o = (long long)blk0 * C;
    const int rows = (int)((long long)(blk1 - blk0) * C / w);  // root rows of the span
    const Leaves<T, KV> lv{buf, rbuf, grp * glen, run_len};
    __syncthreads();  // every warp is done with the previous span
    if (tid < 2 * GROUP) {
      hs.stop[tid] = 0;
      hs.done[tid] = 0;
    }
    PROF_START(t_part);
    partition<T, KV, DESC, L>(lv, o, w, s_rot, s_base, s_off, s_cnt);
    PROF(2, t_part);
    PROF_START(t_span);

    // rows leaf j can give: those before its run's end, at most the R + L + 2
    // its depth-(L - 1) parent can take in R + L - 1 cycles
    auto leaf_rows = [&](int j) { return min(rows + L + 2, (run_len - s_base[j]) / w); };
    if (producer) {
      // lane j feeds leaf j until its rows run out or its parent stops it
      const bool mine = lane < GROUP;
      const int j = mine ? lane : 0, c = GROUP + j;
      const Fifo<T, KV> f = fifo(c);
      const int n = mine ? leaf_rows(j) : 0;
      const long long src = lv.leaf0 + (long long)j * run_len + (mine ? s_base[j] : 0);
      const uint32_t bytes = (uint32_t)(w * sizeof(T)), rbytes = (uint32_t)(w * 4);
      int r = 0;
      bool live = mine;
      while (__any_sync(kFullWarp, live)) {
        bool moved = false;
        if (live && (r == n || hs.stop[c])) {
          hs.given[c] = q_out;
          __threadfence_block();
          hs.done[c] = 1;
          live = false;
        } else if (live && mbar_test(&f.empty[f.slot(q_out)], f.parity(q_out) ^ 1u)) {
          const int sl = f.slot(q_out);
          mbar_arrive_tx(&f.full[sl], bytes + (KV ? rbytes : 0));
          bulk_load(f.k + (size_t)sl * w, buf + src + (long long)r * w, bytes, &f.full[sl]);
          if (KV)
            bulk_load(f.r + (size_t)sl * w, rbuf + src + (long long)r * w, rbytes, &f.full[sl]);
          ++q_out;
          ++r;
          moved = true;
        }
        if (!__any_sync(kFullWarp, moved)) __nanosleep(32);
      }
      PROF(4, t_span);
      continue;
    }

    // node h: its two edges, then its output
    Source<T, KV, DESC, M> side[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 2 * h + e;
      side[e] = Source<T, KV, DESC, M>{fifo(c), q_in[e], 0,
                                       c >= GROUP ? leaf_rows(c - GROUP) : rows + depth + 1, w,
                                       c, e == 1};
    }
    const int lA = s_rot[2 * h], lB = s_rot[2 * h + 1];
    if (depth == 0) {
      T* ok = out + grp * glen + o;
      int32_t* orr = KV ? out_r + grp * glen + o : nullptr;
      node_stream<T, KV, DESC, M>(side[0], side[1], lA, lB, rows, w,
                                  [&](int t, const Lane<T>(&v)[M]) {
#pragma unroll
                                    for (int m = 0; m < M; ++m) {
                                      const int i = lane + 32 * m;
                                      if (i < w) {
                                        ok[(long long)t * w + i] = v[m].k;
                                        if (KV) orr[(long long)t * w + i] = v[m].r;
                                      }
                                    }
                                    return true;
                                  });
    } else {
      // a row goes into the parent's ring once a slot is free, unless the
      // parent has stopped this node
      const Fifo<T, KV> f = fifo(h);
      node_stream<T, KV, DESC, M>(side[0], side[1], lA, lB, rows + depth, w,
                                  [&](int, const Lane<T>(&v)[M]) {
                                    const int sl = f.slot(q_out);
                                    const uint32_t par = f.parity(q_out) ^ 1u;
                                    PROF_START(t_slot);
                                    while (true) {
                                      if (__any_sync(kFullWarp, hs.stop[h] != 0)) return false;
                                      if (__all_sync(kFullWarp, mbar_try(&f.empty[sl], par)))
                                        break;
                                    }
                                    PROF(1, t_slot);
                                    T* rk = f.k + (size_t)sl * w;
                                    int32_t* rr = KV ? f.r + (size_t)sl * w : nullptr;
#pragma unroll
                                    for (int m = 0; m < M; ++m) {
                                      const int i = lane + 32 * m;
                                      if (i < w) {
                                        rk[i] = v[m].k;
                                        if (KV) rr[i] = v[m].r;
                                      }
                                    }
                                    __syncwarp();
                                    if (lane == 0) mbar_arrive(&f.full[sl]);
                                    ++q_out;
                                    return true;
                                  });
      give_up(hs, h, q_out);
    }
    PROF(3, t_span);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      side[e].finish(hs);
      q_in[e] = side[e].q;
    }
  }
  PROF_FLUSH();
}

template <typename T, bool KV, bool DESC, int L, int M>
static cudaError_t prepare(size_t smem) {
  return allow_smem(stream_merge_kernel<T, KV, DESC, L, M>, smem);
}

// CTAs of the kernel an SM holds at once.
template <typename T, bool KV, bool DESC, int L, int M>
static cudaError_t occupancy(int w, int* per_sm) {
  const size_t smem = stream_smem_bytes(L, KV, sizeof(T), w);
  cudaError_t e = prepare<T, KV, DESC, L, M>(smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, stream_merge_kernel<T, KV, DESC, L, M>, 32 << L, smem);
}

// flags[g] = 1, and flags[groups] = 1, where group g (keys [g glen, (g + 1)
// glen), runs of run_len) holds a NaN or a lane that its successor in its
// run goes strictly before: the streamed partition and its restarts need
// NaN-free runs in the call's order, and such groups go to the wide form.
// flags zeroed before. Also writes the runs' starts and lens, which the
// wide form reads. run_len = 2^rlog, glen = 2^glog.
template <typename T, bool KV, bool DESC>
__global__ void __launch_bounds__(256)
    stream_check_kernel(const T* __restrict__ keys, const int32_t* __restrict__ ranks,
                        long long n_val, int rlog, int glog, int groups,
                        int32_t* __restrict__ flags, int32_t* __restrict__ starts,
                        int32_t* __restrict__ lens) {
  const long long runs = n_val >> rlog, last = (1LL << rlog) - 1;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n_val;
       e += (long long)gridDim.x * blockDim.x) {
    if (e < runs) {
      starts[e] = (int32_t)(e << rlog);
      lens[e] = 1 << rlog;
    }
    const Lane<T> x{keys[e], KV ? ranks[e] : 0};
    bool bad = x.k != x.k;
    if ((e & last) != last) {  // not its run's last lane
      const Lane<T> y{keys[e + 1], KV ? ranks[e + 1] : 0};
      bad |= wins<T, KV, DESC>(y, x);
    }
    if (bad) {
      if (!flags[e >> glog]) flags[e >> glog] = 1;
      if (!flags[groups]) flags[groups] = 1;
    }
  }
}

template <typename T, bool KV, bool DESC, int L, int M>
static cudaError_t launch(const void* buf, const void* rbuf, void* out, void* out_r,
                          long long n_val, long long n_out, int run_len, int C, int w,
                          int groups, int spg, int grid, int32_t* check, cudaStream_t st) {
  const size_t smem = stream_smem_bytes(L, KV, sizeof(T), w);
  cudaError_t e = prepare<T, KV, DESC, L, M>(smem);
  if (e != cudaSuccess) return e;
  int32_t *flags = check, *starts = flags + groups + 1, *lens = starts + (groups << L);
  e = cudaMemsetAsync(flags, 0, sizeof(int32_t) * (groups + 1), st);
  if (e != cudaSuccess) return e;
  const int rlog = 31 - __builtin_clz(run_len);
  stream_check_kernel<T, KV, DESC><<<1024, 256, 0, st>>>((const T*)buf, (const int32_t*)rbuf,
                                                         n_val, rlog, rlog + L, groups, flags,
                                                         starts, lens);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  stream_merge_kernel<T, KV, DESC, L, M><<<(unsigned)grid, 32 << L, smem, st>>>(
      (const T*)buf, (const int32_t*)rbuf, (T*)out, (int32_t*)out_r, n_val, n_out, run_len, C, w,
      groups, spg, flags);
  return cudaGetLastError();
}

// Shared memory of one CTA: the compiled kernel's static bytes plus the
// dynamic bytes its launch at w requests.
template <typename T, bool KV, bool DESC, int L, int M>
static cudaError_t footprint(int w, long long* bytes) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, stream_merge_kernel<T, KV, DESC, L, M>);
  if (e != cudaSuccess) return e;
  *bytes = (long long)attr.sharedSizeBytes + (long long)stream_smem_bytes(L, KV, sizeof(T), w);
  return cudaSuccess;
}

// The instantiation for (L, w): M = w/32 lanes per thread (1 below 32).
struct Args {
  const void *buf, *rbuf;
  void *out, *out_r;
  long long n_val, n_out;
  int run_len, C, w, groups, spg, grid;
  int32_t* check;      // the check's flags (groups + 1), the runs' starts and lens
  cudaStream_t st;
  int* per_sm;         // set: report occupancy instead of launching
  long long* smem;     // set: report the footprint instead of launching
};

template <typename T, bool KV, bool DESC, int L, int M>
static cudaError_t run(const Args& a) {
  if (a.per_sm) return occupancy<T, KV, DESC, L, M>(a.w, a.per_sm);
  if (a.smem) return footprint<T, KV, DESC, L, M>(a.w, a.smem);
  return launch<T, KV, DESC, L, M>(a.buf, a.rbuf, a.out, a.out_r, a.n_val, a.n_out, a.run_len,
                                   a.C, a.w, a.groups, a.spg, a.grid, a.check, a.st);
}

template <typename T, bool KV, bool DESC, int L>
static cudaError_t by_width(const Args& a) {
  if (a.w <= 32) return run<T, KV, DESC, L, 1>(a);
  if (a.w == 64) return run<T, KV, DESC, L, 2>(a);
  return run<T, KV, DESC, L, 4>(a);
}

template <typename T, bool KV, bool DESC>
static cudaError_t by_level(int L, const Args& a) {
  switch (L) {
    case 1: return by_width<T, KV, DESC, 1>(a);
    case 2: return by_width<T, KV, DESC, 2>(a);
    case 3: return by_width<T, KV, DESC, 3>(a);
    case 4: return by_width<T, KV, DESC, 4>(a);
  }
  return cudaErrorInvalidValue;
}

static cudaError_t dispatch(int dtype, int kv, int desc, int L, const Args& a) {
  if (a.w < 8 || a.w > 128 || (a.w & (a.w - 1)) || L < 1 || L > 4) return cudaErrorInvalidValue;
  if (dtype != kInt32 && dtype != kFloat32) return cudaErrorInvalidValue;
  if (!kv && !desc) return cudaErrorInvalidValue;  // key-only lanes merge descending only
  if (dtype == kInt32) {
    if (!kv) return by_level<int32_t, false, true>(L, a);
    return desc ? by_level<int32_t, true, true>(L, a) : by_level<int32_t, true, false>(L, a);
  }
  if (!kv) return by_level<float, false, true>(L, a);
  return desc ? by_level<float, true, true>(L, a) : by_level<float, true, false>(L, a);
}

}  // namespace flims

// Shared-memory bytes of one CTA of the kernel for (dtype, kv, desc, L, w),
// as compiled and launched, or a negative CUDA error.
extern "C" long long flims_stream_merge_smem(int dtype, int kv, int desc, int L, int w) {
  long long bytes = 0;
  flims::Args a{};
  a.w = w;
  a.smem = &bytes;
  const cudaError_t e = flims::dispatch(dtype, kv, desc, L, a);
  return e == cudaSuccess ? bytes : -(long long)e;
}

// CTAs per SM the kernel for (dtype, kv, desc, L, w) reaches, or a negative
// CUDA error.
extern "C" int flims_stream_merge_occupancy(int dtype, int kv, int desc, int L, int w) {
  int per_sm = 0;
  flims::Args a{};
  a.w = w;
  a.per_sm = &per_sm;
  const cudaError_t e = flims::dispatch(dtype, kv, desc, L, a);
  return e == cudaSuccess ? per_sm : -(int)e;
}

// One pass: `groups` = runs / 2^L groups of C-blocks, `spg` spans per group,
// `grid` persistent CTAs. `check`: groups + 1 + 2 runs int32 of scratch.
// Groups holding a NaN, or a run out of the call's order, are left by the
// streamed kernel and merged by the wide form (csrc/wide_merge.cu, `steps`
// search steps, its meta / tables / scratch / ctas as flims_wide_tree takes
// them at ntot = n_val), on the card: its kernels return at once where no
// group is flagged. The wide form indexes in int32: n_val < 2^31.
extern "C" int flims_wide_tree(int dtype, int kv, int desc, int sel_max, int L, const void* ka,
                               const void* ra, const void* kb, const void* rb, int pairs,
                               const void* starts, const void* lens, int runs, int n_out, int C,
                               int w, int steps, const void* only, void* meta, void* tables,
                               long long ntot, void* scratch, int ctas, void* out, void* out_r,
                               void* stream);
extern "C" int flims_stream_merge(int dtype, int kv, int desc, int L, const void* buf,
                                  const void* rbuf, void* out, void* out_r, long long n_val,
                                  long long n_out, int run_len, int C, int w, int groups,
                                  int spg, int grid, void* check, int steps, void* wmeta,
                                  void* tables, void* wscratch, int wctas, void* stream) {
  const long long glen = (long long)run_len << L;
  if (C < w || C % w || run_len < w || (run_len & (run_len - 1)) || run_len % w || groups <= 0 ||
      glen % C || n_out < n_val || n_val != glen * groups || n_val > 0x7fffffffLL || spg < 1 ||
      spg > glen / C || grid < 1)
    return cudaErrorInvalidValue;
  flims::Args a{buf, rbuf, out, out_r, n_val, n_out, run_len, C, w, groups, spg, grid,
                (int32_t*)check, (cudaStream_t)stream, nullptr, nullptr};
  const int e = flims::dispatch(dtype, kv, desc, L, a);
  if (e != cudaSuccess) return e;
  const int32_t* flags = (const int32_t*)check;
  const int32_t* starts = flags + groups + 1;
  return flims_wide_tree(dtype, kv, desc, 0, L, buf, rbuf, buf, rbuf, 0, starts,
                         starts + (groups << L), groups << L, (int)n_val, C, w, steps, flags,
                         wmeta, tables, L > 1 ? n_val : 0, wscratch, wctas, out, out_r, stream);
}

#ifdef K8_PROFILE
extern "C" int k8_prof_read(void* dst) {
  return cudaMemcpyFromSymbol(dst, k8_prof, sizeof(k8_prof));
}
extern "C" int k8_prof_zero() {
  void* p = nullptr;
  const cudaError_t e = cudaGetSymbolAddress(&p, k8_prof);
  return e != cudaSuccess ? e : cudaMemset(p, 0, sizeof(k8_prof));
}
#endif
