// K4: L fused levels of the FLiMS merge tree over groups of 2^L ragged
// sorted runs, as a persistent streaming merge tree.
//
// Replaces `_merge_tree_call` (src/repro/kernels/merge_tree.py:319; body
// `tree_dataflow` :178, nested co-rank `_tree_meta_one` :144) behind
// `merge_tree_runs` / `merge_tree_runs_kv`. Leaf j of group `grp` is the run
// buf[starts[g] : starts[g] + lens[g]], g = grp * 2^L + j, read in place at
// any offset; group `grp` writes out[goff[grp] :], its output cut into
// C-wide blocks (blk0[grp] is the group's first block in the flat block
// order) and clipped at n_out.
//
// What bounds it on this card. Bytes: each element is read once and written
// once per pass (0.04 ms key-only at 2^24 keys, 3.35 TB/s). But a FLiMS node
// is a chain, cycle t + 1 needing cycle t's take count, of a few hundred
// instructions a w-row, and 2^L - 1 nodes run per output row, so the kernel
// is latency-bound unless many node chains are in flight. The first version,
// one CTA per (group, block) running the nodes one after another, spent most
// of a CTA's clocks in the butterfly and its shared-memory stages (five CTA
// barriers a w-row at w 128), whole-block inner-node slots (34 KB key-only,
// 68 KB KV at C 4096) held few CTAs on an SM, and every block re-ran the
// nested co-rank partition: over half the clocks of engine.sort's last pass.
//
// The design, K8's streaming tree (csrc/stream_merge.cu) on ragged runs.
// - Persistent CTAs over spans. The grid is at most what the card holds at
//   once (the wrapper's `ctas`). CTA c takes the flat blocks
//   [c G / grid, (c + 1) G / grid), G = blk0[n_groups] read on the card (no
//   host sync), cut into spans at group boundaries; groups with no block are
//   passed over. The partition runs once at a span's first block and the
//   tree streams to the span's end. That is the per-block kernel bit for bit:
//   a node's state after t chunks is a function of the co-ranks of t w under
//   the partition's order alone, so the stream meets each block boundary in
//   the state a restart computes (K8's header has the argument).
// - One warp per tree node, synchronous within the warp only: thread t holds
//   lanes t, t + 32, ...; butterfly stages >= 32 in registers, < 32 by
//   shuffle; every compare a select; the take count a sum of ballots.
// - FIFOs in shared memory between nodes, kRingRows rows an edge, each slot
//   with a full and an empty mbarrier, and K8's per-edge stop handshake. The
//   footprint does not depend on C (`flims_merge_tree_smem` reads it from
//   the compiled kernel).
// - Leaves from a producer warp, which serves the 2^L leaf edges in turn. A
//   whole row whose source is 16-byte aligned goes by cp.async.bulk; any
//   other row (a run starting off 16 bytes, a run's partial last row) by
//   4-byte cp.async, lanes past the run's end not copied. Both complete on
//   the slot's full mbarrier. The parent reads positions at or past a run's
//   end as the fill lane (last key, INVALID_RANK), and fences its reads of
//   a slot (fence.proxy.async) before freeing it for the next copy.
// - The root writes straight to HBM, coalesced, clipped at the group's end
//   and at n_out.
//
// The partition. The order of the nested merges is (key, with rank on KV
// lanes; leaf DESCENDING, since ties go to the right child at every level;
// position). The co-ranks of `_tree_meta_one` are per-leaf counts under it:
// a node's split is the sum of its left leaves' counts of its top-a.
// - Depth 0: the count of leaf j among the group's top-o is the largest p
//   whose element p - 1 ranks below o; its rank is p - 1 plus, per other
//   leaf, the count of that leaf's elements preceding it. Warp j searches
//   p 33-ary; each probe counts the other leaves by binary searches whose
//   ranges shrink with p's: a probe between two earlier ones has each count
//   between theirs.
// - Depth d >= 1: a node's top-a' (a' = s - s % w, s its count at its
//   parent) is its top-s less the last r = s % w of those, which lie among
//   the last min(r, count) elements of each of its leaves' counts. Each warp
//   loads those few into shared memory (one round of loads), counts for each
//   how many of the others follow it, and drops the r last.
// A span at offset 0 of its group needs no search: every count is 0.
#include <type_traits>

#include "flims.cuh"

// Clock counters for scripts/k4_profile.py, compiled in only under
// -DK4_PROFILE: per warp, summed in shared memory and written to
// k4_prof[cta][warp][counter] at the kernel's end, for the first
// K4_PROF_CTAS CTAs. Without the define every PROF* macro is empty.
#ifdef K4_PROFILE
#ifndef K4_PROF_CTAS
#define K4_PROF_CTAS 4096
#endif
constexpr int kProfCounters = 12;
constexpr int kProfWarps = 8;
__device__ unsigned long long k4_prof[K4_PROF_CTAS * kProfWarps * kProfCounters];
// per CTA: globaltimer (ns) at its start and end, and its SM
__device__ unsigned long long k4_when[K4_PROF_CTAS * 3];
__shared__ unsigned long long s_prof[kProfWarps][kProfCounters];
// full_wait (a child's row), empty_wait (a free slot in the parent's ring),
// partition, node_total (the spans' dataflows), prod_total (the producer's
// loops), bfly, put (the root's stores, or a ring write with its wait), next
// (taking a row, its wait included), finish (the end-of-span handshake and
// drain), setup (finding the span, its barrier and leaf table), total (the
// warp's whole run), spans (count)
extern "C" const char* k4_prof_names() {
  return "full_wait,empty_wait,partition,node_total,prod_total,bfly,put,next,finish,setup,"
         "total,spans";
}
__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned smid() {
  unsigned s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  return s;
}
#define PROF_START(t) const long long t = clock64()
#define PROF(k, t)                                                            \
  do {                                                                        \
    if ((threadIdx.x & 31) == 0) s_prof[threadIdx.x >> 5][k] += clock64() - (t); \
  } while (0)
#define PROF_COUNT(k)                                                         \
  do {                                                                        \
    if ((threadIdx.x & 31) == 0) s_prof[threadIdx.x >> 5][k] += 1;            \
  } while (0)
#define PROF_INIT()                                                           \
  do {                                                                        \
    if (threadIdx.x == 0 && blockIdx.x < K4_PROF_CTAS) {                      \
      k4_when[blockIdx.x * 3] = globaltimer();                                \
      k4_when[blockIdx.x * 3 + 2] = smid();                                   \
    }                                                                         \
    for (int i_ = threadIdx.x; i_ < kProfWarps * kProfCounters; i_ += blockDim.x) \
      s_prof[i_ / kProfCounters][i_ % kProfCounters] = 0;                     \
  } while (0)
#define PROF_FLUSH()                                                          \
  do {                                                                        \
    if ((threadIdx.x & 31) == 0 && blockIdx.x < K4_PROF_CTAS)                 \
      for (int k_ = 0; k_ < kProfCounters; ++k_)                              \
        k4_prof[((size_t)blockIdx.x * kProfWarps + (threadIdx.x >> 5)) * kProfCounters + k_] = \
            s_prof[threadIdx.x >> 5][k_];                                     \
    __syncthreads();                                                          \
    if (threadIdx.x == 0 && blockIdx.x < K4_PROF_CTAS)                        \
      k4_when[blockIdx.x * 3 + 1] = globaltimer();                            \
  } while (0)
#else
#define PROF_START(t)
#define PROF(k, t) do { } while (0)
#define PROF_COUNT(k) do { } while (0)
#define PROF_INIT() do { } while (0)
#define PROF_FLUSH() do { } while (0)
#endif

namespace flims {

constexpr int kMaxGroup = 8;  // 2^MAX_LEVELS leaves
// Rows per FIFO ring, inner-node and leaf edges alike.
constexpr int kRingRows = 4;

// Key-only float lanes travel the tree as monotone int32 bit patterns (the
// sign bit flips the other 31: integer order is float order with -0 below
// +0), kept in float registers. XLA's max / min, which the key-only
// butterfly applies, are then one integer instruction each (its +0 / -0
// rule is that order), where the float form takes a dozen selects. The
// selection keeps the float order (+0 and -0 tie). A node that has read a
// row holding a NaN runs the float selection and butterfly from then on.
template <typename T, bool KV>
constexpr bool kMono = !KV && std::is_same<T, float>::value;
// float bits <-> monotone bits (its own inverse)
__device__ __forceinline__ float mono_flip(float x) {
  const int32_t b = __float_as_int(x);
  return __int_as_float(b ^ ((b >> 31) & 0x7fffffff));
}
__device__ __forceinline__ bool mono_nan(float x) {
  const int32_t m = __float_as_int(x);
  return (m > 0x7f800000) | (m < (int32_t)0x807fffff);
}
// the float `x > y` of two NaN-free monotone patterns
__device__ __forceinline__ bool mono_wins(float x, float y) {
  const int32_t a = __float_as_int(x), b = __float_as_int(y);
  return (a > b) & !((a == 0) & (b == -1));
}

// The group's leaves, read in place: element p of leaf j.
template <typename T, bool KV> struct Leaves {
  const T* k;
  const int32_t* r;
  const int* start;  // per leaf, in shared memory
  const int* len;
  __device__ Lane<T> at(int j, int p) const {
    const long long q = (long long)start[j] + p;
    Lane<T> v;
    v.k = k[q];
    v.r = KV ? r[q] : 0;
    return v;
  }
};

// "y precedes x" in the tree's order, y of leaf jj, x of leaf j != jj: a
// leaf right of j precedes x on ties, one left of it does not.
template <typename T, bool KV, bool DESC>
__device__ __forceinline__ bool precedes(const Lane<T>& y, int jj, const Lane<T>& x, int j) {
  return jj > j ? !wins<T, KV, DESC>(x, y) : wins<T, KV, DESC>(y, x);
}

// Sum over the other leaves jj of the count of their elements preceding x
// (an element of leaf j), each count searched in [lo[jj], hi[jj]] (0, 0 for
// j itself); cnt[jj] gets each count. The searches advance together.
template <typename T, bool KV, bool DESC, int GROUP>
__device__ long long count_before(const Leaves<T, KV>& lv, int j, const Lane<T>& x,
                                  const int (&lo)[GROUP], const int (&hi)[GROUP],
                                  int (&cnt)[GROUP]) {
  int b[GROUP], width = 0;
#pragma unroll
  for (int jj = 0; jj < GROUP; ++jj) {
    cnt[jj] = lo[jj];
    b[jj] = hi[jj];
    width = max(width, hi[jj] - lo[jj]);
  }
  const int steps = 32 - __clz(width);
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int jj = 0; jj < GROUP; ++jj) {
      if (cnt[jj] < b[jj]) {
        const int m = (cnt[jj] + b[jj] + 1) >> 1;
        if (precedes<T, KV, DESC>(lv.at(jj, m - 1), jj, x, j)) cnt[jj] = m; else b[jj] = m - 1;
      }
    }
  }
  long long sum = 0;
#pragma unroll
  for (int jj = 0; jj < GROUP; ++jj) sum += cnt[jj];
  return sum;
}

// The count of leaf j (warp j) among the group's top-o: the largest p in
// [0, min(o, len j)] whose element p - 1 ranks below o. 33-ary over p, the
// other leaves' counts searched between those of the bracketing probes.
template <typename T, bool KV, bool DESC, int GROUP>
__device__ int root_count(const Leaves<T, KV>& lv, int j, long long o) {
  const int lane = threadIdx.x & 31;
  int blo[GROUP], bhi[GROUP];
#pragma unroll
  for (int jj = 0; jj < GROUP; ++jj) {
    blo[jj] = 0;
    bhi[jj] = jj == j ? 0 : (int)min(o, (long long)lv.len[jj]);
  }
  long long lo = 0, hi = min(o, (long long)lv.len[j]);
  while (lo < hi) {  // uniform across the warp
    const long long width = hi - lo;
    auto cand = [&](long long v) { return lo + 1 + (v * width) / 32; };
    const long long p = cand(lane);
    int cnt[GROUP];
    const long long rank =
        (p - 1) + count_before<T, KV, DESC, GROUP>(lv, j, lv.at(j, (int)(p - 1)), blo, bhi, cnt);
    const int n_ok = __popc(__ballot_sync(kFullWarp, rank < o));
    if (n_ok == 0) break;
#pragma unroll
    for (int jj = 0; jj < GROUP; ++jj) {
      const int l = __shfl_sync(kFullWarp, cnt[jj], n_ok - 1);
      const int h = __shfl_sync(kFullWarp, cnt[jj], n_ok & 31);
      blo[jj] = l;
      if (n_ok < 32) bhi[jj] = h;
    }
    const long long nlo = cand(n_ok - 1);
    hi = n_ok < 32 ? cand(n_ok) - 1 : hi;
    lo = nlo;
  }
  return (int)lo;
}

// The nested partition of one span at group offset o (all threads call it):
// per internal node (heap index h, root 1, children 2h and 2h + 1) the
// (left, right) initial rotations rot[2h], rot[2h + 1], and per leaf its
// aligned start base[j]. `off` holds each node's aligned offset, `cnt` the
// leaves' counts at the current depth, win_k / win_r w lanes per leaf.
template <typename T, bool KV, bool DESC, int L>
__device__ void partition(const Leaves<T, KV>& lv, long long o, int w, int* rot, int* base,
                          long long* off, int* cnt, T* win_k, int32_t* win_r) {
  constexpr int GROUP = 1 << L;
  const int t = threadIdx.x, j = t >> 5, lane = t & 31;
  int mine = root_count<T, KV, DESC, GROUP>(lv, j, o);
  if (t == 0) off[1] = o;
  for (int d = 0; d < L; ++d) {
    const int span = GROUP >> d, first = (j / span) * span;
    if (d > 0) {
      // drop the last r of the node's top-s: they lie among the last
      // min(r, cnt) of each leaf's counted elements
      long long s = 0;
      for (int jj = first; jj < first + span; ++jj) s += cnt[jj];
      const int r = (int)(s - off[(1 << d) + j / span]);
      const int q = min(r, mine);
      T* wk = win_k + (size_t)j * w;
      int32_t* wr = KV ? win_r + (size_t)j * w : nullptr;
      for (int i = lane; i < q; i += 32) {
        const Lane<T> x = lv.at(j, mine - q + i);
        wk[i] = x.k;
        if (KV) wr[i] = x.r;
      }
      __syncthreads();
      int dropped = 0;
      for (int i0 = 0; i0 < q; i0 += 32) {
        const int i = i0 + lane;
        bool last = false;
        if (i < q) {
          Lane<T> x;
          x.k = wk[i];
          x.r = KV ? wr[i] : 0;
          int after = q - 1 - i;  // its own leaf's, then each other leaf's
          for (int jj = first; jj < first + span; ++jj) {
            if (jj == j) continue;
            const int qq = min(r, cnt[jj]);
            const T* yk = win_k + (size_t)jj * w;
            const int32_t* yr = KV ? win_r + (size_t)jj * w : nullptr;
            int a = 0, b = qq;  // window elements preceding x: a prefix
            while (a < b) {
              const int m = (a + b + 1) >> 1;
              Lane<T> y;
              y.k = yk[m - 1];
              y.r = KV ? yr[m - 1] : 0;
              if (precedes<T, KV, DESC>(y, jj, x, j)) a = m; else b = m - 1;
            }
            after += qq - a;
          }
          last = after < r;
        }
        dropped += __popc(__ballot_sync(kFullWarp, last));
      }
      mine -= dropped;
      __syncthreads();  // every warp has read cnt and the windows
    }
    if (lane == 0) cnt[j] = mine;
    __syncthreads();
    if (t < (1 << d)) {  // one thread per node of this depth
      const int h = (1 << d) + t, lo = t * span, mid = lo + span / 2;
      long long sx = 0;
      for (int jj = lo; jj < mid; ++jj) sx += cnt[jj];
      const long long sy = off[h] - sx;
      rot[2 * h] = (int)(sx % w);
      rot[2 * h + 1] = (int)(sy % w);
      if (span == 2) {
        base[lo] = (int)(sx - sx % w);
        base[lo + 1] = (int)(sy - sy % w);
      } else {
        off[2 * h] = sx - sx % w;
        off[2 * h + 1] = sy - sy % w;
      }
    }
    __syncthreads();
  }
}

// Per-edge stop handshake (edge c = the child's heap index), as K8's: when a
// parent has taken its last row it sets stop[c]; the child then gives no
// more rows, publishes how many it gave over the CTA's life in given[c] and
// sets done[c]; the parent releases the rows it did not read.
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
// `taken` of this span comes from the ring if below `limit` (a child's
// R + d + 1 rows, a leaf's rows before its run's end) and is the fill lane
// (last key, INVALID_RANK) otherwise; so are its positions from `avail` on
// (a leaf's run end). `rev` reads column w-1-i into lane i (side B). On
// monotone lanes (kMono) a leaf's keys are flipped as they are read, and
// `nan` records a NaN in any row read.
template <typename T, bool KV, bool DESC, int M> struct Source {
  Fifo<T, KV> f;
  uint32_t q;  // rows taken from the ring over the CTA's life
  int taken, limit;
  long long avail;
  int w, c;
  bool rev, leaf, nan;
  __device__ void release(int s) {
    if (leaf) fence_proxy_async();  // a leaf slot is refilled by a bulk copy
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&f.empty[s]);
    ++q;
  }
  __device__ void next(Lane<T> (&x)[M]) {
    constexpr bool mono = kMono<T, KV>;
    const int lane = threadIdx.x & 31;
    T fill = last_key<T, DESC>();
    if constexpr (mono) fill = mono_flip(fill);
    PROF_START(t_next);
    if (taken < limit) {
      const int s = f.slot(q);
      PROF_START(t_wait);
      mbar_wait(&f.full[s], f.parity(q));
      PROF(0, t_wait);
      const T* rk = f.k + (size_t)s * w;
      const int32_t* rr = KV ? f.r + (size_t)s * w : nullptr;
      const long long p0 = (long long)taken * w;
      bool bad = false;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int i = lane + 32 * m, col = rev ? w - 1 - i : i;
        if (i < w) {
          const bool real = p0 + col < avail;
          x[m].k = real ? rk[col] : fill;
          x[m].r = real ? (KV ? rr[col] : 0) : kInvalidRank;
          if constexpr (mono) {
            if (leaf && real) x[m].k = mono_flip(x[m].k);
            bad |= mono_nan(x[m].k);
          }
        }
      }
      if constexpr (mono) nan |= __any_sync(kFullWarp, bad);
      release(s);
    } else {
#pragma unroll
      for (int m = 0; m < M; ++m) {
        x[m].k = fill;
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
// uniform across the warp. A side's next row is taken when the window
// advances onto it, so a node starts on two rows a side.
template <typename T, bool KV, bool DESC, int M, class Put>
__device__ void node_stream(Source<T, KV, DESC, M>& A, Source<T, KV, DESC, M>& B, int lA, int lB,
                            int cycles, int w, Put put) {
  constexpr bool mono = kMono<T, KV>;
  const int lane = threadIdx.x & 31;
  Lane<T> a0[M], a1[M], b0[M], b1[M];
  A.next(a0); A.next(a1);
  B.next(b0); B.next(b1);
  for (int t = 0; t < cycles; ++t) {
    const bool slow = mono && (A.nan | B.nan);  // uniform across the warp
    Lane<T> v[M];
    int k = 0;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int i = lane + 32 * m, j = w - 1 - i;
      const Lane<T> ca = pick(i < lA, a1[m], a0[m]);
      const Lane<T> cb = pick(j < lB, b1[m], b0[m]);
      bool win;
      if constexpr (mono)
        win = slow ? mono_flip(ca.k) > mono_flip(cb.k) : mono_wins(ca.k, cb.k);
      else
        win = wins<T, KV, DESC>(ca, cb);
      const bool take = (i < w) & win;
      v[m] = pick(take, ca, cb);
      k += __popc(__ballot_sync(kFullWarp, take));
    }
    PROF_START(t_bfly);
    if constexpr (mono) {
      if (slow) {
#pragma unroll
        for (int m = 0; m < M; ++m) v[m].k = mono_flip(v[m].k);
        warp_butterfly<T, KV, DESC, M>(v, w);
#pragma unroll
        for (int m = 0; m < M; ++m) v[m].k = mono_flip(v[m].k);
      } else {
        Lane<int32_t> u[M];
#pragma unroll
        for (int m = 0; m < M; ++m) u[m] = Lane<int32_t>{__float_as_int(v[m].k), 0};
        warp_butterfly<int32_t, false, true, M>(u, w);
#pragma unroll
        for (int m = 0; m < M; ++m) v[m].k = __int_as_float(u[m].k);
      }
    } else {
      warp_butterfly<T, KV, DESC, M>(v, w);
    }
    PROF(5, t_bfly);
    PROF_START(t_put);
    if (!put(t, v)) return;
    PROF(6, t_put);
    int l2 = lA + k;
    if (l2 >= w) {
#pragma unroll
      for (int m = 0; m < M; ++m) a0[m] = a1[m];
      lA = l2 - w;
      A.next(a1);
    } else {
      lA = l2;
    }
    l2 = lB + (w - k);
    if (l2 >= w) {
#pragma unroll
      for (int m = 0; m < M; ++m) b0[m] = b1[m];
      lB = l2 - w;
      B.next(b1);
    } else {
      lB = l2;
    }
  }
}

// Shared-memory layout, in bytes from the dynamic base: full barriers
// [edge c][slot], empty barriers alike (edges c = 2 .. 2^(L+1) - 1, the heap
// index of the child), then the key rings and, on KV lanes, the rank rings,
// then the partition's windows (w keys, and ranks, per leaf).
__host__ __device__ inline size_t bar_bytes(int L) {
  return ((size_t)2 * (2 << L) * kRingRows * sizeof(uint64_t) + 127) / 128 * 128;
}
__host__ __device__ inline int ring_rows(int L) { return ((2 << L) - 2) * kRingRows; }

size_t tree_smem_bytes(int L, int kv, int key_bytes, int w) {
  const size_t lane = key_bytes + (kv ? 4 : 0);
  return bar_bytes(L) + (size_t)(ring_rows(L) + (1 << L)) * w * lane;
}

// The pass's group table, n_groups + 1 entries each: goff, the exclusive
// prefix sums of the groups' lengths, and blk0, those of their C-block
// counts. One CTA: each thread sums a stretch of groups, a scan runs over
// the threads, each thread writes its stretch. (Done on the host, these
// were a dozen small launches a pass.)
constexpr int kOffsetThreads = 1024;
__global__ void __launch_bounds__(kOffsetThreads)
    tree_offsets_kernel(const int32_t* __restrict__ lens, int group, int n_groups, int C,
                        int32_t* __restrict__ goff, int32_t* __restrict__ blk0) {
  __shared__ int s_len[kOffsetThreads], s_blk[kOffsetThreads];
  const int t = threadIdx.x;
  const int per = (n_groups + kOffsetThreads - 1) / kOffsetThreads;
  const int g0 = min(n_groups, t * per), g1 = min(n_groups, g0 + per);
  auto glen = [&](int g) {
    int l = 0;
    for (int j = 0; j < group; ++j) l += lens[(long long)g * group + j];
    return l;
  };
  auto blocks = [&](int l) { return (int)(((long long)l + C - 1) / C); };
  int sl = 0, sb = 0;
  for (int g = g0; g < g1; ++g) {
    const int l = glen(g);
    sl += l;
    sb += blocks(l);
  }
  s_len[t] = sl;
  s_blk[t] = sb;
  __syncthreads();
  for (int d = 1; d < kOffsetThreads; d <<= 1) {
    const int a = t >= d ? s_len[t - d] : 0, b = t >= d ? s_blk[t - d] : 0;
    __syncthreads();
    s_len[t] += a;
    s_blk[t] += b;
    __syncthreads();
  }
  int ol = s_len[t] - sl, ob = s_blk[t] - sb;
  for (int g = g0; g < g1; ++g) {
    goff[g] = ol;
    blk0[g] = ob;
    const int l = glen(g);
    ol += l;
    ob += blocks(l);
  }
  if (t == kOffsetThreads - 1) {
    goff[n_groups] = s_len[t];
    blk0[n_groups] = s_blk[t];
  }
}

// flags[g] = 1, and flags[n_groups] = 1, where a run of group g (keys
// [starts[r] :+ lens[r]], goff the groups' exclusive length prefix) holds
// a NaN or a lane that its successor goes strictly before: the streamed
// partition and its restarts need NaN-free runs in the call's order, and
// such groups go to the wide form (the JAX kernel's per-block partition).
// flags zeroed before. A CTA a tile of the groups' concatenation, a thread
// a lane, read coalesced: its group by a search of goff bounded by the
// tile's, its run by a walk of the group's lens.
constexpr int kCheckThreads = 256, kCheckTile = 4096;
template <typename T, bool KV, bool DESC>
__global__ void __launch_bounds__(kCheckThreads)
    group_check_kernel(const T* __restrict__ keys, const int32_t* __restrict__ ranks,
                       const int32_t* __restrict__ starts, const int32_t* __restrict__ lens,
                       const int32_t* __restrict__ goff, int n_groups, int group,
                       int32_t* __restrict__ flags) {
  const int total = goff[n_groups];
  for (long long e0 = (long long)blockIdx.x * kCheckTile; e0 < total;
       e0 += (long long)gridDim.x * kCheckTile) {
    const int e1 = (int)min((long long)total, e0 + kCheckTile);
    const int g0 = find_segment(goff, n_groups, (int)e0), g1 = find_segment(goff, n_groups, e1 - 1);
#pragma unroll 4
    for (int e = (int)e0 + threadIdx.x; e < e1; e += kCheckThreads) {
      int lo = g0, hi = g1;  // the last group with goff <= e: the one holding e
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (goff[mid] <= e) lo = mid; else hi = mid - 1;
      }
      int r = lo * group, p = e - goff[lo];
      while (p >= lens[r]) p -= lens[r++];  // the run holding e
      const T* k = keys + starts[r];
      const Lane<T> x{k[p], KV ? ranks[starts[r] + p] : 0};
      bool bad = x.k != x.k;
      if (p + 1 < lens[r]) {
        const Lane<T> y{k[p + 1], KV ? ranks[starts[r] + p + 1] : 0};
        bad |= wins<T, KV, DESC>(y, x);
      }
      if (bad) {
        if (!flags[lo]) flags[lo] = 1;
        if (!flags[n_groups]) flags[n_groups] = 1;
      }
    }
  }
}

// Grid: persistent CTAs of 2^L warps. Warps 0 .. 2^L - 2 run heap nodes
// 1 .. 2^L - 1 (node h at depth floor(log2 h)); the last warp is the leaf
// producer. CTA c takes flat blocks [c G / grid, (c + 1) G / grid), as one
// span per group they touch.
template <typename T, bool KV, bool DESC, int L, int M>
__global__ void __launch_bounds__(32 << L)
    merge_tree_kernel(const T* __restrict__ buf, const int32_t* __restrict__ rbuf,
                      const int32_t* __restrict__ starts, const int32_t* __restrict__ lens,
                      const int32_t* __restrict__ goff, const int32_t* __restrict__ blk0,
                      T* __restrict__ out, int32_t* __restrict__ out_r, int n_groups, int n_out,
                      int C, int w, const int32_t* __restrict__ skip) {
  constexpr int GROUP = 1 << L;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ long long s_off[2 * kMaxGroup];
  __shared__ int s_cnt[kMaxGroup], s_rot[2 * kMaxGroup], s_base[kMaxGroup];
  __shared__ int s_start[kMaxGroup], s_len[kMaxGroup];
  __shared__ Handshake hs;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + (2 << L) * kRingRows;
  T* ring_k = reinterpret_cast<T*>(smem + bar_bytes(L));
  int32_t* ring_r = reinterpret_cast<int32_t*>(ring_k + (size_t)ring_rows(L) * w);
  T* win_k = KV ? reinterpret_cast<T*>(ring_r + (size_t)ring_rows(L) * w)
                : ring_k + (size_t)ring_rows(L) * w;
  int32_t* win_r = reinterpret_cast<int32_t*>(win_k + (size_t)GROUP * w);
  auto fifo = [&](int c) {
    const size_t o = (size_t)(c - 2) * kRingRows * w;
    return Fifo<T, KV>{ring_k + o, KV ? ring_r + o : nullptr, full + c * kRingRows,
                       empty + c * kRingRows};
  };
  PROF_INIT();
  PROF_START(t_total);
  if (tid < 2 * GROUP && tid >= 2) {
    const Fifo<T, KV> f = fifo(tid);
    for (int s = 0; s < kRingRows; ++s) {
      // a leaf row completes on its 32 producer lanes' arrivals
      mbar_init(&f.full[s], tid >= GROUP ? 32 : 1);
      mbar_init(&f.empty[s], 1);
    }
  }
  mbar_init_fence();
  __syncthreads();

  const int h = warp + 1, depth = 31 - __clz(h);
  const bool producer = warp == GROUP - 1;
  // rows taken or given over the CTA's life, per edge this warp touches
  uint32_t q_in[2] = {0, 0}, q_out = 0, q_leaf[GROUP];
#pragma unroll
  for (int j = 0; j < GROUP; ++j) q_leaf[j] = 0;

  const long long G = blk0[n_groups];
  long long b = (long long)blockIdx.x * G / gridDim.x;
  const long long b_end = (long long)(blockIdx.x + 1) * G / gridDim.x;
  while (b < b_end) {
    PROF_START(t_setup);
    const int grp = find_segment(blk0, n_groups + 1, (int)b);
    const long long g0 = blk0[grp], g1 = min(b_end, (long long)blk0[grp + 1]);
    const long long o = (b - g0) * C;
    const long long gbase = goff[grp];
    const long long o_end = min(min((g1 - g0) * C, (long long)goff[grp + 1] - gbase),
                                (long long)n_out - gbase);
    b = g1;
    if (o_end <= o) continue;  // past n_out
    if (skip && skip[grp]) continue;  // a flagged group: the wide form's
    const int rows = (int)((o_end - o + w - 1) / w);  // root rows of the span
    __syncthreads();  // every warp is done with the previous span
    if (tid < 2 * GROUP) {
      hs.stop[tid] = 0;
      hs.done[tid] = 0;
    }
    if (tid < GROUP) {
      s_start[tid] = starts[(long long)grp * GROUP + tid];
      s_len[tid] = lens[(long long)grp * GROUP + tid];
    }
    const Leaves<T, KV> lv{buf, rbuf, s_start, s_len};
    PROF(9, t_setup);
    PROF_COUNT(11);
    PROF_START(t_part);
    if (o == 0) {
      if (tid < 2 * GROUP) s_rot[tid] = 0;
      if (tid < GROUP) s_base[tid] = 0;
      __syncthreads();
    } else {
      __syncthreads();
      partition<T, KV, DESC, L>(lv, o, w, s_rot, s_base, s_off, s_cnt, win_k, win_r);
    }
    PROF(2, t_part);
    PROF_START(t_span);

    // rows leaf j can give: those before its run's end, at most R + L + 2
    // (its depth-(L - 1) parent takes two rows, then at most one a cycle for
    // R + L - 1 cycles)
    auto avail = [&](int j) { return (long long)s_len[j] - s_base[j]; };
    auto leaf_rows = [&](int j) {
      return (int)min((long long)rows + L + 2, (avail(j) + w - 1) / w);
    };
    if (producer) {
      // the warp serves leaf j's edge in turn while its rows last and its
      // parent has not stopped it; a full ring blocks no other leaf
      const uint32_t bytes = (uint32_t)(w * sizeof(T)), rbytes = (uint32_t)(w * 4);
      int r[GROUP];
      bool live[GROUP];
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {
        r[j] = 0;
        live[j] = true;
      }
      bool any = true;
      unsigned nap = 32;  // ns; doubles while no ring has room
      while (any) {
        any = false;
        bool moved = false;
#pragma unroll
        for (int j = 0; j < GROUP; ++j) {
          if (!live[j]) continue;
          const int c = GROUP + j;
          const Fifo<T, KV> f = fifo(c);
          const int stop = __shfl_sync(kFullWarp, hs.stop[c], 0);
          if (r[j] == leaf_rows(j) || stop) {
            if (lane == 0) {
              hs.given[c] = q_leaf[j];
              __threadfence_block();
              hs.done[c] = 1;
            }
            live[j] = false;
            continue;
          }
          any = true;
          // every lane acquires the slot itself: on the cp.async path each
          // lane writes it
          const int sl = f.slot(q_leaf[j]);
          if (!__all_sync(kFullWarp, mbar_test(&f.empty[sl], f.parity(q_leaf[j]) ^ 1u)))
            continue;
          const long long p0 = (long long)r[j] * w, src = (long long)s_start[j] + s_base[j] + p0;
          const bool aligned = !(reinterpret_cast<uintptr_t>(buf + src) & 15) &&
                               (!KV || !(reinterpret_cast<uintptr_t>(rbuf + src) & 15));
          T* dk = f.k + (size_t)sl * w;
          int32_t* dr = KV ? f.r + (size_t)sl * w : nullptr;
          if (aligned && p0 + w <= avail(j)) {
            if (lane == 0) {
              mbar_arrive_tx(&f.full[sl], bytes + (KV ? rbytes : 0));
              bulk_load(dk, buf + src, bytes, &f.full[sl]);
              if (KV) bulk_load(dr, rbuf + src, rbytes, &f.full[sl]);
            } else {
              mbar_arrive(&f.full[sl]);
            }
          } else {
            for (int i = lane; i < w && p0 + i < avail(j); i += 32) {
              cp_async4(dk + i, buf + src + i);
              if (KV) cp_async4(dr + i, rbuf + src + i);
            }
            cp_async_arrive(&f.full[sl]);
          }
          ++q_leaf[j];
          ++r[j];
          moved = true;
        }
        if (moved) {
          nap = 32;
        } else if (any) {
          __nanosleep(nap);
          nap = min(2 * nap, 512u);
        }
      }
      PROF(4, t_span);
      continue;
    }

    // node h: its two edges, then its output
    Source<T, KV, DESC, M> side[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 2 * h + e;
      const bool leaf = c >= GROUP;
      const int limit = leaf ? leaf_rows(c - GROUP) : rows + depth + 1;
      side[e] = Source<T, KV, DESC, M>{fifo(c), q_in[e], 0, limit,
                                       leaf ? avail(c - GROUP) : (long long)limit * w, w, c,
                                       e == 1, leaf, false};
    }
    const int lA = s_rot[2 * h], lB = s_rot[2 * h + 1];
    if (depth == 0) {
      T* ok = out + gbase + o;
      int32_t* orr = KV ? out_r + gbase + o : nullptr;
      const long long valid = o_end - o;
      node_stream<T, KV, DESC, M>(side[0], side[1], lA, lB, rows, w,
                                  [&](int t, const Lane<T>(&v)[M]) {
#pragma unroll
                                    for (int m = 0; m < M; ++m) {
                                      const int i = lane + 32 * m;
                                      const long long p = (long long)t * w + i;
                                      if (i < w && p < valid) {
                                        T key = v[m].k;
                                        if constexpr (kMono<T, KV>) key = mono_flip(key);
                                        ok[p] = key;
                                        if (KV) orr[p] = v[m].r;
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
    PROF_START(t_fin);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      side[e].finish(hs);
      q_in[e] = side[e].q;
    }
    PROF(8, t_fin);
  }
  PROF(10, t_total);
  PROF_FLUSH();
}

template <typename T, bool KV, bool DESC, int L, int M>
static cudaError_t prepare(size_t smem) {
  return allow_smem(merge_tree_kernel<T, KV, DESC, L, M>, smem);
}

// CTAs of the kernel an SM holds at once.
template <typename T, bool KV, bool DESC, int L, int M>
static cudaError_t occupancy(int w, int* per_sm) {
  const size_t smem = tree_smem_bytes(L, KV, sizeof(T), w);
  cudaError_t e = prepare<T, KV, DESC, L, M>(smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, merge_tree_kernel<T, KV, DESC, L, M>, 32 << L, smem);
}

// Shared memory of one CTA: the compiled kernel's static bytes plus the
// dynamic bytes its launch at w requests.
template <typename T, bool KV, bool DESC, int L, int M>
static cudaError_t footprint(int w, long long* bytes) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, merge_tree_kernel<T, KV, DESC, L, M>);
  if (e != cudaSuccess) return e;
  *bytes = (long long)attr.sharedSizeBytes + (long long)tree_smem_bytes(L, KV, sizeof(T), w);
  return cudaSuccess;
}

struct Args {
  const void *buf, *rbuf;
  const int32_t *starts, *lens;
  int32_t* meta;  // goff, blk0, the check's flags, n_groups + 1 entries each
  void *out, *out_r;
  int n_groups, n_out, C, w, grid;
  cudaStream_t st;
  int* per_sm;      // set: report occupancy instead of launching
  long long* smem;  // set: report the footprint instead of launching
};

template <typename T, bool KV, bool DESC, int L, int M>
static cudaError_t run(const Args& a) {
  if (a.per_sm) return occupancy<T, KV, DESC, L, M>(a.w, a.per_sm);
  if (a.smem) return footprint<T, KV, DESC, L, M>(a.w, a.smem);
  const size_t smem = tree_smem_bytes(L, KV, sizeof(T), a.w);
  cudaError_t e = prepare<T, KV, DESC, L, M>(smem);
  if (e != cudaSuccess) return e;
  int32_t *goff = a.meta, *blk0 = goff + a.n_groups + 1, *flags = blk0 + a.n_groups + 1;
  tree_offsets_kernel<<<1, kOffsetThreads, 0, a.st>>>(a.lens, 1 << L, a.n_groups, a.C, goff,
                                                      blk0);
  e = cudaMemsetAsync(flags, 0, sizeof(int32_t) * (a.n_groups + 1), a.st);
  if (e != cudaSuccess) return e;
  const int tiles = (a.n_out + kCheckTile - 1) / kCheckTile;
  group_check_kernel<T, KV, DESC><<<tiles < 4096 ? tiles : 4096, kCheckThreads, 0, a.st>>>(
      (const T*)a.buf, (const int32_t*)a.rbuf, a.starts, a.lens, goff, a.n_groups, 1 << L,
      flags);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  merge_tree_kernel<T, KV, DESC, L, M><<<(unsigned)a.grid, 32 << L, smem, a.st>>>(
      (const T*)a.buf, (const int32_t*)a.rbuf, a.starts, a.lens, goff, blk0, (T*)a.out,
      (int32_t*)a.out_r, a.n_groups, a.n_out, a.C, a.w, flags);
  return cudaGetLastError();
}

// The instantiation for (L, w): M = w/32 lanes per thread (1 below 32).
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
  }
  return cudaErrorInvalidValue;
}

static cudaError_t dispatch(int dtype, int kv, int desc, int L, const Args& a) {
  if (a.w < 8 || a.w > 128 || (a.w & (a.w - 1)) || L < 1 || L > 3) return cudaErrorInvalidValue;
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
extern "C" long long flims_merge_tree_smem(int dtype, int kv, int desc, int L, int w) {
  long long bytes = 0;
  flims::Args a{};
  a.w = w;
  a.smem = &bytes;
  const cudaError_t e = flims::dispatch(dtype, kv, desc, L, a);
  return e == cudaSuccess ? bytes : -(long long)e;
}

// CTAs per SM the kernel for (dtype, kv, desc, L, w) reaches, or a negative
// CUDA error.
extern "C" int flims_merge_tree_occupancy(int dtype, int kv, int desc, int L, int w) {
  int per_sm = 0;
  flims::Args a{};
  a.w = w;
  a.per_sm = &per_sm;
  const cudaError_t e = flims::dispatch(dtype, kv, desc, L, a);
  return e == cudaSuccess ? per_sm : -(int)e;
}

// One pass: n_groups groups of 2^L runs, `grid` persistent CTAs over the
// groups' C-blocks; `meta` is 3 (n_groups + 1) int32 of scratch for the
// group table and the check's flags.
// Groups holding a NaN, or a run out of the call's order, are left by the
// streamed kernel and merged by the wide form (csrc/wide_merge.cu, `steps`
// search steps, its meta / tables / scratch / ctas as flims_wide_tree takes
// them at ntot = wtot), on the card: its kernels return at once where no
// group is flagged.
extern "C" int flims_wide_tree(int dtype, int kv, int desc, int sel_max, int L, const void* ka,
                               const void* ra, const void* kb, const void* rb, int pairs,
                               const void* starts, const void* lens, int runs, int n_out, int C,
                               int w, int steps, const void* only, void* meta, void* tables,
                               long long ntot, void* scratch, int ctas, void* out, void* out_r,
                               void* stream);
extern "C" int flims_merge_tree(int dtype, int kv, int desc, int L, const void* buf,
                                const void* rbuf, const void* starts, const void* lens,
                                void* meta, void* out, void* out_r, int n_groups, int n_out,
                                int C, int w, int grid, int steps, void* wmeta, void* tables,
                                long long wtot, void* wscratch, int wctas, void* stream) {
  if (C < w || C % w || n_groups < 1 || n_out < 1 || grid < 1) return cudaErrorInvalidValue;
  flims::Args a{buf, rbuf, (const int32_t*)starts, (const int32_t*)lens, (int32_t*)meta, out,
                out_r, n_groups, n_out, C, w, grid, (cudaStream_t)stream, nullptr, nullptr};
  const int e = flims::dispatch(dtype, kv, desc, L, a);
  if (e != cudaSuccess) return e;
  const int32_t* flags = (const int32_t*)meta + 2 * (n_groups + 1);
  return flims_wide_tree(dtype, kv, desc, 0, L, buf, rbuf, buf, rbuf, 0, starts, lens,
                         n_groups << L, n_out, C, w, steps, flags, wmeta, tables,
                         L > 1 ? wtot : 0, wscratch, wctas, out, out_r, stream);
}

#ifdef K4_PROFILE
extern "C" int k4_prof_layout(int* ctas, int* warps, int* counters) {
  *ctas = K4_PROF_CTAS;
  *warps = kProfWarps;
  *counters = kProfCounters;
  return 0;
}
extern "C" int k4_prof_read(void* dst) {
  return cudaMemcpyFromSymbol(dst, k4_prof, sizeof(k4_prof));
}
extern "C" int k4_prof_zero() {
  void* p = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&p, k4_prof);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(k4_prof));
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&p, k4_when);
  return e != cudaSuccess ? e : cudaMemset(p, 0, sizeof(k4_when));
}
// (start ns, end ns, SM) per CTA
extern "C" int k4_when_read(void* dst) {
  return cudaMemcpyFromSymbol(dst, k4_when, sizeof(k4_when));
}
#endif
