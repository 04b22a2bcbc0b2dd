// The wide forms of K2 / K3, K4, K8 and K9: every FLiMS width w, fused
// level count L and fan-in the JAX kernels take, where the fast kernels'
// warps do not reach (K2 / K3 past w = 1024, K4 / K8 past L = 3 / 4 or
// outside w in [8, 128], K9 past w = 128), and every K4 / K8 group holding
// a NaN or a run out of order (those kernels' check hands them here).
//
// Replaces, at those parameters, `flims_merge_pallas` /
// `flims_merge_kv_pallas` (src/repro/kernels/flims_merge.py:159, :330),
// `segmented_merge_runs` / `_kv` (segmented_merge.py:140, :299), the merge
// tree `_merge_tree_call` (merge_tree.py:319; body `tree_dataflow` :178,
// nested co-ranks `_tree_meta_one` :144) and the streaming merge
// `stream_merge_pallas` (stream_merge.py:166), and, for K9, the
// `jax.vmap(merge_lanes)` scan of `tree_vmapped` (core/lanes.py:165).
//
// Tree form (`flims_wide_tree`), K2 / K3 as a tree of one level over run
// pairs read from two buffers, K8 as K4 over uniform runs:
// 1. prefix_kernel (one CTA): the leaves' length prefix and, per group, its
//    output offset, its first block and its first table tile.
// 2. table_kernel, once a level from L - 1 up to 1: every inner node's
//    merged sequence below the root, each element i the winner of the
//    merge-path co-rank of i over its children (the plain version's
//    `_tree_fns.materialize`), so the nested co-rank search of a block stays
//    one level deep, as in the JAX kernel's partition. A CTA takes a tile of
//    256 consecutive elements of one group (found from the group table; with
//    `only`, of the flagged groups alone), a thread finds its node among the
//    level's 2^d in d steps and searches its co-rank alone: neighbouring
//    elements probe nearly the same lanes, so a warp's probes coalesce. A
//    group ending past the tables' `ntot` lanes a level (K4's runs may
//    overlap) has no table: its searches go through its children's
//    (`free_elem`), a search a level deeper each level, about
//    (2 steps + 2)^(L - 1) reads a probe, so the callers size the tables
//    by the runs' total past L = 3.
// 3. tree_kernel: persistent teams over the flat (group, block) list, a
//    team a C-wide output block: one warp up to w 128 (w / 32 lanes a
//    thread; from w on idle below 32), else w / M threads holding M lanes
//    each (M = 1 or 16) up to w 8192, several teams a CTA where they are
//    narrow; past w 8192, 512 threads whose lanes stay in the arena (a
//    barrier a butterfly stage).
//    Per block the JAX kernel's nested co-ranks top down, a depth's nodes
//    at once (up to 32 a warp, K2's search rounds over each node's lanes:
//    five steps a round for a whole warp, one for a lane alone), then
//    the root's C / w cycles, pulled: a node runs its next FLiMS cycle only
//    when its parent's heads reach a row it has not produced. So an inner
//    node runs the cycles its parent reads, not all of its C / w + depth (the
//    rest are never read: the bits are the JAX kernel's), and keeps two rows
//    of w lanes, the most its parent's heads can touch, in the team's arena
//    (shared memory where the CTA's arenas fit kArenaSmem, else device
//    memory). A cycle: the rotated heads of A and of reversed B (lane i takes
//    the element congruent to i, and to w - 1 - i, mod w, as the JAX
//    kernel's two-row windows do), the selector (XLA's max on K2 / K3's
//    key-only lanes, the element order on K4 / K8's, the compound order on
//    KV lanes), the count by a warp reduction (and the team's warps' sums),
//    the butterfly in registers across a thread's lanes, through the arena
//    across warps (a named barrier for the team's warps) and by shuffles
//    within one. A node on an odd number of B edges from the root numbers
//    its lanes in reverse, so every lane of a row a node writes is read by
//    the same thread of its parent: no barrier between them. The root writes
//    its block straight to the output, clipped at the group's end and at
//    n_out.
// Lane form (`flims_lane_wide`): a CTA a run pair, its whole chain of
// `merge_lanes` cycles (the next w candidates of A and of reversed B, the
// selector with algorithm 2's dir bits under skew, the butterfly by
// compare-and-select), the lanes in shared memory.
//
// Every compare-exchange, selector and co-rank probe is the JAX kernel's in
// operand order, so the bits are its bits, NaN payloads and zero signs
// included.
//
// Bound: bytes, each key read once and written once a pass (plus, on the
// tree form, each inner level's table written once and read by the
// searches). Built with -DWIDE_PROFILE the tree kernel sums its warps'
// clocks by phase (scripts/wide_profile.py).
#include <cstdint>
#include <cuda_runtime.h>

#include "flims.cuh"

#ifdef WIDE_PROFILE
// the tree kernel's clock64 counters, summed over its warps (lane 0 of each)
constexpr int kWideProf = 8;
__device__ unsigned long long wide_prof[kWideProf];
#define WPROF_START(v) const long long v = clock64()
#define WPROF(i, v) (p_acc[i] += clock64() - (v))
#define WPROF_ADD(i, n) (p_acc[i] += (n))
#else
#define WPROF_START(v)
#define WPROF(i, v)
#define WPROF_ADD(i, n)
#endif

namespace flims {
namespace wide {

constexpr int kPrefixThreads = 1024;
constexpr int kMaxThreads = 512;               // the lane form's CTA
constexpr size_t kSmemLanes = 96 * 1024;       // the lane form's lanes in shared memory up to this
constexpr int kTableThreads = 256;             // a table tile's elements, a CTA's threads
constexpr int kTableCtas = 2048;               // a table launch's CTAs, at most (a grid-stride loop)
constexpr int kCtaThreads = 128;               // tree CTAs of narrow teams hold this many threads
constexpr size_t kArenaSmem = 110 * 1024;      // a tree CTA's arenas in shared memory up to this
constexpr size_t kSmemPlain = 48 * 1024;       // dynamic shared memory a CTA takes without an opt-in
constexpr int kRegW = 8192;                    // the widest w a tree team holds in registers

__host__ __device__ inline int threads_for(int w) {
  const int t = w / 2;
  return t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
}
__host__ __device__ inline size_t lane_bytes(bool kv, int tsize) { return tsize + (kv ? 4 : 0); }
__host__ __device__ inline bool lanes_in_smem(bool kv, int tsize, int w) {
  return (size_t)w * lane_bytes(kv, tsize) <= kSmemLanes;
}
__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// A tree team: M lanes a thread, P threads, teams a CTA. One warp up to w
// 128 (w / 32 lanes a thread: no barrier in a cycle), then w threads up to
// 512 (a team's warps share its arena), then 16 lanes a thread (w 2048 on
// 128 threads, several CTAs an SM) up to kRegW, then 512 threads taking
// w / 512 lanes each from the arena.
__host__ __device__ inline int lanes_per_thread(int w) {
  return w <= 32 ? 1 : w <= 128 ? w / 32 : w <= 512 ? 1 : w <= kRegW ? 16 : w / 512;
}
__host__ __device__ inline int team_threads(int w) {
  const int p = w / lanes_per_thread(w);
  return p < 32 ? 32 : p;
}

// A team's arena: per heap node h (1 .. 2^L - 1) the counts consumed from A
// and from B (its rotations first), its rows produced and its block's
// offset; per leaf its aligned base; two buffers of w lanes for the
// butterfly's stages across warps (past kRegW the first holds the
// team's lanes); two rows of w lanes per inner node below
// the root (keys, then ranks on KV lanes).
struct Arena {
  size_t cons, prod, off, base, xchg, ring, total;
  __host__ __device__ Arena(bool kv, int tsize, int L, int w) {
    const size_t N = (size_t)1 << L, lb = lane_bytes(kv, tsize);
    cons = 0;
    prod = cons + 8 * N;
    off = prod + 4 * N;
    base = off + 4 * N;
    xchg = align16(base + 4 * N);
    ring = align16(xchg + (team_threads(w) > 32 ? 2 * (size_t)w * lb : 0));
    total = align16(ring + (N - 2) * 2 * (size_t)w * lb);
  }
};

// Teams a tree CTA: narrow teams up to kCtaThreads threads, but no more
// than fit kSmemPlain (K4 / K8 launch the tree kernel on every call, and
// where no group is flagged it returns at once: past kSmemPlain that
// launch would take an opt-in and a larger shared-memory carveout).
__host__ __device__ inline int teams_per_cta(bool kv, int tsize, int L, int w) {
  const int p = team_threads(w), most = p >= kCtaThreads ? 1 : kCtaThreads / p;
  const int fit = (int)(kSmemPlain / Arena(kv, tsize, L, w).total);
  return fit < 1 ? 1 : (fit < most ? fit : most);
}

// A tree CTA's dynamic shared memory (0: its arenas are in device memory)
// and the device-memory scratch it takes.
__host__ inline size_t tree_smem(bool kv, int tsize, int L, int w) {
  const size_t a = (size_t)teams_per_cta(kv, tsize, L, w) * Arena(kv, tsize, L, w).total;
  return a <= kArenaSmem ? a : 0;
}
__host__ inline size_t tree_scratch(bool kv, int tsize, int L, int w) {
  return tree_smem(kv, tsize, L, w) ? 0
                                    : (size_t)teams_per_cta(kv, tsize, L, w) *
                                          Arena(kv, tsize, L, w).total;
}

// loff: the leaves' length prefix (runs + 1); goff / blk0 / tile0: each
// group's output offset, first block and first table tile (groups + 1
// each). With `only`, a group whose flag is 0 has no block and no tile:
// another kernel writes it. A group ending past `ntot` lanes has no tile
// (no table: its searches go through its children's).
__global__ void __launch_bounds__(kPrefixThreads)
    prefix_kernel(const int32_t* __restrict__ lens, int runs, int group, int C,
                  const int32_t* __restrict__ only, long long ntot, int32_t* loff, int32_t* goff,
                  int32_t* blk0, int32_t* tile0) {
  if (only && !only[runs / group]) return;  // no group flagged
  __shared__ int32_t s_part[kPrefixThreads];
  block_scan(runs, [&](int i) { return lens[i]; }, loff, s_part);
  const int groups = runs / group;
  auto glen = [&](int g) { return loff[(g + 1) * group] - loff[g * group]; };
  auto on = [&](int g) { return !only || only[g] != 0; };
  block_scan(groups, glen, goff, s_part);
  block_scan(groups, [&](int g) { return on(g) ? (glen(g) + C - 1) / C : 0; }, blk0, s_part);
  block_scan(groups, [&](int g) {
    return on(g) && loff[(g + 1) * group] <= ntot ? (glen(g) + kTableThreads - 1) / kTableThreads
                                                  : 0;
  }, tile0, s_part);
}

// A sequence read in place: k[0 .. len), ranks beside on KV lanes.
template <typename T> struct Seq {
  const T* k;
  const int32_t* r;
  int len;
};

template <typename T, bool KV, bool DESC>
__device__ __forceinline__ Lane<T> at(const Seq<T>& s, int i) {
  return guarded<T, KV, DESC>(s.k, s.r, s.len, i);
}

// The leaves and the inner levels' tables of the tree form.
template <typename T> struct Tree {
  const T *ka, *kb;          // leaf keys; odd leaves read kb when `pairs`
  const int32_t *ra, *rb;
  const int32_t *starts, *lens, *loff;
  const T* tk;               // tables: level d (1 .. L - 1) at (d - 1) * ntot
  const int32_t* tr;
  long long ntot;
  int group, L, pairs;

  __device__ Seq<T> leaf(int run) const {
    const bool b = pairs && (run & 1);
    const int s = starts[run];
    return Seq<T>{(b ? kb : ka) + s, ra ? (b ? rb : ra) + s : nullptr, lens[run]};
  }
  // node of depth d over leaves [first, first + (group >> d)) of its group
  // (first a flat run index); a leaf at d == L
  __device__ Seq<T> node(int d, int first) const {
    if (d == L) return leaf(first);
    const int o = loff[first];
    const size_t lvl = (size_t)(d - 1) * ntot;
    return Seq<T>{tk + lvl + o, tr ? tr + lvl + o : nullptr, loff[first + (group >> d)] - o};
  }
  // whether the group of leaf `first` has its inner levels in the tables
  __device__ bool tabled(int first) const {
    return L == 1 || loff[(first / group + 1) * group] <= ntot;
  }
};

// The merge-path co-rank in [lo, hi] by one thread: `steps` steps of the
// JAX kernels' binary search, `pred(mid)` being "A[mid - 1] goes before
// B[o - mid]".
template <class Pred>
__device__ int corank1(int lo, int hi, int steps, const Pred& pred) {
  for (int s = 0; s < steps && lo < hi; ++s) {
    const int mid = lo + ((hi - lo + 1) >> 1);
    if (pred(mid)) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// The co-ranks of `per` nodes by one warp, 32 / per lanes a node (lane
// `lane` on node lane / lpn): flims::corank's rounds, each evaluating the
// probes of as many steps of the binary search as a node's lanes hold
// (five for a whole warp, one for a lane alone) and then walking them, so
// every co-rank is the binary search's own, corank1's. `pred(mid)` is
// "A[mid - 1] goes before B[o - mid]" for this lane's node.
template <class Pred>
__device__ int corank_nodes(int lo, int hi, int steps, int lane, int lpn, const Pred& pred) {
  const int levels = 31 - __clz(lpn + 1);  // a probe tree of 2^levels - 1 <= lpn nodes
  const int sub = lane % lpn, first = lane - sub;
  auto midpoint = [](int l, int h) { return l + ((h - l + 1) >> 1); };
  while (steps > 0 && __any_sync(kFullWarp, lo < hi)) {
    const int lv = steps < levels ? steps : levels;
    const int n = sub + 1;  // heap index of this lane's probe
    bool ok = false;
    if (lo < hi && n < (1 << lv)) {
      int nlo = lo, nhi = hi;
      for (int d = 30 - __clz(n); d >= 0; --d) {
        const int mid = midpoint(nlo, nhi);
        if ((n >> d) & 1) nlo = mid; else nhi = mid - 1;
      }
      ok = pred(midpoint(nlo, nhi));
    }
    const unsigned took = __ballot_sync(kFullWarp, ok) >> first;
    if (lo < hi) {
      for (int d = 0, node = 1; d < lv; ++d) {
        const int mid = midpoint(lo, hi);
        const int t = (took >> (node - 1)) & 1;
        if (t) lo = mid; else hi = mid - 1;
        node = 2 * node + t;
      }
    }
    steps -= lv;
  }
  return lo;
}

// Element i of node (d, first) of a group without tables: the winner at the
// co-rank of i over its children, their elements found the same way (a
// table's element, unmemoised: about (2 steps + 2)^(L - d) reads, so only
// groups of up to 3 levels come here).
template <typename T, bool KV, bool DESC>
__device__ Lane<T> free_elem(const Tree<T>& tr, int d, int first, int i, int steps) {
  if (d == tr.L) return at<T, KV, DESC>(tr.leaf(first), i);
  const int span = tr.group >> d, half = first + span / 2, o = tr.loff[first];
  const int len = tr.loff[first + span] - o;
  if (i < 0 || i >= len) {  // the co-rank guards
    const bool before = i < 0;
    return Lane<T>{before ? first_key<T, DESC>() : last_key<T, DESC>(),
                   before ? kRankLo : kInvalidRank};
  }
  const int la = tr.loff[half] - o, lb = len - la;
  const int lo = corank1(max(0, i - lb), min(i, la), steps, [&](int mid) {
    return wins<T, KV, DESC>(free_elem<T, KV, DESC>(tr, d + 1, first, mid - 1, steps),
                             free_elem<T, KV, DESC>(tr, d + 1, half, i - mid, steps));
  });
  const Lane<T> x = free_elem<T, KV, DESC>(tr, d + 1, first, lo, steps);
  const Lane<T> y = free_elem<T, KV, DESC>(tr, d + 1, half, i - lo, steps);
  return pick(wins<T, KV, DESC>(x, y), x, y);
}

// Level d's table: element i of every depth-d node of the groups with a
// tile, the winner at the co-rank of i over its children.
template <typename T, bool KV, bool DESC>
__global__ void __launch_bounds__(kTableThreads)
    table_kernel(Tree<T> tr, const int32_t* __restrict__ tile0, int groups, int d, int steps,
                 const int32_t* __restrict__ only, T* tk, int32_t* trk) {
  if (only && !only[groups]) return;  // no group flagged
  const int tiles = tile0[groups], span = tr.group >> d;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int g = find_segment(tile0, groups + 1, t);
    const int run0 = g * tr.group, g0 = tr.loff[run0];
    const int e = (t - tile0[g]) * kTableThreads + threadIdx.x;
    if (e >= tr.loff[run0 + tr.group] - g0) continue;
    int lo = 0, hi = (1 << d) - 1;  // the node holding e: the last starting at or before it
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (tr.loff[run0 + mid * span] - g0 <= e) lo = mid; else hi = mid - 1;
    }
    const int first = run0 + lo * span, i = g0 + e - tr.loff[first];
    const Seq<T> a = tr.node(d + 1, first), b = tr.node(d + 1, first + span / 2);
    const int c = corank1(max(0, i - b.len), min(i, a.len), steps, [&](int mid) {
      return wins<T, KV, DESC>(at<T, KV, DESC>(a, mid - 1), at<T, KV, DESC>(b, i - mid));
    });
    const Lane<T> x = at<T, KV, DESC>(a, c), y = at<T, KV, DESC>(b, i - c);
    const Lane<T> v = pick(wins<T, KV, DESC>(x, y), x, y);
    tk[g0 + e] = v.k;
    if (KV) trk[g0 + e] = v.r;
  }
}

// One launch of the tree kernel.
template <typename T> struct TreeRun {
  Tree<T> tr;
  const int32_t *goff, *blk0, *only;
  int groups, n_out, C, w, steps, sel_max;
  unsigned char* scratch;  // the teams' arenas where they are in device memory, else null
  T* out;
  int32_t* out_r;
};

__device__ __forceinline__ void team_sync(int team, int P) {
  if (P <= 32)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(team + 1), "r"(P) : "memory");
}

// One compare-exchange of a lane with its partner p: the top lane keeps
// the first (XLA's max on key-only lanes), the bottom lane the other, in
// the JAX kernel's operand order (top, bottom).
template <typename T, bool KV, bool DESC>
__device__ __forceinline__ void exch(Lane<T>& v, const Lane<T>& p, bool top) {
  if (KV) {
    const bool keep = wins<T, KV, DESC>(pick(top, v, p), pick(top, p, v));
    v = pick(keep, v, p);
  } else {
    v.k = top ? xmax(v.k, p.k) : xmin(p.k, v.k);
  }
}

// The butterfly over a team's w lanes, thread tt holding lanes m P + tt
// (in reverse, w - 1 - that, where `rev`): stages at and past P pair a
// thread's registers, stages 32 .. P / 2 go through the arena's two
// buffers (one barrier each), the last five are shuffles.
template <typename T, bool KV, bool DESC, int M>
__device__ __forceinline__ void team_butterfly(Lane<T> (&v)[M], bool rev, int w, int P, int tt,
                                               int team, T* xk, int32_t* xr) {
  if constexpr (!KV && std::is_same<T, float>::value) {
    // a one-warp team holding no NaN runs on the monotone int32 bits,
    // whose integer max / min are XLA's there (-0 below +0), as
    // warp_butterfly_mono does
    bool nan = false;
#pragma unroll
    for (int m = 0; m < M; ++m) nan |= v[m].k != v[m].k;
    if (P == 32 && !__any_sync(kFullWarp, nan)) {
      Lane<int32_t> u[M];
#pragma unroll
      for (int m = 0; m < M; ++m) u[m] = Lane<int32_t>{mono(__float_as_int(v[m].k)), 0};
      team_butterfly<int32_t, false, DESC, M>(u, rev, w, P, tt, team, nullptr, nullptr);
#pragma unroll
      for (int m = 0; m < M; ++m) v[m].k = __int_as_float(mono(u[m].k));
      return;
    }
  }
#pragma unroll
  for (int dd = M / 2; dd >= 1; dd >>= 1) {
#pragma unroll
    for (int m = 0; m < M; ++m)
      if (!(m & dd)) {
        if (rev)
          cas_regs<T, KV, DESC>(v[m | dd], v[m]);
        else
          cas_regs<T, KV, DESC>(v[m], v[m | dd]);
      }
  }
  const int q = M > 1 ? P : w;  // the lanes one register of the team spans
  int buf = 0;
  for (int d = q >> 1; d >= 32; d >>= 1, buf ^= 1) {
    T* bk = xk + (size_t)buf * w;
    int32_t* br = xr + (size_t)buf * w;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      bk[m * P + tt] = v[m].k;
      if (KV) br[m * P + tt] = v[m].r;
    }
    team_sync(team, P);
    const bool top = ((tt & d) == 0) != rev;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      Lane<T> p;
      p.k = bk[m * P + (tt ^ d)];
      p.r = KV ? br[m * P + (tt ^ d)] : 0;
      exch<T, KV, DESC>(v[m], p, top);
    }
  }
  for (int d = (q >> 1) < 16 ? (q >> 1) : 16; d >= 1; d >>= 1) {
    const bool top = ((tt & d) == 0) != rev;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      Lane<T> p;
      p.k = __shfl_xor_sync(kFullWarp, v[m].k, d);
      p.r = KV ? __shfl_xor_sync(kFullWarp, v[m].r, d) : 0;
      exch<T, KV, DESC>(v[m], p, top);
    }
  }
}

// The butterfly over w lanes held in the arena (lane l at bk[l], br[l]),
// past kRegW: a stage's pairs split among the team's P threads, a barrier
// a stage. The top of a pair is its lower lane, as in team_butterfly.
template <typename T, bool KV, bool DESC>
__device__ void mem_butterfly(T* bk, int32_t* br, int w, int P, int tt, int team) {
  for (int d = w >> 1; d >= 1; d >>= 1) {
    for (int q = tt; q < (w >> 1); q += P) {
      const int i = ((q & ~(d - 1)) << 1) | (q & (d - 1));
      Lane<T> x{bk[i], KV ? br[i] : 0}, y{bk[i + d], KV ? br[i + d] : 0};
      cas_regs<T, KV, DESC>(x, y);
      bk[i] = x.k;
      bk[i + d] = y.k;
      if (KV) {
        br[i] = x.r;
        br[i + d] = y.r;
      }
    }
    team_sync(team, P);
  }
}

// M: lanes a thread, 0 for a one-warp team at w <= 32, -1 past kRegW (the
// lanes in the arena); the one-warp teams (M 0, 2 and 4) are built for
// several CTAs of 128 threads an SM.
template <typename T, bool KV, bool DESC, int M>
__global__ void __launch_bounds__(M == 0 || M == 2 || M == 4 ? kCtaThreads : 512,
                                  M == 0 ? 6 : (M == 2 || M == 4 ? 4 : 1))
    tree_kernel(TreeRun<T> x) {
  if (x.only && !x.only[x.groups]) return;  // no group flagged: blk0 was not written
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_part[32];  // each warp's count of a cycle
  const Tree<T>& tr = x.tr;
  const int w = x.w, L = tr.L, group = tr.group, C = x.C;
  const int P = team_threads(w), teams = teams_per_cta(KV, sizeof(T), L, w);
  const int team = threadIdx.x / P, tt = threadIdx.x % P, lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5, NW = P >> 5, w0 = team * NW;
  const Arena ar(KV, sizeof(T), L, w);
  unsigned char* mine = x.scratch ? x.scratch + ((size_t)blockIdx.x * teams + team) * ar.total
                                  : smem + (size_t)team * ar.total;
  int* s_cons = reinterpret_cast<int*>(mine + ar.cons);
  int* s_prod = reinterpret_cast<int*>(mine + ar.prod);
  int* s_off = reinterpret_cast<int*>(mine + ar.off);
  int* s_base = reinterpret_cast<int*>(mine + ar.base);
  T* xk = reinterpret_cast<T*>(mine + ar.xchg);
  int32_t* xr = reinterpret_cast<int32_t*>(mine + ar.xchg + 2 * (size_t)w * sizeof(T));
  const size_t inner = ((size_t)1 << L) - 2;
  T* rk = reinterpret_cast<T*>(mine + ar.ring);
  int32_t* rr = reinterpret_cast<int32_t*>(mine + ar.ring + inner * 2 * w * sizeof(T));
  // row r of inner node h: 2 rows a node, r's parity the slot
  auto row = [&](int h, int r) { return ((size_t)(h - 2) * 2 + (r & 1)) * w; };
#ifdef WIDE_PROFILE
  unsigned long long p_acc[kWideProf] = {};
#endif
  const int G = x.blk0[x.groups];
  for (int g = blockIdx.x * teams + team; g < G; g += gridDim.x * teams) {
    const int grp = find_segment(x.blk0, x.groups + 1, g);
    const int o = (g - x.blk0[grp]) * C;
    const int goff = x.goff[grp];
    const int valid = min(min(C, x.goff[grp + 1] - goff - o), x.n_out - goff - o);
    if (valid <= 0) continue;
    WPROF_ADD(7, 1);
    WPROF_START(t_search);
    const int run0 = grp * group;
    const bool tabled = tr.tabled(run0);
    team_sync(team, P);  // the last block's reads of the arena are done
    if (tt == 0) s_off[1] = o;
    team_sync(team, P);
    // the nested co-ranks, top down: a depth's nodes in parallel, up to 32
    // a warp (32 / nodes lanes each), the team's warps taking turns
    for (int d = 0; d < L; ++d) {
      const int span = group >> d, nodes = 1 << d;
      const int per = nodes < 32 ? nodes : 32, lpn = 32 / per;
      for (int q0 = (warp - w0) * per; q0 < nodes; q0 += NW * per) {
        const int q = q0 + lane / lpn, h = nodes + q;
        const int first = run0 + q * span, half = first + span / 2;
        const int a = s_off[h];
        const int la = tr.loff[half] - tr.loff[first];
        const int lb = tr.loff[first + span] - tr.loff[half];
        const int lo = max(0, a - lb), hi = min(a, la);
        int sx;
        if (tabled || d + 1 == L) {
          const Seq<T> A = tr.node(d + 1, first), B = tr.node(d + 1, half);
          sx = corank_nodes(lo, hi, x.steps, lane, lpn, [&](int mid) {
            return wins<T, KV, DESC>(at<T, KV, DESC>(A, mid - 1), at<T, KV, DESC>(B, a - mid));
          });
        } else {
          sx = corank_nodes(lo, hi, x.steps, lane, lpn, [&](int mid) {
            return wins<T, KV, DESC>(free_elem<T, KV, DESC>(tr, d + 1, first, mid - 1, x.steps),
                                     free_elem<T, KV, DESC>(tr, d + 1, half, a - mid, x.steps));
          });
        }
        const int sy = a - sx;
        if (lane % lpn == 0) {
          s_cons[2 * h] = sx % w;
          s_cons[2 * h + 1] = sy % w;
          s_prod[h] = 0;
          if (d + 1 == L) {
            s_base[q * span] = sx - sx % w;
            s_base[q * span + 1] = sy - sy % w;
          } else {
            s_off[2 * h] = sx - sx % w;
            s_off[2 * h + 1] = sy - sy % w;
          }
        }
      }
      team_sync(team, P);
    }
    WPROF(0, t_search);
    // the root's cycles, each node's pulled as its parent's heads need them
    const int root_cycles = (valid + w - 1) / w;
    T* ok = x.out + goff + o;
    int32_t* orr = KV ? x.out_r + goff + o : nullptr;
    int h = 1;
    for (;;) {
      WPROF_START(t_pull);
      const int d = 31 - __clz(h);
      const int cA = s_cons[2 * h], cB = s_cons[2 * h + 1];
      if (d + 1 < L) {
        // a child's rows: C / w + its depth at most (the JAX kernel's)
        const int most = C / w + d + 1;
        const int pa = s_prod[2 * h], pb = s_prod[2 * h + 1];
        if (pa <= (cA + w - 1) / w && pa < most) {
          h = 2 * h;
          WPROF(5, t_pull);
          continue;
        }
        if (pb <= (cB + w - 1) / w && pb < most) {
          h = 2 * h + 1;
          WPROF(5, t_pull);
          continue;
        }
      }
      const int cyc = s_prod[h];
      const bool rev = __popc(h ^ (1 << d)) & 1;  // on an odd number of B edges
      WPROF(5, t_pull);
      WPROF_START(t_heads);
      constexpr int MR = M > 0 ? M : 1;  // lanes a thread holds in registers
      Lane<T> v[MR];
      int took = 0;
      Seq<T> SA{nullptr, nullptr, 0}, SB{nullptr, nullptr, 0};
      if (d + 1 == L) {
        const int j = 2 * (h - (1 << d));
        const Seq<T> la = tr.leaf(run0 + j), lb = tr.leaf(run0 + j + 1);
        const int ba = s_base[j], bb = s_base[j + 1];
        SA = Seq<T>{la.k + ba, KV ? la.r + ba : nullptr, la.len - ba};
        SB = Seq<T>{lb.k + bb, KV ? lb.r + bb : nullptr, lb.len - bb};
      }
      // lane l: head l of A's rotated window against head w - 1 - l of B's,
      // the selector's pick
      auto head = [&](int l) {
        const int j = w - 1 - l;
        const int ia = cA + ((l - cA) & (w - 1)), ib = cB + ((j - cB) & (w - 1));
        Lane<T> ca, cb;
        if (d + 1 == L) {
          ca = at<T, KV, DESC>(SA, ia);
          cb = at<T, KV, DESC>(SB, ib);
        } else {
          const size_t ra = row(2 * h, ia / w) + l, rb = row(2 * h + 1, ib / w) + j;
          ca = Lane<T>{rk[ra], KV ? rr[ra] : 0};
          cb = Lane<T>{rk[rb], KV ? rr[rb] : 0};
        }
        const bool take = wins<T, KV, DESC>(ca, cb);
        took += take;
        Lane<T> u = pick(take, ca, cb);
        if (!KV && x.sel_max) u.k = xmax(ca.k, cb.k);
        return u;
      };
      if constexpr (M < 0) {
        for (int l = tt; l < w; l += P) {
          const Lane<T> u = head(l);
          xk[l] = u.k;
          if (KV) xr[l] = u.r;
        }
      } else {
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          const int p = m * P + tt;
          v[m] = p < w ? head(rev ? w - 1 - p : p) : Lane<T>{last_key<T, DESC>(), kInvalidRank};
        }
      }
      WPROF(1, t_heads);
      WPROF_START(t_count);
      int taken = (int)__reduce_add_sync(kFullWarp, (unsigned)took);
      if (NW > 1) {
        if (lane == 0) s_part[warp] = taken;
        team_sync(team, P);
        taken = 0;
        for (int i = 0; i < NW; ++i) taken += s_part[w0 + i];
      }
      WPROF(2, t_count);
      WPROF_START(t_bfly);
      if constexpr (M < 0)
        mem_butterfly<T, KV, DESC>(xk, xr, w, P, tt, team);
      else
        team_butterfly<T, KV, DESC, MR>(v, rev, w, P, tt, team, xk, xr);
      WPROF(3, t_bfly);
      WPROF_START(t_store);
      if constexpr (M < 0) {
        const size_t r0 = h == 1 ? 0 : row(h, cyc);
        for (int l = tt; l < w; l += P) {
          const int e = cyc * w + l;
          if (h != 1) {
            rk[r0 + l] = xk[l];
            if (KV) rr[r0 + l] = xr[l];
          } else if (e < valid) {
            ok[e] = xk[l];
            if (KV) orr[e] = xr[l];
          }
        }
      } else if (h == 1) {
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          const int e = cyc * w + m * P + tt;
          if (m * P + tt < w && e < valid) {
            ok[e] = v[m].k;
            if (KV) orr[e] = v[m].r;
          }
        }
      } else {
        const size_t r0 = row(h, cyc);
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          const int p = m * P + tt;
          if (p < w) {
            const int l = rev ? w - 1 - p : p;
            rk[r0 + l] = v[m].k;
            if (KV) rr[r0 + l] = v[m].r;
          }
        }
      }
      // every thread writes the node's new state (the same values) and
      // reads its own writes: no barrier but the warp's (past kRegW the
      // team's, as a row's lanes are written and read by other threads)
      s_cons[2 * h] = cA + taken;
      s_cons[2 * h + 1] = cB + w - taken;
      s_prod[h] = cyc + 1;
      if constexpr (M < 0)
        team_sync(team, P);
      else
        __syncwarp();
      WPROF(4, t_store);
      WPROF_ADD(6, 1);
      if (h == 1) {
        if (cyc + 1 >= root_cycles) break;
      } else {
        h >>= 1;
      }
    }
  }
#ifdef WIDE_PROFILE
  if (lane == 0)
    for (int i = 0; i < kWideProf; ++i) atomicAdd(&wide_prof[i], p_acc[i]);
#endif
}

// ---- the lane form (K9) -------------------------------------------------------

template <typename T, bool KV, bool SKEW>
__global__ void __launch_bounds__(kMaxThreads)
    lane_kernel(const T* __restrict__ a, const int32_t* __restrict__ ra, const T* __restrict__ b,
                const int32_t* __restrict__ rb, const int32_t* __restrict__ as,
                const int32_t* __restrict__ al, const int32_t* __restrict__ bs,
                const int32_t* __restrict__ bl, const int32_t* __restrict__ os, int P, int n_out,
                int w, unsigned char* scratch, size_t cta_bytes, T* out, int32_t* rout) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_cnt;
  const int t = threadIdx.x, T_ = blockDim.x;
  unsigned char* lanes = lanes_in_smem(KV, sizeof(T) + 1, w) ? smem
                                                             : scratch + (size_t)blockIdx.x * cta_bytes;
  T* lk = reinterpret_cast<T*>(lanes);
  int32_t* lr = reinterpret_cast<int32_t*>(lanes + (size_t)w * sizeof(T));
  unsigned char* dir = lanes + (size_t)w * lane_bytes(KV, sizeof(T));
  if (t == 0) s_cnt = 0;
  __syncthreads();
  // "x goes first": strict `>` key-only, the compound order on KV lanes
  auto first = [](const Lane<T>& x, const Lane<T>& y) { return wins<T, KV, true>(x, y); };
  const Lane<T> fill{Bounds<T>::lo(), kInvalidRank};
  for (int p = blockIdx.x; p < P; p += gridDim.x) {
    const int la = al[p], lb = bl[p], o0 = os[p];
    const int valid = min(la + lb, n_out - o0);
    if (valid <= 0) continue;
    const T* pa = a + as[p];
    const T* pb = b + bs[p];
    const int32_t* qa = KV ? ra + as[p] : nullptr;
    const int32_t* qb = KV ? rb + bs[p] : nullptr;
    for (int i = t; i < w; i += T_) dir[i] = 0;
    __syncthreads();
    int pA = 0, pB = 0;
    for (int c0 = 0; c0 < valid; c0 += w) {
      int took = 0;
      for (int i = t; i < w; i += T_) {
        const int ia = pA + i, ib = pB + w - 1 - i;
        const Lane<T> x = ia < la ? Lane<T>{pa[ia], KV ? qa[ia] : 0} : fill;
        const Lane<T> y = ib < lb ? Lane<T>{pb[ib], KV ? qb[ib] : 0} : fill;
        bool take = first(x, y);
        if (SKEW) take |= (x.k == y.k) & (dir[i] != 0);
        const Lane<T> v = pick(take, x, y);
        lk[i] = v.k;
        if (KV) lr[i] = v.r;
        dir[i] = !take;
        took += take;
      }
      if (took) atomicAdd(&s_cnt, took);
      __syncthreads();
      const int taken = s_cnt;
      for (int d = w >> 1; d >= 1; d >>= 1) {
        for (int q = t; q < (w >> 1); q += T_) {
          const int i = (q / d) * 2 * d + (q % d);
          const Lane<T> x{lk[i], KV ? lr[i] : 0}, y{lk[i + d], KV ? lr[i + d] : 0};
          const bool m = first(x, y);
          const Lane<T> hi = pick(m, x, y), lo = pick(m, y, x);
          lk[i] = hi.k;
          lk[i + d] = lo.k;
          if (KV) {
            lr[i] = hi.r;
            lr[i + d] = lo.r;
          }
        }
        __syncthreads();
      }
      for (int i = t; i < w && c0 + i < valid; i += T_) {
        out[(size_t)o0 + c0 + i] = lk[i];
        if (KV) rout[(size_t)o0 + c0 + i] = lr[i];
      }
      pA += taken;
      pB += w - taken;
      __syncthreads();
      if (t == 0) s_cnt = 0;
      __syncthreads();
    }
  }
}

__host__ inline size_t lane_cta_bytes(bool kv, int tsize, int w) {
  return lanes_in_smem(kv, tsize + 1, w) ? 0 : align16((size_t)w * (lane_bytes(kv, tsize) + 1));
}

struct TreeArgs {
  int kv, desc, sel_max, L, pairs, runs, n_out, C, w, steps, ctas;
  const void *ka, *ra, *kb, *rb, *starts, *lens;
  const int32_t* only;
  int32_t* meta;
  void* tables;
  long long ntot;
  unsigned char* scratch;
  void *out, *out_r;
  cudaStream_t st;
  int* per_sm;  // set: report the tree kernel's CTAs an SM instead of launching
};

template <typename T, bool KV, bool DESC, int M>
static cudaError_t launch_tree(const TreeArgs& x, const TreeRun<T>& run) {
  const size_t smem = tree_smem(KV, sizeof(T), x.L, x.w);
  const int threads = teams_per_cta(KV, sizeof(T), x.L, x.w) * team_threads(x.w);
  auto kern = tree_kernel<T, KV, DESC, M>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  if (x.per_sm) return cudaOccupancyMaxActiveBlocksPerMultiprocessor(x.per_sm, kern, threads, smem);
  kern<<<x.ctas, threads, smem, x.st>>>(run);
  return cudaGetLastError();
}

template <typename T, bool KV, bool DESC>
static cudaError_t run_tree(const TreeArgs& x) {
  const int group = 1 << x.L, groups = x.runs / group;
  int32_t *loff = x.meta, *goff = loff + x.runs + 1, *blk0 = goff + groups + 1;
  int32_t* tile0 = blk0 + groups + 1;
  Tree<T> tr{(const T*)x.ka, (const T*)x.kb, (const int32_t*)x.ra, (const int32_t*)x.rb,
             (const int32_t*)x.starts, (const int32_t*)x.lens, loff, (const T*)x.tables,
             KV && x.tables ? (const int32_t*)((T*)x.tables + (size_t)(x.L - 1) * x.ntot)
                            : nullptr,
             x.ntot, group, x.L, x.pairs};
  const TreeRun<T> run{tr, goff, blk0, x.only, groups, x.n_out, x.C, x.w, x.steps, x.sel_max,
                       tree_smem(KV, sizeof(T), x.L, x.w) ? nullptr : x.scratch, (T*)x.out,
                       (int32_t*)x.out_r};
  const int M = lanes_per_thread(x.w);
  auto tree = [&]() {
    if (x.w > kRegW) return launch_tree<T, KV, DESC, -1>(x, run);
    if (x.w <= 32) return launch_tree<T, KV, DESC, 0>(x, run);
    if (M == 1) return launch_tree<T, KV, DESC, 1>(x, run);
    if (M == 2) return launch_tree<T, KV, DESC, 2>(x, run);
    if (M == 4) return launch_tree<T, KV, DESC, 4>(x, run);
    return launch_tree<T, KV, DESC, 16>(x, run);
  };
  if (x.per_sm) return tree();
  prefix_kernel<<<1, kPrefixThreads, 0, x.st>>>((const int32_t*)x.lens, x.runs, group, x.C,
                                                x.only, x.L > 1 ? x.ntot : 0, loff, goff, blk0,
                                                tile0);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long tiles = (x.ntot + kTableThreads - 1) / kTableThreads + groups;
  for (int d = x.L - 1; d >= 1 && x.ntot > 0; --d) {
    T* tk = (T*)x.tables + (size_t)(d - 1) * x.ntot;
    int32_t* trk = KV ? const_cast<int32_t*>(tr.tr) + (size_t)(d - 1) * x.ntot : nullptr;
    table_kernel<T, KV, DESC><<<(unsigned)(tiles < kTableCtas ? tiles : kTableCtas),
                                kTableThreads, 0, x.st>>>(tr, tile0, groups, d, x.steps, x.only,
                                                         tk, trk);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return tree();
}

template <typename T>
static cudaError_t tree_dispatch(const TreeArgs& x) {
  if (!x.kv && x.desc) return run_tree<T, false, true>(x);
  if (x.kv && x.desc) return run_tree<T, true, true>(x);
  if (x.kv && !x.desc) return run_tree<T, true, false>(x);
  return cudaErrorInvalidValue;  // key-only lanes merge descending only
}

template <typename T, bool KV, bool SKEW>
static cudaError_t run_lanes(const void* a, const void* ra, const void* b, const void* rb,
                             const int32_t* const* v, int P, int n_out, int w,
                             unsigned char* scratch, int ctas, void* out, void* rout,
                             cudaStream_t st) {
  const size_t smem = lanes_in_smem(KV, sizeof(T) + 1, w)
                          ? (size_t)w * (lane_bytes(KV, sizeof(T)) + 1) : 0;
  auto kern = lane_kernel<T, KV, SKEW>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<ctas, threads_for(w), smem, st>>>((const T*)a, (const int32_t*)ra, (const T*)b,
                                           (const int32_t*)rb, v[0], v[1], v[2], v[3], v[4], P,
                                           n_out, w, scratch, lane_cta_bytes(KV, sizeof(T), w),
                                           (T*)out, (int32_t*)rout);
  return cudaGetLastError();
}

}  // namespace wide
}  // namespace flims

// Device-memory scratch of one tree CTA at (kv, L, w), bytes (0 where its
// teams' arenas fit shared memory); C is not read.
extern "C" long long flims_wide_tree_scratch(int kv, int L, int w, int C) {
  if (L < 1 || L > 20 || w < 1 || (w & (w - 1)) || C < w || C % w)
    return -1;
  return (long long)flims::wide::tree_scratch(kv != 0, 4, L, w);
}

static int tree_entry(int dtype, const flims::wide::TreeArgs& x) {
  using namespace flims;
  if (dtype == kInt32) return wide::tree_dispatch<int32_t>(x);
  if (dtype == kFloat32) return wide::tree_dispatch<float>(x);
  return cudaErrorInvalidValue;
}

// CTAs an SM the tree kernel for (dtype, kv, desc, L, w) reaches, or a
// negative CUDA error.
extern "C" int flims_wide_tree_occupancy(int dtype, int kv, int desc, int L, int w) {
  if (L < 1 || L > 20 || w < 1 || (w & (w - 1))) return -1;
  int per_sm = 0;
  flims::wide::TreeArgs x{};
  x.kv = kv;
  x.desc = desc;
  x.L = L;
  x.w = w;
  x.per_sm = &per_sm;
  const int e = tree_entry(dtype, x);
  return e == cudaSuccess ? per_sm : -e;
}

// meta: runs + 1 + 3 (groups + 1) int32; tables: (L - 1) ntot keys, then
// as many ranks on KV lanes (a group ending past ntot lanes has no table:
// its searches go through its children's, at a cost exponential in L, so
// past L = 3 ntot should cover the runs' total); scratch: ctas x
// flims_wide_tree_scratch bytes; only: null, or a flag a group (0: the
// group is left to another kernel) and after them one more, 0 where no
// group is flagged: then every kernel of the call returns at once.
extern "C" int flims_wide_tree(int dtype, int kv, int desc, int sel_max, int L, const void* ka,
                               const void* ra, const void* kb, const void* rb, int pairs,
                               const void* starts, const void* lens, int runs, int n_out, int C,
                               int w, int steps, const void* only, void* meta, void* tables,
                               long long ntot, void* scratch, int ctas, void* out, void* out_r,
                               void* stream) {
  using namespace flims;
  if (L < 1 || L > 20 || runs < (1 << L) || runs % (1 << L) || w < 1 ||
      (w & (w - 1)) || C < w || C % w || ctas < 1 || !meta ||
      (!scratch && wide::tree_scratch(kv != 0, 4, L, w)) || (L > 1 && ntot > 0 && !tables))
    return cudaErrorInvalidValue;
  const wide::TreeArgs x{kv, desc, sel_max, L, pairs, runs, n_out, C, w, steps, ctas,
                         ka, ra, kb, rb, starts, lens, (const int32_t*)only, (int32_t*)meta,
                         tables, ntot, (unsigned char*)scratch, out, out_r,
                         (cudaStream_t)stream, nullptr};
  return tree_entry(dtype, x);
}

// Per-CTA device-memory scratch of the lane form at (kv, w), bytes (0 where
// the lanes fit shared memory).
extern "C" long long flims_lane_wide_scratch(int kv, int w) {
  if (w < 1 || (w & (w - 1))) return -1;
  return (long long)flims::wide::lane_cta_bytes(kv != 0, 4, w);
}

// P run pairs: a[as[p] :+ al[p]] with b[bs[p] :+ bl[p]] into out[os[p] :],
// cut at n_out; a CTA a pair, `ctas` CTAs.
extern "C" int flims_lane_wide(int dtype, int kv, int skew, int w, const void* a, const void* ra,
                               const void* b, const void* rb, const void* as, const void* al,
                               const void* bs, const void* bl, const void* os, int P, int n_out,
                               void* scratch, int ctas, void* out, void* rout, void* stream) {
  using namespace flims;
  if (w < 1 || (w & (w - 1)) || P < 1 || ctas < 1 || (skew && kv)) return cudaErrorInvalidValue;
  const int32_t* v[5] = {(const int32_t*)as, (const int32_t*)al, (const int32_t*)bs,
                         (const int32_t*)bl, (const int32_t*)os};
  auto st = (cudaStream_t)stream;
  auto sc = (unsigned char*)scratch;
  if (dtype == kInt32) {
    if (kv) return wide::run_lanes<int32_t, true, false>(a, ra, b, rb, v, P, n_out, w, sc, ctas, out, rout, st);
    if (skew) return wide::run_lanes<int32_t, false, true>(a, ra, b, rb, v, P, n_out, w, sc, ctas, out, rout, st);
    return wide::run_lanes<int32_t, false, false>(a, ra, b, rb, v, P, n_out, w, sc, ctas, out, rout, st);
  }
  if (dtype == kFloat32) {
    if (kv) return wide::run_lanes<float, true, false>(a, ra, b, rb, v, P, n_out, w, sc, ctas, out, rout, st);
    if (skew) return wide::run_lanes<float, false, true>(a, ra, b, rb, v, P, n_out, w, sc, ctas, out, rout, st);
    return wide::run_lanes<float, false, false>(a, ra, b, rb, v, P, n_out, w, sc, ctas, out, rout, st);
  }
  return cudaErrorInvalidValue;
}

#ifdef WIDE_PROFILE
extern "C" const char* wide_prof_names() {
  return "search,heads,count,butterfly,store,pull,cycles,blocks";
}
extern "C" int wide_prof_read(void* dst) {
  return cudaMemcpyFromSymbol(dst, wide_prof, sizeof(wide_prof));
}
extern "C" int wide_prof_zero() {
  void* p = nullptr;
  const cudaError_t e = cudaGetSymbolAddress(&p, wide_prof);
  return e != cudaSuccess ? e : cudaMemset(p, 0, sizeof(wide_prof));
}
#endif
