// The wide forms of K2 / K3, K4, K8 and K9: every FLiMS width w, fused
// level count L and fan-in the JAX kernels take, where the fast kernels'
// warps do not reach (K2 / K3 past w = 1024, K4 / K8 past L = 3 / 4 or
// outside w in [8, 128], K9 past w = 128).
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
// 1. prefix_kernel (one CTA): the leaves' length prefix, and per group its
//    output offset and first block.
// 2. table_kernel, once a level from L - 1 up to 1: every inner node's
//    merged sequence below the root, each element i the winner of the
//    merge-path co-rank of i over its children (the plain version's
//    `_tree_fns.materialize`), so the nested co-rank search of a block stays
//    one level deep, as in the JAX kernel's partition.
// 3. tree_kernel, persistent CTAs over the flat (group, block) list: for
//    each C-wide block the JAX kernel's nested co-ranks (a warp a node,
//    K2's five-step search rounds), then the block's nodes deepest first,
//    each running its C / w + depth FLiMS cycles over its children's
//    streams with the whole CTA: the rotated heads of A and of reversed B
//    (lane i takes the element congruent to i, and to w - 1 - i, mod w, as
//    the JAX kernel's two-row windows do), the selector (XLA's max on K2 /
//    K3's key-only lanes, the element order on K4 / K8's, the compound
//    order on KV lanes), the butterfly over the w lanes in shared memory
//    (device memory past kSmemLanes bytes), a barrier a stage. Inner nodes
//    stream into the CTA's device-memory scratch, the root writes its block
//    straight to the output, clipped at the group's end and at n_out.
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
// searches). These are simple forms, not fast ones: a barrier a butterfly
// stage, one node at a time, the tables and the streams in device memory.
#include <cstdint>
#include <cuda_runtime.h>

#include "flims.cuh"

namespace flims {
namespace wide {

constexpr int kPrefixThreads = 1024;
constexpr int kMaxThreads = 512;
constexpr size_t kSmemLanes = 96 * 1024;  // chunk lanes in shared memory up to this

__host__ __device__ inline int threads_for(int w) {
  const int t = w / 2;
  return t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
}
__host__ __device__ inline size_t lane_bytes(bool kv, int tsize) { return tsize + (kv ? 4 : 0); }
__host__ __device__ inline bool lanes_in_smem(bool kv, int tsize, int w) {
  return (size_t)w * lane_bytes(kv, tsize) <= kSmemLanes;
}
__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// loff: the leaves' length prefix (runs + 1); goff / blk0: each group's
// output offset and first block (groups + 1 each). With `only`, a group
// whose flag is 0 has no block: another kernel writes it. `cap` (0: none)
// is the lanes a level of the tables holds: a group ending past it (runs
// that overlap, longer together than the caller's bound) has no block.
__global__ void __launch_bounds__(kPrefixThreads)
    prefix_kernel(const int32_t* __restrict__ lens, int runs, int group, int C,
                  const int32_t* __restrict__ only, long long cap, int32_t* loff, int32_t* goff,
                  int32_t* blk0) {
  if (only && !only[runs / group]) return;  // no group flagged
  __shared__ int32_t s_part[kPrefixThreads];
  block_scan(runs, [&](int i) { return lens[i]; }, loff, s_part);
  const int groups = runs / group;
  auto glen = [&](int g) { return loff[(g + 1) * group] - loff[g * group]; };
  block_scan(groups, glen, goff, s_part);
  auto blocks = [&](int g) {
    if ((only && !only[g]) || (cap && loff[(g + 1) * group] > cap)) return 0;
    return (glen(g) + C - 1) / C;
  };
  block_scan(groups, blocks, blk0, s_part);
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
};

// The merge-path co-rank of o over (a, b) by one thread, `steps` steps of
// the JAX kernels' binary search.
template <typename T, bool KV, bool DESC>
__device__ int corank1(const Seq<T>& a, const Seq<T>& b, int o, int steps) {
  int lo = max(0, o - b.len), hi = min(o, a.len);
  for (int s = 0; s < steps && lo < hi; ++s) {
    const int mid = lo + ((hi - lo + 1) >> 1);
    if (wins<T, KV, DESC>(at<T, KV, DESC>(a, mid - 1), at<T, KV, DESC>(b, o - mid)))
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// Level d's table: element i of every depth-d node, the winner at the
// co-rank of i over its children (with `only`, of the flagged groups').
template <typename T, bool KV, bool DESC>
__global__ void __launch_bounds__(256)
    table_kernel(Tree<T> tr, int runs, int d, int steps, const int32_t* __restrict__ only, T* tk,
                 int32_t* trk) {
  if (only && !only[runs / tr.group]) return;  // no group flagged
  const int span = tr.group >> d;
  const long long n = min(tr.ntot, (long long)tr.loff[runs]);
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    int lo = 0, hi = runs - 1;  // the run holding e: the last with loff <= e
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (tr.loff[mid] <= e) lo = mid; else hi = mid - 1;
    }
    if (only && !only[lo / tr.group]) continue;
    const int first = lo / tr.group * tr.group + (lo % tr.group) / span * span;
    const int i = (int)(e - tr.loff[first]);
    const Seq<T> a = tr.node(d + 1, first), b = tr.node(d + 1, first + span / 2);
    const int c = corank1<T, KV, DESC>(a, b, i, steps);
    const Lane<T> x = at<T, KV, DESC>(a, c), y = at<T, KV, DESC>(b, i - c);
    const Lane<T> v = pick(wins<T, KV, DESC>(x, y), x, y);
    tk[e] = v.k;
    if (KV) trk[e] = v.r;
  }
}

// The FLiMS cycles of one node over the whole CTA: `cycles` chunks of w
// lanes from sources A (rotation lA) and B (rotation lB) into dst (clipped
// at `valid`). lk / lr: the chunk's lanes; s_cnt: the take count.
template <typename T, bool KV, bool DESC>
__device__ void node_cycles(const Seq<T>& A, const Seq<T>& B, int lA, int lB, int cycles, int w,
                            bool sel_max, T* dk, int32_t* dr, int valid, T* lk, int32_t* lr,
                            int* s_cnt) {
  const int t = threadIdx.x, T_ = blockDim.x;
  int cA = lA, cB = lB;  // heads consumed (with the rotation) on each side
  for (int cyc = 0; cyc < cycles && cyc * w < valid; ++cyc) {
    int took = 0;
    for (int i = t; i < w; i += T_) {
      const int j = w - 1 - i;
      const Lane<T> ca = at<T, KV, DESC>(A, cA + ((i - cA) & (w - 1)));
      const Lane<T> cb = at<T, KV, DESC>(B, cB + ((j - cB) & (w - 1)));
      const bool take = wins<T, KV, DESC>(ca, cb);
      Lane<T> v = pick(take, ca, cb);
      if (!KV && sel_max) v.k = xmax(ca.k, cb.k);
      lk[i] = v.k;
      if (KV) lr[i] = v.r;
      took += take;
    }
    if (took) atomicAdd(s_cnt, took);
    __syncthreads();
    const int taken = *s_cnt;
    for (int d = w >> 1; d >= 1; d >>= 1) {
      for (int p = t; p < (w >> 1); p += T_) {
        const int i = (p / d) * 2 * d + (p % d);
        Lane<T> a{lk[i], KV ? lr[i] : 0}, b{lk[i + d], KV ? lr[i + d] : 0};
        cas_regs<T, KV, DESC>(a, b);
        lk[i] = a.k;
        lk[i + d] = b.k;
        if (KV) {
          lr[i] = a.r;
          lr[i + d] = b.r;
        }
      }
      __syncthreads();
    }
    for (int i = t; i < w && cyc * w + i < valid; i += T_) {
      dk[(size_t)cyc * w + i] = lk[i];
      if (KV) dr[(size_t)cyc * w + i] = lr[i];
    }
    cA += taken;
    cB += w - taken;
    __syncthreads();
    if (t == 0) *s_cnt = 0;
    __syncthreads();
  }
}

// Per-CTA scratch of the tree form: node offsets and rotations (by heap
// index), leaf bases, the inner nodes' streams, the chunk lanes where they
// pass shared memory.
struct TreeScratch {
  size_t a, rot, base, streams, lanes, total, n;  // n: the streams' lanes
  __host__ __device__ TreeScratch(bool kv, int tsize, int L, int w, int C) {
    const int group = 1 << L;
    n = 0;
    for (int d = 1; d < L; ++d) n += ((size_t)1 << d) * ((size_t)C / w + d) * w;
    a = 0;
    rot = align16(a + (size_t)2 * group * 4);
    base = align16(rot + (size_t)4 * group * 4);
    streams = align16(base + (size_t)group * 4);
    lanes = align16(streams + n * lane_bytes(kv, tsize));
    total = align16(lanes + (lanes_in_smem(kv, tsize, w) ? 0 : (size_t)w * lane_bytes(kv, tsize)));
  }
};

// Offset (in lanes) of heap node h's stream among the inner nodes below
// the root (depths 1 .. L - 1, each C / w + depth cycles).
__device__ inline size_t stream_off(int h, int C, int w) {
  const int d = 31 - __clz(h);
  size_t n = 0;
  for (int e = 1; e < d; ++e) n += ((size_t)1 << e) * ((size_t)C / w + e) * w;
  return n + (size_t)(h - (1 << d)) * ((size_t)C / w + d) * w;
}

template <typename T, bool KV, bool DESC>
__global__ void __launch_bounds__(kMaxThreads)
    tree_kernel(Tree<T> tr, const int32_t* __restrict__ goff, const int32_t* __restrict__ blk0,
                int groups, int n_out, int C, int w, int steps, bool sel_max,
                const int32_t* __restrict__ only, unsigned char* scratch, size_t cta_bytes,
                T* out, int32_t* out_r) {
  if (only && !only[groups]) return;  // no group flagged: blk0 was not written
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_cnt;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, warps = blockDim.x >> 5;
  const int L = tr.L, group = tr.group;
  const TreeScratch lay(KV, sizeof(T), L, w, C);
  unsigned char* mine = scratch + (size_t)blockIdx.x * cta_bytes;
  int32_t* s_a = reinterpret_cast<int32_t*>(mine + lay.a);
  int32_t* s_rot = reinterpret_cast<int32_t*>(mine + lay.rot);
  int32_t* s_base = reinterpret_cast<int32_t*>(mine + lay.base);
  T* sk = reinterpret_cast<T*>(mine + lay.streams);
  int32_t* sr = reinterpret_cast<int32_t*>(mine + lay.streams + lay.n * sizeof(T));
  const bool in_smem = lanes_in_smem(KV, sizeof(T), w);
  unsigned char* lanes = in_smem ? smem : mine + lay.lanes;
  T* lk = reinterpret_cast<T*>(lanes);
  int32_t* lr = reinterpret_cast<int32_t*>(lanes + (size_t)w * sizeof(T));
  if (t == 0) s_cnt = 0;
  const int G = blk0[groups];
  for (int g = blockIdx.x; g < G; g += gridDim.x) {
    const int grp = find_segment(blk0, groups + 1, g);
    const int o = (g - blk0[grp]) * C;
    const int glen = goff[grp + 1] - goff[grp];
    const int valid = min(min(C, glen - o), n_out - goff[grp] - o);
    if (valid <= 0) continue;
    const int run0 = grp * group;
    // the nested co-ranks, a warp a node, top down
    if (t == 0) s_a[1] = o;
    __syncthreads();
    for (int d = 0; d < L; ++d) {
      const int span = group >> d;
      for (int q = warp; q < (1 << d); q += warps) {
        const int h = (1 << d) + q, first = run0 + q * span;
        const Seq<T> A = tr.node(d + 1, first), B = tr.node(d + 1, first + span / 2);
        const int a = s_a[h];
        const int sx = corank<T, KV, DESC>(A.k, A.r, A.len, B.k, B.r, B.len, a, steps, lane);
        const int sy = a - sx;
        if (lane == 0) {
          s_rot[2 * h] = sx % w;
          s_rot[2 * h + 1] = sy % w;
          if (d + 1 == L) {
            s_base[q * span] = sx - sx % w;
            s_base[q * span + 1] = sy - sy % w;
          } else {
            s_a[2 * h] = sx - sx % w;
            s_a[2 * h + 1] = sy - sy % w;
          }
        }
      }
      __syncthreads();
    }
    // the nodes, deepest first; a child's source from its stream or run
    auto source = [&](int d, int h, int first) -> Seq<T> {
      if (d == L) {
        const Seq<T> s = tr.leaf(first);
        const int b = s_base[first - run0];
        return Seq<T>{s.k + b, KV ? s.r + b : nullptr, s.len - b};
      }
      const size_t off = stream_off(h, C, w);
      return Seq<T>{sk + off, KV ? sr + off : nullptr, (C / w + d) * w};
    };
    for (int d = L - 1; d >= 0; --d) {
      const int span = group >> d;
      for (int q = 0; q < (1 << d); ++q) {
        const int h = (1 << d) + q, first = run0 + q * span;
        const Seq<T> A = source(d + 1, 2 * h, first), B = source(d + 1, 2 * h + 1, first + span / 2);
        T* dk;
        int32_t* dr = nullptr;
        int n;
        if (d == 0) {
          dk = out + goff[grp] + o;
          if (KV) dr = out_r + goff[grp] + o;
          n = valid;
        } else {
          const size_t off = stream_off(h, C, w);
          dk = sk + off;
          if (KV) dr = sr + off;
          n = (C / w + d) * w;
        }
        node_cycles<T, KV, DESC>(A, B, s_rot[2 * h], s_rot[2 * h + 1], C / w + d, w, sel_max, dk,
                                 dr, n, lk, lr, &s_cnt);
      }
    }
  }
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
};

template <typename T, bool KV, bool DESC>
static cudaError_t run_tree(const TreeArgs& x) {
  const int group = 1 << x.L, groups = x.runs / group;
  int32_t *loff = x.meta, *goff = loff + x.runs + 1, *blk0 = goff + groups + 1;
  prefix_kernel<<<1, kPrefixThreads, 0, x.st>>>((const int32_t*)x.lens, x.runs, group, x.C,
                                                x.only, x.L > 1 ? x.ntot : 0, loff, goff, blk0);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  Tree<T> tr{(const T*)x.ka, (const T*)x.kb, (const int32_t*)x.ra, (const int32_t*)x.rb,
             (const int32_t*)x.starts, (const int32_t*)x.lens, loff, (const T*)x.tables,
             KV && x.tables ? (const int32_t*)((T*)x.tables + (size_t)(x.L - 1) * x.ntot)
                            : nullptr,
             x.ntot, group, x.L, x.pairs};
  for (int d = x.L - 1; d >= 1 && x.ntot > 0; --d) {
    T* tk = (T*)x.tables + (size_t)(d - 1) * x.ntot;
    int32_t* trk = KV ? const_cast<int32_t*>(tr.tr) + (size_t)(d - 1) * x.ntot : nullptr;
    const long long blocks = (x.ntot + 255) / 256;
    table_kernel<T, KV, DESC><<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, x.st>>>(
        tr, x.runs, d, x.steps, x.only, tk, trk);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const TreeScratch lay(KV, sizeof(T), x.L, x.w, x.C);
  const size_t smem = lanes_in_smem(KV, sizeof(T), x.w) ? (size_t)x.w * lane_bytes(KV, sizeof(T)) : 0;
  auto kern = tree_kernel<T, KV, DESC>;
  e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<x.ctas, threads_for(x.w), smem, x.st>>>(tr, goff, blk0, groups, x.n_out, x.C, x.w,
                                                 x.steps, x.sel_max != 0, x.only, x.scratch,
                                                 lay.total, (T*)x.out, (int32_t*)x.out_r);
  return cudaGetLastError();
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

// Per-CTA device-memory scratch of the tree form at (kv, L, w, C), bytes.
extern "C" long long flims_wide_tree_scratch(int kv, int L, int w, int C) {
  if (L < 1 || L > 20 || w < 1 || (w & (w - 1)) || C < w || C % w) return -1;
  return (long long)flims::wide::TreeScratch(kv != 0, 4, L, w, C).total;
}

// meta: runs + 1 + 2 (groups + 1) int32; tables: (L - 1) ntot keys, then
// as many ranks on KV lanes (ntot at least the runs' total length: a
// group ending past it is not merged); scratch: ctas x flims_wide_tree_scratch bytes;
// only: null, or a flag a group (0: the group is left to another kernel)
// and after them one more, 0 where no group is flagged: then every kernel
// of the call returns at once.
extern "C" int flims_wide_tree(int dtype, int kv, int desc, int sel_max, int L, const void* ka,
                               const void* ra, const void* kb, const void* rb, int pairs,
                               const void* starts, const void* lens, int runs, int n_out, int C,
                               int w, int steps, const void* only, void* meta, void* tables,
                               long long ntot, void* scratch, int ctas, void* out, void* out_r,
                               void* stream) {
  using namespace flims;
  if (L < 1 || L > 20 || runs < (1 << L) || runs % (1 << L) || w < 1 || (w & (w - 1)) || C < w ||
      C % w || ctas < 1 || !meta || !scratch || (L > 1 && ntot > 0 && !tables))
    return cudaErrorInvalidValue;
  const wide::TreeArgs x{kv, desc, sel_max, L, pairs, runs, n_out, C, w, steps, ctas,
                         ka, ra, kb, rb, starts, lens, (const int32_t*)only, (int32_t*)meta,
                         tables, ntot, (unsigned char*)scratch, out, out_r,
                         (cudaStream_t)stream};
  if (dtype == kInt32) return wide::tree_dispatch<int32_t>(x);
  if (dtype == kFloat32) return wide::tree_dispatch<float>(x);
  return cudaErrorInvalidValue;
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
