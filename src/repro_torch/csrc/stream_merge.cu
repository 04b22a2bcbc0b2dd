// K8: streaming k-way merge of uniform device-resident runs.
//
// Replaces `_stream_call` (src/repro/kernels/stream_merge.py:225; body
// `_stream_kernel` :101, nested co-rank `_stream_meta_one` :69) behind
// `stream_merge_runs` / `stream_merge_runs_kv`.
//
// One CTA per (group of 2^L uniform runs, C-wide output block), max(w, 32)
// threads; L from 1 to 4. Leaf j of group `grp` is the run at flat offset
// (grp * 2^L + j) * run_len: no starts or lengths arrays.
//
// The partition. The TPU kernel takes, per block, each node's co-rank from
// a nested binary search on the host (`_stream_meta_one`): a node's search
// evaluates elements of its children's merged sequences, each of which is
// a search of its own, so the work grows as (log n)^L and the dependent
// loads as (log n)^(L-1): about 10^4 loads at L = 3 and 10^5 at L = 4 for
// runs of 2^20. K8 finds the same numbers another way. The nested merges
// order a node's elements by key (with rank on KV lanes), then by leaf
// DESCENDING (ties go to the right child at every level), then by
// position, a strict total order. Under it the rank of element p of leaf j
// within a node is p plus, for every other leaf j' of the node, the count
// of its elements that precede it: one binary search per leaf j', all
// independent. The count of leaf j among the node's top-a is then the
// largest p whose element p-1 ranks below a. A node's co-rank is the sum
// of its left leaves' counts; its children's aligned offsets follow, and
// the next level repeats with them. Each level runs every leaf's search at
// once, one team of threads per leaf searching (tpl + 1)-ary over the
// leaf's positions (tpl threads, sub-warp ballots). Below the root a
// leaf's count lies within w - 1 under its count at the parent, so those
// searches take two or three rounds instead of five. Dependent loads:
// about (5 + 2 (L - 1)) rounds x 21 steps at runs of 2^20.
//
// The dataflow. The same windowed FLiMS dataflows as K4 (`merge_stream`)
// in post-order, leaves read in place (rows past a run's end read as
// sentinels in registers), inner nodes streamed through shared memory and
// only the root written, straight to the block's flat offset. Whole leaf
// windows are not staged: at the default plan (C = 4096, w = 128, L = 3)
// they would take 148 KiB key-only and 296 KiB on KV lanes. Inner-node
// streams take two slots per depth, reused across subtrees (a subtree's
// streams are dead once its root's stream is produced): 2 (L - 1) slots
// instead of K4's 2^L - 2, which is what lets L = 4 fit on KV lanes.
//
// CTAs past the last block write the `out_slack` trailing sentinels.
//
// Bound: device memory. Each element is read once per pass and written
// once; the partition's searches read a few hundred elements per CTA.
#include "flims.cuh"

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

template <typename T, bool KV> struct StreamCtx {
  Leaves<T, KV> lv;
  const int* rot;
  const int* base;
  T* nk;  // inner-node slots: two per depth 1 .. L-1
  int32_t* nr;
  T* xk;  // butterfly exchange
  int32_t* xr;
  T* ok;  // root output (the block's flat offset)
  int32_t* orr;
  int C, w;
};

// Element offset of the slot of the node at `depth` on `side` (0 left, 1
// right): a node at depth d produces C/w + d rows.
__host__ __device__ inline long long slot_offset(int depth, int side, int C, int w) {
  long long off = 0;
  for (int e = 1; e < depth; ++e) off += 2LL * (C / w + e) * w;
  return off + (long long)side * (C / w + depth) * w;
}

// Post-order production of heap node h at `depth`, spanning SPAN leaves.
template <int SPAN, int GROUP, typename T, bool KV, bool DESC>
__device__ void sproduce(const StreamCtx<T, KV>& cx, int h, int depth) {
  constexpr int H = SPAN / 2;
  const int w = cx.w, C = cx.C;
  if constexpr (H > 1) {
    sproduce<H, GROUP, T, KV, DESC>(cx, 2 * h, depth + 1);
    sproduce<H, GROUP, T, KV, DESC>(cx, 2 * h + 1, depth + 1);
    __syncthreads();
  }
  auto child_stream = [&](int side) {
    const long long so = slot_offset(depth + 1, side, C, w);
    return StreamReader<T, KV, DESC>{cx.nk + so, KV ? cx.nr + so : nullptr, C / w + depth + 1,
                                     w};
  };
  auto leaf = [&](int j) {
    return RunReader<T, KV, DESC>{cx.lv.k, cx.lv.r,
                                  cx.lv.leaf0 + (long long)j * cx.lv.run_len,
                                  cx.lv.run_len, cx.base[j], w};
  };
  const int lA = cx.rot[2 * h], lB = cx.rot[2 * h + 1];
  auto run = [&](auto write, int cycles) {
    if constexpr (H == 1)
      merge_stream<T, KV, DESC, false>(leaf(2 * h - GROUP), leaf(2 * h + 1 - GROUP), lA, lB,
                                       cycles, write, w, cx.xk, cx.xr);
    else
      merge_stream<T, KV, DESC, false>(child_stream(0), child_stream(1), lA, lB, cycles, write,
                                       w, cx.xk, cx.xr);
  };
  if (depth == 0) {
    run([&](int t, int c, const Lane<T>& v) {
      cx.ok[t * w + c] = v.k;
      if (KV) cx.orr[t * w + c] = v.r;
    }, C / w);
  } else {
    const long long so = slot_offset(depth, h & 1, C, w);
    T* sk = cx.nk + so;
    int32_t* sr = KV ? cx.nr + so : nullptr;
    run([&](int t, int c, const Lane<T>& v) {
      sk[t * w + c] = v.k;
      if (KV) sr[t * w + c] = v.r;
    }, C / w + depth);
  }
}

template <typename T, bool KV, bool DESC, int L>
__global__ void stream_merge_kernel(const T* __restrict__ buf, const int32_t* __restrict__ rbuf,
                                    T* __restrict__ out, int32_t* __restrict__ out_r,
                                    long long n_val, long long n_out, int run_len, int C, int w,
                                    int G, long long slots) {
  constexpr int GROUP = 1 << L;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long s_off[2 * kMaxGroup];
  __shared__ int s_cnt[kMaxGroup], s_rot[2 * kMaxGroup], s_base[kMaxGroup];
  const int threads = blockDim.x;
  const int g = blockIdx.x;
  if (g >= G) {  // the trailing out_slack sentinels
    for (long long p = n_val + (long long)(g - G) * C + threadIdx.x;
         p < n_out && p < n_val + (long long)(g - G + 1) * C; p += threads) {
      out[p] = last_key<T, DESC>();
      if (KV) out_r[p] = kInvalidRank;
    }
    return;
  }
  T* xk = reinterpret_cast<T*>(smem);
  int32_t* xr = reinterpret_cast<int32_t*>(xk + threads);
  T* nk = reinterpret_cast<T*>(xr + (KV ? threads : 0));
  int32_t* nr = reinterpret_cast<int32_t*>(nk + slots);

  const long long glen = (long long)GROUP * run_len;
  const int bpg = (int)(glen / C);
  const long long grp = g / bpg;
  const long long o = (long long)(g % bpg) * C;
  Leaves<T, KV> lv{buf, rbuf, grp * glen, run_len};
  partition<T, KV, DESC, L>(lv, o, w, s_rot, s_base, s_off, s_cnt);

  StreamCtx<T, KV> cx{lv, s_rot, s_base, nk, nr, xk, xr,
                      out + grp * glen + o, KV ? out_r + grp * glen + o : nullptr, C, w};
  sproduce<GROUP, GROUP, T, KV, DESC>(cx, 1, 0);
}

constexpr size_t kStaticSmem = sizeof(long long) * 2 * kMaxGroup + sizeof(int) * 4 * kMaxGroup;

size_t stream_smem_bytes(int L, int kv, int key_bytes, int C, int w, long long* slots) {
  const int threads = w < 32 ? 32 : w;
  *slots = slot_offset(L, 0, C, w);  // everything below depth L
  const size_t lane = key_bytes + (kv ? 4 : 0);
  return (size_t)threads * lane + (size_t)(*slots) * lane;
}

template <typename T, bool KV, bool DESC, int L>
static cudaError_t launch(const void* buf, const void* rbuf, void* out, void* out_r,
                          long long n_val, long long n_out, int run_len, int C, int w, int G,
                          cudaStream_t st) {
  long long slots = 0;
  const size_t smem = stream_smem_bytes(L, KV, sizeof(T), C, w, &slots);
  auto kern = stream_merge_kernel<T, KV, DESC, L>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const int threads = w < 32 ? 32 : w;
  const long long tail = (n_out - n_val + C - 1) / C;
  kern<<<(unsigned)(G + tail), threads, smem, st>>>((const T*)buf, (const int32_t*)rbuf,
                                                   (T*)out, (int32_t*)out_r, n_val, n_out,
                                                   run_len, C, w, G, slots);
  return cudaGetLastError();
}

template <typename T, bool KV, bool DESC>
static cudaError_t by_level(int L, const void* buf, const void* rbuf, void* out, void* out_r,
                            long long n_val, long long n_out, int run_len, int C, int w, int G,
                            cudaStream_t st) {
  switch (L) {
    case 1: return launch<T, KV, DESC, 1>(buf, rbuf, out, out_r, n_val, n_out, run_len, C, w, G, st);
    case 2: return launch<T, KV, DESC, 2>(buf, rbuf, out, out_r, n_val, n_out, run_len, C, w, G, st);
    case 3: return launch<T, KV, DESC, 3>(buf, rbuf, out, out_r, n_val, n_out, run_len, C, w, G, st);
    case 4: return launch<T, KV, DESC, 4>(buf, rbuf, out, out_r, n_val, n_out, run_len, C, w, G, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
static cudaError_t dispatch(int kv, int desc, int L, const void* buf, const void* rbuf,
                            void* out, void* out_r, long long n_val, long long n_out,
                            int run_len, int C, int w, int G, cudaStream_t st) {
  if (!kv && desc) return by_level<T, false, true>(L, buf, rbuf, out, out_r, n_val, n_out, run_len, C, w, G, st);
  if (kv && desc) return by_level<T, true, true>(L, buf, rbuf, out, out_r, n_val, n_out, run_len, C, w, G, st);
  if (kv && !desc) return by_level<T, true, false>(L, buf, rbuf, out, out_r, n_val, n_out, run_len, C, w, G, st);
  return cudaErrorInvalidValue;  // key-only lanes merge descending only
}

}  // namespace flims

extern "C" unsigned long long flims_stream_merge_smem(int L, int kv, int key_bytes, int C,
                                                     int w) {
  long long slots = 0;
  return flims::stream_smem_bytes(L, kv, key_bytes, C, w, &slots) + flims::kStaticSmem;
}

extern "C" int flims_stream_merge(int dtype, int kv, int desc, int L, const void* buf,
                                  const void* rbuf, void* out, void* out_r, long long n_val,
                                  long long n_out, int run_len, int C, int w, int G,
                                  void* stream) {
  using namespace flims;
  if (w < 1 || w > 1024 || (w & (w - 1)) || C < w || C % w || run_len < w || run_len % w ||
      G <= 0 || L < 1 || L > 4 || n_out < n_val || ((long long)run_len << L) % C)
    return cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  if (dtype == kInt32)
    return dispatch<int32_t>(kv, desc, L, buf, rbuf, out, out_r, n_val, n_out, run_len, C, w,
                             G, st);
  if (dtype == kFloat32)
    return dispatch<float>(kv, desc, L, buf, rbuf, out, out_r, n_val, n_out, run_len, C, w, G,
                           st);
  return cudaErrorInvalidValue;
}
