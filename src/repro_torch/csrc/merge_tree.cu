// K4: L fused levels of the FLiMS merge tree per output block.
//
// Replaces `_merge_tree_call` (src/repro/kernels/merge_tree.py:319; body
// `tree_dataflow` :178, nested co-rank `_tree_meta_one` :144) behind
// `merge_tree_runs` / `merge_tree_runs_kv`.
//
// One CTA per (group of 2^L runs, C-wide output block), max(w, 32) threads.
// The CTA first computes the nested co-rank partition itself: the root's
// split of the block offset between its children, each child's start
// rounded down to a multiple of w with the residual as the parent's
// initial rotation, recursively down to the leaves. The top search of each
// node is cooperative (coop_search), the nested element lookups inside it
// are per thread. Then the 2^L - 1 windowed dataflows run in post-order:
// inner nodes stream into shared memory (a node at depth d produces
// C/w + d chunks), leaves are read in place from the flat buffer, and only
// the root writes, straight to the group's flat output offset.
//
// Bound: device memory. Each element is read once per pass and written
// once; the inner levels never leave shared memory. At C = 4096, w = 128,
// L = 2 on KV lanes the two inner nodes take 66 KiB of dynamic shared
// memory, which needs the opt-in above 48 KiB.
#include "flims.cuh"

namespace flims {

template <typename T, bool KV, bool DESC> struct Tree {
  const T* k;
  const int32_t* r;
  const int32_t* starts;  // the group's leaf starts and lengths
  const int32_t* lens;
  long long pref[9];      // prefix sums of leaf lengths

  __device__ long long nlen(int lo, int span) const { return pref[lo + span] - pref[lo]; }

  // Element i of the merged sequence of leaves [lo, lo + SPAN), with the
  // guards of `_tree_fns.elem`: position i takes from the right child
  // unless the left child's candidate strictly precedes it.
  template <int SPAN> __device__ Lane<T> elem(int lo, long long i) const {
    Lane<T> v{};
    if constexpr (SPAN == 1) {
      const long long len = lens[lo];
      if (i >= 0 && i < len) {
        v.k = k[starts[lo] + i];
        v.r = KV ? r[starts[lo] + i] : 0;
      }
      return guard<T, DESC>(v, i, len);
    } else {
      const long long len = nlen(lo, SPAN);
      const long long c = corank<SPAN>(lo, i < 0 ? 0 : (i > len ? len : i));
      const Lane<T> ea = elem<SPAN / 2>(lo, c);
      const Lane<T> eb = elem<SPAN / 2>(lo + SPAN / 2, i - c);
      v = wins<T, KV, DESC>(ea, eb) ? ea : eb;
      return guard<T, DESC>(v, i, len);
    }
  }

  template <int SPAN> __device__ bool pred(int lo, long long o, long long m) const {
    constexpr int H = SPAN / 2;
    return wins<T, KV, DESC>(elem<H>(lo, m - 1), elem<H>(lo + H, o - m));
  }

  // Left-child count among the node's top-o, one thread's binary search.
  template <int SPAN> __device__ long long corank(int lo, long long o) const {
    const long long la = nlen(lo, SPAN / 2), lb = nlen(lo + SPAN / 2, SPAN / 2);
    long long a = o - lb > 0 ? o - lb : 0, b = o < la ? o : la;
    while (a < b) {
      const long long m = (a + b + 1) >> 1;
      if (pred<SPAN>(lo, o, m)) a = m; else b = m - 1;
    }
    return a;
  }
};

struct Meta {
  int rot[2 * 7];   // (left, right) initial rotation per internal node, preorder
  int base[8];      // aligned start of each leaf
};

// `_tree_meta_one.assign`: node [lo, lo + SPAN) with preorder index idx
// produces its merged sequence from aligned offset a.
template <int SPAN, typename T, bool KV, bool DESC>
__device__ void assign(const Tree<T, KV, DESC>& tr, Meta& mt, int lo, int idx, int a, int w) {
  if constexpr (SPAN >= 2) {
    constexpr int H = SPAN / 2;
    const long long la = tr.nlen(lo, H), lb = tr.nlen(lo + H, H);
    const int lo_b = (int)(a - lb > 0 ? a - lb : 0), hi_b = (int)(a < la ? a : la);
    const int sx = coop_search(lo_b, hi_b, [&](int m) { return tr.template pred<SPAN>(lo, a, m); });
    const int sy = a - sx;
    mt.rot[2 * idx] = sx % w;
    mt.rot[2 * idx + 1] = sy % w;
    if constexpr (H == 1) {
      mt.base[lo] = sx - sx % w;
      mt.base[lo + 1] = sy - sy % w;
    } else {
      assign<H>(tr, mt, lo, idx + 1, sx - sx % w, w);
      assign<H>(tr, mt, lo + H, idx + H, sy - sy % w, w);
    }
  }
}

template <typename T, bool KV, bool DESC> struct Ctx {
  const Tree<T, KV, DESC>* tr;
  const Meta* mt;
  T* nk;          // inner-node streams, one slot of `slot` elements each
  int32_t* nr;
  int slot;
  T* xk;          // butterfly exchange
  int32_t* xr;
  T* ok;          // root output
  int32_t* orr;
  int valid, C, w;
};

// Post-order production of node [lo, lo + SPAN) with preorder index idx at
// `depth`: children first, then this node's dataflow (`tree_dataflow.produce`).
template <int SPAN, typename T, bool KV, bool DESC>
__device__ void produce(const Ctx<T, KV, DESC>& cx, int lo, int idx, int depth) {
  if constexpr (SPAN >= 2) {
    constexpr int H = SPAN / 2;
    const int w = cx.w;
    const int cycles = cx.C / w + depth;
    if constexpr (H > 1) {
      produce<H>(cx, lo, idx + 1, depth + 1);
      produce<H>(cx, lo + H, idx + H, depth + 1);
      __syncthreads();
    }
    auto child_stream = [&](int cidx) {
      const int rows = cx.C / w + depth + 1;
      return StreamReader<T, KV, DESC>{cx.nk + (long long)(cidx - 1) * cx.slot,
                                       KV ? cx.nr + (long long)(cidx - 1) * cx.slot : nullptr,
                                       rows, w};
    };
    auto leaf = [&](int j) {
      return RunReader<T, KV, DESC>{cx.tr->k, cx.tr->r, cx.tr->starts[j], cx.tr->lens[j],
                                    cx.mt->base[j], w};
    };
    const int lA = cx.mt->rot[2 * idx], lB = cx.mt->rot[2 * idx + 1];
    if (depth == 0) {
      auto write = [&](int t, int c, const Lane<T>& v) {
        const int p = t * w + c;
        if (p < cx.valid) {
          cx.ok[p] = v.k;
          if (KV) cx.orr[p] = v.r;
        }
      };
      const int root_cycles = (cx.valid + w - 1) / w;
      if (H == 1)
        merge_stream<T, KV, DESC, false>(leaf(lo), leaf(lo + 1), lA, lB, root_cycles, write, w,
                                         cx.xk, cx.xr);
      else
        merge_stream<T, KV, DESC, false>(child_stream(idx + 1), child_stream(idx + H), lA, lB,
                                         root_cycles, write, w, cx.xk, cx.xr);
    } else {
      T* sk = cx.nk + (long long)(idx - 1) * cx.slot;
      int32_t* sr = KV ? cx.nr + (long long)(idx - 1) * cx.slot : nullptr;
      auto write = [&](int t, int c, const Lane<T>& v) {
        sk[t * w + c] = v.k;
        if (KV) sr[t * w + c] = v.r;
      };
      if (H == 1)
        merge_stream<T, KV, DESC, false>(leaf(lo), leaf(lo + 1), lA, lB, cycles, write, w,
                                         cx.xk, cx.xr);
      else
        merge_stream<T, KV, DESC, false>(child_stream(idx + 1), child_stream(idx + H), lA, lB,
                                         cycles, write, w, cx.xk, cx.xr);
    }
  }
}

template <typename T, bool KV, bool DESC, int L>
__global__ void merge_tree_kernel(const T* __restrict__ buf, const int32_t* __restrict__ rbuf,
                                  const int32_t* __restrict__ starts,
                                  const int32_t* __restrict__ lens,
                                  const int32_t* __restrict__ goff,
                                  const int32_t* __restrict__ blk0, T* __restrict__ out,
                                  int32_t* __restrict__ out_r, int n_groups, int n_out, int C,
                                  int w, int slot) {
  constexpr int GROUP = 1 << L;
  extern __shared__ __align__(16) unsigned char smem[];
  const int threads = blockDim.x;
  T* xk = reinterpret_cast<T*>(smem);
  int32_t* xr = reinterpret_cast<int32_t*>(xk + threads);
  T* nk = reinterpret_cast<T*>(xr + (KV ? threads : 0));
  int32_t* nr = reinterpret_cast<int32_t*>(nk + (long long)(GROUP - 2) * slot);

  const int g = blockIdx.x;
  if (g >= blk0[n_groups]) return;  // tail CTAs of the static grid
  const int grp = find_segment(blk0, n_groups + 1, g);
  const long long o = (long long)(g - blk0[grp]) * C;
  const long long glen = (long long)goff[grp + 1] - goff[grp];
  // a block never writes past its group, nor past the output
  const int valid = (int)min(min((long long)C, glen - o), (long long)n_out - goff[grp] - o);
  if (valid <= 0) return;

  Tree<T, KV, DESC> tr;
  tr.k = buf;
  tr.r = rbuf;
  tr.starts = starts + (long long)grp * GROUP;
  tr.lens = lens + (long long)grp * GROUP;
  tr.pref[0] = 0;
  for (int j = 0; j < GROUP; ++j) tr.pref[j + 1] = tr.pref[j] + tr.lens[j];

  Meta mt;
  assign<GROUP>(tr, mt, 0, 0, (int)o, w);

  Ctx<T, KV, DESC> cx{&tr, &mt, nk, nr, slot, xk, xr,
                      out + (long long)goff[grp] + o,
                      KV ? out_r + (long long)goff[grp] + o : nullptr,
                      valid, C, w};
  produce<GROUP>(cx, 0, 0, 0);
}

size_t tree_smem_bytes(int L, int kv, int key_bytes, int C, int w, int* slot) {
  const int threads = w < 32 ? 32 : w;
  *slot = (C / w + L - 1) * w;
  const size_t lane = key_bytes + (kv ? 4 : 0);
  return (size_t)threads * lane + (size_t)((1 << L) - 2) * (size_t)(*slot) * lane;
}

template <typename T, bool KV, bool DESC, int L>
static cudaError_t launch(const void* buf, const void* rbuf, const int32_t* starts,
                          const int32_t* lens, const int32_t* goff, const int32_t* blk0,
                          void* out, void* out_r, int n_groups, int n_out, int G, int C,
                          int w, cudaStream_t st) {
  int slot = 0;
  const size_t smem = tree_smem_bytes(L, KV, sizeof(T), C, w, &slot);
  auto kern = merge_tree_kernel<T, KV, DESC, L>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  const int threads = w < 32 ? 32 : w;
  kern<<<G, threads, smem, st>>>((const T*)buf, (const int32_t*)rbuf, starts, lens,
                                         goff, blk0, (T*)out, (int32_t*)out_r, n_groups, n_out,
                                         C, w, slot);
  return cudaGetLastError();
}

template <typename T, bool KV, bool DESC>
static cudaError_t by_level(int L, const void* buf, const void* rbuf, const int32_t* starts,
                            const int32_t* lens, const int32_t* goff, const int32_t* blk0,
                            void* out, void* out_r, int n_groups, int n_out, int G, int C,
                            int w, cudaStream_t st) {
  switch (L) {
    case 1: return launch<T, KV, DESC, 1>(buf, rbuf, starts, lens, goff, blk0, out, out_r, n_groups, n_out, G, C, w, st);
    case 2: return launch<T, KV, DESC, 2>(buf, rbuf, starts, lens, goff, blk0, out, out_r, n_groups, n_out, G, C, w, st);
    case 3: return launch<T, KV, DESC, 3>(buf, rbuf, starts, lens, goff, blk0, out, out_r, n_groups, n_out, G, C, w, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
static cudaError_t dispatch(int kv, int desc, int L, const void* buf, const void* rbuf,
                            const int32_t* starts, const int32_t* lens, const int32_t* goff,
                            const int32_t* blk0, void* out, void* out_r, int n_groups,
                            int n_out, int G, int C, int w, cudaStream_t st) {
  if (!kv && desc) return by_level<T, false, true>(L, buf, rbuf, starts, lens, goff, blk0, out, out_r, n_groups, n_out, G, C, w, st);
  if (kv && desc) return by_level<T, true, true>(L, buf, rbuf, starts, lens, goff, blk0, out, out_r, n_groups, n_out, G, C, w, st);
  if (kv && !desc) return by_level<T, true, false>(L, buf, rbuf, starts, lens, goff, blk0, out, out_r, n_groups, n_out, G, C, w, st);
  return cudaErrorInvalidValue;  // key-only lanes merge descending only
}

}  // namespace flims

extern "C" unsigned long long flims_merge_tree_smem(int L, int kv, int key_bytes, int C, int w) {
  int slot = 0;
  return flims::tree_smem_bytes(L, kv, key_bytes, C, w, &slot);
}

extern "C" int flims_merge_tree(int dtype, int kv, int desc, int L, const void* buf,
                                const void* rbuf, const void* starts, const void* lens,
                                const void* goff, const void* blk0, void* out, void* out_r,
                                int n_groups, int n_out, int G, int C, int w,
                                void* stream) {
  using namespace flims;
  if (w < 1 || w > 1024 || (w & (w - 1)) || C % w || G <= 0) return cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  auto I = [](const void* p) { return (const int32_t*)p; };
  if (dtype == kInt32)
    return dispatch<int32_t>(kv, desc, L, buf, rbuf, I(starts), I(lens), I(goff), I(blk0), out,
                             out_r, n_groups, n_out, G, C, w, st);
  if (dtype == kFloat32)
    return dispatch<float>(kv, desc, L, buf, rbuf, I(starts), I(lens), I(goff), I(blk0), out,
                           out_r, n_groups, n_out, G, C, w, st);
  return cudaErrorInvalidValue;
}
