// K9: the sorted-space FLiMS lane merge of every run pair of one tree level,
// one warp a pair.
//
// No `pl.pallas_call` of the JAX package corresponds: its `tree_vmapped`
// executor (`engine/schedule.py` `_vmapped_reduce`) merges each level's pairs
// with `jax.vmap(merge_lanes)` (`core/lanes.py`), a `lax.scan` over
// ceil(n_out / w) FLiMS cycles that XLA runs as a loop on the device. This
// kernel is that scan: per cycle the next w candidates of A and of reversed
// B, the selector (algorithm 1's `key_compare`, ties to B; algorithm 2's
// skew selector, its dir bit `~take_a` carried per lane; algorithm 3's
// compound (key, rank) order), the log2(w)-stage butterfly by
// compare-and-select (not XLA's max / min: +-0 and NaN payloads leave as
// `merge_lanes` leaves them), the pointers advanced by the popcount of
// take_a. Bit for bit `merge_lanes` on each pair.
//
// Bound: a cycle depends on the last one's pointers (and, under skew, its dir
// bits), so a pair is one chain of ceil(n_out / w) cycles and the top tree
// levels, few pairs of long runs, are latency-bound far above their bytes
// (2 n_out (4 + 4 kv) a level). The design shortens the chain's step: lane l
// of the warp holds elements l, l + 32, ... (E = w / 32 of them above w =
// 32), so the stages at d >= 32 stay in registers and the rest are
// `__shfl_xor_sync`; the popcount is `__ballot_sync` / `__popc`; and the next
// cycle's candidate loads are issued as soon as the pointers are known, so
// they are in flight while the butterfly runs.
#include <cstdint>
#include <cuda_runtime.h>

#include "flims.cuh"

namespace flims {
namespace lane {

constexpr int kWarps = 4;  // pairs a CTA

template <typename T, bool KV, bool SKEW, int W>
__global__ void __launch_bounds__(32 * kWarps)
lane_merge_kernel(const T* __restrict__ a, const int32_t* __restrict__ ra,
                  const T* __restrict__ b, const int32_t* __restrict__ rb,
                  const int32_t* __restrict__ a_starts, const int32_t* __restrict__ a_lens,
                  const int32_t* __restrict__ b_starts, const int32_t* __restrict__ b_lens,
                  const int32_t* __restrict__ out_starts, int run_len, int pairs,
                  long long n_out, T* __restrict__ out, int32_t* __restrict__ rout) {
  constexpr int E = W > 32 ? W / 32 : 1;      // elements a lane
  constexpr int L = W < 32 ? W : 32;          // lanes holding elements
  const int pair = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (pair >= pairs) return;                  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const bool live = lane < L;
  const unsigned live_mask = L == 32 ? 0xffffffffu : (1u << L) - 1u;
  // a uniform level (no starts) merges runs 2p and 2p + 1 of run_len keys
  const bool uniform = a_starts == nullptr;
  const long long so = uniform ? 2LL * run_len * pair : out_starts[pair];
  const long long sa = uniform ? so : a_starts[pair];
  const long long sb = uniform ? so + run_len : b_starts[pair];
  const int na = uniform ? run_len : a_lens[pair];
  const int nb = uniform ? run_len : b_lens[pair];
  const int total = na + nb;
  const int cycles = (total + W - 1) / W;
  const T lo = Bounds<T>::lo();

  Lane<T> ca[E], cb[E], x[E];
  bool dirb[E];
  // candidates of a cycle: A[pA + i] and B[pB + w - 1 - i] for element
  // i = e * 32 + lane; past a run's end they read as padding
  auto load = [&](int pA, int pB) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = e * 32 + lane;
      const int ia = pA + i, ib = pB + W - 1 - i;
      const bool va = live && ia < na, vb = live && ib < nb;
      ca[e].k = va ? a[sa + ia] : lo;
      cb[e].k = vb ? b[sb + ib] : lo;
      if (KV) {
        ca[e].r = va ? ra[sa + ia] : kInvalidRank;
        cb[e].r = vb ? rb[sb + ib] : kInvalidRank;
      } else {
        ca[e].r = cb[e].r = 0;
      }
    }
  };

#pragma unroll
  for (int e = 0; e < E; ++e) dirb[e] = false;
  int pA = 0, pB = 0;
  if (cycles > 0) load(0, 0);
  for (int c = 0; c < cycles; ++c) {
    // the selector: take A's candidate where it wins
    int k = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      bool take = wins<T, KV, true>(ca[e], cb[e]);
      if (SKEW) take = take | ((ca[e].k == cb[e].k) & dirb[e]);
      x[e] = take ? ca[e] : cb[e];
      dirb[e] = !take;
      k += __popc(__ballot_sync(0xffffffffu, take) & live_mask);
    }
    pA += k;
    pB += W - k;
    if (c + 1 < cycles) load(pA, pB);         // in flight during the butterfly
    // the butterfly, d = w/2 .. 1: x[i] and x[i + d] of each 2d-block, the
    // winner first (a select: a pair neither of which wins swaps)
#pragma unroll
    for (int d = W / 2; d >= 32; d >>= 1) {
      const int de = d / 32;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (e & de) continue;
        const Lane<T> t = x[e], u = x[e | de];
        const bool m = wins<T, KV, true>(t, u);
        x[e] = m ? t : u;
        x[e | de] = m ? u : t;
      }
    }
#pragma unroll
    for (int d = (W < 32 ? W : 32) / 2; d >= 1; d >>= 1) {
      const bool top = (lane & d) == 0;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        Lane<T> p;
        p.k = __shfl_xor_sync(0xffffffffu, x[e].k, d);
        p.r = KV ? __shfl_xor_sync(0xffffffffu, x[e].r, d) : 0;
        const Lane<T> t = top ? x[e] : p, u = top ? p : x[e];
        const bool m = wins<T, KV, true>(t, u);
        x[e] = top == m ? t : u;
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int pos = c * W + e * 32 + lane;
      if (live && pos < total && so + pos < n_out) {
        out[so + pos] = x[e].k;
        if (KV) rout[so + pos] = x[e].r;
      }
    }
  }
}

template <typename T, bool KV, bool SKEW, int W>
cudaError_t launch_w(const void* a, const int32_t* ra, const void* b, const int32_t* rb,
                     const int32_t* as, const int32_t* al, const int32_t* bs,
                     const int32_t* bl, const int32_t* os, int run_len, int pairs,
                     long long n_out, void* out, int32_t* rout, cudaStream_t st) {
  const int grid = (pairs + kWarps - 1) / kWarps;
  lane_merge_kernel<T, KV, SKEW, W><<<grid, 32 * kWarps, 0, st>>>(
      (const T*)a, ra, (const T*)b, rb, as, al, bs, bl, os, run_len, pairs, n_out, (T*)out,
      rout);
  return cudaGetLastError();
}

template <typename T, bool KV, bool SKEW>
cudaError_t launch(int w, const void* a, const int32_t* ra, const void* b,
                   const int32_t* rb, const int32_t* as, const int32_t* al,
                   const int32_t* bs, const int32_t* bl, const int32_t* os, int run_len,
                   int pairs, long long n_out, void* out, int32_t* rout, cudaStream_t st) {
#define K9_W(WW)                                                                      \
  case WW:                                                                            \
    return launch_w<T, KV, SKEW, WW>(a, ra, b, rb, as, al, bs, bl, os, run_len, pairs, \
                                     n_out, out, rout, st);
  switch (w) {
    K9_W(1) K9_W(2) K9_W(4) K9_W(8) K9_W(16) K9_W(32) K9_W(64) K9_W(128)
    default: return cudaErrorInvalidValue;
  }
#undef K9_W
}

}  // namespace lane
}  // namespace flims

// dtype 0 int32, 1 float32; kv: ranks ride with the keys under the compound
// order; skew: algorithm 2's selector (key-only). Pair p merges
// a[a_starts[p] : + a_lens[p]] with b[b_starts[p] : + b_lens[p]] into
// out[out_starts[p] :], cut at n_out. With null starts and lengths the level
// is uniform: pair p merges a[2 p run_len : + run_len] with
// b[(2 p + 1) run_len : + run_len] into out[2 p run_len :].
extern "C" int flims_lane_merge(int dtype, int kv, int skew, int w, const void* a,
                                const void* ra, const void* b, const void* rb,
                                const void* a_starts, const void* a_lens,
                                const void* b_starts, const void* b_lens,
                                const void* out_starts, int run_len, int pairs,
                                long long n_out, void* out, void* rout, void* stream) {
  using namespace flims::lane;
  if (pairs <= 0 || n_out <= 0) return 0;
  if ((kv && skew) || dtype < 0 || dtype > 1) return cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  auto r32 = [](const void* p) { return (const int32_t*)p; };
#define K9_CALL(T, KV, SKEW)                                                              \
  return launch<T, KV, SKEW>(w, a, r32(ra), b, r32(rb), r32(a_starts), r32(a_lens),      \
                             r32(b_starts), r32(b_lens), r32(out_starts), run_len,       \
                             pairs, n_out, out, (int32_t*)rout, st)
  if (dtype == 0) {
    if (kv) K9_CALL(int32_t, true, false);
    if (skew) K9_CALL(int32_t, false, true);
    K9_CALL(int32_t, false, false);
  }
  if (kv) K9_CALL(float, true, false);
  if (skew) K9_CALL(float, false, true);
  K9_CALL(float, false, false);
#undef K9_CALL
}
