// K9: the sorted-space FLiMS lane merge of every run pair of one tree level.
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
// Bound: bytes, 2 n_out (4 + 4 kv) a level. But a cycle depends on the last
// one's pointers (and, under skew, its dir bits), so a pair run as one chain
// is ceil(n_out / w) dependent cycles, and the top tree levels (few pairs of
// long runs) would run a handful of warps for tens of thousands of cycles.
// The uniform-level form (`level_kernel`, the executor's) cuts each pair's
// chain into blocks of C cycles, one warp a block, C chosen by the caller so
// that a level fills the card; block j restarts at the merge-path co-rank of
// o = j C w (`corank`, K2's search), and block 0 of a pair at (0, 0).
//
// Why the restart is exact. Where both runs are sorted in the selector's
// order (strict `>` key-only, the compound order KV) and hold no NaN,
// `A[pA + i]` going before `B[pB + w - 1 - i]` is monotone in i, so take_a
// is a prefix and a cycle takes the next w elements of the merge path under
// that order; by induction the chain's pA after t cycles is the co-rank of
// t w, and a block started there selects the same lanes in the same places,
// so the butterfly leaves the same bits, +0.0 / -0.0 included. (A chain may
// run into one side's padding where the other side's real keys equal the
// sentinel; from there every output is the sentinel, whose bits are one.)
// Under skew the dir bits depend on the whole history: a tie may be taken
// from either side, so only the values are fixed, and the block form equals
// the chain where values fix the bits: no NaN, and not both +0.0 and -0.0
// in the pair (always, for int32 keys).
//
// The guard. Where a level has more than one block a pair, one pass over
// its keys (`guard_kernel`, in the same call, no host sync) ORs per pair:
// a NaN, a run out of the selector's order, a +0.0 and a -0.0. A pair with
// a NaN or a run out of order, or under skew with both zeros, runs its
// whole chain in its block 0; its other blocks return. So the output is the
// chain's on every input. A level of one block a pair skips the pass.
//
// The cycle (`run_cycles`, shared by the chain and the blocks): lane l of
// the warp holds elements l, l + 32, ... (E = w / 32 of them above w = 32),
// so the stages at d >= 32 stay in registers and the rest are
// `__shfl_xor_sync`; the popcount is `__ballot_sync` / `__popc`; and the
// next cycle's candidate loads are issued as soon as the pointers are known,
// so they are in flight while the butterfly runs.
//
// The ragged form (`ragged_kernel`: pair p from per-pair starts and
// lengths, cut at n_out; only the card tests call it) keeps one warp a pair,
// each running its whole chain.
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "flims.cuh"

namespace flims {
namespace lane {

constexpr int kWarps = 4;          // warps a CTA
constexpr int kGuardThreads = 256;
constexpr int kGuardCtas = 4096;   // the guard's grid-stride cap

// guard bits of a pair
constexpr int32_t kNaN = 1, kUnsorted = 2, kPosZero = 4, kNegZero = 8;

// Whether a pair of these guard bits runs its whole chain.
template <bool SKEW>
__device__ __forceinline__ bool needs_chain(int32_t f) {
  return (f & (kNaN | kUnsorted)) ||
         (SKEW && (f & (kPosZero | kNegZero)) == (kPosZero | kNegZero));
}

// `cycles` FLiMS cycles of one pair (a[0:na], b[0:nb]) from the pointers
// (pA, pB), the first of them cycle c0 of the pair's chain, the dir bits
// clear. Cycle c writes out[c w + i] for i < w, cut at the pair's `total`
// and at `room`.
template <typename T, bool KV, bool SKEW, int W>
__device__ __forceinline__ void run_cycles(const T* __restrict__ a,
                                           const int32_t* __restrict__ ra, int na,
                                           const T* __restrict__ b,
                                           const int32_t* __restrict__ rb, int nb, int pA,
                                           int pB, int c0, int cycles, int total,
                                           long long room, T* __restrict__ out,
                                           int32_t* __restrict__ rout, int lane) {
  constexpr int E = W > 32 ? W / 32 : 1;      // elements a lane
  constexpr int L = W < 32 ? W : 32;          // lanes holding elements
  const bool live = lane < L;
  const unsigned live_mask = L == 32 ? 0xffffffffu : (1u << L) - 1u;
  const T lo = Bounds<T>::lo();

  Lane<T> ca[E], cb[E], x[E];
  bool dirb[E];
  // candidates of a cycle: A[pA + i] and B[pB + w - 1 - i] for element
  // i = e * 32 + lane; past a run's end they read as padding
  auto load = [&](int pa, int pb) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = e * 32 + lane;
      const int ia = pa + i, ib = pb + W - 1 - i;
      const bool va = live && ia < na, vb = live && ib < nb;
      ca[e].k = va ? a[ia] : lo;
      cb[e].k = vb ? b[ib] : lo;
      if (KV) {
        ca[e].r = va ? ra[ia] : kInvalidRank;
        cb[e].r = vb ? rb[ib] : kInvalidRank;
      } else {
        ca[e].r = cb[e].r = 0;
      }
    }
  };

#pragma unroll
  for (int e = 0; e < E; ++e) dirb[e] = false;
  if (cycles > 0) load(pA, pB);
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
      const int pos = (c0 + c) * W + e * 32 + lane;
      if (live && pos < total && pos < room) {
        out[pos] = x[e].k;
        if (KV) rout[pos] = x[e].r;
      }
    }
  }
}

// Ragged pairs, one warp each running its whole chain: pair p merges
// a[a_starts[p] : + a_lens[p]] with b[b_starts[p] : + b_lens[p]] into
// out[out_starts[p] :], cut at n_out.
template <typename T, bool KV, bool SKEW, int W>
__global__ void __launch_bounds__(32 * kWarps)
ragged_kernel(const T* __restrict__ a, const int32_t* __restrict__ ra,
              const T* __restrict__ b, const int32_t* __restrict__ rb,
              const int32_t* __restrict__ a_starts, const int32_t* __restrict__ a_lens,
              const int32_t* __restrict__ b_starts, const int32_t* __restrict__ b_lens,
              const int32_t* __restrict__ out_starts, int pairs, long long n_out,
              T* __restrict__ out, int32_t* __restrict__ rout) {
  const int pair = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (pair >= pairs) return;                  // whole warps leave together
  const long long so = out_starts[pair];
  if (so >= n_out) return;
  const long long sa = a_starts[pair], sb = b_starts[pair];
  const int na = a_lens[pair], nb = b_lens[pair];
  const int total = na + nb;
  run_cycles<T, KV, SKEW, W>(a + sa, KV ? ra + sa : nullptr, na, b + sb,
                             KV ? rb + sb : nullptr, nb, 0, 0, 0, (total + W - 1) / W,
                             total, n_out - so, out + so, KV ? rout + so : nullptr,
                             threadIdx.x & 31);
}

// A uniform level: pair p merges runs 2p and 2p + 1 of run_len keys of
// `keys` into out[2 p run_len :]. Warp g runs block g % bpp of pair
// g / bpp: at most cpb cycles from cycle (g % bpp) cpb of the chain,
// from the co-rank of its first output; with `flags` a pair the guard
// flagged runs its whole chain in its block 0 instead.
template <typename T, bool KV, bool SKEW, int W>
__global__ void __launch_bounds__(32 * kWarps)
level_kernel(const T* __restrict__ keys, const int32_t* __restrict__ ranks, int run_len,
             int pairs, int bpp, int cpb, const int32_t* __restrict__ flags,
             T* __restrict__ out, int32_t* __restrict__ rout) {
  const long long g = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (g >= (long long)pairs * bpp) return;    // whole warps leave together
  const int pair = (int)(g / bpp), j = (int)(g % bpp);
  const int lane = threadIdx.x & 31;
  const long long so = 2LL * run_len * pair;
  const T* a = keys + so;
  const T* b = a + run_len;
  const int32_t* ra = KV ? ranks + so : nullptr;
  const int32_t* rb = KV ? ra + run_len : nullptr;
  const int total = 2 * run_len, chain = (total + W - 1) / W;
  const int c0 = j * cpb;
  int cycles = min(cpb, chain - c0), pA = 0, pB = 0;
  if (cycles <= 0) return;
  if (flags != nullptr && needs_chain<SKEW>(flags[pair])) {
    if (j > 0) return;
    cycles = chain;
  } else if (j > 0) {
    const int o = c0 * W;
    pA = corank<T, KV, true>(a, ra, run_len, b, rb, run_len, o, 32, lane);
    pB = o - pA;
  }
  run_cycles<T, KV, SKEW, W>(a, ra, run_len, b, rb, run_len, pA, pB, c0, cycles, total,
                             total, out + so, KV ? rout + so : nullptr, lane);
}

// The guard bits of one key.
template <typename T, bool SKEW>
__device__ __forceinline__ int32_t key_bits(T k) {
  if constexpr (std::is_same<T, float>::value) {
    int32_t bits = k != k ? kNaN : 0;
    if (SKEW) {
      const int32_t kb = __float_as_int(k);
      bits |= kb == 0 ? kPosZero : (kb == (int32_t)0x80000000 ? kNegZero : 0);
    }
    return bits;
  }
  return 0;
}

// One pass over a level's n keys, V consecutive keys a thread (V = 8 read
// as two 16-byte loads where run_len is a multiple of 8 and the keys are
// 16-byte aligned, else 1): flags[p] |= the guard bits of pair p's keys (a
// NaN, a +0.0 / -0.0 under skew, a key out of the selector's order after
// its run's previous one). flags is zeroed before.
template <typename T, bool KV, bool SKEW, int V>
__global__ void __launch_bounds__(kGuardThreads)
guard_kernel(const T* __restrict__ keys, const int32_t* __restrict__ ranks, int run_len,
             long long n, int32_t* __restrict__ flags) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kGuardThreads * V;
  for (long long base = ((long long)blockIdx.x * kGuardThreads + (threadIdx.x & ~31)) * V;
       base < n; base += stride) {             // warp-uniform
    const long long i0 = base + (long long)lane * V;
    const int pair = (int)(min(i0, n - 1) / (2LL * run_len));
    int32_t bits = 0;
    if (i0 < n) {
      T k[V + 1];
      if constexpr (V == 8) {
        const int4 u0 = *reinterpret_cast<const int4*>(keys + i0);
        const int4 u1 = *reinterpret_cast<const int4*>(keys + i0 + 4);
        const int32_t raw[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if constexpr (std::is_same<T, float>::value) k[j] = __int_as_float(raw[j]);
          else k[j] = raw[j];
        }
      } else {
        k[0] = keys[i0];
      }
      // the next key, where it follows in the same run (V divides run_len)
      const bool more = (i0 + V) % run_len != 0;
      k[V] = more ? keys[i0 + V] : k[V - 1];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        bits |= key_bits<T, SKEW>(k[j]);
        bool late = k[j + 1] > k[j];
        if (KV && k[j + 1] == k[j] && (j + 1 < V || more))
          late = late || ranks[i0 + j + 1] < ranks[i0 + j];
        if (late) bits |= kUnsorted;
      }
    }
    const int p0 = __shfl_sync(kFullWarp, pair, 0);
    if (__all_sync(kFullWarp, pair == p0)) {
      const int32_t any = (int32_t)__reduce_or_sync(kFullWarp, (unsigned)bits);
      if (lane == 0 && any) atomicOr(&flags[p0], any);
    } else if (bits) {
      atomicOr(&flags[pair], bits);
    }
  }
}

template <typename T, bool KV, bool SKEW, int W>
struct Launch {
  static cudaError_t ragged(const void* a, const int32_t* ra, const void* b,
                            const int32_t* rb, const int32_t* as, const int32_t* al,
                            const int32_t* bs, const int32_t* bl, const int32_t* os,
                            int pairs, long long n_out, void* out, int32_t* rout,
                            cudaStream_t st) {
    const int grid = (pairs + kWarps - 1) / kWarps;
    ragged_kernel<T, KV, SKEW, W><<<grid, 32 * kWarps, 0, st>>>(
        (const T*)a, ra, (const T*)b, rb, as, al, bs, bl, os, pairs, n_out, (T*)out, rout);
    return cudaGetLastError();
  }
  static cudaError_t level(const void* keys, const int32_t* ranks, int run_len, int pairs,
                           int cpb, int32_t* flags, void* out, int32_t* rout,
                           cudaStream_t st) {
    const int chain = (2 * run_len + W - 1) / W;
    const int bpp = (chain + cpb - 1) / cpb;
    if (bpp > 1) {
      if (flags == nullptr) return cudaErrorInvalidValue;
      const long long n = 2LL * run_len * pairs;
      cudaError_t e = cudaMemsetAsync(flags, 0, sizeof(int32_t) * (size_t)pairs, st);
      if (e != cudaSuccess) return e;
      const bool vec = run_len % 8 == 0 && !(reinterpret_cast<uintptr_t>(keys) & 15);
      const long long need = (n + kGuardThreads * 8LL - 1) / (kGuardThreads * 8LL);
      const int grid = (int)(need < kGuardCtas ? need : kGuardCtas);
      if (vec)
        guard_kernel<T, KV, SKEW, 8><<<grid, kGuardThreads, 0, st>>>(
            (const T*)keys, ranks, run_len, n, flags);
      else
        guard_kernel<T, KV, SKEW, 1><<<grid, kGuardThreads, 0, st>>>(
            (const T*)keys, ranks, run_len, n, flags);
      e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
    const long long warps = (long long)pairs * bpp;
    const long long grid = (warps + kWarps - 1) / kWarps;
    if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
    level_kernel<T, KV, SKEW, W><<<(unsigned)grid, 32 * kWarps, 0, st>>>(
        (const T*)keys, ranks, run_len, pairs, bpp, cpb, bpp > 1 ? flags : nullptr, (T*)out,
        rout);
    return cudaGetLastError();
  }
  static cudaError_t occupancy(int* warps) {
    int per_sm = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, level_kernel<T, KV, SKEW, W>, 32 * kWarps, 0);
    *warps = per_sm * kWarps;
    return e;
  }
};

// F(Launch<T, KV, SKEW, W>) for the call's dtype, kv, skew and w.
template <typename F>
cudaError_t dispatch(int dtype, int kv, int skew, int w, F&& f) {
  if ((kv && skew) || dtype < 0 || dtype > 1) return cudaErrorInvalidValue;
  auto by_w = [&](auto t, auto k, auto s) -> cudaError_t {
    using T = typename decltype(t)::type;
    constexpr bool KV = decltype(k)::value, SKEW = decltype(s)::value;
    switch (w) {
      case 1: return f(Launch<T, KV, SKEW, 1>{});
      case 2: return f(Launch<T, KV, SKEW, 2>{});
      case 4: return f(Launch<T, KV, SKEW, 4>{});
      case 8: return f(Launch<T, KV, SKEW, 8>{});
      case 16: return f(Launch<T, KV, SKEW, 16>{});
      case 32: return f(Launch<T, KV, SKEW, 32>{});
      case 64: return f(Launch<T, KV, SKEW, 64>{});
      case 128: return f(Launch<T, KV, SKEW, 128>{});
      default: return cudaErrorInvalidValue;
    }
  };
  using B = std::true_type;
  using N = std::false_type;
  auto by_mode = [&](auto t) -> cudaError_t {
    if (kv) return by_w(t, B{}, N{});
    if (skew) return by_w(t, N{}, B{});
    return by_w(t, N{}, N{});
  };
  if (dtype == 0) return by_mode(std::common_type<int32_t>{});
  return by_mode(std::common_type<float>{});
}

}  // namespace lane
}  // namespace flims

// dtype 0 int32, 1 float32; kv: ranks ride with the keys under the compound
// order; skew: algorithm 2's selector (key-only).
//
// With starts and lengths (ragged): pair p merges a[a_starts[p] : +
// a_lens[p]] with b[b_starts[p] : + b_lens[p]] into out[out_starts[p] :], cut
// at n_out, one warp a pair; mode, cpb and flags are not read.
//
// With null starts and lengths (a uniform level): pair p merges
// a[2 p run_len : + run_len] with a[(2 p + 1) run_len : + run_len] into
// out[2 p run_len :] (b and rb are not read; n_out is 2 pairs run_len).
// mode 0: blocks of cpb cycles, each restarted at its co-rank, with the
// guard's per-pair bits in `flags` (pairs int32 of scratch) where a pair
// has more than one block; mode 1: the whole chain, one warp a pair.
extern "C" int flims_lane_merge(int dtype, int kv, int skew, int w, int mode, const void* a,
                                const void* ra, const void* b, const void* rb,
                                const void* a_starts, const void* a_lens,
                                const void* b_starts, const void* b_lens,
                                const void* out_starts, int run_len, int pairs, int cpb,
                                void* flags, long long n_out, void* out, void* rout,
                                void* stream) {
  using namespace flims::lane;
  if (pairs <= 0 || n_out <= 0) return 0;
  auto st = (cudaStream_t)stream;
  auto r32 = [](const void* p) { return (const int32_t*)p; };
  if (a_starts != nullptr) {
    return dispatch(dtype, kv, skew, w, [&](auto l) {
      return decltype(l)::ragged(a, r32(ra), b, r32(rb), r32(a_starts), r32(a_lens),
                                 r32(b_starts), r32(b_lens), r32(out_starts), pairs,
                                 n_out, out, (int32_t*)rout, st);
    });
  }
  if (run_len <= 0 || (mode != 0 && mode != 1) || (mode == 0 && cpb <= 0))
    return cudaErrorInvalidValue;
  const int chain = (int)((2LL * run_len + w - 1) / w);
  return dispatch(dtype, kv, skew, w, [&](auto l) {
    return decltype(l)::level(a, r32(ra), run_len, pairs, mode == 1 ? chain : cpb,
                              (int32_t*)flags, out, (int32_t*)rout, st);
  });
}

// Warps of the uniform-level kernel an SM holds.
extern "C" int flims_lane_merge_occupancy(int dtype, int kv, int skew, int w) {
  using namespace flims::lane;
  int warps = 0;
  const cudaError_t e =
      dispatch(dtype, kv, skew, w, [&](auto l) { return decltype(l)::occupancy(&warps); });
  return e != cudaSuccess ? -(int)e : warps;
}
