// Shared FLiMS routines for the Hopper kernels: key bounds, XLA's max/min,
// the compound (key, rank) order, the shared-memory bitonic network, the
// FLiMS butterfly run by one warp (K2 / K3, K4, K8), the merge-path co-rank
// search (K2 / K3, K9), mbarriers, 1-D bulk copies and cp.async.
//
// Counterpart of what the JAX package shares between `_merge_kernel` /
// `_merge_kv_kernel` (kernels/flims_merge.py) and `tree_dataflow`
// (kernels/merge_tree.py).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace flims {

constexpr int32_t kInvalidRank = 0x7fffffff;       // INVALID_RANK
constexpr int32_t kRankLo = -0x7fffffff - 1;       // _RANK_LO

template <typename T> struct Bounds;
template <> struct Bounds<int32_t> {
  __device__ static int32_t lo() { return -0x7fffffff - 1; }
  __device__ static int32_t hi() { return 0x7fffffff; }
};
template <> struct Bounds<float> {
  __device__ static float lo() { return -__int_as_float(0x7f800000); }
  __device__ static float hi() { return __int_as_float(0x7f800000); }
};

// (first, last): keys sorting before / after everything real.
template <typename T, bool DESC> __device__ __forceinline__ T first_key() {
  return DESC ? Bounds<T>::hi() : Bounds<T>::lo();
}
template <typename T, bool DESC> __device__ __forceinline__ T last_key() {
  return DESC ? Bounds<T>::lo() : Bounds<T>::hi();
}

// XLA's maximum/minimum, which the key-only JAX kernels use: a NaN operand
// wins, and of a +0/-0 pair max gives +0 and min gives -0 whatever the
// order. Of two NaNs, max(a, b) is a if a's sign bit is set, else b, and
// min(a, b) is b if a's sign bit is set, else a: the rule jnp.maximum /
// jnp.minimum follow on the CPU (jax 0.9.0), in the JAX kernels too. fmaxf
// promises none of it, so the rule is spelled out, as selects: a branch per
// lane would diverge the warp. Callers keep the JAX kernels' operand order.
// xsel(a, b, hi) is max(a, b) where `hi`, else min(a, b): one chain of
// selects for a lane that keeps one side of a compare-exchange.
__device__ __forceinline__ int32_t xsel(int32_t a, int32_t b, bool hi) {
  return (hi ? a > b : a < b) ? a : b;
}
__device__ __forceinline__ float xsel(float a, float b, bool hi) {
  const int32_t ai = __float_as_int(a), bi = __float_as_int(b);
  float r = (hi ? a > b : a < b) ? a : b;
  r = a == b ? __int_as_float(hi ? ai & bi : ai | bi) : r;
  r = b != b ? b : r;
  return a != a && (b == b || (ai < 0) == hi) ? a : r;
}
template <typename T> __device__ __forceinline__ T xmax(T a, T b) { return xsel(a, b, true); }
template <typename T> __device__ __forceinline__ T xmin(T a, T b) { return xsel(a, b, false); }

// float bits <-> monotone int32 (its own inverse). On NaN-free floats the
// integer max / min of these are XLA's max / min, -0 below +0.
__device__ __forceinline__ int32_t mono(int32_t b) { return b ^ ((b >> 31) & 0x7fffffff); }

// One lane: a key and, on KV lanes, its int32 rank.
template <typename T> struct Lane {
  T k;
  int32_t r;
};

// "x goes first": key-only lanes use the strict descending key order
// (ties dequeue from B, algorithm 1); KV lanes the compound order (key in
// the call's direction, rank ascending: algorithm 3).
template <typename T, bool KV, bool DESC>
__device__ __forceinline__ bool wins(const Lane<T>& x, const Lane<T>& y) {
  if (!KV) return x.k > y.k;
  if (DESC) return (x.k > y.k) | ((x.k == y.k) & (x.r < y.r));
  return (x.k < y.k) | ((x.k == y.k) & (x.r < y.r));
}

// a if `keep`, else b, lane by lane without a branch.
template <typename T>
__device__ __forceinline__ Lane<T> pick(bool keep, const Lane<T>& a, const Lane<T>& b) {
  Lane<T> v;
  v.k = keep ? a.k : b.k;
  v.r = keep ? a.r : b.r;
  return v;
}

// The static bitonic network over the c = 2^logc lanes of shared memory
// (K5's segment sort at c = 32768): every thread of
// the CTA runs compare-exchanges j = threadIdx.x, += blockDim.x, with a
// barrier after each stage. The direction rule (first // k) % 2 is the TPU
// kernels' (`_stage_masks`). Key-only lanes sort descending with XLA's
// max/min; KV lanes by the compound order (key in the call's direction,
// rank ascending). The caller syncs before: the lanes must be in place.
template <typename T, bool KV, bool DESC>
__device__ void bitonic_smem(T* sk, int32_t* sr, int logc) {
  const int half = (1 << logc) >> 1;
  for (int lk = 1; lk <= logc; ++lk) {
    for (int ld = lk - 1; ld >= 0; --ld) {
      const int d = 1 << ld;
      for (int j = threadIdx.x; j < half; j += blockDim.x) {
        const int first = ((j >> ld) << (ld + 1)) + (j & (d - 1));
        const int second = first + d;
        const bool asc = (first >> lk) & 1;  // odd k-blocks reverse
        const T kt = sk[first], kb = sk[second];
        if (KV) {
          const int32_t rt = sr[first], rb = sr[second];
          const bool top_first = DESC ? (kt > kb || (kt == kb && rt < rb))
                                      : (kt < kb || (kt == kb && rt < rb));
          if (!(top_first ^ asc)) {
            sk[first] = kb; sk[second] = kt;
            sr[first] = rb; sr[second] = rt;
          }
        } else {
          const T mx = xmax(kt, kb), mn = xmin(kt, kb);
          sk[first] = asc ? mn : mx;
          sk[second] = asc ? mx : mn;
        }
      }
      __syncthreads();
    }
  }
}

// Opt in to more than 48 KB of dynamic shared memory where a launch needs it.
template <class K>
__host__ cudaError_t allow_smem(K kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Warp-synchronous FLiMS (K2 / K3, K4, K8): one warp runs one w-wide
// dataflow, thread t holding lanes t, t + 32, ... (M = w/32 of them; lane
// t < w for w < 32). Lane i owns head i of A and head w-1-i of B, so the
// MAX selector pairs a_i with b_{w-1-i} without a reversal; every control
// value (rotations, rows, the count taken from A) is uniform across the
// warp.
constexpr unsigned kFullWarp = 0xffffffffu;

// One compare-exchange of lanes (top, bottom) within a thread's registers:
// key-only lanes take XLA's max (top) / min (bottom), as `_butterfly_desc`
// does; KV lanes the compound order, as `_butterfly_kv` does.
template <typename T, bool KV, bool DESC>
__device__ __forceinline__ void cas_regs(Lane<T>& top, Lane<T>& bot) {
  if (KV) {
    const bool keep = wins<T, KV, DESC>(top, bot);
    const Lane<T> x = top;
    top = pick(keep, top, bot);
    bot = pick(keep, bot, x);
  } else {
    const T hi = xmax(top.k, bot.k), lo = xmin(top.k, bot.k);
    top.k = hi;
    bot.k = lo;
  }
}

// The butterfly CAS network over the warp's M lanes per thread, stages at
// w/2 .. 1: stages d >= 32 pair registers of one thread (slot m with m ^
// d/32), stages d < 32 shuffle. Lanes >= w (w < 32) shuffle too and are
// ignored.
template <typename T, bool KV, bool DESC, int M>
__device__ __forceinline__ void warp_butterfly(Lane<T> (&v)[M], int w) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int dd = M / 2; dd >= 1; dd >>= 1) {
#pragma unroll
    for (int m = 0; m < M; ++m)
      if (!(m & dd)) cas_regs<T, KV, DESC>(v[m], v[m | dd]);
  }
  const int d0 = M > 1 ? 16 : (w >> 1);
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1) {
    if (d > d0) continue;
    const bool top = (lane & d) == 0;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      Lane<T> p;
      p.k = __shfl_xor_sync(kFullWarp, v[m].k, d);
      p.r = KV ? __shfl_xor_sync(kFullWarp, v[m].r, d) : 0;
      if (KV) {
        // keep = top ? wins(v, p) : wins(p, v), as one compare of picked
        // operands
        const bool keep = wins<T, KV, DESC>(pick(top, v[m], p), pick(top, p, v[m]));
        v[m] = pick(keep, v[m], p);
      } else {
        v[m].k = top ? xmax(v[m].k, p.k) : xmin(p.k, v[m].k);
      }
    }
  }
}

// warp_butterfly where key-only float lanes may hold no NaN (K2, K8): a warp
// without one runs on the monotone int32 bits, whose integer max / min are
// XLA's there (-0 below +0); a NaN keeps the float selects.
template <typename T, bool KV, bool DESC, int M>
__device__ __forceinline__ void warp_butterfly_mono(Lane<T> (&v)[M], int w) {
  if constexpr (!KV && std::is_same<T, float>::value) {
    bool nan = false;
#pragma unroll
    for (int m = 0; m < M; ++m) nan |= v[m].k != v[m].k;
    if (!__any_sync(kFullWarp, nan)) {
      Lane<int32_t> u[M];
#pragma unroll
      for (int m = 0; m < M; ++m) u[m] = Lane<int32_t>{mono(__float_as_int(v[m].k)), 0};
      warp_butterfly<int32_t, false, DESC, M>(u, w);
#pragma unroll
      for (int m = 0; m < M; ++m) v[m].k = __int_as_float(mono(u[m].k));
      return;
    }
  }
  warp_butterfly<T, KV, DESC, M>(v, w);
}

// Element i of a run, with the co-rank guards: the first key (and _RANK_LO)
// before 0, the last key (and INVALID_RANK) from len on.
template <typename T, bool KV, bool DESC>
__device__ __forceinline__ Lane<T> guarded(const T* k, const int32_t* r, int len, int i) {
  Lane<T> v;
  if (i < 0) {
    v.k = first_key<T, DESC>();
    v.r = kRankLo;
  } else if (i >= len) {
    v.k = last_key<T, DESC>();
    v.r = kInvalidRank;
  } else {
    v.k = k[i];
    v.r = KV ? r[i] : 0;
  }
  return v;
}

// The merge-path co-rank of o (K2 / K3's blocks, K9's restarts): `steps`
// steps of the binary search lo, hi = (mid, hi) if A[mid - 1] goes before
// B[o - mid] else (lo, mid - 1), mid = (lo + hi + 1) / 2, five a round over
// the warp. Once lo >= hi no step moves lo.
template <typename T, bool KV, bool DESC>
__device__ int corank(const T* ak, const int32_t* ar, int la, const T* bk, const int32_t* br,
                      int lb, int o, int steps, int lane) {
  int lo = max(0, o - lb), hi = min(o, la);
  auto midpoint = [](int l, int h) { return l + ((h - l + 1) >> 1); };
  while (steps > 0 && lo < hi) {
    const int levels = steps < 5 ? steps : 5;
    const int n = lane + 1;  // heap index of this lane's node
    bool ok = false;
    if (n < (1 << levels)) {
      int nlo = lo, nhi = hi;
      for (int d = 30 - __clz(n); d >= 0; --d) {
        const int mid = midpoint(nlo, nhi);
        if ((n >> d) & 1) nlo = mid; else nhi = mid - 1;
      }
      const int mid = midpoint(nlo, nhi);
      ok = wins<T, KV, DESC>(guarded<T, KV, DESC>(ak, ar, la, mid - 1),
                             guarded<T, KV, DESC>(bk, br, lb, o - mid));
    }
    const unsigned took = __ballot_sync(kFullWarp, ok);
    for (int d = 0, node = 1; d < levels; ++d) {
      const int mid = midpoint(lo, hi);
      const int t = (took >> (node - 1)) & 1;
      if (t) lo = mid; else hi = mid - 1;
      node = 2 * node + t;
    }
    steps -= levels;
  }
  return lo;
}

// mbarriers and 1-D bulk copies (sm_90). A wait spins on try_wait (which
// suspends in hardware) with the parity of the phase it waits for.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* b, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("{ .reg .b64 st; mbarrier.arrive.shared::cta.b64 st, [%0]; }" ::"r"(smem_u32(b))
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_test(uint64_t* b, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{ .reg .pred p; mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2; "
      "selp.u32 %0, 1, 0, p; }"
      : "=r"(ok)
      : "r"(smem_u32(b)), "r"(parity)
      : "memory");
  return ok != 0;
}
__device__ __forceinline__ bool mbar_try(uint64_t* b, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
      "selp.u32 %0, 1, 0, p; }"
      : "=r"(ok)
      : "r"(smem_u32(b)), "r"(parity)
      : "memory");
  return ok != 0;
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  while (!mbar_try(b, parity)) {
  }
}
// `bytes` (a multiple of 16) from global `src` to shared `dst`, both 16-byte
// aligned, completing on `bar`'s transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Orders this thread's generic-proxy accesses to shared memory before later
// async-proxy ones: a consumer that read a ring slot a bulk copy refills
// fences before it frees the slot. The mbarrier alone orders the generic
// proxy only; without the fence the refill could land before the reads
// (-DFLIMS_NO_PROXY_FENCE leaves it out, for scripts/fan2_race.py only).
__device__ __forceinline__ void fence_proxy_async() {
#ifndef FLIMS_NO_PROXY_FENCE
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
#endif
}

// 4 bytes from global `src` to shared `dst` (K4's leaves at any alignment),
// and the arrive on `bar` that fires once every cp.async this thread has
// issued so far is complete (counting as one of the barrier's arrivals).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
// 16 bytes, both addresses 16-byte aligned (K2 / K3's whole aligned rows)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Segment of flat CTA index g: the largest s with blk0[s] <= g.
__device__ __forceinline__ int find_segment(const int32_t* blk0, int n, int g) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (blk0[mid] <= g) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Exclusive prefix of val(0 .. n - 1) into out[0 .. n] over the CTA; s_part
// holds blockDim.x ints.
template <class F>
__device__ void block_scan(int n, const F& val, int32_t* out, int32_t* s_part) {
  const int t = threadIdx.x, T = blockDim.x;
  const int i0 = (int)((long long)t * n / T), i1 = (int)((long long)(t + 1) * n / T);
  int sum = 0;
  for (int i = i0; i < i1; ++i) sum += val(i);
  s_part[t] = sum;
  __syncthreads();
  for (int d = 1; d < T; d <<= 1) {
    const int x = t >= d ? s_part[t - d] : 0;
    __syncthreads();
    s_part[t] += x;
    __syncthreads();
  }
  int run = s_part[t] - sum;
  for (int i = i0; i < i1; ++i) {
    out[i] = run;
    run += val(i);
  }
  if (t == T - 1) out[n] = s_part[t];
  __syncthreads();
}

enum DType : int { kInt32 = 0, kFloat32 = 1 };

}  // namespace flims
