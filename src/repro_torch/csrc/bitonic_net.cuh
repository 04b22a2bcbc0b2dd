// K1's row machinery, shared by K1 (bitonic_sort.cu) and K5 / K6
// (segment_sort.cu): the element policies, the bitonic network in registers
// (WarpNet for rows up to 32 E keys within one warp, WideNet for wider rows
// over a CTA, their stages at d >= 32 E through register-major shared
// memory), lanes in and out, the exact-path test, the fast-path key
// transforms, and sort_lanes, which runs a network on the fast or the exact
// lanes. The network is the TPU kernels' bit for bit: the stage order (lk =
// 1 .. log c, ld = lk - 1 .. 0), the pairs and the direction rule ((first
// >> lk) & 1, odd k-blocks reverse); only where an element lives changes.
// bitonic_sort.cu's header comment gives the design and its measurements.
#pragma once

#include <type_traits>

#include "flims.cuh"

// Clock counters for scripts/k1_profile.py (-DK1_PROFILE) and
// scripts/k56_profile.py (-DK56_PROFILE): per warp, summed in the warp's own
// row of shared memory (no barrier, so warps may exit early) and written to
// net_prof[cta][warp][counter] by its lane 0 at the warp's end, for the
// first NET_PROF_CTAS CTAs, with each CTA's start, end (the last warp's,
// globaltimer) and SM in net_when. The source compiled under the define
// names the counters and reads them out (k1_prof_* / k56_prof_*). Without
// either define every PROF* macro is empty.
#if defined(K1_PROFILE) || defined(K56_PROFILE)
#ifndef NET_PROF_CTAS
#define NET_PROF_CTAS 4096
#endif
constexpr int kProfCounters = 7;
constexpr int kProfWarps = 32;
__device__ unsigned long long net_prof[NET_PROF_CTAS * kProfWarps * kProfCounters];
__device__ unsigned long long net_when[NET_PROF_CTAS * 3];
__shared__ unsigned long long s_prof[kProfWarps][kProfCounters];
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
    if (threadIdx.x == 0 && blockIdx.x < NET_PROF_CTAS) {                     \
      net_when[blockIdx.x * 3] = globaltimer();                               \
      net_when[blockIdx.x * 3 + 2] = smid();                                  \
    }                                                                         \
    if ((threadIdx.x & 31) == 0)                                              \
      for (int k_ = 0; k_ < kProfCounters; ++k_) s_prof[threadIdx.x >> 5][k_] = 0; \
  } while (0)
#define PROF_FLUSH()                                                          \
  do {                                                                        \
    if ((threadIdx.x & 31) == 0 && blockIdx.x < NET_PROF_CTAS) {              \
      for (int k_ = 0; k_ < kProfCounters; ++k_)                              \
        net_prof[((size_t)blockIdx.x * kProfWarps + (threadIdx.x >> 5)) * kProfCounters + k_] = \
            s_prof[threadIdx.x >> 5][k_];                                     \
      atomicMax(&net_when[blockIdx.x * 3 + 1], globaltimer());                \
    }                                                                         \
  } while (0)
#else
#define PROF_START(t)
#define PROF(k, t) do { } while (0)
#define PROF_COUNT(k) do { } while (0)
#define PROF_INIT() do { } while (0)
#define PROF_FLUSH() do { } while (0)
#endif

namespace flims {
namespace net {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kE = 8;                   // elements a thread holds
constexpr int kTile = 32 * kE;          // elements a warp holds

__host__ __device__ constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x >> 1); }

// ---- element policies ------------------------------------------------------
// cas(top, bot, asc): the compare-exchange of a pair (top at the lower
// index). keep(own, p, top, asc): what a lane keeps of the pair it forms
// with lane value p, on the top side or not. Policies with kFlip hold an
// element complemented (flip_if) while its k-block ascends and ignore `asc`.

// int32 in the network's order: int keys, NaN-free float keys as monotone
// bits. Integer max / min are XLA's max / min there, +0 / -0 included.
struct MonoOps {
  using V = int32_t;
  static constexpr bool kFlip = true;
  __device__ static V flip_if(V v, bool f) { return v ^ -(int32_t)f; }
  __device__ static void cas(V& t, V& b, bool) {
    const V hi = max(t, b), lo = min(t, b);
    t = hi;
    b = lo;
  }
  __device__ static V keep(V own, V p, bool top, bool) { return top ? max(own, p) : min(own, p); }
  __device__ static V shfl(V v, int m) { return __shfl_xor_sync(kFull, v, m); }
};

// (key, rank) as one signed 64-bit key: larger goes first. Equal keys are
// equal pairs bit for bit, so which of the two a select takes is moot.
struct PackedOps {
  using V = long long;
  static constexpr bool kFlip = true;
  __device__ static V flip_if(V v, bool f) { return v ^ -(long long)f; }
  __device__ static void cas(V& t, V& b, bool) {
    const bool gt = t > b;
    const V hi = gt ? t : b, lo = gt ? b : t;
    t = hi;
    b = lo;
  }
  __device__ static V keep(V own, V p, bool top, bool) { return (top == (own > p)) ? own : p; }
  __device__ static V shfl(V v, int m) { return __shfl_xor_sync(kFull, v, m); }
};

// Exact key-only float lanes: XLA's max / min (flims.cuh), operand order
// kept: a NaN operand wins, and of two NaNs the top one's sign bit decides.
struct FloatOps {
  using V = float;
  static constexpr bool kFlip = false;
  __device__ static void cas(V& t, V& b, bool asc) {
    const V mx = xmax(t, b), mn = xmin(t, b);
    t = asc ? mn : mx;
    b = asc ? mx : mn;
  }
  __device__ static V keep(V own, V p, bool top, bool asc) {
    const V a = top ? own : p, b = top ? p : own;
    return xsel(a, b, top != asc);
  }
  __device__ static V shfl(V v, int m) { return __shfl_xor_sync(kFull, v, m); }
};

// Exact KV float lanes: the compound compare `(kt > kb) | ((kt == kb) &
// (rt < rb))` (`<` ascending) of the TPU kernel, swaps by selects.
template <bool DESC> struct PairOps {
  using V = Lane<float>;
  static constexpr bool kFlip = false;
  __device__ static void cas(V& t, V& b, bool asc) {
    const bool keep = wins<float, true, DESC>(t, b) ^ asc;
    const V nt = pick(keep, t, b), nb = pick(keep, b, t);
    t = nt;
    b = nb;
  }
  __device__ static V keep(V own, V p, bool top, bool asc) {
    const bool k = (top ? wins<float, true, DESC>(own, p) : wins<float, true, DESC>(p, own)) ^ asc;
    return pick(k, own, p);
  }
  __device__ static V shfl(V v, int m) {
    V o;
    o.k = __shfl_xor_sync(kFull, v.k, m);
    o.r = __shfl_xor_sync(kFull, v.r, m);
    return o;
  }
};

// ---- the network in registers ---------------------------------------------

// Direction of register j in phase LK < log c: bit LK of its row index
// `base + j` (base, the thread's first, a multiple of E).
template <int E, int LK>
__device__ __forceinline__ bool dir_bit(int base, int j) {
  return LK < ilog2(E) ? (j >> LK) & 1 : (base >> LK) & 1;
}

// Stage LD of a phase: registers of one thread below d = E, lanes above.
template <class Ops, int E, int LD, class Asc>
__device__ __forceinline__ void stage(typename Ops::V (&x)[E], int lane, const Asc& asc) {
  constexpr int LOGE = ilog2(E);
  if constexpr (LD >= LOGE) {
    PROF_START(t_s);
    constexpr int mask = 1 << (LD - LOGE);
    const bool top = !(lane & mask);
#pragma unroll
    for (int j = 0; j < E; ++j) x[j] = Ops::keep(x[j], Ops::shfl(x[j], mask), top, asc(j));
    PROF(2, t_s);
  } else {
    PROF_START(t_r);
    constexpr int d = 1 << LD;
#pragma unroll
    for (int j = 0; j < E; ++j)
      if (!(j & d)) Ops::cas(x[j], x[j + d], asc(j));
    PROF(1, t_r);
  }
}

template <class Ops, int E, int LD, class Asc>
__device__ __forceinline__ void stages_down(typename Ops::V (&x)[E], int lane, const Asc& asc) {
  if constexpr (LD >= 0) {
    stage<Ops, E, LD>(x, lane, asc);
    stages_down<Ops, E, LD - 1>(x, lane, asc);
  }
}

// asc of register j in a phase run within the warp (compile-time LK)
template <class Ops, int E, int LK> struct WarpDir {
  int base;
  bool fin;
  __device__ bool operator()(int j) const {
    return !Ops::kFlip && !fin && dir_bit<E, LK>(base, j);
  }
};
// asc of every register of the thread (a phase above the warp's tile)
struct ThreadDir {
  bool asc;
  __device__ bool operator()(int) const { return asc; }
};

// Phases LK .. NPH within the warp (stages below 32 E); the last one is the
// row's final, all descending, when LAST_FINAL.
template <class Ops, int E, int LK, int NPH, bool LAST_FINAL>
__device__ __forceinline__ void warp_phases(typename Ops::V (&x)[E], int base, int lane) {
  if constexpr (LK <= NPH) {
    constexpr int LOGT = ilog2(E) + 5;
    constexpr bool FIN = LAST_FINAL && LK == NPH;
    if constexpr (Ops::kFlip) {
      PROF_START(t_f);
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const bool prev = LK > 1 && dir_bit<E, LK - 1>(base, j);
        const bool cur = !FIN && dir_bit<E, LK>(base, j);
        x[j] = Ops::flip_if(x[j], prev != cur);
      }
      PROF(1, t_f);
    }
    stages_down<Ops, E, (LK < LOGT ? LK : LOGT) - 1>(x, lane, WarpDir<Ops, E, LK>{base, FIN});
    warp_phases<Ops, E, LK + 1, NPH, LAST_FINAL>(x, base, lane);
  }
}

// Rows of 2^LOGC <= 32 E keys, 32 E / 2^LOGC to a warp.
template <int LOGC, int E = kE> struct WarpNet {
  int base, lane;
  template <class Ops>
  __device__ void run(typename Ops::V (&x)[E]) const {
    warp_phases<Ops, E, 1, LOGC, true>(x, base, lane);
  }
};

// A row of c = 2^logc > 32 E keys over c / E threads: the warp's phases
// (its tile sorted in the direction of its k-block), then each phase above
// with its stages d >= 32 E in shared memory and the rest in registers.
// The row's threads are the CTA's first c / E. With SUBSET the CTA may hold
// more (which may have exited), and the row's barriers are the named
// barrier 1 over its c / E threads instead of __syncthreads.
template <int E, bool SUBSET = false> struct WideNet {
  int base, lane, logc;
  unsigned char* smem;
  __device__ __forceinline__ void sync(int n) const {
    if constexpr (SUBSET)
      asm volatile("bar.sync 1, %0;" ::"r"(n) : "memory");
    else
      __syncthreads();
  }
  template <class Ops>
  __device__ void run(typename Ops::V (&x)[E]) const {
    using V = typename Ops::V;
    constexpr int LOGE = ilog2(E), LOGT = LOGE + 5;
    warp_phases<Ops, E, 1, LOGT, false>(x, base, lane);
    V* s = reinterpret_cast<V*>(smem);
    const int t = threadIdx.x, N = SUBSET ? 1 << (logc - LOGE) : blockDim.x,
              lhalf = logc - LOGE - 1;
    for (int lk = LOGT + 1; lk <= logc; ++lk) {
      const bool fin = lk == logc;
      const bool asc = !fin && ((base >> lk) & 1);
      PROF_START(t_m);
      if constexpr (Ops::kFlip) {
        const bool f = ((base >> (lk - 1)) & 1) != asc;
#pragma unroll
        for (int j = 0; j < E; ++j) x[j] = Ops::flip_if(x[j], f);
      }
#pragma unroll
      for (int j = 0; j < E; ++j) s[j * N + t] = x[j];
      sync(N);
      // element i = col E + j sits at s[j N + col]: a stage at d pairs
      // columns dd = d / E apart within one register's stripe
      for (int ld = lk - 1; ld >= LOGT; --ld) {
        const int lds = ld - LOGE, dd = 1 << lds;
#pragma unroll
        for (int u = 0; u < E / 2; ++u) {
          const int P = t + u * N, stripe = P >> lhalf, q = P & ((1 << lhalf) - 1);
          const int col = ((q >> lds) << (lds + 1)) | (q & (dd - 1));
          V* a = s + stripe * N + col;
          V top = a[0], bot = a[dd];
          Ops::cas(top, bot, !Ops::kFlip && !fin && ((col >> (lk - LOGE)) & 1));
          a[0] = top;
          a[dd] = bot;
        }
        sync(N);
      }
#pragma unroll
      for (int j = 0; j < E; ++j) x[j] = s[j * N + t];
      PROF(3, t_m);
      stages_down<Ops, E, LOGT - 1>(x, lane, ThreadDir{!Ops::kFlip && asc});
    }
  }
};

// ---- lanes in and out --------------------------------------------------------

template <typename T> __device__ __forceinline__ T from_bits(int32_t b);
template <> __device__ __forceinline__ int32_t from_bits<int32_t>(int32_t b) { return b; }
template <> __device__ __forceinline__ float from_bits<float>(int32_t b) { return __int_as_float(b); }
__device__ __forceinline__ int32_t to_bits(int32_t v) { return v; }
__device__ __forceinline__ int32_t to_bits(float v) { return __float_as_int(v); }

// E elements from src[g ..], 16-byte vectors when `vec` and whole; 0 past
// `total`.
template <int E, typename T>
__device__ __forceinline__ void load_lanes(const T* __restrict__ src, long long g, long long total,
                                           bool vec, T (&v)[E]) {
  if (vec && g + E <= total) {
    const int4* p = reinterpret_cast<const int4*>(src + g);
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      const int4 w = p[q];
      v[4 * q] = from_bits<T>(w.x);
      v[4 * q + 1] = from_bits<T>(w.y);
      v[4 * q + 2] = from_bits<T>(w.z);
      v[4 * q + 3] = from_bits<T>(w.w);
    }
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j) v[j] = g + j < total ? src[g + j] : T(0);
  }
}

template <int E, typename T>
__device__ __forceinline__ void store_lanes(T* __restrict__ dst, long long g, long long total,
                                            bool vec, const T (&v)[E]) {
  if (vec && g + E <= total) {
    int4* p = reinterpret_cast<int4*>(dst + g);
#pragma unroll
    for (int q = 0; q < E / 4; ++q)
      p[q] = make_int4(to_bits(v[4 * q]), to_bits(v[4 * q + 1]), to_bits(v[4 * q + 2]),
                       to_bits(v[4 * q + 3]));
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j)
      if (g + j < total) dst[g + j] = v[j];
  }
}

// Rows that must take the exact path: float keys holding a NaN, or on KV
// lanes a NaN or a -0.0.
template <typename T, bool KV, int E>
__device__ __forceinline__ bool needs_exact(const T (&k)[E]) {
  if constexpr (!std::is_same<T, float>::value) {
    return false;
  } else {
    bool bad = false;
#pragma unroll
    for (int j = 0; j < E; ++j)
      bad |= (k[j] != k[j]) | (KV && __float_as_int(k[j]) == (int32_t)0x80000000);
    return bad;
  }
}

// the fast path's integer keys: float bits as monotone int32 (`mono`,
// flims.cuh), int32 keys as they are
template <typename T> __device__ __forceinline__ int32_t order_key(T k) {
  return std::is_same<T, float>::value ? mono(to_bits(k)) : to_bits(k);
}
template <typename T> __device__ __forceinline__ T from_order_key(int32_t o) {
  return from_bits<T>(std::is_same<T, float>::value ? mono(o) : o);
}

// Sorts the thread's keys (and ranks) with `net` on the fast or the exact
// path.
template <typename T, bool KV, bool DESC, int E, class Net>
__device__ __forceinline__ void sort_lanes(T (&k)[E], int32_t (&r)[E], bool exact, const Net& net) {
  if constexpr (std::is_same<T, float>::value) {
    if (exact) {
      PROF_COUNT(6);
      if constexpr (KV) {
        Lane<float> x[E];
#pragma unroll
        for (int j = 0; j < E; ++j) x[j] = Lane<float>{k[j], r[j]};
        net.template run<PairOps<DESC>>(x);
#pragma unroll
        for (int j = 0; j < E; ++j) {
          k[j] = x[j].k;
          r[j] = x[j].r;
        }
      } else {
        net.template run<FloatOps>(k);
      }
      return;
    }
  }
  if constexpr (KV) {
    long long x[E];
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int32_t o = DESC ? order_key(k[j]) : ~order_key(k[j]);
      x[j] = (long long)(((unsigned long long)(unsigned)o << 32) |
                         (unsigned)(r[j] ^ 0x7fffffff));
    }
    net.template run<PackedOps>(x);
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int32_t o = (int32_t)(x[j] >> 32);
      k[j] = from_order_key<T>(DESC ? o : ~o);
      r[j] = (int32_t)((unsigned)x[j] ^ 0x7fffffffu);
    }
  } else {
    int32_t x[E];
#pragma unroll
    for (int j = 0; j < E; ++j) x[j] = order_key(k[j]);
    net.template run<MonoOps>(x);
#pragma unroll
    for (int j = 0; j < E; ++j) k[j] = from_order_key<T>(x[j]);
  }
}

}  // namespace net
}  // namespace flims
