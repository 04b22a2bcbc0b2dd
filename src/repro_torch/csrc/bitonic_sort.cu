// K1: bitonic sort of every row of an (m, c) tile, c a power of two from 1
// to 16384, as a register-resident warp network.
//
// Replaces `sort_chunks_pallas` / `sort_chunks_kv_pallas`
// (src/repro/kernels/bitonic_sort.py:84, :106; network in
// `_bitonic_rows_desc` :17 and `_bitonic_rows_kv` :39). The network is the
// TPU kernel's, bit for bit: the same compare-exchange pairs, the stage
// order (lk = 1 .. log c, ld = lk - 1 .. 0) and the direction rule
// ((first >> lk) & 1, odd k-blocks reverse). Key-only rows sort descending
// with XLA's max/min (a NaN operand wins both outputs, so which NaNs
// survive depends on the network); KV rows by (key in the call's
// direction, rank ascending). Only where an element lives changes.
//
// What bounds it. Each element is read once and written once: 0.04 ms
// key-only and 0.08 ms KV at the main path's (65536, 256) at 3.35 TB/s. The
// network is 36 stages of compare-exchanges at c = 256. The first version
// ran them one CTA per row, a thread per pair, in shared memory with a CTA
// barrier after each stage: latency-bound, a warp spent 14.1k SM clocks in
// the stages' shared-memory round trips, 3.9k at barriers and 7.1k loading
// its row, for 0.58 ms (scripts/k1_profile.py; PERF.md §6). This one keeps
// the row in registers: at c = 256 a warp spends ~5k clocks waiting on its
// loads and ~3k on all 36 stages (1.8k of them the 15 shuffle stages; 4.7k
// KV, whose keys shuffle as 64 bits), 32 registers, 16 CTAs (64 warps) an
// SM, and 2^27 keys take ~1.9x (KV ~2.3x) the byte bound: the loads' latency
// and the shuffle stages' instructions (a shuffle, a max, a min and a
// select per shuffled key) between them. 16 or 32 keys a thread (10 or 6 shuffle
// stages) and prefetching the next tile into registers were measured and
// gained nothing: they cost residency (9 and 5 CTAs an SM KV) for the
// instructions they save.
//
// The design.
// - Blocked registers. Thread `lane` of a warp holds E = 8 consecutive
//   elements; a warp holds a tile of 256 (one row at c = 256, 256 / c rows
//   below). A stage with d < E pairs two registers of one thread; one with
//   E <= d < 32 E pairs register j with the same register of lane
//   lane ^ (d / E) through __shfl_xor_sync, each lane keeping its side.
//   Consecutive elements per thread put the lane bits on the index's high
//   bits, which the network touches least: 15 of the 36 stages at c = 256
//   shuffle. Loads and stores are 16-byte vectors where the pointers allow.
// - No barriers in a warp's tile: a CTA of kTileWarps warps takes as many
//   tiles, each warp on its own; the last CTA's warps past m*c idle.
// - Rows wider than a warp's 32 E (c >= 512; E = 16 at c = 16384) span c /
//   E threads of one CTA. Stages with d >= 32 E go through shared memory,
//   laid out register-major (element t E + j at j N + t, N threads) so the
//   stores, loads and the stage's pairs are all conflict-free, with a CTA
//   barrier after each; every finer stage of the phase is back in
//   registers. Shared memory: c x 4 bytes key-only, c x 8 KV.
// - Directions by flipping. On the fast paths the keys travel as integers
//   whose order is the network's order, and the bitwise complement reverses
//   it. An element is complemented while its k-block sorts ascending, so
//   every compare-exchange is one max and one min (one select each way
//   across lanes). Key-only: int32 keys as they are, float keys as monotone
//   int32 bits (the sign bit flips the other 31), whose integer max and min
//   are XLA's max and min with its +0 / -0 rule. KV: one signed 64-bit key,
//   (key, or its complement ascending) << 32 | (rank ^ 0x7fffffff), whose
//   order is the compound order with the rank ascending; equal keys are
//   equal pairs, bit for bit.
// - Exact path. A float row holding a NaN (key-only), or a NaN or a -0.0
//   (KV: the packed key would order -0 below +0, which the compound compare
//   ties), sorts on the float lanes with XLA's max/min or the compound
//   compare, each compare-exchange by selects. The test is warp-uniform
//   (__any_sync; __syncthreads_or for a wide row), so a warp never splits.
#include <type_traits>

#include "flims.cuh"

// Clock counters for scripts/k1_profile.py, compiled in only under
// -DK1_PROFILE: per warp, summed in shared memory and written to
// k1_prof[cta][warp][counter] at the kernel's end, for the first
// K1_PROF_CTAS CTAs, with each CTA's start and end (globaltimer) and SM.
// Without the define every PROF* macro is empty.
#ifdef K1_PROFILE
#ifndef K1_PROF_CTAS
#define K1_PROF_CTAS 4096
#endif
constexpr int kProfCounters = 7;
constexpr int kProfWarps = 32;
__device__ unsigned long long k1_prof[K1_PROF_CTAS * kProfWarps * kProfCounters];
__device__ unsigned long long k1_when[K1_PROF_CTAS * 3];
__shared__ unsigned long long s_prof[kProfWarps][kProfCounters];
// load (global loads, the key transform and the exact-path vote), regs
// (stages within a thread, with the direction flips), shfl (stages across
// lanes), smem (stages through shared memory, their barriers and the copies
// in and out), store, total, exact (count of warps on the exact path)
extern "C" const char* k1_prof_names() { return "load,regs,shfl,smem,store,total,exact"; }
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
    if (threadIdx.x == 0 && blockIdx.x < K1_PROF_CTAS) {                      \
      k1_when[blockIdx.x * 3] = globaltimer();                                \
      k1_when[blockIdx.x * 3 + 2] = smid();                                   \
    }                                                                         \
    for (int i_ = threadIdx.x; i_ < kProfWarps * kProfCounters; i_ += blockDim.x) \
      s_prof[i_ / kProfCounters][i_ % kProfCounters] = 0;                     \
    __syncthreads();                                                          \
  } while (0)
#define PROF_FLUSH()                                                          \
  do {                                                                        \
    __syncthreads();                                                          \
    if ((threadIdx.x & 31) == 0 && blockIdx.x < K1_PROF_CTAS)                 \
      for (int k_ = 0; k_ < kProfCounters; ++k_)                              \
        k1_prof[((size_t)blockIdx.x * kProfWarps + (threadIdx.x >> 5)) * kProfCounters + k_] = \
            s_prof[threadIdx.x >> 5][k_];                                     \
    if (threadIdx.x == 0 && blockIdx.x < K1_PROF_CTAS)                        \
      k1_when[blockIdx.x * 3 + 1] = globaltimer();                            \
  } while (0)
#else
#define PROF_START(t)
#define PROF(k, t) do { } while (0)
#define PROF_COUNT(k) do { } while (0)
#define PROF_INIT() do { } while (0)
#define PROF_FLUSH() do { } while (0)
#endif

namespace flims {
namespace k1 {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kE = 8;                   // elements a thread holds
constexpr int kTile = 32 * kE;          // elements a warp holds
constexpr int kTileWarps = 4;           // warps (tiles) a CTA of the warp kernel
constexpr int kWarpLogC = 8;            // rows up to 2^8 = kTile: the warp kernel
constexpr int kMaxLogC = 14;            // MAX_CHUNK = 16384
constexpr int kWideThreads = 1024;

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

// Exact key-only float lanes: XLA's max / min, operand order kept (a NaN
// operand wins, the top one of two NaNs).
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
    return (top != asc) ? xmax(a, b) : xmin(a, b);
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

// Rows of 2^LOGC <= kTile keys, kTile / 2^LOGC to a warp.
template <int LOGC> struct WarpNet {
  int base, lane;
  template <class Ops>
  __device__ void run(typename Ops::V (&x)[kE]) const {
    warp_phases<Ops, kE, 1, LOGC, true>(x, base, lane);
  }
};

// A row of c = 2^logc > 32 E keys over c / E threads: the warp's phases
// (its tile sorted in the direction of its k-block), then each phase above
// with its stages d >= 32 E in shared memory and the rest in registers.
template <int E> struct WideNet {
  int base, lane, logc;
  unsigned char* smem;
  template <class Ops>
  __device__ void run(typename Ops::V (&x)[E]) const {
    using V = typename Ops::V;
    constexpr int LOGE = ilog2(E), LOGT = LOGE + 5;
    warp_phases<Ops, E, 1, LOGT, false>(x, base, lane);
    V* s = reinterpret_cast<V*>(smem);
    const int t = threadIdx.x, N = blockDim.x, lhalf = logc - LOGE - 1;
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
      __syncthreads();
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
        __syncthreads();
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

// float bits <-> monotone int32 (its own inverse); int32 keys as they are
__device__ __forceinline__ int32_t mono(int32_t b) { return b ^ ((b >> 31) & 0x7fffffff); }
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

// ---- kernels ---------------------------------------------------------------

// Rows of 2^LOGC <= kTile keys: each warp sorts one tile of kTile elements
// of the flat (m, c) array in registers, no barrier.
template <typename T, bool KV, bool DESC, int LOGC>
__global__ void __launch_bounds__(32 * kTileWarps)
    warp_rows_kernel(const T* __restrict__ kin, const int32_t* __restrict__ rin,
                     T* __restrict__ kout, int32_t* __restrict__ rout, long long total, int,
                     int vec) {
  PROF_INIT();
  PROF_START(t_total);
  const int lane = threadIdx.x & 31;
  const long long tile = (long long)blockIdx.x * kTileWarps + (threadIdx.x >> 5);
  if (tile * kTile < total) {  // warp-uniform
    const long long g = tile * kTile + lane * kE;
    T k[kE];
    int32_t r[kE];
    PROF_START(t_load);
    load_lanes<kE>(kin, g, total, vec, k);
    if (KV) load_lanes<kE>(rin, g, total, vec, r);
    const bool exact = __any_sync(kFull, needs_exact<T, KV>(k));
    PROF(0, t_load);
    sort_lanes<T, KV, DESC, kE>(k, r, exact,
                                WarpNet<LOGC>{(lane * kE) & ((1 << LOGC) - 1), lane});
    PROF_START(t_store);
    store_lanes<kE>(kout, g, total, vec, k);
    if (KV) store_lanes<kE>(rout, g, total, vec, r);
    PROF(4, t_store);
  }
  PROF(5, t_total);
  PROF_FLUSH();
}

// Rows of c = 2^logc > 32 E keys: one row a CTA of c / E threads.
template <typename T, bool KV, bool DESC, int E>
__global__ void __launch_bounds__(kWideThreads)
    wide_rows_kernel(const T* __restrict__ kin, const int32_t* __restrict__ rin,
                     T* __restrict__ kout, int32_t* __restrict__ rout, long long total,
                     int logc, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  PROF_INIT();
  PROF_START(t_total);
  const int t = threadIdx.x;
  const long long g = ((long long)blockIdx.x << logc) + (long long)t * E;
  T k[E];
  int32_t r[E];
  PROF_START(t_load);
  load_lanes<E>(kin, g, total, vec, k);
  if (KV) load_lanes<E>(rin, g, total, vec, r);
  const bool exact = __syncthreads_or(needs_exact<T, KV>(k));
  PROF(0, t_load);
  sort_lanes<T, KV, DESC, E>(k, r, exact, WideNet<E>{t * E, t & 31, logc, smem});
  PROF_START(t_store);
  store_lanes<E>(kout, g, total, vec, k);
  if (KV) store_lanes<E>(rout, g, total, vec, r);
  PROF(4, t_store);
  PROF(5, t_total);
  PROF_FLUSH();
}

// ---- launch ------------------------------------------------------------------

template <typename T>
using KernFn = void (*)(const T*, const int32_t*, T*, int32_t*, long long, int, int);

// What one call at width 2^logc runs, or a query of it (smem / per_sm set).
struct Args {
  const void *kin, *rin;
  void *kout, *rout;
  int m, logc;
  cudaStream_t st;
  long long* smem;
  int* per_sm;
};

template <typename T, bool KV, bool DESC, int L>
static KernFn<T> warp_kernel(int logc) {
  if constexpr (L > kWarpLogC) {
    return nullptr;
  } else {
    if (logc == L) return &warp_rows_kernel<T, KV, DESC, L>;
    return warp_kernel<T, KV, DESC, L + 1>(logc);
  }
}

template <typename T, bool KV, bool DESC>
static cudaError_t run(const Args& a) {
  const long long c = 1ll << a.logc, total = (long long)a.m * c;
  KernFn<T> kern;
  int threads;
  size_t dyn = 0;
  long long blocks;
  if (a.logc <= kWarpLogC) {
    kern = warp_kernel<T, KV, DESC, 0>(a.logc);
    threads = 32 * kTileWarps;
    blocks = (total + (long long)kTile * kTileWarps - 1) / ((long long)kTile * kTileWarps);
  } else {
    const int E = a.logc == kMaxLogC ? 16 : 8;
    if (E == 16)
      kern = &wide_rows_kernel<T, KV, DESC, 16>;
    else
      kern = &wide_rows_kernel<T, KV, DESC, 8>;
    threads = (int)(c / E);
    dyn = (size_t)c * (KV ? 8 : 4);
    blocks = a.m;
  }
  cudaError_t e = allow_smem(kern, dyn);
  if (e != cudaSuccess) return e;
  if (a.smem) {
    cudaFuncAttributes at;
    e = cudaFuncGetAttributes(&at, kern);
    *a.smem = (long long)at.sharedSizeBytes + (long long)dyn;
    return e;
  }
  if (a.per_sm) return cudaOccupancyMaxActiveBlocksPerMultiprocessor(a.per_sm, kern, threads, dyn);
  const uintptr_t align = (uintptr_t)a.kin | (uintptr_t)a.rin | (uintptr_t)a.kout | (uintptr_t)a.rout;
  kern<<<(unsigned)blocks, threads, dyn, a.st>>>((const T*)a.kin, (const int32_t*)a.rin, (T*)a.kout,
                                                (int32_t*)a.rout, total, a.logc,
                                                (align & 15) == 0);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch(int kv, int desc, const Args& a) {
  if (!kv && desc) return run<T, false, true>(a);
  if (kv && desc) return run<T, true, true>(a);
  if (kv && !desc) return run<T, true, false>(a);
  return cudaErrorInvalidValue;  // key-only rows sort descending only
}

static cudaError_t by_dtype(int dtype, int kv, int desc, int c, Args a) {
  if (c < 1 || (c & (c - 1)) || c > (1 << kMaxLogC)) return cudaErrorInvalidValue;
  a.logc = ilog2(c);
  if (dtype == kInt32) return dispatch<int32_t>(kv, desc, a);
  if (dtype == kFloat32) return dispatch<float>(kv, desc, a);
  return cudaErrorInvalidValue;
}

}  // namespace k1
}  // namespace flims

extern "C" int flims_bitonic_rows(int dtype, int kv, int desc, const void* kin, const void* rin,
                                  void* kout, void* rout, int m, int c, void* stream) {
  if (m <= 0) return cudaErrorInvalidValue;
  flims::k1::Args a{kin, rin, kout, rout, m, 0, (cudaStream_t)stream, nullptr, nullptr};
  return flims::k1::by_dtype(dtype, kv, desc, c, a);
}

// Shared-memory bytes of one CTA of the kernel for (dtype, kv, desc, c), as
// compiled and launched, or a negative CUDA error.
extern "C" long long flims_bitonic_rows_smem(int dtype, int kv, int desc, int c) {
  long long bytes = 0;
  flims::k1::Args a{};
  a.smem = &bytes;
  const cudaError_t e = flims::k1::by_dtype(dtype, kv, desc, c, a);
  return e == cudaSuccess ? bytes : -(long long)e;
}

// CTAs per SM the kernel for (dtype, kv, desc, c) reaches, or a negative
// CUDA error.
extern "C" int flims_bitonic_rows_occupancy(int dtype, int kv, int desc, int c) {
  int per_sm = 0;
  flims::k1::Args a{};
  a.per_sm = &per_sm;
  const cudaError_t e = flims::k1::by_dtype(dtype, kv, desc, c, a);
  return e == cudaSuccess ? per_sm : -(int)e;
}

#ifdef K1_PROFILE
extern "C" int k1_prof_layout(int* ctas, int* warps, int* counters) {
  *ctas = K1_PROF_CTAS;
  *warps = kProfWarps;
  *counters = kProfCounters;
  return 0;
}
extern "C" int k1_prof_read(void* dst) {
  return cudaMemcpyFromSymbol(dst, k1_prof, sizeof(k1_prof));
}
extern "C" int k1_prof_zero() {
  void* p = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&p, k1_prof);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(k1_prof));
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&p, k1_when);
  return e != cudaSuccess ? e : cudaMemset(p, 0, sizeof(k1_when));
}
// (start ns, end ns, SM) per CTA
extern "C" int k1_when_read(void* dst) {
  return cudaMemcpyFromSymbol(dst, k1_when, sizeof(k1_when));
}
#endif
