// K5 / K6: fused segmented sort of a ragged batch, one launch, on K1's
// register-resident network.
//
// Replaces `segment_sort_pallas` (src/repro/kernels/segmented_merge.py:402,
// `pallas_call` :422, body `_sort_row_kernel` :396) and
// `segment_sort_kv_pallas` (:499, `pallas_call` :521, rank lanes from
// `_rank_bank` :489), which serves `segment_argsort_pallas` :536.
//
// What it computes. Segment s, `keys[offsets[s] : offsets[s+1]]`, padded to
// the static power-of-two `cap` with the last key (and, on KV lanes, whose
// rank is the segment-local position, INVALID_RANK), goes through the TPU
// kernel's bitonic network; the valid prefix is written back to the
// segment's flat offset. The TPU wrapper's padded (S, cap) bank gather and
// its searchsorted unpad have no counterpart.
//
// Paths. The lanes are read once into registers and the segment's threads
// vote over them (__any_sync, __syncthreads_or), so every path is uniform:
// - K5 fast (no NaN): monotone int32 keys over c = next_pow2(len) lanes.
// - K5 exact (a NaN): float lanes with XLA's max/min over the whole cap.
// - K6 fast (no NaN, no -0.0): one packed 64-bit key over c lanes.
// - K6 -0.0 (no NaN): the compound compare on float lanes over c lanes.
// - K6 NaN: the compound compare over the whole cap.
// Why c lanes suffice without a NaN: XLA's max/min on floats is then the
// integer order of the monotone bits (-0 below +0), and on KV lanes the
// compound compare with distinct ranks is a total order too; under a total
// order every sorting network leaves the same sorted lanes, and the padding
// (the last key, INVALID_RANK) sorts after every real lane or equals it bit
// for bit. With a NaN neither is an order and the network decides: the
// JAX kernel's network is the one over `cap`, so those segments run it
// (the first version ran K6 over c lanes there and differed from the
// reference; tests/test_torch_cuda.py::test_k6_nan_segments_match_plain).
//
// Shape. E keys a thread (8, or 16 from cap 16384), thread t holding lanes
// t E .. t E + E - 1, as in K1 (csrc/bitonic_net.cuh):
// - cap <= 256: a CTA of 4 warps, one segment a warp: WarpNet in registers
//   and shuffles, no barrier, no shared memory.
// - cap > 256: one segment a CTA of min(cap / E, 1024) threads. A segment of
//   c <= 32 E lanes sorts on warp 0 as above and the other warps exit after
//   the vote. A wider one runs K1's WideNet on the first c / E threads: its
//   stages at d >= 32 E go through register-major shared memory behind the
//   named barrier 1 over those threads (the rest have exited), every finer
//   stage stays in registers. K5 at c = 32768 (a segment over 16384 keys,
//   or a NaN segment, at cap 32768) sorts in shared memory with today's
//   `bitonic_smem` over all 1024 threads: E = 32 would not fit a 1024-thread
//   CTA's 64 registers a thread.
// - cap past one CTA (> 32768, 16384 on KV lanes; launch_wide): each
//   segment sorts over its width c (next_pow2(len), the whole cap where it
//   holds a NaN; seg_width_kernel), with no bank built in torch. Those
//   with c <= 32768 (16384) sort whole in a CTA as above
//   (segment_sort_kernel at E = 16, told the widths); the wider ones
//   through K1's network past the tile: 16384-key tiles read straight from
//   the flat keys, padded and ranked in registers (seg_first_kernel), the
//   phases above as column passes and tile merges (seg_merge_kernel) over
//   a scratch bank only the kernels touch, the last phase's valid lanes
//   stored to the flat output. The first form
//   gathered a padded (S, cap) bank and a rank bank in torch, ran K1 over
//   every whole cap, a launch a stage above the tile, and gathered the
//   prefixes back: those torch gathers were a third to half of its time
//   (scripts/k56_profile.py --split; PERF.md section 6).
// An empty segment returns before any barrier. Loads and stores are 16-byte
// vectors where the segment's start is 16-byte aligned in both buffers and
// a thread's E lanes are all valid, else scalar (offsets[s] is rarely a
// multiple of 4; the scalar loads of one warp still cover whole sectors).
//
// Bound. Each key is read once and written once (twice on KV lanes, with
// its rank): 0.010 / 0.015 ms at 2^22 keys (3.35 TB/s). The network is
// log2(c)(log2(c)+1)/2 stages over c lanes, those above d = 32 E behind a
// barrier each. The first version ran them all in shared memory, a barrier
// a stage, K5 over the whole cap for every segment: 91% of a warp's clocks
// in those stages, 0.64 / 0.62 ms at the smoke's 528 segments
// (scripts/k56_profile.py; PERF.md §6). Now a c = 16384 segment's warp
// spends ~28% of its clocks in the shared-memory stages and their
// barriers, ~24% in the shuffle stages, the rest in register stages, the
// stores (scalar at unaligned starts) and the loads: the network's stages
// bound it, ~0.17 / 0.34 ms. A CTA holds its 1024 threads' registers and
// cap x 4 B (K5) or cap x 8 B (K6) of shared memory for its life, so at cap
// 16384 an SM runs one segment at a time, and the c = 16384 segments set
// the span.
#include "bitonic_net.cuh"

namespace flims {
namespace seg {

using namespace net;

constexpr int kSegWarps = 4;    // segments (warps) a CTA when cap <= kTile
constexpr int kSmemLogC = 15;   // c = 32768 (K5 only): the shared-memory route
constexpr int kMaxLogKV = 14;   // c = 16384: K6's widest in one CTA
constexpr int kMaxThreads = 1024;
constexpr int kWidthThreads = 256;

// The segment's lanes t E .. t E + E - 1: keys (the last key past `len`)
// and, on KV lanes, ranks (INVALID_RANK past `len`).
template <typename T, bool KV, bool DESC, int E>
__device__ __forceinline__ void load_seg(const T* __restrict__ src, int base, int len, bool vec,
                                         T (&k)[E], int32_t (&r)[E]) {
  if (vec && base + E <= len) {
    const int4* p = reinterpret_cast<const int4*>(src + base);
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      const int4 w = p[q];
      k[4 * q] = from_bits<T>(w.x);
      k[4 * q + 1] = from_bits<T>(w.y);
      k[4 * q + 2] = from_bits<T>(w.z);
      k[4 * q + 3] = from_bits<T>(w.w);
    }
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j) k[j] = base + j < len ? src[base + j] : last_key<T, DESC>();
  }
#pragma unroll
  for (int j = 0; j < E; ++j) r[j] = base + j < len ? base + j : kInvalidRank;
}

// The valid lanes back to the segment's flat offset.
template <typename T, bool KV, int E>
__device__ __forceinline__ void store_seg(T* __restrict__ kdst, int32_t* __restrict__ rdst,
                                          int base, int len, bool vec, const T (&k)[E],
                                          const int32_t (&r)[E]) {
  store_lanes<E>(kdst, base, len, vec, k);
  if (KV) store_lanes<E>(rdst, base, len, vec, r);
}

// (any NaN, any -0.0) among the thread's lanes (padding is +-inf)
template <typename T, int E>
__device__ __forceinline__ void scan_keys(const T (&k)[E], bool& nan, bool& negz) {
  nan = negz = false;
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      nan |= k[j] != k[j];
      negz |= __float_as_int(k[j]) == (int32_t)0x80000000;
    }
  }
}

// WarpNet at the run-time width 2^logc <= 32 E: a warp-uniform switch over
// the template instances.
template <typename T, bool KV, bool DESC, int E, int L = 0>
__device__ __forceinline__ void warp_sort(T (&k)[E], int32_t (&r)[E], bool exact, int logc,
                                          int lane) {
  if constexpr (L <= ilog2(E) + 5) {
    if (logc == L) {
      sort_lanes<T, KV, DESC, E>(k, r, exact, WarpNet<L, E>{(lane * E) & ((1 << L) - 1), lane});
      return;
    }
    warp_sort<T, KV, DESC, E, L + 1>(k, r, exact, logc, lane);
  }
}

// log2 of the lanes a segment sorts over, and whether it takes the exact
// lanes, from the segment's vote.
template <bool KV>
__device__ __forceinline__ int seg_width(int len, int logcap, bool nan, bool negz, bool& exact) {
  exact = KV ? (nan | negz) : nan;
  return nan ? logcap : ilog2(2 * len - 1);
}

// cap <= 32 E: warp w of the CTA sorts segment 4 blockIdx + w.
template <typename T, bool KV, bool DESC, int E>
__device__ __forceinline__ void warp_segment(const T* __restrict__ kin,
                                             const int32_t* __restrict__ offsets,
                                             T* __restrict__ kout, int32_t* __restrict__ pout,
                                             int S, int logcap) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kSegWarps + (threadIdx.x >> 5);
  if (s >= S) return;  // warp-uniform
  const long long o0 = offsets[s];
  const int len = min((int)(offsets[s + 1] - o0), 1 << logcap);
  if (len == 0) return;
  PROF_START(t_load);
  const bool vload = ((uintptr_t)(kin + o0) & 15) == 0;
  const bool vstore = (((uintptr_t)(kout + o0) | (KV ? (uintptr_t)(pout + o0) : 0)) & 15) == 0;
  T k[E];
  int32_t r[E];
  load_seg<T, KV, DESC, E>(kin + o0, lane * E, len, vload, k, r);
  bool nan, negz, exact;
  scan_keys<T, E>(k, nan, negz);
  nan = __any_sync(kFull, nan);
  if (KV) negz = __any_sync(kFull, negz);
  const int logc = seg_width<KV>(len, logcap, nan, negz, exact);
  PROF(0, t_load);
  warp_sort<T, KV, DESC, E>(k, r, exact, logc, lane);
  PROF_START(t_store);
  store_seg<T, KV, E>(kout + o0, pout + (KV ? o0 : 0), lane * E, len, vstore, k, r);
  PROF(4, t_store);
}

// cap > 32 E: one segment a CTA.
template <typename T, bool KV, bool DESC, int E>
__device__ __forceinline__ void cta_segment(const T* __restrict__ kin,
                                            const int32_t* __restrict__ offsets,
                                            T* __restrict__ kout, int32_t* __restrict__ pout,
                                            int s, int logcap, unsigned char* smem) {
  constexpr int LOGE = ilog2(E), LOGT = LOGE + 5;
  const int t = threadIdx.x, lane = t & 31;
  const long long o0 = offsets[s];
  // A cap below the segment's length (engine.segment_sort refuses one)
  // sorts its first cap keys and leaves the rest unwritten.
  const int len = min((int)(offsets[s + 1] - o0), 1 << logcap);
  if (len == 0) return;  // uniform over the CTA, before any barrier
  PROF_START(t_load);
  const bool vload = ((uintptr_t)(kin + o0) & 15) == 0;
  const bool vstore = (((uintptr_t)(kout + o0) | (KV ? (uintptr_t)(pout + o0) : 0)) & 15) == 0;
  T k[E];
  int32_t r[E];
  load_seg<T, KV, DESC, E>(kin + o0, t * E, len, vload, k, r);
  bool nan, negz, exact;
  scan_keys<T, E>(k, nan, negz);
  if (std::is_same<T, float>::value) {
    nan = __syncthreads_or(nan);
    if (KV) negz = __syncthreads_or(negz);
  }
  const int logc = seg_width<KV>(len, logcap, nan, negz, exact);
  PROF(0, t_load);
  if (logc <= LOGT) {
    if (t >= 32) return;
    warp_sort<T, KV, DESC, E>(k, r, exact, logc, lane);
  } else if (KV || logc < kSmemLogC) {
    if (t >= (1 << (logc - LOGE))) return;
    sort_lanes<T, KV, DESC, E>(k, r, exact, WideNet<E, true>{t * E, lane, logc, smem});
  } else {
    // c = 32768 over all of the CTA's threads, in shared memory
    PROF_START(t_m);
    T* sk = reinterpret_cast<T*>(smem);
#pragma unroll
    for (int j = 0; j < E; ++j) sk[t * E + j] = k[j];
    for (int j = blockDim.x * E + t; j < (1 << kSmemLogC); j += blockDim.x)
      sk[j] = j < len ? kin[o0 + j] : last_key<T, DESC>();
    __syncthreads();
    bitonic_smem<T, false, true>(sk, nullptr, kSmemLogC);
    for (int j = t; j < len; j += blockDim.x) kout[o0 + j] = sk[j];
    PROF(3, t_m);
    return;
  }
  PROF_START(t_store);
  store_seg<T, KV, E>(kout + o0, pout + (KV ? o0 : 0), t * E, len, vstore, k, r);
  PROF(4, t_store);
}

// seg_log (caps past one CTA, else null): each segment's width; a segment
// wider than in_log is the wide path's and returns at once.
template <typename T, bool KV, bool DESC, int E, bool WARP>
__global__ void __launch_bounds__(kMaxThreads)
    segment_sort_kernel(const T* __restrict__ kin, const int32_t* __restrict__ offsets,
                        T* __restrict__ kout, int32_t* __restrict__ pout, int S, int logcap,
                        const int32_t* __restrict__ seg_log, int in_log) {
  extern __shared__ __align__(16) unsigned char smem[];
  PROF_INIT();
  PROF_START(t_total);
  if constexpr (WARP)
    warp_segment<T, KV, DESC, E>(kin, offsets, kout, pout, S, logcap);
  else if (!seg_log || seg_log[blockIdx.x] <= in_log)  // uniform over the CTA
    cta_segment<T, KV, DESC, E>(kin, offsets, kout, pout, blockIdx.x, logcap, smem);
  PROF(5, t_total);
  PROF_FLUSH();
}

// ---- caps past one CTA ----------------------------------------------------
// Segment s's width: log2 of the lanes it sorts over (next_pow2(len), or
// the whole cap where it holds a NaN), -1 when empty. A CTA a segment.
template <typename T>
__global__ void __launch_bounds__(kWidthThreads)
    seg_width_kernel(const T* __restrict__ kin, const int32_t* __restrict__ offsets, int logcap,
                     int32_t* __restrict__ seg_log) {
  const int s = blockIdx.x;
  const long long o0 = offsets[s];
  const int len = min((int)(offsets[s + 1] - o0), 1 << logcap);
  bool nan = false;
  if constexpr (std::is_same<T, float>::value)
    for (int i = threadIdx.x; i < len; i += blockDim.x) nan |= kin[o0 + i] != kin[o0 + i];
  nan = __syncthreads_or(nan);
  if (threadIdx.x == 0) seg_log[s] = len == 0 ? -1 : (nan ? logcap : ilog2(2 * len - 1));
}

// Blocks (segment s, tile j) of tpc = cap / 2^kRowTileLog each, over the
// segments wider than one CTA (in_log): tiles j < 2^(width - 14) read
// straight from the flat keys at the segment's offset, padded (the last
// key, INVALID_RANK) and ranked in registers, sorted through the network's
// phases 1 .. 14 (WideNet, odd tiles ascending) and written to the
// segment's row of the bank.
template <typename T, bool KV, bool DESC>
__global__ void __launch_bounds__(kRowThreads)
    seg_first_kernel(const T* __restrict__ kin, const int32_t* __restrict__ offsets,
                     const int32_t* __restrict__ seg_log, T* __restrict__ bk,
                     int32_t* __restrict__ br, int logcap, int in_log) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int E = kRowTileE, LT = kRowTileLog;
  const int tpc = 1 << (logcap - LT);
  const int s = blockIdx.x / tpc, j = blockIdx.x % tpc, t = threadIdx.x;
  const int logc = seg_log[s];
  // uniform over the CTA, before any barrier
  if (logc <= in_log || j >= (1 << (logc - LT))) return;
  const long long o0 = offsets[s];
  const int len = offsets[s + 1] - o0;
  const int base = (j << LT) + t * E;
  T k[E];
  int32_t r[E];
  load_seg<T, KV, DESC, E>(kin + o0, base, len, ((uintptr_t)(kin + o0) & 15) == 0, k, r);
  const bool exact = __syncthreads_or(needs_exact<T, KV>(k));
  sort_lanes<T, KV, DESC, E>(k, r, exact, WideNet<E>{base, t & 31, LT, smem});
  const long long row = (long long)s << logcap;
  store_lanes<E>(bk + row, base, 1ll << logcap, true, k);
  if (KV) store_lanes<E>(br + row, base, 1ll << logcap, true, r);
}

// Phase lk's stages below the tile over the wide segments' bank rows; at a
// segment's last phase the valid lanes go straight to its flat offset.
template <typename T, bool KV, bool DESC>
__global__ void __launch_bounds__(kRowThreads)
    seg_merge_kernel(const int32_t* __restrict__ offsets, const int32_t* __restrict__ seg_log,
                     T* __restrict__ kout, int32_t* __restrict__ pout, T* bk, int32_t* br,
                     int logcap, int in_log, int lk) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int E = kRowTileE, LT = kRowTileLog;
  const int tpc = 1 << (logcap - LT);
  const int s = blockIdx.x / tpc, j = blockIdx.x % tpc, t = threadIdx.x;
  const int logc = seg_log[s];
  if (logc <= in_log || logc < lk || j >= (1 << (logc - LT))) return;
  const int base = (j << LT) + t * E;
  const long long row = (long long)s << logcap, n = 1ll << logcap;
  T x[E];
  int32_t y[E];
  load_lanes<E>(bk + row, base, n, true, x);
  if (KV) load_lanes<E>(br + row, base, n, true, y);
  const bool exact = __syncthreads_or(needs_exact<T, KV>(x));
  sort_lanes<T, KV, DESC, E>(x, y, exact, TileMerge<E>{((base >> lk) & 1) != 0, t & 31, LT, smem});
  if (lk == logc) {
    const long long o0 = offsets[s];
    const int len = offsets[s + 1] - o0;
    const bool vstore = (((uintptr_t)(kout + o0) | (KV ? (uintptr_t)(pout + o0) : 0)) & 15) == 0;
    store_seg<T, KV, E>(kout + o0, pout + (KV ? o0 : 0), base, len, vstore, x, y);
  } else {
    store_lanes<E>(bk + row, base, n, true, x);
    if (KV) store_lanes<E>(br + row, base, n, true, y);
  }
}

// cap past one CTA: the widths; the segments that fit one CTA, whole
// (segment_sort_kernel at E = 16, the wide ones skipped); the wide ones'
// tiles, then each phase above the tile as column passes and a tile merge
// over the bank (S x cap keys, and ranks on KV lanes), its scratch.
template <typename T, bool KV, bool DESC>
static cudaError_t launch_wide(const void* kin, const void* offsets, void* kout, void* pout,
                               int S, int cap, void* bank, void* bank_r, void* seg_log,
                               cudaStream_t st) {
  const int logcap = ilog2(cap), in_log = KV ? kMaxLogKV : kSmemLogC;
  const size_t dyn = (size_t)1 << (KV ? kRowTileLog + 3 : kSmemLogC + 2);  // 128 KB
  auto first = seg_first_kernel<T, KV, DESC>;
  auto merge = seg_merge_kernel<T, KV, DESC>;
  auto narrow = segment_sort_kernel<T, KV, DESC, kRowTileE, false>;
  cudaError_t e = allow_smem(first, dyn);
  if (e == cudaSuccess) e = allow_smem(merge, dyn);
  if (e == cudaSuccess) e = allow_smem(narrow, dyn);
  if (e != cudaSuccess) return e;
  const auto K = (const T*)kin;
  const auto O = (const int32_t*)offsets;
  auto L = (int32_t*)seg_log;
  auto bk = (T*)bank;
  auto br = (int32_t*)bank_r;
  const long long blocks = (long long)S << (logcap - kRowTileLog);
  if (blocks > 0x7fffffffll) return cudaErrorInvalidValue;
  seg_width_kernel<T><<<S, kWidthThreads, 0, st>>>(K, O, logcap, L);
  e = cudaGetLastError();
  if (e == cudaSuccess) {
    narrow<<<S, kMaxThreads, dyn, st>>>(K, O, (T*)kout, (int32_t*)pout, S, logcap, L, in_log);
    e = cudaGetLastError();
  }
  if (e == cudaSuccess) {
    first<<<(unsigned)blocks, kRowThreads, dyn, st>>>(K, O, L, bk, br, logcap, in_log);
    e = cudaGetLastError();
  }
  for (int lk = kRowTileLog + 1; lk <= logcap && e == cudaSuccess; ++lk) {
    e = col_stages<T, KV, DESC>(bk, br, S, logcap, L, in_log, lk, kRowTileLog, st);
    if (e != cudaSuccess) break;
    merge<<<(unsigned)blocks, kRowThreads, dyn, st>>>(O, L, (T*)kout, (int32_t*)pout, bk, br,
                                                      logcap, in_log, lk);
    e = cudaGetLastError();
  }
  return e;
}

template <typename T, bool KV, bool DESC>
static cudaError_t launch(const void* kin, const void* offsets, void* kout, void* pout, int S,
                          int cap, cudaStream_t st) {
  const int logcap = ilog2(cap);
  void (*kern)(const T*, const int32_t*, T*, int32_t*, int, int, const int32_t*, int);
  int threads, blocks;
  size_t smem = 0;
  if (cap <= kTile) {
    kern = segment_sort_kernel<T, KV, DESC, kE, true>;
    threads = 32 * kSegWarps;
    blocks = (S + kSegWarps - 1) / kSegWarps;
  } else {
    const int E = cap <= 8192 ? 8 : 16;
    kern = E == 8 ? segment_sort_kernel<T, KV, DESC, 8, false>
                  : segment_sort_kernel<T, KV, DESC, 16, false>;
    threads = cap / E < kMaxThreads ? cap / E : kMaxThreads;
    blocks = S;
    smem = (size_t)cap * (KV ? 8 : 4);
  }
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<blocks, threads, smem, st>>>((const T*)kin, (const int32_t*)offsets, (T*)kout,
                                      (int32_t*)pout, S, logcap, nullptr, 0);
  return cudaGetLastError();
}

template <typename T, bool KV, bool DESC>
static cudaError_t launch_any(const void* kin, const void* offsets, void* kout, void* pout, int S,
                              int cap, void* bank, void* bank_r, void* seg_log, cudaStream_t st) {
  if (cap <= (KV ? 1 << kMaxLogKV : 1 << kSmemLogC))
    return launch<T, KV, DESC>(kin, offsets, kout, pout, S, cap, st);
  if (!bank || (KV && !bank_r) || !seg_log) return cudaErrorInvalidValue;
  return launch_wide<T, KV, DESC>(kin, offsets, kout, pout, S, cap, bank, bank_r, seg_log, st);
}

template <typename T>
static cudaError_t dispatch(int kv, int desc, const void* kin, const void* offsets, void* kout,
                            void* pout, int S, int cap, void* bank, void* bank_r, void* seg_log,
                            cudaStream_t st) {
  if (!kv && desc)
    return launch_any<T, false, true>(kin, offsets, kout, pout, S, cap, bank, bank_r, seg_log, st);
  if (kv && desc)
    return launch_any<T, true, true>(kin, offsets, kout, pout, S, cap, bank, bank_r, seg_log, st);
  if (kv && !desc)
    return launch_any<T, true, false>(kin, offsets, kout, pout, S, cap, bank, bank_r, seg_log, st);
  return cudaErrorInvalidValue;  // key-only segments sort descending only
}

}  // namespace seg
}  // namespace flims

// Past one CTA (cap > 32768, 16384 on KV lanes) bank / bank_r (S x cap keys
// and ranks) and seg_log (S int32) are the launch's scratch; else unused.
extern "C" int flims_segment_sort(int dtype, int kv, int desc, const void* kin,
                                  const void* offsets, void* kout, void* pout, int S, int cap,
                                  void* bank, void* bank_r, void* seg_log, void* stream) {
  using namespace flims;
  if (S <= 0 || cap < 1 || (cap & (cap - 1)) || cap > (1 << 30)) return cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  if (dtype == kInt32)
    return seg::dispatch<int32_t>(kv, desc, kin, offsets, kout, pout, S, cap, bank, bank_r,
                                  seg_log, st);
  if (dtype == kFloat32)
    return seg::dispatch<float>(kv, desc, kin, offsets, kout, pout, S, cap, bank, bank_r, seg_log,
                                st);
  return cudaErrorInvalidValue;
}

#ifdef K56_PROFILE
// load (the segment's lanes into registers and the vote), regs (stages
// within a thread, with the direction flips), shfl (stages across lanes),
// smem (stages through shared memory with their barriers and copies; the
// whole network on the c = 32768 route), store, total, exact (count of warps
// on the exact lanes)
extern "C" const char* k56_prof_names() { return "load,regs,shfl,smem,store,total,exact"; }
extern "C" int k56_prof_layout(int* ctas, int* warps, int* counters) {
  *ctas = NET_PROF_CTAS;
  *warps = kProfWarps;
  *counters = kProfCounters;
  return 0;
}
extern "C" int k56_prof_read(void* dst) {
  return cudaMemcpyFromSymbol(dst, net_prof, sizeof(net_prof));
}
extern "C" int k56_prof_zero() {
  void* p = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&p, net_prof);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(net_prof));
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&p, net_when);
  return e != cudaSuccess ? e : cudaMemset(p, 0, sizeof(net_when));
}
// (start ns, end ns, SM) per CTA
extern "C" int k56_when_read(void* dst) {
  return cudaMemcpyFromSymbol(dst, net_when, sizeof(net_when));
}
#endif
