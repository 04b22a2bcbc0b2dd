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
constexpr int kMaxThreads = 1024;

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
                                            int logcap, unsigned char* smem) {
  constexpr int LOGE = ilog2(E), LOGT = LOGE + 5;
  const int t = threadIdx.x, lane = t & 31;
  const long long o0 = offsets[blockIdx.x];
  // A cap below the segment's length (engine.segment_sort refuses one)
  // sorts its first cap keys and leaves the rest unwritten.
  const int len = min((int)(offsets[blockIdx.x + 1] - o0), 1 << logcap);
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

template <typename T, bool KV, bool DESC, int E, bool WARP>
__global__ void __launch_bounds__(kMaxThreads)
    segment_sort_kernel(const T* __restrict__ kin, const int32_t* __restrict__ offsets,
                        T* __restrict__ kout, int32_t* __restrict__ pout, int S, int logcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  PROF_INIT();
  PROF_START(t_total);
  if constexpr (WARP)
    warp_segment<T, KV, DESC, E>(kin, offsets, kout, pout, S, logcap);
  else
    cta_segment<T, KV, DESC, E>(kin, offsets, kout, pout, logcap, smem);
  PROF(5, t_total);
  PROF_FLUSH();
}

template <typename T, bool KV, bool DESC>
static cudaError_t launch(const void* kin, const void* offsets, void* kout, void* pout, int S,
                          int cap, cudaStream_t st) {
  const int logcap = ilog2(cap);
  void (*kern)(const T*, const int32_t*, T*, int32_t*, int, int);
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
                                      (int32_t*)pout, S, logcap);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch(int kv, int desc, const void* kin, const void* offsets, void* kout,
                            void* pout, int S, int cap, cudaStream_t st) {
  if (!kv && desc) return launch<T, false, true>(kin, offsets, kout, pout, S, cap, st);
  if (kv && desc) return launch<T, true, true>(kin, offsets, kout, pout, S, cap, st);
  if (kv && !desc) return launch<T, true, false>(kin, offsets, kout, pout, S, cap, st);
  return cudaErrorInvalidValue;  // key-only segments sort descending only
}

}  // namespace seg
}  // namespace flims

extern "C" int flims_segment_sort(int dtype, int kv, int desc, const void* kin,
                                  const void* offsets, void* kout, void* pout, int S, int cap,
                                  void* stream) {
  using namespace flims;
  if (S <= 0 || cap < 1 || (cap & (cap - 1)) || cap > (kv ? 16384 : 32768))
    return cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  if (dtype == kInt32) return seg::dispatch<int32_t>(kv, desc, kin, offsets, kout, pout, S, cap, st);
  if (dtype == kFloat32) return seg::dispatch<float>(kv, desc, kin, offsets, kout, pout, S, cap, st);
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
