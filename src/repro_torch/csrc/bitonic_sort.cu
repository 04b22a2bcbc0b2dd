// K1: bitonic sort of every row of an (m, c) tile, c a power of two from 1
// to 2^30, as a register-resident warp network (rows past 16384 keys also
// through device memory).
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
// - Rows past 16384 keys (c x 8 bytes would pass a CTA's 227 KB at 32768
//   KV) sort in tiles of 16384 with the stages at d >= 16384 as column
//   passes over device memory, up to five stages a pass (sort_rows_past_tile,
//   bitonic_net.cuh): the same network, two launches a phase above the
//   tile, each key read and written once a launch.
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
#include "bitonic_net.cuh"

namespace flims {
namespace k1 {

using namespace net;

constexpr int kTileWarps = 4;           // warps (tiles) a CTA of the warp kernel
constexpr int kWarpLogC = 8;            // rows up to 2^8 = kTile: the warp kernel
constexpr int kMaxLogC = kRowTileLog;   // rows up to 16384 keys: a row a CTA
constexpr int kMaxLogR = 30;            // wider rows: sort_rows_past_tile

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
  const uintptr_t align = (uintptr_t)a.kin | (uintptr_t)a.rin | (uintptr_t)a.kout | (uintptr_t)a.rout;
  const int vec = (align & 15) == 0;
  cudaError_t e;
  if (a.logc <= kWarpLogC) {
    const KernFn<T> kern = warp_kernel<T, KV, DESC, 0>(a.logc);
    const int threads = 32 * kTileWarps;
    const long long tile = (long long)kTile * kTileWarps, blocks = (total + tile - 1) / tile;
    if (a.smem) {
      cudaFuncAttributes at;
      e = cudaFuncGetAttributes(&at, kern);
      *a.smem = (long long)at.sharedSizeBytes;
      return e;
    }
    if (a.per_sm) return cudaOccupancyMaxActiveBlocksPerMultiprocessor(a.per_sm, kern, threads, 0);
    kern<<<(unsigned)blocks, threads, 0, a.st>>>((const T*)a.kin, (const int32_t*)a.rin,
                                                 (T*)a.kout, (int32_t*)a.rout, total, a.logc,
                                                 vec);
    return cudaGetLastError();
  }
  // a row a CTA, or past kMaxLogC keys a tile of one (sort_rows_past_tile,
  // bitonic_net.cuh), whose kernel the queries describe
  const int lt = a.logc < kMaxLogC ? a.logc : kMaxLogC;
  const int E = lt == kMaxLogC ? 16 : 8;
  const auto kern = E == 16 ? &tile_rows_kernel<T, KV, DESC, 16> : &tile_rows_kernel<T, KV, DESC, 8>;
  const int threads = (1 << lt) / E;
  const size_t dyn = ((size_t)1 << lt) * (KV ? 8 : 4);
  e = allow_smem(kern, dyn);
  if (e != cudaSuccess) return e;
  if (a.smem) {
    cudaFuncAttributes at;
    e = cudaFuncGetAttributes(&at, kern);
    *a.smem = (long long)at.sharedSizeBytes + (long long)dyn;
    return e;
  }
  if (a.per_sm) return cudaOccupancyMaxActiveBlocksPerMultiprocessor(a.per_sm, kern, threads, dyn);
  if (a.logc > lt)
    return sort_rows_past_tile<T, KV, DESC>((const T*)a.kin, (const int32_t*)a.rin, (T*)a.kout,
                                            (int32_t*)a.rout, total, a.logc, vec, a.st);
  kern<<<(unsigned)a.m, threads, dyn, a.st>>>((const T*)a.kin, (const int32_t*)a.rin, (T*)a.kout,
                                             (int32_t*)a.rout, total, lt, lt, vec);
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
  if (c < 1 || (c & (c - 1)) || c > (1 << kMaxLogR)) return cudaErrorInvalidValue;
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
// load (global loads, the key transform and the exact-path vote), regs
// (stages within a thread, with the direction flips), shfl (stages across
// lanes), smem (stages through shared memory, their barriers and the copies
// in and out), store, total, exact (count of warps on the exact path)
extern "C" const char* k1_prof_names() { return "load,regs,shfl,smem,store,total,exact"; }
extern "C" int k1_prof_layout(int* ctas, int* warps, int* counters) {
  *ctas = NET_PROF_CTAS;
  *warps = kProfWarps;
  *counters = kProfCounters;
  return 0;
}
extern "C" int k1_prof_read(void* dst) {
  return cudaMemcpyFromSymbol(dst, net_prof, sizeof(net_prof));
}
extern "C" int k1_prof_zero() {
  void* p = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&p, net_prof);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(net_prof));
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&p, net_when);
  return e != cudaSuccess ? e : cudaMemset(p, 0, sizeof(net_when));
}
// (start ns, end ns, SM) per CTA
extern "C" int k1_when_read(void* dst) {
  return cudaMemcpyFromSymbol(dst, net_when, sizeof(net_when));
}
#endif
