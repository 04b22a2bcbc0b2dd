// K7: fused MoE routing, router logits -> capacity slabs, across the card.
//
// Replaces `moe_route_pallas` (src/repro/kernels/route_fuse.py:161,
// `pallas_call` :181; body `_route_kernel` :86, `_topk_softmax` :59).
//
// The six (G, N) lanes, N = T*k, list the pairs p = t*k + j (token t's j-th
// pick) in the ascending order of the JAX kernel's compound keys e*Np + p:
// by expert, then by pair. The keys are distinct, so that order is a
// stable partition of the pairs by expert, a counting sort, and the TPU
// kernel's bitonic chunks and merge tree (how a VMEM-resident sort is built
// there) have nothing to carry over here. Three launches, one C call:
//  1. topk_kernel, a CTA per (group, tile of kTile = 16 tokens): L =
//     min(32, next_pow2(E)) lanes per token, lane l holding experts l, l +
//     L, ... (in registers up to 8 a lane, read again at each sweep above),
//     the row read once, coalesced. k arg-max sweeps compare the monotone
//     int32 transform of the bits (b ^ ((b >> 31) & 0x7fffffff)), so -0.0
//     ranks below +0.0 as in `lax.top_k`, ties to the lower expert, each a
//     shuffle reduction over the token's lanes. `_topk_softmax` masks each
//     pick's key to INT32_MIN and takes the lowest expert among the
//     maximum; sweep j takes the largest (key, -expert) strictly after sweep
//     j-1's pick, which is that rule while the maximum is above INT32_MIN,
//     and once it is INT32_MIN (the logit bits 0xFFFFFFFF) the masked row is
//     INT32_MIN throughout, so this sweep and every later one pick expert 0
//     with the key INT32_MIN. Then `jax.nn.softmax` of the k picks,
//     expf(v - max) / sum (expf, never __expf: the source builds without
//     --use_fast_math), the sum taken in pick order in double and rounded
//     once: a float sum in pick order strays from any other order's by
//     more than ROUTE_WEIGHT_ULPS at k = 64 (13 ulps). Each pair's expert and
//     weight go to a pair-order scratch, and the tile's pairs per expert to
//     cnt[g][e][tile] (atomics on the CTA's own column).
//  2. scan_kernel, a CTA per group: one exclusive scan over cnt[g] read
//     expert-major (a thread a contiguous share), so cnt[g][e][tile] becomes the sorted index of the
//     tile's first pair of expert e, first[e] + (pairs of e in earlier
//     tiles), and first[e] is cnt[g][e][0].
//  3. scatter_kernel, a warp per (group, tile): the tile's pairs in pair
//     order, 32 at a time; a pair's rank among the earlier ones of its
//     expert in the tile is a running count per expert (the tile's own
//     column of cnt, updated in place) plus the lower lanes of its
//     __match_any_sync set. Its sorted index i, its rank in the
//     expert pos = i - first[e], the capacity cut keep = pos < cap and slab
//     = keep ? e*cap + pos : E*cap; the six lanes are written at i.
//
// Bound: latency, not device memory or operations. At a Moonlight chunk (T
// 2048, E 64, k 6) the logits are 512 KiB and the lanes 288 KiB (0.2 us at
// 3.35 TB/s); the sweeps are T*k*E compares. The first version ran the
// whole group on one CTA (one SM of 132) through a bitonic network of
// log2(Np)(log2(Np)+1)/2 barrier-separated stages over shared memory; here
// every stage runs on as many CTAs as the group has tiles, each a short
// chain, and the launches' own latency is most of the time. The wrapper
// keeps the first version's refusals (Np <= 16384, E*Np < 2^31), which the
// JAX kernel's compound key and VMEM set, though nothing here needs them.
#include "flims.cuh"

// Clock counters for scripts/k7_profile.py, compiled in only under
// -DK7_PROFILE: each thread sums SM clocks per phase in registers; at a
// warp's end its lane 0 adds them to k7_prof and counts the warp by kernel, and each
// kernel's earliest CTA start and latest warp end (globaltimer, ns) go to
// k7_span. Without the define every K7_* macro is empty.
#ifdef K7_PROFILE
constexpr int kK7Counters = 6;
constexpr int kK7Kernels = 3;
__device__ unsigned long long k7_prof[kK7Counters + kK7Kernels];  // clocks per phase, warps per kernel
__device__ unsigned long long k7_span[2 * kK7Kernels];
__device__ __forceinline__ unsigned long long k7_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void k7_open(int kid) {
  if (threadIdx.x == 0) atomicMin(&k7_span[2 * kid], k7_now());
}
__device__ __forceinline__ void k7_close(int kid, const unsigned long long* c) {
  if ((threadIdx.x & 31) == 0) {
    for (int i = 0; i < kK7Counters; ++i)
      if (c[i]) atomicAdd(&k7_prof[i], c[i]);
    atomicAdd(&k7_prof[kK7Counters + kid], 1ull);
    atomicMax(&k7_span[2 * kid + 1], k7_now());
  }
}
#define K7_CLOCKS unsigned long long k7c_[kK7Counters] = {}
#define K7_T(t) const long long t = clock64()
#define K7_ACC(c, t) k7c_[c] += clock64() - (t)
#define K7_OPEN(kid) k7_open(kid)
#define K7_CLOSE(kid) k7_close(kid, k7c_)
#else
#define K7_CLOCKS
#define K7_T(t)
#define K7_ACC(c, t) do { } while (0)
#define K7_OPEN(kid) do { } while (0)
#define K7_CLOSE(kid) do { } while (0)
#endif

namespace flims {
namespace route {

__device__ __forceinline__ int32_t untwist(int32_t b) { return b ^ ((b >> 31) & 0x7fffffff); }
constexpr int32_t kKeyMin = -0x7fffffff - 1;
// tokens a tile: at most 16 x 32 lanes = 512 threads a top-k CTA
constexpr int kTile = 16;
constexpr int kScanThreads = 1024;

// PER: experts a lane holds in registers (E <= 8 L); 0: read at each sweep.
// A group of L lanes runs one token; the groups of a warp, and a CTA's
// groups past the tile or past T, sweep too (every shuffle takes the whole
// warp) and store nothing.
template <int PER>
__global__ void __launch_bounds__(1024)
    topk_kernel(const float* __restrict__ logits, int T, int E, int k, int logL, int tiles,
                int32_t* __restrict__ pe, float* __restrict__ pw, int32_t* __restrict__ cnt) {
  const long long g = blockIdx.x;
  const int tl = blockIdx.y, L = 1 << logL;
  const int sub = threadIdx.x & (L - 1), grp = threadIdx.x >> logL;
  K7_CLOCKS;
  K7_OPEN(0);
  int32_t* col = cnt + g * E * tiles + tl;  // expert e at col[e * tiles]
  for (int e = threadIdx.x; e < E; e += blockDim.x) col[(long long)e * tiles] = 0;
  __syncthreads();
  const int t0 = tl * kTile;
  const bool live = grp < kTile && t0 + grp < T;
  const int t = live ? t0 + grp : t0;
  const int32_t* row = reinterpret_cast<const int32_t*>(logits + (g * T + t) * E);
  K7_T(t_load);
  int32_t key[PER > 0 ? PER : 1];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = sub + (i << logL);
    key[i] = e < E ? untwist(__ldg(row + e)) : kKeyMin;
  }
  K7_ACC(0, t_load);
  const long long pbase = (g * T + t) * k;
  int32_t pk = 0;
  int pe_ = -1;
  float vmax = 0.f;
  double sum = 0.0;
  for (int j = 0; j < k; ++j) {
    K7_T(t_sweep);
    // this lane's largest (key, -expert) strictly after the last pick
    int32_t bk = 0;
    int be = -1;
    auto consider = [&](int e, int32_t x) {
      const bool after = j == 0 || x < pk || (x == pk && e > pe_);
      if (e < E && after && (be < 0 || x > bk)) {
        bk = x;
        be = e;
      }
    };
    if constexpr (PER > 0) {
#pragma unroll
      for (int i = 0; i < PER; ++i) consider(sub + (i << logL), key[i]);
    } else {
      for (int e = sub; e < E; e += L) consider(e, untwist(__ldg(row + e)));
    }
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) {
      if (d >= L) continue;
      const int32_t ok = __shfl_xor_sync(kFullWarp, bk, d);
      const int oe = __shfl_xor_sync(kFullWarp, be, d);
      if (oe >= 0 && (be < 0 || ok > bk || (ok == bk && oe < be))) {
        bk = ok;
        be = oe;
      }
    }
    if (be < 0 || bk == kKeyMin) {  // the masked row is all INT32_MIN
      bk = kKeyMin;
      be = 0;
    }
    pk = bk;
    pe_ = be;
    const float v = __int_as_float(untwist(bk));
    if (j == 0) vmax = v;
    sum += (double)expf(v - vmax);
    K7_ACC(1, t_sweep);
    if (live && sub == (j & (L - 1))) {
      K7_T(t_put);
      pe[pbase + j] = be;
      pw[pbase + j] = v;
      atomicAdd(col + (long long)be * tiles, 1);
      K7_ACC(2, t_put);
    }
  }
  K7_T(t_soft);
  // this lane's picks j = sub, sub + L, ...: it stored their values above
  const float fsum = (float)sum;
  if (live)
    for (int j = sub; j < k; j += L) pw[pbase + j] = expf(pw[pbase + j] - vmax) / fsum;
  K7_ACC(2, t_soft);
  K7_CLOSE(0);
}

// One CTA per group: exclusive scan of cnt[g] (E x tiles, expert-major) in
// place, thread t taking a contiguous share; first[g][e] = cnt[g][e][0].
__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(int32_t* __restrict__ cnt, int32_t* __restrict__ first, int E, int tiles) {
  __shared__ int32_t part[kScanThreads];
  K7_CLOCKS;
  K7_OPEN(1);
  K7_T(t_scan);
  const long long g = blockIdx.x, n = (long long)E * tiles;
  int32_t* c = cnt + g * n;
  const int t = threadIdx.x;
  const long long i0 = t * n / kScanThreads, i1 = (t + 1) * n / kScanThreads;
  int32_t sum = 0;
  for (long long i = i0; i < i1; ++i) sum += c[i];
  part[t] = sum;
  __syncthreads();
  for (int d = 1; d < kScanThreads; d <<= 1) {
    const int32_t x = t >= d ? part[t - d] : 0;
    __syncthreads();
    part[t] += x;
    __syncthreads();
  }
  int32_t run = part[t] - sum;
  for (long long i = i0; i < i1; ++i) {
    const int32_t x = c[i];
    c[i] = run;
    if (i % tiles == 0) first[g * E + i / tiles] = run;
    run += x;
  }
  K7_ACC(3, t_scan);
  K7_CLOSE(1);
}

// One warp per (group, tile): the tile's pairs in pair order, 32 at a time.
__global__ void __launch_bounds__(32)
    scatter_kernel(const int32_t* __restrict__ pe, const float* __restrict__ pw,
                   int32_t* __restrict__ cnt, const int32_t* __restrict__ first, int T, int E,
                   int k, int cap, int tiles, int32_t* __restrict__ experts,
                   int32_t* __restrict__ tokens, int32_t* __restrict__ perm,
                   float* __restrict__ weights, int32_t* __restrict__ slabs,
                   int32_t* __restrict__ keep) {
  K7_CLOCKS;
  K7_OPEN(2);
  const long long g = blockIdx.x;
  const int tl = blockIdx.y, lane = threadIdx.x;
  const long long N = (long long)T * k;
  // run[e * tiles]: the sorted index of the next pair of expert e in this tile
  int32_t* run = cnt + g * E * tiles + tl;
  const int32_t* fe = first + g * E;
  const int p_end = (int)min((long long)(tl + 1) * kTile * k, N);
  for (int p0 = tl * kTile * k; p0 < p_end; p0 += 32) {
    K7_T(t_rank);
    const int p = p0 + lane;
    const bool live = p < p_end;
    const int e = live ? pe[g * N + p] : -1;
    const unsigned same = __match_any_sync(kFullWarp, e);
    int32_t* r = run + (long long)(live ? e : 0) * tiles;
    const int i = live ? *r + __popc(same & ((1u << lane) - 1u)) : 0;
    __syncwarp();
    if (live && (same >> lane) == 1u) *r += __popc(same);  // its highest lane
    __syncwarp();
    K7_ACC(4, t_rank);
    K7_T(t_store);
    if (live) {
      const int pos = i - fe[e];
      const bool kept = pos < cap;
      const long long o = g * N + i;
      experts[o] = e;
      tokens[o] = p / k;
      perm[o] = p;
      weights[o] = pw[g * N + p];
      slabs[o] = kept ? e * cap + pos : E * cap;
      keep[o] = kept ? 1 : 0;
    }
    K7_ACC(5, t_store);
  }
  K7_CLOSE(2);
}

template <int PER>
static cudaError_t topk(const float* logits, int G, int T, int E, int k, int logL, int tiles,
                        int32_t* pe, float* pw, int32_t* cnt, cudaStream_t st) {
  const int threads = ((kTile << logL) + 31) / 32 * 32;
  topk_kernel<PER><<<dim3(G, tiles), threads, 0, st>>>(logits, T, E, k, logL, tiles, pe, pw,
                                                       cnt);
  return cudaGetLastError();
}

}  // namespace route
}  // namespace flims

// scratch: G*N pair experts, G*N pair weights, G*E*tiles counts (tiles =
// ceil(T / 16)), G*E firsts
extern "C" int flims_moe_route(const void* logits, int G, int T, int E, int k, int cap,
                               void* experts, void* tokens, void* perm, void* weights,
                               void* slabs, void* keep, void* scratch, void* stream) {
  using namespace flims;
  using namespace flims::route;
  int logL = 0;
  while ((1 << logL) < E && logL < 5) ++logL;
  if (G <= 0 || T <= 0 || k < 1 || k > E || cap < 1) return cudaErrorInvalidValue;
  const int tiles = (T + kTile - 1) / kTile;
  const long long N = (long long)T * k;
  int32_t* pe = (int32_t*)scratch;
  float* pw = (float*)(pe + G * N);
  int32_t* cnt = (int32_t*)(pw + G * N);
  int32_t* first = cnt + (long long)G * E * tiles;
  auto st = (cudaStream_t)stream;
  const int per = (E + (1 << logL) - 1) >> logL;
  const float* lg = (const float*)logits;
  cudaError_t e;
  if (per == 1) e = topk<1>(lg, G, T, E, k, logL, tiles, pe, pw, cnt, st);
  else if (per == 2) e = topk<2>(lg, G, T, E, k, logL, tiles, pe, pw, cnt, st);
  else if (per <= 4) e = topk<4>(lg, G, T, E, k, logL, tiles, pe, pw, cnt, st);
  else if (per <= 8) e = topk<8>(lg, G, T, E, k, logL, tiles, pe, pw, cnt, st);
  else e = topk<0>(lg, G, T, E, k, logL, tiles, pe, pw, cnt, st);
  if (e != cudaSuccess) return e;
  scan_kernel<<<G, kScanThreads, 0, st>>>(cnt, first, E, tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  scatter_kernel<<<dim3(G, tiles), 32, 0, st>>>(
      pe, pw, cnt, first, T, E, k, cap, tiles, (int32_t*)experts, (int32_t*)tokens,
      (int32_t*)perm, (float*)weights, (int32_t*)slabs, (int32_t*)keep);
  return cudaGetLastError();
}

#ifdef K7_PROFILE
// load (the row into registers; its wait shows in the first sweep), sweeps
// (the k arg-max sweeps and their shuffle reductions), softmax (the pair
// stores, the count atomics and the weights), scan, rank (a scatter warp's
// match and running counts), stores (the six lanes)
extern "C" const char* k7_prof_names() { return "load,sweeps,softmax,scan,rank,stores"; }
extern "C" int k7_prof_layout(int* counters, int* kernels) {
  *counters = kK7Counters;
  *kernels = kK7Kernels;
  return 0;
}
extern "C" int k7_prof_zero() {
  unsigned long long span[2 * kK7Kernels];
  for (int i = 0; i < kK7Kernels; ++i) {
    span[2 * i] = ~0ull;
    span[2 * i + 1] = 0;
  }
  const unsigned long long zero[kK7Counters + kK7Kernels] = {};
  cudaError_t e = cudaMemcpyToSymbol(k7_prof, zero, sizeof(zero));
  return e != cudaSuccess ? e : cudaMemcpyToSymbol(k7_span, span, sizeof(span));
}
// clocks per phase summed over warps, then each kernel's warps
extern "C" int k7_prof_read(void* dst) {
  return cudaMemcpyFromSymbol(dst, k7_prof, sizeof(k7_prof));
}
// per kernel: (earliest CTA start, latest warp end) in ns
extern "C" int k7_when_read(void* dst) {
  return cudaMemcpyFromSymbol(dst, k7_span, sizeof(k7_span));
}
#endif
