// K7: fused MoE routing, router logits -> capacity slabs, one CTA per group.
//
// Replaces `moe_route_pallas` (src/repro/kernels/route_fuse.py:161,
// `pallas_call` :181; body `_route_kernel` :86, `_topk_softmax` :59).
//
// For the T tokens of group g (logits (T, E) float32):
//  1. top-k: each thread takes tokens t = threadIdx.x, += blockDim.x and
//     runs k arg-max sweeps over the token's E logits, compared as the
//     monotone int32 transform of their bits (b ^ ((b >> 31) & 0x7fffffff)),
//     so -0.0 ranks below +0.0 as in `lax.top_k`; ties go to the lower
//     expert. Sweep j takes the largest (key, -expert) strictly after sweep
//     j-1's pick, so no mask is kept;
//  2. softmax of the k picked values, `jax.nn.softmax` op for op:
//     expf(v - max) / sum, the sum taken in pick order (expf, never __expf;
//     the source builds without --use_fast_math);
//  3. pair p = t*k + j gets the compound key e*Np + p in shared memory and
//     its weight's bits on the rank lane; lanes N..Np-1 are INT32_MAX /
//     INVALID_RANK pads;
//  4. one ascending KV bitonic network (`bitonic_smem`) over the Np lanes.
//     The keys are distinct, so any correct sort gives the TPU kernel's
//     order: its bitonic chunks plus `tree_dataflow` are how a VMEM-resident
//     sort is built there, with nothing to carry over here;
//  5. the capacity cut: pair i's rank within its expert is i - first[e],
//     first[e] the lower bound of e*Np among the sorted keys (a binary
//     search over shared memory, which equals the TPU kernel's one-hot
//     histogram and exclusive scan and needs no E-sized buffer);
//     keep = rank < cap, slab = keep ? e*cap + rank : E*cap;
//  6. the six (G, N) lanes are written for i < N only.
//
// Bound: latency and shared memory, not device memory. One group's logits
// are read once and six lanes written once (at T = 2048, E = 8, k = 2: 64
// KiB in, 96 KiB out, tens of nanoseconds at 3.35 TB/s), while one CTA runs
// log2(Np)(log2(Np)+1)/2 barrier-separated stages on one SM. The lanes take
// Np * 8 B of shared memory, so Np <= 16384 fits the 227 KB a CTA may use;
// the wrapper refuses more, and a group above that needs a multi-CTA sort.
#include "flims.cuh"

namespace flims {

__device__ __forceinline__ int32_t untwist(int32_t b) { return b ^ ((b >> 31) & 0x7fffffff); }

__global__ void route_kernel(const float* __restrict__ logits, int T, int E, int k, int cap,
                             int logNp, int32_t* __restrict__ experts,
                             int32_t* __restrict__ tokens, int32_t* __restrict__ perm,
                             float* __restrict__ weights, int32_t* __restrict__ slabs,
                             int32_t* __restrict__ keep) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Np = 1 << logNp;
  const int N = T * k;
  int32_t* sk = reinterpret_cast<int32_t*>(smem);
  int32_t* sr = sk + Np;
  const long long g = blockIdx.x;
  const float* lg = logits + g * (long long)T * E;

  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    const int32_t* row = reinterpret_cast<const int32_t*>(lg + (long long)t * E);
    int32_t prev_key = 0;
    int prev_e = -1;
    for (int j = 0; j < k; ++j) {
      int32_t best_key = 0;
      int best_e = -1;
      for (int e = 0; e < E; ++e) {
        const int32_t key = untwist(row[e]);
        const bool after = j == 0 || key < prev_key || (key == prev_key && e > prev_e);
        if (after && (best_e < 0 || key > best_key)) {
          best_key = key;
          best_e = e;
        }
      }
      prev_key = best_key;
      prev_e = best_e;
      const int p = t * k + j;
      sk[p] = best_e * Np + p;
      sr[p] = untwist(best_key);  // the picked logit's bits, for now
    }
    // softmax over this token's k picks (pick 0 is the maximum)
    const float vmax = __int_as_float(sr[t * k]);
    float sum = 0.f;
    for (int j = 0; j < k; ++j) sum += expf(__int_as_float(sr[t * k + j]) - vmax);
    for (int j = 0; j < k; ++j) {
      const float u = expf(__int_as_float(sr[t * k + j]) - vmax);
      sr[t * k + j] = __float_as_int(u / sum);
    }
  }
  for (int i = N + threadIdx.x; i < Np; i += blockDim.x) {
    sk[i] = 0x7fffffff;
    sr[i] = kInvalidRank;
  }
  __syncthreads();
  bitonic_smem<int32_t, true, false>(sk, sr, logNp);

  const long long out0 = g * (long long)N;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const int32_t key = sk[i];
    const int e = key >> logNp;
    const int p = key & (Np - 1);
    int lo = 0, hi = i;  // first index whose key reaches e*Np
    const int32_t base = e << logNp;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (sk[mid] < base) lo = mid + 1; else hi = mid;
    }
    const int pos = i - lo;
    const bool kept = pos < cap;
    experts[out0 + i] = e;
    tokens[out0 + i] = p / k;
    perm[out0 + i] = p;
    weights[out0 + i] = __int_as_float(sr[i]);
    slabs[out0 + i] = kept ? e * cap + pos : E * cap;
    keep[out0 + i] = kept ? 1 : 0;
  }
}

}  // namespace flims

extern "C" int flims_moe_route(const void* logits, int G, int T, int E, int k, int cap, int Np,
                               void* experts, void* tokens, void* perm, void* weights,
                               void* slabs, void* keep, void* stream) {
  using namespace flims;
  if (G <= 0 || T <= 0 || k < 1 || k > E || cap < 1 || Np < T * k || (Np & (Np - 1)))
    return cudaErrorInvalidValue;
  int logNp = 0;
  while ((1 << logNp) < Np) ++logNp;
  const int half = Np / 2;
  const int threads = half < 32 ? 32 : (half > 1024 ? 1024 : half);
  const size_t smem = (size_t)Np * 2 * sizeof(int32_t);
  const cudaError_t e = allow_smem(route_kernel, smem);
  if (e != cudaSuccess) return e;
  route_kernel<<<G, threads, smem, (cudaStream_t)stream>>>(
      (const float*)logits, T, E, k, cap, logNp, (int32_t*)experts, (int32_t*)tokens,
      (int32_t*)perm, (float*)weights, (int32_t*)slabs, (int32_t*)keep);
  return cudaGetLastError();
}
