// K5 / K6: fused segmented sort of a ragged batch, one CTA per segment.
//
// Replaces `segment_sort_pallas` (src/repro/kernels/segmented_merge.py:402,
// `pallas_call` :422, body `_sort_row_kernel` :396) and
// `segment_sort_kv_pallas` (:499, `pallas_call` :521, rank lanes from
// `_rank_bank` :489), which serves `segment_argsort_pallas` :536.
//
// CTA s reads `keys[offsets[s] : offsets[s+1]]` straight into shared memory,
// fills the rest of its lanes with the last key (and INVALID_RANK on KV
// lanes, whose rank is the segment-local position), runs K1's bitonic
// network (`bitonic_smem`) and writes only the valid prefix back to the
// segment's flat offset. The TPU wrapper's padded (S, cap) bank gather and
// its searchsorted unpad have no counterpart: they were two extra passes
// over device memory.
//
// Key-only lanes (K5) run the network over the full static `cap`, as the
// TPU kernel does: with XLA's max/min the sign bits a +0/-0 tie leaves
// depend on the network, so a narrower one would not be bit-for-bit the
// reference. KV lanes (K6) have no ties left (ranks are distinct), so any
// network gives the same output and each CTA sorts only next_pow2(len)
// lanes; an empty segment returns at once.
//
// Bound: shared memory and barriers. Each key is read once and written
// once (twice on KV lanes, with its rank), but the network runs
// log2(c)(log2(c)+1)/2 barrier-separated stages over c lanes. Shared memory
// is c * 4 B (K5) or c * 8 B (K6) per CTA, so c <= 32768 (K5) and
// c <= 16384 (K6) fit the 227 KB a CTA may use; the wrapper refuses more.
#include "flims.cuh"

namespace flims {

template <typename T, bool KV, bool DESC>
__global__ void segment_sort_kernel(const T* __restrict__ kin, const int32_t* __restrict__ offsets,
                                    T* __restrict__ kout, int32_t* __restrict__ pout, int logcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long o0 = offsets[blockIdx.x];
  // A cap below the segment's length (engine.segment_sort refuses one)
  // sorts its first cap keys and leaves the rest unwritten: the kernel
  // never steps past its shared memory.
  int len = (int)(offsets[blockIdx.x + 1] - o0);
  if (len > (1 << logcap)) len = 1 << logcap;
  if (len == 0) return;  // uniform over the CTA: no barrier is skipped by half of it
  int logc = logcap;
  if (KV) {
    logc = 0;
    while ((1 << logc) < len) ++logc;
  }
  const int c = 1 << logc;
  T* sk = reinterpret_cast<T*>(smem);
  int32_t* sr = reinterpret_cast<int32_t*>(sk + c);
  for (int j = threadIdx.x; j < c; j += blockDim.x) {
    const bool valid = j < len;
    sk[j] = valid ? kin[o0 + j] : last_key<T, DESC>();
    if (KV) sr[j] = valid ? j : kInvalidRank;
  }
  __syncthreads();
  bitonic_smem<T, KV, DESC>(sk, sr, logc);
  for (int j = threadIdx.x; j < len; j += blockDim.x) {
    kout[o0 + j] = sk[j];
    if (KV) pout[o0 + j] = sr[j];
  }
}

template <typename T, bool KV, bool DESC>
static cudaError_t launch(const void* kin, const void* offsets, void* kout, void* pout, int S,
                          int cap, cudaStream_t st) {
  int logcap = 0;
  while ((1 << logcap) < cap) ++logcap;
  const int half = cap / 2;
  const int threads = half < 32 ? 32 : (half > 1024 ? 1024 : half);
  const size_t smem = (size_t)cap * (sizeof(T) + (KV ? sizeof(int32_t) : 0));
  auto kern = segment_sort_kernel<T, KV, DESC>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<S, threads, smem, st>>>((const T*)kin, (const int32_t*)offsets, (T*)kout,
                                 (int32_t*)pout, logcap);
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

}  // namespace flims

extern "C" int flims_segment_sort(int dtype, int kv, int desc, const void* kin,
                                  const void* offsets, void* kout, void* pout, int S, int cap,
                                  void* stream) {
  using namespace flims;
  if (S <= 0 || cap < 1 || (cap & (cap - 1))) return cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  if (dtype == kInt32) return dispatch<int32_t>(kv, desc, kin, offsets, kout, pout, S, cap, st);
  if (dtype == kFloat32) return dispatch<float>(kv, desc, kin, offsets, kout, pout, S, cap, st);
  return cudaErrorInvalidValue;
}
