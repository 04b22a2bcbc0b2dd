// K1: bitonic sort of every row of an (m, c) tile, c a power of two.
//
// Replaces `sort_chunks_pallas` / `sort_chunks_kv_pallas`
// (src/repro/kernels/bitonic_sort.py:84, :106; network in
// `_bitonic_rows_desc` :17 and `_bitonic_rows_kv` :39).
//
// One CTA per row, the row (keys, and ranks on KV lanes) in shared memory,
// min(c/2, 1024) threads doing one compare-exchange each per stage with a
// __syncthreads() between stages. The static network and its direction
// rule, (first // k) % 2, are the TPU kernel's. Key-only rows sort
// descending with XLA's max/min; KV rows by (key in the call's direction,
// rank ascending).
//
// Bound: for c = 256 the network runs 36 stages over the row, so at the
// main path's shapes the kernel is bound by shared-memory traffic and
// barriers rather than by device memory (one read and one write of the row).
#include "flims.cuh"

namespace flims {

template <typename T, bool KV, bool DESC>
__global__ void bitonic_rows_kernel(const T* __restrict__ kin, const int32_t* __restrict__ rin,
                                    T* __restrict__ kout, int32_t* __restrict__ rout, int c,
                                    int logc) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sk = reinterpret_cast<T*>(smem);
  int32_t* sr = reinterpret_cast<int32_t*>(sk + c);
  const long long row = (long long)blockIdx.x * c;
  for (int j = threadIdx.x; j < c; j += blockDim.x) {
    sk[j] = kin[row + j];
    if (KV) sr[j] = rin[row + j];
  }
  __syncthreads();
  bitonic_smem<T, KV, DESC>(sk, sr, logc);
  for (int j = threadIdx.x; j < c; j += blockDim.x) {
    kout[row + j] = sk[j];
    if (KV) rout[row + j] = sr[j];
  }
}

template <typename T, bool KV, bool DESC>
static cudaError_t launch(const void* kin, const void* rin, void* kout, void* rout, int m,
                          int c, cudaStream_t st) {
  int logc = 0;
  while ((1 << logc) < c) ++logc;
  const int threads = c / 2 < 1 ? 1 : (c / 2 > 1024 ? 1024 : c / 2);
  const size_t smem = (size_t)c * (sizeof(T) + (KV ? sizeof(int32_t) : 0));
  auto kern = bitonic_rows_kernel<T, KV, DESC>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<m, threads, smem, st>>>((const T*)kin, (const int32_t*)rin, (T*)kout, (int32_t*)rout,
                                 c, logc);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch(int kv, int desc, const void* kin, const void* rin, void* kout,
                            void* rout, int m, int c, cudaStream_t st) {
  if (!kv && desc) return launch<T, false, true>(kin, rin, kout, rout, m, c, st);
  if (kv && desc) return launch<T, true, true>(kin, rin, kout, rout, m, c, st);
  if (kv && !desc) return launch<T, true, false>(kin, rin, kout, rout, m, c, st);
  return cudaErrorInvalidValue;  // key-only rows sort descending only
}

}  // namespace flims

extern "C" int flims_bitonic_rows(int dtype, int kv, int desc, const void* kin, const void* rin,
                                  void* kout, void* rout, int m, int c, void* stream) {
  using namespace flims;
  if (m <= 0 || c < 1 || (c & (c - 1))) return cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  if (dtype == kInt32) return dispatch<int32_t>(kv, desc, kin, rin, kout, rout, m, c, st);
  if (dtype == kFloat32) return dispatch<float>(kv, desc, kin, rin, kout, rout, m, c, st);
  return cudaErrorInvalidValue;
}
