// K2/K3: merge-path partitioned FLiMS merge of R run pairs in one launch.
//
// Replaces `flims_merge_pallas` / `flims_merge_kv_pallas`
// (src/repro/kernels/flims_merge.py:159, :330) and `segmented_merge_runs` /
// `segmented_merge_runs_kv` (src/repro/kernels/segmented_merge.py:140,
// :299); K2 is this kernel with R = 1.
//
// One CTA per (segment, C-wide output block), max(w, 32) threads. A CTA
// finds its segment by binary search over the block prefix sums `blk0`,
// finds its own merge-path co-rank with a cooperative search, and then
// runs ceil(valid / w) FLiMS cycles. Runs are read in place with masked
// loads and the block is written straight to its flat output offset, so
// the TPU kernel's sentinel-padded banks and the (G, C) output plus gather
// (two extra passes over device memory) do not exist here.
//
// Bound: device memory. Each element is read once from each side's window
// and written once; the selector and butterfly are a few dozen integer
// operations per element, far below the card's rate.
#include "flims.cuh"

namespace flims {

template <typename T, bool KV, bool DESC>
__global__ void merge_blocks_kernel(const T* __restrict__ a, const int32_t* __restrict__ ra,
                                    const T* __restrict__ b, const int32_t* __restrict__ rb,
                                    const int32_t* __restrict__ a_starts,
                                    const int32_t* __restrict__ a_lens,
                                    const int32_t* __restrict__ b_starts,
                                    const int32_t* __restrict__ b_lens,
                                    const int32_t* __restrict__ out_off,
                                    const int32_t* __restrict__ blk0,
                                    T* __restrict__ out, int32_t* __restrict__ out_r,
                                    int R, int n_out, int C, int w) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xk = reinterpret_cast<T*>(smem);
  int32_t* xr = reinterpret_cast<int32_t*>(xk + blockDim.x);

  const int g = blockIdx.x;
  if (g >= blk0[R]) return;  // tail CTAs of the static grid
  const int s = find_segment(blk0, R + 1, g);
  const int la = a_lens[s], lb = b_lens[s];
  const long long o = (long long)(g - blk0[s]) * C;
  // a block never writes past its segment, nor past the output
  const int valid = (int)min(min((long long)C, (long long)la + lb - o),
                             (long long)n_out - out_off[s] - o);
  if (valid <= 0) return;

  RunReader<T, KV, DESC> A{a, ra, a_starts[s], la, 0, w};
  RunReader<T, KV, DESC> B{b, rb, b_starts[s], lb, 0, w};
  const int oi = (int)o;
  const int acut = coop_search(max(0, oi - lb), min(oi, la), [&](int m) {
    return wins<T, KV, DESC>(A.at(m - 1), B.at(oi - m));
  });
  const int bcut = oi - acut;
  A.base = acut - acut % w;
  B.base = bcut - bcut % w;

  T* ok = out + (long long)out_off[s] + o;
  int32_t* orr = KV ? out_r + (long long)out_off[s] + o : nullptr;
  auto write = [&](int t, int c, const Lane<T>& v) {
    const int p = t * w + c;
    if (p < valid) {
      ok[p] = v.k;
      if (KV) orr[p] = v.r;
    }
  };
  merge_stream<T, KV, DESC, !KV>(A, B, acut % w, bcut % w, (valid + w - 1) / w,
                                 write, w, xk, xr);
}

template <typename T, bool KV, bool DESC>
static cudaError_t launch(const void* a, const void* ra, const void* b, const void* rb,
                          const int32_t* a_starts, const int32_t* a_lens,
                          const int32_t* b_starts, const int32_t* b_lens,
                          const int32_t* out_off, const int32_t* blk0, void* out,
                          void* out_r, int R, int n_out, int G, int C, int w,
                          cudaStream_t st) {
  const int threads = w < 32 ? 32 : w;
  const size_t smem = (size_t)threads * (sizeof(T) + (KV ? sizeof(int32_t) : 0));
  merge_blocks_kernel<T, KV, DESC><<<G, threads, smem, st>>>(
      (const T*)a, (const int32_t*)ra, (const T*)b, (const int32_t*)rb, a_starts, a_lens,
      b_starts, b_lens, out_off, blk0, (T*)out, (int32_t*)out_r, R, n_out, C, w);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch(int kv, int desc, const void* a, const void* ra, const void* b,
                            const void* rb, const int32_t* as, const int32_t* al,
                            const int32_t* bs, const int32_t* bl, const int32_t* oo,
                            const int32_t* blk0, void* out, void* out_r, int R, int n_out,
                            int G, int C, int w, cudaStream_t st) {
  if (!kv && desc) return launch<T, false, true>(a, ra, b, rb, as, al, bs, bl, oo, blk0, out, out_r, R, n_out, G, C, w, st);
  if (kv && desc) return launch<T, true, true>(a, ra, b, rb, as, al, bs, bl, oo, blk0, out, out_r, R, n_out, G, C, w, st);
  if (kv && !desc) return launch<T, true, false>(a, ra, b, rb, as, al, bs, bl, oo, blk0, out, out_r, R, n_out, G, C, w, st);
  return cudaErrorInvalidValue;  // key-only lanes merge descending only
}

}  // namespace flims

extern "C" int flims_merge_blocks(int dtype, int kv, int desc, const void* a, const void* ra,
                                  const void* b, const void* rb, const void* a_starts,
                                  const void* a_lens, const void* b_starts, const void* b_lens,
                                  const void* out_off, const void* blk0, void* out, void* out_r,
                                  int R, int n_out, int G, int C, int w, void* stream) {
  using namespace flims;
  if (w < 1 || w > 1024 || (w & (w - 1)) || C % w || G <= 0) return cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  auto I = [](const void* p) { return (const int32_t*)p; };
  if (dtype == kInt32)
    return dispatch<int32_t>(kv, desc, a, ra, b, rb, I(a_starts), I(a_lens), I(b_starts),
                             I(b_lens), I(out_off), I(blk0), out, out_r, R, n_out, G, C, w, st);
  if (dtype == kFloat32)
    return dispatch<float>(kv, desc, a, ra, b, rb, I(a_starts), I(a_lens), I(b_starts),
                           I(b_lens), I(out_off), I(blk0), out, out_r, R, n_out, G, C, w, st);
  return cudaErrorInvalidValue;
}
