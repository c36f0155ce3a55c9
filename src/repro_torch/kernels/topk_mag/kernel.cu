// topk_mag: the worker flush's largest-|delta|-first send order, written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/topk_mag/kernel.py:41
// (topk_mag_pallas, body _kernel at :26) together with its host-side f64 tie
// refine (src/repro/kernels/topk_mag/ops.py:23).
//
// Contract: out = the indices of mags in descending order, equal magnitudes
// in first-occurrence order, NaN last -- exactly np.argsort(-mags,
// kind="stable") on the f64 magnitudes.
//
// Design: a rank sort in f64.  One thread per i computes
//   rank[i] = #{j : m_j precedes m_i}
// where j precedes i iff m_j > m_i, or m_j == m_i and j < i (NaN after every
// number, NaNs by index), then writes out[rank[i]] = i.  The relation is a
// strict total order, so the ranks are a permutation.  Comparing in f64
// removes the TPU kernel's f32 ordering and the host refine it needed.
//
// What bounds it on this card: O(n^2) comparisons and 16 n bytes, both tiny
// at the flush's key counts (n = 2 for LDA), so one call costs a launch and
// the caller's copy of the result back to the host.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ bool precedes(double mj, int64_t j, double mi,
                                         int64_t i) {
  const bool nj = isnan(mj), ni = isnan(mi);
  if (nj || ni) return (nj && ni) ? j < i : ni;
  return mj > mi || (mj == mi && j < i);
}

__global__ void topk_mag_kernel(const double* __restrict__ mags, int64_t n,
                                int64_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const double mi = mags[i];
  int64_t rank = 0;
  for (int64_t j = 0; j < n; ++j) rank += precedes(mags[j], j, mi, i);
  out[rank] = i;
}

}  // namespace

// mags: (n,) f64; out: (n,) int64.  The caller guarantees n > 0.
extern "C" int topk_mag_f64(int device, const void* mags, int64_t n, void* out,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  topk_mag_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(mags), n, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
