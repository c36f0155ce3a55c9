// ps_apply: the server shard's ordered scatter-add into its dense master
// block, written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ps_apply/kernel.py:47
// (scatter_add_pallas, body _kernel at :29).
//
// Contract: dense[rows[i], :] += delta[i, :] for i = 0 .. N-1, in that order,
// with plain floating-point `+` and no atomics, so duplicate rows accumulate
// bitwise like numpy's np.add.at.  rows[i] == R (one past the last row) is
// the sentinel: a no-op, as the TPU kernel's dummy row is.
//
// Design: row-grouped, in two steps.
//
// Group (the wrapper, ops.py): torch.sort(rows, stable=True) yields `keys`
// (the rows in ascending order) and `perm` (keys[p] == rows[perm[p]], and
// within a run of equal keys perm ascends).  That sort is index bookkeeping,
// not the work the TPU kernel does: the TPU kernel gets its order from a
// sequential loop over the entries, which a grid of parallel blocks does not
// have, and the stable sort hands that order to the apply.
//
// Apply (ps_apply_f64 / ps_apply_f32): the ordered sum itself, the TPU
// kernel's work, done by the kernel below.
//
// Threads are flattened over (sorted position p, column c) as p * C + c, so
// neighbouring threads take neighbouring columns of one row and every load
// and store of dense and delta is coalesced at any C.  The thread whose p
// starts a run of equal keys (p == 0 or keys[p - 1] != keys[p]) and whose
// row r is below R loads dense[r, c] once, walks q = p, p+1, ... while
// keys[q] == r adding delta[perm[q], c], and stores once; every other thread
// returns.  The sentinel R sorts last and is skipped.  Parallelism is
// (distinct rows) x C threads instead of C.
//
// Why the result is bitwise np.add.at: each element dense[r, c] gets the
// same sequence of correctly rounded additions, in the same order (the
// stable sort keeps submission order inside a run), as np.add.at gives it.
// There is no multiply, so no FMA contraction can occur; there are no
// atomics, and each element is written by exactly one thread, which adds
// nothing outside its run.
//
// What bounds it on this card: the bytes it must move (the touched rows read
// and written once, delta's real rows read once, the row indices read), over
// 3.35 TB/s; one add per element is far below the card's operation rate.
// The walk's loads do not depend on the running sum: a run's end is found
// first (most runs are one entry; a longer one by binary search over the
// ascending keys), and the walk then issues kUnroll perm and delta loads
// before it adds them in order.  A long run (a hot row, a batch all on one
// row) is still walked serially by one thread a column, but with kUnroll
// loads in flight instead of one.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ps_apply_kernel(T* __restrict__ dense, int64_t R, int64_t C, int64_t total,
                const int64_t* __restrict__ keys,
                const int64_t* __restrict__ perm,
                const T* __restrict__ delta, int64_t N) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= total) return;
  const int64_t p = t / C;
  const int64_t c = t - p * C;
  const int64_t r = keys[p];
  if (r >= R || (p > 0 && keys[p - 1] == r)) return;

  // The run is keys[p .. end).  Most runs are one entry long (a batch of
  // distinct rows); a longer run's end is found by binary search, since the
  // keys ascend.
  int64_t end = p + 1;
  if (end < N && keys[end] == r) {
    int64_t hi = N;
    while (end < hi) {
      const int64_t mid = end + (hi - end) / 2;
      if (keys[mid] == r) end = mid + 1; else hi = mid;
    }
  }

  T* cell = dense + r * C + c;
  const T* col = delta + c;
  T acc = *cell;
  int64_t q = p;
  // whole steps of kUnroll entries: every load is issued before the first
  // add waits on one, since none of them depends on acc
  for (; q + kUnroll <= end; q += kUnroll) {
    T v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) v[k] = col[perm[q + k] * C];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) acc = acc + v[k];
  }
  for (; q < end; ++q) acc = acc + col[perm[q] * C];
  *cell = acc;
}

template <typename T>
int launch(int device, void* dense, int64_t R, int64_t C, const void* keys,
           const void* perm, const void* delta, int64_t N, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = N * C;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  ps_apply_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(dense), R, C, total, static_cast<const int64_t*>(keys),
      static_cast<const int64_t*>(perm), static_cast<const T*>(delta), N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dense: (R, C) row-major; keys: (N,) int64, the rows sorted ascending, in
// [0, R]; perm: (N,) int64, the stable sort's permutation; delta: (N, C)
// row-major, in submission order.  The caller guarantees N > 0 and C > 0.
extern "C" int ps_apply_f64(int device, void* dense, int64_t R, int64_t C,
                            const void* keys, const void* perm,
                            const void* delta, int64_t N, void* stream) {
  return launch<double>(device, dense, R, C, keys, perm, delta, N, stream);
}

extern "C" int ps_apply_f32(int device, void* dense, int64_t R, int64_t C,
                            const void* keys, const void* perm,
                            const void* delta, int64_t N, void* stream) {
  return launch<float>(device, dense, R, C, keys, perm, delta, N, stream);
}
