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
// Design: each thread owns one column c of the block (128 threads a block,
// grid ceil(C / 128)) and walks i = 0 .. N-1 in order.  Ownership of the
// column gives the submission order for free; nothing is shared between
// threads, so no atomics and no reordering.
//
// What bounds it on this card: the bytes it must move (the touched rows read
// and written once, plus delta and rows), over 3.35 TB/s.  What it reaches
// instead: its parallelism is only C threads, and each thread's loop is a
// chain of dependent read-modify-writes (a later i may hit the same row), so
// it runs at memory latency on a few SMs, and the topic table (C = 1) runs on
// one thread.  The planned redesign stable-groups the entries by row and
// gives one thread to each (row, column), walking its group in order: still
// bitwise np.add.at, with parallelism rows x columns.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void ps_apply_kernel(T* __restrict__ dense, int64_t R, int64_t C,
                                const int64_t* __restrict__ rows,
                                const T* __restrict__ delta, int64_t N) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= C) return;
  for (int64_t i = 0; i < N; ++i) {
    const int64_t r = rows[i];
    if (r < R) dense[r * C + c] += delta[i * C + c];
  }
}

template <typename T>
int launch(int device, void* dense, int64_t R, int64_t C, const void* rows,
           const void* delta, int64_t N, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((C + kThreads - 1) / kThreads);
  ps_apply_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(dense), R, C, static_cast<const int64_t*>(rows),
      static_cast<const T*>(delta), N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dense: (R, C) row-major; rows: (N,) int64 in [0, R]; delta: (N, C)
// row-major.  The caller guarantees N > 0 and C > 0.
extern "C" int ps_apply_f64(int device, void* dense, int64_t R, int64_t C,
                            const void* rows, const void* delta, int64_t N,
                            void* stream) {
  return launch<double>(device, dense, R, C, rows, delta, N, stream);
}

extern "C" int ps_apply_f32(int device, void* dense, int64_t R, int64_t C,
                            const void* rows, const void* delta, int64_t N,
                            void* stream) {
  return launch<float>(device, dense, R, C, rows, delta, N, stream);
}
