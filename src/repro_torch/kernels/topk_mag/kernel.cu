// topk_mag: the worker flush's largest-|delta|-first send order, written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/topk_mag/kernel.py:41
// (topk_mag_pallas, pl.pallas_call at :58) together with its host-side f64
// tie refine (src/repro/kernels/topk_mag/ops.py:23).
//
// Contract: out = the first k indices of mags in descending order, equal
// magnitudes in first-occurrence order, NaN last -- exactly
// np.argsort(-mags, kind="stable")[:k] on the f64 magnitudes.
//
// Keys.  Each magnitude becomes one uint64 key that is descending in the
// value: -0.0 is taken as +0.0, b = its bits, key = b if the sign is set,
// else b ^ 0x7fff'ffff'ffff'ffff; every NaN gets 0xffff'ffff'ffff'ffff.
// Pairs (key, idx) with a uint32 index are then a strict total order whose
// ascending sort is the contract, so the comparator has no NaN test and the
// sort need not be stable.  Padding is (UINT64_MAX, UINT32_MAX), after every
// real NaN.
//
// Bound: bytes, 8n read and 8k written (16 n bytes for the full order); the
// comparisons a sort needs are far below the card's integer rate.  No size
// here reaches that bound.  Below a few thousand keys a launch costs
// microseconds and one block's log^2 n dependent exchange stages cost more
// than the bytes: those sizes are latency-bound, so they take one launch and,
// for n <= 32, one warp with no barrier.  One block's sort is bound by its
// instructions on one SM (a compare-exchange of 96-bit pairs is a dozen);
// beyond kTile the tiles spread over the SMs and each merge pass streams its
// 24 bytes an element coalesced, through shared memory both ways.
//
// Regimes (the wrapper, ops.py, counts one launch per kernel):
//   n <= 32          one warp, one element a lane, the bitonic network by
//                    __shfl_xor_sync up to the power of two >= n: no shared
//                    memory, no barrier.  1 launch.
//   32 < n <= kTile  one block sorts next_pow2(n) pairs bitonically.  Each
//                    thread holds E (<= 16) consecutive elements of the
//                    sorted order in registers (element bits [0, log E) are
//                    its registers, the next 5 its lane, the rest its warp):
//                    stages of stride < E are register compare-exchanges,
//                    E <= stride < 32E shuffles, stride >= 32E goes through
//                    shared memory with one barrier (two buffers alternate).
//                    At kTile: 78 stages, 42 in registers, 30 by shuffle, 6
//                    through shared memory.  It writes the int64 indices of
//                    the first k.  1 launch.
//   n > kTile        launch A sorts every tile of kTile with the same block
//                    code into scratch (uint64 keys, uint32 indices); then
//                    ceil(log2(tiles)) merge-path passes double the sorted
//                    runs, ping-ponging between two scratch buffers.  A merge
//                    block writes a fixed span of kSpan outputs: one warp
//                    finds where the span starts in the two runs by a 32-way
//                    ballot search along the diagonal (and one where it
//                    ends), the block stages that slice in shared memory,
//                    each thread merges kSpan / 256 outputs after its own
//                    diagonal search there, and the outputs go back through
//                    shared memory so that the stores are coalesced.  The
//                    last pass writes only the int64 indices of the first k.
//                    1 + ceil(log2(tiles)) launches.
// The wrapper allocates the scratch (24 bytes per padded element); the
// kernels allocate nothing and run on the caller's stream.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int64_t kTile = 4096;      // one block's sort; the tile for n > kTile
constexpr int kTileE = 16;           // elements a thread holds at kTile
constexpr int kSpan = 2048;          // outputs of one merge block
constexpr int kMergeThreads = 256;
constexpr int kMergeE = kSpan / kMergeThreads;
constexpr uint64_t kPadKey = ~0ull;
constexpr uint32_t kPadIdx = ~0u;

__device__ __forceinline__ uint64_t sort_key(double x) {
  const uint64_t b =
      static_cast<uint64_t>(__double_as_longlong(x == 0.0 ? 0.0 : x));
  const uint64_t key = (b >> 63) ? b : b ^ 0x7fffffffffffffffull;
  return isnan(x) ? kPadKey : key;
}

__device__ __forceinline__ bool less(uint64_t ka, uint32_t ia, uint64_t kb,
                                     uint32_t ib) {
  return ka < kb || (ka == kb && ia < ib);
}

// Keep the smaller of own and partner if keep_min, else the larger.
__device__ __forceinline__ void keep(uint64_t& k, uint32_t& i, uint64_t pk,
                                     uint32_t pi, bool keep_min) {
  const bool take = less(pk, pi, k, i) == keep_min;
  k = take ? pk : k;
  i = take ? pi : i;
}

// Bitonic sort of N = blockDim.x * E pairs, one block.  The block's input
// is mags[tile, tile + N) (padding past n); the sorted pairs go to
// skeys/sidx[tile + e] (kScratch) or their indices to out[e] for e < k.
// The network runs up to size nsort: N, or for one warp with E = 1, where
// element e is lane e both before and after, the power of two >= n (a pad
// never needs to move, so n = 2 takes one stage, not fifteen).
template <int E, bool kScratch>
__global__ void topk_sort_block(const double* __restrict__ mags, int64_t n,
                                int64_t k, int nsort,
                                int64_t* __restrict__ out,
                                uint64_t* __restrict__ skeys,
                                uint32_t* __restrict__ sidx) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = blockDim.x * E;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * N;
  // sorted position of register 0: warp bits, lane bits, register bits
  const int base = warp * 32 * E + lane * E;

  uint64_t kk[E];
  uint32_t ii[E];
  // The network sorts any arrangement, so load coalesced: register j of
  // (warp, lane) takes element (warp * E + j) * 32 + lane of the block.
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int64_t g = tile + (warp * E + j) * 32 + lane;
    const bool real = g < n;
    kk[j] = real ? sort_key(mags[g]) : kPadKey;
    ii[j] = real ? static_cast<uint32_t>(g) : kPadIdx;
  }

  // shared-memory stages: position p = (warp * E + j) * 32 + lane, so a
  // warp's accesses for one j are contiguous and the partner of p across
  // stride s (a warp bit) is p ^ s
  uint64_t* const sk0 = reinterpret_cast<uint64_t*>(smem);
  uint32_t* const si0 = reinterpret_cast<uint32_t*>(sk0 + 2 * N);
  int buf = 0;

  for (int size = 2; size <= nsort; size <<= 1) {
    const bool asc = (base & size) == 0;   // for size > E; see below
    int stride = size >> 1;
    for (; stride >= 32 * E; stride >>= 1) {
      const bool lower = (base & stride) == 0;
      uint64_t* const sk = sk0 + buf * N;
      uint32_t* const si = si0 + buf * N;
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const int p = (warp * E + j) * 32 + lane;
        sk[p] = kk[j];
        si[p] = ii[j];
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const int p = ((warp * E + j) * 32 + lane) ^ stride;
        keep(kk[j], ii[j], sk[p], si[p], lower == asc);
      }
      buf ^= 1;
    }
    for (; stride >= E; stride >>= 1) {
      const int mask = stride / E;
      const bool lower = (lane & mask) == 0;
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const uint64_t pk = __shfl_xor_sync(0xffffffffu, kk[j], mask);
        const uint32_t pi = __shfl_xor_sync(0xffffffffu, ii[j], mask);
        keep(kk[j], ii[j], pk, pi, lower == asc);
      }
    }
#pragma unroll
    for (int s = E / 2; s > 0; s >>= 1) {
      if (s < size) {
#pragma unroll
        for (int j = 0; j < E; ++j) {
          if ((j & s) == 0) {
            // size may be a register bit here, so the direction is per pair
            const bool up = ((base + j) & size) == 0;
            const bool sw = less(kk[j + s], ii[j + s], kk[j], ii[j]) == up;
            const uint64_t k0 = kk[j], k1 = kk[j + s];
            const uint32_t i0 = ii[j], i1 = ii[j + s];
            kk[j] = sw ? k1 : k0;
            kk[j + s] = sw ? k0 : k1;
            ii[j] = sw ? i1 : i0;
            ii[j + s] = sw ? i0 : i1;
          }
        }
      }
    }
  }

  if constexpr (kScratch) {
    // E consecutive sorted pairs per thread, 16-byte stores
    auto* k2 = reinterpret_cast<ulonglong2*>(skeys + tile + base);
    auto* i4 = reinterpret_cast<uint4*>(sidx + tile + base);
#pragma unroll
    for (int j = 0; j < E; j += 2) k2[j / 2] = make_ulonglong2(kk[j], kk[j + 1]);
#pragma unroll
    for (int j = 0; j < E; j += 4)
      i4[j / 4] = make_uint4(ii[j], ii[j + 1], ii[j + 2], ii[j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j)
      if (base + j < k) out[base + j] = ii[j];
  }
}

// Smallest i in [lo, hi] with B[d - 1 - i] < A[i] (i = hi if none): where
// the merge of A and B has taken i elements of A after d outputs.  One warp,
// 32 probes a round.
__device__ int64_t warp_path_search(const uint64_t* __restrict__ keys,
                                    const uint32_t* __restrict__ idx,
                                    int64_t a0, int64_t na, int64_t b0,
                                    int64_t nb, int64_t d, int lane) {
  int64_t lo = d > nb ? d - nb : 0, hi = d < na ? d : na;
  while (lo < hi) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t i = lo + lane * step;
    bool f = true;
    if (i < hi) {
      const int64_t jb = b0 + d - 1 - i;
      f = less(keys[jb], idx[jb], keys[a0 + i], idx[a0 + i]);
    }
    const unsigned ball = __ballot_sync(0xffffffffu, f);
    if (ball == 0) {
      lo += 31 * step + 1;
    } else {
      const int t = __ffs(ball) - 1;
      const int64_t top = lo + t * step;
      hi = top < hi ? top : hi;
      lo = t ? lo + (t - 1) * step + 1 : lo;
    }
  }
  return lo;
}

// Staged outputs sit at x + x / 16, so that a thread's run of kMergeE
// consecutive outputs does not fall into one shared-memory bank.
__device__ __forceinline__ int padded(int x) { return x + (x >> 4); }

// One merge-path pass: runs of `run` sorted pairs, merged two by two into
// runs of 2 * run.  Block b writes outputs [b * kSpan, (b + 1) * kSpan).
// With out set (the last pass) it writes only the int64 indices below k.
__global__ void __launch_bounds__(kMergeThreads)
    topk_merge_pass(const uint64_t* __restrict__ kin,
                    const uint32_t* __restrict__ iin,
                    uint64_t* __restrict__ kout, uint32_t* __restrict__ iout,
                    int64_t* __restrict__ out, int64_t m, int64_t run,
                    int64_t k) {
  __shared__ uint64_t sk[kSpan + kSpan / 16];
  __shared__ uint32_t si[kSpan + kSpan / 16];
  __shared__ int64_t split[2];
  const int64_t o0 = static_cast<int64_t>(blockIdx.x) * kSpan;
  if (out != nullptr && o0 >= k) return;
  const int64_t p0 = o0 / (2 * run) * (2 * run);
  const int64_t na = run < m - p0 ? run : m - p0;
  const int64_t b0 = p0 + na;
  const int64_t nb = run < m - b0 ? run : m - b0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 2) {
    const int64_t i =
        warp_path_search(kin, iin, p0, na, b0, nb, o0 - p0 + warp * kSpan,
                         lane);
    if (lane == 0) split[warp] = i;
  }
  __syncthreads();
  const int64_t i0 = split[0], j0 = o0 - p0 - i0;
  const int sa = static_cast<int>(split[1] - i0);
  const int sb = kSpan - sa;
  // the slice: A's part at [0, sa), B's at [sa, kSpan), loads all in flight
#pragma unroll
  for (int r = 0; r < kMergeE; ++r) {
    const int x = r * kMergeThreads + threadIdx.x;
    const int64_t g = x < sa ? p0 + i0 + x : b0 + j0 + (x - sa);
    sk[x] = kin[g];
    si[x] = iin[g];
  }
  __syncthreads();

  // this thread's diagonal in the slice, then kMergeE outputs in registers
  const int d = threadIdx.x * kMergeE;
  int lo = d > sb ? d - sb : 0, hi = d < sa ? d : sa;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int jb = sa + d - 1 - mid;
    if (less(sk[jb], si[jb], sk[mid], si[mid]))
      hi = mid;
    else
      lo = mid + 1;
  }
  int ia = lo, ib = d - lo;
  uint64_t ka = ia < sa ? sk[ia] : 0, kb = ib < sb ? sk[sa + ib] : 0;
  uint32_t va = ia < sa ? si[ia] : 0, vb = ib < sb ? si[sa + ib] : 0;
  uint64_t kw[kMergeE];
  uint32_t vw[kMergeE];
#pragma unroll
  for (int r = 0; r < kMergeE; ++r) {
    const bool ta = ib >= sb || (ia < sa && less(ka, va, kb, vb));
    kw[r] = ta ? ka : kb;
    vw[r] = ta ? va : vb;
    if (ta) {
      if (++ia < sa) ka = sk[ia], va = si[ia];
    } else {
      if (++ib < sb) kb = sk[sa + ib], vb = si[sa + ib];
    }
  }
  // through shared memory again, so that the stores are coalesced
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kMergeE; ++r) {
    sk[padded(d + r)] = kw[r];
    si[padded(d + r)] = vw[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kMergeE; ++r) {
    const int x = r * kMergeThreads + threadIdx.x;
    const int64_t o = o0 + x;
    if (out != nullptr) {
      if (o < k) out[o] = si[padded(x)];
    } else {
      kout[o] = sk[padded(x)];
      iout[o] = si[padded(x)];
    }
  }
}

}  // namespace

// The tile size the kernel was built with; the wrapper checks it against its
// own, which it uses to size the scratch.
extern "C" int topk_mag_tile() { return static_cast<int>(kTile); }

// mags: (n,) f64; out: (k,) int64, 0 < k <= n < 2^31.  scratch: 24 *
// ceil(n / kTile) * kTile bytes when n > kTile, else unused.
extern "C" int topk_mag_f64(int device, const void* mags, int64_t n,
                            int64_t k, void* scratch, void* out,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const double*>(mags);
  auto* o = static_cast<int64_t*>(out);
  if (n <= kTile) {
    int nsort = 1;
    while (nsort < n) nsort <<= 1;
    const int N = nsort < 32 ? 32 : nsort;
    const int E = N / 32 < kTileE ? N / 32 : kTileE;
    const int threads = N / E;
    const size_t bytes = threads > 32 ? 2 * static_cast<size_t>(N) * 12 : 0;
    switch (E) {
#define TOPK_BLOCK(e)                                                      \
  case e:                                                                  \
    err = cudaFuncSetAttribute(topk_sort_block<e, false>,                  \
                               cudaFuncAttributeMaxDynamicSharedMemorySize, \
                               static_cast<int>(bytes));                   \
    if (err != cudaSuccess) return static_cast<int>(err);                  \
    topk_sort_block<e, false>                                              \
        <<<1, threads, bytes, s>>>(m, n, k, nsort, o, nullptr, nullptr);  \
    break;
      TOPK_BLOCK(1)
      TOPK_BLOCK(2)
      TOPK_BLOCK(4)
      TOPK_BLOCK(8)
      TOPK_BLOCK(16)
#undef TOPK_BLOCK
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t tiles = (n + kTile - 1) / kTile, mm = tiles * kTile;
  uint64_t* keys[2] = {static_cast<uint64_t*>(scratch),
                       static_cast<uint64_t*>(scratch) + mm};
  uint32_t* idx[2] = {reinterpret_cast<uint32_t*>(keys[1] + mm),
                      reinterpret_cast<uint32_t*>(keys[1] + mm) + mm};
  const size_t bytes = 2 * static_cast<size_t>(kTile) * 12;
  err = cudaFuncSetAttribute(topk_sort_block<kTileE, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_sort_block<kTileE, true>
      <<<static_cast<unsigned>(tiles), kTile / kTileE, bytes, s>>>(
          m, n, k, static_cast<int>(kTile), nullptr, keys[0], idx[0]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int cur = 0;
  for (int64_t run = kTile; run < mm; run *= 2, cur ^= 1) {
    const bool last = 2 * run >= mm;
    topk_merge_pass<<<static_cast<unsigned>(mm / kSpan), kMergeThreads, 0,
                      s>>>(keys[cur], idx[cur], keys[cur ^ 1], idx[cur ^ 1],
                           last ? o : nullptr, mm, run, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
