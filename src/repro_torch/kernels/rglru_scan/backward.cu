// rglru_scan backward: the vector-Jacobian product of the RG-LRU over a
// whole sequence (the function rglru_kernel computes, kernel.cu), written
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no backward kernel of its own.
// Its train step differentiates the jnp oracle
// src/repro/kernels/rglru_scan/ref.py:34 (rglru, linear_recurrence at :16)
// with jax.value_and_grad; ref.py's rglru_bwd and linear_recurrence_bwd are
// this kernel's plain versions.
//
// Three entries:
//   rglru_bwd_bf16, rglru_bwd_f32: x, r, i (b, l, w) and a_param (w,) in one
//   dtype, the forward's states (b, ceil(l / 32), w) float32, dh (b, l, w)
//   in that dtype or null, dh_last (b, w) float32 or null.  Writes dx, dr,
//   di, da_param in that dtype and dinitial (b, w) float32 (or not: null).
//   linear_recurrence_bwd_f32: a, b, dh (b, l, w) float32, the same states
//   and dh_last; writes da, db and dinitial.
//
// The gradient.  With s_t the float32 state after step t (s_{-1} the initial
// state or 0) and g_t = dL/ds_t:
//   g_t = dh_t + a_{t+1} g_{t+1},  g_{l-1} = dh_{l-1} + dh_last
//   da_t = g_t s_{t-1},  dgated_t = g_t,  dinitial = a_0 g_0
// and through the gates (log a = nsp r, nsp = -c softplus(Λ), a = exp(log
// a), a2 = exp(2 log a), keep = max(1 - a2, 1e-12), gated = sqrt(keep) i x):
//   d(ix) = g sqrt(keep);  dx = d(ix) i;  di = d(ix) x
//   dkeep = g (ix) / (2 sqrt(keep)) where 1 - a2 >= 1e-12, else 0 (torch's
//   clamp_min passes the gradient at the tie, so the plain version does)
//   dlog_a = da a + 2 (-dkeep a2);  dr = dlog_a nsp
//   dΛ = dsp z / (z + 1), z = exp(Λ) (dsp itself above 20), dsp = -c Σ_{b,t}
//   dlog_a r
// each op rounded once, in the order autograd takes the plain version.
//
// What bounds it on this card: the bytes.  x, r, i and dh read and dx, dr, di
// written once: 14 bytes an element in bfloat16 (33.6 M elements at
// RecurrentGemma-9B's train call, 2 x 4,096 x 4,096: 0.140 ms over 3.35
// TB/s), with ~100 instructions an element (the gates twice, the division)
// close behind.  Only g's chain is sequential in time (two roundings a step,
// which may not be reassociated), and there are only b * w chains (8,192 at
// the train call).  What the design does about that: it runs the chain
// alone, and everything else in parallel over time.
//   Stage A (rglru_bwd_chain_kernel): one thread a lane walks l-1 ... 0,
//   reading only r (or a) and dh, 4 bytes an element in bfloat16; a block
//   takes kChainLanes lanes of one batch row, and one producer thread streams
//   their (kSteps x kChainLanes) tiles, newest first, through a TMA ring, so
//   the loads in flight do not depend on the thread count.  A tile's a_t and
//   dh_t are all formed before its chain runs over them, so their loads and
//   exps overlap.  It writes the carry a_{t+1} g_{t+1} entering every
//   kSteps-step chunk from the right (b, chunks, w) and dinitial.
//   Stage B (rglru_bwd_chunk_kernel): one thread per (batch row, lane,
//   chunk), 1,048,576 at the train call.  A block takes kChunkLanes lanes of
//   one chunk; one thread loads its x, r, i and dh tiles by TMA into shared
//   memory, so each input is read from device memory once more.  Each thread
//   recomputes its chunk's float32 states in registers from the state the
//   forward saved entering the chunk (kernel.cu writes it when a graph is
//   wanted; the arithmetic is ../rglru_step.cuh's, so bit for bit), then
//   walks the chunk in reverse from stage A's carry, writing dx, dr, di and
//   its (row, chunk, lane) partial of dΛ.
//   rglru_bwd_dparam_kernel sums the partials in a fixed order, the chunks
//   in order within a row, then the rows, so two calls give the same bits
//   (no atomics); the partials reach it through shared memory, many loads
//   in flight, since one thread a lane would wait on each in turn.
// The design moves 18 bytes an element in bfloat16 (stage A reads r and dh
// a second time).  On an H100 at the train call stage B is bound by its
// instructions in bfloat16 and by its bytes in float32: a persistent stage B
// with a two-stage ring, 64 lanes a block, or registers capped for more
// blocks an SM were no faster.
// Every per-element operation and g's order are those of the sequential
// sweep, so dx, dr, di and dinitial are the plain version's bits; only dΛ's
// summation order is the kernel's own.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../hopper.cuh"
#include "../rglru_step.cuh"

namespace {

using namespace hopper;
using rglru::from_f32;
using rglru::to_f32;

constexpr int kSteps = 32;        // steps a chunk: the forward's tile
constexpr int kChainLanes = 64;   // stage A: lanes a block, one a thread
constexpr int kChunkLanes = 128;  // stage B: lanes a block (one chunk)
constexpr int kDparamLanes = 32;  // dΛ's sum: lanes a block
constexpr int kDparamThreads = 256;
constexpr int kSlab = 256;        // partials a lane staged at a time

// Stage A's shared memory, in bytes from a 128-aligned base: the ring's
// stages (each kIn tiles of kSteps x kChainLanes: r or a, then dh), then a
// full and an empty barrier per stage.  ~64 KB of ring in either dtype.
template <typename T, bool kDh>
struct ChainLayout {
  static constexpr int kIn = kDh ? 2 : 1;
  static constexpr int kWarps = kChainLanes / 32;       // consumer warps
  static constexpr int kStages = sizeof(T) == 2 ? 8 : 4;
  static constexpr uint32_t kTile = kSteps * kChainLanes * sizeof(T);
  static constexpr uint32_t kStage = kIn * kTile;
  static constexpr uint32_t kBar = kStages * kStage;
  static constexpr uint32_t kBytes = kBar + 16 * kStages;
  __host__ __device__ static constexpr uint32_t full(int s) {
    return kBar + 8 * s;
  }
  __host__ __device__ static constexpr uint32_t empty(int s) {
    return kBar + 8 * (kStages + s);
  }
  static_assert(kTile % 128 == 0, "tile alignment");
};

// a_t and dh_t of a tile's step t; col: the lane's column of the stage (r
// or a, then dh)
template <typename T, bool kGates, bool kDh>
__device__ __forceinline__ void chain_inputs(const T* col, int t, float nsp,
                                             float& a, float& dh) {
  constexpr int kDhAt = ChainLayout<T, kDh>::kTile / sizeof(T);
  const float v = to_f32(col[t * kChainLanes]);
  a = kGates ? expf(__fmul_rn(nsp, v)) : v;
  dh = kDh ? to_f32(col[kDhAt + t * kChainLanes]) : 0.0f;
}

// one step of g's chain: the carry a_t g_t, g_t = dh_t + the carry from t + 1
template <bool kDh>
__device__ __forceinline__ float chain_step(float a, float dh, float carry) {
  const float g = kDh ? __fadd_rn(dh, carry) : carry;
  return __fmul_rn(a, g);
}

// Stage A.  Maps: in_a r (kGates) or a; in_dh dh (kDh).  Block (lane tile,
// batch row); threads: kChainLanes / 32 consumer warps, then the producer.
// carries: (b, tiles, w), the carry entering each chunk from the right.
template <typename T, bool kGates, bool kDh>
__global__ void __launch_bounds__(kChainLanes + 32)
    rglru_bwd_chain_kernel(const __grid_constant__ CUtensorMap in_a,
                           const __grid_constant__ CUtensorMap in_dh,
                           const T* __restrict__ a_param,
                           const float* __restrict__ dh_last,
                           float* __restrict__ carries,
                           float* __restrict__ dinit, int l, int w, float c) {
  using Y = ChainLayout<T, kDh>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 127) & ~127u;
  uint8_t* const smem = smem_raw + (base - raw);
  const int j0 = blockIdx.x * kChainLanes;
  const int bi = blockIdx.y;
  const int tiles = (l + kSteps - 1) / kSteps;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Y::kStages; ++s) {
      bar_init(base + Y::full(s), 1);
      bar_init(base + Y::empty(s), Y::kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == Y::kWarps) {                 // the producer: newest tile first
    if (lane == 0) {
      for (int q = 0; q < tiles; ++q) {
        const int stage = q % Y::kStages;
        const int k = tiles - 1 - q;
        if (q >= Y::kStages)               // its use q / kStages - 1 read
          bar_wait(base + Y::empty(stage), (q / Y::kStages - 1) & 1);
        bar_arrive_tx(base + Y::full(stage), Y::kStage);
        const uint32_t dst = base + stage * Y::kStage;
        tma_load_3d(dst, &in_a, base + Y::full(stage), j0, k * kSteps, bi);
        if constexpr (kDh)
          tma_load_3d(dst + Y::kTile, &in_dh, base + Y::full(stage), j0,
                      k * kSteps, bi);
      }
    }
    return;
  }

  const int j = j0 + threadIdx.x;
  const bool valid = j < w;
  const int64_t lane_at = static_cast<int64_t>(bi) * w + j;
  float nsp = 0.0f;
  if constexpr (kGates)
    nsp = rglru::neg_c_softplus(valid ? to_f32(a_param[j]) : 0.0f, c);
  float carry = valid && dh_last != nullptr ? dh_last[lane_at] : 0.0f;
  for (int q = 0; q < tiles; ++q) {
    const int stage = q % Y::kStages;
    const int k = tiles - 1 - q;
    const int n = min(kSteps, l - k * kSteps);           // valid steps
    if (valid)
      carries[(static_cast<int64_t>(bi) * tiles + k) * w + j] = carry;
    bar_wait(base + Y::full(stage), (q / Y::kStages) & 1);
    const T* col = reinterpret_cast<const T*>(smem + stage * Y::kStage) +
                   threadIdx.x;
    if (n == kSteps) {
      // every step's a_t and dh_t first, so that their loads and exps are
      // in flight together, then the chain over them
      float av[kSteps], dv[kSteps];
#pragma unroll
      for (int t = 0; t < kSteps; ++t)
        chain_inputs<T, kGates, kDh>(col, t, nsp, av[t], dv[t]);
#pragma unroll
      for (int t = kSteps - 1; t >= 0; --t)
        carry = chain_step<kDh>(av[t], dv[t], carry);
    } else {                               // the last chunk, once a lane
      for (int t = n - 1; t >= 0; --t) {
        float a, dh;
        chain_inputs<T, kGates, kDh>(col, t, nsp, a, dh);
        carry = chain_step<kDh>(a, dh, carry);
      }
    }
    __syncwarp();
    if (lane == 0) bar_arrive(base + Y::empty(stage));   // stage read
  }
  if (valid && dinit != nullptr) dinit[lane_at] = carry;
}

// Stage B's shared memory: the chunk's tiles (kSteps x kChunkLanes each: x,
// r, i, dh or a, b, dh), then one barrier.
template <typename T, bool kGates>
struct ChunkLayout {
  static constexpr int kIn = kGates ? 4 : 3;
  static constexpr uint32_t kTile = kSteps * kChunkLanes * sizeof(T);
  static constexpr uint32_t kBar = kIn * kTile;
  static constexpr uint32_t kBytes = kBar + 8;
  static constexpr int kAt = kTile / sizeof(T);         // tile stride
  static_assert(kTile % 128 == 0, "tile alignment");
};

// Stage B.  Maps in0..in2: x, r, i (kGates) or a, b (in2 unused); in_dh: dh
// (has_dh).  Block (lane tile, chunk, batch row).  d0..d2: dx, dr, di or da,
// db; dnsp_part: (b, tiles, w), each chunk's Σ dlog_a r (kGates).
template <typename T, bool kGates>
__global__ void __launch_bounds__(kChunkLanes)
    rglru_bwd_chunk_kernel(const __grid_constant__ CUtensorMap in0,
                           const __grid_constant__ CUtensorMap in1,
                           const __grid_constant__ CUtensorMap in2,
                           const __grid_constant__ CUtensorMap in_dh,
                           const T* __restrict__ a_param,
                           const float* __restrict__ states,
                           const float* __restrict__ carries,
                           T* __restrict__ d0, T* __restrict__ d1,
                           T* __restrict__ d2, float* __restrict__ dnsp_part,
                           int l, int w, int has_dh, float c) {
  using Y = ChunkLayout<T, kGates>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 127) & ~127u;
  uint8_t* const smem = smem_raw + (base - raw);
  const int j0 = blockIdx.x * kChunkLanes;
  const int k = blockIdx.y;
  const int bi = blockIdx.z;
  const int tiles = gridDim.y;
  const int t0 = k * kSteps;
  const int n = min(kSteps, l - t0);                     // valid steps
  const uint32_t bar = base + Y::kBar;
  if (threadIdx.x == 0) {
    bar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int loads = has_dh ? Y::kIn : Y::kIn - 1;
    bar_arrive_tx(bar, loads * Y::kTile);
    const CUtensorMap* maps[3] = {&in0, &in1, &in2};
    for (int q = 0; q < Y::kIn - 1; ++q)
      tma_load_3d(base + q * Y::kTile, maps[q], bar, j0, t0, bi);
    if (has_dh)
      tma_load_3d(base + (Y::kIn - 1) * Y::kTile, &in_dh, bar, j0, t0, bi);
  }
  const int j = j0 + threadIdx.x;
  if (j >= w) return;                      // thread 0's lane is always valid

  const int64_t at = (static_cast<int64_t>(bi) * tiles + k) * w + j;
  float nsp = 0.0f;
  if constexpr (kGates) nsp = rglru::neg_c_softplus(to_f32(a_param[j]), c);
  float s = states[at];
  float carry = carries[at];
  bar_wait(bar, 0);
  const T* const p0 = reinterpret_cast<const T*>(smem) + threadIdx.x;
  const T* const p1 = p0 + Y::kAt;
  const T* const p2 = p1 + Y::kAt;          // i (kGates)
  const T* const pd = p0 + (Y::kIn - 1) * Y::kAt;

  // the chunk's states: prev[t] = s_{t0+t-1} (steps past l are never read)
  float prev[kSteps];
#pragma unroll
  for (int t = 0; t < kSteps; ++t) {
    prev[t] = s;
    if constexpr (kGates) {
      float a, g;
      rglru::gates(nsp, to_f32(p1[t * kChunkLanes]),
                   to_f32(p2[t * kChunkLanes]), to_f32(p0[t * kChunkLanes]),
                   a, g);
      s = rglru::step(a, s, g);
    } else {
      s = rglru::step(to_f32(p0[t * kChunkLanes]), s,
                      to_f32(p1[t * kChunkLanes]));
    }
  }

  // the chunk in reverse from stage A's carry = a_{t+1} g_{t+1}
  const int64_t row = (static_cast<int64_t>(bi) * l + t0) * w + j;
  float dnsp = 0.0f;
#pragma unroll
  for (int t = kSteps - 1; t >= 0; --t) {
    if (t < n) {
      const float g =
          has_dh ? __fadd_rn(to_f32(pd[t * kChunkLanes]), carry) : carry;
      const int64_t o = row + static_cast<int64_t>(t) * w;
      if constexpr (kGates) {
        const float x = to_f32(p0[t * kChunkLanes]);
        const float r = to_f32(p1[t * kChunkLanes]);
        const float i = to_f32(p2[t * kChunkLanes]);
        const float log_a = __fmul_rn(nsp, r);
        const float a = expf(log_a);
        const float a2 = expf(__fmul_rn(2.0f, log_a));
        const float keep_raw = __fsub_rn(1.0f, a2);
        const float keep = keep_raw < 1e-12f ? 1e-12f : keep_raw;
        const float sq = rglru::sqrt_rn(keep);
        const float ix = __fmul_rn(i, x);
        const float dix = __fmul_rn(g, sq);
        const float dkeep =
            keep_raw >= 1e-12f
                ? __fdiv_rn(__fmul_rn(g, ix), __fmul_rn(2.0f, sq))
                : 0.0f;
        const float dlog_a =
            __fadd_rn(__fmul_rn(__fmul_rn(g, prev[t]), a),
                      __fmul_rn(2.0f, __fmul_rn(-dkeep, a2)));
        d0[o] = from_f32<T>(__fmul_rn(dix, i));
        d1[o] = from_f32<T>(__fmul_rn(dlog_a, nsp));
        d2[o] = from_f32<T>(__fmul_rn(dix, x));
        dnsp = __fadd_rn(dnsp, __fmul_rn(dlog_a, r));
        carry = __fmul_rn(a, g);
      } else {
        d0[o] = from_f32<T>(__fmul_rn(g, prev[t]));
        d1[o] = from_f32<T>(g);
        carry = __fmul_rn(to_f32(p0[t * kChunkLanes]), g);
      }
    }
  }
  if constexpr (kGates) dnsp_part[at] = dnsp;
}

// dΛ: each lane's chunk partials summed in order within a batch row, the
// rows' sums then in order, then the chain through -c softplus(Λ), rounded
// once into the parameter's dtype.  A block takes kDparamLanes lanes: all
// its threads stage kSlab partials a lane at a time in shared memory
// (coalesced, many loads in flight), then one thread a lane adds them.
template <typename T>
__global__ void __launch_bounds__(kDparamThreads)
    rglru_bwd_dparam_kernel(const T* __restrict__ a_param,
                            const float* __restrict__ dnsp_part,
                            T* __restrict__ da_param, int b, int tiles, int w,
                            float c) {
  __shared__ float slab[kSlab][kDparamLanes];
  const int lane = threadIdx.x % kDparamLanes;
  const int j = blockIdx.x * kDparamLanes + lane;
  const int64_t n = static_cast<int64_t>(b) * tiles;   // (row, chunk) order
  float sum = 0.0f, row = 0.0f;
  int k = 0;                                           // chunk in the row
  for (int64_t e0 = 0; e0 < n; e0 += kSlab) {
#pragma unroll 8
    for (int e = threadIdx.x / kDparamLanes; e < kSlab;
         e += kDparamThreads / kDparamLanes)
      slab[e][lane] =
          e0 + e < n && j < w ? dnsp_part[(e0 + e) * w + j] : 0.0f;
    __syncthreads();
    if (threadIdx.x < kDparamLanes) {
      const int m = static_cast<int>(min(int64_t{kSlab}, n - e0));
      for (int e = 0; e < m; ++e) {
        row = __fadd_rn(row, slab[e][lane]);
        if (++k == tiles) {
          sum = __fadd_rn(sum, row);
          row = 0.0f;
          k = 0;
        }
      }
    }
    __syncthreads();
  }
  if (threadIdx.x >= kDparamLanes || j >= w) return;
  const float dsp = __fmul_rn(-c, sum);
  const float lam = to_f32(a_param[j]);
  float d = dsp;
  if (!(lam > 20.0f)) {
    const float z = expf(lam);
    d = __fdiv_rn(__fmul_rn(dsp, z), __fadd_rn(z, 1.0f));
  }
  da_param[j] = from_f32<T>(d);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// ins: x, r, i (kGates) or a, b; a_param null without gates; dh may be null
template <typename T, bool kGates>
int launch(int device, const void* const* ins, const void* a_param,
           const void* states, const void* dh, const void* dh_last,
           void* carries, void* dnsp_part, void* const* outs, void* da_param,
           void* dinit, int64_t b, int64_t l, int64_t w, int64_t wp, double c,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr)
    return static_cast<int>(cudaErrorSharedObjectInitFailed);
  constexpr bool bf16 = sizeof(T) == 2;
  constexpr int kIn = kGates ? 3 : 2;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = static_cast<int>((l + kSteps - 1) / kSteps);
  const void* chained = ins[kGates ? 1 : 0];           // r or a
  const void* dh_or = dh != nullptr ? dh : chained;    // a map, never read

  // stage A: g's chain
  CUtensorMap ma, mdh, m[3], md;
  CUresult res = tensor_map_blw(encode, &ma, chained, bf16, b, l, w, wp,
                                kChainLanes, kSteps);
  if (res == CUDA_SUCCESS)
    res = tensor_map_blw(encode, &mdh, dh_or, bf16, b, l, w, wp, kChainLanes,
                         kSteps);
  for (int q = 0; q < 3 && res == CUDA_SUCCESS; ++q)
    res = tensor_map_blw(encode, &m[q], ins[q < kIn ? q : kIn - 1], bf16, b,
                         l, w, wp, kChunkLanes, kSteps);
  if (res == CUDA_SUCCESS)
    res = tensor_map_blw(encode, &md, dh_or, bf16, b, l, w, wp, kChunkLanes,
                         kSteps);
  if (res != CUDA_SUCCESS) return -static_cast<int>(res);
  const T* ap = static_cast<const T*>(a_param);
  const dim3 grid_a(static_cast<unsigned>((w + kChainLanes - 1) / kChainLanes),
                    static_cast<unsigned>(b));
  const int smem_a =
      static_cast<int>(dh != nullptr ? ChainLayout<T, true>::kBytes
                                     : ChainLayout<T, false>::kBytes) +
      128;
  auto* const chain = dh != nullptr ? rglru_bwd_chain_kernel<T, kGates, true>
                                    : rglru_bwd_chain_kernel<T, kGates, false>;
  if ((err = allow_smem(chain, smem_a)) != cudaSuccess)
    return static_cast<int>(err);
  chain<<<grid_a, kChainLanes + 32, smem_a, st>>>(
      ma, mdh, ap, static_cast<const float*>(dh_last),
      static_cast<float*>(carries), static_cast<float*>(dinit),
      static_cast<int>(l), static_cast<int>(w), static_cast<float>(c));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  // stage B: the chunks
  const int smem = static_cast<int>(ChunkLayout<T, kGates>::kBytes) + 128;
  auto* const chunk = rglru_bwd_chunk_kernel<T, kGates>;
  if ((err = allow_smem(chunk, smem)) != cudaSuccess)
    return static_cast<int>(err);
  const dim3 grid_b(static_cast<unsigned>((w + kChunkLanes - 1) / kChunkLanes),
                    static_cast<unsigned>(tiles), static_cast<unsigned>(b));
  chunk<<<grid_b, kChunkLanes, smem, st>>>(
      m[0], m[1], m[2], md, ap, static_cast<const float*>(states),
      static_cast<const float*>(carries), static_cast<T*>(outs[0]),
      static_cast<T*>(outs[1]), static_cast<T*>(outs[2]),
      static_cast<float*>(dnsp_part), static_cast<int>(l),
      static_cast<int>(w), dh != nullptr, static_cast<float>(c));
  if ((err = cudaGetLastError()) != cudaSuccess || !kGates)
    return static_cast<int>(err);

  rglru_bwd_dparam_kernel<T><<<static_cast<unsigned>(
                                   (w + kDparamLanes - 1) / kDparamLanes),
                               kDparamThreads, 0, st>>>(
      ap, static_cast<const float*>(dnsp_part), static_cast<T*>(da_param),
      static_cast<int>(b), tiles, static_cast<int>(w), static_cast<float>(c));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, r, i, dh: (batch, l, w) at row stride wp (elements; wp * the element
// size a multiple of 16 bytes, pointers 16-byte aligned); dx, dr, di:
// (batch, l, w) contiguous; a_param, da_param (w,); states (the forward's),
// carries, dnsp_part: (batch, ceil(l / 32), w) float32, the last two
// scratch; dh_last, dinit: (batch, w) float32, each may be null, as may dh.
// The caller guarantees batch, l, w > 0, batch and ceil(l / 32) < 65,536
// and w < 2^31.  Returns the launches' cudaError_t, or minus libcuda's
// CUresult where a TMA tensor map could not be encoded.
extern "C" int rglru_bwd_bf16(int device, const void* x, const void* r,
                              const void* i, const void* a_param,
                              const void* states, const void* dh,
                              const void* dh_last, void* carries,
                              void* dnsp_part, void* dx, void* dr, void* di,
                              void* da_param, void* dinit, int64_t batch,
                              int64_t l, int64_t w, int64_t wp, double c,
                              void* stream) {
  const void* ins[3] = {x, r, i};
  void* outs[3] = {dx, dr, di};
  return launch<__nv_bfloat16, true>(device, ins, a_param, states, dh,
                                     dh_last, carries, dnsp_part, outs,
                                     da_param, dinit, batch, l, w, wp, c,
                                     stream);
}

extern "C" int rglru_bwd_f32(int device, const void* x, const void* r,
                             const void* i, const void* a_param,
                             const void* states, const void* dh,
                             const void* dh_last, void* carries,
                             void* dnsp_part, void* dx, void* dr, void* di,
                             void* da_param, void* dinit, int64_t batch,
                             int64_t l, int64_t w, int64_t wp, double c,
                             void* stream) {
  const void* ins[3] = {x, r, i};
  void* outs[3] = {dx, dr, di};
  return launch<float, true>(device, ins, a_param, states, dh, dh_last,
                             carries, dnsp_part, outs, da_param, dinit, batch,
                             l, w, wp, c, stream);
}

// a, b, dh: (batch, l, w) float32 at row stride wp; da, db contiguous;
// states, carries, dh_last, dinit as above.
extern "C" int linear_recurrence_bwd_f32(int device, const void* a,
                                         const void* b, const void* states,
                                         const void* dh, const void* dh_last,
                                         void* carries, void* da, void* db,
                                         void* dinit, int64_t batch,
                                         int64_t l, int64_t w, int64_t wp,
                                         void* stream) {
  const void* ins[3] = {a, b, nullptr};
  void* outs[3] = {da, db, nullptr};
  return launch<float, false>(device, ins, nullptr, states, dh, dh_last,
                              carries, nullptr, outs, nullptr, dinit, batch,
                              l, w, wp, 0.0, stream);
}

// The backward's kernels, five ints each: registers a thread, local
// (spilled) bytes a thread, static and dynamic shared memory a block, and
// blocks a multiprocessor at the launch's block size, as the runtime reports
// them; in the order of ops.BWD_KERNELS (each entry's chain with dh, its
// chunks, then the dΛ sum in bfloat16 and float32).
extern "C" int rglru_bwd_attrs(int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  using B = __nv_bfloat16;
  const void* fns[8] = {
      reinterpret_cast<const void*>(rglru_bwd_chain_kernel<B, true, true>),
      reinterpret_cast<const void*>(rglru_bwd_chunk_kernel<B, true>),
      reinterpret_cast<const void*>(rglru_bwd_chain_kernel<float, true, true>),
      reinterpret_cast<const void*>(rglru_bwd_chunk_kernel<float, true>),
      reinterpret_cast<const void*>(
          rglru_bwd_chain_kernel<float, false, true>),
      reinterpret_cast<const void*>(rglru_bwd_chunk_kernel<float, false>),
      reinterpret_cast<const void*>(rglru_bwd_dparam_kernel<B>),
      reinterpret_cast<const void*>(rglru_bwd_dparam_kernel<float>)};
  const int threads[8] = {kChainLanes + 32, kChunkLanes, kChainLanes + 32,
                          kChunkLanes,      kChainLanes + 32, kChunkLanes,
                          kDparamThreads,   kDparamThreads};
  const int dynamic[8] = {
      static_cast<int>(ChainLayout<B, true>::kBytes) + 128,
      static_cast<int>(ChunkLayout<B, true>::kBytes) + 128,
      static_cast<int>(ChainLayout<float, true>::kBytes) + 128,
      static_cast<int>(ChunkLayout<float, true>::kBytes) + 128,
      static_cast<int>(ChainLayout<float, true>::kBytes) + 128,
      static_cast<int>(ChunkLayout<float, false>::kBytes) + 128,
      0, 0};
  for (int q = 0; q < 8; ++q) {
    if (dynamic[q] > 0 &&
        (err = cudaFuncSetAttribute(
             fns[q], cudaFuncAttributeMaxDynamicSharedMemorySize,
             dynamic[q])) != cudaSuccess)
      return static_cast<int>(err);
    cudaFuncAttributes at;
    if ((err = cudaFuncGetAttributes(&at, fns[q])) != cudaSuccess)
      return static_cast<int>(err);
    int blocks = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &blocks, fns[q], threads[q], dynamic[q])) != cudaSuccess)
      return static_cast<int>(err);
    const int v[5] = {at.numRegs, static_cast<int>(at.localSizeBytes),
                      static_cast<int>(at.sharedSizeBytes), dynamic[q],
                      blocks};
    for (int e = 0; e < 5; ++e) out[5 * q + e] = v[e];
  }
  return 0;
}
