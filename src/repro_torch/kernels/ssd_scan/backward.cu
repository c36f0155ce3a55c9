// ssd_scan backward: the vector-Jacobian product of the Mamba-2 SSD chunked
// scan (kernel.cu's function), written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no backward kernel of its own.
// Its train step differentiates the jnp reference of the scan
// (src/repro/kernels/ssd_scan/ref.py:34) with jax.value_and_grad.  In the
// port a kernel's output has no autograd graph, so the scan's gradient needs
// a kernel of its own: ops.ssd_scan on CUDA tensors is a
// torch.autograd.Function whose backward launches this file's kernels.
//
// Contract.  The forward per (batch, head), state h_t (p x n, float32):
//   h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t
// (B and C at group granularity, head hi reads group hi / (h / g)).  Given
// dy (b, l, h, p) in x's dtype (contiguous) and optionally dfinal (b, h, p,
// n) float32, it writes dx (b, l, h, p) in x's dtype, ddt (b, l, h) float32,
// dA (h,) float32, dB and dC (b, l, g, n) in B's dtype (summed over the
// group's heads) and, where an initial state was given, dinit (b, h, p, n)
// float32.  x, B and C are read through their batch and time strides, as the
// forward reads them.  Arithmetic is float32 throughout; steps past l (the
// last chunk's padding) read as zeros and are never written.
//
// The chunked form.  Within a chunk of cs steps, a_t = cumsum(dt A), L[t, s]
// = exp(a_t - a_s) for s <= t, w_s = exp(a_last - a_s), xdt_s = dt_s x_s,
// S_in the state entering the chunk and dS_out the gradient of the state
// leaving it:
//   y_t   = sum_s (C_t . B_s) L[t, s] xdt_s + exp(a_t) S_in C_t
//   S_out = exp(a_last) S_in + sum_s w_s xdt_s B_s^T
// so that, with dCB[t, s] = L[t, s] (dy_t . xdt_s) and M = (C_t . B_s) dCB:
//   dxdt_s = sum_t (C_t . B_s) L[t, s] dy_t + w_s dS_out B_s
//   dC_t   = sum_s dCB[t, s] B_s + exp(a_t) S_in^T dy_t
//   dB_s   = sum_t dCB[t, s] C_t + w_s dS_out^T xdt_s
//   d a_t  = sum_s M[t, s] - sum_s M[s, t] + dy_t . exp(a_t) S_in C_t
//            - q_t + [t = last] (exp(a_last) <dS_out, S_in> + sum_s q_s),
//   q_s    = w_s xdt_s . (dS_out B_s)
// and ddt_t = A dA_t + x_t . dxdt_t, dA = sum_t dt_t dA_t, where dA_t (the
// gradient of dt_t A) is the reverse cumsum of d a within the chunk.  Six
// launches, in this order on one stream:
//  1. bwd_chunk_state_kernel, a block per (chunk, head, batch): the chunk's
//     cumsum (stored for the later launches), its forward state mass
//     sum_s w_s xdt_s B_s^T and its backward mass sum_t exp(a_t) dy_t C_t^T,
//     two (p x cs)(cs x n) products, into (b, nc, h, p, n) float32 scratch.
//  2. bwd_state_pass_kernel, a thread per state entry: the forward pass over
//     chunks turns the masses into S_in, then the reverse pass turns the
//     backward masses into dS_out (dS_out of the last chunk is dfinal), both
//     in place, with the chunk's <dS_out, S_in> summed per block (no
//     atomics) and dinit = the gradient of the state entering chunk 0.
//  3. bwd_chunk_kernel, a block per (32-row tile, chunk, head, batch): the
//     tile's rows t against the column tiles at or before it (dC_t, sum_s
//     M[t, s]) and its columns s against the row tiles at or after it
//     (dxdt_s, dB_s, sum_t M[t, s]), each 32 x 32 tile of C B^T and dy xdt^T
//     formed in registers and decay-masked; then the S_in and dS_out terms.
//     Tile i has i + 1 row tiles and nt - i column tiles to visit, so every
//     block does the same work.  Writes dx, the per-head dB and dC (b, l, h,
//     n) float32, and three per-step planes (the d a terms, q, x . dxdt).
//  4. bwd_dt_kernel, a block per (chunk, head, batch): the reverse cumsum of
//     d a and the exclusive cumsum of q give dA_t; ddt, and dt . dA_t summed
//     per (batch, chunk, head).
//  5. bwd_group_sum_kernel: dB and dC summed over each group's heads in head
//     order, cast to B's dtype.
//  6. bwd_dA_kernel: dA summed over (batch, chunk) in a fixed order.
// Every sum runs in a fixed order, so the gradient is the same run to run.
//
// What bounds it on this card.  At Mamba2-130M's training call (x 4 x 4,096
// x 24 x 64 bf16, B/C 4 x 4,096 x 1 x 128, chunk 256) the inputs and outputs
// (x, dy, dx, B, C, dB, dC, dt, ddt) are 171 MB, 0.051 ms at 3.35 TB/s.  The
// products the function needs, each pair s <= t of a chunk once, are 4.0e10
// flops: C B^T, dC and dB once per (batch, group), with the heads' masks
// summed first; dy xdt^T and dxdt once per (batch, head); the four state
// products per step and head (the chunk-entry states taken as given).  That
// is 0.60 ms on the float32 pipes at 67 TFLOPS and 0.041 ms on the bf16
// tensor cores, so the bytes bound it.  This kernel forms C B^T and dy xdt^T
// on both the row and the column side of each tile, per head, and
// recomputes the forward's chunk masses: ~1.1e11 flops.  It keeps
// everything on the float32 pipes, operands staged in shared memory and
// 32 x 32 tiles, and also moves the per-head dB / dC partials (2 x 200 MB)
// through device memory; tensor cores, sharing C B^T across a group's heads
// and summing dB / dC across heads on chip are later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kP = 64;           // head dim, the tiles' width (zero-padded)
constexpr int kN = 128;          // state dim
constexpr int kCS = 256;         // chunk
constexpr int kT = 32;           // rows of a tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLdP = kP + 1;     // padded rows: a column's lanes hit distinct banks
constexpr int kLdN = kN + 1;
constexpr int kLdT = kT + 1;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

// Batch and time strides (elements) of x and of B and C; within a step x's
// heads and B's and C's groups are packed.  dy and every output are
// contiguous.
struct Strides {
  int64_t xb, xt, bcb, bct;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// Rows [t0, t0 + kT) of a chunk (the chunk's first step t_base) of a strided
// tensor into a kT x width float tile (row stride ld); a column >= m, a row
// past the chunk or past l reads as zero.  src points at the (batch,
// head-or-group) of step 0.
template <typename T>
__device__ __forceinline__ void load_rows(float* tile, int ld, int width,
                                          const T* __restrict__ src,
                                          int64_t row_stride, int64_t t_base,
                                          int t0, int cs, int64_t l, int m) {
  for (int idx = threadIdx.x; idx < kT * width; idx += kThreads) {
    const int r = idx / width, c = idx % width;
    const int t = t0 + r;
    const bool ok = c < m && t < cs && t_base + t < l;
    tile[r * ld + c] = ok ? to_f(src[(t_base + t) * row_stride + c]) : 0.0f;
  }
}

// The (p, n) state of one (batch, chunk, head) into a kP x kLdN tile, zero
// past p and n.
__device__ __forceinline__ void load_state(float* tile,
                                           const float* __restrict__ src,
                                           int p, int n) {
  for (int idx = threadIdx.x; idx < kP * kN; idx += kThreads) {
    const int r = idx / kN, c = idx % kN;
    tile[r * kLdN + c] = (r < p && c < n) ? src[r * n + c] : 0.0f;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Sum over the 8 lanes that share lane / 8 (an aligned group of 8).
__device__ __forceinline__ float group8_sum(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The block's sum, the same on every thread, in a fixed order.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_sum(v);
  __syncthreads();                        // red is free
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

// Inclusive prefix sum over the block's threads (one value each).
__device__ __forceinline__ float block_scan(float v, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  __syncthreads();
  if (lane == 31) red[warp] = v;
  __syncthreads();
  float before = 0.0f;
  for (int w = 0; w < warp; ++w) before += red[w];
  return v + before;
}

// ---------------------------------------------------------------------------
// 1. chunk cumsum and the chunk's forward and backward state masses
// ---------------------------------------------------------------------------

constexpr int kStateSmem = 4 * (2 * kT * kLdP + 2 * kT * kLdN);

template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_chunk_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const T* __restrict__ B,
                       const T* __restrict__ C, const T* __restrict__ dy,
                       float* __restrict__ acum, float* __restrict__ S,
                       float* __restrict__ dS, int64_t l, int64_t h, int64_t g,
                       int p, int n, int cs, Strides sd) {
  __shared__ float a_s[kCS], dt_s[kCS], red[kWarps];
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);   // kT x kLdP: x
  float* Bt = X + kT * kLdP;                    // kT x kLdN
  float* Dy = Bt + kT * kLdN;                   // kT x kLdP
  float* Ct = Dy + kT * kLdP;                   // kT x kLdN

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t c = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z;
  const int64_t nc = gridDim.x;
  const int64_t gi = hi / (h / g);
  const int64_t t_base = c * cs;
  {
    const bool ok = tid < cs && t_base + tid < l;
    const float d = ok ? dt[(bi * l + t_base + tid) * h + hi] : 0.0f;
    const float v = block_scan(d * A[hi], red);
    if (tid < cs) {
      dt_s[tid] = d;
      a_s[tid] = v;
      acum[(bi * h + hi) * nc * cs + t_base + tid] = v;
    }
  }
  __syncthreads();
  const float a_last = a_s[cs - 1];
  const T* xb = x + bi * sd.xb + hi * p;
  const T* Bb = B + bi * sd.bcb + gi * n;
  const T* Cb = C + bi * sd.bcb + gi * n;
  const T* dyb = dy + bi * l * h * p + hi * p;

  // thread: state rows 8 warp + i, columns lane + 32 k
  float s_acc[8][4], d_acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) s_acc[i][k] = d_acc[i][k] = 0.0f;
  for (int t0 = 0; t0 < cs; t0 += kT) {
    __syncthreads();                       // the previous tiles are consumed
    load_rows(X, kLdP, kP, xb, sd.xt, t_base, t0, cs, l, p);
    load_rows(Bt, kLdN, kN, Bb, sd.bct, t_base, t0, cs, l, n);
    load_rows(Dy, kLdP, kP, dyb, h * p, t_base, t0, cs, l, p);
    load_rows(Ct, kLdN, kN, Cb, sd.bct, t_base, t0, cs, l, n);
    __syncthreads();
    const int rows = min(kT, cs - t0);
    for (int r = 0; r < rows; ++r) {
      const int t = t0 + r;
      const float wx = expf(a_last - a_s[t]) * dt_s[t];
      const float ey = expf(a_s[t]);
      float bv[4], cv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        bv[k] = Bt[r * kLdN + lane + 32 * k];
        cv[k] = Ct[r * kLdN + lane + 32 * k];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xv = X[r * kLdP + 8 * warp + i] * wx;
        const float yv = Dy[r * kLdP + 8 * warp + i] * ey;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          s_acc[i][k] += xv * bv[k];
          d_acc[i][k] += yv * cv[k];
        }
      }
    }
  }
  const int64_t base = ((bi * nc + c) * h + hi) * static_cast<int64_t>(p) * n;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int pr = 8 * warp + i;
    if (pr >= p) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int col = lane + 32 * k;
      if (col < n) {
        S[base + pr * n + col] = s_acc[i][k];
        dS[base + pr * n + col] = d_acc[i][k];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 2. the passes over chunks: S_in forward, dS_out backward, in place
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
bwd_state_pass_kernel(const float* __restrict__ acum,
                      const float* __restrict__ init,
                      const float* __restrict__ dfin, float* __restrict__ S,
                      float* __restrict__ dS, float* __restrict__ sdot_part,
                      float* __restrict__ dinit, int64_t nc, int64_t h,
                      int64_t pn, int cs) {
  __shared__ float red[kWarps];
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t hi = blockIdx.y, bi = blockIdx.z;
  const bool ok = e < pn;
  const int64_t bh = bi * h + hi;
  const float* ab = acum + bh * nc * cs;
  float carry = (ok && init != nullptr) ? init[bh * pn + e] : 0.0f;
  for (int64_t c = 0; c < nc; ++c) {
    const int64_t idx = ((bi * nc + c) * h + hi) * pn + e;
    if (ok) {
      const float mass = S[idx];
      S[idx] = carry;                       // the state entering chunk c
      carry = expf(ab[c * cs + cs - 1]) * carry + mass;
    }
  }
  float grad = (ok && dfin != nullptr) ? dfin[bh * pn + e] : 0.0f;
  for (int64_t c = nc - 1; c >= 0; --c) {
    const int64_t idx = ((bi * nc + c) * h + hi) * pn + e;
    float part = 0.0f;
    if (ok) {
      const float mass = dS[idx];
      dS[idx] = grad;                       // the gradient leaving chunk c
      part = grad * S[idx];
      grad = expf(ab[c * cs + cs - 1]) * grad + mass;
    }
    const float tot = block_sum(part, red);
    if (threadIdx.x == 0)
      sdot_part[((bi * nc + c) * h + hi) * gridDim.x + blockIdx.x] = tot;
  }
  if (ok && dinit != nullptr) dinit[bh * pn + e] = grad;
}

// ---------------------------------------------------------------------------
// 3. the chunk's products, one 32-row tile a block
// ---------------------------------------------------------------------------

constexpr int kUnion = (kT * kLdN + kT * kLdP + 2 * kT * kLdT) > kP * kLdN
                           ? (kT * kLdN + kT * kLdP + 2 * kT * kLdT)
                           : kP * kLdN;
constexpr int kChunkSmem = 4 * (2 * kT * kLdN + 2 * kT * kLdP + kUnion);

template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const T* __restrict__ B, const T* __restrict__ C,
                 const T* __restrict__ dy, const float* __restrict__ acum,
                 const float* __restrict__ S, const float* __restrict__ dS,
                 T* __restrict__ dx, float* __restrict__ dBh,
                 float* __restrict__ dCh, float* __restrict__ rqx, int64_t l,
                 int64_t h, int64_t g, int p, int n, int cs, int ntiles,
                 Strides sd) {
  __shared__ float a_s[kCS], dt_s[kCS];
  __shared__ float rs[kT], csm[kT], ys[kT];
  extern __shared__ float4 smem4[];
  float* Ci = reinterpret_cast<float*>(smem4);   // kT x kLdN: this tile's C
  float* Bi = Ci + kT * kLdN;                    //            its B
  float* Dyi = Bi + kT * kLdN;                   // kT x kLdP: its dy
  float* Xi = Dyi + kT * kLdP;                   //            its x
  float* U = Xi + kT * kLdP;                     // union below
  float* On = U;                                 // the other tile: B or C
  float* Op = On + kT * kLdN;                    //                 x or dy
  float* S1 = Op + kT * kLdP;                    // kT x kLdT: dCB[t][s]
  float* S2 = S1 + kT * kLdT;                    //            P[t][s]
  // (U holds a kP x kLdN state once the passes are done)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t c = blockIdx.x / ntiles, hi = blockIdx.y, bi = blockIdx.z;
  const int it = static_cast<int>(blockIdx.x % ntiles);
  const int64_t nc = gridDim.x / ntiles, ncs = nc * cs;
  const int64_t gi = hi / (h / g);
  const int64_t t_base = c * cs;
  const int i0 = it * kT;

  for (int t = tid; t < cs; t += kThreads) {
    a_s[t] = acum[(bi * h + hi) * ncs + t_base + t];
    dt_s[t] = t_base + t < l ? dt[(bi * l + t_base + t) * h + hi] : 0.0f;
  }
  if (tid < kT) rs[tid] = csm[tid] = 0.0f;
  const T* xb = x + bi * sd.xb + hi * p;
  const T* Bb = B + bi * sd.bcb + gi * n;
  const T* Cb = C + bi * sd.bcb + gi * n;
  const T* dyb = dy + bi * l * h * p + hi * p;
  load_rows(Ci, kLdN, kN, Cb, sd.bct, t_base, i0, cs, l, n);
  load_rows(Bi, kLdN, kN, Bb, sd.bct, t_base, i0, cs, l, n);
  load_rows(Dyi, kLdP, kP, dyb, h * p, t_base, i0, cs, l, p);
  load_rows(Xi, kLdP, kP, xb, sd.xt, t_base, i0, cs, l, p);
  __syncthreads();
  const float a_last = a_s[cs - 1];

  // accumulators: rows 4 warp + r of this tile; columns lane + 32 k
  float dC[4][4], dB[4][4], dX[4][2];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int k = 0; k < 4; ++k) dC[r][k] = dB[r][k] = 0.0f;
    dX[r][0] = dX[r][1] = 0.0f;
  }
  const int tr = tid >> 3, tq = tid & 7;     // a tile entry's row, column quad

  // ---- row side: this tile's rows t against column tiles j <= it ----
  for (int j = 0; j <= it; ++j) {
    const int j0 = j * kT;
    __syncthreads();                         // On, Op, S1 are free
    load_rows(On, kLdN, kN, Bb, sd.bct, t_base, j0, cs, l, n);
    load_rows(Op, kLdP, kP, xb, sd.xt, t_base, j0, cs, l, p);
    __syncthreads();
    float cb[4] = {0.0f, 0.0f, 0.0f, 0.0f}, d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const float* crow = Ci + tr * kLdN;
    for (int k = 0; k < kN; ++k) {
      const float cv = crow[k];
#pragma unroll
      for (int q = 0; q < 4; ++q) cb[q] += cv * On[(4 * tq + q) * kLdN + k];
    }
    const float* yrow = Dyi + tr * kLdP;
    for (int k = 0; k < kP; ++k) {
      const float yv = yrow[k];
#pragma unroll
      for (int q = 0; q < 4; ++q) d[q] += yv * Op[(4 * tq + q) * kLdP + k];
    }
    const int gt = i0 + tr;
    float part = 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int gs = j0 + 4 * tq + q;
      float dcb = 0.0f;
      if (gs <= gt && gt < cs)
        dcb = expf(a_s[gt] - a_s[gs]) * d[q] * dt_s[gs];
      S1[tr * kLdT + 4 * tq + q] = dcb;
      part += cb[q] * dcb;
    }
    part = group8_sum(part);
    if (tq == 0) rs[tr] += part;
    __syncthreads();
    for (int s = 0; s < kT; ++s) {
      float bv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) bv[k] = On[s * kLdN + lane + 32 * k];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a = S1[(4 * warp + r) * kLdT + s];
#pragma unroll
        for (int k = 0; k < 4; ++k) dC[r][k] += a * bv[k];
      }
    }
  }

  // ---- column side: this tile's columns s against row tiles j >= it ----
  for (int j = it; j < ntiles; ++j) {
    const int j0 = j * kT;
    __syncthreads();
    load_rows(On, kLdN, kN, Cb, sd.bct, t_base, j0, cs, l, n);
    load_rows(Op, kLdP, kP, dyb, h * p, t_base, j0, cs, l, p);
    __syncthreads();
    float cb[4] = {0.0f, 0.0f, 0.0f, 0.0f}, d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const float* brow = Bi + tr * kLdN;
    for (int k = 0; k < kN; ++k) {
      const float bv = brow[k];
#pragma unroll
      for (int q = 0; q < 4; ++q) cb[q] += On[(4 * tq + q) * kLdN + k] * bv;
    }
    const float* xrow = Xi + tr * kLdP;
    for (int k = 0; k < kP; ++k) {
      const float xv = xrow[k];
#pragma unroll
      for (int q = 0; q < 4; ++q) d[q] += Op[(4 * tq + q) * kLdP + k] * xv;
    }
    const int gs = i0 + tr;
    float part = 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int gt = j0 + 4 * tq + q;
      float L = 0.0f, dcb = 0.0f;
      if (gs <= gt && gt < cs) {
        L = expf(a_s[gt] - a_s[gs]);
        dcb = L * d[q] * dt_s[gs];
      }
      S1[(4 * tq + q) * kLdT + tr] = dcb;
      S2[(4 * tq + q) * kLdT + tr] = cb[q] * L;
      part += cb[q] * dcb;
    }
    part = group8_sum(part);
    if (tq == 0) csm[tr] += part;
    __syncthreads();
    for (int t = 0; t < kT; ++t) {
      float yv[2], cv[4];
#pragma unroll
      for (int k = 0; k < 2; ++k) yv[k] = Op[t * kLdP + lane + 32 * k];
#pragma unroll
      for (int k = 0; k < 4; ++k) cv[k] = On[t * kLdN + lane + 32 * k];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float pv = S2[t * kLdT + 4 * warp + r];
        const float dv = S1[t * kLdT + 4 * warp + r];
#pragma unroll
        for (int k = 0; k < 2; ++k) dX[r][k] += pv * yv[k];
#pragma unroll
        for (int k = 0; k < 4; ++k) dB[r][k] += dv * cv[k];
      }
    }
  }

  // ---- the carried state's terms ----
  const int64_t sbase = ((bi * nc + c) * h + hi) * static_cast<int64_t>(p) * n;
  __syncthreads();                           // the union is free
  load_state(U, S + sbase, p, n);            // S_in
  __syncthreads();
  {
    float v[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) v[r][k] = 0.0f;
    for (int pp = 0; pp < kP; ++pp) {
      float sv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) sv[k] = U[pp * kLdN + lane + 32 * k];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float yv = Dyi[(4 * warp + r) * kLdP + pp];
#pragma unroll
        for (int k = 0; k < 4; ++k) v[r][k] += yv * sv[k];
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int tl = 4 * warp + r, gt = i0 + tl;
      const float et = gt < cs ? expf(a_s[gt]) : 0.0f;
      float part = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        dC[r][k] += et * v[r][k];
        part += v[r][k] * Ci[tl * kLdN + lane + 32 * k];
      }
      part = warp_sum(part);
      if (lane == 0) ys[tl] = et * part;
    }
  }
  __syncthreads();
  load_state(U, dS + sbase, p, n);           // dS_out
  __syncthreads();
  float q_row[4];
  {
    float u[4][4], z[4][2];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int k = 0; k < 4; ++k) u[r][k] = 0.0f;
      z[r][0] = z[r][1] = 0.0f;
    }
    for (int pp = 0; pp < kP; ++pp) {
      float sv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) sv[k] = U[pp * kLdN + lane + 32 * k];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float xv = Xi[(4 * warp + r) * kLdP + pp];
#pragma unroll
        for (int k = 0; k < 4; ++k) u[r][k] += xv * sv[k];
      }
    }
    for (int k2 = 0; k2 < kN; ++k2) {
      float dv[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) dv[k] = U[(lane + 32 * k) * kLdN + k2];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float bv = Bi[(4 * warp + r) * kLdN + k2];
#pragma unroll
        for (int k = 0; k < 2; ++k) z[r][k] += dv[k] * bv;
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int tl = 4 * warp + r, gs = i0 + tl;
      const bool ok = gs < cs;
      const float ws = ok ? expf(a_last - a_s[gs]) : 0.0f;
      const float dts = ok ? dt_s[gs] : 0.0f;
      float part = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float uu = dts * u[r][k];
        dB[r][k] += ws * uu;
        part += uu * Bi[tl * kLdN + lane + 32 * k];
      }
      q_row[r] = ws * warp_sum(part);
#pragma unroll
      for (int k = 0; k < 2; ++k) dX[r][k] += ws * z[r][k];
    }
  }

  // ---- outputs ----
  const int64_t plane = static_cast<int64_t>(gridDim.z) * h * ncs;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int tl = 4 * warp + r, gs = i0 + tl;
    float part = 0.0f;
#pragma unroll
    for (int k = 0; k < 2; ++k) part += Xi[tl * kLdP + lane + 32 * k] * dX[r][k];
    part = warp_sum(part);
    if (gs >= cs || t_base + gs >= l) continue;     // uniform over the warp
    const int64_t t = t_base + gs;
    const float dts = dt_s[gs];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int col = lane + 32 * k;
      if (col < p) dx[((bi * l + t) * h + hi) * p + col] = from_f<T>(dts * dX[r][k]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int col = lane + 32 * k;
      if (col < n) {
        dBh[((bi * l + t) * h + hi) * n + col] = dB[r][k];
        dCh[((bi * l + t) * h + hi) * n + col] = dC[r][k];
      }
    }
    if (lane == 0) {
      const int64_t o = (bi * h + hi) * ncs + t_base + gs;
      rqx[o] = rs[tl] - csm[tl] + ys[tl];
      rqx[plane + o] = q_row[r];
      rqx[2 * plane + o] = part;
    }
  }
}

// ---------------------------------------------------------------------------
// 4. dA_t by the chunk's cumsums; ddt; dt . dA_t per (batch, chunk, head)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
bwd_dt_kernel(const float* __restrict__ rqx,
              const float* __restrict__ sdot_part,
              const float* __restrict__ acum, const float* __restrict__ dt,
              const float* __restrict__ A, float* __restrict__ ddt,
              float* __restrict__ dA_part, int64_t l, int64_t h, int cs,
              int nblk) {
  __shared__ float red[kWarps], rsum[kThreads], qin[kThreads];
  __shared__ float sdot;
  const int tid = threadIdx.x;
  const int64_t c = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z;
  const int64_t nc = gridDim.x, ncs = nc * cs;
  const int64_t plane = static_cast<int64_t>(gridDim.z) * h * ncs;
  const int64_t row = (bi * h + hi) * ncs + c * cs;
  if (tid == 0) {
    float s = 0.0f;
    for (int k = 0; k < nblk; ++k)
      s += sdot_part[((bi * nc + c) * h + hi) * nblk + k];
    sdot = expf(acum[row + cs - 1]) * s;
  }
  // reverse inclusive cumsum of the d a terms: thread tid holds step
  // kThreads - 1 - tid
  {
    const int t = kThreads - 1 - tid;
    const bool ok = t < cs && c * cs + t < l;
    const float v = block_scan(ok ? rqx[row + t] : 0.0f, red);
    rsum[t] = v;
  }
  const int t = tid;
  const bool ok = t < cs && c * cs + t < l;
  {
    const float v = block_scan(ok ? rqx[plane + row + t] : 0.0f, red);
    qin[t] = v;
  }
  __syncthreads();
  const float dat = rsum[t] + (t > 0 ? qin[t - 1] : 0.0f) + sdot;
  float part = 0.0f;
  if (ok) {
    const int64_t o = (bi * l + c * cs + t) * h + hi;
    ddt[o] = A[hi] * dat + rqx[2 * plane + row + t];
    part = dt[o] * dat;
  }
  const float tot = block_sum(part, red);
  if (tid == 0) dA_part[(bi * nc + c) * h + hi] = tot;
}

// ---------------------------------------------------------------------------
// 5. dB and dC over each group's heads; 6. dA over (batch, chunk)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_group_sum_kernel(const float* __restrict__ dBh,
                     const float* __restrict__ dCh, T* __restrict__ dB,
                     T* __restrict__ dC, int64_t total, int64_t h, int64_t g,
                     int n) {
  const int64_t hg = h / g;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       idx < total; idx += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t col = idx % n, rest = idx / n;
    const int64_t gi = rest % g, bt = rest / g;      // bt = batch * l + t
    const int64_t off = (bt * h + gi * hg) * n + col;
    float sb = 0.0f, sc = 0.0f;
    for (int64_t k = 0; k < hg; ++k) {
      sb += dBh[off + k * n];
      sc += dCh[off + k * n];
    }
    dB[idx] = from_f<T>(sb);
    dC[idx] = from_f<T>(sc);
  }
}

__global__ void __launch_bounds__(kThreads)
bwd_dA_kernel(const float* __restrict__ dA_part, float* __restrict__ dA,
              int64_t bnc, int64_t h) {
  __shared__ float red[kWarps];
  const int64_t hi = blockIdx.x;
  float s = 0.0f;
  for (int64_t k = threadIdx.x; k < bnc; k += kThreads) s += dA_part[k * h + hi];
  const float tot = block_sum(s, red);
  if (threadIdx.x == 0) dA[hi] = tot;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int device, int bytes, bool* done) {
  if (device >= 0 && device < kMaxDevices && done[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && device >= 0 && device < kMaxDevices)
    done[device] = true;
  return err;
}

template <typename T>
struct SmemSet {
  static bool state[kMaxDevices], chunk[kMaxDevices];
};
template <typename T>
bool SmemSet<T>::state[kMaxDevices];
template <typename T>
bool SmemSet<T>::chunk[kMaxDevices];

template <typename T>
int run_backward(int device, const void* x, const void* dt, const void* A,
                 const void* B, const void* C, const void* init,
                 const void* dy, const void* dfin, void* dx, void* ddt,
                 void* dA, void* dB, void* dC, void* dinit, void* acum,
                 void* S, void* dS, void* sdot, void* rqx, void* dBh,
                 void* dCh, void* dA_part, int64_t b, int64_t l, int64_t h,
                 int64_t g, int64_t p, int64_t n, int64_t cs, Strides sd,
                 cudaStream_t stream) {
  cudaError_t err = allow_smem(bwd_chunk_state_kernel<T>, device, kStateSmem,
                               SmemSet<T>::state);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(bwd_chunk_kernel<T>, device, kChunkSmem,
                   SmemSet<T>::chunk);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t nc = (l + cs - 1) / cs, pn = p * n;
  const int ntiles = static_cast<int>((cs + kT - 1) / kT);
  const int nblk = static_cast<int>((pn + kThreads - 1) / kThreads);
  const unsigned ub = static_cast<unsigned>(b), uh = static_cast<unsigned>(h);
  const int ip = static_cast<int>(p), in = static_cast<int>(n);
  const int ics = static_cast<int>(cs);
  const T* tx = static_cast<const T*>(x);
  const T* tB = static_cast<const T*>(B);
  const T* tC = static_cast<const T*>(C);
  const T* tdy = static_cast<const T*>(dy);
  const float* fdt = static_cast<const float*>(dt);
  float* facum = static_cast<float*>(acum);
  float* fS = static_cast<float*>(S);
  float* fdS = static_cast<float*>(dS);
  float* fsdot = static_cast<float*>(sdot);
  float* frqx = static_cast<float*>(rqx);
  float* fdA_part = static_cast<float*>(dA_part);

  bwd_chunk_state_kernel<T><<<dim3(static_cast<unsigned>(nc), uh, ub),
                              kThreads, kStateSmem, stream>>>(
      tx, fdt, static_cast<const float*>(A), tB, tC, tdy, facum, fS, fdS, l,
      h, g, ip, in, ics, sd);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bwd_state_pass_kernel<<<dim3(static_cast<unsigned>(nblk), uh, ub), kThreads,
                          0, stream>>>(
      facum, static_cast<const float*>(init), static_cast<const float*>(dfin),
      fS, fdS, fsdot, static_cast<float*>(dinit), nc, h, pn, ics);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bwd_chunk_kernel<T><<<dim3(static_cast<unsigned>(nc * ntiles), uh, ub),
                        kThreads, kChunkSmem, stream>>>(
      tx, fdt, tB, tC, tdy, facum, fS, fdS, static_cast<T*>(dx),
      static_cast<float*>(dBh), static_cast<float*>(dCh), frqx, l, h, g, ip,
      in, ics, ntiles, sd);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bwd_dt_kernel<<<dim3(static_cast<unsigned>(nc), uh, ub), kThreads, 0,
                  stream>>>(frqx, fsdot, facum, fdt,
                            static_cast<const float*>(A),
                            static_cast<float*>(ddt), fdA_part, l, h, ics,
                            nblk);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int64_t total = b * l * g * n;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  bwd_group_sum_kernel<T><<<static_cast<unsigned>(blocks < 65535 * 8
                                                      ? blocks
                                                      : 65535 * 8),
                            kThreads, 0, stream>>>(
      static_cast<const float*>(dBh), static_cast<const float*>(dCh),
      static_cast<T*>(dB), static_cast<T*>(dC), total, h, g, in);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bwd_dA_kernel<<<uh, kThreads, 0, stream>>>(fdA_part, static_cast<float*>(dA),
                                             b * nc, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The caller guarantees b, l, h > 0, h % g == 0, p <= 64, n <= 128,
// 0 < cs <= 256, b and h < 65,536; x, B and C laid out as Strides says, dy
// contiguous (b, l, h, p) in x's dtype; init, dfin, dinit null or (b, h, p,
// n) float32.  Scratch, float32: acum (b, h, nc * cs); S and dS (b, nc, h,
// p, n); sdot (b, nc, h, ceil(p n / 256)); rqx (3, b, h, nc * cs); dBh and
// dCh (b, l, h, n); dA_part (b, nc, h).  bf16 != 0 selects bfloat16 x, B, C,
// dy, dx, dB, dC, else float32.
extern "C" int ssd_scan_bwd(int device, int bf16_io, const void* x,
                            const void* dt, const void* A, const void* B,
                            const void* C, const void* init, const void* dy,
                            const void* dfin, void* dx, void* ddt, void* dA,
                            void* dB, void* dC, void* dinit, void* acum,
                            void* S, void* dS, void* sdot, void* rqx,
                            void* dBh, void* dCh, void* dA_part, int64_t b,
                            int64_t l, int64_t h, int64_t g, int64_t p,
                            int64_t n, int64_t cs, int64_t xb, int64_t xt,
                            int64_t bcb, int64_t bct, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides sd{xb, xt, bcb, bct};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_io)
    return run_backward<bf16>(device, x, dt, A, B, C, init, dy, dfin, dx, ddt,
                              dA, dB, dC, dinit, acum, S, dS, sdot, rqx, dBh,
                              dCh, dA_part, b, l, h, g, p, n, cs, sd, st);
  return run_backward<float>(device, x, dt, A, B, C, init, dy, dfin, dx, ddt,
                             dA, dB, dC, dinit, acum, S, dS, sdot, rqx, dBh,
                             dCh, dA_part, b, l, h, g, p, n, cs, sd, st);
}
