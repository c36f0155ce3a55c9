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
// forward reads them.  Sums and every float32 value keep float32 (the
// bfloat16 entry's products take their float32 operands split into two
// bf16 parts, ~16 of float32's 24 mantissa bits); steps past l (the last
// chunk's padding) read as zeros and are never written.
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
// gradient of dt_t A) is the reverse cumsum of d a within the chunk.
//
// What bounds it on this card.  At Mamba2-130M's training call (x 4 x 4,096
// x 24 x 64 bf16, B/C 4 x 4,096 x 1 x 128, chunk 256) the inputs and outputs
// (x, dy, dx, B, C, dB, dC, dt, ddt) are 171 MB, 0.051 ms at 3.35 TB/s.  The
// products the function needs, each pair s <= t of a chunk once, are 4.0e10
// flops: C B^T, dC and dB once per (batch, group), with the heads' masks
// summed first; dy xdt^T and dxdt once per (batch, head); the four state
// products per step and head (the chunk-entry states taken as given).  That
// is 0.60 ms on the float32 pipes at 67 TFLOPS and 0.041 ms on the bf16
// tensor cores, so the bytes bound it.
//
// Two entries, chosen by dtype; every sum of either runs in a fixed order
// (no float atomics), so the gradient is the same bits run to run.
//
// bfloat16 (ssd_scan_bwd_bf16): five launches on one stream, every product
// on wgmma (m64n64k16, bf16 in, float32 accumulation).  An operand that is
// bf16 already (x, dy, B, C) goes in as it is; each float32 operand (the
// masked score tiles, the chunk states, w x and exp(a) dy) is split into bf16
// hi + lo and multiplied twice, as the forward's bf16 entry does; the float32
// factors (the decay, dt, w, exp(a)) are folded into that operand or scale
// the accumulator's rows.
//  1. bwd_mass_bf16_kernel, two warpgroups per (chunk, head, batch), 64 of n
//     each: the chunk's cumsum a and its dt (rows of 256 a chunk, for the
//     later launches), the forward mass (w dt x)^T B and the backward mass
//     (exp(a) dy)^T C, both on wgmma as the forward's ssd_chunk_state_kernel
//     forms its one (B and C tiles by cp.async, x and dy a tile ahead).
//  2. bwd_pass_bf16_kernel, a thread per four state entries, eight chunks'
//     loads in flight in both directions (as the forward's state pass): S_in
//     forward (float32 in place of the mass, and split into bf16 hi / lo
//     planes), dS_out in reverse (planes; dfinal leaves the last chunk),
//     <dS_out, S_in> summed per block in a fixed order, dinit.
//  3. bwd_chunk_bf16_kernel, one warpgroup per (side, 64-step tile, chunk,
//     group, batch), walking the group's heads in head order.  The row side
//     of tile I: for each column tile J <= I, C_I B_J^T once, then per head
//     dy_I x_J^T decay-masked into dCB (sum_s M[t, s] from it), the heads'
//     dCB summed in registers and multiplied by B_J once per pair; then per
//     head dy_I S_in (the planes, two halves of n) for dC's carried term and
//     y's d a term.  The column side: for each row tile J >= I, the
//     transposed tile B_I C_J^T once (kept in device memory for the dx steps,
//     in accumulator order), per head x_I dy_J^T into dCB^T (sum_t M[t, s]),
//     summed over the heads and multiplied by C_J once per pair; then per
//     head x_I dS_out and B_I dS_out^T (dB's and dxdt's carried terms, q),
//     and for each J the masked C B^T tile, split, times dy_J (dxdt).  The
//     masked tiles pass from the accumulators into the next product's A
//     fragments in registers; the pairs' dB / dC sums go through a float32
//     tile of the block's in device memory (out of the head loop's
//     registers); dB and dC of a tile are summed over the group's heads on
//     chip and written once, in B's dtype.  The decay exp(a_t - a_s) of a
//     tile below the diagonal is exp(a_t - a_r) exp(a_r - a_s) around the s
//     tile's last step r (2 + 16 exponentials a thread, not 32).  A step's
//     operands (64 x 64 bf16 boxes, the states' planes, a and dt) come by
//     TMA into one of two stages, one thread issuing them as soon as the
//     stage is free; a block has 110 KB of shared memory (two an SM).  The
//     column side has more steps than the row side of the same tile (2 (nt -
//     i) + 2 against i + 3 a head, at n 128), so the grid's slowest index
//     ranks the 2 nt (side, tile) pairs heaviest first.  Where rows are not
//     whole 16-byte runs (p or n not a multiple of 8, or a stride), the same
//     loads go by cp.async, element by element.
//  4. bwd_dt_kernel and 5. bwd_dA_kernel, shared with the float32 entry.
// What holds it back now: each step is a round of wait, products, masks and
// a barrier for one warpgroup, two blocks an SM, so latency, not the tensor
// cores or the bytes, sets the pace (about 3,500 cycles a step; a step's
// TMA issue on one thread about 1,200 of them); and a pair's x and dy tiles
// come again for every pair (about 1 GB from L2 a call).
//
// float32 (ssd_scan_bwd_f32): the float32 pipes (TF32 would not hold the
// gate), six launches:
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
#include <cstdint>
#include <cstring>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../hopper.cuh"
#include "../wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace wgmma;

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


// Rows [t0, t0 + kT) of a chunk (the chunk's first step t_base) of a strided
// tensor into a kT x width float tile (row stride ld); a column >= m, a row
// past the chunk or past l reads as zero.  src points at the (batch,
// head-or-group) of step 0.
__device__ __forceinline__ void load_rows(float* tile, int ld, int width,
                                          const float* __restrict__ src,
                                          int64_t row_stride, int64_t t_base,
                                          int t0, int cs, int64_t l, int m) {
  for (int idx = threadIdx.x; idx < kT * width; idx += kThreads) {
    const int r = idx / width, c = idx % width;
    const int t = t0 + r;
    const bool ok = c < m && t < cs && t_base + t < l;
    tile[r * ld + c] = ok ? src[(t_base + t) * row_stride + c] : 0.0f;
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

__global__ void __launch_bounds__(kThreads)
bwd_chunk_state_kernel(const float* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ A, const float* __restrict__ B,
                       const float* __restrict__ C,
                       const float* __restrict__ dy,
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
  const float* xb = x + bi * sd.xb + hi * p;
  const float* Bb = B + bi * sd.bcb + gi * n;
  const float* Cb = C + bi * sd.bcb + gi * n;
  const float* dyb = dy + bi * l * h * p + hi * p;

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

__global__ void __launch_bounds__(kThreads)
bwd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ B, const float* __restrict__ C,
                 const float* __restrict__ dy, const float* __restrict__ acum,
                 const float* __restrict__ S, const float* __restrict__ dS,
                 float* __restrict__ dx, float* __restrict__ dBh,
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
  const float* xb = x + bi * sd.xb + hi * p;
  const float* Bb = B + bi * sd.bcb + gi * n;
  const float* Cb = C + bi * sd.bcb + gi * n;
  const float* dyb = dy + bi * l * h * p + hi * p;
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
      if (col < p) dx[((bi * l + t) * h + hi) * p + col] = dts * dX[r][k];
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
bwd_dt_kernel(const float* __restrict__ rqx, const float* __restrict__ csum,
              const float* __restrict__ sdot_part,
              const float* __restrict__ acum, const float* __restrict__ dt,
              const float* __restrict__ A, float* __restrict__ ddt,
              float* __restrict__ dA_part, int64_t l, int64_t h, int cs,
              int64_t cstride, int nblk) {
  __shared__ float red[kWarps], rsum[kThreads], qin[kThreads];
  __shared__ float sdot;
  const int tid = threadIdx.x;
  const int64_t c = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z;
  const int64_t nc = gridDim.x, ncs = nc * cstride;
  const int64_t plane = static_cast<int64_t>(gridDim.z) * h * ncs;
  const int64_t row = (bi * h + hi) * ncs + c * cstride;
  if (tid == 0) {
    float s = 0.0f;
    for (int k = 0; k < nblk; ++k)
      s += sdot_part[((bi * nc + c) * h + hi) * nblk + k];
    sdot = expf(acum[row + cs - 1]) * s;
  }
  // reverse inclusive cumsum of the d a terms (less the column sums where
  // they come apart): thread tid holds step kThreads - 1 - tid
  {
    const int t = kThreads - 1 - tid;
    const bool ok = t < cs && c * cs + t < l;
    float v = ok ? rqx[row + t] : 0.0f;
    if (ok && csum != nullptr) v -= csum[row + t];
    rsum[t] = block_scan(v, red);
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

__global__ void __launch_bounds__(kThreads)
bwd_group_sum_kernel(const float* __restrict__ dBh,
                     const float* __restrict__ dCh, float* __restrict__ dB,
                     float* __restrict__ dC, int64_t total, int64_t h,
                     int64_t g,
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
    dB[idx] = sb;
    dC[idx] = sc;
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

// ===========================================================================
// bfloat16 entry: products on wgmma, C B^T once per (batch, group)
// ===========================================================================

constexpr int kTile = 64;                // steps of a row or column tile
constexpr int kBox = kTile * 128;        // a swizzled box: 64 rows of 64 bf16
constexpr int kTileB = 2 * kBox;         // a tile of B or C: two boxes of n
constexpr int kWideThreads = 256;        // two warpgroups
constexpr int kPieces = kTile * 8 / kWideThreads;   // a thread's 16-byte pieces
constexpr int kPassDepth = 8;            // chunks whose loads are in flight
constexpr int kChunkThreads = 128;       // one warpgroup
constexpr int kSumHeads = 32;            // heads whose row sums stay on chip

// the packed bf16 pair of a swizzled tile (64 rows, boxes of 64 columns) at
// row r, columns c and c + 1 (c even), widened
__device__ __forceinline__ float2 tile_pair(const char* tile, int r, int c) {
  const char* at = tile + (c / 64) * kBox + r * 128 +
                   ((((c % 64) / 8) ^ (r % 8)) << 4) + (c % 8) * 2;
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(at));
}

// the sum over the four lanes that hold one accumulator row
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// the A fragments (hi and lo) of the k16 steps of a product whose A is the
// 64 x 64 float32 accumulator v: its 16 x 16 blocks, split
__device__ __forceinline__ void split_frags(const float (&v)[32],
                                            uint32_t (&ph)[4][4],
                                            uint32_t (&pl)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      split2(v[8 * k + 2 * q], v[8 * k + 2 * q + 1], ph[k][q], pl[k][q]);
}

// d (+)= A . B over K = 128 (two boxes), both K-major in shared memory
__device__ __forceinline__ void mma_k128(float (&d)[32], uint32_t a,
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
    wg_mma_ss(d, desc(a + off, 16, 1024), desc(b + off, 16, 1024), kk > 0);
  }
}

// d (+)= A . B over K = 64 (one box), both K-major in shared memory
__device__ __forceinline__ void mma_k64(float (&d)[32], uint32_t a,
                                        uint32_t b, bool accumulate) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wg_mma_ss(d, desc(a + kk * 32, 16, 1024), desc(b + kk * 32, 16, 1024),
              accumulate || kk > 0);
}

// d += (hi + lo) . B, A from registers, B (64 rows of K, 64 columns of N)
// MN-major in shared memory
__device__ __forceinline__ void mma_split_rs(float (&d)[32],
                                             const uint32_t (&ph)[4][4],
                                             const uint32_t (&pl)[4][4],
                                             uint32_t b) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint64_t bd = desc(b + k * 2048, kBox, 1024);
    wg_mma_rs(d, ph[k], bd);
    wg_mma_rs(d, pl[k], bd);
  }
}

// ---------------------------------------------------------------------------
// 1. the chunk's cumsum and both its state masses on wgmma
// ---------------------------------------------------------------------------

// Shared memory, in bytes from a 1024-aligned base.
struct MassSmem {
  static constexpr uint32_t kB = 0;                    // B ring (2 tiles)
  static constexpr uint32_t kC = kB + 2 * kTileB;      // C ring
  static constexpr uint32_t kXh = kC + 2 * kTileB;     // w dt x, hi and lo
  static constexpr uint32_t kXl = kXh + kBox;
  static constexpr uint32_t kYh = kXl + kBox;          // exp(a) dy, hi, lo
  static constexpr uint32_t kYl = kYh + kBox;
  static constexpr uint32_t kDt = kYl + kBox;
  static constexpr uint32_t kA = kDt + 4 * kCS;
  static constexpr uint32_t kW = kA + 4 * kCS;         // w dt
  static constexpr uint32_t kE = kW + 4 * kCS;         // exp(a)
  static constexpr uint32_t kCarry = kE + 4 * kCS;
  static constexpr uint32_t kBytes = kCarry + 4 * (kWideThreads / 32);
  static constexpr int kLdS = kN + 4;                  // staged rows
};
static_assert(2 * kP * MassSmem::kLdS * 4 <= MassSmem::kDt,
              "both masses are staged below dt");

// w dt x or exp(a) dy pieces, split into hi and lo planes of a swizzled box
__device__ __forceinline__ void split_pieces(char* hi_box, char* lo_box,
                                             const uint4 (&raw)[kPieces],
                                             const float* scale, int s0) {
#pragma unroll
  for (int i = 0; i < kPieces; ++i) {
    const int idx = threadIdx.x + i * kWideThreads;
    const int r = idx / 8, c16 = idx % 8;
    const float w = scale[s0 + r];
    bf16 e[8], eh[8], el[8];
    memcpy(e, &raw[i], sizeof(e));
#pragma unroll
    for (int k = 0; k < 8; ++k)
      split1(w * __bfloat162float(e[k]), eh[k], el[k]);
    uint4 vh, vl;
    memcpy(&vh, eh, sizeof(vh));
    memcpy(&vl, el, sizeof(vl));
    const uint32_t at = r * 128 + ((c16 ^ (r % 8)) << 4);
    *reinterpret_cast<uint4*>(hi_box + at) = vh;
    *reinterpret_cast<uint4*>(lo_box + at) = vl;
  }
}

// A block of two warpgroups per (chunk, head, batch), each warpgroup 64 of n:
// the cumsum a and dt (stored with a row of kCS per chunk, constant and zero
// past the sequence), S = sum_s (w_s dt_s x_s)^T B_s and dS = sum_t (exp(a_t)
// dy_t)^T C_t, (p x n) float32 each.
__global__ void __launch_bounds__(kWideThreads, 2)
bwd_mass_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const bf16* __restrict__ B,
                     const bf16* __restrict__ C, const bf16* __restrict__ dy,
                     float* __restrict__ acum, float* __restrict__ dtc,
                     float* __restrict__ S, float* __restrict__ dS, int64_t l,
                     int64_t h, int64_t g, int p, int n, int cs, Strides sd,
                     int vec) {
  extern __shared__ __align__(1024) char smem_raw[];
  using M = MassSmem;
  const uint32_t raw_addr = smem_addr(smem_raw);
  const uint32_t base = (raw_addr + 1023) & ~1023u;   // the swizzle's
  char* smem = smem_raw + (base - raw_addr);           // alignment
  float* s_dt = reinterpret_cast<float*>(smem + M::kDt);
  float* s_a = reinterpret_cast<float*>(smem + M::kA);
  float* s_w = reinterpret_cast<float*>(smem + M::kW);
  float* s_e = reinterpret_cast<float*>(smem + M::kE);
  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32 % 4,
            lane = tid % 32;
  const int64_t c = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z;
  const int64_t nc = gridDim.x, gi = hi / (h / g);
  const int64_t t_base = c * cs;
  const int valid = static_cast<int>(l - t_base < cs ? l - t_base : cs);
  const int64_t hp = h * p;
  const bf16* xb = x + bi * sd.xb + t_base * sd.xt + hi * p;
  const bf16* dyb = dy + (bi * l + t_base) * hp + hi * p;
  const bf16* Bb = B + bi * sd.bcb + t_base * sd.bct + gi * n;
  const bf16* Cb = C + bi * sd.bcb + t_base * sd.bct + gi * n;

  load_swizzled<kTile, 2>(smem + M::kB, Bb, sd.bct, min(kTile, valid), n, vec);
  load_swizzled<kTile, 2>(smem + M::kC, Cb, sd.bct, min(kTile, valid), n, vec);
  cp_async_commit();
  uint4 rx[kPieces], ry[kPieces];      // x and dy, one tile ahead
  load_x<kWideThreads>(rx, xb, sd.xt, min(kTile, valid), p, vec);
  load_x<kWideThreads>(ry, dyb, hp, min(kTile, valid), p, vec);
  chunk_cumsum<kWideThreads, kCS>(dt + (bi * l + t_base) * h + hi, h, valid,
                                  A[hi], s_dt, s_a,
                                  reinterpret_cast<float*>(smem + M::kCarry));
  const int64_t row = ((bi * h + hi) * nc + c) * kCS;
  for (int t = tid; t < kCS; t += kWideThreads) {
    acum[row + t] = s_a[t];
    dtc[row + t] = s_dt[t];
  }
  const float a_last = s_a[kCS - 1];
  for (int t = tid; t < kCS; t += kWideThreads) {
    s_w[t] = expf(a_last - s_a[t]) * s_dt[t];
    s_e[t] = expf(s_a[t]);
  }
  __syncthreads();

  const int n0 = 64 * wg;
  float acc_s[32], acc_d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_s[i] = acc_d[i] = 0.0f;
  const int tiles = (valid + kTile - 1) / kTile;
  for (int j = 0; j < tiles; ++j) {
    const int buf = j % 2, s0 = j * kTile;
    split_pieces(smem + M::kXh, smem + M::kXl, rx, s_w, s0);
    split_pieces(smem + M::kYh, smem + M::kYl, ry, s_e, s0);
    if (j + 1 < tiles) {               // the next tile's x, dy, B and C
      const int s1 = s0 + kTile, rows = min(kTile, valid - s1);
      load_x<kWideThreads>(rx, xb + s1 * sd.xt, sd.xt, rows, p, vec);
      load_x<kWideThreads>(ry, dyb + s1 * hp, hp, rows, p, vec);
      load_swizzled<kTile, 2>(smem + M::kB + (buf ^ 1) * kTileB,
                              Bb + s1 * sd.bct, sd.bct, rows, n, vec);
      load_swizzled<kTile, 2>(smem + M::kC + (buf ^ 1) * kTileB,
                              Cb + s1 * sd.bct, sd.bct, rows, n, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();
    if (n0 < n) {
      // both operands lie row-major over s (K): both go in transposed
      const uint32_t b_half = base + M::kB + buf * kTileB + wg * kBox;
      const uint32_t c_half = base + M::kC + buf * kTileB + wg * kBox;
      wg_fence();
#pragma unroll
      for (int k = 0; k < kTile / 16; ++k) {
        const uint64_t bd = desc(b_half + k * 2048, kBox, 1024);
        wg_mma_tt(acc_s, desc(base + M::kXh + k * 2048, kBox, 1024), bd);
        wg_mma_tt(acc_s, desc(base + M::kXl + k * 2048, kBox, 1024), bd);
        const uint64_t cd = desc(c_half + k * 2048, kBox, 1024);
        wg_mma_tt(acc_d, desc(base + M::kYh + k * 2048, kBox, 1024), cd);
        wg_mma_tt(acc_d, desc(base + M::kYl + k * 2048, kBox, 1024), cd);
      }
      wg_commit_wait();
      reg_fence(acc_s);
      reg_fence(acc_d);
    }
    __syncthreads();
  }

  // stage both masses in shared memory (the rings are free), then store
  // whole rows
  float* out_s = reinterpret_cast<float*>(smem);
  float* out_d = out_s + kP * M::kLdS;
  const int gr = lane / 4, gc = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int at = (16 * warp + gr + 8 * half) * M::kLdS + n0 + 8 * j + gc;
      *reinterpret_cast<float2*>(&out_s[at]) =
          make_float2(acc_s[4 * j + 2 * half], acc_s[4 * j + 2 * half + 1]);
      *reinterpret_cast<float2*>(&out_d[at]) =
          make_float2(acc_d[4 * j + 2 * half], acc_d[4 * j + 2 * half + 1]);
    }
  __syncthreads();
  const int64_t o = ((bi * nc + c) * h + hi) * static_cast<int64_t>(p) * n;
  if (n % 4 == 0) {
    for (int idx = tid; idx < p * n / 4; idx += kWideThreads) {
      const int r = 4 * idx / n, col = 4 * idx % n;
      reinterpret_cast<float4*>(S + o)[idx] =
          *reinterpret_cast<const float4*>(&out_s[r * M::kLdS + col]);
      reinterpret_cast<float4*>(dS + o)[idx] =
          *reinterpret_cast<const float4*>(&out_d[r * M::kLdS + col]);
    }
  } else {
    for (int idx = tid; idx < p * n; idx += kWideThreads) {
      S[o + idx] = out_s[idx / n * M::kLdS + idx % n];
      dS[o + idx] = out_d[idx / n * M::kLdS + idx % n];
    }
  }
}

// ---------------------------------------------------------------------------
// 2. the passes over chunks, eight chunks' loads in flight
// ---------------------------------------------------------------------------

// four consecutive floats from p (those past cnt read as 0); whole when v4
__device__ __forceinline__ float4 load4(const float* __restrict__ p, int cnt,
                                        bool v4) {
  if (v4) return *reinterpret_cast<const float4*>(p);
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = k < cnt ? p[k] : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(float* __restrict__ p, float4 v,
                                       int cnt, bool v4) {
  if (v4) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
  for (int k = 0; k < cnt; ++k) p[k] = e[k];
}

// v split into bf16 hi at o and lo at o + pn
__device__ __forceinline__ void store_planes(bf16* __restrict__ o, int64_t pn,
                                             float4 v, int cnt, bool v4) {
  const float e[4] = {v.x, v.y, v.z, v.w};
  bf16 h4[4], l4[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) split1(e[i], h4[i], l4[i]);
  if (v4) {
    uint2 uh, ul;
    memcpy(&uh, h4, sizeof(uh));
    memcpy(&ul, l4, sizeof(ul));
    *reinterpret_cast<uint2*>(o) = uh;
    *reinterpret_cast<uint2*>(o + pn) = ul;
  } else {
    for (int i = 0; i < cnt; ++i) {
      o[i] = h4[i];
      o[pn + i] = l4[i];
    }
  }
}

__device__ __forceinline__ float4 fma4(float d, float4 c, float4 m) {
  return make_float4(m.x + d * c.x, m.y + d * c.y, m.z + d * c.z,
                     m.w + d * c.w);
}

// Four entries of a (batch, head)'s state a thread.  Forward: the mass S of
// each chunk is replaced in place by the state entering it (float32), which
// also goes out split into bf16 hi / lo planes (b, nc, h, 2, p, n).
// Reverse: the gradient leaving each chunk goes out as planes too, with
// <dS_out, S_in> of the chunk summed per block in a fixed order; dinit is
// the gradient entering chunk 0.
__global__ void __launch_bounds__(kWideThreads)
bwd_pass_bf16_kernel(const float* __restrict__ acum,
                     const float* __restrict__ init,
                     const float* __restrict__ dfin, float* __restrict__ S,
                     const float* __restrict__ dS, bf16* __restrict__ s_pl,
                     bf16* __restrict__ d_pl, float* __restrict__ sdot_part,
                     float* __restrict__ dinit, int64_t nc, int64_t h,
                     int64_t pn) {
  __shared__ float red[kWarps * kPassDepth];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t e = 4 * (blockIdx.x * static_cast<int64_t>(kWideThreads) + tid);
  const bool ok = e < pn;
  const int cnt = ok ? static_cast<int>(pn - e < 4 ? pn - e : 4) : 0;
  const bool v4 = pn % 4 == 0;
  const int64_t hi = blockIdx.y, bi = blockIdx.z, bh = bi * h + hi;
  const float* a_last = acum + bh * nc * kCS + (kCS - 1);
  const int64_t cstep = h * pn;                 // one chunk further
  float* sp = S + (bi * nc * h + hi) * pn + e;
  const float* dp = dS + (bi * nc * h + hi) * pn + e;
  bf16* sop = s_pl + (bi * nc * h + hi) * 2 * pn + e;
  bf16* dop = d_pl + (bi * nc * h + hi) * 2 * pn + e;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  float4 carry = ok && init != nullptr ? load4(init + bh * pn + e, cnt, v4)
                                       : zero;
  for (int64_t c0 = 0; c0 < nc; c0 += kPassDepth) {
    float4 mass[kPassDepth];
    float decay[kPassDepth];
#pragma unroll
    for (int k = 0; k < kPassDepth; ++k) {
      const int64_t c = c0 + k;
      mass[k] = ok && c < nc ? load4(sp + c * cstep, cnt, v4) : zero;
      decay[k] = c < nc ? expf(a_last[c * kCS]) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kPassDepth; ++k) {
      const int64_t c = c0 + k;
      if (c >= nc) break;
      if (ok) {
        store4(sp + c * cstep, carry, cnt, v4);
        store_planes(sop + c * 2 * cstep, pn, carry, cnt, v4);
      }
      carry = fma4(decay[k], carry, mass[k]);
    }
  }

  float4 grad = ok && dfin != nullptr ? load4(dfin + bh * pn + e, cnt, v4)
                                      : zero;
  for (int64_t c0 = nc - 1; c0 >= 0; c0 -= kPassDepth) {
    float4 mass[kPassDepth], sin[kPassDepth];
    float decay[kPassDepth], part[kPassDepth];
#pragma unroll
    for (int k = 0; k < kPassDepth; ++k) {
      const int64_t c = c0 - k;
      mass[k] = ok && c >= 0 ? load4(dp + c * cstep, cnt, v4) : zero;
      sin[k] = ok && c >= 0 ? load4(sp + c * cstep, cnt, v4) : zero;
      decay[k] = c >= 0 ? expf(a_last[c * kCS]) : 0.0f;
      part[k] = 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kPassDepth; ++k) {
      const int64_t c = c0 - k;
      if (c < 0) break;
      if (ok) store_planes(dop + c * 2 * cstep, pn, grad, cnt, v4);
      part[k] = grad.x * sin[k].x + grad.y * sin[k].y + grad.z * sin[k].z +
                grad.w * sin[k].w;
      grad = fma4(decay[k], grad, mass[k]);
    }
#pragma unroll
    for (int k = 0; k < kPassDepth; ++k) part[k] = warp_sum(part[k]);
    __syncthreads();                       // red is free
    if (lane == 0)
#pragma unroll
      for (int k = 0; k < kPassDepth; ++k) red[warp * kPassDepth + k] = part[k];
    __syncthreads();
    if (tid < kPassDepth && c0 - tid >= 0) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w * kPassDepth + tid];
      sdot_part[((bi * nc + c0 - tid) * h + hi) * gridDim.x + blockIdx.x] = s;
    }
  }
  if (ok && dinit != nullptr) store4(dinit + bh * pn + e, grad, cnt, v4);
}

// ---------------------------------------------------------------------------
// 3. the chunk's tiles: a block per (side, 64-step tile, chunk, group, batch)
// ---------------------------------------------------------------------------

// Shared memory, in bytes from a 1024-aligned base: the block's own tile of
// the group (C_I on the row side, B_I on the column side), a pair ring of
// the other operand's tiles, and two stages of per-step operands.
struct ChunkSmem {
  static constexpr uint32_t kOwn = 0;
  static constexpr uint32_t kPair = kOwn + kTileB;        // 2 tiles
  static constexpr uint32_t kStage = kPair + 2 * kTileB;
  // a stage: T0 a 64 x 64 bf16 box; T1 two boxes (a second 64 x 64 tile,
  // the hi / lo planes of half a state, or a 64 x 64 float32 tile of C B^T
  // in accumulator order); a and dt of the head's chunk (kCS each)
  static constexpr uint32_t kT0 = 0;
  static constexpr uint32_t kT1 = kBox;
  static constexpr uint32_t kV = kT1 + 2 * kBox;
  static constexpr uint32_t kStageBytes = kV + 8 * kCS;
  // the per-head sums over the tile's rows (sum_s M[t, s] + the y term, or
  // sum_t M[t, s]), when the block's heads fit
  static constexpr uint32_t kSums = kStage + 2 * kStageBytes;
  static constexpr uint32_t kBytes = kSums + 4 * kTile * kSumHeads;
};
static_assert(ChunkSmem::kStageBytes % 1024 == 0, "stages stay aligned");
static_assert(kTile * kTile * 4 == 2 * kBox, "a float32 tile fills T1");

// What every step of a block reads and writes.
struct ChunkArgs {
  const bf16* x;         // (batch, head 0) of step 0 of the chunk: x, dy
  const bf16* dy;
  const bf16* own;       // the block's tile of C (rows) or B (columns)
  const bf16* other;     // step 0 of the chunk's B (rows) or C (columns)
  const float* av;       // the chunk's a and dt rows of head 0
  const float* dtv;
  const bf16* planes;    // S_in (rows) or dS_out (columns) of head 0
  const float* cbt;      // the column side's C B^T tiles, (nt, 4096)
  int64_t xt, hp, bct;   // x's time stride, dy's (h p), B's and C's
  int64_t ost;           // the step stride of dB and dC (g n)
  int64_t head_a;        // a, dt: one head further
  int64_t head_pl;       // the planes: one head further
  int p, n, valid, i0, nh, heads, vec;
  // TMA (when vec): the maps of x, dy, the own and the other operand (B or
  // C) and the planes; the block's coordinates in them; the stages'
  // barriers
  const CUtensorMap *mx, *mdy, *mown, *mother, *mpl;
  int bi, h0, gi, t_base, plane0;
  uint32_t bar;
};

__device__ __forceinline__ void copy_v(char* dst, const float* a,
                                       const float* dt) {
  // kCS floats of a, then of dt: 2 x 64 pieces of 16 bytes
  const int t = threadIdx.x;
  if (t < kCS / 4) cp_async16(dst + 16 * t, a + 4 * t);
  else if (t < kCS / 2) cp_async16(dst + 4 * kCS + 16 * (t - kCS / 4),
                                   dt + 4 * (t - kCS / 4));
}

// a 64-row tile of NB boxes into shared memory: by cp.async when vec, else
// element by element out of line (the steps' code stays small enough for
// the instruction cache)
template <int NB>
__device__ __noinline__ void copy_tile_slow(char* dst, const bf16* src,
                                            int64_t stride, int rows,
                                            int cols) {
  load_swizzled<kTile, NB>(dst, src, stride, rows, cols, false);
}

template <int NB>
__device__ __forceinline__ void copy_tile(char* dst, const bf16* src,
                                          int64_t stride, int rows, int cols,
                                          bool vec) {
  if (vec)
    load_swizzled<kTile, NB>(dst, src, stride, rows, cols, true);
  else
    copy_tile_slow<NB>(dst, src, stride, rows, cols);
}

// a stage's x or dy tile (rows r0.., one box of p) of head hh
__device__ __forceinline__ void copy_rows(char* dst, const bf16* src,
                                          int64_t stride, int r0,
                                          const ChunkArgs& g) {
  copy_tile<1>(dst, src + r0 * stride, stride, min(kTile, g.valid - r0), g.p,
               g.vec);
}

// half hf of a state's hi and lo planes ([p][n]) into T1
__device__ __forceinline__ void copy_planes(char* dst, const bf16* pl, int hf,
                                            const ChunkArgs& g) {
  const int64_t pn = static_cast<int64_t>(g.p) * g.n;
#pragma unroll
  for (int k = 0; k < 2; ++k)
    copy_tile<1>(dst + k * kBox, pl + k * pn + 64 * hf, g.n, g.p,
                 g.n - 64 * hf, g.vec);
}

// exp(x) by the ex2 unit, results below 2^-126 flushed to zero
__device__ __forceinline__ float fexp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// v[i] *= L[t, s] at this thread's entries of a tile pair, times a scale per
// row (rs_a, rs_b) and, with kColDt, dt per column.  The tile's rows are
// steps t (the row side, kRowsT) or s (the column side's transposed tiles),
// its first row step r0 and first column step c0.  L = exp(a_t - a_s) for s
// <= t < valid, zero elsewhere: within a tile directly; below the diagonal
// as exp(a_t - a_r) exp(a_r - a_s) around the s tile's last step r, so that
// a tile pair costs 2 + 16 exponentials a thread.  Branch-free: masked
// entries are selected away.
template <bool kRowsT, bool kColDt>
__device__ __forceinline__ void apply_decay(float (&v)[32], const float* va,
                                            const float* vdt, int r0, int c0,
                                            int ra, int rb, int gc, bool diag,
                                            int valid, float rs_a,
                                            float rs_b) {
  const int sa = r0 + ra, sb = r0 + rb;            // the rows' steps
  const float a_a = va[sa], a_b = va[sb];
  if (diag) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + 8 * j + gc + e;
        const float a_c = va[c], sc = kColDt ? vdt[c] : 1.0f;
        // the later step minus the earlier one
        const float la = fexp(kRowsT ? a_a - a_c : a_c - a_a);
        const float lb = fexp(kRowsT ? a_b - a_c : a_c - a_b);
        const bool ka = kRowsT ? c <= sa && sa < valid : c >= sa && c < valid;
        const bool kb = kRowsT ? c <= sb && sb < valid : c >= sb && c < valid;
        v[4 * j + e] *= ka ? la * sc * rs_a : 0.0f;
        v[4 * j + 2 + e] *= kb ? lb * sc * rs_b : 0.0f;
      }
    return;
  }
  const float a_r = va[(kRowsT ? c0 : r0) + kTile - 1];
  const float fa = kRowsT ? (sa < valid ? fexp(a_a - a_r) * rs_a : 0.0f)
                          : fexp(a_r - a_a) * rs_a;
  const float fb = kRowsT ? (sb < valid ? fexp(a_b - a_r) * rs_b : 0.0f)
                          : fexp(a_r - a_b) * rs_b;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = c0 + 8 * j + gc + e;
      const float sc = kColDt ? vdt[c] : 1.0f;
      const float fc = kRowsT ? fexp(a_r - va[c]) * sc
                              : (c < valid ? fexp(va[c] - a_r) * sc : 0.0f);
      v[4 * j + e] *= fa * fc;
      v[4 * j + 2 + e] *= fb * fc;
    }
}

// a 64-row tile of dB or dC (two halves of n, float32 accumulators) into
// its rows past i0 in B's dtype; rows past the sequence are not written
__device__ __forceinline__ void store_tile(bf16* __restrict__ out,
                                           const float (&v)[2][32],
                                           const ChunkArgs& g, int ra, int rb,
                                           int gc) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (hf >= g.nh) break;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * hf + 8 * j + gc;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = g.i0 + (half ? rb : ra);
        if (t >= g.valid) continue;
        bf16* o = out + t * g.ost + col;
        const float v0 = v[hf][4 * j + 2 * half];
        const float v1 = v[hf][4 * j + 2 * half + 1];
        if (g.n % 2 == 0 && col + 1 < g.n) {
          *reinterpret_cast<uint32_t*>(o) = bits(__float2bfloat16_rn(v0),
                                                 __float2bfloat16_rn(v1));
        } else {
          if (col < g.n) o[0] = __float2bfloat16_rn(v0);
          if (col + 1 < g.n) o[1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// Per-head sums over a tile's rows, accumulated by the thread that owns the
// row: in shared memory when the block's heads fit, else in their plane.
struct HeadSums {
  float* at;             // row 0 of head 0
  int64_t head;          // one head further
  bool on_chip;
  __device__ __forceinline__ float& operator()(int hh, int r) const {
    return at[hh * head + r];
  }
  // the sums into their plane (rows past the sequence are not written)
  __device__ __forceinline__ void flush(float* plane_at, int64_t plane_head,
                                        int heads, int valid_rows) const {
    if (!on_chip) return;
    __syncthreads();
    for (int idx = threadIdx.x; idx < heads * kTile; idx += kChunkThreads) {
      const int hh = idx / kTile, r = idx % kTile;
      if (r < valid_rows) plane_at[hh * plane_head + r] = at[idx];
    }
  }
};

__device__ __forceinline__ HeadSums head_sums(char* smem, float* plane_at,
                                              const ChunkArgs& g) {
  const bool on_chip = g.heads <= kSumHeads;
  return {on_chip ? reinterpret_cast<float*>(smem + ChunkSmem::kSums)
                  : plane_at,
          on_chip ? kTile : g.head_a, on_chip};
}

// dsum (a pair's masks summed over the heads) times the pair's tile of B or
// C (K its 64 steps, N the halves of n), added to the block's float32 tile
// in device memory, in accumulator order (first: stored): the pairs' sum
// stays out of the head loop's registers.
__device__ __forceinline__ void pair_product(float (&dsum)[32], uint32_t pair,
                                             const ChunkArgs& g,
                                             float* __restrict__ part,
                                             bool first) {
  uint32_t ph[4][4], pl[4][4];
  split_frags(dsum, ph, pl);
  float acc[2][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[0][i] = acc[1][i] = dsum[i] = 0.0f;
  reg_fence(acc[0]);
  reg_fence(acc[1]);
  wg_fence();
  mma_split_rs(acc[0], ph, pl, pair);
  if (g.nh > 1) mma_split_rs(acc[1], ph, pl, pair + kBox);
  wg_commit_wait();
  reg_fence(acc[0]);
  reg_fence(acc[1]);
  float4* o = reinterpret_cast<float4*>(part) + threadIdx.x;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (hf >= g.nh) break;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      float4 v = make_float4(acc[hf][4 * q], acc[hf][4 * q + 1],
                             acc[hf][4 * q + 2], acc[hf][4 * q + 3]);
      float4* at = o + (8 * hf + q) * kChunkThreads;
      if (!first) {
        const float4 w = *at;
        v = make_float4(v.x + w.x, v.y + w.y, v.z + w.z, v.w + w.w);
      }
      *at = v;
    }
  }
}

// A block's steps run through two stages: the operands of step k + 1 are on
// their way (cp.async) while step k computes.
__device__ __forceinline__ int step_begin(const ChunkArgs& g, int k) {
  if (g.vec) {                           // TMA: the stage's barrier
    hopper::bar_wait(g.bar + 8 * (k % 2), (k / 2) & 1);
  } else {
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();
  }
  return k % 2;
}

// the TMA loads of a step (thread 0): x or dy rows r0.. of head hh, a tile
// of B or C (both boxes of n), the hi and lo planes of half hf of a state
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* m,
                                         const ChunkArgs& g, int hh, int r0,
                                         uint32_t bar) {
  hopper::tma_load_4d(dst, m, bar, 0, g.h0 + hh, g.t_base + r0, g.bi);
}

__device__ __forceinline__ void tma_bc(uint32_t dst, const CUtensorMap* m,
                                       const ChunkArgs& g, int r0,
                                       uint32_t bar) {
#pragma unroll
  for (int q = 0; q < 2; ++q)
    hopper::tma_load_4d(dst + q * kBox, m, bar, 64 * q, g.gi,
                        g.t_base + r0, g.bi);
}

__device__ __forceinline__ void tma_planes(uint32_t dst, const ChunkArgs& g,
                                           int hh, int hf, uint32_t bar) {
#pragma unroll
  for (int q = 0; q < 2; ++q)
    hopper::tma_load_3d(dst + q * kBox, g.mpl, bar, 64 * hf, 0,
                        g.plane0 + 2 * hh + q);
}

__device__ __forceinline__ void tma_v(uint32_t dst, const ChunkArgs& g,
                                      int hh, uint32_t bar) {
  hopper::bulk_load(dst, g.av + hh * g.head_a, 4 * kCS, bar);
  hopper::bulk_load(dst + 4 * kCS, g.dtv + hh * g.head_a, 4 * kCS, bar);
}

// ---- the row side: dC of the tile's rows, and sum_s M[t, s] + y_s terms --
//
// Steps: for each column tile J <= I, for each head: dy_I x_J^T (with B_J at
// the pair's first head); then for each head, for each half of n: dy_I S_in.

__device__ __noinline__ void issue_rows_async(const ChunkArgs& g, char* smem,
                                              int nJ, int k);

__device__ __forceinline__ void issue_rows(const ChunkArgs& g, char* smem,
                                           uint32_t base, int nJ, int k) {
  using S = ChunkSmem;
  const int H = g.heads;
  if (!g.vec) {
    issue_rows_async(g, smem, nJ, k);
    return;
  }
  if (threadIdx.x == 0) {                // TMA, from one thread
    const uint32_t sa = base + S::kStage + (k % 2) * S::kStageBytes;
    const uint32_t bar = g.bar + 8 * (k % 2);
    const bool first = k < nJ * H;
    const int J = first ? k / H : 0;
    const int hh = first ? k - J * H : (k - nJ * H) / g.nh;
    const int hf = first ? 0 : k - nJ * H - hh * g.nh;
    hopper::bar_arrive_tx(
        bar, (first ? 2 : 3) * kBox + 8 * kCS + (k == 0 ? kTileB : 0) +
                 (first && hh == 0 ? kTileB : 0));
    if (k == 0) tma_bc(base + S::kOwn, g.mown, g, g.i0, bar);
    if (first) {
      tma_rows(sa + S::kT1, g.mx, g, hh, J * kTile, bar);
      if (hh == 0)
        tma_bc(base + S::kPair + (J % 2) * kTileB, g.mother, g, J * kTile,
               bar);
    } else {
      tma_planes(sa + S::kT1, g, hh, hf, bar);
    }
    tma_rows(sa + S::kT0, g.mdy, g, hh, g.i0, bar);
    tma_v(sa + S::kV, g, hh, bar);
  }
}

// the same loads by cp.async, element by element where a row is not whole
// 16-byte runs
__device__ __noinline__ void issue_rows_async(const ChunkArgs& g, char* smem,
                                              int nJ, int k) {
  using S = ChunkSmem;
  char* st = smem + S::kStage + (k % 2) * S::kStageBytes;
  const int H = g.heads;
  if (k == 0)
    copy_tile<2>(smem + S::kOwn, g.own, g.bct, min(kTile, g.valid - g.i0),
                 g.n, g.vec);
  int hh;
  if (k < nJ * H) {
    const int J = k / H;
    hh = k - J * H;
    copy_rows(st + S::kT1, g.x + hh * g.p, g.xt, J * kTile, g);
    if (hh == 0)
      copy_tile<2>(smem + S::kPair + (J % 2) * kTileB,
                   g.other + J * kTile * g.bct, g.bct,
                   min(kTile, g.valid - J * kTile), g.n, g.vec);
  } else {
    const int k2 = k - nJ * H;
    hh = k2 / g.nh;
    copy_planes(st + S::kT1, g.planes + hh * g.head_pl, k2 - hh * g.nh, g);
  }
  copy_rows(st + S::kT0, g.dy + hh * g.p, g.hp, g.i0, g);
  copy_v(st + S::kV, g.av + hh * g.head_a, g.dtv + hh * g.head_a);
}

__device__ __forceinline__ void step_end_rows(const ChunkArgs& g, char* smem,
                                              uint32_t base, int nJ, int k,
                                              int K) {
  __syncthreads();
  if (k + 2 < K) issue_rows(g, smem, base, nJ, k + 2);
  cp_async_commit();
}

__device__ __forceinline__ void chunk_rows(const ChunkArgs& g, char* smem,
                                           uint32_t base, int it,
                                           bf16* __restrict__ dC,
                                           float* __restrict__ rq,
                                           float* __restrict__ part) {
  using S = ChunkSmem;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, gc = 2 * (lane % 4);
  const int ra = 16 * warp + gr, rb = ra + 8;       // this thread's rows
  const int ta = g.i0 + ra, tb = g.i0 + rb;         // their steps
  const int H = g.heads, nJ = it + 1;
  const int K = nJ * H + H * g.nh;
  const HeadSums sums = head_sums(smem, rq + g.i0, g);
  issue_rows(g, smem, base, nJ, 0);
  cp_async_commit();
  if (K > 1) issue_rows(g, smem, base, nJ, 1);
  cp_async_commit();

  float cb[32], dsum[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dsum[i] = 0.0f;
  const uint32_t own = base + S::kOwn;
  int k = 0;
  for (int J = 0; J < nJ; ++J) {
    const uint32_t pair = base + S::kPair + (J % 2) * kTileB;
    for (int hh = 0; hh < H; ++hh, ++k) {
      const int sb = step_begin(g, k);
      const char* st = smem + S::kStage + sb * S::kStageBytes;
      const uint32_t sa = base + S::kStage + sb * S::kStageBytes;
      const float* va = reinterpret_cast<const float*>(st + S::kV);
      const float* vdt = va + kCS;
      float t[32];
      wg_fence();
      if (hh == 0) mma_k128(cb, own, pair);        // C_I B_J^T, once
      mma_k64(t, sa + S::kT0, sa + S::kT1, false); // dy_I x_J^T
      wg_commit_wait();
      reg_fence(cb);
      reg_fence(t);
      // dCB = L dt_s (dy_t . x_s)
      apply_decay<true, true>(t, va, vdt, g.i0, J * kTile, ra, rb, gc,
                              J == it, g.valid, 1.0f, 1.0f);
      float rsa = 0.0f, rsb = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          rsa += cb[4 * j + e] * t[4 * j + e];
          rsb += cb[4 * j + 2 + e] * t[4 * j + 2 + e];
        }
#pragma unroll
      for (int i = 0; i < 32; ++i) dsum[i] += t[i];
      rsa = quad_sum(rsa);
      rsb = quad_sum(rsb);
      if (lane % 4 == 0) {
        float &oa = sums(hh, ra), &ob = sums(hh, rb);
        if (ta < g.valid) oa = J == 0 ? rsa : oa + rsa;
        if (tb < g.valid) ob = J == 0 ? rsb : ob + rsb;
      }
      if (hh == H - 1)                   // dC += (sum over heads) B_J
        pair_product(dsum, pair, g, part, J == 0);
      step_end_rows(g, smem, base, nJ, k, K);
    }
  }
  // the carried state: dC_t += exp(a_t) S_in^T dy_t, y's d a term
  float dc[2][32];
  {
    const float4* o = reinterpret_cast<const float4*>(part) + tid;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float4 v = hf < g.nh ? o[(8 * hf + q) * kChunkThreads]
                                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        dc[hf][4 * q] = v.x;
        dc[hf][4 * q + 1] = v.y;
        dc[hf][4 * q + 2] = v.z;
        dc[hf][4 * q + 3] = v.w;
      }
  }
  const char* ownp = smem + S::kOwn;
  for (int hh = 0; hh < H; ++hh) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (hf >= g.nh) break;
      const int sb = step_begin(g, k);
      const char* st = smem + S::kStage + sb * S::kStageBytes;
      const uint32_t sa = base + S::kStage + sb * S::kStageBytes;
      const float* va = reinterpret_cast<const float*>(st + S::kV);
      float t[32];
      wg_fence();
#pragma unroll
      for (int pl = 0; pl < 2; ++pl)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wg_mma_st(t, desc(sa + S::kT0 + kk * 32, 16, 1024),
                    desc(sa + S::kT1 + pl * kBox + kk * 2048, kBox, 1024),
                    pl + kk > 0);
      wg_commit_wait();
      reg_fence(t);
      const float ea = ta < g.valid ? expf(va[ta]) : 0.0f;
      const float eb = tb < g.valid ? expf(va[tb]) : 0.0f;
      float ya = 0.0f, yb = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * hf + 8 * j + gc;
        const float2 ca = tile_pair(ownp, ra, col);
        const float2 cc = tile_pair(ownp, rb, col);
        const float v0 = ea * t[4 * j], v1 = ea * t[4 * j + 1];
        const float v2 = eb * t[4 * j + 2], v3 = eb * t[4 * j + 3];
        dc[hf][4 * j] += v0;
        dc[hf][4 * j + 1] += v1;
        dc[hf][4 * j + 2] += v2;
        dc[hf][4 * j + 3] += v3;
        ya += v0 * ca.x + v1 * ca.y;
        yb += v2 * cc.x + v3 * cc.y;
      }
      ya = quad_sum(ya);
      yb = quad_sum(yb);
      if (lane % 4 == 0) {
        if (ta < g.valid) sums(hh, ra) += ya;
        if (tb < g.valid) sums(hh, rb) += yb;
      }
      step_end_rows(g, smem, base, nJ, k, K);
      ++k;
    }
  }
  sums.flush(rq + g.i0, g.head_a, H, g.valid - g.i0);
  store_tile(dC, dc, g, ra, rb, gc);   // in B's dtype
}

// ---- the column side: dB and dx of the tile's columns, their d a terms ---
//
// Steps: for each row tile J >= I, for each head: x_I dy_J^T (with C_J at
// the pair's first head); then for each head: for each half of n, x_I and
// dS_out's half; for each J >= I, dy_J and the kept C B^T tile.

__device__ __noinline__ void issue_cols_async(const ChunkArgs& g, char* smem,
                                              int it, int nJ, int k);

__device__ __forceinline__ void issue_cols(const ChunkArgs& g, char* smem,
                                           uint32_t base, int it, int nJ,
                                           int k) {
  using S = ChunkSmem;
  const int H = g.heads, per = g.nh + nJ;
  if (!g.vec) {
    issue_cols_async(g, smem, it, nJ, k);
    return;
  }
  if (threadIdx.x == 0) {                // TMA, from one thread
    const uint32_t sa = base + S::kStage + (k % 2) * S::kStageBytes;
    const uint32_t bar = g.bar + 8 * (k % 2);
    uint32_t bytes = kBox + 8 * kCS + (k == 0 ? kTileB : 0);
    int hh, kind, J;                     // kind 0: x dy^T, 1: state, 2: dx
    if (k < nJ * H) {
      const int jj = k / H;
      hh = k - jj * H;
      J = it + jj;
      kind = 0;
      bytes += kBox + (hh == 0 ? kTileB : 0);
    } else {
      const int k2 = k - nJ * H;
      hh = k2 / per;
      const int m = k2 - hh * per;
      kind = m < g.nh ? 1 : 2;
      J = kind == 1 ? m : it + m - g.nh;   // the half of n, or J
      bytes += 2 * kBox;
    }
    hopper::bar_arrive_tx(bar, bytes);
    if (k == 0) tma_bc(base + S::kOwn, g.mown, g, g.i0, bar);
    if (kind == 0) {
      tma_rows(sa + S::kT0, g.mx, g, hh, g.i0, bar);
      tma_rows(sa + S::kT1, g.mdy, g, hh, J * kTile, bar);
      if (hh == 0)
        tma_bc(base + S::kPair + ((J - it) % 2) * kTileB, g.mother, g,
               J * kTile, bar);
    } else if (kind == 1) {
      tma_rows(sa + S::kT0, g.mx, g, hh, g.i0, bar);
      tma_planes(sa + S::kT1, g, hh, J, bar);
    } else {
      tma_rows(sa + S::kT0, g.mdy, g, hh, J * kTile, bar);
      hopper::bulk_load(sa + S::kT1, g.cbt + J * (kTile * kTile),
                        4 * kTile * kTile, bar);
    }
    tma_v(sa + S::kV, g, hh, bar);
  }
}

// the same loads by cp.async, element by element where a row is not whole
// 16-byte runs
__device__ __noinline__ void issue_cols_async(const ChunkArgs& g, char* smem,
                                              int it, int nJ, int k) {
  using S = ChunkSmem;
  char* st = smem + S::kStage + (k % 2) * S::kStageBytes;
  const int H = g.heads, per = g.nh + nJ;
  if (k == 0)
    copy_tile<2>(smem + S::kOwn, g.own, g.bct, min(kTile, g.valid - g.i0),
                 g.n, g.vec);
  int hh;
  if (k < nJ * H) {
    const int jj = k / H, J = it + jj;
    hh = k - jj * H;
    copy_rows(st + S::kT0, g.x + hh * g.p, g.xt, g.i0, g);
    copy_rows(st + S::kT1, g.dy + hh * g.p, g.hp, J * kTile, g);
    if (hh == 0)
      copy_tile<2>(smem + S::kPair + (jj % 2) * kTileB,
                   g.other + J * kTile * g.bct, g.bct,
                   min(kTile, g.valid - J * kTile), g.n, g.vec);
  } else {
    const int k2 = k - nJ * H;
    hh = k2 / per;
    const int m = k2 - hh * per;
    if (m < g.nh) {
      copy_rows(st + S::kT0, g.x + hh * g.p, g.xt, g.i0, g);
      copy_planes(st + S::kT1, g.planes + hh * g.head_pl, m, g);
    } else {
      const int J = it + m - g.nh;
      copy_rows(st + S::kT0, g.dy + hh * g.p, g.hp, J * kTile, g);
      const float* src = g.cbt + J * (kTile * kTile);
      const int tid = threadIdx.x;
#pragma unroll
      for (int r4 = 0; r4 < 8; ++r4)
        cp_async16(st + S::kT1 + 16 * (r4 * kChunkThreads + tid),
                   src + 4 * (r4 * kChunkThreads + tid));
    }
  }
  copy_v(st + S::kV, g.av + hh * g.head_a, g.dtv + hh * g.head_a);
}

__device__ __forceinline__ void step_end_cols(const ChunkArgs& g, char* smem,
                                              uint32_t base, int it, int nJ,
                                              int k, int K) {
  __syncthreads();
  if (k + 2 < K) issue_cols(g, smem, base, it, nJ, k + 2);
  cp_async_commit();
}

__device__ __forceinline__ void chunk_cols(const ChunkArgs& g, char* smem,
                                           uint32_t base, int it,
                                           bf16* __restrict__ dB,
                                           bf16* __restrict__ dx,
                                           float* __restrict__ rq,
                                           int64_t plane, float* cbt_out,
                                           float* __restrict__ part) {
  using S = ChunkSmem;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, gc = 2 * (lane % 4);
  const int ra = 16 * warp + gr, rb = ra + 8;       // this thread's rows
  const int ua = g.i0 + ra, ub = g.i0 + rb;         // their steps s
  const int H = g.heads;
  const int nJ = (g.valid - 1) / kTile - it + 1;    // row tiles J >= I
  const int K = nJ * H + H * (g.nh + nJ);
  float* c_rq = rq + 3 * plane;             // sum_t M[t, s]
  float* q_rq = rq + plane;                 // q
  float* x_rq = rq + 2 * plane;             // x . dxdt
  const HeadSums sums = head_sums(smem, c_rq + g.i0, g);
  issue_cols(g, smem, base, it, nJ, 0);
  cp_async_commit();
  if (K > 1) issue_cols(g, smem, base, it, nJ, 1);
  cp_async_commit();

  float cbt[32], dsum[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dsum[i] = 0.0f;
  const uint32_t own = base + S::kOwn;
  const char* ownp = smem + S::kOwn;
  int k = 0;
  // ---- x_I dy_J^T: dB's masks summed over the heads, sum_t M[t, s] ----
  for (int jj = 0; jj < nJ; ++jj) {
    const int J = it + jj;
    const uint32_t pair = base + S::kPair + (jj % 2) * kTileB;
    for (int hh = 0; hh < H; ++hh, ++k) {
      const int sb = step_begin(g, k);
      const char* st = smem + S::kStage + sb * S::kStageBytes;
      const uint32_t sa = base + S::kStage + sb * S::kStageBytes;
      const float* va = reinterpret_cast<const float*>(st + S::kV);
      const float* vdt = va + kCS;
      float t[32];
      wg_fence();
      if (hh == 0) mma_k128(cbt, own, pair);       // B_I C_J^T, once
      mma_k64(t, sa + S::kT0, sa + S::kT1, false); // x_I dy_J^T
      wg_commit_wait();
      reg_fence(cbt);
      reg_fence(t);
      if (hh == 0) {      // kept for the dx steps, in accumulator order
        float4* o = reinterpret_cast<float4*>(cbt_out + J * (kTile * kTile));
#pragma unroll
        for (int r4 = 0; r4 < 8; ++r4)
          o[r4 * kChunkThreads + tid] =
              make_float4(cbt[4 * r4], cbt[4 * r4 + 1], cbt[4 * r4 + 2],
                          cbt[4 * r4 + 3]);
        // read back by this thread's cp.async, or by a TMA bulk copy
        asm volatile("fence.proxy.async.global;" ::: "memory");
      }
      // dCB^T = L dt_s (x_s . dy_t)
      apply_decay<false, false>(t, va, vdt, g.i0, J * kTile, ra, rb, gc,
                                jj == 0, g.valid, vdt[ua], vdt[ub]);
      float csa = 0.0f, csb = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          csa += cbt[4 * j + e] * t[4 * j + e];
          csb += cbt[4 * j + 2 + e] * t[4 * j + 2 + e];
        }
#pragma unroll
      for (int i = 0; i < 32; ++i) dsum[i] += t[i];
      csa = quad_sum(csa);
      csb = quad_sum(csb);
      if (lane % 4 == 0) {
        float &oa = sums(hh, ra), &ob = sums(hh, rb);
        if (ua < g.valid) oa = jj == 0 ? csa : oa + csa;
        if (ub < g.valid) ob = jj == 0 ? csb : ob + csb;
      }
      if (hh == H - 1)                   // dB += (sum over heads) C_J
        pair_product(dsum, pair, g, part, jj == 0);
      step_end_cols(g, smem, base, it, nJ, k, K);
    }
  }
  // dB waits in the pair ring (free from here on), in accumulator order
  float* dbs = reinterpret_cast<float*>(smem + S::kPair);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int i = 0; i < 32; ++i)
      dbs[(32 * hf + i) * kChunkThreads + tid] =
          hf < g.nh ? part[((8 * hf + i / 4) * kChunkThreads + tid) * 4 + i % 4]
                    : 0.0f;

  // ---- per head: the carried state's terms, then dxdt over J >= I ----
  for (int hh = 0; hh < H; ++hh) {
    float dxdt[32];
    float qa = 0.0f, qb = 0.0f, ws_a = 0.0f, ws_b = 0.0f;
    uint32_t xa[8], xb[8];              // x_I at this thread's entries
#pragma unroll
    for (int i = 0; i < 32; ++i) dxdt[i] = 0.0f;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (hf >= g.nh) break;
      const int sb = step_begin(g, k);
      const char* st = smem + S::kStage + sb * S::kStageBytes;
      const uint32_t sa = base + S::kStage + sb * S::kStageBytes;
      const float* va = reinterpret_cast<const float*>(st + S::kV);
      const float* vdt = va + kCS;
      float u[32];
      reg_fence(dxdt);
      wg_fence();
#pragma unroll
      for (int pl = 0; pl < 2; ++pl)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t plb = sa + S::kT1 + pl * kBox;
          // x_I dS_out[:, half]: dS_out's rows are K
          wg_mma_st(u, desc(sa + S::kT0 + kk * 32, 16, 1024),
                    desc(plb + kk * 2048, kBox, 1024), pl + kk > 0);
          // B_I[:, half] dS_out[:, half]^T: dS_out's columns are K
          wg_mma_ss(dxdt, desc(own + hf * kBox + kk * 32, 16, 1024),
                    desc(plb + kk * 32, 16, 1024), 1);
        }
      wg_commit_wait();
      reg_fence(u);
      reg_fence(dxdt);
      const float a_last = va[kCS - 1];
      ws_a = ua < g.valid ? expf(a_last - va[ua]) : 0.0f;
      ws_b = ub < g.valid ? expf(a_last - va[ub]) : 0.0f;
      const float wa = ws_a * vdt[ua], wb = ws_b * vdt[ub];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * hf + 8 * j + gc;
        const float2 ba = tile_pair(ownp, ra, col);
        const float2 bb = tile_pair(ownp, rb, col);
        const float u0 = wa * u[4 * j], u1 = wa * u[4 * j + 1];
        const float u2 = wb * u[4 * j + 2], u3 = wb * u[4 * j + 3];
        float* o = dbs + (32 * hf + 4 * j) * kChunkThreads + tid;
        o[0] += u0;
        o[kChunkThreads] += u1;
        o[2 * kChunkThreads] += u2;
        o[3 * kChunkThreads] += u3;
        qa += u0 * ba.x + u1 * ba.y;
        qb += u2 * bb.x + u3 * bb.y;
      }
      if (hf == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          xa[j] = *reinterpret_cast<const uint32_t*>(
              &st[S::kT0 + ra * 128 + ((j ^ (ra % 8)) << 4) + gc * 2]);
          xb[j] = *reinterpret_cast<const uint32_t*>(
              &st[S::kT0 + rb * 128 + ((j ^ (rb % 8)) << 4) + gc * 2]);
        }
      }
      step_end_cols(g, smem, base, it, nJ, k, K);
      ++k;
    }
    // dxdt = w_s dS_out B_s, then the intra-chunk terms; q
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      dxdt[4 * j] *= ws_a;
      dxdt[4 * j + 1] *= ws_a;
      dxdt[4 * j + 2] *= ws_b;
      dxdt[4 * j + 3] *= ws_b;
    }
    qa = quad_sum(qa);
    qb = quad_sum(qb);
    if (lane % 4 == 0) {
      float* o = q_rq + hh * g.head_a;
      if (ua < g.valid) o[ua] = qa;
      if (ub < g.valid) o[ub] = qb;
    }
    for (int jj = 0; jj < nJ; ++jj, ++k) {
      const int J = it + jj;
      const int sb = step_begin(g, k);
      const char* st = smem + S::kStage + sb * S::kStageBytes;
      const uint32_t sa = base + S::kStage + sb * S::kStageBytes;
      const float* va = reinterpret_cast<const float*>(st + S::kV);
      const float4* cin = reinterpret_cast<const float4*>(st + S::kT1);
      float pv[32];
#pragma unroll
      for (int r4 = 0; r4 < 8; ++r4) {
        const float4 v = cin[r4 * kChunkThreads + tid];
        pv[4 * r4] = v.x;
        pv[4 * r4 + 1] = v.y;
        pv[4 * r4 + 2] = v.z;
        pv[4 * r4 + 3] = v.w;
      }
      apply_decay<false, false>(pv, va, va, g.i0, J * kTile, ra, rb, gc,
                                jj == 0, g.valid, 1.0f, 1.0f);   // P^T
      uint32_t ph[4][4], pl[4][4];
      split_frags(pv, ph, pl);
      reg_fence(dxdt);
      wg_fence();
      mma_split_rs(dxdt, ph, pl, sa + S::kT0);    // dy_J: its rows are K
      wg_commit_wait();
      reg_fence(dxdt);
      step_end_cols(g, smem, base, it, nJ, k, K);
    }
    // dx = dt dxdt in x's dtype; x . dxdt
    const float* dth = g.dtv + hh * g.head_a;
    const float dta = ua < g.valid ? dth[ua] : 0.0f;
    const float dtb = ub < g.valid ? dth[ub] : 0.0f;
    float xsa = 0.0f, xsb = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + gc;
      __nv_bfloat162 pa, pb;
      memcpy(&pa, &xa[j], 4);
      memcpy(&pb, &xb[j], 4);
      const float2 fxa = __bfloat1622float2(pa), fxb = __bfloat1622float2(pb);
      xsa += fxa.x * dxdt[4 * j] + fxa.y * dxdt[4 * j + 1];
      xsb += fxb.x * dxdt[4 * j + 2] + fxb.y * dxdt[4 * j + 3];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int s = half ? ub : ua;
        if (s >= g.valid) continue;
        const float d = half ? dtb : dta;
        bf16* o = dx + s * g.hp + hh * g.p + col;
        const float v0 = d * dxdt[4 * j + 2 * half];
        const float v1 = d * dxdt[4 * j + 2 * half + 1];
        if (g.p % 2 == 0 && col + 1 < g.p) {
          *reinterpret_cast<uint32_t*>(o) = bits(__float2bfloat16_rn(v0),
                                                 __float2bfloat16_rn(v1));
        } else {
          if (col < g.p) o[0] = __float2bfloat16_rn(v0);
          if (col + 1 < g.p) o[1] = __float2bfloat16_rn(v1);
        }
      }
    }
    xsa = quad_sum(xsa);
    xsb = quad_sum(xsb);
    if (lane % 4 == 0) {
      float* o = x_rq + hh * g.head_a;
      if (ua < g.valid) o[ua] = xsa;
      if (ub < g.valid) o[ub] = xsb;
    }
  }
  sums.flush(c_rq + g.i0, g.head_a, H, g.valid - g.i0);
  float db[2][32];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int i = 0; i < 32; ++i)
      db[hf][i] = dbs[(32 * hf + i) * kChunkThreads + tid];
  store_tile(dB, db, g, ra, rb, gc);   // in B's dtype
}

__global__ void __launch_bounds__(kChunkThreads, 2)
bwd_chunk_bf16_kernel(const __grid_constant__ CUtensorMap mx,
                      const __grid_constant__ CUtensorMap mdy,
                      const __grid_constant__ CUtensorMap mb,
                      const __grid_constant__ CUtensorMap mc,
                      const __grid_constant__ CUtensorMap msp,
                      const __grid_constant__ CUtensorMap mdp,
                      const bf16* __restrict__ x, const bf16* __restrict__ B,
                      const bf16* __restrict__ C, const bf16* __restrict__ dy,
                      const float* __restrict__ acum,
                      const float* __restrict__ dtc,
                      const bf16* __restrict__ s_pl,
                      const bf16* __restrict__ d_pl, float* __restrict__ cbt,
                      float* __restrict__ acc, bf16* __restrict__ dx,
                      bf16* __restrict__ dB, bf16* __restrict__ dC,
                      float* __restrict__ rqx,
                      int64_t l, int64_t h, int64_t g, int p, int n, int cs,
                      int nt, uint32_t order, Strides sd, int vec) {
  extern __shared__ __align__(1024) char smem_raw[];
  const uint32_t raw_addr = smem_addr(smem_raw);
  const uint32_t base = (raw_addr + 1023) & ~1023u;   // the swizzle's
  char* smem = smem_raw + (base - raw_addr);           // alignment
  // the grid's slowest index ranks the (side, tile) pairs by their steps,
  // the heaviest first, so that the lightest blocks fill the last wave:
  // rank z is pair order >> 4 z (4 bits: tile q of the column side, or
  // tile q - nt of the row side)
  const int64_t nc = (l + cs - 1) / cs;
  const int64_t c = blockIdx.x % nc, bi = blockIdx.x / nc, gi = blockIdx.y;
  const int q = static_cast<int>(order >> (4 * blockIdx.z)) & 15;
  const bool rows = q >= nt;
  const int it = rows ? q - nt : q;
  const int64_t hg = h / g, h0 = gi * hg;
  const int64_t t_base = c * cs;
  const int valid = static_cast<int>(l - t_base < cs ? l - t_base : cs);
  const int i0 = it * kTile;
  if (i0 >= valid) return;             // a tile past the sequence
  const int64_t pn = static_cast<int64_t>(p) * n;
  const bf16* Bc = B + bi * sd.bcb + t_base * sd.bct + gi * n;
  const bf16* Cc = C + bi * sd.bcb + t_base * sd.bct + gi * n;
  float* cache =
      cbt + (((bi * g + gi) * nc + c) * nt + it) * nt * kTile * kTile;
  // the block's arguments, in shared memory for the out-of-line loads
  __shared__ ChunkArgs a;
  __shared__ __align__(8) uint64_t bars[2];   // the stages' (TMA)
  if (threadIdx.x == 0) {
    a.mx = &mx;
    a.mdy = &mdy;
    a.mown = rows ? &mc : &mb;
    a.mother = rows ? &mb : &mc;
    a.mpl = rows ? &msp : &mdp;
    a.bi = static_cast<int>(bi);
    a.h0 = static_cast<int>(h0);
    a.gi = static_cast<int>(gi);
    a.t_base = static_cast<int>(t_base);
    a.plane0 = static_cast<int>(((bi * nc + c) * h + h0) * 2);
    a.bar = smem_addr(bars);
    hopper::bar_init(a.bar, 1);
    hopper::bar_init(a.bar + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    a.x = x + bi * sd.xb + t_base * sd.xt + h0 * p;
    a.dy = dy + (bi * l + t_base) * h * p + h0 * p;
    a.own = (rows ? Cc : Bc) + i0 * sd.bct;
    a.other = rows ? Bc : Cc;
    a.av = acum + ((bi * h + h0) * nc + c) * kCS;
    a.dtv = dtc + ((bi * h + h0) * nc + c) * kCS;
    a.planes = (rows ? s_pl : d_pl) + ((bi * nc + c) * h + h0) * 2 * pn;
    a.cbt = cache;
    a.xt = sd.xt;
    a.hp = h * p;
    a.bct = sd.bct;
    a.ost = g * n;
    a.head_a = nc * kCS;
    a.head_pl = 2 * pn;
    a.p = p;
    a.n = n;
    a.valid = valid;
    a.i0 = i0;
    a.nh = (n + 63) / 64;
    a.heads = static_cast<int>(hg);
    a.vec = vec;
  }
  __syncthreads();
  float* rq = rqx + ((bi * h + h0) * nc + c) * kCS;
  const int64_t plane = static_cast<int64_t>(gridDim.x) * h * kCS;  // b nc
  bf16* out = (rows ? dC : dB) + ((bi * l + t_base) * g + gi) * n;
  // the block's float32 tile of dB or dC over its pairs
  float* part = acc + ((((bi * g + gi) * nc + c) * 2 + rows) * nt + it) *
                          (kTile * kN);
  if (rows)
    chunk_rows(a, smem, base, it, out, rq, part);
  else
    chunk_cols(a, smem, base, it, out, dx + (bi * l + t_base) * h * p + h0 * p,
               rq, plane, cache, part);
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

bool f32_state_smem[kMaxDevices], f32_chunk_smem[kMaxDevices];
bool mass_smem[kMaxDevices], chunk_smem[kMaxDevices];

int run_backward_f32(int device, const float* x, const float* dt,
                     const float* A, const float* B, const float* C,
                     const float* init, const float* dy, const float* dfin,
                     float* dx, float* ddt, float* dA, float* dB, float* dC,
                     float* dinit, float* acum, float* S, float* dS,
                     float* sdot, float* rqx, float* dBh, float* dCh,
                     float* dA_part, int64_t b, int64_t l, int64_t h,
                     int64_t g, int64_t p, int64_t n, int64_t cs, Strides sd,
                     cudaStream_t stream) {
  cudaError_t err = allow_smem(bwd_chunk_state_kernel, device,
                               kStateSmem, f32_state_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(bwd_chunk_kernel, device, kChunkSmem,
                   f32_chunk_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t nc = (l + cs - 1) / cs, pn = p * n;
  const int ntiles = static_cast<int>((cs + kT - 1) / kT);
  const int nblk = static_cast<int>((pn + kThreads - 1) / kThreads);
  const unsigned ub = static_cast<unsigned>(b), uh = static_cast<unsigned>(h);
  const int ip = static_cast<int>(p), in = static_cast<int>(n);
  const int ics = static_cast<int>(cs);

  bwd_chunk_state_kernel<<<dim3(static_cast<unsigned>(nc), uh, ub),
                                  kThreads, kStateSmem, stream>>>(
      x, dt, A, B, C, dy, acum, S, dS, l, h, g, ip, in, ics, sd);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bwd_state_pass_kernel<<<dim3(static_cast<unsigned>(nblk), uh, ub), kThreads,
                          0, stream>>>(acum, init, dfin, S, dS, sdot, dinit,
                                       nc, h, pn, ics);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bwd_chunk_kernel<<<dim3(static_cast<unsigned>(nc * ntiles), uh, ub),
                            kThreads, kChunkSmem, stream>>>(
      x, dt, B, C, dy, acum, S, dS, dx, dBh, dCh, rqx, l, h, g, ip, in, ics,
      ntiles, sd);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bwd_dt_kernel<<<dim3(static_cast<unsigned>(nc), uh, ub), kThreads, 0,
                  stream>>>(rqx, nullptr, sdot, acum, dt, A, ddt, dA_part, l,
                            h, ics, cs, nblk);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int64_t total = b * l * g * n;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  bwd_group_sum_kernel<<<static_cast<unsigned>(blocks < 65535 * 8
                                                          ? blocks
                                                          : 65535 * 8),
                                kThreads, 0, stream>>>(dBh, dCh, dB, dC,
                                                       total, h, g, in);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bwd_dA_kernel<<<uh, kThreads, 0, stream>>>(dA_part, dA, b * nc, h);
  return static_cast<int>(cudaGetLastError());
}

// a bf16 (b, l, k, m) tensor, each step's k rows of m packed, as the 4-D
// map (m, k, l, b) (element strides 1, m, time, batch), read in boxes of 64
// columns x 64 steps of one row k: a swizzled tile's box
CUresult tensor_map4(hopper::EncodeTiled encode, CUtensorMap* map,
                     const void* ptr, int64_t m, int64_t k, int64_t l,
                     int64_t b, int64_t row, int64_t step, int64_t batch) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(m),
                              static_cast<cuuint64_t>(k),
                              static_cast<cuuint64_t>(l),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(2 * row),
                                 static_cast<cuuint64_t>(2 * step),
                                 static_cast<cuuint64_t>(2 * batch)};
  const cuuint32_t box[4] = {64, 1, kTile, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, one,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// the split states (count, p, n) bf16 as the 3-D map (n, p, count), read in
// boxes of 64 columns x 64 rows
CUresult planes_map(hopper::EncodeTiled encode, CUtensorMap* map,
                    const void* ptr, int64_t p, int64_t n, int64_t count) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(p),
                              static_cast<cuuint64_t>(count)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(2 * n),
                                 static_cast<cuuint64_t>(2 * p * n)};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, one,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

int run_backward_bf16(int device, const bf16* x, const float* dt,
                      const float* A, const bf16* B, const bf16* C,
                      const float* init, const bf16* dy, const float* dfin,
                      bf16* dx, float* ddt, float* dA, bf16* dB, bf16* dC,
                      float* dinit, float* acum, float* dtc, float* S,
                      float* dS, bf16* s_pl, bf16* d_pl, float* cbt,
                      float* acc, float* sdot, float* rqx, float* dA_part,
                      int64_t b,
                      int64_t l, int64_t h, int64_t g, int64_t p, int64_t n,
                      int64_t cs, Strides sd, int vec, cudaStream_t stream) {
  const int mass_bytes = static_cast<int>(MassSmem::kBytes) + 1024;  // to
  const int chunk_bytes = static_cast<int>(ChunkSmem::kBytes) + 1024;  // align
  cudaError_t err = allow_smem(bwd_mass_bf16_kernel, device, mass_bytes,
                               mass_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(bwd_chunk_bf16_kernel, device, chunk_bytes, chunk_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t nc = (l + cs - 1) / cs, pn = p * n;
  const int nt = static_cast<int>((cs + kTile - 1) / kTile);
  const int64_t per_block = 4 * kWideThreads;
  const int nblk = static_cast<int>((pn + per_block - 1) / per_block);
  const unsigned ub = static_cast<unsigned>(b), uh = static_cast<unsigned>(h);
  const int ip = static_cast<int>(p), in = static_cast<int>(n);
  const int ics = static_cast<int>(cs);

  bwd_mass_bf16_kernel<<<dim3(static_cast<unsigned>(nc), uh, ub),
                         kWideThreads, mass_bytes, stream>>>(
      x, dt, A, B, C, dy, acum, dtc, S, dS, l, h, g, ip, in, ics, sd, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bwd_pass_bf16_kernel<<<dim3(static_cast<unsigned>(nblk), uh, ub),
                         kWideThreads, 0, stream>>>(
      acum, init, dfin, S, dS, s_pl, d_pl, sdot, dinit, nc, h, pn);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // the chunk kernel's (side, tile) pairs by their steps a head, heaviest
  // first: the column side of tile q takes 2 (nt - q) + nh, the row side
  // q + 1 + nh (nh halves of n); ties to the column side, the lower tile
  const int nh = static_cast<int>((n + 63) / 64);
  int rank[8], count = 0;
  for (int w = 2 * nt + 2 * nh; w > 0; --w)
    for (int q = 0; q < 2 * nt; ++q)
      if ((q < nt ? 2 * (nt - q) + nh : q - nt + 1 + nh) == w)
        rank[count++] = q;
  uint32_t order = 0;
  for (int r = 0; r < 2 * nt; ++r)
    order |= static_cast<uint32_t>(rank[r]) << (4 * r);
  // TMA maps where the tiles' rows are whole 16-byte runs (vec)
  CUtensorMap maps[6] = {};
  if (vec) {
    const hopper::EncodeTiled encode = hopper::encode_tiled();
    if (encode == nullptr)
      return static_cast<int>(cudaErrorSharedObjectInitFailed);
    CUresult res = tensor_map4(encode, &maps[0], x, p, h, l, b, p, sd.xt,
                               sd.xb);
    if (res == CUDA_SUCCESS)
      res = tensor_map4(encode, &maps[1], dy, p, h, l, b, p, h * p,
                        l * h * p);
    if (res == CUDA_SUCCESS)
      res = tensor_map4(encode, &maps[2], B, n, g, l, b, n, sd.bct, sd.bcb);
    if (res == CUDA_SUCCESS)
      res = tensor_map4(encode, &maps[3], C, n, g, l, b, n, sd.bct, sd.bcb);
    if (res == CUDA_SUCCESS)
      res = planes_map(encode, &maps[4], s_pl, p, n, b * nc * h * 2);
    if (res == CUDA_SUCCESS)
      res = planes_map(encode, &maps[5], d_pl, p, n, b * nc * h * 2);
    if (res != CUDA_SUCCESS) return -static_cast<int>(res);
  }
  bwd_chunk_bf16_kernel<<<dim3(static_cast<unsigned>(nc * b),
                               static_cast<unsigned>(g),
                               static_cast<unsigned>(2 * nt)),
                          kChunkThreads, chunk_bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], x, B, C, dy,
      acum, dtc, s_pl, d_pl, cbt, acc, dx, dB, dC, rqx, l, h, g, ip, in, ics,
      nt, order, sd, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int64_t plane = b * h * nc * kCS;
  bwd_dt_kernel<<<dim3(static_cast<unsigned>(nc), uh, ub), kThreads, 0,
                  stream>>>(rqx, rqx + 3 * plane, sdot, acum, dt, A, ddt,
                            dA_part, l, h, ics, kCS, nblk);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bwd_dA_kernel<<<uh, kThreads, 0, stream>>>(dA_part, dA, b * nc, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entries: the caller guarantees b, l, h > 0, h % g == 0, p <= 64,
// n <= 128, 0 < cs <= 256, b, g and h < 65,536; x, B and C laid out as
// Strides says (xb, xt, bcb, bct), dy contiguous (b, l, h, p) in x's dtype;
// init, dfin, dinit null or (b, h, p, n) float32 (16-byte aligned).
//
// float32 x, B, C, dy, dx, dB, dC.  Scratch, float32: acum (b, h, nc * cs);
// S and dS (b, nc, h, p, n); sdot (b, nc, h, ceil(p n / 256)); rqx (3, b, h,
// nc * cs); dBh and dCh (b, l, h, n); dA_part (b, nc, h).
extern "C" int ssd_scan_bwd_f32(int device, const void* x, const void* dt,
                                const void* A, const void* B, const void* C,
                                const void* init, const void* dy,
                                const void* dfin, void* dx, void* ddt,
                                void* dA, void* dB, void* dC, void* dinit,
                                void* acum, void* S, void* dS, void* sdot,
                                void* rqx, void* dBh, void* dCh,
                                void* dA_part, int64_t b, int64_t l,
                                int64_t h, int64_t g, int64_t p, int64_t n,
                                int64_t cs, int64_t xb, int64_t xt,
                                int64_t bcb, int64_t bct, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto f = [](const void* v) { return static_cast<const float*>(v); };
  auto w = [](void* v) { return static_cast<float*>(v); };
  return run_backward_f32(
      device, f(x), f(dt), f(A), f(B), f(C), f(init), f(dy), f(dfin), w(dx),
      w(ddt), w(dA), w(dB), w(dC), w(dinit), w(acum), w(S), w(dS), w(sdot),
      w(rqx), w(dBh), w(dCh), w(dA_part), b, l, h, g, p, n, cs,
      Strides{xb, xt, bcb, bct}, static_cast<cudaStream_t>(stream));
}

// bfloat16 x, B, C, dy, dx, dB, dC; nc = ceil(l / cs) with b nc < 2^31.
// Scratch: acum and dtc (b, h, nc, 256) float32; S and dS (b, nc, h, p, n)
// float32; s_pl and d_pl (b, nc, h, 2, p, n) bf16;
// cbt (b, g, nc, nt, nt, 64 * 64) float32 with nt = ceil(cs / 64); acc (b,
// g, nc, 2, nt, 64 * 128) float32; sdot (b, nc, h, ceil(p n / 1024)); rqx
// (4, b, h, nc, 256); dA_part (b, nc, h).
// vec says that p, n and the strides are multiples of 8 and x, B, C, dy and
// the scratch 16-byte aligned.
extern "C" int ssd_scan_bwd_bf16(int device, const void* x, const void* dt,
                                 const void* A, const void* B, const void* C,
                                 const void* init, const void* dy,
                                 const void* dfin, void* dx, void* ddt,
                                 void* dA, void* dB, void* dC, void* dinit,
                                 void* acum, void* dtc, void* S, void* dS,
                                 void* s_pl, void* d_pl, void* cbt,
                                 void* acc, void* sdot, void* rqx,
                                 void* dA_part, int64_t b, int64_t l,
                                 int64_t h, int64_t g,
                                 int64_t p, int64_t n, int64_t cs, int64_t xb,
                                 int64_t xt, int64_t bcb, int64_t bct,
                                 int vec, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto h16 = [](const void* v) { return static_cast<const bf16*>(v); };
  auto f = [](const void* v) { return static_cast<const float*>(v); };
  auto w = [](void* v) { return static_cast<float*>(v); };
  auto w16 = [](void* v) { return static_cast<bf16*>(v); };
  return run_backward_bf16(
      device, h16(x), f(dt), f(A), h16(B), h16(C), f(init), h16(dy), f(dfin),
      w16(dx), w(ddt), w(dA), w16(dB), w16(dC), w(dinit), w(acum), w(dtc),
      w(S), w(dS), w16(s_pl), w16(d_pl), w(cbt), w(acc), w(sdot), w(rqx),
      w(dA_part), b, l, h, g, p, n, cs, Strides{xb, xt, bcb, bct}, vec,
      static_cast<cudaStream_t>(stream));
}

// Per bfloat16 kernel (mass, pass, chunk), five ints: registers a thread,
// local (spilled) bytes a thread, static and dynamic shared memory a block,
// and blocks a multiprocessor at the launch's block size, as the runtime
// reports them.
extern "C" int ssd_scan_bwd_bf16_attrs(int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int mass_bytes = static_cast<int>(MassSmem::kBytes) + 1024;
  const int chunk_bytes = static_cast<int>(ChunkSmem::kBytes) + 1024;
  if ((err = allow_smem(bwd_mass_bf16_kernel, device, mass_bytes,
                        mass_smem)) != cudaSuccess ||
      (err = allow_smem(bwd_chunk_bf16_kernel, device, chunk_bytes,
                        chunk_smem)) != cudaSuccess)
    return static_cast<int>(err);
  const void* fns[3] = {reinterpret_cast<const void*>(bwd_mass_bf16_kernel),
                        reinterpret_cast<const void*>(bwd_pass_bf16_kernel),
                        reinterpret_cast<const void*>(bwd_chunk_bf16_kernel)};
  const int threads[3] = {kWideThreads, kWideThreads, kChunkThreads};
  const int dynamic[3] = {mass_bytes, 0, chunk_bytes};
  for (int k = 0; k < 3; ++k) {
    cudaFuncAttributes a;
    if ((err = cudaFuncGetAttributes(&a, fns[k])) != cudaSuccess)
      return static_cast<int>(err);
    int blocks = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &blocks, fns[k], threads[k], dynamic[k])) != cudaSuccess)
      return static_cast<int>(err);
    const int v[5] = {a.numRegs, static_cast<int>(a.localSizeBytes),
                      static_cast<int>(a.sharedSizeBytes), dynamic[k],
                      blocks};
    for (int q = 0; q < 5; ++q) out[5 * k + q] = v[q];
  }
  return 0;
}
