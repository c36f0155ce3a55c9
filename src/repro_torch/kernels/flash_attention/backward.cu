// flash_attention backward: dq, dk and dv of the masked GQA attention that
// kernel.cu computes, written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no backward kernel of its own.
// Its train step differentiates the jnp core
// src/repro/models/attention.py:41 (attention_core, chunked and banded) with
// jax.value_and_grad; ref.py's attention_bwd is this kernel's plain version.
//
// Contract.  kernel.cu's: q (b, sq, kvh, G, dh), k (b, skv, kvh, dh), v (b,
// skv, kvh, dv), all float32 or all bfloat16, contiguous; q_pos (sq,) and
// k_pos (skv,) int32; the window and the softcap.  Also the forward's output
// o (b, sq, kvh, G, dv) in q's dtype, its row log-sum-exp lse (b, kvh, G, sq)
// float32 (+inf on a row with no key) and the cotangent do in q's dtype.
// Writes dq, dk, dv in q's dtype.
//
// The gradient, in float32 (scale = 1 / sqrt(dh)):
//   s = scale q.k, capped: s = cap tanh(s / cap);  P = exp(s - lse) on the
//   pairs the mask keeps, else 0;  dP = do.v;  D = rowsum(do o)
//   dS = P (dP - D) (1 - tanh^2 where capped) scale
//   dq = dS k;  dk = sum over the G heads of dS^T q;  dv = sum of P^T do
// A row with no key has lse = +inf, so its P, dS and gradients are 0.
//
// What bounds it on this card: operations.  Each (query, key) pair the mask
// keeps costs 3 dh + 2 dv multiply-adds (S, dP, dq, dk, dv), so
// RecurrentGemma-9B's train call (2 x 4,096 queries x 16 heads, d 256, window
// 2,048: 2.0e8 pairs) does 5.2e11 flops, 0.52 ms at the bf16 tensor-core
// rate.
//
// Two entries, chosen by dtype; neither falls back to the other.  Both first
// take D = rowsum(do o) in a pre-pass (flash_bwd_dot_kernel, one warp a
// row), use no float atomics and sum in a fixed order, so the bits repeat
// run to run.  In bfloat16, o is the forward's bf16 output plus the rounding
// residual the forward wrote beside it for training (out_lo, required): from
// the bf16 output alone, D's 2^-9 relative error enters dS = P (dP - D)
// where dP and D nearly cancel, and at MusicGen-medium's train call (4 x
// 4,096, 24 heads of d 64, causal, the last of 48 layers) the gradients
// missed the 1e-2 max|plain| gate (1.19e-2 on an H100 80GB HBM3 at 700 W).
//
// bfloat16 (flash_attention_bwd_bf16): every product on wgmma, bf16 in and
// float32 accumulated, in three or four more launches.  Run as the float32
// entry runs, this dtype would sit on the float32 pipes, one block an SM
// with too few dk / dv blocks, mask every band edge tile element by element
// and load its tiles with nothing in flight; each part below answers one of
// those.
//  * Products.  S^T = K Q^T and dP^T = V dO^T (S and dP in the dQ kernel)
//    take the bf16 inputs as they are, both operands in 128-byte swizzled
//    shared memory as TMA writes them; their products are exact in float32.
//    P = exp(s - lse) and dS = P (dP - D) (1 - tanh^2) scale are formed in
//    float32 in registers and rounded to bf16 as the A operand, from
//    registers, of dV += P^T dO, dK += dS^T Q and dQ += dS K.  The dK / dV
//    kernel forms the transposed tiles directly, so P^T and dS^T lie in the
//    accumulator layout that feeds the next product, and Q and dO are read
//    as MN-major B operands through the transpose bit: no tile is transposed
//    through memory.
//  * K / V stay, Q / dO stream (flash_bwd_kv_wgmma_kernel).  One block per
//    (batch, kv head, 64-key tile, slice of the G heads) keeps its K and V
//    tiles in shared memory; a producer warp streams each (query tile, head)
//    step's Q and dO tiles by TMA, with the rows' positions, lse and D,
//    through a two-stage ring (at d 256: K + V 64 KB, two stages 128 KB) and
//    gives its registers to the consumers (setmaxnreg).  dK and dV for 64
//    keys x 256 columns would be 256 floats a thread in one warpgroup, so two
//    consumer warpgroups share the keys: the first forms P^T from S^T and
//    holds dV, the second forms dP^T and dS^T and holds dK (128 floats a
//    thread each).  The first hands P scale (1 - tanh^2) to the second in
//    float32 through 16 KB of shared memory, under two named barriers (ready,
//    free).  Each warpgroup runs two of the four products a step.
//  * dQ without atomics (flash_bwd_q_wgmma_kernel).  One block per (batch,
//    query head, 128 query rows): two consumer warpgroups of 64 rows keep
//    their Q and dO tiles and accumulate dQ in registers; the producer
//    streams each key tile's V and then its K by TMA into separate slots
//    (V's frees after dP, K's after dQ += dS K; at d 256 one slot each, as Q
//    and dO take 128 KB), so dP runs while K arrives.  S and dP are computed
//    again: 7 products where the gradient needs 5.
//  * The band's tiles are classified like the forward's: each producer
//    decides 32 tiles at once, one a lane, from their positions; a tile with
//    no kept pair is skipped, a tile whose every pair is kept (and holds no
//    slot past sq or skv) takes no per-element mask, only the others are
//    masked.
//  * Filling the card.  The G heads of a kv head are split into slices so
//    that the dK / dV grid covers the SMs about four times (RecurrentGemma-
//    9B's train call: 128 key tiles x 4 slices of 4 heads; one slice, 128
//    blocks, took 1.24 ms there, three 0.92, four 0.84); each slice writes
//    its partial dk and dv in float32 and flash_bwd_sum_kernel adds them in
//    slice order and rounds them to bf16.  The partials lie in dq's bytes,
//    which the dQ launch overwrites afterwards (one slice where they would
//    not fit: then the block writes dk and dv itself).  The dK / dV blocks
//    of the first key tiles, which a causal band gives the most query
//    tiles, launch first; the dQ kernel launches its last query tiles
//    first.
//  Rounding: P and dS are rounded to bf16 (2^-9 relative) for the three
//  products that take them, and D is read from the forward's bf16 output:
//  each output lies within 1e-2 max|plain| + 2^-6 |plain| of ref.py's
//  float32 attention_bwd, the bfloat16 gate of the float32-pipe design
//  before it (tests/test_torch_flash_bwd_bf16.py emulates this arithmetic
//  on the CPU).  dh and dv are multiples of 16 up to
//  256; the kernels are built for d = 64, 128 and 256, the smallest that
//  holds both, and a column past dh or dv arrives as zeros.
//  What holds it back now (an H100 at the train call, 1.7-1.8 ms a call,
//  about 30% of the bound): dK / dV 0.84 ms, about half the tensor cores'
//  rate for its four products, and dQ 0.69 ms for three.  The 64 x 64
//  products with both operands in shared memory read 128 bytes a clock, all
//  an SM's shared memory gives; each warpgroup waits for its products
//  before its elementwise work, with only the other warpgroup to fill the
//  gap; and dQ computes S and dP a second time.  A double-buffered P
//  handoff, and K in two slots with the dQ warpgroups taking turns to
//  issue, each moved the call by 3% or less and were left out.
//
// float32 (flash_attention_bwd_f32): the float32 pipes, since TF32 tensor
// cores would not hold float32's tolerance (1e-4 max|plain| + 1e-3 |plain|).
// Two launches after D: a dK / dV kernel, one block per (batch, kv head,
// 32-key tile), walking the query tiles that the window's band can reach
// (the forward's tile skip, from the positions) and within each the G query
// heads in order, accumulating the tile's dk and dv in registers; a dQ
// kernel, one block per (batch, query head, 32-row tile), walking the band's
// key tiles.  Both recompute P from the forward's lse.  Every product runs
// on the float32 pipes from tiles staged in shared memory as float32, rows
// padded by 4 floats so that a quarter-warp's float4 reads of 8 rows hit
// distinct banks; each thread owns 4 rows x 8 columns of an accumulator
// (columns 4 lane + 128 h + e), so its reads of a row are float4 and
// broadcast or conflict-free.  At dh = dv = 256 a block stages four 32-row
// tiles (133 KB).  The float32 pipes (67 TFLOPS) cap it near 7.7 ms at the
// train call's shape.
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../hopper.cuh"
#include "../wgmma.cuh"

namespace {

constexpr int kThreads = 256;     // 8 warps
constexpr int kBQ = 32;           // query rows a tile: 4 a warp
constexpr int kBK = 32;           // keys a tile: one a lane

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

__device__ __forceinline__ int warp_min_i(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ int warp_max_i(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ bool sees(int kp, int qp, int64_t window) {
  return kp <= qp &&
         (window < 0 || static_cast<int64_t>(kp) >
                            static_cast<int64_t>(qp) - window);
}

// a row length in floats: d rounded up to 4, plus 4 of padding
__host__ __device__ __forceinline__ int row_ld(int d) {
  return (d + 3) / 4 * 4 + 4;
}

// rows [r0, r0 + 32) of one head of a (batch, seq, heads, d) tensor into
// shared memory as float32 rows of ``ld`` (zeros past ``n`` rows and d
// columns).  ``base``: the head's first element; ``stride``: elements
// between positions.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* base,
                                      int64_t stride, int64_t r0, int64_t n,
                                      int d) {
  for (int idx = threadIdx.x; idx < 32 * ld; idx += kThreads) {
    const int r = idx / ld, col = idx % ld;
    dst[idx] = (r0 + r < n && col < d)
                   ? to_f(base[(r0 + r) * stride + col]) : 0.0f;
  }
}

// the (min, max) of positions [p0, p0 + 32) below n, over a warp; (INT_MAX,
// INT_MIN) where none
__device__ __forceinline__ int2 pos_range(const int* pos, int64_t p0,
                                          int64_t n) {
  const int lane = threadIdx.x % 32;
  const bool ok = p0 + lane < n;
  const int p = ok ? pos[p0 + lane] : 0;
  return make_int2(warp_min_i(ok ? p : INT_MAX), warp_max_i(ok ? p : INT_MIN));
}

// whether a key tile with positions in k and a query tile in q can share a
// pair: the forward's tile skip
__device__ __forceinline__ bool may(int2 k, int2 q, int64_t window) {
  bool m = k.x <= q.y && q.x <= q.y;
  if (window >= 0)
    m = m && static_cast<int64_t>(k.y) > static_cast<int64_t>(q.x) - window;
  return m;
}

// Shared tiles of one (query tile, key tile) step: Q (kBQ x ldk), dO (kBQ x
// ldv), K (kBK x ldk), V (kBK x ldv); the query rows' positions, lse and D;
// the keys' positions (INT_MAX past skv: never seen).
struct Tiles {
  float *q, *dout, *k, *v;
  int *qp, *kp;
  float *lse, *dsum;
};

// One warp's 4 query rows (4 warp + 0..3) against the lane's key: P and
// dS (scale folded in) of each pair, 0 off the mask.
__device__ __forceinline__ void scores(const Tiles& s, int ldk, int ldv,
                                       int dh, int dv, int64_t window,
                                       float cap, float scale, float (&p)[4],
                                       float (&ds)[4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float sc[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const float* krow = s.k + lane * ldk;
  for (int d = 0; d < dh; d += 4) {
    const float4 k4 = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 q4 =
          *reinterpret_cast<const float4*>(s.q + (4 * warp + i) * ldk + d);
      sc[i] += q4.x * k4.x + q4.y * k4.y + q4.z * k4.z + q4.w * k4.w;
    }
  }
  const float* vrow = s.v + lane * ldv;
  for (int c = 0; c < dv; c += 4) {
    const float4 v4 = *reinterpret_cast<const float4*>(vrow + c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 o4 = *reinterpret_cast<const float4*>(
          s.dout + (4 * warp + i) * ldv + c);
      dp[i] += o4.x * v4.x + o4.y * v4.y + o4.z * v4.z + o4.w * v4.w;
    }
  }
  const int kp = s.kp[lane];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * warp + i;
    float x = sc[i] * scale, dcap = 1.0f;
    if (cap > 0.0f) {
      const float t = tanhf(x / cap);
      x = t * cap;
      dcap = 1.0f - t * t;
    }
    p[i] = sees(kp, s.qp[r], window) ? expf(x - s.lse[r]) : 0.0f;
    ds[i] = p[i] * (dp[i] - s.dsum[r]) * dcap * scale;
  }
}

// D = rowsum(do o) for every (batch, query, head) row, one warp a row
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dot_kernel(const T* __restrict__ out, const T* __restrict__ out_lo,
                     const T* __restrict__ dout, float* __restrict__ dsum,
                     int64_t rows, int64_t sq, int64_t heads, int dv) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) +
                      threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const T* o = out + row * dv;
  const T* d = dout + row * dv;
  float acc = 0.0f;
  if (out_lo != nullptr) {  // bfloat16: o + its residual, float32's o
    const T* lo = out_lo + row * dv;
    for (int c = lane; c < dv; c += 32)
      acc += (to_f(o[c]) + to_f(lo[c])) * to_f(d[c]);
  } else {
    for (int c = lane; c < dv; c += 32) acc += to_f(o[c]) * to_f(d[c]);
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  // row = (bi sq + qi) heads + hh  ->  dsum[(bi heads + hh) sq + qi]
  const int64_t hh = row % heads, bq = row / heads;
  const int64_t qi = bq % sq, bi = bq / sq;
  if (lane == 0) dsum[(bi * heads + hh) * sq + qi] = acc;
}

// The tiles' float offsets in dynamic shared memory
struct Layout {
  int ldk, ldv, q, dout, k, v, extra, bytes;
  __host__ __device__ Layout(int dh, int dv, int extra_floats) {
    ldk = row_ld(dh);
    ldv = row_ld(dv);
    q = 0;
    dout = q + kBQ * ldk;
    k = dout + kBQ * ldv;
    v = k + kBK * ldk;
    extra = v + kBK * ldv;
    // + the rows' positions, lse, D and the keys' positions
    bytes = 4 * (extra + extra_floats + 3 * kBQ + kBK);
  }
};

// dk, dv of one (batch, kv head, 32-key tile)
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ q_pos,
                      const int* __restrict__ k_pos,
                      const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dsum, T* __restrict__ dk,
                      T* __restrict__ dv_out, int64_t sq, int64_t skv,
                      int64_t kvh, int64_t G, int dh, int dv, int64_t window,
                      float cap, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout L(dh, dv, 2 * kBQ * kBK);
  float* ps = smem + L.extra;                 // P, [query][key]
  float* dss = ps + kBQ * kBK;                // dS, [query][key]
  Tiles s{smem + L.q, smem + L.dout, smem + L.k, smem + L.v,
          reinterpret_cast<int*>(dss + kBQ * kBK), nullptr, nullptr,
          nullptr};
  s.lse = reinterpret_cast<float*>(s.qp + kBQ);
  s.dsum = s.lse + kBQ;
  s.kp = reinterpret_cast<int*>(s.dsum + kBQ);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * kBK;
  const int64_t kh = blockIdx.y % kvh, bi = blockIdx.y / kvh;
  const int64_t hq = kvh * G;                 // query heads
  stage(s.k, L.ldk, k + (bi * skv * kvh + kh) * dh, kvh * dh, k0, skv, dh);
  stage(s.v, L.ldv, v + (bi * skv * kvh + kh) * dv, kvh * dv, k0, skv, dv);
  if (warp == 0)
    s.kp[lane] = k0 + lane < skv ? k_pos[k0 + lane] : INT_MAX;
  int2 kr = pos_range(k_pos, k0, skv);        // every warp: its own copy

  // this thread's accumulators: key rows 4 warp + r, columns 4 lane + 128 h
  // + e
  float acc_k[4][8], acc_v[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc_k[r][e] = acc_v[r][e] = 0.0f;

  const int64_t n_qt = (sq + kBQ - 1) / kBQ;
  for (int64_t qt = 0; qt < n_qt; ++qt) {
    const int64_t q0 = qt * kBQ;
    if (!may(kr, pos_range(q_pos, q0, sq), window)) continue;
    for (int64_t g = 0; g < G; ++g) {
      const int64_t head = (bi * kvh + kh) * G + g;   // lse / D row block
      __syncthreads();                    // the previous step is consumed
      stage(s.q, L.ldk, q + (bi * sq * hq + kh * G + g) * dh, hq * dh, q0,
            sq, dh);
      stage(s.dout, L.ldv, dout + (bi * sq * hq + kh * G + g) * dv, hq * dv,
            q0, sq, dv);
      if (warp == 0) {
        const bool ok = q0 + lane < sq;
        s.qp[lane] = ok ? q_pos[q0 + lane] : INT_MIN;
        s.lse[lane] = ok ? lse[head * sq + q0 + lane] : INFINITY;
        s.dsum[lane] = ok ? dsum[head * sq + q0 + lane] : 0.0f;
      }
      __syncthreads();
      float p[4], ds[4];
      scores(s, L.ldk, L.ldv, dh, dv, window, cap, scale, p, ds);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ps[(4 * warp + i) * kBK + lane] = p[i];
        dss[(4 * warp + i) * kBK + lane] = ds[i];
      }
      __syncthreads();
      for (int i = 0; i < kBQ; ++i) {
        const float4 p4 = *reinterpret_cast<const float4*>(ps + i * kBK +
                                                           4 * warp);
        const float4 d4 = *reinterpret_cast<const float4*>(dss + i * kBK +
                                                           4 * warp);
        const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
        const float dr[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 4 * lane + 128 * h;
          if (c < dv) {
            const float4 o4 = *reinterpret_cast<const float4*>(
                s.dout + i * L.ldv + c);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              acc_v[r][4 * h + 0] += pr[r] * o4.x;
              acc_v[r][4 * h + 1] += pr[r] * o4.y;
              acc_v[r][4 * h + 2] += pr[r] * o4.z;
              acc_v[r][4 * h + 3] += pr[r] * o4.w;
            }
          }
          if (c < dh) {
            const float4 q4 = *reinterpret_cast<const float4*>(
                s.q + i * L.ldk + c);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              acc_k[r][4 * h + 0] += dr[r] * q4.x;
              acc_k[r][4 * h + 1] += dr[r] * q4.y;
              acc_k[r][4 * h + 2] += dr[r] * q4.z;
              acc_k[r][4 * h + 3] += dr[r] * q4.w;
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t kj = k0 + 4 * warp + r;
    if (kj >= skv) continue;
    T* krow = dk + ((bi * skv + kj) * kvh + kh) * dh;
    T* vrow = dv_out + ((bi * skv + kj) * kvh + kh) * dv;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * lane + 128 * h + e;
        if (c < dh) krow[c] = from_f<T>(acc_k[r][4 * h + e]);
        if (c < dv) vrow[c] = from_f<T>(acc_v[r][4 * h + e]);
      }
  }
}

// dq of one (batch, query head, 32-row tile)
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ q_pos,
                    const int* __restrict__ k_pos,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum, T* __restrict__ dq,
                    int64_t sq, int64_t skv, int64_t kvh, int64_t G, int dh,
                    int dv, int64_t window, float cap, float scale) {
  constexpr int kLdT = kBQ + 4;               // dS^T rows, padded
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout L(dh, dv, kBK * kLdT);
  float* dst = smem + L.extra;                // dS^T, [key][query]
  Tiles s{smem + L.q, smem + L.dout, smem + L.k, smem + L.v,
          reinterpret_cast<int*>(dst + kBK * kLdT), nullptr, nullptr,
          nullptr};
  s.lse = reinterpret_cast<float*>(s.qp + kBQ);
  s.dsum = s.lse + kBQ;
  s.kp = reinterpret_cast<int*>(s.dsum + kBQ);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kBQ;
  const int64_t head = blockIdx.y;            // over b * kvh * G
  const int64_t hh = head % (kvh * G), bi = head / (kvh * G);
  const int64_t kh = hh / G;
  const int64_t hq = kvh * G;
  stage(s.q, L.ldk, q + (bi * sq * hq + hh) * dh, hq * dh, q0, sq, dh);
  stage(s.dout, L.ldv, dout + (bi * sq * hq + hh) * dv, hq * dv, q0, sq, dv);
  if (warp == 0) {
    const bool ok = q0 + lane < sq;
    s.qp[lane] = ok ? q_pos[q0 + lane] : INT_MIN;
    s.lse[lane] = ok ? lse[head * sq + q0 + lane] : INFINITY;
    s.dsum[lane] = ok ? dsum[head * sq + q0 + lane] : 0.0f;
  }
  const int2 qr = pos_range(q_pos, q0, sq);

  // query rows 4 warp + r, columns 4 lane + 128 h + e
  float acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.0f;

  const int64_t n_kt = (skv + kBK - 1) / kBK;
  for (int64_t kt = 0; kt < n_kt; ++kt) {
    const int64_t k0 = kt * kBK;
    if (!may(pos_range(k_pos, k0, skv), qr, window)) continue;
    __syncthreads();                      // the previous tile is consumed
    stage(s.k, L.ldk, k + (bi * skv * kvh + kh) * dh, kvh * dh, k0, skv, dh);
    stage(s.v, L.ldv, v + (bi * skv * kvh + kh) * dv, kvh * dv, k0, skv, dv);
    if (warp == 0)
      s.kp[lane] = k0 + lane < skv ? k_pos[k0 + lane] : INT_MAX;
    __syncthreads();
    float p[4], ds[4];
    scores(s, L.ldk, L.ldv, dh, dv, window, cap, scale, p, ds);
    *reinterpret_cast<float4*>(dst + lane * kLdT + 4 * warp) =
        make_float4(ds[0], ds[1], ds[2], ds[3]);
    __syncthreads();
    for (int j = 0; j < kBK; ++j) {
      const float4 d4 =
          *reinterpret_cast<const float4*>(dst + j * kLdT + 4 * warp);
      const float dr[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 4 * lane + 128 * h;
        if (c < dh) {
          const float4 k4 =
              *reinterpret_cast<const float4*>(s.k + j * L.ldk + c);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            acc[r][4 * h + 0] += dr[r] * k4.x;
            acc[r][4 * h + 1] += dr[r] * k4.y;
            acc[r][4 * h + 2] += dr[r] * k4.z;
            acc[r][4 * h + 3] += dr[r] * k4.w;
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t qi = q0 + 4 * warp + r;
    if (qi >= sq) continue;
    T* row = dq + (bi * sq * hq + qi * hq + hh) * dh;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * lane + 128 * h + e;
        if (c < dh) row[c] = from_f<T>(acc[r][4 * h + e]);
      }
  }
}

// D = rowsum(do o) into dsum (o + out_lo in bfloat16, null in float32)
template <typename T>
cudaError_t launch_dot(const void* out, const void* out_lo, const void* dout,
                       void* dsum, int64_t b, int64_t sq, int64_t heads,
                       int64_t dvd, cudaStream_t st) {
  const int64_t rows = b * sq * heads;
  flash_bwd_dot_kernel<T><<<static_cast<unsigned>(
                                (rows + kThreads / 32 - 1) / (kThreads / 32)),
                            kThreads, 0, st>>>(
      static_cast<const T*>(out), static_cast<const T*>(out_lo),
      static_cast<const T*>(dout), static_cast<float*>(dsum), rows, sq, heads,
      static_cast<int>(dvd));
  return cudaGetLastError();
}

template <typename T>
int launch(int device, const void* q, const void* k, const void* v,
           const void* q_pos, const void* k_pos, const void* out,
           const void* lse, const void* dout, void* dq, void* dk, void* dv,
           void* dsum, int64_t b, int64_t sq, int64_t skv, int64_t kvh,
           int64_t G, int64_t dh, int64_t dvd, int64_t window, double cap,
           double scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = launch_dot<T>(out, nullptr, dout, dsum, b, sq, kvh * G, dvd, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int idh = static_cast<int>(dh), idv = static_cast<int>(dvd);
  const float fcap = static_cast<float>(cap), fscale =
                                                   static_cast<float>(scale);
  const int smem_kv = Layout(idh, idv, 2 * kBQ * kBK).bytes;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv(static_cast<unsigned>((skv + kBK - 1) / kBK),
                     static_cast<unsigned>(b * kvh));
  flash_bwd_dkdv_kernel<T><<<grid_kv, kThreads, smem_kv, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(k_pos), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<T*>(dk), static_cast<T*>(dv), sq, skv, kvh, G, idh, idv,
      window, fcap, fscale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int smem_q = Layout(idh, idv, kBK * (kBQ + 4)).bytes;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q(static_cast<unsigned>((sq + kBQ - 1) / kBQ),
                    static_cast<unsigned>(b * kvh * G));
  flash_bwd_dq_kernel<T><<<grid_q, kThreads, smem_q, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(k_pos), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<T*>(dq), sq, skv, kvh, G, idh, idv, window, fcap, fscale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16: every product on wgmma, tiles fed by TMA
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;
using bf16 = __nv_bfloat16;
using wgmma::desc;
using wgmma::pack_bf16;
using wgmma::reg_fence;
using wgmma::wg_commit;
using wgmma::wg_commit_wait;
using wgmma::wg_fence;
using wgmma::wg_mma_rs;
using wgmma::wg_mma_ss;
using wgmma::wg_wait;

constexpr int kTile = 64;         // keys of a dK / dV block, query rows a step
constexpr int kBox = 64;          // bf16 columns of one 128-byte swizzled box
constexpr uint32_t kBoxBytes = kTile * 128;   // one box of a 64-row tile
constexpr int kQRows = 128;       // query rows of a dQ block: two warpgroups
constexpr int kConsumers = 256;   // warpgroups 0, 1 consume; 2 produces
constexpr int kTcThreads = kConsumers + 128;
constexpr int kStages = 2;        // (Q, dO) stages of the dK / dV ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSentinel = INT_MAX;          // a key slot past skv
// a step's flag: its tile needs the per-element mask, is wholly kept, or
// marks the end of the block's tiles
constexpr int kMasked = 0, kWhole = 1, kEnd = 2;
// the dK / dV kernel's named barriers between its two consumer warpgroups
constexpr int kPReady = 1, kPFree = 2;

// dK / dV kernel's shared memory, bytes from a 1024-aligned base: the K and
// V tiles (64 rows x D, boxes of 64 columns), then per stage Q and dO, the
// handed-over P (float32, 64 x 64), per stage the rows' positions, lse
// (times log2 e) and D, the flags and the barriers (K / V loaded; per stage
// full and empty)
template <int D>
struct KvSmem {
  static constexpr uint32_t kTileBytes = (D / kBox) * kBoxBytes;
  static constexpr uint32_t kK = 0, kV = kTileBytes, kQ = 2 * kTileBytes;
  static constexpr uint32_t kP = kQ + 2 * kStages * kTileBytes;
  static constexpr uint32_t kRows = kP + kTile * kTile * 4;
  static constexpr uint32_t kFlag = kRows + kStages * 3 * kTile * 4;
  static constexpr uint32_t kBar = kFlag + 8 * kStages;
  static constexpr uint32_t kBytes = kBar + 8 * (1 + 2 * kStages);
  __host__ __device__ static constexpr uint32_t q(int s) {
    return kQ + 2 * s * kTileBytes;
  }
  __host__ __device__ static constexpr uint32_t dout(int s) {
    return q(s) + kTileBytes;
  }
  __host__ __device__ static constexpr uint32_t rows(int s) {
    return kRows + s * 3 * kTile * 4;
  }
  __host__ __device__ static constexpr uint32_t full(int s) {
    return kBar + 8 * (1 + s);
  }
  __host__ __device__ static constexpr uint32_t empty(int s) {
    return kBar + 8 * (1 + kStages + s);
  }
};

// dQ kernel's shared memory: Q and dO (128 rows x D, boxes of 64 columns),
// then per stage a K and a V tile (64 rows x D), per stage the keys'
// positions and the flag, and the barriers (Q / dO loaded; per stage V full,
// K full, V empty, K empty)
template <int D>
struct QSmem {
  static constexpr int kStages = D > 128 ? 1 : 2;
  static constexpr uint32_t kRowBox = kQRows * 128;
  static constexpr uint32_t kRowTile = (D / kBox) * kRowBox;
  static constexpr uint32_t kTileBytes = (D / kBox) * kBoxBytes;
  static constexpr uint32_t kQ = 0, kDo = kRowTile, kKV = 2 * kRowTile;
  static constexpr uint32_t kPos = kKV + 2 * kStages * kTileBytes;
  static constexpr uint32_t kFlag = kPos + kStages * kTile * 4;
  static constexpr uint32_t kBar = kFlag + 8 * kStages;
  static constexpr uint32_t kBytes = kBar + 8 * (1 + 4 * kStages);
  __host__ __device__ static constexpr uint32_t k(int s) {
    return kKV + 2 * s * kTileBytes;
  }
  __host__ __device__ static constexpr uint32_t v(int s) {
    return k(s) + kTileBytes;
  }
  __host__ __device__ static constexpr uint32_t bar(int which, int s) {
    return kBar + 8 * (1 + which * kStages + s);   // 0 V full, 1 K full,
  }                                                // 2 V empty, 3 K empty
};

// positions [first, first + rows) below n: their (min, max) and whether none
// lies past n; (INT_MAX, INT_MIN, false) past the end
struct Range {
  int lo, hi;
  bool full;
};
__device__ __forceinline__ Range tile_range(const int* __restrict__ pos,
                                            int64_t first, int64_t rows,
                                            int64_t n) {
  Range r{INT_MAX, INT_MIN, first + rows <= n};
  for (int64_t j = first; j < first + rows && j < n; ++j) {
    const int p = pos[j];
    r.lo = min(r.lo, p);
    r.hi = max(r.hi, p);
  }
  return r;
}
// some pair of keys kr and queries qr may be kept (the forward's tile skip)
__device__ __forceinline__ bool may_see(Range kr, Range qr, int64_t window) {
  return kr.lo <= qr.hi &&
         (window < 0 || static_cast<int64_t>(kr.hi) >
                            static_cast<int64_t>(qr.lo) - window);
}
// every pair of keys kr and queries qr is kept, and neither tile is cut
__device__ __forceinline__ bool sees_all(Range kr, Range qr, int64_t window) {
  return kr.full && qr.full && kr.hi <= qr.lo &&
         (window < 0 || static_cast<int64_t>(kr.lo) >
                            static_cast<int64_t>(qr.hi) - window);
}
// a range over the warp's lanes (each lane's own range)
__device__ __forceinline__ Range warp_range(Range r) {
  r.lo = warp_min_i(r.lo);
  r.hi = warp_max_i(r.hi);
  r.full = __all_sync(0xffffffffu, r.full);
  return r;
}

// S^T = K Q^T (or dP^T = V dO^T), 64 x 64: both operands K-major, 64-row
// tiles of D / 64 boxes; a k16 step advances 32 bytes inside a box
template <int D>
__device__ __forceinline__ void mma_nt(float (&d)[32], uint32_t a,
                                       uint32_t a_box, uint32_t b,
                                       uint32_t b_box) {
  uint64_t da = desc(a, 16, 1024);
  const uint64_t db = desc(b, 16, 1024);
  asm volatile("" : "+l"(da));
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wg_mma_ss(d, da + (((kk / 4) * a_box + off) >> 4),
              db + (((kk / 4) * b_box + off) >> 4), kk > 0);
  }
}

// acc (64 x D) += A (64 x 64, bf16 fragments in registers) B, B a 64-row
// tile read MN-major: k16 step kk is 16 rows, 2,048 bytes into each box
template <int D>
__device__ __forceinline__ void mma_acc(float (&acc)[D / kBox][32],
                                        const uint32_t (&a)[4][4],
                                        uint32_t b) {
  const uint64_t db = desc(b, kBoxBytes, 1024);
#pragma unroll
  for (int n = 0; n < D / kBox; ++n) reg_fence(acc[n]);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int n = 0; n < D / kBox; ++n)
      wg_mma_rs(acc[n], a[kk], db + ((n * kBoxBytes + kk * 2048) >> 4));
  wg_commit_wait();
#pragma unroll
  for (int n = 0; n < D / kBox; ++n) reg_fence(acc[n]);
}

// a 64 x 64 float32 accumulator as the bf16 A operand: the accumulator's
// 16 x 16 blocks are A's register fragments, k16 step kk packs x[8 kk ..
// 8 kk + 7]
__device__ __forceinline__ void to_a(const float (&x)[32],
                                     uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// Thread (warp w of its warpgroup, lane) holds rows r = 16 w + lane / 4 and
// r + 8 of a 64-row accumulator, and in each 8-column block j the columns
// 8 j + 2 (lane % 4) + {0, 1}: index 4 j + 2 h + e is row r + 8 h, column
// 8 j + 2 (lane % 4) + e.  Rows below ``n`` of a 64 x D accumulator, columns
// below d, go to ``out`` (bf16, rows ``stride`` apart), or in float32 to
// ``part`` where it is not null.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / kBox][32],
                                           int row0, int64_t n, int d,
                                           int64_t stride, bf16* out,
                                           float* part) {
  const int t4 = threadIdx.x % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t r = row0 + 8 * h;
    if (r >= n) continue;
#pragma unroll
    for (int nb = 0; nb < D / kBox; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = nb * kBox + 8 * j + 2 * t4;
        if (c >= d) continue;
        const float x = acc[nb][4 * j + 2 * h], y = acc[nb][4 * j + 2 * h + 1];
        if (part != nullptr)
          *reinterpret_cast<float2*>(part + r * stride + c) =
              make_float2(x, y);
        else
          *reinterpret_cast<uint32_t*>(out + r * stride + c) =
              pack_bf16(x, y);
      }
  }
}

// s * scale, soft-capped as the forward caps it; dcap = 1 - tanh^2 there
__device__ __forceinline__ float capped(float s, float scale, float cap,
                                        float& dcap) {
  if (cap > 0.0f) {
    const float t = tanhf(s * scale / cap);
    dcap = 1.0f - t * t;
    return t * cap;
  }
  dcap = 1.0f;
  return s * scale;
}

// ---- the dK / dV kernel ----------------------------------------------------

struct KvArgs {
  const int* q_pos;
  const int* k_pos;
  const float* lse;
  const float* dsum;
  bf16* dk;
  bf16* dv;
  float* part;        // the slices' float32 partials, or null
  int b, sq, skv, kvh, G, dh, dv_cols, slices;
  int64_t window;
  float cap, scale;
};

// The producer warp: K and V once, then for every query tile that a key of
// the block may see and every head of the slice, the Q and dO tiles with
// the rows' positions, lse and D, and the tile's flag; then the end marker.
template <int D>
__device__ __forceinline__ void kv_produce(uint32_t base, unsigned char* smem,
                                           const CUtensorMap* tq,
                                           const CUtensorMap* tdo,
                                           const CUtensorMap* tk,
                                           const CUtensorMap* tv,
                                           const KvArgs& a, int k0, int kh,
                                           int bi, int g0, int g1) {
  using S = KvSmem<D>;
  const int lane = threadIdx.x % 32;
  const Range kr = warp_range(tile_range(a.k_pos, k0 + 2 * lane, 2, a.skv));
  if (lane == 0) {
    bar_arrive_tx(base + S::kBar, 2 * S::kTileBytes);
    for (int c = 0; c < D / kBox; ++c) {
      tma_load_4d(base + S::kK + c * kBoxBytes, tk, base + S::kBar, c * kBox,
                  kh, k0, bi);
      tma_load_4d(base + S::kV + c * kBoxBytes, tv, base + S::kBar, c * kBox,
                  kh, k0, bi);
    }
  }
  const int hq = a.kvh * a.G;
  const int n_tiles = (a.sq + kTile - 1) / kTile;
  int stage = 0;
  uint32_t phase = 0;
  for (int t0 = 0; t0 < n_tiles; t0 += 32) {
    // lane l decides query tile t0 + l; a ballot gathers the kept ones
    const Range qr = tile_range(a.q_pos, static_cast<int64_t>(t0 + lane) *
                                             kTile, kTile, a.sq);
    uint32_t keep = __ballot_sync(0xffffffffu, may_see(kr, qr, a.window));
    const uint32_t wholes =
        __ballot_sync(0xffffffffu, sees_all(kr, qr, a.window));
    while (keep != 0) {
      const int u = __ffs(keep) - 1;
      keep &= keep - 1;
      const int q0 = (t0 + u) * kTile;
      int pos[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qi = q0 + 32 * i + lane;
        pos[i] = qi < a.sq ? a.q_pos[qi] : INT_MIN;
      }
      for (int g = g0; g < g1; ++g) {
        const int64_t row = (static_cast<int64_t>(bi) * hq + kh * a.G + g) *
                            a.sq;
        bar_wait(base + S::empty(stage), phase ^ 1);
        int* qp_s = reinterpret_cast<int*>(smem + S::rows(stage));
        float* lse_s = reinterpret_cast<float*>(qp_s + kTile);
        float* dsum_s = lse_s + kTile;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = 32 * i + lane, qi = q0 + r;
          qp_s[r] = pos[i];
          lse_s[r] = qi < a.sq ? a.lse[row + qi] * kLog2e : INFINITY;
          dsum_s[r] = qi < a.sq ? a.dsum[row + qi] : 0.0f;
        }
        if (lane == 0)
          reinterpret_cast<int*>(smem + S::kFlag)[2 * stage] =
              (wholes >> u) & 1 ? kWhole : kMasked;
        __syncwarp();
        const uint32_t full = base + S::full(stage);
        if (lane == 0) {
          bar_arrive_tx(full, 2 * S::kTileBytes);
          for (int c = 0; c < D / kBox; ++c) {
            tma_load_4d(base + S::q(stage) + c * kBoxBytes, tq, full,
                        c * kBox, kh * a.G + g, q0, bi);
            tma_load_4d(base + S::dout(stage) + c * kBoxBytes, tdo, full,
                        c * kBox, kh * a.G + g, q0, bi);
          }
        } else {
          bar_arrive(full);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  }
  bar_wait(base + S::empty(stage), phase ^ 1);
  if (lane == 0) reinterpret_cast<int*>(smem + S::kFlag)[2 * stage] = kEnd;
  __syncwarp();
  bar_arrive(base + S::full(stage));
}

// A consumer warpgroup of the dK / dV kernel: the first (``dv_side``) forms
// P^T = exp(S^T - lse) and holds dV, handing P scale dcap to the second,
// which forms dP^T and dS^T and holds dK.
template <int D, bool dv_side>
__device__ __forceinline__ void kv_consume(uint32_t base, unsigned char* smem,
                                           const KvArgs& a, int k0, int kh,
                                           int bi, int slice) {
  using S = KvSmem<D>;
  constexpr int kN = D / kBox;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int t4 = lane % 4, tid = threadIdx.x % 128;
  const int row0 = warp * 16 + lane / 4;
  // this thread's keys: a query at position p keeps key kp where kp <= p <
  // kp + window
  int kp[2];
  int64_t k_until[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kj = k0 + row0 + 8 * h;
    kp[h] = kj < a.skv ? a.k_pos[kj] : kSentinel;
    k_until[h] = a.window >= 0 ? static_cast<int64_t>(kp[h]) + a.window
                               : INT64_MAX;
  }
  float acc[kN][32];
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[n][i] = 0.0f;
  float4* p_buf = reinterpret_cast<float4*>(smem + S::kP);
  if (!dv_side) named_arrive(kPFree, kConsumers);   // the buffer starts free

  bar_wait(base + S::kBar, 0);
  int stage = 0;
  uint32_t phase = 0;
  while (true) {
    bar_wait(base + S::full(stage), phase);
    const int flag = reinterpret_cast<const int*>(smem + S::kFlag)[2 * stage];
    if (flag == kEnd) break;
    const int* qp_s = reinterpret_cast<const int*>(smem + S::rows(stage));
    const float* lse_s = reinterpret_cast<const float*>(qp_s + kTile);
    const float* dsum_s = lse_s + kTile;
    float x[32] = {};
    uint32_t xa[4][4];
    if (dv_side)     // S^T = K Q^T
      mma_nt<D>(x, base + S::kK, kBoxBytes, base + S::q(stage), kBoxBytes);
    else             // dP^T = V dO^T
      mma_nt<D>(x, base + S::kV, kBoxBytes, base + S::dout(stage),
                kBoxBytes);
    wg_commit_wait();
    reg_fence(x);
    if (dv_side) {
      named_sync(kPFree, kConsumers);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t4);
        const int2 q2 = *reinterpret_cast<const int2*>(qp_s + 8 * j + 2 * t4);
        float pc[4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            float dcap;
            const float s = capped(x[i], a.scale, a.cap, dcap);
            float p = exp2f(fmaf(s, kLog2e, -(e ? l2.y : l2.x)));
            if (flag == kMasked) {
              const int qp = e ? q2.y : q2.x;
              if (!(qp >= kp[h] && static_cast<int64_t>(qp) < k_until[h]))
                p = 0.0f;
            }
            x[i] = p;
            pc[2 * h + e] = p * dcap * a.scale;
          }
        p_buf[j * 128 + tid] = make_float4(pc[0], pc[1], pc[2], pc[3]);
      }
      named_arrive(kPReady, kConsumers);
      to_a(x, xa);
      mma_acc<D>(acc, xa, base + S::dout(stage));   // dV += P^T dO
    } else {
      named_sync(kPReady, kConsumers);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 pc = p_buf[j * 128 + tid];
        const float2 d2 =
            *reinterpret_cast<const float2*>(dsum_s + 8 * j + 2 * t4);
        x[4 * j + 0] = pc.x * (x[4 * j + 0] - d2.x);
        x[4 * j + 1] = pc.y * (x[4 * j + 1] - d2.y);
        x[4 * j + 2] = pc.z * (x[4 * j + 2] - d2.x);
        x[4 * j + 3] = pc.w * (x[4 * j + 3] - d2.y);
      }
      named_arrive(kPFree, kConsumers);
      to_a(x, xa);
      mma_acc<D>(acc, xa, base + S::q(stage));      // dK += dS^T Q
    }
    bar_arrive(base + S::empty(stage));
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  if (dv_side) named_sync(kPFree, kConsumers);    // the second's last free

  const int d = dv_side ? a.dv_cols : a.dh;
  const int64_t stride = static_cast<int64_t>(a.kvh) * d;
  const int64_t first = (static_cast<int64_t>(bi) * a.skv + k0) * stride +
                        static_cast<int64_t>(kh) * d;
  float* part = nullptr;
  if (a.part != nullptr) {       // [slices][b][skv][kvh][dh], then dv's
    const int64_t nk = static_cast<int64_t>(a.b) * a.skv * a.kvh * a.dh,
                  nv = static_cast<int64_t>(a.b) * a.skv * a.kvh * a.dv_cols;
    part = a.part + (dv_side ? a.slices * nk + slice * nv : slice * nk) +
           first;
  }
  store_rows<D>(acc, row0, a.skv - k0, d, stride,
                (dv_side ? a.dv : a.dk) + first, part);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_kv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const KvArgs a) {
  using S = KvSmem<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);

  // blocks in order of key tile, so that the first tiles (under a causal
  // band the ones that see the most query tiles) start first
  const int per_tile = gridDim.x / ((a.skv + kTile - 1) / kTile);
  const int kt = blockIdx.x / per_tile, rest = blockIdx.x % per_tile;
  const int slice = rest % a.slices, bh = rest / a.slices;
  const int kh = bh % a.kvh, bi = bh / a.kvh;
  const int k0 = kt * kTile;
  const int g0 = slice * a.G / a.slices, g1 = (slice + 1) * a.G / a.slices;

  if (threadIdx.x == 0) {
    bar_init(base + S::kBar, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(base + S::full(s), 32);          // the producer warp
      bar_init(base + S::empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // one if/else for the roles, never rejoined, or setmaxnreg is ignored
  const int group = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (group == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x / 32 == 8)
      kv_produce<D>(base, smem, &tq, &tdo, &tk, &tv, a, k0, kh, bi, g0, g1);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    if (group == 0)
      kv_consume<D, true>(base, smem, a, k0, kh, bi, slice);
    else
      kv_consume<D, false>(base, smem, a, k0, kh, bi, slice);
  }
}

// dk and dv from the slices' float32 partials, summed in slice order; four
// values a thread
__global__ void __launch_bounds__(256)
flash_bwd_sum_kernel(const float* __restrict__ part, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int64_t nk, int64_t nv,
                     int slices) {
  const int64_t n4 = (nk + nv) / 4;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n4; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t e = 4 * i;
    const bool is_k = e < nk;
    const float* src = is_k ? part + e : part + slices * nk + (e - nk);
    const int64_t step = is_k ? nk : nv;
    float4 acc = *reinterpret_cast<const float4*>(src);
    for (int s = 1; s < slices; ++s) {
      const float4 x = *reinterpret_cast<const float4*>(src + s * step);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    bf16* dst = is_k ? dk + e : dv + (e - nk);
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(pack_bf16(acc.x, acc.y), pack_bf16(acc.z, acc.w));
  }
}

// ---- the dQ kernel ---------------------------------------------------------

struct QArgs {
  const int* q_pos;
  const int* k_pos;
  const float* lse;
  const float* dsum;
  bf16* dq;
  int sq, skv, kvh, G, dh;
  int64_t window;
  float cap, scale;
};

// The producer warp: Q and dO once, then for every key tile that a query of
// the block may see, V with the tile's flag and K with the keys' positions,
// each into its own slot; then the end marker.
template <int D>
__device__ __forceinline__ void q_produce(uint32_t base, unsigned char* smem,
                                          const CUtensorMap* tq,
                                          const CUtensorMap* tdo,
                                          const CUtensorMap* tk,
                                          const CUtensorMap* tv,
                                          const QArgs& a, int q0, int qhead,
                                          int bi) {
  using S = QSmem<D>;
  const int lane = threadIdx.x % 32;
  const Range qr = warp_range(tile_range(a.q_pos, q0 + lane * 4, 4, a.sq));
  const uint32_t bar_q = base + S::kBar;
  if (lane == 0) {
    bar_arrive_tx(bar_q, 2 * S::kRowTile);
    for (int c = 0; c < D / kBox; ++c) {
      tma_load_4d(base + S::kQ + c * S::kRowBox, tq, bar_q, c * kBox, qhead,
                  q0, bi);
      tma_load_4d(base + S::kDo + c * S::kRowBox, tdo, bar_q, c * kBox,
                  qhead, q0, bi);
    }
  }
  const int kh = qhead / a.G;
  int* kpos_s = reinterpret_cast<int*>(smem + S::kPos);
  int* flag_s = reinterpret_cast<int*>(smem + S::kFlag);
  const int n_tiles = (a.skv + kTile - 1) / kTile;
  int stage = 0;
  uint32_t phase = 0;
  for (int t0 = 0; t0 < n_tiles; t0 += 32) {
    const Range kr = tile_range(a.k_pos, static_cast<int64_t>(t0 + lane) *
                                             kTile, kTile, a.skv);
    uint32_t keep = __ballot_sync(0xffffffffu, may_see(kr, qr, a.window));
    const uint32_t wholes =
        __ballot_sync(0xffffffffu, sees_all(kr, qr, a.window));
    while (keep != 0) {
      const int u = __ffs(keep) - 1;
      keep &= keep - 1;
      const int k0 = (t0 + u) * kTile;
      const int pa = k0 + lane < a.skv ? a.k_pos[k0 + lane] : kSentinel;
      const int pb =
          k0 + 32 + lane < a.skv ? a.k_pos[k0 + 32 + lane] : kSentinel;
      // V and the flag
      const uint32_t full_v = base + S::bar(0, stage);
      bar_wait(base + S::bar(2, stage), phase ^ 1);
      if (lane == 0) flag_s[2 * stage] = (wholes >> u) & 1 ? kWhole : kMasked;
      __syncwarp();
      if (lane == 0) {
        bar_arrive_tx(full_v, S::kTileBytes);
        for (int c = 0; c < D / kBox; ++c)
          tma_load_4d(base + S::v(stage) + c * kBoxBytes, tv, full_v,
                      c * kBox, kh, k0, bi);
      } else {
        bar_arrive(full_v);
      }
      // K and the keys' positions
      const uint32_t full_k = base + S::bar(1, stage);
      bar_wait(base + S::bar(3, stage), phase ^ 1);
      kpos_s[stage * kTile + lane] = pa;
      kpos_s[stage * kTile + 32 + lane] = pb;
      __syncwarp();
      if (lane == 0) {
        bar_arrive_tx(full_k, S::kTileBytes);
        for (int c = 0; c < D / kBox; ++c)
          tma_load_4d(base + S::k(stage) + c * kBoxBytes, tk, full_k,
                      c * kBox, kh, k0, bi);
      } else {
        bar_arrive(full_k);
      }
      if (++stage == S::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  bar_wait(base + S::bar(2, stage), phase ^ 1);
  if (lane == 0) flag_s[2 * stage] = kEnd;
  __syncwarp();
  bar_arrive(base + S::bar(0, stage));
}

// A consumer warpgroup of the dQ kernel: 64 query rows (layout as
// store_rows), dQ in registers.
template <int D>
__device__ __forceinline__ void q_consume(uint32_t base,
                                          const unsigned char* smem,
                                          const QArgs& a, int q0, int qhead,
                                          int bi) {
  using S = QSmem<D>;
  constexpr int kN = D / kBox;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, t4 = lane % 4;
  const int row0 = warp * 16 + lane / 4;           // in the warpgroup's rows
  const int hq = a.kvh * a.G;
  const int64_t row = (static_cast<int64_t>(bi) * hq + qhead) * a.sq;
  int qp[2];
  int64_t q_from[2];                               // a key is seen above this
  float lse2[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + wg * 64 + row0 + 8 * h;
    const bool ok = qi < a.sq;
    qp[h] = ok ? a.q_pos[qi] : INT_MIN;            // a padded row sees nothing
    q_from[h] = a.window >= 0 ? static_cast<int64_t>(qp[h]) - a.window
                              : INT64_MIN;
    lse2[h] = ok ? a.lse[row + qi] * kLog2e : INFINITY;
    dd[h] = ok ? a.dsum[row + qi] : 0.0f;
  }
  float acc[kN][32];
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[n][i] = 0.0f;
  const int* kpos_s = reinterpret_cast<const int*>(smem + S::kPos);
  const int* flag_s = reinterpret_cast<const int*>(smem + S::kFlag);
  const uint32_t q_tile = base + S::kQ + wg * 64 * 128;
  const uint32_t do_tile = base + S::kDo + wg * 64 * 128;

  bar_wait(base + S::kBar, 0);
  int stage = 0;
  uint32_t phase = 0;
  while (true) {
    bar_wait(base + S::bar(0, stage), phase);
    const int flag = flag_s[2 * stage];
    if (flag == kEnd) break;
    float dp[32] = {}, s[32] = {};
    mma_nt<D>(dp, do_tile, S::kRowBox, base + S::v(stage), kBoxBytes);
    wg_commit();
    bar_wait(base + S::bar(1, stage), phase);
    mma_nt<D>(s, q_tile, S::kRowBox, base + S::k(stage), kBoxBytes);
    wg_commit();
    wg_wait<1>();                                  // dP: V is read
    reg_fence(dp);
    bar_arrive(base + S::bar(2, stage));
    wg_wait<0>();
    reg_fence(s);
    const int* kp = kpos_s + stage * kTile;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int2 k2 = *reinterpret_cast<const int2*>(kp + 8 * j + 2 * t4);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          float dcap;
          const float x = capped(s[i], a.scale, a.cap, dcap);
          float p = exp2f(fmaf(x, kLog2e, -lse2[h]));
          if (flag == kMasked) {
            const int kpp = e ? k2.y : k2.x;
            if (!(kpp <= qp[h] && static_cast<int64_t>(kpp) > q_from[h]))
              p = 0.0f;
          }
          s[i] = p * dcap * a.scale * (dp[i] - dd[h]);
        }
    }
    uint32_t da[4][4];
    to_a(s, da);
    mma_acc<D>(acc, da, base + S::k(stage));      // dQ += dS K
    bar_arrive(base + S::bar(3, stage));
    if (++stage == S::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  const int64_t stride = static_cast<int64_t>(hq) * a.dh;
  store_rows<D>(acc, row0, a.sq - q0 - wg * 64, a.dh, stride,
                a.dq + (static_cast<int64_t>(bi) * a.sq + q0 + wg * 64) *
                           stride + static_cast<int64_t>(qhead) * a.dh,
                nullptr);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_q_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const QArgs a) {
  using S = QSmem<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);

  const int head = blockIdx.y;                    // over b * kvh * G
  const int qhead = head % (a.kvh * a.G), bi = head / (a.kvh * a.G);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kQRows;  // longest rows first

  if (threadIdx.x == 0) {
    bar_init(base + S::kBar, 1);
    for (int s = 0; s < S::kStages; ++s) {
      bar_init(base + S::bar(0, s), 32);          // the producer warp
      bar_init(base + S::bar(1, s), 32);
      bar_init(base + S::bar(2, s), kConsumers);
      bar_init(base + S::bar(3, s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int group = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (group == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x / 32 == 8)
      q_produce<D>(base, smem, &tq, &tdo, &tk, &tv, a, q0, qhead, bi);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    q_consume<D>(base, smem, a, q0, qhead, bi);
  }
}

// The G heads of a kv head split into slices for the dK / dV grid of
// ``tiles`` key tiles: enough that it covers the SMs about four times, each
// slice's float32 partial dk and dv fitting in dq's bytes; 1 where that
// leaves fewer than two.
int kv_slices(int sms, int64_t tiles, int64_t b, int64_t sq, int64_t skv,
              int64_t kvh, int64_t G, int64_t dh, int64_t dv) {
  const int64_t fit = (2 * b * sq * kvh * G * dh) /
                      (4 * b * skv * kvh * (dh + dv));
  int64_t s = (4 * static_cast<int64_t>(sms) + tiles - 1) / tiles;
  s = s < G ? s : G;
  s = s < fit ? s : fit;
  return s < 2 ? 1 : static_cast<int>(s);
}

template <int D>
int launch(int device, const void* q, const void* k, const void* v,
           const void* q_pos, const void* k_pos, const void* out,
           const void* out_lo, const void* lse, const void* dout, void* dq,
           void* dk, void* dv, void* dsum, int64_t b, int64_t sq, int64_t skv,
           int64_t kvh, int64_t G, int64_t dh, int64_t dvd, int64_t window,
           double cap, double scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr)
    return static_cast<int>(cudaErrorSharedObjectInitFailed);
  const int64_t hq = kvh * G;
  CUtensorMap tq, tdo, tk, tv, tq2, tdo2;
  CUresult res = tensor_map_bf16(encode, &tq, q, dh, hq, sq, b, kTile);
  if (res == CUDA_SUCCESS)
    res = tensor_map_bf16(encode, &tdo, dout, dvd, hq, sq, b, kTile);
  if (res == CUDA_SUCCESS)
    res = tensor_map_bf16(encode, &tk, k, dh, kvh, skv, b, kTile);
  if (res == CUDA_SUCCESS)
    res = tensor_map_bf16(encode, &tv, v, dvd, kvh, skv, b, kTile);
  if (res == CUDA_SUCCESS)
    res = tensor_map_bf16(encode, &tq2, q, dh, hq, sq, b, kQRows);
  if (res == CUDA_SUCCESS)
    res = tensor_map_bf16(encode, &tdo2, dout, dvd, hq, sq, b, kQRows);
  if (res != CUDA_SUCCESS) return -static_cast<int>(res);

  err = launch_dot<bf16>(out, out_lo, dout, dsum, b, sq, hq, dvd, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = b * kvh * ((skv + kTile - 1) / kTile);
  const int slices = kv_slices(sms, tiles, b, sq, skv, kvh, G, dh, dvd);
  const KvArgs ka{static_cast<const int*>(q_pos),
                  static_cast<const int*>(k_pos),
                  static_cast<const float*>(lse),
                  static_cast<const float*>(dsum),
                  static_cast<bf16*>(dk),
                  static_cast<bf16*>(dv),
                  slices > 1 ? static_cast<float*>(dq) : nullptr,
                  static_cast<int>(b), static_cast<int>(sq),
                  static_cast<int>(skv), static_cast<int>(kvh),
                  static_cast<int>(G),
                  static_cast<int>(dh), static_cast<int>(dvd), slices,
                  window, static_cast<float>(cap), static_cast<float>(scale)};
  const int smem_kv = static_cast<int>(KvSmem<D>::kBytes) + 1024;
  err = cudaFuncSetAttribute(flash_bwd_kv_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_kv_wgmma_kernel<D><<<static_cast<unsigned>(tiles * slices),
                                 kTcThreads, smem_kv, st>>>(tq, tdo, tk, tv,
                                                            ka);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (slices > 1) {
    const int64_t nk = b * skv * kvh * dh, nv = b * skv * kvh * dvd;
    const int64_t n4 = (nk + nv) / 4;
    const int64_t blocks = (n4 + 255) / 256 < 8192 ? (n4 + 255) / 256 : 8192;
    flash_bwd_sum_kernel<<<static_cast<unsigned>(blocks), 256, 0, st>>>(
        static_cast<const float*>(dq), static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), nk, nv, slices);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  const QArgs qa{static_cast<const int*>(q_pos),
                 static_cast<const int*>(k_pos),
                 static_cast<const float*>(lse),
                 static_cast<const float*>(dsum),
                 static_cast<bf16*>(dq),
                 static_cast<int>(sq), static_cast<int>(skv),
                 static_cast<int>(kvh), static_cast<int>(G),
                 static_cast<int>(dh), window, static_cast<float>(cap),
                 static_cast<float>(scale)};
  const int smem_q = static_cast<int>(QSmem<D>::kBytes) + 1024;
  err = cudaFuncSetAttribute(flash_bwd_q_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((sq + kQRows - 1) / kQRows),
                  static_cast<unsigned>(b * hq));
  flash_bwd_q_wgmma_kernel<D><<<grid, kTcThreads, smem_q, st>>>(tq2, tdo2,
                                                                tk, tv, qa);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// The caller guarantees b * sq * skv * kvh * G > 0, dh and dv at most 256,
// b * kvh * G < 65,536; window < 0 means none, cap <= 0 means none.  dsum:
// float32 scratch of b * kvh * G * sq.  bfloat16: dh and dv multiples of 16,
// sq and skv < 2^31, q, k, v and dout 16-byte aligned (TMA).  out_lo: in
// bfloat16 the forward's rounding residual of out, which D = rowsum(dout
// (out + out_lo)) adds back, required; the float32 entry takes null.
// Returns the launches' cudaError_t, or minus libcuda's CUresult where a TMA
// tensor map could not be encoded.
extern "C" int flash_attention_bwd_f32(
    int device, const void* q, const void* k, const void* v,
    const void* q_pos, const void* k_pos, const void* out,
    const void* out_lo, const void* lse, const void* dout, void* dq, void* dk,
    void* dv, void* dsum, int64_t b, int64_t sq, int64_t skv, int64_t kvh,
    int64_t G, int64_t dh, int64_t dvd, int64_t window, double cap,
    double scale, void* stream) {
  if (out_lo != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float>(device, q, k, v, q_pos, k_pos, out, lse, dout, dq, dk,
                       dv, dsum, b, sq, skv, kvh, G, dh, dvd, window, cap,
                       scale, stream);
}

extern "C" int flash_attention_bwd_bf16(
    int device, const void* q, const void* k, const void* v,
    const void* q_pos, const void* k_pos, const void* out,
    const void* out_lo, const void* lse, const void* dout, void* dq, void* dk,
    void* dv, void* dsum, int64_t b, int64_t sq, int64_t skv, int64_t kvh,
    int64_t G, int64_t dh, int64_t dvd, int64_t window, double cap,
    double scale, void* stream) {
  if (out_lo == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t d = dh > dvd ? dh : dvd;
  auto* const run = d <= 64 ? tc::launch<64> : d <= 128 ? tc::launch<128>
                                                        : tc::launch<256>;
  return run(device, q, k, v, q_pos, k_pos, out, out_lo, lse, dout, dq, dk,
             dv, dsum, b, sq, skv, kvh, G, dh, dvd, window, cap, scale,
             stream);
}

// The bfloat16 backward's kernels at d 256 (RecurrentGemma-9B's tier): D,
// dK / dV, the slices' sum and dQ, five ints each: registers a thread, local
// (spilled) bytes a thread, static and dynamic shared memory a block, and
// blocks a multiprocessor at the launch's block size, as the runtime
// reports them.
extern "C" int flash_attention_bwd_bf16_attrs(int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int kv_bytes = static_cast<int>(tc::KvSmem<256>::kBytes) + 1024;
  const int q_bytes = static_cast<int>(tc::QSmem<256>::kBytes) + 1024;
  if ((err = cudaFuncSetAttribute(tc::flash_bwd_kv_wgmma_kernel<256>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kv_bytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(tc::flash_bwd_q_wgmma_kernel<256>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  q_bytes)) != cudaSuccess)
    return static_cast<int>(err);
  const void* fns[4] = {
      reinterpret_cast<const void*>(flash_bwd_dot_kernel<__nv_bfloat16>),
      reinterpret_cast<const void*>(tc::flash_bwd_kv_wgmma_kernel<256>),
      reinterpret_cast<const void*>(tc::flash_bwd_sum_kernel),
      reinterpret_cast<const void*>(tc::flash_bwd_q_wgmma_kernel<256>)};
  const int threads[4] = {kThreads, tc::kTcThreads, 256, tc::kTcThreads};
  const int dynamic[4] = {0, kv_bytes, 0, q_bytes};
  for (int i = 0; i < 4; ++i) {
    cudaFuncAttributes at;
    if ((err = cudaFuncGetAttributes(&at, fns[i])) != cudaSuccess)
      return static_cast<int>(err);
    int blocks = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &blocks, fns[i], threads[i], dynamic[i])) != cudaSuccess)
      return static_cast<int>(err);
    const int v[5] = {at.numRegs, static_cast<int>(at.localSizeBytes),
                      static_cast<int>(at.sharedSizeBytes), dynamic[i],
                      blocks};
    for (int j = 0; j < 5; ++j) out[5 * i + j] = v[j];
  }
  return 0;
}
