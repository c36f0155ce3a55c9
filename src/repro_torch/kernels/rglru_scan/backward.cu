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
//   dtype, initial (b, w) float32 or null, dh (b, l, w) in that dtype or
//   null, dh_last (b, w) float32 or null.  Writes dx, dr, di, da_param in
//   that dtype and dinitial (b, w) float32 (where initial is given).
//   linear_recurrence_bwd_f32: a, b, dh (b, l, w) float32, the same initial
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
// The state must be the forward's float32 state (the bf16 h was rounded), so
// the kernel recomputes it with the forward's own arithmetic
// (../rglru_step.cuh), bit for bit.  One thread walks one lane (b, w) of the
// sequence twice: forward, keeping the state entering every kChunk-step chunk
// in a small scratch (b, l / kChunk, w); then backward a chunk at a time, the
// chunk's states recomputed into registers from its saved one, then its
// steps in reverse.  The gates' loads of a chunk are issued together (the
// chunk's loop is unrolled and branch-free, the next chunk's loads issued
// before this one's steps in the forward sweep), neighbouring threads on
// neighbouring lanes.  dΛ sums over (b, l): each thread sums its lane's
// steps, a second launch sums the batch rows in order, so the bits repeat
// run to run (no atomics).
//
// What bounds it on this card: the bytes.  x, r, i and dh read and dx, dr, di
// written once: 14 bytes an element in bfloat16 (33.6 M elements at
// RecurrentGemma-9B's train call, 2 x 4,096 x 4,096: 0.140 ms over 3.35
// TB/s).  This design reads x, r, i twice (20 bytes an element) and has only
// b * w chains (8,192 at the train call, one warp a block, ~2 warps an SM),
// so it is latency-bound: a simple first version.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../rglru_step.cuh"

namespace {

constexpr int kLanes = 32;        // lanes a block: one warp
constexpr int kChunk = 16;        // steps a chunk (saved state; registers)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// a chunk's values of one lane (zeros past l); p: the lane's row, stride w
template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ p,
                                           int64_t t0, int64_t l, int w,
                                           float (&v)[kChunk]) {
#pragma unroll
  for (int t = 0; t < kChunk; ++t)
    v[t] = t0 + t < l ? to_f32(p[(t0 + t) * w]) : 0.0f;
}

// in0, in1, in2: x, r, i (kGates) or a, b (in2 unused); d0, d1, d2: dx, dr,
// di or da, db.  Block (lane tile, batch row).
template <typename T, bool kGates>
__global__ void __launch_bounds__(kLanes)
rglru_bwd_kernel(const T* __restrict__ in0, const T* __restrict__ in1,
                 const T* __restrict__ in2, const T* __restrict__ a_param,
                 const float* __restrict__ init, const T* __restrict__ dh,
                 const float* __restrict__ dh_last, float* __restrict__ ckpt,
                 T* __restrict__ d0, T* __restrict__ d1, T* __restrict__ d2,
                 float* __restrict__ dnsp_part, float* __restrict__ dinit,
                 int64_t l, int w, float c) {
  const int j = blockIdx.x * kLanes + threadIdx.x;
  if (j >= w) return;
  const int64_t bi = blockIdx.y;
  const int64_t row = bi * l * w + j;
  const int64_t nk = (l + kChunk - 1) / kChunk;
  float* const saved = ckpt + bi * nk * w + j;
  const float nsp = kGates ? rglru::neg_c_softplus(to_f32(a_param[j]), c)
                           : 0.0f;

  // the forward sweep: the state entering each chunk
  float s = init != nullptr ? init[bi * w + j] : 0.0f;
  float cx[kChunk], cr[kChunk], ci[kChunk];
  load_chunk(in0 + row, 0, l, w, cx);
  load_chunk(in1 + row, 0, l, w, cr);
  if constexpr (kGates) load_chunk(in2 + row, 0, l, w, ci);
  for (int64_t k = 0; k < nk; ++k) {
    float nx[kChunk], nr[kChunk], ni[kChunk];
    load_chunk(in0 + row, (k + 1) * kChunk, l, w, nx);
    load_chunk(in1 + row, (k + 1) * kChunk, l, w, nr);
    if constexpr (kGates) load_chunk(in2 + row, (k + 1) * kChunk, l, w, ni);
    saved[k * w] = s;
    const int64_t n = l - k * kChunk;                 // steps left
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      float next;
      if constexpr (kGates) {
        float a, g;
        rglru::gates(nsp, cr[t], ci[t], cx[t], a, g);
        next = rglru::step(a, s, g);
      } else {
        next = rglru::step(cx[t], s, cr[t]);
      }
      s = t < n ? next : s;
    }
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      cx[t] = nx[t];
      cr[t] = nr[t];
      if constexpr (kGates) ci[t] = ni[t];
    }
  }

  // the reverse sweep, a chunk at a time; carry = a_{t+1} g_{t+1}
  float carry = dh_last != nullptr ? dh_last[bi * w + j] : 0.0f;
  float dnsp = 0.0f;
  for (int64_t k = nk - 1; k >= 0; --k) {
    const int64_t t0 = k * kChunk;
    const int64_t n = l - t0;
    float px[kChunk], pr[kChunk], pi[kChunk], pd[kChunk], prev[kChunk];
    load_chunk(in0 + row, t0, l, w, px);
    load_chunk(in1 + row, t0, l, w, pr);
    if constexpr (kGates) load_chunk(in2 + row, t0, l, w, pi);
    if (dh != nullptr) {
      load_chunk(dh + row, t0, l, w, pd);
    } else {
#pragma unroll
      for (int t = 0; t < kChunk; ++t) pd[t] = 0.0f;
    }
    float st = saved[k * w];
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      prev[t] = st;
      float next;
      if constexpr (kGates) {
        float a, g;
        rglru::gates(nsp, pr[t], pi[t], px[t], a, g);
        next = rglru::step(a, st, g);
      } else {
        next = rglru::step(px[t], st, pr[t]);
      }
      st = next;
    }
#pragma unroll
    for (int t = kChunk - 1; t >= 0; --t) {
      if (t < n) {
        const float g = dh != nullptr ? __fadd_rn(pd[t], carry) : carry;
        const int64_t at = row + (t0 + t) * w;
        if constexpr (kGates) {
          const float log_a = __fmul_rn(nsp, pr[t]);
          const float a = expf(log_a);
          const float a2 = expf(__fmul_rn(2.0f, log_a));
          const float keep_raw = __fsub_rn(1.0f, a2);
          const float keep = keep_raw < 1e-12f ? 1e-12f : keep_raw;
          const float sq = rglru::sqrt_rn(keep);
          const float ix = __fmul_rn(pi[t], px[t]);
          const float dix = __fmul_rn(g, sq);
          const float dkeep =
              keep_raw >= 1e-12f
                  ? __fdiv_rn(__fmul_rn(g, ix), __fmul_rn(2.0f, sq))
                  : 0.0f;
          const float dlog_a =
              __fadd_rn(__fmul_rn(__fmul_rn(g, prev[t]), a),
                        __fmul_rn(2.0f, __fmul_rn(-dkeep, a2)));
          d0[at] = from_f32<T>(__fmul_rn(dix, pi[t]));
          d1[at] = from_f32<T>(__fmul_rn(dlog_a, nsp));
          d2[at] = from_f32<T>(__fmul_rn(dix, px[t]));
          dnsp = __fadd_rn(dnsp, __fmul_rn(dlog_a, pr[t]));
          carry = __fmul_rn(a, g);
        } else {
          d0[at] = from_f32<T>(__fmul_rn(g, prev[t]));
          d1[at] = from_f32<T>(g);
          carry = __fmul_rn(px[t], g);
        }
      }
    }
  }
  if (dinit != nullptr) dinit[bi * w + j] = carry;
  if constexpr (kGates) dnsp_part[bi * w + j] = dnsp;
}

// dΛ: each lane's partials summed over the batch rows in order, then the
// chain through -c softplus(Λ), rounded once into the parameter's dtype
template <typename T>
__global__ void rglru_bwd_dparam_kernel(const T* __restrict__ a_param,
                                        const float* __restrict__ dnsp_part,
                                        T* __restrict__ da_param, int64_t b,
                                        int w, float c) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= w) return;
  float sum = 0.0f;
  for (int64_t bi = 0; bi < b; ++bi)
    sum = __fadd_rn(sum, dnsp_part[bi * w + j]);
  const float dsp = __fmul_rn(-c, sum);
  const float lam = to_f32(a_param[j]);
  float d = dsp;
  if (!(lam > 20.0f)) {
    const float z = expf(lam);
    d = __fdiv_rn(__fmul_rn(dsp, z), __fadd_rn(z, 1.0f));
  }
  da_param[j] = from_f32<T>(d);
}

template <typename T, bool kGates>
int launch(int device, const void* in0, const void* in1, const void* in2,
           const void* a_param, const void* init, const void* dh,
           const void* dh_last, void* ckpt, void* dnsp_part, void* d0,
           void* d1, void* d2, void* da_param, void* dinit, int64_t b,
           int64_t l, int64_t w, double c, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((w + kLanes - 1) / kLanes),
                  static_cast<unsigned>(b));
  rglru_bwd_kernel<T, kGates><<<grid, kLanes, 0, st>>>(
      static_cast<const T*>(in0), static_cast<const T*>(in1),
      static_cast<const T*>(in2), static_cast<const T*>(a_param),
      static_cast<const float*>(init), static_cast<const T*>(dh),
      static_cast<const float*>(dh_last), static_cast<float*>(ckpt),
      static_cast<T*>(d0), static_cast<T*>(d1), static_cast<T*>(d2),
      static_cast<float*>(dnsp_part), static_cast<float*>(dinit), l,
      static_cast<int>(w), static_cast<float>(c));
  err = cudaGetLastError();
  if (err != cudaSuccess || !kGates) return static_cast<int>(err);
  rglru_bwd_dparam_kernel<T><<<static_cast<unsigned>((w + 255) / 256), 256,
                               0, st>>>(
      static_cast<const T*>(a_param), static_cast<const float*>(dnsp_part),
      static_cast<T*>(da_param), b, static_cast<int>(w),
      static_cast<float>(c));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, r, i, dh, dx, dr, di: (batch, l, w) contiguous; a_param, da_param (w,);
// init, dh_last, dinit: (batch, w) float32, each may be null (dinit where
// init is); ckpt: float32 scratch of batch * ceil(l / 16) * w; dnsp_part:
// float32 scratch of batch * w.  The caller guarantees batch, l, w > 0,
// batch < 65,536 and w < 2^31.  Returns the launches' cudaError_t.
extern "C" int rglru_bwd_bf16(int device, const void* x, const void* r,
                              const void* i, const void* a_param,
                              const void* init, const void* dh,
                              const void* dh_last, void* ckpt,
                              void* dnsp_part, void* dx, void* dr, void* di,
                              void* da_param, void* dinit, int64_t batch,
                              int64_t l, int64_t w, double c, void* stream) {
  return launch<__nv_bfloat16, true>(device, x, r, i, a_param, init, dh,
                                     dh_last, ckpt, dnsp_part, dx, dr, di,
                                     da_param, dinit, batch, l, w, c, stream);
}

extern "C" int rglru_bwd_f32(int device, const void* x, const void* r,
                             const void* i, const void* a_param,
                             const void* init, const void* dh,
                             const void* dh_last, void* ckpt, void* dnsp_part,
                             void* dx, void* dr, void* di, void* da_param,
                             void* dinit, int64_t batch, int64_t l, int64_t w,
                             double c, void* stream) {
  return launch<float, true>(device, x, r, i, a_param, init, dh, dh_last,
                             ckpt, dnsp_part, dx, dr, di, da_param, dinit,
                             batch, l, w, c, stream);
}

// a, b, dh, da, db: (batch, l, w) float32; init, dh_last, dinit as above.
extern "C" int linear_recurrence_bwd_f32(int device, const void* a,
                                         const void* b, const void* init,
                                         const void* dh, const void* dh_last,
                                         void* ckpt, void* da, void* db,
                                         void* dinit, int64_t batch,
                                         int64_t l, int64_t w, void* stream) {
  return launch<float, false>(device, a, b, nullptr, nullptr, init, dh,
                              dh_last, ckpt, nullptr, da, db, nullptr,
                              nullptr, dinit, batch, l, w, 0.0, stream);
}
