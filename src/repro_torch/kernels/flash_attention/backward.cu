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
// Three launches, no float atomics, so the bits repeat run to run: D in a
// pre-pass (one warp a row); a dK / dV kernel, one block per (batch, kv head,
// 32-key tile), walking the query tiles that the window's band can reach (the
// forward's tile skip, from the positions) and within each the G query heads
// in order, accumulating the tile's dk and dv in registers; a dQ kernel, one
// block per (batch, query head, 32-row tile), walking the band's key tiles.
// Both recompute P from the forward's lse.  Every product runs on the
// float32 pipes from tiles staged in shared memory as float32 (a bfloat16
// input is widened once), rows padded by 4 floats so that a quarter-warp's
// float4 reads of 8 rows hit distinct banks; each thread owns 4 rows x 8
// columns of an accumulator (columns 4 lane + 128 h + e), so its reads of a
// row are float4 and broadcast or conflict-free.  At dh = dv = 256 a block
// stages four 32-row tiles (133 KB).
//
// What bounds it on this card: operations.  Each (query, key) pair the mask
// keeps costs 3 dh + 2 dv multiply-adds (S, dP, dq, dk, dv), so
// RecurrentGemma-9B's train call (2 x 4,096 queries x 16 heads, d 256, window
// 2,048: 2.0e8 pairs) does 5.2e11 flops, 0.52 ms at the bf16 tensor-core
// rate.  This first version runs on the float32 pipes (67 TFLOPS), so it can
// reach at most ~7.7 ms there: a simple kernel that is right, to be
// redesigned onto wgmma.
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
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
flash_bwd_dot_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                     float* __restrict__ dsum, int64_t rows, int64_t sq,
                     int64_t heads, int dv) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) +
                      threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const T* o = out + row * dv;
  const T* d = dout + row * dv;
  float acc = 0.0f;
  for (int c = lane; c < dv; c += 32) acc += to_f(o[c]) * to_f(d[c]);
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
  const int64_t heads = kvh * G, rows = b * sq * heads;
  flash_bwd_dot_kernel<T><<<static_cast<unsigned>(
                                (rows + kThreads / 32 - 1) / (kThreads / 32)),
                            kThreads, 0, st>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout),
      static_cast<float*>(dsum), rows, sq, heads, static_cast<int>(dvd));
  err = cudaGetLastError();
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

}  // namespace

// The caller guarantees b * sq * skv * kvh * G > 0, dh and dv at most 256,
// b * kvh * G < 65,536; window < 0 means none, cap <= 0 means none.  dsum:
// float32 scratch of b * kvh * G * sq.  Returns the launches' cudaError_t.
extern "C" int flash_attention_bwd_f32(
    int device, const void* q, const void* k, const void* v,
    const void* q_pos, const void* k_pos, const void* out, const void* lse,
    const void* dout, void* dq, void* dk, void* dv, void* dsum, int64_t b,
    int64_t sq, int64_t skv, int64_t kvh, int64_t G, int64_t dh, int64_t dvd,
    int64_t window, double cap, double scale, void* stream) {
  return launch<float>(device, q, k, v, q_pos, k_pos, out, lse, dout, dq, dk,
                       dv, dsum, b, sq, skv, kvh, G, dh, dvd, window, cap,
                       scale, stream);
}

extern "C" int flash_attention_bwd_bf16(
    int device, const void* q, const void* k, const void* v,
    const void* q_pos, const void* k_pos, const void* out, const void* lse,
    const void* dout, void* dq, void* dk, void* dv, void* dsum, int64_t b,
    int64_t sq, int64_t skv, int64_t kvh, int64_t G, int64_t dh, int64_t dvd,
    int64_t window, double cap, double scale, void* stream) {
  return launch<__nv_bfloat16>(device, q, k, v, q_pos, k_pos, out, lse, dout,
                               dq, dk, dv, dsum, b, sq, skv, kvh, G, dh, dvd,
                               window, cap, scale, stream);
}
