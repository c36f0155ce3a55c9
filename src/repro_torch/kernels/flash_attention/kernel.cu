// flash_attention: online-softmax attention (forward), written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:86
// (flash_attention_pallas, body _kernel at :32).
//
// Contract.  q (b, sq, kvh, G, dh), k (b, skv, kvh, dh), v (b, skv, kvh, dv),
// all float32 or all bfloat16, contiguous; q_pos (sq,) and k_pos (skv,) int32
// absolute positions shared by the batch.  Query head (kv, g) attends to kv
// head kv (GQA).  Key j is seen by query i where k_pos[j] <= q_pos[i] and,
// with window >= 0, k_pos[j] > q_pos[i] - window; an empty key slot carries
// the sentinel 2^30 and is never seen.  Logits are (q . k) * scale, then
// tanh(s / cap) * cap when cap > 0.  Out (b, sq, kvh, G, dv) in q's dtype;
// a row with no key seen gives 0.  Inputs are read into float32 and every
// sum is float32, as in the TPU kernel.
//
// What bounds it on this card: operations.  Each (query, key) pair that the
// mask keeps costs dh + dv multiply-adds, so RecurrentGemma-9B's prefill
// (4 x 4,096 queries x 16 heads, d 256, window 2,048) does 4.1e11 flops on
// 285 MB of inputs and outputs.  This first kernel runs them on the float32
// pipes, not the tensor cores (wgmma with TMA is ROADMAP Queue 2b), so it
// is bound by the shared-memory traffic that feeds those pipes.
//
// Design.  One block of 8 warps takes 32 query rows of one (batch, kv head,
// group) head and walks the keys in tiles of 32, as the TPU kernel walks its
// key blocks, keeping for each row a running max, a running sum and a
// float32 accumulator of dv values (each lane holds dv / 32 of them, so the
// accumulator lives in registers).  A key tile that no query of the block
// can see (wholly after the last query, or wholly before the window of the
// first) is skipped before it is loaded, as the TPU kernel skips its blocks
// (kernel.py:46-52): at window 2,048 over 4,096 positions that leaves a
// quarter of the causal work.  The query tile and each key and value tile
// are staged in shared memory as float32: at d 256 that is 99.6 KB, above the
// 48 KB of static shared memory, so the launch opts in to dynamic shared
// memory.  Each warp owns 4 query rows, and in a key tile each lane owns one
// key: it forms its key's 4 logits from float4 reads (a key row is padded
// by 4 floats, so the lanes of a quarter-warp hit distinct banks; the query
// rows are broadcast), the warp takes each row's max and sum with shuffles,
// and the probabilities are shuffled lane to lane into the P.V product.
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;                  // query rows per warp
constexpr int kBQ = kWarps * kRows;       // 32 query rows per block
constexpr int kBK = 32;                   // keys per tile: one per lane
constexpr int kMaxD = 256;
constexpr int kAcc = kMaxD / 32;          // accumulator columns per lane
constexpr float kNegInf = -1e30f;
constexpr int kSentinel = INT_MAX;        // a padded key: never seen

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
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

size_t smem_bytes(int dh, int dv) {
  const int ld = dh + 4;
  return sizeof(float) * (static_cast<size_t>(kBQ) * ld +
                          static_cast<size_t>(kBK) * ld +
                          static_cast<size_t>(kBK) * dv) +
         sizeof(int) * (kBQ + kBK);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ q_pos,
                 const int* __restrict__ k_pos, T* __restrict__ out,
                 int64_t sq, int64_t skv, int64_t kvh, int64_t G, int dh,
                 int dv, int64_t window, float cap, float scale) {
  extern __shared__ float4 smem4[];
  const int ld = dh + 4;
  float* qs = reinterpret_cast<float*>(smem4);     // kBQ x ld
  float* ks = qs + kBQ * ld;                       // kBK x ld
  float* vs = ks + kBK * ld;                       // kBK x dv
  int* qp = reinterpret_cast<int*>(vs + kBK * dv); // kBQ
  int* kp = qp + kBQ;                              // kBK

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t head = blockIdx.y;                 // over b * kvh * G
  const int64_t g = head % G, kh = (head / G) % kvh, bi = head / (G * kvh);
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kBQ;
  const int64_t q_stride = kvh * G * dh, o_stride = kvh * G * dv;
  const T* qb = q + bi * sq * q_stride + (kh * G + g) * dh;
  T* ob = out + bi * sq * o_stride + (kh * G + g) * dv;
  const T* kb = k + bi * skv * kvh * dh + kh * dh;
  const T* vb = v + bi * skv * kvh * dv + kh * dv;

  for (int idx = tid; idx < kBQ * dh; idx += kThreads) {
    const int r = idx / dh, d = idx % dh;
    qs[r * ld + d] = q0 + r < sq ? to_f(qb[(q0 + r) * q_stride + d]) : 0.0f;
  }
  // the block's valid query positions, and their range for the tile skip
  int q_lo = INT_MAX, q_hi = INT_MIN;
  if (warp == 0) {
    const bool valid = q0 + lane < sq;
    const int p = valid ? q_pos[q0 + lane] : INT_MIN;
    qp[lane] = p;
    q_lo = warp_min_i(valid ? p : INT_MAX);
    q_hi = warp_max_i(p);
  }
  __shared__ int q_range[2];
  if (tid == 0) { q_range[0] = q_lo; q_range[1] = q_hi; }
  __syncthreads();
  q_lo = q_range[0];
  q_hi = q_range[1];

  float m[kRows], l[kRows], acc[kRows][kAcc];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kAcc; ++j) acc[i][j] = 0.0f;
  }
  int my_qp[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) my_qp[i] = qp[warp * kRows + i];

  for (int64_t k0 = 0; k0 < skv; k0 += kBK) {
    // tile skip: every warp reads the tile's positions (uniform answer)
    const bool kvalid = k0 + lane < skv;
    const int kpos = kvalid ? k_pos[k0 + lane] : kSentinel;
    const int k_lo = warp_min_i(kpos);
    const int k_hi = warp_max_i(kvalid ? kpos : INT_MIN);
    bool may = k_lo <= q_hi;
    if (window >= 0)
      may = may && static_cast<int64_t>(k_hi) >
                       static_cast<int64_t>(q_lo) - window;
    if (!may) continue;

    __syncthreads();                    // the previous tile is consumed
    for (int idx = tid; idx < kBK * dh; idx += kThreads) {
      const int r = idx / dh, d = idx % dh;
      ks[r * ld + d] =
          k0 + r < skv ? to_f(kb[(k0 + r) * kvh * dh + d]) : 0.0f;
    }
    for (int idx = tid; idx < kBK * dv; idx += kThreads) {
      const int r = idx / dv, d = idx % dv;
      vs[r * dv + d] =
          k0 + r < skv ? to_f(vb[(k0 + r) * kvh * dv + d]) : 0.0f;
    }
    if (warp == 0) kp[lane] = kpos;
    __syncthreads();

    // logits: lane = key, 4 query rows per warp
    float s[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i] = 0.0f;
    const float* krow = ks + lane * ld;
    for (int d = 0; d < dh; d += 4) {
      const float4 kv4 = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 qv4 =
            *reinterpret_cast<const float4*>(qs + (warp * kRows + i) * ld + d);
        s[i] += qv4.x * kv4.x + qv4.y * kv4.y + qv4.z * kv4.z + qv4.w * kv4.w;
      }
    }
    const int my_kp = kp[lane];
    float p[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float x = s[i] * scale;
      if (cap > 0.0f) x = tanhf(x / cap) * cap;
      const bool seen = sees(my_kp, my_qp[i], window);
      x = seen ? x : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(x));
      const float alpha = expf(m[i] - m_new);
      p[i] = seen ? expf(x - m_new) : 0.0f;
      l[i] = l[i] * alpha + warp_sum(p[i]);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kAcc; ++j) acc[i][j] *= alpha;
    }
    // P . V: key kk's probabilities come from lane kk
    for (int kk = 0; kk < kBK; ++kk) {
      float pk[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pk[i] = __shfl_sync(0xffffffffu, p[i], kk);
      const float* vrow = vs + kk * dv;
#pragma unroll
      for (int j = 0; j < kAcc; ++j) {
        const int c = lane + 32 * j;
        if (c < dv) {
          const float vv = vrow[c];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][j] += pk[i] * vv;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int64_t qi = q0 + warp * kRows + i;
    if (qi >= sq) continue;
    const float denom = l[i] > 0.0f ? l[i] : 1.0f;
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int c = lane + 32 * j;
      if (c < dv) ob[qi * o_stride + c] = from_f<T>(acc[i][j] / denom);
    }
  }
}

template <typename T>
int launch(int device, const void* q, const void* k, const void* v,
           const void* q_pos, const void* k_pos, void* out, int64_t b,
           int64_t sq, int64_t skv, int64_t kvh, int64_t G, int64_t dh,
           int64_t dv, int64_t window, double cap, double scale,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(static_cast<int>(dh), static_cast<int>(dv));
  err = cudaFuncSetAttribute(flash_fwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((sq + kBQ - 1) / kBQ),
                  static_cast<unsigned>(b * kvh * G));
  flash_fwd_kernel<T><<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(k_pos), static_cast<T*>(out), sq, skv, kvh, G,
      static_cast<int>(dh), static_cast<int>(dv), window,
      static_cast<float>(cap), static_cast<float>(scale));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The caller guarantees b * sq * kvh * G * dv > 0, dh % 4 == 0, dh and dv
// <= 256, b * kvh * G < 65,536; window < 0 means none, cap <= 0 means none.
extern "C" int flash_attention_f32(int device, const void* q, const void* k,
                                   const void* v, const void* q_pos,
                                   const void* k_pos, void* out, int64_t b,
                                   int64_t sq, int64_t skv, int64_t kvh,
                                   int64_t G, int64_t dh, int64_t dv,
                                   int64_t window, double cap, double scale,
                                   void* stream) {
  return launch<float>(device, q, k, v, q_pos, k_pos, out, b, sq, skv, kvh, G,
                       dh, dv, window, cap, scale, stream);
}

extern "C" int flash_attention_bf16(int device, const void* q, const void* k,
                                    const void* v, const void* q_pos,
                                    const void* k_pos, void* out, int64_t b,
                                    int64_t sq, int64_t skv, int64_t kvh,
                                    int64_t G, int64_t dh, int64_t dv,
                                    int64_t window, double cap, double scale,
                                    void* stream) {
  return launch<__nv_bfloat16>(device, q, k, v, q_pos, k_pos, out, b, sq, skv,
                               kvh, G, dh, dv, window, cap, scale, stream);
}
