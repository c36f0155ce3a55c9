// ssd_scan: the Mamba-2 SSD chunked scan (arXiv:2405.21060 §6), written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py:79
// (ssd_scan_pallas, body _kernel at :33).
//
// Contract.  x (b, l, h, p), B and C (b, l, g, n) in one dtype (float32 or
// bfloat16; h a multiple of g, head hi reads group hi / (h / g)); dt (b, l, h)
// and A (h,) float32; an optional initial state (b, h, p, n) float32 (zeros
// when null); chunk cs.  Per (batch, head), over chunks of cs steps (the last
// one padded with dt = 0, x = B = C = 0, which leaves the state as it is):
//   dA = dt * A;  a = cumsum(dA) within the chunk;  xdt = x * dt
//   y[t]  = sum_{s <= t} (C[t] . B[s]) exp(a[t] - a[s]) xdt[s]      (intra)
//         + exp(a[t]) (C[t] . state)                               (carried)
//   state = state * exp(a[cs-1]) + sum_s exp(a[cs-1] - a[s]) xdt[s] B[s]^T
// y (b, l, h, p) in x's dtype; the final state (b, h, p, n) float32.  Every
// product and sum is float32, as in the TPU kernel.
//
// What bounds it on this card: operations, on the float32 pipes.  Per chunk
// and head the intra-chunk term costs cs(cs+1)/2 (n + p) multiply-adds and
// the carried term and the state update 2 cs p n; Mamba2-130M's prefill
// (4 x 4,096 steps, 24 heads, p 64, n 128, cs 256) does 3.2e10 flops on ~70
// MB of bf16 inputs and outputs.  The recurrence over chunks is sequential,
// so the parallelism is b * h blocks (96 there, on 132 SMs); tensor cores
// and a split of the intra-chunk work over more blocks are ROADMAP Queue 2b.
//
// Design.  One block of 8 warps per (batch, head) loops over the chunks in
// order and keeps the p x n float32 state in shared memory (32 KB at 64 x 128,
// padded to n + 1 columns so that lanes reading one column of it hit
// distinct banks).  A chunk's xdt (cs x p) and its cumulative decay stay in
// shared memory while the block computes the output a tile of 32 rows at a
// time: the cs x cs score block is 256 KB at cs 256, more than a block's
// shared memory, so each 32 x 32 tile of it is formed from a C tile and a B
// tile (only the tiles on or below the diagonal), decay-masked, and used at
// once.  Each thread accumulates 4 rows x 2 columns of y in registers, then
// the carried-state term; when every row tile is written, the state is
// decayed and the chunk's mass added, each thread owning 32 of its entries.
// B and C are read at group granularity and never broadcast in memory.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;              // rows (t) and columns (s) of a tile
constexpr int kMaxP = 64;              // head dim
constexpr int kMaxN = 128;             // state dim
constexpr int kYRows = kTile / kWarps;           // 4 rows of y per thread
constexpr int kYCols = kMaxP / 32;               // 2 columns of y per thread
constexpr int kSRows = kMaxP / kWarps;           // 8 state rows per thread
constexpr int kSCols = kMaxN / 32;               // 4 state columns per thread

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

size_t smem_bytes(int p, int n, int cs) {
  return sizeof(float) *
         (static_cast<size_t>(p) * (n + 1)         // state
          + static_cast<size_t>(cs) * p            // xdt
          + 2 * static_cast<size_t>(cs)            // a (cumsum), dt
          + static_cast<size_t>(kTile) * n         // C tile
          + static_cast<size_t>(kTile) * (n + 1)   // B tile
          + static_cast<size_t>(kTile) * (kTile + 1)  // score tile
          + kWarps);                               // scan carries
}

// Rows [s0, s0 + kTile) of a (b, l, g, n) tensor's chunk into tile (stride
// ldt), zero where the row lies past the chunk or the sequence.
template <typename T>
__device__ __forceinline__ void load_tile(float* tile, int ldt,
                                          const T* __restrict__ src,
                                          int64_t row0, int s0, int cs,
                                          int64_t l, int64_t row_stride,
                                          int n) {
  for (int idx = threadIdx.x; idx < kTile * n; idx += kThreads) {
    const int r = idx / n, c = idx % n;
    const int s = s0 + r;
    const bool ok = s < cs && row0 + s < l;
    tile[r * ldt + c] = ok ? to_f(src[(row0 + s) * row_stride + c]) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ B,
                const T* __restrict__ C, const float* __restrict__ init,
                T* __restrict__ y, float* __restrict__ fin, int64_t l,
                int64_t h, int64_t g, int p, int n, int cs) {
  extern __shared__ float4 smem4[];
  float* st = reinterpret_cast<float*>(smem4);   // p x (n + 1)
  float* xd = st + p * (n + 1);                  // cs x p
  float* acum = xd + cs * p;                     // cs
  float* dts = acum + cs;                        // cs
  float* Ct = dts + cs;                          // kTile x n
  float* Bt = Ct + kTile * n;                    // kTile x (n + 1)
  float* sc = Bt + kTile * (n + 1);              // kTile x (kTile + 1)
  float* carry = sc + kTile * (kTile + 1);       // kWarps

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t hi = blockIdx.x, bi = blockIdx.y;
  const int64_t gi = hi / (h / g);
  const float a_h = A[hi];
  const int64_t x_stride = h * p, bc_stride = g * n;
  const T* xb = x + bi * l * x_stride + hi * p;
  T* yb = y + bi * l * x_stride + hi * p;
  const T* Bb = B + bi * l * bc_stride + gi * n;
  const T* Cb = C + bi * l * bc_stride + gi * n;
  const float* dtb = dt + bi * l * h + hi;
  const int64_t s_base = (bi * h + hi) * p * n;

  for (int idx = tid; idx < p * n; idx += kThreads) {
    const int r = idx / n, c = idx % n;
    st[r * (n + 1) + c] = init != nullptr ? init[s_base + idx] : 0.0f;
  }

  const int64_t n_chunks = (l + cs - 1) / cs;
  for (int64_t ch = 0; ch < n_chunks; ++ch) {
    const int64_t t_base = ch * cs;
    __syncthreads();                     // the previous chunk is consumed
    // dt, and the inclusive cumsum of dA = dt * A (cs <= 256 = one per thread)
    {
      const bool ok = tid < cs && t_base + tid < l;
      const float d = ok ? dtb[(t_base + tid) * h] : 0.0f;
      float v = d * a_h;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      if (lane == 31) carry[warp] = v;
      __syncthreads();
      float before = 0.0f;
      for (int w = 0; w < warp; ++w) before += carry[w];
      if (tid < cs) {
        dts[tid] = d;
        acum[tid] = v + before;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < cs * p; idx += kThreads) {
      const int t = idx / p, c = idx % p;
      const bool ok = t_base + t < l;
      xd[idx] = ok ? to_f(xb[(t_base + t) * x_stride + c]) * dts[t] : 0.0f;
    }
    __syncthreads();

    // ---- y, one tile of kTile rows at a time ----
    for (int t0 = 0; t0 < cs; t0 += kTile) {
      load_tile(Ct, n, Cb, t_base, t0, cs, l, bc_stride, n);
      float acc[kYRows][kYCols];
#pragma unroll
      for (int i = 0; i < kYRows; ++i)
#pragma unroll
        for (int j = 0; j < kYCols; ++j) acc[i][j] = 0.0f;

      for (int s0 = 0; s0 <= t0; s0 += kTile) {
        __syncthreads();                 // Ct loaded; Bt, sc free
        load_tile(Bt, n + 1, Bb, t_base, s0, cs, l, bc_stride, n);
        __syncthreads();
        // score tile: lane = column s, warp + 8i = row t
        {
          float cb[kYRows];
#pragma unroll
          for (int i = 0; i < kYRows; ++i) cb[i] = 0.0f;
          const float* brow = Bt + lane * (n + 1);
          for (int c = 0; c < n; ++c) {
            const float bv = brow[c];
#pragma unroll
            for (int i = 0; i < kYRows; ++i)
              cb[i] += Ct[(warp + kWarps * i) * n + c] * bv;
          }
#pragma unroll
          for (int i = 0; i < kYRows; ++i) {
            const int r = warp + kWarps * i;
            const int t = t0 + r, s = s0 + lane;
            sc[r * (kTile + 1) + lane] =
                (s <= t && t < cs) ? cb[i] * expf(acum[t] - acum[s]) : 0.0f;
          }
        }
        __syncthreads();
        // y[t, :] += scores[t, s] xdt[s, :]: lane + 32j = column of y
        const int s_end = min(kTile, cs - s0);
        for (int s = 0; s < s_end; ++s) {
          const float* xrow = xd + (s0 + s) * p;
#pragma unroll
          for (int j = 0; j < kYCols; ++j) {
            const int c = lane + 32 * j;
            if (c < p) {
              const float xv = xrow[c];
#pragma unroll
              for (int i = 0; i < kYRows; ++i)
                acc[i][j] += sc[(warp + kWarps * i) * (kTile + 1) + s] * xv;
            }
          }
        }
      }
      // carried state: y[t, c] += (C[t] . state[c, :]) exp(a[t])
      {
        float cst[kYRows][kYCols];
#pragma unroll
        for (int i = 0; i < kYRows; ++i)
#pragma unroll
          for (int j = 0; j < kYCols; ++j) cst[i][j] = 0.0f;
        for (int k = 0; k < n; ++k) {
          float sv[kYCols];
#pragma unroll
          for (int j = 0; j < kYCols; ++j) {
            const int c = lane + 32 * j;
            sv[j] = c < p ? st[c * (n + 1) + k] : 0.0f;
          }
#pragma unroll
          for (int i = 0; i < kYRows; ++i) {
            const float cv = Ct[(warp + kWarps * i) * n + k];
#pragma unroll
            for (int j = 0; j < kYCols; ++j) cst[i][j] += cv * sv[j];
          }
        }
#pragma unroll
        for (int i = 0; i < kYRows; ++i) {
          const int t = t0 + warp + kWarps * i;
          if (t >= cs || t_base + t >= l) continue;
          const float decay = expf(acum[t]);
#pragma unroll
          for (int j = 0; j < kYCols; ++j) {
            const int c = lane + 32 * j;
            if (c < p)
              yb[(t_base + t) * x_stride + c] =
                  from_f<T>(acc[i][j] + cst[i][j] * decay);
          }
        }
      }
      __syncthreads();                   // Ct free for the next row tile
    }

    // ---- state update: decay the old state, add the chunk's mass ----
    const float a_last = acum[cs - 1];
    float add[kSRows][kSCols];
#pragma unroll
    for (int i = 0; i < kSRows; ++i)
#pragma unroll
      for (int j = 0; j < kSCols; ++j) add[i][j] = 0.0f;
    for (int s0 = 0; s0 < cs; s0 += kTile) {
      __syncthreads();
      load_tile(Bt, n + 1, Bb, t_base, s0, cs, l, bc_stride, n);
      __syncthreads();
      const int s_end = min(kTile, cs - s0);
      for (int s = 0; s < s_end; ++s) {
        const float dec = expf(a_last - acum[s0 + s]);
        const float* xrow = xd + (s0 + s) * p;
        const float* brow = Bt + s * (n + 1);
#pragma unroll
        for (int i = 0; i < kSRows; ++i) {
          const int r = warp + kWarps * i;        // state row (head dim)
          if (r >= p) continue;
          const float xv = xrow[r] * dec;
#pragma unroll
          for (int j = 0; j < kSCols; ++j) {
            const int c = lane + 32 * j;          // state column (d_state)
            if (c < n) add[i][j] += xv * brow[c];
          }
        }
      }
    }
    const float chunk_decay = expf(a_last);
#pragma unroll
    for (int i = 0; i < kSRows; ++i) {
      const int r = warp + kWarps * i;
      if (r >= p) continue;
#pragma unroll
      for (int j = 0; j < kSCols; ++j) {
        const int c = lane + 32 * j;
        if (c < n) {
          float* e = st + r * (n + 1) + c;
          *e = *e * chunk_decay + add[i][j];
        }
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < p * n; idx += kThreads) {
    const int r = idx / n, c = idx % n;
    fin[s_base + idx] = st[r * (n + 1) + c];
  }
}

template <typename T>
int launch(int device, const void* x, const void* dt, const void* A,
           const void* B, const void* C, const void* init, void* y, void* fin,
           int64_t b, int64_t l, int64_t h, int64_t g, int64_t p, int64_t n,
           int64_t cs, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(static_cast<int>(p), static_cast<int>(n),
                                 static_cast<int>(cs));
  err = cudaFuncSetAttribute(ssd_scan_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(h), static_cast<unsigned>(b));
  ssd_scan_kernel<T><<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const float*>(init),
      static_cast<T*>(y), static_cast<float*>(fin), l, h, g,
      static_cast<int>(p), static_cast<int>(n), static_cast<int>(cs));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The caller guarantees b, l, h > 0, h % g == 0, p <= 64, n <= 128,
// 0 < cs <= 256, h and b < 65,536.
extern "C" int ssd_scan_f32(int device, const void* x, const void* dt,
                            const void* A, const void* B, const void* C,
                            const void* init, void* y, void* fin, int64_t b,
                            int64_t l, int64_t h, int64_t g, int64_t p,
                            int64_t n, int64_t cs, void* stream) {
  return launch<float>(device, x, dt, A, B, C, init, y, fin, b, l, h, g, p, n,
                       cs, stream);
}

extern "C" int ssd_scan_bf16(int device, const void* x, const void* dt,
                             const void* A, const void* B, const void* C,
                             const void* init, void* y, void* fin, int64_t b,
                             int64_t l, int64_t h, int64_t g, int64_t p,
                             int64_t n, int64_t cs, void* stream) {
  return launch<__nv_bfloat16>(device, x, dt, A, B, C, init, y, fin, b, l, h,
                               g, p, n, cs, stream);
}
