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
// a row with no key seen gives 0.  Every sum is float32, as in the TPU
// kernel.
//
// What bounds it on this card: operations.  Each (query, key) pair that the
// mask keeps costs dh + dv multiply-adds, so RecurrentGemma-9B's prefill
// call (4 x 4,096 queries x 16 heads, d 256, window 2,048: 4.03e8 pairs)
// does 4.13e11 flops on 285 MB of inputs and outputs, 0.42 ms at the bf16
// tensor-core rate against 0.09 ms for the bytes.
//
// Two entries, chosen by dtype; neither falls back to the other.
//
// bfloat16 (flash_wgmma_kernel): both products on the tensor cores, so the
// design is about feeding them.  A block of three warpgroups takes 128 query
// rows of one (batch, kv head, group) head.  One producer warp loads the Q
// tile once and then walks the key tiles (64 keys each) with TMA into a ring
// of two stages, each stage holding K and V (at d 256: Q 64 KB + 2 x 64 KB);
// it gives up its registers (setmaxnreg) to the two consumer warpgroups, 64
// query rows each, which keep the 64 x dv float32 output in registers (128 a
// thread at d 256).  Tiles are 4-D TMA boxes over (d, heads, seq, batch),
// 64 columns a box with the 128-byte swizzle that wgmma reads; columns past
// dh or dv and rows past sq or skv arrive as zeros, and output rows past sq
// are never stored.  S = Q K^T is wgmma m64n64k16 with both operands in
// shared memory (K-major); P is rounded to bf16 and fed from registers as
// the A operand of O += P V, with V read in place as an MN-major operand
// (the transpose bit), so no tile is transposed.  Products of bf16 values
// are exact in float32; the row sum is taken from the float32 P.  Each
// consumer warpgroup runs S, the softmax and P V in turn; the two
// warpgroups overlap each other.  The producer skips a tile that no query
// of the block can see (wholly after the last query, or wholly before the
// window of the first), as the TPU kernel skips its blocks (kernel.py:46-52):
// at window 2,048 over 4,096 positions a block walks ~34 of 64 tiles.  It
// decides 32 tiles at once, one a lane, from their positions, so that a run
// of skipped tiles costs one pass and not a warp reduction each.  It hands
// the kept tile's positions to the consumers with the stage, and marks a
// tile that every query sees wholly, which then takes no per-element mask.
// dh and dv are multiples of 16 up to 256; the kernel is built for d = 64,
// 128 and 256, the smallest that holds both.
//
// float32 (flash_fwd_kernel): the float32 pipes, since TF32 tensor cores
// would not hold float32's tolerance.  One block of 8 warps takes 32 query
// rows of one head and walks the keys in tiles of 32 with the same skip,
// keeping for each row a running max, a running sum and a float32
// accumulator of dv values (each lane holds dv / 32 of them, in registers).
// The query tile and each key and value tile are staged in shared memory as
// float32 (99.6 KB at d 256, so the launch opts in to dynamic shared
// memory).  Each warp owns 4 query rows, and in a key tile each lane owns one
// key: it forms its key's 4 logits from float4 reads (a key row is padded by
// 4 floats, so the lanes of a quarter-warp hit distinct banks; the query rows
// are broadcast), the warp takes each row's max and sum with shuffles, and
// the probabilities are shuffled lane to lane into the P.V product.
#include <climits>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../hopper.cuh"

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
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
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
                 float* __restrict__ lse, int64_t sq, int64_t skv,
                 int64_t kvh, int64_t G, int dh, int dv, int64_t window,
                 float cap, float scale) {
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
    // the row's log-sum-exp, where asked for; +inf for a row with no key
    if (lse != nullptr && lane == 0)
      lse[head * sq + qi] = l[i] > 0.0f ? m[i] + logf(l[i]) : INFINITY;
  }
}

template <typename T>
int launch(int device, const void* q, const void* k, const void* v,
           const void* q_pos, const void* k_pos, void* out, void* lse,
           int64_t b, int64_t sq, int64_t skv, int64_t kvh, int64_t G,
           int64_t dh, int64_t dv, int64_t window, double cap, double scale,
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
      static_cast<const int*>(k_pos), static_cast<T*>(out),
      static_cast<float*>(lse), sq, skv, kvh, G, static_cast<int>(dh),
      static_cast<int>(dv), window, static_cast<float>(cap),
      static_cast<float>(scale));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma on the tensor cores, K and V fed by TMA through a ring
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int kBM = 128;          // query rows a block: two consumer warpgroups
constexpr int kBN = 64;           // keys a tile
constexpr int kStages = 2;        // K/V tiles in the ring
constexpr int kBox = 64;          // bf16 columns of one 128-byte swizzled box
constexpr int kConsumerGroups = 2;  // warpgroups 0, 1 consume; 2 produces
constexpr int kConsumers = 128 * kConsumerGroups;
constexpr int kThreads = kConsumers + 128;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, in bytes from a 1024-aligned base.  Every operand tile is
// a run of boxes of 128-byte rows (64 bf16 columns), as TMA writes them with
// the 128-byte swizzle: Q is kBM rows x D, each K or V tile kBN rows x D.
template <int D>
struct Smem {
  static constexpr uint32_t kBoxes = D / kBox;
  static constexpr uint32_t kQBox = kBM * 128;
  static constexpr uint32_t kKVBox = kBN * 128;
  static constexpr uint32_t kTile = kBoxes * kKVBox;        // one K or V tile
  static constexpr uint32_t kK = kBoxes * kQBox;            // stage s: K at
  static constexpr uint32_t kPos = kK + 2 * kStages * kTile;  // kK + 2 s kTile,
  static constexpr uint32_t kFlag = kPos + kStages * kBN * 4;  // V after it
  static constexpr uint32_t kBar = kFlag + 8 * kStages;
  // barriers: Q loaded; per stage full (producer -> consumers) and empty
  static constexpr uint32_t kBytes = kBar + 8 * (1 + 2 * kStages);
  __host__ __device__ static constexpr uint32_t full(int s) {
    return kBar + 8 * (1 + s);
  }
  __host__ __device__ static constexpr uint32_t empty(int s) {
    return kBar + 8 * (1 + kStages + s);
  }
};
// a stage's flag: its tile needs the per-element mask, is wholly seen, or
// marks the end of the block's key tiles
constexpr int kMasked = 0, kWhole = 1, kEnd = 2;

// wgmma shared-memory descriptor, 128-byte swizzle; byte offsets: ``lbo``
// between swizzle atoms along M/N (MN-major operands only), ``sbo`` between
// groups of 8 rows
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products
__device__ __forceinline__ void reg_fence(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define ACC32(d)                                                             \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])
#define REGS32                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"

// d (64 x 64 f32) (+)= A (64 x 16, shared, K-major) . B (16 x 64, shared,
// K-major); ``accumulate`` 0 overwrites d
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64 f32) += A (64 x 16 bf16, registers) . B (16 x 64, shared,
// MN-major: the transpose bit reads a row-major V tile as it lies)
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The producer warp: Q once, then every key tile that a query of the block
// can see, each with its positions and flag, then the end marker.
template <int D>
__device__ __forceinline__ void produce(
    uint32_t base, int* kpos_s, int* flag_s, const CUtensorMap* tq,
    const CUtensorMap* tk, const CUtensorMap* tv,
    const int* __restrict__ q_pos, const int* __restrict__ k_pos, int q0,
    int sq, int skv, int qhead, int kh, int bi, int64_t window) {
  using S = Smem<D>;
  const int lane = threadIdx.x % 32;
  int q_lo = INT_MAX, q_hi = INT_MIN;
  for (int r = lane; r < kBM; r += 32) {
    if (q0 + r < sq) {
      const int p = q_pos[q0 + r];
      q_lo = min(q_lo, p);
      q_hi = max(q_hi, p);
    }
  }
  q_lo = warp_min_i(q_lo);
  q_hi = warp_max_i(q_hi);
  const uint32_t bar_q = base + S::kBar;
  if (lane == 0) {
    bar_arrive_tx(bar_q, S::kBoxes * S::kQBox);
    for (int c = 0; c < static_cast<int>(S::kBoxes); ++c)
      tma_load_4d(base + c * S::kQBox, tq, bar_q, c * kBox, qhead, q0, bi);
  }
  int stage = 0;
  uint32_t phase = 0;
  const int n_tiles = (skv + kBN - 1) / kBN;
  for (int t0 = 0; t0 < n_tiles; t0 += 32) {
    // lane l decides tile t0 + l from its positions (a tile with a slot
    // past skv is never whole); a ballot gathers the kept ones
    const int t = t0 + lane;
    int k_lo = INT_MAX, k_hi = INT_MIN, k_hi_valid = INT_MIN;
    if (t < n_tiles) {
      const int* kp = k_pos + t * kBN;
      const int n = min(kBN, skv - t * kBN);
      for (int j = 0; j < n; ++j) {
        const int p = kp[j];
        k_lo = min(k_lo, p);
        k_hi = max(k_hi, p);
      }
      k_hi_valid = k_hi;
      if (n < kBN) k_hi = kSentinel;
    }
    bool may = t < n_tiles && k_lo <= q_hi;
    if (window >= 0)
      may = may && static_cast<int64_t>(k_hi_valid) >
                       static_cast<int64_t>(q_lo) - window;
    bool whole = k_hi <= q_lo;
    if (window >= 0)
      whole = whole &&
              static_cast<int64_t>(k_lo) > static_cast<int64_t>(q_hi) - window;
    uint32_t keep = __ballot_sync(0xffffffffu, may);
    const uint32_t wholes = __ballot_sync(0xffffffffu, whole);
    while (keep != 0) {
      const int u = __ffs(keep) - 1;
      keep &= keep - 1;
      const int k0 = (t0 + u) * kBN;
      const int pa = k0 + lane < skv ? k_pos[k0 + lane] : kSentinel;
      const int pb = k0 + 32 + lane < skv ? k_pos[k0 + 32 + lane] : kSentinel;
      const uint32_t full = base + S::full(stage);
      bar_wait(base + S::empty(stage), phase ^ 1);
      kpos_s[stage * kBN + lane] = pa;
      kpos_s[stage * kBN + 32 + lane] = pb;
      if (lane == 0) flag_s[stage] = (wholes >> u) & 1 ? kWhole : kMasked;
      __syncwarp();
      if (lane == 0) {
        bar_arrive_tx(full, 2 * S::kTile);
        const uint32_t ks = base + S::kK + 2 * stage * S::kTile;
        for (int c = 0; c < static_cast<int>(S::kBoxes); ++c) {
          tma_load_4d(ks + c * S::kKVBox, tk, full, c * kBox, kh, k0, bi);
          tma_load_4d(ks + S::kTile + c * S::kKVBox, tv, full, c * kBox, kh,
                      k0, bi);
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
  bar_wait(base + S::empty(stage), phase ^ 1);
  if (lane == 0) flag_s[stage] = kEnd;
  __syncwarp();
  bar_arrive(base + S::full(stage));
}

// A consumer warpgroup: 64 query rows.  Thread (warp w, lane) holds rows
// r = 16 w + lane / 4 and r + 8, and in each 8-column block j of a 64-wide
// accumulator the columns 8 j + 2 (lane % 4) + {0, 1}: index 4 j + 2 h + e
// is row r + 8 h, column 8 j + 2 (lane % 4) + e.
template <int D>
__device__ __forceinline__ void consume(
    uint32_t base, const int* kpos_s, const int* flag_s,
    const int* __restrict__ q_pos, __nv_bfloat16* __restrict__ out,
    __nv_bfloat16* __restrict__ out_lo, float* __restrict__ lse, int q0,
    int sq, int dv, int64_t o_row,
    int64_t o_head, int64_t lse_head, int64_t window, float cap,
    float scale) {
  using S = Smem<D>;
  constexpr int kN = D / kBox;               // 64-column accumulator blocks
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, t4 = lane % 4;
  const int row0 = wg * 64 + warp * 16 + lane / 4;   // in the block
  int qp[2];
  int64_t q_from[2];                         // a key is seen above this
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + row0 + 8 * h;
    qp[h] = qi < sq ? q_pos[qi] : INT_MIN;   // a padded row sees nothing
    q_from[h] = window >= 0 ? static_cast<int64_t>(qp[h]) - window : INT64_MIN;
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float o[kN][32];
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[n][i] = 0.0f;

  const uint32_t q_tile = base + wg * 64 * 128;     // this warpgroup's rows
  bar_wait(base + S::kBar, 0);
  int stage = 0;
  uint32_t phase = 0;
  while (true) {
    bar_wait(base + S::full(stage), phase);
    const int flag = flag_s[stage];
    if (flag == kEnd) break;
    const uint32_t ks = base + S::kK + 2 * stage * S::kTile;
    const uint32_t vs = ks + S::kTile;

    // S = Q K^T: k16 steps advance 32 bytes inside a box, then a box.  Q's
    // descriptor passes through an empty asm each tile, so that the compiler
    // forms the D / 16 of them per tile instead of holding them in registers
    // across the loop
    uint64_t dsc_q = desc(q_tile, 16, 1024);
    const uint64_t dsc_k = desc(ks, 16, 1024);
    asm volatile("" : "+l"(dsc_q));
    float s[32] = {};
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      mma_ss(s, dsc_q + (((kk / 4) * S::kQBox + off) >> 4),
             dsc_k + (((kk / 4) * S::kKVBox + off) >> 4), kk > 0);
    }
    wg_commit_wait();
    reg_fence(s);

    if (cap > 0.0f) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = tanhf(s[i] * scale / cap) * cap;
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= scale;
    }
    if (flag == kMasked) {
      const int* kp = kpos_s + stage * kBN;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = kp[8 * j + 2 * t4 + e];
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (!(p <= qp[h] && static_cast<int64_t>(p) > q_from[h]))
              s[4 * j + 2 * h + e] = -INFINITY;
        }
    }
    // online softmax; a row that has seen nothing yet keeps m = -inf and
    // takes its exponents against 0, so every p and alpha is 0, never NaN
    float alpha[2], m_log2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
      mx = quad_max(mx);
      const float m_use = mx == -INFINITY ? 0.0f : mx;
      alpha[h] = exp2f((m[h] - m_use) * kLog2e);
      m[h] = mx;
      m_log2[h] = m_use * kLog2e;
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i / 2) % 2;
      s[i] = exp2f(fmaf(s[i], kLog2e, -m_log2[h]));
      sum[h] += s[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[n][i] *= alpha[(i / 2) % 2];

    // P as the bf16 A operand: the accumulator's 16 x 16 blocks are the
    // register fragments of A, so k16 step kk packs s[8 kk .. 8 kk + 7]
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

    // O += P V: k16 step kk is 16 keys, 2,048 bytes into each box
    const uint64_t dsc_v = desc(vs, S::kKVBox, 1024);
#pragma unroll
    for (int n = 0; n < kN; ++n) reg_fence(o[n]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < kN; ++n)
        mma_rs(o[n], pa[kk], dsc_v + ((n * S::kKVBox + kk * 2048) >> 4));
    wg_commit_wait();
#pragma unroll
    for (int n = 0; n < kN; ++n) reg_fence(o[n]);
    bar_arrive(base + S::empty(stage));
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  // a row with no key seen has l = 0 and o = 0, and gives 0
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lsum = quad_sum(l[h]);
    const float inv = lsum > 0.0f ? 1.0f / lsum : 0.0f;
    const int qi = q0 + row0 + 8 * h;
    if (qi >= sq) continue;
    // the row's log-sum-exp, where asked for; +inf for a row with no key
    if (lse != nullptr && t4 == 0)
      lse[lse_head + qi] = lsum > 0.0f ? m[h] + logf(lsum) : INFINITY;
    __nv_bfloat16* orow = out + qi * o_row + o_head;
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n * kBox + 8 * j + 2 * t4;
        if (c < dv) {
          const float v0 = o[n][4 * j + 2 * h] * inv;
          const float v1 = o[n][4 * j + 2 * h + 1] * inv;
          const uint32_t hi = pack_bf16(v0, v1);
          *reinterpret_cast<uint32_t*>(orow + c) = hi;
          // where asked for (training), what the bf16 output dropped:
          // bf16(v - bf16(v)), from which the backward's D = rowsum(dO O)
          // takes the float32 output's precision
          if (out_lo != nullptr) {
            const float2 h2 = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&hi));
            *reinterpret_cast<uint32_t*>(out_lo + qi * o_row + o_head + c) =
                pack_bf16(v0 - h2.x, v1 - h2.y);
          }
        }
      }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const int* __restrict__ q_pos,
                   const int* __restrict__ k_pos,
                   __nv_bfloat16* __restrict__ out,
                   __nv_bfloat16* __restrict__ out_lo,
                   float* __restrict__ lse, int sq, int skv, int kvh, int G,
                   int dv, int64_t window, float cap, float scale) {
  using S = Smem<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  int* kpos_s = reinterpret_cast<int*>(smem + S::kPos);
  int* flag_s = reinterpret_cast<int*>(smem + S::kFlag);

  const int head = blockIdx.y;                    // over b * kvh * G
  const int qhead = head % (kvh * G), bi = head / (kvh * G);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;   // longest rows first

  if (threadIdx.x == 0) {
    bar_init(base + S::kBar, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(base + S::full(s), 32);          // the producer warp
      bar_init(base + S::empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // one if/else for the two roles, never rejoined, or setmaxnreg is ignored
  // (the warpgroup's index goes through a shuffle, as CUTLASS does, so that
  // it is visibly uniform over each warp)
  const int group = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (group == kConsumerGroups) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x / 32 == 4 * kConsumerGroups)
      produce<D>(base, kpos_s, flag_s, &tq, &tk, &tv, q_pos, k_pos, q0, sq,
                 skv, qhead, qhead / G, bi, window);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    consume<D>(base, kpos_s, flag_s, q_pos, out, out_lo, lse, q0, sq, dv,
               static_cast<int64_t>(kvh) * G * dv,
               (static_cast<int64_t>(bi) * sq * kvh * G + qhead) * dv,
               (static_cast<int64_t>(bi) * kvh * G + qhead) * sq, window, cap,
               scale);
  }
}

template <int D>
int launch(int device, const void* q, const void* k, const void* v,
           const void* q_pos, const void* k_pos, void* out, void* out_lo,
           void* lse, int64_t b, int64_t sq, int64_t skv, int64_t kvh,
           int64_t G, int64_t dh, int64_t dv, int64_t window, double cap,
           double scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr)
    return static_cast<int>(cudaErrorSharedObjectInitFailed);
  CUtensorMap tq, tk, tv;
  CUresult res = tensor_map_bf16(encode, &tq, q, dh, kvh * G, sq, b, kBM);
  if (res == CUDA_SUCCESS)
    res = tensor_map_bf16(encode, &tk, k, dh, kvh, skv, b, kBN);
  if (res == CUDA_SUCCESS)
    res = tensor_map_bf16(encode, &tv, v, dv, kvh, skv, b, kBN);
  if (res != CUDA_SUCCESS) return -static_cast<int>(res);
  const int smem = static_cast<int>(Smem<D>::kBytes) + 1024;   // + alignment
  err = cudaFuncSetAttribute(flash_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((sq + kBM - 1) / kBM),
                  static_cast<unsigned>(b * kvh * G));
  flash_wgmma_kernel<D><<<grid, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<const int*>(q_pos),
      static_cast<const int*>(k_pos), static_cast<__nv_bfloat16*>(out),
      static_cast<__nv_bfloat16*>(out_lo), static_cast<float*>(lse),
      static_cast<int>(sq), static_cast<int>(skv),
      static_cast<int>(kvh),
      static_cast<int>(G), static_cast<int>(dv), window,
      static_cast<float>(cap), static_cast<float>(scale));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// The caller guarantees b * sq * kvh * G * dv > 0, b * kvh * G < 65,536;
// window < 0 means none, cap <= 0 means none.  float32: dh % 4 == 0, dh and
// dv <= 256.  bfloat16: dh and dv multiples of 16 and <= 256, sq and skv
// < 2^31, 16-byte aligned pointers.  lse: null, or float32 (b, kvh, G, sq)
// for the rows' log-sum-exp of the scaled, capped, masked logits (+inf on a
// row with no key; the backward recomputes P from it).  out_lo: in bfloat16,
// given exactly where lse is (training), a second output of out's shape
// that takes each element's rounding residual, bf16(o - bf16(o)), for the
// backward's D; the float32 entry takes null.  Returns the launch's
// cudaError_t, or minus libcuda's CUresult where a TMA tensor map could not
// be encoded.
extern "C" int flash_attention_f32(int device, const void* q, const void* k,
                                   const void* v, const void* q_pos,
                                   const void* k_pos, void* out, void* out_lo,
                                   void* lse, int64_t b, int64_t sq,
                                   int64_t skv, int64_t kvh, int64_t G,
                                   int64_t dh, int64_t dv, int64_t window,
                                   double cap, double scale, void* stream) {
  if (out_lo != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float>(device, q, k, v, q_pos, k_pos, out, lse, b, sq, skv,
                       kvh, G, dh, dv, window, cap, scale, stream);
}

extern "C" int flash_attention_bf16(int device, const void* q, const void* k,
                                    const void* v, const void* q_pos,
                                    const void* k_pos, void* out, void* out_lo,
                                    void* lse, int64_t b, int64_t sq,
                                    int64_t skv, int64_t kvh, int64_t G,
                                    int64_t dh, int64_t dv, int64_t window,
                                    double cap, double scale, void* stream) {
  if ((out_lo == nullptr) != (lse == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t d = dh > dv ? dh : dv;
  auto* const run = d <= 64 ? tc::launch<64> : d <= 128 ? tc::launch<128>
                                                        : tc::launch<256>;
  return run(device, q, k, v, q_pos, k_pos, out, out_lo, lse, b, sq, skv, kvh,
             G, dh, dv, window, cap, scale, stream);
}
