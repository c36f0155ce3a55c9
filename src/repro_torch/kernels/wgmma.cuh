// Hopper (sm_90a) tensor-core building blocks for the bfloat16 kernels of
// the SSD scan, shared by its forward (ssd_scan/kernel.cu) and its backward
// (ssd_scan/backward.cu), and by the flash-attention backward
// (flash_attention/backward.cu): the split of a float32 value into bf16 hi
// + lo, cp.async copies into the 128-byte swizzled tiles that wgmma reads,
// wgmma's shared-memory descriptor, fences and waits, and the m64n64k16
// bf16 products with float32 accumulation, each operand from shared memory
// (K-major, or MN-major through the transpose bit) or A from registers;
// and the chunk's cumsum and a tile's loads into registers that both ends
// of the SSD scan share.
#pragma once

#include <cstdint>
#include <cstring>
#include <cuda_bf16.h>

namespace wgmma {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t bits(bf16 a, bf16 b) {
  __nv_bfloat162 v(a, b);
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// two float32 values rounded to bf16 and packed (the first in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return bits(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// (a, b) = hi + lo with hi = bf16(v) and lo = bf16(v - hi), packed in pairs
// (the first value in the low half, as an mma fragment holds two columns)
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const bf16 ha = __float2bfloat16_rn(a), hb = __float2bfloat16_rn(b);
  hi = bits(ha, hb);
  lo = bits(__float2bfloat16_rn(a - __bfloat162float(ha)),
            __float2bfloat16_rn(b - __bfloat162float(hb)));
}

__device__ __forceinline__ void split1(float v, bf16& hi, bf16& lo) {
  hi = __float2bfloat16_rn(v);
  lo = __float2bfloat16_rn(v - __bfloat162float(hi));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// wgmma's operand tiles lie in shared memory with the 128-byte swizzle:
// boxes of 64 bf16 columns, each box R rows of 128 bytes, the 16-byte chunk
// c of row r at chunk c ^ (r % 8); every tile 1024-aligned.
//
// R rows of up to NB boxes of bf16 from src (row stride ``stride``, first
// cols columns) into the swizzled tile at dst, zeros past rows or cols; by
// cp.async when vec (cols a multiple of 8, every row 16-byte aligned), else
// element by element
template <int R, int NB>
__device__ __forceinline__ void load_swizzled(char* dst,
                                              const bf16* __restrict__ src,
                                              int64_t stride, int rows,
                                              int cols, bool vec) {
  for (int idx = threadIdx.x; idx < R * NB * 8; idx += blockDim.x) {
    const int r = idx / (NB * 8), c16 = idx % (NB * 8);
    const int c8 = 8 * c16;                        // first column of the chunk
    char* d = dst + (c16 / 8) * R * 128 + r * 128 +
              (((c16 % 8) ^ (r % 8)) << 4);
    if (r < rows && c8 < cols) {
      const bf16* s = src + r * stride + c8;
      if (vec) {
        cp_async16(d, s);
      } else {
        bf16 e[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          e[k] = c8 + k < cols ? s[k] : __float2bfloat16_rn(0.0f);
        memcpy(d, e, sizeof(e));
      }
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
  }
}

// generic-proxy writes (cp.async, st.shared) made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; byte offsets: ``lbo``
// between boxes along M or N (MN-major operands only), ``sbo`` between
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
// the products issued since the last commit as one group; then wait until
// at most N groups are still running
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
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
__device__ __forceinline__ void wg_mma_ss(float (&d)[32], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64 f32) += A (64 x 16 bf16, registers) . B (16 x 64, shared,
// MN-major: the transpose bit reads a row-major x tile as it lies)
__device__ __forceinline__ void wg_mma_rs(float (&d)[32],
                                          const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64 f32) += A (64 x 16, shared, MN-major) . B (16 x 64, shared,
// MN-major): the transpose bits read both as they lie, row-major over K
__device__ __forceinline__ void wg_mma_tt(float (&d)[32], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", %32, %33, p, 1, 1, 1, 1;\n}\n"
      : ACC32(d)
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 64 f32) (+)= A (64 x 16, shared, K-major) . B (16 x 64, shared,
// MN-major: the transpose bit reads a tile that lies row-major over K)
__device__ __forceinline__ void wg_mma_st(float (&d)[32], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// The chunk's dt (zero past valid) and the inclusive cumsum a of dt * a_h,
// for every t < kMaxT (constant past valid), kThreads at a time; s_carry
// holds kThreads / 32 floats.
template <int kThreads, int kMaxT>
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ dtb,
                                             int64_t h, int valid, float a_h,
                                             float* s_dt, float* s_a,
                                             float* s_carry) {
  constexpr int kWarps = kThreads / 32;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float run = 0.0f;
  for (int base = 0; base < kMaxT; base += kThreads) {
    const int t = base + tid;
    const float d = t < valid ? dtb[t * h] : 0.0f;
    float v = d * a_h;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) s_carry[warp] = v;
    __syncthreads();
    float before = run, total = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) before += s_carry[w];
      total += s_carry[w];
    }
    s_dt[t] = d;
    s_a[t] = v + before;
    run += total;
    __syncthreads();
  }
}

// a thread's pieces (8 bf16 each) of a tile of 64 columns, rows after rows
// of 8 pieces, kThreads at a time, into registers; zeros past rows or cols
template <int kThreads, int kPieces>
__device__ __forceinline__ void load_x(uint4 (&raw)[kPieces],
                                       const bf16* __restrict__ src,
                                       int64_t stride, int rows, int cols,
                                       bool vec) {
#pragma unroll
  for (int i = 0; i < kPieces; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / 8, c8 = (idx % 8) * 8;
    raw[i] = make_uint4(0, 0, 0, 0);
    if (r < rows && c8 < cols) {
      const bf16* s = src + r * stride + c8;
      if (vec) {
        raw[i] = *reinterpret_cast<const uint4*>(s);
      } else {
        bf16 e[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          e[k] = c8 + k < cols ? s[k] : __float2bfloat16_rn(0.0f);
        memcpy(&raw[i], e, sizeof(e));
      }
    }
  }
}

}  // namespace wgmma
