// ssd_scan: the Mamba-2 SSD chunked scan (arXiv:2405.21060 §6), written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py:79
// (ssd_scan_pallas, body _kernel at :33).  That kernel walks the chunks of a
// (batch, head) in order on one core and carries the p x n state across its
// sequential chunk axis in VMEM.
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
// y (b, l, h, p) in x's dtype; the final state (b, h, p, n) float32.  The
// decays, the cumsum, the recurrence and the carried state are float32, as
// in the TPU kernel, and every result is held to the plain version in
// float32 on the same values.
//
// What bounds it on this card.  Mamba2-130M's prefill call (4 x 4,096 steps,
// 24 heads, p 64, n 128, cs 256) moves ~114 MB (x and y 50 MB each), 0.034
// ms at 3.35 TB/s; its products, counting the tiles on or below the diagonal
// and the second product of each split below, are ~5.8e10 flops, 0.059 ms on
// the bf16 tensor cores.  On the float32 pipes the same work takes ~0.5 ms
// at best, so the bfloat16 entry puts every product on the tensor cores and
// the chunk axis, sequential on the TPU, goes parallel.
//
// Two entries, chosen by dtype; neither falls back to the other.
//
// bfloat16: three launches, Mamba-2's own decomposition (§6 of the paper),
// parallel over chunks.
//  1. ssd_chunk_state_kernel, two warpgroups per (chunk, head, batch): the
//     chunk's cumsum a (stored, (b, h, nc * cs) float32, for the two
//     launches after it) and its own state mass S_c = sum_s w_s x_s^T B_s
//     with w_s = exp(a_last - a_s) dt_s, a (p x cs)(cs x n) product (each
//     warpgroup half of n), into a (b, nc, h, p, n) float32 scratch, staged
//     in shared memory so that whole rows are stored.  B tiles come by
//     cp.async, x one tile ahead in registers.
//  2. ssd_state_pass_kernel, a thread per four entries of a (batch, head)'s
//     state: the only sequential part, carry = S_c + exp(a_last_c) carry
//     over the chunks in float32, eight chunks' loads in flight; it writes
//     the state entering each chunk, already split into bf16 hi and lo
//     planes ((b, nc, h, 2, p, n)), and the final state.
//  3. ssd_chunk_scan_kernel, two warpgroups per (128-row tile, chunk, head,
//     batch), 64 rows each: the carried term exp(a_t) (C_t . S_in) first,
//     then for each 64-column tile on or before the warpgroup's diagonal
//     P = (C B^T) exp(a_t - a_s) dt_s, masked to s <= t in registers where
//     the tile crosses the diagonal, and y += P x.  The C B^T accumulator is
//     rearranged in registers into the A operand of P x, so P never goes
//     through shared memory.  C, the state's planes and the first x tile
//     come in one cp.async group; then B and x tiles stream through a
//     two-stage ring, whose B half reuses the state's shared memory once
//     the carried term is done (83 KB a block, two blocks an SM).  y is
//     staged in the ring's memory at the end and stored in whole rows.
// Products are wgmma m64n64k16 bf16 with float32 accumulation, operands in
// shared memory with the 128-byte swizzle (cp.async writes it), P from
// registers; x and the B and x tiles of S_c's product lie row-major over
// the reduction and go in through the transpose bits.  An operand that is
// already bf16 (x, B, C) goes in as it is; the float32 factor of each
// product is folded into the other operand (dt into P, w into x for S_c),
// which is split into hi = bf16(v) and lo = bf16(v - hi) and multiplied
// twice, so each product keeps ~16 of float32's 24 mantissa bits: one
// rounding to bf16 would break the float32 gate (atol 1e-3, rtol 4e-3 on
// y; 1e-4 on the state) by 10-60x near zero, and TF32's 10 bits by as
// much.  C B^T needs one product: bf16 times bf16 is exact in float32.
// Tiles are zero-padded in shared memory to p 64 and n 128; rows past the
// chunk or the sequence read as zeros and are never stored.  At the serve
// call the three grids are 1,536, 768 and 3,072 blocks on 132 SMs.  What
// holds it back now is memory more than the tensor cores: each chunk's
// state goes out in float32 and back in as the split planes, and each
// 128-row block brings its state, C and column tiles into shared memory
// through a few dependent round trips.
//
// float32 (ssd_scan_kernel): the float32 pipes, since TF32 tensor cores would
// not hold float32's tolerance.  One block of 8 warps per (batch, head)
// loops over the chunks in order and keeps the p x n state in shared memory
// (32 KB at 64 x 128, padded to n + 1 columns so that lanes reading one
// column of it hit distinct banks).  A chunk's xdt (cs x p) and its
// cumulative decay stay in shared memory while the block computes the
// output a tile of 32 rows at a time: each 32 x 32 tile of the score block
// is formed from a C tile and a B tile (only the tiles on or below the
// diagonal), decay-masked, and used at once.  Each thread accumulates 4 rows
// x 2 columns of y in registers, then the carried-state term; when every
// row tile is written, the state is decayed and the chunk's mass added,
// each thread owning 32 of its entries.
//
// Both entries read B and C at group granularity and never broadcast them
// in memory.
#include <cstdint>
#include <cstring>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace wgmma;

constexpr int kMaxP = 64;              // head dim
constexpr int kMaxN = 128;             // state dim
constexpr int kMaxCS = 256;            // chunk
constexpr int kMaxDevices = 64;

// Batch and time strides (elements) of x and of B and C, which Mamba2 hands
// over as column slices of one projection; within a step x's heads and B's
// and C's groups are packed (p and n elements apart).  y is contiguous.
struct Strides {
  int64_t xb, xt, bcb, bct;
};

// ---------------------------------------------------------------------------
// float32 entry
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;              // rows (t) and columns (s) of a tile
constexpr int kYRows = kTile / kWarps;           // 4 rows of y per thread
constexpr int kYCols = kMaxP / 32;               // 2 columns of y per thread
constexpr int kSRows = kMaxP / kWarps;           // 8 state rows per thread
constexpr int kSCols = kMaxN / 32;               // 4 state columns per thread

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
__device__ __forceinline__ void load_tile(float* tile, int ldt,
                                          const float* __restrict__ src,
                                          int64_t row0, int s0, int cs,
                                          int64_t l, int64_t row_stride,
                                          int n) {
  for (int idx = threadIdx.x; idx < kTile * n; idx += kThreads) {
    const int r = idx / n, c = idx % n;
    const int s = s0 + r;
    const bool ok = s < cs && row0 + s < l;
    tile[r * ldt + c] = ok ? src[(row0 + s) * row_stride + c] : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ B,
                const float* __restrict__ C, const float* __restrict__ init,
                float* __restrict__ y, float* __restrict__ fin, int64_t l,
                int64_t h, int64_t g, int p, int n, int cs, Strides sd) {
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
  const int64_t y_stride = h * p;
  const float* xb = x + bi * sd.xb + hi * p;
  float* yb = y + bi * l * y_stride + hi * p;
  const float* Bb = B + bi * sd.bcb + gi * n;
  const float* Cb = C + bi * sd.bcb + gi * n;
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
      xd[idx] = ok ? xb[(t_base + t) * sd.xt + c] * dts[t] : 0.0f;
    }
    __syncthreads();

    // ---- y, one tile of kTile rows at a time ----
    for (int t0 = 0; t0 < cs; t0 += kTile) {
      load_tile(Ct, n, Cb, t_base, t0, cs, l, sd.bct, n);
      float acc[kYRows][kYCols];
#pragma unroll
      for (int i = 0; i < kYRows; ++i)
#pragma unroll
        for (int j = 0; j < kYCols; ++j) acc[i][j] = 0.0f;

      for (int s0 = 0; s0 <= t0; s0 += kTile) {
        __syncthreads();                 // Ct loaded; Bt, sc free
        load_tile(Bt, n + 1, Bb, t_base, s0, cs, l, sd.bct, n);
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
              yb[(t_base + t) * y_stride + c] = acc[i][j] + cst[i][j] * decay;
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
      load_tile(Bt, n + 1, Bb, t_base, s0, cs, l, sd.bct, n);
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

// ---------------------------------------------------------------------------
// bfloat16 entry (its tensor-core helpers are in ../wgmma.cuh)
// ---------------------------------------------------------------------------

constexpr int kRows = 64;              // rows of a column tile
constexpr int kPassThreads = 256;

constexpr int kStateWarps = 8;
constexpr int kStateThreads = kStateWarps * 32;

// ---------------------------------------------------------------------------
// 1. the chunk's cumsum and its own state mass
// ---------------------------------------------------------------------------

constexpr int kXPieces = kRows * (kMaxP / 8) / kStateThreads;  // 8 bf16 each

// Shared memory, in bytes from a 1024-aligned base.
struct StateSmem {
  static constexpr uint32_t kBTile = 2 * kRows * 128;   // B: 2 boxes of n
  static constexpr uint32_t kXTile = kRows * 128;       // w x: 1 box of p
  static constexpr uint32_t kB = 0;                     // B ring
  static constexpr uint32_t kXh = kB + 2 * kBTile;      // w x, hi and lo
  static constexpr uint32_t kXl = kXh + kXTile;
  static constexpr uint32_t kDt = kXl + kXTile;
  static constexpr uint32_t kA = kDt + 4 * kMaxCS;
  static constexpr uint32_t kW = kA + 4 * kMaxCS;
  static constexpr uint32_t kCarry = kW + 4 * kMaxCS;
  static constexpr uint32_t kBytes = kCarry + 4 * kStateWarps;
  // S_c staged over the ring and w x (free after the loop)
  static constexpr int kLdS = kMaxN + 4;
};
static_assert(kMaxP * StateSmem::kLdS * 4 <= StateSmem::kDt,
              "S_c is staged below dt");

// three blocks an SM: the register allocation left to itself fits two
__global__ void __launch_bounds__(kStateThreads, 3)
ssd_chunk_state_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const bf16* __restrict__ B,
                       float* __restrict__ acum, float* __restrict__ states,
                       int64_t l, int64_t h, int64_t g, int p, int n, int cs,
                       Strides sd, int vec) {
  extern __shared__ __align__(1024) char smem_raw[];
  using S = StateSmem;
  const uint32_t raw_addr = smem_addr(smem_raw);
  const uint32_t base = (raw_addr + 1023) & ~1023u;   // the swizzle's
  char* smem = smem_raw + (base - raw_addr);           // alignment
  float* s_dt = reinterpret_cast<float*>(smem + S::kDt);
  float* s_a = reinterpret_cast<float*>(smem + S::kA);
  float* s_w = reinterpret_cast<float*>(smem + S::kW);
  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32 % 4,
            lane = tid % 32;
  const int64_t c = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z;
  const int64_t nc = gridDim.x, gi = hi / (h / g);
  const int64_t t_base = c * cs;
  const int valid = static_cast<int>(l - t_base < cs ? l - t_base : cs);
  const int64_t x_stride = sd.xt, bc_stride = sd.bct;
  const bf16* xb = x + bi * sd.xb + t_base * x_stride + hi * p;
  const bf16* Bb = B + bi * sd.bcb + t_base * bc_stride + gi * n;

  load_swizzled<kRows, 2>(smem + S::kB, Bb, bc_stride, min(kRows, valid), n,
                          vec);
  cp_async_commit();
  uint4 raw[kXPieces];                 // x, one tile ahead
  load_x<kStateThreads>(raw, xb, x_stride, min(kRows, valid), p, vec);
  chunk_cumsum<kStateThreads, kMaxCS>(
      dt + (bi * l + t_base) * h + hi, h, valid, A[hi], s_dt, s_a,
      reinterpret_cast<float*>(smem + S::kCarry));
  float* acum_c = acum + (bi * h + hi) * nc * cs + c * cs;
  for (int t = tid; t < cs; t += kStateThreads) acum_c[t] = s_a[t];
  const float a_last = s_a[cs - 1];
  for (int t = tid; t < kMaxCS; t += kStateThreads)
    s_w[t] = expf(a_last - s_a[t]) * s_dt[t];
  __syncthreads();

  // S_c (p x n) = (w x)^T B: warpgroup wg takes the columns n0..n0+63; both
  // operands lie row-major over s (K), so both go in transposed
  const int n0 = 64 * wg;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;

  const int tiles = (valid + kRows - 1) / kRows;
  for (int j = 0; j < tiles; ++j) {
    const int buf = j % 2, s0 = j * kRows;
    // w_s x_s, split into hi and lo, 8 columns (one 16-byte chunk) a piece;
    // zero past valid, where w is 0
#pragma unroll
    for (int i = 0; i < kXPieces; ++i) {
      const int idx = tid + i * kStateThreads;
      const int r = idx / (kMaxP / 8), c16 = idx % (kMaxP / 8);
      const float w = s_w[s0 + r];
      bf16 e[8], eh[8], el[8];
      memcpy(e, &raw[i], sizeof(e));
#pragma unroll
      for (int k = 0; k < 8; ++k)
        split1(w * __bfloat162float(e[k]), eh[k], el[k]);
      uint4 vh, vl;
      memcpy(&vh, eh, sizeof(vh));
      memcpy(&vl, el, sizeof(vl));
      const uint32_t at = r * 128 + ((c16 ^ (r % 8)) << 4);
      *reinterpret_cast<uint4*>(smem + S::kXh + at) = vh;
      *reinterpret_cast<uint4*>(smem + S::kXl + at) = vl;
    }
    if (j + 1 < tiles) {               // the next tile's x and B
      const int s1 = s0 + kRows;
      load_x<kStateThreads>(raw, xb + s1 * x_stride, x_stride,
                            min(kRows, valid - s1), p, vec);
      load_swizzled<kRows, 2>(smem + S::kB + (buf ^ 1) * S::kBTile,
                              Bb + s1 * bc_stride, bc_stride,
                              min(kRows, valid - s1), n, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();
    if (n0 < n) {
      // a k16 step is 16 rows of s, 2,048 bytes into each tile
      const uint32_t b_half = base + S::kB + buf * S::kBTile + wg * S::kXTile;
      wg_fence();
#pragma unroll
      for (int k = 0; k < kRows / 16; ++k) {
        const uint64_t b = desc(b_half + k * 2048, S::kXTile, 1024);
        wg_mma_tt(acc, desc(base + S::kXh + k * 2048, S::kXTile, 1024), b);
        wg_mma_tt(acc, desc(base + S::kXl + k * 2048, S::kXTile, 1024), b);
      }
      wg_commit_wait();
      reg_fence(acc);
    }
    __syncthreads();
  }

  // stage S_c in shared memory (the ring is free), then store whole rows
  float* out_s = reinterpret_cast<float*>(smem);
  const int gr = lane / 4, gc = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<float2*>(
          &out_s[(16 * warp + gr + 8 * half) * S::kLdS + n0 + 8 * j + gc]) =
          make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
  __syncthreads();
  float* out = states + ((bi * nc + c) * h + hi) * p * n;
  if (n % 4 == 0) {
    for (int idx = tid; idx < p * n / 4; idx += kStateThreads) {
      const int r = 4 * idx / n, col = 4 * idx % n;
      reinterpret_cast<float4*>(out)[idx] =
          *reinterpret_cast<const float4*>(&out_s[r * S::kLdS + col]);
    }
  } else {
    for (int idx = tid; idx < p * n; idx += kStateThreads)
      out[idx] = out_s[idx / n * S::kLdS + idx % n];
  }
}

// ---------------------------------------------------------------------------
// 2. the state entering each chunk, and the final state
// ---------------------------------------------------------------------------

constexpr int kPassDepth = 8;          // chunks whose loads are in flight

// four consecutive floats from p (those past cnt read as 0); whole when v4
__device__ __forceinline__ float4 load4(const float* __restrict__ p, int cnt,
                                        bool v4) {
  if (v4) return *reinterpret_cast<const float4*>(p);
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = k < cnt ? p[k] : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// s_in (b, nc, h, 2, p, n) bf16: the state entering each chunk, split into
// hi and lo planes as the chunk scan's tensor cores take it.  Four entries
// of the state a thread.
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass_kernel(const float* __restrict__ acum,
                      const float* __restrict__ init,
                      const float* __restrict__ states,
                      bf16* __restrict__ s_in, float* __restrict__ fin,
                      int64_t nc, int64_t h, int64_t pn, int cs) {
  const int64_t e = 4 * (blockIdx.x * static_cast<int64_t>(kPassThreads) +
                         threadIdx.x);
  if (e >= pn) return;
  const int cnt = static_cast<int>(pn - e < 4 ? pn - e : 4);
  const bool v4 = pn % 4 == 0;
  const int64_t hi = blockIdx.y, bi = blockIdx.z;
  const float* a_last = acum + (bi * h + hi) * nc * cs + (cs - 1);
  float4 carry = init != nullptr ? load4(init + (bi * h + hi) * pn + e, cnt, v4)
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float* sp = states + (bi * nc * h + hi) * pn + e;
  bf16* op = s_in + (bi * nc * h + hi) * 2 * pn + e;
  for (int64_t c0 = 0; c0 < nc; c0 += kPassDepth) {
    float4 mass[kPassDepth];
    float decay[kPassDepth];
#pragma unroll
    for (int k = 0; k < kPassDepth; ++k) {
      const int64_t c = c0 + k;
      mass[k] = c < nc ? load4(sp + c * h * pn, cnt, v4)
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      decay[k] = c < nc ? expf(a_last[c * cs]) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kPassDepth; ++k) {
      const int64_t c = c0 + k;
      if (c >= nc) break;
      const float v[4] = {carry.x, carry.y, carry.z, carry.w};
      bf16 h4[4], l4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split1(v[i], h4[i], l4[i]);
      bf16* o = op + c * h * 2 * pn;
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
      carry = make_float4(mass[k].x + decay[k] * carry.x,
                          mass[k].y + decay[k] * carry.y,
                          mass[k].z + decay[k] * carry.z,
                          mass[k].w + decay[k] * carry.w);
    }
  }
  float* f = fin + (bi * h + hi) * pn + e;
  if (v4) {
    *reinterpret_cast<float4*>(f) = carry;
  } else {
    const float v[4] = {carry.x, carry.y, carry.z, carry.w};
    for (int i = 0; i < cnt; ++i) f[i] = v[i];
  }
}

// ---------------------------------------------------------------------------
// 3. y: the carried term, then the tiles on or before the diagonal, on wgmma
// ---------------------------------------------------------------------------

constexpr int kScanGroups = 2;                 // warpgroups: 64 rows of y each
constexpr int kScanThreads = 128 * kScanGroups;
constexpr int kScanRows = 64 * kScanGroups;


// Shared memory, in bytes from a 1024-aligned base.
struct ScanSmem {
  static constexpr uint32_t kC = 0;                          // C: rows t
  static constexpr uint32_t kCBox = kScanRows * 128;         // 2 boxes of n
  static constexpr uint32_t kRing = kC + 2 * kCBox;          // B ring, or
  static constexpr uint32_t kBTile = 2 * kRows * 128;        // S_in's planes
  static constexpr uint32_t kX = kRing + 2 * kBTile;         // x ring
  static constexpr uint32_t kXTile = kRows * 128;            // one box of p
  static constexpr uint32_t kDt = kX + 2 * kXTile;
  static constexpr uint32_t kA = kDt + 4 * kMaxCS;
  static constexpr uint32_t kBytes = kA + 4 * kMaxCS;
};
static_assert(2 * kRows * 128 * 2 == 2 * ScanSmem::kBTile,
              "S_in's two planes fill the B ring");
static_assert(kScanRows * (kMaxP + 8) * 2 <= 2 * ScanSmem::kBTile,
              "y is staged in the ring");

__global__ void __launch_bounds__(kScanThreads)
ssd_chunk_scan_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                      const bf16* __restrict__ B, const bf16* __restrict__ C,
                      const float* __restrict__ acum,
                      const bf16* __restrict__ s_in, bf16* __restrict__ y,
                      int64_t l, int64_t h, int64_t g, int p, int n, int cs,
                      Strides sd, int vec) {
  extern __shared__ __align__(1024) char smem_raw[];
  using S = ScanSmem;
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // the swizzle's alignment
  char* smem = smem_raw + (base - raw);
  float* s_dt = reinterpret_cast<float*>(smem + S::kDt);
  float* s_a = reinterpret_cast<float*>(smem + S::kA);
  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32 % 4,
            lane = tid % 32;
  const int tiles = (cs + kScanRows - 1) / kScanRows;
  const int64_t c = blockIdx.x / tiles, hi = blockIdx.y, bi = blockIdx.z;
  // the longest row tiles of a chunk first
  const int ti = tiles - 1 - static_cast<int>(blockIdx.x % tiles);
  const int64_t nc = gridDim.x / tiles, gi = hi / (h / g);
  const int64_t t_base = c * cs;
  const int valid = static_cast<int>(l - t_base < cs ? l - t_base : cs);
  const int t0 = ti * kScanRows;
  if (t0 >= valid) return;             // rows past the sequence
  // this warpgroup's 64 rows hold some t < valid; the block's column tiles
  // run up to its last row's
  const int w0 = t0 + 64 * wg;         // the warpgroup's first row
  const bool rows_live = w0 < valid;
  const int last_tile = (min(t0 + kScanRows, valid) - 1) / kRows;
  const int64_t x_stride = sd.xt, bc_stride = sd.bct;
  const bf16* xb = x + bi * sd.xb + t_base * x_stride + hi * p;
  const bf16* Bb = B + bi * sd.bcb + t_base * bc_stride + gi * n;
  const bf16* Cb = C + bi * sd.bcb + t_base * bc_stride + gi * n;

  // C rows t0.., the first x tile and the entering state's hi / lo planes
  // (in the B ring until the carried term is done)
  load_swizzled<kScanRows, 2>(smem + S::kC, Cb + t0 * bc_stride, bc_stride,
                              min(kScanRows, valid - t0), n, vec);
  load_swizzled<kRows, 1>(smem + S::kX, xb, x_stride, min(kRows, valid), p,
                          vec);
  const bf16* s_c = s_in + ((bi * nc + c) * h + hi) * 2 * p * n;
  load_swizzled<kRows, 2>(smem + S::kRing, s_c, n, p, n, vec);
  load_swizzled<kRows, 2>(smem + S::kRing + S::kBTile, s_c + p * n, n, p, n,
                          vec);
  cp_async_commit();
  const float* a_c = acum + (bi * h + hi) * nc * cs + c * cs;
  const float* dtb = dt + (bi * l + t_base) * h + hi;
  for (int t = tid; t < kMaxCS; t += kScanThreads) {
    s_a[t] = t < cs ? a_c[t] : 0.0f;
    s_dt[t] = t < valid ? dtb[t * h] : 0.0f;
  }
  cp_async_wait<0>();
  fence_async_smem();
  __syncthreads();

  const int gr = lane / 4, gc = 2 * (lane % 4);
  const int row_a = 64 * wg + 16 * warp + gr, row_b = row_a + 8;  // this
  // thread's rows of the block; C's descriptors start at the warpgroup's
  const uint32_t c_wg = base + S::kC + wg * 64 * 128;

  // carried term: y = exp(a_t) (C_t . S_in), S_in's planes K-major [p][n]
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  if (rows_live) {
    wg_fence();
#pragma unroll
    for (int plane = 0; plane < 2; ++plane)
#pragma unroll
      for (int kk = 0; kk < kMaxN / 16; ++kk) {
        const uint32_t off = (kk / 4) * S::kCBox + (kk % 4) * 32;
        const uint32_t soff = plane * S::kBTile + (kk / 4) * kRows * 128 +
                              (kk % 4) * 32;
        wg_mma_ss(acc, desc(c_wg + off, 16, 1024),
                  desc(base + S::kRing + soff, 16, 1024), plane + kk > 0);
      }
    wg_commit_wait();
    reg_fence(acc);
    const float da = expf(s_a[t0 + row_a]), db = expf(s_a[t0 + row_b]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[4 * j] *= da;
      acc[4 * j + 1] *= da;
      acc[4 * j + 2] *= db;
      acc[4 * j + 3] *= db;
    }
  }
  __syncthreads();                     // the state's planes become the ring

  // intra-chunk term over the column tiles on or before the diagonal
  load_swizzled<kRows, 2>(smem + S::kRing, Bb, bc_stride, min(kRows, valid),
                          n, vec);
  cp_async_commit();
  const float a_ta = s_a[t0 + row_a], a_tb = s_a[t0 + row_b];
  for (int j = 0; j <= last_tile; ++j) {
    const int buf = j % 2, s0 = j * kRows;
    if (j < last_tile) {               // prefetch the next tile
      const int s1 = s0 + kRows;
      load_swizzled<kRows, 2>(smem + S::kRing + (buf ^ 1) * S::kBTile,
                              Bb + s1 * bc_stride, bc_stride,
                              min(kRows, valid - s1), n, vec);
      load_swizzled<kRows, 1>(smem + S::kX + (buf ^ 1) * S::kXTile,
                              xb + s1 * x_stride, x_stride,
                              min(kRows, valid - s1), p, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();
    // a warpgroup skips a tile wholly above its diagonal, and dead rows
    if (rows_live && s0 <= w0 + 63) {
      // C B^T: rows t (the warpgroup's 64), columns s (64), one product
      const uint32_t b_tile = base + S::kRing + buf * S::kBTile;
      float cb[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kMaxN / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wg_mma_ss(cb, desc(c_wg + (kk / 4) * S::kCBox + off, 16, 1024),
                  desc(b_tile + (kk / 4) * kRows * 128 + off, 16, 1024),
                  kk > 0);
      }
      wg_commit_wait();
      reg_fence(cb);
      // P = C B^T exp(a_t - a_s) dt_s for s <= t, in registers, split into
      // hi and lo: the accumulator's 16 x 16 blocks are the A fragments of
      // the k16 steps of y += P x
      const bool below = s0 + kRows - 1 <= w0;   // no mask needed
      uint32_t ph[4][4], pl[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float pv[2][4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int q = 2 * k + half, s = s0 + 8 * q + gc;  // columns s, s+1
          const float2 as = *reinterpret_cast<const float2*>(&s_a[s]);
          const float2 ds = *reinterpret_cast<const float2*>(&s_dt[s]);
          // __expf is within 2 + 1.2 |x| ulp, under the split's 2^-17
          // wherever exp(x) > e^-20; where it is smaller the term is lost
          // in the sum's rounding either way
          pv[half][0] = cb[4 * q] * __expf(a_ta - as.x) * ds.x;
          pv[half][1] = cb[4 * q + 1] * __expf(a_ta - as.y) * ds.y;
          pv[half][2] = cb[4 * q + 2] * __expf(a_tb - as.x) * ds.x;
          pv[half][3] = cb[4 * q + 3] * __expf(a_tb - as.y) * ds.y;
          if (!below) {
            const int ta = t0 + row_a, tb = t0 + row_b;
            if (s > ta) pv[half][0] = 0.0f;
            if (s + 1 > ta) pv[half][1] = 0.0f;
            if (s > tb) pv[half][2] = 0.0f;
            if (s + 1 > tb) pv[half][3] = 0.0f;
          }
        }
        split2(pv[0][0], pv[0][1], ph[k][0], pl[k][0]);
        split2(pv[0][2], pv[0][3], ph[k][1], pl[k][1]);
        split2(pv[1][0], pv[1][1], ph[k][2], pl[k][2]);
        split2(pv[1][2], pv[1][3], ph[k][3], pl[k][3]);
      }
      // y += P x: x MN-major [s][p], a k16 step is 16 rows, 2,048 bytes
      const uint32_t x_tile = base + S::kX + buf * S::kXTile;
      reg_fence(acc);
      wg_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wg_mma_rs(acc, ph[k], desc(x_tile + k * 2048, S::kXTile, 1024));
        wg_mma_rs(acc, pl[k], desc(x_tile + k * 2048, S::kXTile, 1024));
      }
      wg_commit_wait();
      reg_fence(acc);
    }
    __syncthreads();                   // this stage may be refilled
  }

  // y rows t0.., in x's dtype, staged in the ring's memory (free after the
  // loop's last barrier) so that whole rows are stored; rows past the
  // sequence are never stored
  constexpr int kLdY = kMaxP + 8;
  bf16* ys = reinterpret_cast<bf16*>(smem + S::kRing);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<uint32_t*>(&ys[(half ? row_b : row_a) * kLdY + 8 * j +
                                       gc]) =
          bits(__float2bfloat16_rn(acc[4 * j + 2 * half]),
               __float2bfloat16_rn(acc[4 * j + 2 * half + 1]));
  __syncthreads();
  const int rows = min(kScanRows, valid - t0);
  const int64_t y_stride = h * p;
  bf16* yb = y + (bi * l + t_base + t0) * y_stride + hi * p;
  if (vec) {
    for (int idx = tid; idx < rows * (p / 8); idx += kScanThreads) {
      const int r = idx / (p / 8), c8 = idx % (p / 8) * 8;
      *reinterpret_cast<uint4*>(yb + r * y_stride + c8) =
          *reinterpret_cast<const uint4*>(&ys[r * kLdY + c8]);
    }
  } else {
    for (int idx = tid; idx < rows * p; idx += kScanThreads)
      yb[idx / p * y_stride + idx % p] = ys[idx / p * kLdY + idx % p];
  }
}

// A kernel's dynamic shared memory above 48 KB, allowed once per device
// (the attribute holds for the process); a race sets it twice, harmlessly.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int device, int bytes, bool* done) {
  if (device >= 0 && device < kMaxDevices && done[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && device >= 0 && device < kMaxDevices)
    done[device] = true;
  return err;
}

bool chunk_state_smem_set[kMaxDevices], chunk_scan_smem_set[kMaxDevices];

}  // namespace

// The caller guarantees b, l, h > 0, h % g == 0, p <= 64, n <= 128,
// 0 < cs <= 256, h and b < 65,536, and x, B and C laid out as Strides says
// (xb, xt, bcb, bct its batch and time strides).
extern "C" int ssd_scan_f32(int device, const void* x, const void* dt,
                            const void* A, const void* B, const void* C,
                            const void* init, void* y, void* fin, int64_t b,
                            int64_t l, int64_t h, int64_t g, int64_t p,
                            int64_t n, int64_t cs, int64_t xb, int64_t xt,
                            int64_t bcb, int64_t bct, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(static_cast<int>(p), static_cast<int>(n),
                                 static_cast<int>(cs));
  err = cudaFuncSetAttribute(ssd_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(h), static_cast<unsigned>(b));
  ssd_scan_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(init),
      static_cast<float*>(y), static_cast<float*>(fin), l, h, g,
      static_cast<int>(p), static_cast<int>(n), static_cast<int>(cs),
      Strides{xb, xt, bcb, bct});
  return static_cast<int>(cudaGetLastError());
}

// The bfloat16 entry's three launches, in this order on one stream.  Beyond
// the float32 entry's guarantees: acum is (b, h, nc * cs) and states (b, nc,
// h, p, n), both float32, s_in (b, nc, h, 2, p, n) bf16, nc = ceil(l / cs) <
// 2^31 / ceil(cs / 64); vec says that p, n and the strides are multiples
// of 8 and x, B, C and s_in 16-byte aligned.
extern "C" int ssd_chunk_state_bf16(int device, const void* x, const void* dt,
                                    const void* A, const void* B, void* acum,
                                    void* states, int64_t b, int64_t l,
                                    int64_t h, int64_t g, int64_t p, int64_t n,
                                    int64_t cs, int64_t xb, int64_t xt,
                                    int64_t bcb, int64_t bct, int vec,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = static_cast<int>(StateSmem::kBytes) + 1024;  // to align
  err = allow_smem(ssd_chunk_state_kernel, device, smem,
                   chunk_state_smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t nc = (l + cs - 1) / cs;
  const dim3 grid(static_cast<unsigned>(nc), static_cast<unsigned>(h),
                  static_cast<unsigned>(b));
  ssd_chunk_state_kernel<<<grid, kStateThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const bf16*>(B),
      static_cast<float*>(acum), static_cast<float*>(states), l, h, g,
      static_cast<int>(p), static_cast<int>(n), static_cast<int>(cs),
      Strides{xb, xt, bcb, bct}, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ssd_state_pass(int device, const void* acum, const void* init,
                              const void* states, void* s_in, void* fin,
                              int64_t b, int64_t l, int64_t h, int64_t p,
                              int64_t n, int64_t cs, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t nc = (l + cs - 1) / cs, pn = p * n;
  const int64_t per_block = 4 * kPassThreads;
  const dim3 grid(static_cast<unsigned>((pn + per_block - 1) / per_block),
                  static_cast<unsigned>(h), static_cast<unsigned>(b));
  ssd_state_pass_kernel<<<grid, kPassThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(acum), static_cast<const float*>(init),
      static_cast<const float*>(states), static_cast<bf16*>(s_in),
      static_cast<float*>(fin), nc, h, pn, static_cast<int>(cs));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ssd_chunk_scan_bf16(int device, const void* x, const void* dt,
                                   const void* B, const void* C,
                                   const void* acum, const void* s_in,
                                   void* y, int64_t b, int64_t l, int64_t h,
                                   int64_t g, int64_t p, int64_t n, int64_t cs,
                                   int64_t xb, int64_t xt, int64_t bcb,
                                   int64_t bct, int vec, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = static_cast<int>(ScanSmem::kBytes) + 1024;  // to align
  err = allow_smem(ssd_chunk_scan_kernel, device, smem, chunk_scan_smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t nc = (l + cs - 1) / cs;
  const int64_t tiles = (cs + kScanRows - 1) / kScanRows;
  const dim3 grid(static_cast<unsigned>(nc * tiles), static_cast<unsigned>(h),
                  static_cast<unsigned>(b));
  ssd_chunk_scan_kernel<<<grid, kScanThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const bf16*>(B), static_cast<const bf16*>(C),
      static_cast<const float*>(acum), static_cast<const bf16*>(s_in),
      static_cast<bf16*>(y), l, h, g, static_cast<int>(p),
      static_cast<int>(n), static_cast<int>(cs), Strides{xb, xt, bcb, bct},
      vec);
  return static_cast<int>(cudaGetLastError());
}
