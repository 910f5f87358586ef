// Int8 weight-only matmul (W8A16) for Hopper (sm_90a). Built by
// ops/_build.py into a shared library with a plain C entry point and
// called through ctypes by ops/int8_dense.py.
//
// Replaces tf_operator_tpu/ops/int8_dense.py::_int8_matmul_kernel (:47,
// launched by the pallas_call at :80):
//
//   out[i,j] = (sum_k bf16(x[i,k]) * bf16(w_q[k,j])) * scale[j]    f32 sums
//
// cast to out's type (f32 or bf16). With a bias (the model's Int8Dense), the
// f32 bias is added to that product before the cast, as JAX's
// int8_apply(...) + bias then .astype(dtype) does, rounding for rounding: it
// saves the model two elementwise launches a projection. x arrives as f32 or
// bf16 and is rounded to bf16 first, as JAX's x.astype(bf16) does. A bf16
// value times an int8 value fits f32's 24-bit significand, so every product
// is exact and only the order of the f32 sums differs from the plain
// version.
//
// What bounds it. At decode (m = 4 lanes x t = 1) bytes: a call must read
// the int8 weights once, k*n bytes, beside which x, the scales and the
// output are small. At the slice's shapes (d 1024, d_ff 4096, 4 KV heads of
// 64, vocab 32768) a layer's q 1024x1024, kv 1024x512, out 1024x1024,
// in_proj 1024x4096 and out_proj 4096x1024 and the head's 1024x32768 are
// 121.6 MB a decode forward: 36.3 us at 3.35 TB/s, against 72.6 us for the
// same weights in bf16. At prefill (m up to 3500) operations: 2 m k n at
// 989 TFLOP/s, e.g. 29.7 us for m=3500 against 1024x4096. `design` below
// fixes which of three kernels a call runs; int8_design reports it.
//
// m <= 8 (decode, and the head's last prompt row): int8_stream, the design
// of the port's first B5, kept because it measured fastest (PERF.md): it
// reads each weight byte once per call, not once per row of x. CTA (tile,
// split) owns 128 columns and a chunk of k rows; its x chunk, rounded to
// bf16, sits in shared memory as f32. Each thread walks rows of its 16
// columns with one 16-byte load a row (8
// threads cover a 128-byte row segment, so a warp reads 4 whole lines), up
// to eight loads in flight (the next four rows load while the last four
// are summed), widens the int8 values to f32 with a byte permute and one
// add (exact; no int-to-float conversion unit), and keeps m x 16 f32 sums
// in registers. The 16 row lanes of a CTA are summed by shuffles and then
// in shared memory, in a fixed order. A small n gives few 128-column tiles
// (4 for kv), so k is split over up to 8 CTAs (k_split aims at 2 CTAs an
// SM), which form one thread-block cluster; after a cluster barrier each
// CTA adds a share of the tile's columns over all the splits' partials,
// read through distributed shared memory in split order: one launch, no
// scratch in device memory, no atomics, the same sums every run. At these
// shapes a call moves 0.5 to 32 MB, so its time is mostly fixed cost: a
// one-CTA call takes about 3.2 us. A redesign that streamed each CTA's slab
// by TMA into an mbarrier ring, over enough CTAs to fill every SM, measured
// slower at every decode shape of the slice, with any tiling, and its
// loads alone took as long as this kernel's whole call (PERF.md).
// m > 8 with bf16 x (prefill; also k past 8 chunks of 1024): int8_wgmma,
// warp-specialised as the flash kernels are. One thread issues TMA copies
// of the x tile (128 rows x 64 k) and the int8 weight tile (64 k x 128
// columns), both with the 128-byte swizzle, into a ring of four stages.
// The product runs transposed, out^T = W^T x^T: each of two warpgroups owns
// 64 weight columns as wgmma's M side and widens them from the int8 tile
// straight into register A fragments (exact: |w| <= 127 fits bf16), and
// x's 128 rows are the N side, read K-major from shared memory (wgmma
// m64n128k16, f32 sums). The bf16 weights never pass through shared
// memory, which the products' operand reads and the copies already keep
// busy. Two warpgroups a CTA and two CTAs an SM, so that one CTA's ring
// fill and epilogue run under the other's products. Scale, bias and cast in
// the epilogue.
// The same with f32 x (the f32 engine's prefills): int8_tiled, a plain
// tensor-core tile: a CTA of 4 warps owns a 128x64 output tile and walks k
// in steps of 32, the x tile rounded to bf16 and the int8 tile upcast into
// shared memory, read by ldmatrix into mma.sync.m16n8k16 fragments.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

namespace cg = cooperative_groups;

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kNAlign = 128;  // n a multiple of this; k of kBK
// int8_stream: a CTA's 128 columns, 16 a thread, so 8 column groups and
// 16 rows in flight.
constexpr int kCols = 128;
constexpr int kColGroups = kCols / 16;
constexpr int kRowLanes = kThreads / kColGroups;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;        // weight rows a thread loads at once
constexpr int kMaxRows = 8;       // rows of x it serves (1, 2, 4 or 8)
constexpr int kMinChunk = 64;     // k rows a CTA takes at least when split
constexpr int kMaxChunk = 1024;   // k rows a CTA stages (32 KB at 8 rows)
constexpr int kMaxSplits = 8;     // CTAs of a cluster (the portable most)
constexpr int kCtasPerSm = 2;     // CTAs an SM the splits aim at
// int8_tiled: a CTA's 128x64 tile, k steps of 32, each warp 32 rows.
constexpr int kBM = 128;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kLdX = kBK + 8;  // bf16 pitches, padded by 16 bytes: rows stay
constexpr int kLdW = kBN + 8;  // 16-byte aligned, ldmatrix spreads on banks
// int8_wgmma: a CTA's tile of 128 weight columns x 128 rows of x in two
// warpgroups of 64 columns, two CTAs an SM, k steps of 64.
constexpr int kPC = 2;  // warpgroups
constexpr int kPM = 128, kPN = 64 * kPC, kPK = 64;
constexpr int kPStages = 4;
// Shared memory of int8_wgmma: per stage the x tile, then per stage the
// weight tile (one swizzled box), the barriers (full, empty).
constexpr int kPXBytes = kPM * kPK * 2;  // 16 KB
constexpr int kPWBytes = kPK * kPN;      // 8 KB
constexpr int kPW = kPStages * kPXBytes;
constexpr int kPBars = kPW + kPStages * kPWBytes;
constexpr int kPBytes = kPBars + 8 * 2 * kPStages;

enum Design { kTiled = 0, kStream = 1, kWgmma = 2 };

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float round_bf16(bf16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

// The epilogue: sum * scale, plus the bias when there is one, each rounded
// to f32 on its own (no fused multiply-add), cast to T.
template <typename T>
__device__ __forceinline__ T epilogue(float sum, const float* scale,
                                      const float* bias, int col) {
  const float v = __fmul_rn(sum, scale[col]);
  return from_f32<T>(bias ? __fadd_rn(v, bias[col]) : v);
}

// Four int8 values packed in u, widened to f32 exactly: each byte, biased
// by 128 (xor 0x80), becomes the low byte of the bit pattern of 2^23, whose
// last significand bit is 1; subtracting 2^23 + 128 leaves the value.
__device__ __forceinline__ void int8x4_to_f32(uint32_t u, float* f) {
  const uint32_t v = u ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7650 + j)) -
           8388736.f;
}

__device__ __forceinline__ void int8x16_to_f32(uint4 u, float* f) {
  int8x4_to_f32(u.x, f);
  int8x4_to_f32(u.y, f + 4);
  int8x4_to_f32(u.z, f + 8);
  int8x4_to_f32(u.w, f + 12);
}

// acc[i][j] += x[i][r] * w[r][c0 + j] for the M staged rows of x.
template <int M>
__device__ __forceinline__ void fma_row(float (&acc)[M][16], uint4 u,
                                        const float* xs, int chunk, int r) {
  float wf[16];
  int8x16_to_f32(u, wf);
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float xv = xs[i * chunk + r];
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[i][j] = fmaf(xv, wf[j], acc[i][j]);
  }
}

// Rows r0, r0 + kRowLanes, ... of a thread's 16 weight columns (one
// 16-byte load each), zeros at or past `rows`.
__device__ __forceinline__ void load_rows(uint4 (&u)[kUnroll],
                                          const int8_t* wp, int n, int r0,
                                          int rows) {
#pragma unroll
  for (int i = 0; i < kUnroll; ++i) {
    const int r = r0 + i * kRowLanes;
    u[i] = r < rows ? __ldg(reinterpret_cast<const uint4*>(wp + size_t(r) * n))
                    : make_uint4(0u, 0u, 0u, 0u);
  }
}

// Decode: CTA (tile, split) sums rows [split*chunk, +chunk) of k for
// columns [tile*kCols, +kCols) and the m <= M rows of x. With one split it
// writes the output; otherwise the tile's splits, one cluster, add their
// partial sums through distributed shared memory.
template <typename TX, typename TO, int M>
__global__ void __launch_bounds__(kThreads)
int8_stream(const TX* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ scale, const float* __restrict__ bias,
            TO* __restrict__ out, int m, int k, int n, int chunk,
            int splits) {
  extern __shared__ __align__(16) float smem[];
  const int tile = blockIdx.x, split = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = tid % kColGroups, rl = tid / kColGroups;
  const int k0 = split * chunk, rows = min(chunk, k - k0);

  // The first weight rows are requested before x is staged, so that the
  // two waits overlap.
  const int8_t* wp = w + size_t(k0) * n + size_t(tile) * kCols + cg * 16;
  uint4 u[kUnroll];
  load_rows(u, wp, n, rl, rows);
  float* xs = smem;  // [M][chunk]: x's rows over this chunk, bf16-rounded
  for (int e = tid; e < M * chunk; e += kThreads) {
    const int i = e / chunk, r = e % chunk;
    xs[e] = i < m && r < rows ? round_bf16(x[size_t(i) * k + k0 + r]) : 0.f;
  }
  float acc[M][16];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;
  __syncthreads();

  // Each batch's sums run while the next batch's loads are in flight.
  for (int r0 = rl; r0 < rows; r0 += kUnroll * kRowLanes) {
    uint4 next[kUnroll];
    load_rows(next, wp, n, r0 + kUnroll * kRowLanes, rows);
#pragma unroll
    for (int i = 0; i < kUnroll; ++i)
      if (r0 + i * kRowLanes < rows)
        fma_row<M>(acc, u[i], xs, chunk, r0 + i * kRowLanes);
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) u[i] = next[i];
  }

  // The 4 row lanes of a warp (lanes 8 apart) by shuffles, then the warps
  // in order through shared memory, which x no longer needs.
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float v = acc[i][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[i][j] = v;
    }
  __syncthreads();
  float* red = smem;  // [kWarps][M][kCols]
  if (lane < kColGroups) {
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j)
        red[(warp * M + i) * kCols + cg * 16 + j] = acc[i][j];
  }
  __syncthreads();
  // This CTA's sums [M][kCols], its warps added in order, past the staging
  // area in shared memory: the output with one split, else its partial.
  const int stage = max(M * chunk, kWarps * M * kCols);
  float* part = smem + stage;
  for (int e = tid; e < M * kCols; e += kThreads) {
    const int i = e / kCols, c = e % kCols;
    float s = red[i * kCols + c];
#pragma unroll
    for (int wv = 1; wv < kWarps; ++wv) s += red[(wv * M + i) * kCols + c];
    if (splits > 1)
      part[e] = s;
    else if (i < m)
      out[size_t(i) * n + tile * kCols + c] =
          epilogue<TO>(s, scale, bias, tile * kCols + c);
  }
  if (splits == 1) return;

  // The splits of a tile are one thread-block cluster. After its barrier,
  // CTA rank r sums its share of the tile's columns over every split's
  // partial, read from that CTA's shared memory, in split order; the second
  // barrier keeps each CTA's partial alive until all have read it.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int cols = kCols / splits;
  const int c0 = int(cluster.block_rank()) * cols;
  for (int e = tid; e < m * cols; e += kThreads) {
    const int i = e / cols, c = c0 + e % cols;
    float s = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < splits; ++sp)
      s += cluster.map_shared_rank(part, sp)[i * kCols + c];
    out[size_t(i) * n + tile * kCols + c] =
        epilogue<TO>(s, scale, bias, tile * kCols + c);
  }
  cluster.sync();
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return uint32_t(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (uint32_t(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
}

// This thread's A fragments of one k step: the int8 weight tile (kPK k rows
// x kPN columns, TMA's 128-byte swizzle: 16-byte chunk j of row r at j ^
// (r % 8)) transposed, widened to bf16, for the 16 columns n_base + [0, 16)
// that its warp owns. Fragment row g stands for column n_base + 2 g and row
// g + 8 for n_base + 2 g + 1, so that both come from one 2-byte load a k
// row; the epilogue undoes the order. For k slice kk the thread (g, t)
// needs k rows 2t, 2t+1 (registers 0 and 1) and 2t+8, 2t+9 (2 and 3) of the
// slice.
__device__ __forceinline__ void widen_a(uint32_t (&a)[kPK / 16][4],
                                        const unsigned char* w8, int n_base,
                                        int g, int t) {
  const int col = n_base + 2 * g;  // a multiple of 2 within one chunk
  const int chunk = col >> 4, byte = col & 15;
#pragma unroll
  for (int kk = 0; kk < kPK / 16; ++kk) {
    uint32_t pair[4];  // (column 2g, 2g+1) of k rows 2t, 2t+1, 2t+8, 2t+9
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = kk * 16 + 2 * t + (q & 1) + 8 * (q >> 1);
      pair[q] = *reinterpret_cast<const uint16_t*>(
          w8 + r * kPN + (((chunk ^ (r & 7)) << 4) | byte));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float f[4];  // rows 2t(+8) and 2t+1(+8), each at columns 2g, 2g+1
      int8x4_to_f32(pair[2 * h] | (pair[2 * h + 1] << 16), f);
      a[kk][2 * h] = pack(f[0], f[2]);      // column 2g: fragment row g
      a[kk][2 * h + 1] = pack(f[1], f[3]);  // column 2g+1: row g + 8
    }
  }
}

// Prefill with bf16 x, out^T = W^T x^T: CTA (n tile, m tile) computes a
// 128 (n) x 128 (m) tile of out^T. Warpgroup w owns columns [64 w, 64 w +
// 64) of the n tile as wgmma's M side, with the weights widened straight
// from the stage's int8 tile into A fragments (widen_a; no bf16 copy in
// shared memory); x's 128 rows are the N side, read K-major from the TMA
// tile. Thread 0 fills the ring of stages, each refill as soon as every warp
// has released the stage. Each warpgroup widens a step, issues its
// products, waits for them and releases the stage; its 64 sums and one
// step's fragments fit the 128 registers that two CTAs of 256 threads an SM
// leave, and the SM's other three warpgroups' products keep the tensor
// cores busy meanwhile. This tile measured faster than one of 256 columns
// (four warpgroups, one CTA an SM, half the x tile's trips through L2):
// 0.0660 against 0.0760 ms at m=3500, 1024x4096, and than issuing each 16-k
// slice's product as soon as that slice was widened (PERF.md).
template <typename TO>
__global__ void __launch_bounds__(kPC * 128, 2)
int8_wgmma(const __grid_constant__ CUtensorMap xm,
           const __grid_constant__ CUtensorMap wm,
           const float* __restrict__ scale, const float* __restrict__ bias,
           TO* __restrict__ out, int m, int k, int n) {
  unsigned char* smem = sm90::aligned_smem();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kPBars);
  uint64_t* empty = full + kPStages;
  const int n0 = blockIdx.x * kPN, m0 = blockIdx.y * kPM;
  const int steps = (k + kPK - 1) / kPK;
  const int wg = sm90::warpgroup();

  // Step i's x and weight tiles into stage i % kPStages.
  auto load = [&](int i) {
    const int s = i % kPStages;
    sm90::mbar_arrive_expect_tx(&full[s], kPXBytes + kPWBytes);
    sm90::tma_load_2d(smem + s * kPXBytes, &xm, &full[s], i * kPK, m0);
    sm90::tma_load_2d(smem + kPW + s * kPWBytes, &wm, &full[s], n0, i * kPK);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kPStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kPC * 4);  // one arrive a warp
    }
    sm90::fence_barrier_init();
    sm90::prefetch_map(&xm);
    sm90::prefetch_map(&wm);
    for (int i = 0; i < kPStages && i < steps; ++i) load(i);
  }
  __syncthreads();

  const int tid = threadIdx.x % 128;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int n_base = wg * 64 + warp * 16;  // this warp's 16 columns
  float acc[kPM / 8][4];  // out^T: columns 2g (+1) of the warp x the m tile
#pragma unroll
  for (int j = 0; j < kPM / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  uint32_t a[kPK / 16][4];
  for (int i = 0; i < steps; ++i) {
    const int s = i % kPStages;
    // Thread 0 refills the stage that every warp released after step i - 1
    // with step i - 1 + kPStages.
    if (threadIdx.x == 0 && i > 0 && i - 1 + kPStages < steps) {
      sm90::mbar_wait(&empty[(i - 1) % kPStages], ((i - 1) / kPStages) & 1);
      load(i - 1 + kPStages);
    }
    sm90::mbar_wait(&full[s], (i / kPStages) & 1);
    widen_a(a, smem + kPW + s * kPWBytes, n_base, g, t);
    const unsigned char* xs = smem + s * kPXBytes;
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kPK / 16; ++kk)
      sm90::wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&acc[0][0]),
                          a[kk], sm90::desc_sw128(xs + kk * 32));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int kk = 0; kk < kPK / 16; ++kk) sm90::fence_regs(a[kk]);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
  }
#pragma unroll
  for (int j = 0; j < kPM / 8; ++j) sm90::fence_regs(acc[j]);

  // acc[j][i]: column col + (i >> 1), row m0 + 8j + 2t + (i & 1).
  const int col = n0 + n_base + 2 * g;
  const float s0 = scale[col], s1 = scale[col + 1];
  const float b0 = bias ? bias[col] : 0.f, b1 = bias ? bias[col + 1] : 0.f;
#pragma unroll
  for (int j = 0; j < kPM / 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int row = m0 + 8 * j + 2 * t + c;
      if (row >= m) continue;
      float v0 = __fmul_rn(acc[j][c], s0), v1 = __fmul_rn(acc[j][2 + c], s1);
      if (bias) v0 = __fadd_rn(v0, b0), v1 = __fadd_rn(v1, b1);
      TO* dst = out + size_t(row) * n + col;
      dst[0] = from_f32<TO>(v0);
      dst[1] = from_f32<TO>(v1);
    }
}

// The m16n8k16 product on fragments (lane = 4 g + t): A 16x16 row-major
// read by ldmatrix.x4, two B 16x8 fragments of a row-major [k][n] tile by
// ldmatrix.x4.trans; C c[0], c[1] at (row g, cols 2t, 2t+1), c[2], c[3] at
// row g + 8. The same helpers as flash_attention.cu's Mma<bf16>.
struct FragA {
  uint32_t r[4];
};
struct FragB {
  uint32_t r[2];
};

__device__ __forceinline__ FragA load_a(const bf16* p, int ld, int lane) {
  FragA a;
  const unsigned s = static_cast<unsigned>(
      __cvta_generic_to_shared(p + (lane & 15) * ld + (lane >> 4) * 8));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a.r[0]), "=r"(a.r[1]), "=r"(a.r[2]), "=r"(a.r[3])
      : "r"(s));
  return a;
}

// B[k][n] = p[k * ld + n] for k in [0, 16), n in [0, 8) (lo) and [8, 16)
// (hi).
__device__ __forceinline__ void load_bn2(FragB& lo, FragB& hi, const bf16* p,
                                         int ld, int lane) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(
      p + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(lo.r[0]), "=r"(lo.r[1]), "=r"(hi.r[0]), "=r"(hi.r[1])
      : "r"(s));
}

__device__ __forceinline__ void mma(float* c, const FragA& a,
                                    const FragB& b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]),
        "r"(b.r[1]));
}

// Rows [m0, m0 + kBM) x cols [k0, k0 + kBK) of x into xs as bf16; rows at
// or past m are zero.
__device__ __forceinline__ void load_x_tile(bf16* xs, const bf16* x, int m,
                                            int k, int m0, int k0) {
  for (int e = threadIdx.x; e < kBM * (kBK / 8); e += kThreads) {
    const int r = e / (kBK / 8), c = (e % (kBK / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < m)
      v = __ldg(reinterpret_cast<const uint4*>(x + size_t(m0 + r) * k + k0 +
                                               c));
    *reinterpret_cast<uint4*>(xs + r * kLdX + c) = v;
  }
}

__device__ __forceinline__ void load_x_tile(bf16* xs, const float* x, int m,
                                            int k, int m0, int k0) {
  for (int e = threadIdx.x; e < kBM * (kBK / 4); e += kThreads) {
    const int r = e / (kBK / 4), c = (e % (kBK / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m0 + r < m)
      v = __ldg(reinterpret_cast<const float4*>(x + size_t(m0 + r) * k + k0 +
                                                c));
    *reinterpret_cast<uint2*>(xs + r * kLdX + c) =
        make_uint2(pack(v.x, v.y), pack(v.z, v.w));
  }
}

// Prefill with f32 x: CTA (n tile, m tile) computes a kBM x kBN output
// tile; warp w owns its rows [32 w, 32 w + 32) and all kBN columns.
template <typename TX, typename TO>
__global__ void __launch_bounds__(kThreads)
int8_tiled(const TX* __restrict__ x, const int8_t* __restrict__ w,
           const float* __restrict__ scale, const float* __restrict__ bias,
           TO* __restrict__ out, int m, int k, int n) {
  __shared__ __align__(16) uint16_t xs_raw[kBM * kLdX];  // bf16 tiles
  __shared__ __align__(16) uint16_t ws_raw[kBK * kLdW];
  bf16* xs = reinterpret_cast<bf16*>(xs_raw);
  bf16* ws = reinterpret_cast<bf16*>(ws_raw);
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float acc[2][kBN / 8][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < kBN / 8; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    load_x_tile(xs, x, m, k, m0, k0);
    {
      // The int8 tile, kBK x kBN = one 16-byte vector a thread, upcast to
      // bf16 (exact) on its way into shared memory.
      const int r = tid / (kBN / 16), c = (tid % (kBN / 16)) * 16;
      const uint4 u = __ldg(
          reinterpret_cast<const uint4*>(w + size_t(k0 + r) * n + n0 + c));
      float f[16];
      int8x16_to_f32(u, f);
      uint4* dst = reinterpret_cast<uint4*>(ws + r * kLdW + c);
      dst[0] = make_uint4(pack(f[0], f[1]), pack(f[2], f[3]),
                          pack(f[4], f[5]), pack(f[6], f[7]));
      dst[1] = make_uint4(pack(f[8], f[9]), pack(f[10], f[11]),
                          pack(f[12], f[13]), pack(f[14], f[15]));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const FragA a0 = load_a(xs + (warp * 32) * kLdX + kk * 16, kLdX, lane);
      const FragA a1 =
          load_a(xs + (warp * 32 + 16) * kLdX + kk * 16, kLdX, lane);
#pragma unroll
      for (int nf = 0; nf < kBN / 8; nf += 2) {
        FragB lo, hi;
        load_bn2(lo, hi, ws + kk * 16 * kLdW + nf * 8, kLdW, lane);
        mma(acc[0][nf], a0, lo);
        mma(acc[0][nf + 1], a0, hi);
        mma(acc[1][nf], a1, lo);
        mma(acc[1][nf + 1], a1, hi);
      }
    }
    __syncthreads();
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nf = 0; nf < kBN / 8; ++nf) {
    const int col = n0 + nf * 8 + 2 * t;
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + warp * 32 + mf * 16 + g + 8 * half;
        if (row >= m) continue;
        TO* dst = out + size_t(row) * n + col;
        dst[0] = epilogue<TO>(acc[mf][nf][2 * half], scale, bias, col);
        dst[1] = epilogue<TO>(acc[mf][nf][2 * half + 1], scale, bias,
                              col + 1);
      }
  }
}

// The design a call runs, fixed here and nowhere else: the weight stream
// for up to 8 rows of x and k up to 8 chunks of 1024; above that the TMA +
// wgmma tile for bf16 x, the mma.sync tile for f32 x (the f32 engine's
// prefills).
Design design(int m, int k, int x_bf16) {
  if (m <= kMaxRows && k <= kMaxSplits * kMaxChunk) return kStream;
  return x_bf16 ? kWgmma : kTiled;
}

// The current device's SM count, read once a device.
cudaError_t sm_count(int* sms) {
  constexpr int kDevices = 64;
  static int cached[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && cached[dev]) {
    *sms = cached[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < kDevices) cached[dev] = *sms;
  return err;
}

// The splits of k for int8_stream: they double, up to kMaxSplits, while a
// chunk exceeds kMaxChunk, and further while the card holds fewer than
// kCtasPerSm CTAs an SM and a split keeps at least kMinChunk rows. On 132
// SMs: 1024x1024 -> 8 chunks of 128, 1024x512 -> 8 of 128, 1024x4096 -> 8
// of 128, 4096x1024 -> 8 of 512, the head's 1024x32768 -> 2 of 512. No
// chunk is empty (each has >= kMinChunk rows).
int k_split(int k, int n, int sms) {
  const int tiles = n / kCols;
  int splits = 1;
  while (splits < kMaxSplits &&
         ((k + splits - 1) / splits > kMaxChunk ||
          (splits * tiles < kCtasPerSm * sms &&
           k / (2 * splits) >= kMinChunk)))
    splits *= 2;
  return splits;
}

template <typename TX, typename TO, int M>
cudaError_t launch_stream(const void* x, const int8_t* w, const float* scale,
                          const float* bias, void* out, int m, int k, int n,
                          int sms, cudaStream_t stream) {
  const int splits = k_split(k, n, sms);
  const int chunk = (k + splits - 1) / splits;
  // The staging area (x's chunk, then the warps' sums) and the partial.
  const size_t stage = size_t(M) * size_t(chunk > kWarps * kCols
                                               ? chunk
                                               : kWarps * kCols);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(n / kCols, splits);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = sizeof(float) * (stage + size_t(M) * kCols);
  config.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = unsigned(splits);
  cluster.val.clusterDim.z = 1;
  config.attrs = &cluster;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, int8_stream<TX, TO, M>, static_cast<const TX*>(x), w, scale,
      bias, static_cast<TO*>(out), m, k, n, chunk, splits);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename TO>
cudaError_t launch_wgmma(const void* x, const int8_t* w, const float* scale,
                         const float* bias, void* out, int m, int k, int n,
                         cudaStream_t stream) {
  CUtensorMap xm, wm;
  cudaError_t err = sm90::encode_2d_map(
      &xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, m, k, 2ll * k, kPK, kPM,
      CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  err = sm90::encode_2d_map(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, k, n, n,
                            kPN, kPK, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  static bool done = false;
  constexpr size_t bytes = kPBytes + 1024;
  err = sm90::opt_in(int8_wgmma<TO>, bytes, &done);
  if (err != cudaSuccess) return err;
  int8_wgmma<TO><<<dim3(n / kPN, (m + kPM - 1) / kPM), kPC * 128, bytes,
                   stream>>>(
      xm, wm, scale, bias, static_cast<TO*>(out), m, k, n);
  return cudaGetLastError();
}

template <typename TX, typename TO>
cudaError_t launch(const void* x, const int8_t* w, const float* scale,
                   const float* bias, void* out, int m, int k, int n,
                   cudaStream_t stream) {
  const Design d = design(m, k, std::is_same<TX, bf16>::value);
  if constexpr (std::is_same<TX, bf16>::value) {
    if (d == kWgmma)
      return launch_wgmma<TO>(x, w, scale, bias, out, m, k, n, stream);
  }
  if (d != kStream) {
    int8_tiled<TX, TO><<<dim3(n / kBN, (m + kBM - 1) / kBM), kThreads, 0,
                         stream>>>(static_cast<const TX*>(x), w, scale, bias,
                                   static_cast<TO*>(out), m, k, n);
    return cudaGetLastError();
  }
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  if (m == 1)
    return launch_stream<TX, TO, 1>(x, w, scale, bias, out, m, k, n, sms,
                                    stream);
  if (m == 2)
    return launch_stream<TX, TO, 2>(x, w, scale, bias, out, m, k, n, sms,
                                    stream);
  if (m <= 4)
    return launch_stream<TX, TO, 4>(x, w, scale, bias, out, m, k, n, sms,
                                    stream);
  return launch_stream<TX, TO, 8>(x, w, scale, bias, out, m, k, n, sms,
                                  stream);
}

cudaError_t dispatch(const void* x, const void* w_q, const void* scale,
                     const void* bias, void* out, int m, int k, int n,
                     int x_bf16, int out_bf16, void* stream) {
  const int8_t* w = static_cast<const int8_t*>(w_q);
  const float* s = static_cast<const float*>(scale);
  const float* bs = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return out_bf16
               ? launch<bf16, bf16>(x, w, s, bs, out, m, k, n, st)
               : launch<bf16, float>(x, w, s, bs, out, m, k, n, st);
  return out_bf16
             ? launch<float, bf16>(x, w, s, bs, out, m, k, n, st)
             : launch<float, float>(x, w, s, bs, out, m, k, n, st);
}

bool bad_geometry(int m, int k, int n) {
  return m < 1 || k < kBK || n < kNAlign || k % kBK || n % kNAlign;
}

}  // namespace

// x [m,k] (x_bf16: 1 = bf16, 0 = f32), w_q [k,n] int8, scale [n] f32, bias
// [n] f32 or null, out [m,n] (out_bf16: 1 = bf16, 0 = f32). All
// contiguous, 16-byte aligned; n % 128 == 0, k % 32 == 0. Launches on
// `stream` on the current device, allocates nothing, does not synchronise,
// and returns the launch's error (0 = launched).
extern "C" int int8_matmul_launch(const void* x, const void* w_q,
                                  const void* scale, const void* bias,
                                  void* out, int m, int k, int n, int x_bf16,
                                  int out_bf16, void* stream) {
  if (bad_geometry(m, k, n)) return int(cudaErrorInvalidValue);
  return int(dispatch(x, w_q, scale, bias, out, m, k, n, x_bf16, out_bf16,
                      stream));
}

// Which kernel a call of this geometry runs: 0 = mma.sync tile (f32 x
// prefill), 1 = weight stream (m <= 8), 2 = TMA + wgmma tile (bf16 x
// prefill); -1 outside the kernels' geometry.
extern "C" int int8_design(int m, int k, int n, int x_bf16) {
  if (bad_geometry(m, k, n)) return -1;
  return int(design(m, k, x_bf16));
}
