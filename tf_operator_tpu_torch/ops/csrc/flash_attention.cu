// Flash attention forward and backward for Hopper (sm_90a): three kernels
// with plain C entry points, built by ops/_build.py and called through ctypes
// by ops/flash_attention.py.
//
// Replaces tf_operator_tpu/ops/flash_attention.py:
//   flash_fwd  <- _fwd_kernel (:253, pallas_call :408)   O and the row LSE
//   flash_dq   <- _dq_kernel  (:297, pallas_call :455)   dQ
//   flash_dkv  <- _dkv_kernel (:331, pallas_call :475)   dK and dV
// For query row r and key column c of head (b, h), with scale = Dh^-1/2 by
// default and, under causal (tq == tk), only columns c <= r taking part:
//
//   s[r,c]  = (q[r] . k[c]) * scale                              f32
//   lse[r]  = m + log(max(l, 1e-30))    m = max_c s, l = sum_c exp(s - m)
//   o[r]    = sum_c T(exp(s - m)) v[c] / l                        T = v's type
//   p[r,c]  = exp(s[r,c] - lse[r])                               recomputed
//   ds[r,c] = T(p * (do[r] . v[c] - delta[r]) * scale)   delta = rowsum(do*o)
//   dq[r]   = sum_c ds[r,c] k[c]
//   dk[c]   = sum_r ds[r,c] q[r]        dv[c] = sum_r T(p[r,c]) do[r]
//
// q, k, v and do are read as [B, T, H, Dh] through their strides (the model
// hands over slices of its fused qkv projection without a copy); o, dq, dk
// and dv are written contiguous [B, T, H, Dh]; lse and delta are f32
// [B, H, T]. Every sum is f32.
//
// What bounds it: operations. At the training shape (B=2, H=16, T=8192,
// Dh=64, bf16, causal) the forward does 2 products of 2*Dh flops per
// (row, column) pair over T(T+1)/2 pairs a head, 2.75e11 flops, against
// 134 MB of q/k/v/o: about 2000 flops a byte, far above the H100's ~295
// flop/byte ridge, so the tensor cores' 989 TFLOP/s (0.28 ms) is the bound.
// dQ does 3 products and dK/dV 4.
//
// What both designs do about it:
//  - The TPU kernels walk a sequential grid and carry accumulators in VMEM
//    scratch from one grid step to the next. Here a CTA owns one tile and
//    walks the other axis in a loop: the forward and dQ kernels own a
//    query tile and walk key tiles; the dK/dV kernel owns a key tile and
//    walks query tiles from the first one the causal mask lets in, so no
//    sum crosses CTAs, nothing needs atomics and every run gives the same
//    bits.
//  - Causal tiles above the diagonal are neither loaded nor computed, only
//    tiles that straddle it are masked, and the grids start with the
//    longest walks so the short ones fill the tail.
//  - S, P and dS never leave registers: they stay in the products'
//    accumulator fragments, and P and dS, rounded to the input type, are
//    the A operand of the next product. The online softmax's running max
//    and sum and the O, dQ, dK and dV sums are registers too.
//
// Two designs; `design` below fixes which one each instance runs.
//
// The warp-specialised design (bf16 B1, B2 and B3 at Dh 64 and 128), the
// shape of FlashAttention-3. On Hopper only wgmma reaches the tensor cores'
// full rate, and copies issued by the math threads cost them registers and
// issue slots:
//  - A CTA has consumer warpgroups (two in B1, owning 64 query rows each
//    of its 128; two in B2 and B3 at Dh 64 and one at Dh 128, owning 64
//    query rows (B2) or 64 keys (B3) each) and one producer warp. One
//    producer thread issues TMA copies
//    (cp.async.bulk.tensor on a 4-D map of the strided input, rows past T
//    zero-filled) into a ring of stages, each with a full and an empty
//    mbarrier: the producer waits on empty and copies with an expected
//    byte count, the consumers wait on full and arrive on empty when done.
//    The tiles land with the 128-byte swizzle on 1024-byte boundaries,
//    the layout wgmma reads.
//  - Products are wgmma m64nNk16 (f32 sums): S = Q.K^T (B1, B2), dP =
//    dO.V^T (B2) and S^T = K.Q^T, dP^T = V.dO^T (B3) with both operands in
//    shared memory; O += P.V (B1), dQ += dS.K (B2), dV += P^T.dO and dK +=
//    dS^T.Q (B3) with A from registers and B read MN-major through the
//    descriptor's transpose bit.
//  - B2 walks 64-key tiles (its S and dP at 128 keys would not fit the
//    registers), issues tile j + 1's S and dP before tile j's dS.K so the
//    product runs under the next tile's exponentials, keeps its rows' lse
//    and delta in registers, and folds the scale into the dS step.
//  - B1 at Dh 64 issues tile j + 1's S before tile j's P.V, so P.V runs
//    under the next softmax, and its two warpgroups take turns on the
//    tensor cores (named barriers), so one's softmax runs under the other's
//    products. At Dh 64 the exponentials take as long on the MUFU as the
//    products on the tensor cores, so the softmax's ALU work is kept small:
//    the scale is folded into one FMA before a bare ex2.
//  - Registers: 9 warps cap a thread at 168 (3 warps share one of the
//    SM's four schedulers); ptxas held the consumers there even when a
//    producer warpgroup gave its registers away (setmaxnreg), so the
//    producer is one warp, and B3 at Dh 128 (128 f32 sums of dK and dV a
//    thread) and B2 at Dh 128 run one consumer warpgroup to reach 255. No
//    instance spills (chip_smoke checks ptxas).
//
// The mma.sync design (f32 everywhere, bf16 at Dh 32), the shape of
// FlashAttention-2:
//  - A CTA owns one 64-row tile with 4 warps of 16 rows each. Input tiles
//    go through shared memory by cp.async, the walked tiles
//    double-buffered, and the products run as mma.sync m16n8k16 with
//    operands read by ldmatrix. A thread holds two rows of each fragment
//    (g and g+8 of its 16), so row reductions take two shuffles within a
//    quad.
//  - Registers set how many CTAs share an SM; for bf16 at Dh <= 64 the
//    kernels are compiled to fit 4 (forward, dQ) and 3 (dK/dV).
//  - f32 inputs, which the exactness checks and the f32 trainer use, run
//    the product in f32 FMAs on the same fragment layout (operands
//    gathered from the quad by shuffles).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;              // rows a warp owns
constexpr int kTile = kWarps * kRows;  // rows of a CTA's tile
constexpr int kNt = kTile / 8;         // 8-column fragments across a tile
constexpr float kMasked = -1e30f;      // the reference's mask value

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Row pitch of a tile of T in shared memory: padded by 16 bytes, which keeps
// 16-byte row alignment and spreads a fragment's loads over the banks.
template <typename T>
__host__ __device__ constexpr int pitch(int cols) {
  return cols + 16 / int(sizeof(T));
}
__host__ __device__ constexpr size_t up(size_t bytes) {
  return (bytes + 127) & ~size_t(127);
}

// Strides (in elements) of one [B, T, H, Dh] input; Dh is contiguous.
struct View {
  long long sb, st, sh;
};

// Copy 16 bytes from device memory to shared memory without passing
// through registers; with `valid` false the 16 bytes are zero-filled and
// nothing is read. Completes at cp_async_wait.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's copy groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start loading rows [row0, row0 + kTile) of head (b, h) of a strided input
// into a [kTile][pitch] tile; rows at or past n are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, View v,
                                          int b, int h, int row0, int n) {
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kVecs = D / kPer;
  constexpr int ld = pitch<T>(D);
  const T* base = src + b * v.sb + h * v.sh;
  for (int e = threadIdx.x; e < kTile * kVecs; e += kThreads) {
    const int r = e / kVecs, c = (e % kVecs) * kPer;
    const bool in = row0 + r < n;
    cp_async16(dst + r * ld + c, in ? base + (row0 + r) * v.st + c : base,
               in);
  }
}

// The m16n8k16 product D += A.B on fragments, lane = 4 g + t:
//   A (16x16): (row g | g+8, col 2t, 2t+1 | 2t+8, 2t+9)
//   B (16x8):  (row 2t, 2t+1 | 2t+8, 2t+9, col g)
//   C (16x8):  c[0], c[1] at (row g, col 2t, 2t+1); c[2], c[3] at row g+8.
// Operands come from row-major shared-memory tiles: load_a reads a 16x16
// block, load_bt2 the B fragments of two 8-wide n-tiles whose k runs along
// a row (B[k][n] = src[n][k]: K for Q.K^T), load_bn2 two whose n runs
// along a row (B[k][n] = src[k][n]: V for P.V). For bf16 each is one
// ldmatrix.x4 (.trans for load_bn2). from_c turns two C fragments
// (columns 0-7 and 8-15 of a 16x16 block) into an A fragment, rounded
// to T.
template <typename T>
struct Mma;

template <>
struct Mma<bf16> {
  struct A {
    uint32_t r[4];
  };
  struct B {
    uint32_t r[2];
  };
  struct B2 {  // two B fragments: n-tiles n0 and n0 + 1
    B lo, hi;
  };
  static __device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
    return uint32_t(__bfloat16_as_ushort(lo)) |
           (uint32_t(__bfloat16_as_ushort(hi)) << 16);
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    return pack(__float2bfloat16(lo), __float2bfloat16(hi));
  }
  static __device__ __forceinline__ void ldsm(uint32_t (&r)[4],
                                              const bf16* p) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  }
  static __device__ __forceinline__ void ldsm_t(uint32_t (&r)[4],
                                                const bf16* p) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  }
  // Each lane names one 16-byte row of one of the four 8x8 matrices.
  static __device__ __forceinline__ A load_a(const bf16* p, int ld,
                                             int lane) {
    A a;
    ldsm(a.r, p + (lane & 15) * ld + (lane >> 4) * 8);
    return a;
  }
  static __device__ __forceinline__ B2 load_bt2(const bf16* p, int ld,
                                                int lane) {
    uint32_t r[4];
    ldsm(r, p + ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8);
    return B2{B{{r[0], r[1]}}, B{{r[2], r[3]}}};
  }
  static __device__ __forceinline__ B2 load_bn2(const bf16* p, int ld,
                                                int lane) {
    uint32_t r[4];
    ldsm_t(r, p + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8);
    return B2{B{{r[0], r[1]}}, B{{r[2], r[3]}}};
  }
  static __device__ __forceinline__ A from_c(const float* lo,
                                             const float* hi) {
    return A{{pack(lo[0], lo[1]), pack(lo[2], lo[3]), pack(hi[0], hi[1]),
              pack(hi[2], hi[3])}};
  }
  static __device__ __forceinline__ void mma(float* c, const A& a,
                                             const B& b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]),
          "r"(b.r[1]));
  }
};

template <>
struct Mma<float> {
  // The same fragments, one float a value: A r[0..7] = rows (g, g, g+8,
  // g+8, g, g, g+8, g+8) at cols (2t, 2t+1, 2t, 2t+1, 2t+8, 2t+9, 2t+8,
  // 2t+9); B r[0..3] = rows 2t, 2t+1, 2t+8, 2t+9 at col g.
  struct A {
    float r[8];
  };
  struct B {
    float r[4];
  };
  struct B2 {
    B lo, hi;
  };
  static __device__ __forceinline__ A load_a(const float* p, int ld,
                                             int lane) {
    const int g = lane >> 2, t = lane & 3;
    const float* r0 = p + g * ld + 2 * t;
    const float* r8 = p + (g + 8) * ld + 2 * t;
    return A{{r0[0], r0[1], r8[0], r8[1], r0[8], r0[9], r8[8], r8[9]}};
  }
  static __device__ __forceinline__ B load_bt(const float* p, int ld,
                                              int lane) {
    const float* r = p + (lane >> 2) * ld + 2 * (lane & 3);
    return B{{r[0], r[1], r[8], r[9]}};
  }
  static __device__ __forceinline__ B load_bn(const float* p, int ld,
                                              int lane) {
    const int g = lane >> 2, t = lane & 3;
    return B{{p[2 * t * ld + g], p[(2 * t + 1) * ld + g],
              p[(2 * t + 8) * ld + g], p[(2 * t + 9) * ld + g]}};
  }
  static __device__ __forceinline__ B2 load_bt2(const float* p, int ld,
                                                int lane) {
    return B2{load_bt(p, ld, lane), load_bt(p + 8 * ld, ld, lane)};
  }
  static __device__ __forceinline__ B2 load_bn2(const float* p, int ld,
                                                int lane) {
    return B2{load_bn(p, ld, lane), load_bn(p + 8, ld, lane)};
  }
  static __device__ __forceinline__ A from_c(const float* lo,
                                             const float* hi) {
    return A{{lo[0], lo[1], lo[2], lo[3], hi[0], hi[1], hi[2], hi[3]}};
  }
  // Row g's and g+8's k values come from the lanes of quad g; column 2t's
  // and 2t+1's from quads 2t and 2t+1. Sums in f32 FMAs. The loop stays
  // rolled: this path only checks exactness, and unrolled it multiplies
  // the kernels' code and build time.
  static __device__ __forceinline__ void mma(float* c, const A& a,
                                             const B& b) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 1
    for (int src = 0; src < 4; ++src) {
      float av[8], b0[4], b1[4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        av[i] = __shfl_sync(0xffffffffu, a.r[i], 4 * g + src);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        b0[i] = __shfl_sync(0xffffffffu, b.r[i], 8 * t + src);
        b1[i] = __shfl_sync(0xffffffffu, b.r[i], 8 * t + 4 + src);
      }
      // k order: (2src, 2src+1) then (2src+8, 2src+9).
      c[0] = fmaf(av[0], b0[0], fmaf(av[1], b0[1],
             fmaf(av[4], b0[2], fmaf(av[5], b0[3], c[0]))));
      c[1] = fmaf(av[0], b1[0], fmaf(av[1], b1[1],
             fmaf(av[4], b1[2], fmaf(av[5], b1[3], c[1]))));
      c[2] = fmaf(av[2], b0[0], fmaf(av[3], b0[1],
             fmaf(av[6], b0[2], fmaf(av[7], b0[3], c[2]))));
      c[3] = fmaf(av[2], b1[0], fmaf(av[3], b1[1],
             fmaf(av[6], b1[2], fmaf(av[7], b1[3], c[3]))));
    }
  }
};

// S[16][kTile] = A_rows[16][D] . B_rows[kTile][D]^T for one warp: both
// operands row-major tiles in shared memory, the result in C fragments.
template <typename T, int D>
__device__ __forceinline__ void scores(float (&s)[kNt][4], const T* a_rows,
                                       const T* b_rows, int lane) {
  constexpr int ld = pitch<T>(D);
#pragma unroll
  for (int n = 0; n < kNt; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const typename Mma<T>::A a = Mma<T>::load_a(a_rows + kk * 16, ld, lane);
#pragma unroll
    for (int n = 0; n < kNt; n += 2) {
      const typename Mma<T>::B2 b =
          Mma<T>::load_bt2(b_rows + n * 8 * ld + kk * 16, ld, lane);
      Mma<T>::mma(s[n], a, b.lo);
      Mma<T>::mma(s[n + 1], a, b.hi);
    }
  }
}

// acc[16][D] += P[16][kTile] . B_rows[kTile][D] for one warp: P in C
// fragments (rounded to T as the A operand), B a row-major shared tile.
template <typename T, int D>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4],
                                           float (&p)[kNt][4],
                                           const T* b_rows, int lane) {
  constexpr int ld = pitch<T>(D);
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    const typename Mma<T>::A a = Mma<T>::from_c(p[2 * kk], p[2 * kk + 1]);
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      const typename Mma<T>::B2 b =
          Mma<T>::load_bn2(b_rows + kk * 16 * ld + n * 8, ld, lane);
      Mma<T>::mma(acc[n], a, b.lo);
      Mma<T>::mma(acc[n + 1], a, b.hi);
    }
  }
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

// Write a warp's 16 rows of a D-wide sum (C fragments, times `mul` per
// row half) to contiguous [B, T, H, D] output rows.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* out, float (&acc)[D / 8][4],
                                           int b, int h, int heads, int n,
                                           int row_g, float mul_g,
                                           float mul_g8, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_g + 8 * half;
    if (row >= n) continue;
    const float mul = half ? mul_g8 : mul_g;
    T* dst = out + ((size_t(b) * n + row) * heads + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      dst[j * 8 + 2 * t] = from_f32<T>(acc[j][2 * half] * mul);
      dst[j * 8 + 2 * t + 1] = from_f32<T>(acc[j][2 * half + 1] * mul);
    }
  }
}

// CTAs an SM each kernel is compiled to fit by its register count: for
// bf16 at Dh <= 64, 4 for the forward and dQ (128 registers) and 3 for
// dK/dV (168); elsewhere the compiler's choice. A register more than
// that costs a whole CTA an SM.
template <typename T, int D>
constexpr int min_ctas(int bf16_small) {
  return sizeof(T) == 2 && D <= 64 ? bf16_small : 1;
}

template <typename T, int D>
__host__ __device__ constexpr size_t tile_bytes() {
  return up(sizeof(T) * kTile * pitch<T>(D));
}

// The streamed tiles are double-buffered: tile j + 1 loads while tile j
// is used.
template <typename T, int D>
constexpr size_t fwd_smem() {
  return 5 * tile_bytes<T, D>();  // q, then (k, v) twice
}

template <typename T, int D>
constexpr size_t dq_smem() {
  return 6 * tile_bytes<T, D>();  // q, do, then (k, v) twice
}

template <typename T, int D>
constexpr size_t dkv_smem() {
  // k, v, then (q, do) twice and (lse, delta) twice.
  return 6 * tile_bytes<T, D>() + 4 * up(sizeof(float) * kTile);
}

// ---- The warp-specialised design: bf16 B1 and B3 at Dh 64 and 128 ----

constexpr int kWg = 128;  // threads of a warpgroup
// Consumer warpgroups and one producer warp. A producer warpgroup that
// hands its registers to the consumers (setmaxnreg) bought nothing: ptxas
// still held the consumers' code to the launch bound's share, so one warp
// issues the copies.
__host__ __device__ constexpr int ws_threads(int consumers) {
  return consumers * kWg + 32;
}
constexpr int kBlock = 128;  // B1: query rows a CTA and keys a tile
constexpr int kFwdConsumers = kBlock / 64;  // B1: 64 query rows each

// B3: consumer warpgroups a CTA, each owning 64 keys. Two consumers and a
// producer warp are 9 warps, which put 3 on one of the SM's four
// schedulers and so cap a thread at 168 registers (the register file is
// split over the schedulers; two CTAs of 5 warps do the same). At Dh 64
// that holds a consumer: 64 f32 sums of dK and dV, S^T and dP^T of a 64-row
// query tile. At Dh 128 the sums alone take 128 of the 168 and the products
// spill at any query tile, so a CTA owns 64 keys with one consumer
// warpgroup: 5 warps, up to 255 registers a thread, in which 32-row query
// tiles fit without a spill (off the training shape's path).
template <int D>
__host__ __device__ constexpr int dkv_consumers() {
  return D == 64 ? 2 : 1;
}
// B3: query rows a streamed tile.
template <int D>
__host__ __device__ constexpr int q_tile() {
  return D == 64 ? 64 : 32;
}

// A tile of `rows` rows of Dh bf16 as TMA writes it: one 64-column box of
// rows x 128 bytes (128-byte swizzle) per 64 columns, the boxes one after
// the other.
__host__ __device__ constexpr int box_bytes(int rows) { return rows * 128; }
template <int D>
__host__ __device__ constexpr int ws_tile_bytes(int rows) {
  return box_bytes(rows) * (D / 64);
}

// Shared memory of the forward: Q, then K of each stage, V of each stage,
// the barriers (Q's, then full and empty per stage). Every tile starts on
// a 1024-byte boundary, as the 128-byte swizzle needs.
template <int D>
struct FwdLayout {
  static constexpr int kStages = D == 64 ? 3 : 2;  // 112 KB / 160 KB
  static constexpr int kTile = ws_tile_bytes<D>(kBlock);
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBars = kV + kStages * kTile;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages);
};

// Shared memory of dK/dV: K, V, then Q and dO of each stage, then lse and
// delta (f32, a query tile's rows each) of each stage, the barriers (K/V's,
// full, empty).
template <int D>
struct DkvLayout {
  static constexpr int kStages = D == 64 ? 3 : 6;
  static constexpr int kKeys = 64 * dkv_consumers<D>();
  static constexpr int kQRows = q_tile<D>();
  static constexpr int kKv = ws_tile_bytes<D>(kKeys);
  static constexpr int kTile = ws_tile_bytes<D>(kQRows);
  static constexpr int kK = 0;
  static constexpr int kV = kKv;
  static constexpr int kQ = 2 * kKv;
  static constexpr int kDo = kQ + kStages * kTile;
  static constexpr int kRows = kDo + kStages * kTile;
  static constexpr int kRowBytes = 2 * kQRows * 4;
  static constexpr int kBars = kRows + kStages * kRowBytes;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages);
};

// B2: consumer warpgroups a CTA, each owning 64 query rows, and the keys
// of a streamed tile. At Dh 64 two consumers and the producer warp (9
// warps, 168 registers a thread) hold a consumer's 32 f32 of S, 32 of dP,
// 32 of dQ sums and 16 of the bf16 dS operand; 128-key tiles would double
// S and dP past the cap. At Dh 128 the dQ sums take 64 and two tiles' S and
// dP are in flight at once, so a CTA runs one consumer warpgroup (5 warps,
// up to 255 registers), as B3 does.
template <int D>
__host__ __device__ constexpr int dq_consumers() {
  return D == 64 ? 2 : 1;
}
constexpr int kDqKeys = 64;

// Shared memory of dQ: Q and dO (64 rows a consumer), then K and V of each
// stage, the barriers (Q/dO's, full, empty).
template <int D>
struct DqLayout {
  static constexpr int kStages = 4;  // 96 KB at Dh 64, 160 KB at Dh 128
  static constexpr int kRows = 64 * dq_consumers<D>();
  static constexpr int kQTile = ws_tile_bytes<D>(kRows);
  static constexpr int kKvTile = ws_tile_bytes<D>(kDqKeys);
  static constexpr int kQ = 0;
  static constexpr int kDo = kQTile;
  static constexpr int kK = 2 * kQTile;
  static constexpr int kV = kK + kStages * kKvTile;
  static constexpr int kBars = kV + kStages * kKvTile;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages);
};

// Start the TMA loads of rows [row0, row0 + rows) of head (b, h) into a
// tile (one box per 64 columns); their bytes complete on `bar`.
template <int D>
__device__ __forceinline__ void tma_tile(unsigned char* dst,
                                         const CUtensorMap* map,
                                         uint64_t* bar, int b, int h,
                                         int row0, int rows) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    sm90::tma_load_4d(dst + c * box_bytes(rows), map, bar, c * 64, h,
                      row0, b);
}

// Descriptor of the 16-wide k slice kk of a K-major tile of `rows` rows
// (Dh along k): box kk / 4, 32 bytes further per slice within it.
__device__ __forceinline__ uint64_t k_major(const unsigned char* tile,
                                            int rows, int kk) {
  return sm90::desc_sw128(tile + (kk / 4) * box_bytes(rows) +
                          (kk % 4) * 32);
}

// Descriptor of rows [16 kk, 16 kk + 16) of an MN-major tile (rows along
// k), columns [64 c, 64 c + 64).
__device__ __forceinline__ uint64_t mn_major(const unsigned char* tile,
                                             int rows, int kk, int c) {
  return sm90::desc_sw128(tile + c * box_bytes(rows) + kk * 16 * 128);
}

template <int N>
__device__ __forceinline__ float (&flat(float (&a)[N][4]))[4 * N] {
  return *reinterpret_cast<float(*)[4 * N]>(&a[0][0]);
}

constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// 2^x on the MUFU, with a result below 2^-126 flushed to 0. exp2f (without
// fast math) wraps the same instruction in a range fix-up of two or three
// ALU instructions an element to keep such results; a probability that
// small changes no sum here, and the ALUs share the softmax's critical
// path with the MUFU.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One key tile's online-softmax step on a warp's rows of S (wgmma
// accumulator layout: this thread's rows row_g and row_g + 8, columns
// 8 n + 2 t + {0, 1}); with kMask, columns past tk or (causal) past the
// row are masked. The exponentials are base 2 with the scale folded in, as
// FlashAttention does: m is the running max of S scale log2(e), P =
// exp2(S scale log2(e) - m) = exp(S scale - m ln 2), one FMA and one ex2
// an element where exp(S scale - m) took eight instructions (the f32
// mma.sync kernels keep expf). Leaves P in s, updates m and l, and
// returns in alpha the factor the O sums are to be rescaled by.
template <bool kMask>
__device__ __forceinline__ void online_softmax(float (&s)[kBlock / 8][4],
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], int row_g,
                                               int col0, int t, int tk,
                                               float scale_log2, int causal) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < kBlock / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (kMask) {
        const int row = row_g + 8 * (i >> 1);
        const int col = col0 + n * 8 + 2 * t + (i & 1);
        if (!(col < tk && (!causal || col <= row))) s[n][i] = -INFINITY;
      }
      mx[i >> 1] = fmaxf(mx[i >> 1], s[n][i]);
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float m_new = fmaxf(m[hr], quad_max(mx[hr]) * scale_log2);
    alpha[hr] = ex2(m[hr] - m_new);
    m[hr] = m_new;
  }
#pragma unroll
  for (int n = 0; n < kBlock / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // masked: exp2(-inf) = 0
      s[n][i] = ex2(fmaf(s[n][i], scale_log2, -m[i >> 1]));
      sum[i >> 1] += s[n][i];
    }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
    l[hr] = l[hr] * alpha[hr] + quad_sum(sum[hr]);
}

// B3's scores to P^T and dS^T in place, on a warp's keys (rows key_g and
// key_g + 8 of the accumulator layout) against a query tile (columns 8 n
// + 2 t + {0, 1} from q0): P^T = exp2(S^T scale log2(e) - lse log2(e)),
// dS^T = P^T (dP^T - delta) scale, the arithmetic of flash_dkv above with
// the exponential in base 2; lse_s holds lse log2(e). With kMask, queries
// at or past tq and (causal) before the key are 0.
template <bool kMask, int N>
__device__ __forceinline__ void dkv_scores(float (&st)[N / 8][4],
                                           float (&dpt)[N / 8][4],
                                           const float* lse_s,
                                           const float* delta_s, int key_g,
                                           int q0, int t, int tq, float scale,
                                           float scale_log2, int causal) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = n * 8 + 2 * t + (i & 1);
      float p = ex2(fmaf(st[n][i], scale_log2, -lse_s[c]));
      if (kMask) {
        const int key = key_g + 8 * (i >> 1), row = q0 + c;
        if (!(row < tq && (!causal || row >= key))) p = 0.f;
      }
      st[n][i] = p;
      dpt[n][i] = p * (dpt[n][i] - delta_s[c]) * scale;
    }
}

// B1. Grid: x = 128-row query tile (longest rows first), y = head, z =
// batch. Warpgroups 0 and 1 own rows [0, 64) and [64, 128) of the tile;
// the producer warp after them, one thread of it, loads Q once and walks
// the key tiles through the ring of stages.
template <int D>
__global__ void __launch_bounds__(ws_threads(kFwdConsumers), 1)
flash_fwd_ws(const __grid_constant__ CUtensorMap qm,
             const __grid_constant__ CUtensorMap km,
             const __grid_constant__ CUtensorMap vm, bf16* __restrict__ o,
             float* __restrict__ lse, int heads, int tq, int tk, float scale,
             int causal) {
  using L = FwdLayout<D>;
  constexpr int S = L::kStages;
  unsigned char* smem = sm90::aligned_smem();
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + S;

  const int nq = (tq + kBlock - 1) / kBlock;
  const int qt = nq - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nk_all = (tk + kBlock - 1) / kBlock;
  const int nk = causal ? min(qt + 1, nk_all) : nk_all;
  const int wg = sm90::warpgroup();

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kFwdConsumers * 4);  // one arrive a warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == kFwdConsumers) {  // the producer
    if (threadIdx.x == kFwdConsumers * kWg) {
      sm90::prefetch_map(&qm);
      sm90::prefetch_map(&km);
      sm90::prefetch_map(&vm);
      sm90::mbar_arrive_expect_tx(q_full, L::kTile);
      tma_tile<D>(smem + L::kQ, &qm, q_full, b, h, qt * kBlock, kBlock);
      for (int j = 0; j < nk; ++j) {
        const int s = j % S;
        sm90::mbar_wait(&empty[s], ((j / S) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s], 2 * L::kTile);
        tma_tile<D>(smem + L::kK + s * L::kTile, &km, &full[s], b, h,
                    j * kBlock, kBlock);
        tma_tile<D>(smem + L::kV + s * L::kTile, &vm, &full[s], b, h,
                    j * kBlock, kBlock);
      }
    }
  } else {  // a consumer: 64 query rows
    const int tid = threadIdx.x % kWg;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int row0 = qt * kBlock + wg * 64;
    const int row_g = row0 + warp * 16 + g;  // and row_g + 8
    // This warpgroup's 64 rows of Q: 64 rows further into each box.
    const unsigned char* qs = smem + L::kQ + wg * 64 * 128;

    const float scale_log2 = scale * kLog2e;
    float acc[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f}, alpha[2];
    float sc[kBlock / 8][4];      // S of one key tile, then its P in f32
    Mma<bf16>::A p[kBlock / 16];  // P rounded to bf16: P.V's A operand

    // S = Q . K^T of key tile j into sc, issued and committed, not waited
    // for.
    auto issue_scores = [&](int j) {
      const unsigned char* ks = smem + L::kK + (j % S) * L::kTile;
      sm90::mbar_wait(&full[j % S], (j / S) & 1);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_ss_n128(flat(sc), k_major(qs, kBlock, kk),
                            k_major(ks, kBlock, kk), kk > 0);
      sm90::wgmma_commit();
    };
    // The softmax step of key tile j on sc once its product is done;
    // only tiles on the causal diagonal or past tk are masked.
    auto softmax = [&](int j) {
      sm90::fence_regs(flat(sc));
      const int col0 = j * kBlock;
      if ((causal && col0 + kBlock - 1 > row0) || col0 + kBlock > tk)
        online_softmax<true>(sc, m, l, alpha, row_g, col0, t, tk,
                             scale_log2, causal);
      else
        online_softmax<false>(sc, m, l, alpha, row_g, col0, t, tk,
                              scale_log2, causal);
    };

    // O += P . V of key tile j (P in p), issued and committed.
    auto issue_pv = [&](int j) {
      const unsigned char* vs = smem + L::kV + (j % S) * L::kTile;
      sm90::fence_regs(flat(acc));
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlock / 16; ++kk) {
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          sm90::wgmma_rs_n64(
              *reinterpret_cast<float(*)[32]>(&acc[8 * c][0]), p[kk].r,
              mn_major(vs, kBlock, kk, c));
      }
      sm90::wgmma_commit();
    };
    // P rounded to bf16 (the A operand), and O rescaled for tile j.
    auto to_operand = [&]() {
#pragma unroll
      for (int kk = 0; kk < kBlock / 16; ++kk)
        p[kk] = Mma<bf16>::from_c(sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
      for (int jd = 0; jd < D / 8; ++jd)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[jd][i] *= alpha[i >> 1];
    };
    auto release = [&](int j) {  // this warp is done with tile j's stage
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[j % S]);
    };
    // The two warpgroups take turns to issue products (FlashAttention-3's
    // ping-pong), so that one's softmax runs on the ALUs and MUFU while the
    // tensor cores run the other's products, where both would otherwise
    // reach their softmax together and leave the tensor cores idle. Named
    // barrier 1 + w holds warpgroup w until the other one has passed it the
    // turn by arriving there. Both warpgroups walk the same nk tiles and
    // take as many turns, so the turns stay paired: warpgroup 1 passes the
    // first turn before taking any, and warpgroup 0 takes the one it passes
    // last, so that no barrier is left half arrived.
    auto take_turn = [&]() { sm90::named_sync(1 + wg, 2 * kWg); };
    auto pass_turn = [&]() { sm90::named_arrive(2 - wg, 2 * kWg); };

    if (wg == 1) pass_turn();
    sm90::mbar_wait(q_full, 0);
    if constexpr (D == 64) {
      take_turn();
      issue_scores(0);
      pass_turn();
      sm90::wgmma_wait<0>();
      softmax(0);
      // Tile j + 1's S runs on the tensor cores ahead of tile j's P.V, and
      // its softmax while P.V runs: the warpgroup waits on a product only
      // when it needs the result. The last tile is peeled, so that no
      // product is issued under a branch (ptxas then serialises every
      // product of the kernel).
      for (int j = 0; j + 1 < nk; ++j) {
        to_operand();
        take_turn();
        issue_scores(j + 1);
        issue_pv(j);
        pass_turn();
        sm90::wgmma_wait<1>();  // tile j + 1's S (P.V may still run)
        softmax(j + 1);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(flat(acc));
        release(j);
      }
      to_operand();
      take_turn();
      issue_pv(nk - 1);
      pass_turn();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(flat(acc));
      release(nk - 1);
    } else {
      // At Dh 128 the sums of O take 64 registers: a second S would not
      // fit in 168, so each tile's products wait in turn.
      for (int j = 0; j < nk; ++j) {
        take_turn();
        issue_scores(j);
        pass_turn();
        sm90::wgmma_wait<0>();
        softmax(j);
        to_operand();
        take_turn();
        issue_pv(j);
        pass_turn();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(flat(acc));
        release(j);
      }
    }
    if (wg == 0) take_turn();
    const float safe[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
    store_rows<bf16, D>(o, acc, b, h, heads, tq, row_g, 1.f / safe[0],
                        1.f / safe[1], t);
    if (t == 0) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = row_g + 8 * hr;
        if (row < tq)
          lse[(size_t(b) * heads + h) * tq + row] =
              m[hr] * kLn2 + logf(safe[hr]);
      }
    }
  }
}

// B3. Grid: x = key tile (64 keys a consumer warpgroup), y = head, z =
// batch; under causal key tile j meets query tiles from its diagonal on, so
// CTA 0 walks the most. Warpgroup w owns keys [64 w, 64 w + 64) of the
// tile. The producer warp loads K and V once, then per query tile the rows
// of lse and delta (plain loads into shared memory, zero past tq) and Q and
// dO (TMA), all completing on the stage's full barrier (one arrive per
// lane, lane 0's with the TMA bytes).
template <int D>
__global__ void __launch_bounds__(ws_threads(dkv_consumers<D>()), 1)
flash_dkv_ws(const __grid_constant__ CUtensorMap qm,
             const __grid_constant__ CUtensorMap km,
             const __grid_constant__ CUtensorMap vm,
             const __grid_constant__ CUtensorMap dom,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dk, bf16* __restrict__ dv, int heads, int tq,
             int tk, float scale, int causal) {
  using L = DkvLayout<D>;
  constexpr int C = dkv_consumers<D>();
  constexpr int S = L::kStages;
  constexpr int kQTile = L::kQRows;
  unsigned char* smem = sm90::aligned_smem();
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + S;

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * L::kKeys;
  const int nq = (tq + kQTile - 1) / kQTile;
  const int first = causal ? k0 / kQTile : 0;
  const int wg = sm90::warpgroup();

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&full[s], 32);
      sm90::mbar_init(&empty[s], C * 4);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == C) {  // the producer
    const int lane = threadIdx.x % kWg;
    const size_t row_base = (size_t(b) * heads + h) * tq;
    if (lane == 0) {
      sm90::prefetch_map(&qm);
      sm90::prefetch_map(&dom);
      sm90::mbar_arrive_expect_tx(kv_full, 2 * L::kKv);
      tma_tile<D>(smem + L::kK, &km, kv_full, b, h, k0, L::kKeys);
      tma_tile<D>(smem + L::kV, &vm, kv_full, b, h, k0, L::kKeys);
    }
    for (int i = first; i < nq; ++i) {
      const int n = i - first, s = n % S, q0 = i * kQTile;
      sm90::mbar_wait(&empty[s], ((n / S) & 1) ^ 1);
      if (lane == 0) {  // the tiles first: their latency is the longer
        sm90::mbar_expect_tx(&full[s], 2 * L::kTile);
        tma_tile<D>(smem + L::kQ + s * L::kTile, &qm, &full[s], b, h, q0,
                    kQTile);
        tma_tile<D>(smem + L::kDo + s * L::kTile, &dom, &full[s], b, h, q0,
                    kQTile);
      }
      // lse in base 2 (lse log2(e)), as the consumers' exp2 takes it.
      float* rows =
          reinterpret_cast<float*>(smem + L::kRows + s * L::kRowBytes);
      for (int r = lane; r < kQTile; r += 32) {
        const bool in = q0 + r < tq;
        rows[r] = in ? lse[row_base + q0 + r] * kLog2e : 0.f;
        rows[kQTile + r] = in ? delta[row_base + q0 + r] : 0.f;
      }
      sm90::mbar_arrive(&full[s]);  // each lane's stores, released
    }
  } else {  // a consumer: 64 keys
    const int tid = threadIdx.x % kWg;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int key0 = k0 + wg * 64;
    const int key_g = key0 + warp * 16 + g;  // and key_g + 8
    const float scale_log2 = scale * kLog2e;  // P = exp2(S scale log2(e) - lse log2(e))
    const unsigned char* ks = smem + L::kK + wg * 64 * 128;
    const unsigned char* vs = smem + L::kV + wg * 64 * 128;

    float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) dk_acc[j][i] = dv_acc[j][i] = 0.f;

    sm90::mbar_wait(kv_full, 0);
    for (int i0 = first; i0 < nq; ++i0) {
      const int n = i0 - first, s = n % S, q0 = i0 * kQTile;
      sm90::mbar_wait(&full[s], (n / S) & 1);
      // Under causal the diagonal's first query tile lies wholly above
      // the second warpgroup's keys: nothing to add.
      if (!(causal && q0 + kQTile <= key0)) {
        const unsigned char* qs = smem + L::kQ + s * L::kTile;
        const unsigned char* dos = smem + L::kDo + s * L::kTile;
        const float* lse_s =  // lse log2(e)
            reinterpret_cast<const float*>(smem + L::kRows + s * L::kRowBytes);
        const float* delta_s = lse_s + kQTile;

        // Transposed: row = key, column = query.
        float st[kQTile / 8][4], dpt[kQTile / 8][4];
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          sm90::wgmma_ss<kQTile>(flat(st), k_major(ks, L::kKeys, kk),
                                 k_major(qs, kQTile, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          sm90::wgmma_ss<kQTile>(flat(dpt), k_major(vs, L::kKeys, kk),
                                 k_major(dos, kQTile, kk), kk > 0);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(flat(st));
        sm90::fence_regs(flat(dpt));

        // Only the tiles that straddle the causal diagonal or reach past
        // tq are masked.
        if ((causal && q0 < key0 + 63) || q0 + kQTile > tq)
          dkv_scores<true, kQTile>(st, dpt, lse_s, delta_s, key_g, q0, t, tq,
                                   scale, scale_log2, causal);
        else
          dkv_scores<false, kQTile>(st, dpt, lse_s, delta_s, key_g, q0, t,
                                    tq, scale, scale_log2, causal);

        // dV += P^T . dO and dK += dS^T . Q, 16 queries a product, the A
        // operands rounded to bf16 before the fence.
        Mma<bf16>::A p[kQTile / 16], ds[kQTile / 16];
#pragma unroll
        for (int kk = 0; kk < kQTile / 16; ++kk) {
          p[kk] = Mma<bf16>::from_c(st[2 * kk], st[2 * kk + 1]);
          ds[kk] = Mma<bf16>::from_c(dpt[2 * kk], dpt[2 * kk + 1]);
        }
        sm90::fence_regs(flat(dk_acc));
        sm90::fence_regs(flat(dv_acc));
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kQTile / 16; ++kk) {
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            sm90::wgmma_rs_n64(
                *reinterpret_cast<float(*)[32]>(&dv_acc[8 * c][0]), p[kk].r,
                mn_major(dos, kQTile, kk, c));
            sm90::wgmma_rs_n64(
                *reinterpret_cast<float(*)[32]>(&dk_acc[8 * c][0]), ds[kk].r,
                mn_major(qs, kQTile, kk, c));
          }
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(flat(dk_acc));
        sm90::fence_regs(flat(dv_acc));
      }
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[s]);
    }
    store_rows<bf16, D>(dk, dk_acc, b, h, heads, tk, key_g, 1.f, 1.f, t);
    store_rows<bf16, D>(dv, dv_acc, b, h, heads, tk, key_g, 1.f, 1.f, t);
  }
}

// B2's scores to dS in place, on a warp's rows of S and dP (accumulator
// layout: rows row_g and row_g + 8, columns 8 n + 2 t + {0, 1} from col0):
// P = exp2(S scale log2(e) - lse log2(e)), dS = P (dP - delta) scale, the
// arithmetic of flash_dq below with the exponential in base 2; lse2 holds
// the rows' lse log2(e). With kMask, columns at or past tk and (causal)
// past the row are 0.
template <bool kMask>
__device__ __forceinline__ void dq_scores(float (&s)[kDqKeys / 8][4],
                                          const float (&dp)[kDqKeys / 8][4],
                                          const float (&lse2)[2],
                                          const float (&delta)[2], int row_g,
                                          int col0, int t, int tk,
                                          float scale, float scale_log2,
                                          int causal) {
#pragma unroll
  for (int n = 0; n < kDqKeys / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float p = ex2(fmaf(s[n][i], scale_log2, -lse2[i >> 1]));
      if (kMask) {
        const int row = row_g + 8 * (i >> 1);
        const int col = col0 + n * 8 + 2 * t + (i & 1);
        if (!(col < tk && (!causal || col <= row))) p = 0.f;
      }
      s[n][i] = p * (dp[n][i] - delta[i >> 1]) * scale;
    }
}

// B2. Grid: x = query tile of 64 rows a consumer warpgroup (longest walks
// first), y = head, z = batch. The producer warp, one thread of it, loads Q
// and dO once and walks the 64-key tiles of K and V through the ring. Each
// consumer keeps its rows' lse and delta in registers, and per key tile
// computes S = Q.K^T and dP = dO.V^T (both operands K-major in shared
// memory), dS in registers, and dQ += dS.K with dS as the register A
// operand and K read MN-major. Tile j + 1's S and dP are issued before tile
// j's dS.K, so that dS.K runs under the next tile's exponentials.
template <int D>
__global__ void __launch_bounds__(ws_threads(dq_consumers<D>()), 1)
flash_dq_ws(const __grid_constant__ CUtensorMap qm,
            const __grid_constant__ CUtensorMap km,
            const __grid_constant__ CUtensorMap vm,
            const __grid_constant__ CUtensorMap dom,
            const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dq, int heads, int tq, int tk, float scale,
            int causal) {
  using L = DqLayout<D>;
  constexpr int C = dq_consumers<D>();
  constexpr int S = L::kStages;
  constexpr int kN = kDqKeys;
  unsigned char* smem = sm90::aligned_smem();
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + S;

  const int nq = (tq + L::kRows - 1) / L::kRows;
  const int qt = nq - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * L::kRows;
  const int nk_all = (tk + kN - 1) / kN;
  const int nk = causal ? min((q0 + L::kRows + kN - 1) / kN, nk_all) : nk_all;
  const int wg = sm90::warpgroup();

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], C * 4);  // one arrive a consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == C) {  // the producer
    if (threadIdx.x == C * kWg) {
      sm90::prefetch_map(&km);
      sm90::prefetch_map(&vm);
      sm90::mbar_arrive_expect_tx(q_full, 2 * L::kQTile);
      tma_tile<D>(smem + L::kQ, &qm, q_full, b, h, q0, L::kRows);
      tma_tile<D>(smem + L::kDo, &dom, q_full, b, h, q0, L::kRows);
      for (int j = 0; j < nk; ++j) {
        const int s = j % S;
        sm90::mbar_wait(&empty[s], ((j / S) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s], 2 * L::kKvTile);
        tma_tile<D>(smem + L::kK + s * L::kKvTile, &km, &full[s], b, h,
                    j * kN, kN);
        tma_tile<D>(smem + L::kV + s * L::kKvTile, &vm, &full[s], b, h,
                    j * kN, kN);
      }
    }
  } else {  // a consumer: 64 query rows
    const int tid = threadIdx.x % kWg;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int row0 = q0 + wg * 64;
    const int row_g = row0 + warp * 16 + g;  // and row_g + 8
    // This warpgroup's 64 rows of Q and dO: 64 rows further into each box.
    const unsigned char* qs = smem + L::kQ + wg * 64 * 128;
    const unsigned char* dos = smem + L::kDo + wg * 64 * 128;
    const float scale_log2 = scale * kLog2e;
    const size_t row_base = (size_t(b) * heads + h) * tq;
    float lse2[2], dlt[2];  // lse log2(e) and delta of rows row_g, row_g + 8
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row_g + 8 * hr;
      lse2[hr] = row < tq ? lse[row_base + row] * kLog2e : 0.f;
      dlt[hr] = row < tq ? delta[row_base + row] : 0.f;
    }

    float acc[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    float sc[kN / 8][4], dp[kN / 8][4];  // S (then dS in f32) and dP
    Mma<bf16>::A ds[kN / 16];            // dS rounded to bf16: the A operand

    // S and dP of key tile j, issued and committed, not waited for.
    auto issue_sdp = [&](int j) {
      const unsigned char* ks = smem + L::kK + (j % S) * L::kKvTile;
      const unsigned char* vs = smem + L::kV + (j % S) * L::kKvTile;
      sm90::mbar_wait(&full[j % S], (j / S) & 1);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_ss<kN>(flat(sc), k_major(qs, L::kRows, kk),
                           k_major(ks, kN, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_ss<kN>(flat(dp), k_major(dos, L::kRows, kk),
                           k_major(vs, kN, kk), kk > 0);
      sm90::wgmma_commit();
    };
    // dS of key tile j in sc once its products are done; only tiles that
    // straddle the causal diagonal or reach past tk are masked.
    auto scores = [&](int j) {
      sm90::fence_regs(flat(sc));
      sm90::fence_regs(flat(dp));
      const int col0 = j * kN;
      if ((causal && col0 + kN - 1 > row0) || col0 + kN > tk)
        dq_scores<true>(sc, dp, lse2, dlt, row_g, col0, t, tk, scale,
                        scale_log2, causal);
      else
        dq_scores<false>(sc, dp, lse2, dlt, row_g, col0, t, tk, scale,
                         scale_log2, causal);
    };
    // dQ += dS . K of key tile j (dS in ds), issued and committed.
    auto issue_dq = [&](int j) {
      const unsigned char* ks = smem + L::kK + (j % S) * L::kKvTile;
      sm90::fence_regs(flat(acc));
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          sm90::wgmma_rs_n64(
              *reinterpret_cast<float(*)[32]>(&acc[8 * c][0]), ds[kk].r,
              mn_major(ks, kN, kk, c));
      }
      sm90::wgmma_commit();
    };
    auto to_operand = [&]() {
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk)
        ds[kk] = Mma<bf16>::from_c(sc[2 * kk], sc[2 * kk + 1]);
    };
    auto release = [&](int j) {  // this warp is done with tile j's stage
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[j % S]);
    };

    sm90::mbar_wait(q_full, 0);
    issue_sdp(0);
    sm90::wgmma_wait<0>();
    scores(0);
    // The last tile is peeled, so that no product is issued under a branch.
    for (int j = 0; j + 1 < nk; ++j) {
      to_operand();
      issue_sdp(j + 1);
      issue_dq(j);
      sm90::wgmma_wait<1>();  // tile j + 1's S and dP (dS.K may still run)
      scores(j + 1);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(flat(acc));
      release(j);
    }
    to_operand();
    issue_dq(nk - 1);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(flat(acc));
    release(nk - 1);
    store_rows<bf16, D>(dq, acc, b, h, heads, tq, row_g, 1.f, 1.f, t);
  }
}

// Tile i of a kernel's shared memory.
template <typename T, int D>
__device__ __forceinline__ T* tile(unsigned char* smem, int i) {
  return reinterpret_cast<T*>(smem + i * tile_bytes<T, D>());
}

// Grid of the forward and dQ kernels: x = query tile (longest rows first),
// y = head, z = batch.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, min_ctas<T, D>(4))
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
          View qv, View kv, View vv, int heads, int tq, int tk, float scale,
          int causal) {
  constexpr int ld = pitch<T>(D);
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = tile<T, D>(smem, 0);  // then k, v of stage 0 and of stage 1

  const int nq = (tq + kTile - 1) / kTile;
  const int qt = nq - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kTile, r0 = warp * kRows;
  const int row_g = q0 + r0 + g;  // this thread's rows: row_g, row_g + 8

  load_tile<T, D>(qs, q, qv, b, h, q0, tq);
  load_tile<T, D>(tile<T, D>(smem, 1), k, kv, b, h, 0, tk);
  load_tile<T, D>(tile<T, D>(smem, 2), v, vv, b, h, 0, tk);
  cp_async_commit();
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  const int nk_all = (tk + kTile - 1) / kTile;
  const int nk = causal ? min(qt + 1, nk_all) : nk_all;

  for (int j = 0; j < nk; ++j) {
    if (j + 1 < nk) {
      const int next = 1 + 2 * ((j + 1) & 1);
      load_tile<T, D>(tile<T, D>(smem, next), k, kv, b, h, (j + 1) * kTile,
                      tk);
      load_tile<T, D>(tile<T, D>(smem, next + 1), v, vv, b, h,
                      (j + 1) * kTile, tk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile j has landed (tile j + 1 may be in flight)
    __syncthreads();
    const T* ks = tile<T, D>(smem, 1 + 2 * (j & 1));
    const T* vs = tile<T, D>(smem, 2 + 2 * (j & 1));
    float s[kNt][4];
    scores<T, D>(s, qs + r0 * ld, ks, lane);
    float mx[2] = {kMasked, kMasked};
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row_g + 8 * (i >> 1);
        const int col = j * kTile + n * 8 + 2 * t + (i & 1);
        const bool ok = col < tk && (!causal || col <= row);
        s[n][i] = ok ? s[n][i] * scale : -INFINITY;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[n][i]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float m_new = fmaxf(m[hr], quad_max(mx[hr]));
      alpha[hr] = expf(m[hr] - m_new);
      m[hr] = m_new;
    }
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[n][i] = expf(s[n][i] - m[i >> 1]);  // masked: exp(-inf) = 0
        sum[i >> 1] += s[n][i];
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) l[hr] = l[hr] * alpha[hr] + quad_sum(sum[hr]);
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[jd][i] *= alpha[i >> 1];
    accumulate<T, D>(acc, s, vs, lane);
    __syncthreads();  // every warp is done with this stage's k, v
  }
  const float safe[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
  store_rows<T, D>(o, acc, b, h, heads, tq, row_g, 1.f / safe[0],
                   1.f / safe[1], t);
  if (t == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row_g + 8 * hr;
      if (row < tq)
        lse[(size_t(b) * heads + h) * tq + row] = m[hr] + logf(safe[hr]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, min_ctas<T, D>(4))
flash_dq(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const T* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ delta,
         T* __restrict__ dq, View qv, View kv, View vv, View dov, int heads,
         int tq, int tk, float scale, int causal) {
  constexpr int ld = pitch<T>(D);
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = tile<T, D>(smem, 0);
  T* dos = tile<T, D>(smem, 1);  // then k, v of stage 0 and of stage 1

  const int nq = (tq + kTile - 1) / kTile;
  const int qt = nq - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kTile, r0 = warp * kRows;
  const int row_g = q0 + r0 + g;
  const size_t row_base = (size_t(b) * heads + h) * tq;

  load_tile<T, D>(qs, q, qv, b, h, q0, tq);
  load_tile<T, D>(dos, dout, dov, b, h, q0, tq);
  load_tile<T, D>(tile<T, D>(smem, 2), k, kv, b, h, 0, tk);
  load_tile<T, D>(tile<T, D>(smem, 3), v, vv, b, h, 0, tk);
  cp_async_commit();
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row_g + 8 * hr;
    lse_r[hr] = row < tq ? lse[row_base + row] : 0.f;
    delta_r[hr] = row < tq ? delta[row_base + row] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  const int nk_all = (tk + kTile - 1) / kTile;
  const int nk = causal ? min(qt + 1, nk_all) : nk_all;

  for (int j = 0; j < nk; ++j) {
    if (j + 1 < nk) {
      const int next = 2 + 2 * ((j + 1) & 1);
      load_tile<T, D>(tile<T, D>(smem, next), k, kv, b, h, (j + 1) * kTile,
                      tk);
      load_tile<T, D>(tile<T, D>(smem, next + 1), v, vv, b, h,
                      (j + 1) * kTile, tk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* ks = tile<T, D>(smem, 2 + 2 * (j & 1));
    const T* vs = tile<T, D>(smem, 3 + 2 * (j & 1));
    float s[kNt][4], dp[kNt][4];
    scores<T, D>(s, qs + r0 * ld, ks, lane);
    scores<T, D>(dp, dos + r0 * ld, vs, lane);
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int hr = i >> 1, row = row_g + 8 * hr;
        const int col = j * kTile + n * 8 + 2 * t + (i & 1);
        const bool ok = col < tk && (!causal || col <= row);
        const float p = ok ? expf(s[n][i] * scale - lse_r[hr]) : 0.f;
        s[n][i] = p * (dp[n][i] - delta_r[hr]) * scale;  // dS
      }
    accumulate<T, D>(acc, s, ks, lane);
    __syncthreads();
  }
  store_rows<T, D>(dq, acc, b, h, heads, tq, row_g, 1.f, 1.f, t);
}

// Grid: x = key tile, y = head, z = batch. Under causal, key tile j meets
// query tiles from j on, so CTA 0 walks the most and the grid's order
// already starts with the longest walks.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, min_ctas<T, D>(3))
flash_dkv(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dk, T* __restrict__ dv, View qv, View kv, View vv,
          View dov, int heads, int tq, int tk, float scale, int causal) {
  constexpr int ld = pitch<T>(D);
  extern __shared__ __align__(128) unsigned char smem[];
  T* ks = tile<T, D>(smem, 0);
  T* vs = tile<T, D>(smem, 1);  // then q, do of stage 0 and of stage 1
  // lse and delta of stage 0, then of stage 1, after the six tiles.
  float* rows = reinterpret_cast<float*>(smem + 6 * tile_bytes<T, D>());
  constexpr int kRowVec = up(sizeof(float) * kTile) / sizeof(float);

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = kt * kTile, r0 = warp * kRows;
  const int key_g = k0 + r0 + g;  // this thread's keys: key_g, key_g + 8
  const size_t row_base = (size_t(b) * heads + h) * tq;

  const int nq = (tq + kTile - 1) / kTile;
  const int first = causal ? kt : 0;
  // Start loading query tile i (q, do, lse, delta) into `stage`.
  auto load_q = [&](int i, int stage) {
    const int q0 = i * kTile;
    load_tile<T, D>(tile<T, D>(smem, 2 + 2 * stage), q, qv, b, h, q0, tq);
    load_tile<T, D>(tile<T, D>(smem, 3 + 2 * stage), dout, dov, b, h, q0,
                    tq);
    float* lse_s = rows + (2 * stage) * kRowVec;
    float* delta_s = lse_s + kRowVec;
    for (int c = threadIdx.x; c < kTile; c += kThreads) {
      const bool in = q0 + c < tq;
      lse_s[c] = in ? lse[row_base + q0 + c] : 0.f;
      delta_s[c] = in ? delta[row_base + q0 + c] : 0.f;
    }
  };
  load_tile<T, D>(ks, k, kv, b, h, k0, tk);
  load_tile<T, D>(vs, v, vv, b, h, k0, tk);
  load_q(first, 0);
  cp_async_commit();
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[j][i] = dv_acc[j][i] = 0.f;

  for (int i0 = first; i0 < nq; ++i0) {
    const int stage = (i0 - first) & 1;
    if (i0 + 1 < nq) load_q(i0 + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int q0 = i0 * kTile;
    const T* qs = tile<T, D>(smem, 2 + 2 * stage);
    const T* dos = tile<T, D>(smem, 3 + 2 * stage);
    const float* lse_s = rows + (2 * stage) * kRowVec;
    const float* delta_s = rows + (2 * stage + 1) * kRowVec;
    // Transposed: row = key, column = query.
    float st[kNt][4], dpt[kNt][4];
    scores<T, D>(st, ks + r0 * ld, qs, lane);
    scores<T, D>(dpt, vs + r0 * ld, dos, lane);
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = key_g + 8 * (i >> 1);
        const int c = n * 8 + 2 * t + (i & 1), row = q0 + c;
        const bool ok = row < tq && (!causal || row >= key);
        const float p = ok ? expf(st[n][i] * scale - lse_s[c]) : 0.f;
        st[n][i] = p;
        dpt[n][i] = p * (dpt[n][i] - delta_s[c]) * scale;  // dS^T
      }
    accumulate<T, D>(dv_acc, st, dos, lane);
    accumulate<T, D>(dk_acc, dpt, qs, lane);
    __syncthreads();
  }
  store_rows<T, D>(dk, dk_acc, b, h, heads, tk, key_g, 1.f, 1.f, t);
  store_rows<T, D>(dv, dv_acc, b, h, heads, tk, key_g, 1.f, 1.f, t);
}

View view(const long long* s) { return View{s[0], s[1], s[2]}; }

// The design each instance runs, fixed here and nowhere else: the
// warp-specialised TMA + wgmma kernels for bf16 B1, B2 and B3 at Dh 64 and
// 128; the mma.sync kernels for f32 (FMA products on their fragment
// layout, which the exactness checks and the f32 trainer rely on) and for
// bf16 at Dh 32, whose 64-byte rows would need the 64-byte swizzle
// and its own descriptors for a shape no path of the port runs.
enum Kernel { kFwd = 0, kDq = 1, kDkv = 2 };
enum Design { kMmaSync = 0, kWarpSpecialized = 1 };

template <typename T, int D>
constexpr Design design(Kernel) {
  return std::is_same<T, bf16>::value && D >= 64 ? kWarpSpecialized
                                                 : kMmaSync;
}

// TMA maps of the inputs q, k, v (and do) of one launch: `rows`[i] rows a
// box; `strides` holds each input's (batch, time, head) strides in order.
template <int D, int N>
cudaError_t encode_maps(CUtensorMap (&maps)[N], const void* const (&in)[N],
                        const int (&t)[N], const int (&rows)[N], int b,
                        int h, const long long* strides) {
  for (int i = 0; i < N; ++i) {
    const long long* s = strides + 3 * i;
    const cudaError_t err = sm90::encode_bf16_map(
        &maps[i], in[i], b, t[i], h, D, s[0], s[1], s[2], rows[i]);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int D>
cudaError_t fwd_ws(const void* q, const void* k, const void* v, void* o,
                   float* lse, int b, int h, int tq, int tk,
                   const long long* strides, float scale, int causal,
                   cudaStream_t stream) {
  CUtensorMap maps[3];
  cudaError_t err = encode_maps<D, 3>(maps, {q, k, v}, {tq, tk, tk},
                                      {kBlock, kBlock, kBlock}, b, h,
                                      strides);
  if (err != cudaSuccess) return err;
  static bool done = false;
  constexpr size_t bytes = FwdLayout<D>::kBytes + 1024;
  err = sm90::opt_in(flash_fwd_ws<D>, bytes, &done);
  if (err != cudaSuccess) return err;
  const dim3 grid((tq + kBlock - 1) / kBlock, h, b);
  flash_fwd_ws<D><<<grid, ws_threads(kFwdConsumers), bytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(o), lse, h, tq, tk,
      scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t dkv_ws(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, int b, int h, int tq, int tk,
                   const long long* strides, float scale, int causal,
                   cudaStream_t stream) {
  using L = DkvLayout<D>;
  CUtensorMap maps[4];
  cudaError_t err = encode_maps<D, 4>(
      maps, {q, k, v, dout}, {tq, tk, tk, tq},
      {L::kQRows, L::kKeys, L::kKeys, L::kQRows}, b, h, strides);
  if (err != cudaSuccess) return err;
  static bool done = false;
  constexpr size_t bytes = L::kBytes + 1024;
  err = sm90::opt_in(flash_dkv_ws<D>, bytes, &done);
  if (err != cudaSuccess) return err;
  const dim3 grid((tk + L::kKeys - 1) / L::kKeys, h, b);
  flash_dkv_ws<D><<<grid, ws_threads(dkv_consumers<D>()), bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), h, tq, tk, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t dq_ws(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dq, int b, int h, int tq, int tk,
                  const long long* strides, float scale, int causal,
                  cudaStream_t stream) {
  using L = DqLayout<D>;
  CUtensorMap maps[4];
  cudaError_t err = encode_maps<D, 4>(
      maps, {q, k, v, dout}, {tq, tk, tk, tq},
      {L::kRows, kDqKeys, kDqKeys, L::kRows}, b, h, strides);
  if (err != cudaSuccess) return err;
  static bool done = false;
  constexpr size_t bytes = L::kBytes + 1024;
  err = sm90::opt_in(flash_dq_ws<D>, bytes, &done);
  if (err != cudaSuccess) return err;
  const dim3 grid((tq + L::kRows - 1) / L::kRows, h, b);
  flash_dq_ws<D><<<grid, ws_threads(dq_consumers<D>()), bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta, static_cast<bf16*>(dq),
      h, tq, tk, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                float* lse, int b, int h, int tq, int tk,
                const long long* strides, float scale, int causal,
                cudaStream_t stream) {
  if constexpr (design<T, D>(kFwd) == kWarpSpecialized) {
    return fwd_ws<D>(q, k, v, o, lse, b, h, tq, tk, strides, scale, causal,
                     stream);
  } else {
    static bool done = false;
    constexpr size_t bytes = fwd_smem<T, D>();
    cudaError_t err = sm90::opt_in(flash_fwd<T, D>, bytes, &done);
    if (err != cudaSuccess) return err;
    const dim3 grid((tq + kTile - 1) / kTile, h, b);
    flash_fwd<T, D><<<grid, kThreads, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), lse, view(strides),
        view(strides + 3), view(strides + 6), h, tq, tk, scale, causal);
    return cudaGetLastError();
  }
}

template <typename T, int D>
cudaError_t dq_launch(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int b, int h, int tq, int tk,
                      const long long* strides, float scale, int causal,
                      cudaStream_t stream) {
  if constexpr (design<T, D>(kDq) == kWarpSpecialized) {
    return dq_ws<D>(q, k, v, dout, lse, delta, dq, b, h, tq, tk, strides,
                    scale, causal, stream);
  } else {
    static bool done = false;
    constexpr size_t bytes = dq_smem<T, D>();
    cudaError_t err = sm90::opt_in(flash_dq<T, D>, bytes, &done);
    if (err != cudaSuccess) return err;
    const dim3 grid((tq + kTile - 1) / kTile, h, b);
    flash_dq<T, D><<<grid, kThreads, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dq), view(strides), view(strides + 3),
        view(strides + 6), view(strides + 9), h, tq, tk, scale, causal);
    return cudaGetLastError();
  }
}

template <typename T, int D>
cudaError_t dkv_launch(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int b, int h, int tq, int tk,
                       const long long* strides, float scale, int causal,
                       cudaStream_t stream) {
  if constexpr (design<T, D>(kDkv) == kWarpSpecialized) {
    return dkv_ws<D>(q, k, v, dout, lse, delta, dk, dv, b, h, tq, tk,
                     strides, scale, causal, stream);
  } else {
    static bool done = false;
    constexpr size_t bytes = dkv_smem<T, D>();
    cudaError_t err = sm90::opt_in(flash_dkv<T, D>, bytes, &done);
    if (err != cudaSuccess) return err;
    const dim3 grid((tk + kTile - 1) / kTile, h, b);
    flash_dkv<T, D><<<grid, kThreads, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dk), static_cast<T*>(dv), view(strides),
        view(strides + 3), view(strides + 6), view(strides + 9), h, tq, tk,
        scale, causal);
    return cudaGetLastError();
  }
}

bool bad_geometry(int b, int h, int tq, int tk, int causal) {
  return b < 1 || h < 1 || b > 65535 || h > 65535 || tq < 1 || tk < 1 ||
         (causal && tq != tk);
}

}  // namespace

// Dispatch on (is_bf16, dh) to a template instance: bf16 or f32, Dh in
// {32, 64, 128}. An unsupported pair returns cudaErrorInvalidValue.
#define FLASH_DISPATCH(CALL)                                   \
  switch (dh) {                                                \
    case 32:                                                   \
      err = is_bf16 ? CALL(bf16, 32) : CALL(float, 32);        \
      break;                                                   \
    case 64:                                                   \
      err = is_bf16 ? CALL(bf16, 64) : CALL(float, 64);        \
      break;                                                   \
    case 128:                                                  \
      err = is_bf16 ? CALL(bf16, 128) : CALL(float, 128);      \
      break;                                                   \
    default:                                                   \
      err = cudaErrorInvalidValue;                             \
  }

// Inputs q [b, tq, h, dh], k and v [b, tk, h, dh] (and do [b, tq, h, dh]) in
// one dtype (is_bf16: 1 = bf16, 0 = f32), strided, with `strides` holding
// (batch, time, head) strides in elements for each input in argument order;
// dh contiguous, every pointer and stride 16-byte aligned. Outputs are
// contiguous: o/dq [b, tq, h, dh], dk/dv [b, tk, h, dh] in the input dtype,
// lse and delta f32 [b, h, tq]. Each call launches on `stream`, allocates
// nothing, does not synchronise, and returns cudaGetLastError() (0 =
// launched).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, void* lse, int b, int h, int tq,
                                int tk, int dh, const long long* strides,
                                float scale, int causal, int is_bf16,
                                void* stream) {
  if (bad_geometry(b, h, tq, tk, causal)) return int(cudaErrorInvalidValue);
  cudaError_t err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define FWD_CALL(T, D) \
  fwd<T, D>(q, k, v, o, l, b, h, tq, tk, strides, scale, causal, s)
  FLASH_DISPATCH(FWD_CALL)
#undef FWD_CALL
  return int(err);
}

extern "C" int flash_dq_launch(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int b, int h,
                               int tq, int tk, int dh,
                               const long long* strides, float scale,
                               int causal, int is_bf16, void* stream) {
  if (bad_geometry(b, h, tq, tk, causal)) return int(cudaErrorInvalidValue);
  cudaError_t err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
#define DQ_CALL(T, D)                                                    \
  dq_launch<T, D>(q, k, v, dout, l, dl, dq, b, h, tq, tk, strides, scale, \
                  causal, s)
  FLASH_DISPATCH(DQ_CALL)
#undef DQ_CALL
  return int(err);
}

extern "C" int flash_dkv_launch(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int b,
                                int h, int tq, int tk, int dh,
                                const long long* strides, float scale,
                                int causal, int is_bf16, void* stream) {
  if (bad_geometry(b, h, tq, tk, causal)) return int(cudaErrorInvalidValue);
  cudaError_t err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
#define DKV_CALL(T, D)                                                   \
  dkv_launch<T, D>(q, k, v, dout, l, dl, dk, dv, b, h, tq, tk, strides,  \
                   scale, causal, s)
  FLASH_DISPATCH(DKV_CALL)
#undef DKV_CALL
  return int(err);
}

// Which design an instance runs (kernel: 0 = forward, 1 = dQ, 2 = dK/dV):
// 1 = warp-specialised TMA + wgmma, 0 = mma.sync, -1 = no such instance.
extern "C" int flash_design(int is_bf16, int dh, int kernel) {
  if (kernel < 0 || kernel > 2) return -1;
  const Kernel k = static_cast<Kernel>(kernel);
  switch (dh) {
    case 32:
      return is_bf16 ? design<bf16, 32>(k) : design<float, 32>(k);
    case 64:
      return is_bf16 ? design<bf16, 64>(k) : design<float, 64>(k);
    case 128:
      return is_bf16 ? design<bf16, 128>(k) : design<float, 128>(k);
    default:
      return -1;
  }
}
