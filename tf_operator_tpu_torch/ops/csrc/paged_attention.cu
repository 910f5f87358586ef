// Paged decode attention straight off each lane's block table, for Hopper
// (sm_90a). Built by ops/_build.py into a shared library with a plain C
// entry point and called through ctypes by ops/paged_attention.py.
//
// Replaces tf_operator_tpu/ops/paged_attention.py::_paged_kernel (:126,
// launched by the pallas_call at :300). For lane b, KV head kk and query
// row r = (ti, gi) -- head h = kk*g + gi at absolute position index[b]+ti:
//
//   s[c] = (q[b,ti,h,:] . K_b[c,kk,:]) * Dh^-1/2        f32
//   s[c] = -1e30 where c > index[b] + ti                  (the oracle's mask)
//   out[b,ti,h,:] = softmax(s) . V_b[:,kk,:]              f32 [b,t,H,Dh]
//
// where row c of lane b lives in pool block table[b][c / blk], row c % blk.
//
// The kv8 variant reads int8 pools with f32 [nb,blk,KV] scales (ks, vs) in
// JAX's factoring: s[c] = ((q . K8[c]) * ks[c]) * Dh^-1/2, and the value
// scale multiplies each probability in the P.V sum only, so the online
// softmax's normaliser stays the sum of the unscaled exponentials:
// out = sum_c p_c vs_c V8[c] / sum_c p_c, which is softmax(s) * vs then . V.
//
// What bounds it: bytes. A call must read the K and V rows each lane owns,
// (index[b]+t) x KV x Dh x 2 tensors x element bytes, and write the f32
// output. Its flops (4 per K/V element per grouped head) are about one per
// byte, far below the H100's ~295 flop/byte ridge. At the slice's shapes
// (4 lanes at 3500/1750/875/437 tokens, KV=4, Dh=64, bf16) that is about
// 6.7 MB per layer: some 2 us at 3.35 TB/s. kv8 halves the K/V bytes and
// adds 4 bytes of scale per row and KV head: 3.36 MB of int8 K/V, 0.21 MB
// of scales, q, the tables and the f32 output, about 3.60 MB or 1.07 us.
//
// The design: one launch, the block walk split over a thread-block cluster
// and merged through distributed shared memory.
//  - The grid is (S, KV, b) with a cluster of (S, 1, 1): the S CTAs of a
//    cluster share one lane and KV head. S is the caller's (SPLITS in
//    ops/paged_attention.py, at most 16; above 8 the kernel opts into
//    non-portable cluster sizes). At the slice's shapes the wrapper's
//    S = 16 gives 16 x 4 x 4 = 256 CTAs, two an SM.
//  - Each CTA works out the split itself from the lane's counter: nblk =
//    ceil((index[b]+t)/blk) owned blocks, and CTA s walks blocks j = s,
//    s+S, s+2S, ... below nblk (ops/paged_attention.py's split_walk mirrors
//    the rule). Block 0 falls to split 0, so the merged max is a real
//    score; the host needs no lane lengths, so nothing syncs with it. The
//    walk is strided, not contiguous, so the longest lane keeps all S
//    splits busy (28 blocks at S = 16: twelve splits of 2, four of 1).
//  - The walk is pipelined. K and V tiles of TC columns (128, or 64 for f32
//    at Dh 128 so that two stages fit the 227 KB a CTA may have) land in
//    shared memory by cp.async in two stages: the next tile's copies, under
//    kv8 its scales too, are in flight while this tile's scores, softmax
//    and P.V run, and the table entry of the block after that is loaded a
//    tile ahead. The counter, the first two table entries and the query
//    rows are loaded together, before the counter is known. K rows sit 16
//    bytes apart more than their width, so the 16-byte reads of one row a
//    thread meet no bank conflict.
//  - The t*g query rows that share a KV head share one walk, so a K/V row is
//    read once per KV head (GQA), and t > 1 (the speculative verify chunk)
//    rides the same kernel. Each thread scores one key column against four
//    query rows at a time (eight independent sums). Each thread owns two
//    neighbouring output columns of KR query rows in P.V, so one V load
//    serves KR rows and one 16-byte P load four columns.
//  - Online softmax in f32 (running max and sum per query row), expf, the
//    oracle's -1e30 mask. kv8: the key scale on the score before Dh^-1/2,
//    the value scale on P in P.V only.
//  - The merge: each CTA leaves its (max, sum) per query row and its f32
//    P.V sums [rows][Dh] in its own shared memory. After a cluster barrier,
//    CTA rank r writes a 1/S share of the rows x Dh outputs: it weighs every
//    split's partial, read through distributed shared memory in split order
//    0..S-1, by exp(m_s - m) / sum_s l_s exp(m_s - m). A second barrier
//    keeps each partial alive until every CTA has read it. No atomics and
//    no scratch in device memory: two runs give the same bits. A CTA that
//    owns no block publishes m = -inf, l = 0, sums 0 (weight 0) and still
//    reaches both barriers.
// Tensor cores and TMA stay out: t*g <= 32 rows a KV head and about one
// flop a byte. On an H100 80GB HBM3 at 700 W a call at the slice's shapes
// takes about 17.1 us (bf16) and 17.9 us (kv8) of device time at S = 16
// (21.2 and 23.3 us at S = 8), against 17.7 and 17.9 us for the earlier
// two-launch design in the same call (chip_smoke.py's phases 3 and 11,
// CUDA-graph replay; PERF.md). Halving the tiles the longest lane's CTAs
// walk saved about 2 us a tile, and 64-column tiles cost as much a tile as
// 128-column ones: per-tile latency (barriers, the softmax's shuffles,
// shared-memory loads one warp a scheduler cannot hide) and a fixed cost
// outside the walk (the load chain before the first tile, the merge's two
// cluster barriers, the launch) set the pace, not bytes or FMAs.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;      // threads per CTA
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 32;       // query rows (t * g) a CTA serves
constexpr int kMaxSplits = 16;     // the largest (non-portable) cluster
constexpr float kMasked = -1e30f;  // the oracle's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return float(x); }

// One 16-byte vector of T in shared memory, widened to f32.
template <typename T>
__device__ __forceinline__ void load_vec(const T* src, float* dst) {
  constexpr int kPer = 16 / sizeof(T);
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int j = 0; j < kPer; ++j) dst[j] = to_f32(e[j]);
}

// Two neighbouring elements of T in shared memory, widened to f32.
__device__ __forceinline__ void load2(const float* src, float* dst) {
  const float2 v = *reinterpret_cast<const float2*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* src, float* dst) {
  const float2 v =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src));
  dst[0] = v.x;
  dst[1] = v.y;
}
__device__ __forceinline__ void load2(const int8_t* src, float* dst) {
  const char2 v = *reinterpret_cast<const char2*>(src);
  dst[0] = float(v.x);
  dst[1] = float(v.y);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int owned_blocks(int idx, int t, int blk,
                                            int table_len) {
  return min((idx + t + blk - 1) / blk, table_len);
}

// Copy 16 (or 4) bytes from device memory to shared memory without
// passing through registers (cp.async, sm_80 and up).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one committed group (the next tile's) is in flight.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Key columns a tile holds: 128, or 64 where two stages of 128-column K and
// V tiles would not fit a CTA's shared memory (f32 at Dh 128).
template <typename TKV, int DH>
__host__ __device__ constexpr int tile_cols() {
  return sizeof(TKV) * DH >= 512 ? 64 : 128;
}

// Bytes of one K row in shared memory: 16 more than its width, so that
// neighbouring threads' 16-byte reads of their rows fall in other banks.
template <typename TKV, int DH>
__host__ __device__ constexpr int k_row_bytes() {
  return int(sizeof(TKV)) * DH + 16;
}

// One pipeline stage: the K tile, the V tile in its stored type and, under
// kv8, the tile's key and value scales.
template <typename TKV, int DH, bool KV8>
__host__ __device__ constexpr size_t stage_bytes() {
  constexpr int tc = tile_cols<TKV, DH>();
  return size_t(tc) * k_row_bytes<TKV, DH>() + sizeof(TKV) * size_t(tc) * DH +
         (KV8 ? 2 * sizeof(float) * tc : 0);
}

// Two stages, then f32 query rows (the P.V partial after the walk), scores
// (the merge weights after the walk) and the rows' max, sum and rescale.
template <typename TKV, int DH, bool KV8>
__host__ __device__ constexpr size_t smem_bytes(int rows) {
  return 2 * stage_bytes<TKV, DH, KV8>() +
         sizeof(float) * size_t(rows) * (DH + tile_cols<TKV, DH>() + 3);
}

// CTA (split, kk, b) walks blocks split, split + S, ... of lane b's table for
// KV head kk; the S CTAs of the cluster then merge their partials into the
// output. q is TQ, the pools TKV: both f32 or both bf16, or (KV8) int8 pools
// with f32 scale pools k_scale and v_scale [nb,blk,KV] (null otherwise).
// Each thread owns output columns 2*dp, 2*dp+1 of query rows rg + k*NRG,
// k < KR (WIDE: up to 32 rows, else up to 16).
template <typename TQ, typename TKV, int DH, bool KV8, bool WIDE>
__global__ void __launch_bounds__(kThreads)
paged_attend_kernel(const TQ* __restrict__ q, const TKV* __restrict__ pool_k,
                    const TKV* __restrict__ pool_v,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ table,
                    const int* __restrict__ index, float* __restrict__ out,
                    int t, int g, int kv, int blk, int table_len,
                    float scale) {
  constexpr int TC = tile_cols<TKV, DH>();
  constexpr int kRowBytes = k_row_bytes<TKV, DH>();
  constexpr int kPer = 16 / sizeof(TKV);  // elements per 16-byte vector
  constexpr int kVecs = DH / kPer;        // vectors per K/V row
  constexpr int NRG = kThreads / (DH / 2);  // row groups in P.V
  constexpr int KR = (WIDE ? kMaxRows : kMaxRows / 2) / NRG;

  cg::cluster_group cluster = cg::this_cluster();
  const int split = int(cluster.block_rank()), splits = int(gridDim.x);
  const int kk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int dp = tid % (DH / 2), rg = tid / (DH / 2);
  const int rows = t * g, heads = kv * g;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* stages = smem_raw;  // [2] x stage_bytes
  float* qs = reinterpret_cast<float*>(smem_raw +
                                       2 * stage_bytes<TKV, DH, KV8>());
  float* ps = qs + rows * DH;           // [rows][TC] scores, then P
  float* row_m = ps + rows * TC;        // [rows] running max
  float* row_l = row_m + rows;          // [rows] running sum
  float* row_a = row_l + rows;          // [rows] this tile's rescale

  // The counter, the first two table entries of this split and the query
  // rows are loaded together, before the counter is known: every entry
  // exists whatever the counter says (unowned entries hold block 0).
  const int* trow = table + size_t(b) * table_len;
  const int idx = index[b];
  int entry = trow[min(split, table_len - 1)];
  int entry_after = trow[min(split + splits, table_len - 1)];
  for (int e = tid; e < rows * DH; e += kThreads) {
    const int r = e / DH, d = e % DH;
    const int ti = r / g, gi = r % g;
    qs[e] = to_f32(q[((size_t(b) * t + ti) * heads + kk * g + gi) * DH + d]);
  }
  for (int r = tid; r < rows; r += kThreads) {
    row_m[r] = -INFINITY;
    row_l[r] = 0.f;
  }
  float acc[KR][2];
#pragma unroll
  for (int k = 0; k < KR; ++k) acc[k][0] = acc[k][1] = 0.f;

  const int nblk = owned_blocks(idx, t, blk, table_len);
  const int nmine = split < nblk ? (nblk - split + splits - 1) / splits : 0;
  const int tpb = (blk + TC - 1) / TC;  // tiles a block
  const int ntiles = nmine * tpb;
  const size_t row_stride = size_t(kv) * DH;

  // Issues tile it's copies into stage it & 1 from pool block ent.
  auto issue = [&](int it, int ent) {
    unsigned char* st = stages + (it & 1) * stage_bytes<TKV, DH, KV8>();
    TKV* vt = reinterpret_cast<TKV*>(st + TC * kRowBytes);
    const int c0 = (it % tpb) * TC, ncols = min(TC, blk - c0);
    const size_t base = size_t(ent) * blk + c0;
    for (int e = tid; e < ncols * kVecs; e += kThreads) {
      const int c = e / kVecs, v = e % kVecs;
      const size_t at = (base + c) * row_stride + size_t(kk) * DH + v * kPer;
      cp_async16(st + c * kRowBytes + v * 16, pool_k + at);
      cp_async16(vt + c * DH + v * kPer, pool_v + at);
    }
    if constexpr (KV8) {
      float* sc = reinterpret_cast<float*>(vt + TC * DH);  // [2][TC]
      for (int c = tid; c < ncols; c += kThreads) {
        const size_t at = (base + c) * kv + kk;
        cp_async4(sc + c, k_scale + at);
        cp_async4(sc + TC + c, v_scale + at);
      }
    }
  };

  if (ntiles > 0) issue(0, entry);
  cp_async_commit();
  for (int it = 0; it < ntiles; ++it) {
    const int nx = it + 1;
    if (nx < ntiles) {
      if (nx % tpb == 0) {  // the next tile opens this split's next block
        entry = entry_after;
        entry_after =
            trow[min(split + (nx / tpb + 1) * splits, table_len - 1)];
      }
      issue(nx, entry);
    }
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();

    const unsigned char* st = stages + (it & 1) * stage_bytes<TKV, DH, KV8>();
    const TKV* vt = reinterpret_cast<const TKV*>(st + TC * kRowBytes);
    const float* ksc = reinterpret_cast<const float*>(vt + TC * DH);
    const float* vsc = ksc + TC;
    const int j = split + (it / tpb) * splits;
    const int c0 = (it % tpb) * TC, ncols = min(TC, blk - c0);
    if (tid < ncols) {
      // Scores of key column c0+tid against every query row, four rows at a
      // time with two partial sums each.
      float kr[DH];
#pragma unroll
      for (int v = 0; v < kVecs; ++v)
        load_vec(reinterpret_cast<const TKV*>(st + tid * kRowBytes) + v * kPer,
                 kr + v * kPer);
      const float ks = KV8 ? ksc[tid] : 1.f;
      const int pos = j * blk + c0 + tid;
      for (int r0 = 0; r0 < rows; r0 += 4) {
        const float* qr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qr[i] = qs + min(r0 + i, rows - 1) * DH;
        float s[4][2] = {};
#pragma unroll
        for (int d = 0; d < DH; d += 4) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 qv = *reinterpret_cast<const float4*>(qr[i] + d);
            s[i][0] = fmaf(qv.x, kr[d], s[i][0]);
            s[i][1] = fmaf(qv.y, kr[d + 1], s[i][1]);
            s[i][0] = fmaf(qv.z, kr[d + 2], s[i][0]);
            s[i][1] = fmaf(qv.w, kr[d + 3], s[i][1]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + i;
          if (r < rows) {
            float x = s[i][0] + s[i][1];
            if constexpr (KV8) x *= ks;
            ps[r * TC + tid] = pos <= idx + r / g ? x * scale : kMasked;
          }
        }
      }
    }
    __syncthreads();
    // Online softmax over this tile, one warp per query row.
    for (int r0 = 0; r0 < rows; r0 += kWarps) {
      const int r = r0 + warp;
      if (r < rows) {
        float* pr = ps + r * TC;
        float mx = -INFINITY;
        for (int c = lane; c < ncols; c += 32) mx = fmaxf(mx, pr[c]);
        mx = warp_max(mx);
        const float m_old = row_m[r];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int c = lane; c < ncols; c += 32) {
          const float p = expf(pr[c] - m_new);
          sum += p;
          // kv8: the value scale weighs P in P.V only, not in the sum.
          pr[c] = KV8 ? p * vsc[c] : p;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float a = expf(m_old - m_new);  // 0 on the first tile
          row_a[r] = a;
          row_l[r] = row_l[r] * a + sum;
          row_m[r] = m_new;
        }
      }
    }
    __syncthreads();
    // acc[k][:] = acc[k][:] * a + sum_c P[r][c] * V[c][2dp:2dp+2] for row
    // r = rg + k*NRG; rows past the last are read as the last, never stored.
    const float* prow[KR];
    float s[KR][2];
#pragma unroll
    for (int k = 0; k < KR; ++k) {
      prow[k] = ps + min(rg + k * NRG, rows - 1) * TC;
      s[k][0] = s[k][1] = 0.f;
    }
    const TKV* vcol = vt + 2 * dp;
    int c = 0;
    for (; c + 4 <= ncols; c += 4) {
      float v[4][2];
#pragma unroll
      for (int u = 0; u < 4; ++u) load2(vcol + (c + u) * DH, v[u]);
#pragma unroll
      for (int k = 0; k < KR; ++k) {
        const float4 p = *reinterpret_cast<const float4*>(prow[k] + c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          s[k][h] = fmaf(p.x, v[0][h], s[k][h]);
          s[k][h] = fmaf(p.y, v[1][h], s[k][h]);
          s[k][h] = fmaf(p.z, v[2][h], s[k][h]);
          s[k][h] = fmaf(p.w, v[3][h], s[k][h]);
        }
      }
    }
    for (; c < ncols; ++c) {
      float v[2];
      load2(vcol + c * DH, v);
#pragma unroll
      for (int k = 0; k < KR; ++k) {
        s[k][0] = fmaf(prow[k][c], v[0], s[k][0]);
        s[k][1] = fmaf(prow[k][c], v[1], s[k][1]);
      }
    }
#pragma unroll
    for (int k = 0; k < KR; ++k) {
      const float a = row_a[min(rg + k * NRG, rows - 1)];
      acc[k][0] = acc[k][0] * a + s[k][0];
      acc[k][1] = acc[k][1] * a + s[k][1];
    }
    __syncthreads();
  }

  // This CTA's partial P.V sums, [rows][DH], in place of the query rows
  // (which a CTA that owned no tile last wrote).
  __syncthreads();
  float* part = qs;
#pragma unroll
  for (int k = 0; k < KR; ++k) {
    const int r = rg + k * NRG;
    if (r < rows) {
      part[r * DH + 2 * dp] = acc[k][0];
      part[r * DH + 2 * dp + 1] = acc[k][1];
    }
  }
  cluster.sync();

  // Each query row's weights of the splits, in split order:
  // w[sp][r] = exp(m_sp - m) / sum_sp l_sp exp(m_sp - m). Split 0 owns block
  // 0, which every row sees, so m is a real score.
  float* w = ps;  // [splits][rows]
  for (int r = tid; r < rows; r += kThreads) {
    float m = -INFINITY;
    for (int sp = 0; sp < splits; ++sp)
      m = fmaxf(m, cluster.map_shared_rank(row_m, sp)[r]);
    float l = 0.f;
    for (int sp = 0; sp < splits; ++sp) {
      const float e = expf(cluster.map_shared_rank(row_m, sp)[r] - m);
      w[sp * rows + r] = e;
      l = fmaf(cluster.map_shared_rank(row_l, sp)[r], e, l);
    }
    const float inv = 1.f / l;
    for (int sp = 0; sp < splits; ++sp) w[sp * rows + r] *= inv;
  }
  __syncthreads();
  // This CTA's share of the outputs, every split's partial in split order.
  const int total = rows * DH, share = (total + splits - 1) / splits;
  const int e1 = min(total, (split + 1) * share);
  for (int e = split * share + tid; e < e1; e += kThreads) {
    const int r = e / DH, d = e % DH;
    float o = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < splits; ++sp)
      o = fmaf(cluster.map_shared_rank(part, sp)[e], w[sp * rows + r], o);
    const int ti = r / g, gi = r % g;
    out[((size_t(b) * t + ti) * heads + kk * g + gi) * DH + d] = o;
  }
  cluster.sync();
}

template <typename TQ, typename TKV, int DH, bool KV8, bool WIDE>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v,
                   const float* k_scale, const float* v_scale,
                   const int* table, const int* index, float* out, int b,
                   int t, int g, int kv, int blk, int table_len, int splits,
                   cudaStream_t stream) {
  auto* kernel = paged_attend_kernel<TQ, TKV, DH, KV8, WIDE>;
  // Above 48 KB a kernel needs the opt-in; set it once to the most any row
  // count can ask for, with clusters of more than 8 CTAs allowed.
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem_bytes<TKV, DH, KV8>(kMaxRows)));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(splits, kv, b);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem_bytes<TKV, DH, KV8>(t * g);
  config.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = unsigned(splits);
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  config.attrs = &cluster;
  config.numAttrs = 1;
  const float scale = float(1.0 / sqrt(double(DH)));
  const cudaError_t err = cudaLaunchKernelEx(
      &config, kernel, static_cast<const TQ*>(q),
      static_cast<const TKV*>(pool_k), static_cast<const TKV*>(pool_v),
      k_scale, v_scale, table, index, out, t, g, kv, blk, table_len, scale);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename TQ, typename TKV, bool KV8>
cudaError_t launch_dh(int dh, const void* q, const void* pool_k,
                      const void* pool_v, const float* k_scale,
                      const float* v_scale, const int* table,
                      const int* index, float* out, int b, int t, int g,
                      int kv, int blk, int table_len, int splits,
                      cudaStream_t stream) {
  const bool wide = t * g > kMaxRows / 2;
#define PAGED_ARGS                                                           \
  q, pool_k, pool_v, k_scale, v_scale, table, index, out, b, t, g, kv, blk,  \
      table_len, splits, stream
#define PAGED_DH_CASE(D)                                                     \
  case D:                                                                    \
    return wide ? launch<TQ, TKV, D, KV8, true>(PAGED_ARGS)                  \
                : launch<TQ, TKV, D, KV8, false>(PAGED_ARGS);
  switch (dh) {
    PAGED_DH_CASE(16)
    PAGED_DH_CASE(32)
    PAGED_DH_CASE(64)
    PAGED_DH_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef PAGED_DH_CASE
#undef PAGED_ARGS
}

bool bad_geometry(int t, int g, int blk, int table_len, int splits) {
  return t * g > kMaxRows || t < 1 || g < 1 || blk < 1 || table_len < 1 ||
         splits < 1 || splits > kMaxSplits;
}

}  // namespace

// q [b,t,H,Dh] and pools [nb,blk,KV,Dh] in one dtype (is_bf16: 1 = bf16,
// 0 = f32), table [b,table_len] and index [b] int32, out f32 [b,t,H,Dh];
// `splits` is the cluster size S (1..16). All contiguous, 16-byte aligned.
// One launch on `stream`; allocates nothing, does not synchronise, and
// returns the launch's error (0 = launched).
extern "C" int paged_attend_launch(const void* q, const void* pool_k,
                                   const void* pool_v, const void* table,
                                   const void* index, void* out, int b, int t,
                                   int g, int kv, int dh, int blk,
                                   int table_len, int splits, int is_bf16,
                                   void* stream) {
  if (bad_geometry(t, g, blk, table_len, splits)) return cudaErrorInvalidValue;
  const int* tbl = static_cast<const int*>(table);
  const int* idx = static_cast<const int*>(index);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_dh<__nv_bfloat16, __nv_bfloat16, false>(
                    dh, q, pool_k, pool_v, nullptr, nullptr, tbl, idx, o, b,
                    t, g, kv, blk, table_len, splits, s)
              : launch_dh<float, float, false>(
                    dh, q, pool_k, pool_v, nullptr, nullptr, tbl, idx, o, b,
                    t, g, kv, blk, table_len, splits, s);
  return int(err);
}

// The kv8 variant: q [b,t,H,Dh] f32 or bf16 (q_is_bf16), pools
// [nb,blk,KV,Dh] int8, k_scale and v_scale f32 [nb,blk,KV]; the rest as
// paged_attend_launch.
extern "C" int paged_attend_kv8_launch(
    const void* q, const void* pool_k, const void* pool_v,
    const void* k_scale, const void* v_scale, const void* table,
    const void* index, void* out, int b, int t, int g, int kv, int dh,
    int blk, int table_len, int splits, int q_is_bf16, void* stream) {
  if (bad_geometry(t, g, blk, table_len, splits)) return cudaErrorInvalidValue;
  const float* ks = static_cast<const float*>(k_scale);
  const float* vsp = static_cast<const float*>(v_scale);
  const int* tbl = static_cast<const int*>(table);
  const int* idx = static_cast<const int*>(index);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      q_is_bf16 ? launch_dh<__nv_bfloat16, int8_t, true>(
                      dh, q, pool_k, pool_v, ks, vsp, tbl, idx, o, b, t, g,
                      kv, blk, table_len, splits, s)
                : launch_dh<float, int8_t, true>(
                      dh, q, pool_k, pool_v, ks, vsp, tbl, idx, o, b, t, g,
                      kv, blk, table_len, splits, s);
  return int(err);
}
