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
// What the design does about it:
//  - It reads only the blocks a lane owns, nblk = ceil((index[b]+t)/blk),
//    so the traffic follows the lanes' lengths and not max_seq_len.
//  - No copy-then-finalize. The TPU kernel landed every block in VMEM and
//    ran one full-row softmax to stay bit-identical in interpret mode. Here
//    each CTA keeps a running max and sum in f32 (online softmax),
//    accumulates P.V in f32 and never stages more than one tile.
//  - The block walk is split over grid.x (flash-decoding). CTA
//    (split, kk, b) walks `bps` blocks of lane b for KV head kk and writes a
//    partial (max, sum, P.V); a second, small launch merges the partials.
//    Unsplit, the slice's shapes would give 4 lanes x 4 KV heads = 16 CTAs
//    on 132 SMs. With blk=128 and bps=1 the grid is 32 x 4 x 4 = 512 CTAs,
//    of which the (28+14+7+4) x 4 = 212 that own a block at join do work.
//  - The t*g query rows that share a KV head share one walk, so a K/V row is
//    read once per KV head (GQA), and t > 1 (the speculative verify chunk)
//    rides the same kernel.
//  - Each thread holds one key row in registers (16-byte vector loads: 16
//    int8 keys a load under kv8, widened to f32); the V tile is copied into
//    shared memory in its stored type (int8 under kv8) by cp.async while
//    the scores are computed. Under kv8 a thread reads its key column's two
//    scales once (they are strided by KV); the value scale goes to shared
//    memory for the softmax pass to fold into P. A CTA loads its lane's
//    counter, first table entry and query rows together, so the walk
//    waits on one dependent load, not three. The P.V sums keep four
//    partial sums each, so their shared-memory loads overlap.
//  - The merge reads the partials from L2: one warp per query row turns
//    the splits' (max, sum) into weights, then each thread sums its
//    output elements over the splits with several loads in flight.
// Tensor cores (wgmma) and TMA are later work: this is the plain, correct
// first kernel. On an H100 80GB HBM3 at 700 W a call at the slice's shapes
// takes about 19 us of device time (chip_smoke.py, CUDA-graph replay),
// some 11 us in the partial pass and 6 in the merge: chains of dependent
// loads and two launches, not bytes, bound it there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // threads per CTA = key columns per tile
constexpr int kMaxRows = 32;       // query rows (t * g) a CTA serves
constexpr int kMaxSplits = 256;    // splits a merge weighs (32 KB of smem)
constexpr float kMasked = -1e30f;  // the oracle's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return float(x); }

// One 16-byte vector of T, widened to f32.
template <typename T>
__device__ __forceinline__ void load_vec(const T* __restrict__ src,
                                         float* dst) {
  constexpr int kPer = 16 / sizeof(T);
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(src));
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int j = 0; j < kPer; ++j) dst[j] = to_f32(e[j]);
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

// Copy 16 bytes from device memory to shared memory without passing
// through registers (cp.async, sm_80 and up); completes at cp_async_wait.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// The V tile in its stored type, under kv8 the tile's value scales, then
// f32 query rows, scores and row statistics.
template <typename TKV, int DH, bool KV8>
constexpr size_t smem_bytes(int rows) {
  return sizeof(TKV) * size_t(kThreads) * DH +
         sizeof(float) * ((KV8 ? size_t(kThreads) : 0) + size_t(rows) * DH +
                          size_t(rows) * kThreads + 3 * size_t(rows));
}

// Pass 1: CTA (split, kk, b) folds blocks [split*bps, (split+1)*bps) of
// lane b's table into one partial (max, sum, P.V) per query row. q is TQ,
// the pools TKV: both f32 or both bf16, or (KV8) int8 pools with f32 scale
// pools k_scale and v_scale [nb,blk,KV] (null otherwise).
template <typename TQ, typename TKV, int DH, bool KV8>
__global__ void __launch_bounds__(kThreads)
paged_partial(const TQ* __restrict__ q, const TKV* __restrict__ pool_k,
              const TKV* __restrict__ pool_v,
              const float* __restrict__ k_scale,
              const float* __restrict__ v_scale,
              const int* __restrict__ table,
              const int* __restrict__ index, float* __restrict__ m_part,
              float* __restrict__ l_part, float* __restrict__ acc_part,
              int t, int g, int kv, int blk, int table_len, int bps,
              int nsplit, float scale) {
  const int split = blockIdx.x, kk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = t * g, heads = kv * g;
  const int j0 = split * bps;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  TKV* vs = reinterpret_cast<TKV*>(smem_raw);  // [kThreads][DH] V tile
  float* vsc = reinterpret_cast<float*>(vs + kThreads * DH);  // [kThreads]
  float* qs = vsc + (KV8 ? kThreads : 0);  // [rows][DH]
  float* ps = qs + rows * DH;        // [rows][kThreads] scores, then P
  float* row_m = ps + rows * kThreads;  // [rows] running max
  float* row_l = row_m + rows;       // [rows] running sum
  float* row_a = row_l + rows;       // [rows] this tile's rescale

  // The counter, the first table entry and the query rows are loaded
  // together, before the counter is known: entry j0 exists whatever the
  // counter says (unowned entries hold block 0).
  const int idx = index[b];
  int entry = table[size_t(b) * table_len + min(j0, table_len - 1)];
  for (int e = tid; e < rows * DH; e += kThreads) {
    const int r = e / DH, d = e % DH;
    const int ti = r / g, gi = r % g;
    qs[e] = to_f32(q[((size_t(b) * t + ti) * heads + kk * g + gi) * DH + d]);
  }
  const int nblk = owned_blocks(idx, t, blk, table_len);
  if (j0 >= nblk) return;  // this split owns no block of lane b
  const int j1 = min(j0 + bps, nblk);
  for (int r = tid; r < rows; r += kThreads) {
    row_m[r] = -INFINITY;
    row_l[r] = 0.f;
  }
  // Thread tid owns accumulator elements tid + i*kThreads of [rows][DH].
  constexpr int kAcc = (kMaxRows * DH + kThreads - 1) / kThreads;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  __syncthreads();

  constexpr int kPer = 16 / sizeof(TKV);  // elements per 16-byte vector
  constexpr int kVecs = DH / kPer;      // vectors per K/V row
  const size_t row_stride = size_t(kv) * DH;

  for (int j = j0; j < j1; ++j) {
    if (j > j0) entry = table[size_t(b) * table_len + j];
    const size_t base = size_t(entry) * blk;
    for (int c0 = 0; c0 < blk; c0 += kThreads) {
      const int ncols = min(kThreads, blk - c0);
      // The V tile lands in shared memory while the scores are computed.
      for (int e = tid; e < ncols * kVecs; e += kThreads) {
        const int c = e / kVecs, v = e % kVecs;
        cp_async16(vs + c * DH + v * kPer,
                   pool_v + (base + c0 + c) * row_stride + size_t(kk) * DH +
                       v * kPer);
      }
      if (tid < ncols) {
        // Scores of key column c0+tid against every query row.
        const TKV* krow =
            pool_k + (base + c0 + tid) * row_stride + size_t(kk) * DH;
        float kr[DH];
#pragma unroll
        for (int v = 0; v < kVecs; ++v) load_vec(krow + v * kPer, kr + v * kPer);
        float ks = 1.f;
        if constexpr (KV8) {
          const size_t at = (base + c0 + tid) * kv + kk;
          ks = k_scale[at];
          vsc[tid] = v_scale[at];
        }
        const int pos = j * blk + c0 + tid;
        for (int r = 0; r < rows; ++r) {
          const float4* q4 = reinterpret_cast<const float4*>(qs + r * DH);
          float s = 0.f;
#pragma unroll
          for (int d = 0; d < DH / 4; ++d) {
            const float4 qv = q4[d];
            s = fmaf(qv.x, kr[4 * d], s);
            s = fmaf(qv.y, kr[4 * d + 1], s);
            s = fmaf(qv.z, kr[4 * d + 2], s);
            s = fmaf(qv.w, kr[4 * d + 3], s);
          }
          if constexpr (KV8) s *= ks;
          ps[r * kThreads + tid] = pos <= idx + r / g ? s * scale : kMasked;
        }
      }
      cp_async_wait();
      __syncthreads();
      // Online softmax over this tile, one warp per query row.
      for (int r = warp; r < rows; r += kThreads / 32) {
        float* pr = ps + r * kThreads;
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
          if constexpr (KV8)
            pr[c] = p * vsc[c];
          else
            pr[c] = p;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float a = expf(m_old - m_new);  // 0 on the first tile
          row_a[r] = a;
          row_l[r] = row_l[r] * a + sum;
          row_m[r] = m_new;
        }
      }
      __syncthreads();
      // acc[r][d] = acc[r][d] * a[r] + sum_c P[r][c] * V[c][d], with four
      // partial sums and the column loop unrolled, so shared-memory loads
      // overlap instead of each waiting on the one before.
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const int e = tid + i * kThreads;
        if (e < rows * DH) {
          const int r = e / DH, d = e % DH;
          const float* pr = ps + r * kThreads;
          float s[4] = {0.f, 0.f, 0.f, 0.f};
          int c = 0;
#pragma unroll 4
          for (; c + 4 <= ncols; c += 4) {
#pragma unroll
            for (int u = 0; u < 4; ++u)
              s[u] = fmaf(pr[c + u], to_f32(vs[(c + u) * DH + d]), s[u]);
          }
          for (; c < ncols; ++c) s[0] = fmaf(pr[c], to_f32(vs[c * DH + d]), s[0]);
          acc[i] = acc[i] * row_a[r] + ((s[0] + s[1]) + (s[2] + s[3]));
        }
      }
      __syncthreads();
    }
  }
  const size_t part = (size_t(b) * kv + kk) * nsplit + split;
  for (int r = tid; r < rows; r += kThreads) {
    m_part[part * rows + r] = row_m[r];
    l_part[part * rows + r] = row_l[r];
  }
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int e = tid + i * kThreads;
    if (e < rows * DH) acc_part[part * rows * DH + e] = acc[i];
  }
}

// Pass 2: CTA (kk, b) merges lane b's live partials into the output. Split
// 0 always holds column 0, which every query row sees, so the merged max is
// a real score and splits whose rows were all masked weigh exactly 0.
// One warp per query row turns the splits' (max, sum) into normalised
// weights in shared memory ([nsplit][rows] floats); then every thread
// sums its output elements over the splits, several loads in flight.
__global__ void __launch_bounds__(kThreads)
paged_combine(const float* __restrict__ m_part,
              const float* __restrict__ l_part,
              const float* __restrict__ acc_part,
              const int* __restrict__ index, float* __restrict__ out, int t,
              int g, int kv, int dh, int blk, int table_len, int bps,
              int nsplit) {
  const int kk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = t * g, heads = kv * g;
  const int nblk = owned_blocks(index[b], t, blk, table_len);
  const int nlive = (nblk + bps - 1) / bps;
  const size_t base = (size_t(b) * kv + kk) * nsplit;
  const float* mp = m_part + base * rows;  // [nsplit][rows]
  const float* lp = l_part + base * rows;
  extern __shared__ float w[];             // [nlive][rows]
  for (int r = warp; r < rows; r += kThreads / 32) {
    float mx = -INFINITY;
    for (int s = lane; s < nlive; s += 32) mx = fmaxf(mx, mp[s * rows + r]);
    mx = warp_max(mx);
    float l = 0.f;
    for (int s = lane; s < nlive; s += 32) {
      const float e = expf(mp[s * rows + r] - mx);
      w[s * rows + r] = e;
      l = fmaf(lp[s * rows + r], e, l);
    }
    const float inv = 1.f / warp_sum(l);
    for (int s = lane; s < nlive; s += 32) w[s * rows + r] *= inv;
  }
  __syncthreads();
  const float* ap = acc_part + base * rows * dh;  // [nsplit][rows][dh]
  const size_t stride = size_t(rows) * dh;
  for (int e = tid; e < rows * dh; e += kThreads) {
    const int r = e / dh, d = e % dh;
    float o = 0.f;
#pragma unroll 8
    for (int s = 0; s < nlive; ++s) o = fmaf(ap[s * stride + e], w[s * rows + r], o);
    const int ti = r / g, gi = r % g;
    out[((size_t(b) * t + ti) * heads + kk * g + gi) * dh + d] = o;
  }
}

template <typename TQ, typename TKV, int DH, bool KV8>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v,
                   const float* k_scale, const float* v_scale,
                   const int* table, const int* index, float* m_part,
                   float* l_part, float* acc_part, float* out, int b, int t,
                   int g, int kv, int blk, int table_len, int bps,
                   int nsplit, cudaStream_t stream) {
  // Above 48 KB a kernel needs the opt-in; set it once to the most any
  // row count can ask for (98,688 bytes for f32 at DH=128).
  constexpr size_t kMaxSmem = smem_bytes<TKV, DH, KV8>(kMaxRows);
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_partial<TQ, TKV, DH, KV8>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(kMaxSmem));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const float scale = float(1.0 / sqrt(double(DH)));
  paged_partial<TQ, TKV, DH, KV8><<<dim3(nsplit, kv, b), kThreads,
                                    smem_bytes<TKV, DH, KV8>(t * g),
                                    stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(pool_k),
      static_cast<const TKV*>(pool_v), k_scale, v_scale, table, index,
      m_part, l_part, acc_part, t, g, kv, blk, table_len, bps, nsplit,
      scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_combine<<<dim3(kv, b), kThreads,
                  sizeof(float) * size_t(nsplit) * t * g, stream>>>(
      m_part, l_part, acc_part, index, out, t, g, kv, DH, blk, table_len, bps,
      nsplit);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, bool KV8>
cudaError_t launch_dh(int dh, const void* q, const void* pool_k,
                      const void* pool_v, const float* k_scale,
                      const float* v_scale, const int* table,
                      const int* index, float* m_part, float* l_part,
                      float* acc_part, float* out, int b, int t, int g,
                      int kv, int blk, int table_len, int bps, int nsplit,
                      cudaStream_t stream) {
#define PAGED_DH_CASE(D)                                                     \
  case D:                                                                    \
    return launch<TQ, TKV, D, KV8>(q, pool_k, pool_v, k_scale, v_scale,     \
                                   table, index, m_part, l_part, acc_part,   \
                                   out, b, t, g, kv, blk, table_len, bps,    \
                                   nsplit, stream);
  switch (dh) {
    PAGED_DH_CASE(16)
    PAGED_DH_CASE(32)
    PAGED_DH_CASE(64)
    PAGED_DH_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef PAGED_DH_CASE
}

}  // namespace

// q [b,t,H,Dh] and pools [nb,blk,KV,Dh] in one dtype (is_bf16: 1 = bf16,
// 0 = f32), table [b,table_len] and index [b] int32, out f32 [b,t,H,Dh];
// m_part/l_part f32 [b,KV,nsplit,t*g] and acc_part f32
// [b,KV,nsplit,t*g,Dh] are scratch the caller allocates. All contiguous,
// 16-byte aligned. Launches on `stream`, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 = launched).
extern "C" int paged_attend_launch(
    const void* q, const void* pool_k, const void* pool_v, const void* table,
    const void* index, void* m_part, void* l_part, void* acc_part, void* out,
    int b, int t, int g, int kv, int dh, int blk, int table_len, int bps,
    int nsplit, int is_bf16, void* stream) {
  if (t * g > kMaxRows || t < 1 || g < 1 || bps < 1 || nsplit > kMaxSplits)
    return cudaErrorInvalidValue;
  const int* tbl = static_cast<const int*>(table);
  const int* idx = static_cast<const int*>(index);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  float* ap = static_cast<float*>(acc_part);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_dh<__nv_bfloat16, __nv_bfloat16, false>(
                    dh, q, pool_k, pool_v, nullptr, nullptr, tbl, idx, mp, lp,
                    ap, o, b, t, g, kv, blk, table_len, bps, nsplit, s)
              : launch_dh<float, float, false>(
                    dh, q, pool_k, pool_v, nullptr, nullptr, tbl, idx, mp, lp,
                    ap, o, b, t, g, kv, blk, table_len, bps, nsplit, s);
  return int(err);
}

// The kv8 variant: q [b,t,H,Dh] f32 or bf16 (q_is_bf16), pools
// [nb,blk,KV,Dh] int8, k_scale and v_scale f32 [nb,blk,KV]; the rest as
// paged_attend_launch.
extern "C" int paged_attend_kv8_launch(
    const void* q, const void* pool_k, const void* pool_v,
    const void* k_scale, const void* v_scale, const void* table,
    const void* index, void* m_part, void* l_part, void* acc_part, void* out,
    int b, int t, int g, int kv, int dh, int blk, int table_len, int bps,
    int nsplit, int q_is_bf16, void* stream) {
  if (t * g > kMaxRows || t < 1 || g < 1 || bps < 1 || nsplit > kMaxSplits)
    return cudaErrorInvalidValue;
  const float* ks = static_cast<const float*>(k_scale);
  const float* vsp = static_cast<const float*>(v_scale);
  const int* tbl = static_cast<const int*>(table);
  const int* idx = static_cast<const int*>(index);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  float* ap = static_cast<float*>(acc_part);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      q_is_bf16 ? launch_dh<__nv_bfloat16, int8_t, true>(
                      dh, q, pool_k, pool_v, ks, vsp, tbl, idx, mp, lp, ap, o,
                      b, t, g, kv, blk, table_len, bps, nsplit, s)
                : launch_dh<float, int8_t, true>(
                      dh, q, pool_k, pool_v, ks, vsp, tbl, idx, mp, lp, ap, o,
                      b, t, g, kv, blk, table_len, bps, nsplit, s);
  return int(err);
}
