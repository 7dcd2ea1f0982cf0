// Paged attention for Hopper (sm_90a): a window of Q query tokens per slot
// attends over that slot's KV pages through its block table. Q = 1 is
// decode (`paged_attention_decode_kernel`, launched once per layer per
// decoded token); Q = k + 1 is the speculative verify window
// (`paged_attention_multi_kernel`, launched once per layer per verify
// round). Both kernels run one body, `paged_attention_body`, and each has
// its own C entry point and its own name in a profiler trace.
//
// Replaces the TPU kernels `paged_attention` and `paged_attention_multi` in
// src/repro/kernels/paged_attention.py (wrappers :213 and :145, bodies
// `_paged_kernel` :46 and `_paged_multi_kernel` :93). It computes what they
// compute, not how: scale Dh^-0.5, an online softmax with f32 running max
// m, denominator l and accumulator acc, GQA (KV head h serves query heads
// h*G .. h*G+G-1, G = H / Hkv), window row r masked to positions
// < length - (Q-1-r), zeros (not NaN) for a row with nothing to attend
// (a dead slot, length 0, or a row whose limit is <= 0), `layer` indexing
// axis 2 of the pool, output in q's dtype.
//
// Layouts (the JAX package's, unchanged; q is read in place, without the
// TPU wrapper's window-major transpose):
//   q       [B, Q, H, Dh]   (decode: [B, H, Dh], the same memory at Q = 1)
//   pools   [num_blocks + 1, block_size, L, Hkv, Dh]  (last block is trash)
//   tables  [B, n_pages] int32, lengths [B] int32, out like q
//   head_dim a multiple of 8 and at most 128; any Q and G; pools 16-byte
//   aligned
//
// Bound. Each staged K/V element feeds ~4 flops per row, ~4 R in all (12
// flop/byte-pair at R = 12 in bf16), far below the ~295 flop/byte at which
// the H100's bf16 tensor cores become the limit, so the bound is bytes: the
// live K and V pages, sum_b min(length_b, n_pages * block_size) * Hkv * Dh
// * 2 * sizeof(dtype) per call, at 3.35 TB/s. At decode's shapes that is
// well under a microsecond: the time is latency (the launch, dependent
// reads of the length, the table and the pages) and how much of it runs
// one after another.
//
// Design. A cluster of C thread blocks of 256 threads per (slot, KV head,
// row tile), grid (C, Hkv * T, B), C = min(8, ceil(n_pages * block_size /
// 64)) chosen on the host from the table's width alone (the lengths live on
// the card, and reading them would cost a host sync per step). The Q * G
// rows of a KV head (row e: window position e / G, head e % G) are cut into
// T = ceil(Q * G / 64) tiles of at most kMaxRows = 64 rows, so a window of
// any size fits shared memory; each tile walks the same positions through
// the block table (a window past 64 rows reads its K/V T times). A window
// of one tile launches the untiled instantiation, the code of the body
// before the tiles (a tiled instantiation cost a window of 12 rows 0.4 us
// of its 17 us on an H100, PERF.md). Block c of
// the cluster takes the c-th of C equal shares of the slot's live positions
// (a share may be empty: it then holds m = -inf, l = 0) and owns all R rows
// of its tile, so every K/V row is read from device memory once per call
// and tile, not once per query head or window row. The slot's block table is
// staged in shared memory in the same round trip as its length (tables of
// up to kTablePages entries; wider ones are read in place, one dependent
// round trip more: on an H100 that costs 0.00013-0.00026 ms a call at the
// serving decode shape, 1-2 %, see PERF.md); the block walks its share in
// tiles of 64 positions (at the serving shapes a share is one tile). A
// tile is staged in the pool's own dtype with 16-byte `cp.async` copies,
// all issued before one wait (one round trip to device memory per tile),
// K rows padded by 16 bytes so that a warp's 16-byte reads of 32 rows
// are free of bank conflicts; q is staged meanwhile. One thread per (row,
// position) forms a score from q (f32, scaled, in shared
// memory), one warp per row does the online-softmax update with shuffles,
// one thread per (row, channel) rescales and accumulates P.V. The blocks
// of the cluster then merge their (m, l, acc) through distributed shared
// memory: after a cluster barrier, each block reads every rank's partial
// state at once for its slice of the R x Dh outputs and writes that slice,
// and a second barrier keeps each block's shared memory alive until the
// others have read it. No scratch tensor, no atomics, one launch. Plain FMA
// on the CUDA cores: the products are R x Dh by Dh x 64 with R <= 12 on
// the serving paths, too thin for the tensor cores. Measured on the card,
// the time is the launch, three dependent round trips (length and table,
// K/V, the cluster's shared memory) and two cluster barriers.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 64;      // positions per staged tile
constexpr int kThreads = 256;  // eight warps
constexpr int kMaxHeadDim = 128;
constexpr int kMaxRows = 64;   // rows of Q * G one block owns (a tile)
constexpr int kMaxCluster = 8; // the portable cluster size
constexpr int kRankPositions = 64;  // coverage per cluster rank (host side)
constexpr int kTablePages = 1024;   // block-table entries staged in shared
                                    // memory (longer tables are read in
                                    // place)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// shared memory row stride of the K tile, in elements: 16 bytes of padding
template <typename T>
__host__ __device__ constexpr int k_stride(int Dh) {
  return Dh + 16 / static_cast<int>(sizeof(T));
}

// Shared memory, in bytes, for one block of R rows: the K and V tiles in T,
// then f32 q, acc, P and m, l, alpha, then the slot's block table (up to
// kTablePages int32)
template <typename T>
__host__ __device__ inline size_t smem_bytes(int R, int Dh, int n_pages) {
  return sizeof(T) * kTile * (k_stride<T>(Dh) + Dh)
         + sizeof(float) * (2 * static_cast<size_t>(R) * Dh
                            + static_cast<size_t>(R) * kTile
                            + 3 * static_cast<size_t>(R))
         + sizeof(int) * static_cast<size_t>(
               n_pages < kTablePages ? n_pages : kTablePages);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// sum_d q[d] k[d] over Dh channels: q f32, k in T, 16 bytes of each at a
// time, in two partial sums
template <typename T>
__device__ __forceinline__ float dot(const float* q, const T* k, int Dh) {
  constexpr int kVec = 16 / sizeof(T);
  float s[2] = {0.f, 0.f};
  for (int d = 0; d < Dh; d += kVec) {
    const uint4 raw = *reinterpret_cast<const uint4*>(k + d);
    const T* kx = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec; j += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(q + d + j);
      float& a = s[(j / 4) & 1];
      a = fmaf(qv.x, to_float(kx[j]), a);
      a = fmaf(qv.y, to_float(kx[j + 1]), a);
      a = fmaf(qv.z, to_float(kx[j + 2]), a);
      a = fmaf(qv.w, to_float(kx[j + 3]), a);
    }
  }
  return s[0] + s[1];
}

// kTiled: the rows of a KV head span more than one tile (Q * G > 64); the
// untiled instantiation folds row0 = 0 and keeps the one-tile code of a
// window that fits (decode, and verify windows of at most 64 rows)
template <typename T, bool kTiled>
__device__ __forceinline__ void paged_attention_body(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ tables,
    const int* __restrict__ lengths, T* __restrict__ out, int Q, int H,
    int Hkv, int Dh, int L, int block_size, int n_pages, int layer,
    float scale) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x;              // the cluster spans grid axis x
  const int rank = static_cast<int>(cluster.block_rank());
  const int G = H / Hkv;
  const int tiles = kTiled ? (Q * G + kMaxRows - 1) / kMaxRows : 1;
  const int h = kTiled ? blockIdx.y / tiles : blockIdx.y;  // KV head
  const int row0 = kTiled ? (blockIdx.y - h * tiles) * kMaxRows : 0;
  const int b = blockIdx.z;             // slot
  // this tile's R rows: row e of the tile is row row0 + e of the window,
  // at window position (row0 + e) / G and head (row0 + e) % G
  const int R = kTiled ? min(kMaxRows, Q * G - row0) : Q * G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;

  extern __shared__ __align__(16) unsigned char smem[];
  const int KS = k_stride<T>(Dh);
  T* ks = reinterpret_cast<T*>(smem);          // [kTile][KS]
  T* vs = ks + kTile * KS;                     // [kTile][Dh]
  float* qs = reinterpret_cast<float*>(vs + kTile * Dh);  // [R][Dh]
  float* acc = qs + R * Dh;                    // [R][Dh]
  float* ps = acc + R * Dh;                    // [R][kTile]
  float* m_s = ps + R * kTile;                 // [R]
  float* l_s = m_s + R;                        // [R]
  float* alpha_s = l_s + R;                    // [R]
  int* tab_s = reinterpret_cast<int*>(alpha_s + R);  // [<= kTablePages]

  // the slot's block table is read with its length, in one round trip to
  // device memory, not after it
  const int* table = tables + static_cast<size_t>(b) * n_pages;
  const bool staged = n_pages <= kTablePages;
  if (staged)
    for (int i = tid; i < n_pages; i += kThreads) tab_s[i] = table[i];

  // positions past the table's coverage do not exist (as in the plain
  // version's gather of n_pages * block_size positions); the last row
  // reaches furthest, so `length` bounds the walk for every row
  const int cover = n_pages * block_size;
  const int len_b = lengths[b];
  const int length = max(0, min(len_b, cover));
  const int share = (length + C - 1) / C;
  const int p_begin = min(length, rank * share);
  const int p_end = min(length, p_begin + share);

  const size_t row_stride = static_cast<size_t>(L) * Hkv * Dh;  // next pos
  const size_t blk_stride = static_cast<size_t>(block_size) * row_stride;
  const size_t head_off = (static_cast<size_t>(layer) * Hkv + h) * Dh;
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte copy
  const int row_vecs = Dh / kVec;       // the wrapper checks Dh % 8 == 0

  // stage the K and V rows of positions t0 .. t0 + min(kTile, p_end - t0)
  // - 1: every copy of a tile is issued before its one wait
  auto issue = [&](int t0) {
    const int n = min(kTile, p_end - t0);
    for (int e = tid; e < n * row_vecs; e += kThreads) {
      const int t = e / row_vecs;
      const int c = (e - t * row_vecs) * kVec;
      const int pos = t0 + t;
      const int page = staged ? tab_s[pos / block_size]
                              : table[pos / block_size];
      const size_t off =
          static_cast<size_t>(page) * blk_stride +
          static_cast<size_t>(pos % block_size) * row_stride + head_off + c;
      cp_async16(ks + t * KS + c, k_pages + off);
      cp_async16(vs + t * Dh + c, v_pages + off);
    }
  };
  // the first tile's reads go out before q is staged, so the two overlap
  __syncthreads();   // the staged table
  if (p_begin < p_end) issue(p_begin);

  // q row e lives at q[b, w / G, h * G + w % G, :], w = row0 + e
  for (int e = tid; e < R * Dh; e += kThreads) {
    const int row = e / Dh;
    const int w = row0 + row;
    const int r = w / G;
    const size_t src =
        ((static_cast<size_t>(b) * Q + r) * H + static_cast<size_t>(h) * G +
         (w - r * G)) * Dh + (e - row * Dh);
    qs[e] = to_float(q[src]) * scale;
    acc[e] = 0.f;
  }
  for (int row = tid; row < R; row += kThreads) {
    m_s[row] = -INFINITY;
    l_s[row] = 0.f;
  }

  for (int t0 = p_begin; t0 < p_end; t0 += kTile) {
    const int n = min(kTile, p_end - t0);
    if (t0 != p_begin) issue(t0);
    cp_async_wait_all();
    __syncthreads();   // the tile, q, and (first tile) m, l, acc are set

    // scores: one thread per (row, position); row e sees positions below
    // its own limit min(length_b - (Q-1-(row0+e)/G), cover), -inf past it
    for (int e = tid; e < R * kTile; e += kThreads) {
      const int row = e / kTile;
      const int t = e - row * kTile;
      const int limit = min(len_b - (Q - 1 - (row0 + row) / G), cover);
      ps[e] = t < n && t0 + t < limit ? dot(qs + row * Dh, ks + t * KS, Dh)
                                      : -INFINITY;
    }
    __syncthreads();

    // online softmax: one warp per row, two positions per lane. A row can
    // see nothing in a tile (its limit lies before the tile, or at or below
    // 0); then m stays as it was and the row's probabilities are 0
    for (int row = warp; row < R; row += kWarps) {
      float* pr = ps + row * kTile;
      const float s0 = pr[lane], s1 = pr[lane + 32];
      float m_tile = fmaxf(s0, s1);
      for (int o = 16; o > 0; o >>= 1)
        m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, o));
      const float m_old = m_s[row];
      const float m_new = fmaxf(m_old, m_tile);
      const float p0 = s0 > -INFINITY ? expf(s0 - m_new) : 0.f;
      const float p1 = s1 > -INFINITY ? expf(s1 - m_new) : 0.f;
      float sum = p0 + p1;
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      pr[lane] = p0;
      pr[lane + 32] = p1;
      if (lane == 0) {
        // 0 on the row's first live tile; 1 while it has seen nothing
        const float alpha = m_new > -INFINITY ? expf(m_old - m_new) : 1.f;
        alpha_s[row] = alpha;
        l_s[row] = alpha * l_s[row] + sum;
        m_s[row] = m_new;
      }
    }
    __syncthreads();

    // acc = alpha * acc + P V: one thread per (row, channel)
    for (int e = tid; e < R * Dh; e += kThreads) {
      const int row = e / Dh;
      const int d = e - row * Dh;
      const float* pr = ps + row * kTile;
      float a = acc[e] * alpha_s[row];
      for (int t = 0; t < n; ++t) a = fmaf(pr[t], to_float(vs[t * Dh + d]), a);
      acc[e] = a;
    }
    __syncthreads();   // the tile's buffers are free for the next tile
  }

  // merge the cluster's partial states: every rank's m, l and acc are
  // final once all ranks reach the barrier (it orders shared memory across
  // the cluster); this rank writes outputs rank, rank + C, ... of each
  // thread's stride. A rank that saw nothing holds m = -inf and adds
  // nothing; if no rank saw anything the output is 0
  cluster.sync();
  for (int e = rank * kThreads + tid; e < R * Dh; e += C * kThreads) {
    const int row = e / Dh;
    // every rank's (m, l, acc) read at once: one round trip across the
    // cluster
    float mc[kMaxCluster], lc[kMaxCluster], ac[kMaxCluster];
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) {
      mc[c] = -INFINITY;
      lc[c] = ac[c] = 0.f;
      if (c < C) {
        mc[c] = *cluster.map_shared_rank(m_s + row, c);
        lc[c] = *cluster.map_shared_rank(l_s + row, c);
        ac[c] = *cluster.map_shared_rank(acc + e, c);
      }
    }
    float m_max = -INFINITY;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) m_max = fmaxf(m_max, mc[c]);
    float l_sum = 0.f, a_sum = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c)
      if (mc[c] > -INFINITY) {
        const float w = expf(mc[c] - m_max);
        l_sum = fmaf(w, lc[c], l_sum);
        a_sum = fmaf(w, ac[c], a_sum);
      }
    const int w = row0 + row;
    const int r = w / G;
    const size_t dst =
        ((static_cast<size_t>(b) * Q + r) * H + static_cast<size_t>(h) * G +
         (w - r * G)) * Dh + (e - row * Dh);
    out[dst] = from_float<T>(l_sum > 0.f ? a_sum / l_sum : 0.f);
  }
  cluster.sync();   // no rank leaves while another still reads its state
}

// Decode: one query token per slot, q and out [B, H, Dh] (Q = 1).
template <typename T, bool kTiled>
__global__ void __launch_bounds__(kThreads) paged_attention_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ tables,
    const int* __restrict__ lengths, T* __restrict__ out, int /*Q*/, int H,
    int Hkv, int Dh, int L, int block_size, int n_pages, int layer,
    float scale) {
  paged_attention_body<T, kTiled>(q, k_pages, v_pages, tables, lengths, out,
                                  1, H, Hkv, Dh, L, block_size, n_pages,
                                  layer, scale);
}

// Verify window: Q query tokens per slot, q and out [B, Q, H, Dh].
template <typename T, bool kTiled>
__global__ void __launch_bounds__(kThreads) paged_attention_multi_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ tables,
    const int* __restrict__ lengths, T* __restrict__ out, int Q, int H,
    int Hkv, int Dh, int L, int block_size, int n_pages, int layer,
    float scale) {
  paged_attention_body<T, kTiled>(q, k_pages, v_pages, tables, lengths, out,
                                  Q, H, Hkv, Dh, L, block_size, n_pages,
                                  layer, scale);
}

template <typename T>
using Kernel = void (*)(const T*, const T*, const T*, const int*, const int*,
                        T*, int, int, int, int, int, int, int, int, float);

template <typename T>
int launch(Kernel<T> kernel, const void* q, const void* k_pages,
           const void* v_pages, const void* tables, const void* lengths,
           void* out, int B, int Q, int H, int Hkv, int Dh, int L,
           int block_size, int n_pages, int layer, float scale,
           cudaStream_t stream) {
  const int rows = Q * (H / Hkv);
  const int tiles = (rows + kMaxRows - 1) / kMaxRows;
  const size_t smem = smem_bytes<T>(rows < kMaxRows ? rows : kMaxRows, Dh,
                                    n_pages);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // the cluster size from the table's width only: no host read of lengths
  const long long cover = static_cast<long long>(n_pages) * block_size;
  const long long want = (cover + kRankPositions - 1) / kRankPositions;
  const int C = want < 1 ? 1 : want > kMaxCluster ? kMaxCluster
                                                  : static_cast<int>(want);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, Hkv * tiles, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q),
      static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      static_cast<const int*>(tables), static_cast<const int*>(lengths),
      static_cast<T*>(out), Q, H, Hkv, Dh, L, block_size, n_pages, layer,
      scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The kernel for a window (else decode, Q = 1) whose rows do (kTiled) or do
// not span more than one tile
template <typename T, bool kTiled>
Kernel<T> pick(bool window) {
  return window ? paged_attention_multi_kernel<T, kTiled>
                : paged_attention_decode_kernel<T, kTiled>;
}

template <typename T>
int launch_rows(bool window, const void* q, const void* k_pages,
                const void* v_pages, const void* tables, const void* lengths,
                void* out, int B, int Q, int H, int Hkv, int Dh, int L,
                int block_size, int n_pages, int layer, float scale,
                cudaStream_t s) {
  const bool tiled = Q * (H / Hkv) > kMaxRows;
  return launch<T>(tiled ? pick<T, true>(window) : pick<T, false>(window),
                   q, k_pages, v_pages, tables, lengths, out, B, Q, H, Hkv,
                   Dh, L, block_size, n_pages, layer, scale, s);
}

// window: the verify-window kernel, else the decode kernel (Q = 1). dtype:
// 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the launch
// (0 = cudaSuccess); the Python wrappers raise on anything else.
int launch_dtype(bool window, const void* q, const void* k_pages,
                 const void* v_pages, const void* tables, const void* lengths,
                 void* out, int B, int Q, int H, int Hkv, int Dh, int L,
                 int block_size, int n_pages, int layer, float scale,
                 int dtype, void* stream) {
  if (B < 1 || B > 65535 || Q < 1 || Hkv < 1 || H % Hkv ||
      static_cast<long long>(Hkv) *
              ((static_cast<long long>(Q) * (H / Hkv) + kMaxRows - 1) /
               kMaxRows) > 65535 ||
      Dh > kMaxHeadDim || Dh % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_rows<float>(window, q, k_pages, v_pages, tables, lengths,
                              out, B, Q, H, Hkv, Dh, L, block_size, n_pages,
                              layer, scale, s);
  if (dtype == 1)
    return launch_rows<__nv_bfloat16>(window, q, k_pages, v_pages, tables,
                                      lengths, out, B, Q, H, Hkv, Dh, L,
                                      block_size, n_pages, layer, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Decode: q and out [B, H, Dh]. dtype: 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError() after the launch (0 = cudaSuccess).
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages, const void* tables,
                                      const void* lengths, void* out, int B,
                                      int H, int Hkv, int Dh, int L,
                                      int block_size, int n_pages, int layer,
                                      float scale, int dtype, void* stream) {
  return launch_dtype(false, q, k_pages, v_pages, tables, lengths, out, B, 1,
                      H, Hkv, Dh, L, block_size, n_pages, layer, scale, dtype,
                      stream);
}

// Verify window: q and out [B, Q, H, Dh]; as above.
extern "C" int paged_attention_multi_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* lengths, void* out, int B, int Q, int H,
    int Hkv, int Dh, int L, int block_size, int n_pages, int layer,
    float scale, int dtype, void* stream) {
  return launch_dtype(true, q, k_pages, v_pages, tables, lengths, out, B, Q,
                      H, Hkv, Dh, L, block_size, n_pages, layer, scale, dtype,
                      stream);
}
