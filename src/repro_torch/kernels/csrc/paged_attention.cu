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
//   head_dim a multiple of 8 and at most 128; R = Q * G <= 64 rows;
//   pools 16-byte aligned
//
// Bound. Each staged K/V element feeds ~4 flops per row, ~4 R in all (12
// flop/byte-pair at R = 12 in bf16), far below the ~295 flop/byte at which
// the H100's bf16 tensor cores become the limit, so the bound is bytes: the
// live K and V pages, sum_b min(length_b, n_pages * block_size) * Hkv * Dh
// * 2 * sizeof(dtype) per call, at 3.35 TB/s.
//
// Design. One thread block per (slot, KV head) owns all R = Q * G rows of
// that head. It walks the slot's pages once, up to the last row's limit,
// reading tables[b, page] itself (the TPU kernel's clamped index map, which
// skips repeated DMAs, has no counterpart here: pages past the limit are
// never touched, and every limit is clamped to the table's coverage
// n_pages * block_size, as the plain version's gather is). Positions are
// staged 32 at a time: each thread issues all its 16-byte loads of the
// tile's K and V rows before storing them to shared memory as f32 (one
// round trip to device memory per tile), one thread per (row, position)
// forms a score, one warp per row does the online-softmax update with
// shuffles (one lane per position), and one thread per (row, channel)
// rescales and accumulates P.V. Every staged K/V row serves all R rows, so
// K/V are read from device memory once per KV head per call, not once per
// query head or window row. Plain FMA on the CUDA cores: the products are
// R x Dh by Dh x 32, too thin for wgmma; TMA staging and a split over the
// sequence for long contexts are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kTile = 32;      // positions per staged tile = one warp's lanes
constexpr int kThreads = 128;  // four warps
constexpr int kMaxHeadDim = 128;
constexpr int kMaxRows = 64;   // Q * G
// 16-byte loads one thread issues per staged tile and tensor, at most
// (f32, head_dim 128: 32 rows x 32 loads / 128 threads)
constexpr int kMaxLoads = kTile * kMaxHeadDim / 4 / kThreads;

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

// Shared memory, in floats, for one block of R rows.
__host__ __device__ inline size_t smem_floats(int R, int Dh) {
  return static_cast<size_t>(kTile) * (Dh + 1)   // K tile, padded rows
         + static_cast<size_t>(kTile) * Dh       // V tile
         + 2 * static_cast<size_t>(R) * Dh       // scaled q, accumulator
         + static_cast<size_t>(R) * kTile        // scores / probabilities
         + 3 * static_cast<size_t>(R);           // m, l, alpha
}

template <typename T>
__device__ __forceinline__ void paged_attention_body(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ tables,
    const int* __restrict__ lengths, T* __restrict__ out, int Q, int H,
    int Hkv, int Dh, int L, int block_size, int n_pages, int layer,
    float scale) {
  const int h = blockIdx.x;  // KV head
  const int b = blockIdx.y;  // slot
  const int G = H / Hkv;
  const int R = Q * G;       // row e: window position e / G, head e % G
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  extern __shared__ float smem[];
  const int k_stride = Dh + 1;  // odd row stride: no bank conflicts on k
  float* ks = smem;                         // [kTile][Dh + 1]
  float* vs = ks + kTile * k_stride;        // [kTile][Dh]
  float* qs = vs + kTile * Dh;              // [R][Dh]
  float* acc = qs + R * Dh;                 // [R][Dh]
  float* ps = acc + R * Dh;                 // [R][kTile]
  float* m_s = ps + R * kTile;              // [R]
  float* l_s = m_s + R;                     // [R]
  float* alpha_s = l_s + R;                 // [R]

  // positions past the table's coverage do not exist (as in the plain
  // version's gather of n_pages * block_size positions); the last row
  // reaches furthest, so `length` bounds the walk for every row
  const int cover = n_pages * block_size;
  const int len_b = lengths[b];
  const int length = max(0, min(len_b, cover));

  // q row e lives at q[b, e / G, h * G + e % G, :]
  for (int e = tid; e < R * Dh; e += blockDim.x) {
    const int row = e / Dh;
    const int r = row / G;
    const size_t src =
        ((static_cast<size_t>(b) * Q + r) * H + static_cast<size_t>(h) * G +
         (row - r * G)) * Dh + (e - row * Dh);
    qs[e] = to_float(q[src]) * scale;
    acc[e] = 0.f;
  }
  for (int row = tid; row < R; row += blockDim.x) {
    m_s[row] = -INFINITY;
    l_s[row] = 0.f;
  }
  __syncthreads();

  const size_t row_stride = static_cast<size_t>(L) * Hkv * Dh;  // next pos
  const size_t blk_stride = static_cast<size_t>(block_size) * row_stride;
  const size_t head_off = (static_cast<size_t>(layer) * Hkv + h) * Dh;
  const int* table = tables + static_cast<size_t>(b) * n_pages;
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  const int row_vecs = Dh / kVec;       // the wrapper checks Dh % 8 == 0

  for (int t0 = 0; t0 < length; t0 += kTile) {
    const int n_valid = min(kTile, length - t0);

    // stage the K and V rows of positions t0 .. t0 + n_valid - 1: every
    // 16-byte load of the tile is issued before any shared-memory store,
    // so the tile costs one round trip to device memory, not one per load
    uint4 kr[kMaxLoads], vr[kMaxLoads];
#pragma unroll
    for (int i = 0; i < kMaxLoads; ++i) {
      const int e = tid + i * kThreads;
      const int t = e / row_vecs;
      kr[i] = vr[i] = make_uint4(0u, 0u, 0u, 0u);
      if (e < kTile * row_vecs && t < n_valid) {
        const int pos = t0 + t;
        const size_t blk = static_cast<size_t>(table[pos / block_size]);
        const size_t off =
            blk * blk_stride +
            static_cast<size_t>(pos % block_size) * row_stride + head_off +
            static_cast<size_t>(e - t * row_vecs) * kVec;
        kr[i] = *reinterpret_cast<const uint4*>(k_pages + off);
        vr[i] = *reinterpret_cast<const uint4*>(v_pages + off);
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxLoads; ++i) {
      const int e = tid + i * kThreads;
      if (e < kTile * row_vecs) {
        const int t = e / row_vecs;
        const int d0 = (e - t * row_vecs) * kVec;
        const T* kx = reinterpret_cast<const T*>(&kr[i]);
        const T* vx = reinterpret_cast<const T*>(&vr[i]);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          ks[t * k_stride + d0 + j] = to_float(kx[j]);
          vs[t * Dh + d0 + j] = to_float(vx[j]);
        }
      }
    }
    __syncthreads();

    // scores: one thread per (row, position); row e sees positions below
    // its own limit min(length_b - (Q-1-e/G), cover), -inf past it
    for (int e = tid; e < R * kTile; e += blockDim.x) {
      const int row = e / kTile;
      const int t = e - row * kTile;
      const int limit = min(len_b - (Q - 1 - row / G), cover);
      float s = -INFINITY;
      if (t0 + t < limit) {
        const float* qr = qs + row * Dh;
        const float* kt = ks + t * k_stride;
        s = 0.f;
        for (int d = 0; d < Dh; ++d) s = fmaf(qr[d], kt[d], s);
      }
      ps[e] = s;
    }
    __syncthreads();

    // online softmax: one warp per row, one lane per position. A row can
    // see nothing in a tile (its limit lies before the tile, or at or below
    // 0); then m stays as it was and the row's probabilities are 0
    for (int row = warp; row < R; row += n_warps) {
      const float s = ps[row * kTile + lane];
      float m_tile = s;
      for (int o = 16; o > 0; o >>= 1)
        m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, o));
      const float m_old = m_s[row];
      const float m_new = fmaxf(m_old, m_tile);
      const float p = s > -INFINITY ? expf(s - m_new) : 0.f;
      float sum = p;
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ps[row * kTile + lane] = p;
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
    for (int e = tid; e < R * Dh; e += blockDim.x) {
      const int row = e / Dh;
      const int d = e - row * Dh;
      const float* pr = ps + row * kTile;
      float a = acc[e] * alpha_s[row];
      for (int t = 0; t < n_valid; ++t) a = fmaf(pr[t], vs[t * Dh + d], a);
      acc[e] = a;
    }
    __syncthreads();
  }

  for (int e = tid; e < R * Dh; e += blockDim.x) {
    const int row = e / Dh;
    const int r = row / G;
    const size_t dst =
        ((static_cast<size_t>(b) * Q + r) * H + static_cast<size_t>(h) * G +
         (row - r * G)) * Dh + (e - row * Dh);
    const float l = l_s[row];
    out[dst] = from_float<T>(l > 0.f ? acc[e] / l : 0.f);  // nothing: zeros
  }
}

// Decode: one query token per slot, q and out [B, H, Dh] (Q = 1).
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_attention_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ tables,
    const int* __restrict__ lengths, T* __restrict__ out, int /*Q*/, int H,
    int Hkv, int Dh, int L, int block_size, int n_pages, int layer,
    float scale) {
  paged_attention_body<T>(q, k_pages, v_pages, tables, lengths, out, 1, H,
                          Hkv, Dh, L, block_size, n_pages, layer, scale);
}

// Verify window: Q query tokens per slot, q and out [B, Q, H, Dh].
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_attention_multi_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ tables,
    const int* __restrict__ lengths, T* __restrict__ out, int Q, int H,
    int Hkv, int Dh, int L, int block_size, int n_pages, int layer,
    float scale) {
  paged_attention_body<T>(q, k_pages, v_pages, tables, lengths, out, Q, H,
                          Hkv, Dh, L, block_size, n_pages, layer, scale);
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
  const size_t smem = smem_floats(Q * (H / Hkv), Dh) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(Hkv, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), Q, H, Hkv, Dh,
      L, block_size, n_pages, layer, scale);
  return static_cast<int>(cudaGetLastError());
}

// window: the verify-window kernel, else the decode kernel (Q = 1). dtype:
// 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the launch
// (0 = cudaSuccess); the Python wrappers raise on anything else.
int launch_dtype(bool window, const void* q, const void* k_pages,
                 const void* v_pages, const void* tables, const void* lengths,
                 void* out, int B, int Q, int H, int Hkv, int Dh, int L,
                 int block_size, int n_pages, int layer, float scale,
                 int dtype, void* stream) {
  if (B < 1 || Q < 1 || Hkv < 1 || H % Hkv || Q * (H / Hkv) > kMaxRows ||
      Dh > kMaxHeadDim || Dh % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(window ? paged_attention_multi_kernel<float>
                                : paged_attention_decode_kernel<float>,
                         q, k_pages, v_pages, tables, lengths, out, B, Q, H,
                         Hkv, Dh, L, block_size, n_pages, layer, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(
        window ? paged_attention_multi_kernel<__nv_bfloat16>
               : paged_attention_decode_kernel<__nv_bfloat16>,
        q, k_pages, v_pages, tables, lengths, out, B, Q, H, Hkv, Dh, L,
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
