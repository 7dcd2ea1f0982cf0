// Paged decode attention for Hopper (sm_90a): one new query token per slot
// attends over that slot's KV pages through its block table.
//
// Replaces the TPU kernel `paged_attention` in
// src/repro/kernels/paged_attention.py (wrapper :213, body `_paged_kernel`
// :46). It computes what that kernel computes, not how: scale Dh^-0.5, an
// online softmax with f32 running max m, denominator l and accumulator acc,
// GQA (KV head h serves query heads h*G .. h*G+G-1, G = H / Hkv), the tail
// page masked to pos < length, zeros (not NaN) for a dead slot
// (length 0), `layer` indexing axis 2 of the pool, output in q's dtype.
//
// Layouts (the JAX package's, unchanged):
//   q       [B, H, Dh]
//   pools   [num_blocks + 1, block_size, L, Hkv, Dh]  (last block is trash)
//   tables  [B, n_pages] int32, lengths [B] int32, out [B, H, Dh]
//   head_dim a multiple of 8 and at most 128; pools 16-byte aligned
//
// Bound. Decode attention does ~4 flops per K/V byte it reads, far below
// the ~295 flops/byte at which the H100's bf16 tensor cores become the
// limit, so the bound is bytes: the live K and V pages,
// sum_b length_b * Hkv * Dh * 2 * sizeof(dtype) per call, at 3.35 TB/s.
// The serving path launches it once per layer per decoded token.
//
// Design. One thread block per (slot, KV head). The block walks only the
// ceil(length / block_size) live pages, reading tables[b, page] itself (the
// TPU kernel's clamped index map, which skips repeated DMAs, has no
// counterpart here: pages past the length are never touched). Positions
// are staged 32 at a time: each thread issues all its 16-byte loads of the
// tile's K and V rows before storing them to shared memory as f32 (one
// round trip to device memory per tile), one thread per (head, position)
// forms a score, one warp per grouped head does the online-softmax update
// with shuffles (one lane per position), and one thread per (head,
// channel) rescales and accumulates P·V. The G grouped heads share each staged K/V row, so K/V are read from
// device memory once per KV head, not once per query head. Plain FMA on
// the CUDA cores: the products are 1 x Dh by Dh x 32, too thin for wgmma;
// TMA staging and a split over the sequence for long contexts are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kTile = 32;      // positions per staged tile = one warp's lanes
constexpr int kThreads = 128;  // four warps
constexpr int kMaxHeadDim = 128;
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

// Shared memory, in floats, for one block.
__host__ __device__ inline size_t smem_floats(int G, int Dh) {
  return static_cast<size_t>(kTile) * (Dh + 1)   // K tile, padded rows
         + static_cast<size_t>(kTile) * Dh       // V tile
         + 2 * static_cast<size_t>(G) * Dh       // scaled q, accumulator
         + static_cast<size_t>(G) * kTile        // scores / probabilities
         + 3 * static_cast<size_t>(G);           // m, l, alpha
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int* __restrict__ tables,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       int H, int Hkv, int Dh, int L, int block_size,
                       int n_pages, int layer, float scale) {
  const int h = blockIdx.x;  // KV head
  const int b = blockIdx.y;  // slot
  const int G = H / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  extern __shared__ float smem[];
  const int k_stride = Dh + 1;  // odd row stride: no bank conflicts on k
  float* ks = smem;                         // [kTile][Dh + 1]
  float* vs = ks + kTile * k_stride;        // [kTile][Dh]
  float* qs = vs + kTile * Dh;              // [G][Dh]
  float* acc = qs + G * Dh;                 // [G][Dh]
  float* ps = acc + G * Dh;                 // [G][kTile]
  float* m_s = ps + G * kTile;              // [G]
  float* l_s = m_s + G;                     // [G]
  float* alpha_s = l_s + G;                 // [G]

  // positions past the table's coverage do not exist (as in the oracle's
  // gather of n_pages * block_size positions)
  const int length = max(0, min(lengths[b], n_pages * block_size));

  const T* qb = q + (static_cast<size_t>(b) * H + static_cast<size_t>(h) * G) * Dh;
  for (int e = tid; e < G * Dh; e += blockDim.x) {
    qs[e] = to_float(qb[e]) * scale;
    acc[e] = 0.f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
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

    // scores: one thread per (grouped head, position)
    for (int e = tid; e < G * kTile; e += blockDim.x) {
      const int g = e / kTile;
      const int t = e - g * kTile;
      float s = -INFINITY;
      if (t < n_valid) {
        const float* qg = qs + g * Dh;
        const float* kt = ks + t * k_stride;
        s = 0.f;
        for (int d = 0; d < Dh; ++d) s = fmaf(qg[d], kt[d], s);
      }
      ps[e] = s;
    }
    __syncthreads();

    // online softmax: one warp per grouped head, one lane per position
    for (int g = warp; g < G; g += n_warps) {
      const float s = ps[g * kTile + lane];
      float m_tile = s;
      for (int o = 16; o > 0; o >>= 1)
        m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, m_tile);  // finite: lane 0 is valid
      const float p = lane < n_valid ? expf(s - m_new) : 0.f;
      float sum = p;
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ps[g * kTile + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first tile
        alpha_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = alpha * acc + P V: one thread per (grouped head, channel)
    for (int e = tid; e < G * Dh; e += blockDim.x) {
      const int g = e / Dh;
      const int d = e - g * Dh;
      const float* pg = ps + g * kTile;
      float a = acc[e] * alpha_s[g];
      for (int t = 0; t < n_valid; ++t) a = fmaf(pg[t], vs[t * Dh + d], a);
      acc[e] = a;
    }
    __syncthreads();
  }

  T* ob = out + (static_cast<size_t>(b) * H + static_cast<size_t>(h) * G) * Dh;
  for (int e = tid; e < G * Dh; e += blockDim.x) {
    const float l = l_s[e / Dh];
    ob[e] = from_float<T>(l > 0.f ? acc[e] / l : 0.f);  // dead slot: zeros
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* tables, const void* lengths, void* out, int B, int H,
           int Hkv, int Dh, int L, int block_size, int n_pages, int layer,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(H / Hkv, Dh) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(Hkv, B);
  paged_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), H, Hkv, Dh, L,
      block_size, n_pages, layer, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = cudaSuccess); the Python wrapper raises on anything else.
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages, const void* tables,
                                      const void* lengths, void* out, int B,
                                      int H, int Hkv, int Dh, int L,
                                      int block_size, int n_pages, int layer,
                                      float scale, int dtype, void* stream) {
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, tables, lengths, out, B, H, Hkv,
                         Dh, L, block_size, n_pages, layer, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, tables, lengths, out, B,
                                 H, Hkv, Dh, L, block_size, n_pages, layer,
                                 scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
