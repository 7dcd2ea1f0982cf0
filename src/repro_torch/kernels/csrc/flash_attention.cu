// Blocked softmax attention for Hopper (sm_90a), forward only: causal,
// sliding-window or full, with grouped KV heads. The prefill attention of
// every attention layer (one launch per layer per prefill).
//
// Replaces the TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention.py (wrapper :98, body `_flash_kernel`
// :32). It computes what that kernel and its oracle `attention_ref`
// (src/repro/kernels/ref.py:8) compute: scale Dh^-0.5, query i and key j at
// positions i and j, `causal` masking j > i, `window` masking j <= i -
// window, query head h reading KV head h * Hkv / H, an online softmax with
// f32 running max m, denominator l and accumulator acc, zeros (not NaN) for
// a row with nothing to attend, output in q's dtype. Unlike the Pallas
// kernel, which asserts that the block sizes divide S, any Sq and Skv are
// taken: the tail tiles are masked.
//
// Layouts: q [B, H, Sq, Dh], k/v [B, Hkv, Skv, Dh], out like q, each given
// by its batch, head and sequence strides in elements with the channel axis
// contiguous (the model passes [B, S, H, Dh] tensors transposed, so no copy
// is made); head_dim 32, 64, 128 or 256; every stride a multiple of 16
// bytes and every base 16-byte aligned.
//
// Bound. Per unmasked (query, key) pair and query head the work is 4 Dh
// flops (QK and PV) against 2 Dh K/V elements that, once staged, serve 64
// query rows: at the prefill shapes the bound is the bf16 tensor-core peak
// (about 27 GFLOP at a 2 300-token prompt with a 2 048 window, 10 query
// heads, Dh 256: 0.027 ms), far above the bytes (q, k, v and out once).
//
// Design. One block of 256 threads per (batch, query head, 64-row query
// tile), the heaviest (latest) tiles launched first. The block stages its
// scaled q rows in shared memory as f32, then walks the key tiles that hold
// any unmasked position for its rows (tiles wholly in the future or wholly
// older than the window are never read, as `_flash_kernel` skips them),
// staging each K and V tile with 16-byte loads issued before any store. The
// threads form a 16 x 16 grid: thread (ty, tx) owns query rows 4 ty .. 4 ty
// + 3, their scores against keys tx, tx + 16, ... of the tile, and their
// output channels tx, tx + 16, ...; a row's 16 threads are one half-warp, so
// the online-softmax max and sum are shuffles, and m, l and the rescale
// never leave registers. Plain f32 FMA on the CUDA cores: this kernel is
// right before it is fast. mma/wgmma tiles, TMA staging and one block per
// KV head serving its whole query-head group are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kBlockQ = 64;    // query rows per block: 16 groups of 4
constexpr int kRows = 4;       // query rows per thread

// key positions per staged tile: keeps the f32 shared memory of Dh 128 and
// 256 at ~75 and ~140 KB
template <int DH>
struct BlockK {
  static constexpr int value = DH >= 128 ? 32 : 64;
};

template <int DH>
constexpr size_t smem_bytes() {
  constexpr size_t bk = BlockK<DH>::value;
  return sizeof(float) * (kBlockQ * (DH + 4)      // q, padded
                          + bk * (DH + 1)         // K, odd stride
                          + bk * DH               // V
                          + kBlockQ * (bk + 1));  // P
}

struct Strides {
  // batch, head and sequence strides in elements, for q, k, v and out
  long long q[3], k[3], v[3], o[3];
};

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

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int H, int Hkv, int Sq,
    int Skv, Strides st, int causal, int window, float scale) {
  constexpr int BK = BlockK<DH>::value;
  constexpr int QS = DH + 4;    // two half-warps' rows land in other banks
  constexpr int KS = DH + 1;    // 16 key rows at one channel: 16 banks
  constexpr int PS = BK + 1;
  constexpr int kVec = 16 / sizeof(T);       // elements per 16-byte load
  constexpr int kRowVecs = DH / kVec;
  constexpr int kLoads = BK * kRowVecs / kThreads;  // per tile and tensor
  constexpr int kCols = DH / 16;             // output channels per thread
  constexpr int kKeys = BK / 16;             // keys per row per thread
  static_assert(BK * kRowVecs % kThreads == 0, "tile loads must divide");

  const int qt = gridDim.x - 1 - blockIdx.x;  // latest (heaviest) first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h * Hkv / H;
  const int q0 = qt * kBlockQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  extern __shared__ float smem[];
  float* qs = smem;                   // [kBlockQ][QS], scaled
  float* ks = qs + kBlockQ * QS;      // [BK][KS]
  float* vs = ks + BK * KS;           // [BK][DH]
  float* ps = vs + BK * DH;           // [kBlockQ][PS]

  const T* qb = q + b * st.q[0] + h * st.q[1];
  const T* kb = k + b * st.k[0] + hk * st.k[1];
  const T* vb = v + b * st.v[0] + hk * st.v[1];

  // q rows past Sq are staged as zeros; their outputs are never written
  for (int e = tid; e < kBlockQ * kRowVecs; e += kThreads) {
    const int r = e / kRowVecs;
    const int c = (e - r * kRowVecs) * kVec;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < Sq)
      raw = *reinterpret_cast<const uint4*>(qb + (q0 + r) * st.q[2] + c);
    const T* xs = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec; ++j) qs[r * QS + c + j] = to_float(xs[j]) * scale;
  }

  // keys any row of this tile may see: rows q0 .. q0 + kBlockQ - 1 reach
  // back to q0 - window + 1 and (causal) forward to q0 + kBlockQ - 1
  int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Skv, q0 + kBlockQ) : Skv;
  k_lo = k_lo / BK * BK;

  float acc[kRows][kCols];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // q staged; the previous tile's K, V and P consumed
    // stage the K and V rows k0 .. k0 + BK - 1 (zeros past Skv): every
    // 16-byte load of the tile is issued before any shared-memory store
    uint4 kr[kLoads], vr[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = tid + i * kThreads;
      const int t = e / kRowVecs;
      const int c = (e - t * kRowVecs) * kVec;
      kr[i] = vr[i] = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + t < Skv) {
        kr[i] = *reinterpret_cast<const uint4*>(kb + (k0 + t) * st.k[2] + c);
        vr[i] = *reinterpret_cast<const uint4*>(vb + (k0 + t) * st.v[2] + c);
      }
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = tid + i * kThreads;
      const int t = e / kRowVecs;
      const int c = (e - t * kRowVecs) * kVec;
      const T* kx = reinterpret_cast<const T*>(&kr[i]);
      const T* vx = reinterpret_cast<const T*>(&vr[i]);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        ks[t * KS + c + j] = to_float(kx[j]);
        vs[t * DH + c + j] = to_float(vx[j]);
      }
    }
    __syncthreads();

    // scores of rows 4 ty + i against keys k0 + tx + 16 j
    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty * kRows + i) * QS + d];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kv[j] = ks[(tx + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax; a row's 16 threads are one half-warp. A row may see
    // nothing in a tile: then m stays, its probabilities are 0 and, while
    // m is -inf, alpha is 1
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + ty * kRows + i;
      float m_tile = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool ok = kj < Skv && (!causal || kj <= qi) &&
                        (window <= 0 || kj > qi - window);
        s[i][j] = ok ? s[i][j] : -INFINITY;
        m_tile = fmaxf(m_tile, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, o));
      const float m_new = fmaxf(m[i], m_tile);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = s[i][j] > -INFINITY ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty * kRows + i) * PS + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float alpha = m_new > -INFINITY ? expf(m[i] - m_new) : 1.f;
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();  // a row's P is written and read by its own half-warp

    // acc += P V over the tile's keys (V is zero past Skv, P is 0 there)
#pragma unroll 4
    for (int t = 0; t < BK; ++t) {
      float pv[kRows], vv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty * kRows + i) * PS + t];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = vs[t * DH + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  T* ob = out + b * st.o[0] + h * st.o[1];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty * kRows + i;
    if (qi >= Sq) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      ob[qi * st.o[2] + tx + 16 * c] =
          from_float<T>(l[i] > 0.f ? acc[i][c] / l[i] : 0.f);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int Hkv, int Sq, int Skv, const Strides& st, int causal,
           int window, float scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, DH>;
  constexpr size_t smem = smem_bytes<DH>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, Hkv, Sq, Skv, st,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_head_dim(int Dh, const void* q, const void* k, const void* v,
                    void* out, int B, int H, int Hkv, int Sq, int Skv,
                    const Strides& st, int causal, int window, float scale,
                    cudaStream_t s) {
  switch (Dh) {
    case 32:
      return launch<T, 32>(q, k, v, out, B, H, Hkv, Sq, Skv, st, causal,
                           window, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, out, B, H, Hkv, Sq, Skv, st, causal,
                           window, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, out, B, H, Hkv, Sq, Skv, st, causal,
                            window, scale, s);
    case 256:
      return launch<T, 256>(q, k, v, out, B, H, Hkv, Sq, Skv, st, causal,
                            window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v, out: device pointers; strides: 12 host int64 values, the batch,
// head and sequence strides (in elements) of q, k, v and out. causal: 0 or
// 1; window: 0 for none, else the sliding window. dtype: 0 = float32, 1 =
// bfloat16. Returns cudaGetLastError() after the launch (0 = cudaSuccess);
// the Python wrapper raises on anything else.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int H,
                                      int Hkv, int Sq, int Skv, int Dh,
                                      const long long* strides, int causal,
                                      int window, float scale, int dtype,
                                      void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || Sq < 1 || Skv < 1 ||
      window < 0 || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_head_dim<float>(Dh, q, k, v, out, B, H, Hkv, Sq, Skv, st,
                                  causal, window, scale, s);
  if (dtype == 1)
    return launch_head_dim<__nv_bfloat16>(Dh, q, k, v, out, B, H, Hkv, Sq,
                                          Skv, st, causal, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
