// The RG-LRU linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} +
// x_t from h_0 = 0, independently per channel, every h_t written out. The
// prefill recurrence of every recurrent layer (one launch per layer per
// prefill).
//
// Replaces the TPU kernel `rglru_scan` in src/repro/kernels/rglru_scan.py
// (wrapper :49, body `_rglru_kernel` :26), and computes what it computes:
// the carry in f32, each output cast to a's dtype, for any S (the Pallas
// kernel asserts that its chunk divides S). Each step multiplies, rounds,
// then adds and rounds, in f32 (no fused multiply-add), as the plain
// version computes a*h + x: for f32 inputs the two agree bit for bit, and
// for bf16 inputs the kernel equals the plain version run on the inputs
// widened to f32 and rounded once at the end.
//
// Layouts: a, x and h [B, S, R], contiguous, one dtype.
//
// Bound. Two loads and one store per element and two flops: bytes bound it,
// 3 * B * S * R * sizeof(dtype) at 3.35 TB/s (0.011 ms at B 1, S 2 300,
// R 2 560 in bf16).
//
// Design. One thread per (batch, channel) walks the sequence in order, so
// neighbouring threads read neighbouring channels and every step's loads
// coalesce. The loads of kUnroll steps are issued before the first of them
// is used, so a thread keeps 2 * kUnroll loads in flight instead of waiting
// on device memory once per step. A prompt gives only B * R threads (2 560
// at recurrentgemma-2b's width): too few to fill the card, so the kernel
// sits far above its bound; a chunked parallel scan over S is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 16;  // steps whose loads are in flight together

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

template <typename T>
__global__ void __launch_bounds__(kThreads) rglru_scan_kernel(
    const T* __restrict__ a, const T* __restrict__ x, T* __restrict__ h_out,
    int B, int S, int R) {
  const long long lane =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= static_cast<long long>(B) * R) return;
  const int b = static_cast<int>(lane / R);
  const int r = static_cast<int>(lane - static_cast<long long>(b) * R);
  const size_t base = static_cast<size_t>(b) * S * R + r;
  float h = 0.f;
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t off = base + static_cast<size_t>(t + u) * R;
      av[u] = to_float(a[off]);
      xv[u] = to_float(x[off]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), xv[u]);
      h_out[base + static_cast<size_t>(t + u) * R] = from_float<T>(h);
    }
  }
  for (; t < S; ++t) {
    const size_t off = base + static_cast<size_t>(t) * R;
    h = __fadd_rn(__fmul_rn(to_float(a[off]), h), to_float(x[off]));
    h_out[off] = from_float<T>(h);
  }
}

template <typename T>
int launch(const void* a, const void* x, void* h, int B, int S, int R,
           cudaStream_t stream) {
  const long long lanes = static_cast<long long>(B) * R;
  const unsigned blocks =
      static_cast<unsigned>((lanes + kThreads - 1) / kThreads);
  rglru_scan_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x), static_cast<T*>(h),
      B, S, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a, x, h: device pointers to [B, S, R] contiguous tensors. dtype: 0 =
// float32, 1 = bfloat16. Returns cudaGetLastError() after the launch (0 =
// cudaSuccess); the Python wrapper raises on anything else.
extern "C" int rglru_scan_launch(const void* a, const void* x, void* h,
                                 int B, int S, int R, int dtype,
                                 void* stream) {
  if (B < 1 || S < 1 || R < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, x, h, B, S, R, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, x, h, B, S, R, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
