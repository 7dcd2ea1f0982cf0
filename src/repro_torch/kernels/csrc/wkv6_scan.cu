// The RWKV-6 WKV scan for Hopper (sm_90a): per (batch, head) a [Dh, Dh]
// state matrix S, carried in f32 over the sequence,
//
//   y_t     = r_t · (S_t + (u ⊙ k_t) v_tᵀ)
//   S_{t+1} = diag(w_t) S_t + k_t v_tᵀ
//
// from S_0 (zero, or a given state) to S_T, which is written out. Every WKV
// recurrence of the rwkv6 model, prefill (S = prompt length) and decode
// (S = 1, from the slot's state): one launch per layer per call.
//
// Replaces the TPU kernel `wkv6_scan` in src/repro/kernels/wkv6_scan.py
// (wrapper :55, body `_wkv_kernel` :25), and computes what it computes, the
// state in f32 and y in r's dtype, with what the model's decode also needs
// (src/repro/models/rwkv6.py:75, :103): an initial state S_0 and the final
// state S_T. It takes any S (the Pallas kernel asserts that its chunk
// divides S) and Dh 64 or 128. The state's update and the bonus term round
// as the plain version's separate operations do (k v, u (k v), each sum,
// w S, no fused multiply-add), so S_T equals the plain version's bit for
// bit; y is each column's Dh-term dot product, summed in another order than
// the plain version's einsum.
//
// Layouts: r, k, v (f32 or bf16) and w (f32) are [B, S, H, Dh] read through
// their batch, sequence and head strides, channels contiguous, so the
// model's tensors need no transposed copy; u [H, Dh] f32; S_0 and S_T
// [B, H, Dh, Dh] f32 contiguous (row i is S's input channel, column j its
// output channel); y [B, S, H, Dh] contiguous in r's dtype.
//
// Bound. Per step and (batch, head) the function reads 4 Dh inputs and
// writes Dh outputs, and needs 5 Dh^2 + 5 Dh f32 operations: the state's
// update (k v, w S, the sum) and r S, 5 Dh^2; the bonus term is the scalar
// sum_i r_i u_i k_i times v, 5 Dh. (This kernel does 7 Dh^2: it forms
// u (k v) and S + u (k v) to round as the plain version does.) Operations
// bound it on paper: 5 Dh^2 per step against 12 Dh bytes in bf16; at B 1,
// S 2 300, H 32, Dh 64 that is 1.53 GFLOP, 0.02285 ms at 67 TFLOP/s, beside
// 0.0170 ms of bytes.
//
// Design. The columns of S are independent: column j needs only v_t[j] and
// the step's r_t, k_t, w_t and u. One block per (batch, head), one thread
// per column, which keeps its Dh-row column of S in registers for the
// whole sequence. Steps are staged kChunk at a time through shared memory
// (r, k, w and u packed as one float4 per row, so a row is one broadcast
// load; v beside them), all of a chunk's loads issued before the first
// step runs. B * H blocks of Dh threads (32 blocks of 64 threads at a
// full-width prefill) leave most of the card idle and each thread walks
// the sequence serially, so the kernel sits far above its bound; splitting
// a column's rows across threads and the sequence into chunks is later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kChunk = 16;  // steps staged in shared memory at a time

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

// element strides (batch, sequence, head) of r, k, v and w
struct Strides {
  long long r[3], k[3], v[3], w[3];
};

template <typename T, int DH>
__global__ void __launch_bounds__(DH) wkv6_scan_kernel(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* __restrict__ s0,
    T* __restrict__ y, float* __restrict__ s_out, int S, int H,
    Strides st) {
  __shared__ float4 rkwu[kChunk][DH];  // r_i, k_i, w_i, u_i of each step
  __shared__ float vs[kChunk][DH];
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int j = threadIdx.x;
  const size_t state = static_cast<size_t>(bh) * DH * DH + j;

  float s[DH];  // column j of the state
#pragma unroll
  for (int i = 0; i < DH; ++i)
    s[i] = s0 ? s0[state + static_cast<size_t>(i) * DH] : 0.f;
  const float uj = u[h * DH + j];

  const T* rb = r + b * st.r[0] + h * st.r[2] + j;
  const T* kb = k + b * st.k[0] + h * st.k[2] + j;
  const T* vb = v + b * st.v[0] + h * st.v[2] + j;
  const float* wb = w + b * st.w[0] + h * st.w[2] + j;
  T* yb = y + (static_cast<size_t>(b) * S * H + h) * DH + j;

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int n = min(kChunk, S - t0);
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      if (c < n) {
        const long long t = t0 + c;
        rkwu[c][j] = make_float4(to_float(rb[t * st.r[1]]),
                                 to_float(kb[t * st.k[1]]),
                                 wb[t * st.w[1]], uj);
        vs[c][j] = to_float(vb[t * st.v[1]]);
      }
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const float vj = vs[c][j];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < DH; ++i) {
        const float4 q = rkwu[c][i];  // q.x r_i, q.y k_i, q.z w_i, q.w u_i
        const float kv = __fmul_rn(q.y, vj);
        acc = __fmaf_rn(q.x, __fadd_rn(s[i], __fmul_rn(q.w, kv)), acc);
        s[i] = __fadd_rn(__fmul_rn(q.z, s[i]), kv);
      }
      yb[static_cast<size_t>(t0 + c) * H * DH] = from_float<T>(acc);
    }
    __syncthreads();  // the next chunk overwrites the staged steps
  }
#pragma unroll
  for (int i = 0; i < DH; ++i)
    s_out[state + static_cast<size_t>(i) * DH] = s[i];
}

template <typename T, int DH>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, void* y, float* s_out, int B,
           int S, int H, const Strides& st, cudaStream_t stream) {
  wkv6_scan_kernel<T, DH><<<B * H, DH, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, static_cast<T*>(y), s_out, S, H,
      st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(const void* r, const void* k, const void* v, const float* w,
              const float* u, const float* s0, void* y, float* s_out, int B,
              int S, int H, int Dh, const Strides& st, cudaStream_t stream) {
  if (Dh == 64)
    return launch<T, 64>(r, k, v, w, u, s0, y, s_out, B, S, H, st, stream);
  if (Dh == 128)
    return launch<T, 128>(r, k, v, w, u, s0, y, s_out, B, S, H, st, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// r, k, v: [B, S, H, Dh] in `dtype` (0 = float32, 1 = bfloat16); w:
// [B, S, H, Dh] float32; strides: 12 element strides, (batch, sequence,
// head) of r, k, v and w in that order, channels contiguous. u: [H, Dh]
// float32. s0: [B, H, Dh, Dh] float32 contiguous, or null for a zero
// state. y: [B, S, H, Dh] contiguous in `dtype`; s_out: [B, H, Dh, Dh]
// float32 contiguous, distinct from s0. Returns cudaGetLastError() after
// the launch (0 = cudaSuccess); the Python wrapper raises on anything else.
extern "C" int wkv6_scan_launch(const void* r, const void* k, const void* v,
                                const void* w, const void* u, const void* s0,
                                void* y, void* s_out, int B, int S, int H,
                                int Dh, const long long* strides, int dtype,
                                void* stream) {
  if (B < 1 || S < 1 || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  for (int a = 0; a < 3; ++a) {
    st.r[a] = strides[a];
    st.k[a] = strides[3 + a];
    st.v[a] = strides[6 + a];
    st.w[a] = strides[9 + a];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* so = static_cast<float*>(s_out);
  if (dtype == 0)
    return launch_dh<float>(r, k, v, wf, uf, s0f, y, so, B, S, H, Dh, st, s);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(r, k, v, wf, uf, s0f, y, so, B, S, H, Dh,
                                    st, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
