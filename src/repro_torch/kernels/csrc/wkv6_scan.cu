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
// divides S) and Dh 64 or 128. Each state element's update rounds as the
// plain version's separate operations do (k v, w S, their sum, no fused
// multiply-add), in order of t, so S_T equals the plain version's bit for
// bit. y is summed in another order than the plain version's einsum, one
// that depends only on Dh, so a sequence cut anywhere gives the same bits.
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
// b_t = sum_i r_i u_i k_i times v, 5 Dh. Operations bound it on paper: at
// B 1, S 2 300, H 32, Dh 64 that is 1.53 GFLOP, 0.02285 ms at 67 TFLOP/s,
// beside 0.0170 ms of bytes. What bounds this kernel is instruction issue:
// the chain S_{t+1} = w S_t + k v stays serial in t and keeps its
// roundings (splitting t would re-associate the products of w and lose the
// bitwise final state), so the only parallelism is the B H Dh^2 state
// elements, 131 072 at the prefill shape: one warp per scheduler of the
// card, each issuing some 60 instructions a step, with nothing else to hide
// their latencies behind.
//
// Design. A block owns kCols = 16 columns of one head's state (grid B H x
// Dh / 16: 128 blocks at a full-width prefill, 512 at a decode step of 4
// slots), in four warps: warp w holds columns 4w .. 4w+3, lane l rows
// (Dh/32) l .., 8 state elements a thread at Dh 64, in registers, so every
// element's chain is one thread's. Per step a thread loads only its rows of
// r, k and w and its 4 columns of v, as short vectors: 1.25 floats per state
// element (shared memory delivers 128 bytes a cycle, which a layout with
// less reuse runs into). It does 4 operations per element: k v, w S, their
// sum, and r S into its partial sum of each column, to which it adds v_j
// times its rows' share of the scalar b_t = sum_i r_i u_i k_i (the
// 5-operation form of the bonus). A chunk later the 32 partial sums of each
// column are added in a fixed pairwise tree, and y is written out.
// Steps flow in chunks through a ring of kStages raw chunks in shared
// memory, filled by 16-byte `cp.async` (r, k and w rows of the head, v for
// the block's columns only), two chunks in flight while the block works; the
// partial sums go through two more chunks. One barrier per chunk, and no
// shuffle, barrier or store waits inside the serial loop, which loads step
// s + 1 before it runs step s. A row whose address is not a multiple of 16
// bytes (a strided view) is copied with the 16-byte units around it and
// moved into place before it is read, behind a second barrier. The state
// enters and leaves through a tile in shared memory, so that global memory
// sees whole 32-byte sectors (a decode step is mostly these 2 x 2 MB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kCols = 16;    // state columns a block owns
constexpr int kColsPer = 4;  // state columns a thread holds
constexpr int kThreads = 32 * kCols / kColsPer;  // a warp per 4 columns
constexpr int kStages = 3;   // raw chunks in the ring

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// N (2 or 4) consecutive values from shared memory, aligned to their size,
// widened to f32 (bf16 to f32 is exact: the bits move up 16 places)
template <int N>
__device__ __forceinline__ void load_vec(float (&o)[N], const float* p) {
  if constexpr (N == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    o[0] = f.x;
    o[1] = f.y;
  } else {
    static_assert(N == 4, "2 or 4 values");
    const float4 f = *reinterpret_cast<const float4*>(p);
    o[0] = f.x;
    o[1] = f.y;
    o[2] = f.z;
    o[3] = f.w;
  }
}
template <int N>
__device__ __forceinline__ void load_vec(float (&o)[N],
                                         const __nv_bfloat16* p) {
  uint32_t pair[N / 2];
  if constexpr (N == 2) {
    pair[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    static_assert(N == 4, "2 or 4 values");
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    pair[0] = q.x;
    pair[1] = q.y;
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    o[2 * i] = __uint_as_float(pair[i] << 16);
    o[2 * i + 1] = __uint_as_float(pair[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory (at shared address dst), past L1
__device__ __forceinline__ void cp_async16(uint32_t dst, uintptr_t src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// element strides (batch, sequence, head) of r, k, v and w
struct Strides {
  long long r[3], k[3], v[3], w[3];
};

// one tensor's rows for a block: the row of step 0, the bytes between
// steps, the bytes of a row, and where a step's row sits in a raw step
struct Rows {
  const char* p;
  long long step;
  int bytes;
  int slot;
  __device__ __forceinline__ uintptr_t at(int t) const {
    return reinterpret_cast<uintptr_t>(p + t * step);
  }
  __device__ __forceinline__ bool aligned() const {
    return ((reinterpret_cast<uintptr_t>(p) | step) & 15) == 0;
  }
};

template <typename T, int DH>
struct Wkv {
  static constexpr int kRowsPer = DH / 32;  // state rows a thread holds
  static constexpr int kChunk = DH == 64 ? 32 : 16;  // steps per chunk
  // raw rows: each with a 16-byte unit of slack for an unaligned row
  static constexpr int kRBytes = DH * sizeof(T) + 16;      // r, k
  static constexpr int kWBytes = DH * sizeof(float) + 16;  // w
  static constexpr int kVBytes = kCols * sizeof(T) + 16;   // v's columns
  static constexpr int kRawStep = 2 * kRBytes + kWBytes + kVBytes;
  static constexpr int kPartStep = kCols * 32;  // partial sums a step
  // the block's columns of the state, staged so that global memory sees
  // whole 32-byte sectors; rows padded against bank conflicts
  static constexpr int kTileStride = kCols + 4;
  static constexpr int kTileBytes = DH * kTileStride * sizeof(float);
  static constexpr int kTileLoads = DH * kCols / 4 / kThreads;  // a thread

  // the state tile, two chunks of partial sums, then the raw ring, for
  // chunks of `cap` steps, and a spare step after it that the loop may read
  // ahead into
  static size_t smem(int cap) {
    return kTileBytes +
           static_cast<size_t>(cap) *
               (2 * kPartStep * sizeof(float) + kStages * kRawStep) +
           kRawStep;
  }
};

// the 16-byte units of steps t0 .. t0+n-1 of one tensor's rows into ring
// slot `dst` (a shared address), kUnits a row; thread tid takes units tid,
// tid + kThreads, ... of a chunk of kChunk steps
template <int kUnits, int kChunk, int kRawStep>
__device__ __forceinline__ void copy_rows(uint32_t dst, const Rows& src,
                                          int t0, int n, int tid) {
#pragma unroll
  for (int i0 = 0; i0 < kChunk * kUnits; i0 += kThreads) {
    const int i = i0 + tid;
    const int s = i / kUnits;
    const int u = i - s * kUnits;
    const uintptr_t addr = src.at(t0 + s);
    const uintptr_t unit = (addr & ~uintptr_t{15}) + 16 * u;
    if (s < n && unit < addr + src.bytes)
      cp_async16(dst + s * kRawStep + src.slot + 16 * u, unit);
  }
}

// where lane l's partial sum of column c sits in a step's partial sums:
// the lanes' float4 groups rotated by c, so the 16 threads that later sum
// one column each read different banks
__device__ __forceinline__ int partial_at(int c, int l) {
  return c * 32 + 4 * (((l >> 2) + c) & 7) + (l & 3);
}

// (4 blocks an SM, at most 128 registers a thread: a decode step's 512
// blocks run in one wave)
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 4) wkv6_scan_kernel(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* __restrict__ s0,
    T* __restrict__ y, float* __restrict__ s_out, int S, int H, int cap,
    Strides st) {
  using L = Wkv<T, DH>;
  constexpr int R = L::kRowsPer;
  constexpr int esz = sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  float* tile = reinterpret_cast<float*>(smem);
  float* partial = reinterpret_cast<float*>(smem + L::kTileBytes);
  unsigned char* raw = reinterpret_cast<unsigned char*>(
      partial + 2 * cap * L::kPartStep);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int j0 = blockIdx.y * kCols;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;  // columns j0 + 4 warp ..
  const int row0 = lane * R;  // rows row0 .. row0 + R - 1

  const Rows rr{reinterpret_cast<const char*>(r + b * st.r[0] + h * st.r[2]),
                st.r[1] * esz, DH * esz, 0};
  const Rows kr{reinterpret_cast<const char*>(k + b * st.k[0] + h * st.k[2]),
                st.k[1] * esz, DH * esz, L::kRBytes};
  const Rows wr{reinterpret_cast<const char*>(w + b * st.w[0] + h * st.w[2]),
                st.w[1] * 4, DH * 4, 2 * L::kRBytes};
  const Rows vr{
      reinterpret_cast<const char*>(v + b * st.v[0] + h * st.v[2] + j0),
      st.v[1] * esz, kCols * esz, 2 * L::kRBytes + L::kWBytes};
  const bool aligned =
      rr.aligned() && kr.aligned() && wr.aligned() && vr.aligned();
  const int n_chunks = (S + cap - 1) / cap;

  // raw chunk q into ring slot q % kStages
  auto stage = [&](int q) {
    const int t0 = q * cap;
    const int n = min(cap, S - t0);
    const uint32_t dst = smem_addr(raw + (q % kStages) * cap * L::kRawStep);
    copy_rows<L::kRBytes / 16, L::kChunk, L::kRawStep>(dst, rr, t0, n, tid);
    copy_rows<L::kRBytes / 16, L::kChunk, L::kRawStep>(dst, kr, t0, n, tid);
    copy_rows<L::kWBytes / 16, L::kChunk, L::kRawStep>(dst, wr, t0, n, tid);
    copy_rows<L::kVBytes / 16, L::kChunk, L::kRawStep>(dst, vr, t0, n, tid);
  };

  // the landed rows of chunk q that start past a 16-byte boundary, moved
  // down to their slots' starts: a warp a row, 32 elements at a time, each
  // read before any is written
  auto realign = [&](int q) {
    const int t0 = q * cap;
    const int n = min(cap, S - t0);
    unsigned char* src = raw + (q % kStages) * cap * L::kRawStep;
    auto move = [&](const Rows& x, int s, auto one) {
      const int shift = static_cast<int>(x.at(t0 + s) & 15);
      if (shift == 0) return;
      using E = decltype(one);
      E* row = reinterpret_cast<E*>(src + s * L::kRawStep + x.slot);
      const E* from = reinterpret_cast<const E*>(
          reinterpret_cast<const unsigned char*>(row) + shift);
      const int count = x.bytes / static_cast<int>(sizeof(E));
      for (int e = 0; e < count; e += 32) {
        E val = one;
        if (e + lane < count) val = from[e + lane];
        __syncwarp();
        if (e + lane < count) row[e + lane] = val;
        __syncwarp();
      }
    };
    for (int s = warp; s < n; s += kThreads / 32) {
      move(rr, s, T{});
      move(kr, s, T{});
      move(wr, s, 0.f);
      move(vr, s, T{});
    }
  };

  // the block's corner of the state, S[0][j0]; this thread holds
  // S[row0 + m][j0 + 4 warp + c], and u of its rows
  const size_t head = static_cast<size_t>(bh) * DH * DH + j0;
  float sv[R][kColsPer];
  float uu[R];
#pragma unroll
  for (int m = 0; m < R; ++m) uu[m] = u[h * DH + row0 + m];

  // output o of chunk q's y (step o / kCols, column o % kCols): the 32
  // partial sums in a fixed pairwise tree (lanes 0 + 1, 2 + 3, ..., then
  // pairs of those, ...), as four trees over 8 and then theirs, which is the
  // same additions in the same order in fewer registers
  auto finish_one = [&](int q, int o) {
    const int s = o / kCols;
    const int c = o % kCols;
    const float* col = partial + (q & 1) * cap * L::kPartStep +
                       s * L::kPartStep + c * 32;
    float sub[4];
#pragma unroll
    for (int b8 = 0; b8 < 4; ++b8) {
      float p[8];
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const float4 f = *reinterpret_cast<const float4*>(
            col + 4 * ((2 * b8 + g + c) & 7));
        p[4 * g] = f.x;
        p[4 * g + 1] = f.y;
        p[4 * g + 2] = f.z;
        p[4 * g + 3] = f.w;
      }
#pragma unroll
      for (int d = 1; d < 8; d <<= 1)
#pragma unroll
        for (int i = 0; i < 8; i += 2 * d) p[i] = __fadd_rn(p[i], p[i + d]);
      sub[b8] = p[0];
    }
    const float sum =
        __fadd_rn(__fadd_rn(sub[0], sub[1]), __fadd_rn(sub[2], sub[3]));
    y[((static_cast<size_t>(b) * S + q * cap + s) * H + h) * DH + j0 + c] =
        from_float<T>(sum);
  };
  // chunk q's y. Past the chunk's last output a thread repeats it, the same
  // value to the same place, so no branch splits a whole chunk's outputs
  // (and a decode step's 16 take one pass)
  auto finish = [&](int q) {
    const int n_out = min(cap, S - q * cap) * kCols;
#pragma unroll 4
    for (int o0 = 0; o0 < n_out; o0 += kThreads)
      finish_one(q, min(o0 + tid, n_out - 1));
  };

  // the block's columns of the initial state first, the bulk of a decode
  // step's reads: float4 i of a thread is row tile_row(i), columns
  // tile_col(i) .. + 3, so a row's 64 bytes go to 4 neighbouring threads (a
  // contiguous s0 that starts off 16 bytes is read a float at a time)
  auto tile_row = [&](int i) { return (tid + i * kThreads) / (kCols / 4); };
  auto tile_col = [&](int i) {
    return 4 * ((tid + i * kThreads) % (kCols / 4));
  };
  const bool s0_vec = (reinterpret_cast<uintptr_t>(s0) & 15) == 0;
  float4 f[L::kTileLoads];
  if (s0 != nullptr) {
#pragma unroll
    for (int i = 0; i < L::kTileLoads; ++i) {
      const float* src = s0 + head + tile_row(i) * DH + tile_col(i);
      f[i] = s0_vec ? *reinterpret_cast<const float4*>(src)
                    : make_float4(src[0], src[1], src[2], src[3]);
    }
  }
  for (int q = 0; q < kStages - 1; ++q) {
    if (q < n_chunks) stage(q);
    cp_async_commit();
  }
  if (s0 != nullptr) {
#pragma unroll
    for (int i = 0; i < L::kTileLoads; ++i)
      *reinterpret_cast<float4*>(tile + tile_row(i) * L::kTileStride +
                                 tile_col(i)) = f[i];
    __syncthreads();
#pragma unroll
    for (int m = 0; m < R; ++m)
      load_vec(sv[m], tile + (row0 + m) * L::kTileStride + kColsPer * warp);
  } else {
#pragma unroll
    for (int m = 0; m < R; ++m)
#pragma unroll
      for (int c = 0; c < kColsPer; ++c) sv[m][c] = 0.f;
  }

  for (int q = 0; q < n_chunks; ++q) {
    cp_async_wait<kStages - 2>();  // chunk q has landed
    // chunk q is visible, chunk q - 1's steps are done: its raw slot and
    // the partial sums of chunk q - 2 are free
    __syncthreads();
    if (!aligned) {
      realign(q);
      __syncthreads();
    }
    if (q + kStages - 1 < n_chunks) stage(q + kStages - 1);
    cp_async_commit();
    if (q > 0) finish(q - 1);
    // chunk q's steps, each step's inputs loaded a step ahead
    const int n = min(cap, S - q * cap);
    const unsigned char* rs = raw + (q % kStages) * cap * L::kRawStep;
    float* pt = partial + (q & 1) * cap * L::kPartStep;
    float ra[R], ka[R], wa[R], va[kColsPer];
    float rc[R], kc[R], wc[R], vc[kColsPer];
    auto load = [&](float (&rx)[R], float (&kx)[R], float (&wx)[R],
                    float (&vx)[kColsPer], int s) {
      const unsigned char* row = rs + s * L::kRawStep;
      load_vec(rx, reinterpret_cast<const T*>(row) + row0);
      load_vec(kx, reinterpret_cast<const T*>(row + L::kRBytes) + row0);
      load_vec(wx, reinterpret_cast<const float*>(row + 2 * L::kRBytes) +
                       row0);
      load_vec(vx, reinterpret_cast<const T*>(row + 2 * L::kRBytes +
                                              L::kWBytes) +
                       kColsPer * warp);
    };
    // one step: each column's partial sum sum_m r_m S_m + v (sum_m r_m u_m
    // k_m) to shared memory, then S = w S + k v
    auto run = [&](const float (&rx)[R], const float (&kx)[R],
                   const float (&wx)[R], const float (&vx)[kColsPer], int s) {
      float bt = __fmul_rn(rx[0], __fmul_rn(uu[0], kx[0]));
#pragma unroll
      for (int m = 1; m < R; ++m)
        bt = __fmaf_rn(rx[m], __fmul_rn(uu[m], kx[m]), bt);
      float* ps = pt + s * L::kPartStep;
#pragma unroll
      for (int c = 0; c < kColsPer; ++c) {
        float part = __fmul_rn(rx[0], sv[0][c]);
#pragma unroll
        for (int m = 1; m < R; ++m) part = __fmaf_rn(rx[m], sv[m][c], part);
        ps[partial_at(kColsPer * warp + c, lane)] =
            __fmaf_rn(vx[c], bt, part);
      }
#pragma unroll
      for (int m = 0; m < R; ++m)
#pragma unroll
        for (int c = 0; c < kColsPer; ++c)
          sv[m][c] = __fadd_rn(__fmul_rn(wx[m], sv[m][c]),
                               __fmul_rn(kx[m], vx[c]));
    };
    // (a load past n reads a stale row, at most the ring's spare step)
    load(ra, ka, wa, va, 0);
    int s = 0;
    for (; s + 2 <= n; s += 2) {
      load(rc, kc, wc, vc, s + 1);
      run(ra, ka, wa, va, s);
      load(ra, ka, wa, va, s + 2);
      run(rc, kc, wc, vc, s + 1);
    }
    if (s < n) run(ra, ka, wa, va, s);
  }
  // the final state through the tile (its initial reads ended before the
  // loop's first barrier)
#pragma unroll
  for (int m = 0; m < R; ++m)
    *reinterpret_cast<float4*>(tile + (row0 + m) * L::kTileStride +
                               kColsPer * warp) =
        make_float4(sv[m][0], sv[m][1], sv[m][2], sv[m][3]);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < L::kTileLoads; ++i)
    *reinterpret_cast<float4*>(s_out + head + tile_row(i) * DH + tile_col(i)) =
        *reinterpret_cast<const float4*>(tile + tile_row(i) * L::kTileStride +
                                         tile_col(i));
  finish(n_chunks - 1);
}

template <typename T, int DH>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, void* y, float* s_out, int B,
           int S, int H, const Strides& st, cudaStream_t stream) {
  using L = Wkv<T, DH>;
  auto kernel = wkv6_scan_kernel<T, DH>;
  const int cap = S < L::kChunk ? S : L::kChunk;  // steps per chunk
  const size_t smem = L::smem(cap);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::smem(L::kChunk)));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B * H, DH / kCols);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, static_cast<T*>(y), s_out, S, H,
      cap, st);
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
