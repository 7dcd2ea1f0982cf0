// The RG-LRU linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} +
// x_t from h_0 = 0, independently per channel, every h_t written out. The
// prefill recurrence of every recurrent layer (one launch per layer per
// prefill).
//
// Replaces the TPU kernel `rglru_scan` in src/repro/kernels/rglru_scan.py
// (wrapper :49, body `_rglru_kernel` :26), and computes what it computes:
// the carry in f32, each output cast to a's dtype, for any S (the Pallas
// kernel asserts that its chunk divides S). Each step multiplies, rounds,
// then adds and rounds, in f32 (no fused multiply-add), in order of t, as
// the plain version computes a*h + x: for f32 inputs the two agree bit for
// bit, and for bf16 inputs the kernel equals the plain version run on the
// inputs widened to f32 and rounded once at the end.
//
// Layouts: a, x and h [B, S, R], contiguous, one dtype.
//
// Bound. Two loads and one store per element and two flops: bytes bound it,
// 3 * B * S * R * sizeof(dtype) at 3.35 TB/s (0.0105 ms at B 1, S 2 300,
// R 2 560 in bf16). The chain is serial in t and keeps its roundings (a
// scan over chunks of S would re-associate the products of a and lose the
// bitwise equalities), so each channel also takes S dependent multiply-add
// pairs, ~8.5 cycles a step on the H100: ~2 300 x 8.5 cycles, about 10 us,
// about the bytes' time. The work is to keep memory's latency off that
// chain; what is left on it is the consumer's two shared-memory loads and
// one store a step, whose issue from a single warp takes longer than the
// multiply and the add.
//
// Design. A block owns kTile = 16 channels of one batch row (grid R / 16 x
// B: 160 blocks at recurrentgemma-2b's width) and has two warps. The
// consumer warp's first 16 lanes run the channels' chains, one lane each,
// with the carry in a register: they load a group of kGroup steps' a and x
// from shared memory while the group before runs, and write each h to
// shared memory. The producer warp keeps kStages - 1 chunks of kSteps steps
// (256 steps) in flight through a ring of raw chunks in shared memory,
// filled by 16-byte `cp.async`, and stores each finished chunk's h in
// 16-byte stores while the consumer runs the next. One barrier per chunk.
// A row whose address is not a multiple of 16 bytes (R * sizeof(dtype) not
// a multiple of 16, or a view's offset) is copied with the 16-byte units
// around it and moved into place before the consumer reads it, and its h
// is stored element by element. The channels past R in the last tile, and
// the steps past S in the last chunk, are computed on stale values and not
// stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kTile = 16;    // channels per block
constexpr int kSteps = 128;  // steps per chunk
constexpr int kStages = 3;   // raw chunks in the ring
constexpr int kThreads = 64;  // warp 0 consumes, warp 1 produces
constexpr int kGroup = 16;   // steps a consumer lane loads at once

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

template <typename T>
struct Lru {
  // a raw row of the tile, with a 16-byte unit of slack for an unaligned
  // row; a step holds a's row, then x's
  static constexpr int kRow = kTile * sizeof(T) + 16;
  static constexpr int kUnits = kRow / 16;
  static constexpr int kRawStep = 2 * kRow;
  static constexpr int kRaw = kStages * kSteps * kRawStep;
  // h of two chunks, [kSteps][kTile] each
  static constexpr int kOut = 2 * kSteps * kTile * sizeof(T);
  static constexpr int kSmem = kRaw + kOut;
};

// a and x of steps s0 .. s0 + kGroup - 1 of a raw chunk (one channel's,
// at src)
template <typename T>
__device__ __forceinline__ void load_group(float (&av)[kGroup],
                                           float (&xv)[kGroup],
                                           const unsigned char* src, int s0) {
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    const unsigned char* row = src + (s0 + j) * Lru<T>::kRawStep;
    av[j] = to_float(*reinterpret_cast<const T*>(row));
    xv[j] = to_float(*reinterpret_cast<const T*>(row + Lru<T>::kRow));
  }
}

// the chain over steps s0 .. s0 + kGroup - 1, each h to o (one channel's
// column of the chunk's output); returns the carry
template <typename T>
__device__ __forceinline__ float run_group(const float (&av)[kGroup],
                                           const float (&xv)[kGroup],
                                           float h, T* o, int s0) {
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    h = __fadd_rn(__fmul_rn(av[j], h), xv[j]);
    o[(s0 + j) * kTile] = from_float<T>(h);
  }
  return h;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) rglru_scan_kernel(
    const T* __restrict__ a, const T* __restrict__ x, T* __restrict__ h_out,
    int B, int S, int R) {
  using L = Lru<T>;
  constexpr int esz = sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* raw = smem;
  T* out = reinterpret_cast<T*>(smem + L::kRaw);

  const int r0 = blockIdx.x * kTile;
  const int cols = min(kTile, R - r0);
  const size_t base = static_cast<size_t>(blockIdx.y) * S * R + r0;
  const uintptr_t pa = reinterpret_cast<uintptr_t>(a + base);
  const uintptr_t px = reinterpret_cast<uintptr_t>(x + base);
  const uintptr_t ph = reinterpret_cast<uintptr_t>(h_out + base);
  const long long row = static_cast<long long>(R) * esz;  // bytes a step
  const int bytes = cols * esz;
  const int n_chunks = (S + kSteps - 1) / kSteps;
  const int lane = threadIdx.x & 31;
  const bool producer = threadIdx.x >= 32;
  // whether every row of a and x starts on 16 bytes, and of h too with
  // whole 16-byte units
  const bool in_aligned = ((pa | px | static_cast<uintptr_t>(row)) & 15) == 0;
  const bool out_aligned =
      ((ph | static_cast<uintptr_t>(row) | bytes) & 15) == 0;

  // producer: raw chunk q into ring slot q % kStages. Lane l copies unit
  // (l / 2) % kUnits of a's row (l even) or x's (l odd) in steps (l / 2) /
  // kUnits, + kPass, ...; the units past a row's bytes are skipped
  constexpr int kPass = 16 / L::kUnits;  // steps the warp covers at once
  const int unit_u = (lane >> 1) % L::kUnits;
  const int unit_s = (lane >> 1) / L::kUnits;
  auto stage = [&](int q) {
    const int t0 = q * kSteps;
    const int n = min(kSteps, S - t0);
    if (unit_s >= kPass) return;
    uintptr_t addr = ((lane & 1) ? px : pa) + (t0 + unit_s) * row;
    uint32_t dst = smem_addr(raw + (q % kStages) * kSteps * L::kRawStep +
                             unit_s * L::kRawStep + (lane & 1) * L::kRow +
                             16 * unit_u);
    for (int s = unit_s; s < n; s += kPass) {
      const uintptr_t unit = (addr & ~uintptr_t{15}) + 16 * unit_u;
      if (unit < addr + bytes) cp_async16(dst, unit);
      addr += kPass * row;
      dst += kPass * L::kRawStep;
    }
  };

  // producer: move the landed rows of chunk q that start past a 16-byte
  // boundary to their slots' starts; step s's a and x rows, one lane each
  // element
  auto align = [&](int q) {
    if (in_aligned) return;
    const int t0 = q * kSteps;
    const int n = min(kSteps, S - t0);
    unsigned char* src = raw + (q % kStages) * kSteps * L::kRawStep;
    const int which = lane >> 4;
    const int c = lane & 15;
    for (int s = 0; s < n; ++s) {
      T* slot = reinterpret_cast<T*>(src + s * L::kRawStep + which * L::kRow);
      const int shift =
          static_cast<int>(((which ? px : pa) + (t0 + s) * row) & 15) / esz;
      const T val = slot[shift + c];
      __syncwarp();
      slot[c] = val;
      __syncwarp();
    }
  };

  // producer: chunk q's h from shared memory to the output: whole 16-byte
  // units where the rows allow (lane l: unit l % units of steps l / units,
  // + 32 / units, ...), else element by element
  const int out_units = bytes >> 4;  // 1, 2 or 4 when out_aligned
  auto store = [&](int q) {
    const int t0 = q * kSteps;
    const int n = min(kSteps, S - t0);
    const T* o = out + (q & 1) * kSteps * kTile;
    if (out_aligned) {
      const int u = lane % out_units;
      const int pass = 32 / out_units;
      for (int s = lane / out_units; s < n; s += pass)
        *reinterpret_cast<int4*>(ph + (t0 + s) * row + 16 * u) =
            *reinterpret_cast<const int4*>(o + s * kTile + u * (16 / esz));
    } else {
      for (int i = lane; i < n * kTile; i += 32) {
        const int s = i / kTile;
        const int c = i - s * kTile;
        if (c < cols)
          reinterpret_cast<T*>(ph + (t0 + s) * row)[c] = o[s * kTile + c];
      }
    }
  };

  if (producer) {
    for (int q = 0; q < kStages - 1; ++q) {
      if (q < n_chunks) stage(q);
      cp_async_commit();
    }
    cp_async_wait<kStages - 2>();  // chunk 0 has landed
    __syncwarp();
    align(0);
  }
  __syncthreads();
  float h = 0.f;
  for (int q = 0; q < n_chunks; ++q) {
    if (!producer) {
      if (lane < kTile) {
        // chunk q's steps, kGroup at a time, each group's a and x loaded
        // before the group ahead runs, so no load waits in the chain. The
        // last pair of groups may run past S on stale rows: the carry is
        // not used again and the producer stores only S rows.
        const int n = min(kSteps, S - q * kSteps);
        const unsigned char* src =
            raw + (q % kStages) * kSteps * L::kRawStep + lane * esz;
        T* o = out + (q & 1) * kSteps * kTile + lane;
        float av[2][kGroup], xv[2][kGroup];
        load_group<T>(av[0], xv[0], src, 0);
#pragma unroll 1
        for (int s0 = 0; s0 < n; s0 += 2 * kGroup) {
          load_group<T>(av[1], xv[1], src, s0 + kGroup);
          h = run_group<T>(av[0], xv[0], h, o, s0);
          if (s0 + 2 * kGroup < kSteps)
            load_group<T>(av[0], xv[0], src, s0 + 2 * kGroup);
          h = run_group<T>(av[1], xv[1], h, o, s0 + kGroup);
        }
      }
    } else {
      // chunk q - 1's raw slot is free (its steps ran in the last phase)
      if (q + kStages - 1 < n_chunks) stage(q + kStages - 1);
      cp_async_commit();
      if (q > 0) store(q - 1);
      cp_async_wait<kStages - 2>();  // chunk q + 1 has landed
      __syncwarp();
      if (q + 1 < n_chunks) align(q + 1);
    }
    __syncthreads();
  }
  if (producer) store(n_chunks - 1);
}

template <typename T>
int launch(const void* a, const void* x, void* h, int B, int S, int R,
           cudaStream_t stream) {
  using L = Lru<T>;
  auto kernel = rglru_scan_kernel<T>;
  if (L::kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((R + kTile - 1) / kTile, B);
  kernel<<<grid, kThreads, L::kSmem, stream>>>(
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
