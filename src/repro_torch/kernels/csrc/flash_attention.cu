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
// Design, bf16 (every serving path). One block per (batch, query head,
// 64-row query tile), the latest (heaviest) tiles launched first; 4 row
// warps own 16 query rows each. At Dh <= 64 each row warp has a twin that
// takes the other half of every key tile, and the twins merge their
// (m, l, o) at the end: a short prompt's few tiles then keep twice the
// warps busy. Q and a 2-stage ring of K/V tiles (128 keys at Dh <= 64, 64
// at 128, 32 at 256) sit in bf16 shared memory, rows padded by 16 bytes so
// that `ldmatrix` is free of bank conflicts; tile j + 1 is copied with
// 16-byte `cp.async.cg` while tile j computes, and every copy and
// `ldmatrix` address is a per-thread base plus constants. Tiles outside the
// causal / window band are never read, a warp skips a tile that holds
// nothing for its own rows, and only tiles on the band's edge are masked.
// QK^T is `mma.sync.m16n8k16` bf16 x bf16 -> f32 with Q re-read by
// `ldmatrix` on every tile (at Dh 256 the f32 output accumulator alone is
// 128 registers a thread). The scale Dh^-0.5 and log2(e) multiply the f32
// scores, not bf16 q (the scale is not a power of two at Dh 32 and 128),
// folded into one FFMA before each exp2. Row max, exp2 and row sum act on
// the accumulator fragments in registers (a row lies across a quad of
// lanes: two shuffles), and the fragments become PV's A operand without
// leaving registers. The running max moves only when a row's max would
// grow by more than a factor 2^8 (so p <= 2^8), and most tiles of a long
// row skip rescaling o. PV is `mma.sync` with V through `ldmatrix.trans`.
// At Dh 64 the instructions around the tensor cores, not memory, set the
// time per tile: hence the short instruction path per score.
//
// Precision of PV. The limit on a bf16 output is BF16_ATOL + 2^-6 |plain|,
// where plain sums p v in f32. Rounding P once to bf16 (what
// scaled_dot_product_attention does) moves an output by up to
// 2^-9 sum_j p_j |v_j| / l, which exceeds that limit on short rows whose
// values cancel (|plain| << sum p |v|). So P is split into P_hi = bf16(P)
// and P_lo = bf16(P - P_hi) (the difference is exact in f32) and both are
// multiplied into the same f32 accumulator: V is exact in bf16 and a
// bf16 x bf16 product exact in f32, so PV's error is about
// 2^-18 sum_j p_j |v_j| / l plus f32 summation. It doubles PV's
// tensor-core work (1.5x the kernel's), and the two products share each V
// fragment. The denominator l sums the f32 P.
//
// Design, f32 (tests and phase 8 only; the tensor cores' TF32 could not
// hold TOL_F32): one block of 256 threads per 64-row query tile, q scaled
// and staged as f32, K/V staged as f32 with every 16-byte load of a tile
// issued before any store, a 16 x 16 thread grid whose half-warps own rows
// (4 each), plain f32 FMA on the CUDA cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

struct Strides {
  // batch, head and sequence strides in elements, for q, k, v and out
  long long q[3], k[3], v[3], o[3];
};

// ---------------------------------------------------------------- f32 ----

constexpr int kF32Threads = 256;  // a 16 x 16 grid of threads
constexpr int kF32BlockQ = 64;    // query rows per block: 16 groups of 4
constexpr int kF32Rows = 4;       // query rows per thread

// key positions per staged tile: keeps the f32 shared memory of Dh 128 and
// 256 at ~75 and ~140 KB
template <int DH>
struct F32BlockK {
  static constexpr int value = DH >= 128 ? 32 : 64;
};

template <int DH>
constexpr size_t f32_smem_bytes() {
  constexpr size_t bk = F32BlockK<DH>::value;
  return sizeof(float) * (kF32BlockQ * (DH + 4)      // q, padded
                          + bk * (DH + 1)            // K, odd stride
                          + bk * DH                  // V
                          + kF32BlockQ * (bk + 1));  // P
}

template <int DH>
__device__ __forceinline__ void flash_f32_body(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int H, int Hkv,
    int Sq, int Skv, const Strides& st, int causal, int window, float scale,
    float* smem) {
  constexpr int BK = F32BlockK<DH>::value;
  constexpr int QS = DH + 4;    // two half-warps' rows land in other banks
  constexpr int KS = DH + 1;    // 16 key rows at one channel: 16 banks
  constexpr int PS = BK + 1;
  constexpr int kVec = 4;                    // floats per 16-byte load
  constexpr int kRowVecs = DH / kVec;
  constexpr int kLoads = BK * kRowVecs / kF32Threads;  // per tile, tensor
  constexpr int kCols = DH / 16;             // output channels per thread
  constexpr int kKeys = BK / 16;             // keys per row per thread
  static_assert(BK * kRowVecs % kF32Threads == 0, "tile loads must divide");

  const int qt = gridDim.y - 1 - blockIdx.y;  // latest (heaviest) first
  const int h = blockIdx.x;
  const int b = blockIdx.z;
  const int hk = h * Hkv / H;
  const int q0 = qt * kF32BlockQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  float* qs = smem;                      // [kF32BlockQ][QS], scaled
  float* ks = qs + kF32BlockQ * QS;      // [BK][KS]
  float* vs = ks + BK * KS;              // [BK][DH]
  float* ps = vs + BK * DH;              // [kF32BlockQ][PS]

  const float* qb = q + b * st.q[0] + h * st.q[1];
  const float* kb = k + b * st.k[0] + hk * st.k[1];
  const float* vb = v + b * st.v[0] + hk * st.v[1];

  // q rows past Sq are staged as zeros; their outputs are never written
  for (int e = tid; e < kF32BlockQ * kRowVecs; e += kF32Threads) {
    const int r = e / kRowVecs;
    const int c = (e - r * kRowVecs) * kVec;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Sq)
      x = *reinterpret_cast<const float4*>(qb + (q0 + r) * st.q[2] + c);
    qs[r * QS + c + 0] = x.x * scale;
    qs[r * QS + c + 1] = x.y * scale;
    qs[r * QS + c + 2] = x.z * scale;
    qs[r * QS + c + 3] = x.w * scale;
  }

  // keys any row of this tile may see: rows q0 .. q0 + kF32BlockQ - 1
  // reach back to q0 - window + 1 and (causal) forward to q0 + 63
  int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Skv, q0 + kF32BlockQ) : Skv;
  k_lo = k_lo / BK * BK;

  float acc[kF32Rows][kCols];
  float m[kF32Rows], l[kF32Rows];
#pragma unroll
  for (int i = 0; i < kF32Rows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // q staged; the previous tile's K, V and P consumed
    // stage the K and V rows k0 .. k0 + BK - 1 (zeros past Skv): every
    // 16-byte load of the tile is issued before any shared-memory store
    float4 kr[kLoads], vr[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = tid + i * kF32Threads;
      const int t = e / kRowVecs;
      const int c = (e - t * kRowVecs) * kVec;
      kr[i] = vr[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + t < Skv) {
        kr[i] = *reinterpret_cast<const float4*>(kb + (k0 + t) * st.k[2] + c);
        vr[i] = *reinterpret_cast<const float4*>(vb + (k0 + t) * st.v[2] + c);
      }
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = tid + i * kF32Threads;
      const int t = e / kRowVecs;
      const int c = (e - t * kRowVecs) * kVec;
      const float* kx = reinterpret_cast<const float*>(&kr[i]);
      const float* vx = reinterpret_cast<const float*>(&vr[i]);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        ks[t * KS + c + j] = kx[j];
        vs[t * DH + c + j] = vx[j];
      }
    }
    __syncthreads();

    // scores of rows 4 ty + i against keys k0 + tx + 16 j
    float s[kF32Rows][kKeys];
#pragma unroll
    for (int i = 0; i < kF32Rows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[kF32Rows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kF32Rows; ++i)
        qv[i] = qs[(ty * kF32Rows + i) * QS + d];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kv[j] = ks[(tx + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < kF32Rows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax; a row's 16 threads are one half-warp. A row may see
    // nothing in a tile: then m stays, its probabilities are 0 and, while
    // m is -inf, alpha is 1
#pragma unroll
    for (int i = 0; i < kF32Rows; ++i) {
      const int qi = q0 + ty * kF32Rows + i;
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
        ps[(ty * kF32Rows + i) * PS + tx + 16 * j] = p;
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
      float pv[kF32Rows], vv[kCols];
#pragma unroll
      for (int i = 0; i < kF32Rows; ++i)
        pv[i] = ps[(ty * kF32Rows + i) * PS + t];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = vs[t * DH + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kF32Rows; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  float* ob = out + b * st.o[0] + h * st.o[1];
#pragma unroll
  for (int i = 0; i < kF32Rows; ++i) {
    const int qi = q0 + ty * kF32Rows + i;
    if (qi >= Sq) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      ob[qi * st.o[2] + tx + 16 * c] =
          l[i] > 0.f ? acc[i][c] / l[i] : 0.f;
  }
}

// --------------------------------------------------------------- bf16 ----

template <int DH>
struct Mma {
  static constexpr int kRowWarps = 4;                // 16 query rows each
  // warps per row group, each on its share of every key tile: 2 where the
  // accumulator is small (Dh <= 64), so that a short prompt's few tiles
  // have twice the warps in flight
  static constexpr int kSplit = DH <= 64 ? 2 : 1;
  static constexpr int kThreads = 32 * kRowWarps * kSplit;
  static constexpr int kBlockQ = 16 * kRowWarps;
  static constexpr int kBlockK = DH >= 256 ? 32 : DH >= 128 ? 64 : 128;
  static constexpr int kStride = DH + 8;             // +16 bytes per row
  // a 2-stage ring of K/V tiles keeps two blocks on an SM at every Dh
  static constexpr int kStages = 2;
  static constexpr size_t kRing =
      sizeof(bf16) * kStride * 2 * kStages * kBlockK;
  static constexpr size_t kSmem = sizeof(bf16) * kStride * kBlockQ + kRing;
  // the other key shares' partial (m, l, o), merged through the ring
  static constexpr size_t kMerge =
      sizeof(float) * (kSplit - 1) * kRowWarps * 32 * (DH / 2 + 4);
  static_assert(kMerge <= kRing && kBlockK % (16 * kSplit) == 0,
                "key shares of whole k16 steps, merged in the ring");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory (at shared address dst), bypassing
// L1; src_bytes 0 fills the 16 bytes with zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 b16 matrices from shared memory, lane i giving the address
// of row i % 8 of matrix i / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), c 16 x 8 f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) as a bf16 pair hi plus the bf16 pair of what hi leaves out
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - __low2float(h),
                                    x1 - __high2float(h)));
}

template <int DH>
__device__ __forceinline__ void flash_mma_body(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out, int H, int Hkv,
    int Sq, int Skv, const Strides& st, int causal, int window, float scale,
    bf16* smem) {
  using M = Mma<DH>;
  constexpr int BQ = M::kBlockQ, BK = M::kBlockK, SS = M::kStride;
  constexpr int kChunks = DH / 8;   // 16-byte chunks per row
  constexpr int KW = BK / M::kSplit; // keys per warp per tile
  constexpr int kNt = KW / 8;       // n8 score tiles per warp and tile
  constexpr int kOt = DH / 8;       // n8 output tiles

  const int h = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // latest (heaviest) first
  const int b = blockIdx.z;
  const int hk = h * Hkv / H;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rg = warp % M::kRowWarps;   // the warp's 16 query rows
  const int kh = warp / M::kRowWarps;   // and its share of each key tile
  const int kw0 = kh * KW;
  const int g = lane >> 2;          // the fragment's row (and row + 8)
  const int tq = lane & 3;          // the fragment's column pair

  bf16* qs = smem;                          // [BQ][SS]
  bf16* ks = qs + BQ * SS;                  // [kStages][BK][SS]
  bf16* vs = ks + M::kStages * BK * SS;     // [kStages][BK][SS]

  const bf16* qb = q + b * st.q[0] + h * st.q[1];
  const bf16* kb = k + b * st.k[0] + hk * st.k[1];
  const bf16* vb = v + b * st.v[0] + hk * st.v[1];

  // copies: thread tid moves 16-byte chunk lc of rows lr, lr + kPassRows,
  // ... of every tile, so its source and destination advance by constants
  constexpr int kPassRows = M::kThreads / kChunks;
  static_assert(M::kThreads % kChunks == 0 && BQ % kPassRows == 0 &&
                    BK % kPassRows == 0,
                "copies must tile the rows");
  constexpr uint32_t kRowBytes = SS * sizeof(bf16);
  constexpr uint32_t kStageBytes = BK * kRowBytes;
  const int lr = tid / kChunks;
  const int lc = (tid - lr * kChunks) * 8;

  // q rows past Sq are staged as zeros; their outputs are never written
  {
    const uint32_t dst = smem_addr(qs + lr * SS + lc);
    const bf16* src = qb + (q0 + lr) * st.q[2] + lc;
#pragma unroll
    for (int i = 0; i < BQ / kPassRows; ++i) {
      const bool ok = q0 + lr + i * kPassRows < Sq;
      cp_async16(dst + i * kPassRows * kRowBytes,
                 ok ? src + i * kPassRows * st.q[2] : qb, ok ? 16 : 0);
    }
  }

  // keys any row of this tile may see
  int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Skv, q0 + BQ) : Skv;
  k_lo = k_lo / BK * BK;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  const uint32_t k_dst = smem_addr(ks + lr * SS + lc);
  const uint32_t v_dst = smem_addr(vs + lr * SS + lc);
  auto load_kv = [&](int tile, int stage) {
    const int r0 = k_lo + tile * BK + lr;
    const bf16* ksrc = kb + r0 * st.k[2] + lc;
    const bf16* vsrc = vb + r0 * st.v[2] + lc;
#pragma unroll
    for (int i = 0; i < BK / kPassRows; ++i) {
      const bool ok = r0 + i * kPassRows < Skv;  // zeros past Skv: P is 0
      const uint32_t off = stage * kStageBytes + i * kPassRows * kRowBytes;
      cp_async16(k_dst + off, ok ? ksrc + i * kPassRows * st.k[2] : kb,
                 ok ? 16 : 0);
      cp_async16(v_dst + off, ok ? vsrc + i * kPassRows * st.v[2] : vb,
                 ok ? 16 : 0);
    }
  };

  // q with tile 0, then tiles 1 .. kStages - 2: one commit group each
#pragma unroll
  for (int i = 0; i < M::kStages - 1; ++i) {
    if (i < n_tiles) load_kv(i, i);
    cp_async_commit();
  }

  // this warp's rows: wr0 .. wr0 + 15; the thread holds rows wr0 + g and
  // wr0 + g + 8
  const int wr0 = q0 + rg * 16;
  const int row[2] = {wr0 + g, wr0 + g + 8};
  const float sl2 = scale * 1.4426950408889634f;   // exp(x) = exp2(x log2 e)
  // each lane's ldmatrix row addresses: Q's A fragments, K's B fragments
  // (keys as rows), V's B fragments through .trans (keys as rows)
  const uint32_t q_lds =
      smem_addr(qs + (rg * 16 + (lane & 15)) * SS + (lane >> 4) * 8);
  const uint32_t k_lds = smem_addr(
      ks + (kw0 + (lane & 7) + (lane >> 4) * 8) * SS + ((lane >> 3) & 1) * 8);
  const uint32_t v_lds = smem_addr(
      vs + (kw0 + (lane & 7) + ((lane >> 3) & 1) * 8) * SS + (lane >> 4) * 8);

  float o[kOt][4];
#pragma unroll
  for (int i = 0; i < kOt; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int next = j + M::kStages - 1;
    if (next < n_tiles) load_kv(next, next % M::kStages);
    cp_async_commit();
    cp_async_wait<M::kStages - 1>();   // groups 0 .. j: tile j has landed
    __syncthreads();

    const int k0 = k_lo + j * BK + kw0;   // this warp's first key
    const bool visible = wr0 < Sq && k0 < Skv &&
                         (!causal || k0 <= wr0 + 15) &&
                         (window <= 0 || k0 + KW - 1 > wr0 - window);
    if (visible) {
      const uint32_t stage = (j % M::kStages) * kStageBytes;

      // S = Q K^T for the warp's 16 rows and its KW keys of the tile
      float s[kNt][4];
#pragma unroll
      for (int i = 0; i < kNt; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, q_lds + kk * 32);
#pragma unroll
        for (int nn = 0; nn < KW / 16; ++nn) {
          uint32_t bk[4];
          ldmatrix_x4(bk, k_lds + stage + nn * 16 * kRowBytes + kk * 32);
          mma_bf16(s[2 * nn], a, bk[0], bk[1]);
          mma_bf16(s[2 * nn + 1], a, bk[2], bk[3]);
        }
      }

      // mask only a tile on the band's edge: raw scores, -inf where masked
      const bool edge = k0 + KW > Skv || (causal && k0 + KW - 1 > wr0) ||
                        (window > 0 && k0 <= wr0 + 15 - window);
      if (__builtin_expect(edge, 0)) {
#pragma unroll
        for (int i = 0; i < kNt; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kj = k0 + i * 8 + 2 * tq + (e & 1);
            const int qi = row[e >> 1];
            const bool ok = kj < Skv && (!causal || kj <= qi) &&
                            (window <= 0 || kj > qi - window);
            if (!ok) s[i][e] = -INFINITY;
          }
      }

      // online softmax on the fragments, in the exp2 domain: m is a running
      // max of s sl2 (sl2 > 0, so the raw scores' max gives it) and
      // p = exp2(s sl2 - m), one FFMA and one exp2 a score. A row's values
      // lie across the quad of lanes that share g. m moves only when some
      // row of the warp would see p > 2^kLazy: o and l then keep their
      // scale (alpha 1) on most tiles of a long row, which skips the
      // rescale of o, and p stays within [0, 2^kLazy]. While m is -inf, a
      // row's p are exp2(-inf) = 0
      constexpr float kLazy = 8.f;
      float mx[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x = -INFINITY;
#pragma unroll
        for (int i = 0; i < kNt; ++i)
          x = fmaxf(x, fmaxf(s[i][2 * r], s[i][2 * r + 1]));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        mx[r] = x * sl2;
      }
      if (__any_sync(0xffffffffu,
                     mx[0] > m[0] + kLazy || mx[1] > m[1] + kLazy)) {
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(m[r], mx[r]);
          alpha[r] = m_new > -INFINITY ? exp2f(m[r] - m_new) : 1.f;
          l[r] *= alpha[r];
          m[r] = m_new;
        }
#pragma unroll
        for (int i = 0; i < kOt; ++i) {
          o[i][0] *= alpha[0];
          o[i][1] *= alpha[0];
          o[i][2] *= alpha[1];
          o[i][3] *= alpha[1];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_use = m[r] > -INFINITY ? m[r] : 0.f;
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < kNt; ++i)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const float p = exp2f(fmaf(s[i][e], sl2, -m_use));
            s[i][e] = p;
            sum += p;
          }
        l[r] += sum;   // this lane's columns; quad-summed at the end
      }

      // O += P V, P split into bf16 hi + lo, both into the f32 accumulator
#pragma unroll
      for (int kc = 0; kc < KW / 16; ++kc) {
        uint32_t ph[4], pl[4];
        split_bf16(s[2 * kc][0], s[2 * kc][1], ph[0], pl[0]);
        split_bf16(s[2 * kc][2], s[2 * kc][3], ph[1], pl[1]);
        split_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1], ph[2], pl[2]);
        split_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int dn = 0; dn < DH / 16; ++dn) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, v_lds + stage + kc * 16 * kRowBytes +
                                    dn * 32);
          mma_bf16(o[2 * dn], ph, bv[0], bv[1]);
          mma_bf16(o[2 * dn + 1], ph, bv[2], bv[3]);
          mma_bf16(o[2 * dn], pl, bv[0], bv[1]);
          mma_bf16(o[2 * dn + 1], pl, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();   // this stage is free for tile j + kStages
  }
  cp_async_wait<0>();
  __syncthreads();     // with no tile, every thread's q copies have landed

  // the quad's column sums make each row's l
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if constexpr (M::kSplit > 1) {
    // the other key shares hand their (m, l, o) to the first, lane for lane
    // (all hold the same fragment layout), through the now idle ring
    constexpr int kVals = 4 + 4 * kOt;
    float* parts = reinterpret_cast<float*>(ks) + rg * kVals * 32 + lane;
    constexpr int kShareStride = M::kRowWarps * kVals * 32;
    if (kh > 0) {
      float* part = parts + (kh - 1) * kShareStride;
      part[0] = m[0];
      part[32] = m[1];
      part[64] = l[0];
      part[96] = l[1];
#pragma unroll
      for (int i = 0; i < kOt; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[(4 + 4 * i + e) * 32] = o[i][e];
    }
    __syncthreads();
    if (kh == 0) {
#pragma unroll
      for (int sh = 1; sh < M::kSplit; ++sh) {
        const float* part = parts + (sh - 1) * kShareStride;
        float a0[2], a1[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m1 = part[r * 32];
          const float mm = fmaxf(m[r], m1);
          // exp2(-inf) = 0: a share that saw nothing adds nothing
          a0[r] = mm > -INFINITY ? exp2f(m[r] - mm) : 0.f;
          a1[r] = mm > -INFINITY ? exp2f(m1 - mm) : 0.f;
          l[r] = a0[r] * l[r] + a1[r] * part[(2 + r) * 32];
          m[r] = mm;
        }
#pragma unroll
        for (int i = 0; i < kOt; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[i][e] = a0[e >> 1] * o[i][e] +
                      a1[e >> 1] * part[(4 + 4 * i + e) * 32];
      }
    }
  }
  if (kh != 0) return;

  // normalise, stage the warp's 16 output rows in its own q rows, then
  // write them with 16-byte stores
  const float inv[2] = {l[0] > 0.f ? 1.f / l[0] : 0.f,
                        l[1] > 0.f ? 1.f / l[1] : 0.f};
  __syncwarp();
  bf16* os = qs + rg * 16 * SS;
#pragma unroll
  for (int i = 0; i < kOt; ++i) {
    *reinterpret_cast<__nv_bfloat162*>(os + g * SS + i * 8 + 2 * tq) =
        __floats2bfloat162_rn(o[i][0] * inv[0], o[i][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(os + (g + 8) * SS + i * 8 + 2 * tq) =
        __floats2bfloat162_rn(o[i][2] * inv[1], o[i][3] * inv[1]);
  }
  __syncwarp();
  bf16* ob = out + b * st.o[0] + h * st.o[1];
  for (int e = lane; e < 16 * kChunks; e += 32) {
    const int r = e / kChunks;
    const int c = (e - r * kChunks) * 8;
    if (wr0 + r < Sq)
      *reinterpret_cast<uint4*>(ob + (wr0 + r) * st.o[2] + c) =
          *reinterpret_cast<const uint4*>(os + r * SS + c);
  }
}

// ------------------------------------------------------------- kernel ----

template <typename T, int DH>
struct Launch {
  static constexpr bool kMma = std::is_same<T, bf16>::value;
  static constexpr int kThreads = kMma ? Mma<DH>::kThreads : kF32Threads;
  static constexpr int kBlockQ = kMma ? Mma<DH>::kBlockQ : kF32BlockQ;
  static constexpr size_t kSmem = kMma ? Mma<DH>::kSmem : f32_smem_bytes<DH>();
};

template <typename T, int DH>
__global__ void __launch_bounds__(Launch<T, DH>::kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int H, int Hkv, int Sq, int Skv, Strides st,
                           int causal, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (Launch<T, DH>::kMma)
    flash_mma_body<DH>(q, k, v, out, H, Hkv, Sq, Skv, st, causal, window,
                       scale, reinterpret_cast<bf16*>(smem));
  else
    flash_f32_body<DH>(q, k, v, out, H, Hkv, Sq, Skv, st, causal, window,
                       scale, reinterpret_cast<float*>(smem));
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int Hkv, int Sq, int Skv, const Strides& st, int causal,
           int window, float scale, cudaStream_t stream) {
  using L = Launch<T, DH>;
  auto kernel = flash_attention_kernel<T, DH>;
  if (L::kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // query heads fastest, then q tiles latest first: the heaviest tiles of
  // every head start in the first wave
  const dim3 grid(H, (Sq + L::kBlockQ - 1) / L::kBlockQ, B);
  kernel<<<grid, L::kThreads, L::kSmem, stream>>>(
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
      window < 0 || H > 65535 || B > 65535 || (Sq + 63) / 64 > 65535)
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
    return launch_head_dim<bf16>(Dh, q, k, v, out, B, H, Hkv, Sq, Skv, st,
                                 causal, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
