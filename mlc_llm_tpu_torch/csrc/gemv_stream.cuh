// The weight-streaming mainloop of the m = 1 decode GEMVs: the qsplit
// body of kernel 1 (dequant_gemv_qs.cu, also f32 at m <= 8), its pair and
// hsplit bodies (dequant_gemv_gp.cu) and kernel 6, int3 in u16 words at m
// <= 2 (dequant_gemv_gp3.cu). Each source adds a format policy.
//
// Replaces the Pallas kernels mlc_llm_tpu/ops/pallas/dequant_matmul.py
// _dequant_matmul_gp_2d (_kernel_gp with _gp_body_qs, _gp_body and
// _gp_body_hs) at m = 1 and _dequant_matmul_gp3_2d (_gp3_body).
//
// Bound on the H100: the weight bytes (words, scales and minima), about
// two flops a byte, far below the ~295 flops/byte ridge: a GEMV is as fast
// as it streams its words. What kept the SIMT bodies before this one under
// half of that (PERF.md):
//   * an int-to-float conversion per code (16 a clock an SM on sm_90,
//     against 128 FMAs): here a code becomes a float by bit assembly, one
//     shift and one lop3 (16 + q and 8 + q are the f32s with bits 0x41800000
//     | q << 19 and 0x41000000 | q << 20; a raw q is 0x4B000000 | q less
//     2^23), then one FMA;
//   * short-lived blocks whose loads waited behind their x staging and
//     whose reduction was a second launch.
//
// The design:
//   * a block owns kCols = 256 output columns and a contiguous range of
//     `per` K stages (its split-K part); a stage is kRows = 16 word rows,
//     whole groups in every format (int4: 128 k, four groups; int3/u16: 80
//     k, two groups);
//   * one producer warp keeps P::kStages stages in flight in a shared-memory
//     ring: a stage's 16 word rows, its scale rows and minima rows are
//     cp.async.bulk copies (one per row of the column tile; no tensor map,
//     so the host encodes nothing per call) that complete on the slot's
//     `full` mbarrier; the 128 consumer threads release a slot through its
//     `empty` mbarrier. No load waits behind a barrier of the consumers;
//   * the producer first copies the part's slice of x (the policy's few
//     contiguous chunks) with cp.async.bulk, on the same latency as the
//     ring's first stages; the consumers stage it once as f32 in the
//     policy's order (kXRow = 8 values a word row and token, so a row's x
//     is two broadcast float4 reads), then sums each group of x once (sx,
//     rounded where the TPU body rounds it), the warps in turn: once per
//     block and group, not per column or stage (summing a stage's groups
//     in every warp cost the int3 GEMV up to a fifth of its instructions);
//   * a consumer thread owns kColsPerThread = 2 neighbouring columns
//     (four consumer warps a block; one column a thread, eight warps, ran
//     the int3 GEMV at m = 2 up to 1.4x slower): one shared-memory read of
//     its words per word row,
//     every code of the row into f32 partials P per group and column
//     (products exact, f32 sums in k order), then the group's fold with
//     its f32 scales;
//   * one launch a call: a part writes an f32 [M, 256] partial, then takes
//     its column tile's ticket (one thread, an atomic add with release and
//     acquire semantics, behind a barrier of the consumers); the
//     last part to arrive sums the partials in part order (deterministic)
//     into T or f32 and puts the ticket back to 0. The tickets are one
//     zeroed int32 buffer a device, cached by the caller; each launch
//     leaves it zero. One part writes the output directly.
// The plan (parts, stages a part; 256 columns a block) is Python's
// (ops/dequant_matmul.py stream_plan), from shapes only.

#pragma once

#include <atomic>
#include <cstdint>

#include "dequant_wgmma.cuh"
#include "int4_common.cuh"

namespace gs {

using int4k::Num;
using int4k::rnd;

constexpr int kCols = 256;                          // output columns a block
constexpr int kColsPerThread = 2;                   // a consumer thread's columns
constexpr int kConsumers = kCols / kColsPerThread;  // four consumer warps
constexpr int kThreads = kConsumers + 32;           // and one producer warp
constexpr int kRows = 16;                  // word rows a stage
constexpr int kXRow = 8;                   // staged x values a word row and token
constexpr int kMaxPer = 16;                // stages a part (the staged x slice)

struct Params {
  const void* x;         // [M, K] in the compute type
  const uint8_t* w;      // words [rows, N] (the layer's block)
  const uint8_t* s;      // scales [G, N], compute type
  const uint8_t* z;      // minima [G, N], null when sym
  float* partial;        // [parts, M, N] f32 when parts > 1
  int* tickets;          // [ceil(N / kCols)] int32, zero, when parts > 1
  void* out;             // [M, N], compute type or f32
  int K, N, G;           // stored K, columns, groups
  int steps, per, parts;  // stages in K, stages a part, parts
  int out_f32;
};

// (a & mask) | c in one lop3 (written out: ptxas spends two on the two
// immediates of `(a & mask) | c`)
__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t mask, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(d) : "r"(a), "r"(mask), "r"(c));
  return d;
}

// 16 + q as f32 (exact), q the nibble at bit `pos` of w: one shift, one lop3
__device__ __forceinline__ float code16(uint32_t w, int pos) {
  const uint32_t t = pos <= 19 ? (w << (19 - pos)) : (w >> (pos - 19));
  return __uint_as_float(and_or(t, 0x00780000u, 0x41800000u));
}

// q as f32 (exact), q the nibble at bit `pos`: 2^23 + q less 2^23
__device__ __forceinline__ float code_raw(uint32_t w, int pos) {
  return __fsub_rn(__uint_as_float(and_or(w >> pos, 0xFu, 0x4B000000u)), 8388608.f);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(wg::smem_addr(dst)), "l"(src), "r"(bytes), "r"(wg::smem_addr(bar))
      : "memory");
}

// atomicAdd(ticket, 1) with release and acquire semantics at GPU scope
__device__ __forceinline__ int ticket_acq_rel(int* ticket) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(ticket)
               : "memory");
  return old;
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

constexpr int C = kColsPerThread;

// a consumer thread's C 4-byte words of a word row
__device__ __forceinline__ void load_words(const uint8_t* row, int c, uint32_t (&w)[C]) {
  if constexpr (C == 1) {
    w[0] = reinterpret_cast<const uint32_t*>(row)[c];
  } else {
    const uint2 v = reinterpret_cast<const uint2*>(row)[c];
    w[0] = v.x;
    w[1] = v.y;
  }
}

// a consumer thread's C values of a scale or minima row, as f32
template <typename T>
__device__ __forceinline__ void load_cols(const T* row, int c, float (&v)[C]) {
  if constexpr (C == 2) {
    const float2 f = Num<T>::load2(row + 2 * c);
    v[0] = f.x;
    v[1] = f.y;
  } else {
    v[0] = Num<T>::to_f(row[c]);
  }
}

// a consumer thread's C outputs, T or f32
template <typename T>
__device__ __forceinline__ void store_cols(void* out, size_t o, const float (&v)[C],
                                           int out_f32) {
  if (out_f32 || std::is_same<T, float>::value) {
    float* d = static_cast<float*>(out) + o;
    if constexpr (C == 2) *reinterpret_cast<float2*>(d) = make_float2(v[0], v[1]);
    else *d = v[0];
  } else if constexpr (C == 2) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
      *reinterpret_cast<__nv_bfloat162*>(static_cast<T*>(out) + o) =
          __floats2bfloat162_rn(v[0], v[1]);
    else if constexpr (std::is_same<T, __half>::value)
      *reinterpret_cast<__half2*>(static_cast<T*>(out) + o) = __floats2half2_rn(v[0], v[1]);
  } else {
    static_cast<T*>(out)[o] = Num<T>::from_f(v[0]);
  }
}

// Shared memory: the ring, the part's x slice as it arrives
// ([M][kChunks][n * P::kStageX / kChunks] in T), the staged x
// [kMaxPer][kRows][M][kXRow] and the group sums [kMaxPer][kGroups][M], f32
template <class P, int M>
struct Smem {
  static constexpr int kRing = P::kStages * P::kStageBytes;
  static constexpr int kRaw = (kMaxPer * P::kStageX * M * sizeof(typename P::T) + 127) / 128 * 128;
  static constexpr int kX = kMaxPer * kRows * M * kXRow * 4;
  static constexpr int kBytes = kRing + kRaw + kX + kMaxPer * P::kGroups * M * 4;
};

// P: the format policy.
//   using T;                    the compute type (x, scales, minima)
//   kWordBytes                  4 (int4 in u32) or 2 (int3 in u16)
//   kGroups                     groups a stage
//   kStages                     the ring's depth
//   kScaleOffset, kStageBytes   a slot: words [kRows][kCols], then scales
//                               and minima [kGroups][kCols] each
//   kStageX, kChunks            x elements a stage, and the contiguous
//                               chunks of x a part's stages read
//   scale_row(t, j, G)          the scale row of stage t's group j
//   chunk_k(c, t0, K)           the first k of chunk c of the part from
//                               stage t0 (n * kStageX / kChunks elements)
//   raw_index(i, rr, e, n)      where staged value e of word row rr of the
//                               part's stage i lies in the token's x
//                               slice, or -1 (a zero pad)
//   group_sum(xst, j, m, lane)  group j's sum of x for token m from the
//                               stage's staged x, rounded as the TPU body
//                               rounds it, on every lane (a whole warp
//                               calls it)
//   consume<M>(st, xst, sx, acc, asym, c)  the stage: the columns C c ..
//                               C c + C - 1, sx[j * M + m] the group sums
template <class P, int M>
__global__ void __launch_bounds__(kThreads) stream_kernel(const Params p) {
  using T = typename P::T;
  constexpr int R = P::kStages;
  using L = Smem<P, M>;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[R], empty[R], xbar;
  __shared__ int last;
  const T* xraw = reinterpret_cast<const T*>(smem + L::kRing);
  float* xs = reinterpret_cast<float*>(smem + L::kRing + L::kRaw);
  float* sxs = reinterpret_cast<float*>(smem + L::kRing + L::kRaw + L::kX);

  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * kCols;
  const int ncols = min(kCols, p.N - col0);
  const int t0 = blockIdx.y * p.per;
  const int n = min(p.steps - t0, p.per);
  const int slice = n * P::kStageX;  // a token's x elements
  const bool asym = p.z != nullptr;
  if (tid == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      wg::mbar_init(&full[r], 1);
      wg::mbar_init(&empty[r], kConsumers);
    }
    wg::mbar_init(&xbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // the producer warp: one thread issues the x slice, then keeps the
    // ring full
    if (tid == kConsumers) {
      const int len = slice / P::kChunks;
      wg::mbar_expect_tx(&xbar, M * slice * sizeof(T));
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int c = 0; c < P::kChunks; ++c)
          bulk_load(smem + L::kRing + (m * slice + c * len) * sizeof(T),
                    static_cast<const T*>(p.x) + static_cast<size_t>(m) * p.K +
                        P::chunk_k(c, t0, p.K),
                    len * sizeof(T), &xbar);
      const uint32_t wrow = ncols * P::kWordBytes, srow = ncols * sizeof(T);
      const uint32_t tx = kRows * wrow + (asym ? 2 : 1) * P::kGroups * srow;
      for (int i = 0; i < n; ++i) {
        const int slot = i % R, t = t0 + i;
        if (i >= R) wg::mbar_wait(&empty[slot], ((i / R) - 1) & 1);
        uint8_t* st = smem + slot * P::kStageBytes;
        wg::mbar_expect_tx(&full[slot], tx);
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr)
          bulk_load(st + rr * kCols * P::kWordBytes,
                    p.w + (static_cast<size_t>(kRows * t + rr) * p.N + col0) * P::kWordBytes,
                    wrow, &full[slot]);
#pragma unroll
        for (int j = 0; j < P::kGroups; ++j) {
          const size_t o = (static_cast<size_t>(P::scale_row(t, j, p.G)) * p.N + col0) * sizeof(T);
          uint8_t* ss = st + P::kScaleOffset + j * kCols * sizeof(T);
          bulk_load(ss, p.s + o, srow, &full[slot]);
          if (asym) bulk_load(ss + P::kGroups * kCols * sizeof(T), p.z + o, srow, &full[slot]);
        }
      }
    }
    return;
  }

  // the part's x slice, staged once as f32 in the policy's order, then
  // each group's sum of x once, the four warps in turn (the ring fills
  // meanwhile)
  wg::mbar_wait(&xbar, 0);
  for (int idx = tid; idx < n * kRows * M * kXRow; idx += kConsumers) {
    const int e = idx % kXRow, m = (idx / kXRow) % M;
    const int rr = (idx / (kXRow * M)) % kRows, i = idx / (kXRow * M * kRows);
    const int r = P::raw_index(i, rr, e, n);
    xs[idx] = r >= 0 ? Num<T>::to_f(xraw[m * slice + r]) : 0.f;
  }
  consumers_sync();
  const int lane = tid % 32;
#pragma unroll 4
  for (int idx = tid / 32; idx < n * P::kGroups * M; idx += kConsumers / 32) {
    const int m = idx % M, j = (idx / M) % P::kGroups, i = idx / (M * P::kGroups);
    const float v = P::group_sum(xs + i * kRows * M * kXRow, j, m, M, lane);
    if (lane == 0) sxs[idx] = v;
  }
  consumers_sync();

  float acc[M][C];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int cc = 0; cc < C; ++cc) acc[m][cc] = 0.f;
  for (int i = 0; i < n; ++i) {
    const int slot = i % R;
    wg::mbar_wait(&full[slot], (i / R) & 1);
    P::template consume<M>(smem + slot * P::kStageBytes, xs + i * kRows * M * kXRow,
                           sxs + i * P::kGroups * M, acc, asym, tid);
    wg::mbar_arrive(&empty[slot]);
  }

  const int col = col0 + C * tid;
  const bool mine = C * tid < ncols;
  if (p.parts == 1) {
    if (mine) {
#pragma unroll
      for (int m = 0; m < M; ++m)
        store_cols<T>(p.out, static_cast<size_t>(m) * p.N + col, acc[m], p.out_f32);
    }
    return;
  }
  // split K: this part's partial, then the tile's ticket; the last part
  // sums all partials in part order
  if (mine) {
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int cc = 0; cc < C; ++cc)
        p.partial[(static_cast<size_t>(blockIdx.y) * M + m) * p.N + col + cc] = acc[m][cc];
  }
  consumers_sync();
  // one thread takes the ticket after the barrier: its release publishes
  // every consumer's partial, its acquire (and the barrier) orders the
  // last part's reads of the others'
  if (tid == 0) last = ticket_acq_rel(&p.tickets[blockIdx.x]) == p.parts - 1;
  consumers_sync();
  if (!last) return;
  if (mine) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      float v[C];
#pragma unroll
      for (int cc = 0; cc < C; ++cc) v[cc] = 0.f;
      // kBatch parts' loads in flight at a time (a latency each batch),
      // added in part order
      constexpr int kBatch = 8;
      for (int s0 = 0; s0 < p.parts; s0 += kBatch) {
        float u[kBatch][C];
#pragma unroll
        for (int b = 0; b < kBatch; ++b)
#pragma unroll
          for (int cc = 0; cc < C; ++cc)
            u[b][cc] = s0 + b < p.parts ? __ldcg(p.partial + (static_cast<size_t>(s0 + b) * M + m) * p.N +
                                                 col + cc)
                                        : 0.f;
#pragma unroll
        for (int b = 0; b < kBatch; ++b)
#pragma unroll
          for (int cc = 0; cc < C; ++cc)
            if (s0 + b < p.parts) v[cc] += u[b][cc];
      }
      store_cols<T>(p.out, static_cast<size_t>(m) * p.N + col, v, p.out_f32);
    }
  }
  if (tid == 0) p.tickets[blockIdx.x] = 0;
}

// A plan the kernel takes: every part non-empty and within kMaxPer
// stages, the parts covering the K stages exactly once, scratch present
// when split.
inline bool plan_ok(const Params& p) {
  return p.steps >= 1 && p.per >= 1 && p.per <= kMaxPer && p.parts >= 1 &&
         (p.parts - 1) * p.per < p.steps && p.parts * p.per >= p.steps && p.N >= 2 &&
         (p.parts == 1 || (p.partial != nullptr && p.tickets != nullptr));
}

// A streaming body: the format policy P at M tokens, the tag a source's
// dispatch hands to launch and blocks_per_sm.
template <class P, int M>
struct Body {};

// Let stream_kernel<P, M> take its dynamic shared memory: once a device,
// not on every launch.
template <class P, int M>
cudaError_t allow_smem() {
  static std::atomic<uint64_t> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = uint64_t{1} << (dev & 63);
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(stream_kernel<P, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Smem<P, M>::kBytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

// Launch stream_kernel<P, M> over (ceil(N / kCols), parts) blocks.
template <class P, int M>
cudaError_t launch(Body<P, M>, const Params& p, cudaStream_t st) {
  if (!plan_ok(p)) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<P, M>();
  if (err != cudaSuccess) return err;
  dim3 grid((p.N + kCols - 1) / kCols, p.parts);
  stream_kernel<P, M><<<grid, kThreads, Smem<P, M>::kBytes, st>>>(p);
  return cudaGetLastError();
}

// The blocks of stream_kernel<P, M> an SM holds (its shared memory,
// registers and threads bound them) into *n: the count the Python plan
// takes from STREAM_BLOCKS.
template <class P, int M>
cudaError_t blocks_per_sm(Body<P, M>, int* n) {
  cudaError_t err = allow_smem<P, M>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, stream_kernel<P, M>, kThreads,
                                                       Smem<P, M>::kBytes);
}

}  // namespace gs
