// Tiled dequant GEMM for the sym low-bit formats: int3 in u32 words (10
// codes a word) and in u16 words (5), fp4 in u32 words (8), and int8 planes.
//
// Replaces the Pallas kernels mlc_llm_tpu/ops/pallas/dequant_matmul.py
// _kernel (the generic branch of _dequant_matmul_2d, flat weights) and
// _kernel_stacked_generic (_dequant_matmul_stacked_generic_2d, layer-stacked
// weights read in place): one templated kernel, the layer a pointer offset.
// Same math, same rounding points:
//   word kw holds k = kw * epw + i at bits i * nbit; each weight is rebuilt
//   in bf16 as bf16(value(code) * s) (dequant_matmul.py:396), where value is
//   the raw code for int3, +-2^(e-7) (0 when e == 0, sign ignored) for
//   fp4, and the stored signed byte for int8; then acc += x @ w in f32;
//   int3 adds the folded offset term (none for fp4 and int8):
//     sum_kw bf16(sum_i x[kw * epw + i]) * off[g(kw)],  off = bf16(-max_int * s).
//   The offset is constant within a group, so the kernel adds, per group,
//   T[m, g] = sum over the group's words of bf16(word sum of x) times off in
//   f32 on the CUDA cores beside the tensor-core product, not as a second
//   GEMM.
//
// x is read in place: element k of a row is x[m, k] (the TPU's plane
// transpose x_t is its own plumbing).
//
// Bound on the H100: bytes at decode widths (m <= ~185 at 3.6 bits a weight
// against the ~295 flops/byte ridge), the bf16 tensor-core rate above. This
// first version is simple, not fast:
//   * a 64 x 64 output tile per 128-thread block, four warps of 32 x 32 on
//     nvcuda::wmma bf16 16x16x16 products with f32 accumulators;
//   * the K loop walks 4 groups at a time (160 k for int3, 128 otherwise):
//     the x tile is copied to shared memory with 16-byte loads, the words
//     with 16-byte loads (4 u32, 8 u16 or 16 int8 columns a thread) and
//     dequantized into a bf16 tile;
//   * the ragged m edge and a group count that is not a multiple of 4 are
//     masked (zero rows in, no stores out);
//   * when the m x n tiles give fewer than two blocks per SM (decode widths:
//     m = 1..64 at wo gives 64 blocks), K is split over blockIdx.z into f32
//     parts that a second kernel adds in part order (deterministic).
// Small m keeps this tensor-core path (no CUDA-core branch): the dequantize
// work per weight is the same either way, and at m <= 2 the slice's q3
// format takes the gp3 GEMV. wgmma, TMA and a pipelined ring are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

enum Format { kI3W32 = 0, kI3W16 = 1, kF4W32 = 2, kI8 = 3 };

template <int F>
struct Fmt;
template <>
struct Fmt<kI3W32> {
  using Word = uint32_t;
  static constexpr int kEpw = 10, kBits = 3, kWpg = 4;
  static constexpr bool kFp4 = false, kOffset = true;
};
template <>
struct Fmt<kI3W16> {
  using Word = uint16_t;
  static constexpr int kEpw = 5, kBits = 3, kWpg = 8;
  static constexpr bool kFp4 = false, kOffset = true;
};
template <>
struct Fmt<kF4W32> {
  using Word = uint32_t;
  static constexpr int kEpw = 8, kBits = 4, kWpg = 4;
  static constexpr bool kFp4 = true, kOffset = false;
};
template <>
struct Fmt<kI8> {  // one signed code a byte: no fields, no offset term
  using Word = int8_t;
  static constexpr int kEpw = 1, kWpg = 32;
  static constexpr bool kOffset = false;
};

constexpr int BM = 64, BN = 64, kThreads = 128;
constexpr int kTileGroups = 4;  // groups per K step
constexpr int LDB = BN + 8, LDC = BN + 4;
constexpr int kTargetBlocks = 264;  // two blocks per SM before K is split

__device__ __forceinline__ float rbf(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// the unscaled value of field f of a word (see the header)
template <int F>
__device__ __forceinline__ float field_value(typename Fmt<F>::Word w, int f) {
  using T = Fmt<F>;
  if constexpr (F == kI8) {
    return static_cast<float>(w);
  } else {
    const uint32_t code = (static_cast<uint32_t>(w) >> (f * T::kBits)) & ((1u << T::kBits) - 1);
    if constexpr (T::kFp4) {
      const uint32_t e = code & 7u;
      return e == 0 ? 0.f : __uint_as_float(((code >> 3) << 31) | ((e + 120u) << 23));
    } else {
      return static_cast<float>(code);
    }
  }
}

template <int F>
__global__ void __launch_bounds__(kThreads)
gemm_plane_kernel(const __nv_bfloat16* __restrict__ x, const typename Fmt<F>::Word* __restrict__ w,
                  const __nv_bfloat16* __restrict__ s, float* __restrict__ partial,
                  void* __restrict__ out, int M, int G, int N, int tiles_per_split,
                  int max_int, int out_f32) {
  using T = Fmt<F>;
  using Word = typename T::Word;
  constexpr int GK = T::kEpw * T::kWpg;         // k per group: 40 or 32
  constexpr int BK = kTileGroups * GK;          // k per step: 160 or 128
  constexpr int WR = kTileGroups * T::kWpg;     // word rows per step
  constexpr int LDA = BK + 8;
  constexpr int CPV = 16 / sizeof(Word);        // columns per 16-byte load
  constexpr int kBytes = (BM * LDA + BK * LDB) * 2 + 3 * kTileGroups * BN * 4;
  static_assert(BM * LDA * 2 >= BM * LDC * 4, "the epilogue tile reuses the x tile");
  __shared__ __align__(128) unsigned char smem[kBytes];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);           // [BM][LDA]
  __nv_bfloat16* Bs = As + BM * LDA;                                    // [BK][LDB]
  float* sS = reinterpret_cast<float*>(Bs + BK * LDB);                  // [4][BN] scales
  float* sOff = sS + kTileGroups * BN;                                  // [4][BN] offsets
  float* sT = sOff + kTileGroups * BN;                                  // [BM][4] group x sums
  float* Cs = reinterpret_cast<float*>(smem);                           // [BM][LDC], epilogue

  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int K = G * GK;
  const int tiles = (G + kTileGroups - 1) / kTileGroups;
  const int t_begin = blockIdx.z * tiles_per_split;
  const int t_end = min(tiles, t_begin + tiles_per_split);
  // this thread's outputs of the 64 x 64 tile for the offset term and the
  // epilogue: column tid % 64, rows tid / 64 + 2j
  const int on = tid % BN, orow = tid / BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  float offacc[BM / 2];
#pragma unroll
  for (int j = 0; j < BM / 2; ++j) offacc[j] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK, g0 = t * kTileGroups;
    // x tile: As[r][kk] = x[m0 + r][k0 + kk], 8 bf16 per 16-byte load
    for (int i = tid; i < BM * (BK / 8); i += kThreads) {
      const int r = i / (BK / 8), v = (i % (BK / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M && k0 + v < K)
        val = __ldg(reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + k0 + v));
      *reinterpret_cast<uint4*>(As + r * LDA + v) = val;
    }
    // the step's scales (and offsets) as f32
    for (int i = tid; i < kTileGroups * BN; i += kThreads) {
      const int gi = i / BN, c = i % BN, g = g0 + gi;
      const float sv = g < G ? __bfloat162float(s[(size_t)g * N + n0 + c]) : 0.f;
      sS[i] = sv;
      sOff[i] = rbf(sv * static_cast<float>(-max_int));
    }
    __syncthreads();

    // weight tile: word row wr of the step -> Bs rows wr * epw + f
    for (int i = tid; i < WR * (BN / CPV); i += kThreads) {
      const int wr = i / (BN / CPV), c0 = (i % (BN / CPV)) * CPV;
      const int gi = wr / T::kWpg;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (g0 + gi < G)
        raw = __ldg(reinterpret_cast<const uint4*>(
            w + (size_t)(g0 * T::kWpg + wr) * N + n0 + c0));
      const Word* words = reinterpret_cast<const Word*>(&raw);
#pragma unroll
      for (int f = 0; f < T::kEpw; ++f) {
        __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(Bs + (wr * T::kEpw + f) * LDB + c0);
#pragma unroll
        for (int j = 0; j < CPV; j += 2) {
          const float v0 = field_value<F>(words[j], f) * sS[gi * BN + c0 + j];
          const float v1 = field_value<F>(words[j + 1], f) * sS[gi * BN + c0 + j + 1];
          dst[j / 2] = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    if (T::kOffset) {
      // sT[r][gi] = sum over the group's words of bf16(sum of its epw x)
      for (int i = tid; i < BM * kTileGroups; i += kThreads) {
        const int r = i / kTileGroups, gi = i % kTileGroups;
        const __nv_bfloat16* xr = As + r * LDA + gi * GK;
        float tsum = 0.f;
#pragma unroll
        for (int wd = 0; wd < T::kWpg; ++wd) {
          float ws = 0.f;
#pragma unroll
          for (int e = 0; e < T::kEpw; ++e) ws += __bfloat162float(xr[wd * T::kEpw + e]);
          tsum += rbf(ws);
        }
        sT[i] = tsum;
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * LDA + kk * 16, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + (kk * 16) * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    if (T::kOffset) {
#pragma unroll
      for (int j = 0; j < BM / 2; ++j) {
        const float* tr = sT + (orow + 2 * j) * kTileGroups;
#pragma unroll
        for (int gi = 0; gi < kTileGroups; ++gi) offacc[j] = fmaf(tr[gi], sOff[gi * BN + on], offacc[j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < BM / 2; ++j) {
    const int r = orow + 2 * j;
    if (m0 + r >= M) continue;
    const float v = Cs[r * LDC + on] + offacc[j];
    const size_t o = (size_t)(m0 + r) * N + n0 + on;
    if (partial != nullptr)
      partial[(size_t)blockIdx.z * M * N + o] = v;
    else if (out_f32)
      static_cast<float*>(out)[o] = v;
    else
      static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(v);
  }
}

// out[i] = sum over the S split-K parts, in part order.
__global__ void reduce_kernel(const float* __restrict__ partial, void* __restrict__ out, int S,
                              int MN, int out_f32) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float t = 0.f;
  for (int sl = 0; sl < S; ++sl) t += partial[(size_t)sl * MN + i];
  if (out_f32)
    static_cast<float*>(out)[i] = t;
  else
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(t);
}

int tiles_per_split(int G, int splits) {
  const int tiles = (G + kTileGroups - 1) / kTileGroups;
  return (tiles + splits - 1) / splits;
}

template <int F>
void launch(const void* x, const void* w, const void* s, float* partial, void* out, int M,
            int G, int N, int splits, int max_int, int out_f32, cudaStream_t st) {
  dim3 grid(N / BN, (M + BM - 1) / BM, splits);
  gemm_plane_kernel<F><<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const typename Fmt<F>::Word*>(w),
      static_cast<const __nv_bfloat16*>(s), partial, out, M, G, N, tiles_per_split(G, splits),
      max_int, out_f32);
}

}  // namespace

// Number of split-K parts for an M x N output over G groups: 1 when the
// output tiles alone give two blocks per SM. The caller sizes the f32
// scratch [S, M, N] when S > 1.
extern "C" int mlc_gemm_plane_splits(int M, int G, int N) {
  const int blocks = (N / BN) * ((M + BM - 1) / BM);
  const int tiles = (G + kTileGroups - 1) / kTileGroups;
  if (blocks >= kTargetBlocks || tiles <= 1) return 1;
  int splits = (kTargetBlocks + blocks - 1) / blocks;
  if (splits > tiles) splits = tiles;
  const int per = (tiles + splits - 1) / splits;
  return (tiles + per - 1) / per;  // no empty part
}

// fmt: enum Format. x [M, K] bf16 with K = G * (k per group), 16-byte
// aligned rows; w words [G * words per group, N] (int8: [K, N]), a layer's
// block; s [G, N] bf16; partial f32 [splits, M, N] when splits > 1, else
// null; out [M, N] in bf16 (out_f32 = 0) or f32. Needs N % 64 == 0.
// Returns cudaGetLastError() after the launches.
extern "C" int mlc_gemm_plane(int fmt, const void* x, const void* w, const void* s,
                              void* partial, void* out, int M, int G, int N, int splits,
                              int max_int, int out_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = splits > 1 ? static_cast<float*>(partial) : nullptr;
  if (splits > 1 && part == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  switch (fmt) {
    case kI3W32: launch<kI3W32>(x, w, s, part, out, M, G, N, splits, max_int, out_f32, st); break;
    case kI3W16: launch<kI3W16>(x, w, s, part, out, M, G, N, splits, max_int, out_f32, st); break;
    case kF4W32: launch<kF4W32>(x, w, s, part, out, M, G, N, splits, max_int, out_f32, st); break;
    case kI8: launch<kI8>(x, w, s, part, out, M, G, N, splits, max_int, out_f32, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (part != nullptr) {
    const int MN = M * N, threads = 256;
    reduce_kernel<<<(MN + threads - 1) / threads, threads, 0, st>>>(part, out, splits, MN, out_f32);
  }
  return static_cast<int>(cudaGetLastError());
}
