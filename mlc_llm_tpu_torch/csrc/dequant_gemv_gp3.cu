// Group-partial int3 dequant GEMV for u16 words (q3*_s16: sym, group 40).
//
// Replaces the Pallas kernel mlc_llm_tpu/ops/pallas/dequant_matmul.py
// _dequant_matmul_gp3_2d -> _kernel_gp3 / _kernel_gp3_stacked with _gp3_body
// (every decode matmul at m <= 2 when the group count divides by 16). Same
// math, same rounding points:
//   u16 word r of a column holds k = 5r + i at bits 3i (i < 5); a group is
//   8 words = 40 k (the natural order: the TPU's plane transpose and
//   block-diagonal banding only feed its matrix unit);
//   per group g:  P  = sum_k x[k] * (8 + q[k])                 (f32)
//                 sx = sum_i bf16(sum_r x[5r + i])  (each field's 8-element
//                      sum rounded to bf16, as the TPU's bf16 row sums)
//   y += s * (P - (8 + max_int) * sx)                          (f32 scales)
//
// Bound on the H100: bytes. A weight is 3.2 bits of word plus 0.4 bits of
// bf16 scale, ~1.3 flops per byte, far below the ~295 flops/byte ridge
// (Vicuna-7B w_in, 51.9 MB stored: 15.5 us at 3.35 TB/s). The design streams
// the words at full width and keeps the per-code work at three instructions:
//   * a thread owns 8 neighbouring columns, so every word row is one 16-byte
//     load and a warp reads 512 contiguous bytes of it;
//   * a warp owns one group (8 rows) and issues its 8 row loads before any
//     arithmetic; 8 warps per block cover 8 groups, so K is split over
//     blockIdx.y at group boundaries (K = 11008 pads to 288 groups: 36 parts);
//     w_in launches 88 x 16 blocks and even wo 16 x 16 across the 132 SMs;
//   * 8 + q is assembled as f32 bits, 0x41000000 | q << 20 (exact; one shift
//     and one mask per code, no int-to-float convert), then one FMA;
//   * the block's x slice (8 groups x 40 x M) and its sx values are staged
//     once in shared memory as f32;
//   * the 8 warps' sums are added in shared memory in warp order and the K
//     parts by a second small kernel in part order: deterministic, no atomics.
// u16 words arrive as int16 tensors holding the same bits; they are read as
// unsigned words, so no shift sign-extends.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                // groups per block, one per warp
constexpr int kColsPerLane = 8;          // one 16-byte load of u16 words
constexpr int kCols = 32 * kColsPerLane; // 256 columns per block
constexpr int kRows = 8;                 // u16 word rows per group
constexpr int kFields = 5;               // codes per u16 word
constexpr int kGroupK = kRows * kFields; // 40
constexpr float kOffset = 11.f;          // 8 + max_int (int3 sym: 3)

// field at bit `sh` of a 32-bit pair of u16 words, moved to f32 mantissa
// bits 20..22 (its value 8 + q once 0x41000000 is or-ed in)
__device__ __forceinline__ float code_plus_8(uint32_t w, int sh) {
  const uint32_t t = (sh <= 20 ? (w << (20 - sh)) : (w >> (sh - 20))) & 0x00700000u;
  return __uint_as_float(0x41000000u | t);
}

template <int M>
__global__ void __launch_bounds__(kWarps * 32)
gemv_gp3_kernel(const __nv_bfloat16* __restrict__ x, const uint16_t* __restrict__ w,
                const __nv_bfloat16* __restrict__ s, float* __restrict__ partial,
                int G, int N) {
  __shared__ float xs[M][kWarps * kGroupK];
  __shared__ float sxs[M][kWarps];
  __shared__ float red[kWarps][M][kCols];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int K = G * kGroupK;
  const int g0 = blockIdx.y * kWarps;

  for (int i = threadIdx.x; i < M * kWarps * kGroupK; i += blockDim.x) {
    const int m = i / (kWarps * kGroupK), e = i % (kWarps * kGroupK);
    const int k = g0 * kGroupK + e;
    xs[m][e] = k < K ? __bfloat162float(x[(size_t)m * K + k]) : 0.f;
  }
  __syncthreads();
  if (threadIdx.x < M * kWarps) {
    const int m = threadIdx.x / kWarps, gl = threadIdx.x % kWarps;
    const float* xg = &xs[m][gl * kGroupK];
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kFields; ++i) {
      float f = 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) f += xg[kFields * r + i];
      t += __bfloat162float(__float2bfloat16(f));
    }
    sxs[m][gl] = t;
  }
  __syncthreads();

  const int col = blockIdx.x * kCols + lane * kColsPerLane;
  const int g = g0 + warp;
  float acc[M][kColsPerLane];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) acc[m][c] = 0.f;

  if (g < G && col < N) {
    uint4 wv[kRows];
    const uint16_t* wp = w + (size_t)g * kRows * N + col;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      wv[r] = __ldg(reinterpret_cast<const uint4*>(wp + (size_t)r * N));
    const float* xg = &xs[0][warp * kGroupK];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const uint32_t wd[4] = {wv[r].x, wv[r].y, wv[r].z, wv[r].w};
#pragma unroll
      for (int i = 0; i < kFields; ++i) {
        float xv[M];
#pragma unroll
        for (int m = 0; m < M; ++m) xv[m] = xg[m * kWarps * kGroupK + kFields * r + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // column 2j in the low halfword, 2j + 1 in the high one
          const float lo = code_plus_8(wd[j], 3 * i);
          const float hi = code_plus_8(wd[j], 16 + 3 * i);
#pragma unroll
          for (int m = 0; m < M; ++m) {
            acc[m][2 * j] = fmaf(xv[m], lo, acc[m][2 * j]);
            acc[m][2 * j + 1] = fmaf(xv[m], hi, acc[m][2 * j + 1]);
          }
        }
      }
    }
    const uint4 sv = __ldg(reinterpret_cast<const uint4*>(s + (size_t)g * N + col));
    const __nv_bfloat162* s2 = reinterpret_cast<const __nv_bfloat162*>(&sv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float s0 = __low2float(s2[j]), s1 = __high2float(s2[j]);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float off = kOffset * sxs[m][warp];
        acc[m][2 * j] = s0 * (acc[m][2 * j] - off);
        acc[m][2 * j + 1] = s1 * (acc[m][2 * j + 1] - off);
      }
    }
  }

#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) red[warp][m][lane * kColsPerLane + c] = acc[m][c];
  __syncthreads();
  for (int i = threadIdx.x; i < M * kCols; i += blockDim.x) {
    const int m = i / kCols, cc = i % kCols;
    const int n = blockIdx.x * kCols + cc;
    if (n >= N) continue;
    float t = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) t += red[wi][m][cc];
    partial[((size_t)blockIdx.y * M + m) * N + n] = t;
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// out[i] = sum over the S split-K parts, in part order.
template <typename T>
__global__ void reduce_kernel(const float* __restrict__ partial, T* __restrict__ out,
                              int S, int MN) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float t = 0.f;
  for (int sl = 0; sl < S; ++sl) t += partial[(size_t)sl * MN + i];
  out[i] = from_float<T>(t);
}

template <int M>
void launch(const void* x, const void* w, const void* s, void* partial, int G, int N,
            cudaStream_t st) {
  dim3 grid((N + kCols - 1) / kCols, (G + kWarps - 1) / kWarps);
  gemv_gp3_kernel<M><<<grid, kWarps * 32, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint16_t*>(w),
      static_cast<const __nv_bfloat16*>(s), static_cast<float*>(partial), G, N);
}

}  // namespace

// Number of split-K parts: the caller sizes the f32 scratch [S, M, N].
extern "C" int mlc_gemv_gp3_splits(int G) { return (G + kWarps - 1) / kWarps; }

// x [M, 40G] bf16; w u16 words [8G, N] (a layer's block); s [G, N] bf16;
// partial f32 [splits, M, N]; out [M, N] in bf16 (out_f32 = 0) or f32.
// Needs 1 <= M <= 2, G % 8 == 0, N % 8 == 0, 16-byte aligned w and s rows.
// Returns cudaGetLastError() after the launches.
extern "C" int mlc_gemv_gp3(const void* x, const void* w, const void* s, void* partial,
                            void* out, int M, int G, int N, int out_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (M) {
    case 1: launch<1>(x, w, s, partial, G, N, st); break;
    case 2: launch<2>(x, w, s, partial, G, N, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const int MN = M * N, S = mlc_gemv_gp3_splits(G);
  const int threads = 256, blocks = (MN + threads - 1) / threads;
  if (out_f32)
    reduce_kernel<float><<<blocks, threads, 0, st>>>(
        static_cast<const float*>(partial), static_cast<float*>(out), S, MN);
  else
    reduce_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        static_cast<const float*>(partial), static_cast<__nv_bfloat16*>(out), S, MN);
  return static_cast<int>(cudaGetLastError());
}
