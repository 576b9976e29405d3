// Group-partial int4 dequant GEMV for the quarter-split ("qsplit") layout.
//
// Replaces the Pallas kernel mlc_llm_tpu/ops/pallas/dequant_matmul.py
// _dequant_matmul_gp_2d -> _kernel_gp with _gp_body_qs (the decode path,
// m <= 8). Same math, same rounding points:
//   per group g:  P = sum_k x[k] * (16 + q[k])   (f32; products exact)
//                 sx = sum_k x[k]                 (f32 sum, rounded to the
//                                                  compute type as the TPU
//                                                  kernel's sum in that type)
//   y += s * (P - 16*sx) + z * sx                 (asym, f32 scales)
//   y += s * (P - (16 + max_int)*sx)              (sym)
//
// Layout: word row r, bits 16h + 4f hold element f*(K/4) + 2r + h; 16 word
// rows make one group per field f, group index f*(G/4) + r/16. K is the
// stored (group-padded) K; x is padded to it by the caller.
//
// Bound on the H100: weight bytes (0.625 bytes per weight for q4 asym bf16),
// about 2 flops per byte, far below the ~295 flops/byte ridge. The design
// therefore only has to stream the words at full width:
//   * a block covers 64 columns x 8 chunks (a chunk = 16 word rows = 128 k);
//     each warp owns one chunk and each lane two columns, so every row load
//     is a coalesced 256-byte warp transaction along the contiguous N axis;
//   * a lane issues its 16 row loads before any arithmetic (16 loads in
//     flight per thread);
//   * K is split over blockIdx.y so even wo (N = 4096) launches 256 blocks
//     across the 132 SMs; the split-K partials go to an f32 scratch and a
//     second small kernel sums them in a fixed order (deterministic);
//   * the block's slice of x is staged once in shared memory as f32, and the
//     per-group sum of x is one warp shuffle reduction (lane = element).
//
// Compute type T (x, s, z) is bf16, f16 or f32 (the q4bf16, q4f16 and
// qsplit f32 weights); sx is rounded to T (not at all in f32) and the
// output is T or f32. The bf16 instantiation is the kernel measured before
// the other types were added.

#include "int4_common.cuh"

namespace {

using int4k::Num;
using int4k::rnd;

constexpr int kWarps = 8;      // chunks per block, one per warp
constexpr int kCols = 64;      // columns per block, two per lane
constexpr int kRows = 16;      // word rows per chunk

template <typename T, int M>
__global__ void __launch_bounds__(kWarps * 32)
gemv_qs_kernel(const T* __restrict__ x, const int32_t* __restrict__ w, const T* __restrict__ s,
               const T* __restrict__ z, float* __restrict__ partial, int K, int N, int sym) {
  // x slice [M][4 fields][kWarps chunks][32]; reused for the warp reduction
  __shared__ float smem[M * 4 * kWarps * 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int C = K / 128;  // chunks == groups per field quarter
  const int KQ = K / 4;
  const int c0 = blockIdx.y * kWarps;
  const int col = blockIdx.x * kCols + 2 * lane;

  for (int i = threadIdx.x; i < M * 4 * kWarps * 32; i += blockDim.x) {
    const int e = i % 32, cl = (i / 32) % kWarps;
    const int f = (i / (32 * kWarps)) % 4, m = i / (32 * kWarps * 4);
    const int c = c0 + cl;
    smem[i] = c < C ? Num<T>::to_f(x[(size_t)m * K + f * KQ + 32 * c + e]) : 0.f;
  }
  __syncthreads();

  float acc[M][2];
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m][0] = acc[m][1] = 0.f;

  const int c = c0 + warp;
  if (c < C) {
    int2 wv[kRows];
    const int32_t* wp = w + (size_t)(kRows * c) * N + col;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      wv[r] = __ldg(reinterpret_cast<const int2*>(wp + (size_t)r * N));

#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int g = f * C + c;
      const float2 s2 = Num<T>::load2(s + (size_t)g * N + col);
      const float s0 = s2.x, s1 = s2.y;
      float z0 = 0.f, z1 = 0.f;
      if (!sym) {
        const float2 z2 = Num<T>::load2(z + (size_t)g * N + col);
        z0 = z2.x;
        z1 = z2.y;
      }
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float* xs = smem + ((m * 4 + f) * kWarps + warp) * 32;
        float sx = xs[lane];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sx += __shfl_xor_sync(0xffffffffu, sx, o);
        sx = rnd<T>(sx);
        float p0 = 0.f, p1 = 0.f;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float xa = xs[2 * r], xb = xs[2 * r + 1];
          const int lo = 4 * f, hi = 16 + 4 * f;
          p0 = fmaf(xa, 16.f + ((wv[r].x >> lo) & 0xF), p0);
          p0 = fmaf(xb, 16.f + ((wv[r].x >> hi) & 0xF), p0);
          p1 = fmaf(xa, 16.f + ((wv[r].y >> lo) & 0xF), p1);
          p1 = fmaf(xb, 16.f + ((wv[r].y >> hi) & 0xF), p1);
        }
        if (sym) {
          acc[m][0] += s0 * (p0 - 23.f * sx);  // 16 + max_int
          acc[m][1] += s1 * (p1 - 23.f * sx);
        } else {
          acc[m][0] += s0 * (p0 - 16.f * sx) + z0 * sx;
          acc[m][1] += s1 * (p1 - 16.f * sx) + z1 * sx;
        }
      }
    }
  }
  __syncthreads();  // the x slice is dead; reuse smem for the reduction

#pragma unroll
  for (int m = 0; m < M; ++m) {
    smem[(warp * M + m) * kCols + 2 * lane] = acc[m][0];
    smem[(warp * M + m) * kCols + 2 * lane + 1] = acc[m][1];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < M * kCols; i += blockDim.x) {
    const int m = i / kCols, cc = i % kCols;
    float t = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) t += smem[(wi * M + m) * kCols + cc];
    partial[((size_t)blockIdx.y * M + m) * N + blockIdx.x * kCols + cc] = t;
  }
}

template <typename T, int M>
void launch(const void* x, const void* w, const void* s, const void* z, void* partial,
            int K, int N, int sym, cudaStream_t st) {
  const int C = K / 128;
  dim3 grid(N / kCols, (C + kWarps - 1) / kWarps);
  gemv_qs_kernel<T, M><<<grid, kWarps * 32, 0, st>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(w), static_cast<const T*>(s),
      static_cast<const T*>(z), static_cast<float*>(partial), K, N, sym);
}

template <typename T>
int launch_m(const void* x, const void* w, const void* s, const void* z, void* partial,
             int M, int K, int N, int sym, cudaStream_t st) {
  switch (M) {
    case 1: launch<T, 1>(x, w, s, z, partial, K, N, sym, st); break;
    case 2: launch<T, 2>(x, w, s, z, partial, K, N, sym, st); break;
    case 3: launch<T, 3>(x, w, s, z, partial, K, N, sym, st); break;
    case 4: launch<T, 4>(x, w, s, z, partial, K, N, sym, st); break;
    case 5: launch<T, 5>(x, w, s, z, partial, K, N, sym, st); break;
    case 6: launch<T, 6>(x, w, s, z, partial, K, N, sym, st); break;
    case 7: launch<T, 7>(x, w, s, z, partial, K, N, sym, st); break;
    case 8: launch<T, 8>(x, w, s, z, partial, K, N, sym, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// Number of split-K slices: the caller sizes the f32 scratch [S, M, N].
extern "C" int mlc_gemv_qs_splits(int K) { return (K / 128 + kWarps - 1) / kWarps; }

// dtype: int4k::DType of x, s and z. x [M, K]; w int32 words [K/8, N] (a
// layer's block); s, z [K/32, N] (z unused when sym); partial f32
// [splits, M, N]; out [M, N] in the compute type (out_f32 = 0) or f32.
// Needs 1 <= M <= 8, K % 128 == 0, N % 64 == 0.
// Returns cudaGetLastError() after the launches.
extern "C" int mlc_gemv_qs(int dtype, const void* x, const void* w, const void* s,
                           const void* z, void* partial, void* out, int M, int K, int N,
                           int sym, int out_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* part = static_cast<const float*>(partial);
  const int MN = M * N, S = mlc_gemv_qs_splits(K);
  int err;
  switch (dtype) {
    case int4k::kBF16:
      err = launch_m<__nv_bfloat16>(x, w, s, z, partial, M, K, N, sym, st);
      if (!err) int4k::launch_reduce<__nv_bfloat16>(part, out, S, MN, out_f32, st);
      break;
    case int4k::kF16:
      err = launch_m<__half>(x, w, s, z, partial, M, K, N, sym, st);
      if (!err) int4k::launch_reduce<__half>(part, out, S, MN, out_f32, st);
      break;
    case int4k::kF32:
      err = launch_m<float>(x, w, s, z, partial, M, K, N, sym, st);
      if (!err) int4k::launch_reduce<float>(part, out, S, MN, out_f32, st);
      break;
    default: err = static_cast<int>(cudaErrorInvalidValue);
  }
  return err ? err : static_cast<int>(cudaGetLastError());
}
