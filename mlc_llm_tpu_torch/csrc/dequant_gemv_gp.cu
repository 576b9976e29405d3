// Group-partial int4 dequant GEMV for the "pair" and "hsplit" bit orders.
//
// Replaces the Pallas kernel mlc_llm_tpu/ops/pallas/dequant_matmul.py
// _dequant_matmul_gp_2d -> _kernel_gp with the pair body _gp_body (fed by
// _band_store and _u32_halves_bf16) and the hsplit body _gp_body_hs (fed by
// _band_store_hs): the decode path, m <= 8, of the q4*_pair, q4*_sym, q4f32
// and q4*_hs presets. Same math, same rounding points, over the raw codes:
//   per group g:  P = sum_k x[k] * q[k]           (f32; products exact but f32 x)
//                 sx = sum_k x[k]                 (see below)
//   y += s * P + z * sx                           (asym, f32 scales)
//   y += s * (P - max_int * sx)                   (sym)
// sx follows the TPU bodies' band rows, summed in f32 and rounded to the
// compute type T like a jnp.sum in T:
//   pair:   a band row is one parity of one group, so the 16 even and the
//           16 odd elements are summed apart, each rounded to T, and the two
//           added in T (lane pairs of one warp reduction give both sums);
//   hsplit: a band row is one whole group: one sum, rounded once.
// In f32 nothing rounds.
//
// Orders (K is the stored, group-padded K; x is padded to it by the caller):
//   pair:   word r holds k = 8r .. 8r+7, nibble i at bits 4i; 4 word rows
//           make one group (g = r/4);
//   hsplit: byte b of word r holds k = 4r+b (low nibble, group r/8 of the
//           low half) and K/2 + 4r+b (high nibble, group G/2 + r/8).
// The TPU's banding, its even/odd deinterleave and its u32 lane-pair bitcast
// exist to feed the MXU; here each lane reads x from shared memory in place.
//
// Bound on the H100: weight bytes (0.56 bytes per weight for q4f16_hs
// words, scales and minima; 0.75 with f32 scales), about 2 flops per byte,
// far below the ridge. The design is dequant_gemv_qs.cu's stream:
//   * a block covers 64 columns x 4 chunks (a chunk = 16 word rows = 128 k);
//     each warp owns one chunk and each lane two columns, so every row load
//     is a coalesced 256-byte warp transaction along the contiguous N axis;
//   * a lane issues its 16 row loads before any arithmetic (16 loads in
//     flight per thread);
//   * K is split over blockIdx.y, four chunks a block (half the qsplit
//     kernel's eight, so that the 3B width's wo, N = 2560 at K = 3072, still
//     launches 240 blocks over the 132 SMs); the split-K partials go to an
//     f32 scratch and a second small kernel sums them in a fixed order;
//   * the block's slice of x is staged once in shared memory as f32 (pair:
//     128 consecutive k a chunk; hsplit: 64 of each half);
//   * the row count is a template parameter M in {1, 2, 4, 8} (the decode
//     batches); other m run the next M with zero rows, which keeps the
//     build to 24 instantiations.
// Compute type T (x, s, z) is bf16, f16 or f32; the output is T or f32.

#include "int4_common.cuh"

namespace {

using int4k::Num;
using int4k::rnd;

enum Layout { kPair = 0, kHsplit = 1 };

constexpr int kWarps = 4;      // chunks per block, one per warp
constexpr int kCols = 64;      // columns per block, two per lane
constexpr int kRows = 16;      // word rows per chunk
constexpr int kChunkK = 128;   // k per chunk
constexpr int kMaxInt = 7;     // int4 sym: codes q - 7

template <int L, typename T, int M>
__global__ void __launch_bounds__(kWarps * 32)
gemv_gp_kernel(const T* __restrict__ x, const int32_t* __restrict__ w, const T* __restrict__ s,
               const T* __restrict__ z, float* __restrict__ partial, int rows, int K, int N,
               int sym) {
  // x slice [M][kWarps chunks][128] (zero past the `rows` real rows);
  // reused for the warp reduction
  __shared__ float smem[M * kWarps * kChunkK];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int C = K / kChunkK;
  const int KH = K / 2, G = K / 32;
  const int c0 = blockIdx.y * kWarps;
  const int col = blockIdx.x * kCols + 2 * lane;

  for (int i = threadIdx.x; i < M * kWarps * kChunkK; i += blockDim.x) {
    const int e = i % kChunkK, cl = (i / kChunkK) % kWarps, m = i / (kChunkK * kWarps);
    const int c = c0 + cl;
    // pair: k = 128c + e; hsplit: e < 64 the low half's 64c + e, else the
    // high half's
    const int k = L == kPair ? kChunkK * c + e : (e < 64 ? 64 * c + e : KH + 64 * c + e - 64);
    smem[i] = c < C && m < rows ? Num<T>::to_f(x[(size_t)m * K + k]) : 0.f;
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

    // four groups a chunk: pair j -> word rows 4j..4j+3; hsplit j < 2 ->
    // the low nibbles of rows 8j..8j+7, j >= 2 -> the high nibbles of rows
    // 8(j-2)..8(j-2)+7
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int g = L == kPair ? 4 * c + j : (j < 2 ? 2 * c + j : G / 2 + 2 * c + j - 2);
      const float2 s2 = Num<T>::load2(s + (size_t)g * N + col);
      float2 z2 = make_float2(0.f, 0.f);
      if (!sym) z2 = Num<T>::load2(z + (size_t)g * N + col);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        // the group's 32 x values start at xs[0]
        const float* xs = smem + (m * kWarps + warp) * kChunkK + 32 * j;
        float v = xs[lane];
        float sx;
        if (L == kPair) {
          // offsets 16..2 keep the parity: lane 0 ends with the even sum,
          // lane 1 with the odd one
#pragma unroll
          for (int o = 16; o > 1; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
          const float even = rnd<T>(__shfl_sync(0xffffffffu, v, 0));
          const float odd = rnd<T>(__shfl_sync(0xffffffffu, v, 1));
          sx = rnd<T>(even + odd);
        } else {
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
          sx = rnd<T>(v);
        }
        float p0 = 0.f, p1 = 0.f;
        if (L == kPair) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int wx = wv[4 * j + r].x, wy = wv[4 * j + r].y;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float xa = xs[8 * r + i];
              p0 = fmaf(xa, static_cast<float>((wx >> (4 * i)) & 0xF), p0);
              p1 = fmaf(xa, static_cast<float>((wy >> (4 * i)) & 0xF), p1);
            }
          }
        } else {
          const int rb = 8 * (j & 1), sh = j < 2 ? 0 : 4;
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const int wx = wv[rb + r].x, wy = wv[rb + r].y;
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const float xa = xs[4 * r + b];
              p0 = fmaf(xa, static_cast<float>((wx >> (8 * b + sh)) & 0xF), p0);
              p1 = fmaf(xa, static_cast<float>((wy >> (8 * b + sh)) & 0xF), p1);
            }
          }
        }
        if (sym) {
          acc[m][0] += s2.x * (p0 - static_cast<float>(kMaxInt) * sx);
          acc[m][1] += s2.y * (p1 - static_cast<float>(kMaxInt) * sx);
        } else {
          acc[m][0] += s2.x * p0 + z2.x * sx;
          acc[m][1] += s2.y * p1 + z2.y * sx;
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
  for (int i = threadIdx.x; i < rows * kCols; i += blockDim.x) {
    const int m = i / kCols, cc = i % kCols;
    float t = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) t += smem[(wi * M + m) * kCols + cc];
    partial[((size_t)blockIdx.y * rows + m) * N + blockIdx.x * kCols + cc] = t;
  }
}

template <int L, typename T, int M>
void launch(const void* x, const void* w, const void* s, const void* z, void* partial,
            int rows, int K, int N, int sym, cudaStream_t st) {
  const int C = K / kChunkK;
  dim3 grid(N / kCols, (C + kWarps - 1) / kWarps);
  gemv_gp_kernel<L, T, M><<<grid, kWarps * 32, 0, st>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(w), static_cast<const T*>(s),
      static_cast<const T*>(z), static_cast<float*>(partial), rows, K, N, sym);
}

template <int L, typename T>
int launch_m(const void* x, const void* w, const void* s, const void* z, void* partial,
             int M, int K, int N, int sym, cudaStream_t st) {
  if (M < 1 || M > 8) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 1)
    launch<L, T, 1>(x, w, s, z, partial, M, K, N, sym, st);
  else if (M == 2)
    launch<L, T, 2>(x, w, s, z, partial, M, K, N, sym, st);
  else if (M <= 4)
    launch<L, T, 4>(x, w, s, z, partial, M, K, N, sym, st);
  else
    launch<L, T, 8>(x, w, s, z, partial, M, K, N, sym, st);
  return 0;
}

template <typename T>
int launch_t(int layout, const void* x, const void* w, const void* s, const void* z,
             void* partial, void* out, int M, int K, int N, int sym, int out_f32, int S,
             cudaStream_t st) {
  int err;
  if (layout == kPair)
    err = launch_m<kPair, T>(x, w, s, z, partial, M, K, N, sym, st);
  else if (layout == kHsplit)
    err = launch_m<kHsplit, T>(x, w, s, z, partial, M, K, N, sym, st);
  else
    err = static_cast<int>(cudaErrorInvalidValue);
  if (!err) int4k::launch_reduce<T>(static_cast<const float*>(partial), out, S, M * N, out_f32, st);
  return err;
}

}  // namespace

// Number of split-K slices: the caller sizes the f32 scratch [S, M, N].
extern "C" int mlc_gemv_gp_splits(int K) {
  return (K / kChunkK + kWarps - 1) / kWarps;
}

// layout: 0 pair, 1 hsplit; dtype: int4k::DType of x, s and z. x [M, K];
// w int32 words [K/8, N] (a layer's block); s, z [K/32, N] (z unused when
// sym); partial f32 [splits, M, N]; out [M, N] in the compute type
// (out_f32 = 0) or f32. Needs 1 <= M <= 8, K % 128 == 0, N % 64 == 0.
// Returns cudaGetLastError() after the launches.
extern "C" int mlc_gemv_gp(int layout, int dtype, const void* x, const void* w, const void* s,
                           const void* z, void* partial, void* out, int M, int K, int N,
                           int sym, int out_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int S = mlc_gemv_gp_splits(K);
  int err;
  switch (dtype) {
    case int4k::kBF16:
      err = launch_t<__nv_bfloat16>(layout, x, w, s, z, partial, out, M, K, N, sym, out_f32, S, st);
      break;
    case int4k::kF16:
      err = launch_t<__half>(layout, x, w, s, z, partial, out, M, K, N, sym, out_f32, S, st);
      break;
    case int4k::kF32:
      err = launch_t<float>(layout, x, w, s, z, partial, out, M, K, N, sym, out_f32, S, st);
      break;
    default: err = static_cast<int>(cudaErrorInvalidValue);
  }
  return err ? err : static_cast<int>(cudaGetLastError());
}
