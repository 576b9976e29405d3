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
// output is T or f32. This SIMT body runs m = 1 (bf16, f16, f32) and f32
// at every m.
//
// bf16 and f16 at 2 <= m <= 8 run on the tensor cores (GpPolicy, a policy
// of the wgmma mainloop of dequant_wgmma.cuh, m tile 16). The SIMT body
// redoes the nibble extract, the int->float conversion of 16 + q and an
// fmaf for every weight and every row: ~40 instructions a weight at m = 8,
// bound by instructions, not bytes. On the tensor cores the tokens are
// wgmma's N = 16 operand:
//   * A = the exact codes 16 + q as T x 2 bits (the qsplit bit assembly of
//     _qs_planes_bf16, wg::field16: two instructions a register, no
//     multiply), B = x;
//   * a stage is 16 word rows = one whole group of each quarter (32 k, two
//     k16 steps); each quarter's two MMAs run into a fresh f32 fragment,
//     so the fragment is the group partial P = sum x * (16 + q);
//   * fold() sums x over each group (token, quarter) from the stage's x
//     tiles (256 threads, 8 elements each, two shuffles), rounds it to T
//     (sx), and adds s * (P - 16 sx) + z * sx (sym: s * (P - 23 sx)) with
//     the stage's f32 scales to the running sum on the CUDA cores;
//   * split K, the m tile and the epilogue are the mainloop's (the plan
//     from ops/dequant_matmul.py gemm_tiles at GEMV_STAGE_K = 128).

#include "dequant_wgmma.cuh"
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

// the SIMT body: bf16 and f16 at m = 1 only (above it they run GpPolicy)
template <typename T>
int launch_m(const void* x, const void* w, const void* s, const void* z, void* partial,
             int M, int K, int N, int sym, cudaStream_t st) {
  if constexpr (!std::is_same<T, float>::value) {
    if (M != 1) return static_cast<int>(cudaErrorInvalidValue);
    launch<T, 1>(x, w, s, z, partial, K, N, sym, st);
    return 0;
  } else {
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
}

// ---- bf16 and f16 at 2 <= m <= 8: the tensor-core body ----

template <typename TT>
struct GpPolicy {
  using T = TT;
  static constexpr int kSteps = 8, kTiles = 8, kARegs = 4;  // step 2f + h: quarter f, half h
  static constexpr int kParts = 4;                          // one group partial a quarter
  static constexpr int kMaxMT = 16;
  static constexpr int kRows = 16;  // one group of each quarter
  static constexpr int kWBytes = kRows * wg::kBN * 4;
  static constexpr int kSBytes = 2 * 4 * wg::kBN * sizeof(T);  // scales, minima: [4][128]

  // maps: x [M][K] (box [16][16], 32-byte swizzle); words [K/8][N] (box
  // [16][128]); scales and minima [4][G/4][N] (box [4][1][128])
  static __device__ __forceinline__ void load(const wg::Maps& mp, uint8_t* x, uint8_t* w,
                                              uint8_t* s, uint64_t* bar, int t, int m0, int n0,
                                              int MT, const wg::Params& p) {
    const int kq = p.K / 4;
#pragma unroll
    for (int k = 0; k < kSteps; ++k)
      wg::tma_load_2d(x + k * MT * wg::kTileRow, &mp.x, bar,
                      (k / 2) * kq + 32 * t + 16 * (k % 2), m0);
    wg::tma_load_2d(w, &mp.w, bar, n0, kRows * t);
    wg::tma_load_3d(s, &mp.s, bar, n0, t, 0);
    wg::tma_load_3d(s + 4 * wg::kBN * sizeof(T), &mp.z, bar, n0, t, 0);
  }

  // step 2f + h: k 16h .. 16h + 15 of quarter f's group, word rows 8h .. 8h
  // + 7; positions 2c, 2c + 1 are word row 8h + c, 2c + 8, 2c + 9 row 8h +
  // 4 + c; a[.][r]: channel ch + 8 (r % 2), row 8h + c + 4 (r / 2)
  static __device__ __forceinline__ void dequant(uint32_t (&a)[kSteps][4], const uint8_t* wt,
                                                 const uint8_t*, int ch, int c,
                                                 const wg::Params&) {
    const uint32_t* W = reinterpret_cast<const uint32_t*>(wt);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint32_t w = W[(8 * h + c + 4 * (r / 2)) * wg::kBN + ch + 8 * (r % 2)];
#pragma unroll
        for (int f = 0; f < 4; ++f) a[2 * f + h][r] = wg::field16<T>(w, f);
      }
  }

  template <int MT>
  static __device__ __forceinline__ void issue(float (&d)[kParts][MT / 2],
                                               const uint32_t (&a)[kSteps][4],
                                               const uint8_t* x) {
#pragma unroll
    for (int k = 0; k < kSteps; ++k)
      wg::Wgmma<MT, T>::mma(d[k / 2], a[k], wg::desc_sw32(x + k * MT * wg::kTileRow), k % 2);
  }

  template <int MT>
  static __device__ __forceinline__ void fold(float (&acc)[MT / 2], float (&d)[kParts][MT / 2],
                                              const uint8_t* x, const uint8_t*,
                                              const uint8_t* st, int ch, int c, int i,
                                              const wg::Params& p) {
    static_assert(MT == kMaxMT, "the x sums cover a 16-token tile");
    __shared__ float sxs[2][4][16];  // [stage parity][quarter][token]
    const int tid = threadIdx.x;
    {
      // thread: (quarter f, token) = tid / 4, the 8 elements of step 2f +
      // tid % 4 / 2, 16-byte half tid % 2 (the swizzle moves the halves, and
      // the four lanes cover both of both steps)
      const int q = tid / 4, f = q / 16, tok = q % 16;
      const uint4 v = *reinterpret_cast<const uint4*>(
          x + (2 * f + (tid % 4) / 2) * MT * wg::kTileRow + tok * wg::kTileRow + 16 * (tid % 2));
      const uint32_t u[4] = {v.x, v.y, v.z, v.w};
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const typename wg::Vec2<T>::V e = wg::from_bits<typename wg::Vec2<T>::V>(u[j]);
        sum += wg::Vec2<T>::to_f(e.x) + wg::Vec2<T>::to_f(e.y);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (tid % 4 == 0) sxs[i & 1][f][tok] = wg::Vec2<T>::rnd(sum);
    }
    asm volatile("bar.sync 1, 256;" ::: "memory");
    const T* S = reinterpret_cast<const T*>(st);
    const T* Z = S + 4 * wg::kBN;
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      float s[2], z[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s[h] = wg::Vec2<T>::to_f(S[f * wg::kBN + ch + 8 * h]);
        z[h] = p.sym ? 0.f : wg::Vec2<T>::to_f(Z[f * wg::kBN + ch + 8 * h]);
      }
      const float base = p.sym ? 23.f : 16.f;  // 16 + max_int when sym
#pragma unroll
      for (int e = 0; e < MT / 2; ++e) {
        // d[4j + {0,1}] = (channel ch, token 8j + 2c + {0,1}); + {2,3}: ch + 8
        const int tok = 8 * (e / 4) + 2 * c + e % 2, h = (e % 4) / 2;
        const float sx = sxs[i & 1][f][tok];
        acc[e] += s[h] * (d[f][e] - base * sx) + z[h] * sx;
      }
    }
  }
};

template <typename T>
cudaError_t launch_tc(const void* x, const void* w, const void* s, const void* z, float* partial,
                      void* out, int M, int K, int N, int sym, int out_f32, int splits, int per,
                      cudaStream_t st) {
  const CUtensorMapDataType xt =
      std::is_same<T, __nv_bfloat16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const int G = K / 32, steps = K / 128;
  if ((splits - 1) * per >= steps || splits * per < steps) return cudaErrorInvalidValue;
  const size_t es = sizeof(T);
  wg::Maps maps;
  bool ok = wg::map_2d(&maps.x, xt, x, K, M, K * es, 16, 16, CU_TENSOR_MAP_SWIZZLE_32B) &&
            wg::map_2d(&maps.w, CU_TENSOR_MAP_DATA_TYPE_UINT32, w, N, K / 8, N * 4ull, wg::kBN,
                       GpPolicy<T>::kRows) &&
            wg::map_3d(&maps.s, CU_TENSOR_MAP_DATA_TYPE_UINT16, s, N, G / 4, 4, N * es,
                       G / 4 * N * es, wg::kBN, 1, 4) &&
            wg::map_3d(&maps.z, CU_TENSOR_MAP_DATA_TYPE_UINT16, sym ? s : z, N, G / 4, 4,
                       N * es, G / 4 * N * es, wg::kBN, 1, 4);
  if (!ok) return cudaErrorInvalidValue;
  wg::Params p{M, N, K, steps, per, sym, 7, out_f32, partial, out};
  cudaError_t err = wg::launch<GpPolicy<T>, 16>(maps, p, splits, st);
  if (err == cudaSuccess && partial != nullptr)
    int4k::launch_reduce<T>(partial, out, splits, M * N, out_f32, st);
  return err;
}

}  // namespace

// Number of split-K slices of the SIMT body: the caller sizes the f32
// scratch [S, M, N].
extern "C" int mlc_gemv_qs_splits(int K) { return (K / 128 + kWarps - 1) / kWarps; }

// dtype: int4k::DType of x, s and z. x [M, K]; w int32 words [K/8, N] (a
// layer's block); s, z [K/32, N] (z unused when sym); partial f32
// [splits, M, N]; out [M, N] in the compute type (out_f32 = 0) or f32.
// The SIMT body: M = 1, or f32 at 1 <= M <= 8. Needs K % 128 == 0, N % 64
// == 0. Returns cudaGetLastError() after the launches.
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

// The tensor-core body: bf16/f16 (dtype) at 2 <= M <= 8; the arguments of
// mlc_gemv_qs, with `splits` split-K parts of `per` stages (128 k a stage)
// and partial f32 [splits, M, N] when splits > 1 (else null). Needs K %
// 128 == 0, N % 128 == 0 and 16-byte aligned bases (TMA). Returns
// cudaGetLastError() after the launches (cudaErrorInvalidValue for a
// refused tensor map or plan).
extern "C" int mlc_gemv_qs_tc(int dtype, const void* x, const void* w, const void* s,
                              const void* z, void* partial, void* out, int M, int K, int N,
                              int sym, int out_f32, int splits, int per, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = splits > 1 ? static_cast<float*>(partial) : nullptr;
  if (M < 2 || M > 8 || splits < 1 || per < 1 || (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (dtype) {
    case int4k::kBF16:
      err = launch_tc<__nv_bfloat16>(x, w, s, z, part, out, M, K, N, sym, out_f32, splits, per, st);
      break;
    case int4k::kF16:
      err = launch_tc<__half>(x, w, s, z, part, out, M, K, N, sym, out_f32, splits, per, st);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
