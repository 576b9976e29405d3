// Tiled int4 dequant GEMM for the quarter-split ("qsplit") layout.
//
// Replaces the Pallas kernel mlc_llm_tpu/ops/pallas/dequant_matmul.py
// _kernel_pairs_qs (under _dequant_matmul_stacked_2d and the int4 branch of
// _dequant_matmul_2d): the prefill path, 8 < m <= 2048. Same math, same
// rounding points: each weight is rebuilt in the compute type T as
//   w = (16 + q) * s + (z - 16 * s)        (asym)
//   w = (16 + q) * s + s * -(16 + max_int) (sym)
// with every product and sum rounded to T as the TPU kernel's ops in T,
// then acc += x @ w in f32 on the tensor cores.
//
// Layout: word row r, bits 16h + 4f hold element f*(K/4) + 2r + h; 16 word
// rows make one group per field f, group index f*(G/4) + r/16. K is the
// stored (group-padded) K; x is padded to it by the caller.
//
// Bound on the H100: at prefill widths the work is above the bf16 ridge
// (2*m*K*N flops against 0.625*K*N weight bytes: m >= ~185 rows is compute
// bound), so the bound is the tensor-core rate. This first version is
// simple, not fast:
//   * a 64 x 64 output tile per 128-thread block, four warps of 32 x 32;
//   * the K loop walks one chunk at a time (16 word rows = 4 fields x 32 k;
//     half a chunk in f32): the step's four x quarter slices are copied to
//     shared memory with 16-byte loads, its words are dequantized into a
//     128 x 64 tile (64 x 64 in f32), and the tile feeds the tensor cores;
//   * the ragged m edge is masked (zero rows in, no stores out).
// Compute type T (x, s, z; every rounding above is to T): bf16 and f16 run
// nvcuda::wmma 16x16x16 with f32 accumulators, f32 runs 3xTF32 wmma
// m16n16k8 (int4_common.cuh). The output is T or f32. The bf16
// instantiation is the kernel measured before the other types were added.
// wgmma, TMA and a pipelined shared-memory ring are later work.

#include <type_traits>

#include "int4_common.cuh"

namespace {

using namespace nvcuda;
using int4k::Num;
using int4k::rnd;
using int4k::Tile;

constexpr int BM = 64, BN = 64, LDC = BN + 4;
constexpr int kThreads = 128;
// blocks per SM the register budget must allow: bf16 keeps the six (80
// registers) it had before the compute type became a template parameter;
// left free, nvcc took 96 and the 704 blocks of Vicuna's w_in at m = 128
// ran in two waves instead of one (0.608 vs 0.368 ms, H100). f16 and f32
// keep the four and three blocks (124 and 166 registers) nvcc picks
// unbounded; a bound of one block let f32 take 220 (0.71 vs 0.45 ms)
template <typename T>
constexpr int kMinBlocks = std::is_same<T, __nv_bfloat16>::value ? 6
                           : std::is_same<T, __half>::value      ? 4
                                                                 : 3;

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
gemm_qs_kernel(const T* __restrict__ x, const int32_t* __restrict__ w, const T* __restrict__ s,
               const T* __restrict__ z, void* __restrict__ out, int M, int K, int N, int sym,
               int out_f32) {
  constexpr int BK = Tile<T>::BK;  // k per step: 128 (one chunk), 64 in f32
  constexpr int RW = BK / 8;       // word rows per step
  constexpr int FK = BK / 4;       // k of each field per step
  constexpr int LDA = BK + Tile<T>::PAD, LDB = BN + Tile<T>::PAD;
  constexpr int VEC = 16 / sizeof(T);  // x elements per 16-byte load
  constexpr int kSmemBytes = (BM * LDA + BK * LDB) * static_cast<int>(sizeof(T));
  static_assert(BM * LDA * sizeof(T) >= BM * LDC * 4, "the epilogue tile reuses the x tile");
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  T* As = reinterpret_cast<T*>(smem);            // [BM][LDA]
  T* Bs = As + BM * LDA;                         // [BK][LDB]
  float* Cs = reinterpret_cast<float*>(smem);    // [BM][LDC], epilogue

  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int C = K / 128, KQ = K / 4, steps = K / BK;

  typename Tile<T>::Acc acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int t = 0; t < steps; ++t) {
    // A: As[r][f*FK + j] = x[m0 + r][f*KQ + FK*t + j], 16-byte loads
    for (int i = tid; i < BM * (BK / VEC); i += kThreads) {
      const int r = i / (BK / VEC), v = (i % (BK / VEC)) * VEC, f = v / FK, j = v % FK;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M)
        val = __ldg(reinterpret_cast<const uint4*>(
            x + (size_t)(m0 + r) * K + f * KQ + FK * t + j));
      *reinterpret_cast<uint4*>(As + r * LDA + v) = val;
    }
    // B: word (RW*t + rr, n) -> Bs[f*FK + 2*rr + h][n - n0] for f, h
    for (int i = tid; i < RW * BN; i += kThreads) {
      const int rr = i / BN, cc = i % BN, n = n0 + cc;
      const int32_t word = __ldg(w + (size_t)(RW * t + rr) * N + n);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const size_t gi = (size_t)(f * C + (FK * t + 2 * rr) / 32) * N + n;
        const float sf = Num<T>::to_f(s[gi]);
        const float off = sym ? rnd<T>(sf * -23.f)  // -(16 + max_int) * s
                              : rnd<T>(Num<T>::to_f(z[gi]) - rnd<T>(sf * 16.f));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = (word >> (16 * h + 4 * f)) & 0xF;
          Bs[(f * FK + 2 * rr + h) * LDB + cc] = Num<T>::from_f(rnd<T>((16.f + q) * sf) + off);
        }
      }
    }
    __syncthreads();
    Tile<T>::step(acc, As, LDA, Bs, LDB, wm, wn);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * BN; i += kThreads) {
    const int r = i / BN, cc = i % BN;
    if (m0 + r >= M) continue;
    int4k::store_out<T>(out, (size_t)(m0 + r) * N + n0 + cc, Cs[r * LDC + cc], out_f32);
  }
}

template <typename T>
void launch(const void* x, const void* w, const void* s, const void* z, void* out, int M,
            int K, int N, int sym, int out_f32, cudaStream_t st) {
  dim3 grid(N / BN, (M + BM - 1) / BM);
  gemm_qs_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(w), static_cast<const T*>(s),
      static_cast<const T*>(z), out, M, K, N, sym, out_f32);
}

}  // namespace

// dtype: int4k::DType of x, s and z. x [M, K] (16-byte aligned rows); w
// int32 words [K/8, N] (a layer's block); s, z [K/32, N] (z unused when
// sym); out [M, N] in the compute type (out_f32 = 0) or f32. Needs
// K % 128 == 0, N % 64 == 0. Returns cudaGetLastError() after the launch.
extern "C" int mlc_gemm_qs(int dtype, const void* x, const void* w, const void* s,
                           const void* z, void* out, int M, int K, int N, int sym, int out_f32,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case int4k::kBF16: launch<__nv_bfloat16>(x, w, s, z, out, M, K, N, sym, out_f32, st); break;
    case int4k::kF16: launch<__half>(x, w, s, z, out, M, K, N, sym, out_f32, st); break;
    case int4k::kF32: launch<float>(x, w, s, z, out, M, K, N, sym, out_f32, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
