// Tiled int4 dequant GEMM for the quarter-split ("qsplit") layout.
//
// Replaces the Pallas kernel mlc_llm_tpu/ops/pallas/dequant_matmul.py
// _kernel_pairs_qs (under _dequant_matmul_stacked_2d and the int4 branch of
// _dequant_matmul_2d): the prefill path, 8 < m <= 2048. Same math, same
// rounding points: each weight is rebuilt in the compute type T as
//   w = T(T((16 + q) * s) + T(z - T(16 * s)))   (asym)
//   w = T(T((16 + q) * s) + T(s * -(16 + max_int)))   (sym)
// then acc += x @ w in f32 on the tensor cores.
//
// Layout: word row r, bits 16h + 4f hold element f*(K/4) + 2r + h; 16 word
// rows make one group per field (quarter) f, group index f*(G/4) + r/16.
// K is the stored (group-padded) K; x is padded to it by the caller.
//
// Bound on the H100: at prefill widths the work is above the bf16 ridge
// (2*m*K*N flops against 0.625*K*N weight bytes: m >= ~185 rows is compute
// bound), so the bound is the tensor-core rate.
//
// bf16 and f16 run the Hopper mainloop of dequant_wgmma.cuh: wgmma with
// the weight as the register A operand (128 channels a block), x as B in
// shared memory (MT tokens), a TMA ring. One stage is 8 word rows: the
// four quarters' k16 steps of x (four TMA boxes of [MT][16], one per
// quarter: the TPU kernel's four activation quarters as lane slices), the
// 8 x 128 word tile, and the stage's scale and minimum rows (one group of
// each quarter; a [4][128] box each). A thread (channels ch, ch+8; k group
// c) reads word rows c and c+4 of its two channels: one word holds the k
// pair (2c, 2c+1) of all four quarters, so four words feed the stage's
// four k16 steps. Field f becomes one bf16x2 register of the exact values
// 16 + q of k and k+1 by the TPU's bit assembly (_qs_planes_bf16:
// (w >> s & 0x00780078) | 0x41804180; f16: 0x03C003C0 | 0x4C004C00), then
// one __hmul2_rn by the group's scale pair and one __hadd2_rn of its offset
// pair: the two roundings of the TPU body, never contracted into an fma.
// The m tile, the split-K parts and the stages per part come from the
// Python wrapper (ops/dequant_matmul.py gemm_tiles).
//
// f32 keeps the first design (3xTF32 nvcuda::wmma on a 64 x 64 tile, one
// unpipelined stage, int4_common.cuh): it serves only parity checks.

#include <type_traits>

#include "dequant_wgmma.cuh"
#include "int4_common.cuh"

namespace {

using namespace nvcuda;

constexpr int kSymOffset = -23;  // sym: -(16 + max_int), max_int = 7

// ---- bf16 and f16: the wgmma mainloop ----

template <typename TT>
struct QsPolicy {
  using T = TT;
  using V = typename wg::Vec2<T>::V;
  static constexpr int kSteps = 4;                            // one k16 step per quarter
  static constexpr int kTiles = kSteps, kARegs = 4, kParts = 0;
  static constexpr int kMaxMT = 256;
  static constexpr int kRows = 8;                             // word rows a stage
  static constexpr int kWBytes = kRows * wg::kBN * 4;         // [8][128] u32
  static constexpr int kSBytes = 2 * 4 * wg::kBN * sizeof(T); // scales, minima: [4][128] each

  // maps: x [M][K] (box [MT][16], 32-byte swizzle); words [K/8][N] (box
  // [8][128]); scales and minima [4][G/4][N] (box [4][1][128])
  static __device__ __forceinline__ void load(const wg::Maps& mp, uint8_t* x, uint8_t* w,
                                              uint8_t* s, uint64_t* bar, int t, int m0, int n0,
                                              int MT, const wg::Params& p) {
    const int kq = p.K / 4;
#pragma unroll
    for (int f = 0; f < 4; ++f)
      wg::tma_load_2d(x + f * MT * wg::kTileRow, &mp.x, bar, f * kq + 16 * t, m0);
    wg::tma_load_2d(w, &mp.w, bar, n0, kRows * t);
    wg::tma_load_3d(s, &mp.s, bar, n0, t / 2, 0);  // group r / 16 of every quarter
    wg::tma_load_3d(s + 4 * wg::kBN * sizeof(T), &mp.z, bar, n0, t / 2, 0);
  }

  static __device__ __forceinline__ void dequant(uint32_t (&a)[kSteps][4], const uint8_t* wt,
                                                 const uint8_t* st, int ch, int c,
                                                 const wg::Params& p) {
    const uint32_t* W = reinterpret_cast<const uint32_t*>(wt);
    const T* S = reinterpret_cast<const T*>(st);
    const T* Z = S + 4 * wg::kBN;
    // a[.][0]: (ch, k 2c), [1]: (ch+8, k 2c), [2]: (ch, k 2c+8), [3]: (ch+8, k 2c+8)
    const uint32_t w[4] = {W[c * wg::kBN + ch], W[c * wg::kBN + ch + 8],
                           W[(c + 4) * wg::kBN + ch], W[(c + 4) * wg::kBN + ch + 8]};
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      V sc[2], off[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = f * wg::kBN + ch + 8 * h;
        const float sf = wg::Vec2<T>::to_f(S[i]);
        sc[h] = wg::Vec2<T>::dup(sf);
        off[h] = wg::Vec2<T>::dup(p.sym ? sf * static_cast<float>(kSymOffset)
                                    : wg::Vec2<T>::to_f(Z[i]) - wg::Vec2<T>::rnd(sf * 16.f));
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const V v = wg::from_bits<V>(wg::field16<T>(w[r], f));
        a[f][r] = wg::bits(__hadd2_rn(__hmul2_rn(v, sc[r % 2]), off[r % 2]));
      }
    }
  }
};

template <typename T>
cudaError_t launch_wgmma(const void* x, const void* w, const void* s, const void* z,
                         float* partial, void* out, int M, int K, int N, int sym, int out_f32,
                         int mt, int splits, int per, cudaStream_t st) {
  const CUtensorMapDataType xt =
      std::is_same<T, __nv_bfloat16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const int G = K / 32;
  const size_t es = sizeof(T);
  wg::Maps maps;
  bool ok = wg::map_2d(&maps.x, xt, x, K, M, K * es, 16, mt, CU_TENSOR_MAP_SWIZZLE_32B) &&
            wg::map_2d(&maps.w, CU_TENSOR_MAP_DATA_TYPE_UINT32, w, N, K / 8, N * 4ull, wg::kBN,
                       QsPolicy<T>::kRows) &&
            wg::map_3d(&maps.s, CU_TENSOR_MAP_DATA_TYPE_UINT16, s, N, G / 4, 4, N * es,
                       G / 4 * N * es, wg::kBN, 1, 4) &&
            wg::map_3d(&maps.z, CU_TENSOR_MAP_DATA_TYPE_UINT16, sym ? s : z, N, G / 4, 4,
                       N * es, G / 4 * N * es, wg::kBN, 1, 4);
  if (!ok) return cudaErrorInvalidValue;
  wg::Params p{M, N, K, K / 64, per, sym, 7, out_f32, partial, out};
  cudaError_t err = wg::launch_mt<QsPolicy<T>>(mt, maps, p, splits, st);
  if (err == cudaSuccess && partial != nullptr)
    int4k::launch_reduce<T>(partial, out, splits, M * N, out_f32, st);
  return err;
}

// ---- f32: the first design, 3xTF32 wmma ----

constexpr int BM = 64, BN = 64, LDC = BN + 4;
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads, 3)
gemm_qs_f32_kernel(const float* __restrict__ x, const int32_t* __restrict__ w,
                   const float* __restrict__ s, const float* __restrict__ z, float* __restrict__ out,
                   int M, int K, int N, int sym) {
  using Tile = int4k::Tile<float>;
  constexpr int BK = Tile::BK;  // 64 k per step
  constexpr int RW = BK / 8;    // word rows per step
  constexpr int FK = BK / 4;    // k of each field per step
  constexpr int LDA = BK + Tile::PAD, LDB = BN + Tile::PAD;
  constexpr int VEC = 4;        // x elements per 16-byte load
  constexpr int kSmemBytes = (BM * LDA + BK * LDB) * 4;
  static_assert(BM * LDA >= BM * LDC, "the epilogue tile reuses the x tile");
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  float* As = reinterpret_cast<float*>(smem);  // [BM][LDA]
  float* Bs = As + BM * LDA;                   // [BK][LDB]
  float* Cs = As;                              // [BM][LDC], epilogue

  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int C = K / 128, KQ = K / 4, steps = K / BK;

  Tile::Acc acc[2][2];
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
        val = __ldg(reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + f * KQ + FK * t + j));
      *reinterpret_cast<uint4*>(As + r * LDA + v) = val;
    }
    // B: word (RW*t + rr, n) -> Bs[f*FK + 2*rr + h][n - n0] for f, h
    for (int i = tid; i < RW * BN; i += kThreads) {
      const int rr = i / BN, cc = i % BN, n = n0 + cc;
      const int32_t word = __ldg(w + (size_t)(RW * t + rr) * N + n);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const size_t gi = (size_t)(f * C + (FK * t + 2 * rr) / 32) * N + n;
        const float sf = s[gi];
        const float off = sym ? sf * static_cast<float>(kSymOffset) : z[gi] - sf * 16.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = (word >> (16 * h + 4 * f)) & 0xF;
          Bs[(f * FK + 2 * rr + h) * LDB + cc] = (16.f + q) * sf + off;
        }
      }
    }
    __syncthreads();
    Tile::step(acc, As, LDA, Bs, LDB, wm, wn);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * BN; i += kThreads) {
    const int r = i / BN, cc = i % BN;
    if (m0 + r >= M) continue;
    out[(size_t)(m0 + r) * N + n0 + cc] = Cs[r * LDC + cc];
  }
}

}  // namespace

// dtype: int4k::DType of x, s and z. x [M, K] (16-byte aligned rows); w
// int32 words [K/8, N] (a layer's block); s, z [K/32, N] (z unused when
// sym); out [M, N] in the compute type (out_f32 = 0) or f32. Needs
// K % 128 == 0, N % 128 == 0 and 16-byte aligned bases. bf16/f16: the m
// tile mt in {16, 64, 128, 256}, `splits` split-K parts of `per` 64-k
// stages each, partial f32 [splits, M, N] when splits > 1 (else null).
// f32 ignores mt, splits, per and partial. Returns cudaGetLastError()
// after the launches (cudaErrorInvalidValue when a tensor map is refused).
extern "C" int mlc_gemm_qs(int dtype, const void* x, const void* w, const void* s,
                           const void* z, void* partial, void* out, int M, int K, int N, int sym,
                           int out_f32, int mt, int splits, int per, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = splits > 1 ? static_cast<float*>(partial) : nullptr;
  const int steps = K / 64;  // the wgmma ring's stages
  const bool parts_ok = splits >= 1 && per >= 1 && (splits - 1) * per < steps &&
                        splits * per >= steps && (splits == 1 || part != nullptr);
  if (dtype != int4k::kF32 && !parts_ok) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case int4k::kBF16:
      return static_cast<int>(launch_wgmma<__nv_bfloat16>(x, w, s, z, part, out, M, K, N, sym,
                                                          out_f32, mt, splits, per, st));
    case int4k::kF16:
      return static_cast<int>(
          launch_wgmma<__half>(x, w, s, z, part, out, M, K, N, sym, out_f32, mt, splits, per, st));
    case int4k::kF32: {
      dim3 grid(N / BN, (M + BM - 1) / BM);
      gemm_qs_f32_kernel<<<grid, kThreads, 0, st>>>(
          static_cast<const float*>(x), static_cast<const int32_t*>(w),
          static_cast<const float*>(s), static_cast<const float*>(z), static_cast<float*>(out), M,
          K, N, sym);
      return static_cast<int>(cudaGetLastError());
    }
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
