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
// f32 runs the same mainloop as 3xTF32 on wgmma .tf32 (QsF32 below): the
// f32 head of a q4bf16/q4f16 GPT-NeoX above m = 8.

#include <type_traits>

#include "dequant_wgmma.cuh"
#include "int4_common.cuh"

namespace {

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

// ---- f32: 3xTF32 on the mainloop ----

// A stage is 8 word rows (16 k of each quarter) in eight k8 steps, step 2f
// + j = quarter f's k 16t + 8j .. + 7. A of a k8 step: a[0] = (channel ch,
// position c), a[1] = (ch + 8, c), a[2] = (ch, c + 4), a[3] = (ch + 8, c +
// 4); position p of step j is word row 4j + p / 2, half p % 2, so a thread
// reads word rows 4j + c/2 and 4j + 2 + c/2 (bits 16 (c % 2) + 4f of each)
// and one word feeds all four quarters. The weight is rebuilt in f32 as
// the TPU body rounds it, (16 + q) * s + (z - 16 s) (sym: + s * -23), with
// no fma contraction; it is not exact in TF32, so 3xTF32: A split in
// registers into hi and lo, x split by tf32_split_kernel (a prologue) into
// hi and lo tiles, acc += a_lo.x_hi + a_hi.x_lo + a_hi.x_hi, a stage's 24
// MMAs in a fresh fragment (the tensor cores' f32 accumulation truncates)
// that fold() adds to the running sum with rounded f32 adds.
struct QsF32 {
  using T = float;
  static constexpr int kSteps = 8, kTiles = 16, kARegs = 8, kParts = 1;
  static constexpr int kMaxMT = 64;  // acc, the fresh fragment and 64 hi/lo A registers
  static constexpr int kRows = 8;
  static constexpr int kWBytes = kRows * wg::kBN * 4;
  static constexpr int kSBytes = 2 * 4 * wg::kBN * 4;  // scales, minima: [4][128]

  // maps: x the split planes [2][M][K] (box [2][MT][8], 32-byte swizzle:
  // the hi tile, then the lo tile); words [K/8][N] (box [8][128]); scales
  // and minima [4][G/4][N] (box [4][1][128])
  static __device__ __forceinline__ void load(const wg::Maps& mp, uint8_t* x, uint8_t* w,
                                              uint8_t* s, uint64_t* bar, int t, int m0, int n0,
                                              int MT, const wg::Params& p) {
    const int kq = p.K / 4;
#pragma unroll
    for (int k = 0; k < kSteps; ++k)
      wg::tma_load_3d(x + 2 * k * MT * wg::kTileRow, &mp.x, bar, (k / 2) * kq + 16 * t + 8 * (k % 2),
                      m0, 0);
    wg::tma_load_2d(w, &mp.w, bar, n0, kRows * t);
    wg::tma_load_3d(s, &mp.s, bar, n0, t / 2, 0);
    wg::tma_load_3d(s + 4 * wg::kBN * 4, &mp.z, bar, n0, t / 2, 0);
  }

  static __device__ __forceinline__ void dequant(uint32_t (&a)[kSteps][kARegs],
                                                 const uint8_t* wt, const uint8_t* st, int ch,
                                                 int c, const wg::Params& p) {
    const uint32_t* W = reinterpret_cast<const uint32_t*>(wt);
    const float* S = reinterpret_cast<const float*>(st);
    const float* Z = S + 4 * wg::kBN;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint32_t w =
            W[(4 * j + 2 * (r / 2) + c / 2) * wg::kBN + ch + 8 * (r % 2)] >> (16 * (c % 2));
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int i = f * wg::kBN + ch + 8 * (r % 2);
          const float sf = S[i];
          const float off = p.sym ? __fmul_rn(sf, static_cast<float>(kSymOffset))
                                  : __fsub_rn(Z[i], __fmul_rn(sf, 16.f));
          const float q = static_cast<float>(16 + ((w >> (4 * f)) & 0xFu));
          const float v = __fadd_rn(__fmul_rn(q, sf), off);
          const uint32_t hi = wg::tf32(v);
          a[2 * f + j][r] = hi;
          a[2 * f + j][4 + r] = wg::tf32(v - __uint_as_float(hi));
        }
      }
  }

  template <int MT>
  static __device__ __forceinline__ void issue(float (&d)[1][MT / 2],
                                               const uint32_t (&a)[kSteps][kARegs],
                                               const uint8_t* x) {
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const uint32_t(&hi)[4] = *reinterpret_cast<const uint32_t(*)[4]>(&a[k][0]);
      const uint32_t(&lo)[4] = *reinterpret_cast<const uint32_t(*)[4]>(&a[k][4]);
      const uint64_t xh = wg::desc_sw32(x + 2 * k * MT * wg::kTileRow);
      const uint64_t xl = wg::desc_sw32(x + (2 * k + 1) * MT * wg::kTileRow);
      wg::Wgmma<MT, float>::mma(d[0], lo, xh, k > 0);
      wg::Wgmma<MT, float>::mma(d[0], hi, xl);
      wg::Wgmma<MT, float>::mma(d[0], hi, xh);
    }
  }

  template <int MT>
  static __device__ __forceinline__ void fold(float (&acc)[MT / 2], float (&d)[1][MT / 2],
                                              const uint8_t*, const uint8_t*, const uint8_t*,
                                              int, int, int, const wg::Params&) {
#pragma unroll
    for (int i = 0; i < MT / 2; ++i) acc[i] += d[0][i];
  }
};

// xs [2][M][K]: plane 0 tf32(x), plane 1 tf32(x - hi)
__global__ void tf32_split_kernel(const float* __restrict__ x, float* __restrict__ xs, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float v = x[i];
  const uint32_t hi = wg::tf32(v);
  xs[i] = __uint_as_float(hi);
  xs[n + i] = __uint_as_float(wg::tf32(v - __uint_as_float(hi)));
}

cudaError_t launch_f32(const void* x, void* xt, const void* w, const void* s, const void* z,
                       float* partial, void* out, int M, int K, int N, int sym, int mt,
                       int splits, int per, cudaStream_t st) {
  if (xt == nullptr) return cudaErrorInvalidValue;
  const int G = K / 32, threads = 256;
  tf32_split_kernel<<<(M * K + threads - 1) / threads, threads, 0, st>>>(
      static_cast<const float*>(x), static_cast<float*>(xt), M * K);
  wg::Maps maps;
  const bool ok =
      wg::map_3d(&maps.x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, xt, K, M, 2, K * 4ull,
                 static_cast<size_t>(M) * K * 4, 8, mt, 2, CU_TENSOR_MAP_SWIZZLE_32B) &&
      wg::map_2d(&maps.w, CU_TENSOR_MAP_DATA_TYPE_UINT32, w, N, K / 8, N * 4ull, wg::kBN,
                 QsF32::kRows) &&
      wg::map_3d(&maps.s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, s, N, G / 4, 4, N * 4ull,
                 G / 4 * N * 4ull, wg::kBN, 1, 4) &&
      wg::map_3d(&maps.z, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, sym ? s : z, N, G / 4, 4, N * 4ull,
                 G / 4 * N * 4ull, wg::kBN, 1, 4);
  if (!ok) return cudaErrorInvalidValue;
  wg::Params p{M, N, K, K / 64, per, sym, 7, 1, partial, out};
  const cudaError_t err = wg::launch_mt<QsF32>(mt, maps, p, splits, st);
  if (err == cudaSuccess && partial != nullptr)
    int4k::launch_reduce<float>(partial, out, splits, M * N, 1, st);
  return err;
}

}  // namespace

// dtype: int4k::DType of x, s and z. x [M, K] (16-byte aligned rows); xt
// the f32 prologue's scratch [2, M, K] f32 (bf16/f16: null); w int32 words
// [K/8, N] (a layer's block); s, z [K/32, N] (z unused when sym); out [M,
// N] in the compute type (out_f32 = 0) or f32 (always f32 for f32). Needs
// K % 128 == 0, N % 128 == 0 and 16-byte aligned bases. The m tile mt
// (bf16/f16 16, 64, 128, 256; f32 16, 64), `splits` split-K parts of `per`
// 64-k stages each, partial f32 [splits, M, N] when splits > 1 (else null).
// Returns cudaGetLastError() after the launches (cudaErrorInvalidValue
// when a tensor map or the plan is refused).
extern "C" int mlc_gemm_qs(int dtype, const void* x, void* xt, const void* w, const void* s,
                           const void* z, void* partial, void* out, int M, int K, int N, int sym,
                           int out_f32, int mt, int splits, int per, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = splits > 1 ? static_cast<float*>(partial) : nullptr;
  const int steps = K / 64;  // the ring's stages
  if (splits < 1 || per < 1 || (splits - 1) * per >= steps || splits * per < steps ||
      (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (dtype) {
    case int4k::kBF16:
      err = launch_wgmma<__nv_bfloat16>(x, w, s, z, part, out, M, K, N, sym, out_f32, mt,
                                        splits, per, st);
      break;
    case int4k::kF16:
      err = launch_wgmma<__half>(x, w, s, z, part, out, M, K, N, sym, out_f32, mt, splits, per,
                                 st);
      break;
    case int4k::kF32:
      err = launch_f32(x, xt, w, s, z, part, out, M, K, N, sym, mt, splits, per, st);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
