// Dequant GEMM for the int4 "pair" and "hsplit" bit orders.
//
// Replaces the Pallas kernels mlc_llm_tpu/ops/pallas/dequant_matmul.py
// _kernel_pairs (the int4 branch of _dequant_matmul_2d, flat weights),
// _kernel_pairs_stacked (_dequant_matmul_stacked_2d, layer-stacked weights
// read in place) and _kernel_pairs_hs (both, stacked or not): the prefill
// path, 8 < m <= 2048, of the q4*_pair, q4*_sym, q4f32 and q4*_hs presets.
// Same math, same rounding points, every op rounded to the compute type T
// as the TPU bodies' jnp ops in T:
//   pair:   w = q * s (one rounding); acc += x @ w in f32; plus the offset
//           dot (x_even + x_odd, rounded to T) . off with off = z, or
//           s * -max_int (rounded) when sym;
//   hsplit: w = q * s + off (two roundings, never contracted into an fma),
//           off as above; acc += x @ w.
// Orders (K is the stored, group-padded K; x is padded to it by the caller):
//   pair:   word r holds k = 8r .. 8r+7, nibble i at bits 4i;
//   hsplit: byte b of word r holds k = 4r+b (low nibble) and K/2 + 4r+b
//           (high nibble); the low half reads groups [0, G/2), the high
//           half [G/2, G).
//
// Bound on the H100: at prefill widths the work is above the ridge (2*m*K*N
// flops against ~0.56*K*N weight bytes), so the bound is the tensor-core
// rate: 989 TFLOP/s for bf16/f16, a third of the 495 TF32 rate for f32
// (3xTF32).
//
// Both orders are format policies of the Hopper mainloop of
// dequant_wgmma.cuh (wgmma with the weight dequantized in registers into
// the A operand, 128 channels a block, x as B in shared memory, MT tokens,
// a TMA ring, two consumer warpgroups and one producer). A thread
// (channels ch, ch+8; lane group c) takes from each word the nibbles that
// its fragment positions name, so B stays x in natural k order:
//   pair bf16/f16: a stage is 16 word rows (128 k, 4 groups) in 8 k16 steps
//     (word rows 2j, 2j+1: byte c of each); one more k16 step is the offset
//     plane: B holds, per group, its f32 sum of the 16 rounded pair sums
//     as three T terms (hi, mid, lo: bf16's cover f32's 24 bits exactly,
//     f16's to its smallest subnormal, 2^-24), made by
//     pair_offsets_kernel, a prologue of the same entry; A holds off of the
//     group at those three k and zero at the last four;
//   hsplit bf16/f16: a stage is 8 word rows (64 k): group t of the low half
//     (two k16 steps, x at k 32t..) and of the high half (x at K/2 + 32t..),
//     word rows 4j + c/2 and 4j + 2 + c/2, bytes 2(c%2) and 2(c%2)+1;
//   f32 (pair and hsplit): 3xTF32 on wgmma .tf32 (m64nMTk8): A = the f32
//     weight split in registers into hi = tf32(w) and lo = tf32(w - hi), x
//     split the same way by tf32_split_kernel (a prologue) into hi and lo
//     tiles; acc += a_lo.x_hi + a_hi.x_lo + a_hi.x_hi (lo.lo is below f32's
//     last bit). The tensor cores' f32 accumulation truncates, so a stage's
//     24-27 MMAs (64 k) run into a fresh fragment that fold() adds to the
//     running sum with rounded f32 adds. The pair offset is one more k8
//     step: B the two groups' f32 sums of pair sums, A their off.
// The m tile, the split-K parts and the stages per part come from the
// Python wrapper (ops/dequant_matmul.py gemm_tiles, PAIRS_PLAN).

#include <type_traits>

#include "dequant_wgmma.cuh"
#include "int4_common.cuh"

namespace {

enum Layout { kPair = 0, kHsplit = 1 };
constexpr int kMaxInt = 7;  // int4 sym: codes q - 7

// ---- bf16 and f16 ----

// pair: 16 word rows a stage, 8 k16 steps of x and the offset step
template <typename TT>
struct PairHalf {
  using T = TT;
  using V = typename wg::Vec2<T>::V;
  static constexpr int kSteps = 9, kTiles = 9, kARegs = 4, kParts = 0;
  static constexpr int kMaxMT = 128;  // 9 tiles of [256][16] leave < 3 stages
  static constexpr int kRows = 16;
  static constexpr int kWBytes = kRows * wg::kBN * 4;
  static constexpr int kSBytes = 2 * 4 * wg::kBN * sizeof(T);  // scales, minima: [4][128]

  // maps: x [M][K] and o [M][16 * K/128] (box [MT][16], 32-byte swizzle);
  // words [K/8][N] (box [16][128]); scales and minima [G][N] (box [4][128])
  static __device__ __forceinline__ void load(const wg::Maps& mp, uint8_t* x, uint8_t* w,
                                              uint8_t* s, uint64_t* bar, int t, int m0, int n0,
                                              int MT, const wg::Params& p) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      wg::tma_load_2d(x + j * MT * wg::kTileRow, &mp.x, bar, 128 * t + 16 * j, m0);
    wg::tma_load_2d(x + 8 * MT * wg::kTileRow, &mp.o, bar, 16 * t, m0);
    wg::tma_load_2d(w, &mp.w, bar, n0, kRows * t);
    wg::tma_load_2d(s, &mp.s, bar, n0, 4 * t);
    wg::tma_load_2d(s + 4 * wg::kBN * sizeof(T), &mp.z, bar, n0, 4 * t);
  }

  static __device__ __forceinline__ void dequant(uint32_t (&a)[kSteps][4], const uint8_t* wt,
                                                 const uint8_t* st, int ch, int c,
                                                 const wg::Params& p) {
    const uint32_t* W = reinterpret_cast<const uint32_t*>(wt);
    const T* S = reinterpret_cast<const T*>(st);
    const T* Z = S + 4 * wg::kBN;
    // off of group g, channel ch + 8h, as f32 (a T value)
    auto off = [&](int g, int h) {
      const int i = g * wg::kBN + ch + 8 * h;
      return p.sym ? wg::Vec2<T>::rnd(wg::Vec2<T>::to_f(S[i]) * -static_cast<float>(kMaxInt))
                   : wg::Vec2<T>::to_f(Z[i]);
    };
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const V sc[2] = {wg::Vec2<T>::dup(wg::Vec2<T>::to_f(S[(j / 2) * wg::kBN + ch])),
                       wg::Vec2<T>::dup(wg::Vec2<T>::to_f(S[(j / 2) * wg::kBN + ch + 8]))};
      // a[j][r]: channel ch + 8 (r % 2), word row 2j + r / 2, byte c
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint32_t t = W[(2 * j + r / 2) * wg::kBN + ch + 8 * (r % 2)] >> (8 * c);
        const V v = wg::from_bits<V>(wg::codes2<T>((t & 0xFu) | ((t & 0xF0u) << 12)));
        a[j][r] = wg::bits(__hmul2_rn(v, sc[r % 2]));
      }
    }
    // the offset step: position k holds group k / 3 (k < 12), else zero;
    // a[8][r] holds positions 2c, 2c + 1 (r < 2) or 2c + 8, 2c + 9
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k0 = 2 * c + 8 * (r / 2), h = r % 2;
      const float lo = k0 < 12 ? off(k0 / 3, h) : 0.f;
      const float hi = k0 + 1 < 12 ? off((k0 + 1) / 3, h) : 0.f;
      a[8][r] = wg::bits(wg::Vec2<T>::pair(lo, hi));
    }
  }
};

// hsplit: 8 word rows a stage, two k16 steps of each half
template <typename TT>
struct HsplitHalf {
  using T = TT;
  using V = typename wg::Vec2<T>::V;
  static constexpr int kSteps = 4, kTiles = 4, kARegs = 4, kParts = 0;
  static constexpr int kMaxMT = 256;
  static constexpr int kRows = 8;
  static constexpr int kWBytes = kRows * wg::kBN * 4;
  static constexpr int kSBytes = 2 * 2 * wg::kBN * sizeof(T);  // scales, minima: [2][128]

  // maps: x [M][K] (box [MT][16]); words [K/8][N] (box [8][128]); scales
  // and minima [2][G/2][N] (box [2][1][128]: group t of each half)
  static __device__ __forceinline__ void load(const wg::Maps& mp, uint8_t* x, uint8_t* w,
                                              uint8_t* s, uint64_t* bar, int t, int m0, int n0,
                                              int MT, const wg::Params& p) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wg::tma_load_2d(x + k * MT * wg::kTileRow, &mp.x, bar,
                      (k / 2) * (p.K / 2) + 32 * t + 16 * (k % 2), m0);
    wg::tma_load_2d(w, &mp.w, bar, n0, kRows * t);
    wg::tma_load_3d(s, &mp.s, bar, n0, t, 0);
    wg::tma_load_3d(s + 2 * wg::kBN * sizeof(T), &mp.z, bar, n0, t, 0);
  }

  static __device__ __forceinline__ void dequant(uint32_t (&a)[kSteps][4], const uint8_t* wt,
                                                 const uint8_t* st, int ch, int c,
                                                 const wg::Params& p) {
    const uint32_t* W = reinterpret_cast<const uint32_t*>(wt);
    const T* S = reinterpret_cast<const T*>(st);
    const T* Z = S + 2 * wg::kBN;
    V sc[2][2], off[2][2];  // [half][channel ch + 8h]
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = hf * wg::kBN + ch + 8 * h;
        const float sf = wg::Vec2<T>::to_f(S[i]);
        sc[hf][h] = wg::Vec2<T>::dup(sf);
        off[hf][h] = wg::Vec2<T>::dup(p.sym ? sf * -static_cast<float>(kMaxInt)
                                            : wg::Vec2<T>::to_f(Z[i]));
      }
    const int sh = 16 * (c % 2);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        // channel ch + 8 (r % 2), word row 4j + 2 (r / 2) + c / 2, bytes
        // 2 (c % 2) and 2 (c % 2) + 1: low nibbles for the low half's step
        // j, high nibbles for the high half's
        const uint32_t t = W[(4 * j + 2 * (r / 2) + c / 2) * wg::kBN + ch + 8 * (r % 2)] >> sh;
        const uint32_t q[2] = {(t & 0xFu) | ((t & 0xF00u) << 8),
                               ((t >> 4) & 0xFu) | ((t & 0xF000u) << 4)};
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const V v = wg::from_bits<V>(wg::codes2<T>(q[hf]));
          a[2 * hf + j][r] = wg::bits(__hadd2_rn(__hmul2_rn(v, sc[hf][r % 2]), off[hf][r % 2]));
        }
      }
  }
};

// ---- f32: 3xTF32 ----

// shared by both orders: a stage's k8 steps run into one fresh fragment
template <int L>
struct F32Policy {
  using T = float;
  static constexpr bool kPairL = L == kPair;
  static constexpr int kSteps = kPairL ? 9 : 8;  // pair: 8 k8 steps and the offset step
  static constexpr int kTiles = 2 * kSteps;      // hi and lo tiles of each step
  static constexpr int kARegs = 8;               // hi [0..3], lo [4..7]
  static constexpr int kParts = 1;
  static constexpr int kMaxMT = 64;  // acc, the fresh fragment and 64-72 A registers
  static constexpr int kRows = 8;
  static constexpr int kWBytes = kRows * wg::kBN * 4;
  static constexpr int kSBytes = 2 * 2 * wg::kBN * 4;  // scales, minima: [2][128]

  // maps: x the split planes [2][M][Kp] (box [2][MT][8], 32-byte swizzle:
  // the hi tile, then the lo tile); words [K/8][N] (box [8][128]); scales
  // and minima: pair [G][N] (box [2][128], groups 2t, 2t + 1), hsplit
  // [2][G/2][N] (box [2][1][128], group t of each half)
  static __device__ __forceinline__ void load(const wg::Maps& mp, uint8_t* x, uint8_t* w,
                                              uint8_t* s, uint64_t* bar, int t, int m0, int n0,
                                              int MT, const wg::Params& p) {
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      int col;
      if constexpr (kPairL)
        col = k < 8 ? 64 * t + 8 * k : p.K + 8 * t;  // the offset columns follow K
      else
        col = (k / 4) * (p.K / 2) + 32 * t + 8 * (k % 4);
      wg::tma_load_3d(x + 2 * k * MT * wg::kTileRow, &mp.x, bar, col, m0, 0);
    }
    wg::tma_load_2d(w, &mp.w, bar, n0, kRows * t);
    if constexpr (kPairL) {
      wg::tma_load_2d(s, &mp.s, bar, n0, 2 * t);
      wg::tma_load_2d(s + 2 * wg::kBN * 4, &mp.z, bar, n0, 2 * t);
    } else {
      wg::tma_load_3d(s, &mp.s, bar, n0, t, 0);
      wg::tma_load_3d(s + 2 * wg::kBN * 4, &mp.z, bar, n0, t, 0);
    }
  }

  static __device__ __forceinline__ void split(uint32_t (&a)[kARegs], int r, float v) {
    const uint32_t hi = wg::tf32(v);
    a[r] = hi;
    a[4 + r] = wg::tf32(v - __uint_as_float(hi));
  }

  // A of a k8 step (PTX ISA, wgmma .tf32 A in registers): a[0] = (row g,
  // k c), a[1] = (row g + 8, k c), a[2] = (row g, k c + 4), a[3] = (row
  // g + 8, k c + 4)
  static __device__ __forceinline__ void dequant(uint32_t (&a)[kSteps][kARegs],
                                                 const uint8_t* wt, const uint8_t* st, int ch,
                                                 int c, const wg::Params& p) {
    const uint32_t* W = reinterpret_cast<const uint32_t*>(wt);
    const float* S = reinterpret_cast<const float*>(st);
    const float* Z = S + 2 * wg::kBN;
    float sc[2][2], off[2][2];  // [group (pair) or half (hsplit)][channel ch + 8h]
#pragma unroll
    for (int g = 0; g < 2; ++g)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = g * wg::kBN + ch + 8 * h;
        sc[g][h] = S[i];
        off[g][h] = p.sym ? __fmul_rn(S[i], -static_cast<float>(kMaxInt)) : Z[i];
      }
    if constexpr (kPairL) {
      // step j is word row j: nibbles c and c + 4
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint32_t w = W[j * wg::kBN + ch + 8 * (r % 2)];
          const float q = static_cast<float>((w >> (4 * (c + 4 * (r / 2)))) & 0xFu);
          split(a[j], r, __fmul_rn(q, sc[j / 4][r % 2]));
        }
      // the offset step: position k < 2 holds group k's off, the rest zero
#pragma unroll
      for (int r = 0; r < 4; ++r) split(a[8], r, (r < 2 && c < 2) ? off[c][r % 2] : 0.f);
    } else {
      // step j of a half: word rows 2j (k c) and 2j + 1 (k c + 4), byte c;
      // the low nibble for the low half (steps 0-3), the high for the high
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint32_t w = W[(2 * j + r / 2) * wg::kBN + ch + 8 * (r % 2)] >> (8 * c);
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const float q = static_cast<float>((w >> (4 * hf)) & 0xFu);
            split(a[4 * hf + j], r,
                  __fadd_rn(__fmul_rn(q, sc[hf][r % 2]), off[hf][r % 2]));
          }
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

// ---- prologues ----

// pair, T = bf16/f16: xo [M][16 * K/128]; per 128-k stage t, entries 3g ..
// 3g + 2 hold group 4t + g's f32 sum of its 16 pair sums T(x_2i + x_2i+1)
// as three T terms (their sum is the f32 value: bf16's 3 x 8 bits cover
// f32's 24; f16's lowest term stops at its subnormals), entries 12-15 zero
template <typename T>
__global__ void pair_offsets_kernel(const T* __restrict__ x, T* __restrict__ xo, int M, int K) {
  const int stages = K / 128;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * stages) return;
  const int m = i / stages, t = i % stages;
  const T* xr = x + static_cast<size_t>(m) * K + 128 * t;
  T* o = xo + static_cast<size_t>(m) * 16 * stages + 16 * t;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      sum += int4k::rnd<T>(int4k::Num<T>::to_f(xr[32 * g + 2 * j]) +
                           int4k::Num<T>::to_f(xr[32 * g + 2 * j + 1]));
    const float hi = int4k::rnd<T>(sum);
    const float mid = int4k::rnd<T>(sum - hi);
    o[3 * g] = int4k::Num<T>::from_f(hi);
    o[3 * g + 1] = int4k::Num<T>::from_f(mid);
    o[3 * g + 2] = int4k::Num<T>::from_f(sum - hi - mid);
  }
#pragma unroll
  for (int e = 12; e < 16; ++e) o[e] = int4k::Num<T>::from_f(0.f);
}

// f32: xs [2][M][Kp], plane 0 tf32(v), plane 1 tf32(v - hi), for v = x[m,
// k] (k < K) and, pair only (Kp = K + K/8), the offset columns K + 8t + e:
// group 2t + e's f32 sum of its 16 pair sums (e < 2), else zero
__global__ void tf32_split_kernel(const float* __restrict__ x, float* __restrict__ xs, int M,
                                  int K, int Kp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * Kp) return;
  const int m = i / Kp, col = i % Kp;
  const float* xr = x + static_cast<size_t>(m) * K;
  float v = 0.f;
  if (col < K) {
    v = xr[col];
  } else {
    const int t = (col - K) / 8, e = (col - K) % 8;
    if (e < 2) {
      const float* xg = xr + 32 * (2 * t + e);
#pragma unroll
      for (int j = 0; j < 16; ++j) v += xg[2 * j] + xg[2 * j + 1];
    }
  }
  const uint32_t hi = wg::tf32(v);
  xs[i] = __uint_as_float(hi);
  xs[static_cast<size_t>(M) * Kp + i] = __uint_as_float(wg::tf32(v - __uint_as_float(hi)));
}

// ---- launch ----

template <typename T>
constexpr CUtensorMapDataType map_type() {
  return std::is_same<T, __nv_bfloat16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
         : std::is_same<T, __half>::value      ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                               : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}

// scales/minima maps: pair [G][N] in boxes of `rows` groups; hsplit
// [2][G/2][N] in boxes of one group of each half
template <typename T>
bool scale_maps(wg::Maps& maps, int layout, const void* s, const void* z, int G, int N,
                int rows) {
  const size_t es = sizeof(T);
  const CUtensorMapDataType dt = map_type<T>();
  if (layout == kPair)
    return wg::map_2d(&maps.s, dt, s, N, G, N * es, wg::kBN, rows) &&
           wg::map_2d(&maps.z, dt, z, N, G, N * es, wg::kBN, rows);
  return wg::map_3d(&maps.s, dt, s, N, G / 2, 2, N * es, G / 2 * N * es, wg::kBN, 1, 2) &&
         wg::map_3d(&maps.z, dt, z, N, G / 2, 2, N * es, G / 2 * N * es, wg::kBN, 1, 2);
}

template <typename T>
cudaError_t launch_half(int layout, const void* x, void* xt, const void* w, const void* s,
                        const void* z, float* partial, void* out, int M, int K, int N, int sym,
                        int out_f32, int mt, int splits, int per, cudaStream_t st) {
  const int G = K / 32;
  const size_t es = sizeof(T);
  const CUtensorMapDataType dt = map_type<T>();
  const int rows = layout == kPair ? PairHalf<T>::kRows : HsplitHalf<T>::kRows;
  const int steps = K / (8 * rows);
  if ((splits - 1) * per >= steps || splits * per < steps) return cudaErrorInvalidValue;
  wg::Maps maps;
  bool ok = wg::map_2d(&maps.x, dt, x, K, M, K * es, 16, mt, CU_TENSOR_MAP_SWIZZLE_32B) &&
            wg::map_2d(&maps.w, CU_TENSOR_MAP_DATA_TYPE_UINT32, w, N, K / 8, N * 4ull, wg::kBN,
                       rows) &&
            scale_maps<T>(maps, layout, s, sym ? s : z, G, N, 4);
  if (layout == kPair) {
    if (xt == nullptr) return cudaErrorInvalidValue;
    const int cols = 16 * steps, threads = 256;
    pair_offsets_kernel<T><<<(M * steps + threads - 1) / threads, threads, 0, st>>>(
        static_cast<const T*>(x), static_cast<T*>(xt), M, K);
    ok = ok && wg::map_2d(&maps.o, dt, xt, cols, M, cols * es, 16, mt, CU_TENSOR_MAP_SWIZZLE_32B);
  }
  if (!ok) return cudaErrorInvalidValue;
  wg::Params p{M, N, K, steps, per, sym, kMaxInt, out_f32, partial, out};
  const cudaError_t err = layout == kPair ? wg::launch_mt<PairHalf<T>>(mt, maps, p, splits, st)
                                          : wg::launch_mt<HsplitHalf<T>>(mt, maps, p, splits, st);
  if (err == cudaSuccess && partial != nullptr)
    int4k::launch_reduce<T>(partial, out, splits, M * N, out_f32, st);
  return err;
}

cudaError_t launch_f32(int layout, const void* x, void* xt, const void* w, const void* s,
                       const void* z, float* partial, void* out, int M, int K, int N, int sym,
                       int mt, int splits, int per, cudaStream_t st) {
  const int G = K / 32, steps = K / 64;
  if ((splits - 1) * per >= steps || splits * per < steps || xt == nullptr)
    return cudaErrorInvalidValue;
  const int Kp = layout == kPair ? K + K / 8 : K;
  const int threads = 256;
  tf32_split_kernel<<<(M * Kp + threads - 1) / threads, threads, 0, st>>>(
      static_cast<const float*>(x), static_cast<float*>(xt), M, K, Kp);
  wg::Maps maps;
  const bool ok = wg::map_3d(&maps.x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, xt, Kp, M, 2, Kp * 4ull,
                             static_cast<size_t>(M) * Kp * 4, 8, mt, 2,
                             CU_TENSOR_MAP_SWIZZLE_32B) &&
                  wg::map_2d(&maps.w, CU_TENSOR_MAP_DATA_TYPE_UINT32, w, N, K / 8, N * 4ull,
                             wg::kBN, 8) &&
                  scale_maps<float>(maps, layout, s, sym ? s : z, G, N, 2);
  if (!ok) return cudaErrorInvalidValue;
  wg::Params p{M, N, K, steps, per, sym, kMaxInt, 1, partial, out};
  const cudaError_t err = layout == kPair
                              ? wg::launch_mt<F32Policy<kPair>>(mt, maps, p, splits, st)
                              : wg::launch_mt<F32Policy<kHsplit>>(mt, maps, p, splits, st);
  if (err == cudaSuccess && partial != nullptr)
    int4k::launch_reduce<float>(partial, out, splits, M * N, 1, st);
  return err;
}

}  // namespace

// layout: 0 pair, 1 hsplit; dtype: int4k::DType of x, s and z. x [M, K]
// (16-byte aligned); xt the prologue's scratch: bf16/f16 pair [M, 16 *
// K/128] in x's dtype, hsplit none (null), f32 [2, M, Kp] f32 with Kp = K
// + K/8 (pair) or K (hsplit); w int32 words [K/8, N] (a layer's block); s,
// z [K/32, N] (z unused when sym); out [M, N] in the compute type (out_f32
// = 0) or f32. The m tile mt (bf16/f16 pair 16, 64, 128; hsplit also 256;
// f32 16, 64), `splits` split-K parts of `per` stages (a stage: 128 k for
// bf16/f16 pair, else 64), partial f32 [splits, M, N] when splits > 1, else
// null. Needs K % 128 == 0, N % 128 == 0 and 16-byte aligned bases.
// Returns cudaGetLastError() after the launches (cudaErrorInvalidValue for
// a refused tensor map or plan).
extern "C" int mlc_gemm_pairs(int layout, int dtype, const void* x, void* xt, const void* w,
                              const void* s, const void* z, void* partial, void* out, int M,
                              int K, int N, int sym, int out_f32, int mt, int splits, int per,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = splits > 1 ? static_cast<float*>(partial) : nullptr;
  if (splits < 1 || per < 1 || (splits > 1 && part == nullptr) ||
      (layout != kPair && layout != kHsplit))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (dtype) {
    case int4k::kBF16:
      err = launch_half<__nv_bfloat16>(layout, x, xt, w, s, z, part, out, M, K, N, sym, out_f32,
                                       mt, splits, per, st);
      break;
    case int4k::kF16:
      err = launch_half<__half>(layout, x, xt, w, s, z, part, out, M, K, N, sym, out_f32, mt,
                                splits, per, st);
      break;
    case int4k::kF32:
      err = launch_f32(layout, x, xt, w, s, z, part, out, M, K, N, sym, mt, splits, per, st);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
