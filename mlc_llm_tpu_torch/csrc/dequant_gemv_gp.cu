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
// words, scales and minima; 0.75 with f32 scales), about 2 flops per byte
// and row, far below the ridge.
//
// m = 1 runs GpStream, the pair/hsplit policy of the weight-streaming
// mainloop of gemv_stream.cuh (see there for the design and what bounds
// it): a stage is 16 word rows = 128 k = four whole groups (pair: groups
// 4t .. 4t + 3, four rows each; hsplit: the stage's two groups of each
// half, the low nibbles of rows 0-7 and 8-15, then the high nibbles), so
// every group's P and fold finish inside the stage. A raw code q becomes
// the f32 q exactly by bit assembly (gs::code_raw: 0x4B000000 | q, less
// 2^23), then one FMA. One launch a call.
//
// 2 <= m <= 8 runs on the tensor cores, as policies of the wgmma mainloop
// of dequant_wgmma.cuh at m tile 16 (the tokens are wgmma's N = 16
// operand). A SIMT body redoes the nibble extract, the code's conversion
// and an fmaf for every weight and every row, so m = 8 would cost eight
// times m = 1's instructions over the same bytes. Here:
//   * A = the raw codes 0-15, exact in bf16, f16 and TF32 (bf16/f16: the
//     code pair bit assembly wg::codes2, no multiply); B = x in natural k
//     order, so each order's k order of a step is chosen to make a thread's
//     A register come from one word: pair step k is word rows 2k and 2k +
//     1, byte c of each; hsplit steps j (low half) and 4 + j (high half)
//     share word rows 4j + c/2 and 4j + 2 + c/2, bytes 2 (c % 2) and 2 (c %
//     2) + 1, low and high nibbles;
//   * a stage is 16 word rows = 128 k = four groups (pair: 4t .. 4t + 3;
//     hsplit: the stage's two groups of each half), and each group's MMAs
//     run into a fresh f32 fragment, the group partial P;
//   * fold() adds s * P + z * sx (sym: s * (P - 7 sx)) with the stage's
//     scales on the CUDA cores. bf16/f16 take the group sums of x from the
//     stage's x tiles (256 threads, 8 elements each, two shuffles, the even
//     and odd sums apart for pair) at the rounding points above;
//   * f32 runs TF32 wgmma (k8). A is exact in TF32, so only x is split,
//     into hi = tf32(x) and lo = tf32(x - hi) planes by a prologue kernel:
//     two products a step, each group's eight into its fresh fragment (the
//     tensor cores' f32 accumulation truncates). The prologue also writes
//     each group's f32 sum of x, which the stage loads beside its scales;
//   * split K, the m tile and the epilogue are the mainloop's (the plan
//     from ops/dequant_matmul.py gemm_tiles at GEMV_STAGE_K = 128).
// Compute type T (x, s, z) is bf16, f16 or f32; the output is T or f32.

#include <type_traits>

#include "gemv_stream.cuh"

namespace {

using int4k::Num;
using int4k::rnd;

enum Layout { kPair = 0, kHsplit = 1 };

constexpr int kRows = 16;      // word rows of a tensor-core stage
constexpr int kMaxInt = 7;     // int4 sym: codes q - 7

// m = 1. Staged x of word row rr of stage t (value e): pair k = 128t +
// 8rr + e (nibble e); hsplit the low nibble of byte e (k = 64t + 4rr + e)
// for e < 4, the high nibble of byte e - 4 (k = K/2 + 64t + 4rr + e - 4)
// above. Group j of the stage: pair rows 4j .. 4j + 3; hsplit half j / 2,
// rows 8 (j % 2) .. + 7. A part's x is one chunk (pair) or one a half
// (hsplit).
template <int L, typename TT>
struct GpStream {
  using T = TT;
  static constexpr int kWordBytes = 4, kGroups = 4, kStages = 2;
  static constexpr int kScaleOffset = gs::kRows * gs::kCols * kWordBytes;
  static constexpr int kStageBytes = kScaleOffset + 2 * kGroups * gs::kCols * sizeof(T);
  static constexpr int kStageX = 128, kChunks = L == kPair ? 1 : 2;

  static __device__ __forceinline__ int scale_row(int t, int j, int G) {
    return L == kPair ? 4 * t + j : (j / 2) * (G / 2) + 2 * t + j % 2;
  }
  static __device__ __forceinline__ int chunk_k(int c, int t0, int K) {
    return L == kPair ? 128 * t0 : c * (K / 2) + 64 * t0;
  }
  static __device__ __forceinline__ int raw_index(int i, int rr, int e, int n) {
    if (L == kPair) return 128 * i + 8 * rr + e;
    return (e / 4) * 64 * n + 64 * i + 4 * rr + e % 4;
  }
  // pair: lane = element (row 4j + lane / 8, nibble lane % 8; k parity
  // lane % 2): the even and odd sums each rounded to T, added in T;
  // hsplit: one sum rounded once
  static __device__ __forceinline__ float group_sum(const float* xst, int j, int m, int M,
                                                    int lane) {
    if (L == kPair) {
      float v = xst[((4 * j + lane / 8) * M + m) * gs::kXRow + lane % 8];
#pragma unroll
      for (int o = 16; o > 1; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      const float even = rnd<T>(__shfl_sync(0xffffffffu, v, 0));
      const float odd = rnd<T>(__shfl_sync(0xffffffffu, v, 1));
      return rnd<T>(even + odd);
    }
    float v = xst[((8 * (j % 2) + lane / 4) * M + m) * gs::kXRow + 4 * (j / 2) + lane % 4];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return rnd<T>(v);
  }

  template <int M>
  static __device__ __forceinline__ void consume(const uint8_t* st, const float* xst,
                                                 const float* sx, float (&acc)[M][gs::C],
                                                 bool asym, int c) {
    constexpr int C = gs::C;
    float p[M][4][C];
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int cc = 0; cc < C; ++cc) p[m][j][cc] = 0.f;
#pragma unroll
    for (int rr = 0; rr < gs::kRows; ++rr) {
      uint32_t w[C];
      gs::load_words(st + rr * gs::kCols * kWordBytes, c, w);
      float q[C][8];
#pragma unroll
      for (int cc = 0; cc < C; ++cc)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          q[cc][e] = gs::code_raw(w[cc], L == kPair ? 4 * e : 8 * (e % 4) + 4 * (e / 4));
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float4* xr = reinterpret_cast<const float4*>(xst + (rr * M + m) * gs::kXRow);
        const float4 a = xr[0], b = xr[1];
        const float xv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int j = L == kPair ? rr / 4 : 2 * (e / 4) + rr / 8;
#pragma unroll
          for (int cc = 0; cc < C; ++cc) p[m][j][cc] = fmaf(xv[e], q[cc][e], p[m][j][cc]);
        }
      }
    }
    // y += s * P + z * sx (sym: s * (P - 7 sx)), f32 scales
    const T* S = reinterpret_cast<const T*>(st + kScaleOffset);
    const T* Z = S + kGroups * gs::kCols;
    const float base = asym ? 0.f : static_cast<float>(kMaxInt);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s[C], z[C];
      gs::load_cols(S + j * gs::kCols, c, s);
      if (asym) {
        gs::load_cols(Z + j * gs::kCols, c, z);
      } else {
#pragma unroll
        for (int cc = 0; cc < C; ++cc) z[cc] = 0.f;
      }
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float v = sx[j * M + m];
#pragma unroll
        for (int cc = 0; cc < C; ++cc) acc[m][cc] += s[cc] * (p[m][j][cc] - base * v) + z[cc] * v;
      }
    }
  }
};

// ---- 2 <= m <= 8: the tensor-core policies ----

template <typename T>
constexpr CUtensorMapDataType map_type() {
  return std::is_same<T, __nv_bfloat16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
         : std::is_same<T, __half>::value      ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                               : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}

// both orders' stage: 16 word rows = 128 k = four groups, part p of the
// stage in fresh fragment p; pair: groups 4t + p; hsplit: p = 2 hf + gg,
// group hf * G/2 + 2t + gg (half hf, the stage's two groups of each half)
template <int L>
__device__ __forceinline__ void load_words_scales(const wg::Maps& mp, uint8_t* w, uint8_t* s,
                                                  uint64_t* bar, int t, int n0, int sbytes) {
  wg::tma_load_2d(w, &mp.w, bar, n0, kRows * t);
  if constexpr (L == kPair) {
    wg::tma_load_2d(s, &mp.s, bar, n0, 4 * t);
    wg::tma_load_2d(s + sbytes, &mp.z, bar, n0, 4 * t);
  } else {
    wg::tma_load_3d(s, &mp.s, bar, n0, 2 * t, 0);
    wg::tma_load_3d(s + sbytes, &mp.z, bar, n0, 2 * t, 0);
  }
}

// the fold: acc += s * (P - base * sx) + z * sx for each of the stage's
// four groups (base = max_int when sym, where z is 0; else 0), f32 scales;
// sx(p, token) from the caller
template <typename T, int MT, typename SX>
__device__ __forceinline__ void fold_groups(float (&acc)[MT / 2], float (&d)[4][MT / 2],
                                            const uint8_t* st, int ch, int c,
                                            const wg::Params& p, SX sx_at) {
  const T* S = reinterpret_cast<const T*>(st);
  const T* Z = S + 4 * wg::kBN;
  const float base = p.sym ? static_cast<float>(kMaxInt) : 0.f;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    float sc[2], z[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sc[h] = Num<T>::to_f(S[g * wg::kBN + ch + 8 * h]);
      z[h] = p.sym ? 0.f : Num<T>::to_f(Z[g * wg::kBN + ch + 8 * h]);
    }
#pragma unroll
    for (int e = 0; e < MT / 2; ++e) {
      // d[4j + {0,1}] = (channel ch, token 8j + 2c + {0,1}); + {2,3}: ch + 8
      const int tok = 8 * (e / 4) + 2 * c + e % 2, h = (e % 4) / 2;
      const float sx = sx_at(g, tok);
      acc[e] += sc[h] * (d[g][e] - base * sx) + z[h] * sx;
    }
  }
}

// bf16 and f16: A = the raw codes (exact), eight k16 steps a stage, two
// per group
template <int L, typename TT>
struct GpHalf {
  using T = TT;
  using V = typename wg::Vec2<T>::V;
  static constexpr int kSteps = 8, kTiles = 8, kARegs = 4, kParts = 4, kMaxMT = 16;
  static constexpr int kWBytes = kRows * wg::kBN * 4;
  static constexpr int kSBytes = 2 * 4 * wg::kBN * sizeof(T);  // scales, minima: [4][128]

  // maps: x [M][K] (box [16][16], 32-byte swizzle); words [K/8][N] (box
  // [16][128]); scales and minima: pair [G][N] (box [4][128]), hsplit
  // [2][G/2][N] (box [2][2][128])
  static __device__ __forceinline__ void load(const wg::Maps& mp, uint8_t* x, uint8_t* w,
                                              uint8_t* s, uint64_t* bar, int t, int m0, int n0,
                                              int MT, const wg::Params& p) {
    // step k: pair k 128t + 16k; hsplit half k / 4 at 64t + 16 (k % 4)
#pragma unroll
    for (int k = 0; k < kSteps; ++k)
      wg::tma_load_2d(x + k * MT * wg::kTileRow, &mp.x, bar,
                      L == kPair ? 128 * t + 16 * k : (k / 4) * (p.K / 2) + 64 * t + 16 * (k % 4),
                      m0);
    load_words_scales<L>(mp, w, s, bar, t, n0, 4 * wg::kBN * sizeof(T));
  }

  // positions 2c, 2c + 1 (a[.][0..1]) and 2c + 8, 2c + 9 (a[.][2..3]) of
  // channels ch, ch + 8 (r % 2); B is x in natural k order, so
  //   pair step k: word rows 2k (positions 0-7) and 2k + 1, byte c;
  //   hsplit steps j and 4 + j: word rows 4j + c/2 and 4j + 2 + c/2, bytes
  //   2 (c % 2) and 2 (c % 2) + 1, low nibbles (half 0) or high (half 1)
  static __device__ __forceinline__ void dequant(uint32_t (&a)[kSteps][4], const uint8_t* wt,
                                                 const uint8_t*, int ch, int c,
                                                 const wg::Params&) {
    const uint32_t* W = reinterpret_cast<const uint32_t*>(wt);
    if constexpr (L == kPair) {
#pragma unroll
      for (int k = 0; k < kSteps; ++k)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint32_t t = W[(2 * k + r / 2) * wg::kBN + ch + 8 * (r % 2)] >> (8 * c);
          a[k][r] = wg::codes2<T>((t & 0xFu) | ((t & 0xF0u) << 12));
        }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint32_t t =
              W[(4 * j + 2 * (r / 2) + c / 2) * wg::kBN + ch + 8 * (r % 2)] >> (16 * (c % 2));
          a[j][r] = wg::codes2<T>((t & 0xFu) | ((t & 0xF00u) << 8));
          a[4 + j][r] = wg::codes2<T>(((t >> 4) & 0xFu) | ((t & 0xF000u) << 4));
        }
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

  // the group sums of x from the stage's tiles: thread (group p, token) =
  // tid / 4 sums 8 elements of tile 2p + tid % 4 / 2, 16-byte half tid % 2
  // (the swizzle moves whole halves, so element e of a half is k parity e
  // % 2); pair rounds its even and odd sums to T and adds them in T,
  // hsplit rounds one sum
  template <int MT>
  static __device__ __forceinline__ void fold(float (&acc)[MT / 2], float (&d)[kParts][MT / 2],
                                              const uint8_t* x, const uint8_t*,
                                              const uint8_t* st, int ch, int c, int i,
                                              const wg::Params& p) {
    static_assert(MT == kMaxMT, "the x sums cover a 16-token tile");
    __shared__ float sxs[2][4][16];  // [stage parity][group][token]
    const int tid = threadIdx.x;
    {
      const int q = tid / 4, g = q / 16, tok = q % 16;
      const uint4 v = *reinterpret_cast<const uint4*>(
          x + (2 * g + (tid % 4) / 2) * MT * wg::kTileRow + tok * wg::kTileRow + 16 * (tid % 2));
      const uint32_t u[4] = {v.x, v.y, v.z, v.w};
      float even = 0.f, odd = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const V e = wg::from_bits<V>(u[j]);
        even += wg::Vec2<T>::to_f(e.x);
        odd += wg::Vec2<T>::to_f(e.y);
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        even += __shfl_xor_sync(0xffffffffu, even, o);
        odd += __shfl_xor_sync(0xffffffffu, odd, o);
      }
      if (tid % 4 == 0)
        sxs[i & 1][g][tok] = L == kPair ? rnd<T>(rnd<T>(even) + rnd<T>(odd)) : rnd<T>(even + odd);
    }
    asm volatile("bar.sync 1, 256;" ::: "memory");
    fold_groups<T, MT>(acc, d, st, ch, c, p,
                       [&](int g, int tok) { return sxs[i & 1][g][tok]; });
  }
};

// f32: A = the raw codes (exact in TF32), x split by gp_f32_prologue into
// TF32 hi and lo planes: two products a step (x_hi.A + x_lo.A), sixteen
// k8 steps a stage, four per group into the group's fresh fragment; the
// prologue also writes each group's f32 sum of x, in stage order
template <int L>
struct GpF32 {
  using T = float;
  static constexpr int kSteps = 16, kTiles = 32, kARegs = 4, kParts = 4, kMaxMT = 16;
  static constexpr int kWBytes = kRows * wg::kBN * 4;
  static constexpr int kScaleBytes = 4 * wg::kBN * 4;           // scales or minima: [4][128]
  static constexpr int kSBytes = 2 * kScaleBytes + 16 * 4 * 4;  // and the x sums [16][4]

  // maps: x the split planes [2][M][K] (box [2][16][8], 32-byte swizzle:
  // the hi tile, then the lo tile); words, scales, minima as GpHalf; o the
  // group sums [M][G] in stage order (box [16][4])
  static __device__ __forceinline__ void load(const wg::Maps& mp, uint8_t* x, uint8_t* w,
                                              uint8_t* s, uint64_t* bar, int t, int m0, int n0,
                                              int MT, const wg::Params& p) {
    // step k: pair k 128t + 8k; hsplit half k / 8 at 64t + 8 (k % 8)
#pragma unroll
    for (int k = 0; k < kSteps; ++k)
      wg::tma_load_3d(x + 2 * k * MT * wg::kTileRow, &mp.x, bar,
                      L == kPair ? 128 * t + 8 * k : (k / 8) * (p.K / 2) + 64 * t + 8 * (k % 8),
                      m0, 0);
    load_words_scales<L>(mp, w, s, bar, t, n0, kScaleBytes);
    wg::tma_load_2d(s + 2 * kScaleBytes, &mp.o, bar, 4 * t, m0);
  }

  // A of a k8 step: a[0] = (channel ch, position c), a[1] = (ch + 8, c),
  // a[2] = (ch, c + 4), a[3] = (ch + 8, c + 4);
  //   pair step k: word row k, nibbles c and c + 4;
  //   hsplit steps j and 8 + j: word rows 2j (position c) and 2j + 1
  //   (c + 4), byte c, low nibble (half 0) or high (half 1)
  static __device__ __forceinline__ void dequant(uint32_t (&a)[kSteps][4], const uint8_t* wt,
                                                 const uint8_t*, int ch, int c,
                                                 const wg::Params&) {
    const uint32_t* W = reinterpret_cast<const uint32_t*>(wt);
    if constexpr (L == kPair) {
#pragma unroll
      for (int k = 0; k < kSteps; ++k)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint32_t w = W[k * wg::kBN + ch + 8 * (r % 2)];
          a[k][r] = __float_as_uint(static_cast<float>((w >> (4 * (c + 4 * (r / 2)))) & 0xFu));
        }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint32_t w = W[(2 * j + r / 2) * wg::kBN + ch + 8 * (r % 2)] >> (8 * c);
          a[j][r] = __float_as_uint(static_cast<float>(w & 0xFu));
          a[8 + j][r] = __float_as_uint(static_cast<float>((w >> 4) & 0xFu));
        }
    }
  }

  template <int MT>
  static __device__ __forceinline__ void issue(float (&d)[kParts][MT / 2],
                                               const uint32_t (&a)[kSteps][4],
                                               const uint8_t* x) {
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const uint64_t xh = wg::desc_sw32(x + 2 * k * MT * wg::kTileRow);
      const uint64_t xl = wg::desc_sw32(x + (2 * k + 1) * MT * wg::kTileRow);
      wg::Wgmma<MT, float>::mma(d[k / 4], a[k], xh, k % 4);
      wg::Wgmma<MT, float>::mma(d[k / 4], a[k], xl);
    }
  }

  template <int MT>
  static __device__ __forceinline__ void fold(float (&acc)[MT / 2], float (&d)[kParts][MT / 2],
                                              const uint8_t*, const uint8_t*,
                                              const uint8_t* st, int ch, int c, int,
                                              const wg::Params& p) {
    static_assert(MT == kMaxMT, "the x sums cover a 16-token tile");
    const float* sums = reinterpret_cast<const float*>(st + 2 * kScaleBytes);  // [16][4]
    fold_groups<float, MT>(acc, d, st, ch, c, p,
                           [&](int g, int tok) { return sums[tok * 4 + g]; });
  }
};

// f32: xs [2][M][K], plane 0 tf32(x), plane 1 tf32(x - hi); sums [M][G],
// column 4t + p the f32 sum of x over part p of stage t's group (pair:
// the even and the odd elements summed apart, then added)
template <int L>
__global__ void gp_f32_prologue(const float* __restrict__ x, float* __restrict__ xs,
                                float* __restrict__ sums, int M, int K) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < M * K) {
    const float v = x[i];
    const uint32_t hi = wg::tf32(v);
    xs[i] = __uint_as_float(hi);
    xs[static_cast<size_t>(M) * K + i] = __uint_as_float(wg::tf32(v - __uint_as_float(hi)));
  }
  const int G = K / 32;
  if (i < M * G) {
    const int m = i / G, col = i % G, t = col / 4, part = col % 4;
    const int g = L == kPair ? col : (part / 2) * (G / 2) + 2 * t + part % 2;
    const float* xg = x + static_cast<size_t>(m) * K + 32 * g;
    float even = 0.f, odd = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      even += xg[2 * j];
      odd += xg[2 * j + 1];
    }
    sums[i] = even + odd;
  }
}

// scales/minima maps: pair [G][N] (box [4][128]); hsplit [2][G/2][N] (box
// [2][2][128]: the stage's two groups of each half)
template <int L, typename T>
bool scale_maps(wg::Maps& maps, const void* s, const void* z, int G, int N) {
  const size_t es = sizeof(T);
  const CUtensorMapDataType dt = map_type<T>();
  if (L == kPair)
    return wg::map_2d(&maps.s, dt, s, N, G, N * es, wg::kBN, 4) &&
           wg::map_2d(&maps.z, dt, z, N, G, N * es, wg::kBN, 4);
  return wg::map_3d(&maps.s, dt, s, N, G / 2, 2, N * es, G / 2 * N * es, wg::kBN, 2, 2) &&
         wg::map_3d(&maps.z, dt, z, N, G / 2, 2, N * es, G / 2 * N * es, wg::kBN, 2, 2);
}

template <int L, typename T>
cudaError_t launch_tc(const void* x, void* xt, const void* w, const void* s, const void* z,
                      float* partial, void* out, int M, int K, int N, int sym, int out_f32,
                      int splits, int per, cudaStream_t st) {
  const int G = K / 32, steps = K / 128;
  if ((splits - 1) * per >= steps || splits * per < steps) return cudaErrorInvalidValue;
  const size_t es = sizeof(T);
  wg::Maps maps;
  bool ok = wg::map_2d(&maps.w, CU_TENSOR_MAP_DATA_TYPE_UINT32, w, N, K / 8, N * 4ull, wg::kBN,
                       kRows) &&
            scale_maps<L, T>(maps, s, sym ? s : z, G, N);
  wg::Params p{M, N, K, steps, per, sym, kMaxInt, out_f32, partial, out};
  cudaError_t err;
  if constexpr (std::is_same<T, float>::value) {
    if (xt == nullptr) return cudaErrorInvalidValue;
    float* xs = static_cast<float*>(xt);
    float* sums = xs + 2 * static_cast<size_t>(M) * K;
    const int threads = 256;
    gp_f32_prologue<L><<<(M * K + threads - 1) / threads, threads, 0, st>>>(
        static_cast<const float*>(x), xs, sums, M, K);
    ok = ok &&
         wg::map_3d(&maps.x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, xs, K, M, 2, K * 4ull,
                    static_cast<size_t>(M) * K * 4, 8, 16, 2, CU_TENSOR_MAP_SWIZZLE_32B) &&
         wg::map_2d(&maps.o, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, sums, G, M, G * 4ull, 4, 16);
    if (!ok) return cudaErrorInvalidValue;
    err = wg::launch<GpF32<L>, 16>(maps, p, splits, st);
  } else {
    ok = ok && wg::map_2d(&maps.x, map_type<T>(), x, K, M, K * es, 16, 16,
                          CU_TENSOR_MAP_SWIZZLE_32B);
    if (!ok) return cudaErrorInvalidValue;
    err = wg::launch<GpHalf<L, T>, 16>(maps, p, splits, st);
  }
  if (err == cudaSuccess && partial != nullptr)
    int4k::launch_reduce<T>(partial, out, splits, M * N, out_f32, st);
  return err;
}

template <typename T>
cudaError_t launch_tc_layout(int layout, const void* x, void* xt, const void* w, const void* s,
                             const void* z, float* partial, void* out, int M, int K, int N,
                             int sym, int out_f32, int splits, int per, cudaStream_t st) {
  if (layout == kPair)
    return launch_tc<kPair, T>(x, xt, w, s, z, partial, out, M, K, N, sym, out_f32, splits, per,
                               st);
  if (layout == kHsplit)
    return launch_tc<kHsplit, T>(x, xt, w, s, z, partial, out, M, K, N, sym, out_f32, splits,
                                 per, st);
  return cudaErrorInvalidValue;
}

// Call f(gs::Body<GpStream<layout, T>, 1>()) on the streaming body of
// (layout, dtype) (cudaErrorInvalidValue for another).
template <class F>
cudaError_t with_stream_body(int layout, int dtype, F f) {
  auto go = [&](auto tag) {
    using T = decltype(tag);
    return layout == kPair ? f(gs::Body<GpStream<kPair, T>, 1>())
                           : f(gs::Body<GpStream<kHsplit, T>, 1>());
  };
  if (layout != kPair && layout != kHsplit) return cudaErrorInvalidValue;
  switch (dtype) {
    case int4k::kBF16: return go(__nv_bfloat16());
    case int4k::kF16: return go(__half());
    case int4k::kF32: return go(0.f);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// The streaming body, M = 1. layout: 0 pair, 1 hsplit; dtype:
// int4k::DType of x, s and z. x [1, K]; w int32 words [K/8, N] (a layer's
// block); s, z [K/32, N] (z null when sym); `parts` split-K parts of `per`
// 128-k stages (at most gs::kMaxPer), with partial f32 [parts, 1, N] and
// tickets int32 [ceil(N / 256)], zero, when parts > 1 (else null); out
// [1, N] in the compute type (out_f32 = 0) or f32. Needs K % 128 == 0, N %
// 8 == 0 and 16-byte aligned bases. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a refused plan).
extern "C" int mlc_gemv_gp(int layout, int dtype, const void* x, const void* w, const void* s,
                           const void* z, void* partial, void* tickets, void* out, int M, int K,
                           int N, int out_f32, int parts, int per, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const gs::Params p{x, static_cast<const uint8_t*>(w), static_cast<const uint8_t*>(s),
                     static_cast<const uint8_t*>(z), static_cast<float*>(partial),
                     static_cast<int*>(tickets), out, K, N, K / 32, K / 128, per, parts,
                     out_f32};
  if (M != 1 || K % 128 != 0 || N % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      with_stream_body(layout, dtype, [&](auto body) { return gs::launch(body, p, st); }));
}

// The blocks of the streaming body of (layout, dtype) an SM holds, into *n.
extern "C" int mlc_gemv_gp_blocks(int layout, int dtype, int* n) {
  return static_cast<int>(
      with_stream_body(layout, dtype, [&](auto body) { return gs::blocks_per_sm(body, n); }));
}

// The tensor-core body, 2 <= M <= 8: the arguments of mlc_gemv_gp, with xt
// the f32 prologue's scratch (f32: [2, M, K] TF32 planes then [M, K/32]
// group sums, f32; bf16/f16: null), `splits` split-K parts of `per` stages
// (128 k a stage) and partial f32 [splits, M, N] when splits > 1 (else
// null). Needs K % 128 == 0, N % 128 == 0 and 16-byte
// aligned bases (TMA). Returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for a refused tensor map or plan).
extern "C" int mlc_gemv_gp_tc(int layout, int dtype, const void* x, void* xt, const void* w,
                              const void* s, const void* z, void* partial, void* out, int M,
                              int K, int N, int sym, int out_f32, int splits, int per,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = splits > 1 ? static_cast<float*>(partial) : nullptr;
  if (M < 2 || M > 8 || splits < 1 || per < 1 || (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (dtype) {
    case int4k::kBF16:
      err = launch_tc_layout<__nv_bfloat16>(layout, x, xt, w, s, z, part, out, M, K, N, sym,
                                            out_f32, splits, per, st);
      break;
    case int4k::kF16:
      err = launch_tc_layout<__half>(layout, x, xt, w, s, z, part, out, M, K, N, sym, out_f32,
                                     splits, per, st);
      break;
    case int4k::kF32:
      err = launch_tc_layout<float>(layout, x, xt, w, s, z, part, out, M, K, N, sym, out_f32,
                                    splits, per, st);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
