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
// m = 1 (bf16, f16, f32) and f32 at every m <= 8 run QsStream, the
// qsplit policy of the weight-streaming mainloop of gemv_stream.cuh (see
// there for the design and what bounds it): a word of a thread's column
// gives 8 codes, each 16 + q as f32 bits (gs::code16: one shift, one
// lop3), one FMA each into the partial of its quarter's group; a stage
// (16 word rows) is one group of each quarter, so P and the fold of every
// group finish inside the stage. One launch a call.
//
// bf16 and f16 at 2 <= m <= 8 run on the tensor cores (GpPolicy, a policy
// of the wgmma mainloop of dequant_wgmma.cuh, m tile 16). A SIMT body
// redoes the nibble extract, the code's conversion and an fmaf for every
// weight and every row: ~40 instructions a weight at m = 8,
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

#include "gemv_stream.cuh"

namespace {

using int4k::Num;
using int4k::rnd;

// m = 1 (and f32 at m <= 8): stage t holds group t of each quarter f, word
// row rr the quarter's elements 2 rr (bits 4f) and 2 rr + 1 (bits 16 + 4f);
// staged x of a row: value e = 2f + h is quarter f's element 2 rr + h. A
// part's x is four chunks, one a quarter.
template <typename TT>
struct QsStream {
  using T = TT;
  static constexpr int kWordBytes = 4, kGroups = 4, kStages = 2;
  static constexpr int kScaleOffset = gs::kRows * gs::kCols * kWordBytes;
  static constexpr int kStageBytes = kScaleOffset + 2 * kGroups * gs::kCols * sizeof(T);
  static constexpr int kStageX = 128, kChunks = 4;

  static __device__ __forceinline__ int scale_row(int t, int j, int G) { return j * (G / 4) + t; }
  static __device__ __forceinline__ int chunk_k(int c, int t0, int K) {
    return c * (K / 4) + 32 * t0;
  }
  static __device__ __forceinline__ int raw_index(int i, int rr, int e, int n) {
    return (e / 2) * 32 * n + 32 * i + 2 * rr + e % 2;
  }
  // quarter j's group: lane = element (row lane / 2, half lane % 2); one
  // f32 sum rounded to T
  static __device__ __forceinline__ float group_sum(const float* xst, int j, int m, int M,
                                                    int lane) {
    float v = xst[((lane / 2) * M + m) * gs::kXRow + 2 * j + lane % 2];
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
      for (int f = 0; f < 4; ++f)
#pragma unroll
        for (int cc = 0; cc < C; ++cc) p[m][f][cc] = 0.f;
#pragma unroll
    for (int rr = 0; rr < gs::kRows; ++rr) {
      uint32_t w[C];
      gs::load_words(st + rr * gs::kCols * kWordBytes, c, w);
      float q[C][8];
#pragma unroll
      for (int cc = 0; cc < C; ++cc)
#pragma unroll
        for (int e = 0; e < 8; ++e) q[cc][e] = gs::code16(w[cc], 4 * (e / 2) + 16 * (e % 2));
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float4* xr = reinterpret_cast<const float4*>(xst + (rr * M + m) * gs::kXRow);
        const float4 a = xr[0], b = xr[1];
        const float xv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int e = 0; e < 8; ++e)
#pragma unroll
          for (int cc = 0; cc < C; ++cc)
            p[m][e / 2][cc] = fmaf(xv[e], q[cc][e], p[m][e / 2][cc]);
      }
    }
    // y += s * (P - 16 sx) + z * sx (sym: s * (P - 23 sx)), f32 scales
    const T* S = reinterpret_cast<const T*>(st + kScaleOffset);
    const T* Z = S + kGroups * gs::kCols;
    const float base = asym ? 16.f : 23.f;
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      float s[C], z[C];
      gs::load_cols(S + f * gs::kCols, c, s);
      if (asym) {
        gs::load_cols(Z + f * gs::kCols, c, z);
      } else {
#pragma unroll
        for (int cc = 0; cc < C; ++cc) z[cc] = 0.f;
      }
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float v = sx[f * M + m];
#pragma unroll
        for (int cc = 0; cc < C; ++cc) acc[m][cc] += s[cc] * (p[m][f][cc] - base * v) + z[cc] * v;
      }
    }
  }
};

// Call f(gs::Body<P, M>()) on the streaming body of (dtype, M): bf16 and
// f16 at M = 1, f32 at 1 <= M <= 8 (cudaErrorInvalidValue for another).
template <class F>
cudaError_t with_stream_body(int dtype, int M, F f) {
  switch (dtype) {
    case int4k::kBF16:
      return M == 1 ? f(gs::Body<QsStream<__nv_bfloat16>, 1>()) : cudaErrorInvalidValue;
    case int4k::kF16:
      return M == 1 ? f(gs::Body<QsStream<__half>, 1>()) : cudaErrorInvalidValue;
    case int4k::kF32:
      switch (M) {
        case 1: return f(gs::Body<QsStream<float>, 1>());
        case 2: return f(gs::Body<QsStream<float>, 2>());
        case 3: return f(gs::Body<QsStream<float>, 3>());
        case 4: return f(gs::Body<QsStream<float>, 4>());
        case 5: return f(gs::Body<QsStream<float>, 5>());
        case 6: return f(gs::Body<QsStream<float>, 6>());
        case 7: return f(gs::Body<QsStream<float>, 7>());
        case 8: return f(gs::Body<QsStream<float>, 8>());
      }
  }
  return cudaErrorInvalidValue;
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

// The streaming body. dtype: int4k::DType of x, s and z. x [M, K]; w
// int32 words [K/8, N] (a layer's block); s, z [K/32, N] (z null when
// sym); `parts` split-K parts of `per` 128-k stages (at most gs::kMaxPer),
// with partial f32 [parts, M, N] and tickets int32 [ceil(N / 256)], zero,
// when parts > 1 (else null); out [M, N] in the compute type (out_f32 = 0)
// or f32. M = 1, or f32 at 1 <= M <= 8. Needs K % 128 == 0, N % 8 == 0 and
// 16-byte aligned bases. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a refused plan).
extern "C" int mlc_gemv_qs(int dtype, const void* x, const void* w, const void* s,
                           const void* z, void* partial, void* tickets, void* out, int M, int K,
                           int N, int out_f32, int parts, int per, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const gs::Params p{x, static_cast<const uint8_t*>(w), static_cast<const uint8_t*>(s),
                     static_cast<const uint8_t*>(z), static_cast<float*>(partial),
                     static_cast<int*>(tickets), out, K, N, K / 32, K / 128, per, parts,
                     out_f32};
  if (K % 128 != 0 || N % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      with_stream_body(dtype, M, [&](auto body) { return gs::launch(body, p, st); }));
}

// The blocks of the streaming body of (dtype, M) an SM holds, into *n.
extern "C" int mlc_gemv_qs_blocks(int dtype, int M, int* n) {
  return static_cast<int>(
      with_stream_body(dtype, M, [&](auto body) { return gs::blocks_per_sm(body, n); }));
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
