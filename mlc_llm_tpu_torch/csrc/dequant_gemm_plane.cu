// Dequant GEMM for the sym low-bit formats: int3 in u32 words (10 codes a
// word) and in u16 words (5), fp4 in u32 words (8), and int8 planes.
//
// Replaces the Pallas kernels mlc_llm_tpu/ops/pallas/dequant_matmul.py
// _kernel (the generic branch of _dequant_matmul_2d, flat weights) and
// _kernel_stacked_generic (_dequant_matmul_stacked_generic_2d, layer-stacked
// weights read in place): one templated kernel, the layer a pointer offset.
// Same math, same rounding points:
//   word kw holds k = kw * epw + i at bits i * nbit; each weight is rebuilt
//   in bf16 as bf16(value(code) * s) (dequant_matmul.py:396), where value is
//   the raw code for int3, +-2^(e-7) (0 when e == 0) for fp4, and the
//   stored signed byte for int8; then acc += x @ w in f32; int3 adds the
//   folded offset term (none for fp4 and int8):
//     sum_kw bf16(sum_i x[kw * epw + i]) * off[g(kw)],  off = bf16(-max_int * s).
//
// Bound on the H100: bytes at decode widths (m <= ~185 at 3.6 bits a weight
// against the ~295 flops/byte ridge), the bf16 tensor-core rate above.
//
// The Hopper mainloop of dequant_wgmma.cuh (wgmma, the weight as the
// register A operand, a TMA ring), with A streamed one k16 step at a time
// (kStream: two A buffers, so an m tile of 256 tokens fits the registers
// beside its accumulator and each warpgroup's dequant of a step overlaps
// its own MMA of the step before). x arrives in the TPU wrapper's
// plane-transposed order x_t[f, m, kw] = x[m, kw * epw + f] (+ for int3 one
// more plane, the bf16 word sums of x), made by plane_x_kernel, a prologue
// launched by the same entry (int8 reads x itself as its one plane). A
// stage is one chunk of 16 consecutive words (int8: four chunks of 16
// rows): a k16 step is field f of the chunk's words, so the chunk's words
// feed epw steps. A thread (channels ch, ch+8; k group c) reads words 2c,
// 2c+1 and 2c+8, 2c+9 of its two channels; each pair lies in one group
// (4 words for int3/u32 and fp4, 8 for u16, 32 rows for int8), so one
// scale pair multiplies it (one __hmul2_rn: the body's one rounding).
// int3's offset is one more k16 step on the tensor cores: A holds off
// (constant over a group's words), B the word-sum plane. Group counts that
// are no multiple of a chunk read zeros past the stored words, scales and
// x (TMA fills out of bounds with zeros; the x_t planes are zero-padded).
// The m tile (up to 256, 128 for int3/u32), the split-K parts and the
// stages per part come from the Python wrapper (ops/dequant_matmul.py
// plane_tiles).

#include "dequant_wgmma.cuh"
#include "int4_common.cuh"

namespace {

enum Format { kI3W32 = 0, kI3W16 = 1, kF4W32 = 2, kI8 = 3 };

template <int F>
struct Fmt;
template <>
struct Fmt<kI3W32> {
  using Word = uint32_t;
  static constexpr int kEpw = 10, kWpg = 4, kChunks = 1;
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_UINT32;
};
template <>
struct Fmt<kI3W16> {
  using Word = uint16_t;
  static constexpr int kEpw = 5, kWpg = 8, kChunks = 1;
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_UINT16;
};
template <>
struct Fmt<kF4W32> {
  using Word = uint32_t;
  static constexpr int kEpw = 8, kWpg = 4, kChunks = 1;
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_UINT32;
};
template <>
struct Fmt<kI8> {  // one signed code a byte: no fields, no offset term
  using Word = int8_t;
  static constexpr int kEpw = 1, kWpg = 32, kChunks = 4;
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_UINT8;
};

template <int F>
constexpr bool kOffset = F == kI3W32 || F == kI3W16;

// A thread's words and scales of one fetch: for rows (ch, words 2c, 2c+1),
// (ch+8, the same), (ch, words 2c+8, 2c+9), (ch+8, the same), the low and
// the high word of the pair and the pair's scale, duplicated. Two formats
// pack a pair into lo alone, the low word in bits 0-15: int3/u16 (both
// words), and fp4, which fetches a chunk in two halves of four fields (a
// word's bits 0-15, then 16-31), so that 4 registers hold a pair's codes
// as for int3/u16, and the m64n256 accumulator still fits beside them
struct PlaneChunk {
  uint32_t lo[4], hi[4];
  __nv_bfloat162 sc[4];
};

// the bf16x2 bits of the unscaled values of field f of pair r (low half:
// the low word), exact
template <int F>
__device__ __forceinline__ uint32_t value_pair(const PlaneChunk& w, int r, int f) {
  if constexpr (F == kI8) {
    return wg::bits(__floats2bfloat162_rn(static_cast<float>(static_cast<int8_t>(w.lo[r])),
                                          static_cast<float>(static_cast<int8_t>(w.hi[r]))));
  } else if constexpr (F == kF4W32) {
    // field f of the half: both codes at once, one a 16-bit lane;
    // +-2^(e-7): exponent field e + 120, sign bit 15; 0 when e == 0
    const uint32_t t = (w.lo[r] >> (4 * f)) & 0x000F000Fu;
    const uint32_t e = t & 0x00070007u;
    const uint32_t nz = __vcmpne2(e, 0u);  // 0xFFFF a lane where e != 0
    return ((((e + 0x00780078u) << 7) | ((t & 0x00080008u) << 12)) & nz);
  } else {
    // int3: 128 + code exactly (bf16 128.0 is 0x4300, its ulp 1), less 128
    const uint32_t t =
        F == kI3W16 ? ((w.lo[r] >> (3 * f)) & 0x00070007u) | 0x43004300u
                    : ((w.lo[r] >> (3 * f)) & 7u) | (((w.hi[r] >> (3 * f)) & 7u) << 16) | 0x43004300u;
    return wg::bits(__hsub2(wg::from_bits<__nv_bfloat162>(t), __float2bfloat162_rn(128.f)));
  }
}

template <int F>
struct PlanePolicy {
  using T = __nv_bfloat16;
  using Word = typename Fmt<F>::Word;
  using Chunk = PlaneChunk;
  static constexpr int kEpw = Fmt<F>::kEpw, kWpg = Fmt<F>::kWpg, kChunks = Fmt<F>::kChunks;
  static constexpr int kPlanes = kEpw + (kOffset<F> ? 1 : 0);  // x_t planes
  static constexpr int kHalves = F == kF4W32 ? 2 : 1;  // fetches a chunk
  static constexpr int kSteps = kChunks * kPlanes, kChunkSteps = kPlanes / kHalves;
  static constexpr int kTiles = kSteps, kARegs = 4, kParts = 0;
  // the ring holds three stages of [256][32 bytes] x tiles for 6 (int3/u16),
  // 8 (fp4) and 4 (int8) tiles a stage in 225 KB, not for int3/u32's 11;
  // the formats with the m tile of 256 stream A per k16 step (its
  // accumulator leaves no room for a stage's fragments), int3/u32 builds a
  // stage's 11 steps at once in the mainloop's usual ring (faster at its
  // widest tile, 128)
  static constexpr int kMaxMT = F == kI3W32 ? 128 : 256;
  static constexpr bool kStream = kMaxMT == 256;
  static constexpr int kRingBytes = kMaxMT == 256 ? 225 * 1024 : wg::kRingBudget;
  static constexpr int kRows = 16 * kChunks;                    // word rows a stage
  static constexpr int kSRows = kRows / kWpg > 0 ? kRows / kWpg : 1;
  static constexpr int kWBytes = kRows * wg::kBN * sizeof(Word);
  static constexpr int kSBytes = kSRows * wg::kBN * 2;

  // maps: x_t [planes][M][KWp] (box [planes][MT][16], 32-byte swizzle);
  // words [KW][N] (box [kRows][128]); scales [G][N] (box [kSRows][128])
  static __device__ __forceinline__ void load(const wg::Maps& mp, uint8_t* x, uint8_t* w,
                                              uint8_t* s, uint64_t* bar, int t, int m0, int n0,
                                              int MT, const wg::Params& p) {
#pragma unroll
    for (int j = 0; j < kChunks; ++j)
      wg::tma_load_3d(x + j * kPlanes * MT * wg::kTileRow, &mp.x, bar, 16 * (kChunks * t + j),
                      m0, 0);
    wg::tma_load_2d(w, &mp.w, bar, n0, kRows * t);
    wg::tma_load_2d(s, &mp.s, bar, n0, kRows * t / kWpg);
  }

  // fetch j's words and scales of channels ch and ch + 8, k group c (chunk
  // j / kHalves; fp4's half j % 2); each pair lies in one group, so one
  // scale multiplies it
  static __device__ __forceinline__ Chunk fetch(const uint8_t* wt, const uint8_t* st, int ch,
                                                int c, int j, const wg::Params&) {
    const Word* W = reinterpret_cast<const Word*>(wt);
    const __nv_bfloat16* S = reinterpret_cast<const __nv_bfloat16*>(st);
    Chunk x;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 16 * (j / kHalves) + 2 * c + 8 * (r / 2), col = ch + 8 * (r % 2);
      const Word lo = W[row * wg::kBN + col], hi = W[(row + 1) * wg::kBN + col];
      if constexpr (F == kI3W16) {
        x.lo[r] = static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
        x.hi[r] = 0u;
      } else if constexpr (F == kF4W32) {
        const uint32_t l = lo, h = hi;
        x.lo[r] = j % 2 == 0 ? (l & 0xFFFFu) | (h << 16) : (l >> 16) | (h & 0xFFFF0000u);
        x.hi[r] = 0u;
      } else {
        x.lo[r] = static_cast<uint32_t>(lo);
        x.hi[r] = static_cast<uint32_t>(hi);
      }
      x.sc[r] = __bfloat162bfloat162(S[(row / kWpg) * wg::kBN + col]);
    }
    return x;
  }


  // the stage at once (kStream false): every step's A, fetch by fetch
  static __device__ __forceinline__ void dequant(uint32_t (&a)[kSteps][4], const uint8_t* wt,
                                                 const uint8_t* st, int ch, int c,
                                                 const wg::Params& p) {
#pragma unroll
    for (int j = 0; j < kSteps / kChunkSteps; ++j) {
      const Chunk w = fetch(wt, st, ch, c, j, p);
#pragma unroll
      for (int f = 0; f < kChunkSteps; ++f) dequant_step(f, a[j * kChunkSteps + f], w, p);
    }
  }

  // A of step f of a chunk: bf16(value * s) of field f (one __hmul2_rn),
  // or for int3's offset step (f == epw) off = bf16(-max_int * s)
  static __device__ __forceinline__ void dequant_step(int f, uint32_t (&a)[4], const Chunk& w,
                                                      const wg::Params& p) {
    if (kOffset<F> && f == kEpw) {
      const __nv_bfloat162 neg_max = __float2bfloat162_rn(static_cast<float>(-p.max_int));
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = wg::bits(__hmul2_rn(w.sc[r], neg_max));
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[r] = wg::bits(
            __hmul2_rn(wg::from_bits<__nv_bfloat162>(value_pair<F>(w, r, f)), w.sc[r]));
    }
  }
};

// x [M][KW * epw] -> x_t [planes][M][KWp]: plane f < epw holds
// x[m, kw * epw + f], int3's plane epw the bf16 word sum (f32, in field
// order); zero for KW <= kw < KWp
template <int F>
__global__ void plane_x_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ xt,
                               int M, int KW, int KWp) {
  constexpr int E = Fmt<F>::kEpw;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * KWp) return;
  const int m = i / KWp, kw = i % KWp;
  float sum = 0.f;
#pragma unroll
  for (int f = 0; f < E; ++f) {
    const __nv_bfloat16 v =
        kw < KW ? x[static_cast<size_t>(m) * KW * E + kw * E + f] : __float2bfloat16(0.f);
    xt[(static_cast<size_t>(f) * M + m) * KWp + kw] = v;
    sum += __bfloat162float(v);
  }
  if constexpr (kOffset<F>) xt[(static_cast<size_t>(E) * M + m) * KWp + kw] = __float2bfloat16(sum);
}

template <int F>
cudaError_t launch(const void* x, void* xt, const void* w, const void* s, float* partial,
                   void* out, int M, int G, int N, int mt, int splits, int per, int max_int,
                   int out_f32, cudaStream_t st) {
  using P = PlanePolicy<F>;
  const int rows = F == kI8 ? 32 * G : G * Fmt<F>::kWpg;  // stored word rows (int8: K)
  const int steps = (rows + P::kRows - 1) / P::kRows;
  if ((splits - 1) * per >= steps || splits * per < steps) return cudaErrorInvalidValue;
  wg::Maps maps;
  bool ok;
  if constexpr (F == kI8) {
    ok = wg::map_3d(&maps.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, rows, M, 1, rows * 2ull,
                    static_cast<size_t>(M) * rows * 2, 16, mt, 1, CU_TENSOR_MAP_SWIZZLE_32B);
  } else {
    const int kwp = (rows + 7) / 8 * 8;  // 16-byte rows of x_t
    const int threads = 256;
    plane_x_kernel<F><<<(M * kwp + threads - 1) / threads, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(xt), M, rows, kwp);
    ok = wg::map_3d(&maps.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, xt, kwp, M, P::kPlanes,
                    kwp * 2ull, static_cast<size_t>(M) * kwp * 2, 16, mt, P::kPlanes,
                    CU_TENSOR_MAP_SWIZZLE_32B);
  }
  ok = ok &&
       wg::map_2d(&maps.w, Fmt<F>::kType, w, N, rows, static_cast<size_t>(N) * sizeof(typename Fmt<F>::Word),
                  wg::kBN, P::kRows) &&
       wg::map_2d(&maps.s, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, s, N, G, N * 2ull, wg::kBN, P::kSRows);
  if (!ok) return cudaErrorInvalidValue;
  maps.z = maps.s;
  wg::Params p{M, N, rows, steps, per, 1, max_int, out_f32, partial, out};
  cudaError_t err = wg::launch_mt<P>(mt, maps, p, splits, st);
  if (err == cudaSuccess && partial != nullptr)
    int4k::launch_reduce<__nv_bfloat16>(partial, out, splits, M * N, out_f32, st);
  return err;
}

}  // namespace

// fmt: enum Format. x [M, K] bf16 with K = G * (k per group), 16-byte
// aligned; xt bf16 scratch [planes, M, KWp] (planes = epw, + 1 for int3;
// KWp = the word rows rounded up to 8; null for int8); w words [G * words
// per group, N] (int8: [K, N]), a layer's block; s [G, N] bf16; out [M, N]
// in bf16 (out_f32 = 0) or f32. The m tile mt in {16, 64, 128, 256} (not
// 256 for int3/u32), `splits`
// split-K parts of `per` stages (16 word rows a stage; int8: 64 rows),
// partial f32 [splits, M, N] when splits > 1, else null. Needs N % 128 ==
// 0 and 16-byte aligned bases. Returns cudaGetLastError() after the
// launches (cudaErrorInvalidValue for a refused tensor map or plan).
extern "C" int mlc_gemm_plane(int fmt, const void* x, void* xt, const void* w, const void* s,
                              void* partial, void* out, int M, int G, int N, int mt, int splits,
                              int per, int max_int, int out_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = splits > 1 ? static_cast<float*>(partial) : nullptr;
  if (splits < 1 || per < 1 || (splits > 1 && part == nullptr) ||
      (fmt != kI8 && xt == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (fmt) {
    case kI3W32:
      err = launch<kI3W32>(x, xt, w, s, part, out, M, G, N, mt, splits, per, max_int, out_f32, st);
      break;
    case kI3W16:
      err = launch<kI3W16>(x, xt, w, s, part, out, M, G, N, mt, splits, per, max_int, out_f32, st);
      break;
    case kF4W32:
      err = launch<kF4W32>(x, xt, w, s, part, out, M, G, N, mt, splits, per, max_int, out_f32, st);
      break;
    case kI8:
      err = launch<kI8>(x, xt, w, s, part, out, M, G, N, mt, splits, per, max_int, out_f32, st);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
