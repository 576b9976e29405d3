// Group-partial int3 dequant GEMV for u16 words (q3*_s16: sym, group 40).
//
// Replaces the Pallas kernel mlc_llm_tpu/ops/pallas/dequant_matmul.py
// _dequant_matmul_gp3_2d -> _kernel_gp3 / _kernel_gp3_stacked with _gp3_body
// (every decode matmul at m <= 2 when the group count divides by 16). Same
// math, same rounding points:
//   u16 word r of a column holds k = 5r + i at bits 3i (i < 5); a group is
//   8 words = 40 k (the natural order: the TPU's plane transpose and
//   block-diagonal banding only feed its matrix unit);
//   per group g:  P  = sum_k x[k] * (8 + q[k])                 (f32)
//                 sx = sum_i T(sum_r x[5r + i])  (each field's 8-element
//                      sum rounded to the compute type T, x's: bf16 or
//                      f16, as the TPU's row sums of its T x planes)
//   y += s * (P - (8 + max_int) * sx)                          (f32 scales)
// The codes 8 + q are exact in both types, so only the x staging, the
// sums' rounding and the scales depend on T.
//
// Bound on the H100: bytes. A weight is 3.2 bits of word plus 0.4 bits of
// 16-bit scale, ~1.3 flops per byte, far below the ~295 flops/byte ridge
// (Vicuna-7B w_in, 51.9 MB stored: 15.5 us at 3.35 TB/s).
//
// Gp3Stream is the int3/u16 policy of the weight-streaming mainloop of
// gemv_stream.cuh (see there for the design): a stage is 16 u16 word rows
// = two groups (80 k); a consumer thread's two columns are one 4-byte
// shared-memory read a row (the first column in the low halfword), each
// of its ten codes 8 + q assembled as f32 bits, 0x41000000 | q << 20
// (exact; one shift and one lop3), then one FMA per token. u16 words arrive as int16 tensors holding the same bits; they are
// read as unsigned words, so no shift sign-extends. One launch a call.

#include "gemv_stream.cuh"

namespace {

constexpr int kFields = 5;       // codes per u16 word
constexpr float kOffset = 11.f;  // 8 + max_int (int3 sym: 3)

// field at bit `sh` of a 32-bit pair of u16 words, moved to f32 mantissa
// bits 20..22 and or-ed into 0x41000000: 8 + q (one shift, one lop3)
__device__ __forceinline__ float code_plus_8(uint32_t w, int sh) {
  const uint32_t t = sh <= 20 ? (w << (20 - sh)) : (w >> (sh - 20));
  return __uint_as_float(gs::and_or(t, 0x00700000u, 0x41000000u));
}

// staged x of word row rr of stage t: value e < 5 is k = 80t + 5rr + e
// (values 5-7 are zero pads); group j of the stage: rows 8j .. 8j + 7; a
// part's x is one chunk
template <typename T_>
struct Gp3Stream {
  using T = T_;
  static constexpr int kWordBytes = 2, kGroups = 2, kStages = 3;
  static constexpr int kScaleOffset = gs::kRows * gs::kCols * kWordBytes;
  static constexpr int kStageBytes = kScaleOffset + 2 * kGroups * gs::kCols * sizeof(T);
  static constexpr int kStageX = 80, kChunks = 1;

  static __device__ __forceinline__ int scale_row(int t, int j, int) { return 2 * t + j; }
  static __device__ __forceinline__ int chunk_k(int, int t0, int) { return 80 * t0; }
  static __device__ __forceinline__ int raw_index(int i, int rr, int e, int) {
    return e < kFields ? 80 * i + kFields * rr + e : -1;
  }
  // lane r < 8 (and its copies r + 8, ...) holds row 8j + r; each field's
  // 8-row sum rounded to T, the five added in f32
  static __device__ __forceinline__ float group_sum(const float* xst, int j, int m, int M,
                                                    int lane) {
    const float* xr = xst + ((8 * j + lane % 8) * M + m) * gs::kXRow;
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kFields; ++i) {
      float v = xr[i];
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      t += int4k::rnd<T>(v);
    }
    return t;
  }

  template <int M>
  static __device__ __forceinline__ void consume(const uint8_t* st, const float* xst,
                                                 const float* sx, float (&acc)[M][gs::C], bool,
                                                 int c) {
    constexpr int C = gs::C;
    const T* S = reinterpret_cast<const T*>(st + kScaleOffset);
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      float p[M][C];
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int cc = 0; cc < C; ++cc) p[m][cc] = 0.f;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int rr = 8 * j + r;
        // the thread's u16 words: one (zero-extended) or two in one 32-bit
        // word, column C c in the low half
        static_assert(C <= 2, "at most two u16 columns a thread");
        const uint8_t* row = st + rr * gs::kCols * kWordBytes;
        const uint32_t w = C == 2 ? reinterpret_cast<const uint32_t*>(row)[c]
                                  : reinterpret_cast<const uint16_t*>(row)[c];
        float q[C][kFields];
#pragma unroll
        for (int cc = 0; cc < C; ++cc)
#pragma unroll
          for (int i = 0; i < kFields; ++i) q[cc][i] = code_plus_8(w, 16 * cc + 3 * i);
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const float4* xr = reinterpret_cast<const float4*>(xst + (rr * M + m) * gs::kXRow);
          const float4 a = xr[0], b = xr[1];
          const float xv[kFields] = {a.x, a.y, a.z, a.w, b.x};
#pragma unroll
          for (int i = 0; i < kFields; ++i)
#pragma unroll
            for (int cc = 0; cc < C; ++cc) p[m][cc] = fmaf(xv[i], q[cc][i], p[m][cc]);
        }
      }
      float s[C];
      gs::load_cols(S + j * gs::kCols, c, s);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float off = kOffset * sx[j * M + m];
#pragma unroll
        for (int cc = 0; cc < C; ++cc) acc[m][cc] += s[cc] * (p[m][cc] - off);
      }
    }
  }
};

template <typename T, class F>
cudaError_t with_m(int M, F f) {
  switch (M) {
    case 1: return f(gs::Body<Gp3Stream<T>, 1>());
    case 2: return f(gs::Body<Gp3Stream<T>, 2>());
  }
  return cudaErrorInvalidValue;
}

// Call f(gs::Body<Gp3Stream<T>, M>()) on the streaming body of (dtype, M):
// bf16 and f16 at 1 <= M <= 2 (cudaErrorInvalidValue for another).
template <class F>
cudaError_t with_stream_body(int dtype, int M, F f) {
  switch (dtype) {
    case int4k::kBF16: return with_m<__nv_bfloat16>(M, f);
    case int4k::kF16: return with_m<__half>(M, f);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: int4k::DType of x and s (bf16 or f16). x [M, 40G]; w u16 words
// [8G, N] (a layer's block); s [G, N]; `parts` split-K parts of `per` 80-k
// stages (at most gs::kMaxPer), with partial f32 [parts, M, N] and tickets
// int32 [ceil(N / 256)], zero, when parts > 1 (else null); out [M, N] in
// x's type (out_f32 = 0) or f32. Needs 1 <= M <= 2, G % 2 == 0, N % 8 ==
// 0, 16-byte aligned w and s bases. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a refused plan).
extern "C" int mlc_gemv_gp3(int dtype, const void* x, const void* w, const void* s,
                            void* partial, void* tickets, void* out, int M, int G, int N,
                            int out_f32, int parts, int per, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const gs::Params p{x, static_cast<const uint8_t*>(w), static_cast<const uint8_t*>(s), nullptr,
                     static_cast<float*>(partial), static_cast<int*>(tickets), out, 40 * G, N,
                     G, G / 2, per, parts, out_f32};
  if (G % 2 != 0 || N % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      with_stream_body(dtype, M, [&](auto body) { return gs::launch(body, p, st); }));
}

// The blocks of the streaming body of (dtype, M) an SM holds, into *n.
extern "C" int mlc_gemv_gp3_blocks(int dtype, int M, int* n) {
  return static_cast<int>(
      with_stream_body(dtype, M, [&](auto body) { return gs::blocks_per_sm(body, n); }));
}
