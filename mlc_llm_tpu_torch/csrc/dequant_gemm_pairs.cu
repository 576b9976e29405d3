// Tiled int4 dequant GEMM for the "pair" and "hsplit" bit orders.
//
// Replaces the Pallas kernels mlc_llm_tpu/ops/pallas/dequant_matmul.py
// _kernel_pairs (the int4 branch of _dequant_matmul_2d, flat weights),
// _kernel_pairs_stacked (_dequant_matmul_stacked_2d, layer-stacked weights
// read in place) and _kernel_pairs_hs (both, stacked or not): the prefill
// path, 8 < m <= 2048, of the q4*_pair, q4*_sym, q4f32 and q4*_hs presets.
// One templated kernel; the layer is a pointer offset. Same math, same
// rounding points, every op rounded to the compute type T as the TPU
// bodies' jnp ops in T:
//   pair:   w = q * s (one rounding); acc += x @ w in f32; plus the offset
//           dot (x_even + x_odd, rounded to T) . off with off = z, or
//           s * -max_int (rounded) when sym. off is constant in a group, so
//           the kernel sums each group's 16 rounded pair sums on the CUDA
//           cores beside the tensor-core tile and adds sum * off in the
//           epilogue, as dequant_gemm_plane.cu folds its offset: no second
//           GEMM;
//   hsplit: w = q * s + off (two roundings), off as above; acc += x @ w.
//
// Orders (K is the stored, group-padded K; x is padded to it by the caller):
//   pair:   word r holds k = 8r .. 8r+7, nibble i at bits 4i;
//   hsplit: byte b of word r holds k = 4r+b (low nibble) and K/2 + 4r+b
//           (high nibble); the low half reads groups [0, G/2), the high
//           half [G/2, G).
// The TPU's even/odd deinterleave of x (pair) is its own plumbing: the x
// tile is a plain slice of x (pair) or of its two halves (hsplit).
//
// Compute type T (x, s, z): bf16 and f16 run nvcuda::wmma 16x16x16 with f32
// accumulators; f32 runs 3xTF32 wmma m16n16k8 (int4_common.cuh), which
// keeps f32 accuracy at a third of the TF32 rate. The output is T or f32.
//
// Bound on the H100: at prefill widths the work is above the ridge (2*m*K*N
// flops against ~0.56*K*N weight bytes), so the bound is the tensor-core
// rate. This first version is simple, not fast:
//   * a 64 x 64 output tile per 128-thread block, four warps of 32 x 32;
//   * the K loop walks 128 k a step (64 in f32): the x tile is copied to
//     shared memory with 16-byte loads, the step's words are dequantized
//     into a T tile at the body's rounding points;
//   * the ragged m edge is masked (zero rows in, no stores out);
//   * when the m x n tiles give fewer than two blocks per SM (the 3B
//     width's N = 2560 is 40 column tiles), K is split over blockIdx.z into
//     f32 parts that a second kernel adds in part order (deterministic).
// wgmma, TMA and a pipelined shared-memory ring are later work.

#include "int4_common.cuh"

namespace {

using namespace nvcuda;
using int4k::Num;
using int4k::rnd;
using int4k::Tile;

enum Layout { kPair = 0, kHsplit = 1 };

constexpr int BM = 64, BN = 64, kThreads = 128;
constexpr int LDC = BN + 4;
constexpr int kMaxInt = 7;          // int4 sym: codes q - 7
constexpr int kTargetBlocks = 264;  // two blocks per SM before K is split

template <int L, typename T>
__global__ void __launch_bounds__(kThreads)
gemm_pairs_kernel(const T* __restrict__ x, const int32_t* __restrict__ w,
                  const T* __restrict__ s, const T* __restrict__ z, float* __restrict__ partial,
                  void* __restrict__ out, int M, int K, int N, int steps_per_split, int sym,
                  int out_f32) {
  constexpr int BK = Tile<T>::BK;         // k per step
  constexpr int RW = BK / 8;              // word rows per step
  constexpr int GS = BK / 32;             // groups per step (pair)
  constexpr int LDA = BK + Tile<T>::PAD, LDB = BN + Tile<T>::PAD;
  constexpr int VEC = 16 / sizeof(T);     // x elements per 16-byte load
  constexpr int kOffBytes = L == kPair ? (GS * BN + BM * GS) * 4 : 0;
  constexpr int kBytes = (BM * LDA + BK * LDB) * static_cast<int>(sizeof(T)) + kOffBytes;
  static_assert(BM * LDA * sizeof(T) >= BM * LDC * 4, "the epilogue tile reuses the x tile");
  __shared__ __align__(128) unsigned char smem[kBytes];
  T* As = reinterpret_cast<T*>(smem);                      // [BM][LDA]
  T* Bs = As + BM * LDA;                                   // [BK][LDB]
  float* sOff = reinterpret_cast<float*>(Bs + BK * LDB);   // [GS][BN] pair offsets
  float* sT = sOff + GS * BN;                              // [BM][GS] pair x sums
  float* Cs = reinterpret_cast<float*>(smem);              // [BM][LDC], epilogue

  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KH = K / 2, G = K / 32;
  const int steps = K / BK;
  const int t_begin = blockIdx.z * steps_per_split;
  const int t_end = min(steps, t_begin + steps_per_split);
  // this thread's outputs of the 64 x 64 tile for the offset term and the
  // epilogue: column tid % 64, rows tid / 64 + 2j
  const int on = tid % BN, orow = tid / BN;

  typename Tile<T>::Acc acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  float offacc[BM / 2];
#pragma unroll
  for (int j = 0; j < BM / 2; ++j) offacc[j] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    // x tile: pair As[r][kk] = x[m0 + r][BK*t + kk]; hsplit the step's
    // BK/2 k of the low half, then the same of the high half
    for (int i = tid; i < BM * (BK / VEC); i += kThreads) {
      const int r = i / (BK / VEC), v = (i % (BK / VEC)) * VEC;
      const int k = L == kPair ? BK * t + v
                               : (v < BK / 2 ? (BK / 2) * t + v : KH + (BK / 2) * t + v - BK / 2);
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M) val = __ldg(reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + k));
      *reinterpret_cast<uint4*>(As + r * LDA + v) = val;
    }
    if (L == kPair) {
      for (int i = tid; i < GS * BN; i += kThreads) {
        const size_t o = (size_t)(GS * t + i / BN) * N + n0 + i % BN;
        sOff[i] = sym ? rnd<T>(Num<T>::to_f(s[o]) * -static_cast<float>(kMaxInt))
                      : Num<T>::to_f(z[o]);
      }
    }
    __syncthreads();

    // weight tile: word row RW*t + rr -> Bs rows of its k in the x tile
    for (int i = tid; i < RW * BN; i += kThreads) {
      const int rr = i / BN, cc = i % BN, n = n0 + cc;
      const int32_t word = __ldg(w + (size_t)(RW * t + rr) * N + n);
      if (L == kPair) {
        const float sf = Num<T>::to_f(s[(size_t)(GS * t + rr / 4) * N + n]);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          Bs[(8 * rr + e) * LDB + cc] =
              Num<T>::from_f(static_cast<float>((word >> (4 * e)) & 0xF) * sf);
      } else {
        const int glo = (BK / 64) * t + rr / 8, ghi = G / 2 + glo;
        const size_t olo = (size_t)glo * N + n, ohi = (size_t)ghi * N + n;
        const float slo = Num<T>::to_f(s[olo]), shi = Num<T>::to_f(s[ohi]);
        const float offlo = sym ? rnd<T>(slo * -static_cast<float>(kMaxInt)) : Num<T>::to_f(z[olo]);
        const float offhi = sym ? rnd<T>(shi * -static_cast<float>(kMaxInt)) : Num<T>::to_f(z[ohi]);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const float qlo = static_cast<float>((word >> (8 * b)) & 0xF);
          const float qhi = static_cast<float>((word >> (8 * b + 4)) & 0xF);
          Bs[(4 * rr + b) * LDB + cc] = Num<T>::from_f(rnd<T>(qlo * slo) + offlo);
          Bs[(BK / 2 + 4 * rr + b) * LDB + cc] = Num<T>::from_f(rnd<T>(qhi * shi) + offhi);
        }
      }
    }
    if (L == kPair) {
      // sT[r][gi] = sum over the group's 16 pairs of T(x_even + x_odd)
      for (int i = tid; i < BM * GS; i += kThreads) {
        const T* xr = As + (i / GS) * LDA + 32 * (i % GS);
        float tsum = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          tsum += rnd<T>(Num<T>::to_f(xr[2 * j]) + Num<T>::to_f(xr[2 * j + 1]));
        sT[i] = tsum;
      }
    }
    __syncthreads();

    Tile<T>::step(acc, As, LDA, Bs, LDB, wm, wn);
    if (L == kPair) {
#pragma unroll
      for (int j = 0; j < BM / 2; ++j) {
        const float* tr = sT + (orow + 2 * j) * GS;
#pragma unroll
        for (int gi = 0; gi < GS; ++gi) offacc[j] = fmaf(tr[gi], sOff[gi * BN + on], offacc[j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < BM / 2; ++j) {
    const int r = orow + 2 * j;
    if (m0 + r >= M) continue;
    const float v = Cs[r * LDC + on] + (L == kPair ? offacc[j] : 0.f);
    const size_t o = (size_t)(m0 + r) * N + n0 + on;
    if (partial != nullptr)
      partial[(size_t)blockIdx.z * M * N + o] = v;
    else
      int4k::store_out<T>(out, o, v, out_f32);
  }
}

int steps_of(int K, int dtype) { return K / (dtype == int4k::kF32 ? Tile<float>::BK : 128); }

template <int L, typename T>
void launch(const void* x, const void* w, const void* s, const void* z, float* partial,
            void* out, int M, int K, int N, int splits, int sym, int out_f32, cudaStream_t st) {
  const int steps = K / Tile<T>::BK;
  dim3 grid(N / BN, (M + BM - 1) / BM, splits);
  gemm_pairs_kernel<L, T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(w), static_cast<const T*>(s),
      static_cast<const T*>(z), partial, out, M, K, N, (steps + splits - 1) / splits, sym,
      out_f32);
}

template <typename T>
int launch_t(int layout, const void* x, const void* w, const void* s, const void* z,
             float* part, void* out, int M, int K, int N, int splits, int sym, int out_f32,
             cudaStream_t st) {
  if (layout == kPair)
    launch<kPair, T>(x, w, s, z, part, out, M, K, N, splits, sym, out_f32, st);
  else if (layout == kHsplit)
    launch<kHsplit, T>(x, w, s, z, part, out, M, K, N, splits, sym, out_f32, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (part != nullptr) int4k::launch_reduce<T>(part, out, splits, M * N, out_f32, st);
  return 0;
}

}  // namespace

// Number of split-K parts for an M x N output over K (dtype: int4k::DType):
// 1 when the output tiles alone give two blocks per SM. The caller sizes
// the f32 scratch [S, M, N] when S > 1.
extern "C" int mlc_gemm_pairs_splits(int M, int K, int N, int dtype) {
  const int blocks = (N / BN) * ((M + BM - 1) / BM);
  const int steps = steps_of(K, dtype);
  if (blocks >= kTargetBlocks || steps <= 1) return 1;
  int splits = (kTargetBlocks + blocks - 1) / blocks;
  if (splits > steps) splits = steps;
  const int per = (steps + splits - 1) / splits;
  return (steps + per - 1) / per;  // no empty part
}

// layout: 0 pair, 1 hsplit; dtype: int4k::DType of x, s and z. x [M, K]
// (16-byte aligned rows); w int32 words [K/8, N] (a layer's block); s, z
// [K/32, N] (z unused when sym); partial f32 [splits, M, N] when splits > 1,
// else null; out [M, N] in the compute type (out_f32 = 0) or f32. Needs
// K % 128 == 0, N % 64 == 0. Returns cudaGetLastError() after the launches.
extern "C" int mlc_gemm_pairs(int layout, int dtype, const void* x, const void* w, const void* s,
                              const void* z, void* partial, void* out, int M, int K, int N,
                              int splits, int sym, int out_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = splits > 1 ? static_cast<float*>(partial) : nullptr;
  if (splits > 1 && part == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int err;
  switch (dtype) {
    case int4k::kBF16:
      err = launch_t<__nv_bfloat16>(layout, x, w, s, z, part, out, M, K, N, splits, sym, out_f32, st);
      break;
    case int4k::kF16:
      err = launch_t<__half>(layout, x, w, s, z, part, out, M, K, N, splits, sym, out_f32, st);
      break;
    case int4k::kF32:
      err = launch_t<float>(layout, x, w, s, z, part, out, M, K, N, splits, sym, out_f32, st);
      break;
    default: err = static_cast<int>(cudaErrorInvalidValue);
  }
  return err ? err : static_cast<int>(cudaGetLastError());
}
