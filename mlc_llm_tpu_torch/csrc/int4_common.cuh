// Shared by the int4 dequant kernels (dequant_gemv_qs.cu, dequant_gemv_gp.cu,
// dequant_gemm_qs.cu, dequant_gemm_pairs.cu) and dequant_gemm_plane.cu: the
// three compute types, the split-K reduction, and the f32 tensor-core step
// of a 64 x 64 output tile of gemm_qs's f32 body.
//
// Compute type T (x, scales and minima; the output is T or f32). The f32
// step runs 3xTF32 wmma m16n16k8: each operand v is split into
//   hi = tf32(v) and lo = tf32(v - hi), and acc += lo*hi' + hi*lo' + hi*hi'
//   (the lo*lo term is below f32's last bit). That keeps f32 accuracy
//   (plain TF32 rounds x and w to 10 mantissa bits, ~1e-3 relative, and
//   misses the f32 plain version at 1e-4) at a third of the 495 TFLOP/s
//   TF32 rate, 2.5x the 67 TFLOP/s of f32 FMAs on the CUDA cores. The
//   tensor cores' f32 accumulation truncates; over the 960 MMAs of a
//   K = 2560 product that bias reached 1.8e-4 on outputs of ~2 (H100), so
//   each shared-memory step's 24 MMAs run into a zeroed fragment, which is
//   then added to the running sum with rounded f32 adds.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace int4k {

using namespace nvcuda;

// the compute-type ids the Python wrappers pass (ops/dequant_matmul.py DTYPE_IDS)
enum DType { kBF16 = 0, kF16 = 1, kF32 = 2 };

template <typename T>
struct Num;
template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float v) { return __float2bfloat16(v); }
  // two neighbouring values (4-byte aligned) as f32
  static __device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
};
template <>
struct Num<__half> {
  static __device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
  static __device__ __forceinline__ __half from_f(float v) { return __float2half_rn(v); }
  static __device__ __forceinline__ float2 load2(const __half* p) {
    return __half22float2(*reinterpret_cast<const __half2*>(p));
  }
};
template <>
struct Num<float> {
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float from_f(float v) { return v; }
  static __device__ __forceinline__ float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
};

// v rounded to T, back in f32 (identity for f32): the TPU bodies' rounding points
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return Num<T>::to_f(Num<T>::from_f(v));
}

// The f32 tensor-core step of a 64 x 64 output tile over four warps (2 x 2
// of 32 x 32): As [64][lda] (k contiguous) and Bs [BK][ldb] (n contiguous)
// in shared memory; BK = 64 is the K depth a shared-memory step holds.
template <typename T>
struct Tile;

template <>
struct Tile<float> {
  static constexpr int BK = 64, PAD = 4;
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;
  using FA = wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, wmma::row_major>;
  using FB = wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, wmma::row_major>;

  template <typename F>
  static __device__ __forceinline__ void split(F& hi, F& lo) {
#pragma unroll
    for (int t = 0; t < hi.num_elements; ++t) {
      const float v = hi.x[t];
      const float h = wmma::__float_to_tf32(v);
      hi.x[t] = h;
      lo.x[t] = wmma::__float_to_tf32(v - h);
    }
  }

  static __device__ __forceinline__ void step(Acc (&acc)[2][2], const float* As, int lda,
                                              const float* Bs, int ldb, int wm, int wn) {
    Acc part[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(part[i][j], 0.f);
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      FA ah[2], al[2];
      FB bh[2], bl[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(ah[i], As + (wm * 32 + i * 16) * lda + kk * 8, lda);
        split(ah[i], al[i]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(bh[j], Bs + (kk * 8) * ldb + wn * 32 + j * 16, ldb);
        split(bh[j], bl[j]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::mma_sync(part[i][j], al[i], bh[j], part[i][j]);
          wmma::mma_sync(part[i][j], ah[i], bl[j], part[i][j]);
          wmma::mma_sync(part[i][j], ah[i], bh[j], part[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int t = 0; t < acc[i][j].num_elements; ++t) acc[i][j].x[t] += part[i][j].x[t];
  }
};

// out[i] = sum over the S split-K slices of partial [S, MN], in slice order
// (deterministic), written as OutT.
template <typename OutT>
__global__ void reduce_kernel(const float* __restrict__ partial, OutT* __restrict__ out, int S,
                              int MN) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float t = 0.f;
  for (int sl = 0; sl < S; ++sl) t += partial[(size_t)sl * MN + i];
  out[i] = Num<OutT>::from_f(t);
}

// Launch reduce_kernel writing T (out_f32 = 0) or f32.
template <typename T>
void launch_reduce(const float* partial, void* out, int S, int MN, int out_f32,
                   cudaStream_t st) {
  const int threads = 256, blocks = (MN + threads - 1) / threads;
  if (out_f32)
    reduce_kernel<float><<<blocks, threads, 0, st>>>(partial, static_cast<float*>(out), S, MN);
  else
    reduce_kernel<T><<<blocks, threads, 0, st>>>(partial, static_cast<T*>(out), S, MN);
}

}  // namespace int4k
