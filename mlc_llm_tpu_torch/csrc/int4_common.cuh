// Shared by the int4 dequant kernels (dequant_gemv_qs.cu, dequant_gemv_gp.cu,
// dequant_gemm_qs.cu, dequant_gemm_pairs.cu) and dequant_gemm_plane.cu: the
// three compute types and the split-K reduction.
//
// Compute type T (x, scales and minima; the output is T or f32). The f32
// GEMMs (the QsF32 and F32Policy policies of the wgmma mainloop) run
// 3xTF32: each operand v is split into hi = tf32(v) and lo = tf32(v - hi),
// and acc += lo*hi' + hi*lo' + hi*hi' (the lo*lo term is below f32's last
// bit). That keeps f32 accuracy (plain TF32 rounds x and w to 10 mantissa
// bits, ~1e-3 relative, and misses the f32 plain version at 1e-4) at a
// third of the 495 TFLOP/s TF32 rate, 2.5x the 67 TFLOP/s of f32 FMAs on
// the CUDA cores. The tensor cores' f32 accumulation truncates; over the
// 960 MMAs of a K = 2560 product that bias reached 1.8e-4 on outputs of ~2
// (H100), so each 64-k stage's MMAs run into a fresh fragment, which is
// then added to the running sum with rounded f32 adds.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace int4k {

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
