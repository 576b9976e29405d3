// The residual sum and the norm(s) of one decoder norm site, in one launch
// (kernel 9).
//
// Replaces no TPU kernel: the JAX package's norm sites (mlc_llm_tpu/models/
// layers.py layer_norm, rms_norm, and the residual adds and f16 clamp of
// models/transformer.py) are plain jnp code that XLA fuses into one pass
// over the rows. The port ran them as PyTorch ops, one launch each: 14 a
// LayerNorm, 2-3 for the residual sum and the f16 clamp, one a row-parallel
// bias. This kernel is that fusion, written by hand.
//
// For each of R rows of H elements of T (bf16, f16 or f32), one launch
// computes
//   t_j   = round_T(t_j + bias_j)             for 0-2 terms, each bias optional;
//   h'    = round_T(round_T(h + t_1) + t_2)   then, where asked, clamped to
//                                             +-c (c rounded to T by the wrapper);
//   out_k = norm_k(h')                        for 1 or 2 parameter sets,
// LayerNorm: mean = sum(x) / H, var = sum((x - mean)^2) / H,
//   out = ((x - mean) * (1 / sqrt(var + eps))) * w + b;
// RMSNorm: out = (x * (1 / sqrt(sum(x * x) / H + eps))) * w;
// in f32 from h', each product and sum rounded once (the __f*_rn
// intrinsics: no FMA contraction), the output rounded once to T. These are
// the plain chain's rounding points (ops/norm.py residual_norm_plain); only
// the order of the f32 sums differs. The two norms of a parallel-residual
// layer share one mean and variance: the plain chain computes the same two
// numbers twice.
//
// Bound on the H100: bytes. Each element costs ~10 f32 operations against
// 2-12 bytes moved (h, the terms, h' and the outputs), far below the ~295
// flops/byte ridge. What the design does about it:
//   * one block a row, and the row stays in registers from its load to its
//     last store: h and the terms are read once, h' and each output written
//     once, nothing in between goes to device memory (the plain chain makes
//     ~17 passes over [R, H] in f32 for one LayerNorm with its residual);
//   * 16-byte loads and stores: thread t owns the vectors t, t + threads,
//     ... (VPT of them, VEC = 16 / sizeof(T) elements each), so a warp's
//     access is 512 contiguous bytes;
//   * the sums reduce in registers, then across the warp by xor shuffles,
//     then across warps through shared memory, every thread adding the
//     warps' partials in warp order: every thread holds the same total and
//     a result does not change from run to run;
//   * the loads of h, the terms and their biases are all issued before the
//     first add, and the norm parameters are prefetched into L2 while the
//     sums reduce: a decode site of 1-8 rows is bound by memory latency,
//     which this pays about once for the rows and once for the
//     parameters;
//   * the plan (VPT, threads) comes from the wrapper (ops/norm.py
//     launch_plan), from H and T alone: VPT the least of 1, 2, 4 that
//     keeps a row's block at 512 threads or fewer (VPT 4 holds 102
//     registers a thread without spilling; 8 would spill the hoisted
//     loads), so H is at most 16384 in bf16/f16 and 8192 in f32. A decode row of 2560
//     f16 elements is 320 threads with one vector each; 2048 prefill rows
//     are 2048 blocks, several resident on each SM.
// Two-pass variance from registers (not E[x^2] - mean^2), as the plain
// chain computes it.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rn {

enum DType { kBF16 = 0, kF16 = 1, kF32 = 2 };
constexpr int kMaxThreads = 512;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T's precision, back in f32
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// the 16 bytes at element `elem` of a T array
template <typename T>
__device__ __forceinline__ uint4 load16(const void* base, size_t elem) {
  return __ldg(reinterpret_cast<const uint4*>(static_cast<const T*>(base) + elem));
}

template <typename T, int VEC>
__device__ __forceinline__ void unpack(const uint4& raw, float (&v)[VEC]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] = to_f(e[i]);
}

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const void* base, size_t elem, float (&v)[VEC]) {
  unpack<T, VEC>(load16<T>(base, elem), v);
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(void* base, size_t elem, const float (&v)[VEC]) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) e[i] = from_f<T>(v[i]);
  *reinterpret_cast<uint4*>(static_cast<T*>(base) + elem) = raw;
}

// The block's sum of v: xor shuffles within the warp, then the warps'
// partials added in warp order by every thread.
__device__ __forceinline__ float block_sum(float v, float* partial) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
  const int warps = blockDim.x >> 5;
  for (int w = 0; w < warps; ++w) total = __fadd_rn(total, partial[w]);
  return total;
}

struct Params {
  const void* h;
  const void* t[2];   // residual terms [R, H]
  const void* tb[2];  // their biases [H] or null
  const void* w[2];   // norm scales [H]
  const void* b[2];   // LayerNorm shifts [H]
  void* h_out;        // h' [R, H], written when nterms > 0
  void* out[2];       // the normalised rows [R, H]
  long long hs, ts[2];  // row strides of h and the terms, in elements
  int H, nterms, nnorms, rms;
  float eps, clamp;   // clamp <= 0: none
};

template <typename T, int VPT>
__global__ void __launch_bounds__(kMaxThreads) residual_norm_kernel(const Params p) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float partial[2][kMaxThreads / 32];
  const int nvec = p.H / VEC;
  const size_t row = static_cast<size_t>(blockIdx.x) * p.H;  // of the outputs
  // every load of h, the terms and their biases is issued before any is
  // used (one memory latency, not one a tensor), and the norm parameters,
  // read after the sums, are fetched into L2 meanwhile
  uint4 raw[3][VPT], raw_b[2][VPT];
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const int i = threadIdx.x + v * blockDim.x;
    if (i >= nvec) continue;
    const size_t col = static_cast<size_t>(i) * VEC;
    raw[0][v] = load16<T>(p.h, blockIdx.x * p.hs + col);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j >= p.nterms) break;
      raw[1 + j][v] = load16<T>(p.t[j], blockIdx.x * p.ts[j] + col);
      if (p.tb[j] != nullptr) raw_b[j][v] = load16<T>(p.tb[j], col);
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (k >= p.nnorms) break;
      prefetch_l2(static_cast<const T*>(p.w[k]) + col);
      if (!p.rms) prefetch_l2(static_cast<const T*>(p.b[k]) + col);
    }
  }
  float x[VPT][VEC];
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    if (threadIdx.x + v * blockDim.x >= nvec) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) x[v][e] = 0.f;
      continue;
    }
    unpack<T, VEC>(raw[0][v], x[v]);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j >= p.nterms) break;
      float t[VEC];
      unpack<T, VEC>(raw[1 + j][v], t);
      if (p.tb[j] != nullptr) {
        float b[VEC];
        unpack<T, VEC>(raw_b[j][v], b);
#pragma unroll
        for (int e = 0; e < VEC; ++e) t[e] = round_to<T>(__fadd_rn(t[e], b[e]));
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) x[v][e] = round_to<T>(__fadd_rn(x[v][e], t[e]));
    }
  }
  if (p.nterms > 0) {
    const float c = p.clamp;
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      const int i = threadIdx.x + v * blockDim.x;
      if (i >= nvec) continue;
      if (c > 0.f) {
#pragma unroll
        for (int e = 0; e < VEC; ++e)  // comparisons keep a NaN, as torch.clamp does
          x[v][e] = x[v][e] > c ? c : (x[v][e] < -c ? -c : x[v][e]);
      }
      store_vec<T, VEC>(p.h_out, row + static_cast<size_t>(i) * VEC, x[v]);
    }
  }

  // masked vectors hold 0 and add nothing
  float s = 0.f;
#pragma unroll
  for (int v = 0; v < VPT; ++v)
#pragma unroll
    for (int e = 0; e < VEC; ++e) s = __fadd_rn(s, p.rms ? __fmul_rn(x[v][e], x[v][e]) : x[v][e]);
  s = block_sum(s, partial[0]);
  const float n = static_cast<float>(p.H);
  float mean = 0.f, r;
  if (p.rms) {
    r = 1.f / sqrtf(__fadd_rn(s / n, p.eps));
  } else {
    mean = s / n;
    float q = 0.f;
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      const bool live = threadIdx.x + v * blockDim.x < nvec;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float d = live ? __fsub_rn(x[v][e], mean) : 0.f;
        q = __fadd_rn(q, __fmul_rn(d, d));
      }
    }
    q = block_sum(q, partial[1]);
    r = 1.f / sqrtf(__fadd_rn(q / n, p.eps));
  }

#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (k >= p.nnorms) break;
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      const int i = threadIdx.x + v * blockDim.x;
      if (i >= nvec) continue;
      const size_t col = static_cast<size_t>(i) * VEC;
      float w[VEC], y[VEC];
      load_vec<T, VEC>(p.w[k], col, w);
      if (p.rms) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) y[e] = __fmul_rn(__fmul_rn(x[v][e], r), w[e]);
      } else {
        float b[VEC];
        load_vec<T, VEC>(p.b[k], col, b);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          y[e] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x[v][e], mean), r), w[e]), b[e]);
      }
      store_vec<T, VEC>(p.out[k], row + col, y);
    }
  }
}

template <typename T>
int launch(const Params& p, int R, int vpt, int threads, cudaStream_t stream) {
  const dim3 grid(R), block(threads);
  switch (vpt) {
    case 1: residual_norm_kernel<T, 1><<<grid, block, 0, stream>>>(p); break;
    case 2: residual_norm_kernel<T, 2><<<grid, block, 0, stream>>>(p); break;
    case 4: residual_norm_kernel<T, 4><<<grid, block, 0, stream>>>(p); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rn

// h, terms t0/t1 with biases tb0/tb1 (null when absent), norm parameters
// w0/b0 and w1/b1 (b null for RMSNorm); outputs h_out (nterms > 0) and
// out0/out1, contiguous [R, H]. h and the terms are rows of H contiguous
// elements at row strides hs, ts0, ts1 (elements, whole 16-byte vectors).
// Every pointer 16-byte aligned; vpt and threads from ops/norm.py
// launch_plan.
extern "C" int mlc_residual_norm(const void* h, const void* t0, const void* t1, const void* tb0,
                                 const void* tb1, const void* w0, const void* b0, const void* w1,
                                 const void* b1, void* h_out, void* out0, void* out1,
                                 long long hs, long long ts0, long long ts1, int R, int H,
                                 int nterms, int nnorms, int rms, float eps, float clamp,
                                 int dtype, int vpt, int threads, void* stream) {
  const int esize = dtype == rn::kF32 ? 4 : 2;
  const int vec = 16 / esize;
  if (dtype < rn::kBF16 || dtype > rn::kF32 || R < 1 || H < 1 || H % vec || nterms < 0 ||
      nterms > 2 || nnorms < 1 || nnorms > 2 || threads < 32 || threads % 32 ||
      threads > rn::kMaxThreads || static_cast<long long>(threads) * vpt * vec < H ||
      hs < H || hs % vec || (nterms > 0 && (ts0 < H || ts0 % vec)) ||
      (nterms > 1 && (ts1 < H || ts1 % vec)) ||
      (nterms > 0 && h_out == nullptr) || (nterms > 1 && t1 == nullptr) ||
      (nterms > 0 && t0 == nullptr) || w0 == nullptr || out0 == nullptr ||
      (nnorms > 1 && (w1 == nullptr || out1 == nullptr)) ||
      (!rms && (b0 == nullptr || (nnorms > 1 && b1 == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  const rn::Params p{h, {t0, t1}, {tb0, tb1}, {w0, w1}, {b0, b1}, h_out, {out0, out1},
                     hs, {ts0, ts1}, H, nterms, nnorms, rms, eps, clamp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rn::kBF16: return rn::launch<__nv_bfloat16>(p, R, vpt, threads, s);
    case rn::kF16: return rn::launch<__half>(p, R, vpt, threads, s);
    default: return rn::launch<float>(p, R, vpt, threads, s);
  }
}
