// The Hopper mainloop of the dequant GEMMs (dequant_gemm_qs.cu,
// dequant_gemm_plane.cu, dequant_gemm_pairs.cu) and of the group-partial
// GEMVs at 2 <= m <= 8 (dequant_gemv_qs.cu, dequant_gemv_gp.cu):
// warp-specialized wgmma over a TMA ring,
// with the weights dequantized in registers into wgmma's A operand.
//
// Each block computes one output tile transposed, out^T[n, m] = W^T[n, k] .
// x^T[k, m]: the weight's 128 output channels of the tile fill wgmma's M
// (one 64-row slice per consumer warpgroup, two consumer warpgroups), and
// MT tokens fill wgmma's N (MT in {16, 64, 128, 256}, a template
// parameter the Python wrapper picks from m). So one kernel serves a
// decode at m = 8 and a prefill at m = 2048 without padding m to 64.
//
// The ring: a producer warpgroup (one thread issues) keeps TMA loads of a
// stage's x tiles, word tile and scale tile STAGES deep, completing on
// each stage's `full` mbarrier; the 256 consumer threads wait on it,
// rebuild their A fragments from the stage's words and scales (the format
// policy P's dequant, at the TPU body's rounding points), issue one
// wgmma.mma_async m64nMTk16 per k16 step with B read from shared memory,
// wait for them, and release the stage through its `empty` mbarrier.
// setmaxnreg moves registers from the producer warpgroup to the
// consumers (a 64 x 256 f32 accumulator is 128 registers a thread).
//
// B (x) tiles are [MT][16] elements of the compute type, 32 bytes a row,
// in the 32-byte swizzle that TMA writes and the wgmma descriptor names
// (K-major: one k16 step is exactly one swizzle atom wide, so a tile holds
// one step). Rows past m are zero-filled by TMA: the ragged m edge costs
// nothing. Words and scales land unswizzled, [rows][128 channels].
//
// The epilogue stages the f32 tile through shared memory (the ring,
// quiescent by then) so the [m, n] stores are coalesced: the compute type,
// f32, or an f32 split-K part [S, M, N] that int4k::reduce_kernel sums in
// part order.
//
// A policy may run a stage's MMAs into fresh f32 fragments instead of the
// running accumulator and fold them in on the CUDA cores (P::kParts): the
// f32 GEMMs (3xTF32 on wgmma .tf32, whose truncating accumulation must not
// run the whole K) and the group-partial GEMV (each group's partial is
// scaled and offset in f32, as the TPU body does).
//
// A policy may instead stream its A fragments one k16 step at a time
// (P::kStream: gemm_plane at int3/u16, fp4 and int8, whose m tile reaches
// 256): step k is dequantized into one of two register buffers, fenced,
// issued and committed, and `wgmma.wait_group 1` retires step k - 1's MMA
// before its buffer is rewritten for step k + 1. So 8 A
// registers are live instead of 4 * kSteps (an m64n256 accumulator fits the
// 168 registers ptxas grants 384-thread blocks), and a warpgroup's dequant
// of step k + 1 overlaps its own MMA of step k. The MMAs still add into
// the accumulator in k order: the sums are those of the stage-at-once loop,
// bit for bit. Policies without the flag compile as before.
//
// Register A fragment of a k16 step (PTX ISA, wgmma .bf16/.f16 A in
// registers): warp w of a warpgroup holds rows 16w..16w+15; lane l with
// g = l / 4, c = l % 4 holds a[0] = (row g, k 2c..2c+1), a[1] = (row g+8,
// k 2c..), a[2] = (row g, k 2c+8..), a[3] = (row g+8, k 2c+8..), the lower
// k in the low half. Accumulator: d[4j + {0,1}] = (row g, col 8j + 2c +
// {0,1}), d[4j + {2,3}] = (row g+8, the same cols).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace wg {

constexpr int kBN = 128;                 // output channels of a block tile
constexpr int kConsumers = 256;          // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kRingBudget = 200 * 1024;  // shared-memory bytes of the ring
constexpr int kMaxStages = 8;
constexpr int kLdc = kBN + 4;            // f32 epilogue row pitch (conflict-free)
constexpr int kTileRow = 32;             // bytes of one B tile row (16 elements)

// The launch arguments every format shares; the format reads its own
// (K, sym, max_int).
struct Params {
  int M, N, K;
  int steps, per;  // K stages in all; stages per split-K part
  int sym, max_int, out_f32;
  float* partial;  // [S, M, N] f32 when split, else null
  void* out;       // [M, N], the compute type or f32
};

// x, words, scales, minima (minima = scales where a format has none), and
// a policy's extra x plane (gemm_pairs' pair offsets; unset elsewhere)
struct Maps {
  CUtensorMap x, w, s, z, o;
};

__host__ __device__ constexpr int align1k(int b) { return (b + 1023) / 1024 * 1024; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// wait until the phase of parity `parity` has completed; a wait that
// outlasts 10 s (a ring whose loads never land) traps instead of hanging
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > 10000000000ull) __trap();
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// the wgmma descriptor of a [rows][16] B tile in the 32-byte swizzle,
// K-major: rows 32 bytes apart, 8-row groups 256 bytes apart (SBO); the
// leading offset is unused when one k16 step spans the swizzle atom
__device__ __forceinline__ uint64_t desc_sw32(const void* tile) {
  const uint64_t a = smem_addr(tile);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (static_cast<uint64_t>(256 >> 4) << 32) |
         (3ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// wait until at most N committed wgmma groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator reads or writes across a
// wgmma fence or wait
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// bf16x2 / f16x2 bit casts, and the T x 2 helpers of the policies
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t bits(__half2 v) { return *reinterpret_cast<uint32_t*>(&v); }
template <typename T2>
__device__ __forceinline__ T2 from_bits(uint32_t u) {
  return *reinterpret_cast<T2*>(&u);
}

// field f of a qsplit word as the T x 2 bits of 16 + q (low half: k, high
// half: k + 1), exact
template <typename T>
__device__ __forceinline__ uint32_t field16(uint32_t w, int f) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const uint32_t t = f == 0 ? (w << 3) : (w >> (4 * f - 3));
    return (t & 0x00780078u) | 0x41804180u;
  } else {
    const uint32_t t = f == 0 ? (w << 6) : f == 1 ? (w << 2) : (w >> (4 * f - 6));
    return (t & 0x03C003C0u) | 0x4C004C00u;
  }
}

template <typename T>
struct Vec2;
template <>
struct Vec2<__nv_bfloat16> {
  using V = __nv_bfloat162;
  static __device__ __forceinline__ V dup(float v) { return __float2bfloat162_rn(v); }
  static __device__ __forceinline__ V pair(float lo, float hi) {
    return __floats2bfloat162_rn(lo, hi);
  }
  static __device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ float rnd(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
};
template <>
struct Vec2<__half> {
  using V = __half2;
  static __device__ __forceinline__ V dup(float v) { return __float2half2_rn(v); }
  static __device__ __forceinline__ V pair(float lo, float hi) { return __floats2half2_rn(lo, hi); }
  static __device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
  static __device__ __forceinline__ float rnd(float v) { return __half2float(__float2half_rn(v)); }
};

// two int4 codes (bits 0-3 and 16-19 of t, the rest zero) as T x 2 bits,
// exact: bf16 128 + q less 128, f16 1024 + q less 1024 (ulp 1 at both)
template <typename T>
__device__ __forceinline__ uint32_t codes2(uint32_t t) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return bits(__hsub2(from_bits<__nv_bfloat162>(t | 0x43004300u), __float2bfloat162_rn(128.f)));
  else
    return bits(__hsub2(from_bits<__half2>(t | 0x64006400u), __float2half2_rn(1024.f)));
}

// f32 rounded to TF32 (round to nearest, ties away: cvt.rna), as f32 bits
__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// d (+)= A (registers) . B (descriptor), m64 x N x k16 (bf16/f16) or k8
// (tf32: T = float, A's four registers hold f32 bits already rounded to
// TF32), f32 accumulators. scale_d = 0 overwrites d (a fresh fragment).
template <int N, typename T>
struct Wgmma;

template <>
struct Wgmma<16, __nv_bfloat16> {
  static __device__ __forceinline__ void mma(float (&d)[8], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<64, __nv_bfloat16> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<128, __nv_bfloat16> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<256, __nv_bfloat16> {
  static __device__ __forceinline__ void mma(float (&d)[128], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<16, __half> {
  static __device__ __forceinline__ void mma(float (&d)[8], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<64, __half> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<128, __half> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<256, __half> {
  static __device__ __forceinline__ void mma(float (&d)[128], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<16, float> {
  static __device__ __forceinline__ void mma(float (&d)[8], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<64, float> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

// A policy's optional flags: P::kStream (stream A per k16 step) and
// P::kRingBytes (the ring's shared-memory budget, kRingBudget when unset)
template <class P, class = void>
struct Streams {
  static constexpr bool value = false;
};
template <class P>
struct Streams<P, std::void_t<decltype(P::kStream)>> {
  static constexpr bool value = P::kStream;
};
template <class P, class = void>
struct RingBytes {
  static constexpr int value = kRingBudget;
};
template <class P>
struct RingBytes<P, std::void_t<decltype(P::kRingBytes)>> {
  static constexpr int value = P::kRingBytes;
};

// Shared-memory plan of a ring: per stage, the x tiles (P::kTiles of
// [MT][32 bytes]: 16 bf16/f16 or 8 f32 k), the word tile and the scale
// tile, each 1024-aligned; the epilogue's [MT][kLdc] f32 tile reuses the
// ring.
template <class P, int MT>
struct Ring {
  static constexpr int kX = P::kTiles * MT * kTileRow;
  static constexpr int kStage = align1k(kX) + align1k(P::kWBytes) + align1k(P::kSBytes);
  static constexpr int kStagesFit = RingBytes<P>::value / kStage;
  static constexpr int kStages = kStagesFit < kMaxStages ? kStagesFit : kMaxStages;
  static constexpr int kTx = kX + P::kWBytes + P::kSBytes;  // bytes a stage's loads deliver
  static constexpr int kEpi = MT * kLdc * 4;
  static constexpr int kBytes = (kStages * kStage > kEpi ? kStages * kStage : kEpi) + 1024;
  static_assert(kStages >= 3, "the ring needs at least three stages");
};

// P: the format policy.
//   using T;                  the compute type (bf16, f16; float: TF32 wgmma)
//   kSteps                    MMA k steps a stage (k16; k8 for TF32)
//   kTiles                    x tiles a stage (kSteps, or 2 kSteps for
//                             3xTF32's hi and lo tiles)
//   kARegs                    A registers a step (4; 8 for TF32 hi and lo)
//   kParts                    0: every MMA adds into the running
//                             accumulator; n > 0: a stage's MMAs run into n
//                             fresh f32 fragments, which fold() then adds
//                             to the accumulator on the CUDA cores
//   kMaxMT                    the widest m tile compiled
//   kWBytes, kSBytes          the stage's word and scale bytes
//   load(maps, x, w, s, bar, t, m0, n0, p)    issue stage t's TMA loads
//                             (exactly Ring::kTx bytes onto bar)
//   dequant(a, w, s, ch, c, p)  the stage's A fragments of channels ch and
//                             ch + 8 (within the tile), k group c
//   (with kStream = true the mainloop calls these instead of dequant:)
//   kChunkSteps, Chunk        the steps that share one fetch of the
//                             thread's words and scales, held in a Chunk
//   fetch(w, s, ch, c, j, p)  chunk j's Chunk (steps j * kChunkSteps ..)
//   dequant_step(f, a, chunk, p)  step f of the chunk into a[4]
//   issue<MT>(parts, a, x)      (kParts > 0) the stage's MMAs
//   fold<MT>(acc, parts, x, w, s, ch, c, i, p)  (kParts > 0) add the parts
//                             to acc; i counts the block's stages; all 256
//                             consumer threads call it
template <class P, int MT>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(const __grid_constant__ Maps maps, const Params p) {
  using T = typename P::T;
  using R = Ring<P, MT>;
  constexpr int S = R::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  __shared__ __align__(8) uint64_t full[S], empty[S];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * MT;
  const int t0 = blockIdx.z * p.per;
  const int t1 = min(p.steps, t0 + p.per);
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // the producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == kConsumers) {
      for (int t = t0, i = 0; t < t1; ++t, ++i) {
        const int s = i % S;
        mbar_wait(&empty[s], ((i / S) & 1) ^ 1);
        uint8_t* st = smem + s * R::kStage;
        mbar_expect_tx(&full[s], R::kTx);
        P::load(maps, st, st + align1k(R::kX), st + align1k(R::kX) + align1k(P::kWBytes),
                &full[s], t, m0, n0, MT, p);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int warp = tid / 32, lane = tid % 32;
    const int ch = warp * 16 + lane / 4;  // warps 0-3: channels 0-63, 4-7: 64-127
    const int c = lane % 4;
    float acc[MT / 2];
#pragma unroll
    for (int i = 0; i < MT / 2; ++i) acc[i] = 0.f;
    constexpr int kP = P::kParts > 0 ? P::kParts : 1;
    float part[kP][MT / 2];  // unused when P::kParts == 0

    // each warpgroup waits for its stage's wgmma group before it releases
    // the stage; the other warpgroup's group keeps the tensor cores busy
    // meanwhile (keeping one group in flight across the next dequant gave
    // no gain on the H100, and wrong plane results at m = 128)
    for (int t = t0, i = 0; t < t1; ++t, ++i) {
      const int s = i % S;
      mbar_wait(&full[s], (i / S) & 1);
      const uint8_t* st = smem + s * R::kStage;
      const uint8_t* wt = st + align1k(R::kX);
      const uint8_t* sc = wt + align1k(P::kWBytes);
      if constexpr (Streams<P>::value) {
        uint32_t a[2][P::kARegs];  // step k in buffer k % 2
        typename P::Chunk w;
        fence_acc(acc);
#pragma unroll
        for (int k = 0; k < P::kSteps; ++k) {
          if (k % P::kChunkSteps == 0) w = P::fetch(wt, sc, ch, c, k / P::kChunkSteps, p);
          P::dequant_step(k % P::kChunkSteps, a[k % 2], w, p);
          wgmma_fence();
          Wgmma<MT, T>::mma(acc, a[k % 2], desc_sw32(st + k * MT * kTileRow));
          wgmma_commit();
          if (k + 1 < P::kSteps) wgmma_wait<1>();  // step k - 1 retired: its buffer is free
        }
        wgmma_wait_all();
        fence_acc(acc);
      } else {
        uint32_t a[P::kSteps][P::kARegs];
        P::dequant(a, wt, sc, ch, c, p);
        if constexpr (P::kParts == 0) {
          fence_acc(acc);
          wgmma_fence();
#pragma unroll
          for (int k = 0; k < P::kSteps; ++k)
            Wgmma<MT, T>::mma(acc, a[k], desc_sw32(st + k * MT * kTileRow));
          wgmma_commit();
          wgmma_wait_all();
          fence_acc(acc);
        } else {
#pragma unroll
          for (int j = 0; j < kP; ++j) fence_acc(part[j]);
          wgmma_fence();
          P::template issue<MT>(part, a, st);
          wgmma_commit();
          wgmma_wait_all();
#pragma unroll
          for (int j = 0; j < kP; ++j) fence_acc(part[j]);
          P::template fold<MT>(acc, part, st, wt, sc, ch, c, i, p);
        }
      }
      mbar_arrive(&empty[s]);
    }

    // epilogue: every consumer is past the ring before it is overwritten
    asm volatile("bar.sync 1, 256;" ::: "memory");
    float* cs = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int j = 0; j < MT / 8; ++j) {
      const int tok = 8 * j + 2 * c;
      cs[tok * kLdc + ch] = acc[4 * j];
      cs[(tok + 1) * kLdc + ch] = acc[4 * j + 1];
      cs[tok * kLdc + ch + 8] = acc[4 * j + 2];
      cs[(tok + 1) * kLdc + ch + 8] = acc[4 * j + 3];
    }
    asm volatile("bar.sync 1, 256;" ::: "memory");
    for (int i = tid; i < MT * (kBN / 4); i += kConsumers) {
      const int tok = i / (kBN / 4), col = (i % (kBN / 4)) * 4;
      if (m0 + tok >= p.M) break;  // i grows with tok
      const float4 v = *reinterpret_cast<const float4*>(cs + tok * kLdc + col);
      const size_t o = static_cast<size_t>(m0 + tok) * p.N + n0 + col;
      if (p.partial != nullptr) {
        *reinterpret_cast<float4*>(p.partial + static_cast<size_t>(blockIdx.z) * p.M * p.N + o) = v;
      } else if (p.out_f32 || std::is_same<T, float>::value) {
        *reinterpret_cast<float4*>(static_cast<float*>(p.out) + o) = v;
      } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
        *reinterpret_cast<uint2*>(static_cast<T*>(p.out) + o) = make_uint2(bits(lo), bits(hi));
      } else if constexpr (std::is_same<T, __half>::value) {
        __half2 lo = __floats2half2_rn(v.x, v.y), hi = __floats2half2_rn(v.z, v.w);
        *reinterpret_cast<uint2*>(static_cast<T*>(p.out) + o) = make_uint2(bits(lo), bits(hi));
      }
    }
  }
}

// Launch gemm_kernel<P, MT> over (N / 128, ceil(M / MT), splits) blocks.
template <class P, int MT>
cudaError_t launch(const Maps& maps, const Params& p, int splits, cudaStream_t st) {
  auto kern = gemm_kernel<P, MT>;
  constexpr int bytes = Ring<P, MT>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(p.N / kBN, (p.M + MT - 1) / MT, splits);
  kern<<<grid, kThreads, bytes, st>>>(maps, p);
  return cudaGetLastError();
}

// Dispatch the m tile width (a runtime choice of the Python wrapper), up
// to the policy's widest, P::kMaxMT.
template <class P>
cudaError_t launch_mt(int mt, const Maps& maps, const Params& p, int splits, cudaStream_t st) {
  switch (mt) {
    case 16: return launch<P, 16>(maps, p, splits, st);
    case 64:
      if constexpr (P::kMaxMT >= 64) return launch<P, 64>(maps, p, splits, st);
      return cudaErrorInvalidValue;
    case 128:
      if constexpr (P::kMaxMT >= 128) return launch<P, 128>(maps, p, splits, st);
      return cudaErrorInvalidValue;
    case 256:
      if constexpr (P::kMaxMT >= 256) return launch<P, 256>(maps, p, splits, st);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

// ---- host: tensor maps, built per call from the layer's base pointers ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up in libcuda at run time, without linking it
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A tiled map of `rank` dims (innermost first), strides in bytes of dims
// 1.. (multiples of 16), zero fill out of bounds. False when refused.
inline bool make_map(CUtensorMap* map, CUtensorMapDataType dt, int rank, const void* base,
                     const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                     CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return fn(map, dt, rank, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// [rows][cols] with rows `pitch` bytes apart, boxes of [box_rows][box_cols]
inline bool map_2d(CUtensorMap* map, CUtensorMapDataType dt, const void* base, int cols,
                   int rows, size_t pitch, int box_cols, int box_rows,
                   CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {pitch};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  return make_map(map, dt, 2, base, dims, strides, box, swizzle);
}

// [planes][rows][cols], rows `pitch` and planes `plane_pitch` bytes apart
inline bool map_3d(CUtensorMap* map, CUtensorMapDataType dt, const void* base, int cols,
                   int rows, int planes, size_t pitch, size_t plane_pitch, int box_cols,
                   int box_rows, int box_planes,
                   CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {pitch, plane_pitch};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows),
                             static_cast<cuuint32_t>(box_planes)};
  return make_map(map, dt, 3, base, dims, strides, box, swizzle);
}

}  // namespace wg
