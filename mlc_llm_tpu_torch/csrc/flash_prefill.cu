// Causal flash attention of a reset prefill: a block's queries against the
// block's own keys and values, with the online softmax (kernel 8).
//
// Replaces the Pallas TPU kernel behind mlc_llm_tpu/ops/attention.py
// flash_prefill: jax.experimental.pallas.ops.tpu.flash_attention's
// flash_attention(causal=True, sm_scale=1/sqrt(D)), whose body is the
// pallas_call of _flash_attention_kernel_single_batch (jax 0.9.0,
// flash_attention.py:342-481). Same math, same rounding points (the plain
// version, ops/attention.py flash_prefill_plain, repeats them):
//   s = q . k over D in f32, times 1/sqrt(D) in f32;
//   keys above the diagonal (col > row) are masked (JAX adds -0.7 * FLT_MAX,
//   which the exponential takes to 0 as it does -inf here);
//   the online softmax keeps m and l in f32; p = exp(s - m) is summed into
//   l in f32 and rounded to v's type before the P.V product, which
//   accumulates in f32; the output is acc / l, rounded once to q's type.
// Both bodies fold the scale and log2(e) into one f32 constant c:
// the running max m is kept over the raw s (the same maximum: the scale is
// positive) and p = exp2(s * c - m * c), one FMA and ex2 a score. That is
// exp(s * scale - m * scale) reformulated, not a new rounding point.
// q, k, v [B, H, S, D] with any strides whose last dimension is contiguous
// (the forward hands over its [B, S, H, D] projections as they are); Hkv
// divides Hq and query head h reads kv-head h / (Hq / Hkv) (JAX repeats the
// kv-heads; nothing is repeated here). The output is written through its own
// strides (the forward's [B, S, H, D]).
//
// Bound on the H100: at S = 1024 and 2048 with D = 128 the work is
// 2 * B * H * S^2 * D causal operations against 4 * B * H * S * D * 2 bytes
// of q, k, v and o, ~S/4 operations a byte: near the bf16 ridge (~295) at
// S = 1024, above it at 2048. Between the two products the exponentials
// (one MUFU op a score) take about half the products' tensor-core time
// unless they overlap them, and every 128-query block reads its K and V
// tiles again from L2. What the bf16/f16 design does:
//   * one block per (head, batch, 128-query tile), the heads varying
//     fastest, so that the tiles with the most keys go first across the
//     whole grid (with the query tiles fastest, the last heads' heaviest
//     tiles start last: 7-33% slower); two warpgroups of 64 query rows
//     each, and thread 0 issues every TMA load. There is no producer
//     warpgroup: ptxas (CUDA 12.9) grants a block of three warpgroups, or
//     two and a warp, 168 registers a thread whether or not setmaxnreg
//     moves them, and the consumers spilled (232 bytes at D = 128, 652 at
//     D = 256) and ran 14-98% slower; two warpgroups alone get up to 255,
//     and the body takes 200 at D = 128 and 231 at D = 256;
//   * TMA over 4-D tensor maps (D, S, H, B) built on the host from the
//     strides at each launch (passed __grid_constant__; a captured graph
//     keeps them by value), in the 128-byte swizzle: a row is D / 64 boxes
//     of 64 elements. Q is loaded once; K and V tiles (BN = 128 keys at D =
//     128, 64 at D = 256, so that the 64 x D f32 output accumulator fits:
//     64 or 128 registers a thread) go through a ring of two stages with
//     their own full/empty mbarriers: K of tile t + 1 is loaded as soon as
//     both warpgroups' Q K^T of tile t - 1 is done, V when their P V is;
//   * both products on wgmma with f32 accumulators: S = Q K^T (m64nBNk16,
//     Q and K from shared memory, both K-major); O += P V with P in
//     registers (the score accumulator of keys 16 kk .. 16 kk + 15 is the A
//     fragment of step kk as it lies, rounded to v's type) and V read
//     MN-major (D contiguous) through the transpose-B form;
//   * within a warpgroup, Q K^T of tile t and P V of tile t - 1 are issued
//     together and the softmax of tile t runs while that P V is on the
//     tensor cores (wgmma.wait_group 1). Ping-pong between the warpgroups
//     (taking turns to issue, so that one's softmax runs under the other's
//     products) cost 3-8% at S = 2048 and D = 256 and moved S = 1024 by
//     under 1% (scripts/torch_ablation.py --kernel flash_prefill): not
//     built in;
//   * tiles above the diagonal are neither loaded nor computed; only a
//     warpgroup's last tile crosses its diagonal and is masked (one a block
//     at BN = 128, two at BN = 64, where the first warpgroup skips the last
//     tile, all above its rows);
//   * the output is staged in the warpgroup's half of Q's buffer in the
//     same swizzle and written by a TMA store into the strided output.
// On the H100 the body is bound by its loads, not its products: with both
// wgmma products taken out it keeps 72-83% of its time (scripts/
// torch_ablation.py --kernel flash_prefill); each 128-query block reads its
// K/V tiles again from L2.
// The f32 body (flash_prefill_tf32) keeps f32's accuracy on the tensor
// cores with 3xTF32 on wgmma .tf32, as the f32 GEMMs do: each operand x is
// split into hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi), and a . b
// = a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (lo.lo is below f32's last bit), in
// both S = Q K^T and P V. Its work is 3x the products' at the TF32 rate,
// 165 TFLOP/s of f32 products. It keeps the bf16/f16 body's grid order,
// its skipped and masked tiles, its 4-D maps and its lack of a producer
// warpgroup. What differs:
//   * wgmma .tf32 reads shared-memory operands only K-major. Q and K are
//     (D contiguous), and TMA lands them; V is not, so the threads split
//     and transpose each landed V tile into V^T hi and lo (keys
//     contiguous), and split each K tile (and Q, once) into hi and lo. K's
//     hi and lo rows are stacked, so that one wgmma of N = 2 BN takes
//     q_hi.k_hi and q_hi.k_lo and Q's A tile is read from shared memory
//     twice a k8 step, not three times;
//   * P goes from registers without a shuffle: the k8 A fragment holds
//     columns c and c + 4 of a quad where the score accumulator holds keys
//     2c and 2c + 1, so V^T's columns are written in the order 0 2 4 6 1 3
//     5 7 within each 8 keys and the fragment is the scores as they lie;
//   * the tensor cores' f32 accumulation truncates: each tile's P V runs
//     into a fresh fragment that the CUDA cores fold into o with the online
//     softmax's rescale, o = o * alpha + part (S is fresh each tile);
//   * hi and lo double f32's tiles again. A block is two warpgroups: at D
//     = 128 they hold 64 query rows each (Q hi and lo 128 KB) over 32-key
//     tiles; at D = 256 they share 64 rows (also 128 KB) over 16-key tiles
//     (V^T rows of 64 bytes, in the 64-byte swizzle) and split D, each
//     taking Q K^T over its 128 columns (the halves of S summed through
//     shared memory) and P V into its 128 columns of o. With K and V^T in
//     hi and lo and the K and V tiles TMA lands, 224 KB either way: one
//     block an SM. A thread holds 64 registers of o and 64 of the fresh
//     part either way (a first build with one warpgroup of 64 rows at D =
//     256, o 128 registers a thread, spilled and ran slower than SDPA);
//   * the tile loop runs in lock step: every thread splits the landed
//     tile, a barrier, the next tile's TMA loads go out, each warpgroup runs
//     Q K^T, the softmax and P V, a barrier.
// On the H100 the f32 body runs at 0.49-0.75x causal SDPA in f32 and
// 2.3-4.5x its 3xTF32 bound: with every wgmma taken out it keeps 60-74% of
// its time, with no K/V split 67-69% (scripts/torch_ablation.py --kernel
// flash_prefill). The splits and the products, both on shared memory, take
// about a third each, in turn; splitting V under Q K^T and K under P V
// (two barriers a tile) was no faster.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "dequant_wgmma.cuh"

namespace {

enum DType { kBF16 = 0, kF16 = 1, kF32 = 2 };  // ops/attention.py FLASH_TYPES

struct Strides {
  long long b, h, s;  // elements; the last dimension is contiguous
};

struct Args {
  const void *q, *k, *v;
  void* o;
  Strides qs, ks, vs, os;
  int S, rep;
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- bf16 / f16

template <typename T>
constexpr bool kIsBF16 = std::is_same<T, __nv_bfloat16>::value;

constexpr int kRows = 128;     // query rows a block: two warpgroups of 64
constexpr int kThreads = 256;  // two warpgroups: up to 255 registers a thread
constexpr int kAtom = 128;     // bytes of a swizzled row: 64 elements

template <int D>
struct Tile {
  static constexpr int kBN = D == 128 ? 128 : 64;  // keys a K/V tile
  static constexpr int kStages = 2;                 // K/V ring stages
  static constexpr int kQBytes = kRows * D * 2;     // [D / 64][128 rows][64]
  static constexpr int kKVBytes = kBN * D * 2;      // [D / 64][BN rows][64]
  static constexpr int kSmem = kQBytes + 2 * kStages * kKVBytes + 1024;  // + alignment
};

// q, k, v and o as 4-D maps over (D, S, H, B), boxes of 64 x rows x 1 x 1
struct Maps {
  CUtensorMap q, k, v, o;
};

// a wgmma descriptor in the 128-byte swizzle: K-major operands (Q, K) use
// sbo = 1024 (8 rows of 128 bytes) and no lbo; the MN-major V uses lbo =
// the distance between its 64-column blocks and sbo = 1024 (8 keys)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return ((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// d = A B (scale_d = 0) or d += A B, m64 x N x k16, A and B K-major in
// shared memory (descriptors), f32 accumulators
template <int N, typename T>
struct SS;
// d += A B, m64 x N x k16, A in registers (four T x 2 words), B MN-major in
// shared memory (the transpose-B form)
template <int N, typename T>
struct RS;

template <typename T>
struct SS<64, T> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    if constexpr (kIsBF16<T>)
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
          "%32, %33, p, 1, 1, 0, 0;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
          : "l"(a), "l"(b), "r"(scale_d));
    else
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
          "%32, %33, p, 1, 1, 0, 0;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
          : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <typename T>
struct SS<128, T> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    if constexpr (kIsBF16<T>)
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
          "%64, %65, p, 1, 1, 0, 0;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
          : "l"(a), "l"(b), "r"(scale_d));
    else
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
          "%64, %65, p, 1, 1, 0, 0;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
          : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <typename T>
struct RS<128, T> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t* a, uint64_t b) {
    if constexpr (kIsBF16<T>)
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
          "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
    else
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
          "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <typename T>
struct RS<256, T> {
  static __device__ __forceinline__ void mma(float (&d)[128], const uint32_t* a, uint64_t b) {
    if constexpr (kIsBF16<T>)
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
          "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
    else
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
          "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// Q K^T of one K tile into s: D / 16 steps, A the warpgroup's 64 rows of Q
// and B the tile's BN keys, both K-major in the 128-byte swizzle (column
// block kk / 4, 32 bytes a step within it); one wgmma group
template <typename T, int D>
__device__ __forceinline__ void issue_qk(float (&s)[Tile<D>::kBN / 2], uint32_t q_addr,
                                         uint32_t k_addr) {
  constexpr int BN = Tile<D>::kBN;
  wg::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    SS<BN, T>::mma(s, desc_sw128(q_addr + (kk / 4) * kRows * kAtom + (kk % 4) * 32, 16, 1024),
                   desc_sw128(k_addr + (kk / 4) * BN * kAtom + (kk % 4) * 32, 16, 1024), kk > 0);
  wg::wgmma_commit();
}

// o += P V of one V tile: BN / 16 steps, A the packed P words of step kk,
// B keys 16 kk .. 16 kk + 15 of V, MN-major: 8 keys a 1024-byte atom, the
// 64-column blocks BN * 128 bytes apart; one wgmma group
template <typename T, int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&p)[Tile<D>::kBN / 4],
                                         uint32_t v_addr) {
  constexpr int BN = Tile<D>::kBN;
  wg::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    RS<D, T>::mma(o, p + 4 * kk, desc_sw128(v_addr + kk * 16 * kAtom, BN * kAtom, 1024));
  wg::wgmma_commit();
}

// A thread's two query rows (row g and g + 8 of its warp's 16): the running
// max of the raw scores, this thread's share of the running sum, and the
// rescale that o still owes for the last max
struct Rows {
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f, al_a = 0.f, al_b = 0.f;
};

// The online softmax of one tile's scores, in place (s becomes p, f32).
// Accumulator layout: s[4j + {0,1}] = (row a, key 8j + 2cq + {0,1}),
// s[4j + {2,3}] = (row b, the same keys). A diagonal tile masks the keys
// above each row.
template <int N>
__device__ __forceinline__ void softmax(float (&s)[N], Rows& r, bool diag, int key0, int row_a,
                                        int row_b, float c) {
  if (diag) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const int col = key0 + 8 * j;
      if (col > row_a) s[4 * j] = -INFINITY;
      if (col + 1 > row_a) s[4 * j + 1] = -INFINITY;
      if (col > row_b) s[4 * j + 2] = -INFINITY;
      if (col + 1 > row_b) s[4 * j + 3] = -INFINITY;
    }
  }
  float mx_a = r.m_a, mx_b = r.m_b;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
    mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  // a row lives on the 4 threads of a quad
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
  // tile 0 holds key 0, at or below every row: the max is finite from it
  // on, and the first rescale is exp2(-inf) = 0 (o and l are still 0)
  r.al_a = ex2((r.m_a - mx_a) * c);
  r.al_b = ex2((r.m_b - mx_b) * c);
  r.m_a = mx_a;
  r.m_b = mx_b;
  const float nm_a = -mx_a * c, nm_b = -mx_b * c;
  float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    s[4 * j] = ex2(fmaf(s[4 * j], c, nm_a));
    s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], c, nm_a));
    s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], c, nm_b));
    s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], c, nm_b));
    rs_a += s[4 * j] + s[4 * j + 1];
    rs_b += s[4 * j + 2] + s[4 * j + 3];
  }
  r.l_a = r.l_a * r.al_a + rs_a;
  r.l_b = r.l_b * r.al_b + rs_b;
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const Rows& r) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    o[4 * j] *= r.al_a;
    o[4 * j + 1] *= r.al_a;
    o[4 * j + 2] *= r.al_b;
    o[4 * j + 3] *= r.al_b;
  }
}

// p rounded to T in pairs: word i = (s[2i], s[2i + 1]), so words 4 kk ..
// 4 kk + 3 are the A fragment of P V's step kk as the scores lie
template <typename T, int N>
__device__ __forceinline__ void pack_p(uint32_t (&p)[N / 2], const float (&s)[N]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) p[i] = wg::bits(wg::Vec2<T>::pair(s[2 * i], s[2 * i + 1]));
}

// one consumer warp's share of a stage's release
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  if (lane == 0) wg::mbar_arrive(bar);
}

// The ring's loads, issued by one thread (thread 0, in the first consumer
// warpgroup): tile t of K or V into stage t % kStages once both consumer
// warpgroups have released the tile that stage held before
template <int D>
struct Loader {
  static constexpr int BN = Tile<D>::kBN, kStages = Tile<D>::kStages;
  const Maps& maps;
  uint8_t *sk, *sv;
  uint64_t *k_full, *v_full, *k_empty, *v_empty;
  int hk, b;

  __device__ __forceinline__ void load(const CUtensorMap* map, uint8_t* ring, uint64_t* full,
                                       uint64_t* empty, int t) const {
    const int s = t % kStages;
    wg::mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
    wg::mbar_expect_tx(&full[s], Tile<D>::kKVBytes);
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb)
      tma_load_4d(ring + s * Tile<D>::kKVBytes + cb * BN * kAtom, map, &full[s], cb * 64, t * BN,
                  hk, b);
  }
  __device__ __forceinline__ void k(int t) const { load(&maps.k, sk, k_full, k_empty, t); }
  __device__ __forceinline__ void v(int t) const { load(&maps.v, sv, v_full, v_empty, t); }
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_prefill_wg(const __grid_constant__ Maps maps, const int rep, const float c) {
  using W = Tile<D>;
  constexpr int BN = W::kBN, kStages = W::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* sk = sq + W::kQBytes;             // [kStages][kKVBytes]
  uint8_t* sv = sk + kStages * W::kKVBytes;  // [kStages][kKVBytes]
  __shared__ __align__(8) uint64_t q_full, k_full[kStages], v_full[kStages], k_empty[kStages],
      v_empty[kStages];

  const int h = blockIdx.x, b = blockIdx.y;
  const int qb = gridDim.z - 1 - blockIdx.z;  // the tiles with the most keys first
  const int tid = threadIdx.x;
  const int wgi = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, cq = lane % 4;
  const int r0 = qb * kRows + wgi * 64;  // the warpgroup's first query row
  const int row_a = r0 + 16 * warp + g, row_b = row_a + 8;
  // the warpgroup's tiles: those with a key at or below one of its rows;
  // the last one, and only it, crosses the diagonal. The block's: the
  // second warpgroup's, one more than the first's at BN = 64
  const int n_tiles = (r0 + 64 + BN - 1) / BN;
  const int n_block = (qb + 1) * kRows / BN;
  const bool issuer = tid == 0;
  const Loader<D> load{maps, sk, sv, k_full, v_full, k_empty, v_empty, h / rep, b};

  if (issuer) {
    wg::mbar_init(&q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(&k_full[s], 1);
      wg::mbar_init(&v_full[s], 1);
      wg::mbar_init(&k_empty[s], 8);  // one arrival a consumer warp
      wg::mbar_init(&v_empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    wg::mbar_expect_tx(&q_full, W::kQBytes);
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb)
      tma_load_4d(sq + cb * kRows * kAtom, &maps.q, &q_full, cb * 64, qb * kRows, h, b);
    for (int t = 0; t < kStages && t < n_block; ++t) {
      load.k(t);
      load.v(t);
    }
  }
  __syncthreads();

  const uint32_t q_addr = smem_u32(sq) + wgi * 64 * kAtom;  // the warpgroup's 64 rows of Q
  const uint32_t k_addr = smem_u32(sk), v_addr = smem_u32(sv);
  float o[D / 2], s[BN / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
  uint32_t p[BN / 4];
  Rows r;

  wg::mbar_wait(&q_full, 0);
  wg::mbar_wait(&k_full[0], 0);
  issue_qk<T, D>(s, q_addr, k_addr);
  wg::wgmma_wait<0>();
  wg::fence_acc(s);
  release(&k_empty[0], lane);
  softmax(s, r, n_tiles == 1, 2 * cq, row_a, row_b, c);
  pack_p<T>(p, s);
  for (int t = 1; t < n_tiles; ++t) {
    const int st = t % kStages, pst = (t - 1) % kStages;
    // K of tile t + kStages - 1 into the stage tile t - 1 held: both
    // warpgroups released it after their Q K^T of tile t - 1
    if (issuer && t + kStages - 1 < n_block) load.k(t + kStages - 1);
    // Q K^T of tile t goes to the tensor cores first; o takes the rescale
    // of tile t - 1's max meanwhile, then P V of tile t - 1 queues behind
    wg::mbar_wait(&k_full[st], (t / kStages) & 1);
    issue_qk<T, D>(s, q_addr, k_addr + st * W::kKVBytes);
    rescale(o, r);
    wg::mbar_wait(&v_full[pst], ((t - 1) / kStages) & 1);
    issue_pv<T, D>(o, p, v_addr + pst * W::kKVBytes);
    wg::wgmma_wait<1>();  // tile t's scores are in; P V still runs
    wg::fence_acc(s);
    release(&k_empty[st], lane);
    softmax(s, r, t == n_tiles - 1, t * BN + 2 * cq, row_a, row_b, c);
    wg::wgmma_wait<0>();
    wg::fence_acc(o);
    release(&v_empty[pst], lane);
    // V of tile t + kStages - 1 into the stage whose P V just finished
    if (issuer && t + kStages - 1 < n_block) load.v(t + kStages - 1);
    pack_p<T>(p, s);
  }
  rescale(o, r);
  {
    const int last = n_tiles - 1, st = last % kStages;
    wg::mbar_wait(&v_full[st], (last / kStages) & 1);
    issue_pv<T, D>(o, p, v_addr + st * W::kKVBytes);
    wg::wgmma_wait<0>();
    wg::fence_acc(o);
  }

  // epilogue: o / l, rounded once to T, staged in the warpgroup's rows of
  // Q's buffer (every Q K^T that read them is done) in the 128-byte
  // swizzle, then one TMA store a 64-column block
  r.l_a += __shfl_xor_sync(0xffffffffu, r.l_a, 1);
  r.l_a += __shfl_xor_sync(0xffffffffu, r.l_a, 2);
  r.l_b += __shfl_xor_sync(0xffffffffu, r.l_b, 1);
  r.l_b += __shfl_xor_sync(0xffffffffu, r.l_b, 2);
  const float inv_a = 1.f / r.l_a, inv_b = 1.f / r.l_b;
  uint8_t* so = sq + wgi * 64 * kAtom;
  const int lr = 16 * warp + g;  // row a's row in the warpgroup; row b's is lr + 8
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    // column 8j + 2cq: 64-column block j / 8, 16-byte chunk j % 8, which
    // the swizzle XORs with the row's index mod 8 (g for both rows)
    uint8_t* blk = so + (j / 8) * kRows * kAtom + (((j % 8) ^ g) * 16) + cq * 4;
    *reinterpret_cast<uint32_t*>(blk + lr * kAtom) =
        wg::bits(wg::Vec2<T>::pair(o[4 * j] * inv_a, o[4 * j + 1] * inv_a));
    *reinterpret_cast<uint32_t*>(blk + (lr + 8) * kAtom) =
        wg::bits(wg::Vec2<T>::pair(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b));
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wgi) : "memory");
  if (tid % 128 == 0) {
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb)
      tma_store_4d(&maps.o, so + cb * kRows * kAtom, cb * 64, r0, h, b);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

// ----------------------------------------------------------------------- f32

// d = A B (scale_d = 0) or d += A B, m64 x N x k8 in TF32 (f32 bits whose
// low 13 are zero), A and B K-major in shared memory (descriptors)
template <int N>
struct Tf32SS;

template <>
struct Tf32SS<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Tf32SS<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Tf32SS<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

// d (+)= A B, m64 x 128 x k8 in TF32, A in registers (a[0] = (row g, k
// c), a[1] = (row g + 8, k c), a[2] = (row g, k c + 4), a[3] = (row g + 8,
// k c + 4)), B K-major in shared memory
struct Tf32RS {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t* a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// The f32 body's tiles. A block is two warpgroups. At D = 128 they hold
// 64 query rows each (128 a block) over 32-key tiles; at D = 256 they share
// 64 rows and split D: each computes Q K^T over its 128 columns of D (the
// two halves of S are summed through shared memory) and P V into its 128
// columns of o, over 16-key tiles. Either way Q, K and V^T in hi and lo and
// the two tiles TMA lands fit 227 KB, and a thread holds a 64 x 128 part
// of o (64 registers) and a fresh part of P V as large
template <int D>
struct F32Tile {
  static constexpr bool kSplitD = D == 256;            // warpgroups split D, not rows
  static constexpr int kRows = kSplitD ? 64 : 128;      // query rows a block
  static constexpr int kThreads = 256;
  static constexpr int kBN = kSplitD ? 16 : 32;         // keys a tile
  static constexpr int kVtRow = kBN * 4;                // bytes of a V^T row
  static constexpr int kVtLayout = kBN == 32 ? 1 : 2;   // its swizzle: 128 or 64 bytes
  static constexpr int kQBytes = kRows * D * 4;         // a Q plane: [D / 32][rows][32]
  static constexpr int kKVBytes = kBN * D * 4;          // a K, V or V^T plane
  // Q hi and lo, K hi and lo (stacked: [D / 32][hi rows, lo rows][32]),
  // V^T hi and lo, and the K and V tiles as TMA lands them (at D = 256 the
  // K tile's buffer carries the halves of S between its split and the next
  // K tile's load)
  static constexpr int kSmem = 2 * kQBytes + 6 * kKVBytes + 1024;
};

// a byte offset within a 1024-aligned tile in the 128-byte (64-byte)
// swizzle: its 16-byte chunk XOR address bits 7-9 (7-8), as TMA writes the
// tile and wgmma reads it
__device__ __forceinline__ uint32_t swz128(uint32_t o) { return o ^ ((o >> 3) & 0x70); }
__device__ __forceinline__ uint32_t swz64(uint32_t o) { return o ^ ((o >> 3) & 0x30); }

// x = hi + lo + (what 3xTF32 drops): hi = cvt.rna.tf32(x), lo =
// cvt.rna.tf32(x - hi) (x - hi is exact in f32), as f32 bits
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = wg::tf32(x);
  lo = wg::tf32(x - __uint_as_float(hi));
}

// a plane of Bytes from `src` into hi (in place when hi == src) and lo,
// element by element: the three share one layout, whatever its swizzle
template <int Bytes, int Threads>
__device__ __forceinline__ void split_plane(uint8_t* hi, uint8_t* lo, const uint8_t* src,
                                            int tid) {
#pragma unroll 4
  for (int i = tid; i < Bytes / 16; i += Threads) {
    const float4 x = reinterpret_cast<const float4*>(src)[i];
    uint4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    reinterpret_cast<uint4*>(hi)[i] = h;
    reinterpret_cast<uint4*>(lo)[i] = l;
  }
}

// The K tile as TMA lands it ([D / 32][BN keys][32], 128-byte swizzle)
// into hi and lo stacked a column block: [D / 32][2 BN][32], keys 0 .. BN -
// 1 of hi, then of lo, so that one wgmma of N = 2 BN multiplies q_hi by
// both. BN rows are whole 1024-byte swizzle atoms: the swizzle carries over
template <int D>
__device__ __forceinline__ void split_k(uint8_t* sk, const uint8_t* stk, int tid) {
  using W = F32Tile<D>;
  constexpr int kBlock = W::kBN * kAtom;  // a column block of the landed tile
#pragma unroll 4
  for (int i = tid; i < W::kKVBytes / 16; i += W::kThreads) {
    const float4 x = reinterpret_cast<const float4*>(stk)[i];
    uint4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    uint8_t* at = sk + (16 * i / kBlock) * 2 * kBlock + (16 * i) % kBlock;
    *reinterpret_cast<uint4*>(at) = h;
    *reinterpret_cast<uint4*>(at + kBlock) = l;
  }
}

// The V tile as TMA lands it ([D / 32][BN keys][32] in the 128-byte
// swizzle) into V^T hi and lo, [D rows][BN keys], keys contiguous (wgmma
// .tf32 reads B only K-major). Key 8i + e of the tile goes to column 8i +
// e / 2 (e even) or 8i + 4 + e / 2 (e odd): the k order in which a
// thread's scores of keys 2c and 2c + 1 are already its A fragment (see
// issue_pv3). A warp's lanes are the tile's 32 keys (two rows of 16) of
// 4-column chunks: distinct swizzled chunks on the read, distinct banks on
// each write
template <int D>
__device__ __forceinline__ void split_v(uint8_t* vh, uint8_t* vl, const uint8_t* stv, int tid) {
  using W = F32Tile<D>;
  constexpr int BN = W::kBN;
  const int e = tid % BN;
  const int col = (e & ~7) | ((e & 1) << 2) | ((e & 7) >> 1);
#pragma unroll 2
  for (int c4 = tid / BN; c4 < D / 4; c4 += W::kThreads / BN) {
    const int d = 4 * c4;
    const float4 x = *reinterpret_cast<const float4*>(
        stv + swz128((d / 32) * BN * kAtom + e * kAtom + (d % 32) * 4));
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t o = (d + i) * W::kVtRow + col * 4;
      const uint32_t at = BN == 32 ? swz128(o) : swz64(o);
      uint32_t h, l;
      split(xs[i], h, l);
      *reinterpret_cast<uint32_t*>(vh + at) = h;
      *reinterpret_cast<uint32_t*>(vl + at) = l;
    }
  }
}

// the descriptor of V^T rows in its swizzle: 8 rows a group, sbo apart
template <int D>
__device__ __forceinline__ uint64_t desc_vt(uint32_t addr) {
  using W = F32Tile<D>;
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>((8 * W::kVtRow) >> 4) << 32) |
         (static_cast<uint64_t>(W::kVtLayout) << 62);
}

// S = Q K^T of one tile over 128 columns of D (all of D = 128, the
// warpgroup's half of D = 256), in 3xTF32, into two fresh fragments: 16 k8
// steps (column block kk / 4, 32 bytes a step within it), each q_hi.[k_hi;
// k_lo] (one wgmma of N = 2 BN: Q's A tile is read once for both) into
// s2, and q_lo.k_hi into s (lo.lo is below f32's last bit); one group.
// sum_s adds them: s = (q_lo.k_hi + q_hi.k_lo) + q_hi.k_hi
template <int D>
__device__ __forceinline__ void issue_qk3(float (&s)[F32Tile<D>::kBN / 2],
                                          float (&s2)[F32Tile<D>::kBN], uint32_t qh, uint32_t ql,
                                          uint32_t kh) {
  using W = F32Tile<D>;
  constexpr int BN = W::kBN;
  // the addresses opaque each call: the 48 descriptors, hoisted out of the
  // tile loop, would hold 96 registers
  asm volatile("" : "+r"(qh), "+r"(ql), "+r"(kh));
  wg::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
    const uint32_t oq = (kk / 4) * W::kRows * kAtom + (kk % 4) * 32;
    const uint32_t ok = (kk / 4) * 2 * BN * kAtom + (kk % 4) * 32;
    const uint64_t q_hi = desc_sw128(qh + oq, 16, 1024), q_lo = desc_sw128(ql + oq, 16, 1024);
    const uint64_t k = desc_sw128(kh + ok, 16, 1024);  // hi rows, then lo rows
    Tf32SS<2 * BN>::mma(s2, q_hi, k, kk > 0);
    Tf32SS<BN>::mma(s, q_lo, k, kk > 0);
  }
  wg::wgmma_commit();
}

template <int N>
__device__ __forceinline__ void sum_s(float (&s)[N], const float (&s2)[2 * N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = (s[i] + s2[N + i]) + s2[i];
}

// p's A fragments, split: step j (keys 8j .. 8j + 7) takes the thread's
// scores as they lie, (row g, key 2c), (row g + 8, key 2c), (row g, key
// 2c + 1), (row g + 8, key 2c + 1), i.e. k = c and c + 4 name keys 2c and
// 2c + 1, the order split_v wrote V^T's columns in: no shuffle
template <int N>
__device__ __forceinline__ void split_p(uint32_t (&ph)[N], uint32_t (&pl)[N],
                                        const float (&s)[N]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    split(s[4 * j], ph[4 * j], pl[4 * j]);
    split(s[4 * j + 2], ph[4 * j + 1], pl[4 * j + 1]);
    split(s[4 * j + 1], ph[4 * j + 2], pl[4 * j + 2]);
    split(s[4 * j + 3], ph[4 * j + 3], pl[4 * j + 3]);
  }
}

// part = P V of 128 output columns (V^T rows from vh / vl), in 3xTF32,
// into a fresh fragment (the tensor cores' f32 accumulation truncates, so
// o is summed on the CUDA cores): BN / 8 k8 steps; one group
template <int D>
__device__ __forceinline__ void issue_pv3(float (&part)[64],
                                          const uint32_t (&ph)[F32Tile<D>::kBN / 2],
                                          const uint32_t (&pl)[F32Tile<D>::kBN / 2],
                                          uint32_t vh, uint32_t vl) {
  asm volatile("" : "+r"(vh), "+r"(vl));  // no descriptor hoisted out of the tile loop
  wg::wgmma_fence();
#pragma unroll
  for (int j = 0; j < F32Tile<D>::kBN / 8; ++j) {
    const uint64_t v_hi = desc_vt<D>(vh + 32 * j), v_lo = desc_vt<D>(vl + 32 * j);
    Tf32RS::mma(part, pl + 4 * j, v_hi, j > 0);
    Tf32RS::mma(part, ph + 4 * j, v_lo, 1);
    Tf32RS::mma(part, ph + 4 * j, v_hi, 1);
  }
  wg::wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(F32Tile<D>::kThreads, 1)
    flash_prefill_tf32(const __grid_constant__ Maps maps, float* const out, const Strides os,
                       const int rep, const float c) {
  using W = F32Tile<D>;
  constexpr int BN = W::kBN, R = W::kRows;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* sql = sq + W::kQBytes;
  uint8_t* sk = sql + W::kQBytes;  // K hi and lo, stacked
  uint8_t* svt = sk + 2 * W::kKVBytes;
  uint8_t* svtl = svt + W::kKVBytes;
  uint8_t* stk = svtl + W::kKVBytes;  // the K and V tiles as TMA lands them
  uint8_t* stv = stk + W::kKVBytes;
  __shared__ __align__(8) uint64_t q_full, kv_full;

  const int h = blockIdx.x, b = blockIdx.y;
  const int qb = gridDim.z - 1 - blockIdx.z;  // the tiles with the most keys first
  const int tid = threadIdx.x;
  const int wgi = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, cq = lane % 4;
  // the warpgroup's first query row, and its first column of D (of Q K^T's
  // k and of o)
  const int r0 = qb * R + (W::kSplitD ? 0 : wgi * 64);
  const int d0 = W::kSplitD ? wgi * 128 : 0;
  const int row_a = r0 + 16 * warp + g, row_b = row_a + 8;
  // the warpgroup's tiles hold a key at or below one of its rows; the
  // block's are the last warpgroup's
  const int n_tiles = (r0 + 64) / BN;
  const int n_block = (qb + 1) * R / BN;
  const int hk = h / rep;

  auto load = [&](const CUtensorMap* map, uint8_t* dst, int t) {
#pragma unroll
    for (int cb = 0; cb < D / 32; ++cb)
      tma_load_4d(dst + cb * BN * kAtom, map, &kv_full, cb * 32, t * BN, hk, b);
  };
  if (tid == 0) {
    wg::mbar_init(&q_full, 1);
    wg::mbar_init(&kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    wg::mbar_expect_tx(&q_full, W::kQBytes);
#pragma unroll
    for (int cb = 0; cb < D / 32; ++cb)
      tma_load_4d(sq + cb * R * kAtom, &maps.q, &q_full, cb * 32, qb * R, h, b);
    wg::mbar_expect_tx(&kv_full, 2 * W::kKVBytes);
    load(&maps.v, stv, 0);
    load(&maps.k, stk, 0);
  }
  __syncthreads();
  wg::mbar_wait(&q_full, 0);
  // Q into hi (in place) and lo; the first tile's barrier orders it before
  // any product
  split_plane<W::kQBytes, W::kThreads>(sq, sql, sq, tid);

  const uint32_t qoff = W::kSplitD ? (d0 / 32) * R * kAtom : wgi * 64 * kAtom;
  const uint32_t qh = smem_u32(sq) + qoff, ql = smem_u32(sql) + qoff;
  const uint32_t kh = smem_u32(sk) + (d0 / 32) * 2 * BN * kAtom;
  const uint32_t vh = smem_u32(svt) + d0 * W::kVtRow, vl = smem_u32(svtl) + d0 * W::kVtRow;
  float o[64], s[BN / 2], s2[BN], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = part[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN; ++i) s2[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
  uint32_t ph[BN / 2], pl[BN / 2];
  Rows r;

  for (int t = 0; t < n_block; ++t) {
    // every thread splits the landed tile: K into hi and lo, V into V^T
    // hi and lo; then the next tile's loads go out under this tile's work
    wg::mbar_wait(&kv_full, t & 1);
    split_k<D>(sk, stk, tid);
    split_v<D>(svt, svtl, stv, tid);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (tid == 0 && t + 1 < n_block) {
      wg::mbar_expect_tx(&kv_full, 2 * W::kKVBytes);
      load(&maps.v, stv, t + 1);
      if (!W::kSplitD) load(&maps.k, stk, t + 1);
    }
    if (t < n_tiles) {  // at D = 256 every thread's tiles are the block's
      issue_qk3<D>(s, s2, qh, ql, kh);
      wg::wgmma_wait<0>();
      wg::fence_acc(s);
      wg::fence_acc(s2);
      sum_s(s, s2);
      if constexpr (W::kSplitD) {
        // S = the two warpgroups' halves, summed through the K tile's
        // landing buffer (a + b = b + a: both hold the same S), which the
        // next K tile's load overwrites once both have read
        float4* ex = reinterpret_cast<float4*>(stk);
        ex[(2 * wgi) * 128 + tid % 128] = make_float4(s[0], s[1], s[2], s[3]);
        ex[(2 * wgi + 1) * 128 + tid % 128] = make_float4(s[4], s[5], s[6], s[7]);
        __syncthreads();
        const float4 x0 = ex[(2 - 2 * wgi) * 128 + tid % 128];
        const float4 x1 = ex[(3 - 2 * wgi) * 128 + tid % 128];
        s[0] += x0.x, s[1] += x0.y, s[2] += x0.z, s[3] += x0.w;
        s[4] += x1.x, s[5] += x1.y, s[6] += x1.z, s[7] += x1.w;
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncthreads();
        if (tid == 0 && t + 1 < n_block) load(&maps.k, stk, t + 1);
      }
      // only the warpgroup's last 64 / BN tiles cross its diagonal
      softmax(s, r, (t + 1) * BN > r0, t * BN + 2 * cq, row_a, row_b, c);
      split_p(ph, pl, s);
      // o = o * alpha + part, the part fresh each tile
      issue_pv3<D>(part, ph, pl, vh, vl);
      wg::wgmma_wait<0>();
      wg::fence_acc(part);
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] = fmaf(o[i], i % 4 < 2 ? r.al_a : r.al_b, part[i]);
    }
    __syncthreads();  // every product that read this tile's K and V^T is done
  }

  // epilogue: o / l in f32, straight from the fragment (row a, columns d0
  // + 8j + 2c and + 1: one 32-byte sector a row a quad)
  r.l_a += __shfl_xor_sync(0xffffffffu, r.l_a, 1);
  r.l_a += __shfl_xor_sync(0xffffffffu, r.l_a, 2);
  r.l_b += __shfl_xor_sync(0xffffffffu, r.l_b, 1);
  r.l_b += __shfl_xor_sync(0xffffffffu, r.l_b, 2);
  const float inv_a = 1.f / r.l_a, inv_b = 1.f / r.l_b;
  float* og = out + b * os.b + h * os.h + d0 + 2 * cq;
  float* oa = og + static_cast<long long>(row_a) * os.s;
  float* ob = og + static_cast<long long>(row_b) * os.s;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    *reinterpret_cast<float2*>(oa + 8 * j) = make_float2(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
    *reinterpret_cast<float2*>(ob + 8 * j) =
        make_float2(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
  }
}

// ------------------------------------------------------------------ launches

// a [B, H, S, D] operand through its strides as a 4-D map over (D, S, H,
// B), boxes of 128 bytes (64 bf16/f16 or 32 f32) x `rows` positions,
// 128-byte swizzle
bool map_operand(CUtensorMap* map, CUtensorMapDataType dt, int esize, const void* base, int D,
                 int S, int H, int B, const Strides& st, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.s) * esize,
                                 static_cast<cuuint64_t>(st.h) * esize,
                                 static_cast<cuuint64_t>(st.b) * esize};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kAtom / esize),
                             static_cast<cuuint32_t>(rows), 1, 1};
  return wg::make_map(map, dt, 4, base, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <typename T, int D>
int launch_wg(const Args& a, int B, int Hq, int Hkv, cudaStream_t st) {
  const CUtensorMapDataType dt =
      kIsBF16<T> ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  Maps maps;
  if (!map_operand(&maps.q, dt, 2, a.q, D, a.S, Hq, B, a.qs, kRows) ||
      !map_operand(&maps.k, dt, 2, a.k, D, a.S, Hkv, B, a.ks, Tile<D>::kBN) ||
      !map_operand(&maps.v, dt, 2, a.v, D, a.S, Hkv, B, a.vs, Tile<D>::kBN) ||
      !map_operand(&maps.o, dt, 2, a.o, D, a.S, Hq, B, a.os, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_prefill_wg<T, D>;
  const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             Tile<D>::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // c = 1/sqrt(D) * log2(e): exp(s * scale - m * scale) = exp2(s * c - m * c)
  kern<<<dim3(Hq, B, a.S / kRows), kThreads, Tile<D>::kSmem, st>>>(
      maps, a.rep, a.scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_tf32(const Args& a, int B, int Hq, int Hkv, cudaStream_t st) {
  using W = F32Tile<D>;
  const CUtensorMapDataType dt = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  Maps maps;
  if (!map_operand(&maps.q, dt, 4, a.q, D, a.S, Hq, B, a.qs, W::kRows) ||
      !map_operand(&maps.k, dt, 4, a.k, D, a.S, Hkv, B, a.ks, W::kBN) ||
      !map_operand(&maps.v, dt, 4, a.v, D, a.S, Hkv, B, a.vs, W::kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_prefill_tf32<D>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, W::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(Hq, B, a.S / W::kRows), W::kThreads, W::kSmem, st>>>(
      maps, static_cast<float*>(a.o), a.os, a.rep, a.scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, Hq, S, D], k and v [B, Hkv, S, D] and o [B, Hq, S, D], each through
// its (batch, head, position) strides in elements with the last dimension
// contiguous; dtype 0 bf16, 1 f16, 2 f32 for all four. Needs D in {128,
// 256}, S % 128 == 0 (the bf16/f16 body's query tile), Hkv dividing Hq,
// 16-byte aligned pointers and strides that are multiples of 16 bytes.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// when an argument or a tensor map is refused.
extern "C" int mlc_flash_prefill(const void* q, const void* k, const void* v, void* o, int B,
                                 int Hq, int Hkv, int S, int D, int dtype, long long qsb,
                                 long long qsh, long long qss, long long ksb, long long ksh,
                                 long long kss, long long vsb, long long vsh, long long vss,
                                 long long osb, long long osh, long long oss, void* stream) {
  const int esize = dtype == kF32 ? 4 : 2;
  const long long strides[12] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss};
  bool aligned = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                   reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) %
                  16) == 0;
  for (long long s : strides) aligned = aligned && (s * esize) % 16 == 0;
  if ((D != 128 && D != 256) || dtype < kBF16 || dtype > kF32 || B < 1 || S < kRows ||
      S % kRows || Hkv < 1 || Hq % Hkv || !aligned)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, {qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss}, {osb, osh, oss},
               S, Hq / Hkv, 1.0f / sqrtf(static_cast<float>(D))};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBF16:
      return D == 128 ? launch_wg<__nv_bfloat16, 128>(a, B, Hq, Hkv, st)
                      : launch_wg<__nv_bfloat16, 256>(a, B, Hq, Hkv, st);
    case kF16:
      return D == 128 ? launch_wg<__half, 128>(a, B, Hq, Hkv, st)
                      : launch_wg<__half, 256>(a, B, Hq, Hkv, st);
    default:
      return D == 128 ? launch_tf32<128>(a, B, Hq, Hkv, st)
                      : launch_tf32<256>(a, B, Hq, Hkv, st);
  }
}
