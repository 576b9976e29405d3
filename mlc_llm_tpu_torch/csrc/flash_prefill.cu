// Causal flash attention of a reset prefill: a block's queries against the
// block's own keys and values, with the online softmax.
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
// q, k, v [B, H, S, D] with any strides whose last dimension is contiguous
// (the forward hands over its [B, S, H, D] projections as they are); Hkv
// divides Hq and query head h reads kv-head h / (Hq / Hkv) (JAX repeats the
// kv-heads; nothing is repeated here). The output is written through its own
// strides (the forward's [B, S, H, D]).
//
// Bound on the H100: at S = 1024 and 2048 with D = 128 the work is
// 2 * B * H * S^2 * D causal operations against 4 * B * H * S * D * 2 bytes
// of q, k, v and o, ~S/4 operations a byte: near the bf16 ridge (~295) at
// S = 1024, above it at 2048, so the tensor cores and the bytes bound it
// about equally. What the design does:
//   * one block per (64-query tile, head, batch), four warps of 16 query
//     rows; the tiles with the most keys are scheduled first;
//   * Q is staged once in shared memory; K and V tiles (64 keys at D = 128,
//     32 at D = 256, so that the f32 output accumulator of 16 x D a warp
//     fits the registers) are staged by cp.async into two buffers, the next
//     tile loading while the current one computes; rows are padded by 16
//     bytes so ldmatrix reads them without bank conflicts;
//   * bf16 and f16 run both products on the tensor cores with
//     mma.sync.m16n8k16 and f32 accumulation: S = Q K^T from ldmatrix
//     fragments, the scores stay in registers, P is rounded to v's type in
//     registers and fed as the A fragment of P V (V fragments by
//     ldmatrix.trans); nothing of the [S, S] matrix reaches memory;
//   * tiles above the diagonal are never loaded; a warp skips a tile whose
//     keys all lie above its rows; the diagonal tile is masked;
//   * f32 runs a CUDA-core body: a block of 8 warps holds 32 query rows (4 a
//     warp) against 32-key tiles; lane j computes key j's scores with float4
//     reads of a padded K row, the warp reduces max and sum by shuffles, and
//     each lane accumulates D / 32 output columns.
// wgmma and TMA, a persistent schedule and warp specialisation are later
// work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every cp.async group of this thread but the newest one has landed
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  // c[16 x 8] += a[16 x 16] b[16 x 8], f32 accumulation
  static __device__ __forceinline__ void run(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // two f32 values rounded to the type, lo in the low half
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

// ---------------------------------------------------------------- bf16 / f16

constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcRows = 16 * kTcWarps;  // query rows a block

template <int D>
struct TcTile {
  static constexpr int kKeys = D == 256 ? 32 : 64;  // keys a K/V tile
  static constexpr int kLd = D + 8;                 // a staged row, elements: +16 bytes
  static constexpr int kSmemElems = (kTcRows + 4 * kKeys) * kLd;  // Q, 2 x K, 2 x V
};

template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads) flash_prefill_tc(Args a) {
  using Tile = TcTile<D>;
  constexpr int BN = Tile::kKeys, LD = Tile::kLd, CH = D / 8;  // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // [64][LD]
  T* sK = sQ + kTcRows * LD;               // [2][BN][LD]
  T* sV = sK + 2 * BN * LD;                // [2][BN][LD]

  const int qb = gridDim.x - 1 - blockIdx.x;  // the tiles with the most keys first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / a.rep;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* qg = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h +
                static_cast<long long>(qb) * kTcRows * a.qs.s;
  const T* kg = static_cast<const T*>(a.k) + b * a.ks.b + hk * a.ks.h;
  const T* vg = static_cast<const T*>(a.v) + b * a.vs.b + hk * a.vs.h;

  for (int i = tid; i < kTcRows * CH; i += kTcThreads) {
    const int r = i / CH, c = i % CH;
    cp_async16(sQ + r * LD + c * 8, qg + r * a.qs.s + c * 8);
  }
  auto load_kv = [&](int t, int buf) {
    const T* kt = kg + static_cast<long long>(t) * BN * a.ks.s;
    const T* vt = vg + static_cast<long long>(t) * BN * a.vs.s;
    T* dk = sK + buf * BN * LD;
    T* dv = sV + buf * BN * LD;
    for (int i = tid; i < BN * CH; i += kTcThreads) {
      const int r = i / CH, c = i % CH;
      cp_async16(dk + r * LD + c * 8, kt + r * a.ks.s + c * 8);
      cp_async16(dv + r * LD + c * 8, vt + r * a.vs.s + c * 8);
    }
  };
  // keys [0, (qb + 1) * 64): every tile at or below the diagonal
  const int n_tiles = (qb + 1) * kTcRows / BN;
  load_kv(0, 0);
  cp_async_commit();

  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = qb * kTcRows + warp * 16;  // the warp's first query row
  const int r_lo = row0 + g, r_hi = row0 + g + 8;
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;  // l: this thread's share

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_kv(t + 1, (t + 1) & 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const int key0 = t * BN;
    if (key0 <= row0 + 15) {  // some key of the tile is at or below a row of this warp
      const T* cK = sK + (t & 1) * BN * LD;
      const T* cV = sV + (t & 1) * BN * LD;
      float s[BN / 8][4];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qa[4];
        ldsm_x4(qa, sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int nn = 0; nn < BN / 16; ++nn) {
          uint32_t kb[4];
          ldsm_x4(kb, cK + (nn * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 +
                          ((lane >> 3) & 1) * 8);
          Mma<T>::run(s[2 * nn], qa, kb[0], kb[1]);
          Mma<T>::run(s[2 * nn + 1], qa, kb[2], kb[3]);
        }
      }
      // scale, mask above the diagonal, the tile's row max
      const bool diag = key0 + BN - 1 > row0;
      float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = key0 + j * 8 + 2 * t4;
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= a.scale;
        if (diag) {
          if (c > r_lo) s[j][0] = -INFINITY;
          if (c + 1 > r_lo) s[j][1] = -INFINITY;
          if (c > r_hi) s[j][2] = -INFINITY;
          if (c + 1 > r_hi) s[j][3] = -INFINITY;
        }
        mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
      }
      // a row lives on the 4 threads of a quad
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
      // tile 0 holds key 0, at or below every row: the max is finite from it on
      const float al_lo = __expf(m_lo - mx_lo), al_hi = __expf(m_hi - mx_hi);
      m_lo = mx_lo;
      m_hi = mx_hi;
      float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        s[j][0] = __expf(s[j][0] - mx_lo);
        s[j][1] = __expf(s[j][1] - mx_lo);
        s[j][2] = __expf(s[j][2] - mx_hi);
        s[j][3] = __expf(s[j][3] - mx_hi);
        rs_lo += s[j][0] + s[j][1];
        rs_hi += s[j][2] + s[j][3];
      }
      l_lo = l_lo * al_lo + rs_lo;
      l_hi = l_hi * al_hi + rs_hi;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][0] *= al_lo;
        acc[j][1] *= al_lo;
        acc[j][2] *= al_hi;
        acc[j][3] *= al_hi;
      }
      // P (rounded to v's type) . V: the score fragments of keys 16 kk ..
      // 16 kk + 15 are the A fragment as they lie
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint32_t pa[4] = {Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]),
                                Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]),
                                Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dd = 0; dd < D / 16; ++dd) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, cV + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD + dd * 16 +
                                (lane >> 4) * 8);
          Mma<T>::run(acc[2 * dd], pa, vb[0], vb[1]);
          Mma<T>::run(acc[2 * dd + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // the buffer just read is the next iteration's load target
  }

  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
  T* og = static_cast<T*>(a.o) + b * a.os.b + h * a.os.h;
  uint32_t* o_lo = reinterpret_cast<uint32_t*>(og + r_lo * a.os.s + 2 * t4);
  uint32_t* o_hi = reinterpret_cast<uint32_t*>(og + r_hi * a.os.s + 2 * t4);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o_lo[j * 4] = Mma<T>::pack(acc[j][0] * inv_lo, acc[j][1] * inv_lo);
    o_hi[j * 4] = Mma<T>::pack(acc[j][2] * inv_hi, acc[j][3] * inv_hi);
  }
}

// ----------------------------------------------------------------------- f32

constexpr int kF32Warps = 8;
constexpr int kF32Threads = kF32Warps * 32;
constexpr int kF32Rows = 32;                       // query rows a block
constexpr int kF32Keys = 32;                       // keys a tile: one a lane
constexpr int kRowsPerWarp = kF32Rows / kF32Warps;  // 4

template <int D>
struct F32Tile {
  // K rows padded by 4 floats: lane j's float4 reads of row j, 8 lanes a
  // phase, fall on 32 distinct banks
  static constexpr int kLdK = D + 4;
  static constexpr int kSmemFloats = kF32Rows * D + 2 * kF32Keys * kLdK + 2 * kF32Keys * D;
};

template <int D>
__global__ void __launch_bounds__(kF32Threads, 2) flash_prefill_f32(Args a) {
  using Tile = F32Tile<D>;
  constexpr int LDK = Tile::kLdK, CH = D / 4, DL = D / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [32][D]
  float* sK = sQ + kF32Rows * D;                   // [2][32][LDK]
  float* sV = sK + 2 * kF32Keys * LDK;             // [2][32][D]

  const int qb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / a.rep;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* qg = static_cast<const float*>(a.q) + b * a.qs.b + h * a.qs.h +
                    static_cast<long long>(qb) * kF32Rows * a.qs.s;
  const float* kg = static_cast<const float*>(a.k) + b * a.ks.b + hk * a.ks.h;
  const float* vg = static_cast<const float*>(a.v) + b * a.vs.b + hk * a.vs.h;

  for (int i = tid; i < kF32Rows * CH; i += kF32Threads) {
    const int r = i / CH, c = i % CH;
    cp_async16(sQ + r * D + c * 4, qg + r * a.qs.s + c * 4);
  }
  auto load_kv = [&](int t, int buf) {
    const float* kt = kg + static_cast<long long>(t) * kF32Keys * a.ks.s;
    const float* vt = vg + static_cast<long long>(t) * kF32Keys * a.vs.s;
    for (int i = tid; i < kF32Keys * CH; i += kF32Threads) {
      const int r = i / CH, c = i % CH;
      cp_async16(sK + (buf * kF32Keys + r) * LDK + c * 4, kt + r * a.ks.s + c * 4);
      cp_async16(sV + (buf * kF32Keys + r) * D + c * 4, vt + r * a.vs.s + c * 4);
    }
  };
  const int n_tiles = qb + 1;  // 32-key tiles at or below the diagonal
  load_kv(0, 0);
  cp_async_commit();

  const int rw0 = warp * kRowsPerWarp;  // the warp's first row in the block
  float o[kRowsPerWarp][DL];
  float m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) o[r][i] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_kv(t + 1, (t + 1) & 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const float* cK = sK + (t & 1) * kF32Keys * LDK;
    const float* cV = sV + (t & 1) * kF32Keys * D;
    // lane j: key t * 32 + j against the warp's rows
    float s[kRowsPerWarp] = {};
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(cK + lane * LDK + d);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(sQ + (rw0 + r) * D + d);
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
      }
    }
    const int key = t * kF32Keys + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = qb * kF32Rows + rw0 + r;
      float sr = key > row ? -INFINITY : s[r] * a.scale;
      float mx = sr;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      mx = fmaxf(mx, m[r]);  // finite: tile 0 holds key 0
      const float p = __expf(sr - mx);
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      const float al = __expf(m[r] - mx);
      l[r] = l[r] * al + ps;
      m[r] = mx;
      s[r] = p;
#pragma unroll
      for (int i = 0; i < DL; ++i) o[r][i] *= al;
    }
#pragma unroll 8
    for (int j = 0; j < kF32Keys; ++j) {
      float vj[DL];
#pragma unroll
      for (int i = 0; i < DL; ++i) vj[i] = cV[j * D + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pj = __shfl_sync(0xffffffffu, s[r], j);
#pragma unroll
        for (int i = 0; i < DL; ++i) o[r][i] = fmaf(pj, vj[i], o[r][i]);
      }
    }
    __syncthreads();
  }

  float* og = static_cast<float*>(a.o) + b * a.os.b + h * a.os.h;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const float inv = 1.f / l[r];
    float* orow = og + static_cast<long long>(qb * kF32Rows + rw0 + r) * a.os.s;
#pragma unroll
    for (int i = 0; i < DL; ++i) orow[lane + 32 * i] = o[r][i] * inv;
  }
}

// ------------------------------------------------------------------ launches

template <typename K>
int launch_kernel(K kern, dim3 grid, int threads, size_t smem, cudaStream_t st, const Args& a) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<grid, threads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_tc(const Args& a, int B, int Hq, cudaStream_t st) {
  return launch_kernel(flash_prefill_tc<T, D>, dim3(a.S / kTcRows, Hq, B), kTcThreads,
                       TcTile<D>::kSmemElems * sizeof(T), st, a);
}

template <int D>
int launch_f32(const Args& a, int B, int Hq, cudaStream_t st) {
  return launch_kernel(flash_prefill_f32<D>, dim3(a.S / kF32Rows, Hq, B), kF32Threads,
                       F32Tile<D>::kSmemFloats * sizeof(float), st, a);
}

}  // namespace

// q [B, Hq, S, D], k and v [B, Hkv, S, D] and o [B, Hq, S, D], each through
// its (batch, head, position) strides in elements with the last dimension
// contiguous; dtype 0 bf16, 1 f16, 2 f32 for all four. Needs D in {128,
// 256}, S % 64 == 0, Hkv dividing Hq, 16-byte aligned pointers and strides
// that are multiples of 16 bytes. Returns cudaGetLastError() after the
// launch.
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
  if ((D != 128 && D != 256) || dtype < kBF16 || dtype > kF32 || B < 1 || S < 64 || S % 64 ||
      Hkv < 1 || Hq % Hkv || !aligned)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, {qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss}, {osb, osh, oss},
               S, Hq / Hkv, 1.0f / sqrtf(static_cast<float>(D))};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBF16:
      return D == 128 ? launch_tc<__nv_bfloat16, 128>(a, B, Hq, st)
                      : launch_tc<__nv_bfloat16, 256>(a, B, Hq, st);
    case kF16:
      return D == 128 ? launch_tc<__half, 128>(a, B, Hq, st) : launch_tc<__half, 256>(a, B, Hq, st);
    default:
      return D == 128 ? launch_f32<128>(a, B, Hq, st) : launch_f32<256>(a, B, Hq, st);
  }
}
