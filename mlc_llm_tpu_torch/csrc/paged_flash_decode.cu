// Paged flash-decode attention over the head-packed page pool, bf16 or int8 KV.
//
// Replaces the Pallas kernel mlc_llm_tpu/ops/pallas/paged_attention.py
// paged_flash_decode -> _kernel (one decode step of one layer). Same math,
// same rounding points (the plain version, ops/paged_attention.py
// paged_flash_decode_plain, repeats them):
//   for slot b and query head hq (kv-head h = hq / rep, group g = h / hb,
//   lanes (h % hb) * D .. + D of each [ps, hb * D] page row):
//   q_pos = lengths[b] (pre-advance: the current token's KV is written);
//   pages p = 0 .. min(np - 1, q_pos / ps), page id table[b, p];
//   s = (q . k) in f32 (int8: k codes as bf16, then s *= ks[pos]),
//       s *= 1/sqrt(D), positions > q_pos masked to -1e30;
//   online softmax per page, m / l / acc in f32; pij = exp(s - m_new) is
//   rounded to bf16 before the PV product in bf16 mode; in int8 mode
//   V = v_code * vs[pos] in f32 and pij stays f32;
//   out = acc / max(l, 1e-20), bf16.
//
// Bound on the H100: bytes. Every valid K/V row of a slot is read once
// (2 * D bytes per position per head in bf16, D + 4 in int8) and the dots
// do ~2 flops per byte read, far below the ~295 flops/byte ridge. What the
// design does about it:
//   * one block per (kv-head, slot) holds up to 8 of the rep query rows
//     that share the kv-head (more rows: more blocks along z), so each K/V
//     row is read once for all of them (GQA);
//   * the block loads its own page ids from the table (the TPU kernel's
//     scalar prefetch) and walks only the pages and positions up to q_pos:
//     a short slot in a mixed batch reads only its own length;
//   * 16 lanes own one position's 128-element row, 8 elements each (one
//     16-byte load in bf16, 8 bytes in int8), so a warp reads two rows per
//     load, and each lane issues the loads of 4 positions before it uses
//     any: 256 threads keep 64 rows (16 KB in bf16) in flight per block,
//     which a latency-bound walk of a long slot needs;
//   * scores reduce over the 16 lanes with 4 shuffles; PV accumulates in
//     registers per lane group (8 columns x rows), rescaled by each page's
//     alpha, and the 16 groups' partial sums are added in a fixed order at
//     the end, so results do not change from run to run.
// Split-KV over pages (flash-decoding) for long contexts at small batch,
// cp.async / TMA staging and tensor-core dots are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kD = 128;                   // head dim
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 16;                // lanes per position row
constexpr int kEl = kD / kLanes;          // elements per lane: 8
constexpr int kGroups = kThreads / kLanes;  // positions per pass: 16
constexpr int kUnroll = 4;                // positions per lane group per pass
constexpr int kMaxRows = 8;               // query rows per block
constexpr float kNegInf = -1e30f;

template <bool INT8>
struct Row;  // one lane's 8 elements of a K or V row, as loaded

template <>
struct Row<false> {
  uint4 u;
  __device__ __forceinline__ void load(const void* base, size_t idx) {
    u = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(base) + idx);
  }
  __device__ __forceinline__ void zero() { u = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ void to_float(float (&x)[kEl]) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < kEl / 2; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      x[2 * j] = f.x;
      x[2 * j + 1] = f.y;
    }
  }
};

template <>
struct Row<true> {
  uint2 u;
  __device__ __forceinline__ void load(const void* base, size_t idx) {
    u = *reinterpret_cast<const uint2*>(static_cast<const int8_t*>(base) + idx);
  }
  __device__ __forceinline__ void zero() { u = make_uint2(0, 0); }
  __device__ __forceinline__ void to_float(float (&x)[kEl]) const {
    const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int j = 0; j < kEl; ++j) x[j] = static_cast<float>(c[j]);
  }
};

__device__ __forceinline__ float group_sum(float v) {  // over 16 lanes
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <bool INT8, int RB>
__global__ void __launch_bounds__(kThreads)
paged_flash_decode_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ kp,
                          const void* __restrict__ vp, const float* __restrict__ ks,
                          const float* __restrict__ vs, const int32_t* __restrict__ table,
                          const int32_t* __restrict__ lengths, __nv_bfloat16* __restrict__ out,
                          int L, int P, int ps, int hb, int maxp, int np, int layer, int rep,
                          float scale) {
  extern __shared__ float smem[];
  float* p_s = smem;               // [RB][ps]: scores, then probabilities
  float* acc_s = p_s + RB * ps;    // [RB][kD]: the groups' summed PV
  float* m_s = acc_s + RB * kD;    // [RB]
  float* l_s = m_s + RB;           // [RB]
  float* a_s = l_s + RB;           // [RB] this page's rescale factor

  const int h = blockIdx.x, b = blockIdx.y, Hkv = gridDim.x;
  const int row0 = blockIdx.z * RB, nrows = min(RB, rep - row0);
  const int g = h / hb, hh = h % hb;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = tid / kLanes, sub = tid % kLanes;
  const size_t hbD = (size_t)hb * kD;
  const size_t lane_off = (size_t)hh * kD + kEl * sub;
  const int q_pos = lengths[b];
  const int n_pages = min(np - 1, q_pos / ps) + 1;
  const size_t q0 = (((size_t)b * Hkv + h) * rep + row0) * kD;

  float qr[RB][kEl], acc[RB][kEl];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    Row<false> t;
    if (r < nrows) t.load(q, q0 + (size_t)r * kD + kEl * sub);
    else t.zero();
    t.to_float(qr[r]);
#pragma unroll
    for (int j = 0; j < kEl; ++j) acc[r][j] = 0.f;
  }
  for (int i = tid; i < RB * kD; i += kThreads) acc_s[i] = 0.f;
  if (tid < RB) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  for (int p = 0; p < n_pages; ++p) {
    const size_t page = ((size_t)g * L + layer) * P + table[(size_t)b * maxp + p];
    const int nvalid = min(ps, q_pos - p * ps + 1);  // positions <= q_pos

    // scores: each lane group takes positions grp, grp + 16, ...; every
    // lane joins the shuffles, with zeros past nvalid
    for (int base = 0; base < nvalid; base += kGroups * kUnroll) {
      Row<INT8> kr[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int pos = base + grp + u * kGroups;
        if (pos < nvalid) kr[u].load(kp, (page * ps + pos) * hbD + lane_off);
        else kr[u].zero();
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int pos = base + grp + u * kGroups;
        float k[kEl];
        kr[u].to_float(k);
        const float ksc = (INT8 && pos < nvalid) ? ks[(page * hb + hh) * ps + pos] : 1.f;
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          float d = 0.f;
#pragma unroll
          for (int j = 0; j < kEl; ++j) d = fmaf(qr[r][j], k[j], d);
          d = group_sum(d);
          if (INT8) d *= ksc;
          if (sub == 0 && pos < nvalid && r < nrows) p_s[r * ps + pos] = d * scale;
        }
      }
    }
    __syncthreads();

    // online softmax update, one warp per query row
    for (int r = warp; r < nrows; r += kWarps) {
      float* pr = p_s + r * ps;
      float mx = kNegInf;
      for (int i = lane; i < nvalid; i += 32) mx = fmaxf(mx, pr[i]);
      mx = warp_max(mx);
      const float m_prev = m_s[r], m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int i = lane; i < nvalid; i += 32) {
        const float e = expf(pr[i] - m_new);
        sum += e;
        pr[i] = INT8 ? e : __bfloat162float(__float2bfloat16(e));
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V, per lane group over its positions
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const float alpha = r < nrows ? a_s[r] : 0.f;
#pragma unroll
      for (int j = 0; j < kEl; ++j) acc[r][j] *= alpha;
    }
    for (int base = 0; base < nvalid; base += kGroups * kUnroll) {
      Row<INT8> vr[kUnroll];
      float vsc[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int pos = base + grp + u * kGroups;
        vsc[u] = 1.f;
        if (pos < nvalid) {
          vr[u].load(vp, (page * ps + pos) * hbD + lane_off);
          if (INT8) vsc[u] = vs[(page * ps + pos) * hb + hh];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int pos = base + grp + u * kGroups;
        if (pos >= nvalid) continue;
        float v[kEl];
        vr[u].to_float(v);
        if (INT8) {
#pragma unroll
          for (int j = 0; j < kEl; ++j) v[j] *= vsc[u];
        }
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          if (r >= nrows) break;
          const float pij = p_s[r * ps + pos];
#pragma unroll
          for (int j = 0; j < kEl; ++j) acc[r][j] = fmaf(pij, v[j], acc[r][j]);
        }
      }
    }
    __syncthreads();  // p_s and a_s are rewritten by the next page
  }

  // the 16 lane groups' partial sums, added in a fixed order
  for (int gi = 0; gi < kGroups; ++gi) {
    if (grp == gi) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r >= nrows) break;
#pragma unroll
        for (int j = 0; j < kEl; ++j) acc_s[r * kD + kEl * sub + j] += acc[r][j];
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < nrows * kD; i += kThreads)
    out[q0 + i] = __float2bfloat16(acc_s[i] / fmaxf(l_s[i / kD], 1e-20f));
}

template <bool INT8, int RB>
int launch(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
           const void* table, const void* lengths, void* out, int B, int Hkv, int L, int P,
           int ps, int hb, int maxp, int np, int layer, int rep, cudaStream_t st) {
  const size_t smem = (size_t)(RB * ps + RB * kD + 3 * RB) * sizeof(float);
  auto kern = paged_flash_decode_kernel<INT8, RB>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(Hkv, B, (rep + RB - 1) / RB), kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), kp, vp, static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(lengths), static_cast<__nv_bfloat16*>(out), L, P, ps, hb,
      maxp, np, layer, rep, 1.0f / sqrtf(static_cast<float>(kD)));
  return static_cast<int>(cudaGetLastError());
}

template <bool INT8>
int launch_rows(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
                const void* table, const void* lengths, void* out, int B, int Hkv, int L, int P,
                int ps, int hb, int maxp, int np, int layer, int rep, cudaStream_t st) {
  // the fewest register rows that hold rep (rep > 8: several blocks per kv-head)
  auto go = [&](auto rows) {
    return launch<INT8, decltype(rows)::value>(q, kp, vp, ks, vs, table, lengths, out, B,
                                               Hkv, L, P, ps, hb, maxp, np, layer, rep, st);
  };
  if (rep == 1) return go(std::integral_constant<int, 1>());
  if (rep == 2) return go(std::integral_constant<int, 2>());
  if (rep <= 4) return go(std::integral_constant<int, 4>());
  return go(std::integral_constant<int, kMaxRows>());
}

}  // namespace

// q [B, Hq, 1, D] bf16; k/v pages [G, L, P, ps, hb*D] bf16 or int8 (int8 = 1);
// ks [G, L, P, hb, ps] and vs [G, L, P, ps, hb] f32 (int8 only, else null);
// table int32 [B, maxp]; lengths int32 [B]; out [B, Hq, 1, D] bf16.
// Needs D == 128, Hq % (G*hb) == 0, 1 <= np <= maxp, 16-byte aligned q and pages.
// Returns cudaGetLastError() after the launch.
extern "C" int mlc_paged_flash_decode(const void* q, const void* kp, const void* vp,
                                      const void* ks, const void* vs, const void* table,
                                      const void* lengths, void* out, int B, int Hq, int G,
                                      int L, int P, int ps, int hb, int D, int maxp, int np,
                                      int layer, int int8, void* stream) {
  const int Hkv = G * hb;
  if (D != kD || Hkv <= 0 || Hq % Hkv || np < 1 || np > maxp ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(kp) |
       reinterpret_cast<uintptr_t>(vp)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rep = Hq / Hkv;
  return int8 ? launch_rows<true>(q, kp, vp, ks, vs, table, lengths, out, B, Hkv, L, P, ps, hb,
                                  maxp, np, layer, rep, st)
              : launch_rows<false>(q, kp, vp, ks, vs, table, lengths, out, B, Hkv, L, P, ps,
                                   hb, maxp, np, layer, rep, st);
}
