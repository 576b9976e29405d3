// Paged flash-decode attention over the head-packed page pool.
//
// Replaces the Pallas kernel mlc_llm_tpu/ops/pallas/paged_attention.py
// paged_flash_decode -> _kernel (one decode step of one layer). Same math,
// same rounding points (the plain version, ops/paged_attention.py
// paged_flash_decode_plain, repeats them):
//   for slot b and query head hq (kv-head h = hq / rep, group g = h / hb,
//   lanes (h % hb) * D .. + D of each [ps, hb * D] page row):
//   q_pos = lengths[b] (pre-advance: the current token's KV is written);
//   pages p = 0 .. min(np - 1, q_pos / ps), page id table[b, p];
//   q is rounded to the page type (bf16 for int8 codes), once;
//   s = (q . k) in f32 (int8: k codes as bf16, then s *= ks[pos]),
//       s *= 1/sqrt(D), positions > q_pos masked to -1e30;
//   online softmax per page, m / l / acc in f32; pij = exp(s - m_new) is
//   rounded to bf16 before the PV product only for bf16 pages (f16 and f32
//   pages keep it f32); in int8 mode V = v_code * vs[pos] in f32;
//   out = acc / max(l, 1e-20), in q's type.
// Query types bf16, f16 and f32; page types bf16, f16, f32 and int8 (with
// f32 scales); head dims 80, 128 and 256.
//
// Bound on the H100: bytes. Every valid K/V row of a slot is read once
// (2 * D * sizeof(page) bytes per position per head, D + 4 each in int8)
// and the dots do ~2 flops per byte read, far below the ~295 flops/byte
// ridge. What the design does about it:
//   * one block per (kv-head, slot, split) holds up to 8 of the rep query
//     rows that share the kv-head (D = 256: 2; more rows: more blocks along
//     z), so each K/V row is read once for all of them (GQA);
//   * the block loads its own page ids from the table (the TPU kernel's
//     scalar prefetch) and walks only the pages and positions up to q_pos:
//     a short slot in a mixed batch reads only its own length;
//   * a group of 16 lanes owns one position's row, EL elements a lane (EL =
//     8 for D <= 128, 16 for D = 256; at D = 80 lanes 10-15 of a group stay
//     idle, so that the shuffle reduction keeps its 16 lanes and each lane's
//     row slice stays 16-byte aligned: h * 80 elements is 160 bytes), and
//     each lane issues the loads of 4 positions before it uses any: 256
//     threads keep 64 rows in flight per block, which a latency-bound walk
//     of a long slot needs;
//   * q is read in its own type and rounded in the prologue, and the output
//     is written in it in the epilogue, so the walk is compiled once per
//     page type, lane width and row count (24 instantiations);
//   * scores reduce over the 16 lanes with 4 shuffles; PV accumulates in
//     registers per lane group (EL columns x rows), rescaled by each page's
//     alpha, and the 16 groups' partial sums are added in a fixed order at
//     the end (a warp's two by a shuffle, then the 8 warps' in warp order),
//     so results do not change from run to run;
//   * split-KV (flash-decoding): the grid's x axis holds nsplit splits of
//     each kv-head; split s walks pages [s * pps, min(n_pages, (s + 1) *
//     pps)) of its slot with the online softmax above from an empty state
//     (so with bf16 pages pij is rounded against the split's own running
//     max) and writes its partial, f32 acc, m and l per query row, to a
//     workspace. A lone long slot then runs on nsplit times as many blocks
//     as kv-heads, not on 32 of the 132 SMs. The last split to finish a
//     (slot, kv-head, row block) learns it from an atomic ticket taken after
//     a __threadfence(), combines the partials in split order (m = max m_s,
//     acc = sum_s exp(m_s - m) * acc_s, l the same way), writes acc / max(l,
//     1e-20) and puts the ticket back to 0, so the call stays one launch and
//     its result does not change from run to run. A split that starts past
//     the slot's length holds the empty partial (m = -1e30, l = 0, which
//     weighs exp(-1e30 - m) = 0 in the combine): it takes its ticket and
//     writes nothing, and the combine reads only the splits that hold pages.
//     pps comes from the wrapper's plan (ops/paged_attention.py
//     split_pages), made from shapes the host knows, never from lengths;
//     nsplit = 1 writes the output directly, as before the split;
//   * with int8 pages the V rows of a page and their scales are staged into
//     shared memory with cp.async when the page starts (each lane its own
//     slice, the scales by a group's first lane), so they land while the
//     scores and the softmax run, and the PV pass reads them from shared
//     memory: a page costs the K rows' load latency, not K's and then V's
//     and their scales'. bf16, f16 and f32 pages load V as K (their 32-64
//     KB of staged rows would cut the blocks an SM holds by more than the
//     latency saves).
// TMA staging, prefetching the next page and tensor-core dots are later
// work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 16;                  // lanes per position row
constexpr int kGroups = kThreads / kLanes;  // positions per pass: 16
constexpr int kUnroll = 4;                  // positions per lane group per pass
constexpr float kNegInf = -1e30f;

enum QType { kQBF16 = 0, kQF16 = 1, kQF32 = 2 };  // ops/paged_attention.py Q_TYPES

// one lane's EL elements of a K or V row, as loaded (KT: the page type)
template <typename KT, int EL>
struct Row {
  static constexpr int kBytes = EL * static_cast<int>(sizeof(KT));
  static constexpr int kVec = kBytes >= 16 ? 16 : 8;  // int8 at EL = 8: one 8-byte load
  static constexpr int kN = kBytes / kVec;
  uint32_t w[kBytes / 4];

  __device__ __forceinline__ void load(const void* base, size_t idx) {
    const uint8_t* p = reinterpret_cast<const uint8_t*>(static_cast<const KT*>(base) + idx);
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      if constexpr (kVec == 16) {
        const uint4 v = *reinterpret_cast<const uint4*>(p + 16 * i);
        w[4 * i] = v.x;
        w[4 * i + 1] = v.y;
        w[4 * i + 2] = v.z;
        w[4 * i + 3] = v.w;
      } else {
        const uint2 v = *reinterpret_cast<const uint2*>(p + 8 * i);
        w[2 * i] = v.x;
        w[2 * i + 1] = v.y;
      }
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kBytes / 4; ++i) w[i] = 0u;
  }
  // from shared memory, where stage() put it
  __device__ __forceinline__ void load_shared(const uint8_t* p) {
#pragma unroll
    for (int i = 0; i < kBytes / 4; ++i) w[i] = reinterpret_cast<const uint32_t*>(p)[i];
  }
  // copy the lane's slice of row idx into shared memory at dst (cp.async,
  // completes at the next cp_async_wait_all of this thread)
  static __device__ __forceinline__ void stage(uint8_t* dst, const void* base, size_t idx) {
    const uint8_t* src = reinterpret_cast<const uint8_t*>(static_cast<const KT*>(base) + idx);
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      if constexpr (kVec == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d + 16 * i), "l"(src + 16 * i)
                     : "memory");
      else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d + 8 * i), "l"(src + 8 * i)
                     : "memory");
    }
  }
  __device__ __forceinline__ void to_float(float (&x)[EL]) const {
    if constexpr (sizeof(KT) == 2) {
#pragma unroll
      for (int j = 0; j < EL / 2; ++j) {
        float2 f;
        if constexpr (std::is_same<KT, __nv_bfloat16>::value)
          f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
        else
          f = __half22float2(*reinterpret_cast<const __half2*>(&w[j]));
        x[2 * j] = f.x;
        x[2 * j + 1] = f.y;
      }
    } else if constexpr (std::is_same<KT, float>::value) {
#pragma unroll
      for (int j = 0; j < EL; ++j) x[j] = __uint_as_float(w[j]);
    } else if constexpr (std::is_same<KT, int8_t>::value) {
      const int8_t* c = reinterpret_cast<const int8_t*>(w);
#pragma unroll
      for (int j = 0; j < EL; ++j) x[j] = static_cast<float>(c[j]);
    }
  }
};

// v rounded to the type q is cast to before the score dot: the page type,
// bf16 for int8 codes
template <typename KT>
__device__ __forceinline__ float round_q(float v) {
  if constexpr (std::is_same<KT, __half>::value) return __half2float(__float2half_rn(v));
  else if constexpr (std::is_same<KT, float>::value) return v;
  else return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float load_q(const void* q, size_t i, int qt) {
  if (qt == kQF32) return static_cast<const float*>(q)[i];
  if (qt == kQF16) return __half2float(static_cast<const __half*>(q)[i]);
  return __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i]);
}

__device__ __forceinline__ void store_out(void* out, size_t i, float v, int qt) {
  if (qt == kQF32) static_cast<float*>(out)[i] = v;
  else if (qt == kQF16) static_cast<__half*>(out)[i] = __float2half_rn(v);
  else static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v);
}

__device__ __forceinline__ void cp_async_scalar(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// V rows staged in shared memory: int8 pages only (with their scales); with
// 2- and 4-byte pages the 32-64 KB a block would stage cost more in blocks
// an SM holds than the V loads' latency (scripts/torch_plan_sweep.py)
template <typename KT>
constexpr bool kStageV = std::is_same<KT, int8_t>::value;

// shared-memory bytes of a block: p_s [RB][ps], acc_s [RB][D], m_s, l_s,
// a_s [RB], red_s [8 warps][RB][D] (f32), then, staging, from a 16-byte
// boundary the page's V rows [ps][16 lanes][a lane's bytes] and their
// scales [ps]
template <int RB>
__host__ __device__ constexpr size_t v_offset(int ps, int D) {
  return ((size_t)(RB * ps + RB * D + 3 * RB + kWarps * RB * D) * 4 + 15) / 16 * 16;
}
template <typename KT, int EL, int RB>
__host__ __device__ constexpr size_t smem_bytes(int ps, int D) {
  return v_offset<RB>(ps, D) +
         (kStageV<KT> ? (size_t)ps * kLanes * EL * sizeof(KT) + (size_t)ps * 4 : 0);
}

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

// the split-KV workspace: partials [nsplit][B * Hq][D] (acc) and [nsplit][B
// * Hq][2] (m, l), and one ticket per (slot, kv-head, row block), zero
// between launches
struct Split {
  float* acc;
  float* ml;
  int* tickets;
  int n, pps;  // splits, pages per split
};

// the blocks an SM must hold, for one row of 2-byte or int8 pages (the
// registry's models): 4 (at most 64 registers a thread) at 8 elements a
// lane (Vicuna-7B, the NeoX 3B), 2 (128) at 16 (MOSS): the page walk is
// latency bound and wants blocks in flight, and left to itself ptxas takes
// more registers than these; f32 pages and more rows would spill, and
// take what they need
template <typename KT, int EL, int RB>
constexpr int kMinBlocks = RB == 1 && sizeof(KT) <= 2 ? (EL == 8 ? 4 : 2) : 1;

template <typename KT, int EL, int RB>
__global__ void __launch_bounds__(kThreads, kMinBlocks<KT, EL, RB>)
paged_flash_decode_kernel(const void* __restrict__ q, const void* __restrict__ kp,
                          const void* __restrict__ vp, const float* __restrict__ ks,
                          const float* __restrict__ vs, const int32_t* __restrict__ table,
                          const int32_t* __restrict__ lengths, void* __restrict__ out, int L,
                          int P, int ps, int hb, int D, int maxp, int np, int layer, int rep,
                          int qt, float scale, const Split sp) {
  constexpr bool kInt8 = std::is_same<KT, int8_t>::value;
  extern __shared__ float smem[];
  float* p_s = smem;               // [RB][ps]: scores, then probabilities
  float* acc_s = p_s + RB * ps;    // [RB][D]: the groups' summed PV
  float* m_s = acc_s + RB * D;     // [RB]
  float* l_s = m_s + RB;           // [RB]
  float* a_s = l_s + RB;           // [RB] this page's rescale factor
  float* red_s = a_s + RB;         // [kWarps][RB][D]: the warps' PV sums
  uint8_t* v_s = reinterpret_cast<uint8_t*>(smem) + v_offset<RB>(ps, D);
  float* vs_s = reinterpret_cast<float*>(v_s + (size_t)ps * kLanes * Row<KT, EL>::kBytes);
  __shared__ int last;             // this block finishes its cell's combine

  const int h = blockIdx.x / sp.n, split = blockIdx.x % sp.n, b = blockIdx.y;
  const int Hkv = gridDim.x / sp.n;
  const int row0 = blockIdx.z * RB, nrows = min(RB, rep - row0);
  const int g = h / hb, hh = h % hb;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = tid / kLanes, sub = tid % kLanes;
  const bool live = sub * EL < D;  // D = 80: lanes 10-15 of a group idle
  const size_t hbD = (size_t)hb * D;
  const size_t lane_off = (size_t)hh * D + EL * sub;
  const int q_pos = lengths[b];
  const int n_pages = min(np - 1, q_pos / ps) + 1;
  const int p0 = split * sp.pps, p1 = min(n_pages, p0 + sp.pps);
  const size_t q0 = (((size_t)b * Hkv + h) * rep + row0) * D;

  float qr[RB][EL], acc[RB][EL];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int j = 0; j < EL; ++j) {
      qr[r][j] = (r < nrows && live && p0 < p1)
                     ? round_q<KT>(load_q(q, q0 + (size_t)r * D + EL * sub + j, qt))
                     : 0.f;
      acc[r][j] = 0.f;
    }
  if (tid < RB) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  for (int p = p0; p < p1; ++p) {
    const size_t page = ((size_t)g * L + layer) * P + table[(size_t)b * maxp + p];
    const int nvalid = min(ps, q_pos - p * ps + 1);  // positions <= q_pos

    // int8: the lane's V rows of the page and their scales start for shared
    // memory now and land while the scores and the softmax run
    if constexpr (kStageV<KT>) {
      if (live) {
        for (int pos = grp; pos < nvalid; pos += kGroups) {
          Row<KT, EL>::stage(v_s + ((size_t)pos * kLanes + sub) * Row<KT, EL>::kBytes, vp,
                             (page * ps + pos) * hbD + lane_off);
          if (sub == 0) cp_async_scalar(vs_s + pos, vs + (page * ps + pos) * hb + hh);
        }
      }
      cp_async_commit();
    }

    // scores: each lane group takes positions grp, grp + 16, ...; every
    // lane joins the shuffles, with zeros past nvalid and on idle lanes
    for (int base = 0; base < nvalid; base += kGroups * kUnroll) {
      Row<KT, EL> kr[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int pos = base + grp + u * kGroups;
        if (pos < nvalid && live) kr[u].load(kp, (page * ps + pos) * hbD + lane_off);
        else kr[u].zero();
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int pos = base + grp + u * kGroups;
        float k[EL];
        kr[u].to_float(k);
        const float ksc = (kInt8 && pos < nvalid) ? ks[(page * hb + hh) * ps + pos] : 1.f;
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          float d = 0.f;
#pragma unroll
          for (int j = 0; j < EL; ++j) d = fmaf(qr[r][j], k[j], d);
          d = group_sum(d);
          if (kInt8) d *= ksc;
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
        pr[i] = std::is_same<KT, __nv_bfloat16>::value ? __bfloat162float(__float2bfloat16(e)) : e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    if constexpr (kStageV<KT>) cp_async_wait_all();  // the barrier shows everyone's
    __syncthreads();

    // acc = acc * alpha + P V, per lane group over its positions
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const float alpha = r < nrows ? a_s[r] : 0.f;
#pragma unroll
      for (int j = 0; j < EL; ++j) acc[r][j] *= alpha;
    }
    for (int base = 0; base < nvalid && live; base += kGroups * kUnroll) {
      Row<KT, EL> vr[kUnroll];
      float vsc[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int pos = base + grp + u * kGroups;
        vsc[u] = 1.f;
        if (pos < nvalid) {
          if constexpr (kStageV<KT>) {
            vr[u].load_shared(v_s + ((size_t)pos * kLanes + sub) * Row<KT, EL>::kBytes);
            vsc[u] = vs_s[pos];
          } else {
            vr[u].load(vp, (page * ps + pos) * hbD + lane_off);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int pos = base + grp + u * kGroups;
        if (pos >= nvalid) continue;
        float v[EL];
        vr[u].to_float(v);
        if (kInt8) {
#pragma unroll
          for (int j = 0; j < EL; ++j) v[j] *= vsc[u];
        }
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          if (r >= nrows) break;
          const float pij = p_s[r * ps + pos];
#pragma unroll
          for (int j = 0; j < EL; ++j) acc[r][j] = fmaf(pij, v[j], acc[r][j]);
        }
      }
    }
    __syncthreads();  // p_s and a_s are rewritten by the next page
  }

  // the 16 lane groups' partial sums, added in a fixed order: a warp's two
  // groups by one shuffle, then the 8 warps' sums through shared memory in
  // warp order, behind one barrier (an empty split, p0 >= n_pages, skips
  // this uniformly: it holds no partial)
  if (p0 < p1) {
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int j = 0; j < EL; ++j) acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], kLanes);
    if (lane < kLanes && live) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r >= nrows) break;
#pragma unroll
        for (int j = 0; j < EL; ++j) red_s[(warp * RB + r) * D + EL * sub + j] = acc[r][j];
      }
    }
    __syncthreads();
    for (int i = tid; i < nrows * D; i += kThreads) {
      float v = red_s[i];
      for (int w = 1; w < kWarps; ++w) v += red_s[w * RB * D + i];
      acc_s[i] = v;
    }
    __syncthreads();
  }
  if (sp.n == 1) {
    for (int i = tid; i < nrows * D; i += kThreads)
      store_out(out, q0 + i, acc_s[i] / fmaxf(l_s[i / D], 1e-20f), qt);
    return;
  }

  // split-KV: write this split's partial, take the cell's ticket; the last
  // split combines all partials in split order. The indices are derived
  // again from blockIdx and the slot's length, so that the page walk above
  // keeps fewer registers live
  const int sx = blockIdx.x % sp.n, bx = blockIdx.y;
  const int hx = blockIdx.x / sp.n, row0x = blockIdx.z * RB;
  const int n_pages_x = min(np - 1, lengths[bx] / ps) + 1;
  const size_t rows = (size_t)gridDim.y * Hkv * rep;  // B * Hq query rows
  const size_t row_base = ((size_t)bx * Hkv + hx) * rep + row0x;
  if (sx * sp.pps < n_pages_x) {
    float* pa = sp.acc + ((size_t)sx * rows + row_base) * D;
    for (int i = tid; i < nrows * D; i += kThreads) pa[i] = acc_s[i];
    if (tid < nrows) {
      float* pm = sp.ml + 2 * ((size_t)sx * rows + row_base + tid);
      pm[0] = m_s[tid];
      pm[1] = l_s[tid];
    }
  }
  __threadfence();
  __syncthreads();
  const size_t cell = ((size_t)bx * Hkv + hx) * gridDim.z + blockIdx.z;
  if (tid == 0) last = atomicAdd(&sp.tickets[cell], 1) == sp.n - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int ns = (n_pages_x + sp.pps - 1) / sp.pps;  // the splits that hold pages
  for (int i = tid; i < nrows * D; i += kThreads) {
    const size_t row = row_base + i / D;
    float m = kNegInf;
    for (int s = 0; s < ns; ++s) m = fmaxf(m, __ldcg(sp.ml + 2 * ((size_t)s * rows + row)));
    float a = 0.f, l = 0.f;
    for (int s = 0; s < ns; ++s) {
      const size_t k = (size_t)s * rows + row;
      const float w = expf(__ldcg(sp.ml + 2 * k) - m);
      l = __fadd_rn(l, __fmul_rn(w, __ldcg(sp.ml + 2 * k + 1)));
      a = __fadd_rn(a, __fmul_rn(w, __ldcg(sp.acc + k * D + i % D)));
    }
    store_out(out, row_base * D + i, a / fmaxf(l, 1e-20f), qt);
  }
  if (tid == 0) sp.tickets[cell] = 0;
}

struct Args {
  const void *q, *kp, *vp, *ks, *vs, *table, *lengths;
  void* out;
  int B, Hkv, L, P, ps, hb, D, maxp, np, layer, rep, qt;
  Split sp;
  cudaStream_t st;
};

template <typename KT, int EL, int RB>
int launch(const Args& a) {
  const size_t smem = smem_bytes<KT, EL, RB>(a.ps, a.D);
  auto kern = paged_flash_decode_kernel<KT, EL, RB>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(a.Hkv * a.sp.n, a.B, (a.rep + RB - 1) / RB), kThreads, smem, a.st>>>(
      a.q, a.kp, a.vp, static_cast<const float*>(a.ks), static_cast<const float*>(a.vs),
      static_cast<const int32_t*>(a.table), static_cast<const int32_t*>(a.lengths), a.out, a.L,
      a.P, a.ps, a.hb, a.D, a.maxp, a.np, a.layer, a.rep, a.qt,
      1.0f / sqrtf(static_cast<float>(a.D)), a.sp);
  return static_cast<int>(cudaGetLastError());
}

// the fewest register rows that hold rep (more: several blocks per kv-head);
// EL = 16 (D = 256) holds at most 2 rows
template <typename KT>
int launch_rows(const Args& a) {
  if (a.D == 256) return a.rep == 1 ? launch<KT, 16, 1>(a) : launch<KT, 16, 2>(a);
  if (a.rep == 1) return launch<KT, 8, 1>(a);
  if (a.rep == 2) return launch<KT, 8, 2>(a);
  if (a.rep <= 4) return launch<KT, 8, 4>(a);
  return launch<KT, 8, 8>(a);
}

}  // namespace

// q [B, Hq, 1, D] in qt (0 bf16, 1 f16, 2 f32); k/v pages [G, L, P, ps,
// hb*D] in kt (0 bf16, 1 f16, 2 f32, 3 int8); ks [G, L, P, hb, ps] and vs
// [G, L, P, ps, hb] f32 (int8 only, else null); table int32 [B, maxp];
// lengths int32 [B]; out [B, Hq, 1, D] in qt. nsplit splits of pps pages
// cover the window np, none empty ((nsplit - 1) * pps < np <= nsplit *
// pps); when nsplit > 1, part_acc f32 [nsplit, B * Hq, D], part_ml f32
// [nsplit, B * Hq, 2] and tickets int32 [B * Hq], all zero between launches
// (the kernel puts each ticket it takes back to 0). Needs D in {80, 128,
// 256}, Hq % (G*hb) == 0, 1 <= np <= maxp, 16-byte aligned q and pages.
// Returns cudaGetLastError() after the launch.
extern "C" int mlc_paged_flash_decode(const void* q, const void* kp, const void* vp,
                                      const void* ks, const void* vs, const void* table,
                                      const void* lengths, void* out, int B, int Hq, int G,
                                      int L, int P, int ps, int hb, int D, int maxp, int np,
                                      int layer, int kt, int qt, int nsplit, int pps,
                                      void* part_acc, void* part_ml, void* tickets,
                                      void* stream) {
  const int Hkv = G * hb;
  if ((D != 80 && D != 128 && D != 256) || qt < kQBF16 || qt > kQF32 || Hkv <= 0 ||
      Hq % Hkv || np < 1 || np > maxp || nsplit < 1 || pps < 1 || (nsplit - 1) * pps >= np ||
      nsplit * pps < np ||
      (nsplit > 1 && (part_acc == nullptr || part_ml == nullptr || tickets == nullptr)) ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(kp) |
       reinterpret_cast<uintptr_t>(vp)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const Split sp{static_cast<float*>(part_acc), static_cast<float*>(part_ml),
                 static_cast<int*>(tickets), nsplit, pps};
  const Args a{q, kp, vp, ks, vs, table, lengths, out, B, Hkv, L, P, ps, hb, D, maxp, np, layer,
               Hq / Hkv, qt, sp, static_cast<cudaStream_t>(stream)};
  switch (kt) {
    case 0: return launch_rows<__nv_bfloat16>(a);
    case 1: return launch_rows<__half>(a);
    case 2: return launch_rows<float>(a);
    case 3: return launch_rows<int8_t>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
