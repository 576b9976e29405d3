"""Where a stage of a tensor-core kernel spends its time, on the GPU, by
ablation.

    python scripts/torch_ablation.py --kernel gemv_gp
    python scripts/torch_ablation.py --kernel gemm_plane
    python scripts/torch_ablation.py --kernel gemv_stream
    python scripts/torch_ablation.py --kernel flash_prefill

Builds variants of this tree's kernel, each with one part of its stage
taken out by a source edit, all with one nvcc each started together, and
times them through the kernel's C entry. The variants compute wrong
results on purpose and are timed only.

--kernel gemv_gp: csrc/dequant_gemv_gp.cu, the bf16/f16 policy's stage
(GpHalf), the f16 body at m = 8 through `mlc_gemv_gp_tc`, at the GPT-NeoX
3B shapes (wqkv, wo, w_in, w_out; stored K) under several split-K plans:
- base: the policy as it is;
- no_sums: the group sums of x and the warpgroups' barrier skipped (sx =
  0 in the fold);
- no_fold: the whole fold skipped (sums, barrier, the scale and offset
  arithmetic);
- no_dequant: A a constant instead of the words' codes (no shared-memory
  word loads, no bit assembly);
- no_mma: the stage's wgmma skipped;
- none: no fold, no dequant and no wgmma: the TMA ring and the loop alone.
A plan with one split-K part at w_out (80 stages in 20 blocks, one an SM)
reads as time per stage of a block.

--kernel gemm_plane: csrc/dequant_gemm_plane.cu, the streamed k16 step of
the mainloop (csrc/dequant_wgmma.cuh, kStream), through `mlc_gemm_plane`
under the wrapper's plan (`plane_tiles`): q3bf16_s16 at the Vicuna-7B
shapes (wqkv, wo, w_in, w_out; stored K) at m = 2048, and at w_in m = 128;
fp4bf16 and q8bf16 at w_in, m = 2048:
- base: the kernel as it is;
- no_mma: the step's wgmma skipped (the dequant kept live);
- no_dequant: A a constant instead of the words' values (no shared-memory
  word or scale loads, no bit assembly);
- ring: neither: the TMA ring, its barriers and the loop alone.

--kernel gemv_stream: the weight-streaming mainloop of the m = 1 GEMVs
(csrc/gemv_stream.cuh, the qsplit policy QsStream of
csrc/dequant_gemv_qs.cu), bf16, m = 1, through `mlc_gemv_qs` at the
Vicuna-7B shapes (stored K), under the wrapper's plan (`stream_plan`) and
with twice its parts:
- base: the kernel as it is;
- no_codes: a code is the word or-ed into 0x41800000 (no shift, no lop3
  per code; one a word);
- no_math: no codes and no FMAs (the words and x still read from shared
  memory, one add a row);
- ring: no stage consumed (the ring, its barriers, the x staging and the
  combine alone);
- no_stage_x: ring and math as base, no x slice staged or summed;
- no_combine: the parts write their partials, no ticket, no combine;
- empty: the kernel returns at once (the launch and timing floor);
- stages3, stages4: a ring of 3 or 4 stages (2 as built);
- cols1: one column a consumer thread (two as built; eight consumer warps
  a block instead of four).

--kernel flash_prefill: csrc/flash_prefill.cu, the bf16/f16 wgmma body
(flash_prefill_wg), through `mlc_flash_prefill` at chip_smoke.py's
FLASH_CASES shapes (q, k, v the strided views of one projection):
- base: the kernel as it is (within a warpgroup, the softmax of tile t
  under the P V of tile t - 1; no ping-pong);
- producer_wg: a third warpgroup issues the loads, setmaxnreg 24 / 240;
- pingpong: the two warpgroups take turns to issue their products;
- no_overlap: within a warpgroup, every wgmma group waited for at once;
- qb_fastest: the grid's query tiles vary fastest (heaviest first within
  a head) instead of the heads;
- l2_256: the tensor maps promote L2 fetches to 256 bytes (128 as built);
- direct_store: the output stored from registers, 16 bytes a thread after
  a transpose over each quad, instead of staged in shared memory for one
  TMA store a 64-column block;
- no_exp: ex2 a copy (the softmax without its MUFU work);
- no_qk, no_pv: the Q K^T or the P V wgmma skipped;
- no_mma: both skipped (the TMA ring, barriers and softmax alone);
and the f32 body (flash_prefill_tf32, 3xTF32 on wgmma .tf32) at the same
shapes in f32 (base and no_exp time it too):
- f32_no_mma: every wgmma skipped (loads, splits, softmax and fold alone);
- f32_1xtf32: one TF32 product each (hi . hi), no cross terms;
- f32_no_split: the lo planes of Q, K and V^T not written (their products
  still run);
- f32_no_convert: no landed K or V tile split or transposed.

Times are CUDA-event means with the 50 MB L2 flushed before each launch,
as chip_smoke.py times them. Prints ptxas's registers and spills of each
flash_prefill variant's kernel entries, one JSON line per case, then the
card's name and power limit. The variants are built under
csrc/build/ablation/<kernel>/. An edit is (old, new) in the kernel's
edited file, or (file, old, new).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "mlc_llm_tpu_torch", "csrc")
OUT = os.path.join(CSRC, "build", "ablation")
sys.path.insert(0, ROOT)

from mlc_llm_tpu_torch.ops import NVCC_FLAGS, _nvcc  # noqa: E402
from mlc_llm_tpu_torch.ops import attention as att  # noqa: E402
from mlc_llm_tpu_torch.ops import dequant_matmul as dm  # noqa: E402
from mlc_llm_tpu_torch.quant import pad_quantized_groups, quantize, resolve_spec  # noqa: E402

# ---- gemv_gp: edits of csrc/dequant_gemv_gp.cu
GP_NO_SUMS = [('''    asm volatile("bar.sync 1, 256;" ::: "memory");
    fold_groups<T, MT>(acc, d, st, ch, c, p,
                       [&](int g, int tok) { return sxs[i & 1][g][tok]; });''',
               '''    fold_groups<T, MT>(acc, d, st, ch, c, p, [&](int, int) { return 0.f; });'''),
              ('''      if (tid % 4 == 0)
        sxs[i & 1][g][tok] = L == kPair''', '''      if (tid % 4 == 8)
        sxs[i & 1][g][tok] = L == kPair''')]
GP_NO_FOLD = [('''    static_assert(MT == kMaxMT, "the x sums cover a 16-token tile");
    __shared__ float sxs[2][4][16];''', '''    static_assert(MT == kMaxMT, "the x sums cover a 16-token tile");
    if (MT > 0) return;
    __shared__ float sxs[2][4][16];''')]
GP_NO_DEQUANT = [('''    const uint32_t* W = reinterpret_cast<const uint32_t*>(wt);
    if constexpr (L == kPair) {
#pragma unroll
      for (int k = 0; k < kSteps; ++k)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint32_t t = W[(2 * k + r / 2) * wg::kBN + ch + 8 * (r % 2)] >> (8 * c);''',
                  '''    const uint32_t* W = reinterpret_cast<const uint32_t*>(wt);
    if (kSteps > 0) {
      for (int k = 0; k < kSteps; ++k)
        for (int r = 0; r < 4; ++r) a[k][r] = 0x3c003c00u + ch;
      return;
    }
    if constexpr (L == kPair) {
#pragma unroll
      for (int k = 0; k < kSteps; ++k)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint32_t t = W[(2 * k + r / 2) * wg::kBN + ch + 8 * (r % 2)] >> (8 * c);''')]
# codes2 never yields 0x3039 and the constant above never does: no MMA runs
GP_NO_MMA = [('''    for (int k = 0; k < kSteps; ++k)
      wg::Wgmma<MT, T>::mma(d[k / 2], a[k], wg::desc_sw32(x + k * MT * wg::kTileRow), k % 2);''',
              '''    for (int k = 0; k < kSteps; ++k)
      if (a[k][0] == 0x3039u)
        wg::Wgmma<MT, T>::mma(d[k / 2], a[k], wg::desc_sw32(x + k * MT * wg::kTileRow), k % 2);''')]

# ---- gemm_plane: edits of csrc/dequant_wgmma.cuh
PLANE_DEQUANT = """          if (k % P::kChunkSteps == 0) w = P::fetch(wt, sc, ch, c, k / P::kChunkSteps, p);
          P::dequant_step(k % P::kChunkSteps, a[k % 2], w, p);
"""
PLANE_MMA = """          Wgmma<MT, T>::mma(acc, a[k % 2], desc_sw32(st + k * MT * kTileRow));
"""
PLANE_NO_DEQUANT = [(PLANE_DEQUANT, """          a[k % 2][0] = a[k % 2][1] = a[k % 2][2] = a[k % 2][3] = 0x3F803F80u + ch;
""")]
PLANE_NO_MMA = [(PLANE_MMA, """          asm volatile("" ::"r"(a[k % 2][0]), "r"(a[k % 2][1]), "r"(a[k % 2][2]),
                       "r"(a[k % 2][3]));
""")]


# ---- gemv_stream: edits of csrc/dequant_gemv_qs.cu (QsStream) and csrc/gemv_stream.cuh
QS_CODES = """        for (int e = 0; e < 8; ++e) q[cc][e] = gs::code16(w[cc], 4 * (e / 2) + 16 * (e % 2));"""
QS_FMAS = """            p[m][e / 2][cc] = fmaf(xv[e], q[cc][e], p[m][e / 2][cc]);"""
STREAM_NO_CODES = [(QS_CODES, """        for (int e = 0; e < 8; ++e) q[cc][e] = __uint_as_float(w[cc] | 0x41800000u);""")]
STREAM_NO_MATH = STREAM_NO_CODES + [(QS_FMAS, """            if (e == 0) p[m][0][cc] += q[cc][0] + xv[0];""")]
STREAM_COLS1 = [("gemv_stream.cuh", "constexpr int kColsPerThread = 2; ",
                 "constexpr int kColsPerThread = 1; ")]
STREAM_CONSUME = """    P::template consume<M>(smem + slot * P::kStageBytes, xs + i * kRows * M * kXRow,
                           sxs + i * P::kGroups * M, acc, asym, tid);"""
STREAM_RING = [("gemv_stream.cuh", STREAM_CONSUME, """    acc[0][0] += sxs[i];""")]
STREAM_NO_STAGE_X = [("gemv_stream.cuh", """  wg::mbar_wait(&xbar, 0);
""", ""), ("gemv_stream.cuh",
           """    xs[idx] = r >= 0 ? Num<T>::to_f(xraw[m * slice + r]) : 0.f;""",
           """    xs[idx] = 0.f * r;"""),
                     ("gemv_stream.cuh",
                      """    const float v = P::group_sum(xs + i * kRows * M * kXRow, j, m, M, lane);""",
                      """    const float v = 0.f * lane;""")]
STREAM_NO_COMBINE = [("gemv_stream.cuh", """  if (tid == 0) last = ticket_acq_rel""",
                      """  if (M > 0) return;
  if (tid == 0) last = ticket_acq_rel""")]
STREAM_EMPTY = [("gemv_stream.cuh", """  const bool asym = p.z != nullptr;
""", """  const bool asym = p.z != nullptr;
  if (p.K > 0) return;
""")]
QS_STAGES = "  static constexpr int kWordBytes = 4, kGroups = 4, kStages = 2;"
STREAM_STAGES = {r: [(QS_STAGES, QS_STAGES.replace("kStages = 2", f"kStages = {r}"))]
                 for r in (3, 4)}

VICUNA_STORED = ((4096, 12288), (4096, 4096), (4096, 22016), (11264, 4096), (4096, 32000))


def _qs_inputs(gen, K, N):
    w = torch.randint(-2**31, 2**31 - 1, (K // 8, N), generator=gen, device="cuda",
                      dtype=torch.int64).to(torch.int32)
    s = (torch.rand((K // 32, N), generator=gen, device="cuda") * 0.01).bfloat16()
    z = (torch.rand((K // 32, N), generator=gen, device="cuda") * -0.05).bfloat16()
    x = torch.randn((1, K), generator=gen, device="cuda").bfloat16()
    return x, w, s, z


def gemv_stream_cases(gen):
    """(row, launch(lib)) for the bf16 qsplit stream at m = 1, the wrapper's
    plan and twice its parts."""
    for K, N in VICUNA_STORED:
        x, w, s, z = _qs_inputs(gen, K, N)
        out = torch.empty((1, N), dtype=torch.bfloat16, device="cuda")
        steps = K // 128
        _, planned, _ = dm.stream_plan("qsplit", 1, K, N)
        for want in sorted({planned, min(steps, 2 * planned)}):
            per = -(-steps // want)
            parts = -(-steps // per)
            if per > dm.STREAM_MAX_PER:
                continue
            part = torch.empty((parts, 1, N), dtype=torch.float32, device="cuda")
            tickets = torch.zeros(-(-N // 256), dtype=torch.int32, device="cuda")

            def launch(lib, part=part, tickets=tickets, parts=parts, per=per):
                return lib.mlc_gemv_qs(0, x.data_ptr(), w.data_ptr(), s.data_ptr(),
                                       z.data_ptr(), part.data_ptr(), tickets.data_ptr(),
                                       out.data_ptr(), 1, K, N, 0, parts, per,
                                       torch.cuda.current_stream().cuda_stream)
            yield dict(k=K, n=N, m=1, dtype="bfloat16", parts=parts, per=per,
                       planned=parts == planned), launch


def gemv_gp_cases(gen):
    """(row, launch(lib)) for the f16 GEMV at m = 8, both layouts, each plan."""
    m = 8
    for K, N in ((3072, 8192), (3072, 2560), (3072, 10240), (10240, 2560)):  # stored K, N
        G, steps = K // 32, K // 128
        w = torch.randint(-2**31, 2**31 - 1, (K // 8, N), generator=gen, device="cuda",
                          dtype=torch.int64).to(torch.int32)
        s = (torch.rand((G, N), generator=gen, device="cuda") * 0.01).half()
        z = (torch.rand((G, N), generator=gen, device="cuda") * -0.05).half()
        x = torch.randn((m, K), generator=gen, device="cuda").half()
        out = torch.empty((m, N), dtype=torch.half, device="cuda")
        for layout, lname in ((1, "hsplit"), (0, "pair")):
            for splits in (1, 2, 3, 4, 6):
                per = -(-steps // splits)
                parts = -(-steps // per)
                part = (torch.empty((parts, m, N), dtype=torch.float32, device="cuda")
                        if parts > 1 else None)

                def launch(lib, layout=layout, part=part, parts=parts, per=per):
                    return lib.mlc_gemv_gp_tc(
                        layout, 1, x.data_ptr(), None, w.data_ptr(), s.data_ptr(),
                        z.data_ptr(), None if part is None else part.data_ptr(),
                        out.data_ptr(), m, K, N, 0, 0, parts, per,
                        torch.cuda.current_stream().cuda_stream)
                yield dict(k=K, n=N, m=m, layout=lname, dtype="float16", parts=parts,
                           per=per), launch


def gemm_plane_cases(gen):
    """(row, launch(lib)) for the plane GEMM under the wrapper's plan."""
    cases = ([("q3bf16_s16", k, n, 2048) for k, n in
              ((4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096))]
             + [("q3bf16_s16", 4096, 22016, 128), ("fp4bf16", 4096, 22016, 2048),
                ("q8bf16", 4096, 22016, 2048)])
    for preset, k, n, m in cases:
        spec = resolve_spec(preset)
        qt = pad_quantized_groups(quantize(
            torch.randn((k, n), generator=gen, device="cuda") * 0.02, spec))
        fmt = dm.PLANE_FORMATS[(spec.mode, spec.storage, spec.group_size)]
        rows, N = qt.data.shape
        G = qt.scale.shape[0]
        epw = 1 if spec.storage == "i8" else spec.elems_per_word
        x = torch.randn((m, rows * epw), generator=gen, device="cuda").to(torch.bfloat16)
        mt, splits, per = dm.plane_tiles(fmt, m, N, rows)
        planes = 0 if spec.storage == "i8" else epw + int(spec.mode == "int3")
        xt = (torch.empty((planes, m, -(-rows // 8) * 8), dtype=torch.bfloat16, device="cuda")
              if planes else None)
        part = (torch.empty((splits, m, N), dtype=torch.float32, device="cuda")
                if splits > 1 else None)
        out = torch.empty((m, N), dtype=torch.bfloat16, device="cuda")

        def launch(lib, fmt=fmt, x=x, xt=xt, qt=qt, part=part, out=out, m=m, G=G, N=N, mt=mt,
                   splits=splits, per=per, max_int=spec.max_int):
            return lib.mlc_gemm_plane(
                fmt, dm.DTYPE_IDS[x.dtype], x.data_ptr(), None if xt is None else xt.data_ptr(), qt.data.data_ptr(),
                qt.scale.data_ptr(), None if part is None else part.data_ptr(),
                out.data_ptr(), m, G, N, mt, splits, per, max_int, 0,
                torch.cuda.current_stream().cuda_stream)
        yield dict(quant=preset, k=rows * epw, n=N, m=m, mt=mt, parts=splits), launch


# ---- flash_prefill: edits of csrc/flash_prefill.cu
# ping-pong: the warpgroups take turns to issue their products (named
# barriers 3 and 4); each takes n_block + 1 turns (the first Q K^T, one a
# tile after it, the last P V; the first pads with empty turns at BN = 64),
# the first goes first and the second hands over no last turn
FP_PINGPONG = [
    ("// one consumer warp's share of a stage's release\n", """__device__ __forceinline__ void my_turn(int wgi) {
  asm volatile("bar.sync %0, 256;" ::"r"(3 + wgi) : "memory");
}
__device__ __forceinline__ void your_turn(int wgi) {
  asm volatile("bar.arrive %0, 256;" ::"r"(4 - wgi) : "memory");
}

// one consumer warp's share of a stage's release
"""),
    ("  wg::mbar_wait(&q_full, 0);\n  wg::mbar_wait(&k_full[0], 0);\n"
     "  issue_qk<T, D>(s, q_addr, k_addr);\n",
     "  if (wgi == 1) your_turn(wgi);\n  wg::mbar_wait(&q_full, 0);\n"
     "  wg::mbar_wait(&k_full[0], 0);\n  my_turn(wgi);\n"
     "  issue_qk<T, D>(s, q_addr, k_addr);\n  your_turn(wgi);\n"),
    ("    issue_qk<T, D>(s, q_addr, k_addr + st * W::kKVBytes);\n",
     "    my_turn(wgi);\n    issue_qk<T, D>(s, q_addr, k_addr + st * W::kKVBytes);\n"),
    ("    issue_pv<T, D>(o, p, v_addr + pst * W::kKVBytes);\n",
     "    issue_pv<T, D>(o, p, v_addr + pst * W::kKVBytes);\n    your_turn(wgi);\n"),
    ("    issue_pv<T, D>(o, p, v_addr + st * W::kKVBytes);\n",
     "    my_turn(wgi);\n    issue_pv<T, D>(o, p, v_addr + st * W::kKVBytes);\n"
     "    if (wgi == 0) your_turn(wgi);\n"
     "    for (int t = n_tiles; t < n_block; ++t) {\n      my_turn(wgi);\n"
     "      your_turn(wgi);\n    }\n")]
FP_QB_FASTEST = [("  const int h = blockIdx.x, b = blockIdx.y;\n  const int qb = gridDim.z - 1 - blockIdx.z;",
                  "  const int h = blockIdx.y, b = blockIdx.z;\n  const int qb = gridDim.x - 1 - blockIdx.x;"),
                 ("dim3(Hq, B, a.S / kRows)", "dim3(a.S / kRows, Hq, B)")]
# the output written from registers, 16 bytes a thread after a 4 x 4
# transpose of 32-bit words over each quad, instead of staged in shared
# memory and stored by TMA (the staging code is left unreachable)
FP_DIRECT_STORE = [
    ("flash_prefill_wg(const __grid_constant__ Maps maps, const int rep, const float c) {",
     "flash_prefill_wg(const __grid_constant__ Maps maps, const int rep, const float c,\n"
     "                 void* const out_p, const long long osb, const long long osh,\n"
     "                 const long long oss) {"),
    ("      maps, a.rep, a.scale * 1.4426950408889634f);",
     "      maps, a.rep, a.scale * 1.4426950408889634f, a.o, a.os.b, a.os.h, a.os.s);"),
    ("  uint8_t* so = sq + wgi * 64 * kAtom;\n", """  T* og = static_cast<T*>(out_p) + b * osb + h * osh;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float inv = half ? inv_b : inv_a;
    T* orow = og + static_cast<long long>(half ? row_b : row_a) * oss;
#pragma unroll
    for (int m = 0; m < D / 32; ++m) {
      uint32_t w[4], x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = wg::bits(wg::Vec2<T>::pair(o[16 * m + 4 * i + 2 * half] * inv,
                                          o[16 * m + 4 * i + 2 * half + 1] * inv));
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = cq ^ k;
        const uint32_t got = __shfl_xor_sync(
            0xffffffffu, i == 0 ? w[0] : i == 1 ? w[1] : i == 2 ? w[2] : w[3], k);
        x[k] = got;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = cq ^ i;
        y[i] = k == 0 ? x[0] : k == 1 ? x[1] : k == 2 ? x[2] : x[3];
      }
      *reinterpret_cast<uint4*>(orow + 8 * (4 * m + cq)) = make_uint4(y[0], y[1], y[2], y[3]);
    }
  }
  if (D > 0) return;
  uint8_t* so = sq + wgi * 64 * kAtom;
""")]
# a third warpgroup as the producer, with setmaxnreg moving registers to
# the consumers (24 and 240), as the GEMMs' mainloop does: thread 0 still
# issues Q and the first stages, thread 256 every later tile
FP_PRODUCER_WG = [
    ("constexpr int kThreads = 256;", "constexpr int kThreads = 384;"),
    ("    if (issuer && t + kStages - 1 < n_block) load.k(t + kStages - 1);\n", ""),
    ("    if (issuer && t + kStages - 1 < n_block) load.v(t + kStages - 1);\n", ""),
    ("  __syncthreads();\n\n  const uint32_t q_addr =", """  __syncthreads();
  if (tid >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid == 256)
      for (int t = kStages; t < n_block; ++t) {
        load.k(t);
        load.v(t);
      }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");

  const uint32_t q_addr =""")]
FP_L2_256 = [("dequant_wgmma.cuh", "CU_TENSOR_MAP_L2_PROMOTION_L2_128B",
              "CU_TENSOR_MAP_L2_PROMOTION_L2_256B")]
FP_NO_OVERLAP = [("    wg::wgmma_wait<1>();  // tile t's scores are in; P V still runs",
                  "    wg::wgmma_wait<0>();")]
FP_NO_EXP = [('  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "  y = x;")]
# a shared-memory address is never 0xFFFFFFFF: the guarded wgmma never runs
FP_NO_QK = [("    SS<BN, T>::mma(s, desc_sw128(",
             "    if (q_addr == 0xFFFFFFFFu) SS<BN, T>::mma(s, desc_sw128(")]
FP_NO_PV = [("    RS<D, T>::mma(o, p + 4 * kk,",
             "    if (v_addr == 0xFFFFFFFFu) RS<D, T>::mma(o, p + 4 * kk,")]
# the f32 body (flash_prefill_tf32), 3xTF32 on wgmma .tf32
FP32_QK = ("    Tf32SS<2 * BN>::mma(s2, q_hi, k, kk > 0);\n"
           "    Tf32SS<BN>::mma(s, q_lo, k, kk > 0);\n")
FP32_PV = ("    Tf32RS::mma(part, pl + 4 * j, v_hi, j > 0);\n"
           "    Tf32RS::mma(part, ph + 4 * j, v_lo, 1);\n"
           "    Tf32RS::mma(part, ph + 4 * j, v_hi, 1);\n")
# a shared-memory address is never 0xFFFFFFFF: the guarded wgmma never runs
FP32_NO_MMA = [(FP32_QK, "    if (qh == 0xFFFFFFFFu) {\n" + FP32_QK + "    }\n"),
               (FP32_PV, "    if (vh == 0xFFFFFFFFu) {\n" + FP32_PV + "    }\n")]
# one TF32 product each (hi . hi): what the split and the cross terms cost
FP32_ONE_PRODUCT = [(FP32_QK, "    Tf32SS<BN>::mma(s, q_hi, k, kk > 0);\n"),
                    ("      sum_s(s, s2);\n", ""),
                    (FP32_PV, "    Tf32RS::mma(part, ph + 4 * j, v_hi, j > 0);\n")]
# the lo planes of Q, K and V^T never written (their products still run)
FP32_NO_SPLIT = [("    reinterpret_cast<uint4*>(lo)[i] = l;\n", ""),
                 ("    *reinterpret_cast<uint4*>(at + kBlock) = l;\n", ""),
                 ("      *reinterpret_cast<uint32_t*>(vl + at) = l;\n", "")]
# no thread splits or transposes a landed K or V tile (Q is still split)
FP32_NO_CONVERT = [("    split_k<D>(sk, stk, tid);\n    split_v<D>(svt, svtl, stv, tid);\n", "")]

def flash_prefill_cases(gen):
    """(row, launch(lib)) for the bf16/f16 and the f32 body at chip_smoke.py's
    shapes."""
    from mlc_llm_tpu_torch.models import get_config

    moss = get_config("moss-moon-003-sft")
    for B, hq, hkv, S, D, dt in ((1, 32, 32, 1024, 128, torch.bfloat16),
                                 (1, 32, 32, 2048, 128, torch.bfloat16),
                                 (2, 32, 32, 1024, 128, torch.bfloat16),
                                 (1, 32, 32, 1024, 128, torch.float16),
                                 (1, moss.num_heads, moss.num_kv_heads, 1024, moss.head_dim,
                                  torch.bfloat16),
                                 (1, 32, 32, 1024, 128, torch.float32),
                                 (1, 32, 32, 2048, 128, torch.float32),
                                 (2, 32, 32, 1024, 128, torch.float32),
                                 (1, moss.num_heads, moss.num_kv_heads, 1024, moss.head_dim,
                                  torch.float32)):
        qkv = torch.randn((B, S, (hq + 2 * hkv) * D), generator=gen, device="cuda").to(dt)
        q, k, v = (t.reshape(B, S, -1, D).transpose(1, 2)
                   for t in qkv.split([hq * D, hkv * D, hkv * D], dim=-1))
        out = torch.empty((B, S, hq, D), dtype=dt, device="cuda").transpose(1, 2)
        strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]

        def launch(lib, q=q, k=k, v=v, out=out, strides=strides, B=B, hq=hq, hkv=hkv, S=S, D=D,
                   dt=dt):
            return lib.mlc_flash_prefill(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                         out.data_ptr(), B, hq, hkv, S, D, att.FLASH_TYPES[dt],
                                         *strides, torch.cuda.current_stream().cuda_stream)
        yield dict(b=B, hq=hq, hkv=hkv, s=S, d=D, dtype=str(dt).replace("torch.", "")), launch


# per kernel: the source built, the file the edits apply to, the C entry
# and its argument types, the variants' edits, the cases, and the reps
KERNELS = {
    "gemv_gp": dict(
        source="dequant_gemv_gp.cu", edited="dequant_gemv_gp.cu", entry="mlc_gemv_gp_tc",
        argtypes=[ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
        + [ctypes.c_void_p],
        variants={"base": [], "no_sums": GP_NO_SUMS, "no_fold": GP_NO_FOLD,
                  "no_dequant": GP_NO_DEQUANT, "no_mma": GP_NO_MMA,
                  "none": GP_NO_FOLD + GP_NO_DEQUANT + GP_NO_MMA},
        cases=gemv_gp_cases, reps=30),
    "gemm_plane": dict(
        source="dequant_gemm_plane.cu", edited="dequant_wgmma.cuh", entry="mlc_gemm_plane",
        argtypes=dm._PLANE_ARGS["mlc_gemm_plane"],
        variants={"base": [], "no_mma": PLANE_NO_MMA, "no_dequant": PLANE_NO_DEQUANT,
                  "ring": PLANE_NO_DEQUANT + PLANE_NO_MMA},
        cases=gemm_plane_cases, reps=10),
    "gemv_stream": dict(
        source="dequant_gemv_qs.cu", edited="dequant_gemv_qs.cu", entry="mlc_gemv_qs",
        argtypes=dm._GEMV_ARGS["mlc_gemv_qs"],
        variants={"base": [], "no_codes": STREAM_NO_CODES, "no_math": STREAM_NO_MATH,
                  "ring": STREAM_RING, "no_stage_x": STREAM_NO_STAGE_X,
                  "no_combine": STREAM_NO_COMBINE, "empty": STREAM_EMPTY,
                  "stages3": STREAM_STAGES[3], "stages4": STREAM_STAGES[4],
                  "cols1": STREAM_COLS1},
        cases=gemv_stream_cases, reps=30),
    "flash_prefill": dict(
        source="flash_prefill.cu", edited="flash_prefill.cu", entry="mlc_flash_prefill",
        argtypes=att._FLASH_ARGS["mlc_flash_prefill"],
        variants={"base": [], "producer_wg": FP_PRODUCER_WG, "pingpong": FP_PINGPONG,
                  "no_overlap": FP_NO_OVERLAP,
                  "qb_fastest": FP_QB_FASTEST, "l2_256": FP_L2_256,
                  "direct_store": FP_DIRECT_STORE, "no_exp": FP_NO_EXP,
                  "no_qk": FP_NO_QK, "no_pv": FP_NO_PV, "no_mma": FP_NO_QK + FP_NO_PV,
                  "f32_no_mma": FP32_NO_MMA, "f32_1xtf32": FP32_ONE_PRODUCT,
                  "f32_no_split": FP32_NO_SPLIT, "f32_no_convert": FP32_NO_CONVERT},
        cases=flash_prefill_cases, reps=30, ptxas=("flash_prefill_wg", "flash_prefill_tf32"),
        # f32_* variants time the f32 body, the others the bf16/f16 body;
        # base and no_exp (the shared ex2) both
        applies=lambda name, row: name in ("base", "no_exp")
        or name.startswith("f32_") == (row["dtype"] == "float32")),
}


def apply_edits(d: str, edits, edited: str):
    """Apply each edit, (old, new) in `edited` or (file, old, new), to the
    sources copied into d."""
    for edit in edits:
        fname, old, new = edit if len(edit) == 3 else (edited, *edit)
        path = os.path.join(d, fname)
        src = open(path).read()
        if old not in src:
            raise SystemExit(f"csrc/{fname} changed: an ablation edit no longer applies")
        with open(path, "w") as f:
            f.write(src.replace(old, new, 1))


def build(kernel: str):
    """One nvcc per variant, all started together; the loaded libraries."""
    spec = KERNELS[kernel]
    procs = []
    for name, edits in spec["variants"].items():
        d = os.path.join(OUT, kernel, name)
        os.makedirs(d, exist_ok=True)
        for f in os.listdir(d):
            os.remove(os.path.join(d, f))
        for f in os.listdir(CSRC):
            if f.endswith(".cuh") or f == spec["source"]:
                shutil.copy(os.path.join(CSRC, f), d)
        apply_edits(d, edits, spec["edited"])
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", os.path.join(d, "variant.so"),
               os.path.join(d, spec["source"])]
        procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for the {name} variant:\n{out}")
        entry = None
        for line in out.splitlines():  # ptxas: each entry's registers and spills
            hit = re.search(r"Compiling entry function '(\S+)'", line)
            if hit:
                entry = hit.group(1)
            elif entry and any(p in entry for p in spec.get("ptxas", ())) and (
                    "spill" in line or "Used" in line):
                print(json.dumps({"variant": name, "entry": entry, "ptxas": line.strip()}))
        lib = ctypes.CDLL(os.path.join(OUT, kernel, name, "variant.so"))
        getattr(lib, spec["entry"]).argtypes = spec["argtypes"]
        libs[name] = lib
    return libs


def time_ms(fn, flush, reps):
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    for start, end in ev:
        flush.sum()
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / reps


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="gemv_gp")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    spec = KERNELS[args.kernel]
    libs = build(args.kernel)
    flush = torch.ones(64 * 2**20, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for row, launch in spec["cases"](gen):
        for name, lib in libs.items():
            if not spec.get("applies", lambda n, r: True)(name, row):
                continue

            def run(lib=lib, name=name):
                err = launch(lib)
                if err:
                    raise RuntimeError(f"{name}: cudaError {err}")
            row[name] = time_ms(run, flush, spec["reps"])
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
