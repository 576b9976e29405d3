"""Where a stage of the tensor-core pair/hsplit GEMV spends its time, on
the GPU, by ablation.

    python scripts/torch_gp_gemv_ablation.py

Builds variants of this tree's csrc/dequant_gemv_gp.cu, each with one part
of the bf16/f16 policy's stage (GpHalf) taken out, and times the f16 body
at m = 8 through the C entry `mlc_gemv_gp_tc`, at the GPT-NeoX 3B shapes
(wqkv, wo, w_in, w_out; stored K) under several split-K plans. The
variants compute wrong results on purpose and are timed only:
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
reads as time per stage of a block. Times are CUDA-event means with the
50 MB L2 flushed before each launch, as chip_smoke.py times them. Prints
one JSON line per (shape, layout, plan), then the card's name and power
limit. The variants are built under csrc/build/ablation/.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "mlc_llm_tpu_torch", "csrc")
OUT = os.path.join(CSRC, "build", "ablation")
sys.path.insert(0, ROOT)

from mlc_llm_tpu_torch.ops import NVCC_FLAGS, _nvcc  # noqa: E402

SHAPES = [(3072, 8192), (3072, 2560), (3072, 10240), (10240, 2560)]  # stored K, N
SPLITS = (1, 2, 3, 4, 6)
NO_SUMS = [('''    asm volatile("bar.sync 1, 256;" ::: "memory");
    fold_groups<T, MT>(acc, d, st, ch, c, p,
                       [&](int g, int tok) { return sxs[i & 1][g][tok]; });''',
            '''    fold_groups<T, MT>(acc, d, st, ch, c, p, [&](int, int) { return 0.f; });'''),
           ('''      if (tid % 4 == 0)
        sxs[i & 1][g][tok] = L == kPair''', '''      if (tid % 4 == 8)
        sxs[i & 1][g][tok] = L == kPair''')]
NO_FOLD = [('''    static_assert(MT == kMaxMT, "the x sums cover a 16-token tile");
    __shared__ float sxs[2][4][16];''', '''    static_assert(MT == kMaxMT, "the x sums cover a 16-token tile");
    if (MT > 0) return;
    __shared__ float sxs[2][4][16];''')]
NO_DEQUANT = [('''    const uint32_t* W = reinterpret_cast<const uint32_t*>(wt);
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
NO_MMA = [('''    for (int k = 0; k < kSteps; ++k)
      wg::Wgmma<MT, T>::mma(d[k / 2], a[k], wg::desc_sw32(x + k * MT * wg::kTileRow), k % 2);''',
           '''    for (int k = 0; k < kSteps; ++k)
      if (a[k][0] == 0x3039u)
        wg::Wgmma<MT, T>::mma(d[k / 2], a[k], wg::desc_sw32(x + k * MT * wg::kTileRow), k % 2);''')]
VARIANTS = {"base": [], "no_sums": NO_SUMS, "no_fold": NO_FOLD, "no_dequant": NO_DEQUANT,
            "no_mma": NO_MMA, "none": NO_FOLD + NO_DEQUANT + NO_MMA}


def variant_source(src: str, edits) -> str:
    for old, new in edits:
        if old not in src:
            raise SystemExit("csrc/dequant_gemv_gp.cu changed: an ablation edit no longer applies")
        src = src.replace(old, new, 1)
    return src


def build():
    os.makedirs(OUT, exist_ok=True)
    for name in os.listdir(CSRC):
        if name.endswith(".cuh"):
            shutil.copy(os.path.join(CSRC, name), OUT)
    src = open(os.path.join(CSRC, "dequant_gemv_gp.cu")).read()
    procs = []
    for name, edits in VARIANTS.items():
        cu = os.path.join(OUT, f"gp_{name}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(src, edits))
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", os.path.join(OUT, f"gp_{name}.so"), cu]
        procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for the {name} variant:\n{out}")
        lib = ctypes.CDLL(os.path.join(OUT, f"gp_{name}.so"))
        lib.mlc_gemv_gp_tc.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [
            ctypes.c_int] * 7 + [ctypes.c_void_p]
        libs[name] = lib
    return libs


def time_ms(fn, flush, reps=30):
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
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    libs = build()
    flush = torch.ones(64 * 2**20, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    m = 8
    for K, N in SHAPES:
        G, steps = K // 32, K // 128
        w = torch.randint(-2**31, 2**31 - 1, (K // 8, N), generator=gen, device="cuda",
                          dtype=torch.int64).to(torch.int32)
        s = (torch.rand((G, N), generator=gen, device="cuda") * 0.01).half()
        z = (torch.rand((G, N), generator=gen, device="cuda") * -0.05).half()
        x = torch.randn((m, K), generator=gen, device="cuda").half()
        out = torch.empty((m, N), dtype=torch.half, device="cuda")
        for layout, lname in ((1, "hsplit"), (0, "pair")):
            for splits in SPLITS:
                per = -(-steps // splits)
                parts = -(-steps // per)
                part = (torch.empty((parts, m, N), dtype=torch.float32, device="cuda")
                        if parts > 1 else None)
                row = dict(k=K, n=N, m=m, layout=lname, dtype="float16", parts=parts, per=per)
                for name, lib in libs.items():
                    def run(lib=lib):
                        err = lib.mlc_gemv_gp_tc(
                            layout, 1, x.data_ptr(), None, w.data_ptr(), s.data_ptr(),
                            z.data_ptr(), None if part is None else part.data_ptr(),
                            out.data_ptr(), m, K, N, 0, 0, parts, per,
                            torch.cuda.current_stream().cuda_stream)
                        if err:
                            raise RuntimeError(f"{name}: cudaError {err}")
                    row[name] = time_ms(run, flush)
                print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
