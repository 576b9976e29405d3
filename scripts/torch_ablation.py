"""Where a stage of a tensor-core kernel spends its time, on the GPU, by
ablation.

    python scripts/torch_ablation.py --kernel gemv_gp
    python scripts/torch_ablation.py --kernel gemm_plane

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

Times are CUDA-event means with the 50 MB L2 flushed before each launch,
as chip_smoke.py times them. Prints one JSON line per case, then the
card's name and power limit. The variants are built under
csrc/build/ablation/<kernel>/.
"""

from __future__ import annotations

import argparse
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
                fmt, x.data_ptr(), None if xt is None else xt.data_ptr(), qt.data.data_ptr(),
                qt.scale.data_ptr(), None if part is None else part.data_ptr(),
                out.data_ptr(), m, G, N, mt, splits, per, max_int, 0,
                torch.cuda.current_stream().cuda_stream)
        yield dict(quant=preset, k=rows * epw, n=N, m=m, mt=mt, parts=splits), launch


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
}


def variant_source(src: str, edits, edited: str) -> str:
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"csrc/{edited} changed: an ablation edit no longer applies")
        src = src.replace(old, new, 1)
    return src


def build(kernel: str):
    """One nvcc per variant, all started together; the loaded libraries."""
    spec = KERNELS[kernel]
    src = open(os.path.join(CSRC, spec["edited"])).read()
    procs = []
    for name, edits in spec["variants"].items():
        d = os.path.join(OUT, kernel, name)
        os.makedirs(d, exist_ok=True)
        for f in os.listdir(CSRC):
            if f.endswith(".cuh") or f == spec["source"]:
                shutil.copy(os.path.join(CSRC, f), d)
        with open(os.path.join(d, spec["edited"]), "w") as f:
            f.write(variant_source(src, edits, spec["edited"]))
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", os.path.join(d, "variant.so"),
               os.path.join(d, spec["source"])]
        procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for the {name} variant:\n{out}")
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
