"""Time the wgmma kernels of this tree under every launch plan, on the GPU.

    python scripts/torch_plan_sweep.py [--only KERNEL[:PRESET],...] [--reps N]

For each case (kernel, preset, shape, m: the 3B and Vicuna-7B shapes the
NeoX and Vicuna prefills and the b8 decode steps run; `gemm_qs` in bf16 at
the Vicuna-7B shapes at m = 128 and 2048, in f16 and f32 at the 3B shapes
at m = 128; `gemv_gp` at m = 8 at the 3B shapes, hsplit f16 and pair f32
with their f32 lm heads), forces each distinct plan (m
tile, split-K parts, stages per part) in place of `gemm_tiles`' choice,
holds the result against the plain version (1e-2; f32 atol 1e-4, rtol
1e-3) and times it as chip_smoke.py does (CUDA events, the L2 flushed
before each launch). Prints one JSON line per (case, plan) with the plan
`gemm_tiles` picks marked, then the card's name and power limit. --only
keeps the named kernels (or kernel:preset pairs); --reps sets the timed
launches of each plan (default 20).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mlc_llm_tpu_torch.ops import dequant_matmul as dm  # noqa: E402
from mlc_llm_tpu_torch.quant import pad_quantized_groups, quantize, resolve_spec  # noqa: E402
from mlc_llm_tpu_torch.quant.groupwise import torch_dtype  # noqa: E402

VICUNA = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096), (4096, 32000)]
NEOX_3B = [(2560, 7680), (2560, 2560), (2560, 10240), (10240, 2560), (2560, 50432)]
# (kernel, preset, k, n, m); a preset ending in ":f32" computes in f32 (a
# model's f32 lm head)
CASES = [("gemv_qs", "q4bf16", 4096, 12288, 8), ("gemv_qs", "q4bf16", 4096, 4096, 8),
         ("gemv_qs", "q4bf16", 4096, 22016, 8), ("gemv_qs", "q4bf16", 11008, 4096, 8),
         ("gemm_pairs", "q4f16_hs", 2560, 7680, 128), ("gemm_pairs", "q4f16_hs", 2560, 2560, 128),
         ("gemm_pairs", "q4f16_hs", 2560, 10240, 128), ("gemm_pairs", "q4f16_hs", 10240, 2560, 128),
         ("gemm_pairs", "q4f32", 2560, 10240, 128), ("gemm_pairs", "q4f32", 2560, 2560, 128),
         ("gemm_pairs", "q4bf16_pair", 4096, 22016, 128), ("gemm_qs", "q4f16", 2560, 10240, 128)]
CASES += [("gemm_qs", "q4bf16", k, n, m) for m in (128, 2048) for k, n in VICUNA
          if m == 128 or n != 32000]
CASES += [("gemm_qs", "q4f16", k, n, 128) for k, n in NEOX_3B[:4] if n != 10240]
CASES += [("gemm_qs", "q4f32", k, n, 128) for k, n in NEOX_3B]
CASES += [("gemv_gp", preset + (":f32" if n == 50432 and preset == "q4f16_hs" else ""), k, n, 8)
          for preset in ("q4f16_hs", "q4f32") for k, n in NEOX_3B]


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


def geometry(kernel, spec, cd):
    """(k of a stage, compiled m tiles, gemm_tiles' keyword arguments) of a
    kernel."""
    if kernel == "gemv_qs":
        return dm.GEMV_STAGE_K, dm.GEMV_WIDTHS, dict(max_splits=dm.GEMV_MAX_SPLITS)
    if kernel == "gemv_gp":
        return dm.GEMV_STAGE_K, dm.GEMV_WIDTHS, dict(times=dm.GP_GEMV_TIMES)
    if kernel == "gemm_qs":
        widths, times = dm.QS_PLAN[cd == torch.float32]
        return dm.QS_STAGE_K, widths, dict(times=times)
    stage_k, widths, times = dm.PAIRS_PLAN[(spec.layout, cd == torch.float32)]
    return stage_k, widths, dict(times=times)


def plans(m, steps, widths):
    out = []
    for mt in widths:
        if mt < m and mt != widths[-1] and 2 * mt < m:
            continue
        seen = set()
        for s in range(1, min(steps, dm.MAX_SPLITS) + 1):
            per = -(-steps // s)
            parts = -(-steps // per)
            if (parts, per) not in seen:
                seen.add((parts, per))
                out.append((mt, parts, per))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="", help="comma-separated kernel or kernel:preset names")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    only = set(filter(None, args.only.split(",")))
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.ones(64 * 2**20, dtype=torch.float32, device="cuda")
    chosen_tiles = dm.gemm_tiles
    for kernel, preset, k, n, m in CASES:
        if only and kernel not in only and f"{kernel}:{preset}" not in only:
            continue
        spec = resolve_spec(preset.split(":")[0])
        if preset.endswith(":f32"):
            spec = dataclasses.replace(spec, dtype="float32")
        if kernel == "gemm_qs":
            spec = dataclasses.replace(spec, layout="qsplit")
        qts = [pad_quantized_groups(quantize(
            torch.randn((k, n), generator=gen, device="cuda") * 0.02, spec)) for _ in range(2)]
        one = qts[-1]
        data = torch.stack([q.data for q in qts])
        scale = torch.stack([q.scale for q in qts])
        zero = None if one.zero is None else torch.stack([q.zero for q in qts])
        K, N = one.data.shape[0] * 8, one.data.shape[1]
        cd = torch_dtype(spec.dtype)
        x = torch.zeros((m, K), dtype=cd, device="cuda")
        x[:, :k] = torch.randn((m, k), generator=gen, device="cuda").to(cd)
        fn, plain = getattr(dm, kernel), getattr(dm, kernel + "_plain")
        extra = (spec.layout,) if kernel in ("gemm_pairs", "gemv_gp") else ()
        want = plain(x, one.data, one.scale, one.zero, *extra, cd)
        tol = (dict(atol=1e-4, rtol=1e-3) if cd == torch.float32
               else dict(atol=1e-2, rtol=1e-2))
        stage_k, widths, kwargs = geometry(kernel, spec, cd)
        steps = K // stage_k
        pick = chosen_tiles(m, N, steps, widths, **kwargs)
        for plan in plans(m, steps, widths):
            dm.gemm_tiles = lambda *a, _p=plan, **kw: _p
            try:
                def run():
                    return fn(x, data, scale, zero, *extra, layer=1, out_dtype=cd)

                ok = torch.allclose(run().float(), want.float(), **tol)
                t = time_ms(run, flush, args.reps)
            finally:
                dm.gemm_tiles = chosen_tiles
            print(json.dumps(dict(kernel=kernel, quant=preset, k=K, n=N, m=m, mt=plan[0],
                                  parts=plan[1], per=plan[2], ms=t, ok=ok,
                                  picked=plan == pick)), flush=True)
        del data, scale, zero, qts
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
