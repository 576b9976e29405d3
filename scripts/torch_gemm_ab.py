"""Time the dequant GEMMs and GEMVs of one tree of the port on the GPU,
beside the library call, to compare two trees in one run on one card.

    python scripts/torch_gemm_ab.py [--tree DIR] [--label NAME] [--only KERNEL,...]

Imports `mlc_llm_tpu_torch` from DIR (default: this checkout), builds its
kernels, and times, at the Vicuna-7B shapes: `gemm_qs` on q4bf16 at m =
128 and 2048, `gemm_plane` on q3bf16_s16 and q3f16_s16 at m = 8, 128
and 2048 (and on q3bf16, fp4bf16, q8bf16 and their f16 presets at w_in),
`gemv_qs` on q4bf16 at m = 1, 3 and 8, `gemv_gp3` on q3bf16_s16 and
q3f16_s16 at m = 1 and 2, and
`gemm_pairs` in bf16 (q4bf16_pair, q4bf16_hs) at w_in, m = 128; at the
GPT-NeoX 3B shapes: `gemm_pairs` on q4f32 (pair, f32) and q4f16_hs
(hsplit, f16; the lm head in f32) at m = 128 and, on w_in, 2048,
`gemv_gp` on the same two presets at m = 1, 3 and 8, `gemv_qs` in f16
and f32 (qsplit) at w_in, m = 1, and `gemm_qs` in f16 and f32 at m = 128; and
`paged_flash_decode` at the serve pool's layout (hb 8, page 128, a
16-page window) at b8 over mixed lengths, at b8 x 1024 and at b1 x 255,
256, 1023 and 2047: Vicuna-7B (D
128, bf16 q, bf16 and int8 pages), the NeoX 3B (D 80, f32 and f16 q) and
MOSS (D 256), against SDPA on the gathered K/V (a shape or dtype a
tree's kernel does not take prints as unsupported). Layer weights are stacked [2, ...]
and read at layer 1; the lm head is flat with f32 out, at m <= 128 only.
Each kernel
result is held against its plain version (1e-2; f32 atol 1e-4, rtol 1e-3)
before it is timed. Times are CUDA-event means with the 50 MB L2 flushed
before each launch, as chip_smoke.py times them; `host_us` is the median
host time of one wrapper call (its Python, plan, scratch and launch API
calls; the device idle before each call); the library call is
torch.matmul on the weight dequantized once (f32: TF32 off). --only keeps
the named kernels. Prints one JSON line per row, then the card's name and
power limit. To compare a parent tree, unpack it with `git archive` into
a directory that .gitignore lists and run the two in turns (parent,
change, change, parent) in one command.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [("wqkv", 4096, 12288), ("wo", 4096, 4096), ("w_in", 4096, 22016),
          ("w_out", 11008, 4096), ("lm_head", 4096, 32000)]
SHAPES_3B = [("wqkv", 2560, 7680), ("wo", 2560, 2560), ("w_in", 2560, 10240),
             ("w_out", 10240, 2560), ("lm_head", 2560, 50432)]
# (preset, kernel, shapes, {shape name or "*": ms}, lm head in f32 compute)
CASES = [("q4bf16", "gemm_qs", SHAPES, {"*": (128, 2048)}, False),
         ("q3bf16_s16", "gemm_plane", SHAPES, {"*": (8, 128, 2048)}, False),
         ("q3bf16", "gemm_plane", SHAPES, {"w_in": (8, 128, 2048)}, False),
         ("fp4bf16", "gemm_plane", SHAPES, {"w_in": (8, 128, 2048)}, False),
         ("q8bf16", "gemm_plane", SHAPES, {"w_in": (8, 128, 2048)}, False),
         ("q3f16_s16", "gemm_plane", SHAPES, {"*": (8, 128, 2048)}, False),
         ("q3f16", "gemm_plane", SHAPES, {"w_in": (8, 128, 2048)}, False),
         ("fp4f16", "gemm_plane", SHAPES, {"w_in": (8, 128, 2048)}, False),
         ("q8f16", "gemm_plane", SHAPES, {"w_in": (8, 128, 2048)}, False),
         ("q4bf16", "gemv_qs", SHAPES, {"*": (1, 3, 8)}, False),
         ("q3bf16_s16", "gemv_gp3", SHAPES, {"*": (1, 2)}, False),
         ("q3f16_s16", "gemv_gp3", SHAPES, {"*": (1, 2)}, False),
         ("q4bf16_pair", "gemm_pairs", SHAPES, {"w_in": (128,)}, False),
         ("q4bf16_hs", "gemm_pairs", SHAPES, {"w_in": (128,)}, False),
         ("q4f32", "gemm_pairs", SHAPES_3B, {"*": (128,), "w_in": (128, 2048)}, True),
         ("q4f16_hs", "gemm_pairs", SHAPES_3B, {"*": (128,), "w_in": (128, 2048)}, True),
         ("q4f32", "gemv_gp", SHAPES_3B, {"*": (1, 3, 8)}, True),
         ("q4f16_hs", "gemv_gp", SHAPES_3B, {"*": (1, 3, 8)}, True),
         ("q4f16", "gemv_qs", SHAPES_3B, {"w_in": (1,)}, True),
         ("q4f32:qsplit", "gemv_qs", SHAPES_3B, {"w_in": (1,)}, True),
         ("q4f16", "gemm_qs", SHAPES_3B, {"*": (128,)}, True),
         ("q4f32:qsplit", "gemm_qs", SHAPES_3B, {"*": (128,)}, True)]
# kernel 7: (label, kv-heads, query heads, head dim, q dtype, page dtypes)
PAGED = [("vicuna", 32, 32, 128, "bfloat16", ("bfloat16", "int8")),
         ("neox-3b", 32, 32, 80, "float32", ("bfloat16", "int8")),
         ("neox-3b", 32, 32, 80, "float16", ("bfloat16", "int8")),
         ("moss", 24, 24, 256, "bfloat16", ("bfloat16",))]
PAGED_LENGTHS = [1, 127, 128, 511, 1023, 1024, 1536, 2047]


def time_ms(torch, fn, flush, reps):
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


def host_us(torch, fn, reps=200):
    """The median host time of one call, µs, each started on an idle device."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def paged_rows(torch, label, gen, flush):
    from mlc_llm_tpu_torch.ops import paged_attention as pa

    hb, ps, window = 8, 128, 16
    W = window * ps
    for name, hkv, hq, D, qname, pages in PAGED:
        qdt = getattr(torch, qname)
        for lengths in (PAGED_LENGTHS, [1024] * 8, [255], [256], [1023], [2047]):
            B = len(lengths)
            G, P = hkv // hb, B * window + 1
            table = (torch.randperm(P - 1, generator=torch.Generator().manual_seed(0))
                     .reshape(B, window) + 1).int().cuda()
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            q = torch.randn((B, hq, 1, D), generator=gen, device="cuda").to(qdt)
            mask = (torch.arange(W, device="cuda")[None, :] <= lens[:, None].long())[:, None, None]
            for pname in pages:
                shape = (G, 2, P, ps, hb * D)
                ks = vs = None
                if pname == "int8":
                    kp, vp = (torch.randint(-127, 128, shape, generator=gen, device="cuda",
                                            dtype=torch.int8) for _ in range(2))
                    ks = torch.rand((G, 2, P, hb, ps), generator=gen, device="cuda") * 0.02 + 1e-3
                    vs = torch.rand((G, 2, P, ps, hb), generator=gen, device="cuda") * 0.02 + 1e-3
                else:
                    kp, vp = (torch.randn(shape, generator=gen, device="cuda").to(
                        getattr(torch, pname)) for _ in range(2))

                def gathered(pages, sc, k_side):
                    x = pages[:, 1][:, table.long()].float()
                    if sc is not None:
                        s = sc[:, 1][:, table.long()]
                        s = s.transpose(-1, -2) if k_side else s
                        x = x.reshape(G, B, window, ps, hb, D) * s[..., None]
                    x = x.reshape(G, B, window, ps, hb, D).permute(1, 0, 4, 2, 3, 5)
                    return x.reshape(B, hkv, W, D).to(qdt).contiguous()

                kc, vc = gathered(kp, ks, True), gathered(vp, vs, False)

                def run():
                    return pa.paged_flash_decode(q, kp, vp, ks, vs, table, lens, 1,
                                                 num_pages_window=window, head_dim=D)

                row = dict(tree=label, kernel="paged_flash_decode", shape=name, d=D, q=qname,
                           pages=pname, b=B, lengths=lengths)
                try:
                    got = run()
                except NotImplementedError:
                    print(json.dumps(dict(row, unsupported=True)), flush=True)
                    continue
                want = pa.paged_flash_decode_plain(q, kp, vp, ks, vs, table, lens, 1,
                                                   num_pages_window=window, head_dim=D)
                ok = torch.allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2)
                t = time_ms(torch, run, flush, 20)
                lib = time_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, kc, vc, attn_mask=mask), flush, 20)
                print(json.dumps(dict(row, ms=t, library_ms=lib, ratio=t / lib, ok=ok)),
                      flush=True)
                del kp, vp, ks, vs, kc, vc
            torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--only", default="", help="comma-separated kernel names to keep")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import dataclasses

    import torch

    from mlc_llm_tpu_torch.ops import dequant_matmul as dm
    from mlc_llm_tpu_torch.quant import (QuantizedTensor, pad_quantized_groups, quantize,
                                         resolve_spec)
    from mlc_llm_tpu_torch.quant.groupwise import dequantize, torch_dtype

    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    if not os.path.abspath(dm.__file__).startswith(os.path.abspath(args.tree)):
        sys.exit(f"imported {dm.__file__}, not the tree {args.tree}")
    only = set(filter(None, args.only.split(",")))
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.ones(64 * 2**20, dtype=torch.float32, device="cuda")
    for quant, kname, shapes, ms_by_shape, head_f32 in CASES:
        if only and kname not in only:
            continue
        fn, plain = getattr(dm, kname), getattr(dm, kname + "_plain")
        for name, k, n in shapes:
            ms = ms_by_shape.get(name, ms_by_shape.get("*", ()))
            flat = name == "lm_head"
            if not ms or (flat and min(ms) > 128):
                continue
            spec = resolve_spec(quant.split(":")[0])
            if quant.endswith(":qsplit"):
                spec = dataclasses.replace(spec, layout="qsplit")
            if flat and head_f32:
                spec = dataclasses.replace(spec, dtype="float32")
            qts = [pad_quantized_groups(quantize(
                torch.randn((k, n), generator=gen, device="cuda") * 0.02, spec))
                for _ in range(1 if flat else 2)]
            one = qts[-1]
            data = one.data if flat else torch.stack([q.data for q in qts])
            scale = one.scale if flat else torch.stack([q.scale for q in qts])
            zero = None if one.zero is None else (
                one.zero if flat else torch.stack([q.zero for q in qts]))
            layer = None if flat else 1
            rows, N = one.data.shape
            K = rows if spec.storage == "i8" else rows * spec.elems_per_word
            cd = torch_dtype(spec.dtype)
            dense = dequantize(QuantizedTensor(one.data, one.scale, one.zero, spec=spec,
                                               shape=(K, N)), cd)
            out_dtype = torch.float32 if flat else cd
            extra = ((spec,) if kname == "gemm_plane"
                     else (spec.layout,) if kname in ("gemm_pairs", "gemv_gp") else ())
            # gemv_gp3 takes no minima (sym)
            zarg = () if kname == "gemv_gp3" else (zero,)
            zone = () if kname == "gemv_gp3" else (one.zero,)
            tol = (dict(atol=1e-4, rtol=1e-3) if cd == torch.float32
                   else dict(atol=1e-2, rtol=1e-2))
            for m in ms:
                if flat and m > 128:
                    continue
                x = torch.zeros((m, K), dtype=cd, device="cuda")
                x[:, :k] = torch.randn((m, k), generator=gen, device="cuda").to(cd)

                def run():
                    return fn(x, data, scale, *zarg, *extra, layer=layer, out_dtype=out_dtype)

                try:
                    got = run()
                except NotImplementedError as e:  # a tree without this kernel
                    print(json.dumps(dict(tree=args.label, kernel=kname, quant=quant,
                                          shape=name, m=m, unsupported=str(e))), flush=True)
                    continue
                want = plain(x, one.data, one.scale, *zone, *extra, out_dtype)
                ok = torch.allclose(got.float(), want.float(), **tol)
                reps = 20 if m <= 128 else 5
                t = time_ms(torch, run, flush, reps)
                lib = time_ms(torch, lambda: torch.matmul(x, dense), flush, reps)
                print(json.dumps(dict(tree=args.label, kernel=kname, quant=quant,
                                      dtype=str(cd).replace("torch.", ""), shape=name,
                                      m=m, k=K, n=N, ms=t, library_ms=lib, ratio=t / lib,
                                      tflops=2 * m * K * N / (t * 1e-3) / 1e12, ok=ok,
                                      host_us=host_us(torch, run))),
                      flush=True)
            del data, scale, zero, dense, qts
            torch.cuda.empty_cache()
    if not only or "paged_flash_decode" in only:
        paged_rows(torch, args.label, gen, flush)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
