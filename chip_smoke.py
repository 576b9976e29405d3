"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check exits non-zero before the last line):

1. card identity (nvidia-smi name and power limit), then the seven kernel
   sources are built from csrc/ with nvcc, one process per source, all at
   once (build seconds printed, and ptxas's registers, shared memory,
   spills and performance notes of the five sources on the wgmma
   mainloop: gemm_qs, gemm_plane, gemm_pairs, gemv_qs and gemv_gp; then
   each gemm_plane instantiation's registers, spills and C7512 notes: the
   m tile of 256 must be there for int3/u16, fp4 and int8, without spills);
2. kernel phase: each hand-written kernel against its plain PyTorch
   version on the card, at the shapes of the main paths, with kernel,
   plain, bound and library times: at the Vicuna-7B shapes q4bf16 (qsplit
   GEMV at m=1, 3 and 8, GEMM at m=128 and m=2048 and on the flat lm head at
   m=128); q3bf16_s16 (int3 GEMV at m=1 and m=2, plane GEMM at m=8, 128 and
   2048); the plane GEMM on q3bf16, fp4bf16 and q8bf16 at w_in, m=1, 128
   and 2048; the pair and hsplit GEMV and GEMM in bf16 at w_in (m=1, 128); at
   the GPT-NeoX 3B shapes q4f32 (pair, f32) and q4f16_hs (hsplit, f16, the
   lm head in f32): GEMV at m=1, 3 and 8 and GEMM at m=128 on all five
   shapes and at m=2048 on w_in; the qsplit GEMM in f16 and f32 on all five
   3B shapes, the qsplit GEMV in f16 and f32 at w_in and the qsplit f32
   GEMV on the lm head; paged flash-decode at batch 8 over mixed lengths
   and at batch 1 x 255, 256, 1023 and 2047, at Vicuna-7B's shapes (D 128,
   bf16 q, bf16 and int8 KV), the NeoX 3B's (D 80, f32 and f16 q, bf16 and
   int8 KV) and MOSS's (D 256, bf16 q and KV), each under the wrapper's
   split-KV plan (printed), held against the plain version under the same
   plan; each row prints its TFLOP/s and its time over the library call's;
3. parity phase: 2-layer models at full width, the same params through
   forward on the card (kernels) and on the CPU (plain versions), logits
   compared for a 64-token prefill and 4 decode steps: Vicuna-7B in q4bf16
   and q3bf16_s16, RedPajama-INCITE-Chat-3B-v1 in q4f32, dolly-v2-3b in
   q4f16_hs and in q4bf16; then on the card (Vicuna q4bf16, RedPajama
   q4f32, dolly q4f16_hs), 8 slots of mixed prompt lengths, the paged cache
   against the slot cache (bf16) and int8 paged KV against bf16 paged KV,
   for a prefill and 4 decode steps;
4. chat phase: full-depth Vicuna-7B q4bf16 on random weights through
   InferenceEngine and ChatSession (slot cache, batch 1), 3 greedy turns
   of 32 new tokens, with the launch counters held to the counts the path
   implies;
5. serve phase: the same model behind SchedulerServer
   (ContinuousBatchingScheduler over InferenceEngine(kv_layout="paged",
   max_batch=8, max_seq_len=2048, page_size=128)); 16 requests from a
   seed submitted by RemoteScheduler over localhost, with TTFT, decode
   rates, step wall and launch counts; then a shorter in-process run
   with int8 KV under kv_layout="auto", which must resolve to paged;
6. q3 chat phase: the q4 params are freed; full-depth Vicuna-7B
   q3bf16_s16 (random weights quantized on the card) with int8 slot KV at
   batch 1, 3 greedy turns of 32 new tokens through ChatSession: every
   decode matmul on the int3 GEMV, every prefill layer matmul on the plane
   GEMM, launch counts held to the path's;
7. q3 scheduler run: 8 requests in process, int8 KV under
   kv_layout="auto" (paged), b8 decode through the plane GEMM and kernel 7;
8. GPT-NeoX chat phases: the q3 params are freed; full-depth
   RedPajama-INCITE-Chat-3B-v1 in q4f32, then full-depth dolly-v2-3b in
   q4f16_hs (random weights quantized on the card), bf16 slot KV, batch 1,
   3 greedy turns of 32 new tokens with the dolly template: every decode
   matmul and the f32 lm head on the pair/hsplit GEMV, every prefill layer
   matmul on the pair/hsplit GEMM, launch counts held to the path's; after
   each chat, the same model behind ContinuousBatchingScheduler over
   InferenceEngine(kv_layout="paged", max_batch=8, max_seq_len=2048,
   page_size=128), 8 requests in process (prompts of 16-1500 tokens, 32 new
   tokens, one sampled): every b8 decode matmul and the f32 lm head on the
   pair/hsplit GEMV at m = 8, admission prefill on the pair/hsplit GEMM,
   kernel 7 at D = 80 (f32 q for RedPajama, f16 q for dolly) once a layer
   a decode forward;
9. one JSON line of kernels, the card line, and the final ok line.

Every launch counter is set to 0 just before a path is driven and read
just after; launches made to compare a kernel with its plain version do
not count. Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from mlc_llm_tpu_torch.engine import GenerationConfig, InferenceEngine
from mlc_llm_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
from mlc_llm_tpu_torch.engine.session import ChatConfig, ChatSession
from mlc_llm_tpu_torch.models import (
    forward,
    get_config,
    init_kv_cache,
    init_paged_kv_cache,
    init_random_params,
)
from mlc_llm_tpu_torch.models.transformer import tree_map
from mlc_llm_tpu_torch.ops import KERNELS, build_kernels
from mlc_llm_tpu_torch.ops import dequant_matmul as dm
from mlc_llm_tpu_torch.ops import paged_attention as pa
from mlc_llm_tpu_torch.parallel.wire import RemoteScheduler, SchedulerServer
from mlc_llm_tpu_torch.quant import (
    QUANT_PRESETS,
    QuantizedTensor,
    pad_quantized_groups,
    quantize,
    resolve_spec,
)
from mlc_llm_tpu_torch.quant.groupwise import dequantize, torch_dtype
from mlc_llm_tpu_torch.tokenizer import ByteTokenizer

# H100 SXM data-sheet peaks (dense): HBM3 bytes/s, and the operation rate
# each kernel computes at: bf16/f16 tensor cores, f32 FMAs on the CUDA
# cores (the f32 SIMT GEMVs), 3xTF32 (three TF32 products per f32 product:
# the f32 GEMMs, int4_common.cuh) and 2xTF32 (the f32 pair/hsplit GEMV at
# m >= 2: A exact in TF32, x split in two)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FMA_FLOPS = 67e12
F32_3XTF32_FLOPS = 495e12 / 3
F32_2XTF32_FLOPS = 495e12 / 2
KERNEL_TOL = 1e-2      # atol and rtol, kernel vs its plain version (bf16, f16)
# f32 compute: the kernel and its plain version round nothing but their
# f32 sums, which run in another order (3xTF32 keeps f32's accuracy)
F32_KERNEL_TOL = dict(atol=1e-4, rtol=1e-3)
# kernel 7 with 2-byte or int8 pages: the kernel and its plain version
# round at the same points and differ by at most 5e-4 here (H100); a
# combine that drops or doubles one of 16 partials at b1 x 2047 moves the
# output by up to 3e-2 to 5e-2 (the plain version so mutated, on the
# CPU). rtol covers a one-ulp bf16 rounding of the larger outputs of
# short slots.
PAGED_KERNEL_TOL = dict(atol=2e-3, rtol=1e-2)
# card (kernels) vs CPU (plain versions) logits, as a share of the largest
# |logit|. Activations are bf16 between ops; a bf16 rounding that goes the
# other way after an f32 sum in another order (0.4%) is amplified by the
# random full-width layers (gain 0.02*sqrt(4096) = 1.3 per matmul). On an
# H100 one decode step differed by 4.2% of max |logit| card vs CPU in
# this phase; a wrong layout, group or scale differs by ~100%. f16
# activations round at 1/2048, within the same share.
LOGIT_RTOL = 1e-1
# f32 activations (q4f32): only the bf16 KV cache rounds (an f32 sum in
# another order can tip one of its roundings). On an H100 the largest
# share was 1.4e-4 (the 64-token prefill); 2e-3 is fifty times tighter
# than the bf16 share
F32_LOGIT_RTOL = 2e-3
# int8 against bf16 KV, same share: an absmax/127 code steps by ~1/40 of a
# row's spread where bf16 rounds each value by 1/256 of itself, so int8 KV
# moves the logits several times as far as the bf16 roundings above
INT8_LOGIT_RTOL = 2e-1
VICUNA = get_config("vicuna-v1-7b")
REDPAJAMA = get_config("RedPajama-INCITE-Chat-3B-v1")
DOLLY = get_config("dolly-v2-3b")
SHAPES = [  # (name, k, n) of the main path's quantized matmuls
    ("wqkv", 4096, 12288),
    ("wo", 4096, 4096),
    ("w_in", 4096, 22016),
    ("w_out", 11008, 4096),
    ("lm_head", 4096, 32000),
]
# the GPT-NeoX 3B width (both 3B models; RedPajama's vocabulary, dolly's
# 50280 is stored as the same 51200 columns); k = 2560 is stored as 96 groups
SHAPES_3B = [
    ("wqkv", 2560, 7680),
    ("wo", 2560, 2560),
    ("w_in", 2560, 10240),
    ("w_out", 10240, 2560),
    ("lm_head", 2560, 50432),
]
SOURCES = {
    "gemv_qs": ("mlc_llm_tpu_torch/csrc/dequant_gemv_qs.cu",
                "mlc_llm_tpu/ops/pallas/dequant_matmul.py:1430"),
    "gemm_qs": ("mlc_llm_tpu_torch/csrc/dequant_gemm_qs.cu",
                "mlc_llm_tpu/ops/pallas/dequant_matmul.py:1670"),
    # the pair and hsplit bodies of rows 1-3 (_gp_body :1068, _gp_body_hs
    # :1117; _kernel_pairs_stacked :1624, _kernel_pairs_hs :257)
    "gemv_gp": ("mlc_llm_tpu_torch/csrc/dequant_gemv_gp.cu",
                "mlc_llm_tpu/ops/pallas/dequant_matmul.py:1430"),
    "gemm_pairs": ("mlc_llm_tpu_torch/csrc/dequant_gemm_pairs.cu",
                   "mlc_llm_tpu/ops/pallas/dequant_matmul.py:1670"),
    "gemv_gp3": ("mlc_llm_tpu_torch/csrc/dequant_gemv_gp3.cu",
                 "mlc_llm_tpu/ops/pallas/dequant_matmul.py:592"),
    # rows 5 (stacked, :725) and 4 (the flat generic branch, :791)
    "gemm_plane": ("mlc_llm_tpu_torch/csrc/dequant_gemm_plane.cu",
                   "mlc_llm_tpu/ops/pallas/dequant_matmul.py:725"),
    "paged_flash_decode": ("mlc_llm_tpu_torch/csrc/paged_flash_decode.cu",
                           "mlc_llm_tpu/ops/pallas/paged_attention.py:145"),
}
QSPLIT_F32 = dataclasses.replace(QUANT_PRESETS["q4f32"], layout="qsplit")
# (label, spec, shapes, lm head in f32, [(kernel, {shape: ms})]): the m of
# each main-path shape; the lm head is flat (f32 out; in f32 compute where
# the model's fp32_lm_head asks for it), every other weight stacked [2, ...]
# and read at layer 1 (out in the compute dtype)
MATMUL_CASES = [
    ("q4bf16", "q4bf16", SHAPES, False,
     [("gemv_qs", {"*": (1, 3, 8)}), ("gemm_qs", {"*": (128, 2048), "lm_head": (128,)})]),
    ("q3bf16_s16", "q3bf16_s16", SHAPES, False,
     [("gemv_gp3", {"*": (1, 2)}), ("gemm_plane", {"*": (8, 128, 2048)})]),
    # the other plane formats once each, at their decode and prefill widths
    # (m = 2048: the m tile of 256 for fp4 and int8, 128 for int3/u32)
    ("q3bf16", "q3bf16", SHAPES, False, [("gemm_plane", {"w_in": (1, 128, 2048)})]),
    ("fp4bf16", "fp4bf16", SHAPES, False, [("gemm_plane", {"w_in": (1, 128, 2048)})]),
    ("q8bf16", "q8bf16", SHAPES, False, [("gemm_plane", {"w_in": (1, 128, 2048)})]),
    # the pair and hsplit bodies in bf16, beside the qsplit rows
    ("q4bf16_pair", "q4bf16_pair", SHAPES, False,
     [("gemv_gp", {"w_in": (1,)}), ("gemm_pairs", {"w_in": (128,)})]),
    ("q4bf16_hs", "q4bf16_hs", SHAPES, False,
     [("gemv_gp", {"w_in": (1,)}), ("gemm_pairs", {"w_in": (128,)})]),
    # the two 3B chats' presets
    ("q4f32", "q4f32", SHAPES_3B, True,
     [("gemv_gp", {"*": (1, 3, 8)}), ("gemm_pairs", {"*": (128,), "w_in": (128, 2048)})]),
    ("q4f16_hs", "q4f16_hs", SHAPES_3B, True,
     [("gemv_gp", {"*": (1, 3, 8)}), ("gemm_pairs", {"*": (128,), "w_in": (128, 2048)})]),
    # qsplit in f16 (dolly q4f16) and f32 (the f32 head of a q4bf16/q4f16 NeoX)
    ("q4f16", "q4f16", SHAPES_3B, True,
     [("gemv_qs", {"w_in": (1,), "lm_head": (1,)}), ("gemm_qs", {"*": (128,)})]),
    ("q4f32 qsplit", QSPLIT_F32, SHAPES_3B, True,
     [("gemv_qs", {"w_in": (1,)}), ("gemm_qs", {"*": (128,)})]),
]
# the serve phase's paged pool and the kernel phase's paged shapes
PAGE_SIZE, SERVE_BATCH, SERVE_SEQ = 128, 8, 2048
PAGED_LENGTHS = [1, 127, 128, 511, 1023, 1024, 1536, 2047]
# one slot's lengths at b1: a split boundary (255, 256: pages 2 and 3) and
# half and all of the window
PAGED_B1_LENGTHS = (255, 256, 1023, SERVE_SEQ - 1)
PAGED_WINDOW = 16  # pages: SERVE_SEQ / PAGE_SIZE
PAGED_HEAD_BLOCK = 8
MOSS = get_config("moss-moon-003-sft")
# kernel 7's cases: (label, kv-heads, query heads, head dim, q dtype, page
# dtypes) at the serve pool's layout (hb 8, page 128), each at b8 over
# PAGED_LENGTHS and at b1 x PAGED_B1_LENGTHS: Vicuna-7B (D 128, bf16 q), the NeoX 3B
# (D 80; RedPajama q4f32's f32 q, dolly q4f16_hs's f16 q) and MOSS (D 256)
PAGED_CASES = [
    ("vicuna", VICUNA.num_kv_heads, VICUNA.num_heads, VICUNA.head_dim, torch.bfloat16,
     (torch.bfloat16, torch.int8)),
    ("neox-3b f32 q", REDPAJAMA.num_kv_heads, REDPAJAMA.num_heads, REDPAJAMA.head_dim,
     torch.float32, (torch.bfloat16, torch.int8)),
    ("neox-3b f16 q", DOLLY.num_kv_heads, DOLLY.num_heads, DOLLY.head_dim, torch.float16,
     (torch.bfloat16, torch.int8)),
    ("moss", MOSS.num_kv_heads, MOSS.num_heads, MOSS.head_dim, torch.bfloat16,
     (torch.bfloat16,)),
]


# the sources on the wgmma mainloop (csrc/dequant_wgmma.cuh): the build
# reports their registers, shared memory, spills and ptxas's notes (C7512:
# serialized wgmma)
WGMMA_SOURCES = ("dequant_gemm_qs", "dequant_gemm_plane", "dequant_gemm_pairs",
                 "dequant_gemv_qs", "dequant_gemv_gp")


def ptxas_summary(log: str):
    """nvcc -Xptxas -v's report cut to each kernel entry's name, spill
    bytes, registers and shared memory, and ptxas's performance notes."""
    keep = ("Compiling entry", "spill", "Used", "Performance", "warning")
    return [f"    {line.strip()}" for line in log.splitlines() if any(k in line for k in keep)]


def plane_instantiations(log: str):
    """gemm_plane's mainloop instantiations in ptxas's report: (format id,
    m tile, registers, spill store bytes, spill load bytes, C7512 notes),
    from the mangled name gemm_kernel<PlanePolicy<F>, MT>."""
    out, cur = [], None
    for line in log.splitlines():
        hit = re.search(r"Compiling entry function '(\S*PlanePolicyILi(\d)EEELi(\d+)EE\S*)'",
                        line)
        if hit:
            cur = dict(name=hit.group(1), fmt=int(hit.group(2)), mt=int(hit.group(3)),
                       regs=None, spill_stores=None, spill_loads=None, c7512=0)
            out.append(cur)
            continue
        if cur is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill and cur["spill_stores"] is None:
            cur["spill_stores"], cur["spill_loads"] = map(int, spill.groups())
        used = re.search(r"Used (\d+) registers", line)
        if used and cur["regs"] is None:
            cur["regs"] = int(used.group(1))
            cur = None
    for e in out:  # ptxas names the function in each note
        e["c7512"] = sum("C7512" in line and e["name"] in line for line in log.splitlines())
    return out


def fail(msg: str):
    print(f"FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


COUNTED = {"gemv_qs": dm.gemv_qs, "gemm_qs": dm.gemm_qs, "gemv_gp": dm.gemv_gp,
           "gemm_pairs": dm.gemm_pairs, "gemv_gp3": dm.gemv_gp3, "gemm_plane": dm.gemm_plane,
           "paged_flash_decode": pa.paged_flash_decode}


def reset_counters():
    for fn in COUNTED.values():
        fn.launches = 0


def read_counters():
    return {name: fn.launches for name, fn in COUNTED.items()}


def time_ms(fn, flush, reps: int) -> float:
    """Mean device time of fn over reps launches (CUDA events). Before
    each launch a pass over `flush` evicts the 50 MB L2, and a ~1 ms device
    spin keeps the device busy while the host enqueues fn, so the events
    hold no host time. The flush READS the buffer: a write would leave the
    L2 full of dirty lines whose write-back slows the timed kernel."""
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


def bound(m: int, k: int, n: int, weight_bytes: int, x_bytes: int, out_bytes: int,
          flops: float = BF16_FLOPS):
    """Least time (ms) for y[m,n] = x[m,k] @ dequant(W): every input read
    once (x in its dtype; the weight's stored bytes: words or int8 plane,
    scales, and minima when asym), the output written once, against
    `flops`, the rate of the kernel's operations, for 2*m*k*n of them."""
    nbytes = m * k * x_bytes + weight_bytes + m * n * out_bytes
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * m * k * n / flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def op_rate(kname: str, dtype, m: int) -> float:
    """The operation rate a kernel computes at (see the constants)."""
    if dtype != torch.float32:
        return BF16_FLOPS
    if kname == "gemv_gp" and m >= 2:
        return F32_2XTF32_FLOPS
    return F32_FMA_FLOPS if kname.startswith("gemv") else F32_3XTF32_FLOPS


def paged_bound(lengths, ps: int, hkv: int, hq: int, d: int, page_bytes: int, q_bytes: int,
                window: int):
    """Least time (ms) of one paged decode step of one layer: the pages
    the slots' lengths reach, read once (K and V of `page_bytes` an
    element, plus their f32 scales in int8), q read and the output written
    once (`q_bytes` an element), the page table and lengths; against the
    bf16 rate for 4*D operations per (position, query head) (the score and
    the PV dots)."""
    pages = sum(q_pos // ps + 1 for q_pos in lengths)
    nbytes = pages * ps * hkv * d * page_bytes * 2
    if page_bytes == 1:
        nbytes += pages * ps * hkv * 4 * 2
    nbytes += len(lengths) * hq * d * q_bytes * 2 + len(lengths) * (window + 1) * 4
    positions = sum(q_pos + 1 for q_pos in lengths)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * positions * hq * d / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stack(qts):
    z = qts[0].zero
    return QuantizedTensor(data=torch.stack([q.data for q in qts]),
                           scale=torch.stack([q.scale for q in qts]),
                           zero=None if z is None else torch.stack([q.zero for q in qts]),
                           spec=qts[0].spec, shape=qts[0].shape)


def call_kernel(kname, x, w, layer, out_dtype):
    """The kernel's wrapper on w (stacked with layer, or flat)."""
    fn = getattr(dm, kname)
    if kname == "gemv_gp3":
        return fn(x, w.data, w.scale, layer=layer, out_dtype=out_dtype)
    if kname == "gemm_plane":
        return fn(x, w.data, w.scale, w.zero, w.spec, layer=layer, out_dtype=out_dtype)
    if kname in ("gemv_gp", "gemm_pairs"):
        return fn(x, w.data, w.scale, w.zero, w.spec.layout, layer=layer, out_dtype=out_dtype)
    return fn(x, w.data, w.scale, w.zero, layer=layer, out_dtype=out_dtype)


def call_plain(kname, x, w, out_dtype):
    """The kernel's plain version on the flat weight w."""
    fn = getattr(dm, kname + "_plain")
    if kname == "gemv_gp3":
        return fn(x, w.data, w.scale, out_dtype)
    if kname == "gemm_plane":
        return fn(x, w.data, w.scale, w.zero, w.spec, out_dtype)
    if kname in ("gemv_gp", "gemm_pairs"):
        return fn(x, w.data, w.scale, w.zero, w.spec.layout, out_dtype)
    return fn(x, w.data, w.scale, w.zero, out_dtype)


def stored_k(w):
    rows = w.data.shape[-2]
    return rows if w.spec.storage == "i8" else rows * w.spec.elems_per_word


def matmul_rows(gen, flush):
    rows = []
    for label, spec, shapes, head_f32, cases in MATMUL_CASES:
        spec = resolve_spec(spec)
        for name, k, n in shapes:
            todo = [(kname, m) for kname, ms_by_shape in cases
                    for m in ms_by_shape.get(name, ms_by_shape.get("*", ()))]
            if not todo:
                continue
            sp = spec
            if name == "lm_head" and head_f32:
                sp = dataclasses.replace(spec, dtype="float32")
                label_h = f"{label} (f32 head)" if spec.dtype != "float32" else label
            else:
                label_h = label
            rows += shape_rows(gen, flush, label_h, sp, name, k, n, todo)
    return rows


def shape_rows(gen, flush, label, spec, name, k, n, cases):
    """Every (kernel, m) case of one spec at one shape, on one weight."""
    rows = []
    flat = name == "lm_head"
    qts = [pad_quantized_groups(quantize(
        torch.randn((k, n), generator=gen, device="cuda") * 0.02, spec))
        for _ in range(1 if flat else 2)]
    # layer weights stacked [2, KW, N], read at layer 1; the lm head flat
    one = qts[-1]
    w, layer = (one, None) if flat else (stack(qts), 1)
    K, N = stored_k(one), one.data.shape[1]
    cdtype = torch_dtype(spec.dtype)
    # the library yardstick multiplies by the whole stored [K, N] weight,
    # dequantized once in the compute dtype
    dense = dequantize(QuantizedTensor(one.data, one.scale, one.zero, spec=one.spec,
                                       shape=(K, N)), cdtype)
    out_dtype = torch.float32 if flat else cdtype
    tol = F32_KERNEL_TOL if cdtype == torch.float32 else dict(atol=KERNEL_TOL, rtol=KERNEL_TOL)
    esize = torch.empty((), dtype=cdtype).element_size()
    for kname, m in cases:
        x = torch.zeros((m, K), dtype=cdtype, device="cuda")
        x[:, :k] = torch.randn((m, k), generator=gen, device="cuda").to(cdtype)

        def run_kernel():
            return call_kernel(kname, x, w, layer, out_dtype)

        def run_plain():
            return call_plain(kname, x, one, out_dtype)

        def run_library():
            return torch.matmul(x, dense)

        got, want = run_kernel(), run_plain()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), **tol)
        reps = 20 if m <= 128 else 5
        b_ms, b_by = bound(m, K, N, one.nbytes(), esize, 4 if flat else esize,
                           op_rate(kname, cdtype, m))
        row = dict(kernel=kname, quant=label, dtype=str(cdtype).replace("torch.", ""),
                   shape=name, m=m, k=K, n=N, max_abs_err=err,
                   ms=time_ms(run_kernel, flush, reps),
                   plain_ms=time_ms(run_plain, flush, min(reps, 5)),
                   library_ms=time_ms(run_library, flush, reps),
                   bound_ms=b_ms, bound_by=b_by)
        row["tflops"] = 2 * m * K * N / (row["ms"] * 1e-3) / 1e12
        row["vs_library"] = row["ms"] / row["library_ms"]
        print(f"  {kname} {label} {name} m={m} K={K} N={N}: max_abs_err={err:.3g} "
              f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
              f"library_ms={row['library_ms']:.4f} bound_ms={b_ms:.4f} ({b_by}) "
              f"{row['tflops']:.1f} TFLOP/s, {row['vs_library']:.2f}x library")
        if not ok:
            fail(f"{kname} {label} {name} m={m} disagrees with its plain version (max {err})")
        rows.append(row)
    del w, dense
    return rows


def paged_rows(gen, flush, window=PAGED_WINDOW):
    """paged_flash_decode at each PAGED_CASES shape, in the serve pool's
    layout (hb 8, page 128, a 16-page window): 8 slots of PAGED_LENGTHS,
    and one slot at 2047. The library yardstick is
    scaled_dot_product_attention over the same window ALREADY GATHERED to
    contiguous [B, H, W, D] K/V in q's dtype (int8: dequantized), masked to
    each slot's length: no single PyTorch call attends a paged pool."""
    rows = []
    hb, ps, L = PAGED_HEAD_BLOCK, PAGE_SIZE, 2
    for label, hkv, hq, D, qdt, page_dtypes in PAGED_CASES:
        for lengths in (PAGED_LENGTHS, *([n] for n in PAGED_B1_LENGTHS)):
            rows += paged_case(gen, flush, label, hkv, hq, D, qdt, page_dtypes, lengths, window,
                               hb, ps, L)
    return rows


def paged_case(gen, flush, label, hkv, hq, D, qdt, page_dtypes, lengths, window, hb, ps, L):
    rows = []
    B = len(lengths)
    G, P = hkv // hb, B * window + 1
    table = (torch.randperm(P - 1, generator=torch.Generator().manual_seed(0))
             .reshape(B, window) + 1).int().cuda()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q = torch.randn((B, hq, 1, D), generator=gen, device="cuda").to(qdt)
    W = window * ps
    mask = (torch.arange(W, device="cuda")[None, :] <= lens[:, None].long())[:, None, None, :]
    for pdt in page_dtypes:
        int8 = pdt == torch.int8
        shape = (G, L, P, ps, hb * D)
        if int8:
            kp, vp = (torch.randint(-127, 128, shape, generator=gen, device="cuda",
                                    dtype=torch.int8) for _ in range(2))
            ks = torch.rand((G, L, P, hb, ps), generator=gen, device="cuda") * 0.02 + 1e-3
            vs = torch.rand((G, L, P, ps, hb), generator=gen, device="cuda") * 0.02 + 1e-3
        else:
            kp, vp = (torch.randn(shape, generator=gen, device="cuda").to(pdt)
                      for _ in range(2))
            ks = vs = None

        def run_kernel():
            return pa.paged_flash_decode(q, kp, vp, ks, vs, table, lens, 1,
                                         num_pages_window=window, head_dim=D)

        # the plain version under the kernel's split plan
        pps, nsplit = pa.launch_plan(q, kp, table, window)

        def run_plain():
            return pa.paged_flash_decode_plain(q, kp, vp, ks, vs, table, lens, 1,
                                               num_pages_window=window, head_dim=D,
                                               pages_per_split=pps)

        # contiguous K/V of the window for the yardstick, [B, H, W, D]
        def gathered(pages, sc, k_side):
            x = pages[:, 1][:, table.long()].float()  # [G, B, np, ps, hb*D]
            if sc is not None:
                s = sc[:, 1][:, table.long()]  # k [G,B,np,hb,ps]; v [G,B,np,ps,hb]
                s = s.transpose(-1, -2) if k_side else s
                x = x.reshape(G, B, window, ps, hb, D) * s[..., None]
            x = x.reshape(G, B, window, ps, hb, D).permute(1, 0, 4, 2, 3, 5)
            return x.reshape(B, hkv, W, D).to(qdt).contiguous()

        kc, vc = gathered(kp, ks, True), gathered(vp, vs, False)
        rep = hq // hkv

        def run_library():
            return torch.nn.functional.scaled_dot_product_attention(
                q, kc, vc, attn_mask=mask, **({"enable_gqa": True} if rep > 1 else {}))

        got, want = run_kernel(), run_plain()
        lib = run_library()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        lib_err = (lib.float() - want.float()).abs().max().item()
        tol = F32_KERNEL_TOL if qdt == pdt == torch.float32 else PAGED_KERNEL_TOL
        ok = got.dtype == qdt and torch.allclose(got.float(), want.float(), **tol)
        page_bytes = torch.empty((), dtype=pdt).element_size()
        q_bytes = torch.empty((), dtype=qdt).element_size()
        b_ms, b_by = paged_bound(lengths, ps, hkv, hq, D, page_bytes, q_bytes, window)
        kv = str(pdt).replace("torch.", "")
        qs = str(qdt).replace("torch.", "")
        name = f"{label} b{B} {kv} KV" if B > 1 else f"{label} b1x{lengths[0]} {kv} KV"
        row = dict(kernel="paged_flash_decode", shape=name, dtype=qs, m=B, k=W, n=hq, d=D,
                   pages_per_split=pps, splits=nsplit,
                   max_abs_err=err, ms=time_ms(run_kernel, flush, 20),
                   plain_ms=time_ms(run_plain, flush, 5),
                   library_ms=time_ms(run_library, flush, 20), bound_ms=b_ms, bound_by=b_by)
        row["vs_library"] = row["ms"] / row["library_ms"]
        print(f"  paged_flash_decode {name} D={D} q={qs} lengths={lengths} window={W} "
              f"split plan {nsplit} x {pps} pages: "
              f"max_abs_err={err:.3g} (library vs plain {lib_err:.3g}) ms={row['ms']:.4f} "
              f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}) {row['vs_library']:.2f}x library, "
              f"{row['ms'] / b_ms:.1f}x bound")
        if not ok:
            fail(f"paged_flash_decode {name} disagrees with its plain version (max {err})")
        rows.append(row)
        del kp, vp, ks, vs, kc, vc
    return rows


def kernel_phase():
    print("== kernel phase (torch.backends.cuda.matmul.allow_tf32 = False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.ones(64 * 2**20, dtype=torch.float32, device="cuda")  # 256 MB
    rows = matmul_rows(gen, flush) + paged_rows(gen, flush)
    del flush
    torch.cuda.empty_cache()
    return rows


def pad_params(params):
    return tree_map(lambda x: pad_quantized_groups(x) if isinstance(x, QuantizedTensor)
                    else x, params)


def card_vs_cpu(cfg, params, rtol=LOGIT_RTOL):
    cpu = tree_map(lambda x: x.map(lambda t: t.cpu()) if isinstance(x, QuantizedTensor)
                   else x.cpu(), params)
    toks = torch.randint(3, cfg.vocab_size, (1, 64), generator=torch.Generator().manual_seed(1))
    caches = {"cuda": init_kv_cache(cfg, 1, 128, device="cuda"),
              "cpu": init_kv_cache(cfg, 1, 128, device="cpu")}
    for step in range(5):
        logits = {}
        for dev, p in (("cuda", params), ("cpu", cpu)):
            lg, caches[dev] = forward(p, cfg, toks.to(dev), caches[dev], attn_window=128)
            logits[dev] = lg.float().cpu()
        if not torch.isfinite(logits["cuda"]).all() or logits["cuda"].shape != (1, cfg.vocab_size):
            fail("card logits not finite or of the wrong shape")
        err = (logits["cuda"] - logits["cpu"]).abs().max().item()
        scale = logits["cpu"].abs().max().item()
        print(f"  card vs CPU, {'prefill 64' if step == 0 else f'decode {step}'}: "
              f"max |logit diff| = {err:.4g}, max |logit| = {scale:.4g}, ratio {err / scale:.4g}")
        if err > rtol * scale:
            fail(f"card logits differ from the CPU's by {err} > {rtol} * {scale}")
        toks = logits["cpu"].argmax(-1, keepdim=True)
        # each decode step starts both sides from the card's cache, so a
        # step is held on its own error, not on the prefill's amplified
        caches["cpu"].k.copy_(caches["cuda"].k)
        caches["cpu"].v.copy_(caches["cuda"].v)


def paged_vs_slot(cfg, params):
    """8 slots of mixed prompt lengths, prefill + 4 decode steps, on the
    card: bf16 paged logits against slot logits (LOGIT_RTOL: the paged
    decode rounds its probabilities to bf16 for bf16 pages, the slot path
    to the activations' type), int8 paged against bf16 paged
    (INT8_LOGIT_RTOL). The paged decode runs kernel 7."""
    print(f"  paged vs slot: {cfg.name}, D = {cfg.head_dim}")
    B, ps = SERVE_BATCH, PAGE_SIZE
    lens = [5, 100, 127, 128, 129, 300, 700, 1000]
    S = 1024  # the prefill bucket
    rng = np.random.default_rng(1)
    toks = np.zeros((B, S), np.int64)
    for b, n in enumerate(lens):
        toks[b, :n] = rng.integers(3, cfg.vocab_size, n)
    table = np.arange(1, B * PAGED_WINDOW + 1, dtype=np.int32).reshape(B, PAGED_WINDOW)
    caches = {"slot": init_kv_cache(cfg, B, SERVE_SEQ, device="cuda")}
    for name, dt in (("paged", torch.bfloat16), ("paged int8", torch.int8)):
        c = init_paged_kv_cache(cfg, B, B * PAGED_WINDOW + 1, ps, PAGED_WINDOW, dtype=dt,
                                device="cuda")
        c.set_page_table(table)
        caches[name] = c
    x = torch.from_numpy(toks).cuda()
    seq_lens = torch.tensor(lens)
    reset_counters()
    for step in range(5):
        logits = {}
        for name, c in caches.items():
            lg, _ = forward(params, cfg, x, c, seq_lens=seq_lens if step == 0 else None,
                            attn_window=S if step == 0 else SERVE_SEQ)
            logits[name] = lg.float().cpu()
            if not torch.isfinite(logits[name]).all() or logits[name].shape != (B, cfg.vocab_size):
                fail(f"{name} logits not finite or of the wrong shape")
        scale = logits["slot"].abs().max().item()
        what = f"prefill {lens}" if step == 0 else f"decode {step}"
        for name, ref, tol in (("paged", "slot", LOGIT_RTOL),
                               ("paged int8", "paged", INT8_LOGIT_RTOL)):
            err = (logits[name] - logits[ref]).abs().max().item()
            print(f"  {name} vs {ref}, {what}: max |logit diff| = {err:.4g}, "
                  f"max |logit| = {scale:.4g}, ratio {err / scale:.4g}")
            if err > tol * scale:
                fail(f"{name} logits differ from {ref} by {err} > {tol} * {scale}")
        x = logits["slot"].argmax(-1, keepdim=True).cuda()
    got = read_counters()["paged_flash_decode"]
    if got != 2 * 4 * cfg.num_layers:  # two paged caches x 4 decode steps x L
        fail(f"paged_flash_decode launched {got} times in the parity decode steps")


def parity_phase():
    cfg = VICUNA.replace(num_layers=2)
    for quant in ("q4bf16", "q3bf16_s16"):
        print(f"== parity phase: 2-layer Vicuna-7B width, {quant}")
        params = pad_params(init_random_params(cfg, quant, seed=1, device="cuda"))
        card_vs_cpu(cfg, params)
        if quant == "q4bf16":
            paged_vs_slot(cfg, params)
        del params
        torch.cuda.empty_cache()
    # GPT-NeoX at the 3B width: pair f32 layers and head; hsplit f16 layers
    # and f32 head; qsplit bf16 layers and the qsplit f32 head
    # and the NeoX paged decode (kernel 7 at D = 80, f32 and f16 q)
    for model, quant in ((REDPAJAMA, "q4f32"), (DOLLY, "q4f16_hs"), (DOLLY, "q4bf16")):
        rtol = F32_LOGIT_RTOL if quant == "q4f32" else LOGIT_RTOL
        print(f"== parity phase: 2-layer {model.name}, {quant} (share {rtol})")
        cfg = model.replace(num_layers=2)
        params = pad_params(init_random_params(cfg, quant, seed=1, device="cuda"))
        card_vs_cpu(cfg, params, rtol)
        if quant != "q4bf16":
            paged_vs_slot(cfg, params)
        del params
        torch.cuda.empty_cache()


# the kernel of each quantized matmul on the main paths, by preset: the
# layer matmuls of a prefill (m = the bucket), every matmul at m = 1 (b1
# decode, and the lm head of a prefill, which runs at its last position
# only), and every matmul of a b8 decode step (m = 8)
PATH_KERNELS = {"q4bf16": {"prefill": "gemm_qs", "m1": "gemv_qs", "m8": "gemv_qs"},
                "q3bf16_s16": {"prefill": "gemm_plane", "m1": "gemv_gp3", "m8": "gemm_plane"},
                "q4f32": {"prefill": "gemm_pairs", "m1": "gemv_gp", "m8": "gemv_gp"},
                "q4f16_hs": {"prefill": "gemm_pairs", "m1": "gemv_gp", "m8": "gemv_gp"}}


def expected_launches(quant, *, layers=VICUNA.num_layers, b1_steps=0, prefills=0,
                      b8_forwards=0):
    """Launch counts a path implies: per prefill 4L layer matmuls and the
    lm head at m=1; per b1 decode step 4L + 1 matmuls at m=1; per b8
    decode forward 4L + 1 matmuls at m=8 and L paged decodes."""
    k, L = PATH_KERNELS[quant], layers
    want = dict.fromkeys(COUNTED, 0)
    want[k["prefill"]] += 4 * L * prefills
    want[k["m1"]] += (4 * L + 1) * b1_steps + prefills
    want[k["m8"]] += (4 * L + 1) * b8_forwards
    want["paged_flash_decode"] += L * b8_forwards
    return want


def param_bytes(params) -> int:
    sizes = []
    tree_map(lambda x: sizes.append(x.nbytes() if isinstance(x, QuantizedTensor)
                                    else x.numel() * x.element_size()), params)
    return sum(sizes)


def chat_phase(params, quant="q4bf16", cache_dtype=torch.bfloat16, cfg=VICUNA):
    kv = "int8" if cache_dtype == torch.int8 else "bf16"
    print(f"== chat phase: {cfg.name} {quant}, {cfg.num_layers} layers, {kv} slot cache, "
          f"batch 1, {cfg.conv_template} template")
    engine = InferenceEngine(cfg, params, max_batch=1, cache_dtype=cache_dtype,
                             max_seq_len=min(cfg.max_seq_len, 768 * 2), device="cuda")
    if engine.kv_layout != "slot" or engine.cache.k.dtype != cache_dtype:
        fail(f"chat engine runs {engine.kv_layout} {engine.cache.k.dtype} KV")
    nbytes = param_bytes(engine.params)
    print(f"  params (groups padded to multiples of 32): {nbytes} bytes, "
          f"{nbytes / 2**30:.3f} GiB")
    lg = engine.prefill([[cfg.bos_token_id] + list(b"Hello")])
    if lg.shape != (1, cfg.vocab_size) or not torch.isfinite(lg).all():
        fail("full-depth prefill logits not finite or of the wrong shape")
    engine.reset()
    engine.stats.reset()
    session = ChatSession(engine, ByteTokenizer(), cfg,
                          ChatConfig(temperature=0.0, max_gen_len=32, max_window_size=768))
    prompts = ["Hello! Who are you?", "Name three colors.", "Thanks, bye."]
    reset_counters()
    ttft = []
    for prompt in prompts:
        before = engine.stats.prefill_time
        reply = session.ask(prompt)
        ttft.append((engine.stats.prefill_time - before) * 1e3)
        print(f"  USER: {prompt!r} -> {len(reply)} chars")
    launches = read_counters()
    steps = engine.stats.decode_tokens
    stats = dict(model=cfg.name, quant=quant, kv=kv, param_bytes=nbytes, prefill_ms=ttft,
                 decode_tok_s=engine.stats.decode_tps, decode_steps=steps)
    print(f"  prefill ms per turn (TTFT less sampling): {[round(t, 2) for t in ttft]}; "
          f"decode {engine.stats.decode_tps:.2f} tok/s over {steps} steps")
    want = expected_launches(quant, layers=cfg.num_layers, b1_steps=steps,
                             prefills=len(prompts))
    print(f"  launches: {launches} (want {want})")
    if steps == 0 or launches != want:
        fail("launch counts do not match the chat path")
    return launches, stats


def serve_requests(n=16, vocab=VICUNA.vocab_size, sampled=lambda i: i % 4 == 3):
    """n requests from a seed: prompt lengths 16-1500, 32 new tokens; the
    `sampled` ones at T 0.7, top-p 0.95 and their own seed, the rest
    greedy (by default every fourth one sampled)."""
    rng = np.random.default_rng(2)
    out = []
    for i in range(n):
        k = int(rng.integers(16, 1501))
        prompt = [int(t) for t in rng.integers(3, vocab, k)]
        out.append((prompt, GenerationConfig(max_new_tokens=32,
                                             temperature=0.7 if sampled(i) else 0.0,
                                             top_p=0.95, seed=i)))
    return out


def serve_phase(params):
    print(f"== serve phase: vicuna-v1-7b q4bf16, 32 layers, paged KV (page {PAGE_SIZE}), "
          f"max_batch {SERVE_BATCH}, max_seq_len {SERVE_SEQ}, SchedulerServer + RemoteScheduler")
    engine = InferenceEngine(VICUNA, params, max_batch=SERVE_BATCH, max_seq_len=SERVE_SEQ,
                             kv_layout="paged", page_size=PAGE_SIZE, device="cuda")
    sched = ContinuousBatchingScheduler(engine, seed=0)
    admitted = []
    prefill_slot = engine._prefill_slot

    def counted_prefill(*a, **kw):
        admitted.append(1)
        return prefill_slot(*a, **kw)

    engine._prefill_slot = counted_prefill
    server = SchedulerServer(sched).start()
    client = RemoteScheduler(("127.0.0.1", server.port), timeout=600)
    try:
        work = serve_requests()
        first_at = {}
        lock = threading.Lock()

        def on_token(i):
            def cb(_tok):
                with lock:
                    first_at.setdefault(i, time.perf_counter())
            return cb

        reset_counters()
        engine.decode_forwards = 0
        engine.stats.reset()
        t0 = time.perf_counter()
        reqs = [(client.submit(p, g, on_token=on_token(i)), time.perf_counter())
                for i, (p, g) in enumerate(work)]
        if not client.wait_all(900):
            fail(f"serve: requests did not complete (server error: {server.error})")
        wall = time.perf_counter() - t0
        launches = read_counters()
        st = client.stats()
    finally:
        client.close()
        server.stop()
    if server.error is not None:
        fail(f"serve: the scheduler failed:\n{server.error}")
    lens = [len(r.output) for r, _ in reqs]
    if any(r.error for r, _ in reqs) or min(lens) < 1 or max(lens) > 32:
        fail(f"serve: bad completions {lens} {[r.error for r, _ in reqs]}")
    if sum(lens) < 0.9 * 16 * 32:  # a stop token ends a request early only by chance
        fail(f"serve: only {sum(lens)} tokens generated")
    ttft = sorted((first_at[i] - t_sub) * 1e3 for i, (_, t_sub) in enumerate(reqs))
    forwards, n_pre = engine.decode_forwards, len(admitted)
    want = expected_launches("q4bf16", b8_forwards=forwards, prefills=n_pre)
    p50 = float(np.percentile(ttft, 50))
    p99 = float(np.percentile(ttft, 99))
    out = dict(
        requests=16, tokens=sum(lens), tokens_per_request=lens, wall_s=wall,
        ttft_p50_ms=p50, ttft_p99_ms=p99,
        aggregate_tok_s=sum(lens) / wall,
        server_decode_tok_s=st["decode_tokens"] / st["decode_time"],
        decode_forwards=forwards, step_wall_ms=st["decode_time"] / forwards * 1e3,
        prefill_s=st["prefill_time"], admissions=n_pre)
    print(f"  {json.dumps(out)}")
    print(f"  launches: {launches} (want {want})")
    if forwards == 0 or launches != want:
        fail("launch counts do not match the serve path")
    return launches, out


def int8_auto_phase(params, quant="q4bf16"):
    print(f"== {quant}, int8 KV under kv_layout='auto' (in-process scheduler, 8 requests)")
    engine = InferenceEngine(VICUNA, params, max_batch=SERVE_BATCH, max_seq_len=SERVE_SEQ,
                             cache_dtype=torch.int8, kv_layout="auto", page_size=PAGE_SIZE,
                             device="cuda")
    if engine.kv_layout != "paged" or engine.cache.k_pages.dtype != torch.int8:
        fail(f"kv_layout='auto' with int8 KV resolved to {engine.kv_layout}")
    sched = ContinuousBatchingScheduler(engine, seed=0)
    admitted = []
    prefill_slot = engine._prefill_slot

    def counted_prefill(*a, **kw):
        admitted.append(1)
        return prefill_slot(*a, **kw)

    engine._prefill_slot = counted_prefill
    reset_counters()
    t0 = time.perf_counter()
    reqs = [sched.submit(p, g) for p, g in serve_requests()[:8]]
    sched.run()
    wall = time.perf_counter() - t0
    launches = read_counters()
    want = expected_launches(quant, b8_forwards=engine.decode_forwards, prefills=len(admitted))
    stats = dict(quant=quant, tokens=sum(len(r.output) for r in reqs), wall_s=wall,
                 decode_tok_s=engine.stats.decode_tps, decode_forwards=engine.decode_forwards,
                 admissions=len(admitted), prefill_s=engine.stats.prefill_time)
    print(f"  kv_layout={engine.kv_layout}, {stats['tokens']} tokens in {wall:.2f} s, "
          f"decode {engine.stats.decode_tps:.2f} tok/s over {engine.decode_forwards} forwards, "
          f"{len(admitted)} admissions, prefill {engine.stats.prefill_time:.2f} s")
    print(f"  launches: {launches} (want {want})")
    if not all(r.done and r.output for r in reqs):
        fail("int8 auto run: a request did not complete")
    if engine.decode_forwards == 0 or launches != want:
        fail("int8 auto run: launch counts do not match the path")
    return launches, stats


def neox_serve_phase(params, cfg, quant):
    """The paged continuous-batching server on a GPT-NeoX model: 8
    requests in process (one sampled) through ContinuousBatchingScheduler
    over InferenceEngine(kv_layout="paged"), bf16 pages. Every b8 decode
    forward runs its 4L layer matmuls and the f32 lm head through gemv_gp
    at m = 8 and kernel 7 once a layer (D = 80, q in the model's type);
    every admission its layer matmuls through gemm_pairs and its lm head
    through gemv_gp at m = 1."""
    print(f"== {cfg.name} {quant} serve: paged KV (page {PAGE_SIZE}), max_batch {SERVE_BATCH}, "
          f"max_seq_len {SERVE_SEQ}, in-process scheduler, 8 requests")
    engine = InferenceEngine(cfg, params, max_batch=SERVE_BATCH, max_seq_len=SERVE_SEQ,
                             kv_layout="paged", page_size=PAGE_SIZE, device="cuda")
    if engine.kv_layout != "paged" or engine.cache.k_pages.dtype != torch.bfloat16:
        fail(f"{cfg.name} serve engine runs {engine.kv_layout} {engine.cache.k_pages.dtype} KV")
    sched = ContinuousBatchingScheduler(engine, seed=0)
    admitted = []
    prefill_slot = engine._prefill_slot

    def counted_prefill(*a, **kw):
        admitted.append(1)
        return prefill_slot(*a, **kw)

    engine._prefill_slot = counted_prefill
    # the m of every matmul routed to gemv_gp (route is a pure function of
    # the weight's format and m; the wrapper keeps its own launch count)
    gp_rows = []
    route = dm.route

    def route_rows(spec, n_groups, m):
        kind = route(spec, n_groups, m)
        if kind == "gemv_gp":
            gp_rows.append(m)
        return kind

    work = serve_requests(8, cfg.vocab_size, sampled=lambda i: i == 7)
    reset_counters()
    dm.route = route_rows
    try:
        t0 = time.perf_counter()
        reqs = [sched.submit(p, g) for p, g in work]
        sched.run()
        wall = time.perf_counter() - t0
    finally:
        dm.route = route
    launches = read_counters()
    forwards, n_pre, L = engine.decode_forwards, len(admitted), cfg.num_layers
    want = expected_launches(quant, layers=L, b8_forwards=forwards, prefills=n_pre)
    lens = [len(r.output) for r in reqs]
    stats = dict(model=cfg.name, quant=quant, requests=len(reqs), tokens=sum(lens), wall_s=wall,
                 decode_tok_s=engine.stats.decode_tps, decode_forwards=forwards,
                 step_wall_ms=engine.stats.decode_time / max(forwards, 1) * 1e3,
                 admissions=n_pre, prefill_s=engine.stats.prefill_time)
    print(f"  {json.dumps(stats)}")
    m8, m1 = gp_rows.count(SERVE_BATCH), gp_rows.count(1)
    print(f"  launches: {launches} (want {want}); routed to gemv_gp at m = 8: {m8} "
          f"(want {(4 * L + 1) * forwards}), at m = 1: {m1} (want {n_pre})")
    if not all(r.done and r.output for r in reqs) or min(lens) < 1:
        fail(f"{cfg.name} serve: bad completions {lens}")
    if forwards == 0 or launches != want:
        fail(f"{cfg.name} serve: launch counts do not match the path")
    if m8 != (4 * L + 1) * forwards or m1 != n_pre or len(gp_rows) != m8 + m1:
        fail(f"{cfg.name} serve: gemv_gp was routed m = {sorted(set(gp_rows))}, not the path's")
    return launches, stats


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    t0 = time.perf_counter()
    # the wgmma sources are built in any case, so that ptxas reports them
    # on a warm csrc/build/ too
    logs = build_kernels(KERNELS, extra_flags=("-Xptxas", "-v"), force=WGMMA_SOURCES)
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for name in WGMMA_SOURCES:
        print(f"  ptxas, {name}.cu:")
        print("\n".join(ptxas_summary(logs[name])))
    # every gemm_plane instantiation: registers, spills, serialized wgmma;
    # the m tile of 256 (A streamed per k16 step) must not spill
    plane = plane_instantiations(logs["dequant_gemm_plane"])
    for e in plane:
        print(f"  gemm_plane format {e['fmt']} MT={e['mt']}: {e['regs']} registers, spill "
              f"stores {e['spill_stores']} B, loads {e['spill_loads']} B, C7512 notes "
              f"{e['c7512']}")
    wide = [e for e in plane if e["mt"] == 256]
    if sorted(e["fmt"] for e in wide) != [1, 2, 3] or any(
            e["spill_stores"] != 0 or e["spill_loads"] != 0 for e in wide):
        fail(f"gemm_plane MT=256 instantiations missing or spilling: {wide}")

    rows = kernel_phase()
    parity_phase()
    t0 = time.perf_counter()
    params = init_random_params(VICUNA, "q4bf16", seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"full-depth params in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    paths = {}
    paths["chat"], chat_stats = chat_phase(params)
    torch.cuda.empty_cache()
    paths["serve"], serve_stats = serve_phase(params)
    torch.cuda.empty_cache()
    paths["int8_auto"], _ = int8_auto_phase(params)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    params = init_random_params(VICUNA, "q3bf16_s16", seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"full-depth q3bf16_s16 params in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    paths["q3_chat"], q3_chat_stats = chat_phase(params, "q3bf16_s16", torch.int8)
    torch.cuda.empty_cache()
    paths["q3_serve"], q3_serve_stats = int8_auto_phase(params, "q3bf16_s16")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    neox_stats = {}
    for path, cfg, quant in (("rp_chat", REDPAJAMA, "q4f32"), ("dolly_chat", DOLLY, "q4f16_hs")):
        t0 = time.perf_counter()
        params = init_random_params(cfg, quant, seed=0, device="cuda")
        torch.cuda.synchronize()
        print(f"full-depth {cfg.name} {quant} params in {time.perf_counter() - t0:.1f} s, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        paths[path], neox_stats[path] = chat_phase(params, quant, cfg=cfg)
        torch.cuda.empty_cache()
        serve_path = path.replace("chat", "serve")
        paths[serve_path], neox_stats[serve_path] = neox_serve_phase(params, cfg, quant)
        del params
        gc.collect()
        torch.cuda.empty_cache()

    # per kernel: its main-path shape (GEMVs: w_in at decode m=1; GEMMs: w_in
    # at prefill m=128; paged: bf16 KV at b8); every shape is in "shapes".
    # launches: the count on the kernel's own slice's path (the q4 serve
    # phase for rows 1-3 and 7, the q3 chat phase for rows 4-6, the
    # RedPajama q4f32 chat for the pair/hsplit bodies), and each path's
    # count in launches_by_path
    kernels = []
    tops = {"gemv_qs": ("q4bf16", "w_in", 1, "serve"),
            "gemm_qs": ("q4bf16", "w_in", 128, "serve"),
            "gemv_gp": ("q4f32", "w_in", 8, "rp_serve"),
            "gemm_pairs": ("q4f32", "w_in", 128, "rp_chat"),
            "gemv_gp3": ("q3bf16_s16", "w_in", 1, "q3_chat"),
            "gemm_plane": ("q3bf16_s16", "w_in", 128, "q3_chat"),
            "paged_flash_decode": (None, "vicuna b8 bfloat16 KV", SERVE_BATCH, "serve")}
    for kname, (quant, shape, m, path) in tops.items():
        mine = [r for r in rows if r["kernel"] == kname]
        top = next(r for r in mine
                   if r.get("quant") == quant and r["shape"] == shape and r["m"] == m)
        src, replaces = SOURCES[kname]
        kernels.append(dict(
            name=kname, route="cuda", source=src, replaces=replaces,
            launches=paths[path][kname],
            launches_by_path={p: c[kname] for p, c in paths.items()},
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
            bound_by=top["bound_by"], library_ms=top["library_ms"],
            shapes=[{k: r.get(k) for k in ("quant", "dtype", "shape", "m", "k", "n",
                                           "max_abs_err", "ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms", "tflops",
                                           "vs_library")}
                    for r in mine]))
    if not all(math.isfinite(k["ms"]) and k["launches"] > 0 for k in kernels):
        fail("a kernel time is not finite or a kernel never ran on its path")
    print(json.dumps({"chat": chat_stats, "serve": serve_stats, "q3_chat": q3_chat_stats,
                      "q3_serve": q3_serve_stats, **neox_stats}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
