"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check exits non-zero before the last line):

1. card identity (nvidia-smi name and power limit), then the eight kernel
   sources are built from csrc/ with nvcc, one process per source, all at
   once (build seconds printed, and ptxas's registers, shared memory,
   spills and performance notes of the five sources on the wgmma
   mainloop: gemm_qs, gemm_plane, gemm_pairs, gemv_qs and gemv_gp, and of
   kernel 8, flash_prefill, whose six instantiations must be there without
   spills and whose two f32 ones must run HGMMA (cuobjdump -sass); then
   each gemm_plane instantiation's registers, spills and C7512 notes: the
   m tile of 256 must be there for int3/u16, fp4 and int8, in bf16 and in
   f16, without spills; and each instantiation of the weight-streaming
   mainloop of the m = 1 GEMVs, csrc/gemv_stream.cuh: all 20 must be
   there, without spills);
2. kernel phase: each hand-written kernel against its plain PyTorch
   version on the card, at the shapes of the main paths, with kernel,
   plain, bound and library times: kernel 8 (the reset prefill's causal
   flash attention) on the forward's strided q, k and v at Vicuna-7B's
   (1, 32, 1024, 128) and (1, 32, 2048, 128) in bf16, the G = 2 admission
   (2, 32, 1024, 128), (1, 32, 1024, 128) in f16, and MOSS's (1, 24,
   1024, 256) in bf16, and the f32 body at the same four shapes (library:
   scaled_dot_product_attention(is_causal=True); the f32 rows' bound at
   3xTF32's 165 TFLOP/s, the f32 FMA bound at 67 beside it); at the
   Vicuna-7B shapes q4bf16 (qsplit
   GEMV at m=1, 3 and 8: m = 8 is the b1 verify pass at K = 8; GEMM at
   m=32, the b8 scheduler's verify pass at K = 4, m=128 and m=2048, and on
   the flat lm head at m=32 and 128); q3bf16_s16 (int3 GEMV at m=1 and m=2, plane GEMM at m=8, 128 and
   2048); the plane GEMM on q3bf16, fp4bf16 and q8bf16 at w_in, m=1, 128
   and 2048; the f16 bodies: q3f16_s16's int3 GEMV at m=1 and 2 on w_in
   and the lm head, and the plane GEMM on q3f16_s16, q3f16, fp4f16 and
   q8f16 at w_in, m=1, 8, 128 and 2048 (q3f16_s16 also on the flat lm
   head at m=8, the b8 decode's); the pair and hsplit GEMV and GEMM in bf16 at w_in (m=1, 128);
   the flat lm head GEMM at m=512 (ppl's); at moss-moon-003-sft's shapes
   q4bf16 (qsplit GEMV at m=1 and 8, GEMM at m=128; the lm head's N =
   107008); at the GPT-NeoX 3B shapes q4f32 (pair, f32) and q4f16_hs (hsplit, f16, the
   lm head in f32): GEMV at m=1, 3 and 8 and GEMM at m=128 on all five
   shapes and at m=2048 on w_in; the qsplit GEMM in f16 and f32 on all five
   3B shapes, the qsplit GEMV in f16 and f32 at w_in and the qsplit f32
   GEMV on the lm head; paged flash-decode at batch 8 over mixed lengths
   and at batch 1 x 255, 256, 1023 and 2047, at Vicuna-7B's shapes (D 128,
   bf16 q, bf16 and int8 KV), the NeoX 3B's (D 80, f32 and f16 q, bf16 and
   int8 KV) and MOSS's (D 256, bf16 q and KV), each under the wrapper's
   split-KV plan (printed), held against the plain version under the same
   plan; each row prints its TFLOP/s and its time over the library call's;
   then one m = 1 call of each streaming GEMV body (qsplit bf16, f16 and
   f32; pair and hsplit in bf16, f16 and f32; int3/u16 in bf16 and f16 at
   m = 1 and 2), at
   a w_in shape whose plan splits K, counted with torch.profiler: each must
   be one device kernel (the split parts combined in the same launch);
3. parity phase: 2-layer models at full width, the same params through
   forward on the card (kernels) and on the CPU (plain versions), logits
   compared for a 64-token prefill and 4 decode steps: Vicuna-7B in q4bf16,
   q3bf16_s16 and the f16 presets q3f16_s16, q3f16, fp4f16 and q8f16 (the
   last three, plane GEMM only, for a prefill and 2 decode steps),
   RedPajama-INCITE-Chat-3B-v1 in q4f32, dolly-v2-3b in q4f16_hs and in
   q4bf16; then on the card (Vicuna q4bf16 and q3f16_s16, RedPajama q4f32,
   dolly q4f16_hs), 8 slots of mixed prompt lengths, the paged cache
   against the slot cache (bf16; f16 for q3f16_s16) and int8 paged KV
   against the 16-bit paged KV, for a prefill and 4 decode steps; then HF-layout f16 state dicts drawn
   from a seed (2 layers at Vicuna-7B's and moss-moon-003-sft's widths)
   through models.hf_loader.params_from_hf on the card and on the CPU,
   every leaf bit-equal; debug.compare.compare_paths on the Vicuna model
   (q4bf16 and q4f32); MOSS's logits card vs CPU and its paged cache vs
   its slot cache (kernel 7 at D = 256);
4. checkpoint phase: `build --random --device cuda` writes Vicuna-7B
   q4bf16 at full depth into a temporary directory, `load_params(device=
   "cuda")` reads it back through the native reader (native.py; pinned
   staging buffers), every leaf on the card and bit-equal to
   init_random_params(seed=0) (bytes, build and load seconds, GB/s; the
   load just after the write, then a second load, and the process's
   resident and cgroup memory);
5. chat phase: the loaded Vicuna-7B q4bf16 through InferenceEngine and
   ChatSession (slot cache, batch 1), 3 greedy turns of 32 new tokens,
   with the launch counters held to the counts the path implies; then on
   the checkpoint, in process: the CLI with --weights (one-shot), ppl
   (window 512, stride 256, 2048 tokens: every window's layer matmuls and
   its lm head at m = 512 on gemm_qs, launches held) and evaluate
   --profile;
5a. flash phases, on the same params: a b1 chat on bf16 slot KV whose
   first turn is a 1559-token prompt (the reset prefill at bucket 2048:
   kernel 8 once a layer), then a short append turn (none), the two
   prefills' program keys apart by their flash flag; a 1500-token reset
   prefill's logits held against the same block through
   forward_block(prefill_flash=False) (attend) at LOGIT_RTOL; then the b8
   slot scheduler, precompiled, admits four greedy requests of 1500,
   1800, 1024 and 1300 tokens (the first two as one G = 2 admission;
   kernel 8 3L times) with the same streams as on an engine that runs its
   programs eagerly; q3f16_s16 on f16 slot KV (phase 8b), MOSS (phase 10)
   and Vicuna q4f32 (phase 10b, the f32 body) each run one 1100-token
   flash prefill held the same way. Every
   other path (paged, int8, short prompts) is held to 0 launches of
   kernel 8;
5b. speculation phase, on the same params: (a) b1 slot KV, the motif
   prompt of scripts/spec_bench.py (64 tokens) through speculative_stream
   at K = 8 with three drafters: one that proposes nothing (the no-draft
   stream: every token from the same m = 8 verify program, the
   reference), the prompt-lookup drafter, and one that replays the
   no-draft stream (random full-width weights give output that does not
   repeat, so the prompt-lookup drafter finds next to nothing; the replay
   accepts every draft the verify pass agrees with), the plain
   graph-replayed generate beside them (tok/s, tokens a pass, the accepted
   share, verify pass ms, captures, match length against plain); then 2
   greedy chat turns through ChatSession(speculative_k=8) with the same
   three drafters; (b) the b8 slot scheduler with speculative_k=4, two
   greedy requests and, after 3 verify passes, a sampled one (the switch
   to the plain pipeline and back), with the same three drafters, and the
   plain scheduler's step wall. Each stream equals its no-draft stream, or
   its first divergence falls at a no-draft top-2 logit gap within the
   logit difference measured between the two streams up to it; the replay
   runs take fewer passes than the no-draft ones; replays equal verify
   runs; launch counts held: a b1 pass 4L + 1 gemv_qs calls at m = 8, a
   scheduler pass 4L + 1 gemm_qs calls at m = 32;
6. serve phase: the same model behind SchedulerServer
   (ContinuousBatchingScheduler(multi_step="auto:4") over
   InferenceEngine(kv_layout="paged", max_batch=8, max_seq_len=2048,
   page_size=128), the engine precompiled as `serve --precompile
   --multi-step auto:4` does it: every program JAX's precompile compiles
   and the K = 2 and 4 blocks, their count, seconds and pool bytes
   printed); 16 requests from a seed (every fourth sampled) submitted by
   RemoteScheduler over localhost, with TTFT, decode rates, step wall and
   launch counts; no graph is captured while serving, every admission,
   first-token draw, step and K-step block is a replay, and the same
   requests through a single-step scheduler on the same engine give the
   same streams, greedy and sampled; then a shorter in-process run with
   int8 KV under kv_layout="auto", which must resolve to paged;
6b. graph phase: every program's graph against the same program run
   eagerly (the engine's program runner swapped for a direct call):
   full-depth Vicuna q4bf16 at b1, the prefill logits bit for bit, greedy
   tokens (16, both step walls printed) and a sampled stream (T 0.7, a
   fixed seed) equal; then 8 requests through the paged b8 scheduler at 2
   layers on an engine precompile() captured (their count, capture
   seconds and pool bytes printed; the run captures none);
6c. coordinator phase: HostCoordinator over two engines on the q4 params
   (b2, paged, precompiled; one params tree, every leaf shared): a local
   scheduler and one behind SchedulerServer through RemoteScheduler on
   localhost; 8 greedy requests complete, 4 on each host, each host's
   streams equal to its engine's scheduler run alone on its requests, no
   graph captured while serving;
6d. tune phase: tune.tune_shapes on w_in (4096 x 22016, q4bf16) at m = 1
   and 128 into a temporary table; with it loaded each call launches the
   table's plan and agrees with the plain version; without it the plans
   are the time models';
7. q3 chat phase: the q4 params are freed; full-depth Vicuna-7B
   q3bf16_s16 (random weights quantized on the card) with int8 slot KV at
   batch 1, 3 greedy turns of 32 new tokens through ChatSession: every
   decode matmul on the int3 GEMV, every prefill layer matmul on the plane
   GEMM, launch counts held to the path's;
8. q3 scheduler run: 8 requests in process, int8 KV under
   kv_layout="auto" (paged), b8 decode through the plane GEMM and kernel 7;
8b. q3f16 phases: the q3bf16 params are freed; full-depth Vicuna-7B
   q3f16_s16 (the f16 bodies) with f16 slot KV at batch 1, 3 greedy turns
   through ChatSession (decode on the f16 int3 GEMV, prefill on the f16
   plane GEMM), then 8 requests through the paged b8 scheduler with f16
   pages (b8 decode and the flat lm head on the f16 plane GEMM at m = 8,
   kernel 7 with f16 q and f16 pages at D = 128); launch counts held, the
   logits of every forward finite, and each run's device idle share
   (the same work twice again, its graphs captured, the second time under
   torch.profiler; the chat's first turn).
   Every chat and paged-server phase holds the logits of every forward
   finite;
9. GPT-NeoX chat phases: the q3 params are freed; full-depth
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
10. MOSS phase: the NeoX params are freed; full-depth moss-moon-003-sft
   q4bf16 (random weights quantized on the card), a b1 chat on bf16 slot
   KV (3 greedy turns of at most 32 tokens, the moss template) and 8
   requests through the paged b8 scheduler (kernel 7 at D = 256), launch
   counts held, then the same requests twice again, the second time under
   torch.profiler, for the device idle share;
10b. q4f32 flash phase: the MOSS params are freed; full-depth Vicuna-7B
   q4f32 (f32 compute) on an f32 slot cache, one 1100-token reset prefill
   (bucket 2048) as a graph replay: kernel 8's f32 body once a layer (every
   call's q f32), the logits held against forward_block(prefill_flash=
   False) at F32_LOGIT_RTOL, within LOGIT_RTOL (nothing rounds to bf16 on
   either side: the share measures the f32 body's error through 32
   layers);
10c. dump phase (run after the graph phase, before any phase that
   profiles graph replays): the flash chat phase again on the q4 params,
   then debug/dump.py on its engine: every program key dumped (aten ops, a replay's device kernels,
   the graph's dot file, the launched sources' SASS and PTX), each
   wrapper's launch counter equal to its main kernels in the trace, every
   kernel the chat counted named; gemv_qs re-injected on the b1 decode
   program from an unchanged copy of csrc/dequant_gemv_qs.cu (logits bit
   for bit the program's own) and from an edited one (other logits); the
   engine's cache, runs and counters unchanged;
10d. tensor-parallel phases (after the tune phase): (b) tp = 1 over NCCL
   in this process on the q4 params (shard_params at tp = 1 returns them
   as they are): the engine's programs captured with the all-reduces
   inside; a b1 prefill's logits and 16 greedy tokens bit for bit equal
   to the same engine run eagerly and to the unsharded engine's; then the
   q4 params are freed and (a) tp = 2 over gloo: two child processes of
   this script (--tp-rank), both on the one card (NCCL refuses two ranks
   on one device: the run measures correctness and host staging, not
   NVLink TP), each drawing Vicuna-7B q4bf16 (seed 0) and running its
   shards (repacked to the pair order: the pair bf16 bodies): the logits
   gate at 2 layers of full width against the unsharded forward on the
   same weights in the pair order (LOGIT_RTOL; slot with kernel 8 on 16
   heads, paged bf16 and int8 pools with kernel 7 on 2 head groups), a b1
   chat whose first turn is ~1050 tokens (kernel 8) and two short turns,
   the paged b8 scheduler (8 prompts of 16-1024 tokens, 32 new tokens) on
   bf16 and on int8 pages, each rank's launches held to the path's
   (gemv_gp, gemm_pairs, kernel 7, kernel 8), the eager step's wall, its
   all-reduces' share and its device time; then full-depth Vicuna-7B
   q4f32 on an f32 slot cache, the slot gate at F32_LOGIT_RTOL; the two
   ranks' streams equal; (c) u4: `build --random --quantization
   q4bf16_plane --device cuda` at full depth into a temporary directory,
   loaded, its bytes printed (on disk, counted, on the card), a b1 chat of
   3 greedy turns (no kernel launch: the dense route), then 2 layers card
   vs CPU at LOGIT_RTOL; the kernel phase holds the pair bf16 GEMV (m = 1,
   8) and GEMM (m = 128, 2048) at the tp = 2 shard shapes;
11. one JSON line of stats, one of kernels, the card line, and the final
   ok line. Each phase prints its seconds.

Every prefill, first-token draw, decode step and K-step block of the
chat, serve, scheduler and CLI paths replays one captured CUDA graph
(engine/programs.py); each path prints its graphs, their capture
seconds, its program runs by kind (held to its prefills, draws and
decode forwards, every run a replay) and the graph pool's bytes.

Every launch counter is set to 0 just before a path is driven and read
just after; launches made to compare a kernel with its plain version do
not count. A replay adds the launches its graph recorded at capture; a
graph's warm-up step and its capture add none. Needs a CUDA device;
exits non-zero without one.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import gc
import io
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque

import numpy as np
import torch

from mlc_llm_tpu_torch import build, cli, evaluate, ppl, tune
from mlc_llm_tpu_torch.debug import dump
from mlc_llm_tpu_torch.debug.compare import compare_paths
from mlc_llm_tpu_torch.engine import GenerationConfig, InferenceEngine, speculative
from mlc_llm_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
from mlc_llm_tpu_torch.engine.session import ChatConfig, ChatSession
from mlc_llm_tpu_torch.models import (
    forward,
    forward_block,
    get_config,
    init_kv_cache,
    init_paged_kv_cache,
    init_random_params,
)
from mlc_llm_tpu_torch.models import transformer as tr
from mlc_llm_tpu_torch.models.hf_loader import params_from_hf
from mlc_llm_tpu_torch.models.transformer import pad_params, param_bytes, tree_map
from mlc_llm_tpu_torch.ops import BUILD_DIR, CSRC, KERNELS, _nvcc, build_kernels, load_kernel
from mlc_llm_tpu_torch.ops import attention as att
from mlc_llm_tpu_torch.ops import dequant_matmul as dm
from mlc_llm_tpu_torch.ops import matmul as mm
from mlc_llm_tpu_torch.ops import paged_attention as pa
from mlc_llm_tpu_torch.parallel.coordinator import HostCoordinator
from mlc_llm_tpu_torch.parallel.multihost import initialize
from mlc_llm_tpu_torch.parallel.sharding import (
    _repack_hsplit_for_sharding,
    make_mesh,
    shard_params,
)
from mlc_llm_tpu_torch.parallel.wire import RemoteRequest, RemoteScheduler, SchedulerServer
from mlc_llm_tpu_torch.serve import multi_step_compile_ks
from mlc_llm_tpu_torch.quant import (
    QUANT_PRESETS,
    QuantizedTensor,
    pad_quantized_groups,
    quantize,
    resolve_spec,
)
from mlc_llm_tpu_torch.quant.groupwise import dequantize, torch_dtype
from mlc_llm_tpu_torch.tokenizer import ByteTokenizer
from mlc_llm_tpu_torch.utils import checkpoint
from mlc_llm_tpu_torch.utils.checkpoint import load_params

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
# moss-moon-003-sft (hidden 6144, FFN 24576; every group count divisible by 4)
SHAPES_MOSS = [
    ("wqkv", 6144, 18432),
    ("wo", 6144, 6144),
    ("w_in", 6144, 24576),
    ("w_out", 24576, 6144),
    ("lm_head", 6144, 107008),
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
    # flash_prefill (mlc_llm_tpu/ops/attention.py:125) calls JAX's library
    # kernel, whose pallas_call body is _flash_attention_kernel_single_batch
    # (jax 0.9.0, jax/experimental/pallas/ops/tpu/flash_attention.py:342)
    "flash_prefill": ("mlc_llm_tpu_torch/csrc/flash_prefill.cu",
                      "mlc_llm_tpu/ops/attention.py:125"),
}
# Vicuna-7B's rank-local weights at tp = 2 (parallel/sharding.py): wqkv [q_r |
# k_r | v_r], wo's and w_out's k halves (w_out: 172 groups, padded to 192),
# w_in [gate_r | up_r] (stored 11264) and the lm head's 16000 columns
# (stored 16384); q4bf16 repacked to the pair order
SHAPES_TP2 = [
    ("wqkv", 4096, 6144),
    ("wo", 2048, 4096),
    ("w_in", 4096, 11008),
    ("w_out", 5504, 4096),
    ("lm_head", 4096, 16000),
]
QSPLIT_F32 = dataclasses.replace(QUANT_PRESETS["q4f32"], layout="qsplit")
# (label, spec, shapes, lm head in f32, [(kernel, {shape: ms})]): the m of
# each main-path shape; the lm head is flat (f32 out; in f32 compute where
# the model's fp32_lm_head asks for it), every other weight stacked [2, ...]
# and read at layer 1 (out in the compute dtype)
MATMUL_CASES = [
    ("q4bf16", "q4bf16", SHAPES, False,
     [("gemv_qs", {"*": (1, 3, 8)}),
      ("gemm_qs", {"*": (32, 128, 2048), "lm_head": (32, 128, 512)})]),
    # moss-moon-003-sft: its decode and serve GEMVs and its prefill GEMM
    ("q4bf16 moss", "q4bf16", SHAPES_MOSS, False,
     [("gemv_qs", {"*": (1, 8)}), ("gemm_qs", {"*": (128,)})]),
    ("q3bf16_s16", "q3bf16_s16", SHAPES, False,
     [("gemv_gp3", {"*": (1, 2)}), ("gemm_plane", {"*": (8, 128, 2048)})]),
    # the other plane formats once each, at their decode and prefill widths
    # (m = 2048: the m tile of 256 for fp4 and int8, 128 for int3/u32)
    ("q3bf16", "q3bf16", SHAPES, False, [("gemm_plane", {"w_in": (1, 128, 2048)})]),
    ("fp4bf16", "fp4bf16", SHAPES, False, [("gemm_plane", {"w_in": (1, 128, 2048)})]),
    ("q8bf16", "q8bf16", SHAPES, False, [("gemm_plane", {"w_in": (1, 128, 2048)})]),
    # the f16 bodies of rows 4-6: q3f16_s16's decode GEMV (b1 decode and a
    # prefill's lm head), its plane GEMM (prefill, b8 decode and the b8 lm
    # head), and the other three f16 plane presets at w_in
    ("q3f16_s16", "q3f16_s16", SHAPES, False,
     [("gemv_gp3", {"w_in": (1, 2), "lm_head": (1, 2)}),
      ("gemm_plane", {"w_in": (1, 8, 128, 2048), "lm_head": (8,)})]),
    *[(p, p, SHAPES, False, [("gemm_plane", {"w_in": (1, 8, 128, 2048)})])
      for p in ("q3f16", "fp4f16", "q8f16")],
    # the pair and hsplit bodies in bf16, beside the qsplit rows
    ("q4bf16_pair", "q4bf16_pair", SHAPES, False,
     [("gemv_gp", {"w_in": (1,)}), ("gemm_pairs", {"w_in": (128,)})]),
    ("q4bf16_hs", "q4bf16_hs", SHAPES, False,
     [("gemv_gp", {"w_in": (1,)}), ("gemm_pairs", {"w_in": (128,)})]),
    # the tp = 2 shards' pair bf16 bodies: the TP decode's GEMV (b1 and b8)
    # and the TP prefill's GEMM
    ("q4bf16 tp2", "q4bf16_pair", SHAPES_TP2, False,
     [("gemv_gp", {"*": (1, 8)}), ("gemm_pairs", {"*": (128, 2048)})]),
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
# the SASS opcodes counted in kernel 8's f32 body: the tensor-core products,
# the FMAs (softmax and fold: no f32 product runs on the CUDA cores), the
# exponentials and the TMA loads
SASS_OPS = ("HGMMA", "FFMA", "MUFU", "UTMALDG")
# the sources of the weight-streaming mainloop (csrc/gemv_stream.cuh), whose
# stream_kernel instantiations must not spill
STREAM_SOURCES = ("dequant_gemv_qs", "dequant_gemv_gp", "dequant_gemv_gp3")


def ptxas_summary(log: str):
    """nvcc -Xptxas -v's report cut to each kernel entry's name, spill
    bytes, registers and shared memory, and ptxas's performance notes."""
    keep = ("Compiling entry", "spill", "Used", "Performance", "warning")
    return [f"    {line.strip()}" for line in log.splitlines() if any(k in line for k in keep)]


def ptxas_entries(log: str, pattern: str):
    """ptxas's report of each kernel entry whose mangled name matches
    `pattern` (one group: the name): its regex groups, registers, spill
    store bytes and spill load bytes."""
    out, cur = [], None
    for line in log.splitlines():
        hit = re.search(rf"Compiling entry function '({pattern})'", line)
        if hit:
            cur = dict(name=hit.group(1), groups=hit.groups()[1:], regs=None,
                       spill_stores=None, spill_loads=None)
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
    return out


def plane_instantiations(log: str):
    """gemm_plane's mainloop instantiations in ptxas's report: (format id,
    compute type, m tile, registers, spill store bytes, spill load bytes,
    C7512 notes), from the mangled name gemm_kernel<PlanePolicy<F, T>, MT>
    (T: __nv_bfloat16 or __half)."""
    out = ptxas_entries(log, r"\S*PlanePolicyILi(\d)E(\S*?)EELi(\d+)EE\S*")
    for e in out:  # ptxas names the function in each note
        fmt, typ, mt = e.pop("groups")
        e["fmt"], e["mt"] = int(fmt), int(mt)
        e["dtype"] = "f16" if "half" in typ else "bf16" if "bfloat16" in typ else typ
        e["c7512"] = sum("C7512" in line and e["name"] in line for line in log.splitlines())
    return out


def stream_instantiations(log: str):
    """The weight-streaming mainloop's stream_kernel instantiations in
    ptxas's report: name, registers, spill store and load bytes."""
    return ptxas_entries(log, r"\S*stream_kernel\S*")


def sass_counts(so: str, pattern: str):
    """cuobjdump -sass of a built library: per kernel function whose name
    contains `pattern`, the count of each opcode of SASS_OPS."""
    out = subprocess.run([os.path.join(os.path.dirname(_nvcc()), "cuobjdump"), "-sass", so],
                         capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        hit = re.search(r"Function : (\S+)", line)
        if hit:
            fn = hit.group(1) if pattern in hit.group(1) else None
            if fn:
                counts[fn] = dict.fromkeys(SASS_OPS, 0)
            continue
        op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if fn and op and op.group(1) in SASS_OPS:
            counts[fn][op.group(1)] += 1
    return counts


def stream_blocks_check():
    """Each streaming body's blocks an SM as the built kernel reports them
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor) against the count
    stream_plan prices it at (dm.STREAM_BLOCKS, by word kind, compute
    dtype bytes and m)."""
    qs = load_kernel("dequant_gemv_qs", dm._GEMV_ARGS)
    gp = load_kernel("dequant_gemv_gp", dm._GP_ARGS)
    gp3 = load_kernel("dequant_gemv_gp3", dm._GP3_ARGS)
    names = {v: str(k).split(".")[-1] for k, v in dm.DTYPE_IDS.items()}
    bodies = ([(f"qsplit {names[d]} m={m}", ("int4", 4 if d == 2 else 2, m),
                lambda n, d=d, m=m: qs.mlc_gemv_qs_blocks(d, m, n))
               for d, m in [(0, 1), (1, 1)] + [(2, m) for m in range(1, 9)]]
              + [(f"{lay} {names[d]} m=1", ("int4", 4 if d == 2 else 2, 1),
                  lambda n, d=d, i=i: gp.mlc_gemv_gp_blocks(i, d, n))
                 for lay, i in dm.LAYOUT_IDS.items() for d in range(3)]
              + [(f"int3 {names[d]} m={m}", ("int3", 2, m),
                  lambda n, d=d, m=m: gp3.mlc_gemv_gp3_blocks(d, m, n))
                 for d in (0, 1) for m in (1, 2)])
    wrong = []
    for label, key, query in bodies:
        n = ctypes.c_int(0)
        err = query(ctypes.addressof(n))
        print(f"  stream_kernel {label}: {n.value} blocks an SM (STREAM_BLOCKS "
              f"{dm.STREAM_BLOCKS[key]}), cudaError {err}")
        if err or n.value != dm.STREAM_BLOCKS[key]:
            wrong.append(label)
    if wrong:
        fail(f"stream_plan prices these streaming bodies at the wrong blocks an SM: {wrong}")


def fail(msg: str):
    print(f"FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


COUNTED = {"gemv_qs": dm.gemv_qs, "gemm_qs": dm.gemm_qs, "gemv_gp": dm.gemv_gp,
           "gemm_pairs": dm.gemm_pairs, "gemv_gp3": dm.gemv_gp3, "gemm_plane": dm.gemm_plane,
           "paged_flash_decode": pa.paged_flash_decode, "flash_prefill": att.flash_prefill}


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


# kernel 8's cases: (label, B, query heads, kv-heads, S, D, dtype): a reset
# prefill at Vicuna-7B's buckets 1024 and 2048, the grouped admission at G =
# 2, the f16 body (q3f16_s16), and MOSS (D 256); the f32 body (q4f32 and
# f32 on Vicuna, MOSS) at the same shapes
FLASH_CASES = [
    ("vicuna", 1, 32, 32, 1024, 128, torch.bfloat16),
    ("vicuna", 1, 32, 32, 2048, 128, torch.bfloat16),
    ("vicuna G=2", 2, 32, 32, 1024, 128, torch.bfloat16),
    ("vicuna", 1, 32, 32, 1024, 128, torch.float16),
    ("moss", 1, MOSS.num_heads, MOSS.num_kv_heads, 1024, MOSS.head_dim, torch.bfloat16),
    ("vicuna", 1, 32, 32, 1024, 128, torch.float32),
    ("vicuna", 1, 32, 32, 2048, 128, torch.float32),
    ("vicuna G=2", 2, 32, 32, 1024, 128, torch.float32),
    ("moss", 1, MOSS.num_heads, MOSS.num_kv_heads, 1024, MOSS.head_dim, torch.float32),
]


def flash_bound(B, hq, hkv, S, D, esize, flops):
    """Least time (ms) of one causal flash prefill: q and o (hq heads) and
    k and v (hkv heads) moved once, against `flops` for the 2 * B * hq * S^2
    * D operations of the two causal products (half the square each)."""
    nbytes = (2 * hq + 2 * hkv) * B * S * D * esize
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * B * hq * S * S * D / flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_rows(gen, flush):
    """flash_prefill at each FLASH_CASES shape, q, k and v the strided views
    of one [B, S, (hq + 2 hkv) D] projection as the forward hands them
    over; the library yardstick is scaled_dot_product_attention(is_causal=
    True) on the same views (the port never calls it)."""
    rows = []
    for label, B, hq, hkv, S, D, dt in FLASH_CASES:
        qkv = torch.randn((B, S, (hq + 2 * hkv) * D), generator=gen, device="cuda").to(dt)
        q, k, v = (t.reshape(B, S, -1, D).transpose(1, 2)
                   for t in qkv.split([hq * D, hkv * D, hkv * D], dim=-1))

        def run_kernel():
            return att.flash_prefill(q, k, v)

        def run_plain():
            return att.flash_prefill_plain(q, k, v)

        def run_library():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, **({"enable_gqa": True} if hq != hkv else {}))

        got, want = run_kernel(), run_plain()
        lib = run_library()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        lib_err = (lib.float() - want.float()).abs().max().item()
        f32 = dt == torch.float32
        tol = F32_KERNEL_TOL if f32 else dict(atol=KERNEL_TOL, rtol=KERNEL_TOL)
        ok = got.dtype == dt and torch.allclose(got.float(), want.float(), **tol)
        esize = torch.empty((), dtype=dt).element_size()
        # the f32 body's products are 3xTF32 on the tensor cores
        b_ms, b_by = flash_bound(B, hq, hkv, S, D, esize,
                                 F32_3XTF32_FLOPS if f32 else BF16_FLOPS)
        dts = str(dt).replace("torch.", "")
        name = f"{label} b{B} S{S} D{D} {dts}"
        row = dict(kernel="flash_prefill", shape=name, dtype=dts, m=B * S, k=S, n=hq, d=D,
                   max_abs_err=err, ms=time_ms(run_kernel, flush, 20),
                   plain_ms=time_ms(run_plain, flush, 3),
                   library_ms=time_ms(run_library, flush, 20), bound_ms=b_ms, bound_by=b_by)
        if f32:  # the same work on the f32 FMA units, the CUDA-core bound
            row["bound_f32_fma_ms"] = flash_bound(B, hq, hkv, S, D, esize, F32_FMA_FLOPS)[0]
        row["tflops"] = 2 * B * hq * S * S * D / (row["ms"] * 1e-3) / 1e12
        row["vs_library"] = row["ms"] / row["library_ms"]
        print(f"  flash_prefill {name}: max_abs_err={err:.3g} (library vs plain {lib_err:.3g}) "
              f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
              f"library_ms={row['library_ms']:.4f} bound_ms={b_ms:.4f} ({b_by}"
              + (f"; f32 FMA {row['bound_f32_fma_ms']:.4f}" if f32 else "") + ") "
              f"{row['tflops']:.1f} TFLOP/s, {row['vs_library']:.2f}x library, "
              f"{row['ms'] / b_ms:.1f}x bound")
        if not ok:
            fail(f"flash_prefill {name} disagrees with its plain version (max {err})")
        rows.append(row)
        del qkv, q, k, v, got, want, lib
    return rows


def kernel_phase():
    print("== kernel phase (torch.backends.cuda.matmul.allow_tf32 = False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.ones(64 * 2**20, dtype=torch.float32, device="cuda")  # 256 MB
    rows = flash_rows(gen, flush) + matmul_rows(gen, flush) + paged_rows(gen, flush)
    del flush
    torch.cuda.empty_cache()
    return rows


# one m = 1 call of each streaming GEMV body (and gemv_gp3 at m = 2), at a
# w_in shape whose plan splits K (so the last part's combine runs): (label,
# spec, k, n, m)
ONE_LAUNCH_CASES = [
    ("gemv_qs bf16", "q4bf16", 4096, 22016, 1),
    ("gemv_qs f16", "q4f16", 2560, 10240, 1),
    ("gemv_qs f32", QSPLIT_F32, 2560, 10240, 1),
    *[(f"gemv_gp {lay} {dt}", dataclasses.replace(QUANT_PRESETS["q4f32"], layout=lay, dtype=dt),
       2560, 10240, 1) for lay in ("pair", "hsplit") for dt in ("bfloat16", "float16", "float32")],
    ("gemv_gp3 m=1", "q3bf16_s16", 4096, 22016, 1),
    ("gemv_gp3 m=2", "q3bf16_s16", 4096, 22016, 2),
    ("gemv_gp3 f16 m=1", "q3f16_s16", 4096, 22016, 1),
    ("gemv_gp3 f16 m=2", "q3f16_s16", 4096, 22016, 2),
]


def one_launch_phase():
    """Each case's call is one device kernel (torch.profiler), from two
    before the split parts were combined in the same launch."""
    from torch.profiler import ProfilerActivity, profile

    print("== one-launch phase (torch.profiler, CUDA activity)")
    gen = torch.Generator(device="cuda").manual_seed(3)
    for label, spec, k, n, m in ONE_LAUNCH_CASES:
        spec = resolve_spec(spec)
        w = pad_quantized_groups(quantize(
            torch.randn((k, n), generator=gen, device="cuda") * 0.02, spec))
        x = torch.randn((m, stored_k(w)), generator=gen, device="cuda").to(torch_dtype(spec.dtype))
        kname = dm.route(spec, w.n_groups, m)
        cols, parts, per = dm.stream_plan(
            "int3" if kname == "gemv_gp3" else spec.layout, m, stored_k(w), w.data.shape[1],
            x.element_size())
        call_kernel(kname, x, w, None, x.dtype)  # warm: the build and the tickets
        torch.cuda.synchronize()
        # a trace that holds no device activity at all measured nothing (the
        # call raises if its launch fails): it is taken again, up to 3 times
        for tries in range(1, 4):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                call_kernel(kname, x, w, None, x.dtype)
                torch.cuda.synchronize()
            names = [e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
            if names:
                break
        print(f"  {label} ({kname}, {parts} parts of {per} stages, {cols} columns a block): "
              f"{len(names)} device kernel(s) {names} (trace {tries})")
        if len(names) != 1:
            fail(f"{label}: one m = {m} call launched {len(names)} device kernels, not 1")
        del w, x


def card_vs_cpu(cfg, params, rtol=LOGIT_RTOL, steps=5):
    """A 64-token prefill and steps - 1 decode steps, the logits on the
    card (kernels) against the CPU's (plain versions)."""
    cpu = tree_map(lambda x: x.map(lambda t: t.cpu()) if isinstance(x, QuantizedTensor)
                   else x.cpu(), params)
    toks = torch.randint(3, cfg.vocab_size, (1, 64), generator=torch.Generator().manual_seed(1))
    caches = {"cuda": init_kv_cache(cfg, 1, 128, device="cuda"),
              "cpu": init_kv_cache(cfg, 1, 128, device="cpu")}
    for step in range(steps):
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


def paged_vs_slot(cfg, params, dtype=torch.bfloat16):
    """8 slots of mixed prompt lengths, prefill + 4 decode steps, on the
    card: paged logits against slot logits, both caches in `dtype` (bf16
    or f16; LOGIT_RTOL: the paged decode rounds its probabilities to the
    pages' type, the slot path to the activations' type), int8 paged
    against the `dtype` paged (INT8_LOGIT_RTOL). The paged decode runs
    kernel 7."""
    print(f"  paged vs slot: {cfg.name}, D = {cfg.head_dim}, {dtype} KV")
    B, ps = SERVE_BATCH, PAGE_SIZE
    lens = [5, 100, 127, 128, 129, 300, 700, 1000]
    S = 1024  # the prefill bucket
    rng = np.random.default_rng(1)
    toks = np.zeros((B, S), np.int64)
    for b, n in enumerate(lens):
        toks[b, :n] = rng.integers(3, cfg.vocab_size, n)
    table = np.arange(1, B * PAGED_WINDOW + 1, dtype=np.int32).reshape(B, PAGED_WINDOW)
    caches = {"slot": init_kv_cache(cfg, B, SERVE_SEQ, dtype=dtype, device="cuda")}
    for name, dt in (("paged", dtype), ("paged int8", torch.int8)):
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
    # the f16 presets (rows 4-6's f16 bodies) are held like q3bf16_s16: f16
    # rounds at 1/2048, within the bf16 share; q3f16_s16's paged decode
    # runs kernel 7 with f16 q over f16 pages. q3f16, fp4f16 and q8f16 (the
    # plane GEMM at every m) take the prefill and 2 decode steps: the CPU
    # side dequantizes every weight again at each step
    for quant in ("q4bf16", "q3bf16_s16", "q3f16_s16", "q3f16", "fp4f16", "q8f16"):
        print(f"== parity phase: 2-layer Vicuna-7B width, {quant}")
        params = pad_params(init_random_params(cfg, quant, seed=1, device="cuda"))
        card_vs_cpu(cfg, params, steps=3 if quant in ("q3f16", "fp4f16", "q8f16") else 5)
        if quant in ("q4bf16", "q3f16_s16"):
            paged_vs_slot(cfg, params, torch_dtype(resolve_spec(quant).dtype))
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


def hf_state_dict(cfg, seed: int):
    """An HF-layout state dict of cfg (Llama's or MOSS's names; MOSS's
    fused qkv_proj), f16 on the card, from a seed: weights N(0, 0.02),
    norm weights 1 + N(0, 0.1), biases N(0, 0.02)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    H, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size

    def rand(*shape, center=0.0, std=0.02):
        return (torch.randn(shape, generator=gen, device="cuda") * std + center).half()

    def norm(n):
        return rand(n, center=1.0, std=0.1)

    if cfg.family == "llama":
        sd = {"model.embed_tokens.weight": rand(V, H), "model.norm.weight": norm(H),
              "lm_head.weight": rand(V, H)}
        for i in range(cfg.num_layers):
            p = f"model.layers.{i}"
            sd.update({f"{p}.self_attn.{x}_proj.weight": rand(H, H) for x in "qkvo"})
            sd.update({f"{p}.mlp.gate_proj.weight": rand(F, H),
                       f"{p}.mlp.up_proj.weight": rand(F, H),
                       f"{p}.mlp.down_proj.weight": rand(H, F),
                       f"{p}.input_layernorm.weight": norm(H),
                       f"{p}.post_attention_layernorm.weight": norm(H)})
        return sd
    sd = {"transformer.wte.weight": rand(V, H), "transformer.ln_f.weight": norm(H),
          "transformer.ln_f.bias": rand(H), "lm_head.weight": rand(V, H), "lm_head.bias": rand(V)}
    for i in range(cfg.num_layers):
        p = f"transformer.h.{i}"
        sd.update({f"{p}.ln_1.weight": norm(H), f"{p}.ln_1.bias": rand(H),
                   f"{p}.attn.qkv_proj.weight": rand(3 * H, H),
                   f"{p}.attn.out_proj.weight": rand(H, H),
                   f"{p}.mlp.fc_in.weight": rand(F, H), f"{p}.mlp.fc_in.bias": rand(F),
                   f"{p}.mlp.fc_out.weight": rand(H, F), f"{p}.mlp.fc_out.bias": rand(H)})
    return sd


def flat_leaves(tree, prefix=""):
    """key -> tensor of every leaf (a QuantizedTensor's data, scale, zero),
    and key/spec -> (spec, logical shape) of every QuantizedTensor."""
    out = {}
    for k, node in tree.items():
        key = prefix + k
        if isinstance(node, dict):
            out.update(flat_leaves(node, key + "/"))
        elif isinstance(node, QuantizedTensor):
            out[f"{key}/spec"] = (node.spec, node.shape)
            out.update({f"{key}/{f}": t for f, t in (("data", node.data), ("scale", node.scale),
                                                     ("zero", node.zero)) if t is not None})
        else:
            out[key] = node
    return out


def unequal_leaves(a, b):
    """Keys of the leaves that differ between two param trees (in dtype,
    shape or any bit), or that only one of them has."""
    fa, fb = flat_leaves(a), flat_leaves(b)
    bad = sorted(set(fa) ^ set(fb))
    for k in set(fa) & set(fb):
        x, y = fa[k], fb[k]
        if isinstance(x, tuple):
            same = x == y
        else:
            same = x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y.to(x.device))
        if not same:
            bad.append(k)
    return bad


def compare_phase(cfg, q4bf16, q4f32):
    """debug.compare.compare_paths, card against CPU, at the JAX tool's
    atol 1e-2 / rtol 1e-3 on the JAX tool's 8 tokens. q4bf16: every matmul
    row must pass; its logits row is printed only, since bf16 activations
    between ops at full width move the logits further (a bf16 rounding
    tipped by an f32 sum in another order, amplified by the random layers;
    card_vs_cpu holds them to LOGIT_RTOL of the largest |logit|). q4f32
    (the same weights, f32 activations): every row must pass."""
    for quant, params in (("q4bf16", q4bf16), ("q4f32", pad_params(q4f32))):
        rows = compare_paths(cfg, params, [[1, 2, 3, 4, 5, 6, 7, 8]])
        for name, max_abs, ok in rows:
            print(f"  compare_paths {quant} {'OK ' if ok else 'DIFF'} {name}: "
                  f"max |diff| {max_abs:.3e}")
        held = rows if quant == "q4f32" else [r for r in rows if r[0].startswith("qmatmul")]
        if not all(ok for _, _, ok in held):
            fail(f"debug.compare.compare_paths {quant}: a row differs beyond its tolerance")


def hf_parity_phase():
    """HF-layout weights at full width, 2 layers: params_from_hf on the
    card and on the CPU must give bit-equal leaves (the quantizer on the
    card; build --device cuda relies on it). Then each model's logits card
    vs CPU, MOSS's paged cache vs its slot cache (kernel 7 at D = 256), and
    debug.compare on the Vicuna model (compare_phase)."""
    for cfg, seed in ((VICUNA.replace(num_layers=2), 11), (MOSS.replace(num_layers=2), 12)):
        print(f"== parity phase: HF-layout 2-layer {cfg.name}, q4bf16 from f16 weights")
        sd = hf_state_dict(cfg, seed)
        t0 = time.perf_counter()
        card = params_from_hf(sd, cfg, "q4bf16", device="cuda")
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        sd_cpu = {k: v.cpu() for k, v in sd.items()}
        t0 = time.perf_counter()
        cpu = params_from_hf(sd_cpu, cfg, "q4bf16", device="cpu")
        t_cpu = time.perf_counter() - t0
        del sd_cpu
        leaves = flat_leaves(card)
        bad = unequal_leaves(card, cpu)
        del cpu
        gc.collect()
        print(f"  params_from_hf: card {t_card:.2f} s, CPU {t_cpu:.2f} s; {len(leaves)} leaves, "
              f"{param_bytes(card)} bytes; unequal card vs CPU: {bad}")
        if bad or not all(t.device.type == "cuda" for k, t in leaves.items()
                          if not k.endswith("/spec")):
            fail(f"{cfg.name}: params_from_hf on the card differs from the CPU's: {bad}")
        card = pad_params(card)
        card_vs_cpu(cfg, card)
        if cfg.family == "moss":
            del sd
            paged_vs_slot(cfg, card)
        else:
            q4f32 = params_from_hf(sd, cfg, "q4f32", device="cuda")
            del sd
            compare_phase(cfg, card, q4f32)
            del q4f32
        del card
        gc.collect()
        torch.cuda.empty_cache()


# the kernel of each quantized matmul on the main paths, by preset: the
# layer matmuls of a prefill (m = the bucket), every matmul at m = 1 (b1
# decode, and the lm head of a prefill, which runs at its last position
# only), and every matmul of a b8 decode step (m = 8)
PATH_KERNELS = {"q4bf16": {"prefill": "gemm_qs", "m1": "gemv_qs", "m8": "gemv_qs"},
                "q3bf16_s16": {"prefill": "gemm_plane", "m1": "gemv_gp3", "m8": "gemm_plane"},
                "q3f16_s16": {"prefill": "gemm_plane", "m1": "gemv_gp3", "m8": "gemm_plane"},
                "q4f32": {"prefill": "gemm_pairs", "m1": "gemv_gp", "m8": "gemv_gp"},
                "q4f16_hs": {"prefill": "gemm_pairs", "m1": "gemv_gp", "m8": "gemv_gp"},
                # q4bf16 sharded over tp: repacked to the pair order
                "q4bf16 tp": {"prefill": "gemm_pairs", "m1": "gemv_gp", "m8": "gemv_gp"},
                # u4 planes reach no kernel: dequantize and multiply
                "q4bf16_plane": {"prefill": None, "m1": None, "m8": None}}


def expected_launches(quant, *, layers=VICUNA.num_layers, b1_steps=0, prefills=0,
                      b8_forwards=0, flash_prefills=0):
    """Launch counts a path implies: per prefill 4L layer matmuls and the
    lm head at m=1; per b1 decode step 4L + 1 matmuls at m=1; per b8
    decode forward 4L + 1 matmuls at m=8 and L paged decodes; per reset
    prefill of at least 1024 tokens on the slot cache (flash_prefills of
    the prefills) L flash attentions (kernel 8)."""
    k, L = PATH_KERNELS[quant], layers
    want = dict.fromkeys(COUNTED, 0)
    want["flash_prefill"] += L * flash_prefills
    for kname, n in ((k["prefill"], 4 * L * prefills),
                     (k["m1"], (4 * L + 1) * b1_steps + prefills),
                     (k["m8"], (4 * L + 1) * b8_forwards)):
        if kname is not None:
            want[kname] += n
    want["paged_flash_decode"] += L * b8_forwards
    return want


KV_NAMES = {torch.bfloat16: "bf16", torch.float16: "f16", torch.int8: "int8",
            torch.float32: "f32"}


# [non-finite logits, forwards] of finite_logits, on the card; never
# freed, since the decode graphs captured under finite_logits go on adding
# into it at every replay
_FINITE = []


@contextlib.contextmanager
def finite_logits(label):
    """Hold the logits of every forward the engine runs inside to be
    finite: each forward (every prefill, decode step and verify pass,
    inside its captured graph) adds its count of non-finite logits and one
    forward to two counters on the card (no host sync a step), read once
    at the end."""
    from mlc_llm_tpu_torch.engine import engine as engine_mod

    if not _FINITE:
        _FINITE.append(torch.zeros(2, dtype=torch.int64, device="cuda"))
    counts = _FINITE[0]
    counts.zero_()
    fwd_block, fwd_decode, fwd_verify = (engine_mod.forward_block, engine_mod.forward_decode,
                                         engine_mod.forward_verify)

    def count(logits):
        counts[0].add_((~torch.isfinite(logits)).sum())
        counts[1].add_(1)
        return logits

    engine_mod.forward_block = lambda *a, **kw: count(fwd_block(*a, **kw))
    engine_mod.forward_decode = lambda *a, **kw: count(fwd_decode(*a, **kw))
    engine_mod.forward_verify = lambda *a, **kw: count(fwd_verify(*a, **kw))
    try:
        yield
    finally:
        engine_mod.forward_block, engine_mod.forward_decode = fwd_block, fwd_decode
        engine_mod.forward_verify = fwd_verify
    bad, forwards = counts.tolist()
    print(f"  {label}: {forwards} forwards, {bad} non-finite logits")
    if bad or not forwards:
        fail(f"{label}: logits not finite")


@contextlib.contextmanager
def phase_seconds(name):
    t0 = time.perf_counter()
    yield
    print(f"-- {name}: {time.perf_counter() - t0:.1f} s")


def graph_stats(engine):
    """The engine's graphs: how many were captured, each one's warm-up +
    capture seconds, its program runs by kind, and the bytes of their
    shared pool."""
    secs = engine.programs.capture_seconds()
    return dict(graphs=engine.programs.count, replays=engine.programs.replays,
                runs=engine.programs.runs_by_kind(),
                capture_s={" ".join(map(str, k)): v
                           for k, v in sorted(secs.items(), key=lambda kv: str(kv[0]))},
                graph_pool_bytes=engine.programs.pool_bytes())


def flash_prefills_since(engine, mark, cfg):
    """The prefill programs run since `mark` that take kernel 8: a reset
    or fresh block (the key's flash flag) whose bucket and head dim pass
    the gate, on a cache that is not int8."""
    if engine.cache_dtype == torch.int8:
        return 0
    delta = collections.Counter(engine.programs.runs) - mark[0]
    return sum(n for key, n in delta.items() if key[0].startswith("prefill") and key[-1]
               and att.flash_prefill_supported(key[2], cfg.head_dim))


def program_mark(engine):
    """A mark of the engine's program runs (by key) and graph replays."""
    return collections.Counter(engine.programs.runs), engine.programs.replays


def runs_since(engine, mark, label):
    """The program runs since `mark`, by kind, with "forwards": the decode
    forwards they ran (a K-step block K). Fails unless every run was a
    graph replay."""
    runs0, replays0 = mark
    delta = collections.Counter(engine.programs.runs) - runs0
    if engine.programs.replays - replays0 != sum(delta.values()):
        fail(f"{label}: {sum(delta.values())} program runs, "
             f"{engine.programs.replays - replays0} graph replays")
    kinds = collections.Counter()
    for key, n in delta.items():
        kinds[key[0]] += n
        if key[0] in ("decode", "decode_k"):
            kinds["forwards"] += n * (key[2] if key[0] == "decode_k" else 1)
    return dict(kinds)


def chat_phase(params, quant="q4bf16", cache_dtype=torch.bfloat16, cfg=VICUNA,
               idle_share=False):
    """b1 chat: 3 greedy turns through ChatSession on the slot cache in
    cache_dtype, launch counts held to the path's and the logits of every
    forward finite. idle_share runs the first turn twice more, its graphs
    already captured, the second time under torch.profiler: the device
    idle share is 1 - its kernels' device time over the unprofiled
    rerun's wall."""
    kv = KV_NAMES[cache_dtype]
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
    mark = program_mark(engine)
    ttft, turn_s = [], []
    t0 = time.perf_counter()
    with finite_logits(f"{cfg.name} {quant} chat"):
        for prompt in prompts:
            before = engine.stats.prefill_time
            t_turn = time.perf_counter()
            reply = session.ask(prompt)
            turn_s.append(time.perf_counter() - t_turn)
            ttft.append((engine.stats.prefill_time - before) * 1e3)
            print(f"  USER: {prompt!r} -> {len(reply)} chars")
    wall = time.perf_counter() - t0
    launches = read_counters()
    runs = runs_since(engine, mark, f"{cfg.name} {quant} chat")
    # a turn re-encoded from position 0 at bucket >= 1024 is a flash reset
    # prefill (MOSS's long template at its 1024 bucket)
    flash = flash_prefills_since(engine, mark, cfg)
    steps = engine.stats.decode_tokens
    stats = dict(model=cfg.name, quant=quant, kv=kv, param_bytes=nbytes, prefill_ms=ttft,
                 decode_tok_s=engine.stats.decode_tps, decode_steps=steps,
                 step_wall_ms=engine.stats.decode_time / max(steps, 1) * 1e3, wall_s=wall,
                 **graph_stats(engine))
    print(f"  prefill ms per turn (TTFT less sampling): {[round(t, 2) for t in ttft]}; "
          f"decode {engine.stats.decode_tps:.2f} tok/s over {steps} steps; graphs "
          f"{stats['graphs']} (capture s {stats['capture_s']}), the turns' replays {runs}, "
          f"pool {stats['graph_pool_bytes']} bytes")
    if runs != {"prefill": len(prompts), "sample": len(prompts), "decode": steps,
                "forwards": steps}:
        fail(f"{len(prompts)} turns of {steps} decode steps ran the programs {runs}")
    want = expected_launches(quant, layers=cfg.num_layers, b1_steps=steps,
                             prefills=len(prompts), flash_prefills=flash)
    print(f"  launches: {launches} (want {want}; {flash} flash reset prefills)")
    if steps == 0 or launches != want:
        fail("launch counts do not match the chat path")
    if idle_share:
        def first_turn():
            engine.reset()
            ChatSession(engine, ByteTokenizer(), cfg, ChatConfig(
                temperature=0.0, max_gen_len=32, max_window_size=768)).ask(prompts[0])

        # the turn's graphs are captured by now: time it again, then profile it
        t0 = time.perf_counter()
        first_turn()
        turn_wall = time.perf_counter() - t0
        stats["device_ms"] = device_busy_ms(first_turn)
        stats["device_idle_share"] = 1 - stats["device_ms"] / (turn_wall * 1e3)
        print(f"  the first turn again, then under torch.profiler: {stats['device_ms']:.1f} ms "
              f"of kernels -> device idle share {stats['device_idle_share']:.4f} of its "
              f"{turn_wall:.3f} s wall")
    return launches, stats


# the flash chat's first turn: 1386 bytes of text, 1559 tokens with the
# vicuna template (ByteTokenizer: a token a byte), so the reset prefill runs
# the 2048 bucket
FLASH_TURN = " ".join(
    f"Paragraph {i}: the reset prefill attends over its own keys and values, tile by tile, "
    "with the online softmax kept in registers." for i in range(11))


def flash_logits_check(engine, cfg, label, n, seed=11, rtol=LOGIT_RTOL):
    """One reset prefill of n >= 1024 random tokens through the engine's
    program (a graph replay: kernel 8 once a layer), its logits held
    against the same block through forward_block(..., prefill_flash=False)
    run eagerly (attend over the cache), as a share of the largest |logit|,
    at LOGIT_RTOL: kernel 8 rounds p against its key tiles' running max
    and attend rounds the normalised probabilities, each to the compute
    type, and the random full-width layers amplify a rounding that goes the
    other way as they do card against CPU (4.2% there); f32 compute on an
    f32 cache rounds nothing to bf16 on either side and is held at
    F32_LOGIT_RTOL. Leaves the engine reset."""
    toks = [int(t) for t in np.random.default_rng(seed).integers(3, cfg.vocab_size, n)]
    engine.reset()
    reset_counters()
    got = engine.prefill([toks])
    torch.cuda.synchronize()
    counts = read_counters()
    launches = counts["flash_prefill"]
    bucket = engine.bucket_for(n)
    block = torch.zeros((1, bucket), dtype=torch.int64, device="cuda")
    block[0, :n] = torch.tensor(toks, device="cuda")
    engine.reset()
    want = forward_block(engine.params, cfg, block, engine.cache, None,
                         torch.zeros(1, dtype=torch.int64, device="cuda"),
                         torch.tensor([n], device="cuda"),
                         attn_window=engine.decode_window(bucket), prefill_flash=False)
    torch.cuda.synchronize()
    engine.reset()
    share = ((got - want).abs().max() / want.abs().max()).item()
    same_top = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    out = dict(tokens=n, bucket=bucket, flash_launches=launches, logit_share=share,
               argmax_equal=same_top, launches=counts)
    print(f"  {label}: a {n}-token reset prefill (bucket {bucket}) ran kernel 8 {launches} "
          f"times (want {cfg.num_layers}); its logits against attend's: {share:.4g} of max "
          f"|logit| (limit {rtol}), argmax equal {same_top}")
    if launches != cfg.num_layers or not torch.isfinite(got).all() or share > rtol:
        fail(f"{label}: the flash reset prefill did not run kernel 8 once a layer, or its "
             f"logits are not finite or differ from attend's")
    return out


def flash_chat_phase(params, cfg=VICUNA, quant="q4bf16"):
    """b1 chat on a bf16 slot cache whose first turn is a 1559-token
    prompt (the reset prefill at bucket 2048: kernel 8 once a layer), then
    a short append turn (attend over the history: no kernel 8), launch
    counts held to the path's and the logits of every forward finite; the
    program keys of the two prefills differ in their flash flag; then
    flash_logits_check on the same engine and the graph pool's bytes.
    Returns the launches, the stats and the engine (the dump phase's)."""
    print(f"== flash chat phase: {cfg.name} {quant}, bf16 slot cache, batch 1, a "
          f"{len(FLASH_TURN)}-byte first turn")
    engine = InferenceEngine(cfg, params, max_batch=1, max_seq_len=2048, device="cuda")
    session = ChatSession(engine, ByteTokenizer(), cfg,
                          ChatConfig(temperature=0.0, max_gen_len=16, max_window_size=2048))
    reset_counters()
    mark = program_mark(engine)
    per_turn, prefill_ms = [], []
    with finite_logits(f"{cfg.name} {quant} flash chat"):
        for prompt in (FLASH_TURN, "Thanks, bye."):
            before = engine.stats.prefill_time
            session.ask(prompt)
            prefill_ms.append((engine.stats.prefill_time - before) * 1e3)
            per_turn.append(read_counters()["flash_prefill"])
    launches = read_counters()
    runs = runs_since(engine, mark, f"{cfg.name} flash chat")
    steps = engine.stats.decode_tokens
    keys = sorted(k for k in engine.programs.keys if k[0] == "prefill")
    want = expected_launches(quant, layers=cfg.num_layers, b1_steps=steps, prefills=2,
                             flash_prefills=1)
    stats = dict(model=cfg.name, quant=quant, prefill_tokens=engine.stats.prefill_tokens,
                 prefill_ms=prefill_ms, flash_launches_by_turn=per_turn, decode_steps=steps,
                 prefill_keys=[list(k) for k in keys], **graph_stats(engine))
    print(f"  prefill ms per turn {[round(t, 2) for t in prefill_ms]}; kernel 8 launches after "
          f"each turn {per_turn}; prefill keys {keys}; runs {runs}; pool "
          f"{stats['graph_pool_bytes']} bytes; launches {launches} (want {want})")
    # the reset at bucket 2048 (window 2048) with the flag; the append
    # without it, at the history's window 2048
    if (per_turn != [cfg.num_layers] * 2 or launches != want
            or [k[-1] for k in keys] != [False, True] or keys[1][2:4] != (2048, 2048)
            or keys[0][3] != 2048
            or runs != {"prefill": 2, "sample": 2, "decode": steps, "forwards": steps}):
        fail("flash chat: kernel 8 did not run once a layer on the first turn only, or the "
             "turns' programs or launches are not the path's")
    check = flash_logits_check(engine, cfg, f"{cfg.name} {quant}", 1500)
    check.pop("launches")
    stats["logits"] = check
    return launches, stats, engine


FLASH_SCHED_LENS = (1500, 1800, 1024, 1300)  # buckets 2048, 2048, 1024, 2048


def flash_scheduler_phase(params, cfg=VICUNA):
    """The b8 slot scheduler admits four greedy requests of 1024-2000
    tokens: the first two together (a G = 2 grouped admission at bucket
    2048), the others one by one (buckets 1024 and 2048), each a flash
    prefill (kernel 8 once a layer a forward: 3L). Run on an engine that
    precompile() captured (no graph captured while serving, every run a
    replay), then on a fresh engine whose programs run eagerly: the
    streams are equal."""
    print(f"== flash scheduler phase: {cfg.name} q4bf16, b8 slot cache, 4 requests of "
          f"{FLASH_SCHED_LENS} tokens")
    rng = np.random.default_rng(7)
    work = [([int(t) for t in rng.integers(3, cfg.vocab_size, n)],
             GenerationConfig(max_new_tokens=16, temperature=0.0)) for n in FLASH_SCHED_LENS]
    outs, stats = {}, {}
    for mode in ("graph", "eager"):
        eng = InferenceEngine(cfg, params, max_batch=SERVE_BATCH, max_seq_len=SERVE_SEQ,
                              device="cuda")
        if mode == "graph":
            t0 = time.perf_counter()
            n = eng.precompile()
            stats["precompile_s"] = time.perf_counter() - t0
            stats["precompiled"] = n
            mark = program_mark(eng)
        else:
            eager_steps(eng)
        groups = []
        grouped = eng._prefill_slots
        eng._prefill_slots = lambda toks, *a, **kw: groups.append(toks.shape) or grouped(
            toks, *a, **kw)
        sched = ContinuousBatchingScheduler(eng, seed=0)
        reset_counters()
        t0 = time.perf_counter()
        reqs = [sched.submit(p, g) for p, g in work]
        sched.run()
        wall = time.perf_counter() - t0
        launches = read_counters()
        outs[mode] = [r.output for r in reqs]
        stats[f"{mode}_wall_s"] = wall
        stats[f"{mode}_launches"] = launches
        print(f"  {mode}: {wall:.2f} s, grouped admissions {groups}, kernel 8 launches "
              f"{launches['flash_prefill']} (want {3 * cfg.num_layers}), tokens "
              f"{[len(o) for o in outs[mode]]}")
        if launches["flash_prefill"] != 3 * cfg.num_layers or groups != [(2, 2048)]:
            fail(f"flash scheduler {mode}: kernel 8 launches or grouped admissions are not "
                 "the path's")
        if mode == "graph":
            runs = runs_since(eng, mark, "flash scheduler")
            stats.update(graph_stats(eng), runs_served=runs)
            print(f"  precompile captured {n} graphs in {stats['precompile_s']:.1f} s, pool "
                  f"{stats['graph_pool_bytes']} bytes; the run's replays {runs}")
            if eng.programs.count != n or runs.get("prefill_slots") != 3:
                fail(f"flash scheduler: a graph was captured while serving, or the run ran "
                     f"outside its graphs: {runs}")
            paths_launches = launches
        del eng, sched
        gc.collect()
        torch.cuda.empty_cache()
    print(f"  streams graph == eager: {outs['graph'] == outs['eager']}")
    if outs["graph"] != outs["eager"] or min(len(o) for o in outs["graph"]) < 1:
        fail("flash scheduler: the precompiled and eager streams differ")
    return paths_launches, stats


def flash_prefill_phase(params, cfg, quant, cache_dtype=torch.bfloat16, n=1100,
                        rtol=LOGIT_RTOL):
    """flash_logits_check on a b1 slot engine of cfg with a cache_dtype
    cache (MOSS: D = 256; q3f16_s16 on f16 KV: the f16 body; q4f32 on f32
    KV: the f32 body), and the dtype of q at each of the forward's kernel 8
    calls (made while the prefill's graph is captured)."""
    print(f"== flash prefill: {cfg.name} {quant}, {KV_NAMES[cache_dtype]} slot cache, batch 1")
    engine = InferenceEngine(cfg, params, max_batch=1, max_seq_len=min(cfg.max_seq_len, 2048),
                             cache_dtype=cache_dtype, device="cuda")
    dtypes, real = set(), tr.flash_prefill
    tr.flash_prefill = lambda q, k, v: dtypes.add(str(q.dtype)) or real(q, k, v)
    try:
        out = flash_logits_check(engine, cfg, f"{cfg.name} {quant}", n, rtol=rtol)
    finally:
        tr.flash_prefill = real
    out.update(graph_stats(engine), q_dtypes=sorted(dtypes))
    print(f"  kernel 8's q in the forward: {sorted(dtypes)}")
    del engine
    return out.pop("launches"), out


def checkpoint_phase(tmp):
    """build --random on the card into `tmp`, then load_params onto the
    card: every leaf on the card and bit-equal to the seed-0 draw. Returns
    the loaded params and the phase's numbers."""
    print(f"== checkpoint phase: {VICUNA.name} q4bf16, build --random --device cuda, "
          f"load_params(device='cuda') through the native reader ({checkpoint.READ_THREADS} "
          f"threads) and two pinned staging buffers of {checkpoint.STAGE_BYTES >> 20} MB")
    du = shutil.disk_usage(tmp)
    print(f"  {tmp}: {du.free / 1e9:.1f} GB free of {du.total / 1e9:.1f} GB")
    built = build.main(["--model", VICUNA.name, "--random", "--quantization", "q4bf16", "-o",
                        tmp, "--device", "cuda"])
    with open(f"{tmp}/manifest.json") as f:
        nbytes = json.load(f)["total_bytes"]
    t0 = time.perf_counter()
    params, meta = load_params(tmp, device="cuda")
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    # the same files again, now read once: their pages in the cache unless
    # the machine's memory gave them up
    t0 = time.perf_counter()
    again, _ = load_params(tmp, device="cuda")
    torch.cuda.synchronize()
    t_again = time.perf_counter() - t0
    del again
    leaves = flat_leaves(params)
    if not all(t.device.type == "cuda" for k, t in leaves.items() if not k.endswith("/spec")):
        fail("load_params(device='cuda') left a leaf off the card")
    ref = init_random_params(VICUNA, "q4bf16", seed=0, device="cuda")
    bad = unequal_leaves(params, ref)
    del ref
    torch.cuda.empty_cache()
    stats = dict(bytes=nbytes, leaves=len(leaves), params_s=built["params_s"],
                 write_s=built["write_s"], write_gb_s=nbytes / built["write_s"] / 1e9,
                 load_s=t_load, load_gb_s=nbytes / t_load / 1e9, load_again_s=t_again,
                 load_again_gb_s=nbytes / t_again / 1e9, read_threads=checkpoint.READ_THREADS,
                 stage_bytes=checkpoint.STAGE_BYTES, host_memory=host_memory(), meta=meta)
    print(f"  {json.dumps(stats)}")
    print("  (params_s: the seed-0 draw and quantization on the card; write_s: each leaf "
          "copied to the host and written; load_s: the files just written; load_again_s: "
          "read a second time; host_memory: this process's resident bytes and its cgroup's "
          "memory, whose limit decides whether the files stay in the page cache)")
    if bad or built["bytes"] != nbytes or meta.get("built_with") != "mlc_llm_tpu_torch.build":
        fail(f"checkpoint: loaded leaves differ from init_random_params(seed=0): {bad}")
    return params, stats


def host_memory():
    """This process's resident bytes and its cgroup's current and limit
    bytes (cgroup v2 files, read only; None where absent)."""
    def read(path, key=None):
        try:
            with open(path) as f:
                text = f.read()
        except OSError:
            return None
        if key is None:
            return text.strip()
        hit = re.search(rf"^{key}:\s+(\d+) kB", text, re.M)
        return int(hit.group(1)) * 1024 if hit else None

    return dict(rss=read("/proc/self/status", "VmRSS"),
                cgroup_current=read("/sys/fs/cgroup/memory.current"),
                cgroup_max=read("/sys/fs/cgroup/memory.max"))


def tools_phase(tmp):
    """The entry points on the checkpoint: the CLI (--weights, one-shot),
    ppl (its lm head at m = 512 on the flat gemm_qs) and evaluate
    (--profile). Returns {path: launches} and ppl's result."""
    paths = {}
    print("== cli --weights (in process)")
    out = io.StringIO()
    reset_counters()
    with contextlib.redirect_stdout(out):
        cli.main(["--model", VICUNA.name, "--weights", tmp, "--prompt", "hi", "--max-gen-len", "8",
                  "--temperature", "0"])
    paths["cli"] = read_counters()
    print(f"  stdout {out.getvalue()!r}; launches {paths['cli']}")
    # random weights mostly pick ids above the byte tokenizer's 256, which
    # decode to nothing: the reply may be empty, its newline is printed
    if not out.getvalue() or not paths["cli"]["gemv_qs"] or not paths["cli"]["gemm_qs"]:
        fail("cli --weights printed nothing or ran no kernel")

    print("== ppl --weights, window 512, stride 256, the 2048-token synthetic stream")
    # the kernel and m of every flat (unstacked) quantized matmul: the lm head
    flat = []
    dequant = mm.dequant_matmul

    def head_spy(x, w, out_dtype=None, layer=None):
        if layer is None:
            m = x.numel() // x.shape[-1]
            flat.append((dm.route(w.spec, w.n_groups, m), m))
        return dequant(x, w, out_dtype=out_dtype, layer=layer)

    reset_counters()
    mm.dequant_matmul = head_spy
    try:
        res = ppl.main(["--model", VICUNA.name, "--weights", tmp, "--window", "512",
                        "--stride", "256"])
    finally:
        mm.dequant_matmul = dequant
    paths["ppl"] = read_counters()
    windows = len(range(0, 2048 - 1, 256))
    want = dict.fromkeys(COUNTED, 0)
    want["gemm_qs"] = windows * (4 * VICUNA.num_layers + 1)
    print(f"  launches {paths['ppl']} (want {want}); flat matmuls (kernel, m): {flat}")
    if (not math.isfinite(res["perplexity"]) or paths["ppl"] != want
            or flat != [("gemm_qs", 512)] * windows):
        fail("ppl: perplexity not finite, or the launches are not the path's")

    print("== evaluate --weights --prompt-len 128 --gen-len 32 --profile")
    reset_counters()
    evaluate.main(["--model", VICUNA.name, "--weights", tmp, "--prompt-len", "128",
                   "--gen-len", "32", "--profile"])
    paths["evaluate"] = read_counters()
    print(f"  launches {paths['evaluate']}")
    gc.collect()
    torch.cuda.empty_cache()
    return paths, res


# the re-injection check's edit of csrc/dequant_gemv_qs.cu: the m = 1 body's
# asym group-sum offset (16, the codes' midpoint) off by one
GEMV_QS_EDIT = ("const float base = asym ? 16.f : 23.f;", "const float base = asym ? 17.f : 23.f;")


def dump_phase(engine, counted):
    """debug/dump.py on the flash chat engine: every program key it has
    (and JAX's three at bucket 128) dumped; each kernel wrapper a replay
    counted has its main kernels in that program's kernels.txt (as often
    as the counter says, or, where the profiler lost a record in each of
    its traces, one fewer in the whole program: printed; never more) and
    its source's .sass and .ptx;
    every csrc kernel the chat's launch counters counted appears in some
    kernels.txt.
    Then gemv_qs re-injected on the b1 decode program: an unchanged copy of
    its source gives the program's own logits bit for bit, an edited copy
    (GEMV_QS_EDIT) others; the engine's cache and counters are unchanged
    by all of it."""
    print("== dump phase: the flash chat engine's programs (debug/dump.py)")
    before = {k: t.clone() for k, t in dump._cache_tensors(engine.cache).items()}
    runs = dict(engine.programs.runs)
    reset_counters()
    outdir = tempfile.mkdtemp(prefix="chip_smoke_dump_")
    try:
        t0 = time.perf_counter()
        written = dump.dump_engine_programs(engine, outdir)
        dump_s = time.perf_counter() - t0
        keys = dump.engine_program_keys(engine)
        rows, seen, traces, lost = {}, collections.Counter(), {}, {}
        for name, key in keys.items():
            text = open(os.path.join(outdir, f"{name}.kernels.txt")).read()
            lines = re.findall(r"launches (\w+) (\w+) counter=(\d+) main_kernels=(\d+)", text)
            rows[name] = {w: (int(c), int(m)) for w, _, c, m in lines}
            traces[name] = int(re.search(r"trace (\d+) of", text).group(1))
            for w, src, c, m in lines:
                seen[src] += int(m)
                if int(m) < int(c):  # the profiler can lose a record, not invent one
                    lost[name] = lost.get(name, 0) + int(c) - int(m)
                if not 0 < int(m) <= int(c) or lost.get(name, 0) > 1 \
                        or f"{src}.sass" not in written or f"{src}.ptx" not in written:
                    mine = [ln for ln in text.splitlines() if f"  {src}" in ln]
                    fail(f"dump: {name} ({key}): {w} counted {c} launches, the trace holds "
                         f"{m} of {src}'s main kernels (records the program's trace lost: "
                         f"{lost.get(name, 0)}, at most 1 allowed; sass/ptx written: "
                         f"{f'{src}.sass' in written}/{f'{src}.ptx' in written}); its "
                         f"kernels in the trace: {mine}")
            for ext in ("ops.txt", "kernels.txt", "graph.dot"):
                if os.path.getsize(os.path.join(outdir, f"{name}.{ext}")) < 100:
                    fail(f"dump: {name}.{ext} is (nearly) empty")
        missing = [k for k in engine.programs.keys if k not in keys.values()]
        chat = [src for src, w in zip(KERNELS, COUNTED) if counted[w]]
        unseen = [src for src in chat if not seen[src]]
        print(f"  {len(keys)} programs ({sorted(keys)}), {len(written)} files in {dump_s:.1f} s; "
              f"per program, wrapper: (counter, main kernels in the trace) {rows}; the trace "
              f"kept (of up to {dump.TRACES}) {traces}; records it lost {lost}")
        if missing or unseen:
            fail(f"dump: keys not dumped {missing}; kernels the chat counted and no "
                 f"kernels.txt names {unseen}")
        name = next(n for n in keys if n.startswith("decode_w"))
        src = open(os.path.join(CSRC, "dequant_gemv_qs.cu")).read()
        if src.count(GEMV_QS_EDIT[0]) != 1:
            fail("dump: the re-injection edit's line is not in csrc/dequant_gemv_qs.cu once")
        same, edited = (os.path.join(outdir, f) for f in ("same.cu", "edited.cu"))
        with open(same, "w") as f:
            f.write(src)
        with open(edited, "w") as f:
            f.write(src.replace(*GEMV_QS_EDIT))
        t0 = time.perf_counter()
        want = dump.run_engine_program(engine, name)[0]
        got = dump.reinject_engine_program(engine, name, "gemv_qs", same)[0]
        other = dump.reinject_engine_program(engine, name, "gemv_qs", edited)[0]
        again = dump.run_engine_program(engine, name)[0]
        reinject_s = time.perf_counter() - t0
        diff = (other - want).abs().max().item()
        print(f"  re-injected gemv_qs on {name} ({keys[name]}): unchanged copy bit-equal "
              f"{torch.equal(got, want)}, edited copy max |diff| {diff:.4g}, the built "
              f"library after {torch.equal(again, want)} ({reinject_s:.1f} s)")
        if not (torch.equal(got, want) and torch.equal(again, want)) or not diff > 0 \
                or not torch.isfinite(other).all():
            fail("dump: re-injection of gemv_qs does not reproduce the program's logits from an "
                 "unchanged copy, or an edited copy does not change them")
        cache_same = all(torch.equal(t, before[k])
                         for k, t in dump._cache_tensors(engine.cache).items())
        if not cache_same or dict(engine.programs.runs) != runs or any(read_counters().values()):
            fail("dump: the engine's cache, program runs or launch counters changed")
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    return dict(programs=len(keys), files=len(written), dump_s=dump_s, reinject_s=reinject_s,
                edited_max_abs_diff=diff, counters=rows, traces=traces, lost_records=lost)


def tune_phase():
    """tune.tune_shapes on one Vicuna-7B shape (w_in) at m = 1 and 128 into
    a temporary table; with that table loaded each call launches the
    table's plan (a spy on launch_plan) and agrees with the plain version;
    with the table gone the plans are the time models' again."""
    print("== tune phase: tune_shapes(w_in 4096 x 22016, q4bf16, m = 1 and 128) into a "
          "temporary table")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    table_path = os.path.join(tmp, "tuned_plans.json")
    try:
        t0 = time.perf_counter()
        table = tune.tune_shapes([(4096, 22016)], "q4bf16", ms=(1, 128), reps=10, out=table_path)
        tune_s = time.perf_counter() - t0
        header, plans = dm.load_tuned_plans(table_path)
        print(f"  {len(table)} entries in {tune_s:.1f} s, header {header}")
        if header.get("card") != torch.cuda.get_device_name() or sorted(plans) != sorted(table):
            fail(f"tune: the table's header {header} or entries {sorted(plans)} are wrong")
        spec = resolve_spec("q4bf16")
        gen = torch.Generator(device="cuda").manual_seed(5)
        used, real = [], dm.launch_plan

        def spy(*a, **kw):
            used.append(real(*a, **kw))
            return used[-1]

        out = {}
        for m in (1, 128):
            case = tune.Case(spec, 4096, 22016, m, gen)
            entry = plans[case.key()]
            used.clear()
            dm.launch_plan = spy
            try:
                ok = case.check()
            finally:
                dm.launch_plan = real
            out[case.key()] = dict(entry, check=ok, launched=[list(p) for p in used])
            print(f"  {case.key()}: {json.dumps(entry)}; launched {used}, agrees {ok}")
            if used != [tuple(entry["plan"])] or not ok or not entry["model_ok"]:
                fail(f"tune: {case.key()} launched {used}, not the table's plan "
                     f"{entry['plan']}, or disagrees with the plain version")
            del case
    finally:
        dm.load_tuned_plans()
        shutil.rmtree(tmp, ignore_errors=True)
    key = dm.plan_key("gemm_qs", "qsplit", torch.bfloat16, 128, 4096, 22016)
    if dm.launch_plan("gemm_qs", "qsplit", torch.bfloat16, 128, 4096, 22016,
                      torch.cuda.get_device_name()) != dm.model_plan(
                          "gemm_qs", "qsplit", torch.bfloat16, 128, 4096, 22016):
        fail(f"tune: with no table {key} does not take the time models' plan")
    return dict(tune_s=tune_s, entries=out)


COORD_SEQ = 512


def coordinator_phase(params):
    """HostCoordinator over two engines on one params tree (b2, paged KV,
    precompiled): one local ContinuousBatchingScheduler, one behind
    SchedulerServer through RemoteScheduler on localhost. 8 greedy
    requests complete, 4 go to each host, and each host's streams equal
    its engine's scheduler run alone on the requests it received (paged
    admission is one request at a time and a decode step's rows are
    independent, so a request's stream does not depend on its company)."""
    print(f"== coordinator phase: {VICUNA.name} q4bf16, two engines on one params tree "
          f"(b2, paged, max_seq_len {COORD_SEQ}), a local host and one behind the wire")
    padded = pad_params(params)
    engines = [InferenceEngine(VICUNA, padded, max_batch=2, max_seq_len=COORD_SEQ,
                               kv_layout="paged", page_size=PAGE_SIZE, device="cuda")
               for _ in range(2)]
    leaves = [{k: t for k, t in flat_leaves(e.params).items() if not k.endswith("/spec")}
              for e in engines]
    shared = leaves[0].keys() == leaves[1].keys() and all(
        t.data_ptr() == leaves[1][k].data_ptr() for k, t in leaves[0].items())
    t0 = time.perf_counter()
    graphs = [e.precompile() for e in engines]
    pre_s = time.perf_counter() - t0
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(3, VICUNA.vocab_size, int(rng.integers(16, 400)))]
               for _ in range(8)]
    gen = GenerationConfig(max_new_tokens=32, temperature=0.0)
    server = SchedulerServer(ContinuousBatchingScheduler(engines[1])).start()
    remote = RemoteScheduler(("127.0.0.1", server.port), timeout=600)
    try:
        local = ContinuousBatchingScheduler(engines[0])
        coord = HostCoordinator([local, remote])
        reset_counters()
        t0 = time.perf_counter()
        reqs = [coord.submit(p, gen) for p in prompts]
        coord.run()
        wall = time.perf_counter() - t0
        launches = read_counters()
        text = coord.stats_text()
    finally:
        remote.close()
        server.stop()
    if server.error is not None:
        fail(f"coordinator: the remote scheduler failed:\n{server.error}")
    hosts = [[i for i, r in enumerate(reqs) if isinstance(r, RemoteRequest) == bool(h)]
             for h in (0, 1)]
    same = []
    for engine, idx in zip(engines, hosts):
        alone = ContinuousBatchingScheduler(engine)
        again = [alone.submit(prompts[i], gen) for i in idx]
        alone.run()
        same.append([reqs[i].output == a.output for i, a in zip(idx, again)])
    tokens = sum(len(r.output) for r in reqs)
    captured = [e.programs.count for e in engines]
    out = dict(requests=len(reqs), by_host=hosts, tokens=tokens, wall_s=wall,
               aggregate_tok_s=tokens / wall, precompiled=graphs, precompile_s=pre_s,
               graphs_after=captured, shared_params=shared, streams_equal_alone=same,
               stats_text=text, launches=launches)
    print(f"  {json.dumps(out)}")
    if (not shared or not all(r.done and not getattr(r, "error", None) for r in reqs)
            or [len(h) for h in hosts] != [4, 4] or not all(all(x) for x in same)
            or captured != graphs or tokens < 0.9 * 8 * 32):
        fail("coordinator: the hosts do not share the params, a request failed, the split is "
             "not 4 and 4, a graph was captured while serving, or a host's streams differ from "
             "its scheduler run alone")
    return out



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


SERVE_MULTI_STEP = "auto:4"  # the serve phase's --multi-step: K-step blocks of 2 and 4


def serve_phase(params):
    print(f"== serve phase: vicuna-v1-7b q4bf16, 32 layers, paged KV (page {PAGE_SIZE}), "
          f"max_batch {SERVE_BATCH}, max_seq_len {SERVE_SEQ}, multi_step {SERVE_MULTI_STEP!r}, "
          f"precompiled, SchedulerServer + RemoteScheduler")
    engine = InferenceEngine(VICUNA, params, max_batch=SERVE_BATCH, max_seq_len=SERVE_SEQ,
                             kv_layout="paged", page_size=PAGE_SIZE, device="cuda")
    # serve --precompile --multi-step auto:4
    t0 = time.perf_counter()
    n = engine.precompile(multi_step=multi_step_compile_ks(SERVE_MULTI_STEP))
    pre = dict(precompile_s=time.perf_counter() - t0, precompiled=n,
               precompile_pool_bytes=engine.programs.pool_bytes())
    print(f"  precompile: {n} graphs in {pre['precompile_s']:.2f} s, pool "
          f"{pre['precompile_pool_bytes']} bytes")
    if n != len(engine.precompile_keys(multi_step_compile_ks(SERVE_MULTI_STEP))) or \
            engine.programs.count != n:
        fail(f"serve: precompile captured {engine.programs.count} graphs, returned {n}")
    sched = ContinuousBatchingScheduler(engine, seed=0, multi_step=SERVE_MULTI_STEP)
    admitted = []
    prefill_slot = engine._prefill_slot

    def counted_prefill(*a, **kw):
        admitted.append(1)
        return prefill_slot(*a, **kw)

    engine._prefill_slot = counted_prefill
    server = SchedulerServer(sched).start()
    client = RemoteScheduler(("127.0.0.1", server.port), timeout=600)
    work = serve_requests()
    try:
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
        mark = program_mark(engine)
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
    runs = runs_since(engine, mark, "serve")
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
        prefill_s=st["prefill_time"], admissions=n_pre, serve_runs=runs, **pre,
        **graph_stats(engine))
    print(f"  {json.dumps(out)}")
    print(f"  launches: {launches} (want {want})")
    if forwards == 0 or launches != want:
        fail("launch counts do not match the serve path")
    if engine.programs.count != n:
        fail(f"serve: {engine.programs.count - n} graphs captured while serving")
    if (runs.get("prefill_slots") != n_pre or runs.get("sample") != n_pre
            or runs.get("forwards") != forwards or not runs.get("decode_k")):
        fail(f"serve: {n_pre} admissions and {forwards} decode forwards ran the programs "
             f"{runs}")
    # the same requests through a single-step scheduler on the same engine
    single = ContinuousBatchingScheduler(engine, seed=0)
    again = [single.submit(p, g) for p, g in work]
    single.run()
    if engine.programs.count != n:
        fail("serve: the single-step rerun captured a graph")
    same = [r.output == a.output for (r, _), a in zip(reqs, again)]
    sampled = [g.temperature > 0 for _, g in work]
    out["k_step_equals_single_step"] = same
    print(f"  K-step ({SERVE_MULTI_STEP}) streams == single-step streams: {same} "
          f"(sampled: {[i for i, x in enumerate(sampled) if x]})")
    if not all(same):
        fail("serve: K-step block streams differ from single-step streams")
    return launches, out


def eager_steps(engine):
    """Run the engine's programs without their graphs: the same program
    functions on the same fixed buffers, called directly at every run
    (what a CPU engine does)."""
    engine.programs.run = lambda key, fn, warm_up: fn()


def graph_phase(params):
    """Graphs against the same programs run eagerly: full-depth Vicuna
    q4bf16 at b1 (slot KV): the prefill logits bit for bit, 16 greedy
    tokens and a sampled stream (T 0.7, top-p 0.95, seed 5: each draw a
    function of (seed, step)) equal; then 8 greedy requests through the
    paged b8 scheduler at 2 layers on a precompiled engine (the run
    captures none)."""
    print("== graph phase: every program's graph against the eager program")
    prompt = [[VICUNA.bos_token_id] + list(b"Tell me about graphs.")]
    greedy = GenerationConfig(max_new_tokens=16, temperature=0.0)
    sampled = GenerationConfig(max_new_tokens=16, temperature=0.7, top_p=0.95, seed=5)
    toks, stats, logits = {}, {}, {}
    for mode in ("graph", "eager"):
        eng = InferenceEngine(VICUNA, params, max_batch=1, max_seq_len=1536, device="cuda")
        eng.cfg = VICUNA.replace(stop_tokens=())  # decode the full count
        if mode == "eager":
            eager_steps(eng)
        logits[mode] = eng.prefill(prompt)
        mark = program_mark(eng)
        for name, gen in (("greedy", greedy), ("sampled", sampled)):
            toks[mode, name] = eng.generate(prompt, gen)[0]
            # the step wall of a second run: the graphs were captured in the first
            eng.stats.reset()
            if eng.generate(prompt, gen)[0] != toks[mode, name]:
                fail(f"b1 {mode} {name}: a second run gave other tokens")
            stats[f"b1_{mode}_{name}_step_ms"] = (eng.stats.decode_time
                                                   / eng.stats.decode_tokens * 1e3)
        if mode == "graph":
            runs = runs_since(eng, mark, "b1 graph")
            print(f"  b1 graph runs over 4 generations: {runs}")
            if runs != {"prefill": 4, "sample": 4, "decode": 60, "forwards": 60}:
                fail(f"b1 graph: the generations ran the programs {runs}")
        del eng
    same_logits = torch.equal(logits["graph"], logits["eager"])
    print(f"  b1 full depth: prefill logits graph == eager: {same_logits}; greedy graph "
          f"{toks['graph', 'greedy']}, eager {toks['eager', 'greedy']}; sampled (T 0.7) graph "
          f"{toks['graph', 'sampled']}, eager {toks['eager', 'sampled']}; step wall of a "
          f"second run: greedy {stats['b1_graph_greedy_step_ms']:.3f} ms graph, "
          f"{stats['b1_eager_greedy_step_ms']:.3f} ms eager; sampled "
          f"{stats['b1_graph_sampled_step_ms']:.3f} ms graph, "
          f"{stats['b1_eager_sampled_step_ms']:.3f} ms eager")
    if not same_logits:
        fail("b1 graph and eager prefill logits differ")
    for name in ("greedy", "sampled"):
        if toks["graph", name] != toks["eager", name] or len(toks["graph", name]) != 16:
            fail(f"b1 graph and eager {name} tokens differ")
    cfg = VICUNA.replace(num_layers=2)
    small = init_random_params(cfg, "q4bf16", seed=0, device="cuda")
    work = serve_requests(8, sampled=lambda i: False)
    for mode in ("graph", "eager"):
        eng = InferenceEngine(cfg, small, max_batch=SERVE_BATCH, max_seq_len=SERVE_SEQ,
                              kv_layout="paged", page_size=PAGE_SIZE, device="cuda")
        if mode == "graph":
            t0 = time.perf_counter()
            n = eng.precompile()
            stats["precompile_s"] = time.perf_counter() - t0
            stats.update(graph_stats(eng))
            print(f"  b8 paged, 2 layers: precompile captured {n} graphs in "
                  f"{stats['precompile_s']:.2f} s (capture s {stats['capture_s']}), pool "
                  f"{stats['graph_pool_bytes']} bytes")
            if n != len(eng.precompile_keys()) or eng.programs.count != n:
                fail(f"precompile captured {eng.programs.count} graphs, returned {n}, "
                     f"want {len(eng.precompile_keys())}")
            mark = program_mark(eng)
        else:
            eager_steps(eng)
        sched = ContinuousBatchingScheduler(eng, seed=0)
        reqs = [sched.submit(p, g) for p, g in work]
        sched.run()
        toks[mode] = [r.output for r in reqs]
        if mode == "graph":
            runs = runs_since(eng, mark, "b8 paged graph run")
            if eng.programs.count != n or runs.get("prefill_slots") != len(work):
                fail(f"the precompiled b8 engine captured a graph while serving, or ran "
                     f"outside its graphs: {runs}")
    lens = [len(t) for t in toks["graph"]]
    print(f"  b8 paged scheduler: {sum(lens)} tokens {lens}, graph == eager: "
          f"{toks['graph'] == toks['eager']}")
    if toks["graph"] != toks["eager"] or min(lens) < 1:
        fail("b8 paged graph and eager greedy tokens differ")
    del small
    return stats


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
    mark = program_mark(engine)
    t0 = time.perf_counter()
    reqs = [sched.submit(p, g) for p, g in serve_requests()[:8]]
    sched.run()
    wall = time.perf_counter() - t0
    launches = read_counters()
    runs = runs_since(engine, mark, f"{quant} int8 auto run")
    want = expected_launches(quant, b8_forwards=engine.decode_forwards, prefills=len(admitted))
    stats = dict(quant=quant, tokens=sum(len(r.output) for r in reqs), wall_s=wall,
                 decode_tok_s=engine.stats.decode_tps, decode_forwards=engine.decode_forwards,
                 admissions=len(admitted), prefill_s=engine.stats.prefill_time,
                 **graph_stats(engine))
    print(f"  kv_layout={engine.kv_layout}, {stats['tokens']} tokens in {wall:.2f} s, "
          f"decode {engine.stats.decode_tps:.2f} tok/s over {engine.decode_forwards} forwards, "
          f"{len(admitted)} admissions, prefill {engine.stats.prefill_time:.2f} s")
    print(f"  launches: {launches} (want {want})")
    if not all(r.done and r.output for r in reqs):
        fail("int8 auto run: a request did not complete")
    if engine.decode_forwards == 0 or launches != want:
        fail("int8 auto run: launch counts do not match the path")
    if runs != {"prefill_slots": len(admitted), "sample": len(admitted),
                "decode": engine.decode_forwards, "forwards": engine.decode_forwards}:
        fail(f"int8 auto run: a prefill, draw or decode forward ran outside its graph: {runs}")
    return launches, stats


def device_busy_ms(fn) -> float:
    """Device time of fn's CUDA kernels (the sum of their self times
    under torch.profiler, CUDA activity only)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = [getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
          for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA")]
    return sum(us) / 1e3


def model_serve_phase(params, cfg, quant, idle_share=False, page_dtype=torch.bfloat16):
    """The paged continuous-batching server on a model: 8 requests in
    process (one sampled) through ContinuousBatchingScheduler over
    InferenceEngine(kv_layout="paged"), pages in page_dtype. Every b8
    decode forward runs its 4L layer matmuls and the lm head through the
    preset's kernel at m = 8 (gemv_gp for pair/hsplit, gemv_qs for qsplit,
    gemm_plane for int3/u16) and kernel 7 once a layer (D = 80 for the
    NeoX 3B, 128 for Vicuna, 256 for MOSS; q in the model's type); every
    admission its layer matmuls through the preset's GEMM and its lm head
    through its kernel at m = 1 (the GEMV; gemv_gp3 for int3/u16). The
    logits of every forward are held finite. With idle_share, the same
    requests run twice more, their graphs already captured, the second
    time under torch.profiler: the device idle share is 1 - their
    kernels' device time over the unprofiled rerun's wall."""
    print(f"== {cfg.name} {quant} serve: paged {KV_NAMES[page_dtype]} KV (page {PAGE_SIZE}), "
          f"max_batch {SERVE_BATCH}, max_seq_len {SERVE_SEQ}, in-process scheduler, 8 requests")
    engine = InferenceEngine(cfg, params, max_batch=SERVE_BATCH, max_seq_len=SERVE_SEQ,
                             cache_dtype=page_dtype, kv_layout="paged", page_size=PAGE_SIZE,
                             device="cuda")
    if engine.kv_layout != "paged" or engine.cache.k_pages.dtype != page_dtype:
        fail(f"{cfg.name} serve engine runs {engine.kv_layout} {engine.cache.k_pages.dtype} KV")
    sched = ContinuousBatchingScheduler(engine, seed=0)
    admitted = []
    prefill_slot = engine._prefill_slot

    def counted_prefill(*a, **kw):
        admitted.append(1)
        return prefill_slot(*a, **kw)

    engine._prefill_slot = counted_prefill
    # the (kernel, m) of every quantized matmul (route is a pure function
    # of the weight's format and m; the wrapper keeps its own launch count)
    kinds = PATH_KERNELS[quant]
    routed = []
    route = dm.route

    def route_rows(spec, n_groups, m):
        kind = route(spec, n_groups, m)
        routed.append((kind, m))
        return kind

    work = serve_requests(8, cfg.vocab_size, sampled=lambda i: i == 7)
    reset_counters()
    mark = program_mark(engine)
    dm.route = route_rows
    try:
        with finite_logits(f"{cfg.name} {quant} serve"):
            t0 = time.perf_counter()
            reqs = [sched.submit(p, g) for p, g in work]
            sched.run()
            wall = time.perf_counter() - t0
    finally:
        dm.route = route
    launches = read_counters()
    runs = runs_since(engine, mark, f"{cfg.name} serve")
    forwards, n_pre, L = engine.decode_forwards, len(admitted), cfg.num_layers
    want = expected_launches(quant, layers=L, b8_forwards=forwards, prefills=n_pre)
    lens = [len(r.output) for r in reqs]
    stats = dict(model=cfg.name, quant=quant, requests=len(reqs), tokens=sum(lens), wall_s=wall,
                 decode_tok_s=engine.stats.decode_tps, decode_forwards=forwards,
                 step_wall_ms=engine.stats.decode_time / max(forwards, 1) * 1e3,
                 admissions=n_pre, prefill_s=engine.stats.prefill_time, **graph_stats(engine))
    print(f"  {json.dumps(stats)}")
    # route runs in Python only at each graph's warm-up step and capture (a
    # replay runs no Python): a decode graph routes its 4L + 1 matmuls at m
    # = 8, an admission graph its layer matmuls at m = its bucket and its
    # lm head at m = 1
    graphs = collections.Counter(k[0] for k in engine.programs.capture_seconds())
    traced = 2 * graphs["decode"]
    m8 = routed.count((kinds["m8"], SERVE_BATCH))
    m1 = routed.count((kinds["m1"], 1))
    # m = 8 is a b8 decode, m = 1 a prefill's lm head, any other m a prefill
    stray = sorted({(k, m) for k, m in routed
                    if k != {SERVE_BATCH: kinds["m8"], 1: kinds["m1"]}.get(m, kinds["prefill"])})
    print(f"  launches: {launches} (want {want}); routed to {kinds['m8']} at m = 8: {m8} "
          f"(want {(4 * L + 1) * traced}: {graphs['decode']} decode graphs, each warmed up "
          f"and captured), to {kinds['m1']} at m = 1: {m1} (want "
          f"{2 * graphs['prefill_slots']}: {graphs['prefill_slots']} admission graphs); "
          f"runs {runs}")
    if not all(r.done and r.output for r in reqs) or min(lens) < 1:
        fail(f"{cfg.name} serve: bad completions {lens}")
    if forwards == 0 or launches != want or runs != {
            "prefill_slots": n_pre, "sample": n_pre, "decode": forwards, "forwards": forwards}:
        fail(f"{cfg.name} serve: launch counts or program runs do not match the path")
    if m8 != (4 * L + 1) * traced or m1 != 2 * graphs["prefill_slots"] or stray:
        fail(f"{cfg.name} serve: matmuls routed off the path's kernels: {stray}")
    if idle_share:
        def rerun():
            again = ContinuousBatchingScheduler(engine, seed=0)
            for p, g in work:
                again.submit(p, g)
            again.run()

        # the run's graphs are captured by now: time it again, then profile it
        t0 = time.perf_counter()
        rerun()
        rerun_wall = time.perf_counter() - t0
        stats["device_ms"] = device_busy_ms(rerun)
        stats["device_idle_share"] = 1 - stats["device_ms"] / (rerun_wall * 1e3)
        print(f"  the same requests again, then under torch.profiler: {stats['device_ms']:.1f} "
              f"ms of kernels -> device idle share {stats['device_idle_share']:.4f} of the "
              f"{rerun_wall:.3f} s wall")
    return launches, stats


# the speculation phase: scripts/spec_bench.py's repetitive prompt (a
# cycled 8-token motif the drafter can hit), the b1 verify width and the
# scheduler's
SPEC_MOTIF = ([311, 42, 87, 1009, 55, 7, 66, 23] * 8)[:64]
SPEC_K, SPEC_TOKENS, SCHED_SPEC_K = 8, 64, 4


class NoDraft(speculative.NgramDrafter):
    """The no-draft stream's drafter: every pass carries t_last alone,
    padded to K, so every token comes from the same m = K program."""

    def propose(self, k):
        return []


class CountingDrafter(speculative.NgramDrafter):
    """The prompt-lookup drafter, counting the draft tokens it proposes."""

    proposed = 0

    def propose(self, k):
        out = super().propose(k)
        CountingDrafter.proposed += len(out)
        return out


class ReplayDrafter(speculative.NgramDrafter):
    """Proposes the next tokens of a reference stream (refs: prompt tuple ->
    the tokens generated after it, the no-draft stream's), so that drafts
    are accepted wherever the verify pass agrees with its no-draft run: on
    random full-width weights the prompt-lookup drafter finds next to
    nothing to propose (the output does not repeat), and this exercises the
    accepted-draft path at full depth."""

    refs = {}

    def __init__(self, history, max_ngram=3):
        super().__init__(history, max_ngram)
        keys = sorted(self.refs, key=len, reverse=True)
        key = next((k for k in keys if tuple(self.history[:len(k)]) == k), ())
        self.prompt_len, self.ref = len(key), self.refs.get(key, [])

    def propose(self, k):
        n = len(self.history) - self.prompt_len
        return list(self.ref[n:n + k])


@contextlib.contextmanager
def drafter(cls):
    orig = speculative.NgramDrafter
    speculative.NgramDrafter = cls
    try:
        yield
    finally:
        speculative.NgramDrafter = orig


def record_verify(engine):
    """Keep the logits of every K > 1 verify pass the engine runs, and of
    its last decode step in engine.last_step_logits (copies of the graph's
    outputs, which the next replay overwrites). Returns the list the
    verify logits go into."""
    kept = []
    run = engine.programs.run

    def spy(key, fn, warm_up):
        out = run(key, fn, warm_up)
        if key[0] == "verify" and key[2] > 1:
            kept.append(out[0].clone())
        elif key[0] == "decode":
            engine.last_step_logits = out[0].clone()
        return out

    engine.programs.run = spy
    return kept


def tag_b1(stream, kept, sink):
    """Yield a b1 speculative stream's tokens, appending (token, logits
    row it came from) to sink: the first token is the prefill's (None),
    then row j of the pass that emitted it as its j-th token."""
    seen, row = 0, 0
    try:
        for tok in stream:
            n = len(kept)
            row = row + 1 if n == seen else 0
            sink.append((tok, kept[-1][0, row] if n else None))
            seen = n
            yield tok
    finally:
        stream.close()


def tag_scheduler(sched, kept):
    """Record (token, logits row) per request of a scheduler: a verify
    pass's tokens from its [B, K] logits (row j of the slot for its j-th
    token of the pass), a plain step's from that step's [B, V] logits (the
    drain pops its entry in dispatch order), a first token as None.
    Returns {request id: [(token, row)]}."""
    rec, state, steps = {}, {"src": None, "rows": {}}, deque()

    class Tap(deque):
        def popleft(self):
            owners = super().popleft()
            state["src"] = ("first",) if isinstance(owners, tuple) else ("step",
                                                                          steps.popleft())
            return owners

    sched._pending_slots = Tap(sched._pending_slots)
    emit, dispatch, spec = sched._emit, sched._decode_dispatch, sched._decode_dispatch_speculative

    def tagged_emit(req, tok):
        src = state["src"]
        if src[0] == "verify":
            j = state["rows"].get(req.id, 0)
            state["rows"][req.id] = j + 1
            row = kept[-1][req.slot, j]
        else:
            row = src[1][req.slot] if src[0] == "step" else None
        rec.setdefault(req.id, []).append((tok, row))
        return emit(req, tok)

    def tagged_dispatch(k_steps=None):
        dispatch(k_steps)
        steps.append(sched.engine.last_step_logits)

    def tagged_spec():
        state["src"], state["rows"] = ("verify",), {}
        spec()

    sched._emit, sched._decode_dispatch = tagged_emit, tagged_dispatch
    sched._decode_dispatch_speculative = tagged_spec
    return rec


def match_len(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))


def hold_to_no_draft(label, got, want):
    """A speculative stream against its no-draft stream, as lists of
    (token, logits row). Equal token for token, or else the rule fixed in
    advance: the first divergence d falls where the no-draft logits' top-2
    gap is within the largest difference measured between the two
    streams' logits at the positions 1..d, computed on the same tokens.
    Returns the match length."""
    a, b = [t for t, _ in got], [t for t, _ in want]
    if a == b:
        return len(a)
    d = match_len(a, b)
    if d == 0 or d >= min(len(a), len(b)):
        fail(f"{label}: speculative {a} and no-draft {b} streams differ at {d}")
    diff = max((got[i][1].float() - want[i][1].float()).abs().max().item()
               for i in range(1, d + 1))
    top2 = torch.topk(want[d][1].float(), 2).values
    gap = (top2[0] - top2[1]).item()
    print(f"  {label}: streams diverge at token {d}: no-draft top-2 gap {gap:.4g}, largest "
          f"logit difference over positions 1..{d} {diff:.4g}")
    if gap > diff:
        fail(f"{label}: the divergence at {d} is no argmax tie (gap {gap} > {diff})")
    return d


def verify_capture_stats(engine):
    secs = engine.programs.capture_seconds()
    return {str(k[1:]): v for k, v in sorted(secs.items(), key=lambda kv: str(kv[0]))}


def spec_b1_phase(params):
    """(a) b1 slot KV, full depth: the motif prompt through
    speculative_stream at K = 8 with a drafter that proposes nothing (the
    no-draft stream, the reference), with the prompt-lookup drafter, and
    with a drafter that replays the no-draft stream (every draft that the
    verify pass agrees with is accepted), the plain graph-replayed generate
    beside them; then 2 greedy chat turns through
    ChatSession(speculative_k=8) with the same three drafters. Launch
    counts held: every K-wide pass 4L + 1 gemv_qs calls (m = 8), every K =
    1 pass or stop feed the same at m = 1, every prefill 4L gemm_qs calls
    and its lm head on gemv_qs."""
    L = VICUNA.num_layers
    print(f"== speculation phase (a): {VICUNA.name} q4bf16, {L} layers, bf16 slot KV, batch 1, "
          f"K = {SPEC_K}, the motif prompt ({len(SPEC_MOTIF)} tokens), {SPEC_TOKENS} tokens")
    cfg = VICUNA.replace(stop_tokens=())  # decode the full count

    def fresh():
        eng = InferenceEngine(VICUNA, params, max_batch=1, max_seq_len=1536, device="cuda")
        eng.cfg = cfg
        return eng

    out, paths = {}, {}
    plain_eng = fresh()
    gen = GenerationConfig(max_new_tokens=SPEC_TOKENS, temperature=0.0)
    plain = plain_eng.generate([SPEC_MOTIF], gen)[0]
    plain_eng.stats.reset()
    t0 = time.perf_counter()
    if plain_eng.generate([SPEC_MOTIF], gen)[0] != plain:
        fail("spec b1: a second plain run gave other tokens")
    out["plain_tok_s"] = SPEC_TOKENS / (time.perf_counter() - t0)
    out["plain_step_ms"] = plain_eng.stats.decode_time / plain_eng.stats.decode_tokens * 1e3
    del plain_eng
    runs = {}
    for name, cls in (("no-draft", NoDraft), ("spec", CountingDrafter),
                      ("replay", ReplayDrafter)):
        eng = fresh()
        kept = record_verify(eng)
        stats, sink = {}, []
        CountingDrafter.proposed = 0
        reset_counters()
        with drafter(cls):
            list(tag_b1(speculative.speculative_stream(eng, SPEC_MOTIF, SPEC_TOKENS, SPEC_K,
                                                       stats=stats), kept, sink))
        launches = read_counters()
        want = expected_launches("q4bf16", b1_steps=eng.verify_forwards, prefills=1)
        print(f"  {name}: {stats}, verify runs {eng.verify_forwards}, replays "
              f"{eng.programs.replays}, graphs {eng.programs.count}; launches {launches} "
              f"(want {want})")
        if launches != want:
            fail(f"spec b1 {name}: launch counts do not match the path")
        ran = runs_since(eng, (collections.Counter(), 0), f"spec b1 {name}")
        if ran != {"prefill": 1, "verify": eng.verify_forwards} or not (
                0 <= eng.verify_forwards - stats["passes"] <= 1):
            fail(f"spec b1 {name}: the programs {ran} for {stats['passes']} passes")
        if len(sink) != SPEC_TOKENS or stats["passes"] >= len(sink):
            fail(f"spec b1 {name}: {len(sink)} tokens in {stats['passes']} passes")
        if name == "no-draft":
            ReplayDrafter.refs = {tuple(SPEC_MOTIF): [t for t, _ in sink]}
        else:
            out[f"{name}_match_no_draft"] = hold_to_no_draft(f"spec b1 {name}", sink,
                                                             runs["no-draft"][0])
        runs[name] = (sink, stats)
        out[name] = dict(stats, verify_runs=eng.verify_forwards)
        if name == "spec":
            out["spec"]["proposed_drafts"] = CountingDrafter.proposed
            out.update(graphs=eng.programs.count, capture_s=verify_capture_stats(eng))
            paths["spec_b1"] = launches
        # the wall of a rerun, its graphs captured
        tokens = [t for t, _ in sink]
        eng.stats.reset()
        t0 = time.perf_counter()
        with drafter(cls):
            again = speculative.generate_speculative(eng, SPEC_MOTIF, SPEC_TOKENS, SPEC_K)
        wall = time.perf_counter() - t0
        if again != tokens:
            fail(f"spec b1 {name}: a second run gave other tokens")
        out[name].update(tok_s=SPEC_TOKENS / wall,
                         verify_pass_ms=eng.stats.decode_time / stats["passes"] * 1e3,
                         tokens_per_pass=(len(tokens) - 1) / stats["passes"],
                         accepted_share_of_tokens=stats["accepted_drafts"] / (len(tokens) - 1),
                         match_plain=match_len(tokens, plain),
                         vs_plain=SPEC_TOKENS / wall / out["plain_tok_s"])
        del eng
        torch.cuda.empty_cache()
    replay = runs["replay"][1]
    if replay["accepted_drafts"] == 0 or replay["passes"] >= runs["no-draft"][1]["passes"]:
        fail(f"spec b1 replay: no draft accepted at full depth ({replay})")
    out["spec"]["accepted_share_of_proposed"] = out["spec"]["accepted_drafts"] / max(
        out["spec"]["proposed_drafts"], 1)
    # 2 greedy chat turns: the no-draft session, the prompt-lookup one and
    # the one that replays the no-draft turns
    turns = ["Repeat after me: one two three, one two three, one two three.", "Again, please."]
    chats, refs = {}, {}
    for name, cls in (("no-draft", NoDraft), ("spec", speculative.NgramDrafter),
                      ("replay", ReplayDrafter)):
        eng = InferenceEngine(VICUNA, params, max_batch=1, max_seq_len=1536, device="cuda")
        kept = record_verify(eng)
        session = ChatSession(eng, ByteTokenizer(), VICUNA,
                              ChatConfig(temperature=0.0, max_gen_len=32, max_window_size=768),
                              speculative_k=SPEC_K)
        sinks, prompts = [], []
        inner = session._speculative_tokens

        def tagged(toks, g, inner=inner, kept=kept, sinks=sinks, prompts=prompts):
            sinks.append([])
            prompts.append(tuple(toks))
            return tag_b1(inner(toks, g), kept, sinks[-1])

        session._speculative_tokens = tagged
        ReplayDrafter.refs = refs
        reset_counters()
        t0 = time.perf_counter()
        with drafter(cls), finite_logits(f"spec chat {name}"):
            replies = [session.ask(t) for t in turns]
        chat_wall = time.perf_counter() - t0
        launches = read_counters()
        want = expected_launches("q4bf16", b1_steps=eng.verify_forwards, prefills=len(turns))
        print(f"  chat {name}: {[len(r) for r in replies]} chars, {eng.verify_forwards} verify "
              f"runs, {eng.programs.replays} replays, {chat_wall:.3f} s; launches {launches} "
              f"(want {want})")
        ran = runs_since(eng, (collections.Counter(), 0), f"spec chat {name}")
        if len(sinks) != len(turns) or launches != want or ran != {
                "prefill": len(turns), "verify": eng.verify_forwards}:
            fail(f"spec chat {name}: the turns did not run the speculative path's counts "
                 f"({ran})")
        chats[name] = sinks
        out[f"chat_{name}_verify_runs"] = eng.verify_forwards
        if name == "no-draft":
            refs = {p: [t for t, _ in sink] for p, sink in zip(prompts, sinks)}
        else:
            out[f"chat_{name}_match_no_draft"] = [
                hold_to_no_draft(f"spec chat {name} turn {i}", g, w)
                for i, (g, w) in enumerate(zip(sinks, chats["no-draft"]))]
        if name == "spec":
            paths["spec_chat"] = launches
        del eng, session
        torch.cuda.empty_cache()
    out["chat_tokens"] = [len(g) for g in chats["no-draft"]]
    out["card"] = card_name()
    if out["chat_replay_verify_runs"] >= out["chat_no-draft_verify_runs"]:
        fail("spec chat replay: no draft accepted in the session's turns")
    print(f"  {json.dumps(out)}")
    return paths, out


def spec_scheduler_phase(params):
    """(b) The b8 slot scheduler with speculative_k=4: two greedy requests
    (the motif prompt and an arbitrary one), then after 3 verify passes a
    sampled request (the switch to the plain pipeline and back). Run with
    a drafter that proposes nothing (the reference), the prompt-lookup
    drafter and one that replays the reference's streams; each greedy
    stream is held to the reference's; a verify pass is 4L + 1 gemm_qs
    calls at m = 32 (the layers and the flat lm head); the plain scheduler
    gives the b8 step wall."""
    L = VICUNA.num_layers
    print(f"== speculation phase (b): {VICUNA.name} q4bf16, {L} layers, slot KV, max_batch "
          f"{SERVE_BATCH}, max_seq_len {SERVE_SEQ}, speculative_k {SCHED_SPEC_K}")
    rng = np.random.default_rng(5)
    arbitrary = [int(t) for t in rng.integers(3, VICUNA.vocab_size, 100)]
    greedy = GenerationConfig(max_new_tokens=48, temperature=0.0)
    sampled = GenerationConfig(max_new_tokens=8, temperature=0.7, top_p=0.95, seed=11)
    eng = InferenceEngine(VICUNA, params, max_batch=SERVE_BATCH, max_seq_len=SERVE_SEQ,
                          device="cuda")
    eng.cfg = VICUNA.replace(stop_tokens=())
    if eng.kv_layout != "slot":
        fail("the speculative scheduler needs slot KV")
    prefills = []
    one, group = eng._prefill_slot, eng._prefill_slots
    eng._prefill_slot = lambda *a, **kw: prefills.append(1) or one(*a, **kw)
    eng._prefill_slots = lambda *a, **kw: prefills.append(1) or group(*a, **kw)
    out, runs, paths = {}, {}, {}
    run = eng.programs.run
    for name, cls in (("no-draft", NoDraft), ("spec", speculative.NgramDrafter),
                      ("replay", ReplayDrafter)):
        eng.reset()
        eng.programs.run = run
        kept = record_verify(eng)
        sched = ContinuousBatchingScheduler(eng, seed=0, speculative_k=SCHED_SPEC_K)
        rec = tag_scheduler(sched, kept)
        pass_s = []
        spec = sched._decode_dispatch_speculative

        def timed(spec=spec, pass_s=pass_s):
            t0 = time.perf_counter()
            spec()
            pass_s.append(time.perf_counter() - t0)

        sched._decode_dispatch_speculative = timed
        v0, d0, prefills[:] = eng.verify_forwards, eng.decode_forwards, []
        reset_counters()
        with drafter(cls), finite_logits(f"spec scheduler {name}"):
            reqs = [sched.submit(SPEC_MOTIF, greedy), sched.submit(arbitrary, greedy)]
            while len(pass_s) < 3 and sched.has_work():
                sched.step()
            reqs.append(sched.submit(SPEC_MOTIF[:20], sampled))
            sched.run()
        launches = read_counters()
        passes, steps = eng.verify_forwards - v0, eng.decode_forwards - d0
        want = dict.fromkeys(COUNTED, 0)
        want["gemm_qs"] = (4 * L + 1) * passes + 4 * L * len(prefills)
        want["gemv_qs"] = (4 * L + 1) * steps + len(prefills)
        print(f"  {name}: {passes} verify passes, {steps} plain b8 steps, {len(prefills)} "
              f"prefills, outputs {[len(r.output) for r in reqs]}; launches {launches} "
              f"(want {want})")
        if launches != want or passes == 0 or steps == 0:
            fail(f"spec scheduler {name}: launch counts do not match the path, or a mode "
                 "never ran")
        if not all(r.done and r.output for r in reqs) or any(
                len(r.output) != 48 for r in reqs[:2]):
            fail(f"spec scheduler {name}: bad completions")
        runs[name] = (rec, reqs)
        out[name] = dict(passes=passes, plain_steps=steps,
                         pass_wall_ms=float(np.median(pass_s)) * 1e3)
        if name == "no-draft":
            ReplayDrafter.refs = {tuple(r.prompt): list(r.output) for r in reqs[:2]}
        else:
            nrec, nreqs = runs["no-draft"]
            out[name]["match_no_draft"] = [
                hold_to_no_draft(f"spec scheduler {name} request {i}", rec[r.id], nrec[n.id])
                for i, (r, n) in enumerate(zip(reqs[:2], nreqs[:2]))]
        if name == "spec":
            paths["spec_sched"] = launches
            out.update(tokens=sum(len(r.output) for r in reqs[:2]),
                       capture_s=verify_capture_stats(eng))
    if out["replay"]["passes"] >= out["no-draft"]["passes"]:
        fail(f"spec scheduler replay: no draft accepted ({out['replay']})")
    del runs, rec
    eng.programs.run = run
    # the plain scheduler on the same requests: its b8 step wall, the
    # second run's (the first captures the graphs)
    for i in range(2):
        eng.reset()
        eng.stats.reset()
        d0 = eng.decode_forwards
        sched = ContinuousBatchingScheduler(eng, seed=0)
        for p, g in ((SPEC_MOTIF, greedy), (arbitrary, greedy), (SPEC_MOTIF[:20], sampled)):
            sched.submit(p, g)
        sched.run()
    out["plain_step_wall_ms"] = eng.stats.decode_time / (eng.decode_forwards - d0) * 1e3
    out["pass_vs_plain_step"] = out["spec"]["pass_wall_ms"] / out["plain_step_wall_ms"]
    out["card"] = card_name()
    print(f"  {json.dumps(out)}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return paths, out


# ---------------------------------------------------------------- tensor parallelism
# (a) tp = 2 over gloo: two child processes (this script with --tp-rank),
# both ranks on the one card; (b) tp = 1 over NCCL in this process.
TP_WORLD = 2
# the TP chat's first turn: 7 paragraphs, about 1060 tokens with the
# vicuna template (ByteTokenizer: a token a byte), a reset prefill at the
# 2048 bucket (kernel 8 on the rank's 16 heads)
TP_TURN = " ".join(
    f"Paragraph {i}: the reset prefill attends over its own keys and values, tile by tile, "
    "with the online softmax kept in registers." for i in range(7))
# the b8 paged requests' prompt lengths (buckets 16 to 1024), 32 new tokens
TP_PROMPT_LENS = (16, 100, 200, 300, 500, 700, 900, 1024)
TP_GATE_STEPS = 3  # decode steps of the logits gate after each prefill
TP_GATE_PATHS = ("slot", "paged_bf16", "paged_int8")
TP_GATE_LAYERS = 2  # the bf16 gate's depth: the parity phase's cut
TP_PROBE_STEPS = 8


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def tp_requests(vocab=VICUNA.vocab_size):
    rng = np.random.default_rng(3)
    return [([int(t) for t in rng.integers(3, vocab, n)],
             GenerationConfig(max_new_tokens=32, temperature=0.0)) for n in TP_PROMPT_LENS]


def tp_gate(params, cfg, mesh, ref=None, paths=TP_GATE_PATHS, slot_dtype=torch.bfloat16):
    """The logits gate's forwards (models.forward, the model API the
    engine's programs share their body with) on `paths`: "slot", a
    1100-token reset prefill on a slot cache of slot_dtype (prefill_flash:
    kernel 8) and TP_GATE_STEPS decode steps; "paged_bf16" and
    "paged_int8", the 8 TP_PROMPT_LENS prompts as one [8, 1024] prefill on
    the paged cache and TP_GATE_STEPS decode steps (kernel 7). mesh None:
    the unsharded forward, whose greedy tokens feed every decode step
    (ref: those tokens, fed to the sharded one). Returns {path: [(logits
    on the host, next tokens)]}."""
    tp = 1 if mesh is None else TP_WORLD
    gen = torch.Generator().manual_seed(4)
    out = {}

    def run(name, cache, toks, seq_lens, flash):
        steps = []
        lg, cache = forward(params, cfg, toks, cache, seq_lens=seq_lens, prefill_flash=flash,
                            mesh=mesh)
        for i in range(TP_GATE_STEPS + 1):
            nxt = lg.argmax(-1, keepdim=True) if ref is None else ref[name][i][1].cuda()
            steps.append((lg.float().cpu(), nxt.cpu()))
            if i == TP_GATE_STEPS:
                break
            lg, cache = forward(params, cfg, nxt, cache, mesh=mesh)
        out[name] = steps

    toks = torch.zeros((1, 1152), dtype=torch.int64)
    toks[0, :1100] = torch.randint(3, cfg.vocab_size, (1100,), generator=gen)
    if "slot" in paths:
        run("slot", init_kv_cache(cfg, 1, SERVE_SEQ, slot_dtype, device="cuda", tp=tp),
            toks.cuda(), [1100], True)
    toks = torch.zeros((8, 1024), dtype=torch.int64)
    for b, n in enumerate(TP_PROMPT_LENS):
        toks[b, :n] = torch.randint(3, cfg.vocab_size, (n,), generator=gen)
    pages = SERVE_SEQ // PAGE_SIZE
    table = 1 + np.arange(8 * pages, dtype=np.int32).reshape(8, pages)
    for dtype in (torch.bfloat16, torch.int8):
        if f"paged_{KV_NAMES[dtype]}" not in paths:
            continue
        cache = init_paged_kv_cache(cfg, 8, 8 * pages + 1, PAGE_SIZE, pages, dtype=dtype,
                                    head_block=PAGED_HEAD_BLOCK, device="cuda", tp=tp)
        cache.set_page_table(table)
        run(f"paged_{KV_NAMES[dtype]}", cache, toks.cuda(), list(TP_PROMPT_LENS), False)
    return out


def first_layers(params, L):
    """The params of a model cut to its first L layers (views)."""
    def cut(v):
        return v.map(lambda t: t[:L]) if isinstance(v, QuantizedTensor) else v[:L]

    return {k: {n: cut(v) for n, v in params[k].items()} if k == "layers" else params[k]
            for k in params}


def tp_hold(rank, label, got, ref, rtol, other=None):
    """Each forward's |tp - unsharded| / max |logit| held to rtol (and
    the logits finite, of the unsharded shape); `other`: a second
    unsharded run whose distance to `ref` is printed beside. Returns
    {path: ratios}."""
    ratios = {}
    for name, steps in got.items():
        r = []
        for (lg, _), (want, _) in zip(steps, ref[name]):
            if lg.shape != want.shape or not torch.isfinite(lg).all():
                fail(f"tp rank {rank} {label} {name}: logits of shape {tuple(lg.shape)}, "
                     f"finite {bool(torch.isfinite(lg).all())}")
            r.append((lg - want).abs().max().item() / want.abs().max().item())
        ratios[name] = r
        beside = ""
        if other is not None:
            apart = [(a - b).abs().max().item() / b.abs().max().item()
                     for (a, _), (b, _) in zip(ref[name], other[name])]
            beside = f"; the unsharded pair order against the qsplit order {apart}"
        print(f"  rank {rank} {label} {name}: |tp - unsharded| / max |logit| per forward "
              f"{r}{beside}")
        if max(r) > rtol:
            fail(f"tp rank {rank} {label} {name}: logits beyond {rtol} of the unsharded")
    return ratios


def tp_probe(engine, prompts):
    """The eager decode step on `engine` (a tp rank's): a prefill of
    `prompts`, then TP_PROBE_STEPS greedy steps timed by the host clock
    (synchronized), again with every all-reduce timed (synchronized before
    and after: its own wall, not the compute queued before it), and again
    under torch.profiler. Returns the step wall, the collectives' share of
    the timed run's step wall, and the device ms a step."""
    engine.reset()
    B = engine.max_batch
    tok = engine.prefill(prompts, reserve_tokens=4 * TP_PROBE_STEPS).argmax(-1)
    active = np.zeros(B, bool)
    active[:len(prompts)] = True
    seeds, steps = np.zeros(B, np.int64), np.ones(B, np.int64)

    def run(n):
        nonlocal tok
        for _ in range(n):
            window = engine.decode_window(int(engine.cache.lengths.max()) + 1)
            tok = engine._decode_sample(tok[:, None], active, seeds, steps, 0.0, 1.0,
                                        attn_window=window)
        torch.cuda.synchronize()

    def timed(n):
        t0 = time.perf_counter()
        run(n)
        return (time.perf_counter() - t0) / n * 1e3

    run(2)
    wall = timed(TP_PROBE_STEPS)
    spent = [0.0]
    reduce = tr.all_reduce

    def timed_reduce(x, tp):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = reduce(x, tp)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        return y

    tr.all_reduce = timed_reduce
    try:
        timed_wall = timed(TP_PROBE_STEPS)
    finally:
        tr.all_reduce = reduce
    device_ms = device_busy_ms(lambda: run(TP_PROBE_STEPS)) / TP_PROBE_STEPS
    return dict(step_wall_ms=wall, timed_step_wall_ms=timed_wall,
                collective_ms=spent[0] / TP_PROBE_STEPS * 1e3,
                collective_share=spent[0] * 1e3 / TP_PROBE_STEPS / timed_wall,
                device_ms=device_ms, device_idle_share=1 - device_ms / wall)


def tp_engine_check(engine, label):
    if not engine.programs.eager or engine.programs.count or engine.programs.replays:
        fail(f"{label}: a gloo engine must run its programs eagerly, captured "
             f"{engine.programs.count}, replayed {engine.programs.replays}")


def tp_chat(local, mesh, rank):
    """b1 chat on the rank's slot cache (16 heads), 3 greedy turns of 32
    tokens: the TP_TURN reset prefill (kernel 8 once a layer), then two
    short append turns."""
    engine = InferenceEngine(VICUNA, local, max_batch=1, max_seq_len=SERVE_SEQ, device="cuda",
                             mesh=mesh)
    session = ChatSession(engine, ByteTokenizer(), VICUNA,
                          ChatConfig(temperature=0.0, max_gen_len=32, max_window_size=2048))
    reset_counters()
    replies, lens = [], []
    with finite_logits(f"tp rank {rank} chat"):
        for prompt in (TP_TURN, "Name three colors.", "Thanks, bye."):
            before = engine.stats.prefill_tokens
            replies.append(session.ask(prompt))
            lens.append(engine.stats.prefill_tokens - before)
    launches = read_counters()
    steps = engine.stats.decode_tokens
    want = expected_launches("q4bf16 tp", b1_steps=steps, prefills=3, flash_prefills=1)
    tp_engine_check(engine, "tp chat")
    print(f"  rank {rank} chat: prefill tokens {lens}, {steps} decode steps, step wall "
          f"{engine.stats.decode_time / max(steps, 1) * 1e3:.2f} ms; launches {launches} "
          f"(want {want})")
    if launches != want or steps == 0 or lens[0] < 1024:
        fail(f"tp rank {rank} chat: launch counts do not match the path")
    probe = tp_probe(engine, [[VICUNA.bos_token_id] + list(b"Tell me about sharding.")])
    return dict(replies=replies, prefill_tokens=lens, decode_steps=steps,
                step_wall_ms=engine.stats.decode_time / max(steps, 1) * 1e3, probe=probe,
                launches=launches)


def tp_serve(local, mesh, rank, dtype):
    """The paged b8 scheduler on the rank's pool (G/tp head groups): the 8
    TP_PROMPT_LENS greedy requests of 32 new tokens."""
    kv = KV_NAMES[dtype]
    engine = InferenceEngine(VICUNA, local, max_batch=SERVE_BATCH, max_seq_len=SERVE_SEQ,
                             cache_dtype=dtype, kv_layout="paged", page_size=PAGE_SIZE,
                             device="cuda", mesh=mesh)
    G = engine.cache.k_pages.shape[0]
    sched = ContinuousBatchingScheduler(engine, seed=0)
    reset_counters()
    t0 = time.perf_counter()
    with finite_logits(f"tp rank {rank} serve {kv}"):
        reqs = [sched.submit(p, g) for p, g in tp_requests()]
        sched.run()
    wall = time.perf_counter() - t0
    launches = read_counters()
    forwards, prefills = engine.decode_forwards, engine.prefill_forwards
    want = expected_launches("q4bf16 tp", b8_forwards=forwards, prefills=prefills)
    tp_engine_check(engine, f"tp serve {kv}")
    outputs = [r.output for r in reqs]
    print(f"  rank {rank} serve {kv}: {G} local head groups, {prefills} admissions, {forwards} "
          f"b8 forwards, step wall {engine.stats.decode_time / max(forwards, 1) * 1e3:.2f} ms, "
          f"{sum(map(len, outputs))} tokens in {wall:.2f} s; launches {launches} (want {want})")
    if launches != want or not all(r.done and r.output for r in reqs):
        fail(f"tp rank {rank} serve {kv}: launch counts or completions do not match the path")
    stats = dict(outputs=outputs, head_groups=G, admissions=prefills, decode_forwards=forwards,
                 step_wall_ms=engine.stats.decode_time / max(forwards, 1) * 1e3, wall_s=wall,
                 launches=launches)
    if dtype == torch.bfloat16:
        stats["probe"] = tp_probe(engine, [p for p, _ in tp_requests()])
    return stats


def tp_rank_main(rank: int, port: str, out_dir: str):
    """One rank of phase (a). Vicuna-7B q4bf16 drawn on the card (seed 0,
    as the parent's); the logits gate at TP_GATE_LAYERS layers of full
    width, the parity phase's cut: this rank's shards (shard_params over
    a ("dp", "tp") mesh of 2 gloo ranks) against the unsharded forward on
    the same weights in the pair order the shards are repacked to (exact),
    within LOGIT_RTOL, on TP_GATE_PATHS (the distance of the unsharded
    pair order from the qsplit order beside it); then at full depth the
    chat and the paged b8 scheduler (bf16 and int8 pages), launch counts
    held; then Vicuna-7B q4f32 at full depth (f32 slot cache), the slot
    gate within F32_LOGIT_RTOL. Writes tp.<rank>.json into out_dir. In
    bf16, random full-depth layers amplify the bodies' other rounding
    points to a third of max |logit| between the unsharded pair and qsplit
    orders (scripts/torch_tp_gate.py), sharded or not: hence the depth of
    the bf16 gate and the f32 one at full depth."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: the TP rank needs the GPU")
    t0 = time.perf_counter()
    initialize(f"localhost:{port}", TP_WORLD, rank, backend="gloo")
    mesh = make_mesh(tp=TP_WORLD, device_type="cuda")
    full = init_random_params(VICUNA, "q4bf16", seed=0, device="cuda")
    cfg = VICUNA.replace(num_layers=TP_GATE_LAYERS)
    part = first_layers(full, TP_GATE_LAYERS)
    ref_qsplit = tp_gate(pad_params(part), cfg, None)
    ref = tp_gate(pad_params(_repack_hsplit_for_sharding(part)), cfg, None, ref_qsplit)
    got = tp_gate(pad_params(shard_params(part, mesh, cfg)), cfg, mesh, ref)
    gate = tp_hold(rank, f"bf16 gate, {TP_GATE_LAYERS} layers", got, ref, LOGIT_RTOL, ref_qsplit)
    del part, ref_qsplit, ref, got
    local = shard_params(full, mesh, VICUNA)
    del full
    gc.collect()
    torch.cuda.empty_cache()
    shapes = {k: dict(shape=list(v.shape), stored=list(v.data.shape[1:]), layout=v.spec.layout)
              for k, v in local["layers"].items() if isinstance(v, QuantizedTensor)}
    shapes["lm_head"] = dict(shape=list(local["lm_head"]["w"].shape),
                             stored=list(local["lm_head"]["w"].data.shape))
    print(f"  rank {rank}: shards {shapes}, {param_bytes(local)} bytes; set-up "
          f"{time.perf_counter() - t0:.1f} s")
    result = dict(rank=rank, shards=shapes, gate=gate, chat=tp_chat(local, mesh, rank))
    for dtype in (torch.bfloat16, torch.int8):
        result[f"serve_{KV_NAMES[dtype]}"] = tp_serve(local, mesh, rank, dtype)
    del local
    gc.collect()
    torch.cuda.empty_cache()
    full = init_random_params(VICUNA, "q4f32", seed=0, device="cuda")
    ref = tp_gate(pad_params(full), VICUNA, None, paths=("slot",), slot_dtype=torch.float32)
    local = pad_params(shard_params(full, mesh, VICUNA))
    del full
    got = tp_gate(local, VICUNA, mesh, ref, paths=("slot",), slot_dtype=torch.float32)
    result["gate_f32_full_depth"] = tp_hold(rank, "q4f32 gate, full depth", got, ref,
                                            F32_LOGIT_RTOL)
    torch.distributed.destroy_process_group()
    result["seconds"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"tp.{rank}.json"), "w") as f:
        json.dump(result, f)


def tp_gloo_phase():
    """Phase (a): TP_WORLD child processes of this script, each one gloo
    rank on the one card (NCCL refuses two ranks on one device), so the
    run measures correctness and host staging, not NVLink TP. Holds each
    rank's gate, launches and completions (in the child) and the ranks'
    streams equal to each other; returns rank 0's stats and each rank's
    launches by path."""
    print(f"== TP phase (a): tp = {TP_WORLD} over gloo, both ranks on the one card, "
          f"Vicuna-7B q4bf16 at full depth")
    out = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    port = str(free_port())
    logs = [open(os.path.join(out, f"rank{r}.log"), "w+") for r in range(TP_WORLD)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--tp-rank", str(r),
                               port, out], stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(TP_WORLD)]
    try:
        for p in procs:
            p.wait(timeout=900)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()  # the processes started here
                p.wait()
    try:
        for r, log in enumerate(logs):
            log.seek(0)
            for line in log.read().splitlines():
                print(f"  [rank {r}] {line}")
            log.close()
        if any(p.returncode != 0 for p in procs):
            fail(f"tp ranks exited {[p.returncode for p in procs]}")
        res = []
        for r in range(TP_WORLD):
            with open(os.path.join(out, f"tp.{r}.json")) as f:
                res.append(json.load(f))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    streams = [(x["chat"]["replies"], x["serve_bf16"]["outputs"], x["serve_int8"]["outputs"])
               for x in res]
    print(f"  the ranks' streams equal: {all(s == streams[0] for s in streams)}; rank 0 "
          f"chat replies {[len(t) for t in streams[0][0]]} chars, serve tokens bf16 "
          f"{[len(t) for t in streams[0][1]]}, int8 {[len(t) for t in streams[0][2]]}")
    if any(s != streams[0] for s in streams):
        fail("the tp ranks' streams differ")
    paths = {}
    for r, x in enumerate(res):
        for name in ("chat", "serve_bf16", "serve_int8"):
            paths[f"tp{TP_WORLD}_{name}_rank{r}"] = x[name].pop("launches")
    stats = res[0]
    for name in ("chat", "serve_bf16", "serve_int8"):
        stats[name].pop("outputs", None)
        stats[name].pop("replies", None)
    stats["seconds_by_rank"] = [x["seconds"] for x in res]
    print(f"  rank 0: {json.dumps({k: stats[k] for k in ('gate', 'chat', 'serve_bf16')})}")
    return paths, stats


def tp_nccl_phase(params):
    """Phase (b): tp = 1 over NCCL in this process, on the q4 params (at tp
    = 1 shard_params returns them as they are): the engine's programs are
    captured with the collectives inside. A b1 prefill's logits and 16
    greedy tokens: graph == eager bit for bit, and == the unsharded
    engine's (an all-reduce over one rank is the identity)."""
    print("== TP phase (b): tp = 1 over NCCL, the collectives inside the captured graphs")
    initialize(f"localhost:{free_port()}", 1, 0, backend="nccl")
    try:
        mesh = make_mesh(tp=1, device_type="cuda")
        local = shard_params(params, mesh, VICUNA)
        if local is not params:
            fail("shard_params at tp = 1 copied the params")
        prompt = [[VICUNA.bos_token_id] + list(b"Tell me about collectives.")]
        greedy = GenerationConfig(max_new_tokens=16, temperature=0.0)
        logits, toks, stats = {}, {}, {}
        for mode in ("graph", "eager", "unsharded"):
            eng = InferenceEngine(VICUNA, local, max_batch=1, max_seq_len=1536, device="cuda",
                                  mesh=None if mode == "unsharded" else mesh)
            eng.cfg = VICUNA.replace(stop_tokens=())  # decode the full count
            if mode == "eager":
                eager_steps(eng)
            if eng.programs.eager:
                fail("an NCCL engine must capture its programs")
            logits[mode] = eng.prefill(prompt)
            toks[mode] = eng.generate(prompt, greedy)[0]
            eng.stats.reset()
            mark = program_mark(eng)
            if eng.generate(prompt, greedy)[0] != toks[mode]:
                fail(f"tp = 1 {mode}: a second run gave other tokens")
            stats[f"{mode}_step_ms"] = eng.stats.decode_time / eng.stats.decode_tokens * 1e3
            if mode == "graph":
                runs = runs_since(eng, mark, "tp = 1 graph")
                stats.update(graphs=eng.programs.count, runs=runs)

                def one_step():
                    eng.generate(prompt, GenerationConfig(max_new_tokens=2, temperature=0.0))

                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    one_step()
                    torch.cuda.synchronize()
                stats["nccl_kernels"] = sum(e.count for e in prof.key_averages()
                                            if "nccl" in e.key.lower())
            del eng
        same = {m: torch.equal(logits["graph"], logits[m]) for m in ("eager", "unsharded")}
        print(f"  graphs {stats['graphs']}, runs {stats['runs']}; prefill logits graph == eager "
              f"{same['eager']}, == unsharded {same['unsharded']}; tokens graph "
              f"{toks['graph']}, eager {toks['eager']}, unsharded {toks['unsharded']}; step ms "
              f"graph {stats['graph_step_ms']:.3f}, eager {stats['eager_step_ms']:.3f}, "
              f"unsharded {stats['unsharded_step_ms']:.3f}; NCCL kernels in a 2-token "
              f"generate's trace {stats['nccl_kernels']}")
        if not all(same.values()) or len({tuple(t) for t in toks.values()}) != 1:
            fail("tp = 1 over NCCL: graph, eager and unsharded logits or tokens differ")
        if stats["runs"] != {"prefill": 1, "sample": 1, "decode": 15, "forwards": 15}:
            fail(f"tp = 1 graph: the generation ran the programs {stats['runs']}")
    finally:
        torch.distributed.destroy_process_group()
    return stats


def u4_phase():
    """Phase (c): u4 planes (q4bf16_plane, one code a byte on the card; no
    kernel reads them: every matmul dequantizes and multiplies). `build
    --random --device cuda` writes full-depth Vicuna-7B into a temporary
    directory, load_params reads it, a b1 chat of 3 greedy turns runs on
    it (launches: none; logits finite); then 2 layers at full width card
    vs CPU within LOGIT_RTOL."""
    print("== u4 phase (c): Vicuna-7B q4bf16_plane")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_u4_")
    try:
        t0 = time.perf_counter()
        build.main(["--model", VICUNA.name, "--random", "--quantization", "q4bf16_plane",
                    "-o", tmp, "--device", "cuda"])
        build_s = time.perf_counter() - t0
        disk = sum(os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp))
        t0 = time.perf_counter()
        params, meta = load_params(tmp, device="cuda")
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    planes = [v for v in params["layers"].values() if isinstance(v, QuantizedTensor)]
    device_bytes = sum(t.numel() * t.element_size() for v in planes
                       for t in (v.data, v.scale, v.zero))
    stats = dict(build_s=build_s, load_s=load_s, disk_bytes=disk,
                 param_bytes=param_bytes(params), layer_device_bytes=device_bytes,
                 data_dtype=str(planes[0].data.dtype))
    print(f"  built in {build_s:.1f} s, loaded in {load_s:.1f} s; stored bytes: on disk {disk}, "
          f"param_bytes (half a byte a code) {stats['param_bytes']}, the layers' planes on the "
          f"card {device_bytes} ({stats['data_dtype']})")
    if meta.get("quantization") != "q4bf16_plane" or planes[0].data.dtype != torch.uint8:
        fail(f"u4 checkpoint: {meta}, {planes[0].data.dtype}")
    launches, stats["chat"] = chat_phase(params, "q4bf16_plane")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cfg = VICUNA.replace(num_layers=2)
    card_vs_cpu(cfg, init_random_params(cfg, "q4bf16_plane", seed=0, device="cuda"))
    return launches, stats


def card_name():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA GPU")
    card = card_name()
    print(f"card: {card}")
    t0 = time.perf_counter()
    # the wgmma sources are built in any case, so that ptxas reports them
    # on a warm csrc/build/ too
    logs = build_kernels(KERNELS, extra_flags=("-Xptxas", "-v"),
                         force=WGMMA_SOURCES + STREAM_SOURCES + ("flash_prefill",))
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for name in WGMMA_SOURCES + ("flash_prefill",):
        print(f"  ptxas, {name}.cu:")
        print("\n".join(ptxas_summary(logs[name])))
    # every gemm_plane instantiation: registers, spills, serialized wgmma;
    # the m tile of 256 (A streamed per k16 step) must not spill
    plane = plane_instantiations(logs["dequant_gemm_plane"])
    for e in plane:
        print(f"  gemm_plane format {e['fmt']} {e['dtype']} MT={e['mt']}: {e['regs']} "
              f"registers, spill stores {e['spill_stores']} B, loads {e['spill_loads']} B, "
              f"C7512 notes {e['c7512']}")
    wide = [e for e in plane if e["mt"] == 256]
    if sorted((e["fmt"], e["dtype"]) for e in wide) != [
            (f, d) for f in (1, 2, 3) for d in ("bf16", "f16")] or any(
            e["spill_stores"] != 0 or e["spill_loads"] != 0 for e in wide):
        fail(f"gemm_plane MT=256 instantiations missing or spilling: {wide}")
    # the streaming GEMVs: qsplit bf16/f16 at m = 1 and f32 at m = 1..8,
    # pair and hsplit in three types at m = 1, int3/u16 in bf16 and f16 at
    # m = 1 and 2
    stream = [dict(e, source=name) for name in STREAM_SOURCES
              for e in stream_instantiations(logs[name])]
    for e in stream:
        print(f"  stream_kernel ({e['source']}.cu) {e['name']}: {e['regs']} registers, spill "
              f"stores {e['spill_stores']} B, loads {e['spill_loads']} B")
    if len(stream) != 10 + 6 + 4 or any(
            e["spill_stores"] != 0 or e["spill_loads"] != 0 for e in stream):
        fail(f"stream_kernel instantiations missing or spilling: {stream}")
    stream_blocks_check()
    # kernel 8's wgmma body in bf16 and f16 at D = 128 and 256: its two
    # warpgroups hold a 64 x D f32 accumulator and must not spill
    fp = ptxas_entries(logs["flash_prefill"], r"\S*flash_prefill_wg\S*")
    for e in fp:
        print(f"  flash_prefill_wg {e['name']}: {e['regs']} registers, spill stores "
              f"{e['spill_stores']} B, loads {e['spill_loads']} B")
    if len(fp) != 4 or any(e["spill_stores"] != 0 or e["spill_loads"] != 0 for e in fp):
        fail(f"flash_prefill_wg instantiations missing or spilling: {fp}")
    # its f32 body at D = 128 and 256 (3xTF32 on wgmma .tf32): no spills,
    # and HGMMA in the SASS of both
    f32 = ptxas_entries(logs["flash_prefill"], r"\S*flash_prefill_tf32\S*")
    sass = sass_counts(os.path.join(BUILD_DIR, "flash_prefill.so"), "flash_prefill_tf32")
    for e in f32:
        print(f"  flash_prefill_tf32 {e['name']}: {e['regs']} registers, spill stores "
              f"{e['spill_stores']} B, loads {e['spill_loads']} B; SASS "
              f"{sass.get(e['name'], {})}")
    if len(f32) != 2 or any(e["spill_stores"] != 0 or e["spill_loads"] != 0
                            or not sass.get(e["name"], {}).get("HGMMA") for e in f32):
        fail(f"flash_prefill_tf32 instantiations missing, spilling or without HGMMA: {f32}")

    with phase_seconds("kernel phase"):
        rows = kernel_phase()
    with phase_seconds("one-launch phase"):
        one_launch_phase()
    with phase_seconds("parity phase"):
        parity_phase()
    with phase_seconds("HF parity phase"):
        hf_parity_phase()
    paths = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        with phase_seconds("checkpoint phase"):
            params, ckpt_stats = checkpoint_phase(tmp)
        print(f"full-depth params loaded, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
              f"allocated")
        with phase_seconds("chat phase"):
            paths["chat"], chat_stats = chat_phase(params)
        torch.cuda.empty_cache()
        with phase_seconds("flash chat phase"):
            paths["flash_chat"], flash_chat_stats, engine = flash_chat_phase(params)
        del engine
        torch.cuda.empty_cache()
        with phase_seconds("flash scheduler phase"):
            paths["flash_scheduler"], flash_sched_stats = flash_scheduler_phase(params)
        torch.cuda.empty_cache()
        with phase_seconds("speculation phase"):
            spec_paths, spec_b1 = spec_b1_phase(params)
            sched_paths, spec_sched = spec_scheduler_phase(params)
        paths.update(spec_paths, **sched_paths)
        with phase_seconds("tools phase"):
            tool_paths, ppl_res = tools_phase(tmp)
        paths.update(tool_paths)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    with phase_seconds("serve phase"):
        paths["serve"], serve_stats = serve_phase(params)
    torch.cuda.empty_cache()
    with phase_seconds("int8 auto phase"):
        paths["int8_auto"], _ = int8_auto_phase(params)
    torch.cuda.empty_cache()
    with phase_seconds("graph phase"):
        graph_phase_stats = graph_phase(params)
    torch.cuda.empty_cache()
    # the dump runs before the phases that profile graph replays (q3f16's
    # and MOSS's idle shares): run after them, its traces of one prefill
    # held one gemm_qs launch fewer than the counter, three traces running.
    # A fresh flash chat engine (the same path and checks) is dumped
    with phase_seconds("dump phase"):
        counted, _, engine = flash_chat_phase(params)
        dump_stats = dump_phase(engine, counted)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    with phase_seconds("coordinator phase"):
        coordinator_stats = coordinator_phase(params)
    gc.collect()
    torch.cuda.empty_cache()
    with phase_seconds("tune phase"):
        tune_stats = tune_phase()
    with phase_seconds("TP phase (b)"):
        tp_nccl_stats = tp_nccl_phase(params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"before the TP ranks: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved in this process")
    with phase_seconds("TP phase (a)"):
        tp_paths, tp_gloo_stats = tp_gloo_phase()
    paths.update(tp_paths)
    with phase_seconds("u4 phase (c)"):
        paths["u4_chat"], u4_stats = u4_phase()
    gc.collect()
    torch.cuda.empty_cache()

    with phase_seconds("q3 phases"):
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

    # the f16 bodies at full depth: q3f16_s16 on f16 slot KV (b1 chat) and
    # f16 pages (the b8 scheduler)
    with phase_seconds("q3f16 phases"):
        t0 = time.perf_counter()
        params = init_random_params(VICUNA, "q3f16_s16", seed=0, device="cuda")
        torch.cuda.synchronize()
        print(f"full-depth q3f16_s16 params in {time.perf_counter() - t0:.1f} s, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        paths["q3f16_chat"], q3f16_chat_stats = chat_phase(
            params, "q3f16_s16", torch.float16, idle_share=True)
        torch.cuda.empty_cache()
        paths["q3f16_flash"], q3f16_flash_stats = flash_prefill_phase(
            params, VICUNA, "q3f16_s16", torch.float16)
        torch.cuda.empty_cache()
        paths["q3f16_serve"], q3f16_serve_stats = model_serve_phase(
            params, VICUNA, "q3f16_s16", idle_share=True, page_dtype=torch.float16)
        del params
        gc.collect()
        torch.cuda.empty_cache()

    neox_stats = {}
    for path, cfg, quant in (("rp_chat", REDPAJAMA, "q4f32"), ("dolly_chat", DOLLY, "q4f16_hs")):
        with phase_seconds(f"{cfg.name} {quant} phases"):
            t0 = time.perf_counter()
            params = init_random_params(cfg, quant, seed=0, device="cuda")
            torch.cuda.synchronize()
            print(f"full-depth {cfg.name} {quant} params in {time.perf_counter() - t0:.1f} s, "
                  f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
            paths[path], neox_stats[path] = chat_phase(params, quant, cfg=cfg)
            torch.cuda.empty_cache()
            serve_path = path.replace("chat", "serve")
            paths[serve_path], neox_stats[serve_path] = model_serve_phase(params, cfg, quant)
            del params
            gc.collect()
            torch.cuda.empty_cache()

    # MOSS: full depth, q4bf16 (every tensor qsplit), random weights
    # quantized on the card; b1 chat on bf16 slot KV, then the paged server
    # (kernel 7 at D = 256)
    with phase_seconds("MOSS phases"):
        t0 = time.perf_counter()
        params = init_random_params(MOSS, "q4bf16", seed=0, device="cuda")
        torch.cuda.synchronize()
        print(f"full-depth {MOSS.name} q4bf16 params in {time.perf_counter() - t0:.1f} s, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        paths["moss_chat"], moss_chat_stats = chat_phase(params, "q4bf16", cfg=MOSS)
        torch.cuda.empty_cache()
        paths["moss_flash"], moss_flash_stats = flash_prefill_phase(params, MOSS, "q4bf16")
        torch.cuda.empty_cache()
        paths["moss_serve"], moss_serve_stats = model_serve_phase(params, MOSS, "q4bf16",
                                                                  idle_share=True)
        del params
        gc.collect()
        torch.cuda.empty_cache()

    # kernel 8's f32 body on its path: full-depth Vicuna q4f32 (f32
    # compute) on an f32 slot cache, a reset prefill of 1100 tokens
    with phase_seconds("q4f32 flash phase"):
        t0 = time.perf_counter()
        params = init_random_params(VICUNA, "q4f32", seed=0, device="cuda")
        torch.cuda.synchronize()
        print(f"full-depth {VICUNA.name} q4f32 params in {time.perf_counter() - t0:.1f} s, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        paths["q4f32_flash"], q4f32_flash_stats = flash_prefill_phase(
            params, VICUNA, "q4f32", torch.float32, rtol=F32_LOGIT_RTOL)
        if q4f32_flash_stats["q_dtypes"] != ["torch.float32"]:
            fail(f"q4f32 flash: kernel 8 ran on {q4f32_flash_stats['q_dtypes']}, not f32 alone")
        del params
        gc.collect()
        torch.cuda.empty_cache()

    # per kernel: its main-path shape (GEMVs: w_in at decode m=1; GEMMs: w_in
    # at prefill m=128; paged: bf16 KV at b8); every shape is in "shapes".
    # launches: the count on the kernel's own slice's path (the q4 serve
    # phase for rows 1-3 and 7, the q3 chat phase for rows 4-6, the
    # RedPajama q4f32 chat for the pair/hsplit bodies), and each path's
    # count in launches_by_path (q3f16_chat and q3f16_serve: the f16 bodies
    # of rows 4-6)
    kernels = []
    tops = {"gemv_qs": ("q4bf16", "w_in", 1, "serve"),
            "gemm_qs": ("q4bf16", "w_in", 128, "serve"),
            "gemv_gp": ("q4f32", "w_in", 8, "rp_serve"),
            "gemm_pairs": ("q4f32", "w_in", 128, "rp_chat"),
            "gemv_gp3": ("q3bf16_s16", "w_in", 1, "q3_chat"),
            "gemm_plane": ("q3bf16_s16", "w_in", 128, "q3_chat"),
            "paged_flash_decode": (None, "vicuna b8 bfloat16 KV", SERVE_BATCH, "serve"),
            "flash_prefill": (None, "vicuna b1 S1024 D128 bfloat16", 1024, "flash_chat")}
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
                                           "bound_by", "bound_f32_fma_ms", "library_ms",
                                           "tflops", "vs_library")}
                    for r in mine]))
    if not all(math.isfinite(k["ms"]) and k["launches"] > 0 for k in kernels):
        fail("a kernel time is not finite or a kernel never ran on its path")
    print(json.dumps({"checkpoint": ckpt_stats, "chat": chat_stats, "ppl": ppl_res,
                      "serve": serve_stats, "q3_chat": q3_chat_stats,
                      "q3_serve": q3_serve_stats, "q3f16_chat": q3f16_chat_stats,
                      "q3f16_serve": q3f16_serve_stats, **neox_stats,
                      "moss_chat": moss_chat_stats,
                      "moss_serve": moss_serve_stats, "graph": graph_phase_stats,
                      "flash_chat": flash_chat_stats, "flash_scheduler": flash_sched_stats,
                      "flash_q3f16": q3f16_flash_stats, "flash_moss": moss_flash_stats,
                      "flash_q4f32": q4f32_flash_stats,
                      "speculation_b1": spec_b1, "speculation_scheduler": spec_sched,
                      "dump": dump_stats, "coordinator": coordinator_stats,
                      "tune": tune_stats, "tp_gloo": tp_gloo_stats, "tp_nccl": tp_nccl_stats,
                      "u4": u4_stats}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-rank"]:
        tp_rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        main()
