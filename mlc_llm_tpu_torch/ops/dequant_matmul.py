"""Fused dequant + matmul: six CUDA kernel wrappers, their plain PyTorch
versions, launch counters, and the routing that picks one.

Routing mirrors the JAX dispatch (``mlc_llm_tpu/ops/pallas/
dequant_matmul.py:1788-1876``, stacked and flat alike), in its order:

1. ``gp3_matmul_supported`` (``:432-440``: int3, u16, group 40, sym,
   m <= 2, G % 16 == 0) -> ``gemv_gp3`` (``csrc/dequant_gemv_gp3.cu``,
   replaces ``_dequant_matmul_gp3_2d``, PERF.md row 6);
2. ``gp_matmul_supported`` (``:1006-1023``: int4, u32, group 32, m <= 8,
   groups blockable) -> ``gemv_qs`` for qsplit (``csrc/dequant_gemv_qs.cu``,
   ``_dequant_matmul_gp_2d`` with ``_gp_body_qs``, row 1), ``gemv_gp`` for
   the pair and hsplit orders (``csrc/dequant_gemv_gp.cu``, ``_gp_body``
   and ``_gp_body_hs``, row 1);
3. a split layout whose group count the TPU kernels cannot block
   (``:1817``, ``:1863``) -> dense: dequantize, then ``torch.matmul``;
4. int4 in u32 words -> ``gemm_qs`` for qsplit (``csrc/dequant_gemm_qs.cu``,
   ``_kernel_pairs_qs``, rows 2-3), ``gemm_pairs`` for pair and hsplit
   (``csrc/dequant_gemm_pairs.cu``, ``_kernel_pairs``,
   ``_kernel_pairs_stacked`` and ``_kernel_pairs_hs``, rows 2-3);
5. everything else word-packed or i8 -> ``gemm_plane``
   (``csrc/dequant_gemm_plane.cu``, ``_dequant_matmul_2d``'s generic
   branch and ``_dequant_matmul_stacked_generic_2d``, rows 4-5); its CUDA
   kernel takes the sym int3, fp4 and int8 presets, and int4 in u16 words
   (no preset) runs only on the CPU.

Above m = 2048 rows the weight is dequantized once and multiplied
(``mlc_llm_tpu/ops/matmul.py`` ``prefill_kernel_max_m``). For the presets:

==============================  =========  ==========  ============  ========
format                          m <= 2     2 < m <= 8  8 < m <= 2048  m > 2048
==============================  =========  ==========  ============  ========
q4bf16, q4f16 (qsplit)          gemv_qs    gemv_qs     gemm_qs       dense
q4*_pair, q4*_sym, q4f32        gemv_gp    gemv_gp     gemm_pairs    dense
q4*_hs (hsplit, G % 16 == 0)    gemv_gp    gemv_gp     gemm_pairs    dense
q3*_s16 (G % 16 == 0)           gemv_gp3   gemm_plane  gemm_plane    dense
q3*, fp4*, q8* (bf16 and f16)   gemm_plane gemm_plane  gemm_plane    dense
==============================  =========  ==========  ============  ========

The four int4 kernels compute in the spec's dtype, bf16, f16 or f32 (x
and the scales in that dtype, the output in it or in f32); no int4 order
raises. The int3, fp4 and int8 kernels take bf16 and f16 (every low-bit
preset: q3bf16, q3f16, q3*_s16, fp4*, q8*).

Each wrapper picks its path from the tensors' device: CPU tensors run
the plain version (``*_plain``), CUDA tensors launch the kernel or
raise. ``<wrapper>.launches`` counts kernel launches, and nothing else.

Stacked weights stay one ``[L, KW, N]`` tensor: the kernels read layer
``l`` at a pointer offset, never through a copy.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import json
import os
from typing import Optional

import torch

from ..quant.groupwise import (
    QuantizedTensor,
    _f4_to_float,
    _unpack_words,
    dequantize,
    words_per_group,
)
from ..quant.spec import QUANT_PRESETS, QuantSpec
from . import check_launch, load_kernel, zeroed_tickets

GEMV_MAX_M = 8       # gp_matmul_supported: m <= 8
GP3_MAX_M = 2        # gp3_matmul_supported: m <= 2
GEMM_MAX_M = 2048    # matmul.py prefill_kernel_max_m()

_P = ctypes.c_void_p
_I = ctypes.c_int
_GEMV_ARGS = {"mlc_gemv_qs": [_I] + [_P] * 7 + [_I] * 6 + [_P],
              "mlc_gemv_qs_tc": [_I] + [_P] * 6 + [_I] * 7 + [_P],
              "mlc_gemv_qs_blocks": [_I] * 2 + [_P]}
_GEMM_ARGS = {"mlc_gemm_qs": [_I] + [_P] * 7 + [_I] * 8 + [_P]}
_GP_ARGS = {"mlc_gemv_gp": [_I] * 2 + [_P] * 7 + [_I] * 6 + [_P],
            "mlc_gemv_gp_tc": [_I] * 2 + [_P] * 7 + [_I] * 7 + [_P],
            "mlc_gemv_gp_blocks": [_I] * 2 + [_P]}
_PAIRS_ARGS = {"mlc_gemm_pairs": [_I] * 2 + [_P] * 7 + [_I] * 8 + [_P]}
_GP3_ARGS = {"mlc_gemv_gp3": [_I] + [_P] * 6 + [_I] * 6 + [_P],
             "mlc_gemv_gp3_blocks": [_I] * 2 + [_P]}
_PLANE_ARGS = {"mlc_gemm_plane": [_I] * 2 + [_P] * 6 + [_I] * 8 + [_P]}
_QSPLIT = QUANT_PRESETS["q4bf16"]
_Q3S16 = QUANT_PRESETS["q3bf16_s16"]
# int4/u32 words in each bit order (the unpacker reads only the order)
_INT4 = {lay: dataclasses.replace(_QSPLIT, layout=lay) for lay in ("pair", "hsplit", "qsplit")}
INT4_MAX = _QSPLIT.max_int
# the int4 kernels' compute dtypes -> their ids in csrc (enum DType) and
# the pair/hsplit kernels' layout ids (enum Layout)
DTYPE_IDS = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
LAYOUT_IDS = {"pair": 0, "hsplit": 1}
# the plane kernel's formats, all sym: (mode, storage, group size) -> its
# format id (csrc/dequant_gemm_plane.cu, enum Format)
PLANE_FORMATS = {("int3", "u32", 40): 0, ("int3", "u16", 40): 1, ("fp4", "u32", 32): 2,
                 ("int8", "i8", 32): 3}
_WORD_DTYPES = {"u32": torch.int32, "u16": torch.int16, "i8": torch.int8}
# the compute dtypes of the int3/fp4/int8 kernels (gemv_gp3, gemm_plane)
_PLANE_DTYPES = (torch.bfloat16, torch.float16)

# The wgmma kernels (gemm_qs, gemm_pairs, gemm_plane, and gemv_qs in
# bf16/f16 and gemv_gp at 2 <= m <= 8; csrc/dequant_wgmma.cuh): a block
# computes 128 output channels by an m tile of MT tokens, one block an SM;
# K runs in stages of the ring, split over blockIdx.z into f32 parts where
# the tiles alone leave SMs idle.
TILE_N = 128
H100_SMS = 132
HBM_BYTES_PER_US = 3.35e6  # H100 SXM HBM3, 3.35 TB/s
MAX_SPLITS = 16
QS_WIDTHS = (16, 64, 128, 256)  # gemm_qs's compiled m tiles
QS_STAGE_K = 64                 # k of a gemm_qs stage: 8 word rows, 16 k of each quarter
# gemm_qs: f32 compute -> (compiled m tiles, gemm_tiles' time model: µs a
# stage at m tile MT, µs a block's fixed cost, MT). bf16/f16: four k16
# steps a stage, as hsplit's, whose times hold here; f32 (3xTF32): eight
# k8 steps of three products, MT <= 64. Checked and fitted against
# scripts/torch_plan_sweep.py on an H100 (700 W): bf16 at the Vicuna-7B
# shapes (m = 128, 2048) and f16 at the 3B shapes (m = 128) pick the
# sweep's fastest plan or one within 2.2%; f32 at the 3B shapes within
# 1.8%, but for w_out's shape at 3.8% (54 stages in one wave against 6-16
# parts over two to five waves, which the wave model cannot prefer)
QS_PLAN = {False: (QS_WIDTHS, (0.65, 6.7, 128)), True: ((16, 64), (2.2, 5.0, 64))}
# word rows of a gemm_plane stage, by format id: one 16-word chunk; int8 four
PLANE_STAGE_ROWS = {0: 16, 1: 16, 2: 16, 3: 64}
# gemm_plane's compiled m tiles, by format id: up to 256 where the ring
# holds three stages of the x tiles at that width (int3/u16: 6 tiles a
# stage, fp4 8, int8 4; A streamed per k16 step leaves the registers for
# the m64n256 accumulator), 128 for int3/u32 (11 tiles a stage)
PLANE_WIDTHS = {0: (16, 64, 128), 1: QS_WIDTHS, 2: QS_WIDTHS, 3: QS_WIDTHS}
# gemm_plane's time model, by format id and m tile: (µs a stage, µs a
# block's fixed cost) for gemm_tiles at that tile. Fitted to
# scripts/torch_plan_sweep.py on an H100 (700 W): the tiles a main-path m
# picks (16 at m = 8, 128 at m = 128, the widest at m = 2048; q3bf16_s16
# at the Vicuna-7B shapes, the other formats at w_in) choose the sweep's
# fastest plan at every swept shape; MT = 64, which no main path picks, is
# fitted to all its swept plans. int3/u32 builds a stage's A at once at MT =
# 128 (no streaming): its block cost keeps m = 128 unsplit, which ran 2.4%
# faster than two parts (scripts/torch_gemm_ab.py)
PLANE_TIMES = {
    0: {16: (1.28, 1.0), 64: (1.33, 2.0), 128: (1.52, 10.0)},
    1: {16: (0.70, 1.5), 64: (0.71, 2.0), 128: (0.72, 4.5), 256: (1.46, 0.0)},
    2: {16: (1.26, 1.0), 64: (1.20, 2.0), 128: (1.54, 2.5), 256: (1.98, 2.0)},
    3: {16: (0.86, 1.5), 64: (0.88, 2.0), 128: (1.04, 2.0), 256: (1.24, 1.0)},
}
# gemm_pairs: (layout, f32 compute) -> (k of a stage, compiled m tiles,
# gemm_tiles' time model: µs a stage at m tile MT, µs a block's fixed
# cost, MT).
# bf16/f16 pair: 16 word rows (4 groups) and the offset step, whose 9 x
# tiles fill the ring at MT = 128; hsplit: 8 word rows (a group of each
# half); f32 (3xTF32): 8 word rows, MT <= 64 (the fresh fragment and the
# hi/lo A registers beside the accumulator). The times are fitted to
# scripts/torch_plan_sweep.py on an H100 (700 W) at the 3B shapes, m = 128:
# hsplit f16 0.65 and 6.7 at MT = 128, f32 1.66 and 7.3 at MT = 64; pair
# bf16/f16 (twice the k a stage) is scaled from hsplit
PAIRS_PLAN = {("pair", False): (128, (16, 64, 128), (1.3, 7.0, 128)),
              ("hsplit", False): (64, QS_WIDTHS, (0.65, 6.7, 128)),
              ("pair", True): (64, (16, 64), (1.66, 7.3, 64)),
              ("hsplit", True): (64, (16, 64), (1.66, 7.3, 64))}
GEMV_STAGE_K = 128       # gemv_qs on tensor cores: a stage is one group of each quarter
GEMV_WIDTHS = (16,)      # its one m tile (m <= 8)
# at most 4 split-K parts: the GEMV streams bytes, and each part writes
# and the reduction reads an f32 [m, n] (16 parts would add a fifth to
# w_in's weight bytes for a 5% shorter wave plan)
GEMV_MAX_SPLITS = 4
# the pair/hsplit GEMV at 2 <= m <= 8 (the same mainloop and stage k):
# gemm_tiles' time model (µs a stage at MT = 16, µs a block's fixed cost,
# MT), fitted to scripts/torch_plan_sweep.py on an H100 (700 W) at the 3B
# shapes, m = 8, hsplit f16 and pair f32 with their f32 heads: the split
# plan it picks is the sweep's fastest at every swept shape (a cap of 4
# parts, gemv_qs's, ran the N = 2560 shapes up to 27% slower)
GP_GEMV_TIMES = (0.3, 0.0, 16)
# The m = 1 GEMVs (and the f32 qsplit GEMV at every m; csrc/gemv_stream.cuh):
# a block streams STREAM_COLS output columns over a contiguous range of at
# most STREAM_MAX_PER K stages (the x slice it stages in shared memory); a
# stage is 16 word rows, STREAM_STAGE_K k by order. The last part of a
# column tile to finish sums the f32 parts in the same launch.
STREAM_COLS = 256
STREAM_MAX_PER = 16
STREAM_MAX_PARTS = 64
STREAM_STAGE_K = {"qsplit": 128, "pair": 128, "hsplit": 128, "int3": 80}
# the blocks an SM holds of each stream_kernel instantiation (its shared
# memory bounds them), by (word kind, compute dtype bytes, m): bf16 and f16
# share an entry (the same shared memory); chip_smoke.py holds each
# instantiation against cudaOccupancyMaxActiveBlocksPerMultiprocessor of
# the built kernel
STREAM_BLOCKS = {("int4", 2, 1): 4, ("int3", 2, 1): 5, ("int3", 2, 2): 4,
                 **{("int4", 4, m): b for m, b in zip(range(1, 9), (3, 2, 2, 1, 1, 1, 1, 1))}}
# stream_plan's time model: (the HBM rate the streaming blocks share, B/µs;
# one block's own streaming rate, B/µs; a block's fixed cost, µs), fitted
# to scripts/torch_plan_sweep.py on an H100 (700 W)
STREAM_TIMES = (2.6e6, 1.0e4, 6.0)


# cached: every decode step asks again for the same shapes, and b1 decode
# is bound by the host (the loop below costs tens of µs of Python a call)
@functools.lru_cache(maxsize=None)
def stream_plan(order: str, m: int, K: int, N: int, itemsize: int = 2):
    """The streaming GEMV's launch plan for an [m, n] output over the
    stored K of a weight in `order` ("qsplit", "pair", "hsplit" or
    "int3") and a compute dtype of `itemsize` bytes, for which a kernel
    is built (STREAM_BLOCKS; else ValueError): (columns a block,
    split-K parts, stages a part). Part p covers stages [p * per, min(steps,
    (p + 1) * per)): none is empty, none longer than STREAM_MAX_PER. Each
    split count is priced on STREAM_TIMES: the resident blocks (at most
    the SMs times STREAM_BLOCKS; more make waves) share the HBM
    rate, each at most its own rate, so a stage takes max(stage bytes *
    resident blocks / HBM rate, stage bytes / a block's rate); a wave
    costs per stages and a block's fixed cost; when split, the f32 parts'
    bytes (written, then read by the last part) at the HBM rate. A count
    with more parts is taken only when it is at least 5% cheaper. Reads no
    tensor."""
    int3 = order == "int3"
    slots = STREAM_BLOCKS.get(("int3" if int3 else "int4", itemsize, m))
    if slots is None:
        raise ValueError(f"stream_plan: no streaming body for {order} at m = {m} "
                         f"with {itemsize}-byte compute")
    # a stage: 16 word rows of the block's columns, and its groups' scales
    # (int4: and minima)
    stage_bytes = STREAM_COLS * (16 * (2 if int3 else 4) + (2 if int3 else 8) * itemsize)
    steps = K // STREAM_STAGE_K[order]
    tiles = -(-N // STREAM_COLS)
    hbm, rate, block_us = STREAM_TIMES
    cap = H100_SMS * slots
    best = None
    for s in range(-(-steps // STREAM_MAX_PER), min(steps, STREAM_MAX_PARTS) + 1):
        per = -(-steps // s)
        parts = -(-steps // per)
        blocks = tiles * parts
        stage_us = max(stage_bytes * min(blocks, cap) / hbm, stage_bytes / rate)
        cost = -(-blocks // cap) * (per * stage_us + block_us)
        if parts > 1:
            cost += parts * m * N * 8 / HBM_BYTES_PER_US
        if best is None or cost < 0.95 * best[0]:
            best = (cost, parts, per)
    if best is None:
        raise ValueError(f"stream_plan: K = {K} needs more than {STREAM_MAX_PARTS} parts")
    return STREAM_COLS, best[1], best[2]


def _stream_scratch(x, m: int, N: int, parts: int, stream: int):
    """The streaming GEMV's split-K scratch: the f32 parts [parts, m, N]
    and the column tiles' zeroed tickets on `stream`, or (None, None)
    unsplit."""
    if parts == 1:
        return None, None
    return (torch.empty((parts, m, N), dtype=torch.float32, device=x.device),
            zeroed_tickets(x.device, stream, -(-N // STREAM_COLS)))


def _plane_geometry(fmt: int, m: int, rows: int):
    """gemm_plane's (K stages, compiled m tiles, gemm_tiles' time model)
    for `rows` stored word rows of format `fmt` (int8: k rows): the time
    model of the narrowest of the format's m tiles that holds m (its
    widest above)."""
    widths = PLANE_WIDTHS[fmt]
    mt = next((w for w in widths if w >= m), widths[-1])
    stage_us, block_us = PLANE_TIMES[fmt][mt]
    return -(-rows // PLANE_STAGE_ROWS[fmt]), widths, (stage_us, block_us, mt)


def plane_tiles(fmt: int, m: int, n: int, rows: int):
    """gemm_plane's launch plan for an [m, n] output over `rows` stored
    word rows of format `fmt` (int8: k rows): the narrowest of the format's
    m tiles that holds m (its widest above), and the split-K plan that
    `gemm_tiles` prices on the format's time model at that tile."""
    steps, widths, times = _plane_geometry(fmt, m, rows)
    return gemm_tiles(m, n, steps, widths, times=times)


def gemm_tiles(m: int, n: int, steps: int, widths, sms: int = H100_SMS,
               max_splits: int = MAX_SPLITS, times=None):
    """The wgmma GEMMs' launch plan for an [m, n] output over `steps` K
    stages: (m tile, split-K parts, stages per part). The m tile is the
    narrowest compiled width that holds m (the widest above it). Part p
    covers stages [p * per, min(steps, (p + 1) * per)): none is empty; at
    most `max_splits` parts.

    Without `times`: K is split when the tiles alone give fewer blocks
    than SMs, at least until they fill one wave, and at decode widths (m
    within the narrowest tile, where an f32 part is small) also to even out
    the last wave; among those split counts the plan minimises the stages
    one SM walks, ceil(blocks * parts / sms) waves of `per` stages each,
    and prefers fewer parts (each part writes an f32 [m, n]).

    With `times` = (µs a stage at m tile t, µs a block's fixed cost: ring
    fill, epilogue; t): every split count, 1 included, is priced as waves
    * (per * stage + block), the stage's time scaled by mt / t, plus, when
    split, the f32 parts' bytes (written, then read by the reduction) at
    the HBM rate; a count with more parts is taken only when it is at
    least 5% cheaper."""
    mt = next((w for w in widths if w >= m), widths[-1])
    blocks = (n // TILE_N) * -(-m // mt)
    if times is not None:
        stage_us, block_us, fit_mt = times
        stage_us *= mt / fit_mt
        best = None
        for s in range(1, min(steps, max_splits) + 1):
            per = -(-steps // s)
            parts = -(-steps // per)
            cost = -(-blocks * parts // sms) * (per * stage_us + block_us)
            if parts > 1:
                cost += parts * m * n * 8 / HBM_BYTES_PER_US
            if best is None or cost < 0.95 * best[0]:
                best = (cost, parts, per)
        return mt, best[1], best[2]
    if blocks >= sms and m > widths[0]:
        return mt, 1, steps
    lo = min(-(-sms // blocks), steps, max_splits)
    best = None
    for s in range(lo, min(steps, max_splits) + 1):
        per = -(-steps // s)
        parts = -(-steps // per)
        cost = -(-blocks * parts // sms) * per
        if best is None or cost < best[0]:
            best = (cost, parts, per)
    return mt, best[1], best[2]


# the plane kernel's formats by name ("<mode>_<storage>", a launch plan's
# format): (format id, k a stored row)
PLANE_FORMAT_NAMES = {
    f"{mode}_{storage}": (fid, 1 if storage == "i8" else QuantSpec(
        mode=mode, group_size=group, sym=True, storage=storage).elems_per_word)
    for (mode, storage, group), fid in PLANE_FORMATS.items()}
# the plan table that mlc_llm_tpu_torch.tune writes for one card (none is
# committed: without it every plan is the time models')
TUNED_PLANS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tuned_plans.json")
_tuned = None  # (header, plans) of the table in use, read at first need


def plan_format(kernel: str, spec: QuantSpec) -> str:
    """A launch plan's weight format: the int4 kernels' bit order
    ("qsplit", "pair", "hsplit"), else "<mode>_<storage>"."""
    if kernel in ("gemv_qs", "gemm_qs", "gemv_gp", "gemm_pairs"):
        return spec.layout
    return f"{spec.mode}_{spec.storage}"


def plan_body(kernel: str, dtype: torch.dtype, m: int) -> str:
    """Which body of a kernel runs at m rows in `dtype`: "stream" (the
    weight-streaming GEMVs: gemv_gp3; gemv_qs and gemv_gp at m = 1,
    gemv_qs in f32 at every m) or "tiles" (the wgmma bodies). The
    wrappers and plan_geometry both branch on it."""
    if kernel == "gemv_gp3" or (kernel in ("gemv_qs", "gemv_gp") and m == 1) or (
            kernel == "gemv_qs" and dtype == torch.float32):
        return "stream"
    return "tiles"


def plan_geometry(kernel: str, fmt: str, dtype: torch.dtype, m: int, K: int):
    """How a kernel's body at m rows over stored K plans its launch:
    ("stream", K stages, None, {}) for the weight-streaming GEMVs
    (stream_plan), else ("tiles", K stages, compiled m tiles, gemm_tiles'
    keyword arguments)."""
    f32 = dtype == torch.float32
    if plan_body(kernel, dtype, m) == "stream":
        order = "int3" if kernel == "gemv_gp3" else fmt
        return "stream", K // STREAM_STAGE_K[order], None, {}
    if kernel == "gemv_qs":
        return "tiles", K // GEMV_STAGE_K, GEMV_WIDTHS, dict(max_splits=GEMV_MAX_SPLITS)
    if kernel == "gemv_gp":
        return "tiles", K // GEMV_STAGE_K, GEMV_WIDTHS, dict(times=GP_GEMV_TIMES)
    if kernel == "gemm_qs":
        widths, times = QS_PLAN[f32]
        return "tiles", K // QS_STAGE_K, widths, dict(times=times)
    if kernel == "gemm_pairs":
        stage_k, widths, times = PAIRS_PLAN[(fmt, f32)]
        return "tiles", K // stage_k, widths, dict(times=times)
    if kernel == "gemm_plane":
        fid, per_row = PLANE_FORMAT_NAMES[fmt]
        steps, widths, times = _plane_geometry(fid, m, K // per_row)
        return "tiles", steps, widths, dict(times=times)
    raise ValueError(f"no launch plan for kernel {kernel!r}")


def model_plan(kernel: str, fmt: str, dtype: torch.dtype, m: int, K: int, N: int):
    """The plan the time models pick: stream_plan's (columns a block,
    parts, stages a part) for a streaming body, else gemm_tiles' (m tile,
    parts, stages a part); gemm_plane's through plane_tiles."""
    if kernel == "gemm_plane":
        fid, per_row = PLANE_FORMAT_NAMES[fmt]
        return plane_tiles(fid, m, N, K // per_row)
    how, steps, widths, kw = plan_geometry(kernel, fmt, dtype, m, K)
    if how == "stream":
        return stream_plan("int3" if kernel == "gemv_gp3" else fmt, m, K, N, dtype.itemsize)
    return gemm_tiles(m, N, steps, widths, **kw)


def plan_key(kernel: str, fmt: str, dtype: torch.dtype, m: int, K: int, N: int) -> str:
    """A plan table's key: kernel, format, compute dtype, m, stored K, N."""
    return f"{kernel}:{fmt}:{str(dtype).split('.')[-1]}:{m}:{K}:{N}"


def load_tuned_plans(path: str = TUNED_PLANS):
    """Read the plan table at `path` (written by mlc_llm_tpu_torch.tune)
    and make it the one launch_plan reads; a missing file is an empty
    table. Returns (header, plans)."""
    global _tuned
    if os.path.exists(path):
        with open(path) as f:
            table = json.load(f)
        _tuned = (table["header"], table["plans"])
    else:
        _tuned = ({}, {})
    _table_plan.cache_clear()
    return _tuned


def launch_plan(kernel: str, fmt: str, dtype: torch.dtype, m: int, K: int, N: int,
                card: Optional[str] = None):
    """The launch plan of one call: the plan table's entry for this exact
    (kernel, format, compute dtype, m, K, N) when the table was written on
    a card of this name (`card`: torch.cuda.get_device_name of the call's
    device), else the time models' (model_plan)."""
    if card is not None:
        if _tuned is None:
            load_tuned_plans()
        hit = _table_plan(kernel, fmt, dtype, m, K, N, card)
        if hit is not None:
            return hit
    return model_plan(kernel, fmt, dtype, m, K, N)


# cached until load_tuned_plans reads a table: every decode step asks
# again for the same shapes
@functools.lru_cache(maxsize=None)
def _table_plan(kernel, fmt, dtype, m, K, N, card):
    """The table's plan for this call on a card named `card`, or None."""
    header, plans = _tuned
    hit = plans.get(plan_key(kernel, fmt, dtype, m, K, N))
    return tuple(hit["plan"]) if hit is not None and header.get("card") == card else None


@functools.lru_cache(maxsize=None)
def _card_of(index: int) -> str:
    return torch.cuda.get_device_name(index)


def _card(x: torch.Tensor) -> Optional[str]:
    """The name of x's card (None off a CUDA device: no table applies)."""
    return _card_of(x.device.index or 0) if x.device.type == "cuda" else None


def route(spec: QuantSpec, n_groups: int, m: int) -> str:
    """The kernel the JAX dispatch picks for a quantized weight of
    n_groups groups at m rows (see the module doc):
    "gemv_gp3", "gemv_qs", "gemv_gp", "gemm_qs", "gemm_pairs",
    "gemm_plane" or "dense"."""
    if m > GEMM_MAX_M or spec.storage not in ("u32", "u16", "i8"):
        return "dense"
    if (spec.mode == "int3" and spec.storage == "u16" and spec.group_size == 40 and spec.sym
            and m <= GP3_MAX_M and n_groups % 16 == 0):
        return "gemv_gp3"
    int4w = spec.mode == "int4" and spec.storage == "u32"
    # split layouts fetch per-plane scale blocks of G/2 (hsplit) or G/4
    # (qsplit) rows, which must be 8-row multiples (:1026-1045)
    blockable = {"qsplit": n_groups % 32 == 0, "hsplit": n_groups % 16 == 0}.get(
        spec.layout, True)
    if int4w and spec.group_size == 32 and m <= GEMV_MAX_M and blockable and n_groups % 8 == 0:
        return "gemv_qs" if spec.layout == "qsplit" else "gemv_gp"
    if not blockable:
        return "dense"
    if int4w:
        return "gemm_qs" if spec.layout == "qsplit" and spec.group_size == 32 else "gemm_pairs"
    return "gemm_plane"


def _codes16(words: torch.Tensor) -> torch.Tensor:
    """qsplit words [KW, N] -> f32 values 16 + q in element order [K, N]
    (exact: the TPU kernels bit-assemble the same bf16 values)."""
    return _unpack_words(words, _QSPLIT).to(torch.float32) + 16.0


def _gp_sum(P, sx, scale, zero, offset: float):
    """y = sum_g s*(P - offset*sx) + z*sx (asym) or s*(P - (offset +
    max_int)*sx) (sym), in f32 from f32 partials [m, G, N] and x sums
    [m, G, 1]: the GEMV bodies' closing step."""
    s = scale.float()[None]
    if zero is None:
        return (s * (P - (offset + INT4_MAX) * sx)).sum(dim=1)
    return (s * (P - offset * sx) + zero.float()[None] * sx).sum(dim=1)


def gemv_qs_plain(x, words, scale, zero, out_dtype):
    """Plain version of the qsplit GEMV, in the TPU kernel's arithmetic
    order: f32 group partials P = sum x*(16+q), the group sum of x rounded
    to the compute dtype (x's: bf16, f16 or f32), then f32 scales: y =
    sum_g s*(P - 16*sx) + z*sx (asym) or s*(P - (16+max_int)*sx) (sym).
    x: [m, K]; words [K/8, N]; scale/zero [K/32, N]; returns [m, N] in
    out_dtype."""
    m, K = x.shape
    G, N = scale.shape
    xg = x.float().reshape(m, G, 32)
    vals = _codes16(words).reshape(G, 32, N)
    P = torch.einsum("mgk,gkn->mgn", xg, vals)
    sx = xg.sum(dim=2).to(x.dtype).float()[:, :, None]
    return _gp_sum(P, sx, scale, zero, 16.0).to(out_dtype)


def gemv_gp_plain(x, words, scale, zero, layout: str, out_dtype):
    """Plain version of the pair and hsplit GEMVs (_gp_body, _gp_body_hs),
    in their arithmetic order: f32 group partials P = sum x*q over the raw
    codes, then y = sum_g s*P + z*sx (asym) or s*(P - max_int*sx) (sym)
    with f32 scales. sx is the group's sum of x in the compute dtype (x's):
    pair sums the 16 even and the 16 odd elements apart, rounds each, and
    adds them in that dtype (a band row is one parity of one group);
    hsplit rounds the 32-element sum once (a band row is one group). x:
    [m, K]; words [K/8, N]; scale/zero [K/32, N]; returns [m, N]."""
    m, K = x.shape
    G, N = scale.shape
    cd = x.dtype
    xg = x.float().reshape(m, G, 32)
    codes = _unpack_words(words, _INT4[layout]).float().reshape(G, 32, N)
    P = torch.einsum("mgk,gkn->mgn", xg, codes)
    if layout == "pair":
        par = xg.reshape(m, G, 16, 2).sum(dim=2).to(cd)
        sx = (par[..., 0] + par[..., 1]).float()
    else:
        sx = xg.sum(dim=2).to(cd).float()
    return _gp_sum(P, sx[:, :, None], scale, zero, 0.0).to(out_dtype)


def gemm_weight_plain(words, scale, zero, dtype=torch.bfloat16) -> torch.Tensor:
    """The qsplit GEMM's weight in the compute dtype: w = (16+q)*s +
    (z - 16*s), each op rounded to `dtype` as in the TPU kernel (sym:
    (16+q)*s + s*-23)."""
    G, N = scale.shape
    vals = _codes16(words).to(dtype).reshape(G, 32, N)
    se = scale.to(dtype)[:, None, :]
    off = se * -(16 + INT4_MAX) if zero is None else zero.to(dtype)[:, None, :] - se * 16
    return (vals * se + off).reshape(G * 32, N)


def gemm_qs_plain(x, words, scale, zero, out_dtype):
    """Plain version of the qsplit GEMM: dequant in x's dtype, then an
    f32-accumulated matmul. x: [m, K]; returns [m, N] in out_dtype."""
    w = gemm_weight_plain(words, scale, zero, x.dtype)
    return torch.matmul(x.float(), w.float()).to(out_dtype)


def gemm_pairs_plain(x, words, scale, zero, layout: str, out_dtype):
    """Plain version of the pair and hsplit GEMMs, each op rounded to the
    compute dtype (x's) where the TPU kernel rounds:
    - pair (_kernel_pairs, _kernel_pairs_stacked): w = q*s, plus one
      offset dot of (x_even + x_odd) against off = z, or s*-max_int (sym);
    - hsplit (_kernel_pairs_hs): w = q*s + off, two roundings.
    Products and sums in f32. x: [m, K]; returns [m, N] in out_dtype."""
    m, K = x.shape
    G, N = scale.shape
    cd = x.dtype
    codes = _unpack_words(words, _INT4[layout]).to(cd).reshape(G, 32, N)
    se = scale.to(cd)[:, None, :]
    off = se * -INT4_MAX if zero is None else zero.to(cd)[:, None, :]
    if layout == "pair":
        y = torch.matmul(x.float(), (codes * se).reshape(K, N).float())
        xp = x.reshape(m, K // 2, 2)
        t = (xp[..., 0] + xp[..., 1]).float().reshape(m, G, 16).sum(dim=2)
        y = y + torch.matmul(t, off[:, 0].float())
    else:
        y = torch.matmul(x.float(), (codes * se + off).reshape(K, N).float())
    return y.to(out_dtype)


def gemv_gp3_plain(x, words, scale, out_dtype):
    """Plain version of the int3/u16 GEMV (_gp3_body), in its arithmetic
    order. u16 word r holds k = 5r + i at bits 3i; a group is 8 words
    (40 k). Per group, f32 partials P = sum x*(8+q); each of the five
    fields' 8-element sums of x rounded to x's dtype (bf16 or f16: the
    TPU body sums its x planes in that dtype), then added in f32 (sx);
    y = sum_g s*(P - (8+max_int)*sx) with f32 scales. x: [m, 40G];
    words [8G, N] int16; scale [G, N]; returns [m, N] in out_dtype."""
    m, K = x.shape
    G, N = scale.shape
    xg = x.float().reshape(m, G, 40)
    vals = (_unpack_words(words, _Q3S16).to(torch.float32) + 8.0).reshape(G, 40, N)
    P = torch.einsum("mgk,gkn->mgn", xg, vals)
    sx = xg.reshape(m, G, 8, 5).sum(dim=2).to(x.dtype).float().sum(dim=2)
    y = (scale.float()[None] * (P - float(8 + _Q3S16.max_int) * sx[:, :, None])).sum(dim=1)
    return y.to(out_dtype)


def plane_weight_plain(data, scale, spec: QuantSpec, dtype=torch.bfloat16) -> torch.Tensor:
    """The plane kernel's weight [K_stored, N]: value(code) * s rounded to
    `dtype` (the TPU kernel's rounding point, dequant_matmul.py:396).
    value is the raw code for int3/int4 (the offset is a separate term),
    ±2^(e-7) or 0 for fp4, and the stored signed byte for i8."""
    G, N = scale.shape
    if spec.storage == "i8":
        vals = data.to(dtype)
    else:
        codes = _unpack_words(data, spec)
        vals = _f4_to_float(codes, dtype) if spec.mode == "fp4" else codes.to(dtype)
    return (vals.reshape(G, -1, N) * scale.to(dtype)[:, None, :]).reshape(-1, N)


def gemm_plane_plain(x, data, scale, zero, spec: QuantSpec, out_dtype):
    """Plain version of the plane GEMM (_kernel, dequant_matmul.py:362):
    y = x @ W in f32 with W from plane_weight_plain, plus, for word-packed
    int formats, the folded offset sum_kw T(sum_i x[kw*epw+i]) * off[g]
    with off = T(-max_int*s) (sym) or z (asym), T x's dtype. x: [m, K_stored] with
    K_stored = rows * epw (words) or rows (i8); returns [m, N]."""
    m = x.shape[0]
    G = scale.shape[0]
    cdtype = x.dtype
    y = torch.matmul(x.float(), plane_weight_plain(data, scale, spec, cdtype).float())
    if spec.storage != "i8" and spec.mode != "fp4":
        kw = data.shape[0]
        xs = x.float().reshape(m, kw, spec.elems_per_word).sum(dim=2).to(cdtype).float()
        t = xs.reshape(m, G, words_per_group(spec)).sum(dim=2)
        off = scale.to(cdtype) * -spec.max_int if spec.sym else zero.to(cdtype)
        y = y + torch.matmul(t, off.float())
    return y.to(out_dtype)


def _layer_view(t: Optional[torch.Tensor], layer: Optional[int]):
    if t is None or layer is None:
        return t
    return t[layer]


def _check_cuda_args(name, x, data, scale, zero, layer, out_dtype, *, word_dtype,
                     k_per_row, group_k, g_mult=1, n_mult=64, dtypes=(torch.bfloat16,)):
    """Device, dtype, contiguity, alignment and shape checks before a
    launch: x [m, K] with K = k_per_row * rows = group_k * G, N % n_mult
    == 0, G % g_mult == 0, data/scale/zero stacked exactly when layer is
    given; x, scale and zero in one of `dtypes` (the kernel's compute
    dtypes), the output in x's dtype or f32."""
    if x.dtype not in dtypes or scale.dtype != x.dtype or (
            zero is not None and zero.dtype != x.dtype):
        raise NotImplementedError(
            f"{name}: CUDA kernel computes in {[str(d) for d in dtypes]} with x, scales "
            f"and minima in one dtype, got {x.dtype}/{scale.dtype}/"
            f"{None if zero is None else zero.dtype}")
    if out_dtype not in (x.dtype, torch.float32):
        raise NotImplementedError(f"{name}: out_dtype {out_dtype} not supported for {x.dtype} x")
    if data.dtype != word_dtype:
        raise ValueError(f"{name}: weight data must be {word_dtype}, got {data.dtype}")
    for t in (x, data, scale) + (() if zero is None else (zero,)):
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if x.data_ptr() % 16 or data.data_ptr() % 16:
        raise ValueError(f"{name}: x and the weight data must be 16-byte aligned")
    K = x.shape[1]
    rows, N = data.shape[-2:]
    G = scale.shape[-2]
    if (K != k_per_row * rows or K != group_k * G or G % g_mult or N % n_mult
            or scale.shape[-1] != N or (zero is not None and zero.shape != scale.shape)):
        raise ValueError(
            f"{name}: bad shapes x {tuple(x.shape)}, data {tuple(data.shape)}, "
            f"scale {tuple(scale.shape)} (need K = {k_per_row}*rows = {group_k}*G, "
            f"G % {g_mult} == 0, N % {n_mult} == 0)")
    if (data.ndim == 3) != (layer is not None):
        raise ValueError(f"{name}: pass layer exactly when the weights are stacked")
    if data.ndim == 3 and not 0 <= layer < data.shape[0]:
        raise IndexError(f"{name}: layer {layer} out of range")


def _check_int4(name, x, data, scale, zero, layer, out_dtype, layout=None):
    """_check_cuda_args for the int4/u32 kernels (any compute dtype, G %
    4 == 0: a 128-element K step is whole groups in every order)."""
    if layout is not None and layout not in LAYOUT_IDS:
        raise NotImplementedError(f"{name}: no CUDA kernel for the {layout!r} order")
    _check_cuda_args(name, x, data, scale, zero, layer, out_dtype, word_dtype=torch.int32,
                     k_per_row=8, group_k=32, g_mult=4, dtypes=tuple(DTYPE_IDS))


def _ptrs(data, scale, zero, layer):
    """Layer-l base pointers into stacked [L, ...] buffers (no copy): the
    offset is l times one layer's bytes, from each tensor's own element
    size (int32/int16/int8 data; bf16, f16 or f32 scales)."""
    def at(t):
        if t is None:
            return None
        return t.data_ptr() + (0 if layer is None else layer * t.stride(0) * t.element_size())

    return at(data), at(scale), at(zero)


def _check_tma(name, *ptrs):
    """TMA reads a tensor from a 16-byte aligned base (the layer's, for
    stacked weights): raise on one it would refuse."""
    if any(p is not None and p % 16 for p in ptrs):
        raise ValueError(f"{name}: every base pointer (x, and the layer's words, scales and "
                         "minima) must be 16-byte aligned for TMA")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def gemv_qs(x, data, scale, zero, layer=None, out_dtype=torch.bfloat16):
    """Group-partial dequant GEMV, qsplit order. x: [m <= 8, K_stored] in
    bf16, f16 or f32; data int32 [KW, N] or [L, KW, N] (then pass
    `layer`); scale/zero like data with G = K/32 rows, in x's dtype; zero
    None for sym. Returns [m, N] in out_dtype (x's or f32). bf16 and f16
    at m >= 2 run the tensor-core body (N % 128 == 0), the rest the
    streaming body (one launch a call); one launch counter."""
    if x.device.type == "cpu":
        return gemv_qs_plain(x, _layer_view(data, layer), _layer_view(scale, layer),
                             _layer_view(zero, layer), out_dtype)
    _check_int4("gemv_qs", x, data, scale, zero, layer, out_dtype)
    m, K = x.shape
    N = data.shape[-1]
    if not 1 <= m <= GEMV_MAX_M:
        raise ValueError(f"gemv_qs: m={m} outside 1..{GEMV_MAX_M}")
    lib = load_kernel("dequant_gemv_qs", _GEMV_ARGS)
    wp, sp, zp = _ptrs(data, scale, zero, layer)
    out = torch.empty((m, N), dtype=out_dtype, device=x.device)
    sym, out_f32 = int(zero is None), int(out_dtype == torch.float32)
    _check_tma("gemv_qs", x.data_ptr(), wp, sp, zp)
    if plan_body("gemv_qs", x.dtype, m) == "tiles":  # the tensor-core body
        if N % TILE_N:
            raise ValueError(f"gemv_qs: N={N} is not a multiple of {TILE_N} at m={m}")
        _, splits, per = launch_plan("gemv_qs", "qsplit", x.dtype, m, K, N, _card(x))
        partial = (torch.empty((splits, m, N), dtype=torch.float32, device=x.device)
                   if splits > 1 else None)
        err = lib.mlc_gemv_qs_tc(
            DTYPE_IDS[x.dtype], x.data_ptr(), wp, sp, zp,
            None if partial is None else partial.data_ptr(), out.data_ptr(), m, K, N, sym,
            out_f32, splits, per, _stream(x))
    else:
        _, parts, per = launch_plan("gemv_qs", "qsplit", x.dtype, m, K, N, _card(x))
        st = _stream(x)
        partial, tickets = _stream_scratch(x, m, N, parts, st)
        err = lib.mlc_gemv_qs(
            DTYPE_IDS[x.dtype], x.data_ptr(), wp, sp, zp,
            None if partial is None else partial.data_ptr(),
            None if tickets is None else tickets.data_ptr(), out.data_ptr(), m, K, N, out_f32,
            parts, per, st)
    check_launch(err, "gemv_qs")
    gemv_qs.launches += 1
    return out


gemv_qs.launches = 0


def gemv_gp(x, data, scale, zero, layout: str, layer=None, out_dtype=torch.bfloat16):
    """Group-partial dequant GEMV for the pair and hsplit orders; the
    arguments of gemv_qs, plus the weight's `layout`. m = 1 runs the
    streaming body (one launch a call); 2 <= m <= 8 the tensor-core body
    (N % 128 == 0) in every compute
    dtype, f32 with a prologue that splits x into TF32 planes and sums its
    groups (scratch [2*m*K + m*G] f32); one launch counter."""
    if x.device.type == "cpu":
        return gemv_gp_plain(x, _layer_view(data, layer), _layer_view(scale, layer),
                             _layer_view(zero, layer), layout, out_dtype)
    _check_int4("gemv_gp", x, data, scale, zero, layer, out_dtype, layout)
    m, K = x.shape
    N = data.shape[-1]
    if not 1 <= m <= GEMV_MAX_M:
        raise ValueError(f"gemv_gp: m={m} outside 1..{GEMV_MAX_M}")
    lib = load_kernel("dequant_gemv_gp", _GP_ARGS)
    out = torch.empty((m, N), dtype=out_dtype, device=x.device)
    wp, sp, zp = _ptrs(data, scale, zero, layer)
    sym, out_f32 = int(zero is None), int(out_dtype == torch.float32)
    _check_tma("gemv_gp", x.data_ptr(), wp, sp, zp)
    if plan_body("gemv_gp", x.dtype, m) == "tiles":  # the tensor-core body
        if N % TILE_N:
            raise ValueError(f"gemv_gp: N={N} is not a multiple of {TILE_N} at m={m}")
        _, splits, per = launch_plan("gemv_gp", layout, x.dtype, m, K, N, _card(x))
        partial = (torch.empty((splits, m, N), dtype=torch.float32, device=x.device)
                   if splits > 1 else None)
        xt = (torch.empty((2 * m * K + m * (K // 32),), dtype=torch.float32, device=x.device)
              if x.dtype == torch.float32 else None)
        err = lib.mlc_gemv_gp_tc(
            LAYOUT_IDS[layout], DTYPE_IDS[x.dtype], x.data_ptr(),
            None if xt is None else xt.data_ptr(), wp, sp, zp,
            None if partial is None else partial.data_ptr(), out.data_ptr(), m, K, N, sym,
            out_f32, splits, per, _stream(x))
    else:
        _, parts, per = launch_plan("gemv_gp", layout, x.dtype, m, K, N, _card(x))
        st = _stream(x)
        partial, tickets = _stream_scratch(x, m, N, parts, st)
        err = lib.mlc_gemv_gp(
            LAYOUT_IDS[layout], DTYPE_IDS[x.dtype], x.data_ptr(), wp, sp, zp,
            None if partial is None else partial.data_ptr(),
            None if tickets is None else tickets.data_ptr(), out.data_ptr(), m, K, N, out_f32,
            parts, per, st)
    check_launch(err, "gemv_gp")
    gemv_gp.launches += 1
    return out


gemv_gp.launches = 0


def gemm_qs(x, data, scale, zero, layer=None, out_dtype=torch.bfloat16):
    """Tiled dequant GEMM, qsplit order; same arguments as gemv_qs, m up
    to 2048."""
    if x.device.type == "cpu":
        return gemm_qs_plain(x, _layer_view(data, layer), _layer_view(scale, layer),
                             _layer_view(zero, layer), out_dtype)
    _check_int4("gemm_qs", x, data, scale, zero, layer, out_dtype)
    m, K = x.shape
    N = data.shape[-1]
    if not 1 <= m <= GEMM_MAX_M:
        raise ValueError(f"gemm_qs: m={m} outside 1..{GEMM_MAX_M}")
    if N % TILE_N:
        raise ValueError(f"gemm_qs: N={N} is not a multiple of {TILE_N}")
    wp, sp, zp = _ptrs(data, scale, zero, layer)
    _check_tma("gemm_qs", x.data_ptr(), wp, sp, zp)
    f32 = x.dtype == torch.float32
    mt, splits, per = launch_plan("gemm_qs", "qsplit", x.dtype, m, K, N, _card(x))
    lib = load_kernel("dequant_gemm_qs", _GEMM_ARGS)
    # f32: the prologue's TF32 hi and lo planes of x
    xt = torch.empty((2, m, K), dtype=torch.float32, device=x.device) if f32 else None
    partial = (torch.empty((splits, m, N), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    out = torch.empty((m, N), dtype=out_dtype, device=x.device)
    err = lib.mlc_gemm_qs(
        DTYPE_IDS[x.dtype], x.data_ptr(), None if xt is None else xt.data_ptr(), wp, sp, zp,
        None if partial is None else partial.data_ptr(), out.data_ptr(), m, K, N,
        int(zero is None), int(out_dtype == torch.float32), mt, splits, per, _stream(x))
    check_launch(err, "gemm_qs")
    gemm_qs.launches += 1
    return out


gemm_qs.launches = 0


def _pairs_scratch(layout: str, x: torch.Tensor) -> Optional[torch.Tensor]:
    """gemm_pairs' prologue output for x [m, K]: bf16/f16 pair the offset
    plane [m, 16 * K/128] (per 128-k stage, each group's sum of its pair
    sums as three terms in x's dtype); f32 the TF32 hi and lo planes of x
    [2, m, Kp] (pair: Kp = K + K/8, the groups' pair-sum columns after K);
    bf16/f16 hsplit none."""
    m, K = x.shape
    if x.dtype == torch.float32:
        kp = K + K // 8 if layout == "pair" else K
        return torch.empty((2, m, kp), dtype=torch.float32, device=x.device)
    if layout == "pair":
        return torch.empty((m, 16 * (K // 128)), dtype=x.dtype, device=x.device)
    return None


def gemm_pairs(x, data, scale, zero, layout: str, layer=None, out_dtype=torch.bfloat16):
    """Tiled dequant GEMM for the pair and hsplit orders; the arguments of
    gemv_gp, m up to 2048."""
    if x.device.type == "cpu":
        return gemm_pairs_plain(x, _layer_view(data, layer), _layer_view(scale, layer),
                                _layer_view(zero, layer), layout, out_dtype)
    _check_int4("gemm_pairs", x, data, scale, zero, layer, out_dtype, layout)
    m, K = x.shape
    N = data.shape[-1]
    if not 1 <= m <= GEMM_MAX_M:
        raise ValueError(f"gemm_pairs: m={m} outside 1..{GEMM_MAX_M}")
    if N % TILE_N:
        raise ValueError(f"gemm_pairs: N={N} is not a multiple of {TILE_N}")
    wp, sp, zp = _ptrs(data, scale, zero, layer)
    _check_tma("gemm_pairs", x.data_ptr(), wp, sp, zp)
    mt, splits, per = launch_plan("gemm_pairs", layout, x.dtype, m, K, N, _card(x))
    lib = load_kernel("dequant_gemm_pairs", _PAIRS_ARGS)
    xt = _pairs_scratch(layout, x)
    partial = (torch.empty((splits, m, N), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    out = torch.empty((m, N), dtype=out_dtype, device=x.device)
    err = lib.mlc_gemm_pairs(
        LAYOUT_IDS[layout], DTYPE_IDS[x.dtype], x.data_ptr(),
        None if xt is None else xt.data_ptr(), wp, sp, zp,
        None if partial is None else partial.data_ptr(), out.data_ptr(), m, K, N,
        int(zero is None), int(out_dtype == torch.float32), mt, splits, per, _stream(x))
    check_launch(err, "gemm_pairs")
    gemm_pairs.launches += 1
    return out


gemm_pairs.launches = 0


def gemv_gp3(x, data, scale, layer=None, out_dtype=torch.bfloat16):
    """int3/u16 group-partial GEMV (q3*_s16, sym, group 40). x: [m <= 2,
    40G] bf16 or f16; data int16 [8G, N] or [L, 8G, N] (then pass
    `layer`); scale [G, N] like data, in x's dtype, G % 16 == 0. Returns
    [m, N] in out_dtype."""
    if x.device.type == "cpu":
        return gemv_gp3_plain(x, _layer_view(data, layer), _layer_view(scale, layer), out_dtype)
    _check_cuda_args("gemv_gp3", x, data, scale, None, layer, out_dtype,
                     word_dtype=torch.int16, k_per_row=5, group_k=40, g_mult=16, n_mult=8,
                     dtypes=_PLANE_DTYPES)
    m = x.shape[0]
    G, N = scale.shape[-2:]
    if not 1 <= m <= GP3_MAX_M:
        raise ValueError(f"gemv_gp3: m={m} outside 1..{GP3_MAX_M}")
    lib = load_kernel("dequant_gemv_gp3", _GP3_ARGS)
    wp, sp, _ = _ptrs(data, scale, None, layer)
    _check_tma("gemv_gp3", x.data_ptr(), wp, sp)
    _, parts, per = launch_plan("gemv_gp3", "int3_u16", x.dtype, m, x.shape[1], N, _card(x))
    st = _stream(x)
    partial, tickets = _stream_scratch(x, m, N, parts, st)
    out = torch.empty((m, N), dtype=out_dtype, device=x.device)
    err = lib.mlc_gemv_gp3(DTYPE_IDS[x.dtype], x.data_ptr(), wp, sp,
                           None if partial is None else partial.data_ptr(),
                           None if tickets is None else tickets.data_ptr(), out.data_ptr(), m, G,
                           N, int(out_dtype == torch.float32), parts, per, st)
    check_launch(err, "gemv_gp3")
    gemv_gp3.launches += 1
    return out


gemv_gp3.launches = 0


def gemm_plane(x, data, scale, zero, spec: QuantSpec, layer=None, out_dtype=torch.bfloat16):
    """Plane dequant GEMM for int3 (u32/u16 words), fp4 and int8, at any m
    up to 2048. x: [m, K_stored] bf16 or f16; data [KW, N] words or an
    int8 plane [K, N] (or [L, ...], then pass `layer`); scale/zero [G, N]
    like data, in x's dtype; zero None unless asym (the plain version's
    only: the kernel's formats are sym). Returns [m, N]."""
    if x.device.type == "cpu":
        return gemm_plane_plain(x, _layer_view(data, layer), _layer_view(scale, layer),
                                _layer_view(zero, layer), spec, out_dtype)
    fmt = PLANE_FORMATS.get((spec.mode, spec.storage, spec.group_size))
    if fmt is None or not spec.sym or zero is not None:
        raise NotImplementedError(
            f"gemm_plane: no CUDA kernel for {'sym' if spec.sym else 'asym'} "
            f"{spec.mode}/{spec.storage}/group {spec.group_size} (sym formats: "
            f"{sorted(PLANE_FORMATS)})")
    epw = 1 if spec.storage == "i8" else spec.elems_per_word
    _check_cuda_args("gemm_plane", x, data, scale, None, layer, out_dtype,
                     word_dtype=_WORD_DTYPES[spec.storage], k_per_row=epw,
                     group_k=spec.group_size, n_mult=TILE_N, dtypes=_PLANE_DTYPES)
    m = x.shape[0]
    G, N = scale.shape[-2:]
    rows = data.shape[-2]
    if not 1 <= m <= GEMM_MAX_M:
        raise ValueError(f"gemm_plane: m={m} outside 1..{GEMM_MAX_M}")
    wp, sp, _ = _ptrs(data, scale, None, layer)
    _check_tma("gemm_plane", x.data_ptr(), wp, sp)
    mt, splits, per = launch_plan("gemm_plane", plan_format("gemm_plane", spec), x.dtype, m,
                                  x.shape[1], N, _card(x))
    lib = load_kernel("dequant_gemm_plane", _PLANE_ARGS)
    # x in the plane-transposed order (+ int3's word-sum plane), rows of
    # the word count rounded up to 8 (16 bytes): the prologue's output
    planes = 0 if spec.storage == "i8" else epw + int(spec.mode == "int3")
    xt = (torch.empty((planes, m, -(-rows // 8) * 8), dtype=x.dtype, device=x.device)
          if planes else None)
    partial = (torch.empty((splits, m, N), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    out = torch.empty((m, N), dtype=out_dtype, device=x.device)
    err = lib.mlc_gemm_plane(
        fmt, DTYPE_IDS[x.dtype], x.data_ptr(), None if xt is None else xt.data_ptr(), wp, sp,
        None if partial is None else partial.data_ptr(), out.data_ptr(), m, G, N, mt, splits,
        per, spec.max_int, int(out_dtype == torch.float32), _stream(x))
    check_launch(err, "gemm_plane")
    gemm_plane.launches += 1
    return out


gemm_plane.launches = 0


def dense_matmul(x, w: QuantizedTensor, out_dtype=None, layer=None):
    """Dequantize (layer `layer` of a stacked w) in x's dtype, then
    multiply: the path without a kernel, as JAX leaves it to XLA
    (``mlc_llm_tpu/ops/matmul.py:78-79``, ``jnp.matmul(x, wd,
    preferred_element_type=out_dtype)``). On CUDA the product runs in x's
    dtype on the tensor cores with f32 accumulation: ``torch.matmul`` when
    the output is in x's dtype, else an f32-output ``torch.mm`` (f32 x:
    full f32, TF32 off). On the CPU both operands go to f32 first (the same
    values: products of two bf16/f16 values are exact in f32)."""
    if layer is not None:
        w = w.map(lambda t: t[layer])
    wd = dequantize(w, dtype=x.dtype)
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return torch.matmul(x.float(), wd.float()).to(out_dtype)
    if out_dtype == x.dtype:
        return torch.matmul(x, wd)
    y = torch.mm(x.reshape(-1, x.shape[-1]), wd, out_dtype=torch.float32)
    return y.reshape(*x.shape[:-1], wd.shape[1]).to(out_dtype)


def dequant_matmul(x, w: QuantizedTensor, out_dtype=None, layer=None):
    """x: [..., k] @ dequant(w) -> [..., n] through the kernel that
    `route` picks (gemv_gp3, gemv_qs, gemv_gp, gemm_qs, gemm_pairs or
    gemm_plane). `layer` selects a layer of a stacked w (the kernels'
    pointer offset). A split-order weight whose groups the TPU kernels
    cannot block is dequantized and multiplied, as JAX does here
    (:1863-1870), and so is any weight above m = 2048 rows, as JAX's
    qmatmul does (``mlc_llm_tpu/ops/matmul.py`` prefill_kernel_max_m)."""
    spec = w.spec
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    kind = route(spec, w.n_groups, x2.shape[0])
    if kind == "dense":
        return dense_matmul(x, w, out_dtype, layer)
    rows = w.data.shape[-2]
    k_stored = rows if spec.storage == "i8" else rows * spec.elems_per_word
    if x2.shape[1] != k_stored:
        # zero activations over the padded groups (their scales are zero)
        x2 = torch.nn.functional.pad(x2, (0, k_stored - x2.shape[1]))
    x2 = x2.contiguous()
    if kind == "gemv_gp3":
        y = gemv_gp3(x2, w.data, w.scale, layer=layer, out_dtype=out_dtype)
    elif kind == "gemm_plane":
        y = gemm_plane(x2, w.data, w.scale, w.zero, spec, layer=layer, out_dtype=out_dtype)
    elif kind in ("gemv_gp", "gemm_pairs"):
        fn = gemv_gp if kind == "gemv_gp" else gemm_pairs
        y = fn(x2, w.data, w.scale, w.zero, spec.layout, layer=layer, out_dtype=out_dtype)
    else:
        fn = gemv_qs if kind == "gemv_qs" else gemm_qs
        y = fn(x2, w.data, w.scale, w.zero, layer=layer, out_dtype=out_dtype)
    return y[:, : w.shape[1]].reshape(*lead, w.shape[1])
