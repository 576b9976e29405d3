"""The Hopper GEMMs' design on the CPU: the launch plan, the qsplit bit
assembly, and each kernel's k order, emulated in torch.

csrc/dequant_gemm_qs.cu (bf16/f16) and csrc/dequant_gemm_plane.cu run the
wgmma mainloop of csrc/dequant_wgmma.cuh, which only the card runs
(tests/test_torch_cuda.py). What the CPU can hold is the arithmetic around
it:

- `gemm_tiles`, the Python plan of m tile, split-K parts and stages per
  part, at every main-path shape;
- the qsplit bf16x2 (and f16x2) bit assembly of 16 + q, bit for bit
  against JAX's `_qs_planes_bf16` (as the JAX suite runs it on the CPU)
  and `_codes16`;
- a torch emulation of each kernel's k order, built from the register
  fragments a thread holds (lane (g, c) of warp w: channels 16w + g and
  +8, k pairs 2c and 2c + 8 of a k16 step): qsplit walks 8 word rows a
  stage, one k16 step per quarter; the plane kernel walks 16 words a
  stage, one k16 step per field of the plane-transposed x_t, and for int3
  one more step of the word-sum plane against off = bf16(-max_int * s).
  The weights round where the kernels round (one bf16 or f16 product, one
  sum for qsplit), so the emulation meets the plain versions up to f32
  sums in another order: 1e-5 relative (atol 1e-5 of the output's max)
  before the output rounding, f32 out. Against the JAX kernels in
  interpret mode it holds 1e-2, the tolerance of
  tests/test_torch_{kernels,lowbit_kernels}.py (XLA's CPU fusion rounds
  elsewhere).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlc_llm_tpu.ops.pallas.dequant_matmul import (
    _dequant_matmul_2d,
    _dequant_matmul_stacked_generic_2d,
    _qs_planes_bf16,
)
from mlc_llm_tpu.ops.pallas.dequant_matmul import dequant_matmul as jdm
from mlc_llm_tpu.ops.pallas.dequant_matmul import dequant_matmul_stacked as jdms
from mlc_llm_tpu.quant import quantize as jquantize
from mlc_llm_tpu.quant.spec import QUANT_PRESETS as JPRESETS
from mlc_llm_tpu_torch.models.convert import params_from_jax, tensor_from_numpy
from mlc_llm_tpu_torch.ops import dequant_matmul as dm
from mlc_llm_tpu_torch.quant.groupwise import _unpack_words, words_per_group

torch.set_num_threads(2)

JAX_TOL = dict(atol=1e-2, rtol=1e-2)
SMS = 132

# (name, stored k, stored n) of the main paths: Vicuna-7B q4 (K = 11008 as
# 352 groups), the GPT-NeoX 3B width (K = 2560 as 96 groups), Vicuna-7B
# q3bf16_s16 (K = 4096 as 128 groups of 40, 11008 as 288)
VICUNA = [("wqkv", 4096, 12288), ("wo", 4096, 4096), ("w_in", 4096, 22528),
          ("w_out", 11264, 4096), ("lm_head", 4096, 32768)]
NEOX_3B = [("wqkv", 3072, 7680), ("wo", 3072, 2560), ("w_in", 3072, 10240),
           ("w_out", 10240, 2560), ("lm_head", 3072, 51200)]
Q3 = [("wqkv", 5120, 12288), ("wo", 5120, 4096), ("w_in", 5120, 22528),
      ("w_out", 11520, 4096), ("lm_head", 5120, 32768)]
PLAN_CASES = ([("gemm_qs", "vicuna") + s for s in VICUNA]
              + [("gemm_qs", "3b") + s for s in NEOX_3B]
              + [("gemm_plane", "q3") + s for s in Q3])


def _steps(kernel, k):
    if kernel == "gemm_qs":
        return k // dm.QS_STAGE_K
    return -(-(k // 5) // dm.PLANE_STAGE_ROWS[1])  # q3bf16_s16: 5 k a u16 word


def _plan(kernel, k, n, m):
    """(compiled m tiles, the time model gemm_tiles priced, the plan):
    gemm_qs on QS_PLAN (bf16/f16); gemm_plane (q3bf16_s16) through
    plane_tiles, on its format's time model at the chosen m tile."""
    if kernel == "gemm_qs":
        widths, times = dm.QS_PLAN[False]
        return widths, times, dm.gemm_tiles(m, n, _steps(kernel, k), widths, times=times)
    plan = dm.plane_tiles(1, m, n, k // 5)
    return dm.PLANE_WIDTHS[1], (*dm.PLANE_TIMES[1][plan[0]], plan[0]), plan


@pytest.mark.parametrize("m", [8, 9, 128, 2047, 2048])
@pytest.mark.parametrize("kernel,model,name,k,n", PLAN_CASES)
def test_gemm_tiles_plan(kernel, model, name, k, n, m):
    # both kernels plan on a time model: gemm_qs on QS_PLAN, gemm_plane on
    # its format's PLANE_TIMES at the m tile it picks
    widths, times, (mt, parts, per) = _plan(kernel, k, n, m)
    steps = _steps(kernel, k)
    assert mt in widths and (mt >= m or mt == widths[-1])
    # part p covers stages [p * per, (p + 1) * per): each stage in one
    # part, no part empty
    covered = [t for p in range(parts) for t in range(p * per, min(steps, (p + 1) * per))]
    assert covered == list(range(steps))
    assert all(p * per < steps for p in range(parts))
    assert 1 <= parts <= dm.MAX_SPLITS
    # no split count is 5% cheaper under the time model (a block's fixed
    # cost can make one short wave the fastest plan)
    stage_us, block_us, fit_mt = times

    def cost(pt, pr):
        c = -(-(n // dm.TILE_N) * -(-m // mt) * pt // SMS) * (
            pr * stage_us * mt / fit_mt + block_us)
        return c + (pt * m * n * 8 / dm.HBM_BYTES_PER_US if pt > 1 else 0.0)

    for s in range(1, min(steps, dm.MAX_SPLITS) + 1):
        p_per = -(-steps // s)
        assert cost(-(-steps // p_per), p_per) >= 0.95 * cost(parts, per) - 1e-9


def test_gemm_tiles_splits_only_where_needed():
    # prefill at m = 2048 never splits (the tiles fill the card); decode
    # widths split at wo, and to even out w_in's last wave
    widths, times = dm.QS_PLAN[False]
    assert dm.gemm_tiles(2048, 4096, 64, widths, times=times) == (256, 1, 64)
    assert dm.gemm_tiles(128, 22528, 64, widths, times=times) == (128, 1, 64)
    assert dm.plane_tiles(1, 8, 4096, 1024)[1] > 1
    assert dm.plane_tiles(1, 8, 22528, 1024)[1] > 1
    assert dm.plane_tiles(1, 2048, 22528, 1024) == (256, 1, 64)


# gemm_plane's m tiles by format (PLANE_FORMATS ids: int3/u32, int3/u16,
# fp4, int8): 256 where three ring stages of the format's x tiles fit in a
# 225 KB ring (kRingBytes; 6, 8 and 4 tiles of [256][32 bytes] a stage,
# plus the word and scale tiles), 128 for int3/u32's 11, which keeps the
# mainloop's 200 KB ring
PLANE_STAGE_TILES = {0: 11, 1: 6, 2: 8, 3: 4}


@pytest.mark.parametrize("fmt", sorted(PLANE_STAGE_TILES))
def test_plane_widths_fit_the_ring(fmt):
    widths = dm.PLANE_WIDTHS[fmt]
    assert widths[:3] == (16, 64, 128) and set(dm.PLANE_TIMES[fmt]) == set(widths)
    word = {0: 4, 1: 2, 2: 4, 3: 1}[fmt]
    rows = dm.PLANE_STAGE_ROWS[fmt]
    wpg = {0: 4, 1: 8, 2: 4, 3: 32}[fmt]

    def stage(mt):  # 1024-aligned x tiles, word tile and scale tile
        al = lambda b: -(-b // 1024) * 1024  # noqa: E731
        return al(PLANE_STAGE_TILES[fmt] * mt * 32) + al(rows * 128 * word) + al(
            max(rows // wpg, 1) * 128 * 2)

    ring = 225 * 1024 if 256 in widths else 200 * 1024
    for mt in widths:
        assert ring // stage(mt) >= 3
    # the next width up is compiled where it fits
    assert (256 in widths) == ((225 * 1024) // stage(256) >= 3)


@pytest.mark.parametrize("fmt,rows", [(1, 1024), (1, 2304), (0, 512), (2, 512), (3, 4096)])
@pytest.mark.parametrize("m", [1, 8, 16, 17, 64, 65, 128, 129, 255, 256, 257, 2047, 2048])
@pytest.mark.parametrize("n", [4096, 22528])
def test_plane_tiles_plan(fmt, rows, m, n):
    widths = dm.PLANE_WIDTHS[fmt]
    mt, parts, per = dm.plane_tiles(fmt, m, n, rows)
    steps = -(-rows // dm.PLANE_STAGE_ROWS[fmt])
    # the narrowest compiled tile that holds m, the widest above
    assert mt == next((w for w in widths if w >= m), widths[-1])
    assert (mt, parts, per) == dm.gemm_tiles(m, n, steps, widths,
                                             times=(*dm.PLANE_TIMES[fmt][mt], mt))
    assert 1 <= parts <= dm.MAX_SPLITS and (parts - 1) * per < steps <= parts * per


# ---- the qsplit bit assembly ----

def _field_bits(words: torch.Tensor, f: int, dtype) -> torch.Tensor:
    """csrc/dequant_gemm_qs.cu field16: field f of u32 words [W, N] as the
    bits of 16 + q in `dtype` (bf16: (w >> s & 0x00780078) | 0x41804180;
    f16: q at mantissa bits 6-9 under 0x4C00), [2W, N], row 2r + h the
    half h of word r."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    if dtype == torch.bfloat16:
        t = (w << 3) if f == 0 else (w >> (4 * f - 3))
        bits = (t & 0x00780078) | 0x41804180
    else:
        t = (w << 6) if f == 0 else (w << 2) if f == 1 else (w >> (4 * f - 6))
        bits = (t & 0x03C003C0) | 0x4C004C00
    halves = torch.stack([bits & 0xFFFF, bits >> 16], dim=1).reshape(-1, words.shape[1])
    return halves.to(torch.int32).to(torch.int16).view(dtype)


@pytest.fixture(scope="module")
def qs_weight():
    rng = np.random.default_rng(3)
    jq = jquantize((rng.standard_normal((1024, 256)) * 0.05).astype(np.float32), "q4bf16")
    return jq, params_from_jax(jax.tree.map(np.asarray, jq))


@pytest.mark.parametrize("f", [0, 1, 2, 3])
def test_qs_bit_assembly_matches_jax_planes(qs_weight, f):
    jq, tq = qs_weight
    got = _field_bits(tq.data, f, torch.bfloat16)
    want = np.asarray(_qs_planes_bf16(jq.data, f, True))
    assert np.array_equal(got.view(torch.int16).numpy(), want.view(np.int16))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("f", [0, 1, 2, 3])
def test_qs_bit_assembly_matches_codes16(qs_weight, f, dtype):
    # plane f row 2r + h is element f*(K/4) + 2r + h: the exact value 16 + q
    _, tq = qs_weight
    K = tq.data.shape[0] * 8
    want = dm._codes16(tq.data)[f * K // 4:(f + 1) * K // 4]
    got = _field_bits(tq.data, f, dtype)
    assert torch.equal(got.float(), want)


# ---- the kernels' k order ----

def _fragment_k(rows_of_pair):
    """The k16 step's register layout: for each k in 0..15 the (c, j, h)
    that holds it (a[2j + .] of lane c holds k = 2c + 8j + h) mapped to
    the source row rows_of_pair(c, j) + h of the step's data."""
    idx = []
    for k in range(16):
        c, j, h = (k % 8) // 2, k // 8, k % 2
        idx.append(rows_of_pair(c, j) + h)
    return idx


def emulate_gemm_qs(x, words, scale, zero, dtype):
    """gemm_qs's mainloop in torch: stage t (word rows 8t..8t+7), quarter
    f: A [N, 16] from the words a thread reads (word rows c and c + 4 of
    the stage: k pairs 2c and 2c + 8), w = T(T((16+q)*s) + off), B = x's
    quarter f at k 16t..16t+15; acc += B @ A^T in f32. Returns f32 [m, N]."""
    m, K = x.shape
    G, N = scale.shape
    kq = K // 4
    acc = torch.zeros((m, N), dtype=torch.float32)
    rows = _fragment_k(lambda c, j: 2 * (c + 4 * j))  # word row c + 4j holds k 2(c+4j) + h
    for t in range(K // 64):
        for f in range(4):
            plane = _field_bits(words[8 * t:8 * t + 8], f, dtype)  # [16, N], row 2r + h
            g = f * (G // 4) + t // 2
            s = scale[g].to(dtype)
            off = s * -23 if zero is None else zero[g].to(dtype) - s * 16
            a = (plane[rows] * s + off).float()  # [16, N]: T ops, each rounded
            b = x[:, f * kq + 16 * t:f * kq + 16 * t + 16].float()
            acc += b @ a
    return acc


def emulate_gemm_plane(x, data, scale, spec):
    """gemm_plane's mainloop in torch: the prologue's x_t [planes, m, KW]
    (fields, and int3's bf16 word sums), then per stage of 16 words and per
    field f: A [N, 16] = bf16(value * s) of words 2c, 2c+1, 2c+8, 2c+9 of
    the chunk, B = x_t[f] at the chunk; int3 adds the word-sum plane
    against off = bf16(-max_int * s). int8 reads x as its one plane. Past
    the stored words everything reads zero (TMA's fill, the padded x_t).
    Returns f32 [m, N]."""
    m, K = x.shape
    G, N = scale.shape
    i8 = spec.storage == "i8"
    epw = 1 if i8 else spec.elems_per_word
    wpg = spec.group_size if i8 else words_per_group(spec)
    kw = data.shape[0]
    xt = x.reshape(m, kw, epw).permute(2, 0, 1)
    if spec.mode == "int3":
        xt = torch.cat([xt, x.float().reshape(m, kw, epw).sum(2).to(x.dtype)[None]])
    if i8:
        vals = data.to(torch.bfloat16).reshape(kw, 1, N)
    else:
        codes = _unpack_words(data, spec).reshape(kw, epw, N)
        vals = (dm._f4_to_float(codes, torch.bfloat16) if spec.mode == "fp4"
                else codes.to(torch.bfloat16))
    pad = -kw % 16
    xt = torch.nn.functional.pad(xt, (0, pad))
    vals = torch.nn.functional.pad(vals, (0, 0, 0, 0, 0, pad))
    s_rows = torch.nn.functional.pad(scale[torch.arange(kw) // wpg], (0, 0, 0, pad))
    order = _fragment_k(lambda c, j: 2 * c + 8 * j)  # words 2c + 8j + h of the chunk
    acc = torch.zeros((m, N), dtype=torch.float32)
    for kw0 in range(0, kw + pad, 16):
        idx = [kw0 + k for k in order]
        s = s_rows[idx]
        for f in range(xt.shape[0]):
            a = vals[idx, f] * s if f < epw else s * -spec.max_int
            acc += xt[f][:, idx].float() @ a.float()
    return acc


def _bf16_bits(b):
    """int64 tensor of 16-bit patterns -> bf16 tensor"""
    return (((b & 0xFFFF) ^ 0x8000) - 0x8000).to(torch.int16).view(torch.bfloat16)


def _step_values(lo, hi, f, spec):
    """The kernel's value_pair from a chunk's register words: lo and hi
    the low and high word of each pair (int64, the stored bits), packed
    into one register as fetch() packs them (int3/u16 lo | hi << 16; fp4 the
    half of four fields, 16 bits of each word). Returns the
    unscaled bf16 values of field f, [2 * pairs, N], pair rows interleaved."""
    if spec.storage == "i8":
        v = torch.stack([lo, hi], 1).to(torch.int8).to(torch.bfloat16)
        return v.reshape(-1, lo.shape[1])
    if spec.mode == "fp4":
        # fetched in two halves of four fields, a pair packed into one
        # register; both codes converted at once, one a 16-bit lane
        p = ((lo & 0xFFFF) | (hi << 16)) if f < 4 else ((lo >> 16) | (hi & 0xFFFF0000))
        t = (p >> (4 * (f % 4))) & 0x000F000F
        e = t & 0x00070007
        nz = ((e | (e >> 1) | (e >> 2)) & 0x00010001) * 0xFFFF
        bits = (((e + 0x00780078) << 7) | ((t & 0x00080008) << 12)) & nz
        return _bf16_bits(torch.stack([bits, bits >> 16], 1)).reshape(-1, lo.shape[1])
    if spec.storage == "u16":
        t = (((lo | (hi << 16)) >> (3 * f)) & 0x00070007) | 0x43004300
    else:
        t = ((lo >> (3 * f)) & 7) | (((hi >> (3 * f)) & 7) << 16) | 0x43004300
    halves = _bf16_bits(torch.stack([t, t >> 16], 1)).reshape(-1, lo.shape[1])
    return (halves.float() - 128.0).to(torch.bfloat16)  # exact: __hsub2 of 128


def emulate_gemm_plane_streamed(x, data, scale, spec):
    """gemm_plane's mainloop as the kStream policy runs it: per chunk of 16
    words the thread's words and scales are fetched once (int3/u16 packed
    into one register a pair), then each k16 step's A is dequantized from
    them alone and its MMA issued, step after step. Returns f32 [m, N]."""
    m, K = x.shape
    G, N = scale.shape
    i8 = spec.storage == "i8"
    epw = 1 if i8 else spec.elems_per_word
    wpg = spec.group_size if i8 else words_per_group(spec)
    kw = data.shape[0]
    xt = x.reshape(m, kw, epw).permute(2, 0, 1)
    if spec.mode == "int3":
        xt = torch.cat([xt, x.float().reshape(m, kw, epw).sum(2).to(x.dtype)[None]])
    pad = -kw % 16
    xt = torch.nn.functional.pad(xt, (0, pad))
    bits = {"u32": 0xFFFFFFFF, "u16": 0xFFFF, "i8": 0xFF}[spec.storage]
    words = torch.nn.functional.pad(data.to(torch.int64) & bits, (0, 0, 0, pad))
    s_rows = torch.nn.functional.pad(scale[torch.arange(kw) // wpg], (0, 0, 0, pad))
    neg_max = torch.tensor(-spec.max_int, dtype=torch.bfloat16)
    acc = torch.zeros((m, N), dtype=torch.float32)
    for kw0 in range(0, kw + pad, 16):
        lo, hi = words[kw0:kw0 + 16:2], words[kw0 + 1:kw0 + 16:2]  # the chunk's pairs
        s = s_rows[kw0:kw0 + 16]
        for f in range(xt.shape[0]):  # one k16 step, A in natural k order
            a = _step_values(lo, hi, f, spec) * s if f < epw else s * neg_max
            acc += xt[f][:, kw0:kw0 + 16].float() @ a.float()
    return acc


def test_fragment_k_is_the_natural_order():
    # a[2j + .] of lane c holds k = 2c + 8j + h; qsplit word row c + 4j
    # holds k 2(c + 4j) + h of its quarter, plane word 2c + 8j + h is k:
    # both kernels read B in natural k order
    assert _fragment_k(lambda c, j: 2 * (c + 4 * j)) == list(range(16))
    assert _fragment_k(lambda c, j: 2 * c + 8 * j) == list(range(16))


def _close_f32(got, want):
    tol = 1e-5 * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=tol)


@pytest.mark.parametrize("preset", ["q4bf16", "q4bf16_sym", "q4f16"])
@pytest.mark.parametrize("stacked", [False, True], ids=["flat", "stacked"])
def test_gemm_qs_k_order_matches_plain_and_jax(preset, stacked):
    rng = np.random.default_rng(4)
    spec = dataclasses.replace(JPRESETS[preset], layout="qsplit")  # sym is pair order
    qts = [jquantize((rng.standard_normal((1024, 256)) * 0.05).astype(np.float32), spec)
           for _ in range(2)]
    jq = qts[1]
    tq = params_from_jax(jax.tree.map(np.asarray, jq))
    dt = jnp.dtype(tq.spec.dtype)
    xj = jnp.asarray(rng.standard_normal((9, 1024)) * 0.1, dt)
    xt = tensor_from_numpy(np.asarray(xj))
    got = emulate_gemm_qs(xt, tq.data, tq.scale, tq.zero, xt.dtype)
    _close_f32(got, dm.gemm_qs_plain(xt, tq.data, tq.scale, tq.zero, torch.float32))
    if stacked:
        jst = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs, 0), *qts)
        want = jdms(xj, jst, jnp.int32(1))
        got = got.to(xt.dtype)
    else:
        want = jdm(xj, jq, out_dtype=jnp.float32)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **JAX_TOL)


# 16 groups each, and group counts that are no multiple of the 16-word
# chunk (q3bf16: 5 groups are 20 words; q3bf16_s16: 3 groups, 24 words)
PLANE_CASES = [("q3bf16_s16", 640), ("q3bf16", 640), ("fp4bf16", 512), ("q8bf16", 512),
               ("q3bf16", 200), ("q3bf16_s16", 120)]


@pytest.mark.parametrize("preset,k", PLANE_CASES)
@pytest.mark.parametrize("stacked", [False, True], ids=["flat", "stacked"])
def test_gemm_plane_k_order_matches_plain_and_jax(preset, k, stacked):
    rng = np.random.default_rng(5)
    qts = [jquantize((rng.standard_normal((k, 256)) * 0.05).astype(np.float32), preset)
           for _ in range(2)]
    jq = qts[1]
    tq = params_from_jax(jax.tree.map(np.asarray, jq))
    spec = tq.spec
    rows = tq.data.shape[0]
    k_stored = rows if spec.storage == "i8" else rows * spec.elems_per_word
    xj = jnp.asarray(rng.standard_normal((9, k)) * 0.1, jnp.bfloat16)
    xt = torch.nn.functional.pad(tensor_from_numpy(np.asarray(xj)), (0, k_stored - k))
    got = emulate_gemm_plane(xt, tq.data, tq.scale, spec)
    _close_f32(got, dm.gemm_plane_plain(xt, tq.data, tq.scale, None, spec, torch.float32))
    if stacked:
        jst = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs, 0), *qts)
        want = _dequant_matmul_stacked_generic_2d(
            xj, jnp.asarray([1], jnp.int32), jst.data, jst.scale, jst.zero, spec=jst.spec,
            shape=jst.shape, out_dtype=jnp.bfloat16, interpret=True)
        got = got.to(torch.bfloat16)
    else:
        want = _dequant_matmul_2d(xj, jq.data, jq.scale, jq.zero, spec=jq.spec, shape=jq.shape,
                                  out_dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(got.float().numpy()[:, :256], np.asarray(want, np.float32),
                               **JAX_TOL)


@pytest.mark.parametrize("preset,k", PLANE_CASES + [("q3bf16_s16", 4000), ("fp4bf16", 1024)])
def test_gemm_plane_streamed_k_order_is_bit_equal(preset, k):
    # A streamed per k16 step from the chunk's register words (kStream)
    # adds the same products in the same k order as the stage-at-once
    # loop: the f32 sums are equal bit for bit
    rng = np.random.default_rng(6)
    tq = params_from_jax(jax.tree.map(np.asarray, jquantize(
        (rng.standard_normal((k, 256)) * 0.05).astype(np.float32), preset)))
    spec = tq.spec
    rows = tq.data.shape[0]
    k_stored = rows if spec.storage == "i8" else rows * spec.elems_per_word
    x = torch.nn.functional.pad(
        torch.from_numpy(rng.standard_normal((9, k)) * 0.1).to(torch.bfloat16), (0, k_stored - k))
    got = emulate_gemm_plane_streamed(x, tq.data, tq.scale, spec)
    assert torch.equal(got, emulate_gemm_plane(x, tq.data, tq.scale, spec))
