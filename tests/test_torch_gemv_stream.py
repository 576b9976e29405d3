"""The streaming m = 1 GEMVs on the CPU: each format policy of
csrc/gemv_stream.cuh emulated in torch, and the launch plan.

csrc/gemv_stream.cuh runs the qsplit (csrc/dequant_gemv_qs.cu, QsStream),
pair and hsplit (csrc/dequant_gemv_gp.cu, GpStream) and int3/u16
(csrc/dequant_gemv_gp3.cu, Gp3Stream) bodies on the card only
(tests/test_torch_cuda.py). What the CPU holds:

- a torch emulation of each policy as the kernel computes it: the plan's
  split-K parts (`dm.stream_plan`, or a forced plan), in each part its
  stages in order; per stage the staged x (x_k: the k of each staged value
  of a word row), the codes as the kernel assembles them from the words'
  bits (16 + q as f32 bits 0x41800000 | q << 19; raw q as 0x4B000000 | q
  less 2^23; int3's 8 + q as 0x41000000 | q << 20, from a 32-bit pair of
  u16 columns), each group's f32 partial P summed in the kernel's row
  order, the group sums of x gathered by the kernel's lane map and rounded
  as the TPU bodies round them (qsplit and hsplit once to T; pair the even
  and odd sums each rounded, added in T; int3 each field's sum rounded to
  T, the five added in f32), the fold s * (P - base * sx) + z * sx, and
  the parts summed in part order. Each position's nibble is checked to hold
  the code of the k its staged x holds, each staged value to come from
  that k of the part's x slice as the kernel copies it (a few contiguous
  chunks), and each group's lane map to cover exactly the group's k. Against the plain versions: 1e-5 relative;
  against the JAX kernels in Pallas interpret mode (the dispatchers
  `dequant_matmul` and `dequant_matmul_stacked`, which reach
  `_dequant_matmul_gp_2d` and `_dequant_matmul_gp3_2d` at m = 1 and 2): 1e-2
  in bf16 and f16, atol 1e-4 and rtol 1e-3 in f32, the tolerances of
  tests/test_torch_int4_layouts.py and tests/test_torch_lowbit_kernels.py;
- `stream_plan`, from shapes only, at every Vicuna-7B and GPT-NeoX 3B
  shape and at ragged edges: the parts cover the K stages exactly once,
  none is empty or longer than the staged x slice, and it reads no tensor.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlc_llm_tpu.ops.pallas.dequant_matmul import dequant_matmul as jdm
from mlc_llm_tpu.ops.pallas.dequant_matmul import dequant_matmul_stacked as jdms
from mlc_llm_tpu.quant import quantize as jquantize
from mlc_llm_tpu.quant.groupwise import pad_quantized_groups as jpad
from mlc_llm_tpu.quant.spec import QUANT_PRESETS as JPRESETS
from mlc_llm_tpu_torch.models.convert import params_from_jax, tensor_from_numpy
from mlc_llm_tpu_torch.ops import dequant_matmul as dm
from mlc_llm_tpu_torch.quant.groupwise import _unpack_words

torch.set_num_threads(2)

JAX_TOL = dict(atol=1e-2, rtol=1e-2)
F32_JAX_TOL = dict(atol=1e-4, rtol=1e-3)
ROWS = 16  # word rows a stage (gs::kRows)


def _f32(bits: torch.Tensor) -> torch.Tensor:
    """u32 bit patterns held in int64 -> f32 values."""
    b = bits & 0xFFFFFFFF
    return torch.where(b >= 2**31, b - 2**32, b).to(torch.int32).view(torch.float32)


def _shift(w, sh):
    """w << sh (sh > 0) or w >> -sh, as a 32-bit shift."""
    return (w << sh) & 0xFFFFFFFF if sh >= 0 else w >> -sh


def code16(w, pos):
    """gs::code16: 16 + q, q the nibble at bit pos."""
    return _f32((_shift(w, 19 - pos) & 0x00780000) | 0x41800000)


def code_raw(w, pos):
    """gs::code_raw: 2^23 + q less 2^23."""
    return _f32(((w >> pos) & 0xF) | 0x4B000000) - 8388608.0


def code_plus_8(w, sh):
    """Gp3Stream's code_plus_8: 8 + q, q the 3-bit field at bit sh."""
    return _f32((_shift(w, 20 - sh) & 0x00700000) | 0x41000000)


# the policies: k of a staged value (t, rr, e), the code's bit position in
# its word, its group within the stage, the group's scale row, the fold's
# offset base (asym, sym), the group sum's lane map (lane -> (rr, e)), and
# the part's x slice as the kernel copies it: `chunks` contiguous chunks,
# chunk c from k = chunk_k(c, t0, K), and where a staged value lies in it
# (raw_index(i, rr, e, n) for the part's stage i of n)
POLICIES = {
    "qsplit": dict(
        stage_k=128, groups=4, base=(16.0, 23.0),
        x_k=lambda t, rr, e, K: (e // 2) * (K // 4) + 32 * t + 2 * rr + e % 2,
        pos=lambda rr, e: 4 * (e // 2) + 16 * (e % 2),
        group=lambda rr, e: e // 2,
        scale_row=lambda t, j, G: j * (G // 4) + t,
        lanes=lambda j: [(lane // 2, 2 * j + lane % 2) for lane in range(32)],
        chunks=4, chunk_k=lambda c, t0, K: c * (K // 4) + 32 * t0,
        raw_index=lambda i, rr, e, n: (e // 2) * 32 * n + 32 * i + 2 * rr + e % 2),
    "pair": dict(
        stage_k=128, groups=4, base=(0.0, 7.0),
        x_k=lambda t, rr, e, K: 128 * t + 8 * rr + e,
        pos=lambda rr, e: 4 * e,
        group=lambda rr, e: rr // 4,
        scale_row=lambda t, j, G: 4 * t + j,
        lanes=lambda j: [(4 * j + lane // 8, lane % 8) for lane in range(32)],
        chunks=1, chunk_k=lambda c, t0, K: 128 * t0,
        raw_index=lambda i, rr, e, n: 128 * i + 8 * rr + e),
    "hsplit": dict(
        stage_k=128, groups=4, base=(0.0, 7.0),
        x_k=lambda t, rr, e, K: (0 if e < 4 else K // 2) + 64 * t + 4 * rr + e % 4,
        pos=lambda rr, e: 8 * (e % 4) + 4 * (e // 4),
        group=lambda rr, e: 2 * (e // 4) + rr // 8,
        scale_row=lambda t, j, G: (j // 2) * (G // 2) + 2 * t + j % 2,
        lanes=lambda j: [(8 * (j % 2) + lane // 4, 4 * (j // 2) + lane % 4)
                         for lane in range(32)],
        chunks=2, chunk_k=lambda c, t0, K: c * (K // 2) + 64 * t0,
        raw_index=lambda i, rr, e, n: (e // 4) * 64 * n + 64 * i + 4 * rr + e % 4),
    "int3": dict(
        stage_k=80, groups=2, base=(None, 11.0),
        x_k=lambda t, rr, e, K: 80 * t + 5 * rr + e if e < 5 else -1,
        group=lambda rr, e: rr // 8,
        scale_row=lambda t, j, G: 2 * t + j,
        lanes=lambda j: [(8 * j + lane % 8, i) for lane in range(8) for i in range(5)],
        chunks=1, chunk_k=lambda c, t0, K: 80 * t0,
        raw_index=lambda i, rr, e, n: 80 * i + 5 * rr + e if e < 5 else -1),
}


def _group_sum(order, xg, dtype):
    """The group's sum of x [m, n] (n values in k order), rounded as the
    policy's group_sum rounds it."""
    if order == "pair":
        even = xg[:, 0::2].sum(dim=1).to(dtype).float()
        odd = xg[:, 1::2].sum(dim=1).to(dtype).float()
        return (even + odd).to(dtype).float()
    if order == "int3":  # each field's 8-row sum to T, the five in f32
        return xg.reshape(-1, 8, 5).sum(dim=1).to(dtype).float().sum(dim=1)
    return xg.sum(dim=1).to(dtype).float()


def _codes(order, words, t, rr, e, spec_codes):
    """The f32 codes of staged value e of word row rr of stage t for every
    column, as the kernel assembles them, after checking that the nibble
    holds the code of the k that x_k stages there (spec_codes: the codes in
    k order from the unpacker)."""
    pol = POLICIES[order]
    if order == "int3":
        u16 = words[ROWS * t + rr].to(torch.int64) & 0xFFFF  # [N]
        w32 = u16[0::2] | (u16[1::2] << 16)  # column pair 2c, 2c + 1
        lo, hi = code_plus_8(w32, 3 * e), code_plus_8(w32, 16 + 3 * e)
        vals = torch.stack([lo, hi], dim=1).reshape(-1)
        raw = vals - 8.0
    else:
        w = words[ROWS * t + rr].to(torch.int64) & 0xFFFFFFFF
        pos = pol["pos"](rr, e)
        vals = code16(w, pos) if order == "qsplit" else code_raw(w, pos)
        raw = vals - 16.0 if order == "qsplit" else vals
    return vals, raw


def emulate_stream(order, x, words, scale, zero, parts, per):
    """The streaming GEMV as csrc/gemv_stream.cuh computes it (module doc);
    x [m, K] in the compute dtype, words [rows, N], scale/zero [G, N].
    Returns f32 [m, N]."""
    pol = POLICIES[order]
    m, K = x.shape
    G, N = scale.shape
    dtype = x.dtype
    spec = dm._Q3S16 if order == "int3" else dm._INT4[order]
    spec_codes = _unpack_words(words, spec).float()  # [K, N], k order
    steps = K // pol["stage_k"]
    assert (parts - 1) * per < steps <= parts * per and per <= dm.STREAM_MAX_PER
    base = pol["base"][1 if zero is None else 0]
    xf = x.float()
    out = torch.zeros((m, N))
    stage_x = pol["stage_k"]
    for part in range(parts):
        acc = torch.zeros((m, N))
        t0, n = part * per, min(steps - part * per, per)
        # the k of each element of the part's x slice, chunk after chunk
        ln = n * stage_x // pol["chunks"]
        raw_k = [pol["chunk_k"](c, t0, K) + o for c in range(pol["chunks"]) for o in range(ln)]
        for t in range(t0, t0 + n):
            P = torch.zeros((pol["groups"], m, N))
            ks = {j: [] for j in range(pol["groups"])}
            for rr in range(ROWS):
                for e in range(8):
                    k = pol["x_k"](t, rr, e, K)
                    r = pol["raw_index"](t - t0, rr, e, n)
                    assert (k < 0) == (r < 0) and (k < 0 or raw_k[r] == k)
                    if k < 0:
                        continue
                    vals, raw = _codes(order, words, t, rr, e, spec_codes)
                    assert torch.equal(raw, spec_codes[k]), (order, t, rr, e)
                    j = pol["group"](rr, e)
                    ks[j].append(k)
                    P[j] += xf[:, k:k + 1] * vals[None]
            for j in range(pol["groups"]):
                g = pol["scale_row"](t, j, G)
                gk = pol["stage_k"] // pol["groups"]
                lane_ks = sorted({pol["x_k"](t, rr, e, K) for rr, e in pol["lanes"](j)})
                assert sorted(ks[j]) == lane_ks == list(range(gk * g, gk * g + gk))
                if order == "pair":  # the lanes' parity is the k parity
                    assert all(pol["x_k"](t, rr, e, K) % 2 == lane % 2
                               for lane, (rr, e) in enumerate(pol["lanes"](j)))
                sx = _group_sum(order, xf[:, gk * g:gk * g + gk], dtype)[:, None]
                s = scale[g].float()[None]
                z = 0.0 if zero is None else zero[g].float()[None]
                acc += s * (P[j] - base * sx) + z * sx
        out += acc  # the last part sums the parts in part order
    return out


def _close_f32(got, want):
    tol = 1e-5 * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=tol)


@functools.lru_cache(maxsize=None)
def _quantized(spec, k, n, seed):
    rng = np.random.default_rng(seed)
    return [jpad(jquantize((rng.standard_normal((k, n)) * 0.05).astype(np.float32), spec))
            for _ in range(2)]


def _jax_weights(spec, k, n, seed):
    """Two layers of random weights quantized by the JAX package (cached),
    and a generator for x."""
    return np.random.default_rng(seed + 1000), _quantized(spec, k, n, seed)


# (preset, order): every bit order in bf16, f16 and f32, sym and asym
INT4_CASES = [("q4bf16", "qsplit"), ("q4bf16_sym", "qsplit"), ("q4f16", "qsplit"),
              ("q4f32", "qsplit"), ("q4bf16_pair", "pair"), ("q4bf16_sym", "pair"),
              ("q4f16_pair", "pair"), ("q4f32", "pair"), ("q4bf16_hs", "hsplit"),
              ("q4f16_hs", "hsplit"), ("q4f32", "hsplit"), ("q4bf16_sym", "hsplit")]
K, N = 1024, 384  # 32 groups (qsplit blocks them); a ragged 256-column tile


def _check_against_jax(jq, qts, xj, got, stacked, dtype):
    if stacked:
        jst = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs, 0), *qts)
        want = jdms(xj, jst, jnp.int32(1))
        got = got.to(dtype)
    else:
        want = jdm(xj, jq, out_dtype=jnp.float32)
    tol = F32_JAX_TOL if dtype == torch.float32 else JAX_TOL
    want = np.asarray(want, np.float32)  # [m, the weight's unpadded N]
    np.testing.assert_allclose(got[:, :want.shape[1]].float().numpy(), want, **tol)


@pytest.mark.parametrize("stacked", [False, True], ids=["flat", "stacked"])
@pytest.mark.parametrize("preset,order", INT4_CASES)
def test_int4_stream_matches_plain_and_jax(preset, order, stacked):
    spec = dataclasses.replace(JPRESETS[preset], layout=order)
    rng, qts = _jax_weights(spec, K, N, seed=60)
    jq = qts[1]
    tq = params_from_jax(jax.tree.map(np.asarray, jq))
    kind = dm.route(tq.spec, tq.scale.shape[0], 1)
    assert kind == ("gemv_qs" if order == "qsplit" else "gemv_gp")
    xj = jnp.asarray(rng.standard_normal((1, K)) * 0.1, jnp.dtype(tq.spec.dtype))
    xt = tensor_from_numpy(np.asarray(xj))
    _, parts, per = dm.stream_plan(order, 1, K, N)
    got = emulate_stream(order, xt, tq.data, tq.scale, tq.zero, parts, per)
    if order == "qsplit":
        plain = dm.gemv_qs_plain(xt, tq.data, tq.scale, tq.zero, torch.float32)
    else:
        plain = dm.gemv_gp_plain(xt, tq.data, tq.scale, tq.zero, order, torch.float32)
    _close_f32(got, plain)
    _check_against_jax(jq, qts, xj, got, stacked, xt.dtype)


@pytest.mark.parametrize("parts,per", [(1, 8), (3, 3), (8, 1)])
@pytest.mark.parametrize("preset,order", [("q4bf16", "qsplit"), ("q4f32", "pair"),
                                          ("q4f16_hs", "hsplit")])
def test_int4_stream_any_split_is_the_same_sum(preset, order, parts, per):
    # every plan the kernel takes covers the 8 stages once: the parts' sum
    # holds the plain version whatever the split
    spec = dataclasses.replace(JPRESETS[preset], layout=order)
    rng, qts = _jax_weights(spec, K, 256, seed=61)
    tq = params_from_jax(jax.tree.map(np.asarray, qts[1]))
    x = torch.from_numpy(rng.standard_normal((1, K)) * 0.1).to(getattr(torch, tq.spec.dtype))
    got = emulate_stream(order, x, tq.data, tq.scale, tq.zero, parts, per)
    if order == "qsplit":
        plain = dm.gemv_qs_plain(x, tq.data, tq.scale, tq.zero, torch.float32)
    else:
        plain = dm.gemv_gp_plain(x, tq.data, tq.scale, tq.zero, order, torch.float32)
    _close_f32(got, plain)


@pytest.mark.parametrize("m", [2, 5, 8])
def test_qsplit_f32_stream_at_m_above_1(m):
    # f32 qsplit runs the streaming body at every m <= 8 (no tensor-core
    # body): the tokens share the codes, each its own x and group sums
    spec = dataclasses.replace(JPRESETS["q4f32"], layout="qsplit")
    rng, qts = _jax_weights(spec, K, N, seed=62 + m)
    jq = qts[1]
    tq = params_from_jax(jax.tree.map(np.asarray, jq))
    xj = jnp.asarray(rng.standard_normal((m, K)) * 0.1, jnp.float32)
    xt = tensor_from_numpy(np.asarray(xj))
    _, parts, per = dm.stream_plan("qsplit", m, K, N, 4)
    got = emulate_stream("qsplit", xt, tq.data, tq.scale, tq.zero, parts, per)
    _close_f32(got, dm.gemv_qs_plain(xt, tq.data, tq.scale, tq.zero, torch.float32))
    _check_against_jax(jq, qts, xj, got, False, xt.dtype)


# (preset, the scale of x): bf16, and f16 at x ~ 2 N(0, 1), where the
# field sums' rounding type shows
INT3_CASES = [("q3bf16_s16", 0.1), ("q3f16_s16", 2.0)]


@pytest.mark.parametrize("preset,x_scale", INT3_CASES, ids=["bf16", "f16"])
@pytest.mark.parametrize("stacked", [False, True], ids=["flat", "stacked"])
@pytest.mark.parametrize("m", [1, 2])
def test_int3_stream_matches_plain_and_jax(m, stacked, preset, x_scale):
    # q3*_s16 at 32 groups (1280 k; the gp3 kernel needs G % 16 == 0);
    # N = 264, stored as 384 columns: a ragged tile past one whole one
    spec = JPRESETS[preset]
    k, n = 1280, 264
    rng, qts = _jax_weights(spec, k, n, seed=70 + m)
    jq = qts[1]
    tq = params_from_jax(jax.tree.map(np.asarray, jq))
    G = tq.scale.shape[0]
    assert G == 32 and dm.route(tq.spec, G, m) == "gemv_gp3"
    xj = jnp.asarray(rng.standard_normal((m, k)) * x_scale, spec.dtype)
    xt = tensor_from_numpy(np.asarray(xj))
    _, parts, per = dm.stream_plan("int3", m, 40 * G, n, xt.element_size())
    got = emulate_stream("int3", xt, tq.data, tq.scale, None, parts, per)
    _close_f32(got, dm.gemv_gp3_plain(xt, tq.data, tq.scale, torch.float32))
    _check_against_jax(jq, qts, xj, got, stacked, xt.dtype)


@pytest.mark.parametrize("preset,order", [("q4f32", "pair"), ("q4f16_hs", "hsplit"),
                                          ("q4f16", "qsplit")])
def test_int4_stream_3b_groups(preset, order):
    # K = 2560 (80 groups) stored as 96, as the engine pads the 3B width:
    # the stages run over the padded groups, whose scales are zero
    spec = dataclasses.replace(JPRESETS[preset], layout=order)
    rng, qts = _jax_weights(spec, 2560, 128, seed=80)
    tq = params_from_jax(jax.tree.map(np.asarray, qts[1]))
    assert tq.scale.shape[0] == 96
    Ks = tq.data.shape[0] * 8
    x = torch.zeros((1, Ks), dtype=getattr(torch, tq.spec.dtype))
    x[:, :2560] = torch.from_numpy(rng.standard_normal((1, 2560)) * 0.1).to(x.dtype)
    _, parts, per = dm.stream_plan(order, 1, Ks, 128)
    got = emulate_stream(order, x, tq.data, tq.scale, tq.zero, parts, per)
    if order == "qsplit":
        plain = dm.gemv_qs_plain(x, tq.data, tq.scale, tq.zero, torch.float32)
    else:
        plain = dm.gemv_gp_plain(x, tq.data, tq.scale, tq.zero, order, torch.float32)
    _close_f32(got, plain)


# ---- the plan, from shapes only ----

# (order, stored K, N) of every m = 1 matmul on the main paths: Vicuna-7B
# q4bf16 (qsplit) and q3bf16_s16 (int3; K = 40 G, G padded to 16), the 3B
# width in pair and hsplit (K = 2560 stored as 3072), and ragged edges
VICUNA = [(4096, 12288), (4096, 4096), (4096, 22016), (11264, 4096), (4096, 32000)]
VICUNA_Q3 = [(5120, 12288), (5120, 4096), (5120, 22016), (11520, 4096), (5120, 32768)]
NEOX_3B = [(3072, 7680), (3072, 2560), (3072, 10240), (10240, 2560), (3072, 50432)]
PLAN_SHAPES = ([("qsplit", k, n) for k, n in VICUNA + NEOX_3B]
               + [(o, k, n) for o in ("pair", "hsplit") for k, n in NEOX_3B]
               + [("int3", k, n) for k, n in VICUNA_Q3]
               + [("qsplit", 128, 8), ("qsplit", 1024, 264), ("pair", 65536, 4096),
                  ("int3", 80, 8), ("int3", 1280, 264), ("hsplit", 256, 50432)])


# the (compute dtype bytes, m) of each order's streaming bodies: qsplit
# bf16/f16 at m = 1 and f32 at every m <= 8, pair and hsplit in each type at
# m = 1, int3 in bf16 and f16 at m <= 2
STREAMED = {"qsplit": [(2, 1)] + [(4, m) for m in range(1, 9)],
            "pair": [(2, 1), (4, 1)], "hsplit": [(2, 1), (4, 1)], "int3": [(2, 1), (2, 2)]}


def test_stream_blocks_cover_the_streaming_bodies():
    # STREAM_BLOCKS has an entry for every body the wrappers launch (by word
    # kind, dtype bytes and m) and none other: a plan without one raises
    def kind(order, it, m):
        return ("int3" if order == "int3" else "int4"), it, m

    assert {kind(o, it, m) for o, c in STREAMED.items() for it, m in c} == set(dm.STREAM_BLOCKS)
    for order in STREAMED:
        for it in (2, 4):
            for m in range(1, 9):
                if kind(order, it, m) in dm.STREAM_BLOCKS:
                    dm.stream_plan(order, m, 40 * 128, 4096, it)
                else:
                    with pytest.raises(ValueError, match="no streaming body"):
                        dm.stream_plan(order, m, 40 * 128, 4096, it)


@pytest.mark.parametrize("m", [1, 2, 8])
@pytest.mark.parametrize("order,k,n", PLAN_SHAPES)
def test_stream_plan_covers_k_once(order, k, n, m):
    # at m, each order's body in the compute type it is built for there
    # (qsplit above m = 1: f32); pair, hsplit above m = 1 and int3 above 2
    # run the tensor-core or plane kernels, and their plan raises
    itemsize = next((it for it, mm in STREAMED[order] if mm == m), None)
    if itemsize is None:
        with pytest.raises(ValueError, match="no streaming body"):
            dm.stream_plan(order, m, k, n)
        return
    cols, parts, per = dm.stream_plan(order, m, k, n, itemsize)
    steps = k // dm.STREAM_STAGE_K[order]
    assert cols == dm.STREAM_COLS == 256
    assert 1 <= per <= dm.STREAM_MAX_PER and 1 <= parts <= dm.STREAM_MAX_PARTS
    covered = [t for p in range(parts) for t in range(p * per, min(steps, (p + 1) * per))]
    assert covered == list(range(steps))  # each stage once, in part order
    assert all(p * per < steps for p in range(parts))  # no part empty


class _NoTorch:
    def __getattr__(self, name):
        raise AssertionError(f"stream_plan touched torch.{name}")


def test_stream_plan_reads_no_tensor(monkeypatch):
    # the plan is a function of (order, m, K, N, itemsize): it runs with
    # torch taken away, and is the same on every call
    want = [dm.stream_plan(o, 1, k, n) for o, k, n in PLAN_SHAPES]
    monkeypatch.setattr(dm, "torch", _NoTorch())
    dm.stream_plan.cache_clear()  # computed anew, without torch
    assert [dm.stream_plan(o, 1, k, n) for o, k, n in PLAN_SHAPES] == want
