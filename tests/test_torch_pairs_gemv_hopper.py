"""The redesigned pair/hsplit GEMM and the tensor-core qsplit GEMV on the
CPU: the launch plan, the bit assembly, and each kernel's k order, emulated
in torch.

csrc/dequant_gemm_pairs.cu (pair and hsplit, bf16/f16/f32) and the
tensor-core body of csrc/dequant_gemv_qs.cu (2 <= m <= 8, bf16/f16) run
the wgmma mainloop of csrc/dequant_wgmma.cuh, which only the card runs
(tests/test_torch_cuda.py). What the CPU holds is the arithmetic around it:

- `gemm_tiles` with the pairs plans (`PAIRS_PLAN`: stage k, m tiles, time
  model) and the GEMV's
  (`GEMV_STAGE_K`, `GEMV_MAX_SPLITS`) at every main-path shape;
- the bit assembly: the int4 code pairs of `wg::codes2` (bf16 128 + q less
  128, f16 1024 + q less 1024) and the qsplit 16 + q of `wg::field16`,
  against JAX's `_qs_planes_bf16`;
- the pair offset plane's three T terms (their sum is the f32 group sum);
- torch emulations of each kernel's k order and fold, built from the
  register fragment a thread holds: for a k16 step, lane (g, c) of warp w
  holds channels 16w + g and +8 at positions 2c, 2c + 1 and 2c + 8, 2c + 9;
  for a TF32 k8 step, positions c and c + 4. The emulation reads, for every
  position, the nibble the kernel's thread reads (word row, byte, nibble)
  and the x column the stage's B tile holds there; both must name the same
  k. The weights round where the kernels round (pair: one T product;
  hsplit: a T product and a T sum; f32: f32 ops, then the 3xTF32 split of
  weight and x, each stage in a fresh fragment; the GEMV: exact 16 + q,
  f32 group partials, the T-rounded group sum of x, f32 scales). Against
  the plain versions: 1e-5 relative (atol 1e-5 of the output's max), f32
  out; against the JAX kernels in interpret mode: 1e-2, f32 atol 1e-4 and
  rtol 1e-3, the tolerances of tests/test_torch_int4_layouts.py;
- `dense_matmul` and `attend` on CPU tensors: what they gave before their
  CUDA paths moved to the tensor cores, bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlc_llm_tpu.ops.pallas.dequant_matmul import _qs_planes_bf16
from mlc_llm_tpu.ops.pallas.dequant_matmul import dequant_matmul as jdm
from mlc_llm_tpu.ops.pallas.dequant_matmul import dequant_matmul_stacked as jdms
from mlc_llm_tpu.quant import quantize as jquantize
from mlc_llm_tpu.quant.groupwise import pad_quantized_groups as jpad
from mlc_llm_tpu.quant.spec import QUANT_PRESETS as JPRESETS
from mlc_llm_tpu_torch.models.convert import params_from_jax, tensor_from_numpy
from mlc_llm_tpu_torch.ops import attention
from mlc_llm_tpu_torch.ops import dequant_matmul as dm
from mlc_llm_tpu_torch.quant.groupwise import _unpack_words, dequantize

torch.set_num_threads(2)

JAX_TOL = dict(atol=1e-2, rtol=1e-2)
F32_JAX_TOL = dict(atol=1e-4, rtol=1e-3)
SMS = 132
NEOX_3B = [("wqkv", 3072, 7680), ("wo", 3072, 2560), ("w_in", 3072, 10240),
           ("w_out", 10240, 2560), ("lm_head", 3072, 51200)]
VICUNA = [("wqkv", 4096, 12288), ("wo", 4096, 4096), ("w_in", 4096, 22016),
          ("w_out", 11264, 4096), ("lm_head", 4096, 32000)]


# ---- the launch plans ----

def _model_cost(m, n, mt, parts, per, times):
    """gemm_tiles' time model of one plan (µs)."""
    stage_us, block_us, fit_mt = times
    blocks = (n // dm.TILE_N) * -(-m // mt)
    cost = -(-blocks * parts // SMS) * (per * stage_us * mt / fit_mt + block_us)
    return cost + (parts * m * n * 8 / dm.HBM_BYTES_PER_US if parts > 1 else 0.0)


@pytest.mark.parametrize("m", [9, 128, 2047, 2048])
@pytest.mark.parametrize("layout,f32", sorted(dm.PAIRS_PLAN))
@pytest.mark.parametrize("name,k,n", NEOX_3B + VICUNA)
def test_gemm_pairs_plan(name, k, n, layout, f32, m):
    stage_k, widths, times = dm.PAIRS_PLAN[(layout, f32)]
    assert k % stage_k == 0
    steps = k // stage_k
    mt, parts, per = dm.gemm_tiles(m, n, steps, widths, times=times)
    assert mt in widths and (mt >= m or mt == widths[-1])
    covered = [t for p in range(parts) for t in range(p * per, min(steps, (p + 1) * per))]
    assert covered == list(range(steps))
    assert 1 <= parts <= dm.MAX_SPLITS
    # no split count is 5% cheaper under the model, and the plan is no
    # dearer than the unsplit one
    cost = _model_cost(m, n, mt, parts, per, times)
    for s in range(1, min(steps, dm.MAX_SPLITS) + 1):
        p_per = -(-steps // s)
        assert _model_cost(m, n, mt, -(-steps // p_per), p_per, times) >= 0.95 * cost - 1e-9
    assert cost <= _model_cost(m, n, mt, 1, steps, times)


# the plans scripts/torch_plan_sweep.py found fastest on an H100 (700 W) at
# the 3B shapes, m = 128, or one within 4% of the fastest: (layout, f32,
# k, n) -> plans
SWEEP_BEST = {("hsplit", False, 3072, 10240): {(128, 1, 48)},
              ("hsplit", False, 3072, 7680): {(128, 2, 24)},
              ("hsplit", False, 3072, 2560): {(128, 4, 12), (128, 5, 10), (128, 6, 8)},
              ("hsplit", False, 10240, 2560): {(128, 6, 27)},
              ("pair", True, 3072, 10240): {(64, 2, 24), (64, 3, 16), (64, 4, 12)},
              ("pair", True, 3072, 2560): {(64, 3, 16)}}


@pytest.mark.parametrize("layout,f32,k,n", sorted(SWEEP_BEST))
def test_gemm_pairs_plan_matches_the_sweep(layout, f32, k, n):
    stage_k, widths, times = dm.PAIRS_PLAN[(layout, f32)]
    assert dm.gemm_tiles(128, n, k // stage_k, widths, times=times) in SWEEP_BEST[
        (layout, f32, k, n)]


@pytest.mark.parametrize("m", [2, 3, 5, 8])
@pytest.mark.parametrize("name,k,n", NEOX_3B + VICUNA)
def test_gemv_qs_plan(name, k, n, m):
    steps = k // dm.GEMV_STAGE_K
    mt, parts, per = dm.gemm_tiles(m, n, steps, dm.GEMV_WIDTHS, max_splits=dm.GEMV_MAX_SPLITS)
    assert mt == 16 and 1 <= parts <= dm.GEMV_MAX_SPLITS
    covered = [t for p in range(parts) for t in range(p * per, min(steps, (p + 1) * per))]
    assert covered == list(range(steps))
    # one wave at least, unless the tiles and the split cap cannot fill it
    assert (n // dm.TILE_N) * parts >= min(SMS, (n // dm.TILE_N) * dm.GEMV_MAX_SPLITS)


# ---- the bit assembly ----

def _codes2(pairs: torch.Tensor, dtype) -> torch.Tensor:
    """wg::codes2: code pairs (low at bits 0-3, high at bits 16-19) ->
    T x 2 values, [..., 2]: T(bits | 128 or 1024 magic) less the magic."""
    lo = pairs & 0xF
    hi = (pairs >> 16) & 0xF
    magic, bias = (0x4300, 128.0) if dtype == torch.bfloat16 else (0x6400, 1024.0)
    halves = torch.stack([lo, hi], dim=-1) | magic
    vals = halves.to(torch.int16).view(dtype)
    return vals - torch.tensor(bias, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
def test_codes2_is_exact(dtype):
    q = torch.arange(256, dtype=torch.int32)
    pairs = (q & 0xF) | ((q >> 4) << 16)
    got = _codes2(pairs, dtype)
    assert torch.equal(got.float(), torch.stack([q & 0xF, q >> 4], dim=-1).float())


def _field16(words: torch.Tensor, f: int, dtype) -> torch.Tensor:
    """wg::field16: field f of qsplit words [W, N] as T bits of 16 + q,
    [2W, N], row 2r + h the half h of word r."""
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
    rng = np.random.default_rng(7)
    jq = jquantize((rng.standard_normal((512, 128)) * 0.05).astype(np.float32), "q4bf16")
    return jq, params_from_jax(jax.tree.map(np.asarray, jq))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("f", [0, 1, 2, 3])
def test_gemv_bit_assembly_matches_jax_planes(qs_weight, f, dtype):
    # the A operand of the tensor-core GEMV is the exact 16 + q: bf16 bits
    # equal JAX's _qs_planes_bf16; f16 holds the same values
    jq, tq = qs_weight
    got = _field16(tq.data, f, dtype)
    want = np.asarray(_qs_planes_bf16(jq.data, f, True))
    assert np.array_equal(got.float().numpy(), want.astype(np.float32))
    if dtype == torch.bfloat16:
        assert np.array_equal(got.view(torch.int16).numpy(), want.view(np.int16))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
def test_pair_offset_terms_sum_to_f32(dtype):
    # pair_offsets_kernel: hi = T(S), mid = T(S - hi), lo = T(S - hi - mid);
    # the three products with off add up to S * off in f32. bf16 (8 bits a
    # term, f32's exponent range) is exact; f16's lo term may fall below
    # its smallest subnormal (2^-24), so it is exact to half of that
    S = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32)) * 3
    hi, mid, lo = _three_terms(S, dtype)
    err = (hi.double() + mid.double() + lo.double() - S.double()).abs().max().item()
    assert err <= (0.0 if dtype == torch.bfloat16 else 2.0**-25)


# ---- the kernels' k order ----

def _three_terms(S, dtype):
    hi = S.to(dtype)
    mid = (S - hi.float()).to(dtype)
    lo = (S - hi.float() - mid.float()).to(dtype)
    return hi, mid, lo


def _tf32(v: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero."""
    b = v.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _k16_positions():
    """(position, c, j, h) of a k16 step: a[2j + .] of lane c holds
    position 2c + 8j + h."""
    return [(p, (p % 8) // 2, p // 8, p % 2) for p in range(16)]


def _k8_positions():
    """(position, c, r2) of a TF32 k8 step: a[2 r2 + .] of lane c holds
    position c + 4 r2."""
    return [(p, p % 4, p // 4) for p in range(8)]


def _weight_at(codes, k_idx, scale, zero, layout, dtype):
    """The kernel's A values at element rows k_idx [P] of all channels:
    pair T(q*s); hsplit T(T(q*s) + off); f32 the same ops in f32."""
    q = codes[k_idx].to(dtype)
    s = scale[torch.tensor(k_idx) // 32].to(dtype)
    w = q * s
    if layout == "hsplit":
        off = s * -dm.INT4_MAX if zero is None else zero[torch.tensor(k_idx) // 32].to(dtype)
        w = w + off
    return w


def emulate_gemm_pairs(x, words, scale, zero, layout):
    """gemm_pairs' mainloop in torch. Per stage, per MMA step: the k each
    fragment position's nibble holds (k_w) and the k the B tile holds
    there (k_x) must agree. bf16/f16: acc += B @ A; pair's offset step
    holds (hi, mid, lo) of each group's f32 sum of T pair sums. f32: A and
    B split into TF32 hi and lo, a stage's three products into a fresh
    fragment, added to acc. Returns f32 [m, N]."""
    m, K = x.shape
    G, N = scale.shape
    dtype = x.dtype
    f32 = dtype == torch.float32
    codes = _unpack_words(words, dm._INT4[layout])
    off_g = (scale.to(dtype) * -dm.INT4_MAX) if zero is None else zero.to(dtype)
    acc = torch.zeros((m, N), dtype=torch.float32)
    psum = (x[:, 0::2].float() + x[:, 1::2].float()).to(dtype).float()  # T(x_2i + x_2i+1)
    S = psum.reshape(m, G, 16).sum(dim=2)  # [m, G] f32
    if not f32:
        stage_k = 128 if layout == "pair" else 64
        for t in range(K // stage_k):
            steps = []
            if layout == "pair":
                for j in range(8):
                    kw = [8 * (16 * t + 2 * j + jj) + 2 * c + h for _, c, jj, h in _k16_positions()]
                    kx = [128 * t + 16 * j + p for p in range(16)]
                    steps.append((kw, kx))
            else:
                for hf in range(2):
                    for j in range(2):
                        kw = [hf * K // 2 + 4 * (8 * t + 4 * j + 2 * jj + c // 2) + 2 * (c % 2) + h
                              for _, c, jj, h in _k16_positions()]
                        kx = [hf * K // 2 + 32 * t + 16 * j + p for p in range(16)]
                        steps.append((kw, kx))
            for kw, kx in steps:
                assert kw == kx
                a = _weight_at(codes, kw, scale, zero, layout, dtype).float()
                acc += x[:, kx].float() @ a
            if layout == "pair":
                terms = _three_terms(S[:, 4 * t:4 * t + 4], dtype)  # 3 x [m, 4]
                b = torch.zeros((m, 16), dtype=torch.float32)
                a = torch.zeros((16, N), dtype=torch.float32)
                for g in range(4):
                    for e in range(3):
                        b[:, 3 * g + e] = terms[e][:, g].float()
                        a[3 * g + e] = off_g[4 * t + g].float()
                acc += b @ a
        return acc
    for t in range(K // 64):
        steps = []
        for j in range(8):
            if layout == "pair":
                kw = [8 * (8 * t + j) + c + 4 * r2 for _, c, r2 in _k8_positions()]
                kx = [64 * t + 8 * j + p for p in range(8)]
            else:
                hf, jj = j // 4, j % 4
                kw = [hf * K // 2 + 4 * (8 * t + 2 * jj + r2) + c for _, c, r2 in _k8_positions()]
                kx = [hf * K // 2 + 32 * t + 8 * jj + p for p in range(8)]
            assert kw == kx
            steps.append((x[:, kx], _weight_at(codes, kw, scale, zero, layout, dtype)))
        if layout == "pair":
            b = torch.zeros((m, 8))
            a = torch.zeros((8, N))
            b[:, :2] = S[:, 2 * t:2 * t + 2]
            a[:2] = off_g[2 * t:2 * t + 2]
            steps.append((b, a))
        part = torch.zeros((m, N))
        for b, a in steps:
            bh, ah = _tf32(b), _tf32(a)
            bl, al = _tf32(b - bh), _tf32(a - ah)
            part += bh @ al + bl @ ah + bh @ ah
        acc += part
    return acc


def emulate_gemv_qs_tc(x, words, scale, zero):
    """The tensor-core gemv_qs in torch: per stage t (one group of each
    quarter) and quarter f, two k16 steps of A = 16 + q (exact) against x
    into a fresh partial P; sx = T(sum of x over the group); acc += s *
    (P - 16 sx) + z * sx (sym: s * (P - 23 sx)), f32 scales. Returns f32
    [m, N]."""
    m, K = x.shape
    G, N = scale.shape
    kq = K // 4
    vals = dm._codes16(words)  # [K, N], element order
    acc = torch.zeros((m, N), dtype=torch.float32)
    for t in range(K // 128):
        for f in range(4):
            P = torch.zeros((m, N))
            for h in range(2):
                kw = [f * kq + 2 * (16 * t + 8 * h + c + 4 * jj) + hb
                      for _, c, jj, hb in _k16_positions()]
                kx = [f * kq + 32 * t + 16 * h + p for p in range(16)]
                assert kw == kx
                P += x[:, kx].float() @ vals[kw]
            cols = slice(f * kq + 32 * t, f * kq + 32 * t + 32)
            sx = x[:, cols].float().sum(dim=1).to(x.dtype).float()[:, None]
            g = f * (G // 4) + t
            s = scale[g].float()[None]
            if zero is None:
                acc += s * (P - 23.0 * sx)
            else:
                acc += s * (P - 16.0 * sx) + zero[g].float()[None] * sx
    return acc


def _close_f32(got, want):
    tol = 1e-5 * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=tol)


def _jax_weights(preset, layout, k, n, seed):
    rng = np.random.default_rng(seed)
    spec = dataclasses.replace(JPRESETS[preset], layout=layout)
    qts = [jpad(jquantize((rng.standard_normal((k, n)) * 0.05).astype(np.float32), spec))
           for _ in range(2)]
    return rng, qts


# (preset, layout): pair and hsplit, sym and asym, in bf16, f16 and f32
PAIRS_CASES = [("q4bf16_pair", "pair"), ("q4bf16_sym", "pair"), ("q4f16_pair", "pair"),
               ("q4f32", "pair"), ("q4bf16_hs", "hsplit"), ("q4f16_hs", "hsplit"),
               ("q4f32", "hsplit"), ("q4bf16_sym", "hsplit")]


@pytest.mark.parametrize("preset,layout", PAIRS_CASES)
@pytest.mark.parametrize("stacked", [False, True], ids=["flat", "stacked"])
def test_gemm_pairs_k_order_matches_plain_and_jax(preset, layout, stacked):
    rng, qts = _jax_weights(preset, layout, 1024, 256, seed=11)
    jq = qts[1]
    tq = params_from_jax(jax.tree.map(np.asarray, jq))
    dt = jnp.dtype(tq.spec.dtype)
    xj = jnp.asarray(rng.standard_normal((9, 1024)) * 0.1, dt)
    xt = tensor_from_numpy(np.asarray(xj))
    got = emulate_gemm_pairs(xt, tq.data, tq.scale, tq.zero, layout)
    _close_f32(got, dm.gemm_pairs_plain(xt, tq.data, tq.scale, tq.zero, layout, torch.float32))
    tol = F32_JAX_TOL if dt == jnp.float32 else JAX_TOL
    if stacked:
        jst = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs, 0), *qts)
        want = jdms(xj, jst, jnp.int32(1))
        got = got.to(xt.dtype)
    else:
        want = jdm(xj, jq, out_dtype=jnp.float32)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("preset,layout", [("q4f32", "pair"), ("q4f16_hs", "hsplit"),
                                           ("q4bf16_pair", "pair")])
def test_gemm_pairs_k_order_3b_groups(preset, layout):
    # K = 2560 (80 groups) stored as 96, as the engine pads the 3B width
    rng, qts = _jax_weights(preset, layout, 2560, 128, seed=12)
    tq = params_from_jax(jax.tree.map(np.asarray, qts[1]))
    assert tq.scale.shape[0] == 96
    K = tq.data.shape[0] * 8
    x = torch.zeros((12, K), dtype=getattr(torch, tq.spec.dtype))
    x[:, :2560] = torch.from_numpy(rng.standard_normal((12, 2560)) * 0.1).to(x.dtype)
    got = emulate_gemm_pairs(x, tq.data, tq.scale, tq.zero, layout)
    _close_f32(got, dm.gemm_pairs_plain(x, tq.data, tq.scale, tq.zero, layout, torch.float32))


@pytest.mark.parametrize("sym", [False, True], ids=["asym", "sym"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("m", [2, 3, 5, 8])
def test_gemv_qs_tc_fold_matches_plain_and_jax(m, dtype, sym):
    preset = {("bfloat16", False): "q4bf16", ("bfloat16", True): "q4bf16_sym",
              ("float16", False): "q4f16", ("float16", True): "q4f16"}[(dtype, sym)]
    spec = dataclasses.replace(JPRESETS[preset], layout="qsplit", sym=sym, dtype=dtype)
    rng = np.random.default_rng(20 + m)
    jq = jquantize((rng.standard_normal((1024, 256)) * 0.05).astype(np.float32), spec)
    tq = params_from_jax(jax.tree.map(np.asarray, jq))
    assert (tq.zero is None) == sym
    xj = jnp.asarray(rng.standard_normal((m, 1024)) * 0.1, jnp.dtype(dtype))
    xt = tensor_from_numpy(np.asarray(xj))
    got = emulate_gemv_qs_tc(xt, tq.data, tq.scale, tq.zero)
    _close_f32(got, dm.gemv_qs_plain(xt, tq.data, tq.scale, tq.zero, torch.float32))
    want = jdm(xj, jq, out_dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), **JAX_TOL)


# ---- the repaired products, unchanged on the CPU ----

def _dense_before(x, w, out_dtype=None, layer=None):
    if layer is not None:
        w = w.map(lambda t: t[layer])
    wd = dequantize(w, dtype=x.dtype)
    return torch.matmul(x.float(), wd.float()).to(out_dtype or x.dtype)


def _attend_before(q, k, v, q_pos, *, mask_value=-1e30, v_transposed=False):
    B, Hq, Sq, D = q.shape
    Hkv, Smax = k.shape[1], k.shape[2]
    if Hq != Hkv:
        rep = Hq // Hkv
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / D**0.5)
    kpos = torch.arange(Smax)[None, None, :]
    qabs = q_pos[:, None, None] + torch.arange(Sq)[None, :, None]
    valid = kpos <= qabs
    scores = torch.where(valid[:, None], scores, torch.full_like(scores, mask_value))
    probs = torch.softmax(scores, dim=-1).to(q.dtype).float()
    vt = v.float().transpose(-1, -2) if v_transposed else v.float()
    return torch.matmul(probs, vt).to(q.dtype)


@pytest.mark.parametrize("preset,out_f32", [("q4bf16", False), ("q4f32", False),
                                            ("q4f16_hs", True), ("q3bf16", True)])
def test_dense_matmul_cpu_unchanged(preset, out_f32):
    rng = np.random.default_rng(30)
    jq = jquantize((rng.standard_normal((256, 256)) * 0.05).astype(np.float32), preset)
    tq = params_from_jax(jax.tree.map(np.asarray, jq))
    x = torch.from_numpy(rng.standard_normal((2, 5, 256)) * 0.1).to(getattr(torch, tq.spec.dtype))
    out_dtype = torch.float32 if out_f32 else None
    got = dm.dense_matmul(x, tq, out_dtype)
    want = _dense_before(x, tq, out_dtype)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("hq,hkv,v_transposed", [(4, 4, True), (8, 2, True), (4, 4, False)])
def test_attend_cpu_unchanged(dtype, hq, hkv, v_transposed):
    g = torch.Generator().manual_seed(31)
    B, Sq, Smax, D = 2, 5, 24, 32
    q = torch.randn((B, hq, Sq, D), generator=g).to(dtype)
    k = torch.randn((B, hkv, Smax, D), generator=g).to(dtype)
    v = torch.randn((B, hkv, D, Smax) if v_transposed else (B, hkv, Smax, D), generator=g).to(dtype)
    q_pos = torch.tensor([3, 19])
    got = attention.attend(q, k, v, q_pos, v_transposed=v_transposed)
    want = _attend_before(q, k, v, q_pos, v_transposed=v_transposed)
    assert got.dtype == dtype and torch.equal(got, want)
