"""The redesigned pair/hsplit GEMV at 2 <= m <= 8 and the f32 qsplit GEMM
on the CPU: each kernel's k order and fold emulated in torch, and the
`gemm_qs` launch plan.

csrc/dequant_gemv_gp.cu (GpHalf, GpF32) and csrc/dequant_gemm_qs.cu
(QsF32) run the wgmma mainloop of csrc/dequant_wgmma.cuh, which only the
card runs (tests/test_torch_cuda.py). What the CPU holds:

- a torch emulation of each policy built from the register fragment a
  thread holds (a k16 step: lane c holds positions 2c, 2c + 1 and 2c + 8,
  2c + 9; a TF32 k8 step: positions c and c + 4). For every position it
  names the k of the nibble the kernel's thread reads (word row, byte,
  nibble) and the k of the x column the stage's B tile holds there; both
  must agree. The GEMV: A = the raw codes (exact), each group's MMAs into
  a fresh f32 partial P, then s * P + z * sx (sym: s * (P - 7 sx)) with f32
  scales; sx the group sum of x rounded as the TPU bodies round it (pair:
  the even and odd sums each rounded to T and added in T; hsplit: one
  rounded sum; f32: none), f32 with two TF32 products (x_hi . A + x_lo .
  A). The f32 GEMM: w = (16 + q) * s + (z - 16 s) in f32, 3xTF32 on the
  split weight and x, a 64-k stage in a fresh fragment.
  Against the plain versions: 1e-5 relative (atol 1e-5 of the output's
  max); against the JAX kernels in Pallas interpret mode (the dispatchers
  `dequant_matmul` and `dequant_matmul_stacked`, which reach
  `_dequant_matmul_gp_2d` at m <= 8 and `_kernel_pairs_qs` above): 1e-2 in
  bf16 and f16, atol 1e-4 and rtol 1e-3 in f32, the tolerances of
  tests/test_torch_int4_layouts.py;
- `gemm_tiles` on `QS_PLAN`, `gemm_qs`'s time model, against the plans
  scripts/torch_plan_sweep.py timed on an H100: it picks the fastest or one
  within 3% of it.
"""

import dataclasses

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


def _tf32(v: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero."""
    b = v.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _k16_positions():
    """(position, c, jj, h) of a k16 step: register pair jj of lane c holds
    position 8 jj + 2c + h."""
    return [(p, (p % 8) // 2, p // 8, p % 2) for p in range(16)]


def _k8_positions():
    """(position, c, r2) of a TF32 k8 step: lane c holds position c + 4 r2."""
    return [(p, p % 4, p // 4) for p in range(8)]


def _gp_steps(layout, K, t, f32):
    """Stage t's MMA steps of the GEMV: [(part, k_w, k_x)], the k each A
    position's nibble holds (word row, byte, nibble as the kernel reads
    it) and the k of the B tile's column there."""
    steps = []
    if not f32:
        for k in range(8):
            if layout == "pair":
                kw = [8 * (16 * t + 2 * k + jj) + 2 * c + h for _, c, jj, h in _k16_positions()]
                kx = [128 * t + 16 * k + p for p in range(16)]
            else:
                hf, j = k // 4, k % 4
                kw = [hf * K // 2 + 4 * (16 * t + 4 * j + 2 * jj + c // 2) + 2 * (c % 2) + h
                      for _, c, jj, h in _k16_positions()]
                kx = [hf * K // 2 + 64 * t + 16 * j + p for p in range(16)]
            steps.append((k // 2, kw, kx))
        return steps
    for k in range(16):
        if layout == "pair":
            kw = [8 * (16 * t + k) + c + 4 * r2 for _, c, r2 in _k8_positions()]
            kx = [128 * t + 8 * k + p for p in range(8)]
        else:
            hf, j = k // 8, k % 8
            kw = [hf * K // 2 + 4 * (16 * t + 2 * j + r2) + c for _, c, r2 in _k8_positions()]
            kx = [hf * K // 2 + 64 * t + 8 * j + p for p in range(8)]
        steps.append((k // 4, kw, kx))
    return steps


def _gp_group(layout, G, t, part):
    """The group of the stage's part: pair 4t + part; hsplit half part // 2,
    group 2t + part % 2 of that half."""
    return 4 * t + part if layout == "pair" else (part // 2) * (G // 2) + 2 * t + part % 2


def emulate_gemv_gp_tc(x, words, scale, zero, layout):
    """The tensor-core gemv_gp in torch (see the module doc). Returns f32
    [m, N]."""
    m, K = x.shape
    G, N = scale.shape
    dtype = x.dtype
    f32 = dtype == torch.float32
    codes = _unpack_words(words, dm._INT4[layout]).float()  # [K, N], k order
    base = 0.0 if zero is not None else float(dm.INT4_MAX)
    acc = torch.zeros((m, N), dtype=torch.float32)
    for t in range(K // 128):
        P = torch.zeros((4, m, N))
        for part, kw, kx in _gp_steps(layout, K, t, f32):
            assert kw == kx
            a = codes[kw]
            xs = x[:, kx].float()
            if f32:
                hi = _tf32(xs)
                P[part] += hi @ a + _tf32(xs - hi) @ a
            else:
                P[part] += xs @ a
        for part in range(4):
            g = _gp_group(layout, G, t, part)
            xg = x[:, 32 * g:32 * g + 32].float()
            if f32:
                sx = xg[:, 0::2].sum(dim=1) + xg[:, 1::2].sum(dim=1)
            elif layout == "pair":
                even = xg[:, 0::2].sum(dim=1).to(dtype)
                odd = xg[:, 1::2].sum(dim=1).to(dtype)
                sx = (even + odd).float()
            else:
                sx = xg.sum(dim=1).to(dtype).float()
            sx = sx[:, None]
            s = scale[g].float()[None]
            z = 0.0 if zero is None else zero[g].float()[None]
            acc += s * (P[part] - base * sx) + z * sx
    return acc


def emulate_gemm_qs_f32(x, words, scale, zero):
    """The f32 gemm_qs policy in torch: per 64-k stage t, steps 2f + j of
    quarter f (k f*K/4 + 16t + 8j ..), A = the f32 weight (16 + q) * s +
    (z - 16 s) (sym: s * -23) at the positions' k, 3xTF32 into a fresh
    fragment, added to acc. Returns f32 [m, N]."""
    m, K = x.shape
    G, N = scale.shape
    kq = K // 4
    vals = dm._codes16(words)  # [K, N], element order
    se = scale.float()
    off = se * -23.0 if zero is None else zero.float() - se * 16.0
    acc = torch.zeros((m, N), dtype=torch.float32)
    for t in range(K // 64):
        part = torch.zeros((m, N))
        for k in range(8):
            f, j = k // 2, k % 2
            kw = [f * kq + 2 * (8 * t + 4 * j + 2 * r2 + c // 2) + c % 2
                  for _, c, r2 in _k8_positions()]
            kx = [f * kq + 16 * t + 8 * j + p for p in range(8)]
            assert kw == kx
            g = torch.tensor(kw) // 32
            a = vals[kw] * se[g] + off[g]
            b = x[:, kx].float()
            bh, ah = _tf32(b), _tf32(a)
            bl, al = _tf32(b - bh), _tf32(a - ah)
            part += bh @ al + bl @ ah + bh @ ah
        acc += part
    return acc


def _close_f32(got, want):
    tol = 1e-5 * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=tol)


def _jax_weights(spec, k, n, seed):
    rng = np.random.default_rng(seed)
    qts = [jpad(jquantize((rng.standard_normal((k, n)) * 0.05).astype(np.float32), spec))
           for _ in range(2)]
    return rng, qts


# (preset, layout): pair and hsplit, sym and asym, in bf16, f16 and f32
GP_CASES = [("q4bf16_pair", "pair"), ("q4bf16_sym", "pair"), ("q4f16_pair", "pair"),
            ("q4f32", "pair"), ("q4bf16_hs", "hsplit"), ("q4f16_hs", "hsplit"),
            ("q4f32", "hsplit"), ("q4bf16_sym", "hsplit")]


@pytest.mark.parametrize("m", [2, 3, 8])
@pytest.mark.parametrize("preset,layout", GP_CASES)
@pytest.mark.parametrize("stacked", [False, True], ids=["flat", "stacked"])
def test_gemv_gp_tc_fold_matches_plain_and_jax(preset, layout, stacked, m):
    spec = dataclasses.replace(JPRESETS[preset], layout=layout)
    rng, qts = _jax_weights(spec, 1024, 256, seed=40 + m)
    jq = qts[1]
    tq = params_from_jax(jax.tree.map(np.asarray, jq))
    assert dm.route(tq.spec, tq.scale.shape[0], m) == "gemv_gp"
    dt = jnp.dtype(tq.spec.dtype)
    xj = jnp.asarray(rng.standard_normal((m, 1024)) * 0.1, dt)
    xt = tensor_from_numpy(np.asarray(xj))
    got = emulate_gemv_gp_tc(xt, tq.data, tq.scale, tq.zero, layout)
    _close_f32(got, dm.gemv_gp_plain(xt, tq.data, tq.scale, tq.zero, layout, torch.float32))
    if stacked:
        jst = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs, 0), *qts)
        want = jdms(xj, jst, jnp.int32(1))
        got = got.to(xt.dtype)
    else:
        want = jdm(xj, jq, out_dtype=jnp.float32)
    tol = F32_JAX_TOL if dt == jnp.float32 else JAX_TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("preset,layout", [("q4f32", "pair"), ("q4f16_hs", "hsplit"),
                                           ("q4f32", "hsplit")])
def test_gemv_gp_tc_3b_groups(preset, layout):
    # K = 2560 (80 groups) stored as 96, as the engine pads the 3B width:
    # the stages run over the padded groups, whose scales are zero
    spec = dataclasses.replace(JPRESETS[preset], layout=layout)
    rng, qts = _jax_weights(spec, 2560, 128, seed=41)
    tq = params_from_jax(jax.tree.map(np.asarray, qts[1]))
    assert tq.scale.shape[0] == 96
    K = tq.data.shape[0] * 8
    x = torch.zeros((8, K), dtype=getattr(torch, tq.spec.dtype))
    x[:, :2560] = torch.from_numpy(rng.standard_normal((8, 2560)) * 0.1).to(x.dtype)
    got = emulate_gemv_gp_tc(x, tq.data, tq.scale, tq.zero, layout)
    _close_f32(got, dm.gemv_gp_plain(x, tq.data, tq.scale, tq.zero, layout, torch.float32))


@pytest.mark.parametrize("m", [9, 16, 100])
@pytest.mark.parametrize("sym", [False, True], ids=["asym", "sym"])
@pytest.mark.parametrize("stacked", [False, True], ids=["flat", "stacked"])
def test_gemm_qs_f32_k_order_matches_plain_and_jax(sym, stacked, m):
    spec = dataclasses.replace(JPRESETS["q4f32"], layout="qsplit", sym=sym)
    rng, qts = _jax_weights(spec, 1024, 256, seed=50 + m)
    jq = qts[1]
    tq = params_from_jax(jax.tree.map(np.asarray, jq))
    assert (tq.zero is None) == sym and dm.route(tq.spec, tq.scale.shape[0], m) == "gemm_qs"
    xj = jnp.asarray(rng.standard_normal((m, 1024)) * 0.1, jnp.float32)
    xt = tensor_from_numpy(np.asarray(xj))
    got = emulate_gemm_qs_f32(xt, tq.data, tq.scale, tq.zero)
    _close_f32(got, dm.gemm_qs_plain(xt, tq.data, tq.scale, tq.zero, torch.float32))
    if stacked:
        jst = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs, 0), *qts)
        want = jdms(xj, jst, jnp.int32(1))
    else:
        want = jdm(xj, jq, out_dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), **F32_JAX_TOL)


# ---- the split plans, against the sweep ----

# scripts/torch_plan_sweep.py on an H100 80GB HBM3 (700 W): for each swept
# shape, the plans within 3% of the fastest (f32 gemm_qs from a 100-launch
# sweep, the rest from 20 launches a plan). (kernel, preset, stored K, N, m)
SWEEP_WITHIN_3PCT = {
    ("gemm_qs", "q4bf16", 4096, 4096, 128): {(128, 4, 16)},
    ("gemm_qs", "q4bf16", 4096, 4096, 2048): {(256, 1, 64)},
    ("gemm_qs", "q4bf16", 4096, 12288, 128): {(128, 1, 64)},
    ("gemm_qs", "q4bf16", 4096, 12288, 2048): {(256, 1, 64)},
    ("gemm_qs", "q4bf16", 4096, 22528, 128): {(128, 1, 64), (128, 2, 32)},
    ("gemm_qs", "q4bf16", 4096, 22528, 2048): {(256, 1, 64)},
    ("gemm_qs", "q4bf16", 4096, 32768, 128): {(128, 1, 64)},
    ("gemm_qs", "q4bf16", 11264, 4096, 128): {(128, 4, 44)},
    ("gemm_qs", "q4bf16", 11264, 4096, 2048): {(256, 1, 176)},
    ("gemm_qs", "q4f16", 3072, 2560, 128): {(64, 3, 16), (128, 5, 10), (128, 6, 8)},
    ("gemm_qs", "q4f16", 3072, 8192, 128): {(128, 2, 24)},
    ("gemm_qs", "q4f16", 3072, 10240, 128): {(128, 1, 48)},
    ("gemm_qs", "q4f16", 10240, 2560, 128): {(128, 6, 27)},
    ("gemm_qs", "q4f32", 3072, 2560, 128): {(64, 6, 8), (64, 3, 16)},
    ("gemm_qs", "q4f32", 3072, 8192, 128): {(64, 2, 24), (64, 1, 48)},
    ("gemm_qs", "q4f32", 3072, 10240, 128): {(64, 4, 12), (64, 3, 16)},
    ("gemm_qs", "q4f32", 3072, 51200, 128): {(64, 1, 48)},
    ("gemv_gp", "q4f16_hs", 3072, 2560, 8): {(16, 6, 4)},
    ("gemv_gp", "q4f16_hs", 3072, 8192, 8): {(16, 2, 12)},
    ("gemv_gp", "q4f16_hs", 3072, 10240, 8): {(16, 3, 8)},
    ("gemv_gp", "q4f16_hs", 10240, 2560, 8): {(16, 6, 14)},
    ("gemv_gp", "q4f16_hs:f32", 3072, 51200, 8): {(16, 3, 8), (16, 1, 24), (16, 2, 12)},
    ("gemv_gp", "q4f32", 3072, 2560, 8): {(16, 6, 4)},
    ("gemv_gp", "q4f32", 3072, 8192, 8): {(16, 2, 12)},
    ("gemv_gp", "q4f32", 3072, 10240, 8): {(16, 3, 8)},
    ("gemv_gp", "q4f32", 3072, 51200, 8): {(16, 3, 8), (16, 4, 6), (16, 2, 12)},
    ("gemv_gp", "q4f32", 10240, 2560, 8): {(16, 6, 14)},
}


def _plan(kernel, preset, k, n, m):
    if kernel == "gemv_gp":
        return dm.gemm_tiles(m, n, k // dm.GEMV_STAGE_K, dm.GEMV_WIDTHS, times=dm.GP_GEMV_TIMES)
    widths, times = dm.QS_PLAN[preset == "q4f32"]
    return dm.gemm_tiles(m, n, k // dm.QS_STAGE_K, widths, times=times)


@pytest.mark.parametrize("kernel,preset,k,n,m", sorted(SWEEP_WITHIN_3PCT))
def test_plan_matches_the_sweep(kernel, preset, k, n, m):
    assert _plan(kernel, preset, k, n, m) in SWEEP_WITHIN_3PCT[(kernel, preset, k, n, m)]


def test_gemm_qs_f32_plan_off_the_sweep_where_the_wave_model_cannot_follow():
    # f32 at w_out's shape (K = 10240, N = 2560; no model stores a qsplit
    # f32 weight there: the qsplit f32 weight is a NeoX lm head). The
    # sweep's plans within 3% run 6 to 16 parts over two to five waves
    # (0.1196-0.1226 ms); the wave model prices one wave of 54 stages below
    # any of them, and that plan took 0.1242 ms, 3.8% over the fastest.
    # Held here so that a refit that moves it shows
    assert _plan("gemm_qs", "q4f32", 10240, 2560, 128) == (64, 3, 54)


@pytest.mark.parametrize("m", [2, 3, 5, 8])
@pytest.mark.parametrize("n", [2560, 8192, 10240, 51200])
@pytest.mark.parametrize("k", [3072, 10240])
def test_gemv_gp_plan_covers_k(k, n, m):
    steps = k // dm.GEMV_STAGE_K
    mt, parts, per = dm.gemm_tiles(m, n, steps, dm.GEMV_WIDTHS, times=dm.GP_GEMV_TIMES)
    assert mt == 16 and 1 <= parts <= dm.MAX_SPLITS
    covered = [t for p in range(parts) for t in range(p * per, min(steps, (p + 1) * per))]
    assert covered == list(range(steps))
