"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc (a CUDA kernel has no
interpret mode) and skips without one. This file imports only torch and
the port, so it runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import dataclasses
import time

import pytest
import torch

from mlc_llm_tpu_torch.ops import dequant_matmul as dm
from mlc_llm_tpu_torch.quant import QUANT_PRESETS, pad_quantized_groups, quantize

TOL = dict(atol=1e-2, rtol=1e-2)

def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no interpret mode)")


def _card_weight(k, n, sym=False):
    spec = dataclasses.replace(QUANT_PRESETS["q4bf16_sym" if sym else "q4bf16"],
                               layout="qsplit")
    g = torch.Generator(device="cuda").manual_seed(0)
    return quantize(torch.randn((k, n), generator=g, device="cuda") * 0.02, spec)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("sym", [False, True], ids=["asym", "sym"])
def test_cuda_gemv_matches_plain(m, sym):
    _need_gpu()
    qt = _card_weight(4096, 4096, sym)
    x = (torch.randn((m, 4096), device="cuda") * 0.5).to(torch.bfloat16)
    before = dm.gemv_qs.launches
    got = dm.gemv_qs(x, qt.data, qt.scale, qt.zero, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert dm.gemv_qs.launches == before + 1
    want = dm.gemv_qs_plain(x, qt.data, qt.scale, qt.zero, torch.float32)
    # the bf16-rounded group sums may round the other way after an f32
    # sum in another order: the CPU tolerance, not a tighter one
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [16, 200])
def test_cuda_gemm_matches_plain(m):
    _need_gpu()
    torch.backends.cuda.matmul.allow_tf32 = False
    qt = _card_weight(4096, 4096)
    x = (torch.randn((m, 4096), device="cuda") * 0.5).to(torch.bfloat16)
    before = dm.gemm_qs.launches
    got = dm.gemm_qs(x, qt.data, qt.scale, qt.zero, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert dm.gemm_qs.launches == before + 1
    want = dm.gemm_qs_plain(x, qt.data, qt.scale, qt.zero, torch.float32)
    # identical bf16 weights; only the f32 summation order differs
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("rep,hb,ps,lengths", [
    (1, 8, 128, [1, 127, 128, 700]),   # Vicuna-7B's pool layout, page edges
    (4, 2, 16, [0, 17, 100, 63]),      # GQA, small pages
    (3, 4, 32, [31, 32, 255, 9]),      # rows that fill no power of two
    (16, 8, 64, [5, 64, 500, 0]),      # more query rows than one block holds
])
def test_cuda_paged_flash_decode_matches_plain(int8, rep, hb, ps, lengths):
    _need_gpu()
    from mlc_llm_tpu_torch.ops import paged_attention as pa

    g = torch.Generator(device="cuda").manual_seed(0)
    B, D, L, Hkv = len(lengths), 128, 2, 8
    G, P, maxp = Hkv // hb, 64, 8
    shape = (G, L, P, ps, hb * D)
    if int8:
        kp, vp = (torch.randint(-127, 128, shape, generator=g, device="cuda",
                                dtype=torch.int8) for _ in range(2))
        ks = torch.rand((G, L, P, hb, ps), generator=g, device="cuda") * 0.02 + 1e-3
        vs = torch.rand((G, L, P, ps, hb), generator=g, device="cuda") * 0.02 + 1e-3
    else:
        kp, vp = (torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        ks = vs = None
    table = (torch.randperm(P - 1, generator=torch.Generator().manual_seed(1))[:B * maxp]
             .reshape(B, maxp) + 1).int().cuda()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q = torch.randn((B, Hkv * rep, 1, D), generator=g, device="cuda").to(torch.bfloat16)
    before = pa.paged_flash_decode.launches
    got = pa.paged_flash_decode(q, kp, vp, ks, vs, table, lens, 1, num_pages_window=maxp,
                                head_dim=D)
    torch.cuda.synchronize()
    assert pa.paged_flash_decode.launches == before + 1
    want = pa.paged_flash_decode_plain(q, kp, vp, ks, vs, table, lens, 1,
                                       num_pages_window=maxp, head_dim=D)
    # the same roundings, summed in another order: one bf16 ulp of the output
    torch.testing.assert_close(got.float(), want.float(), **TOL)


def _stacked(preset, k, n, layers=2):
    # preset: a preset name or a QuantSpec
    g = torch.Generator(device="cuda").manual_seed(0)
    qts = [pad_quantized_groups(quantize(torch.randn((k, n), generator=g, device="cuda") * 0.02,
                                         preset)) for _ in range(layers)]
    z = qts[0].zero
    return qts, (torch.stack([q.data for q in qts]), torch.stack([q.scale for q in qts]),
                 None if z is None else torch.stack([q.zero for q in qts]))


def _x_for(qt, m):
    spec = qt.spec
    rows = qt.data.shape[-2]
    K = rows if spec.storage == "i8" else rows * spec.elems_per_word
    return (torch.randn((m, K), device="cuda") * 0.5).to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("k,n", [(4096, 4096), (11008, 384)])  # 288 groups; a ragged 256-column edge
def test_cuda_gemv_gp3_matches_plain(m, k, n):
    _need_gpu()
    qts, (data, scale, _) = _stacked("q3bf16_s16", k, n)
    x = _x_for(qts[1], m)
    before = dm.gemv_gp3.launches
    got = dm.gemv_gp3(x, data, scale, layer=1, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert dm.gemv_gp3.launches == before + 1
    want = dm.gemv_gp3_plain(x, qts[1].data, qts[1].scale, torch.float32)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 200])
@pytest.mark.parametrize("preset", ["q3bf16_s16", "q3bf16", "fp4bf16", "q8bf16"])
def test_cuda_gemm_plane_matches_plain(preset, m):
    _need_gpu()
    torch.backends.cuda.matmul.allow_tf32 = False
    qts, (data, scale, zero) = _stacked(preset, 4096, 4096)
    x = _x_for(qts[1], m)
    before = dm.gemm_plane.launches
    got = dm.gemm_plane(x, data, scale, zero, qts[1].spec, layer=1, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert dm.gemm_plane.launches == before + 1
    want = dm.gemm_plane_plain(x, qts[1].data, qts[1].scale, qts[1].zero, qts[1].spec,
                               torch.bfloat16)
    # identical bf16 weights; the f32 sums run in another order
    torch.testing.assert_close(got.float(), want.float(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("preset,k", [("q3bf16", 200), ("q3bf16_s16", 120), ("q8bf16", 96)])
def test_cuda_gemm_plane_ragged_groups(preset, k):
    # group counts that are not a multiple of the kernel's 4-group K step
    # (5, 3 and 3 groups, unpadded)
    _need_gpu()
    spec = QUANT_PRESETS[preset]
    g = torch.Generator(device="cuda").manual_seed(1)
    qt = quantize(torch.randn((k, 128), generator=g, device="cuda") * 0.02, spec)
    x = _x_for(qt, 3)
    got = dm.gemm_plane(x, qt.data, qt.scale, qt.zero, spec, out_dtype=torch.float32)
    want = dm.gemm_plane_plain(x, qt.data, qt.scale, qt.zero, spec, torch.float32)
    torch.testing.assert_close(got, want, **TOL)


# int4 in every order and compute dtype: (preset, layout); the hsplit f32
# weight is the q4f16_hs model's lm head
INT4_CASES = [("q4bf16_pair", "pair"), ("q4bf16_sym", "pair"), ("q4f16_pair", "pair"),
              ("q4f32", "pair"), ("q4bf16_hs", "hsplit"), ("q4f16_hs", "hsplit"),
              ("q4f32", "hsplit"), ("q4f16", "qsplit"), ("q4f32", "qsplit")]
# f32: nothing rounds but the f32 sums (3xTF32 in the GEMMs keeps f32's
# accuracy); bf16/f16: a rounded group sum or weight may fall the other way
F32_TOL = dict(atol=1e-4, rtol=1e-3)


def _int4_stacked(preset, layout, k=2560, n=2560):
    # the 3B width: k = 2560 is 80 groups, padded to 96 as the engine pads
    spec = dataclasses.replace(QUANT_PRESETS[preset], layout=layout)
    qts, stacked = _stacked(spec, k, n)
    x = _x_for(qts[1], 1).to(getattr(torch, spec.dtype))
    return qts[1], stacked, x


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("preset,layout", INT4_CASES)
def test_cuda_int4_gemv_matches_plain(preset, layout, m):
    _need_gpu()
    one, (data, scale, zero), x = _int4_stacked(preset, layout)
    x = x[:1].repeat(m, 1) * torch.arange(1, m + 1, device="cuda", dtype=x.dtype)[:, None]
    fn, plain = ((dm.gemv_qs, dm.gemv_qs_plain) if layout == "qsplit"
                 else (dm.gemv_gp, dm.gemv_gp_plain))
    extra = () if layout == "qsplit" else (layout,)
    before = fn.launches
    got = fn(x, data, scale, zero, *extra, layer=1, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(x, one.data, one.scale, one.zero, *extra, torch.float32)
    torch.testing.assert_close(got, want, **(F32_TOL if x.dtype == torch.float32 else TOL))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [16, 200])
@pytest.mark.parametrize("preset,layout", INT4_CASES)
def test_cuda_int4_gemm_matches_plain(preset, layout, m):
    _need_gpu()
    torch.backends.cuda.matmul.allow_tf32 = False
    one, (data, scale, zero), x = _int4_stacked(preset, layout)
    x = x[:1].repeat(m, 1) + torch.randn((m, x.shape[1]), device="cuda").to(x.dtype) * 0.5
    fn, plain = ((dm.gemm_qs, dm.gemm_qs_plain) if layout == "qsplit"
                 else (dm.gemm_pairs, dm.gemm_pairs_plain))
    extra = () if layout == "qsplit" else (layout,)
    before = fn.launches
    got = fn(x, data, scale, zero, *extra, layer=1, out_dtype=x.dtype)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(x, one.data, one.scale, one.zero, *extra, x.dtype)
    torch.testing.assert_close(got.float(), want.float(),
                               **(F32_TOL if x.dtype == torch.float32 else TOL))


@pytest.mark.cuda
def test_cuda_int4_mixed_dtypes_raise():
    # f32 x on bf16 scales has no kernel: it raises, nothing converts
    _need_gpu()
    one, (data, scale, zero), x = _int4_stacked("q4bf16_pair", "pair")
    with pytest.raises(NotImplementedError, match="one dtype"):
        dm.gemv_gp(x.float(), data, scale, zero, "pair", layer=1)


# The wgmma GEMMs (csrc/dequant_wgmma.cuh) at chip_smoke.py's KERNEL_TOL
# (TOL): ragged m over every compiled m tile, stacked (layer 1 of 2) and
# flat, split K on and off.
RAGGED_M = [9, 17, 100, 129, 1000, 2047]
# (preset, stacked, out in f32): qsplit sym and asym, bf16 and f16
QS_CASES = [("q4bf16", True, False), ("q4bf16_sym", False, True), ("q4f16", True, True),
            ("q4f16", False, False)]


def _weights(preset, k, n, stacked):
    qts, stacked_t = _stacked(preset, k, n, layers=2 if stacked else 1)
    if stacked:
        return qts[1], stacked_t, 1
    one = qts[0]
    return one, (one.data, one.scale, one.zero), None


@pytest.mark.cuda
@pytest.mark.parametrize("m", RAGGED_M)
@pytest.mark.parametrize("preset,stacked,out_f32", QS_CASES)
def test_cuda_wgmma_gemm_qs_matches_plain(preset, stacked, out_f32, m):
    _need_gpu()
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = dataclasses.replace(QUANT_PRESETS[preset], layout="qsplit")
    one, (data, scale, zero), layer = _weights(spec, 4096, 1024, stacked)
    cd = getattr(torch, spec.dtype)
    x = _x_for(one, m).to(cd)
    out_dtype = torch.float32 if out_f32 else cd
    before = dm.gemm_qs.launches
    got = dm.gemm_qs(x, data, scale, zero, layer=layer, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert dm.gemm_qs.launches == before + 1
    want = dm.gemm_qs_plain(x, one.data, one.scale, one.zero, out_dtype)
    torch.testing.assert_close(got.float(), want.float(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(9, 4096, 4096), (128, 11008, 4096), (2047, 4096, 22016),
                                   (200, 2560, 2560)])
def test_cuda_wgmma_gemm_qs_split_k(m, k, n):
    # split K on (m = 9, 128 at N = 4096; the 3B width) and off (m = 2047 at
    # w_in); k = 2560 is 80 groups, stored as 96
    _need_gpu()
    torch.backends.cuda.matmul.allow_tf32 = False
    one, (data, scale, zero), layer = _weights("q4bf16", k, n, True)
    x = _x_for(one, m)
    K, N = x.shape[1], data.shape[-1]
    splits = dm.gemm_tiles(m, N, K // dm.QS_STAGE_K, dm.QS_WIDTHS)[1]
    assert (splits > 1) == (m < 2047)
    got = dm.gemm_qs(x, data, scale, zero, layer=layer)
    want = dm.gemm_qs_plain(x, one.data, one.scale, one.zero, torch.bfloat16)
    torch.testing.assert_close(got.float(), want.float(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m", RAGGED_M)
@pytest.mark.parametrize("preset", ["q3bf16_s16", "q3bf16", "fp4bf16", "q8bf16"])
@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "flat"])
def test_cuda_wgmma_gemm_plane_matches_plain(preset, stacked, m):
    # k = 4096 is 103 int3 groups, padded to 128 as the engine pads
    _need_gpu()
    torch.backends.cuda.matmul.allow_tf32 = False
    one, (data, scale, zero), layer = _weights(preset, 4096, 1024, stacked)
    x = _x_for(one, m)
    out_dtype = torch.bfloat16 if stacked else torch.float32
    before = dm.gemm_plane.launches
    got = dm.gemm_plane(x, data, scale, zero, one.spec, layer=layer, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert dm.gemm_plane.launches == before + 1
    want = dm.gemm_plane_plain(x, one.data, one.scale, one.zero, one.spec, out_dtype)
    torch.testing.assert_close(got.float(), want.float(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(8, 4096), (8, 22016), (2047, 4096)])
def test_cuda_wgmma_gemm_plane_split_k(m, n):
    # split K on at the b8 decode (wo, and w_in's uneven last wave), off at m = 2047
    _need_gpu()
    torch.backends.cuda.matmul.allow_tf32 = False
    one, (data, scale, zero), layer = _weights("q3bf16_s16", 4096, n, True)
    x = _x_for(one, m)
    rows, N = data.shape[-2:]
    assert (dm.plane_tiles(1, m, N, rows)[1] > 1) == (m == 8)
    got = dm.gemm_plane(x, data, scale, zero, one.spec, layer=layer)
    want = dm.gemm_plane_plain(x, one.data, one.scale, one.zero, one.spec, torch.bfloat16)
    torch.testing.assert_close(got.float(), want.float(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["gemm_qs", "gemm_plane"])
def test_cuda_wgmma_misaligned_x_raises(kernel):
    # TMA reads from 16-byte aligned bases: x one element off raises
    _need_gpu()
    preset = "q4bf16" if kernel == "gemm_qs" else "q3bf16_s16"
    one, (data, scale, zero), layer = _weights(preset, 4096, 1024, False)
    K = _x_for(one, 1).shape[1]
    x = torch.zeros(16 * K + 1, dtype=torch.bfloat16, device="cuda")[1:].view(16, K)
    with pytest.raises(ValueError, match="16-byte aligned"):
        if kernel == "gemm_qs":
            dm.gemm_qs(x, data, scale, zero)
        else:
            dm.gemm_plane(x, data, scale, zero, one.spec)


# gemm_pairs on the wgmma mainloop (csrc/dequant_gemm_pairs.cu): both
# orders in bf16, f16 and f32, sym and asym, stacked (layer 1 of 2) and
# flat, out in the compute dtype or f32, over every compiled m tile; the
# 3B width's K = 2560 (80 groups, stored as 96)
PAIRS_WG_CASES = [("q4bf16_pair", "pair", True, False), ("q4bf16_sym", "pair", False, True),
                  ("q4f16_pair", "pair", True, True), ("q4f32", "pair", True, False),
                  ("q4f32", "pair", False, True), ("q4bf16_hs", "hsplit", True, False),
                  ("q4f16_hs", "hsplit", False, True), ("q4f16_hs", "hsplit", True, False),
                  ("q4f32", "hsplit", False, True), ("q4bf16_sym", "hsplit", True, False)]


def _pairs_weights(preset, layout, k, n, stacked):
    spec = dataclasses.replace(QUANT_PRESETS[preset], layout=layout)
    one, tensors, layer = _weights(spec, k, n, stacked)
    cd = getattr(torch, spec.dtype)
    return one, tensors, layer, cd


@pytest.mark.cuda
@pytest.mark.parametrize("m", RAGGED_M)
@pytest.mark.parametrize("preset,layout,stacked,out_f32", PAIRS_WG_CASES)
def test_cuda_wgmma_gemm_pairs_matches_plain(preset, layout, stacked, out_f32, m):
    _need_gpu()
    torch.backends.cuda.matmul.allow_tf32 = False
    one, (data, scale, zero), layer, cd = _pairs_weights(preset, layout, 2560, 1024, stacked)
    assert one.scale.shape[0] == 96
    x = _x_for(one, m).to(cd)
    out_dtype = torch.float32 if out_f32 else cd
    before = dm.gemm_pairs.launches
    got = dm.gemm_pairs(x, data, scale, zero, layout, layer=layer, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert dm.gemm_pairs.launches == before + 1
    want = dm.gemm_pairs_plain(x, one.data, one.scale, one.zero, layout, out_dtype)
    torch.testing.assert_close(got.float(), want.float(),
                               **(F32_TOL if cd == torch.float32 else TOL))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(9, 2560, 2560), (128, 10240, 2560), (2047, 2560, 10240)])
@pytest.mark.parametrize("preset,layout", [("q4f32", "pair"), ("q4f16_hs", "hsplit"),
                                           ("q4bf16_pair", "pair")])
def test_cuda_wgmma_gemm_pairs_split_k(preset, layout, m, k, n):
    # split K on (m = 9, 128 at N = 2560) and off (m = 2047 at w_in)
    _need_gpu()
    torch.backends.cuda.matmul.allow_tf32 = False
    one, (data, scale, zero), layer, cd = _pairs_weights(preset, layout, k, n, True)
    x = _x_for(one, m).to(cd)
    K, N = x.shape[1], data.shape[-1]
    stage_k, widths, times = dm.PAIRS_PLAN[(layout, cd == torch.float32)]
    splits = dm.gemm_tiles(m, N, K // stage_k, widths, times=times)[1]
    assert (splits > 1) == (m < 2047)
    got = dm.gemm_pairs(x, data, scale, zero, layout, layer=layer, out_dtype=cd)
    want = dm.gemm_pairs_plain(x, one.data, one.scale, one.zero, layout, cd)
    torch.testing.assert_close(got.float(), want.float(),
                               **(F32_TOL if cd == torch.float32 else TOL))


@pytest.mark.cuda
@pytest.mark.parametrize("preset,layout", [("q4bf16_pair", "pair"), ("q4f32", "hsplit")])
def test_cuda_wgmma_gemm_pairs_misaligned_x_raises(preset, layout):
    _need_gpu()
    one, (data, scale, zero), layer, cd = _pairs_weights(preset, layout, 2560, 1024, False)
    K = _x_for(one, 1).shape[1]
    x = torch.zeros(16 * K + 1, dtype=cd, device="cuda")[1:].view(16, K)
    with pytest.raises(ValueError, match="16-byte aligned"):
        dm.gemm_pairs(x, data, scale, zero, layout, out_dtype=cd)


# gemv_qs on the tensor cores (2 <= m <= 8, bf16 and f16): the Vicuna-7B
# widths (wo; w_out's K = 11008 stored as 11264) and the 3B width (K = 2560
# stored as 3072)
@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("preset", ["q4bf16", "q4bf16_sym", "q4f16"])
@pytest.mark.parametrize("k,n", [(4096, 4096), (11008, 4096), (2560, 2560)])
def test_cuda_gemv_qs_tensor_cores_matches_plain(k, n, preset, m):
    _need_gpu()
    spec = dataclasses.replace(QUANT_PRESETS[preset], layout="qsplit")
    one, (data, scale, zero), layer = _weights(spec, k, n, True)
    x = _x_for(one, m).to(getattr(torch, spec.dtype))
    before = dm.gemv_qs.launches
    got = dm.gemv_qs(x, data, scale, zero, layer=layer, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert dm.gemv_qs.launches == before + 1
    want = dm.gemv_qs_plain(x, one.data, one.scale, one.zero, torch.float32)
    # a group sum of x rounded to T may fall the other way after an f32 sum
    # in another order: the CPU tolerance
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.cuda
def test_cuda_gemv_qs_tensor_cores_sym_f16():
    _need_gpu()
    spec = dataclasses.replace(QUANT_PRESETS["q4f16"], layout="qsplit", sym=True)
    one, (data, scale, zero), layer = _weights(spec, 4096, 1024, False)
    assert zero is None
    x = _x_for(one, 5).to(torch.float16)
    got = dm.gemv_qs(x, data, scale, zero, out_dtype=torch.float16)
    want = dm.gemv_qs_plain(x, one.data, one.scale, one.zero, torch.float16)
    torch.testing.assert_close(got.float(), want.float(), **TOL)


# the dense route and attention on the tensor cores against their CPU path
@pytest.mark.cuda
@pytest.mark.parametrize("preset,out_dtype", [("q4bf16", None), ("q4bf16", torch.float32),
                                              ("q4f16_hs", torch.float32), ("q4f32", None)])
def test_cuda_dense_matmul_matches_cpu(preset, out_dtype):
    _need_gpu()
    torch.backends.cuda.matmul.allow_tf32 = False
    qt = _card_weight_preset(preset, 4096, 1024)
    cd = getattr(torch, qt.spec.dtype)
    x = (torch.randn((2, 1100, 4096), device="cuda") * 0.5).to(cd)
    got = dm.dense_matmul(x, qt, out_dtype)
    want = dm.dense_matmul(x.cpu(), qt.map(lambda t: t.cpu()), out_dtype)
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float().cpu(), want.float(),
                               **(F32_TOL if cd == torch.float32 else TOL))


def _card_weight_preset(preset, k, n):
    g = torch.Generator(device="cuda").manual_seed(0)
    return quantize(torch.randn((k, n), generator=g, device="cuda") * 0.02, preset)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("hq,hkv", [(32, 32), (32, 8)])
def test_cuda_attend_matches_cpu(dtype, hq, hkv):
    _need_gpu()
    from mlc_llm_tpu_torch.ops import attention

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    B, Sq, Smax, D = 2, 64, 256, 128
    q = torch.randn((B, hq, Sq, D), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, hkv, Smax, D), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, hkv, D, Smax), generator=g, device="cuda").to(dtype)
    q_pos = torch.tensor([0, 150], device="cuda")
    got = attention.attend(q, k, v, q_pos, v_transposed=True)
    want = attention.attend(q.cpu(), k.cpu(), v.cpu(), q_pos.cpu(), v_transposed=True)
    assert got.dtype == dtype
    # the same products and roundings; the f32 sums run in another order
    torch.testing.assert_close(got.float().cpu(), want.float(),
                               **(F32_TOL if dtype == torch.float32 else TOL))


# kernel 7 at every head dim of the registry (80: NeoX 3B, 128, 256: MOSS),
# every query type and every page type
def _paged_inputs(D, hkv, rep, hb, qdt, pdt, lengths, ps=64, maxp=8, seed=0, pool=64):
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, L, P = len(lengths), 2, pool
    G = hkv // hb
    shape = (G, L, P, ps, hb * D)
    ks = vs = None
    if pdt == torch.int8:
        kp, vp = (torch.randint(-127, 128, shape, generator=g, device="cuda",
                                dtype=torch.int8) for _ in range(2))
        ks = torch.rand((G, L, P, hb, ps), generator=g, device="cuda") * 0.02 + 1e-3
        vs = torch.rand((G, L, P, ps, hb), generator=g, device="cuda") * 0.02 + 1e-3
    else:
        kp, vp = (torch.randn(shape, generator=g, device="cuda").to(pdt) for _ in range(2))
    table = (torch.randperm(P - 1, generator=torch.Generator().manual_seed(1))[:B * maxp]
             .reshape(B, maxp) + 1).int().cuda()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q = torch.randn((B, hkv * rep, 1, D), generator=g, device="cuda").to(qdt)
    return q, kp, vp, ks, vs, table, lens


PAGE_DTYPES = [torch.bfloat16, torch.float16, torch.float32, torch.int8]
Q_DTYPES = [torch.bfloat16, torch.float16, torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("pdt", PAGE_DTYPES, ids=lambda t: str(t)[6:])
@pytest.mark.parametrize("qdt", Q_DTYPES, ids=lambda t: str(t)[6:])
@pytest.mark.parametrize("D,hkv,rep,hb", [(80, 32, 1, 8), (80, 8, 3, 4), (128, 8, 2, 8),
                                          (256, 24, 1, 8), (256, 4, 3, 2)])
def test_cuda_paged_flash_decode_head_dims_and_types(D, hkv, rep, hb, qdt, pdt):
    _need_gpu()
    from mlc_llm_tpu_torch.ops import paged_attention as pa

    q, kp, vp, ks, vs, table, lens = _paged_inputs(D, hkv, rep, hb, qdt, pdt,
                                                   [0, 63, 64, 300, 511])
    before = pa.paged_flash_decode.launches
    got = pa.paged_flash_decode(q, kp, vp, ks, vs, table, lens, 1, num_pages_window=8,
                                head_dim=D)
    torch.cuda.synchronize()
    assert pa.paged_flash_decode.launches == before + 1 and got.dtype == qdt
    want = pa.paged_flash_decode_plain(q, kp, vp, ks, vs, table, lens, 1, num_pages_window=8,
                                       head_dim=D)
    # the same roundings, summed in another order; f32 pages and q round nothing
    tol = F32_TOL if qdt == pdt == torch.float32 else TOL
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 96, 512])
def test_cuda_paged_flash_decode_other_head_dims_raise(D):
    # no lane layout compiled for D: it raises, nothing runs the plain version
    _need_gpu()
    from mlc_llm_tpu_torch.ops import paged_attention as pa

    q, kp, vp, ks, vs, table, lens = _paged_inputs(D, 8, 1, 8, torch.bfloat16, torch.bfloat16,
                                                   [5, 70])
    before = pa.paged_flash_decode.launches
    with pytest.raises(NotImplementedError, match="head_dim"):
        pa.paged_flash_decode(q, kp, vp, ks, vs, table, lens, 1, num_pages_window=8,
                              head_dim=D)
    assert pa.paged_flash_decode.launches == before


# gemv_gp on the tensor cores (2 <= m <= 8): pair and hsplit, bf16, f16 and
# f32 (TF32 on x's hi and lo planes), sym and asym, at the 3B width (K =
# 2560 stored as 3072; w_out's K = 10240)
GP_TC_CASES = [("q4bf16_pair", "pair"), ("q4bf16_sym", "pair"), ("q4f16_pair", "pair"),
               ("q4f32", "pair"), ("q4bf16_hs", "hsplit"), ("q4f16_hs", "hsplit"),
               ("q4f32", "hsplit"), ("q4bf16_sym", "hsplit")]


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("preset,layout", GP_TC_CASES)
@pytest.mark.parametrize("k,n", [(2560, 2560), (10240, 2560)])
def test_cuda_gemv_gp_tensor_cores_matches_plain(k, n, preset, layout, m):
    _need_gpu()
    one, (data, scale, zero), layer, cd = _pairs_weights(preset, layout, k, n, True)
    x = _x_for(one, m).to(cd)
    before = dm.gemv_gp.launches
    got = dm.gemv_gp(x, data, scale, zero, layout, layer=layer, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert dm.gemv_gp.launches == before + 1
    want = dm.gemv_gp_plain(x, one.data, one.scale, one.zero, layout, torch.float32)
    torch.testing.assert_close(got, want, **(F32_TOL if cd == torch.float32 else TOL))


@pytest.mark.cuda
@pytest.mark.parametrize("preset,layout", [("q4f32", "pair"), ("q4f32", "hsplit"),
                                           ("q4f16_hs", "hsplit")])
def test_cuda_gemv_gp_tensor_cores_flat_head(preset, layout):
    # the 3B lm head: flat, N = 50432, f32 out (f32 compute for q4f16_hs's head)
    _need_gpu()
    spec = dataclasses.replace(QUANT_PRESETS[preset], layout=layout, dtype="float32")
    one, (data, scale, zero), layer = _weights(spec, 2560, 50432, False)
    x = _x_for(one, 8).float()
    got = dm.gemv_gp(x, data, scale, zero, layout, out_dtype=torch.float32)
    want = dm.gemv_gp_plain(x, one.data, one.scale, one.zero, layout, torch.float32)
    torch.testing.assert_close(got, want, **F32_TOL)


# gemm_qs in f32 on the wgmma mainloop (3xTF32): sym and asym, stacked and
# flat, over both compiled m tiles, split K on and off
@pytest.mark.cuda
@pytest.mark.parametrize("m", RAGGED_M)
@pytest.mark.parametrize("sym,stacked", [(False, True), (True, False)], ids=["asym", "sym"])
def test_cuda_wgmma_gemm_qs_f32_matches_plain(sym, stacked, m):
    _need_gpu()
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = dataclasses.replace(QUANT_PRESETS["q4f32"], layout="qsplit", sym=sym)
    one, (data, scale, zero), layer = _weights(spec, 2560, 2560, stacked)
    x = _x_for(one, m).float()
    before = dm.gemm_qs.launches
    got = dm.gemm_qs(x, data, scale, zero, layer=layer, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert dm.gemm_qs.launches == before + 1
    want = dm.gemm_qs_plain(x, one.data, one.scale, one.zero, torch.float32)
    torch.testing.assert_close(got, want, **F32_TOL)


# gemm_plane at the m tile of 256 (A streamed per k16 step; int3/u32 runs
# its widest, 128): ragged m around and past the tile, every format,
# stacked and flat, split K off and on (the plan forced)
@pytest.mark.cuda
@pytest.mark.parametrize("parts", [1, 3], ids=["unsplit", "split3"])
@pytest.mark.parametrize("m", [255, 256, 257, 2047, 2048])
@pytest.mark.parametrize("preset", ["q3bf16_s16", "q3bf16", "fp4bf16", "q8bf16"])
@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "flat"])
def test_cuda_gemm_plane_wide_tile_matches_plain(stacked, preset, m, parts, monkeypatch):
    _need_gpu()
    torch.backends.cuda.matmul.allow_tf32 = False
    one, (data, scale, zero), layer = _weights(preset, 4096, 1024, stacked)
    x = _x_for(one, m)
    spec = one.spec
    fmt = dm.PLANE_FORMATS[(spec.mode, spec.storage, spec.group_size)]
    steps = -(-data.shape[-2] // dm.PLANE_STAGE_ROWS[fmt])
    mt, per = dm.PLANE_WIDTHS[fmt][-1], -(-steps // parts)
    monkeypatch.setattr(dm, "plane_tiles", lambda *a: (mt, -(-steps // per), per))
    out_dtype = torch.bfloat16 if stacked else torch.float32
    got = dm.gemm_plane(x, data, scale, zero, spec, layer=layer, out_dtype=out_dtype)
    torch.cuda.synchronize()
    want = dm.gemm_plane_plain(x, one.data, one.scale, one.zero, spec, out_dtype)
    torch.testing.assert_close(got.float(), want.float(), **TOL)


# kernel 7 under split-KV at the serve pool's layout (page 128, a 16-page
# window): one long slot (b1) and 8 slots of mixed lengths, on and around
# the split boundaries, every head dim, q type and page type, under the
# wrapper's plan and a forced one of 3 pages; held against the plain
# version under the same plan, and run twice: bit-identical outputs.
# Kernel and plain version round at the same points: an atol of 2e-3
# fails a combine that drops or doubles one partial of a long slot
# (which moves the output by 3e-2 or more), rtol covers one bf16 ulp of
# the larger outputs.
PAGED_SPLIT_TOL = dict(atol=2e-3, rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("forced", [None, 3], ids=["plan", "pps3"])
@pytest.mark.parametrize("batch", ["b1", "b8"])
@pytest.mark.parametrize("pdt", PAGE_DTYPES, ids=lambda t: str(t)[6:])
@pytest.mark.parametrize("qdt", Q_DTYPES, ids=lambda t: str(t)[6:])
@pytest.mark.parametrize("D,hkv,rep,hb", [(80, 32, 1, 8), (128, 32, 1, 8), (128, 8, 4, 8),
                                          (256, 24, 1, 8)])
def test_cuda_paged_flash_decode_split(D, hkv, rep, hb, qdt, pdt, batch, forced, monkeypatch):
    _need_gpu()
    from mlc_llm_tpu_torch.ops import paged_attention as pa

    ps, window = 128, 16
    if forced is not None:
        monkeypatch.setattr(pa, "split_pages", lambda *a: forced)
    B = 1 if batch == "b1" else 8
    probe, kp0, _, _, _, table0, _ = _paged_inputs(D, hkv, rep, hb, qdt, pdt, [0] * B, ps=ps,
                                                   maxp=window, pool=B * window + 1)
    pps, nsplit = pa.launch_plan(probe, kp0, table0, window)
    edge = pps * ps  # the first position of split 1
    if B == 1:
        runs = [[n] for n in (0, edge - 1, edge, edge + 1, window * ps - 1)]
    else:
        runs = [[0, 1, edge - 1, edge, edge + 1, 2 * edge, 1500, window * ps - 1]]
    for lengths in runs:
        q, kp, vp, ks, vs, table, lens = _paged_inputs(D, hkv, rep, hb, qdt, pdt, lengths,
                                                       ps=ps, maxp=window, pool=B * window + 1)

        def run():
            return pa.paged_flash_decode(q, kp, vp, ks, vs, table, lens, 1,
                                         num_pages_window=window, head_dim=D)

        before = pa.paged_flash_decode.launches
        got, again = run(), run()
        torch.cuda.synchronize()
        assert pa.paged_flash_decode.launches == before + 2 and got.dtype == qdt
        assert torch.equal(got, again)  # the combine's order is fixed
        want = pa.paged_flash_decode_plain(q, kp, vp, ks, vs, table, lens, 1,
                                           num_pages_window=window, head_dim=D,
                                           pages_per_split=pps)
        tol = F32_TOL if qdt == pdt == torch.float32 else PAGED_SPLIT_TOL
        torch.testing.assert_close(got.float(), want.float(), **tol)


# The streaming GEMVs (csrc/gemv_stream.cuh): every m = 1 body (gp3 also at
# m = 2) at every main-path shape, stacked (layer 1 of 2) or, for the lm
# heads, flat with an f32 out (f32 compute where the model's head is f32);
# sym and asym; ragged N (a part-filled 256-column tile). One launch
# counter tick a call; two calls bit-equal (the parts are summed in part
# order); the tickets left zero.
VICUNA_MM = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096), (4096, 32000)]
NEOX_3B_MM = [(2560, 7680), (2560, 2560), (2560, 10240), (10240, 2560), (2560, 50432)]
STREAM_CASES = ([("q4bf16", "qsplit", k, n) for k, n in VICUNA_MM]
                + [("q4f32", "pair", k, n) for k, n in NEOX_3B_MM]
                + [("q4f16_hs", "hsplit", k, n) for k, n in NEOX_3B_MM]
                + [("q4f16", "qsplit", 2560, 10240), ("q4f32", "qsplit", 2560, 10240),
                   ("q4bf16_pair", "pair", 4096, 22016), ("q4bf16_hs", "hsplit", 4096, 22016),
                   ("q4bf16_sym", "qsplit", 4096, 4096), ("q4bf16_sym", "pair", 2560, 2560),
                   ("q4bf16_sym", "hsplit", 2560, 2560), ("q4bf16", "qsplit", 4096, 320),
                   ("q4f32", "pair", 2560, 320), ("q4f16_hs", "hsplit", 2560, 320)])


def _tickets_zero():
    from mlc_llm_tpu_torch.ops import _TICKETS

    return all(int(t.abs().sum()) == 0 for t in _TICKETS.values())


def _stream_call(counted, call, want, tol):
    """Two calls of `call` (one launch of the `counted` wrapper each):
    bit-equal, the tickets zero after, and close to `want`."""
    before = counted.launches
    got, again = call(), call()
    torch.cuda.synchronize()
    assert counted.launches == before + 2
    assert torch.equal(got, again)  # deterministic: the parts in part order
    assert _tickets_zero()
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("preset,order,k,n", STREAM_CASES)
def test_cuda_stream_gemv_matches_plain(preset, order, k, n):
    _need_gpu()
    spec = dataclasses.replace(QUANT_PRESETS[preset], layout=order)
    head = n in (32000, 50432)
    if head and order != "qsplit":
        spec = dataclasses.replace(spec, dtype="float32")  # the 3B models' f32 heads
    qts, (data, scale, zero) = _stacked(spec, k, n)
    one = qts[1]
    x = _x_for(one, 1).to(getattr(torch, spec.dtype))
    layer, out_dtype = (None, torch.float32) if head else (1, x.dtype)
    if head:
        data, scale, zero = one.data, one.scale, one.zero
    fn, plain = ((dm.gemv_qs, dm.gemv_qs_plain) if order == "qsplit"
                 else (dm.gemv_gp, dm.gemv_gp_plain))
    extra = () if order == "qsplit" else (order,)
    assert dm.route(one.spec, one.scale.shape[0], 1) == fn.__name__
    want = plain(x, one.data, one.scale, one.zero, *extra, out_dtype)
    _stream_call(fn, lambda: fn(x, data, scale, zero, *extra, layer=layer, out_dtype=out_dtype),
                 want, F32_TOL if x.dtype == torch.float32 else TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("k,n", VICUNA_MM + [(4096, 264)])
def test_cuda_stream_gemv_gp3_matches_plain(k, n, m):
    _need_gpu()
    qts, (data, scale, _) = _stacked("q3bf16_s16", k, n)
    one = qts[1]
    x = _x_for(one, m)
    head = n == 32000
    layer, out_dtype = (None, torch.float32) if head else (1, torch.bfloat16)
    if head:
        data, scale = one.data, one.scale
    want = dm.gemv_gp3_plain(x, one.data, one.scale, out_dtype)
    _stream_call(dm.gemv_gp3,
                 lambda: dm.gemv_gp3(x, data, scale, layer=layer, out_dtype=out_dtype), want, TOL)


# The f16 bodies of the int3/fp4/int8 kernels (q3f16, q3f16_s16, fp4f16,
# q8f16): x, x_t, the scales and the tensor maps in f16. x ~ 0.5 N(0, 1):
# a map that read f16 bytes as bf16 would miss the plain version by far
# more than TOL at this magnitude.
F16_PLANE = ["q3f16_s16", "q3f16", "fp4f16", "q8f16"]


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("k,n", VICUNA_MM + [(4096, 264)])
def test_cuda_stream_gemv_gp3_f16_matches_plain(k, n, m):
    _need_gpu()
    qts, (data, scale, _) = _stacked("q3f16_s16", k, n)
    one = qts[1]
    x = _x_for(one, m).half()
    head = n == 32000
    layer, out_dtype = (None, torch.float32) if head else (1, torch.float16)
    if head:
        data, scale = one.data, one.scale
    want = dm.gemv_gp3_plain(x, one.data, one.scale, out_dtype)
    _stream_call(dm.gemv_gp3,
                 lambda: dm.gemv_gp3(x, data, scale, layer=layer, out_dtype=out_dtype), want, TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8] + RAGGED_M)
@pytest.mark.parametrize("preset", F16_PLANE)
@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "flat"])
def test_cuda_wgmma_gemm_plane_f16_matches_plain(preset, stacked, m):
    _need_gpu()
    torch.backends.cuda.matmul.allow_tf32 = False
    one, (data, scale, zero), layer = _weights(preset, 4096, 1024, stacked)
    x = _x_for(one, m).half()
    out_dtype = torch.float16 if stacked else torch.float32
    before = dm.gemm_plane.launches
    got = dm.gemm_plane(x, data, scale, zero, one.spec, layer=layer, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert dm.gemm_plane.launches == before + 1 and got.dtype == out_dtype
    want = dm.gemm_plane_plain(x, one.data, one.scale, one.zero, one.spec, out_dtype)
    torch.testing.assert_close(got.float(), want.float(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [1, 3], ids=["unsplit", "split3"])
@pytest.mark.parametrize("m", [256, 2047])
@pytest.mark.parametrize("preset", F16_PLANE)
def test_cuda_gemm_plane_f16_wide_tile_matches_plain(preset, m, parts, monkeypatch):
    _need_gpu()
    torch.backends.cuda.matmul.allow_tf32 = False
    one, (data, scale, zero), layer = _weights(preset, 4096, 1024, True)
    x = _x_for(one, m).half()
    spec = one.spec
    fmt = dm.PLANE_FORMATS[(spec.mode, spec.storage, spec.group_size)]
    steps = -(-data.shape[-2] // dm.PLANE_STAGE_ROWS[fmt])
    mt, per = dm.PLANE_WIDTHS[fmt][-1], -(-steps // parts)
    monkeypatch.setattr(dm, "plane_tiles", lambda *a: (mt, -(-steps // per), per))
    got = dm.gemm_plane(x, data, scale, zero, spec, layer=layer, out_dtype=torch.float16)
    torch.cuda.synchronize()
    want = dm.gemm_plane_plain(x, one.data, one.scale, one.zero, spec, torch.float16)
    torch.testing.assert_close(got.float(), want.float(), **TOL)


@pytest.mark.cuda
def test_cuda_f16_x_on_bf16_scales_raises():
    # x and the scales in one dtype: f16 x on a bf16 preset's scales has
    # no kernel, and nothing converts
    _need_gpu()
    one, (data, scale, zero), _ = _weights("q3bf16_s16", 4096, 1024, True)
    x = _x_for(one, 1).half()
    with pytest.raises(NotImplementedError, match="one dtype"):
        dm.gemv_gp3(x, data, scale, layer=1, out_dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="one dtype"):
        dm.gemm_plane(x, data, scale, zero, one.spec, layer=1, out_dtype=torch.float16)


# ------------------------------------------------------- the decode graph
# Each decode step of a CUDA engine replays one captured graph
# (engine/programs.py). The eager step is the same step function run
# without the graph (the engine's programs.run swapped for a direct
# call). Tolerance 0: every kernel of the step combines its split parts
# in a fixed order (the streaming GEMVs and kernel 7 in part order after
# their tickets, the wgmma GEMVs through their partial buffers), so two
# eager runs agree bit for bit and a replay must too.

GRAPH_LAYERS = 2


@pytest.fixture(scope="module")
def vicuna2():
    _need_gpu()
    from mlc_llm_tpu_torch.models import get_config, init_random_params

    cfg = get_config("vicuna-v1-7b").replace(num_layers=GRAPH_LAYERS)
    return cfg, init_random_params(cfg, "q4bf16", seed=0, device="cuda")


def _graph_engine(vicuna2, batch, eager=False):
    from mlc_llm_tpu_torch.engine import InferenceEngine

    cfg, params = vicuna2
    kw = dict(kv_layout="paged", page_size=128) if batch > 1 else {}
    eng = InferenceEngine(cfg, params, max_batch=batch, max_seq_len=2048, device="cuda", **kw)
    eng.cfg = cfg.replace(stop_tokens=())  # decode the full count
    seen = []
    run = eng.programs.run

    def spy(key, fn, warm_up):
        out = fn() if eager else run(key, fn, warm_up)
        seen.append(tuple(t.clone() for t in out))
        return out

    eng.programs.run = spy
    return eng, seen


def _graph_prompts(batch):
    rng = torch.Generator().manual_seed(3)
    return [torch.randint(3, 32000, (int(n),), generator=rng).tolist()
            for n in torch.randint(8, 300, (batch,), generator=rng)]


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8], ids=["b1-slot", "b8-paged"])
def test_cuda_decode_graph_matches_eager_step(vicuna2, batch):
    from mlc_llm_tpu_torch.engine import GenerationConfig
    from mlc_llm_tpu_torch.ops import kernel_wrappers

    prompts = _graph_prompts(batch)
    gen = GenerationConfig(max_new_tokens=12, temperature=0.0)
    runs = []
    for eager in (False, True):
        eng, seen = _graph_engine(vicuna2, batch, eager)
        before = [w.launches for w in kernel_wrappers()]
        toks = eng.generate(prompts, gen)
        torch.cuda.synchronize()
        launches = [w.launches - b for w, b in zip(kernel_wrappers(), before)]
        runs.append((eng, seen, toks, launches))
    (geng, gseen, gtoks, glaunch), (eeng, eseen, etoks, elaunch) = runs
    assert gtoks == etoks and all(len(t) == 12 for t in gtoks)
    # the prefill, the first-token draw and 11 decode steps
    assert len(gseen) == len(eseen) == 13
    for g, e in zip(gseen, eseen):
        assert all(torch.equal(a, b) for a, b in zip(g, e))
    # a replay counts the launches of the program it replays, and nothing else
    assert glaunch == elaunch and sum(glaunch) > 0
    assert geng.programs.count == len(geng.programs.keys) >= 3
    assert geng.programs.runs_by_kind() == {"prefill": 1, "sample": 1, "decode": 11}
    assert geng.programs.replays == 13 and geng.decode_forwards == 11
    assert eeng.programs.count == 0
    # the capture stream's tickets are left zero by the replays
    from mlc_llm_tpu_torch.ops import _TICKETS

    tickets = _TICKETS[(torch.device("cuda", torch.cuda.current_device()),
                        geng.programs._stream.cuda_stream)]
    assert int(tickets.abs().sum()) == 0
    # a repeated run captures nothing new and gives the same tokens
    count = geng.programs.count
    assert geng.generate(prompts, gen) == gtoks and geng.programs.count == count


@pytest.mark.cuda
def test_cuda_trace_places_replays_on_the_host_clock(vicuna2):
    from mlc_llm_tpu_torch.engine import GenerationConfig
    from mlc_llm_tpu_torch.engine.scheduler import ContinuousBatchingScheduler

    eng, _ = _graph_engine(vicuna2, 1)
    tr = eng.trace
    tr.start()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        toks = eng.generate(_graph_prompts(1), GenerationConfig(max_new_tokens=12,
                                                               temperature=0.0))[0]
    t_stop = time.perf_counter()
    tr.stop()
    assert len(toks) == 12
    # the prefill, the draw and the decode step were captured inside the trace
    assert tr.captures == 3 and [s.key[0] for s in tr.named("capture")] == [
        "prefill", "sample", "decode"]
    replays = tr.named("replay")
    assert len(replays) == 13 and all(s.device is not None for s in replays)
    for s in replays:
        a, b = s.device
        # the device starts a replay after the host launched it and ends it
        # before stop() (the clocks are tied to within a wake-up of the host)
        assert s.start - 2e-3 <= a < b <= t_stop + 2e-3
    dev = [s.device for s in replays]
    assert all(p[1] <= q[0] + 1e-6 for p, q in zip(dev, dev[1:]))
    by_key = tr.device_seconds()
    assert sum(n for n, _ in by_key.values()) == 13
    assert {k[0] for k in by_key} == {"prefill", "sample", "decode"}
    gaps = tr.gaps()
    split = tr.gap_split()
    assert gaps and abs(sum(split.values()) - sum(b - a for a, b in gaps)) < 1e-9
    assert eng.readbacks_landed + eng.readbacks_blocked == 12
    names = {e.key for e in prof.key_averages()}
    assert {"mlc/turn", "mlc/step", "mlc/replay", "mlc/capture"} <= names
    # the pool's events serve the next start, and an off trace records nothing
    pooled = len(tr._pool)
    assert pooled == 26
    n = len(tr.spans)
    eng.generate(_graph_prompts(1), GenerationConfig(max_new_tokens=4, temperature=0.0))
    assert len(tr.spans) == n
    tr.start()
    forwards = eng.decode_forwards
    sched = ContinuousBatchingScheduler(eng, seed=0)
    sched.submit(_graph_prompts(1)[0], GenerationConfig(max_new_tokens=6, temperature=0.0))
    sched.run()
    tr.stop()
    assert len(tr._pool) >= pooled and all(s.device for s in tr.named("replay"))
    assert sched.rows_emitted == 5 and sched.rows_dispatched == eng.decode_forwards - forwards


@pytest.mark.cuda
def test_cuda_precompile_captures_every_window(vicuna2):
    from mlc_llm_tpu_torch.engine import GenerationConfig

    eng, _ = _graph_engine(vicuna2, 8)
    windows = {eng.decode_window(b) for b in eng.buckets} | {eng.max_seq_len}
    assert eng.precompile() == len(eng.precompile_keys()) == eng.programs.count
    assert {k[2] for k in eng.programs.keys if k[0] == "decode"} == windows
    assert eng.programs.pool_bytes() > 0
    n = eng.programs.count
    eng.generate(_graph_prompts(8), GenerationConfig(max_new_tokens=4, temperature=0.7, seed=1))
    # the prefill, the draw and every step replay a precompiled graph
    assert eng.programs.count == n and eng.programs.replays == 5


@pytest.mark.cuda
def test_cuda_scheduler_decode_ahead_same_tokens(vicuna2):
    from mlc_llm_tpu_torch.engine import GenerationConfig
    from mlc_llm_tpu_torch.engine.scheduler import ContinuousBatchingScheduler

    # dispatch-ahead and K-step blocks (one graph a block) change when
    # tokens are read back, never which
    outs = []
    for kw in (dict(decode_ahead=0), dict(decode_ahead=2), dict(multi_step=4)):
        eng, _ = _graph_engine(vicuna2, 8)
        blocks = []
        block = eng._decode_sample_k
        eng._decode_sample_k = lambda *a, **k: blocks.append(k["k_steps"]) or block(*a, **k)
        sched = ContinuousBatchingScheduler(eng, seed=0, **kw)
        reqs = [sched.submit(p, GenerationConfig(max_new_tokens=10,
                                                 temperature=0.7 if i == 3 else 0.0, seed=i))
                for i, p in enumerate(_graph_prompts(6))]
        sched.run()
        assert all(r.done and len(r.output) == 10 for r in reqs)
        runs = eng.programs.runs
        assert eng.programs.replays == sum(runs.values())
        assert eng.decode_forwards == sum(n * (k[2] if k[0] == "decode_k" else 1)
                                          for k, n in runs.items() if k[0].startswith("decode"))
        assert bool(blocks) == ("multi_step" in kw) == any(k[0] == "decode_k" for k in runs)
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1] == outs[2]


# The speculative verify pass (engine.verify, one graph per (batch, K,
# window)) at 2 layers. Its reference on the card is the no-draft stream:
# the same passes with a drafter that proposes nothing, so every token
# comes from the same m = K program (the m = 1 decode step runs another
# kernel body, whose last bits may break a random-weight argmax tie the
# other way). Random full-width weights give output that does not
# repeat, so the prompt-lookup drafter finds next to nothing to propose;
# a drafter that replays the no-draft stream has its drafts accepted
# wherever the verify pass agrees, which holds a row's result independent
# of its place in the m tile.

class _NoDraft:
    def __init__(self, history, max_ngram=3):
        pass

    def extend(self, toks):
        pass

    def propose(self, k):
        return []


class _Replay:
    """Proposes the next tokens of the reference stream of its prompt
    (refs: prompt tuple -> the tokens generated after it)."""

    refs = {}

    def __init__(self, history, max_ngram=3):
        self.history = list(history)
        key = max((k for k in self.refs if tuple(self.history[:len(k)]) == k), key=len,
                  default=())
        self.prompt_len, self.ref = len(key), self.refs.get(key, [])

    def extend(self, toks):
        self.history.extend(toks)

    def propose(self, k):
        n = len(self.history) - self.prompt_len
        return list(self.ref[n:n + k])


def _spec_engine(vicuna2, batch, eager=False):
    from mlc_llm_tpu_torch.engine import InferenceEngine

    cfg, params = vicuna2
    eng = InferenceEngine(cfg, params, max_batch=batch, max_seq_len=2048, device="cuda")
    eng.cfg = cfg.replace(stop_tokens=())  # decode the full count
    seen = []
    run = eng.programs.run

    def spy(key, fn, warm_up):
        out = fn() if eager else run(key, fn, warm_up)
        seen.append(tuple(t.clone() for t in out))
        return out

    eng.programs.run = spy
    return eng, seen


MOTIF = ([311, 42, 87, 1009, 55, 7, 66, 23] * 8)[:64]


@pytest.mark.cuda
def test_cuda_verify_graph_matches_eager_verify(vicuna2, monkeypatch):
    from mlc_llm_tpu_torch.engine import speculative

    monkeypatch.setattr(speculative, "NgramDrafter", _NoDraft)
    eng, _ = _spec_engine(vicuna2, 1)
    _Replay.refs = {tuple(MOTIF): speculative.generate_speculative(eng, MOTIF, 40, 8)}
    monkeypatch.setattr(speculative, "NgramDrafter", _Replay)
    runs = []
    for eager in (False, True):
        eng, seen = _spec_engine(vicuna2, 1, eager)
        stats = {}
        toks = speculative.generate_speculative(eng, MOTIF, max_new_tokens=40, draft_k=8,
                                                stats=stats)
        runs.append((eng, seen, toks, stats))
    (geng, gseen, gtoks, gstats), (_, eseen, etoks, estats) = runs
    assert gtoks == etoks and gstats == estats and len(gtoks) == 40
    assert gstats["accepted_drafts"] > 0
    assert len(gseen) == len(eseen) == gstats["passes"] + 1  # and the prefill
    for g, e in zip(gseen, eseen):
        assert all(torch.equal(a, b) for a, b in zip(g, e))
    assert geng.programs.runs_by_kind() == {"prefill": 1, "verify": gstats["passes"]}
    assert geng.programs.replays == geng.verify_forwards + 1
    assert {k[:3] for k in geng.programs.keys if k[0] == "verify"} == {("verify", 1, 8)}
    assert geng.programs.count == len(geng.programs.keys)


@pytest.mark.cuda
@pytest.mark.parametrize("drafter", ["prompt-lookup", "replay"])
def test_cuda_speculative_matches_no_draft_stream(vicuna2, drafter, monkeypatch):
    from mlc_llm_tpu_torch.engine import speculative

    streams, stats = [], []
    lookup = speculative.NgramDrafter
    for cls in (_NoDraft, lookup if drafter == "prompt-lookup" else _Replay):
        monkeypatch.setattr(speculative, "NgramDrafter", cls)
        eng, _ = _spec_engine(vicuna2, 1)
        st = {}
        streams.append(speculative.generate_speculative(eng, MOTIF, max_new_tokens=48,
                                                        draft_k=8, stats=st))
        stats.append(st)
        _Replay.refs = {tuple(MOTIF): streams[0]}
    assert streams[0] == streams[1] and len(streams[0]) == 48
    assert stats[0]["passes"] == 47 and stats[0]["accepted_drafts"] == 0
    if drafter == "replay":
        assert stats[1]["passes"] < stats[0]["passes"] and stats[1]["accepted_drafts"] > 0


@pytest.mark.cuda
def test_cuda_scheduler_speculation_matches_no_draft_run(vicuna2, monkeypatch):
    from mlc_llm_tpu_torch.engine import GenerationConfig, speculative
    from mlc_llm_tpu_torch.engine.scheduler import ContinuousBatchingScheduler

    monkeypatch.setenv("MLC_SPEC_FORCE", "1")
    prompts = [MOTIF] + _graph_prompts(5)
    outs, passes = [], []
    for drafter in (_NoDraft, speculative.NgramDrafter, _Replay):
        monkeypatch.setattr(speculative, "NgramDrafter", drafter)
        eng, _ = _spec_engine(vicuna2, 8)
        sched = ContinuousBatchingScheduler(eng, seed=0, speculative_k=4,
                                            speculative_max_batch=8)
        reqs = [sched.submit(p, GenerationConfig(max_new_tokens=16, temperature=0.0))
                for p in prompts]
        sched.run()
        assert all(r.done and len(r.output) == 16 for r in reqs)
        kinds = eng.programs.runs_by_kind()
        assert eng.programs.replays == sum(kinds.values())
        assert (kinds["verify"], kinds.get("decode", 0)) == (eng.verify_forwards,
                                                             eng.decode_forwards)
        outs.append([r.output for r in reqs])
        passes.append(eng.verify_forwards)
        _Replay.refs = {tuple(p): o for p, o in zip(prompts, outs[0])}
    assert outs[0] == outs[1] == outs[2]
    assert 0 < passes[2] < passes[0]


# Every engine program a graph: the prefill programs (one graph per (G,
# bucket, window), the target slots a device tensor), the first-token
# sampler, the decode step with its in-graph draw and the K-step block, at
# 2 layers against the same programs run eagerly.

@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_cuda_prefill_graph_matches_eager_prefill(vicuna2, layout):
    from mlc_llm_tpu_torch.engine import InferenceEngine

    cfg, params = vicuna2
    kw = dict(kv_layout="paged", page_size=128) if layout == "paged" else {}
    prompts = _graph_prompts(3)
    outs = []
    for eager in (False, True):
        eng = InferenceEngine(cfg, params, max_batch=4, max_seq_len=2048, device="cuda", **kw)
        if eager:
            eng.programs.run = lambda key, fn, warm_up: fn()
        got = [eng.prefill(prompts[:2], reserve_tokens=8)]
        # admissions into slots 3 then 2 (fresh), then a segment appended to 3
        for slot, p, append in ((3, prompts[2], False), (2, prompts[0][:40], False),
                                (3, prompts[1][:20], True)):
            if eng.allocator is not None:
                if not append:
                    eng.free_slot_pages(slot)
                total = int(eng.cache.lengths[slot]) * append + len(p) + 8
                eng.assign_pages(slot, eng.pages_needed(slot, total))
            bucket = eng.bucket_for(len(p))
            toks = torch.zeros((1, bucket), dtype=torch.int64)
            toks[0, :len(p)] = torch.tensor(p)
            start = int(eng.cache.lengths[slot]) if append else 0
            got.append(eng._prefill_slot(toks.numpy(), len(p), slot, append,
                                         attn_window=eng.decode_window(start + bucket)))
        torch.cuda.synchronize()
        cache = eng.cache
        names = ("k_pages", "v_pages") if layout == "paged" else ("k", "v")
        outs.append((got, [getattr(cache, n).clone() for n in names], cache.lengths.clone(),
                     eng.programs.count, eng.programs.keys))
    (g, gkv, glen, gcount, gkeys), (e, ekv, elen, ecount, _) = outs
    assert all(torch.equal(a, b) for a, b in zip(g, e))  # logits bit for bit
    assert all(torch.equal(a, b) for a, b in zip(gkv, ekv))  # the KV rows too
    assert torch.equal(glen, elen) and gcount == len(gkeys) >= 2 and ecount == 0


@pytest.mark.cuda
def test_cuda_sampled_stream_graph_equals_eager(vicuna2):
    from mlc_llm_tpu_torch.engine import GenerationConfig

    prompts = _graph_prompts(1)
    gen = GenerationConfig(max_new_tokens=12, temperature=0.7, top_p=0.95, seed=5)
    streams = []
    for eager in (False, True):
        eng, seen = _graph_engine(vicuna2, 1, eager)
        streams.append(eng.generate(prompts, gen)[0])
    assert streams[0] == streams[1] and len(streams[0]) == 12
    greedy = _graph_engine(vicuna2, 1)[0].generate(
        prompts, GenerationConfig(max_new_tokens=12, temperature=0.0))[0]
    assert streams[0] != greedy  # the draws are not argmax


@pytest.mark.cuda
def test_cuda_k_step_block_matches_single_steps(vicuna2):
    import numpy as np

    engines = [_graph_engine(vicuna2, 8)[0] for _ in range(2)]
    prompts = _graph_prompts(8)
    for eng in engines:
        eng.prefill(prompts, reserve_tokens=16)
    active = np.ones(8, bool)
    active[5] = False
    seeds, steps = np.arange(8) + 100, np.ones(8, np.int64)
    temps = np.where(np.arange(8) % 3 == 0, 0.7, 0.0).astype(np.float32)
    tok = torch.arange(8, device="cuda")[:, None] + 7
    window = engines[0].decode_window(max(len(p) for p in prompts) + 8)
    block = engines[0]._decode_sample_k(tok, active, seeds, steps, temps, 0.95,
                                        attn_window=window, k_steps=4)
    single, cur = [], tok
    for i in range(4):
        single.append(engines[1]._decode_sample(cur, active, seeds, steps + i, temps, 0.95,
                                                attn_window=window))
        cur = single[-1][:, None]
    assert torch.equal(block, torch.stack(single))
    assert engines[0].programs.runs_by_kind()["decode_k"] == 1


@pytest.mark.cuda
def test_cuda_precompiled_server_captures_nothing(vicuna2):
    from mlc_llm_tpu_torch.engine import GenerationConfig
    from mlc_llm_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
    from mlc_llm_tpu_torch.serve import multi_step_compile_ks

    eng, _ = _graph_engine(vicuna2, 8)
    n = eng.precompile(multi_step=multi_step_compile_ks("auto:4"))
    assert n == len(eng.precompile_keys((2, 4))) == eng.programs.count
    work = [(p, GenerationConfig(max_new_tokens=10, temperature=0.7 if i % 4 == 3 else 0.0,
                                 seed=i)) for i, p in enumerate(_graph_prompts(12))]
    outs = []
    for kw in (dict(multi_step="auto:4"), {}):
        sched = ContinuousBatchingScheduler(eng, seed=0, **kw)
        reqs = [sched.submit(p, g) for p, g in work]
        sched.run()
        outs.append([r.output for r in reqs])
    assert eng.programs.count == n  # serving captured no graph
    kinds = eng.programs.runs_by_kind()
    assert eng.programs.replays == sum(kinds.values()) and kinds["decode_k"] > 0
    assert kinds["prefill_slots"] == kinds["sample"] == 2 * len(work)
    assert outs[0] == outs[1]


@pytest.mark.cuda
def test_cuda_paged_decode_does_not_depend_on_the_window():
    # tolerance 0: kernel 7 under the wrapper's plan (pages per split from
    # the table's width) gives a slot the same bits at windows 4, 8 and 16
    # pages of a 16-page table: Vicuna-7B's b8 shape, slots within 4 pages
    _need_gpu()
    from mlc_llm_tpu_torch.ops import paged_attention as pa

    g = torch.Generator(device="cuda").manual_seed(0)
    B, H, D, ps, maxp, hb = 8, 32, 128, 128, 16, 8
    shape = (H // hb, 1, B * maxp + 1, ps, hb * D)
    kp, vp = (torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
              for _ in range(2))
    table = (torch.randperm(B * maxp, generator=torch.Generator().manual_seed(1)) + 1)
    table = table.int().reshape(B, maxp).cuda()
    lengths = torch.randint(0, 4 * ps, (B,), generator=g, device="cuda", dtype=torch.int32)
    q = torch.randn((B, H, 1, D), generator=g, device="cuda").to(torch.bfloat16)
    outs = [pa.paged_flash_decode(q, kp, vp, None, None, table, lengths, 0,
                                  num_pages_window=w, head_dim=D) for w in (4, 8, 16)]
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    assert [pa.launch_plan(q, kp, table, w) for w in (4, 8, 16)] == [(2, 2), (2, 4), (2, 8)]


# kernel 8: the reset prefill's causal flash attention, at Vicuna-7B's (D
# 128) and MOSS's (D 256) head dims, in bf16, f16 and f32, with GQA and in
# the forward's strided [B, S, H, D] layout
def _flash_inputs(B, Hq, Hkv, S, D, dtype, strided, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if strided:  # q, k, v as the forward hands them over: views of one qkv
        qkv = torch.randn((B, S, (Hq + 2 * Hkv) * D), generator=g, device="cuda").to(dtype)
        return tuple(t.reshape(B, S, -1, D).transpose(1, 2)
                     for t in qkv.split([Hq * D, Hkv * D, Hkv * D], dim=-1))
    return tuple(torch.randn((B, h, S, D), generator=g, device="cuda").to(dtype)
                 for h in (Hq, Hkv, Hkv))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32],
                         ids=["bf16", "f16", "f32"])
@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("B,Hq,Hkv,S,strided", [
    (1, 8, 8, 1024, False), (2, 8, 2, 256, True), (1, 4, 1, 2048, True),
    # one 128-query block and one key tile (the wgmma descriptors alone);
    # odd counts of 128-row tiles; B = 2 in separate buffers (the batch
    # stride is not S times the row stride); GQA rep 2
    (1, 4, 4, 128, False), (1, 4, 2, 1152, True), (1, 4, 4, 1920, False),
    (2, 8, 4, 384, False),
    # 512 128-query tiles: every block of the persistent grid walks several
    (2, 32, 8, 1024, True)])
def test_cuda_flash_prefill_matches_plain(B, Hq, Hkv, S, strided, D, dtype):
    _need_gpu()
    from mlc_llm_tpu_torch.ops import attention as att

    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _flash_inputs(B, Hq, Hkv, S, D, dtype, strided)
    before = att.flash_prefill.launches
    got = att.flash_prefill(q, k, v)
    torch.cuda.synchronize()
    assert att.flash_prefill.launches == before + 1
    assert got.shape == (B, Hq, S, D) and got.dtype == dtype
    want = att.flash_prefill_plain(q, k, v)
    # p rounds against the running max of the kernel's key tiles and against
    # the row's max in the plain version; the f32 sums run in another order
    torch.testing.assert_close(got.float(), want.float(),
                               **(F32_TOL if dtype == torch.float32 else TOL))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("B,Hq,Hkv,S,strided", [
    (1, 8, 8, 1024, False), (2, 8, 2, 256, True), (1, 4, 1, 2048, True), (1, 4, 4, 128, False)])
def test_cuda_flash_prefill_f32_peaked_matches_plain(B, Hq, Hkv, S, strided, D):
    # the f32 body (3xTF32) where the softmax is peaked: q scaled so that
    # the scores reach about +-30, where an error in s moves p by as much
    # times |s|; the same tolerance as the unscaled cases
    _need_gpu()
    from mlc_llm_tpu_torch.ops import attention as att

    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _flash_inputs(B, Hq, Hkv, S, D, torch.float32, strided, seed=1)
    q = q * 6.0
    scores = (q.float() @ k.repeat_interleave(Hq // Hkv, 1).transpose(-1, -2)) * D**-0.5
    assert 20 < scores.abs().max().item() < 60
    got = att.flash_prefill(q, k, v)
    torch.cuda.synchronize()
    want = att.flash_prefill_plain(q, k, v)
    torch.testing.assert_close(got, want, **F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [((1, 4, 1024, 80), torch.bfloat16),
                                         ((1, 4, 1000, 128), torch.bfloat16),
                                         ((1, 4, 1088, 128), torch.bfloat16),
                                         ((1, 4, 1024, 128), torch.int8)])
def test_cuda_flash_prefill_unsupported_raises(shape, dtype):
    # a CUDA tensor the kernel does not take raises; nothing falls back
    _need_gpu()
    from mlc_llm_tpu_torch.ops import attention as att

    x = torch.zeros(shape, dtype=dtype, device="cuda")
    before = att.flash_prefill.launches
    with pytest.raises(NotImplementedError):
        att.flash_prefill(x, x, x)
    assert att.flash_prefill.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("D,dtype", [(128, torch.bfloat16), (256, torch.float16)])
def test_cuda_flash_prefill_graph_replay_matches_eager(D, dtype):
    # the tensor maps are encoded at capture and replayed by value: new
    # inputs copied into the captured buffers give the eager result bit for
    # bit
    _need_gpu()
    from mlc_llm_tpu_torch.ops import attention as att

    B, Hq, Hkv, S = 1, 8, 4, 1024
    q, k, v = _flash_inputs(B, Hq, Hkv, S, D, dtype, strided=True)
    att.flash_prefill(q, k, v)  # first use: build, load, driver entry point
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = att.flash_prefill(q, k, v)
    for seed in (1, 2):
        nq, nk, nv = _flash_inputs(B, Hq, Hkv, S, D, dtype, strided=True, seed=seed)
        for dst, src in ((q, nq), (k, nk), (v, nv)):
            dst.copy_(src)
        before = att.flash_prefill.launches
        graph.replay()
        want = att.flash_prefill(nq, nk, nv)
        torch.cuda.synchronize()
        assert att.flash_prefill.launches == before + 1  # the eager call's
        assert torch.equal(out, want)
        torch.testing.assert_close(out.float(), att.flash_prefill_plain(nq, nk, nv).float(),
                                   **TOL)


@pytest.mark.cuda
def test_cuda_flash_reset_and_append_replay_their_own_graphs():
    # a reset prefill at bucket 2048 replays a graph with kernel 8 once a
    # layer; the same bucket and window from position 0 without the flag
    # (an append on an empty slot) replays another graph, through attend;
    # both agree with the plain forward on the CPU at the card's tolerance
    _need_gpu()
    from mlc_llm_tpu_torch.engine import InferenceEngine
    from mlc_llm_tpu_torch.models import get_config, init_random_params
    from mlc_llm_tpu_torch.ops import attention as att

    cfg = get_config("tiny-llama").replace(hidden_size=256, intermediate_size=512, num_heads=2,
                                           num_kv_heads=2, max_seq_len=2048)
    params = init_random_params(cfg, "bf16", seed=0, device="cuda")
    eng = InferenceEngine(cfg, params, max_batch=1, device="cuda")
    prompt = [int(t) for t in torch.randint(3, 256, (1100,), generator=torch.Generator()
                                            .manual_seed(0))]
    before = att.flash_prefill.launches
    flash = eng.prefill([prompt])
    assert att.flash_prefill.launches == before + cfg.num_layers
    eng.reset()
    plain = eng.prefill([prompt], reset=False)
    assert att.flash_prefill.launches == before + cfg.num_layers
    assert eng.programs.keys == {("prefill", 1, 2048, 2048, True),
                                 ("prefill", 1, 2048, 2048, False)}
    assert eng.programs.count == 2
    cpu = InferenceEngine(cfg, params, max_batch=1, device="cpu")
    want = cpu.prefill([prompt])
    for got in (flash, plain):
        torch.testing.assert_close(got.cpu(), want, atol=5e-2, rtol=5e-2)


# ----------------------------------------------------- tools and host runtime

@pytest.mark.cuda
def test_cuda_pinned_load_is_bit_equal(vicuna2, tmp_path, monkeypatch):
    # load_params on the card reads through the pinned ring; a ring of
    # 1 MB buffers makes every large leaf cross several fills
    from mlc_llm_tpu_torch.utils import checkpoint

    cfg, params = vicuna2
    ck = str(tmp_path / "ck")
    checkpoint.save_params(params, ck, meta={"model": cfg.name})
    for stage in (checkpoint.STAGE_BYTES, 1 << 20):
        monkeypatch.setattr(checkpoint, "STAGE_BYTES", stage)
        loaded, _ = checkpoint.load_params(ck, device="cuda")
        flat_a, flat_b = _leaves(params), _leaves(loaded)
        assert flat_a.keys() == flat_b.keys()
        for k in flat_a:
            assert flat_b[k].is_cuda and torch.equal(flat_a[k], flat_b[k]), (stage, k)


def _leaves(tree, prefix=""):
    from mlc_llm_tpu_torch.quant import QuantizedTensor

    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        elif isinstance(v, QuantizedTensor):
            out.update({f"{prefix}{k}/{f}": t for f, t in
                        (("data", v.data), ("scale", v.scale), ("zero", v.zero)) if t is not None})
        else:
            out[prefix + k] = v
    return out


@pytest.mark.cuda
def test_cuda_reinject_gemv_qs(vicuna2, tmp_path):
    # an unchanged copy of csrc/dequant_gemv_qs.cu gives the decode
    # program's own logits bit for bit; a copy whose group sums are offset
    # gives others; the built library is back after each call
    import os

    from mlc_llm_tpu_torch import ops
    from mlc_llm_tpu_torch.debug import dump
    from mlc_llm_tpu_torch.engine import InferenceEngine

    cfg, params = vicuna2
    eng = InferenceEngine(cfg, params, max_batch=1, max_seq_len=256, device="cuda")
    name = next(n for n in dump.engine_program_keys(eng, 16) if n.startswith("decode_w"))
    src = open(os.path.join(ops.CSRC, "dequant_gemv_qs.cu")).read()
    edit = "const float base = asym ? 16.f : 23.f;"
    assert src.count(edit) == 1
    same, edited = tmp_path / "same.cu", tmp_path / "edited.cu"
    same.write_text(src)
    edited.write_text(src.replace(edit, "const float base = asym ? 17.f : 23.f;"))
    launches = dm.gemv_qs.launches
    want = dump.run_engine_program(eng, name, 16)[0]
    got = dump.reinject_engine_program(eng, name, "gemv_qs", str(same), 16)[0]
    assert torch.equal(got, want)
    other = dump.reinject_engine_program(eng, name, "dequant_gemv_qs", str(edited), 16)[0]
    assert torch.isfinite(other).all() and not torch.equal(other, want)
    assert torch.equal(dump.run_engine_program(eng, name, 16)[0], want)
    assert dm.gemv_qs.launches == launches and "dequant_gemv_qs" not in ops._INJECTED


@pytest.mark.cuda
def test_cuda_dump_names_every_counted_kernel(vicuna2, tmp_path):
    import os
    import re

    from mlc_llm_tpu_torch.debug import dump
    from mlc_llm_tpu_torch.engine import InferenceEngine

    cfg, params = vicuna2
    eng = InferenceEngine(cfg, params, max_batch=1, max_seq_len=256, device="cuda")
    written = dump.dump_engine_programs(eng, str(tmp_path), prefill_bucket=16)
    assert all(os.path.getsize(os.path.join(tmp_path, w)) > 100 for w in written)
    for name in dump.engine_program_keys(eng, 16):
        assert {f"{name}.ops.txt", f"{name}.kernels.txt", f"{name}.graph.dot"} <= set(written)
        text = open(os.path.join(tmp_path, f"{name}.kernels.txt")).read()
        for wrapper, src, counter, main in re.findall(
                r"launches (\w+) (\w+) counter=(\d+) main_kernels=(\d+)", text):
            assert counter == main and int(counter) > 0, (name, wrapper)
            assert f"{src}.sass" in written and f"{src}.ptx" in written
    # the b1 decode's m = 1 GEMVs, the 16-token prefill's GEMMs
    assert {"dequant_gemv_qs.sass", "dequant_gemm_qs.sass"} <= set(written)


# ------------------------------------------------- tensor parallelism, tp = 2
# Vicuna-7B's rank-local weights at tp = 2 (parallel/sharding.py): q4bf16
# repacked to the pair order, so every sharded matmul runs the pair bf16
# bodies: wqkv, wo, w_in ([gate_r | up_r], stored 11264), w_out (172 groups,
# padded to 192) and the lm head (16000 columns, stored 16384)
TP2_SHAPES = [(4096, 6144), (2048, 4096), (4096, 11008), (5504, 4096), (4096, 16000)]


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 128, 2048])
@pytest.mark.parametrize("k,n", TP2_SHAPES)
def test_cuda_pair_bf16_at_tp2_shard_shapes(k, n, m):
    _need_gpu()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    qt = pad_quantized_groups(quantize(torch.randn((k, n), generator=g, device="cuda") * 0.02,
                                       QUANT_PRESETS["q4bf16_pair"]))
    K = qt.data.shape[0] * 8
    x = torch.zeros((m, K), dtype=torch.bfloat16, device="cuda")
    x[:, :k] = (torch.randn((m, k), generator=g, device="cuda") * 0.5).to(torch.bfloat16)
    assert dm.route(qt.spec, qt.n_groups, m) == ("gemv_gp" if m <= 8 else "gemm_pairs")
    fn, plain = (dm.gemv_gp, dm.gemv_gp_plain) if m <= 8 else (dm.gemm_pairs,
                                                               dm.gemm_pairs_plain)
    before = fn.launches
    got = fn(x, qt.data, qt.scale, qt.zero, "pair", out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(x, qt.data, qt.scale, qt.zero, "pair", torch.bfloat16)
    torch.testing.assert_close(got.float(), want.float(), **TOL)


@pytest.mark.cuda
def test_cuda_tp2_gloo_forward_matches_unsharded(tmp_path):
    """Two gloo ranks on the one card (tests/torch_tp_worker.py, case
    tp2_q4bf16: the widened tiny llama, q4bf16 repacked to pair): each
    rank's logits of a prefill and two decode steps against the unsharded
    forward's on the card, at the CPU tests' 2e-2."""
    _need_gpu()
    import os
    import socket
    import subprocess
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_tp_worker as w

    from mlc_llm_tpu_torch.models import init_random_params

    model, quant, _, kind = w.CASES["tp2_q4bf16"]
    cfg = w.config(model)
    params = init_random_params(cfg, quant, seed=1, device="cpu")
    torch.save(params, tmp_path / f"{model}-{quant}.pt")
    s = socket.socket()
    s.bind(("localhost", 0))
    port = str(s.getsockname()[1])
    s.close()
    procs = [subprocess.Popen([sys.executable, w.__file__, "2", str(r), port, str(tmp_path),
                               "cuda", "tp2_q4bf16"], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), "\n---\n".join(logs)
    ref = w.run_forward(w.to_device(params, "cuda"), cfg,
                        w.make_cache(cfg, kind, quant, 2, "cuda"), [0, 1])
    for r in range(2):
        got = torch.load(tmp_path / f"tp2_q4bf16.{r}.pt", weights_only=False)
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, atol=2e-2, rtol=2e-2)


# ------------------------------------------------- kernel 9: residual + norm

NORM_HIDDEN = (2560, 4096, 5120, 6144, 8192)  # every preset's hidden size
NORM_DTYPES = (torch.bfloat16, torch.float16, torch.float32)


def _norm_site(R, H, dtype, kind, nterms, nnorms, biased, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape, center=0.0, std=1.0):
        return (center + std * torch.randn(shape, generator=g, device="cuda")).to(dtype)

    h = rand(R, H)
    terms = [rand(R, H) for _ in range(nterms)]
    biases = [rand(H, std=0.1) if biased else None for _ in range(nterms)]
    norms = [(rand(H, center=1.0, std=0.1), rand(H, std=0.1) if kind == "layernorm" else None)
             for _ in range(nnorms)]
    return h, terms, biases, norms


def _within_one_ulp(got, want):
    # 16-bit outputs: the same value or a neighbour (the kernel's f32 sums
    # run in another order, so a value next to a rounding boundary may
    # round the other way); f32 outputs carry that order's difference
    # unrounded: a few f32 ulps of the row's scale
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))
        return
    bits = (got.view(torch.int16).int() - want.view(torch.int16).int()).abs()
    near_zero = (got.float() - want.float()).abs() <= 1e-6
    assert bool(((bits <= 1) | near_zero).all()), \
        f"max bit distance {int(bits.max())}, max diff {(got.float() - want.float()).abs().max()}"


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 8, 2048])
@pytest.mark.parametrize("H", NORM_HIDDEN)
@pytest.mark.parametrize("dtype", NORM_DTYPES, ids=["bf16", "f16", "f32"])
@pytest.mark.parametrize("kind,nterms,nnorms,biased", [
    ("layernorm", 2, 2, True),     # a parallel-residual layer's end: dolly, NeoX
    ("layernorm", 2, 1, True),     # MOSS: one norm for both branches, b_out only
    ("rmsnorm", 1, 1, False),      # Llama's sequential sites
    ("layernorm", 0, 2, False),    # layer 0's entry: the embedding's norms
], ids=["ln-2t-2n", "ln-2t-1n", "rms-1t-1n", "ln-0t-2n"])
def test_cuda_residual_norm_matches_plain(R, H, dtype, kind, nterms, nnorms, biased):
    _need_gpu()
    from mlc_llm_tpu_torch.ops import norm

    assert norm.residual_norm_supported(H, dtype)
    h, terms, biases, norms = _norm_site(R, H, dtype, kind, nterms, nnorms, biased)
    clamp = 55504.0 if dtype == torch.float16 and nterms else None
    before = norm.residual_norm.launches
    got_h, got = norm.residual_norm(h, terms, biases, norms, 1e-5, kind, clamp)
    torch.cuda.synchronize()
    assert norm.residual_norm.launches == before + 1
    want_h, want = norm.residual_norm_plain(h, terms, biases, norms, 1e-5, kind, clamp)
    assert torch.equal(got_h, want_h)  # the adds and the clamp round as the chain does
    assert len(got) == nnorms
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == h.shape
        _within_one_ulp(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 8, 2048])
def test_cuda_residual_norm_clamps_f16(R):
    # f16 rows near 65504: the sum overflows or passes the bound and is
    # clamped to +-55504 as torch.clamp rounds it (55488), bit for bit
    _need_gpu()
    from mlc_llm_tpu_torch.ops import norm

    h, terms, biases, norms = _norm_site(R, 2560, torch.float16, "layernorm", 2, 2, True, seed=3)
    g = torch.Generator(device="cuda").manual_seed(4)
    # finite rows of +-40000: h + t1 passes 55504 or overflows to inf
    h, *terms = ((torch.rand((R, 2560), generator=g, device="cuda") * 2 - 1) * 40000.0
                 for _ in range(3))
    h, terms = h.half(), [t.half() for t in terms]
    got_h, got = norm.residual_norm(h, terms, biases, norms, 1e-5, "layernorm", 55504.0)
    want_h, want = norm.residual_norm_plain(h, terms, biases, norms, 1e-5, "layernorm", 55504.0)
    torch.cuda.synchronize()
    assert float(want_h.abs().max()) == 55488.0
    assert torch.equal(got_h, want_h)
    for a, b in zip(got, want):
        _within_one_ulp(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", NORM_DTYPES, ids=["bf16", "f16", "f32"])
def test_cuda_residual_norm_graph_replay_counts_launches(dtype):
    # captured in a step program: a replay adds its one launch to the
    # counter and gives the eager result bit for bit on new inputs
    _need_gpu()
    from mlc_llm_tpu_torch.engine.programs import StepPrograms
    from mlc_llm_tpu_torch.ops import norm

    h, terms, biases, norms = _norm_site(8, 2560, dtype, "layernorm", 2, 2, True)
    progs = StepPrograms(torch.device("cuda"))

    def fn():
        h2, outs = norm.residual_norm(h, terms, biases, norms, 1e-5, "layernorm")
        return (h2, *outs)

    before = norm.residual_norm.launches
    progs.run("site", fn, fn)
    assert norm.residual_norm.launches == before + 1  # the replay's; capture's taken out
    for seed in (1, 2):
        nh, nterms, _, _ = _norm_site(8, 2560, dtype, "layernorm", 2, 2, True, seed=seed)
        h.copy_(nh)
        for dst, src in zip(terms, nterms):
            dst.copy_(src)
        before = norm.residual_norm.launches
        out = progs.run("site", fn, fn)
        want = fn()
        torch.cuda.synchronize()
        assert norm.residual_norm.launches == before + 2  # the replay's and the eager call's
        assert all(torch.equal(a, b) for a, b in zip(out, want))
    assert progs.count == 1 and progs.replays == 3


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["width", "param-dtype", "kind"])
def test_cuda_residual_norm_refused_raises(case):
    # a CUDA site the kernel does not take raises; nothing falls back
    _need_gpu()
    from mlc_llm_tpu_torch.ops import norm

    H = 2564 if case == "width" else 2560
    assert norm.residual_norm_supported(H, torch.bfloat16) == (case != "width")
    h, terms, biases, norms = _norm_site(8, H, torch.bfloat16, "layernorm", 1, 1, True)
    kind = "layernorm"
    if case == "param-dtype":
        norms = [(w.float(), b) for w, b in norms]
    if case == "kind":
        kind = "groupnorm"
    before = norm.residual_norm.launches
    with pytest.raises(ValueError if case == "kind" else NotImplementedError):
        norm.residual_norm(h, terms, biases, norms, 1e-5, kind)
    assert norm.residual_norm.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("model,quant,batch", [("dolly-v2-3b", "q4f16_hs", 8),
                                               ("moss-moon-003-sft", "q4bf16", 1)])
def test_cuda_decode_graph_runs_one_residual_norm_a_site(model, quant, batch):
    # a decode forward replays L + 1 norm sites (33 at dolly's 32 layers,
    # 35 at MOSS's 34), and its eager program has no aten.mean of a norm
    _need_gpu()
    from mlc_llm_tpu_torch.debug import dump
    from mlc_llm_tpu_torch.engine import GenerationConfig, InferenceEngine
    from mlc_llm_tpu_torch.models import get_config, init_random_params
    from mlc_llm_tpu_torch.ops import norm

    cfg = get_config(model).replace(num_layers=GRAPH_LAYERS)
    params = init_random_params(cfg, quant, seed=0, device="cuda")
    kw = dict(kv_layout="paged", page_size=128) if batch > 1 else {}
    eng = InferenceEngine(cfg, params, max_batch=batch, max_seq_len=2048, device="cuda", **kw)
    eng.cfg = cfg.replace(stop_tokens=())
    prompts = [list(range(5, 5 + 40 + 7 * i)) for i in range(batch)]
    gen = GenerationConfig(max_new_tokens=6, temperature=0.0)
    eng.generate(prompts, gen)  # captures every program this path runs
    f0, n0 = eng.decode_forwards, norm.residual_norm.launches
    eng.generate(prompts, gen)
    torch.cuda.synchronize()
    forwards = eng.decode_forwards - f0
    # the prefill's sites once, then L + 1 a decode forward
    assert forwards == 5
    assert norm.residual_norm.launches - n0 == (cfg.num_layers + 1) * (forwards + 1)
    key = next(k for k in eng.programs.keys if k[0] == "decode")
    with dump._on_cache_copy(eng, [key]):
        with dump._OpLog() as log:
            dump._program(eng, key)(*dump._zero_args(eng, key))
    torch.cuda.synchronize()
    assert log.lines and not [ln for ln in log.lines if ln.startswith("aten.mean")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", NORM_DTYPES, ids=["bf16", "f16", "f32"])
def test_cuda_residual_norm_reads_strided_rows(dtype):
    # h and the terms as column slices of wider buffers (a matmul's padded
    # output): the kernel reads each at its row stride
    _need_gpu()
    from mlc_llm_tpu_torch.ops import norm

    h, terms, biases, norms = _norm_site(8, 2560, dtype, "layernorm", 2, 2, True)
    wide = [torch.zeros((8, 2688), dtype=dtype, device="cuda") for _ in range(3)]
    for w, t in zip(wide, (h, *terms)):
        w[:, :2560] = t
    sh, *sterms = (w[:, :2560] for w in wide)
    assert norm.row_stride(sh) == 2688 and not sh.is_contiguous()
    got_h, got = norm.residual_norm(sh, sterms, biases, norms, 1e-5, "layernorm")
    want_h, want = norm.residual_norm_plain(h, terms, biases, norms, 1e-5, "layernorm")
    torch.cuda.synchronize()
    assert got_h.is_contiguous() and torch.equal(got_h, want_h)
    for a, b in zip(got, want):
        _within_one_ulp(a, b)
