"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc (a CUDA kernel has no
interpret mode) and skips without one. This file imports only torch and
the port, so it runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import dataclasses

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
