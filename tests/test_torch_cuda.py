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
from mlc_llm_tpu_torch.quant import QUANT_PRESETS, quantize

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
