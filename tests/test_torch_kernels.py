"""The qsplit dequant kernels' plain versions against the JAX Pallas
kernels, and the CUDA kernels against their plain versions.

On the CPU the JAX functions run their Pallas kernels in interpret mode
(as tests/test_pallas_kernels.py runs them), and the port's wrappers run
their plain PyTorch versions: the group-partial GEMV at m <= 8 and the
pairs GEMM above. Tolerance 1e-2 (atol and rtol), the JAX suite's own
for these kernels: the sums run in another order.

The CUDA kernels themselves are held against these plain versions in
tests/test_torch_cuda.py, which needs a GPU.
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
from mlc_llm_tpu_torch.ops import resolve_device
from mlc_llm_tpu_torch.ops.matmul import qmatmul
from mlc_llm_tpu_torch.quant import dequantize, quantize

torch.set_num_threads(2)

TOL = dict(atol=1e-2, rtol=1e-2)
K, N = 1024, 384


def _spec(sym):
    base = JPRESETS["q4bf16_sym" if sym else "q4bf16"]
    return dataclasses.replace(base, layout="qsplit")


@pytest.fixture(scope="module", params=[False, True], ids=["asym", "sym"])
def weights(request):
    rng = np.random.default_rng(1)
    qts = [jpad(jquantize((rng.standard_normal((K, N)) * 0.05).astype(np.float32),
                          _spec(request.param))) for _ in range(3)]
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs, 0), *qts)
    return (qts[1], stacked,
            params_from_jax(jax.tree.map(np.asarray, qts[1])),
            params_from_jax(jax.tree.map(np.asarray, stacked)))


def _x(m, seed):
    x = jnp.asarray(np.random.default_rng(seed).standard_normal((m, K)) * 0.1, jnp.bfloat16)
    return x, tensor_from_numpy(np.asarray(x))


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL)


@pytest.mark.parametrize("m", [1, 2, 8])
@pytest.mark.parametrize("stacked", [False, True], ids=["flat", "stacked"])
def test_gemv_plain_matches_pallas_gp(weights, m, stacked):
    jflat, jst, tflat, tst = weights
    xj, xt = _x(m, seed=m)
    if stacked:
        want = jdms(xj, jst, jnp.int32(1))
        got = dm.dequant_matmul(xt, tst, layer=1)
    else:
        # the lm head's form: flat weights, f32 out
        want = jdm(xj, jflat, out_dtype=jnp.float32)
        got = dm.dequant_matmul(xt, tflat, out_dtype=torch.float32)
    assert dm.gemv_qs.launches == 0  # CPU tensors never launch
    _close(got, want)


@pytest.mark.parametrize("m", [16, 64])
@pytest.mark.parametrize("stacked", [False, True], ids=["flat", "stacked"])
def test_gemm_plain_matches_pallas_pairs(weights, m, stacked):
    jflat, jst, tflat, tst = weights
    xj, xt = _x(m, seed=m)
    if stacked:
        want = jdms(xj, jst, jnp.int32(1))
        got = dm.dequant_matmul(xt, tst, layer=1)
    else:
        want = jdm(xj, jflat)
        got = dm.dequant_matmul(xt, tflat)
    assert dm.gemm_qs.launches == 0
    _close(got, want)


def test_unpadded_k_is_zero_padded():
    # k=3960 is stored as 124 groups (k 3968): x is zero-padded to it
    w = (np.random.default_rng(0).standard_normal((3960, 256)) * 0.05).astype(np.float32)
    qt = quantize(torch.from_numpy(w), "q4bf16")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 3960)) * 0.1).to(torch.bfloat16)
    want = torch.matmul(x.float(), dequantize(qt, torch.bfloat16).float())
    torch.testing.assert_close(dm.dequant_matmul(x, qt, out_dtype=torch.float32), want, **TOL)


def test_formats_without_a_kernel_raise_not_fall_back(monkeypatch):
    # every int4 order has a kernel now: an hsplit weight (16 groups, the
    # hsplit GEMV's blockable count) takes gemv_gp's plain version on the
    # CPU and equals the JAX kernel; nothing falls back to dequantizing
    rng = np.random.default_rng(0)
    jq = jquantize((rng.standard_normal((512, 128)) * 0.05).astype(np.float32), "q4bf16_hs")
    hs = params_from_jax(jax.tree.map(np.asarray, jq))
    assert dm.route(hs.spec, hs.n_groups, 1) == "gemv_gp"

    def no_dense(*a, **k):
        raise AssertionError("fell back to dense_matmul")

    monkeypatch.setattr(dm, "dense_matmul", no_dense)
    xj = jnp.asarray(rng.standard_normal((1, 512)) * 0.1, jnp.bfloat16)
    want = jdm(xj, jq, out_dtype=jnp.float32)
    got = qmatmul(tensor_from_numpy(np.asarray(xj)), hs, out_dtype=torch.float32)
    assert dm.gemv_gp.launches == 0
    _close(got, want)


def test_cuda_request_without_gpu_raises():
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")
