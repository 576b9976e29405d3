"""The int4 kernels' plain versions in every bit order and compute dtype
against the JAX Pallas kernels.

Presets: q4bf16_pair, q4bf16_hs, q4bf16_sym (pair order, sym), q4f32
(pair, f32 compute), q4f16_hs (hsplit, f16) and q4f16 (qsplit, f16). On
the CPU the JAX dispatchers (dequant_matmul, dequant_matmul_stacked) run
their Pallas kernels in interpret mode, as tests/test_pallas_kernels.py
runs them; the port's dequant_matmul runs gemv_gp_plain / gemv_qs_plain
at m <= 8 and gemm_pairs_plain / gemm_qs_plain above, on CPU tensors,
where no kernel launches.

Tolerances: 1e-2 (atol and rtol) in bf16 and f16, the one of
tests/test_torch_kernels.py, since the sums run in another order and a
rounded group sum or weight can fall the other way; atol 1e-4 and rtol
1e-3 in f32, where nothing rounds but the f32 sums (the JAX suite holds
q4f32 at 1e-4, tests/test_pallas_kernels.py:61). The plain versions
round where the TPU bodies' jnp ops round; XLA's CPU fusion, which runs
interpret mode, skips two of those roundings (it adds the pair GEMV's two
rounded half sums in f32, and rounds an f16 q*s + z once), which moves
outputs of magnitude ~0.6 by up to 2e-3.

The CUDA kernels are held against these plain versions in
tests/test_torch_cuda.py, which needs a GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlc_llm_tpu.ops.pallas.dequant_matmul import dequant_matmul as jdm
from mlc_llm_tpu.ops.pallas.dequant_matmul import dequant_matmul_stacked as jdms
from mlc_llm_tpu.quant import quantize as jquantize
from mlc_llm_tpu.quant.groupwise import pad_quantized_groups as jpad
from mlc_llm_tpu_torch.models.convert import params_from_jax, tensor_from_numpy
from mlc_llm_tpu_torch.ops import dequant_matmul as dm

torch.set_num_threads(2)

K, N = 1024, 384  # 32 groups: every order's kernel blocks them
PRESETS = ["q4bf16_pair", "q4bf16_hs", "q4bf16_sym", "q4f32", "q4f16_hs", "q4f16"]
TOL = {"float32": dict(atol=1e-4, rtol=1e-3)}
LOW_TOL = dict(atol=1e-2, rtol=1e-2)
WRAPPERS = (dm.gemv_qs, dm.gemv_gp, dm.gemm_qs, dm.gemm_pairs, dm.gemv_gp3, dm.gemm_plane)


@pytest.fixture(scope="module", params=PRESETS)
def weights(request):
    rng = np.random.default_rng(1)
    qts = [jpad(jquantize((rng.standard_normal((K, N)) * 0.05).astype(np.float32),
                          request.param)) for _ in range(3)]
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs, 0), *qts)
    return (request.param, qts[1], stacked,
            params_from_jax(jax.tree.map(np.asarray, qts[1])),
            params_from_jax(jax.tree.map(np.asarray, stacked)))


def _x(m, spec, seed):
    x = jnp.asarray(np.random.default_rng(seed).standard_normal((m, K)) * 0.1,
                    jnp.dtype(spec.dtype))
    return x, tensor_from_numpy(np.asarray(x))


def _check(weights, m, stacked):
    preset, jflat, jst, tflat, tst = weights
    xj, xt = _x(m, tflat.spec, seed=m)
    if stacked:
        want = jdms(xj, jst, jnp.int32(1))
        got = dm.dequant_matmul(xt, tst, layer=1)
        assert got.dtype == xt.dtype
    else:
        # the lm head's form: flat weights, f32 out
        want = jdm(xj, jflat, out_dtype=jnp.float32)
        got = dm.dequant_matmul(xt, tflat, out_dtype=torch.float32)
    assert all(fn.launches == 0 for fn in WRAPPERS)  # CPU tensors never launch
    tol = TOL.get(tflat.spec.dtype, LOW_TOL)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("m", [1, 2, 8])
@pytest.mark.parametrize("stacked", [False, True], ids=["flat", "stacked"])
def test_gemv_plain_matches_pallas_gp(weights, m, stacked):
    assert dm.route(weights[3].spec, 32, m) in ("gemv_gp", "gemv_qs")
    _check(weights, m, stacked)


@pytest.mark.parametrize("m", [16, 64])
@pytest.mark.parametrize("stacked", [False, True], ids=["flat", "stacked"])
def test_gemm_plain_matches_pallas_pairs(weights, m, stacked):
    assert dm.route(weights[3].spec, 32, m) in ("gemm_pairs", "gemm_qs")
    _check(weights, m, stacked)
