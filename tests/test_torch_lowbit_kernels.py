"""The int3 GEMV's and the plane GEMM's plain versions against the JAX
Pallas kernels, and the port's routing against the JAX dispatch.

On the CPU the JAX functions run their Pallas kernels in interpret mode
(as tests/test_pallas_kernels.py runs them): the gp3 kernel through the
dispatcher (dequant_matmul / dequant_matmul_stacked), the generic plane
kernels (_dequant_matmul_2d's generic branch, _dequant_matmul_stacked_
generic_2d) called directly, so that every format meets the plane kernel
at every m, m <= 2 included. The port's wrappers run their plain
versions on CPU tensors. Tolerance 1e-2 (atol and rtol), the one
tests/test_torch_kernels.py uses: the sums run in another order.

The CUDA kernels are held against these plain versions in
tests/test_torch_cuda.py, which needs a GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlc_llm_tpu.ops.matmul import prefill_kernel_max_m
from mlc_llm_tpu.ops.pallas.dequant_matmul import (
    _dequant_matmul_2d,
    _dequant_matmul_stacked_generic_2d,
    gp3_matmul_supported,
    gp_matmul_supported,
    split_groups_blockable,
)
from mlc_llm_tpu.ops.pallas.dequant_matmul import dequant_matmul as jdm
from mlc_llm_tpu.ops.pallas.dequant_matmul import dequant_matmul_stacked as jdms
from mlc_llm_tpu.quant import quantize as jquantize
from mlc_llm_tpu.quant.groupwise import pad_quantized_groups as jpad
from mlc_llm_tpu.quant.spec import QUANT_PRESETS as JPRESETS
from mlc_llm_tpu_torch.models.convert import params_from_jax, tensor_from_numpy
from mlc_llm_tpu_torch.ops import dequant_matmul as dm
from mlc_llm_tpu_torch.quant import QUANT_PRESETS

torch.set_num_threads(2)

TOL = dict(atol=1e-2, rtol=1e-2)
N = 384
# 16 groups each: the gp3 kernel's G % 16 == 0 holds for int3 in u16 words
K_OF = {"q3bf16": 640, "q3bf16_s16": 640, "fp4bf16": 512, "q8bf16": 512}
PLANE_PRESETS = list(K_OF)


def _stack3(preset, k):
    rng = np.random.default_rng(1)
    qts = [jquantize((rng.standard_normal((k, N)) * 0.05).astype(np.float32), preset)
           for _ in range(3)]
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs, 0), *qts)
    return qts, stacked, params_from_jax(jax.tree.map(np.asarray, stacked))


@pytest.fixture(scope="module", params=PLANE_PRESETS)
def weights(request):
    preset = request.param
    qts, jst, tst = _stack3(preset, K_OF[preset])
    return preset, qts, jst, tst


def _x(m, k, seed):
    x = jnp.asarray(np.random.default_rng(seed).standard_normal((m, k)) * 0.1, jnp.bfloat16)
    return x, tensor_from_numpy(np.asarray(x))


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL)


def _jax_route(spec, G, m):
    """The JAX dispatch's choice, from its own predicates (ops/matmul.py
    qmatmul, pallas/dequant_matmul.py dequant_matmul)."""
    if m > prefill_kernel_max_m() or spec.storage not in ("u32", "u16", "i8"):
        return "dense"
    if gp3_matmul_supported(spec, G, m):
        return "gemv_gp3"
    if gp_matmul_supported(spec, G, m):
        return "gemv_qs" if spec.layout == "qsplit" else "gemv_gp"
    if spec.layout in ("hsplit", "qsplit") and not split_groups_blockable(spec, G):
        return "dense"
    if spec.mode == "int4" and spec.storage == "u32":
        return "gemm_qs" if spec.layout == "qsplit" else "gemm_pairs"
    return "gemm_plane"


@pytest.mark.parametrize("preset", ["q4bf16", "q4bf16_hs", "q4bf16_pair", "q4bf16_sym",
                                    "q3bf16", "q3bf16_s16", "fp4bf16", "q8bf16",
                                    "q3f16", "q3f16_s16", "fp4f16", "q8f16"])
def test_route_matches_jax_dispatch(preset):
    groups = (1, 2, 4, 8, 12, 16, 24, 32, 48, 64, 96, 103, 128, 276, 288, 344, 352)
    ms = (1, 2, 3, 4, 7, 8, 9, 16, 128, 2048, 2049)
    for G in groups:
        for m in ms:
            want = _jax_route(JPRESETS[preset], G, m)
            assert dm.route(QUANT_PRESETS[preset], G, m) == want, (preset, G, m)


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("stacked", [False, True], ids=["flat", "stacked"])
def test_gemv_gp3_plain_matches_pallas_gp3(m, stacked):
    qts, jst, tst = _stack3("q3bf16_s16", 640)
    tflat = params_from_jax(jax.tree.map(np.asarray, qts[1]))
    assert dm.route(tflat.spec, tflat.n_groups, m) == "gemv_gp3"
    xj, xt = _x(m, 640, seed=m)
    if stacked:
        want = jdms(xj, jst, jnp.int32(1))
        got = dm.dequant_matmul(xt, tst, layer=1)
    else:
        # the lm head's form: flat weights, f32 out
        want = jdm(xj, qts[1], out_dtype=jnp.float32)
        got = dm.dequant_matmul(xt, tflat, out_dtype=torch.float32)
    assert dm.gemv_gp3.launches == 0  # CPU tensors never launch
    _close(got, want)


def _port_x(xt, w):
    """x zero-padded to the stored k, as dequant_matmul pads it."""
    rows = w.data.shape[-2]
    k_stored = rows if w.spec.storage == "i8" else rows * w.spec.elems_per_word
    return torch.nn.functional.pad(xt, (0, k_stored - xt.shape[1]))


@pytest.mark.parametrize("m", [1, 4, 8, 24])
def test_gemm_plane_plain_matches_pallas_generic(weights, m):
    preset, qts, _, _ = weights
    jq = qts[2]
    tq = params_from_jax(jax.tree.map(np.asarray, jq))
    xj, xt = _x(m, K_OF[preset], seed=10 + m)
    want = _dequant_matmul_2d(xj, jq.data, jq.scale, jq.zero, spec=jq.spec, shape=jq.shape,
                              out_dtype=jnp.float32, interpret=True)
    got = dm.gemm_plane(_port_x(xt, tq), tq.data, tq.scale, tq.zero, tq.spec,
                        out_dtype=torch.float32)
    assert dm.gemm_plane.launches == 0
    _close(got[:, :N], want)


@pytest.mark.parametrize("m", [1, 8])
def test_gemm_plane_plain_matches_pallas_stacked_generic(weights, m):
    preset, _, jst, tst = weights
    xj, xt = _x(m, K_OF[preset], seed=20 + m)
    want = _dequant_matmul_stacked_generic_2d(
        xj, jnp.asarray([1], jnp.int32), jst.data, jst.scale, jst.zero, spec=jst.spec,
        shape=jst.shape, out_dtype=jnp.bfloat16, interpret=True)
    got = dm.gemm_plane(_port_x(xt, tst), tst.data, tst.scale, tst.zero, tst.spec, layer=1)
    _close(got[:, :N], want)


def test_plane_routes_through_dequant_matmul(weights):
    # the router reaches gemm_plane for each plane format at m > 2 (and at
    # every m for the formats without a gp3 form), stacked and flat
    preset, _, jst, tst = weights
    xj, xt = _x(5, K_OF[preset], seed=3)
    assert dm.route(tst.spec, tst.n_groups, 5) == "gemm_plane"
    want = jdms(xj, jst, jnp.int32(2))
    _close(dm.dequant_matmul(xt, tst, layer=2), want)


@pytest.mark.parametrize("preset", ["q3bf16_s16", "q8bf16"])
def test_stacked_wrappers_read_layer_l(preset):
    # u16 words and int8 planes: layer l > 0 of a stacked weight is layer
    # l's result (the kernels' pointer offset), and _ptrs offsets each
    # tensor by its own element size
    qts, _, tst = _stack3(preset, K_OF[preset])
    _, xt = _x(2, K_OF[preset], seed=5)
    x = _port_x(xt, tst)
    for layer in (1, 2):
        flat = params_from_jax(jax.tree.map(np.asarray, qts[layer]))
        want = dm.gemm_plane_plain(x, flat.data, flat.scale, flat.zero, flat.spec, torch.bfloat16)
        got = dm.gemm_plane(x, tst.data, tst.scale, tst.zero, tst.spec, layer=layer)
        assert torch.equal(got, want)
        if preset == "q3bf16_s16":
            want = dm.gemv_gp3_plain(x, flat.data, flat.scale, torch.bfloat16)
            assert torch.equal(dm.gemv_gp3(x, tst.data, tst.scale, layer=layer), want)
        wp, sp, zp = dm._ptrs(tst.data, tst.scale, tst.zero, layer)
        assert (wp, sp, zp) == (tst.data[layer].data_ptr(), tst.scale[layer].data_ptr(), None)


def test_ptrs_offset_int32_words_and_minima():
    # asym int4 words (4-byte data, bf16 scales and minima)
    qts, _, tst = _stack3("q4bf16", 256)
    wp, sp, zp = dm._ptrs(tst.data, tst.scale, tst.zero, 2)
    assert (wp, sp, zp) == (tst.data[2].data_ptr(), tst.scale[2].data_ptr(),
                            tst.zero[2].data_ptr())


def test_unpadded_q3_group_count_routes_to_plane():
    # 103 groups (k=4096 before the engine pads): gp3 needs G % 16, so even
    # m=1 takes the plane kernel, as in JAX
    rng = np.random.default_rng(6)
    jq = jquantize((rng.standard_normal((4096, 128)) * 0.05).astype(np.float32), "q3bf16_s16")
    tq = params_from_jax(jax.tree.map(np.asarray, jq))
    assert tq.n_groups == 103 and dm.route(tq.spec, 103, 1) == "gemm_plane"
    assert dm.route(tq.spec, 128, 1) == "gemv_gp3"
    assert jpad(jq).scale.shape[0] == 128
