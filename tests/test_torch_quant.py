"""The port's int4 quantizer against the JAX quantizer (the other formats:
tests/test_torch_lowbit_quant.py).

Same fp32 weights in, the packed words, scales and minima must be
bit-identical (u32 words compared as int32 bits), in all three word
orders and for sym; dequantize, the 32-group repack and the embedding
gather must match exactly too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlc_llm_tpu.quant import dequantize as jdequantize
from mlc_llm_tpu.quant import quantize as jquantize
from mlc_llm_tpu.quant import take_dequantize as jtake
from mlc_llm_tpu.quant.groupwise import pad_quantized_groups as jpad
from mlc_llm_tpu.quant.spec import QUANT_PRESETS as JPRESETS
from mlc_llm_tpu_torch.models.convert import params_from_jax, tensor_from_numpy
from mlc_llm_tpu_torch.quant import (
    QUANT_PRESETS,
    QuantSpec,
    dequantize,
    pad_quantized_groups,
    quantize,
    resolve_spec,
    take_dequantize,
)

torch.set_num_threads(2)

# the default qsplit order, the two older orders, sym (pair order, the
# preset's own), sym in the qsplit order the GEMV kernel covers, and the
# f32 and f16 compute presets (f32 and f16 scales and minima)
PRESETS = ["q4bf16", "q4bf16_hs", "q4bf16_pair", "q4bf16_sym", "q4bf16_sym_qs",
           "q4f32", "q4f16", "q4f16_hs", "q4f16_pair"]


def _spec(name):
    if name == "q4bf16_sym_qs":
        return dataclasses.replace(resolve_spec("q4bf16_sym"), layout="qsplit")
    return resolve_spec(name)


def _jspec(name):
    if name == "q4bf16_sym_qs":
        return dataclasses.replace(JPRESETS["q4bf16_sym"], layout="qsplit")
    return JPRESETS[name]


def _w(k, n, seed):
    return (np.random.default_rng(seed).standard_normal((k, n)) * 0.05).astype(np.float32)


def _same(jax_qt, port_qt):
    conv = params_from_jax(jax.tree.map(np.asarray, jax_qt))
    assert torch.equal(conv.data, port_qt.data)
    assert torch.equal(conv.scale, port_qt.scale)
    assert (conv.zero is None) == (port_qt.zero is None)
    if conv.zero is not None:
        assert torch.equal(conv.zero, port_qt.zero)
    assert conv.shape == port_qt.shape and conv.spec == port_qt.spec


def test_presets_copied():
    assert {k: dataclasses.asdict(v) for k, v in QUANT_PRESETS.items()} == {
        k: dataclasses.asdict(v) for k, v in JPRESETS.items()}


@pytest.mark.parametrize("preset", PRESETS)
def test_quantize_bit_identical(preset):
    # k=384: 12 groups (split-able by 4), n=200: lane-padded columns
    w = _w(384, 200, seed=0)
    _same(jquantize(w, _jspec(preset)), quantize(torch.from_numpy(w), _spec(preset)))


@pytest.mark.parametrize("preset", PRESETS)
def test_dequantize_matches(preset):
    w = _w(256, 384, seed=1)
    qt = quantize(torch.from_numpy(w), _spec(preset))
    want = tensor_from_numpy(np.asarray(jdequantize(jquantize(w, _jspec(preset)), "bfloat16")))
    assert torch.equal(dequantize(qt, "bfloat16"), want)


@pytest.mark.parametrize("preset", PRESETS)
def test_pad_quantized_groups_matches(preset):
    # 12 groups -> 32: the split orders repack at the code level
    w = _w(384, 128, seed=2)
    jq = jquantize(w, _jspec(preset))
    tq = quantize(torch.from_numpy(w), _spec(preset))
    _same(jpad(jq), pad_quantized_groups(tq))
    # layer-stacked [L, KW, N] leaves pad layer by layer
    jst = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), jq, jq)
    tst = params_from_jax(jax.tree.map(np.asarray, jst))
    _same(jpad(jst), pad_quantized_groups(tst))


def test_take_dequantize_matches():
    w = _w(128, 256, seed=3)  # [hidden, vocab] embedding layout
    idx = np.array([[5, 0, 255], [17, 17, 3]], np.int32)
    want = jtake(jquantize(w, "q4bf16"), jnp.asarray(idx))
    got = take_dequantize(quantize(torch.from_numpy(w), "q4bf16"), torch.from_numpy(idx).long())
    assert got.shape == (2, 3, 128)
    assert torch.equal(got, tensor_from_numpy(np.asarray(want)))


def test_unported_format_raises():
    # every storage of the JAX package is ported (int3, fp4 and int8 in
    # tests/test_torch_lowbit_quant.py, u4 planes in tests/test_torch_u4.py):
    # a storage outside the spec's table still raises
    assert quantize(torch.zeros(64, 128), "q4bf16_plane").data.dtype == torch.uint8
    with pytest.raises(ValueError):
        quantize(torch.zeros(64, 128), QuantSpec("int4", 32, False, "u8", "bfloat16"))
