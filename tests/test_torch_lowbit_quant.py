"""The port's int3, fp4 and int8 quantizer against the JAX quantizer.

Same fp32 weights in: the packed words (u32 as int32 bits, u16 as int16
bits), the int8 planes, the scales and the fp4 codes must be
bit-identical, before and after the 32-group padding, flat and
layer-stacked; dequantize and the embedding gather must match exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlc_llm_tpu.quant import dequantize as jdequantize
from mlc_llm_tpu.quant import quantize as jquantize
from mlc_llm_tpu.quant import take_dequantize as jtake
from mlc_llm_tpu.quant.groupwise import _f32_to_f4 as j_f32_to_f4
from mlc_llm_tpu.quant.groupwise import pad_quantized_groups as jpad
from mlc_llm_tpu_torch.models.convert import params_from_jax, tensor_from_numpy
from mlc_llm_tpu_torch.quant import dequantize, pad_quantized_groups, quantize, take_dequantize
from mlc_llm_tpu_torch.quant.groupwise import _f32_to_f4

torch.set_num_threads(2)

PRESETS = ["q3bf16", "q3bf16_s16", "fp4bf16", "q8bf16"]
WORD_DTYPES = {"q3bf16": torch.int32, "q3bf16_s16": torch.int16, "fp4bf16": torch.int32,
               "q8bf16": torch.int8}


def _w(k, n, seed):
    return (np.random.default_rng(seed).standard_normal((k, n)) * 0.05).astype(np.float32)


def _same(jax_qt, port_qt):
    conv = params_from_jax(jax.tree.map(np.asarray, jax_qt))
    assert conv.data.dtype == port_qt.data.dtype
    assert torch.equal(conv.data, port_qt.data)
    assert torch.equal(conv.scale, port_qt.scale)
    assert (conv.zero is None) == (port_qt.zero is None)
    assert conv.shape == port_qt.shape and conv.spec == port_qt.spec


@pytest.mark.parametrize("preset", PRESETS)
def test_quantize_bit_identical(preset):
    # k=250: a ragged last group (40 and 32 do not divide it); n=200:
    # lane-padded columns
    w = _w(250, 200, seed=0)
    tq = quantize(torch.from_numpy(w), preset)
    assert tq.data.dtype == WORD_DTYPES[preset]
    _same(jquantize(w, preset), tq)


@pytest.mark.parametrize("preset", PRESETS)
def test_pad_quantized_groups_matches(preset):
    # 7-8 groups -> 32 (i8 planes stay as they are, as in JAX)
    w = _w(300, 128, seed=2)
    jq = jquantize(w, preset)
    tq = quantize(torch.from_numpy(w), preset)
    _same(jpad(jq), pad_quantized_groups(tq))
    # layer-stacked [L, KW, N] leaves
    jst = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), jq, jq)
    tst = params_from_jax(jax.tree.map(np.asarray, jst))
    _same(jpad(jst), pad_quantized_groups(tst))


@pytest.mark.parametrize("preset", PRESETS)
def test_dequantize_matches(preset):
    w = _w(250, 384, seed=1)
    jq = jquantize(w, preset)
    tq = quantize(torch.from_numpy(w), preset)
    for jqt, tqt in ((jq, tq), (jpad(jq), pad_quantized_groups(tq))):
        want = tensor_from_numpy(np.asarray(jdequantize(jqt, "bfloat16")))
        assert torch.equal(dequantize(tqt, "bfloat16"), want)
        want32 = tensor_from_numpy(np.asarray(jdequantize(jqt, "float32")))
        assert torch.equal(dequantize(tqt, "float32"), want32)


@pytest.mark.parametrize("preset", PRESETS)
def test_take_dequantize_matches(preset):
    w = _w(120, 256, seed=3)  # [hidden, vocab] embedding layout
    idx = np.array([[5, 0, 255], [17, 17, 3]], np.int32)
    want = jtake(jpad(jquantize(w, preset)), jnp.asarray(idx))
    got = take_dequantize(pad_quantized_groups(quantize(torch.from_numpy(w), preset)),
                          torch.from_numpy(idx).long())
    assert got.shape == (2, 3, 120)
    assert torch.equal(got, tensor_from_numpy(np.asarray(want)))


def test_fp4_codes_bit_identical_at_the_edges():
    # zeros of both signs, the rounding boundary of the exponent (the
    # mantissa MSB rounds up), the 2^-7 floor (e_f32 == 120), below it,
    # and the clamp at 2^0 and above
    vals = np.array([0.0, -0.0, 1.0, -1.0, 0.75, 0.7499, 1.5, 2.0, 1e3, -1e3,
                     2.0**-7, 2.0**-8, 1.5 * 2.0**-8, 2.0**-9, -2.0**-7, 0.375, 0.3751,
                     3.0 * 2.0**-7, np.nextafter(np.float32(2.0**-7), 0)], np.float32)
    vals = np.concatenate([vals, np.random.default_rng(4).standard_normal(200).astype(np.float32)])
    want = np.asarray(j_f32_to_f4(jnp.asarray(vals))).astype(np.int64)
    got = _f32_to_f4(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got, want)


def test_u16_words_convert_to_int16_bits():
    words = np.array([[0, 1, 0x7FFF, 0x8000, 0xFFFF]], np.uint16)
    t = tensor_from_numpy(words)
    assert t.dtype == torch.int16
    assert t.view(torch.uint16).numpy().tolist() == words.tolist()
