"""u4 plane storage (``q4bf16_plane``) in the port against the JAX package.

JAX stores the plane as ml_dtypes ``uint4`` [k_pad, n], one code a byte
on the host; the port stores the same bytes as uint8. Held here: the
quantizer's codes, scales and minima bit for bit, dequantize and nbytes
equal, checkpoints both ways (JAX's build -> the port's loader, the port's
build -> JAX's loader), tiny-llama's logits against JAX's within 5e-2 (the
u4 matmul dequantizes and multiplies on both sides; the port's CPU path
multiplies in f32, JAX's in bf16), the greedy tokens, and the CLI.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlc_llm_tpu import build as jbuild
from mlc_llm_tpu.models import forward as jforward
from mlc_llm_tpu.models import get_config as jget_config
from mlc_llm_tpu.models import init_kv_cache as jinit_kv
from mlc_llm_tpu.models import init_random_params as jinit
from mlc_llm_tpu.quant import dequantize as jdequantize
from mlc_llm_tpu.quant import quantize as jquantize
from mlc_llm_tpu.utils import checkpoint as jckpt
from mlc_llm_tpu_torch import build, cli
from mlc_llm_tpu_torch.models import forward, get_config, init_kv_cache, init_random_params
from mlc_llm_tpu_torch.models.convert import params_from_jax, tensor_from_numpy
from mlc_llm_tpu_torch.models.transformer import pad_params, param_bytes
from mlc_llm_tpu_torch.quant import QuantizedTensor, dequantize, pad_quantized_groups, quantize
from mlc_llm_tpu_torch.utils.checkpoint import load_params

torch.set_num_threads(2)
_jforward = jax.jit(jforward, static_argnames=("cfg",))


@pytest.mark.parametrize("k,n", [(64, 128), (100, 4100), (256, 96)])
def test_quantize_matches_jax_bit_for_bit(k, n):
    w = (np.random.default_rng(k + n).standard_normal((k, n)) * 0.05).astype(np.float32)
    jq = jquantize(w, "q4bf16_plane")
    tq = quantize(torch.from_numpy(w), "q4bf16_plane")
    assert np.asarray(jq.data).dtype.name == "uint4" and tq.data.dtype == torch.uint8
    assert tq.data.shape == jq.data.shape and tq.shape == jq.shape
    assert torch.equal(tq.data, tensor_from_numpy(np.asarray(jq.data)))
    assert torch.equal(tq.scale, tensor_from_numpy(np.asarray(jq.scale)))
    assert torch.equal(tq.zero, tensor_from_numpy(np.asarray(jq.zero)))
    assert torch.equal(dequantize(tq), tensor_from_numpy(np.asarray(jdequantize(jq))))
    assert tq.nbytes() == jq.nbytes()
    # planes are left as they are by group padding, as in JAX
    assert pad_quantized_groups(tq) is tq


def test_params_from_jax_and_param_bytes():
    cfg = jget_config("tiny-llama")
    jp = jinit(cfg, "q4bf16_plane", seed=0)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    w_in = tp["layers"]["w_in"]
    assert isinstance(w_in, QuantizedTensor) and w_in.data.dtype == torch.uint8
    assert torch.equal(w_in.data, torch.from_numpy(
        np.asarray(jp["layers"]["w_in"].data).view(np.uint8).copy()))
    assert param_bytes(tp) == sum(
        x.nbytes() if hasattr(x, "spec") else x.size * x.dtype.itemsize
        for x in jax.tree.leaves(jp, is_leaf=lambda x: hasattr(x, "spec")))


def test_jax_build_loads_in_the_port(tmp_path):
    jbuild.main(["--model", "tiny-llama", "--random", "--quantization", "q4bf16_plane",
                 "-o", str(tmp_path), "--platform", "cpu"])
    man = json.loads((tmp_path / "manifest.json").read_text())
    assert man["leaves"]["layers/wqkv/data"]["dtype"] == "uint4"
    tp, meta = load_params(str(tmp_path), device="cpu")
    assert meta["quantization"] == "q4bf16_plane"
    jp, _ = jckpt.load_params(str(tmp_path))
    want = params_from_jax(jax.tree.map(np.asarray, jp))
    for key in ("wqkv", "wo", "w_in", "w_out"):
        a, b = tp["layers"][key], want["layers"][key]
        assert a.spec == b.spec and a.shape == b.shape
        assert all(torch.equal(x, y) for x, y in ((a.data, b.data), (a.scale, b.scale),
                                                  (a.zero, b.zero)))


def test_port_build_loads_in_jax(tmp_path):
    build.main(["--model", "tiny-llama", "--random", "--quantization", "q4bf16_plane", "-o",
                str(tmp_path), "--device", "cpu"])
    man = json.loads((tmp_path / "manifest.json").read_text())
    assert man["leaves"]["layers/w_out/data"]["dtype"] == "uint4"
    jl, meta = jckpt.load_params(str(tmp_path))
    assert meta["quantization"] == "q4bf16_plane"
    assert np.asarray(jl["layers"]["w_out"].data).dtype.name == "uint4"
    tp, _ = load_params(str(tmp_path), device="cpu")
    got = params_from_jax(jax.tree.map(np.asarray, jl))
    for key in ("wqkv", "w_out"):
        assert torch.equal(got["layers"][key].data, tp["layers"][key].data)
    cfg = jget_config("tiny-llama")
    toks = [[1, 2, 3, 4, 5]]
    jlog, _ = _jforward(jl, cfg, jnp.asarray(toks, jnp.int32), jinit_kv(cfg, 1, 16))
    tlog, _ = forward(pad_params(tp), get_config("tiny-llama"), torch.tensor(toks),
                      init_kv_cache(get_config("tiny-llama"), 1, 16, device="cpu"))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=5e-2, rtol=0)


def test_fabricated_planes_are_codes():
    cfg = get_config("tiny-llama")
    p = init_random_params(cfg, "q4bf16_plane", seed=0, fabricate=True, device="cpu")
    data = p["layers"]["w_in"].data
    assert data.dtype == torch.uint8 and int(data.max()) <= 15
    assert data.shape == (cfg.num_layers, cfg.hidden_size, 256)


def test_tiny_llama_logits_and_tokens_match_jax():
    cfg = jget_config("tiny-llama")
    jp = jinit(cfg, "q4bf16_plane", seed=1)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    tcfg = get_config("tiny-llama")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    jc = jinit_kv(cfg, 2, 32)
    tc = init_kv_cache(tcfg, 2, 32, device="cpu")
    jl, jc = _jforward(jp, cfg, jnp.asarray(toks), jc)
    tl, tc = forward(tp, tcfg, torch.from_numpy(toks).long(), tc)
    for step in range(4):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-2, rtol=0)
        nxt = np.asarray(jnp.argmax(jl, axis=-1), np.int32)[:, None]
        assert (tl.argmax(-1).numpy() == nxt[:, 0]).all()
        jl, jc = _jforward(jp, cfg, jnp.asarray(nxt), jc)
        tl, tc = forward(tp, tcfg, torch.tensor(nxt).long(), tc)


def test_cli_runs_plane_preset(capsys):
    cli.main(["--model", "tiny-llama", "--random-weights", "--quantization", "q4bf16_plane",
              "--prompt", "hi", "--temperature", "0", "--max-gen-len", "4",
              "--max-window-size", "64", "--device", "cpu"])
    got = capsys.readouterr()
    assert got.out.endswith("\n") and "decode:" in got.err
