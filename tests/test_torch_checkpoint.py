"""The port's checkpoint reader and writer against the JAX package's.

Both packages write one raw .bin per leaf and a manifest.json; the port
reads what JAX writes and JAX reads what the port writes, with every
leaf bit-equal. Presets on tiny-llama: q4bf16 (hsplit and qsplit tensors
side by side: k = 64 gives 2 groups, which cannot quarter-split), q3bf16_s16
(u16 words), q3f16_s16 (u16 words, f16 scales), q8bf16 (int8 planes), f32
(dense); on tiny-gpt_neox q4f32 (pair words, f32 scales, layernorm biases).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlc_llm_tpu.models import forward as jforward
from mlc_llm_tpu.models import get_config as jget_config
from mlc_llm_tpu.models import init_kv_cache as jinit_kv
from mlc_llm_tpu.models import init_random_params as jinit
from mlc_llm_tpu.quant import quantize as jquantize
from mlc_llm_tpu.utils import checkpoint as jckpt
from mlc_llm_tpu_torch.models import forward, get_config, init_kv_cache, init_random_params
from mlc_llm_tpu_torch.models.convert import params_from_jax
from mlc_llm_tpu_torch.models.transformer import pad_params
from mlc_llm_tpu_torch.quant import QuantizedTensor
from mlc_llm_tpu_torch.utils.checkpoint import load_params, save_params

torch.set_num_threads(2)

CASES = [("tiny-llama", "q4bf16"), ("tiny-llama", "q3bf16_s16"), ("tiny-llama", "q8bf16"),
         ("tiny-llama", "f32"), ("tiny-gpt_neox", "q4f32"), ("tiny-llama", "q3f16_s16")]
_jforward = jax.jit(jforward, static_argnames=("cfg",))


def _flat(tree, prefix=""):
    out = {}
    for k, node in tree.items():
        key = prefix + k
        if isinstance(node, dict):
            out.update(_flat(node, key + "/"))
        elif isinstance(node, QuantizedTensor):
            out[key + "/spec"] = (node.spec, node.shape)
            out.update({f"{key}/{f}": t for f, t in (("data", node.data), ("scale", node.scale),
                                                     ("zero", node.zero)) if t is not None})
        else:
            out[key] = node
    return out


def _assert_bit_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if k.endswith("/spec"):
            assert fa[k] == fb[k], k
        else:
            assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


@pytest.mark.parametrize("name,quant", CASES)
def test_jax_checkpoint_loads_in_the_port(tmp_path, name, quant):
    cfg = jget_config(name)
    jp = jinit(cfg, quant, seed=4)
    jckpt.save_params(jp, str(tmp_path), meta={"model": name})
    tp, meta = load_params(str(tmp_path), device="cpu")
    assert meta == {"model": name}
    _assert_bit_equal(tp, params_from_jax(jax.tree.map(np.asarray, jp)))
    if quant == "q4bf16":
        layouts = {v[0].layout for k, v in _flat(tp).items() if k.endswith("/spec")}
        assert layouts == {"hsplit", "qsplit"}


@pytest.mark.parametrize("name,quant", CASES)
def test_port_checkpoint_loads_in_jax(tmp_path, name, quant):
    cfg = jget_config(name)
    jp = jinit(cfg, quant, seed=5)
    save_params(params_from_jax(jax.tree.map(np.asarray, jp)), str(tmp_path),
                meta={"model": name})
    man = json.loads((tmp_path / "manifest.json").read_text())
    want = {k: str(np.asarray(v).dtype) for k, v in _flat_jax(jp).items()}
    assert {k: e["dtype"] for k, e in man["leaves"].items()} == want
    jl, _ = jckpt.load_params(str(tmp_path))
    for k, v in _flat_jax(jl).items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(_flat_jax(jp)[k]))
    toks = jnp.asarray([[1, 2, 3, 4, 5]], jnp.int32)
    a, _ = _jforward(jp, cfg, toks, jinit_kv(cfg, 1, 16))
    b, _ = _jforward(jl, cfg, toks, jinit_kv(cfg, 1, 16))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _flat_jax(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "name", p))) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("name,quant", CASES)
def test_port_round_trip_logits(tmp_path, name, quant):
    cfg = get_config(name)
    params = init_random_params(cfg, quant, seed=6, device="cpu")
    save_params(params, str(tmp_path), meta={"model": name})
    loaded, _ = load_params(str(tmp_path), device="cpu")
    _assert_bit_equal(loaded, params)
    toks = torch.tensor([[1, 2, 3, 4, 5]])
    a, _ = forward(pad_params(params), cfg, toks, init_kv_cache(cfg, 1, 16, device="cpu"))
    b, _ = forward(pad_params(loaded), cfg, toks, init_kv_cache(cfg, 1, 16, device="cpu"))
    assert torch.equal(a, b)


def test_manifest_without_layout_loads_as_pair(tmp_path):
    w = (np.random.default_rng(0).standard_normal((128, 128)) * 0.05).astype(np.float32)
    jckpt.save_params({"w": jquantize(w, "q4bf16_pair")}, str(tmp_path), meta={})
    man = json.loads((tmp_path / "manifest.json").read_text())
    for info in man["quantized"].values():
        info["spec"].pop("layout")
    (tmp_path / "manifest.json").write_text(json.dumps(man))
    tree, _ = load_params(str(tmp_path), device="cpu")
    assert tree["w"].spec.layout == "pair"
    _assert_bit_equal(tree, params_from_jax({"w": jax.tree.map(np.asarray, jquantize(
        w, "q4bf16_pair"))}))


def test_u4_manifest_raises(tmp_path):
    # a u4 plane ("uint4", one code a byte) loads bit-equal; a plane file
    # of another size than its manifest shape raises
    w = (np.random.default_rng(1).standard_normal((64, 128)) * 0.05).astype(np.float32)
    jckpt.save_params({"w": jquantize(w, "q4bf16_plane")}, str(tmp_path), meta={})
    tree, _ = load_params(str(tmp_path), device="cpu")
    _assert_bit_equal(tree, params_from_jax({"w": jax.tree.map(np.asarray, jquantize(
        w, "q4bf16_plane"))}))
    with open(tmp_path / "w.data.bin", "ab") as f:
        f.write(b"\0")
    with pytest.raises(ValueError, match="bytes"):
        load_params(str(tmp_path), device="cpu")


def test_group_padded_params_are_not_saved(tmp_path):
    cfg = get_config("tiny-llama")
    params = pad_params(init_random_params(cfg, "q4bf16", seed=0, device="cpu"))
    with pytest.raises(ValueError, match="group-padded"):
        save_params(params, str(tmp_path))


def test_cuda_load_without_a_gpu_raises(tmp_path):
    save_params(init_random_params(get_config("tiny-llama"), "f32", device="cpu"), str(tmp_path))
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the load would succeed")
    with pytest.raises(RuntimeError, match="cuda"):
        load_params(str(tmp_path))
