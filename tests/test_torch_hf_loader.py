"""The port's HF loader against HuggingFace transformers and the JAX loader.

Tiny randomly initialised HF models (the JAX suite's, tests/test_models.py)
go through the port's params_from_hf:
- port logits against HF logits at 2e-3 in f32 (the JAX suite's
  tolerance), for Llama (also with grouped-query attention), GPT-NeoX and
  MOSS (GPT-J architecture);
- the port's leaves against the JAX loader's (through
  models.convert.params_from_jax), bit-equal in q4bf16 and f32, at a
  hidden size of 128: the JAX loader quantizes the embedding without the
  per-shape layout fallback, so at 64 (2 groups) it cannot quarter-split
  it;
- MOSS's fused qkv_proj de-interleave against the JAX one;
- build --hf-path on a save_pretrained directory, then the CLI on it.
"""

import io
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from mlc_llm_tpu.models import get_config as jget_config
from mlc_llm_tpu.models import hf_loader as jhf
from mlc_llm_tpu_torch import build, cli
from mlc_llm_tpu_torch.models import forward, get_config, init_kv_cache
from mlc_llm_tpu_torch.models.convert import params_from_jax
from mlc_llm_tpu_torch.models.hf_loader import params_from_hf, split_moss_qkv
from mlc_llm_tpu_torch.quant import QuantizedTensor
from mlc_llm_tpu_torch.utils.checkpoint import load_params

transformers = pytest.importorskip("transformers")
torch.set_num_threads(2)

FAMILIES = ["llama", "gpt_neox", "moss"]


def _hf_model(family, hidden=64):
    torch.manual_seed(0)
    if family == "llama":
        m = transformers.LlamaForCausalLM(transformers.LlamaConfig(
            vocab_size=256, hidden_size=hidden, intermediate_size=2 * hidden,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
            max_position_embeddings=128, rms_norm_eps=1e-6, rope_theta=10000.0,
            tie_word_embeddings=False))
    elif family == "gpt_neox":
        m = transformers.GPTNeoXForCausalLM(transformers.GPTNeoXConfig(
            vocab_size=256, hidden_size=hidden, intermediate_size=4 * hidden,
            num_hidden_layers=2, num_attention_heads=4, max_position_embeddings=128,
            rotary_pct=0.25, use_parallel_residual=True, layer_norm_eps=1e-5,
            tie_word_embeddings=False))
    else:  # moss: GPT-J architecture
        m = transformers.GPTJForCausalLM(transformers.GPTJConfig(
            vocab_size=256, n_embd=hidden, n_head=4, n_layer=2, n_inner=4 * hidden,
            n_positions=128, rotary_dim=hidden // 16, activation_function="gelu_new",
            tie_word_embeddings=False))
    return m.eval()


def _widths(family, hidden):
    ff = 2 * hidden if family == "llama" else 4 * hidden
    return dict(hidden_size=hidden, intermediate_size=ff)


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
            assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
            assert torch.equal(fa[k], fb[k]), k


def _logits(params, cfg, toks):
    cache = init_kv_cache(cfg, toks.shape[0], 32, dtype=torch.float32, device="cpu")
    got, _ = forward(params, cfg, torch.from_numpy(toks), cache, last_only=False)
    return got.numpy()


@pytest.mark.parametrize("family", FAMILIES)
def test_logits_match_hf_f32(family):
    cfg = get_config(f"tiny-{family}")
    hf = _hf_model(family)
    params = params_from_hf(hf, cfg, "f32", device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12))
    with torch.no_grad():
        want = hf(torch.from_numpy(toks)).logits.float().numpy()
    np.testing.assert_allclose(_logits(params, cfg, toks), want, atol=2e-3, rtol=2e-3)


def test_gqa_logits_match_hf():
    torch.manual_seed(1)
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=8, num_key_value_heads=2, max_position_embeddings=64,
        rms_norm_eps=1e-6, tie_word_embeddings=False)).eval()
    cfg = get_config("tiny-llama").replace(vocab_size=128, num_heads=8, num_kv_heads=2,
                                           max_seq_len=64)
    params = params_from_hf(hf, cfg, "f32", device="cpu")
    toks = np.random.default_rng(0).integers(0, 128, (1, 10))
    with torch.no_grad():
        want = hf(torch.from_numpy(toks)).logits.float().numpy()
    np.testing.assert_allclose(_logits(params, cfg, toks), want, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("quant", ["q4bf16", "f32"])
@pytest.mark.parametrize("family", FAMILIES)
def test_leaves_match_the_jax_loader(family, quant):
    hf = _hf_model(family, hidden=128)
    over = _widths(family, 128)
    jp = jhf.params_from_hf(hf, jget_config(f"tiny-{family}").replace(**over), quant)
    got = params_from_hf(hf, get_config(f"tiny-{family}").replace(**over), quant, device="cpu")
    _assert_bit_equal(got, params_from_jax(jax.tree.map(np.asarray, jp)))


def test_state_dict_mapping_equals_the_module():
    hf = _hf_model("gpt_neox")
    cfg = get_config("tiny-gpt_neox")
    sd = {k: v.clone() for k, v in hf.state_dict().items()}
    _assert_bit_equal(params_from_hf(sd, cfg, "q4f32", device="cpu"),
                      params_from_hf(hf, cfg, "q4f32", device="cpu"))


def test_moss_fused_qkv_deinterleave():
    H, mp = 64, 4
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((H, H)).astype(np.float32) for _ in range(3))
    per = H // mp
    # the MOSS layout: mp blocks, each holding its q, v, k rows in that order
    fused = np.concatenate([np.concatenate([x[j * per:(j + 1) * per] for x in (q, v, k)])
                            for j in range(mp)])
    got = split_moss_qkv(torch.from_numpy(fused), H)
    for g, want, jw in zip(got, (q, k, v), jhf._split_moss_qkv(fused, H)):
        np.testing.assert_array_equal(g.numpy(), want)
        np.testing.assert_array_equal(g.numpy(), jw)
    # a MOSS state dict with the fused weight loads as its GPT-J layout
    hf = _hf_model("moss")
    cfg = get_config("tiny-moss")
    sd = dict(hf.state_dict())
    fused_sd = {key: t for key, t in sd.items()
                if not any(f".attn.{x}_proj." in key for x in "qkv")}
    for i in range(cfg.num_layers):
        ws = [sd[f"transformer.h.{i}.attn.{x}_proj.weight"] for x in "qvk"]
        fused_sd[f"transformer.h.{i}.attn.qkv_proj.weight"] = torch.cat(
            [torch.cat([w[j * per:(j + 1) * per] for w in ws]) for j in range(mp)])
    _assert_bit_equal(params_from_hf(fused_sd, cfg, "q4bf16", device="cpu"),
                      params_from_hf(sd, cfg, "q4bf16", device="cpu"))


def test_build_hf_path_then_cli(tmp_path):
    hf = _hf_model("llama")
    hf.save_pretrained(tmp_path / "hf")
    out = str(tmp_path / "ck")
    build.main(["--model", "tiny-llama", "--hf-path", str(tmp_path / "hf"), "--quantization",
                "q4bf16", "-o", out, "--device", "cpu"])
    loaded, meta = load_params(out, device="cpu")
    assert meta["built_with"] == "mlc_llm_tpu_torch.build"
    _assert_bit_equal(loaded, params_from_hf(hf, get_config("tiny-llama"), "q4bf16",
                                             device="cpu"))
    buf = io.StringIO()
    with redirect_stdout(buf):
        cli.main(["--model", "tiny-llama", "--weights", out, "--prompt", "hi", "--temperature",
                  "0", "--max-gen-len", "4", "--device", "cpu"])
    assert buf.getvalue().endswith("\n")
