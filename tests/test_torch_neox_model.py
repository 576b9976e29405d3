"""The port's GPT-NeoX forward, engine and CLI against the JAX package.

Two tiny wirings of the family: tiny-gpt_neox (dolly's: parallel
residual, 25% rotary) and a sequential one with full rotary
(RedPajama's), each in q4bf16 (qsplit layers where the groups split,
hsplit where they do not, the f32 head), q4f32 (pair order, f32 compute)
and q4f16_hs (hsplit, f16 layers, f32 head). The JAX side builds the
parameters and then redraws every LayerNorm weight and bias and the four
linear biases from a seeded numpy generator, since init_random_params
sets them to constants that would hide a wrong bias path; the port gets
the same values through models.convert.

On the CPU the JAX forward dequantizes and multiplies while the port runs
its kernels' plain versions (gemv_gp/gemv_qs at m <= 8, gemm_pairs/gemm_qs
above), which round like the TPU kernels. Logits are held at 5e-2
absolute in bf16 and f16, the repo's kernel-vs-jnp tolerance
(tests/test_torch_model.py; the largest difference seen here is 3.3e-3
on logits of magnitude ~0.5), and at 1e-4 in f32, where only the bf16 KV
cache rounds and an f32 sum in another order could push one of its
values across a rounding boundary (seen: 2.6e-7).
"""

import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlc_llm_tpu.engine import GenerationConfig as JGen
from mlc_llm_tpu.engine import InferenceEngine as JEngine
from mlc_llm_tpu.models import forward as jforward
from mlc_llm_tpu.models import get_config as jget_config
from mlc_llm_tpu.models import init_kv_cache as jinit_kv
from mlc_llm_tpu.models import init_random_params as jinit
from mlc_llm_tpu.models.config import MODEL_REGISTRY as JREGISTRY
from mlc_llm_tpu.quant.groupwise import QuantizedTensor as JQT
from mlc_llm_tpu.quant.groupwise import pad_quantized_groups as jpad
from mlc_llm_tpu_torch import cli
from mlc_llm_tpu_torch.engine import GenerationConfig, InferenceEngine
from mlc_llm_tpu_torch.models import forward, get_config, init_kv_cache
from mlc_llm_tpu_torch.models.convert import params_from_jax
from mlc_llm_tpu_torch.ops import dequant_matmul as dm

torch.set_num_threads(2)

NEOX = sorted(n for n, c in JREGISTRY.items() if c.family == "gpt_neox")
# RedPajama-INCITE's wiring on the tiny width
WIRINGS = {"parallel": {}, "sequential": dict(parallel_residual=False, rotary_pct=1.0)}
QUANTS = ["q4bf16", "q4f32", "q4f16_hs"]
LOGIT_ATOL = {"q4f32": 1e-4}
_jforward = jax.jit(jforward, static_argnames=("cfg", "attn_window"))
_BIASES = ("ln1_w", "ln1_b", "ln2_w", "ln2_b", "bqkv", "bo", "b_in", "b_out")


def _redraw(a, rng, center):
    return jnp.asarray(center + rng.standard_normal(a.shape) * 0.1, a.dtype)


def _jparams(wiring, quant, seed):
    cfg = jget_config("tiny-gpt_neox").replace(**WIRINGS[wiring])
    jp = jinit(cfg, quant, seed=seed)
    rng = np.random.default_rng(100 + seed)
    layers = dict(jp["layers"])
    for key in _BIASES:
        layers[key] = _redraw(layers[key], rng, 1.0 if key.endswith("_w") else 0.0)
    final = {"w": _redraw(jp["final_ln"]["w"], rng, 1.0),
             "b": _redraw(jp["final_ln"]["b"], rng, 0.0)}
    jp = {**jp, "layers": layers, "final_ln": final}
    jp = jax.tree.map(lambda x: jpad(x) if isinstance(x, JQT) else x, jp,
                      is_leaf=lambda x: isinstance(x, JQT))
    return cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("name", NEOX)
def test_neox_config_copied(name):
    assert get_config(name).__dict__ == jget_config(name).__dict__


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("wiring", list(WIRINGS))
def test_neox_forward_logits_match_jax(wiring, quant):
    cfg, jp, tp = _jparams(wiring, quant, seed=3)
    assert tp["layers"]["wqkv"].spec.dtype == jp["layers"]["wqkv"].spec.dtype
    assert tp["lm_head"]["w"].scale.dtype == torch.float32  # the f32 head
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 16)).astype(np.int32)
    jc, tc = jinit_kv(cfg, 1, 64), init_kv_cache(cfg, 1, 64, device="cpu")
    # right-padded prefill (13 real tokens in a 16 bucket: the GEMMs), then
    # 3 decodes (the GEMVs)
    jl, jc = _jforward(jp, cfg, jnp.asarray(toks), jc, seq_lens=jnp.asarray([13]),
                       attn_window=64)
    tl, tc = forward(tp, cfg, torch.from_numpy(toks).long(), tc, seq_lens=[13],
                     attn_window=64)
    atol = LOGIT_ATOL.get(quant, 5e-2)
    for step in range(4):
        assert tl.shape == (1, cfg.vocab_size) and tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol, rtol=0)
        if step == 3:
            break
        nxt = np.asarray(jnp.argmax(jl, -1)).reshape(1, 1).astype(np.int32)
        jl, jc = _jforward(jp, cfg, jnp.asarray(nxt), jc, attn_window=64)
        tl, tc = forward(tp, cfg, torch.from_numpy(nxt).long(), tc, attn_window=64)
    assert int(tc.lengths[0]) == int(jc.lengths[0]) == 16
    assert all(fn.launches == 0 for fn in (dm.gemv_gp, dm.gemm_pairs, dm.gemv_qs, dm.gemm_qs))


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("wiring", list(WIRINGS))
def test_neox_engine_greedy_tokens_match_jax(wiring, quant):
    cfg, jp, tp = _jparams(wiring, quant, seed=0)
    prompt = [int(t) for t in np.random.default_rng(5).integers(3, 256, 11)]
    want = JEngine(cfg, jp, max_seq_len=128).generate(
        [prompt], JGen(max_new_tokens=12, temperature=0.0))
    eng = InferenceEngine(get_config("tiny-gpt_neox").replace(**WIRINGS[wiring]), tp,
                          max_seq_len=128, device="cpu")
    got = eng.generate([prompt], GenerationConfig(max_new_tokens=12, temperature=0.0))
    assert got == want
    assert eng.stats.prefill_tokens == 11


@pytest.mark.parametrize("quant", ["q4f32", "q4f16_hs"])
def test_neox_cli_one_shot_on_cpu(quant):
    out = io.StringIO()
    with redirect_stdout(out):
        cli.main(["--model", "tiny-gpt_neox", "--random-weights", "--quantization", quant,
                  "--prompt", "hi", "--temperature", "0", "--max-gen-len", "8",
                  "--device", "cpu"])
    assert out.getvalue().endswith("\n")
