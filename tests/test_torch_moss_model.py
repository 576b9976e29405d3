"""The port's MOSS forward, engine and CLI on the slot cache, against the
JAX package.

tiny-moss is MOSS's block on the tiny width: one LayerNorm feeding both
branches, GPT-J rotary on a quarter of the head dim, gelu_new, a biased
MLP and a biased lm head. The JAX side builds the parameters and then
redraws the LayerNorm weights and biases, the MLP biases and the lm-head
bias from a seeded numpy generator (init_random_params sets them to
constants that would hide a wrong bias path); the port gets the same
values through models.convert. Presets: q4bf16 (qsplit where the groups
split, hsplit where they do not), q4f32 (pair order, f32 compute),
q4f16_hs (hsplit, f16) and f32 (dense).

Logits are held at 5e-2 absolute in bf16 and f16 (the repo's
kernel-vs-jnp tolerance: the port's CPU path rounds like the TPU kernels,
tests/test_torch_model.py) and at 1e-4 in f32 compute, where only the
bf16 KV cache rounds. MOSS's bos/eos ids (106028/106068) lie outside the
tiny vocabulary of 256, so the prompts are ids inside it and the CLI
runs a copy of tiny-moss whose bos/eos are ids 1 and 2.
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
from mlc_llm_tpu.quant.groupwise import QuantizedTensor as JQT
from mlc_llm_tpu.quant.groupwise import pad_quantized_groups as jpad
from mlc_llm_tpu_torch import cli
from mlc_llm_tpu_torch.engine import GenerationConfig, InferenceEngine
from mlc_llm_tpu_torch.models import config as tconfig
from mlc_llm_tpu_torch.models import forward, get_config, init_kv_cache
from mlc_llm_tpu_torch.models.convert import params_from_jax

torch.set_num_threads(2)

QUANTS = ["q4bf16", "q4f32", "q4f16_hs", "f32"]
LOGIT_ATOL = {"q4f32": 1e-4, "f32": 1e-4}
_jforward = jax.jit(jforward, static_argnames=("cfg", "attn_window"))
_REDRAWN = ("ln1_w", "ln1_b", "b_in", "b_out")


def _redraw(a, rng, center):
    return jnp.asarray(center + rng.standard_normal(a.shape) * 0.1, a.dtype)


def _jparams(quant, seed):
    cfg = jget_config("tiny-moss")
    jp = jinit(cfg, quant, seed=seed)
    rng = np.random.default_rng(200 + seed)
    layers = dict(jp["layers"])
    for key in _REDRAWN:
        layers[key] = _redraw(layers[key], rng, 1.0 if key.endswith("_w") else 0.0)
    final = {"w": _redraw(jp["final_ln"]["w"], rng, 1.0),
             "b": _redraw(jp["final_ln"]["b"], rng, 0.0)}
    head = dict(jp["lm_head"], b=_redraw(jp["lm_head"]["b"], rng, 0.0))
    jp = {**jp, "layers": layers, "final_ln": final, "lm_head": head}
    jp = jax.tree.map(lambda x: jpad(x) if isinstance(x, JQT) else x, jp,
                      is_leaf=lambda x: isinstance(x, JQT))
    return cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("name", ["moss-moon-003-sft", "tiny-moss"])
def test_moss_config_copied(name):
    assert get_config(name).__dict__ == jget_config(name).__dict__


@pytest.mark.parametrize("quant", QUANTS)
def test_moss_forward_logits_match_jax(quant):
    cfg, jp, tp = _jparams(quant, seed=3)
    assert set(tp["layers"]) == {"ln1_w", "ln1_b", "wqkv", "wo", "w_in", "b_in", "w_out",
                                 "b_out"}
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 16)).astype(np.int32)
    jc, tc = jinit_kv(cfg, 1, 64), init_kv_cache(cfg, 1, 64, device="cpu")
    # a right-padded prefill (13 real tokens in a 16 bucket), then 3 decodes
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


@pytest.mark.parametrize("quant", QUANTS[:3])
def test_moss_engine_greedy_tokens_match_jax(quant):
    cfg, jp, tp = _jparams(quant, seed=0)
    prompt = [int(t) for t in np.random.default_rng(5).integers(3, 256, 11)]
    want = JEngine(cfg, jp, max_seq_len=128).generate(
        [prompt], JGen(max_new_tokens=12, temperature=0.0))
    eng = InferenceEngine(get_config("tiny-moss"), tp, max_seq_len=128, device="cpu")
    got = eng.generate([prompt], GenerationConfig(max_new_tokens=12, temperature=0.0))
    assert got == want
    assert eng.stats.prefill_tokens == 11


@pytest.mark.parametrize("quant", QUANTS[:3])
def test_moss_cli_one_shot(quant, monkeypatch):
    tiny = tconfig.MODEL_REGISTRY["tiny-moss"]
    monkeypatch.setitem(tconfig.MODEL_REGISTRY, "tiny-moss",
                        tiny.replace(bos_token_id=1, eos_token_id=2, stop_tokens=(2,)))
    out = io.StringIO()
    with redirect_stdout(out):
        cli.main(["--model", "tiny-moss", "--random-weights", "--quantization", quant,
                  "--prompt", "hi", "--temperature", "0", "--max-gen-len", "8",
                  "--device", "cpu"])
    assert out.getvalue().endswith("\n")
