"""The port's perplexity, compare and evaluate tools on the CPU.

- ppl.perplexity of the port against the JAX one on the same params and
  tokens: |Δ log ppl| < 1e-3 in f32 (f32 arithmetic on both sides, an f32
  KV cache) and < 1e-2 in q4bf16 (the port's CPU path rounds like the TPU
  kernels, bf16 KV); and the JAX suite's sanity bounds
  (tests/test_tools.py): near-uniform prediction on random weights, q8
  close to dense;
- debug.compare.compare_paths on tiny models (on the CPU both sides run
  the plain versions, so every row passes at 0);
- evaluate.main with --profile prints its timings and its table.
"""

import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlc_llm_tpu.models import get_config as jget_config
from mlc_llm_tpu.models import init_random_params as jinit
from mlc_llm_tpu.ppl import perplexity as jperplexity
from mlc_llm_tpu_torch import evaluate, ppl
from mlc_llm_tpu_torch.debug import compare
from mlc_llm_tpu_torch.models import get_config, init_random_params
from mlc_llm_tpu_torch.models.convert import params_from_jax

torch.set_num_threads(2)


@pytest.mark.parametrize("quant,cache,tol", [("f32", "float32", 1e-3),
                                             ("q4bf16", "bfloat16", 1e-2)])
def test_perplexity_matches_jax(quant, cache, tol):
    cfg = jget_config("tiny-llama")
    jp = jinit(cfg, quant, seed=2)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, 300, dtype=np.int32)
    want = jperplexity(jp, cfg, toks, window=64, stride=32, cache_dtype=getattr(jnp, cache))
    got = ppl.perplexity(params_from_jax(jax.tree.map(np.asarray, jp)), get_config("tiny-llama"),
                         toks, window=64, stride=32, cache_dtype=getattr(torch, cache))
    assert got["tokens_scored"] == want["tokens_scored"]
    assert abs(np.log(got["perplexity"]) - np.log(want["perplexity"])) < tol


def test_perplexity_uniform_sanity():
    cfg = get_config("tiny-llama")
    params = init_random_params(cfg, "f32", seed=0, device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, 300, dtype=np.int32)
    res = ppl.perplexity(params, cfg, toks, window=64, stride=32, cache_dtype=torch.float32)
    # random weights ~ uniform prediction -> ppl near the vocabulary size
    assert 100 < res["perplexity"] < 600
    assert res["tokens_scored"] > 200


def test_quantized_ppl_close_to_dense():
    cfg = get_config("tiny-llama")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, 200, dtype=np.int32)
    a = ppl.perplexity(init_random_params(cfg, "f32", seed=1, device="cpu"), cfg, toks,
                       window=64, stride=32, cache_dtype=torch.float32)
    b = ppl.perplexity(init_random_params(cfg, "q8bf16", seed=1, device="cpu"), cfg, toks,
                       window=64, stride=32)
    assert abs(np.log(a["perplexity"]) - np.log(b["perplexity"])) < 0.1


def test_ppl_main_prints_one_json_line(capsys):
    res = ppl.main(["--model", "tiny-llama", "--random", "--window", "64", "--device", "cpu"])
    assert capsys.readouterr().out.count("\n") == 1
    assert res["tokens_scored"] == 2047 and np.isfinite(res["perplexity"])


@pytest.mark.parametrize("name,quant", [("tiny-llama", "q4bf16"), ("tiny-gpt_neox", "q4bf16"),
                                        ("tiny-moss", "q3bf16_s16")])
def test_compare_paths_on_the_cpu(name, quant):
    cfg = get_config(name)
    params = init_random_params(cfg, quant, seed=2, device="cpu")
    rows = compare.compare_paths(cfg, params, [[1, 2, 3, 4]])
    assert [r[0] for r in rows] == ["qmatmul[w_in]", "qmatmul[w_out]", "qmatmul[wo]",
                                    "qmatmul[wqkv]", "forward logits"]
    assert all(ok and err == 0.0 for _, err, ok in rows), rows


def test_compare_main_exit_code():
    out = io.StringIO()
    with redirect_stdout(out):
        assert compare.main(["--model", "tiny-llama", "--device", "cpu"]) == 0
    assert out.getvalue().count("OK ") == 5


def test_evaluate_main_profile():
    out = io.StringIO()
    with redirect_stdout(out):
        evaluate.main(["--model", "tiny-llama", "--random", "--device", "cpu", "--prompt-len",
                       "16", "--gen-len", "4", "--max-seq-len", "64", "--profile"])
    text = out.getvalue()
    assert "prefill[16]:" in text and "ms/tok" in text
    for op in ("dequant_matmul[wqkv]", "dequant_matmul[w_out]", "lm_head",
               "decode_attention[L=16]x1layer", "sample_top_p"):
        assert op in text
    with pytest.raises(SystemExit, match="must fit"):
        evaluate.main(["--model", "tiny-llama", "--random", "--device", "cpu", "--prompt-len",
                       "60", "--gen-len", "4", "--max-seq-len", "64"])
