"""The port's forward, engine and CLI against the JAX package.

The JAX side builds the parameters; the port gets the same values
through models.convert.params_from_jax. On the CPU the JAX forward runs
its dequantize-then-matmul path and the port runs its kernels' plain
versions, which round like the TPU kernels (the GEMM rebuilds each
weight as (16+q)*s + (z-16*s) in bf16). Logits are held at 5e-2
absolute (the repo's kernel-vs-jnp tolerance; the largest difference
seen on these models is ~3e-2 on logits of magnitude ~0.7).
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
from mlc_llm_tpu_torch.models import forward, get_config, init_kv_cache
from mlc_llm_tpu_torch.models.convert import params_from_jax

torch.set_num_threads(2)

LOGIT_ATOL = 5e-2
_jforward = jax.jit(jforward, static_argnames=("cfg", "attn_window"))
# tiny-llama mixes layouts (its k=64 tensors fall back to hsplit); the
# widened variant is qsplit throughout, so every matmul is a kernel's
QSPLIT_ONLY = dict(hidden_size=128, intermediate_size=256)


def _jparams(over, quant, seed):
    cfg = jget_config("tiny-llama").replace(**over)
    jp = jinit(cfg, quant, seed=seed)
    jp = jax.tree.map(lambda x: jpad(x) if isinstance(x, JQT) else x, jp,
                      is_leaf=lambda x: isinstance(x, JQT))
    return cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def test_config_copied():
    assert get_config("vicuna-v1-7b").__dict__ == jget_config("vicuna-v1-7b").__dict__
    assert get_config("tiny-llama").__dict__ == jget_config("tiny-llama").__dict__


@pytest.mark.parametrize("quant", ["q4bf16", "bf16"])
@pytest.mark.parametrize("over", [{}, QSPLIT_ONLY], ids=["tiny-llama", "qsplit-only"])
def test_forward_logits_match_jax(over, quant):
    cfg, jp, tp = _jparams(over, quant, seed=3)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 16)).astype(np.int32)
    jc, tc = jinit_kv(cfg, 1, 64), init_kv_cache(cfg, 1, 64, device="cpu")
    # right-padded prefill (13 real tokens in a 16 bucket), then 3 decodes
    jl, jc = _jforward(jp, cfg, jnp.asarray(toks), jc, seq_lens=jnp.asarray([13]),
                       attn_window=64)
    tl, tc = forward(tp, cfg, torch.from_numpy(toks).long(), tc, seq_lens=[13],
                     attn_window=64)
    for step in range(4):
        assert tl.shape == (1, cfg.vocab_size) and tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0)
        if step == 3:
            break
        nxt = np.asarray(jnp.argmax(jl, -1)).reshape(1, 1).astype(np.int32)
        jl, jc = _jforward(jp, cfg, jnp.asarray(nxt), jc, attn_window=64)
        tl, tc = forward(tp, cfg, torch.from_numpy(nxt).long(), tc, attn_window=64)
    assert int(tc.lengths[0]) == int(jc.lengths[0]) == 16


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("over", [{}, QSPLIT_ONLY], ids=["tiny-llama", "qsplit-only"])
def test_engine_greedy_tokens_match_jax(over, seed):
    # near-tied logits can break the other way under the port's kernel
    # rounding; on these seeds the top-1/top-2 logit gap stays >= 8.5e-3
    # over the 12 tokens, far above float noise
    cfg, jp, tp = _jparams(over, "q4bf16", seed=seed)
    prompt = [int(t) for t in np.random.default_rng(seed).integers(3, 256, 11)]
    want = JEngine(cfg, jp, max_seq_len=128).generate(
        [prompt], JGen(max_new_tokens=12, temperature=0.0))
    eng = InferenceEngine(get_config("tiny-llama").replace(**over), tp, max_seq_len=128,
                          device="cpu")
    got = eng.generate([prompt], GenerationConfig(max_new_tokens=12, temperature=0.0))
    assert got == want
    assert eng.stats.prefill_tokens == 11


def test_cli_one_shot_on_cpu():
    out = io.StringIO()
    with redirect_stdout(out):
        cli.main(["--model", "tiny-llama", "--random-weights", "--prompt", "hi",
                  "--temperature", "0", "--max-gen-len", "8", "--device", "cpu"])
    assert out.getvalue().endswith("\n")


def test_cli_weights_not_ported(tmp_path):
    """--weights on a directory that holds no checkpoint exits with a
    clear message (checkpoint loading is ported; the test keeps its name)."""
    with pytest.raises(SystemExit, match="manifest.json missing"):
        cli.main(["--model", "tiny-llama", "--weights", str(tmp_path / "ckpt"), "--device",
                  "cpu"])
