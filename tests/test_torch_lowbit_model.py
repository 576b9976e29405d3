"""The port's forward, engine, scheduler and front ends on the low-bit
formats, against the JAX package on the CPU.

The JAX side builds tiny-llama in q3bf16_s16 (int3, five codes per u16
word, group 40) and pads its groups to multiples of 32 as its engine
does; the port gets the same values through models.convert. On the CPU
the JAX forward dequantizes and multiplies, while the port runs its
kernels' plain versions (the int3 GEMV at m <= 2, the plane GEMM above),
which round like the TPU kernels. Logits are held at 5e-2 absolute, the
repo's kernel-vs-jnp tolerance (tests/test_torch_model.py).
"""

import argparse
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
from mlc_llm_tpu_torch import cli, serve
from mlc_llm_tpu_torch.engine import GenerationConfig, InferenceEngine
from mlc_llm_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
from mlc_llm_tpu_torch.models import forward, get_config, init_kv_cache, init_random_params
from mlc_llm_tpu_torch.models.convert import params_from_jax
from mlc_llm_tpu_torch.ops import dequant_matmul as dm
from mlc_llm_tpu_torch.quant import QuantizedTensor

torch.set_num_threads(2)

LOGIT_ATOL = 5e-2
Q3 = "q3bf16_s16"
_jforward = jax.jit(jforward, static_argnames=("cfg", "attn_window"))


def _jparams(quant, seed):
    cfg = jget_config("tiny-llama")
    jp = jinit(cfg, quant, seed=seed)
    jp = jax.tree.map(lambda x: jpad(x) if isinstance(x, JQT) else x, jp,
                      is_leaf=lambda x: isinstance(x, JQT))
    return cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_q3_forward_logits_match_jax(kv):
    cfg, jp, tp = _jparams(Q3, seed=3)
    jdt, tdt = (jnp.int8, torch.int8) if kv == "int8" else (jnp.bfloat16, torch.bfloat16)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 16)).astype(np.int32)
    jc, tc = jinit_kv(cfg, 1, 64, dtype=jdt), init_kv_cache(cfg, 1, 64, dtype=tdt, device="cpu")
    # right-padded prefill (13 real tokens in a 16 bucket: the plane GEMM),
    # then 3 decodes (the int3 GEMV)
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


@pytest.mark.parametrize("seed", [0, 4])
def test_q3_engine_greedy_tokens_match_jax(seed):
    # near-tied logits can break the other way under the port's kernel
    # rounding; on these seeds the top-1/top-2 logit gap stays >= 9e-3
    # over the 12 tokens, far above float noise
    cfg, jp, tp = _jparams(Q3, seed=seed)
    prompt = [int(t) for t in np.random.default_rng(seed).integers(3, 256, 11)]
    want = JEngine(cfg, jp, max_seq_len=128).generate(
        [prompt], JGen(max_new_tokens=12, temperature=0.0))
    eng = InferenceEngine(get_config("tiny-llama"), tp, max_seq_len=128, device="cpu")
    got = eng.generate([prompt], GenerationConfig(max_new_tokens=12, temperature=0.0))
    assert got == want


@pytest.mark.parametrize("quant", ["q4bf16", "q3bf16", Q3, "fp4bf16", "q8bf16"])
def test_fabricated_params_match_jax_layout(quant):
    # fabricate=True draws the stored layout directly: every leaf's shape
    # and dtype equal JAX's fab (u32 words as int32, u16 as int16)
    cfg = jget_config("tiny-llama")
    want = params_from_jax(jax.tree.map(np.asarray, jinit(cfg, quant, seed=0, fabricate=True)))
    got = init_random_params(get_config("tiny-llama"), quant, seed=0, fabricate=True,
                             device="cpu")

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], f"{prefix}/{k}")
        elif isinstance(tree, QuantizedTensor):
            for f in ("data", "scale", "zero"):
                t = getattr(tree, f)
                yield f"{prefix}.{f}", None if t is None else (tuple(t.shape), t.dtype)
            yield f"{prefix}.spec", (tree.spec, tree.shape)
        else:
            yield prefix, (tuple(tree.shape), tree.dtype)

    assert dict(leaves(got)) == dict(leaves(want))


@pytest.mark.parametrize("quant", [Q3, "fp4bf16", "q8bf16"])
def test_cli_one_shot_lowbit_on_cpu(quant):
    out = io.StringIO()
    with redirect_stdout(out):
        cli.main(["--model", "tiny-llama", "--random-weights", "--quantization", quant,
                  "--prompt", "hi", "--temperature", "0", "--max-gen-len", "8",
                  "--device", "cpu"])
    assert out.getvalue().endswith("\n")


def test_q3_scheduler_b4_reaches_the_plane_gemm(monkeypatch):
    # serve's engine on the CPU (--quantization q3bf16_s16 --paged
    # --max-batch 4): admissions prefill one slot at m = the bucket, each
    # decode step runs all 4 slots at m = 4, past the int3 GEMV's m <= 2
    args = argparse.Namespace(model="tiny-llama", weights=None, random_weights=True,
                              quantization=Q3, fabricate=False, max_batch=4, max_seq_len=64,
                              paged=True, page_size=8, prefix_cache_pages=None, device="cpu")
    engine = serve.build_engine(args)
    seen = []
    plain = dm.gemm_plane_plain

    def spy(x, *a, **kw):
        seen.append(x.shape[0])
        return plain(x, *a, **kw)

    monkeypatch.setattr(dm, "gemm_plane_plain", spy)
    sched = ContinuousBatchingScheduler(engine)
    gen = GenerationConfig(max_new_tokens=6, temperature=0.0)
    reqs = [sched.submit([5 + i, 6, 7 + 2 * i], gen) for i in range(4)]
    sched.run()
    assert all(r.done and 1 <= len(r.output) <= 6 for r in reqs)
    assert 4 in seen and engine.decode_forwards > 0
    # the same engine's solo decode of request 0 (m = 1: the int3 GEMV)
    # agrees on its first token, which the prefill alone decides
    solo = InferenceEngine(engine.cfg, engine.params, max_seq_len=64, device="cpu")
    assert solo.generate([[5, 6, 7]], gen)[0][0] == reqs[0].output[0]
