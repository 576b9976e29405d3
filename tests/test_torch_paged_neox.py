"""Kernel 7 at every head dim, query type and page type, and GPT-NeoX and
MOSS on the paged cache, against the JAX package.

Same inputs, made with numpy, go through both packages. Tolerances:
- kernel 7's plain version against JAX's Pallas kernel in interpret mode
  (`interpret=True`): 1e-5 with f32 pages and f32 q (the same f32
  arithmetic, summed in another order), 2e-2 otherwise (a bf16/f16 q or
  output, or a bf16 probability, may round the other way after an f32 sum
  in another order). Head dims 16, 20 and 32 (20 stands in for the 3B's 80,
  whose CUDA lane count is no power of two), q in f32/f16/bf16, pages in
  f32/f16/bf16/int8, rep 1 and 2;
- logits of the paged forward against JAX's paged forward and against the
  port's own slot forward, for a right-padded prefill and decode steps
  across a page boundary: 1e-4 in q4f32 on f32 pages (f32 arithmetic in
  both), 5e-2 in q4f16_hs on f16 pages (the port's CPU path rounds like the
  TPU kernels, tests/test_torch_model.py); tiny-gpt_neox (dolly's block:
  parallel residual, rotary on a quarter of the dims, biased qkv),
  tiny-moss (GPT-J rotary, one norm, biased MLP and lm head) and a
  RedPajama-like cut at hidden 80, 4 heads (D = 20, sequential residual,
  full rotary);
- greedy tokens of the paged engine equal the JAX paged engine's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlc_llm_tpu.engine import GenerationConfig as JGen
from mlc_llm_tpu.engine import InferenceEngine as JEngine
from mlc_llm_tpu.models import forward as jforward
from mlc_llm_tpu.models import get_config as jget_config
from mlc_llm_tpu.models import init_random_params as jinit
from mlc_llm_tpu.models import paged_cache as jpc
from mlc_llm_tpu.quant.groupwise import QuantizedTensor as JQT
from mlc_llm_tpu.quant.groupwise import pad_quantized_groups as jpad
from mlc_llm_tpu_torch.engine import GenerationConfig, InferenceEngine
from mlc_llm_tpu_torch.models import forward, init_kv_cache
from mlc_llm_tpu_torch.models import paged_cache as tpc
from mlc_llm_tpu_torch.models.convert import params_from_jax, tensor_from_numpy
from mlc_llm_tpu_torch.ops.paged_attention import paged_flash_decode

torch.set_num_threads(2)

_jforward = jax.jit(jforward, static_argnames=("cfg",))
JDT = {"float32": jnp.float32, "float16": jnp.float16, "bfloat16": jnp.bfloat16,
       "int8": jnp.int8}
TDT = {"float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16,
       "int8": torch.int8}


def _t(a):
    return None if a is None else tensor_from_numpy(np.asarray(a))


# ------------------------------------------------------------ kernel 7

@pytest.mark.parametrize("rep", [1, 2])
@pytest.mark.parametrize("pages", ["float32", "float16", "bfloat16", "int8"])
@pytest.mark.parametrize("qdt", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("D", [16, 20, 32])
def test_paged_flash_decode_plain_matches_pallas(D, qdt, pages, rep):
    rng = np.random.default_rng(D + 7 * rep)
    ps, Hq, L, P = 8, 4, 2, 16
    Hkv = Hq // rep
    hb = jpc.default_head_block(Hkv)
    G = Hkv // hb
    shape = (G, L, P, ps, hb * D)
    ks = vs = None
    if pages == "int8":
        kp, vp = (rng.integers(-127, 127, shape).astype(np.int8) for _ in range(2))
        ks = (rng.random((G, L, P, hb, ps)) * 0.02 + 0.001).astype(np.float32)
        vs = (rng.random((G, L, P, ps, hb)) * 0.02 + 0.001).astype(np.float32)
    else:
        kp, vp = (np.asarray(jnp.asarray(rng.standard_normal(shape), JDT[pages]))
                  for _ in range(2))
    table = np.array([[3, 5, 1, 9], [2, 8, 4, 0]], np.int32)
    q = np.asarray(jnp.asarray(rng.standard_normal((2, Hq, 1, D)), JDT[qdt]))
    lens = np.array([19, 8], np.int32)  # mid-page; the second slot's last page partly valid
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    want = jpc.paged_flash_decode(j(q), j(kp), j(vp), j(ks), j(vs), j(table), j(lens),
                                  jnp.int32(1), num_pages_window=4, head_dim=D,
                                  interpret=True)
    before = paged_flash_decode.launches
    got = paged_flash_decode(_t(q), _t(kp), _t(vp), _t(ks), _t(vs), _t(table), _t(lens), 1,
                             num_pages_window=4, head_dim=D)
    assert paged_flash_decode.launches == before  # CPU tensors: the plain version
    assert got.dtype == TDT[qdt] and want.dtype == JDT[qdt]
    tol = 1e-5 if pages == qdt == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# ------------------------------------------------------------- forward

def _cfg(name):
    if name == "d20":  # RedPajama's block at hidden 80, 4 heads: D = 20
        return jget_config("tiny-gpt_neox").replace(
            name="tiny-gpt_neox-d20", hidden_size=80, rotary_pct=1.0, parallel_residual=False)
    return jget_config(name)


def _params(name, quant, seed):
    cfg = _cfg(name)
    jp = jinit(cfg, quant, seed=seed)
    jp = jax.tree.map(lambda x: jpad(x) if isinstance(x, JQT) else x, jp,
                      is_leaf=lambda x: isinstance(x, JQT))
    return cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("quant,kv,tol", [("q4f32", "float32", 1e-4),
                                          ("q4f16_hs", "float16", 5e-2)])
@pytest.mark.parametrize("name", ["tiny-gpt_neox", "tiny-moss", "d20"])
def test_paged_forward_matches_jax_and_slot(name, quant, kv, tol):
    cfg, jp, tp = _params(name, quant, seed=3)
    assert cfg.head_dim == (20 if name == "d20" else 16)
    table = np.zeros((2, 8), np.int32)
    table[0, :4], table[1, :4] = [3, 7, 1, 12], [5, 2, 9, 4]
    jc = jpc.init_paged_kv_cache(cfg, 2, 16, 8, 8, dtype=JDT[kv])
    jc = jpc.PagedKVCache(k_pages=jc.k_pages, v_pages=jc.v_pages, page_table=jnp.asarray(table),
                          lengths=jc.lengths, k_scale=jc.k_scale, v_scale=jc.v_scale)
    tc = tpc.init_paged_kv_cache(cfg, 2, 16, 8, 8, dtype=TDT[kv], device="cpu")
    tc.set_page_table(table)
    sc = init_kv_cache(cfg, 2, 64, dtype=TDT[kv], device="cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    # a right-padded prefill (9 real tokens in slot 1), then 7 decode steps
    # crossing the page boundary at position 16
    jl, jc = _jforward(jp, cfg, jnp.asarray(toks), jc, seq_lens=jnp.asarray([10, 9]))
    tl, tc = forward(tp, cfg, torch.from_numpy(toks).long(), tc, seq_lens=[10, 9])
    sl, sc = forward(tp, cfg, torch.from_numpy(toks).long(), sc, seq_lens=[10, 9])
    for i in range(8):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol, rtol=0)
        np.testing.assert_allclose(tl.numpy(), sl.numpy(), atol=tol, rtol=0)
        if i == 7:
            break
        nxt = np.array([[i + 3], [i + 5]], np.int32)
        jl, jc = _jforward(jp, cfg, jnp.asarray(nxt), jc)
        tl, tc = forward(tp, cfg, torch.from_numpy(nxt).long(), tc)
        sl, sc = forward(tp, cfg, torch.from_numpy(nxt).long(), sc)
    assert tc.lengths.tolist() == np.asarray(jc.lengths).tolist() == [17, 16]


@pytest.mark.parametrize("name", ["tiny-gpt_neox", "tiny-moss", "d20"])
def test_paged_engine_greedy_matches_jax(name):
    cfg, jp, tp = _params(name, "q4f32", seed=0)
    gen = dict(max_new_tokens=6, temperature=0.0)
    prompts = [[1, 2, 3, 4, 5], [7, 8]]
    want = JEngine(cfg, jp, max_batch=2, max_seq_len=64, kv_layout="paged",
                   page_size=8).generate(prompts, JGen(**gen))
    paged = InferenceEngine(cfg, tp, max_batch=2, max_seq_len=64, kv_layout="paged",
                            page_size=8, device="cpu")
    assert paged.generate(prompts, GenerationConfig(**gen)) == want
    assert paged.decode_forwards == 5  # max_new_tokens - 1 after the prefill's token
