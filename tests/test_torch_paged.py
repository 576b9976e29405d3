"""The port's paged KV cache, int8 KV and kernel 7's plain version against
the JAX package.

Same inputs, made with numpy, go through both packages. Tolerances:
- the paged writes and the int8 KV codes are bit-equal;
- kernel 7's plain version against JAX's Pallas kernel in interpret
  mode: 1e-5 with f32 pages (the same f32 arithmetic, summed in another
  order), 2e-2 with int8 pages (as tests/test_paged_kv.py: q is rounded
  to bf16 for the int8 score dot);
- logits against JAX's paged forward: 1e-5 at f32 params, 5e-2 at
  q4bf16 (the port's CPU path rounds like the TPU kernels,
  tests/test_torch_model.py) and with int8 KV (the port's decode rounds q
  to bf16 for the int8 dot where JAX's CPU gather path does not).
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
from mlc_llm_tpu.models import transformer as jtf
from mlc_llm_tpu.quant.groupwise import QuantizedTensor as JQT
from mlc_llm_tpu.quant.groupwise import pad_quantized_groups as jpad
from mlc_llm_tpu_torch.engine import GenerationConfig, InferenceEngine
from mlc_llm_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
from mlc_llm_tpu_torch.models import forward, get_config, init_kv_cache, init_random_params
from mlc_llm_tpu_torch.models import paged_cache as tpc
from mlc_llm_tpu_torch.models import transformer as ttf
from mlc_llm_tpu_torch.models.convert import params_from_jax, tensor_from_numpy
from mlc_llm_tpu_torch.ops.paged_attention import paged_flash_decode

torch.set_num_threads(2)

_jforward = jax.jit(jforward, static_argnames=("cfg",))
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


def _t(a):
    return tensor_from_numpy(np.asarray(a))


# ------------------------------------------------------------ kernel 7

@pytest.mark.parametrize("dtype,rep,lengths,window", [
    ("float32", 1, [19, 8], 4),    # mid-page
    ("int8", 1, [19, 8], 4),
    ("float32", 2, [15, 16], 4),   # the last position of a page, the first of the next
    ("int8", 2, [31, 0], 4),       # the window's last position; a length-0 slot
    ("float32", 1, [23, 7], 3),    # num_pages_window < maxp
])
def test_paged_flash_decode_plain_matches_pallas(dtype, rep, lengths, window):
    rng = np.random.default_rng(7)
    D, ps, Hq, L, P = 16, 8, 4, 2, 16
    Hkv = Hq // rep
    hb = jpc.default_head_block(Hkv)
    G = Hkv // hb
    shape = (G, L, P, ps, hb * D)
    if dtype == "int8":
        kp, vp = (rng.integers(-127, 127, shape).astype(np.int8) for _ in range(2))
        ks = (rng.random((G, L, P, hb, ps)) * 0.02 + 0.001).astype(np.float32)
        vs = (rng.random((G, L, P, ps, hb)) * 0.02 + 0.001).astype(np.float32)
    else:
        kp, vp = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
        ks = vs = None
    table = np.array([[3, 5, 1, 9], [2, 8, 4, 0]], np.int32)
    q = rng.standard_normal((2, Hq, 1, D)).astype(np.float32)
    lens = np.array(lengths, np.int32)
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    want = jpc.paged_flash_decode(jnp.asarray(q), j(kp), j(vp), j(ks), j(vs), jnp.asarray(table),
                                  jnp.asarray(lens), jnp.int32(1), num_pages_window=window,
                                  head_dim=D, interpret=True)
    t = lambda a: None if a is None else _t(a)  # noqa: E731
    before = paged_flash_decode.launches
    got = paged_flash_decode(_t(q), _t(kp), _t(vp), t(ks), t(vs), _t(table), _t(lens), 1,
                             num_pages_window=window, head_dim=D)
    assert paged_flash_decode.launches == before  # CPU tensors: the plain version
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol)


# -------------------------------------------------------------- writes

@pytest.mark.parametrize("start,S", [
    ([13, 7], 1),    # decode, mid-page
    ([6, 13], 4),    # unaligned appends across a page boundary
    ([40, 50], 32),  # padded buckets overrunning the table's capacity
], ids=["decode", "unaligned-append", "padded-overrun"])
def test_paged_writes_bit_equal_jax(start, S):
    rng = np.random.default_rng(11)
    G, hb, D, L, P, ps, maxp = 2, 2, 4, 2, 20, 8, 8
    H, B, l = G * hb, 2, 1
    table = np.stack([rng.permutation(np.arange(1, 10))[:maxp],
                      rng.permutation(np.arange(10, 19))[:maxp]]).astype(np.int32)
    st = np.array(start, np.int32)
    pages = rng.standard_normal((G, L, P, ps, hb * D)).astype(np.float32)
    ksc = rng.standard_normal((G, L, P, hb, ps)).astype(np.float32)
    vsc = rng.standard_normal((G, L, P, ps, hb)).astype(np.float32)
    new_k = rng.standard_normal((B, H, S, D)).astype(np.float32)
    new_v = rng.standard_normal((B, H, D, S)).astype(np.float32)
    new_s = rng.standard_normal((B, H, S)).astype(np.float32)
    jt, js, jl = jnp.asarray(table), jnp.asarray(st), jnp.int32(l)
    cases = [
        (jpc.write_tokens_paged_k, tpc.write_tokens_paged_k, pages, new_k),
        (jpc.write_tokens_paged_v, tpc.write_tokens_paged_v, pages, new_v),
        (jpc.write_scales_paged_k, tpc.write_scales_paged_k, ksc, new_s),
        (jpc.write_scales_paged_v, tpc.write_scales_paged_v, vsc, new_s),
    ]
    for jfn, tfn, buf, new in cases:
        want = np.asarray(jfn(jnp.asarray(buf), jnp.asarray(new), jl, jt, js))
        got = tfn(torch.from_numpy(buf.copy()), torch.from_numpy(new), l,
                  torch.from_numpy(table), torch.from_numpy(st))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=jfn.__name__)
        assert not np.array_equal(want, buf)  # the case wrote something


def test_quantize_kv_bit_equal_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 5, 16)).astype(np.float32) * rng.choice(
        [1e-3, 1.0, 40.0], size=(2, 3, 5, 1)).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row: the 1e-8 clamp
    x[1, 1, 1, :4] = [127.0, -63.5, 0.5, -1.5]  # exact halves: round half to even
    for xs in (x, x.astype(jnp.bfloat16)):
        jq, js = jtf._quantize_kv(jnp.asarray(xs))
        tq, ts = ttf._quantize_kv(_t(xs))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        xt = np.swapaxes(np.asarray(xs), 2, 3)
        jq, js = jtf._quantize_kv_t(jnp.asarray(xt))
        tq, ts = ttf._quantize_kv_t(_t(xt))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# ------------------------------------------------------------- forward

def _jparams(quant, seed):
    cfg = jget_config("tiny-llama")
    jp = jinit(cfg, quant, seed=seed)
    jp = jax.tree.map(lambda x: jpad(x) if isinstance(x, JQT) else x, jp,
                      is_leaf=lambda x: isinstance(x, JQT))
    return cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("quant,kv,tol", [
    ("f32", "float32", 1e-5), ("q4bf16", "bfloat16", 5e-2), ("f32", "int8", 5e-2),
])
def test_paged_forward_matches_jax(quant, kv, tol):
    cfg, jp, tp = _jparams(quant, seed=2)
    table = np.zeros((2, 8), np.int32)
    table[0, :4], table[1, :4] = [3, 7, 1, 12], [5, 2, 9, 4]
    jc = jpc.init_paged_kv_cache(cfg, 2, 16, 8, 8, dtype=JDT[kv])
    jc = jpc.PagedKVCache(k_pages=jc.k_pages, v_pages=jc.v_pages, page_table=jnp.asarray(table),
                          lengths=jc.lengths, k_scale=jc.k_scale, v_scale=jc.v_scale)
    tc = tpc.init_paged_kv_cache(cfg, 2, 16, 8, 8, dtype=TDT[kv], device="cpu")
    tc.set_page_table(table)
    sc = init_kv_cache(cfg, 2, 64, dtype=TDT[kv], device="cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
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


def test_paged_engine_greedy_matches_jax_and_slot():
    cfg, jp, tp = _jparams("f32", seed=0)
    gen = dict(max_new_tokens=6, temperature=0.0)
    prompts = [[1, 2, 3, 4, 5], [7, 8]]
    want = JEngine(cfg, jp, max_batch=2, max_seq_len=64, kv_layout="paged",
                   page_size=8).generate(prompts, JGen(**gen))
    paged = InferenceEngine(cfg, tp, max_batch=2, max_seq_len=64, kv_layout="paged",
                            page_size=8, device="cpu")
    slot = InferenceEngine(cfg, tp, max_batch=2, max_seq_len=64, device="cpu")
    assert paged.generate(prompts, GenerationConfig(**gen)) == want
    assert slot.generate(prompts, GenerationConfig(**gen)) == want
    assert paged.decode_forwards == 5  # max_new_tokens - 1 after the prefill's token


def test_kv_layout_auto_rule():
    cfg = get_config("tiny-llama")
    params = init_random_params(cfg, "f32", seed=0, device="cpu")

    def layout(**kw):
        return InferenceEngine(cfg, params, max_seq_len=64, kv_layout="auto", page_size=8,
                               device="cpu", **kw).kv_layout

    assert layout(max_batch=2, cache_dtype=torch.int8) == "paged"
    assert layout(max_batch=1, cache_dtype=torch.int8) == "slot"
    assert layout(max_batch=2) == "slot"


# ------------------------------------------------- allocator, prefix cache

def test_allocator():
    alloc = tpc.PageAllocator(8)
    assert alloc.free_pages == 7  # page 0 reserved
    a = alloc.alloc(3)
    assert len(set(a)) == 3 and 0 not in a
    assert not alloc.can_alloc(5)
    alloc.ref(a[:1])
    alloc.free(a)
    assert alloc.free_pages == 6  # a[0] still referenced
    alloc.free(a[:1])
    assert alloc.free_pages == 7
    with pytest.raises(ValueError, match="double free"):
        alloc.free(a[:1])
    with pytest.raises(MemoryError):
        alloc.alloc(8)


@pytest.fixture(scope="module")
def tiny():
    cfg = get_config("tiny-llama")
    return cfg, init_random_params(cfg, "f32", seed=0, device="cpu")


def _prefix_sched(tiny, prefix_pages=64, num_pages=61, prefill_chunk=None):
    cfg, params = tiny
    eng = InferenceEngine(cfg, params, max_batch=2, max_seq_len=64, kv_layout="paged",
                          page_size=8, num_pages=num_pages, prefix_cache_pages=prefix_pages,
                          device="cpu")
    return eng, ContinuousBatchingScheduler(eng, prefill_chunk=prefill_chunk)


def _no_cache_outputs(tiny, prompts, gen):
    cfg, params = tiny
    ref = ContinuousBatchingScheduler(InferenceEngine(
        cfg, params, max_batch=2, max_seq_len=64, kv_layout="paged", page_size=8, device="cpu"))
    want = [ref.submit(p, gen) for p in prompts]
    ref.run()
    return [w.output for w in want]


@pytest.mark.parametrize("chunk", [None, 16], ids=["whole", "chunked"])
def test_prefix_cache_reuses_pages_exactly(tiny, chunk):
    eng, sched = _prefix_sched(tiny, prefill_chunk=chunk)
    gen = GenerationConfig(max_new_tokens=5, temperature=0.0)
    system = [int(t) for t in np.random.default_rng(4).integers(1, 200, size=24)]
    tail = [int(t) for t in np.random.default_rng(6).integers(1, 200, size=20)]
    prompts = [system + [7, 8, 9], system + tail, system + [7, 8, 9]]
    got = []
    for p in prompts:  # sequential, so each admission can hit the last insert
        got.append(sched.submit(p, gen))
        sched.run()
    assert [g.output for g in got] == _no_cache_outputs(tiny, prompts, gen)
    assert eng.prefix_cache.hits >= 2
    assert got[1].start_len == 24 and got[1].prefix_tokens == system
    assert eng.stats.prefill_tokens < sum(len(p) for p in prompts)


def test_prefix_cache_refcounts_survive_slot_recycling(tiny):
    eng, sched = _prefix_sched(tiny)
    gen = GenerationConfig(max_new_tokens=4, temperature=0.0)
    system = list(range(2, 26))  # 24 tokens = 3 pages
    for i in range(4):  # more requests than slots: recycling
        sched.submit(system + [30 + i], gen)
    sched.run()
    held = eng.prefix_cache.pages_held
    assert held > 0
    assert eng.allocator.free_pages == eng.num_pages - 1 - held
    eng.prefix_cache.clear()
    assert eng.allocator.free_pages == eng.num_pages - 1


def test_prefix_cache_evicts_under_pool_pressure(tiny):
    eng, sched = _prefix_sched(tiny, num_pages=19)  # 18 usable; ~5 per request
    gen = GenerationConfig(max_new_tokens=4, temperature=0.0)
    rng = np.random.default_rng(9)
    reqs = []
    for _ in range(4):
        reqs.append(sched.submit([int(t) for t in rng.integers(1, 200, size=26)], gen))
        sched.run()
    assert all(r.done and len(r.output) > 0 for r in reqs)
    assert eng.prefix_cache.pages_held <= 18
