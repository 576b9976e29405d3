"""The port's decode step program (``engine/programs.py``) on the CPU.

On a CUDA engine every decode step replays one captured graph; on the
CPU the same step function runs eagerly through the same fixed buffers.
These tests hold that function against the engine's decode path as it
was before the step became a program (``forward`` on the host lengths,
then ``sample_token_perslot`` at the same (seed, step)), bit for bit:
both run the same plain kernels in the same order, so logits, tokens
and the KV cache agree exactly (tolerance 0). They also hold the pieces that make the step
capturable: the step reads no host mirror, the device write index and
the batched slot scatter equal the host index and the per-slot loop,
and a repeated workload asks for no new step program. Greedy tokens
are held against the JAX engine on the same f32 weights.
"""

import jax
import numpy as np
import pytest
import torch

from mlc_llm_tpu.engine import GenerationConfig as JGen
from mlc_llm_tpu.engine import InferenceEngine as JEngine
from mlc_llm_tpu.models import get_config as jget_config
from mlc_llm_tpu.models import init_random_params as jinit
from mlc_llm_tpu_torch.engine import GenerationConfig, InferenceEngine
from mlc_llm_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
from mlc_llm_tpu_torch.models import forward, get_config, init_kv_cache, init_random_params
from mlc_llm_tpu_torch.models import paged_cache as tpc
from mlc_llm_tpu_torch.models.convert import params_from_jax
from mlc_llm_tpu_torch.models.transformer import (
    _attend_slot,
    _quantize_kv,
    _quantize_kv_t,
    slot_write_index,
)
from mlc_llm_tpu_torch.ops.attention import attend_cache
from mlc_llm_tpu_torch.ops.sampling import sample_token_perslot

torch.set_num_threads(2)

KV = {"slot-bf16": ("slot", torch.bfloat16), "slot-int8": ("slot", torch.int8),
      "paged-bf16": ("paged", torch.bfloat16), "paged-int8": ("paged", torch.int8)}
QUANT = {"tiny-llama": "q4bf16", "tiny-gpt_neox": "q4f32"}


def _engine(model, kv):
    layout, dtype = KV[kv]
    cfg = get_config(model)
    params = init_random_params(cfg, QUANT[model], seed=0, device="cpu")
    return InferenceEngine(cfg, params, max_batch=2, max_seq_len=64, cache_dtype=dtype,
                           kv_layout=layout, page_size=8, device="cpu")


def _cache_tensors(cache):
    names = ("k_pages", "v_pages", "page_table") if hasattr(cache, "k_pages") else ("k", "v")
    out = {n: getattr(cache, n) for n in names + ("k_scale", "v_scale", "lengths")}
    return {n: t for n, t in out.items() if t is not None}


def _eager_step(eng, tokens, active, seeds, steps, temps, top_p, window):
    """The decode step as the engine ran it before it became a step
    program: forward from the host lengths, then the per-slot sampler."""
    logits, eng.cache = forward(eng.params, eng.cfg, tokens, eng.cache,
                                seq_lens=torch.from_numpy(active.astype(np.int64)),
                                attn_window=window)
    t = torch.from_numpy(np.where(active, temps, 0.0).astype(np.float32))
    nxt = sample_token_perslot(logits, torch.tensor(seeds), torch.tensor(steps), t,
                               torch.full(t.shape, top_p), 64)
    return logits, torch.where(torch.from_numpy(active), nxt, tokens[:, 0])


@pytest.mark.parametrize("kv", list(KV))
@pytest.mark.parametrize("model", list(QUANT))
def test_step_program_matches_eager_forward(model, kv):
    # tolerance 0: the same plain kernels on the same values in both
    eng, ref = _engine(model, kv), _engine(model, kv)
    prompts = [[3, 9, 27, 81, 17, 5, 12], [7, 1, 4]]
    for e in (eng, ref):
        e.prefill(prompts, reserve_tokens=8)
    seen = []
    run = eng.programs.run
    eng.programs.run = lambda *a: seen.append(run(*a)) or seen[-1]
    seeds = np.array([5, 9])
    active = np.array([True, False])  # slot 1 frozen
    tok = torch.tensor([[11], [13]])
    frozen = int(eng.cache.lengths[1])
    for step, temp in enumerate((0.0, 0.0, 0.8)):
        temps = np.array([temp, 0.7], np.float32)
        steps = np.array([step, step])
        got = eng._decode_sample(tok, active, seeds, steps, temps, 0.9, attn_window=16,
                                 top_k=64)
        want_logits, want = _eager_step(ref, tok, active, seeds, steps, temps, 0.9, 16)
        assert torch.equal(seen[-1][0], want_logits), step
        assert torch.equal(got, want), step
        assert int(got[1]) == 13 and int(eng.cache.lengths[1]) == frozen
        tok = got[:, None]
    # a K-step block against K eager steps at steps 3 and 4
    temps = np.array([0.8, 0.0], np.float32)
    block = eng._decode_sample_k(tok, active, seeds, np.array([3, 3]), temps, 0.9,
                                 attn_window=32, k_steps=2)
    for i in range(2):
        _, want = _eager_step(ref, tok, active, seeds, np.array([3 + i] * 2), temps, 0.9, 32)
        assert torch.equal(block[i], want)
        tok = want[:, None]
    a, b = _cache_tensors(eng.cache), _cache_tensors(ref.cache)
    assert a.keys() == b.keys() and all(torch.equal(a[n], b[n]) for n in a)
    assert int(eng.cache.lengths[0]) == len(prompts[0]) + 5
    assert eng.decode_forwards == 5
    assert {k for k in eng.programs.keys if k[0].startswith("decode")} == {
        ("decode", 2, 16), ("decode_k", 2, 2, 32)}


@pytest.mark.parametrize("kv", ["slot-bf16", "paged-int8"])
def test_step_reads_no_host_mirror(kv):
    # tolerance 0: one step of two identical engines, one with its host
    # mirrors poisoned after staging
    engs = [_engine("tiny-llama", kv), _engine("tiny-llama", kv)]
    outs = []
    for poison, eng in zip((False, True), engs):
        eng.prefill([[3, 9, 27, 81, 17], [7, 1, 4, 2]], reserve_tokens=8)
        active = np.array([True, True])
        eng._stage_decode(torch.tensor([[11], [13]]), active, [1, 2], [0, 0], 0.8, 0.9)
        lengths = eng.cache.lengths.clone()
        if poison:
            eng.cache.lengths[:] = 10_000
            if kv.startswith("paged"):
                eng._table_np[:] = 999
        logits, nxt = eng.programs.run(*eng._program(("decode", 2, 16)))
        outs.append((logits.clone(), nxt.clone(), eng.cache.lengths_dev.clone()))
        eng.cache.lengths.copy_(lengths)
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert outs[0][2].tolist() == [6, 5]  # the device lengths advanced
    a, b = _cache_tensors(engs[0].cache), _cache_tensors(engs[1].cache)
    assert all(torch.equal(a[n], b[n]) for n in a)


@pytest.mark.parametrize("lengths", [[13, 7, 0], [63, 64, 8], [40, 16, 23]],
                         ids=["mid-page", "at-capacity", "page-starts"])
def test_device_write_index_matches_host(lengths):
    # tolerance 0: integer indices. The host rule of a decode write (S ==
    # 1): the page column clamped to the table's last, every token written
    rng = np.random.default_rng(1)
    table = rng.permutation(np.arange(1, 40))[:24].reshape(3, 8).astype(np.int32)
    pos = np.array(lengths)
    pid = table[np.arange(3), np.minimum(pos // 8, 7)].astype(np.int64)
    want = torch.from_numpy(pid * 8 + pos % 8)
    got = tpc.paged_write_index(torch.from_numpy(table), torch.tensor(lengths), 1, 8)
    assert torch.equal(got.flat, want)
    hh = np.arange(2)
    kidx = ((pid[:, None] * 2 + hh[None]) * 8 + (pos % 8)[:, None]).reshape(-1)
    assert torch.equal(got.k_scale_index(2), torch.from_numpy(kidx))


def _old_slot_write(cache, l, k, v, starts):
    """The per-slot write loop the batched scatter replaced."""
    B, S = k.shape[:2]
    smax = cache.max_len
    kt, vt = k.transpose(1, 2), v.permute(0, 2, 3, 1)
    ks = vs = None
    if cache.k.dtype == torch.int8:
        kt, ks = _quantize_kv(kt)
        vt, vs = _quantize_kv_t(vt)
    for b in range(B):
        st = min(starts[b], smax - S)
        cache.k[l, b, :, st:st + S] = kt[b].to(cache.k.dtype)
        cache.v[l, b, :, :, st:st + S] = vt[b].to(cache.v.dtype)
        if ks is not None:
            cache.k_scale[l, b, :, st:st + S] = ks[b]
            cache.v_scale[l, b, :, st:st + S] = vs[b]


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8], ids=["bf16", "int8"])
def test_batched_slot_scatter_matches_loop(dtype, S):
    # tolerance 0: copies of the same values; slot 2 starts at the cache's
    # end, where the start is clamped to smax - S
    cfg = get_config("tiny-llama")
    g = torch.Generator().manual_seed(0)
    H, D, smax, l = cfg.num_kv_heads, cfg.head_dim, 32, 1
    starts = [5, 29, 32]
    q, k, v = (torch.randn((3, S, H, D), generator=g).to(torch.bfloat16) for _ in range(3))
    new, old = (init_kv_cache(cfg, 3, smax, dtype=dtype, device="cpu") for _ in range(2))
    start_dev = torch.tensor(starts)
    out = _attend_slot(q, k, v, new, l, slot_write_index(start_dev, S, smax), start_dev, None,
                       None)
    _old_slot_write(old, l, k, v, starts)
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(new, name), getattr(old, name)
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b)), name
    ksc = vsc = None
    if dtype == torch.int8:
        ksc, vsc = old.k_scale[l], old.v_scale[l]
    want = attend_cache(q.transpose(1, 2), old.k[l], old.v[l], ksc, vsc, start_dev)
    assert torch.equal(out, want)
    assert int(new.k[l, 2, :, smax - S:].abs().sum()) > 0  # the clamped block landed


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_repeated_workload_asks_no_new_step_program(layout):
    # the counterpart of tests/test_compile_guard.py: after a warm-up, an
    # identical generate (greedy and sampled) and scheduler run add no key
    eng = _engine("tiny-llama", f"{layout}-bf16")
    greedy = GenerationConfig(max_new_tokens=6, temperature=0.0)
    sampled = GenerationConfig(max_new_tokens=6, temperature=0.8, seed=7)
    prompts = [[1, 2, 3], [4, 5]]

    def workload():
        eng.generate(prompts, greedy)
        eng.generate(prompts, sampled)
        sched = ContinuousBatchingScheduler(eng)
        sched.submit([1, 2, 3], GenerationConfig(max_new_tokens=5, temperature=0.0))
        sched.run()

    workload()
    keys = set(eng.programs.keys)
    assert {k[0] for k in keys} == {"prefill", "prefill_slots", "sample", "decode"}
    assert all(k[:2] == ("decode", 2) for k in keys if k[0] == "decode")
    workload()
    assert eng.programs.keys == keys
    assert eng.precompile() == 0 and eng.programs.count == 0  # the CPU captures nothing


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_greedy_tokens_match_jax_engine(layout):
    # f32 weights; prompts of 12 and 5 tokens and 10 new tokens cross the
    # 16-token window bucket, so two decode programs run
    jcfg = jget_config("tiny-llama")
    jp = jinit(jcfg, "f32", seed=1)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    kw = dict(max_batch=2, max_seq_len=64)
    if layout == "paged":
        kw.update(kv_layout="paged", page_size=8)
    prompts = [[int(t) for t in np.random.default_rng(4).integers(3, 256, 12)], [7, 8, 9, 10, 11]]
    want = JEngine(jcfg, jp, **kw).generate(prompts, JGen(max_new_tokens=10, temperature=0.0))
    eng = InferenceEngine(get_config("tiny-llama"), tp, device="cpu", **kw)
    got = eng.generate(prompts, GenerationConfig(max_new_tokens=10, temperature=0.0))
    assert got == want
    assert {k[2] for k in eng.programs.keys if k[0] == "decode"} == {16, 32}
