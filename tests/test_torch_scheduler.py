"""The port's continuous-batching scheduler and session scheduler mode.

The behaviours of tests/test_scheduler.py on the port, on the CPU:
greedy streams are compared exactly between scheduler configurations
of the same engine (same kernels' plain versions, same rounding). One
test holds a paged scheduler's greedy streams against the JAX
scheduler's on the same f32 parameters.
"""

import jax
import numpy as np
import pytest
import torch

from mlc_llm_tpu.engine import GenerationConfig as JGen
from mlc_llm_tpu.engine import InferenceEngine as JEngine
from mlc_llm_tpu.engine.scheduler import ContinuousBatchingScheduler as JSched
from mlc_llm_tpu.models import get_config as jget_config
from mlc_llm_tpu.models import init_random_params as jinit
from mlc_llm_tpu_torch.engine import GenerationConfig, InferenceEngine
from mlc_llm_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
from mlc_llm_tpu_torch.engine.session import ChatConfig, ChatSession
from mlc_llm_tpu_torch.models import get_config, init_random_params
from mlc_llm_tpu_torch.models.convert import params_from_jax
from mlc_llm_tpu_torch.ops.sampling import sample_token_perslot

torch.set_num_threads(2)

CFG = get_config("tiny-llama")


@pytest.fixture(scope="module")
def params():
    return init_random_params(CFG, "f32", seed=0, device="cpu")


def _engine(params, layout="slot", **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_seq_len", 64)
    if layout == "paged":
        kw.setdefault("page_size", 8)
    return InferenceEngine(CFG, params, kv_layout=layout, device="cpu", **kw)


def _greedy(n, **kw):
    return GenerationConfig(max_new_tokens=n, temperature=0.0, **kw)


def _solo(params, prompt, gen, max_seq_len=64):
    return _engine(params, max_batch=1, max_seq_len=max_seq_len).generate([prompt], gen)[0]


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_single_request_matches_plain_generate(params, layout):
    eng = _engine(params, layout)
    sched = ContinuousBatchingScheduler(eng)
    seen = []
    req = sched.submit([5, 6, 7], _greedy(6), on_token=seen.append)
    sched.run()
    assert req.done and req.output == seen
    assert req.output == eng.generate([[5, 6, 7]], _greedy(6))[0]
    assert req.ttft is not None and req.finished_at >= req.first_token_at


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_more_requests_than_slots(params, layout):
    eng = _engine(params, layout)
    sched = ContinuousBatchingScheduler(eng)
    prompts = [[i + 1, i + 2, i + 3] for i in range(10)]  # 10 requests, 4 slots
    reqs = [sched.submit(p, _greedy(5)) for p in prompts]
    sched.run()
    for p, r in zip(prompts, reqs):
        assert r.done and r.output == _solo(params, p, _greedy(5))
    if layout == "paged":
        assert eng.allocator.free_pages == eng.num_pages - 1  # pool fully recycled


def test_paged_scheduler_matches_jax_scheduler():
    jcfg = jget_config("tiny-llama")
    jp = jinit(jcfg, "f32", seed=1)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    prompts = [[int(t) for t in np.random.default_rng(i).integers(1, 200, n)]
               for i, n in enumerate((3, 20, 9))]
    jeng = JEngine(jcfg, jp, max_batch=2, max_seq_len=64, kv_layout="paged", page_size=8)
    js = JSched(jeng)
    want = [js.submit(p, JGen(max_new_tokens=5, temperature=0.0)) for p in prompts]
    js.run()
    sched = ContinuousBatchingScheduler(_engine(tp, "paged", max_batch=2))
    got = [sched.submit(p, _greedy(5)) for p in prompts]
    sched.run()
    assert [g.output for g in got] == [w.output for w in want]


def test_grouped_admission_engages_and_matches_solo(params):
    eng = _engine(params)
    sched = ContinuousBatchingScheduler(eng)
    calls = []
    orig = eng._prefill_slots

    def spy(toks, lens, slots, **kw):
        calls.append(len(slots))
        return orig(toks, lens, slots, **kw)

    eng._prefill_slots = spy
    prompts = [[i + 1, i + 2, i + 3] for i in range(4)]
    reqs = [sched.submit(p, _greedy(5)) for p in prompts]
    sched.run()
    assert calls == [4]  # one grouped prefill of 4
    for p, r in zip(prompts, reqs):
        assert r.output == _solo(params, p, _greedy(5))


def test_grouped_admission_sampled_seed_parity(params):
    def gen(seed):
        return GenerationConfig(max_new_tokens=6, temperature=0.8, top_p=0.9, seed=seed)

    s1 = ContinuousBatchingScheduler(_engine(params))
    a1, b1 = s1.submit([5, 6, 7], gen(11)), s1.submit([9, 8, 7], gen(22))
    s1.run()
    s2 = ContinuousBatchingScheduler(_engine(params))
    a2 = s2.submit([5, 6, 7], gen(11))
    s2.step()  # single path: the group scan needs two requests
    b2 = s2.submit([9, 8, 7], gen(22))
    s2.run()
    assert (a1.output, b1.output) == (a2.output, b2.output)


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_chunked_prefill_matches_whole_prompt(params, layout):
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(1, CFG.vocab_size, size=n)] for n in (45, 30, 7)]

    def run(chunk):
        s = ContinuousBatchingScheduler(_engine(params, layout, max_batch=2),
                                        prefill_chunk=chunk)
        reqs = [s.submit(p, _greedy(5)) for p in prompts]
        s.run()
        return [r.output for r in reqs]

    assert run(16) == run(None)


def test_chunked_prefill_cancel_frees_pages(params):
    eng = _engine(params, "paged", max_batch=2)
    sched = ContinuousBatchingScheduler(eng, prefill_chunk=16)
    free0 = eng.allocator.free_pages
    r = sched.submit(list(range(2, 50)), _greedy(4))
    sched.step()  # the first chunk is in; still prefilling
    assert r.slot in sched._prefilling
    sched.cancel(r)
    assert r.done and r.slot not in sched._prefilling
    assert eng.allocator.free_pages == free0
    r2 = sched.submit([1, 2, 3], _greedy(4))
    sched.run()
    assert r2.done and len(r2.output) > 0


def test_chunked_prefill_rejects_non_bucket(params):
    with pytest.raises(ValueError):
        ContinuousBatchingScheduler(_engine(params, max_batch=1), prefill_chunk=24)


def test_speculative_raises_with_roadmap_item(params):
    with pytest.raises(NotImplementedError, match="item 5"):
        ContinuousBatchingScheduler(_engine(params), speculative_k=4)


@pytest.mark.parametrize("gen", [
    _greedy(9),
    GenerationConfig(max_new_tokens=7, temperature=0.8, top_p=0.9, seed=5),
    _greedy(11, stop_tokens=tuple(range(0, 200, 3))),  # stops inside blocks
], ids=["greedy", "sampled", "stops"])
def test_multi_step_and_decode_ahead_outputs_identical(params, gen):
    prompts = [[3, 4, 5], [6, 7], [8, 9, 10, 11], [12], [13, 14, 15]]

    def run(layout="slot", **kw):
        s = ContinuousBatchingScheduler(_engine(params, layout, max_batch=2), **kw)
        reqs = [s.submit(p, gen) for p in prompts]
        s.run()
        assert all(r.done for r in reqs)
        return [r.output for r in reqs]

    base = run()
    assert run(decode_ahead=3) == base
    assert run(multi_step=4) == base
    assert run(multi_step=3, decode_ahead=2) == base
    assert run(multi_step="auto:4") == base
    # the paged layout against itself: its decode sums the softmax page
    # by page, so its logits differ from the slot path's in the last bits
    # and a sampled draw near a threshold may go the other way
    assert run("paged", multi_step=4, decode_ahead=2) == run("paged")


def test_adaptive_multi_step_choose_k(params):
    eng = _engine(params)
    s = ContinuousBatchingScheduler(eng, multi_step="auto:8")
    assert s.adaptive_multi_step and s.multi_step == 8
    s.submit([3, 4, 5], _greedy(4))
    s._admit()
    assert s._choose_k() is None  # 1/4 occupancy: single step
    for p in ([6, 7], [8, 9], [10, 11]):
        s.submit(p, _greedy(4))
    s._admit()
    assert s._choose_k() == 8  # full occupancy
    s.submit([12, 13], _greedy(4))
    s._admit()
    assert s.pending and s._choose_k() == 8  # backlog: full K
    s.run()
    s2 = ContinuousBatchingScheduler(eng, multi_step="auto:8")
    for p in ([3, 4], [5, 6], [7, 8]):
        s2.submit(p, _greedy(4))
    s2._admit()
    assert s2._choose_k() == 4  # 3/4 occupancy: 8*3//4 = 6 -> 4
    s2.run()


def test_dispatch_budget_prunes_dead_blocks(params):
    eng = _engine(params)
    sched = ContinuousBatchingScheduler(eng, multi_step=4, decode_ahead=2)
    rows = []
    orig_k, orig_1 = eng._decode_sample_k, eng._decode_sample

    def spy_k(*a, **kw):
        rows.append(kw["k_steps"])
        return orig_k(*a, **kw)

    eng._decode_sample_k = spy_k
    gen = _greedy(8)
    # prompts whose greedy streams run the full 8 tokens (no stop token)
    prompts = [[i + 1, i + 2, i + 3] for i in (4, 5, 6, 7)]
    reqs = [sched.submit(p, gen) for p in prompts]
    sched.run()
    single = eng.decode_forwards - sum(rows)  # forwards outside K-blocks
    assert all(r.done and len(r.output) == 8 for r in reqs)
    # the first token comes from prefill; 7 decode rows are needed, with
    # one block of slack for the gate
    assert sum(rows) + single <= 8 + 4, (rows, single)
    eng._decode_sample_k, eng._decode_sample = orig_k, orig_1
    for p, r in zip(prompts, reqs):
        assert r.output == _solo(params, p, gen)


def test_paged_pool_backpressure(params):
    eng = _engine(params, "paged", num_pages=13)  # ~2 sequences' pages
    sched = ContinuousBatchingScheduler(eng)
    reqs = [sched.submit(list(range(2, 40)), _greedy(4)) for _ in range(4)]
    sched.step()
    assert 0 < sched.num_active < 4  # backpressure kept some pending
    sched.run()
    assert all(r.done for r in reqs)
    assert eng.allocator.free_pages == eng.num_pages - 1


def test_admission_clamp_keeps_newest_end(params):
    eng = _engine(params)
    sched = ContinuousBatchingScheduler(eng)
    long_prompt = list(range(1, eng.max_seq_len + 30))
    req = sched.submit(long_prompt, _greedy(eng.max_seq_len + 5))
    sched.run()
    assert req.done and len(req.prompt) >= 1
    assert req.prompt == long_prompt[-len(req.prompt):]


def test_sampler_draws_depend_only_on_own_generator():
    """Identical logits rows under different batch compositions give
    identical draws: a row's draw reads only its own generator."""
    row = torch.from_numpy(np.random.default_rng(4).standard_normal(256).astype(np.float32))
    other = torch.from_numpy(np.random.default_rng(5).standard_normal((3, 256)).astype(np.float32))

    def draws(batch, pos, temps, n=6):
        gens = [torch.Generator().manual_seed(100 + i) for i in range(len(batch))]
        gens[pos] = torch.Generator().manual_seed(42)
        return [int(sample_token_perslot(batch, gens, temps, 0.95)[pos]) for _ in range(n)]

    a = draws(row[None], 0, [0.9])
    b = draws(torch.stack([other[0], other[1], row, other[2]]), 2, [0.0, 1.3, 0.9, 0.7])
    c = draws(torch.stack([row, other[0]]), 0, np.array([0.9, 0.0]))
    assert a == b == c


def test_sessions_share_one_scheduler(params):
    class ByteTok:
        def encode(self, s):
            return [b % 50 + 2 for b in s.encode()]

        def decode(self, ids):
            return "".join(chr(i + 64) for i in ids)

    cfg = CFG.replace(max_seq_len=64)
    chat = ChatConfig(temperature=0.0, max_gen_len=5, mean_gen_len=5, max_window_size=64)
    for layout in ("slot", "paged"):
        eng = _engine(params, layout, max_batch=2)
        sched = ContinuousBatchingScheduler(eng)
        s1 = ChatSession(tokenizer=ByteTok(), cfg=cfg, chat=chat, conv_template="vicuna_v1.1",
                         scheduler=sched)
        s2 = ChatSession(tokenizer=ByteTok(), cfg=cfg, chat=chat, conv_template="dolly",
                         scheduler=sched)
        assert s1.slot != s2.slot
        r1a = s1.ask("Hi")
        s2.ask("Yo")
        s1.ask("More")  # turn 2: append-prefill into the same slot
        assert s1.total_len > 0 and s2.total_len > 0
        if layout == "paged":
            assert len(eng._slot_pages[s1.slot]) > 0  # the session kept its pages
        solo = ChatSession(tokenizer=ByteTok(), cfg=cfg, chat=chat,
                           conv_template="vicuna_v1.1",
                           scheduler=ContinuousBatchingScheduler(_engine(params, layout)))
        assert solo.ask("Hi") == r1a
        s1.close()
        s2.close()
        solo.close()
        if layout == "paged":
            assert len(eng._slot_pages[s1.slot]) == 0  # released
