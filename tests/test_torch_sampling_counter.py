"""The counter-based sampler (``ops/sampling.py``) and the programs that
draw with it, on the CPU.

A row's draw is a function of (seed, step) alone: Philox-4x32-10 of the
counter (step, 0, 0, 0) under the key (seed, 0), then the inverse CDF of
the top-k / top-p-masked probabilities. These tests hold Philox to the
Random123 known-answer vectors, the draws to the masked softmax by a
chi-square test (fixed seeds, p > 1e-3), a row's token to its (seed,
step) whatever its place and the batch's other rows, T < 1e-6 to argmax,
and a K-step block (one program) to K single steps token for token,
sampled rows included, in the engine and in the scheduler.
"""

import numpy as np
import pytest
import torch
from scipy import stats

from mlc_llm_tpu_torch.engine import GenerationConfig, InferenceEngine
from mlc_llm_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
from mlc_llm_tpu_torch.models import get_config, init_random_params
from mlc_llm_tpu_torch.ops.sampling import philox4x32, sample_token_perslot

torch.set_num_threads(2)

M = 0xFFFFFFFF


def test_philox_matches_known_answers():
    # Random123's kat_vectors for philox4x32_10: (counter, key) -> output
    kat = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
           ((M, M, M, M), (M, M), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
           ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    ctr = torch.tensor([c for c, _, _ in kat]).T
    key = torch.tensor([k for _, k, _ in kat]).T
    assert philox4x32(ctr, key).T.tolist() == [list(w) for _, _, w in kat]


def _masked_probs(row, temperature, top_p, top_k):
    """The nucleus distribution in float64: softmax of row / T, the top_k
    prefilter, then the smallest descending prefix whose mass reaches
    top_p (the crossing token kept), renormalized."""
    z = row.astype(np.float64) / temperature
    p = np.exp(z - z.max())
    p /= p.sum()
    order = np.argsort(-p, kind="stable")
    if top_k:
        order = order[:top_k]
    keep = (np.cumsum(p[order]) - p[order]) < top_p
    out = np.zeros_like(p)
    out[order[keep]] = p[order[keep]]
    return out / out.sum()


@pytest.mark.parametrize("top_k", [0, 8])
def test_draws_follow_the_masked_softmax(top_k):
    n, V = 20000, 32
    row = np.random.default_rng(3).standard_normal(V).astype(np.float32) * 1.5
    want = _masked_probs(row, 0.8, 0.9, top_k)
    lg = torch.from_numpy(row).expand(n, V)
    got = sample_token_perslot(lg, torch.full((n,), 12345), torch.arange(n),
                               torch.full((n,), 0.8), torch.full((n,), 0.9), top_k)
    counts = np.bincount(got.numpy(), minlength=V)
    kept = want > 0
    assert counts[~kept].sum() == 0 and kept.sum() > 2
    chi = stats.chisquare(counts[kept], want[kept] * n)
    assert chi.pvalue > 1e-3, (chi, counts[kept], want[kept] * n)


def test_draw_depends_only_on_seed_and_step():
    rng = np.random.default_rng(4)
    lg = torch.from_numpy(rng.standard_normal((6, 200)).astype(np.float32))
    seeds, steps = torch.tensor([7, 7, 8, 9, 2**32 - 1, 0]), torch.tensor([0, 1, 0, 5, 3, 9])
    temps, top_p = torch.full((6,), 1.2), torch.full((6,), 0.97)
    base = sample_token_perslot(lg, seeds, steps, temps, top_p)
    # another order of the rows, and other rows beside row 2
    perm = torch.tensor([3, 5, 0, 2, 4, 1])
    moved = sample_token_perslot(lg[perm], seeds[perm], steps[perm], temps, top_p)
    assert torch.equal(moved, base[perm])
    mixed = lg.clone()
    mixed[[0, 1, 3]] = torch.from_numpy(rng.standard_normal((3, 200)).astype(np.float32))
    other = temps.clone()
    other[4] = 0.0
    got = sample_token_perslot(mixed, seeds, steps, other, top_p)
    assert got[2] == base[2] and got[5] == base[5]
    # a row's stream moves with its step and its seed
    draws = {int(sample_token_perslot(lg[:1], seeds[:1], torch.tensor([s]), temps[:1],
                                      top_p[:1])[0]) for s in range(20)}
    assert len(draws) > 3


def test_greedy_below_threshold():
    lg = torch.from_numpy(np.random.default_rng(5).standard_normal((4, 64)).astype(np.float32))
    lg[1, 9] = lg[1, 40] = lg[1].max() + 1.0  # a tie: the first index wins
    temps = torch.tensor([0.0, 1e-7, 9e-7, 0.0])
    got = sample_token_perslot(lg, torch.arange(4), torch.arange(4), temps,
                               torch.full((4,), 0.95))
    assert torch.equal(got, lg.argmax(-1)) and got[1] == 9


def _engine(layout, params, cfg):
    kw = dict(kv_layout="paged", page_size=8) if layout == "paged" else {}
    return InferenceEngine(cfg, params, max_batch=3, max_seq_len=64, device="cpu", **kw)


@pytest.fixture(scope="module")
def tiny():
    cfg = get_config("tiny-llama")
    return cfg, init_random_params(cfg, "q4bf16", seed=0, device="cpu")


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_k_step_block_equals_single_steps(tiny, layout):
    # tolerance 0: the block's K forwards and draws are the single steps'
    cfg, params = tiny
    block, single = _engine(layout, params, cfg), _engine(layout, params, cfg)
    prompts = [[3, 9, 27, 81, 17], [7, 1, 4], [5, 5]]
    for e in (block, single):
        e.prefill(prompts, reserve_tokens=12)
    active = np.array([True, True, False])  # slot 2 frozen
    seeds, steps = np.array([11, 12, 13]), np.array([1, 4, 0])
    temps = np.array([0.9, 0.0, 0.7], np.float32)  # slot 0 sampled, slot 1 greedy
    tok = torch.tensor([[2], [6], [8]])
    got = block._decode_sample_k(tok, active, seeds, steps, temps, 0.95, attn_window=32,
                                 k_steps=4)
    want = []
    for i in range(4):
        want.append(single._decode_sample(tok if i == 0 else want[-1][:, None], active, seeds,
                                          steps + i, temps, 0.95, attn_window=32))
    assert torch.equal(got, torch.stack(want))
    assert got[:, 2].tolist() == [8] * 4  # the frozen slot keeps its token
    assert torch.equal(block.cache.lengths, single.cache.lengths)
    names = ("k_pages", "v_pages") if layout == "paged" else ("k", "v")
    assert all(torch.equal(getattr(block.cache, n), getattr(single.cache, n)) for n in names)
    # the reset prefill's flash flag is set on the slot layout only
    assert block.programs.runs == {("prefill", 3, 16, 16, layout == "slot"): 1,
                                   ("decode_k", 3, 4, 32): 1}


def test_scheduler_multi_step_streams_equal_single_steps(tiny):
    # K-step blocks (adaptive and static) change when tokens are read
    # back, never which: greedy and sampled requests alike
    cfg, params = tiny
    work = [([1 + i, 2 + i, 3 + i], GenerationConfig(max_new_tokens=9, temperature=0.8 * (i % 2),
                                                      seed=i)) for i in range(5)]
    outs = []
    for kw in ({}, {"multi_step": 4}, {"multi_step": "auto:4"}):
        eng = _engine("paged", params, cfg)
        sched = ContinuousBatchingScheduler(eng, seed=0, **kw)
        reqs = [sched.submit(p, g) for p, g in work]
        sched.run()
        outs.append([r.output for r in reqs])
        kinds = eng.programs.runs_by_kind()
        assert ("decode_k" in kinds) == bool(kw) and kinds["sample"] == len(work)
    assert outs[0] == outs[1] == outs[2]
    assert any(len(set(o)) > 1 for o in outs[0])
