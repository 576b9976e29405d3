"""The port's prompt-lookup speculative decoding on the CPU.

The cases of tests/test_speculative.py on the port: acceptance keeps a
draft token only when it equals the verify pass's own argmax, and on the
CPU the verify pass (m = K) and the decode step (m = 1) run the same
plain versions, so the speculative stream must equal plain greedy decode
token for token, and the host lengths after every turn must equal
plain's. The same seed-built f32 parameters go through the JAX package's
generate_speculative and the port's: streams, passes and accepted drafts
must be equal. On q4bf16 (the kernels' plain versions) the stream is
held against the no-draft stream, the reference the card uses: the same
passes with a drafter that proposes nothing.
"""

import jax
import numpy as np
import pytest
import torch

from mlc_llm_tpu.engine import InferenceEngine as JEngine
from mlc_llm_tpu.engine.speculative import generate_speculative as jgenerate_speculative
from mlc_llm_tpu.models import get_config as jget_config
from mlc_llm_tpu.models import init_random_params as jinit
from mlc_llm_tpu_torch.engine import GenerationConfig, InferenceEngine
from mlc_llm_tpu_torch.engine import speculative
from mlc_llm_tpu_torch.engine.session import ChatConfig, ChatSession
from mlc_llm_tpu_torch.engine.speculative import (
    NgramDrafter,
    generate_speculative,
    rtt_gate_ok,
)
from mlc_llm_tpu_torch.models import forward, forward_verify, get_config, init_random_params
from mlc_llm_tpu_torch.models.convert import params_from_jax
from mlc_llm_tpu_torch.tokenizer import ByteTokenizer

torch.set_num_threads(2)

CFG = get_config("tiny-llama")
MOTIF = [5, 6, 7, 5, 6, 7, 5, 6, 7, 5, 6]  # repetitive: drafts accepted
ARBITRARY = [11, 3, 19, 42, 7, 23, 2, 31]  # drafts rejected


@pytest.fixture(autouse=True)
def _force_gate(monkeypatch):
    # the streams are under test here; the RTT gate has its own tests
    monkeypatch.setenv("MLC_SPEC_FORCE", "1")


@pytest.fixture(scope="module")
def params():
    return init_random_params(CFG, "f32", seed=0, device="cpu")


def _engine(params, max_seq_len=128, **kw):
    return InferenceEngine(CFG, params, max_batch=1, max_seq_len=max_seq_len, device="cpu",
                           **kw)


def _greedy(n, **kw):
    return GenerationConfig(max_new_tokens=n, temperature=0.0, **kw)


def _lengths(eng):
    return int(eng.cache.lengths[0])


class _NoDraft(NgramDrafter):
    def propose(self, k):
        return []


def test_ngram_drafter():
    d = NgramDrafter([1, 2, 3, 9, 1, 2, 3])
    # suffix [1, 2, 3] recurs at position 0; the continuation was [9, 1, 2]
    assert d.propose(3) == [9, 1, 2]
    d.extend([7])
    assert d.propose(2) == []  # suffix ..., 3, 7 never seen before
    # single-token fallback: last occurrence of 3 -> followed by 9
    assert NgramDrafter([3, 9, 5, 3], max_ngram=1).propose(1) == [9]


@pytest.mark.parametrize("prompt", [MOTIF, ARBITRARY], ids=["motif", "arbitrary"])
@pytest.mark.parametrize("draft_k", [4, 8])
def test_speculative_matches_plain_greedy(params, prompt, draft_k):
    eng = _engine(params)
    want = eng.generate([prompt], _greedy(24))[0]
    len_p = _lengths(eng)
    stats = {}
    got = generate_speculative(eng, prompt, max_new_tokens=24, draft_k=draft_k, stats=stats)
    assert got == want, (stats, got, want)
    assert _lengths(eng) == len_p
    # never more passes than plain decode would take steps
    assert 1 <= stats["passes"] <= len(got)
    assert stats["tokens"] == len(got)


def test_speculative_accepts_on_cycled_output(params):
    """Random-weight greedy output settles into a cycle; once the cycle is
    in the history the drafter's tokens are accepted."""
    eng = _engine(params)
    want = eng.generate([[5, 6, 7]], _greedy(48))[0]
    assert len(set(want)) < len(want)  # the output repeats tokens
    stats = {}
    got = generate_speculative(eng, [5, 6, 7], max_new_tokens=48, draft_k=8, stats=stats)
    assert got == want
    assert stats["passes"] < len(got) and stats["accepted_drafts"] > 0, stats


def test_speculative_matches_greedy_at_window_edge(params):
    """Generation limited by max_seq_len: the passes shrink to K = 1 near
    the edge instead of stopping K tokens early."""
    eng = _engine(params, max_seq_len=64)
    prompt = [5, 6, 7, 5, 6, 7, 5, 6, 7, 5]
    want = eng.generate([prompt], _greedy(100))[0]
    stats = {}
    got = generate_speculative(eng, prompt, max_new_tokens=100, draft_k=8, stats=stats)
    assert got == want, (len(got), len(want), stats)
    # the edge's S = 1 passes
    assert any(k[0] == "verify" and k[2] == 1 for k in eng.programs.keys)


def test_speculative_reuses_programs(params):
    """The verify programs live on the engine: a second call with the
    same shapes asks for no new program key (JAX: no new compile)."""
    eng = _engine(params, max_seq_len=64)
    generate_speculative(eng, [5, 6, 7, 5, 6, 7], max_new_tokens=8, draft_k=4)
    progs, keys = eng._speculative_programs, set(eng.programs.keys)
    verify = {k for k in keys if k[0] == "verify"}
    assert verify and all(k[:3] == ("verify", 1, 4) for k in verify)
    assert {k[0] for k in keys - verify} == {"prefill"}  # the prompt's prefill program
    generate_speculative(eng, [5, 6, 7, 5, 6, 7], max_new_tokens=8, draft_k=4)
    assert eng._speculative_programs is progs and eng.programs.keys == keys


def _session(params, spec_k):
    eng = _engine(params, max_seq_len=128)  # tiny-llama's rotary table
    chat = ChatConfig(temperature=0.0, max_gen_len=16, mean_gen_len=16, max_window_size=128,
                      seed=1)
    return ChatSession(eng, ByteTokenizer(), CFG, chat, conv_template="vicuna_v1.1",
                       speculative_k=spec_k), eng


def test_session_speculative_matches_plain(params):
    """ChatSession(speculative_k=4) gives the plain session's replies and
    lengths over two turns (the second appends), with drafts accepted."""
    (plain, eng_p), (spec, eng_s) = _session(params, None), _session(params, 4)
    passes = []
    orig = eng_s.verify
    eng_s.verify = lambda toks, w: passes.append(toks.shape[1]) or orig(toks, w)
    for turn in ("Hi hi hi hi hi", "More please more please"):
        assert spec.ask(turn) == plain.ask(turn)
        assert _lengths(eng_s) == _lengths(eng_p)
    assert passes and eng_s.stats.decode_tokens == eng_p.stats.decode_tokens


def test_session_respects_the_rtt_gate(params, monkeypatch):
    monkeypatch.delenv("MLC_SPEC_FORCE")
    monkeypatch.setenv("MLC_SPEC_RTT_GATE_MS", "-1")  # no round trip is that fast
    spec, eng_s = _session(params, 4)
    called = []
    monkeypatch.setattr(spec, "_speculative_tokens", lambda *a: called.append(1))
    reply = spec.ask("Hi hi hi hi hi")
    assert not called and eng_s._spec_rtt_ok is False and eng_s.verify_forwards == 0
    assert reply == _session(params, None)[0].ask("Hi hi hi hi hi")


def test_rtt_gate_measures_once_per_engine(params, monkeypatch):
    monkeypatch.delenv("MLC_SPEC_FORCE")
    eng = _engine(params)
    assert rtt_gate_ok(eng, threshold_ms=1e6) is True
    assert rtt_gate_ok(eng, threshold_ms=-1.0) is True  # cached on the engine
    assert rtt_gate_ok(_engine(params), threshold_ms=-1.0) is False
    monkeypatch.setenv("MLC_SPEC_FORCE", "1")
    assert rtt_gate_ok(_engine(params), threshold_ms=-1.0) is True


def test_speculative_multiturn_append_matches_plain(params):
    """Turn 1 is capped mid-pass (accepted drafts beyond the cap are not
    kept in the KV), then turn 2 appends: streams and lengths equal
    plain's in both turns."""
    prompt = [5, 6, 7] * 3
    eng_p, eng_s = _engine(params), _engine(params)
    want1 = eng_p.generate([prompt], _greedy(12))[0]
    stats = {}
    got1 = generate_speculative(eng_s, prompt, max_new_tokens=12, draft_k=4, stats=stats)
    assert got1 == want1 and stats["accepted_drafts"] > 0
    assert _lengths(eng_s) == _lengths(eng_p)
    turn2 = [9, 9, 5, 6, 7]
    want2 = eng_p.generate([turn2], _greedy(12), reset=False)[0]
    got2 = generate_speculative(eng_s, turn2, max_new_tokens=12, draft_k=4, reset=False)
    assert got2 == want2
    assert _lengths(eng_s) == _lengths(eng_p)


@pytest.mark.parametrize("prompt, stop_at, stop_is_draft", [
    ([5, 6, 7] * 3, 3, False),
    ([5, 6, 7] * 3, 6, False),
    # the prompt holds the output's cycle, so the stop is an accepted draft
    ([5, 6, 7] * 3 + [23, 164, 112, 253, 112], 1, True),
], ids=["model-token-3", "model-token-6", "accepted-draft"])
def test_speculative_stop_token_matches_plain(params, prompt, stop_at, stop_is_draft):
    """A stop token hit mid-pass leaves the lengths where the plain loop
    leaves them (its dispatch-ahead feeds the stop token): a stop that
    was an accepted draft is already written, the model's own is fed by
    an S = 1 pass."""
    base = _engine(params).generate([prompt], _greedy(12))[0]
    stop_tok = base[stop_at]
    eng_p, eng_s = _engine(params), _engine(params)
    want = eng_p.generate([prompt], _greedy(12, stop_tokens=(stop_tok,)))[0]
    stats = {}
    got = generate_speculative(eng_s, prompt, max_new_tokens=12, draft_k=4,
                               stop_tokens={stop_tok}, stats=stats)
    assert got == want and len(got) < 12
    assert _lengths(eng_s) == _lengths(eng_p)
    fed = any(k[2] == 1 for k in eng_s.programs.keys)
    assert fed != stop_is_draft and (stats["accepted_drafts"] > 0 or not stop_is_draft)


def test_speculative_matches_plain_int8_kv(params):
    """int8 KV: the per-token absmax quantization is the same whether an
    S = K pass or an S = 1 step writes the token."""
    prompt = [5, 6, 7] * 3
    eng_p = _engine(params, cache_dtype=torch.int8)
    want = eng_p.generate([prompt], _greedy(16))[0]
    eng_s = _engine(params, cache_dtype=torch.int8)
    stats = {}
    got = generate_speculative(eng_s, prompt, max_new_tokens=16, draft_k=4, stats=stats)
    assert got == want, (got, want, stats)
    assert _lengths(eng_s) == _lengths(eng_p)


@pytest.fixture(scope="module")
def jax_pair():
    jcfg = jget_config("tiny-llama")
    jp = jinit(jcfg, "f32", seed=0)
    return jcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("prompt", [MOTIF, ARBITRARY], ids=["motif", "arbitrary"])
@pytest.mark.parametrize("draft_k", [4, 8])
def test_speculative_matches_jax_package(jax_pair, prompt, draft_k):
    jcfg, jp, tp = jax_pair
    jstats, stats = {}, {}
    want = jgenerate_speculative(JEngine(jcfg, jp, max_batch=1, max_seq_len=128), prompt,
                                 max_new_tokens=24, draft_k=draft_k, stats=jstats)
    got = generate_speculative(_engine(tp), prompt, max_new_tokens=24, draft_k=draft_k,
                               stats=stats)
    assert got == [int(t) for t in want]
    assert stats == jstats, (stats, jstats)


def test_q4bf16_speculative_matches_no_draft_stream(monkeypatch):
    """q4bf16 on the kernels' plain versions (the verify pass's layer
    matmuls at m = K on gemv_qs): the stream equals the no-draft stream,
    the card's reference, and so does every host length."""
    qp = init_random_params(CFG, "q4bf16", seed=0, device="cpu")
    prompt = [5, 6, 7] * 4
    eng_s = _engine(qp)
    stats = {}
    got = generate_speculative(eng_s, prompt, max_new_tokens=32, draft_k=8, stats=stats)
    monkeypatch.setattr(speculative, "NgramDrafter", _NoDraft)
    eng_n = _engine(qp)
    nstats = {}
    want = generate_speculative(eng_n, prompt, max_new_tokens=32, draft_k=8, stats=nstats)
    assert got == want and _lengths(eng_s) == _lengths(eng_n)
    assert nstats["accepted_drafts"] == 0 and nstats["passes"] == len(want) - 1
    assert stats["accepted_drafts"] > 0 and stats["passes"] < nstats["passes"]


def test_forward_verify_writes_the_block_and_advances_nothing(params):
    """forward_verify at the device lengths equals forward over the same
    block with seq_lens 0 (every position's logits), writes the same K/V
    and leaves both lengths where they were; the paged cache raises."""
    eng_a, eng_b = _engine(params), _engine(params)
    for e in (eng_a, eng_b):
        e.prefill([[3, 4, 5, 6, 7]])
    toks = torch.tensor([[8, 9, 10, 11]])
    eng_a.cache.lengths_dev.copy_(eng_a.cache.lengths)
    got = forward_verify(eng_a.params, CFG, toks, eng_a.cache, attn_window=16)
    want, _ = forward(eng_b.params, CFG, toks, eng_b.cache, seq_lens=[0], last_only=False,
                      attn_window=16)
    assert got.shape == (1, 4, CFG.vocab_size) and torch.equal(got, want)
    assert torch.equal(eng_a.cache.k, eng_b.cache.k) and torch.equal(eng_a.cache.v, eng_b.cache.v)
    assert int(eng_a.cache.lengths[0]) == int(eng_a.cache.lengths_dev[0]) == 5
    paged = InferenceEngine(CFG, params, max_batch=1, max_seq_len=64, kv_layout="paged",
                            page_size=8, device="cpu")
    with pytest.raises(ValueError, match="slot"):
        forward_verify(paged.params, CFG, toks, paged.cache)
    with pytest.raises(ValueError, match="slot"):
        paged.verify(np.zeros((1, 4), np.int64), 16)
