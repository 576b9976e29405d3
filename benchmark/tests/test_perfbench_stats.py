"""Tails and rates are taken over all requests and the whole window, and a
stall inside the window moves them."""

import math

import numpy as np
import pytest



def test_percentile_matches_numpy():
    from harness import stats

    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 150, 1000):
        x = rng.exponential(size=n).tolist()
        for q in (50, 90, 95):
            assert stats.percentile(x, q) == pytest.approx(float(np.percentile(x, q)))
    assert stats.percentile([], 90) is None


def test_failed_requests_raise_the_tail():
    from harness import stats

    ok = [0.1] * 95
    assert stats.percentile(ok + [math.inf] * 5, 90) == pytest.approx(0.1)
    assert stats.percentile(ok[:85] + [math.inf] * 15, 90) == math.inf


def _ctx(served, start=0.0, end=10.0):
    from harness import readers, spec
    from harness.loops import Window
    from harness.record import Recorder
    import torch

    win = Window(start, end, served, {})
    dense = spec.load_arch("dense")
    shapes = dense.Shapes(hidden=64, ffn=256, layers=2, heads=4, kv_heads=4, head_dim=16,
                          vocab=256, gated=False, act_dtype="bfloat16",
                          head_dtype="bfloat16", kv_dtype="bfloat16")
    return readers.Context(cell=None, window=win, seconds=end - start, setup_s=1.0,
                           rec=Recorder(False, torch.device("cpu")), trace=None, shapes=shapes,
                           batch=1, on_card=False)


def _served(due, first, gap, n, done=True):
    from harness.loops import Served

    s = Served(due=due, prompt_len=8, context=0, asked=n, greedy=False)
    s.times = [first + i * gap for i in range(n)]
    s.tokens = list(range(n))
    s.done = done
    return s


def _steady(stall_at=None, stall=0.0):
    """One request due every 0.1 s for 10 s; each answered 50 ms after it is
    due, then 20 tokens 10 ms apart; from stall_at everything is `stall`
    seconds later."""
    served = []
    for i in range(100):
        due = 0.1 * i
        shift = stall if stall_at is not None and due >= stall_at else 0.0
        served.append(_served(due, due + 0.05 + shift, 0.01, 20))
    return served


def test_rate_is_over_the_whole_window():
    from harness import readers

    ctx = _ctx(_steady())
    # tokens with times in [0, 10): every request's 20 tokens but the tail's
    want = sum(1 for s in ctx.window.served for t in s.times if 0 <= t < 10) / 10.0
    assert readers.out_tok_s(ctx) == pytest.approx(want)
    assert readers.out_tok_s(_ctx(_steady(), end=20.0)) < want


def test_a_stall_moves_the_rate_and_the_tail():
    from harness import readers, stats

    base = _ctx(_steady())
    stalled = _ctx(_steady(stall_at=8.0, stall=1.5))
    assert readers.out_tok_s(stalled) < readers.out_tok_s(base)
    p90 = lambda c: stats.percentile(readers.ttft_s(c), 90)
    assert p90(base) == pytest.approx(0.05)
    assert p90(stalled) > 1.0
    # the time from due, not from submission or admission
    assert min(readers.ttft_s(base)) == pytest.approx(0.05)


def test_unfinished_requests_enter_tails_as_infinite():
    from harness import readers, stats

    served = _steady()
    for s in served[:20]:
        s.times, s.done = [], False
    ctx = _ctx(served)
    assert stats.percentile(readers.ttft_s(ctx), 90) == math.inf
    assert stats.percentile(readers.tpot_s(ctx), 90) == math.inf
    assert len(readers.ttft_s(ctx)) == 100


def test_tpot():
    from harness import readers

    ctx = _ctx([_served(0.0, 0.2, 0.015, 11)])
    assert readers.tpot_s(ctx) == [pytest.approx(0.015)]


def test_tails_before_the_traced_stretch_keep_failures():
    from harness import readers

    served = _steady()
    served[3].error, served[3].done = "RuntimeError()", False
    ctx = _ctx(served)
    # the requests whose last token came before 5.0, and the failed one
    before = readers.ttft_s(ctx, before=5.0)
    ended = [s for s in served if s.error is None and s.times[-1] < 5.0]
    assert len(before) == len(ended) + 1 and math.inf in before
    assert len(readers.tpot_s(ctx, before=5.0)) == len(ended) + 1
    assert len(readers.ttft_s(ctx)) == 100
