"""The traffic generator: deterministic per seed, within the mix's ranges,
and the same work for every seed in another order."""

import collections

import numpy as np
import pytest

from conftest import ROOT


def _mix(name):
    from harness import spec

    return spec.load_cell(ROOT, name).mix


@pytest.mark.parametrize("name", ["dolly3b-q4f16hs.serve-chat"])
def test_open_schedule_is_deterministic_and_in_range(name):
    from harness import traffic

    mix = _mix(name)
    a = traffic.open_schedule(mix, 2**31 + 7, 20.0, 50280)
    b = traffic.open_schedule(mix, 2**31 + 7, 20.0, 50280)
    assert [(r.due, r.prompt, r.max_new, r.temperature, r.seed) for r in a] == \
        [(r.due, r.prompt, r.max_new, r.temperature, r.seed) for r in b]
    pr, out = mix["prompt_tokens"], mix["output_tokens"]
    assert all(pr["min"] <= len(r.prompt) <= pr["max"] for r in a)
    assert all(out["min"] <= r.max_new <= out["max"] for r in a)
    assert all(0 <= t < 50280 for r in a for t in r.prompt)
    dues = [r.due for r in a]
    assert dues == sorted(dues) and dues[0] == -mix["preroll_s"]
    rate = mix["rate_rps"]
    parts = [round(rate * mix["preroll_s"]), round(rate * 20.0), round(rate * mix["tail_s"])]
    assert len(a) == sum(parts)
    # exactly rate x 20 requests due in the window, whatever the seed
    assert sum(1 for d in dues if 0 <= d < 20.0) == parts[1]
    greedy = sum(r.greedy for r in a)
    assert greedy == sum(round(mix["sampling"]["greedy_share"] * n) for n in parts)


def test_open_schedule_same_work_other_order():
    from harness import traffic

    mix = _mix("dolly3b-q4f16hs.serve-chat")
    a = traffic.open_schedule(mix, 11, 20.0, 50280)
    b = traffic.open_schedule(mix, 2**31 + 12, 20.0, 50280)
    win = lambda s: [r for r in s if 0 <= r.due < 20.0]
    assert sorted(len(r.prompt) for r in win(a)) == sorted(len(r.prompt) for r in win(b))
    assert sorted(r.max_new for r in win(a)) == sorted(r.max_new for r in win(b))
    # the window's arrivals start at 0 and its gaps fill it up to the next
    # stretch's first arrival at 20
    gaps = lambda s: sorted(np.diff([r.due for r in win(s)] + [20.0]))
    assert win(a)[0].due == 0.0 and np.allclose(gaps(a), gaps(b))
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]
    assert a[0].prompt[:8] != b[0].prompt[:8]


def test_open_arrivals_bunch_as_a_poisson_stream_does():
    """The window's arrivals counted in bins of 4.25 s spread as Poisson
    counts do (variance / mean about 1; a stream dealt evenly reads about
    0), and some bins hold bursts of a third again the mean or more."""
    from harness import traffic

    mix = _mix("dolly3b-q4f16hs.serve-chat")
    disp, peak = [], []
    for seed in range(40):
        due = [r.due for r in traffic.open_schedule(mix, 2**31 + seed, 51.0, 50280)]
        c = np.histogram([d for d in due if 0 <= d < 51.0], bins=np.linspace(0, 51.0, 13))[0]
        disp.append(c.var(ddof=1) / c.mean())
        peak.append(c.max() / c.mean())
    assert 0.75 <= float(np.mean(disp)) <= 1.25
    assert max(peak) >= 1.3


def test_dealt_blocks_hold_one_value_of_each_stratum():
    from harness import traffic

    x = traffic.dealt(np.arange(48), 4, np.random.default_rng(3))
    assert sorted(x.tolist()) == list(range(48))
    for i in range(0, 48, 4):
        assert sorted(v // 12 for v in x[i:i + 4]) == [0, 1, 2, 3]


def test_chat_schedule_is_deterministic_and_in_range():
    from harness import traffic

    mix = _mix("moss16b-q4bf16.chat-b1")
    a = traffic.chat_schedule(mix, 5, 107008)
    b = traffic.chat_schedule(mix, 5, 107008)
    c = traffic.chat_schedule(mix, 6, 107008)
    flat = lambda s: [(len(t.user), t.answer, t.temperature, t.seed) for ss in s for t in ss]
    assert flat(a) == flat(b) and flat(a) != flat(c)
    assert len(a) == mix["pool_sessions"]
    lo, hi = mix["turns_per_session"]["min"], mix["turns_per_session"]["max"]
    assert all(lo <= len(s) <= hi for s in a)
    ft, ut, an = mix["first_turn_tokens"], mix["user_turn_tokens"], mix["answer_tokens"]
    assert all(ft["min"] <= len(s[0].user) <= ft["max"] for s in a)
    assert all(ut["min"] <= len(t.user) <= ut["max"] for s in a for t in s[1:])
    assert all(an["min"] <= t.answer <= an["max"] for s in a for t in s)
    assert collections.Counter(len(s) for s in a) == collections.Counter(len(s) for s in c)


def test_quantile_set_medians():
    from harness import traffic

    x = traffic.quantile_set({"dist": "lognormal", "median": 384, "sigma": 0.7, "min": 32,
                              "max": 1536}, 1001)
    assert x[500] == 384 and x.min() >= 32 and x.max() <= 1536
    u = traffic.quantile_set({"dist": "uniform", "min": 1024, "max": 1900}, 100)
    assert u.min() >= 1024 and u.max() <= 1900 and abs(np.median(u) - 1462) <= 5
