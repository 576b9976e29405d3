"""The engine's trace (``engine/trace.py``) and the always-on counters, on
the CPU: an off trace records nothing; on, ``generate_stream`` and the
scheduler give their span trees with the right parents and ids; the
scheduler's row counters and ``admitted_at`` agree with what the clients
received; the gap split and self times on hand-made intervals and a fake
clock (no CUDA).
"""

import collections

import pytest
import torch

from mlc_llm_tpu_torch.engine import GenerationConfig, InferenceEngine
from mlc_llm_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
from mlc_llm_tpu_torch.engine.trace import (
    OUTSIDE,
    Trace,
    replay_gaps,
    self_segments,
    split_intervals,
)
from mlc_llm_tpu_torch.models import get_config, init_random_params

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


def _greedy(n):
    return GenerationConfig(max_new_tokens=n, temperature=0.0)


def _children(spans, i):
    return [s for s in spans if s.parent == i]


def _names(spans, i):
    return [s.name for s in _children(spans, i)]


def _serve(eng, prompts, n, **kw):
    """Three requests through a scheduler; the tokens each client got."""
    sched = ContinuousBatchingScheduler(eng, **kw)
    got = collections.defaultdict(list)
    reqs = [sched.submit(p, _greedy(n), on_token=got[i].append) for i, p in enumerate(prompts)]
    sched.run()
    return sched, reqs, got


PROMPTS = [[5, 6, 7], [9, 10, 11, 12, 13], [17, 18]]


# ------------------------------------------------------------------ off
def test_off_trace_records_nothing(params):
    eng = _engine(params, max_batch=1)
    tr = eng.trace
    assert not tr.on and tr.span("step") is tr.span("drain") is tr.replay(("decode",))
    list(eng.generate_stream([[5, 6, 7]], _greedy(4)))
    eng2 = _engine(params, "paged")
    _serve(eng2, PROMPTS, 4)
    assert tr.spans == [] and eng2.trace.spans == [] and tr.captures == 0


def test_stop_turns_it_off_and_start_clears(params):
    eng = _engine(params, max_batch=1)
    eng.trace.start()
    list(eng.generate_stream([[5, 6, 7]], _greedy(3)))
    eng.trace.stop()
    n = len(eng.trace.spans)
    assert n > 0
    list(eng.generate_stream([[5, 6, 7]], _greedy(3)))
    assert len(eng.trace.spans) == n  # off again
    eng.trace.start()
    assert eng.trace.spans == []


# --------------------------------------------------------------- span trees
def test_generate_stream_span_tree(params):
    eng = _engine(params, max_batch=1)
    eng.trace.start()
    toks = [t for _, t in eng.generate_stream([[5, 6, 7]], _greedy(5))]
    toks2 = [t for _, t in eng.generate_stream([[8, 9]], _greedy(3))]
    eng.trace.stop()
    sp = eng.trace.spans
    turns = [s for s in sp if s.name == "turn"]
    assert [s.parent for s in turns] == [-1, -1] and turns[0].rid != turns[1].rid
    assert all(s.parent != -1 for s in sp if s.name != "turn")
    for turn, n in zip(turns, (len(toks), len(toks2))):
        kids = _names(sp, turn.index)
        # the prefill, the first draw, then a step a decode step and a last
        # one that only reads the final token back
        assert kids == ["prefill", "sample"] + ["step"] * n
        prefill, sample, *steps = _children(sp, turn.index)
        assert _names(sp, prefill.index) == ["stage", "replay"]
        assert _children(sp, prefill.index)[1].key[0] == "prefill"
        assert _names(sp, sample.index) == ["stage", "replay"]
        assert _children(sp, sample.index)[1].key == ("sample", 1)
        for st in steps[:-1]:
            assert _names(sp, st.index) == ["stage", "replay", "readback", "client"]
            assert _children(sp, st.index)[1].key[0] == "decode"
        assert _names(sp, steps[-1].index) == ["readback", "client"]
    # every span of a turn carries its id, and lies inside its parent
    for s in sp:
        top = s
        while top.parent != -1:
            up = sp[top.parent]
            assert up.start <= s.start and s.end <= up.end
            top = up
        assert s.rid == top.rid
    # the readbacks: the CPU's copies always find their result there
    assert eng.readbacks_landed == len(toks) + len(toks2) and eng.readbacks_blocked == 0


@pytest.mark.parametrize("layout", ["paged", "slot"])
def test_scheduler_span_tree(params, layout):
    eng = _engine(params, layout)
    eng.trace.start()
    sched, reqs, got = _serve(eng, PROMPTS, 5)
    eng.trace.stop()
    sp = eng.trace.spans
    ids = {r.id for r in reqs}
    roots = [s for s in sp if s.parent == -1]
    # scheduler.step, and run()'s last drain
    assert {s.name for s in roots} == {"step", "drain"} and roots[-1].name == "drain"
    admits = [s for s in sp if s.name == "admit"]
    for a in admits:
        assert sp[a.parent].name == "step"
        assert _names(sp, a.index) == ["prefill", "sample"]
        prefill, sample = _children(sp, a.index)
        assert _names(sp, prefill.index) == ["stage", "replay"]
        assert _children(sp, prefill.index)[1].key[0] == "prefill_slots"
        assert _names(sp, sample.index) == ["stage", "replay"]
        assert all(s.rid == a.rid for s in sp if s.parent in (a.index, prefill.index,
                                                               sample.index))
    if layout == "paged":  # one admission a request, under its id
        assert sorted(a.rid for a in admits) == sorted(ids)
    else:  # two fresh requests of one bucket share a grouped admission
        assert [a.rid for a in admits] == [None, 2]
        assert _children(sp, _children(sp, admits[0].index)[0].index)[1].key[1] == 2
    for d in (s for s in sp if s.name == "dispatch"):
        assert sp[d.parent].name == "step" and _names(sp, d.index) == ["stage", "replay"]
        assert _children(sp, d.index)[1].key[0] in ("decode", "decode_k")
        assert d.rid is None
    for d in (s for s in sp if s.name == "drain"):
        assert set(_names(sp, d.index)) <= {"emit"}  # nothing blocks on the CPU
    assert sum(len(v) for v in got.values()) == 15


# ----------------------------------------------------------------- counters
@pytest.mark.parametrize("kw", [{}, {"multi_step": 4}, {"multi_step": "auto:4"},
                                {"decode_ahead": 2}],
                         ids=["plain", "k4", "auto", "ahead2"])
def test_scheduler_row_counters(params, kw):
    eng = _engine(params, "paged")
    sched, reqs, got = _serve(eng, PROMPTS, 7, **kw)
    received = sum(len(v) for v in got.values())
    assert received == sum(len(r.output) for r in reqs) == 21
    # every request's first token comes from its admission, the rest are
    # decode rows
    assert sched.rows_emitted + len(reqs) == received
    assert sched.rows_dispatched == eng.max_batch * eng.decode_forwards
    assert sched.rows_dispatched == sched.rows_emitted + sched.rows_dropped
    assert sched.rows_emitted <= sched.rows_active <= sched.rows_dispatched
    for r in reqs:
        assert r.submitted_at <= r.admitted_at <= r.first_token_at


def test_admitted_at_marks_the_end_of_the_queue_wait(params):
    eng = _engine(params, "paged", max_batch=1)
    sched = ContinuousBatchingScheduler(eng)
    reqs = [sched.submit(p, _greedy(3)) for p in PROMPTS]
    assert all(r.admitted_at is None for r in reqs)
    sched.step()
    assert reqs[0].admitted_at is not None and reqs[1].admitted_at is None
    sched.run()
    # one slot: each request waits for the one before it to finish
    for a, b in zip(reqs, reqs[1:]):
        assert a.finished_at <= b.admitted_at <= b.first_token_at


# -------------------------------------------------------------- clock split
class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _hand_made_trace():
    """step [0, 10) > stage [1, 2), replay [2, 5), readback [6, 9);
    then client [10, 14) alone; replay device intervals [3, 4) and [7, 8)
    and [15, 16)."""
    clock = FakeClock()
    tr = Trace(clock=clock)
    tr.start()
    with tr.span("step", rid=7):
        clock.t = 1.0
        with tr.span("stage"):
            clock.t = 2.0
        with tr.replay(("decode", 1, 16)) as r1:
            clock.t = 5.0
        clock.t = 6.0
        with tr.span("readback"):
            clock.t = 9.0
        clock.t = 10.0
    with tr.span("client"):
        clock.t = 14.0
    clock.t = 15.0
    with tr.replay(("decode", 1, 16)) as r2:
        clock.t = 16.0
    tr.stop()
    # what stop() places from the events on the card, set by hand
    r1.device = (3.0, 4.0)
    r2.device = (15.0, 16.0)
    return tr


def test_self_times_on_a_fake_clock():
    tr = _hand_made_trace()
    assert [(s.name, s.parent, s.rid) for s in tr.spans] == [
        ("step", -1, 7), ("stage", 0, 7), ("replay", 0, 7), ("readback", 0, 7),
        ("client", -1, None), ("replay", -1, None)]
    assert tr.self_times() == {"step": 10.0 - 1.0 - 3.0 - 3.0, "stage": 1.0, "replay": 4.0,
                               "readback": 3.0, "client": 4.0}
    assert tr.self_times(start=4.0, end=12.0) == {"step": 2.0, "stage": 0.0, "replay": 1.0,
                                                  "readback": 3.0, "client": 2.0}
    assert [s.name for s in tr.named("replay", 0.0, 10.0)] == ["replay"]


def test_gap_split_on_a_fake_clock():
    tr = _hand_made_trace()
    assert tr.gaps() == [(4.0, 15.0)]
    # the gap [4, 15): replay 4-5, step 5-6, readback 6-9, step 9-10,
    # client 10-14, nothing 14-15
    assert tr.gap_split() == {"replay": 1.0, "step": 2.0, "readback": 3.0, "client": 4.0,
                              OUTSIDE: 1.0}
    assert tr.gap_split(start=8.0, end=12.0) == {"readback": 1.0, "step": 1.0, "client": 2.0}
    assert tr.device_seconds() == {("decode", 1, 16): (2, 2.0)}
    assert tr.device_seconds(end=10.0) == {("decode", 1, 16): (1, 1.0)}


def test_replay_gaps_merge_overlaps_and_clip():
    dev = [(0.0, 2.0), (1.0, 3.0), (3.0, 4.0), (6.0, 7.0), (6.5, 6.8), (9.0, 10.0)]
    assert replay_gaps(dev) == [(4.0, 6.0), (7.0, 9.0)]
    assert replay_gaps(dev, 5.0, 8.0) == [(5.0, 6.0), (7.0, 8.0)]
    assert replay_gaps([]) == [] and replay_gaps([(1.0, 2.0)]) == []


def test_split_intervals_and_segments_tile():
    segs = [(0.0, 1.0, "a"), (2.0, 3.0, "b"), (3.0, 5.0, "a")]
    assert split_intervals([(0.5, 4.0)], segs) == {"a": 1.5, "b": 1.0, OUTSIDE: 1.0}
    assert split_intervals([(6.0, 7.0)], segs) == {OUTSIDE: 1.0}
    tr = _hand_made_trace()
    pieces = self_segments(tr.spans)
    # the pieces tile the spans' union, [0, 14) and [15, 16), each once
    assert all(a < b for a, b, _ in pieces)
    assert all(p[1] <= q[0] for p, q in zip(pieces, pieces[1:]))
    assert sum(b - a for a, b, _ in pieces) == 15.0


def test_span_left_open_across_start_is_harmless():
    clock = FakeClock()
    tr = Trace(clock=clock)
    tr.start()
    outer = tr.span("turn")
    outer.__enter__()
    tr.start()  # restarted while a span is open
    with tr.span("step"):
        clock.t = 1.0
    outer.__exit__(None, None, None)
    with tr.span("client"):
        clock.t = 2.0
    assert [(s.name, s.parent) for s in tr.spans] == [("step", -1), ("client", -1)]


def test_spans_are_profiler_ranges_while_a_profiler_records(params):
    eng = _engine(params, max_batch=1)
    eng.trace.start()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        list(eng.generate_stream([[5, 6, 7]], _greedy(3)))
    eng.trace.stop()
    names = {e.key for e in prof.key_averages()}
    assert {"mlc/turn", "mlc/prefill", "mlc/step", "mlc/replay", "mlc/readback",
            "mlc/client"} <= names
