"""The per-layer metrics that read the program's own records, and the
program's trace left off by the harness.

``queue_wait_p90_ms.serve`` reads each request's ``admitted_at``; a
program without it (an older checkout) gives the reader nothing to read,
and the metric is left out instead of the run failing. The harness never
starts the program's trace (``engine.trace``), traced run or not, so the
end-to-end numbers and the harness's own spans are taken with it off.
"""

import time
import types

import pytest

from conftest import tiny_cell

SERVE = "dolly3b-q4f16hs.serve-chat"


def _run(name, trace):
    from harness import cell as cell_mod

    cell = tiny_cell(name)
    cell.config["correct"]["limits"] = {"error_scale": 0.1}
    cell.config["correct"]["min_compared"] = 8
    seen = {}

    def keep(engine, sched):
        seen["trace"] = engine.trace

    out = cell_mod.run_cell(cell, 2**31 + 77, 6.0, trace, "cpu", time.perf_counter(),
                            after_setup=keep)
    return out, seen["trace"]


@pytest.mark.parametrize("trace", [True, False], ids=["traced", "untraced"])
def test_harness_leaves_the_program_trace_off(trace):
    out, tr = _run(SERVE, trace)
    assert out["correct"], out["checks"]
    assert not tr.on and tr.spans == [] and tr.captures == 0
    if trace:
        wait = out["metrics"]["queue_wait_p90_ms.serve"]
        assert wait["unit"] == "ms" and 0.0 <= wait["value"] < 60e3
    else:
        assert "queue_wait_p90_ms.serve" not in out["metrics"]


def _ctx(reqs, host_end=100.0):
    from harness import spec
    from harness.loops import Served, Window
    from harness.readers import Context

    served = [Served(due=r.submitted_at, prompt_len=4, context=0, asked=4, greedy=True, req=r)
              for r in reqs]
    served[-1].measured = False  # due after the window: not read
    win = Window(0.0, 200.0, served, {})
    return Context(spec.load_cell(tiny_cell(SERVE).root, SERVE), win, 200.0, 1.0, None, None,
                   None, 8, False, quiet_end=host_end)


def test_queue_wait_reader():
    from harness import spec

    read = spec.metric_reader("queue_wait_p90_ms.serve")
    reqs = [types.SimpleNamespace(submitted_at=float(i), admitted_at=float(i) + 0.01 * i)
            for i in range(11)]
    reqs[-1].admitted_at = reqs[-1].submitted_at + 50.0
    # ten measured waits of 0, 10, ..., 90 ms: the p90 lies between the
    # two largest
    assert read(_ctx(reqs)) == pytest.approx(81.0)
    # a request admitted after the traced stretch began is not read
    reqs[9].admitted_at = 150.0
    assert read(_ctx(reqs)) == pytest.approx(72.0)


def test_queue_wait_reader_without_admitted_at():
    from harness import spec

    read = spec.metric_reader("queue_wait_p90_ms.serve")
    reqs = [types.SimpleNamespace(submitted_at=float(i)) for i in range(4)]
    assert read(_ctx(reqs)) is None
