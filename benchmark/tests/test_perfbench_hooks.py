"""The harness's hooks on the program fail loudly: a step program captured
inside the window, or a wrapped call that the program no longer makes,
stops the run instead of moving a capture into the window or leaving a
per-layer metric out."""

import time
import types

import pytest
import torch

from conftest import tiny_cell

CELLS = ["moss16b-q4bf16.chat-b1", "dolly3b-q4f16hs.serve-chat"]


def _traced(name, after_setup=None):
    from harness import cell as cell_mod

    cell = tiny_cell(name)
    cell.config["correct"]["limits"] = {"error_scale": 0.1}
    cell.config["correct"]["min_compared"] = 8
    return cell_mod.run_cell(cell, 2**31 + 9, 6.0, True, "cpu", time.perf_counter(),
                             after_setup=after_setup)


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_finds_every_hook(name):
    out = _traced(name)
    assert out["correct"], out["checks"]
    assert out["metrics"]  # the host-timed per-layer readers found their runs


def bypassed_staging(engine, sched):
    """The decode staging runs unwrapped, as if the program had renamed
    the method the harness wraps."""
    engine._stage_decode = types.MethodType(type(engine)._stage_decode, engine)


@pytest.mark.parametrize("name", CELLS)
def test_bypassed_hook_stops_the_run(name):
    with pytest.raises(RuntimeError, match="decode/decode_k runs with work"):
        _traced(name, bypassed_staging)


def test_recorder_verify_names_what_is_missing():
    from harness.record import Recorder

    rec = Recorder(True, torch.device("cpu"))
    need = {"spans": ("admit", "drain"), "runs": (("prefill_slots",),)}
    with pytest.raises(RuntimeError, match="admit, drain, prefill_slots runs with work"):
        rec.verify(need)
    with rec.span("admit"), rec.span("drain"):
        pass
    with pytest.raises(RuntimeError, match="prefill_slots"):
        rec.verify(need)
    Recorder(False, torch.device("cpu")).verify(need)  # an untraced run records nothing


def test_capture_inside_the_window_stops_the_run():
    from harness import program

    class Programs:
        def __init__(self):
            self.keys = {("decode", 8, 512): 0.1}

        @property
        def count(self):
            return len(self.keys)

        def capture_seconds(self):
            return dict(self.keys)

    engine = types.SimpleNamespace(programs=Programs())
    program.no_capture_in_window(engine, 1)
    engine.programs.keys[("decode_k", 8, 4, 1024)] = 0.2
    with pytest.raises(RuntimeError, match=r"1 step program\(s\) captured.*decode_k"):
        program.no_capture_in_window(engine, 1)
