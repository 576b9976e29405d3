"""On the card, at each cell's own size: sound runs read within the
limit, and the control (the reference in fp8 in the program's place, read
at the same positions of the same served tokens) reads beyond it, on three
seeds. Run on the card with

    python -m pytest benchmark/tests/test_perfbench_card.py -m cuda -q

(about 2 minutes a seed for MOSS, 1 for dolly). Here it skips."""

import time

import pytest

from conftest import ROOT

SEEDS = [2**31 + 101, 2**31 + 202, 2**31 + 303]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["moss16b-q4bf16.chat-b1", "dolly3b-q4f16hs.serve-chat"])
def test_control_fails_and_program_passes(card, name, seed):
    from harness import cell as cell_mod
    from harness import spec

    cell = spec.load_cell(ROOT, name)
    out = cell_mod.run_cell(cell, seed, 20.0, False, card, time.perf_counter(),
                            controls=("fp8",))
    limits = cell.config["correct"]["limits"]
    assert out["correct"], out["checks"]
    # the control fails at least one of the numbers compared
    assert any(out["notes"]["fp8_" + n] > lim for n, lim in limits.items()
               if lim is not None), out["notes"]
