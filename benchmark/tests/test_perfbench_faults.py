"""A run with the timed path broken underneath comes out not correct.

Each case skips the look for a card and drives the rest of a run of both
cells through ``run_cell`` on the CPU at a tiny size (the kernels' plain
versions), once sound and once with a fault planted where the cell can
have it: a decode step that hands back its state unchanged (the token it
was fed), and a token altered where it is produced (the first-token draw
and every decode step). The tiny model's limit is its own: sound tiny
runs read an `error_scale` of 1e-5 to ~0.03, a fault 10 (the grid's top).
"""

import time

import pytest

from conftest import tiny_cell

CELLS = ["moss16b-q4bf16.chat-b1", "dolly3b-q4f16hs.serve-chat"]
TINY_LIMIT = 0.1


def _run(name, fault=None, seed=2**31 + 5):
    from harness import cell as cell_mod

    cell = tiny_cell(name)
    cell.config["correct"]["limits"] = {"error_scale": TINY_LIMIT}
    cell.config["correct"]["min_compared"] = 8
    return cell_mod.run_cell(cell, seed, 6.0, False, "cpu", time.perf_counter(),
                             after_setup=fault)


def unchanged_state(engine, sched):
    """Every decode step returns the tokens it was fed."""

    def step(tokens, active, *a, **kw):
        return tokens[:, 0].clone()

    def block(tokens, active, *a, k_steps=4, **kw):
        return tokens[:, 0].clone().expand(k_steps, -1).clone()

    engine._decode_sample = step
    engine._decode_sample_k = block


def altered_tokens(engine, sched):
    """Each token is moved to the next id where it is drawn."""
    V = engine.cfg.vocab_size
    sample, step, block = engine.sample, engine._decode_sample, engine._decode_sample_k
    engine.sample = lambda *a, **kw: (sample(*a, **kw) + 1) % V
    engine._decode_sample = lambda *a, **kw: (step(*a, **kw) + 1) % V
    engine._decode_sample_k = lambda *a, **kw: (block(*a, **kw) + 1) % V


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = _run(name)
    assert out["correct"], out["checks"]
    assert out["checks"]["served_compared"]["value"] >= 8
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", [unchanged_state, altered_tokens])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault):
    out = _run(name, fault)
    assert not out["correct"]
    assert out["checks"]["error_scale"]["value"] > TINY_LIMIT
