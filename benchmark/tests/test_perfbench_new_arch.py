"""A block the harness does not know comes in as new files only.

``gqa_bench/`` is a bench_dir of its own: an architecture
(``arch/swiglu_gqa.py``: RMSNorm, SwiGLU, 4 query heads to 2 K/V heads,
the port's ``llama`` family), two configurations that name it, the mixes
cut to a tiny model and three metrics, one of which reads the program's
scheduler through the run's Context. ``run_cell`` drives it on the CPU
in both loops and the harness finds every part by name; a planted fault
reads not correct.
"""

import ast
import json
import os
import time

import pytest

from conftest import BENCH, ROOT

GQA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "gqa_bench")
CELLS = {"gqa.chat-b1": ("tiny-swiglu-gqa.slot", "chat-b1"),
         "gqa.serve-chat": ("tiny-swiglu-gqa.paged", "serve-chat")}
BLOCK_WORDS = ("single_norm", "parallel_residual", "wqkv", "gelu", "ln1_b", "final_ln_b")


def _cell(tmp_path, name):
    from harness import spec

    bench = {
        "configs": [{"name": c, "file": os.path.join(GQA, "configs", c + ".json")}
                    for c, _ in CELLS.values()],
        "workloads": [{"name": n, "config": c, "traffic": t, "chips": 1}
                      for n, (c, t) in CELLS.items()],
        "end_to_end": [{"name": "out_tok_s", "unit": "tokens/s"},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "rows_dispatched.serve", "unit": "rows",
                       "workloads": ["gqa.serve-chat"]}]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return spec.load_cell(str(tmp_path), name, GQA)


def _run(cell, trace=False, fault=None):
    from harness import cell as cell_mod

    return cell_mod.run_cell(cell, 2**31 + 41, 6.0, trace, "cpu", time.perf_counter(),
                             after_setup=fault)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_new_block_runs_correct_in_both_loops(tmp_path, name):
    cell = _cell(tmp_path, name)
    assert cell.arch.__file__ == os.path.join(GQA, "arch", "swiglu_gqa.py")
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert out["checks"]["served_compared"]["value"] >= 8
    assert sorted(out["metrics"]) == ["out_tok_s", "setup_s"]
    w = cell.arch.work(cell.model, cell.deployment)
    assert 0 < w.products_bound_s(1, 1) < w.step_least_s([(0, 64)], 1)


def final_norm_negated(engine, sched):
    """One weight perturbed: the final RMSNorm's scale, sign flipped."""
    engine.params["final_ln"]["w"].neg_()


def test_planted_fault_is_not_correct(tmp_path):
    cell = _cell(tmp_path, "gqa.serve-chat")
    out = _run(cell, fault=final_norm_negated)
    assert not out["correct"]
    assert out["checks"]["error_scale"]["value"] > out["checks"]["error_scale"]["limit"]


def test_metric_reads_the_schedulers_counter(tmp_path):
    out = _run(_cell(tmp_path, "gqa.serve-chat"), trace=True)
    assert out["correct"], out["checks"]
    assert out["metrics"]["rows_dispatched.serve"]["value"] > 0


def test_reference_imports_nothing_of_the_program():
    """Only build_params, inside its body, imports the program, in every
    architecture module, this test's included."""
    paths = [os.path.join(d, "arch", f) for d in (BENCH, GQA)
             for f in sorted(os.listdir(os.path.join(d, "arch"))) if f.endswith(".py")]
    assert len(paths) >= 2
    for path in paths:
        tree = ast.parse(open(path).read())
        inside = {id(n) for f in ast.walk(tree)
                  if isinstance(f, ast.FunctionDef) and f.name == "build_params"
                  for n in ast.walk(f)}
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            if any(n.split(".")[0] == "mlc_llm_tpu_torch" for n in names):
                assert id(node) in inside, (path, node.lineno)


def test_no_block_is_named_outside_arch():
    """The harness, the shared reference and the scripts name no block
    and no architecture."""
    paths = [os.path.join(BENCH, f) for f in ("run.py", "calibrate.py", "sweep.py")]
    for d in ("harness", "reference"):
        paths += [os.path.join(BENCH, d, f) for f in os.listdir(os.path.join(BENCH, d))
                  if f.endswith(".py")]
    for path in paths:
        text = open(path).read().lower()
        for word in BLOCK_WORDS + ("swiglu_gqa",):
            assert word not in text, (path, word)
    assert os.path.exists(os.path.join(ROOT, "BENCHMARK.json"))
