"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module name (the port's name begins with the JAX
package's)."""

import ast
import os
import subprocess
import sys

from conftest import BENCH, ROOT


def test_forbidden_names_are_whole_top_level_names():
    from harness import guard

    names = ["mlc_llm_tpu_torch", "mlc_llm_tpu_torch.engine", "jax_like", "flaxen", "numpy",
             "mlc_llm_tpu", "mlc_llm_tpu.ops.pallas", "jax", "jaxlib.xla_client", "flax.core"]
    assert guard.forbidden_modules(names) == [
        "flax.core", "jax", "jaxlib.xla_client", "mlc_llm_tpu", "mlc_llm_tpu.ops.pallas"]


def _sources():
    for d, _, files in os.walk(BENCH):
        if os.sep + "tests" in d[len(BENCH):] or "__pycache__" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_the_benchmark_runs_imports_them():
    bad = []
    sources = list(_sources())
    assert os.path.join(BENCH, "arch", "dense.py") in sources
    for path in sources:
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            bad += [(path, n) for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "flax", "mlc_llm_tpu")]
    assert not bad


def test_a_run_loads_none_of_them():
    """Every module of the harness, the reference, the architectures, the
    metrics and the port they drive, imported in a fresh process, then
    sys.modules checked."""
    code = f"""
import glob, importlib.util, os, sys
sys.path[:0] = [{BENCH!r}, {ROOT!r}]
from harness import cell, check, guard, loops, program, readers, record, roofline, spec, stats, trace, traffic, weights
from reference import model, quant
import mlc_llm_tpu_torch.engine.engine, mlc_llm_tpu_torch.engine.scheduler
for p in glob.glob(os.path.join({BENCH!r}, "metrics", "*.py")):
    s = importlib.util.spec_from_file_location("m" + str(abs(hash(p))), p)
    s.loader.exec_module(importlib.util.module_from_spec(s))
archs = glob.glob(os.path.join({BENCH!r}, "arch", "*.py"))
assert archs
for p in archs:
    spec.load_arch(os.path.basename(p)[:-3])
print(guard.forbidden_modules())
"""
    env = dict(os.environ, USE_FLAX="0")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
